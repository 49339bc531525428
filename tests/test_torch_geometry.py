"""PyTorch port of geometry/ (se3, camera, coords) against the JAX package
on the same numpy inputs.

The JAX side runs jitted, as the JAX step does: XLA then compiles a
division by a constant into a multiply by its float32 reciprocal, which
the port mirrors (geometry/f32.py).

Tolerances: integer coordinate algebra (world2voxel, blocks, hash, keys)
is bit-exact; pixel rays are bit-exact; float SE(3) maps agree within
1e-6 (float32 op order: XLA contracts multiply-adds into FMAs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tt

from voxelhashing_demo_tpu.config import CameraConfig as JCam
from voxelhashing_demo_tpu.geometry import camera as jcam
from voxelhashing_demo_tpu.geometry import coords as jco
from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu_torch.config import CameraConfig as TCam
from voxelhashing_demo_tpu_torch.geometry import camera as tcam
from voxelhashing_demo_tpu_torch.geometry import coords as tco
from voxelhashing_demo_tpu_torch.geometry import se3 as tse3

torch.set_num_threads(1)


def _twists(seed, n=64, scale=0.5):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32) * scale
    xi[:4, 3:] = 0.0                       # pure translations
    xi[4:8, 3:] *= 1e-4                    # tiny rotations (Taylor branch)
    return xi


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.numpy()


def test_hat_vee():
    w = _twists(0)[:, 3:]
    np.testing.assert_array_equal(_t(tse3.hat(tt(w))),
                                  _j(jse3.hat(jnp.asarray(w))))
    M = _j(jse3.hat(jnp.asarray(w)))
    np.testing.assert_array_equal(_t(tse3.vee(tt(M))),
                                  _j(jse3.vee(jnp.asarray(M))))


@pytest.mark.parametrize("seed", [1, 2])
def test_exp_log_inverse(seed):
    xi = _twists(seed)
    Tj = _j(jse3.exp(jnp.asarray(xi)))
    Tt = _t(tse3.exp(tt(xi)))
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    np.testing.assert_allclose(_t(tse3.log(tt(Tj))),
                               _j(jse3.log(jnp.asarray(Tj))), atol=1e-5)
    np.testing.assert_allclose(_t(tse3.inverse(tt(Tj))),
                               _j(jse3.inverse(jnp.asarray(Tj))), atol=1e-6)
    np.testing.assert_allclose(
        _t(tse3.rotation_angle(tt(Tj))),
        _j(jse3.rotation_angle(jnp.asarray(Tj))), atol=1e-6)


def test_apply_and_rotation():
    T = _j(jse3.exp(jnp.asarray(_twists(3)[10])))
    pts = np.random.default_rng(4).normal(size=(50, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _t(tse3.apply(tt(T), tt(pts))),
        _j(jse3.apply(jnp.asarray(T), jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_allclose(
        _t(tse3.apply_rotation(tt(T), tt(pts))),
        _j(jse3.apply_rotation(jnp.asarray(T), jnp.asarray(pts))), atol=1e-6)
    np.testing.assert_array_equal(_t(tse3.identity()), _j(jse3.identity()))


@pytest.mark.parametrize("cam_kw", [{}, dict(width=80, height=60, fx=64.6625,
                                             fy=64.5625, cx=39.7, cy=29.8)])
def test_camera(cam_kw):
    jc, tc = JCam(**cam_kw), TCam(**cam_kw)
    np.testing.assert_array_equal(
        _t(tcam.pixel_rays(tc)),
        _j(jax.jit(jcam.pixel_rays, static_argnums=(0,))(jc)))
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 2.0
    pts[:8, 2] = 0.0                       # z == 0 guard
    pts[8:16, 2] *= -1.0                   # behind the camera
    uvj, vj = jcam.project(jnp.asarray(pts), jc)
    uvt, vt = tcam.project(tt(pts), tc)
    np.testing.assert_allclose(_t(uvt), _j(uvj), rtol=1e-6)
    np.testing.assert_array_equal(_t(vt), _j(vj))
    ij_j, okj = jcam.project_nearest(jnp.asarray(pts), jc)
    ij_t, okt = tcam.project_nearest(tt(pts), tc)
    np.testing.assert_array_equal(_t(okt), _j(okj))
    np.testing.assert_array_equal(_t(ij_t)[_j(okj)], _j(ij_j)[_j(okj)])


@pytest.mark.parametrize("cam_kw", [{}, dict(width=80, height=60, fx=64.6625,
                                             fy=64.5625, cx=39.7, cy=29.8)])
def test_intrinsic_matrices(cam_kw):
    """K and K^-1 (entries rounded once from double precision): within
    1e-6 of JAX's (in fact equal), and inverse to each other."""
    jc, tc = JCam(**cam_kw), TCam(**cam_kw)
    K, Ki = tcam.intrinsic_matrix(tc), tcam.inv_intrinsic_matrix(tc)
    assert K.dtype == Ki.dtype == torch.float32 and K.shape == (3, 3)
    np.testing.assert_allclose(_t(K), _j(jcam.intrinsic_matrix(jc)),
                               atol=1e-6)
    np.testing.assert_allclose(_t(Ki), _j(jcam.inv_intrinsic_matrix(jc)),
                               atol=1e-6)
    np.testing.assert_allclose(_t(K @ Ki), np.eye(3), atol=1e-6)
    assert tcam.intrinsic_matrix(tc, dtype=torch.float64).dtype == \
        torch.float64


def test_compose():
    A = tse3.exp(tt(_twists(11)))
    B = tse3.exp(tt(_twists(12)))
    jA, jB = jnp.asarray(_t(A)), jnp.asarray(_t(B))
    np.testing.assert_allclose(_t(tse3.compose(A, B)),
                               _j(jax.jit(jse3.compose)(jA, jB)), atol=1e-6)
    np.testing.assert_allclose(_t(tse3.compose(A[0], B[0])),
                               _j(jse3.compose(jA[0], jB[0])), atol=1e-6)


def test_round_half_to_even():
    """project_nearest's rounding: exact .5 pixel coords go to even."""
    x = np.array([0.5, 1.5, 2.5, -0.5, 3.5], np.float32)
    np.testing.assert_array_equal(_t(torch.round(tt(x))),
                                  _j(jnp.round(jnp.asarray(x))))


def test_coords_integer_algebra():
    rng = np.random.default_rng(6)
    pts = (rng.normal(size=(2000, 3)) * 3.0).astype(np.float32)
    pts[:6] = [[0.01, -0.01, 0.0], [-0.03, 0.03, 0.05], [0.0, -0.0, 0.1],
               [0.009999, -0.009999, 0.02], [-0.17, 0.17, -0.16],
               [1e-9, -1e-9, 0.0]]
    for vs in (0.02, 0.05):
        vox_t = tco.world2voxel(tt(pts), vs)
        vox_j = jax.jit(jco.world2voxel, static_argnums=(1,))(
            jnp.asarray(pts), vs)
        np.testing.assert_array_equal(_t(vox_t), _j(vox_j))
        blk_t = tco.world2block(tt(pts), vs, 8)
        blk_j = jax.jit(jco.world2block, static_argnums=(1, 2))(
            jnp.asarray(pts), vs, 8)
        np.testing.assert_array_equal(_t(blk_t), _j(blk_j))
    blocks = rng.integers(-700, 700, size=(3000, 3)).astype(np.int32)
    bt, bj = tt(blocks), jnp.asarray(blocks)
    np.testing.assert_array_equal(_t(tco.voxel2block(bt, 8)),
                                  _j(jco.voxel2block(bj, 8)))
    np.testing.assert_array_equal(_t(tco.block2voxel(bt, 8)),
                                  _j(jco.block2voxel(bj, 8)))
    np.testing.assert_array_equal(_t(tco.block2world(bt, 0.02, 8)),
                                  _j(jco.block2world(bj, 0.02, 8)))
    for nb in (1024, 4096, 65536, 1000):
        np.testing.assert_array_equal(_t(tco.spatial_hash(bt, nb)),
                                      _j(jco.spatial_hash(bj, nb)))
    keys_t = tco.pack_block_key(bt, 10)
    keys_j = jco.pack_block_key(bj, 10)
    np.testing.assert_array_equal(_t(keys_t), _j(keys_j))
    assert (_t(keys_t) == tco.EMPTY_KEY).any()       # out-of-range blocks
    np.testing.assert_array_equal(_t(tco.unpack_block_key(keys_t, 10)),
                                  _j(jco.unpack_block_key(keys_j, 10)))
    idx = np.arange(512, dtype=np.int32)
    loc_t = tco.delinearize_voxel(tt(idx), 8)
    np.testing.assert_array_equal(
        _t(loc_t), _j(jco.delinearize_voxel(jnp.asarray(idx), 8)))
    np.testing.assert_array_equal(_t(tco.linearize_voxel(loc_t, 8)), idx)
    assert tco.EMPTY_KEY == int(jco.EMPTY_KEY)
