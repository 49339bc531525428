"""The port's hash raycaster (ops/hash_raycast.py) against the JAX
package's, from ONE map built by the JAX package and carried across as
numpy (the map of tests/test_hash_raycast.py: a 160x120 camera, 2 cm
voxels, two fused views of the synthetic scene).

Tolerances:
- ``densify_active`` at the identity pose (the cache centre 1.728 m ahead
  lies mid-block, away from a block boundary): ``origin`` and
  ``voxel_size`` equal, sdf and weight within 1e-6 (copies of the map's
  values).
- ``sample_hash_trilinear`` on random positions: ``known`` equal, values
  within 1e-5; and, as in the JAX test, equal to the cache's sampler
  wherever the cache knows the point.
- ``raycast_hash``, both normal modes: hit masks equal on >= 99.9% of the
  pixels; where both hit, depth within 1e-4 m and normals within 1e-3 on
  >= 99.9% (128 adaptive steps).
- A camera 5 m from the origin: the cache follows it (hit > 0.8, median
  depth error under a voxel) and agrees with the JAX render as above,
  normals on >= 99%: the constant-depth plane at 1.5 m lies exactly on a
  voxel boundary, so a one-ulp difference in the hit depth moves the
  gradient's samples into the next voxel, which at the frustum's rim is
  unobserved (normal 0 in one package, (0, 0, -1) in the other).
- padded ActiveSet rows (ptr -1) and rows outside the cache are dropped.
- K12's plain versions (``densify_active_reference``, the count compared
  on the device, and ``densify_rows_reference``) against the jitted JAX
  ``densify_active`` / ``densify_rows`` on the same numpy inputs, bit for
  bit: the set's count cut to half with the rows past it left valid (the
  JAX set's past rows freed), and explicit rows with invalid, padded and
  far rows.  On CPU tensors the wrappers (``densify_active``,
  ``densify_rows``, ``raycast_hash``) are the plain versions, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np_tree, tt

from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import hash_raycast as jhr
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.utils import synthetic as jsyn
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import hash_raycast as thr
from voxelhashing_demo_tpu_torch.ops import tsdf as ttsdf

torch.set_num_threads(1)

CAM_KW = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.65, cy=59.8)
HASH_KW = dict(num_buckets=8192, bucket_size=4, num_blocks=8192,
               max_active=4096, max_new_per_frame=4096)
DIMS = (192, 192, 192)


def _cfgs(mod):
    return (mod.CameraConfig(**CAM_KW),
            mod.FusionConfig(voxel_size=0.02, truncation=0.08),
            mod.HashConfig(**HASH_KW),
            mod.RaycastConfig(max_steps=128, cache_dims=DIMS))


JCAM, JFUS, JHASH, JRC = _cfgs(jcfg)
TCAM, TFUS, THASH, TRC = _cfgs(tcfg)


def _fuse(hmap, T, depth):
    frame = jpre.preprocess_metric(depth, JCAM)
    return jho.fuse_frame(hmap, frame, T, JCAM, JHASH, JFUS)


@pytest.fixture(scope="module")
def scene():
    hmap = jho.create(JHASH)
    for t in (0.0, 0.5):
        T = jnp.asarray(jsyn.orbit_pose(t, 0.05, 2.0))
        hmap, _, _ = _fuse(hmap, T, jsyn.render_depth(T, JCAM))
    jact = jho.compact_visible(hmap, JHASH, jse3.identity(), JCAM, JFUS)
    tmap = convert.hashmap_from_numpy(np_tree(hmap), device="cpu")
    tact = convert.active_from_numpy(np_tree(jact), device="cpu")
    return dict(jmap=hmap, jact=jact, tmap=tmap, tact=tact)


def test_compact_visible_carried(scene):
    t = tho.compact_visible(scene["tmap"], THASH, torch.eye(4), TCAM, TFUS)
    for f in ("blocks", "ptrs", "count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(scene["jact"], f)))


def test_densify_active_matches(scene):
    jc = jax.jit(jhr.densify_active, static_argnames=(
        "cfg", "fusion", "cache_dims"))(
            scene["jmap"], scene["jact"], JHASH, JFUS, jse3.identity(), DIMS)
    tc = thr.densify_active(scene["tmap"], scene["tact"], THASH, TFUS,
                            torch.eye(4), DIMS)
    np.testing.assert_array_equal(tc.origin.numpy(), np.asarray(jc.origin))
    np.testing.assert_array_equal(tc.voxel_size.numpy(),
                                  np.asarray(jc.voxel_size))
    assert tuple(tc.sdf.shape) == DIMS and tc.sdf.is_contiguous()
    np.testing.assert_allclose(tc.sdf.numpy(), np.asarray(jc.sdf), atol=1e-6)
    np.testing.assert_allclose(tc.weight.numpy(), np.asarray(jc.weight),
                               atol=1e-6)
    assert (tc.weight > 0).float().mean() > 0.005


def test_densify_drops_padding_and_far_rows(scene):
    """Rows with ptr -1 (their clipped pointer reads row 0) and rows whose
    block lies outside the cache leave no trace."""
    tmap, tact = scene["tmap"], scene["tact"]
    n = int(tact.count)
    V = THASH.voxels_per_block
    blocks = torch.cat([tact.blocks[:n],
                        tact.blocks[:1],                      # padded row
                        torch.tensor([[4000, 0, 0]], dtype=torch.int32)])
    rows = tmap.tsdf[tact.ptrs[:n].long()]
    w = tmap.weight[tact.ptrs[:n].long()]
    junk = torch.full((2, V), 7.0)
    valid = torch.cat([torch.ones(n, dtype=torch.bool),
                       torch.tensor([False, True])])
    got = thr.densify_rows(blocks, torch.cat([rows, junk]),
                           torch.cat([w, junk]), valid, THASH, TFUS,
                           torch.eye(4), DIMS)
    want = thr.densify_active(tmap, tact, THASH, TFUS, torch.eye(4), DIMS)
    assert torch.equal(got.sdf, want.sdf)
    assert torch.equal(got.weight, want.weight)
    assert not (got.sdf == 7.0).any()


def _points():
    rng = np.random.default_rng(0)
    return rng.uniform([-0.5, -0.3, 1.0], [0.5, 0.6, 2.2],
                       size=(512, 3)).astype(np.float32)


def test_sample_hash_trilinear_matches(scene):
    p = _points()
    js, jw = jax.jit(jhr.sample_hash_trilinear,
                     static_argnames=("cfg", "fusion"))(
                         scene["jmap"], JHASH, JFUS, jnp.asarray(p))
    ts, tw = thr.sample_hash_trilinear(scene["tmap"], THASH, TFUS, tt(p))
    jk, tk = np.asarray(jw) > 0, tw.numpy() > 0
    np.testing.assert_array_equal(tk, jk)
    assert tk.mean() > 0.1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_direct_sampler_matches_cache(scene):
    p = tt(_points())
    s_direct, w_direct = thr.sample_hash_trilinear(scene["tmap"], THASH,
                                                   TFUS, p)
    cache = thr.densify_active(scene["tmap"], scene["tact"], THASH, TFUS,
                               torch.eye(4), DIMS)
    s_cache, w_cache = ttsdf.trilinear_sample(cache, p)
    known_cache = w_cache.numpy() > 0
    known_direct = w_direct.numpy() > 0
    assert known_cache.mean() > 0.1
    assert not (known_cache & ~known_direct).any()
    np.testing.assert_allclose(s_direct.numpy()[known_cache],
                               s_cache.numpy()[known_cache], atol=1e-5)


def _compare_renders(jo, to, normal_share=0.999):
    jh, th = np.asarray(jo.hit), to.hit.numpy()
    assert (jh == th).mean() >= 0.999
    both = jh & th
    d_ok = np.abs(to.depth.numpy() - np.asarray(jo.depth))[both] <= 1e-4
    assert d_ok.mean() >= 0.999
    n_ok = np.abs(to.normals.numpy() - np.asarray(jo.normals))[both].max(
        axis=-1) <= 1e-3
    assert n_ok.mean() >= normal_share
    for x in to:
        assert torch.isfinite(x.float()).all()
    return th


@pytest.mark.parametrize("normal_mode", ["gradient", "image"])
def test_raycast_hash_matches(scene, normal_mode):
    jrc = dataclasses.replace(JRC, normal_mode=normal_mode)
    trc = dataclasses.replace(TRC, normal_mode=normal_mode)
    jo = jhr.raycast_hash(scene["jmap"], scene["jact"], JHASH,
                          jse3.identity(), JCAM, jrc, JFUS, cache_dims=DIMS)
    to = thr.raycast_hash(scene["tmap"], scene["tact"], THASH, torch.eye(4),
                          TCAM, trc, TFUS, cache_dims=DIMS)
    th = _compare_renders(jo, to)
    d_true = np.asarray(jsyn.render_depth(jse3.identity(), JCAM))
    both = th & (d_true > 0)
    assert both.sum() / max((d_true > 0).sum(), 1) > 0.8
    assert np.median(np.abs(to.depth.numpy() - d_true)[both]) < 0.02


def test_cache_centering_far_from_origin():
    """Blocks far from the world origin still land in the cache when the
    camera is there (tests/test_hash_raycast.py, far-from-origin case)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (5.0, 0.0, 0.0)
    d = jnp.full((JCAM.height, JCAM.width), 1.5, dtype=jnp.float32)
    hmap, jact, n = _fuse(jho.create(JHASH), jnp.asarray(T), d)
    assert int(n) > 0
    jo = jhr.raycast_hash(hmap, jact, JHASH, jnp.asarray(T), JCAM, JRC, JFUS,
                          cache_dims=DIMS)
    tmap = convert.hashmap_from_numpy(np_tree(hmap), device="cpu")
    tact = tho.compact_visible(tmap, THASH, tt(T), TCAM, TFUS)
    to = thr.raycast_hash(tmap, tact, THASH, tt(T), TCAM, TRC, TFUS,
                          cache_dims=DIMS)
    th = _compare_renders(jo, to, normal_share=0.99)
    assert th.mean() > 0.8
    assert np.median(np.abs(to.depth.numpy()[th] - 1.5)) < 0.02


def test_densify_plain_count_on_device_matches_jax(scene):
    """The plain cache walks ``active[:count]`` by a mask computed on the
    device: with the count cut to half and the rows past it still valid,
    it equals JAX's cache of the same set with those rows freed."""
    tact, jact = scene["tact"], scene["jact"]
    half = int(tact.count) // 2
    cut = tho.ActiveSet(blocks=tact.blocks, ptrs=tact.ptrs,
                        count=torch.tensor(half, dtype=torch.int32))
    jptrs = np.asarray(jact.ptrs).copy()
    jptrs[half:] = -1
    jc = jax.jit(jhr.densify_active, static_argnames=(
        "cfg", "fusion", "cache_dims"))(
            scene["jmap"], jact._replace(ptrs=jnp.asarray(jptrs)), JHASH,
            JFUS, jse3.identity(), DIMS)
    tc = thr.densify_active_reference(scene["tmap"], cut, THASH, TFUS,
                                      torch.eye(4), DIMS)
    for f in ("sdf", "weight", "origin", "voxel_size"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    full = thr.densify_active_reference(scene["tmap"], tact, THASH, TFUS,
                                        torch.eye(4), DIMS)
    assert (full.weight > 0).sum() > (tc.weight > 0).sum() > 0


def test_densify_rows_plain_matches_jax(scene):
    """Explicit rows (the sharded path's form): the set's rows, a padded
    row marked invalid holding valid-looking data, a valid row far outside
    the cache and a junk row marked invalid; bit for bit against JAX."""
    tmap, tact = scene["tmap"], scene["tact"]
    n = int(tact.count)
    V = THASH.voxels_per_block
    rng = np.random.default_rng(7)
    blocks = np.concatenate([tact.blocks[:n].numpy(),
                             tact.blocks[:1].numpy(),
                             [[4000, 0, 0], [1, 2, 3]]]).astype(np.int32)
    ptrs = tact.ptrs[:n].long()
    sdf = np.concatenate([tmap.tsdf[ptrs].numpy(),
                          rng.random((3, V), dtype=np.float32)])
    w = np.concatenate([tmap.weight[ptrs].numpy(),
                        rng.random((3, V), dtype=np.float32) + 1])
    valid = np.concatenate([np.ones(n, bool), [False, True, False]])
    valid[::5] = False
    jc = jax.jit(jhr.densify_rows, static_argnames=(
        "cfg", "fusion", "cache_dims"))(
            jnp.asarray(blocks), jnp.asarray(sdf), jnp.asarray(w),
            jnp.asarray(valid), JHASH, JFUS, jse3.identity(), DIMS)
    tc = thr.densify_rows_reference(tt(blocks), tt(sdf), tt(w),
                                    torch.as_tensor(valid), THASH, TFUS,
                                    torch.eye(4), DIMS)
    for f in ("sdf", "weight", "origin", "voxel_size"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def test_wrappers_on_cpu_are_the_plain_versions(scene):
    """On CPU tensors ``densify_active``, ``densify_rows`` and
    ``raycast_hash`` run the plain versions (K12 and K11 run only on the
    card): equal bit for bit, no launch counted."""
    tmap, tact = scene["tmap"], scene["tact"]
    n12 = thr.LAUNCHES_DENSIFY
    got = thr.densify_active(tmap, tact, THASH, TFUS, torch.eye(4), DIMS)
    want = thr.densify_active_reference(tmap, tact, THASH, TFUS,
                                        torch.eye(4), DIMS)
    for f in ("sdf", "weight", "origin", "voxel_size"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    safe = torch.clamp(tact.ptrs, 0, tmap.tsdf.shape[0] - 1).long()
    args = (tact.blocks, tmap.tsdf[safe], tmap.weight[safe],
            tact.ptrs != tho.FREE_PTR, THASH, TFUS, torch.eye(4), DIMS)
    got = thr.densify_rows(*args)
    want = thr.densify_rows_reference(*args)
    for f in ("sdf", "weight", "origin", "voxel_size"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert thr.LAUNCHES_DENSIFY == n12
