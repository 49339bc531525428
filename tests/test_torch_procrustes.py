"""PyTorch port of geometry/procrustes.py: the cases of
tests/test_procrustes.py on the port, and each function against the JAX
package on the same numpy inputs.

Tolerances: ``procrustes`` against the known transform 1e-4 (as the JAX
test) and against JAX 1e-5 (one 3x3 SVD; the rotation does not depend on
the SVD's sign convention at rank >= 2); ``procrustes_init`` and
``procrustes_init_raced`` on rendered room frames against JAX 1e-4 (two or
three association + solve rounds); for collinear points only "finite,
det = +1" is asked of either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tt

from voxelhashing_demo_tpu.config import CameraConfig as JCam
from voxelhashing_demo_tpu.config import ICPConfig as JICP
from voxelhashing_demo_tpu.geometry import procrustes as jproc
from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import icp as jicp
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch.config import CameraConfig as TCam
from voxelhashing_demo_tpu_torch.config import ICPConfig as TICP
from voxelhashing_demo_tpu_torch.geometry import procrustes as tproc
from voxelhashing_demo_tpu_torch.ops import icp as ticp
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre
from voxelhashing_demo_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CAM_KW = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.65, cy=59.8)
J_PROC = jax.jit(jproc.procrustes)


def _random_T(rng, max_rot_deg, max_trans):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(5.0, max_rot_deg))
    xi = np.concatenate([rng.uniform(-max_trans, max_trans, 3),
                         axis * ang]).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def _rot_err_deg(A, B):
    R = np.asarray(A)[:3, :3].T @ np.asarray(B)[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("trial", range(5))
def test_recovers_random_rigid_transforms(trial):
    rng = np.random.RandomState(trial)
    T = _random_T(rng, max_rot_deg=120.0, max_trans=1.0)
    src = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    est = tproc.procrustes(tt(src), tt(tgt)).numpy()
    np.testing.assert_allclose(est, T, atol=1e-4)
    ref = np.asarray(J_PROC(jnp.asarray(src), jnp.asarray(tgt)))
    np.testing.assert_allclose(est, ref, atol=1e-5)


def test_weights_ignore_outliers():
    rng = np.random.RandomState(1)
    T = _random_T(rng, max_rot_deg=60.0, max_trans=0.5)
    src = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    w = np.ones(200, np.float32)
    bad = rng.choice(200, 60, replace=False)
    tgt[bad] += rng.normal(0, 5.0, (60, 3)).astype(np.float32)
    w[bad] = 0.0
    est = tproc.procrustes(tt(src), tt(tgt), tt(w)).numpy()
    np.testing.assert_allclose(est, T, atol=1e-4)
    ref = np.asarray(J_PROC(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(w)))
    np.testing.assert_allclose(est, ref, atol=1e-5)


def test_planar_points_no_reflection_and_degenerate_safe():
    rng = np.random.RandomState(2)
    T = _random_T(rng, max_rot_deg=40.0, max_trans=0.3)
    src = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    src[:, 2] = 0.0                              # planar: rank 2
    tgt = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    est = tproc.procrustes(tt(src), tt(tgt)).numpy()
    assert np.linalg.det(est[:3, :3]) > 0.99
    np.testing.assert_allclose(est @ np.c_[src, np.ones(100)].T,
                               np.c_[tgt, np.ones(100)].T, atol=1e-3)
    ref = np.asarray(J_PROC(jnp.asarray(src), jnp.asarray(tgt)))
    np.testing.assert_allclose(est, ref, atol=1e-5)
    # total weight zero -> identity
    out = tproc.procrustes(tt(src), tt(tgt), torch.zeros(100)).numpy()
    np.testing.assert_array_equal(out, np.eye(4, dtype=np.float32))


def test_collinear_points_finite_rotation():
    """Rank 1: the rotation about the line is free, so the packages may
    differ; both must return a finite proper rotation."""
    t = np.linspace(-1, 1, 50, dtype=np.float32)[:, None]
    src = t * np.array([[1.0, 2.0, -0.5]], np.float32)
    tgt = src + np.array([0.1, 0.0, 0.2], np.float32)
    for est in (tproc.procrustes(tt(src), tt(tgt)).numpy(),
                np.asarray(J_PROC(jnp.asarray(src), jnp.asarray(tgt)))):
        assert np.isfinite(est).all()
        np.testing.assert_allclose(np.linalg.det(est[:3, :3]), 1.0,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def room_pair():
    """Two rendered room frames ~45 degrees apart (port's renderer on the
    CPU), preprocessed by each package from the same uint16 images."""
    jcam, tcam = JCam(**CAM_KW), TCam(**CAM_KW)
    sweep = 90.0
    Ta = synthetic.room_sweep_pose(0.0, sweep)
    Tb = synthetic.room_sweep_pose(0.5, sweep)
    raws = [synthetic.depth_to_raw(synthetic.render_depth(
        torch.as_tensor(T, dtype=torch.float32), tcam,
        sdf=synthetic.room_sdf), tcam) for T in (Ta, Tb)]
    pre = jax.jit(jpre.preprocess, static_argnums=(1,))
    ja, jb = (pre(jnp.asarray(r), jcam) for r in raws)
    ta, tb = (tpre.preprocess(tt(r.astype(np.int32)), tcam) for r in raws)
    return dict(jcam=jcam, tcam=tcam, ja=ja, jb=jb, ta=ta, tb=tb,
                T_true=np.linalg.inv(Ta) @ Tb)


def test_procrustes_init_matches_jax(room_pair):
    p = room_pair
    init = _random_T(np.random.RandomState(3), 12.0, 0.05)
    f = jax.jit(jproc.procrustes_init, static_argnums=(2, 3, 4))
    ref = np.asarray(f(p["jb"], p["ja"], p["jcam"], JICP(), 2,
                       jnp.asarray(init)))
    got = tproc.procrustes_init(p["tb"], p["ta"], p["tcam"], TICP(),
                                rounds=2, init_T=tt(init)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - init).max() > 1e-2      # the rounds moved it


def test_yaw_starts_match_jax():
    yaws = jnp.deg2rad(jnp.asarray(tproc.YAWS_DEG, dtype=jnp.float32))
    got = tproc.yaw_starts(device="cpu").numpy()
    np.testing.assert_allclose(got[:, 0, 0], np.asarray(jnp.cos(yaws)),
                               atol=1e-7)
    np.testing.assert_allclose(got[:, 0, 2], np.asarray(jnp.sin(yaws)),
                               atol=1e-7)
    np.testing.assert_array_equal(got[:, 2, 0], -got[:, 0, 2])
    np.testing.assert_array_equal(got[3], np.eye(4, dtype=np.float32))


def test_raced_init_matches_jax_and_extends_icp_basin(room_pair):
    """The 45-degree pair: identity-start ICP locks into a wrong basin,
    the yaw-raced init + the same ICP recovers the truth; the raced init
    equals JAX's (the winning hypothesis scores 4112 gated inliers, the
    next 3061: the pick decides with margin)."""
    p = room_pair
    jicfg, ticfg = JICP(max_iters=15), TICP(max_iters=15)
    T_true = p["T_true"]

    ident = ticp.icp_align(p["tb"], p["ta"], p["tcam"], ticfg)
    assert _rot_err_deg(ident.transform.numpy(), T_true) > 10.0

    f = jax.jit(jproc.procrustes_init_raced, static_argnums=(2, 3))
    ref = np.asarray(f(p["jb"], p["ja"], p["jcam"], jicfg))
    T0 = tproc.procrustes_init_raced(p["tb"], p["ta"], p["tcam"],
                                     ticfg).numpy()
    np.testing.assert_allclose(T0, ref, atol=1e-4)
    assert _rot_err_deg(T0, T_true) < 10.0

    refined = ticp.icp_align(p["tb"], p["ta"], p["tcam"], ticfg,
                             init_T=tt(T0))
    T1 = refined.transform.numpy()
    assert _rot_err_deg(T1, T_true) < 1.0
    assert np.linalg.norm(T1[:3, 3] - T_true[:3, 3]) < 0.02
    ref1 = jicp.icp_align(p["jb"], p["ja"], p["jcam"], jicfg,
                          init_T=jnp.asarray(ref))
    np.testing.assert_allclose(T1, np.asarray(ref1.transform), atol=1e-4)


def test_zero_frame_gives_identity(room_pair):
    """A frame with no valid pixel (the pad of a JAX candidate batch) has
    total weight 0, so every round's solve is the identity:
    ``procrustes_init`` returns its start, and the race, all scores 0,
    returns the first hypothesis' start."""
    p = room_pair
    zero = tpre.Frame(*(torch.zeros_like(x) for x in p["ta"]))
    T = tproc.procrustes_init(p["tb"], zero, p["tcam"], TICP(), rounds=2)
    np.testing.assert_array_equal(T.numpy(), np.eye(4, dtype=np.float32))
    raced = tproc.procrustes_init_raced(p["tb"], zero, p["tcam"], TICP())
    np.testing.assert_array_equal(
        raced.numpy(), tproc.yaw_starts(device="cpu")[0].numpy())
