"""PyTorch port of ops/pose_graph.py against the JAX package.

Graphs are built with numpy from seeds (rings with noisy-odometry initial
estimates, random graphs with nonzero residuals), carried to both packages
as the same arrays (``convert.pose_graph_from_numpy``), the JAX side
jitted.

Tolerances: residuals and robust weights 1e-6; per-edge blocks J / H / b
(``_edge_blocks``) atol 1e-5; assembled H rtol 1e-4 / atol 1e-5; a dense or
CG step 1e-5; optimized poses 1e-4 (10 Gauss-Newton iterations of float32
solves in another summation order); ``gnc_delta`` rtol 1e-6 (``pow`` in the
last ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import KeyframeConfig as JK
from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import pose_graph as jpg
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.config import KeyframeConfig as TK
from voxelhashing_demo_tpu_torch.geometry import se3 as tse3
from voxelhashing_demo_tpu_torch.ops import pose_graph as tpg

torch.set_num_threads(1)

J_EXP = jax.jit(jse3.exp)


def _exp(xi):
    return np.asarray(J_EXP(jnp.asarray(np.asarray(xi, np.float32))))


def _ring_poses(K, radius=1.0):
    a = 2 * np.pi * np.arange(K) / K
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = radius * np.cos(a), radius * np.sin(a), a
    return list(_exp(xi))


def _rel(Ta, Tb):
    return (np.linalg.inv(Ta.astype(np.float64))
            @ Tb.astype(np.float64)).astype(np.float32)


def _arrays(poses, edges, cap_K, cap_E):
    """numpy graph arrays by the JAX field names; ``edges`` is a list of
    (i, j, T_ij, weight)."""
    P = np.broadcast_to(np.eye(4, dtype=np.float32), (cap_K, 4, 4)).copy()
    P[:len(poses)] = np.stack(poses)
    ij = np.zeros((cap_E, 2), np.int32)
    ET = np.broadcast_to(np.eye(4, dtype=np.float32), (cap_E, 4, 4)).copy()
    w = np.zeros((cap_E,), np.float32)
    for e, (i, j, T, wt) in enumerate(edges):
        ij[e], ET[e], w[e] = (i, j), T, wt
    return dict(poses=P, num_poses=np.int32(len(poses)), edges_ij=ij,
                edges_T=ET, edges_w=w, num_edges=np.int32(len(edges)))


def _both(arrays):
    jg = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jg, convert.pose_graph_from_numpy(arrays, device="cpu")


def _drift_ring(K=8, seed=0, cap_K=None, cap_E=None, trans=0.02, rot=0.01,
                extra=()):
    """The drifted ring of tests/test_pose_graph.py and
    tests/test_backend_robustness.py: noisy-odometry estimates, clean
    odometry measurements, the true closure, plus ``extra`` edges."""
    gt = _ring_poses(K)
    rng = np.random.RandomState(seed)
    est = [gt[0]]
    for i in range(K - 1):
        noise = np.concatenate([rng.normal(0, trans, 3),
                                rng.normal(0, rot, 3)]).astype(np.float32)
        est.append((est[-1] @ (_rel(gt[i], gt[i + 1]) @ _exp(noise))
                    ).astype(np.float32))
    edges = [(i, i + 1, _rel(gt[i], gt[i + 1]), 1.0) for i in range(K - 1)]
    edges.append((K - 1, 0, _rel(gt[K - 1], gt[0]), 1.0))
    edges += list(extra)
    return _arrays(est, edges, cap_K or K, cap_E or K + 4), gt


def _random_graph(K=7, E=12, cap_K=12, cap_E=20, seed=3):
    """Poses perturbed off a ring, random weighted edges measured at the
    truth (nonzero residuals up to ~0.2)."""
    rng = np.random.RandomState(seed)
    gt = _ring_poses(K)
    poses = []
    for T in gt:
        noise = np.concatenate([rng.normal(0, 0.05, 3),
                                rng.normal(0, 0.03, 3)]).astype(np.float32)
        poses.append((T @ _exp(noise)).astype(np.float32))
    edges = []
    for _ in range(E):
        i, j = rng.choice(K, size=2, replace=False)
        edges.append((int(i), int(j), _rel(gt[i], gt[j]),
                      float(rng.uniform(0.5, 2.0))))
    return _arrays(poses, edges, cap_K, cap_E)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_create_grow_and_convert_round_trip():
    jg, tg = jpg.create(4, 6), tpg.create(4, 6, device="cpu")
    for f in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(_np(getattr(jg, f)),
                                      np.asarray(getattr(tg, f)), f)
    arrays, _ = _drift_ring()
    jg, tg = _both(arrays)
    jb, tb = jpg.grow(jg, 32, 64), tpg.grow(tg, 32, 64)
    back = convert.pose_graph_to_numpy(tb)
    for f in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jb, f)), f)
        assert back[f].dtype == np.asarray(getattr(jb, f)).dtype, f
    with pytest.raises(ValueError):
        tpg.grow(tb, 4, 4)


def test_add_pose_add_edge_and_capacity_noops():
    jg, tg = jpg.create(2, 1), tpg.create(2, 1, device="cpu")
    T = _exp([0.1, 0.2, 0.3, 0.0, 0.4, 0.0])
    for _ in range(4):
        jg = jpg.add_pose(jg, jnp.asarray(T))
        jg = jpg.add_edge(jg, 0, 1, jnp.asarray(T), 2.0)
        tg = tpg.add_pose(tg, T)
        tg = tpg.add_edge(tg, 0, 1, T, 2.0)
    assert (tg.num_poses, tg.num_edges) == (2, 1)
    back = convert.pose_graph_to_numpy(tg)
    for f in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jg, f)), f)


@pytest.mark.parametrize("kernel", ["gm", "huber"])
def test_residuals_and_robust_weights(kernel):
    jg, tg = _both(_random_graph())
    r_j = jax.jit(jpg.edge_residuals)(jg.poses, jg.edges_ij, jg.edges_T)
    r_t = tpg.edge_residuals(tg.poses, tg.edges_ij, tg.edges_T)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6)
    assert float(np.abs(np.asarray(r_j)).max()) > 0.05
    w_j = jax.jit(jpg.robust_edge_weights, static_argnums=(1, 2))(
        jg, 0.1, kernel)
    w_t = tpg.robust_edge_weights(tg, 0.1, kernel)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    with pytest.raises(ValueError):
        tpg.robust_edge_weights(tg, 0.1, "cauchy")


def test_residuals_zero_at_ground_truth():
    gt = _ring_poses(6)
    arrays = _arrays(gt, [(i, i + 1, _rel(gt[i], gt[i + 1]), 1.0)
                          for i in range(5)], 6, 6)
    _, tg = _both(arrays)
    r = tpg.edge_residuals(tg.poses, tg.edges_ij, tg.edges_T)
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)


def _scaled_residual_graph(scale):
    """Three poses, two edges whose residual is ``scale`` x a fixed twist
    (0: exactly on the clamp's edge of ``se3.log``; ~1: a radian)."""
    gt = _ring_poses(3)
    off = _exp(np.array([0.3, -0.2, 0.25, 0.5, -0.6, 0.55], np.float32)
               * scale)
    edges = [(0, 1, (_rel(gt[0], gt[1]) @ off).astype(np.float32), 1.0),
             (1, 2, (off @ _rel(gt[1], gt[2])).astype(np.float32), 0.7)]
    return _arrays(gt, edges, 4, 3)


@pytest.mark.parametrize("scale", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("delta", [None, 0.1])
def test_edge_blocks_match_jax(scale, delta):
    """J (through H = J^T W J and b = J^T W r), per edge, against
    ``jax.jacfwd``: at a zero residual, a small one and one of ~1 rad."""
    jg, tg = _both(_scaled_residual_graph(scale))
    out_j = jax.jit(jpg._edge_blocks, static_argnums=(1, 2))(jg, delta, "gm")
    out_t = tpg._edge_blocks(tg, delta, "gm")
    for name, a, b in zip(("i", "j", "Hii", "Hij", "Hjj", "b", "chi2"),
                          out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   err_msg=name)
    # the Jacobian itself, against jacfwd of the JAX residual
    Ti = jg.poses[jg.edges_ij[:, 0]]
    Tj = jg.poses[jg.edges_ij[:, 1]]

    def r_of(xi, Ti_e, Tj_e, Z_e):
        return jse3.log(jse3.inverse(Z_e) @ jse3.inverse(
            Ti_e @ jse3.exp(xi[:6])) @ (Tj_e @ jse3.exp(xi[6:])))

    J_j = jax.jit(jax.vmap(jax.jacfwd(r_of), in_axes=(None, 0, 0, 0)))(
        jnp.zeros((12,), jnp.float32), Ti, Tj, jg.edges_T)
    J_t = tpg._edge_jacobians(tg.poses[tg.edges_ij[:, 0].long()],
                              tg.poses[tg.edges_ij[:, 1].long()], tg.edges_T)
    assert J_t.dtype == torch.float32
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-5)


@pytest.mark.parametrize("delta", [None, 0.1])
def test_normal_equations_dense_and_cg_step(delta):
    jg, tg = _both(_random_graph(K=9, E=16, cap_K=16, cap_E=24))
    H_j, b_j, c_j = jax.jit(jpg.build_normal_equations,
                            static_argnums=(1, 2))(jg, delta, "gm")
    H_t, b_t, c_t = tpg.build_normal_equations(tg, delta, "gm")
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)

    jk, tk = JK(ba_cg_iters=200, ba_cg_tol=1e-7), TK(ba_cg_iters=200,
                                                     ba_cg_tol=1e-7)
    d_j = jax.jit(jpg.apply_update, static_argnums=(3,))(jg, H_j, b_j, jk)
    d_t = tpg.apply_update(tg, H_t, b_t, tk)
    np.testing.assert_allclose(d_t.poses.numpy(), np.asarray(d_j.poses),
                               atol=1e-5)
    assert float(np.abs(np.asarray(d_j.poses) - np.asarray(jg.poses)).max()
                 ) > 1e-2
    cg_j = jax.jit(jpg.solve_delta_cg, static_argnums=(1, 2))(jg, delta, jk)
    cg_t = tpg.solve_delta_cg(tg, delta, tk)
    np.testing.assert_allclose(cg_t.numpy(), np.asarray(cg_j), atol=1e-5)


def test_gnc_delta_matches_traced_loop():
    jk, tk = JK(ba_iters=8), TK(ba_iters=8)
    f = jax.jit(lambda i: jpg.gnc_delta(jk, i))
    for i in range(8):
        np.testing.assert_allclose(float(tpg.gnc_delta(tk, i)),
                                   float(f(jnp.int32(i))), rtol=1e-6)
    assert tpg.gnc_delta(TK(ba_robust_delta=0.0), 3) is None
    assert tpg.gnc_delta(TK(ba_gnc_init_scale=1.0), 3) == 0.1


def _ate(poses, gt):
    return float(np.sqrt(np.mean(np.sum(
        (np.asarray(poses)[:, :3, 3] - np.asarray(gt)[:, :3, 3]) ** 2, -1))))


@pytest.mark.parametrize("solver", ["dense", "cg", "auto"])
def test_optimize_drift_ring(solver):
    """tests/test_pose_graph.py's drift ring: same optimum as JAX, drift
    corrected, anchor fixed."""
    arrays, gt = _drift_ring(K=8, cap_E=10)
    jg, tg = _both(arrays)
    kw = dict(ba_iters=10, ba_solver=solver, ba_dense_max_k=4)
    out_j, info_j = jpg.optimize(jg, JK(**kw))
    out_t, info_t = tpg.optimize(tg, TK(**kw))
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-4)
    np.testing.assert_allclose(float(info_t.chi2_initial),
                               float(info_j.chi2_initial), rtol=1e-5)
    assert float(info_t.chi2_final) < 1e-8
    assert info_t.iters == int(info_j.iters) == 10
    assert _ate(out_t.poses.numpy()[:8], gt) < 1e-3
    assert _ate(out_t.poses.numpy()[:8], gt) < 0.1 * _ate(arrays["poses"],
                                                          gt)
    np.testing.assert_allclose(out_t.poses[0].numpy(), gt[0], atol=1e-4)
    # the input graph's poses were not written
    np.testing.assert_array_equal(tg.poses.numpy(), arrays["poses"])
    with pytest.raises(ValueError):
        tpg.optimize(tg, TK(ba_solver="lu"))


@pytest.mark.parametrize("delta,kernel", [(0.0, "gm"), (0.1, "huber"),
                                          (0.1, "gm")])
def test_optimize_false_edge_ring(delta, kernel):
    """tests/test_backend_robustness.py's false loop closure (wrong by
    ~0.5 m): the port lands where JAX lands for each kernel; GM sheds the
    edge."""
    false_T = _exp([0.5, -0.3, 0.2, 0.0, 0.3, 0.0])
    arrays, gt = _drift_ring(K=8, extra=[(2, 6, false_T, 1.0)])
    jg, tg = _both(arrays)
    kw = dict(ba_iters=10, ba_robust_delta=delta, ba_robust_kernel=kernel)
    out_j, _ = jpg.optimize(jg, JK(**kw))
    out_t, _ = tpg.optimize(tg, TK(**kw))
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-4)
    ate = _ate(out_t.poses.numpy(), gt)
    if (delta, kernel) == (0.1, "gm"):
        assert ate < 0.005
    elif delta > 0:
        assert ate < 0.05
    else:
        assert ate > 0.05          # unprotected: the false edge bends it


def test_grow_leaves_the_optimum():
    arrays, _ = _drift_ring()
    _, tg = _both(arrays)
    small, _ = tpg.optimize(tg, TK(ba_iters=8))
    big, _ = tpg.optimize(tpg.grow(tg, 32, 64), TK(ba_iters=8))
    np.testing.assert_allclose(big.poses[:8].numpy(), small.poses.numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(
        big.poses[8:].numpy(),
        np.broadcast_to(np.eye(4, dtype=np.float32), (24, 4, 4)))


def test_empty_and_padded_graph_is_noop():
    tg = tpg.add_pose(tpg.create(4, 4, device="cpu"), np.eye(4))
    out, info = tpg.optimize(tg, TK(ba_iters=3))
    assert torch.isfinite(out.poses).all()
    assert float(info.chi2_final) == 0.0
    np.testing.assert_allclose(out.poses[0].numpy(), np.eye(4), atol=1e-5)


def test_cg_at_k512_capacity():
    """128 poses in a 512-capacity graph with chords ("auto" takes CG):
    same optimum as JAX, pads untouched."""
    K, cap = 128, 512
    gt = _ring_poses(K)
    chords = [(i, i + K // 2, _rel(gt[i], gt[i + K // 2]), 1.0)
              for i in range(0, K - K // 2, 16)]
    arrays, gt = _drift_ring(K=K, seed=7, cap_K=cap, cap_E=2 * cap,
                             trans=0.01, rot=0.005, extra=chords)
    jg, tg = _both(arrays)
    assert cap > TK().ba_dense_max_k
    out_j, info_j = jpg.optimize(jg, JK(ba_iters=10))
    out_t, info_t = tpg.optimize(tg, TK(ba_iters=10))
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-4)
    assert float(info_t.chi2_final) < 1e-6
    assert _ate(out_t.poses.numpy()[:K], gt) < 5e-3
    np.testing.assert_array_equal(
        out_t.poses[cap - 16:].numpy(),
        np.broadcast_to(np.eye(4, dtype=np.float32), (16, 4, 4)))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_failed_cholesky_is_a_noop(solver):
    """A system that cannot be factored (negative damping beyond H's
    spectrum: not positive definite) gives no update, as the JAX version's
    NaN solve does."""
    arrays, _ = _drift_ring()
    jg, tg = _both(arrays)
    kw = dict(ba_iters=2, ba_solver=solver, ba_damping=-1e9,
              ba_robust_delta=0.0)
    out_j, _ = jpg.optimize(jg, JK(**kw))
    out_t, _ = tpg.optimize(tg, TK(**kw))
    np.testing.assert_array_equal(np.asarray(out_j.poses), arrays["poses"])
    np.testing.assert_array_equal(out_t.poses.numpy(), arrays["poses"])


def test_repeatable():
    """Two runs of one solve give the same bits (on the CPU here; on the
    card tests/test_torch_cuda_kernels.py and chip_smoke.py check it)."""
    arrays, _ = _drift_ring(K=8)
    _, tg = _both(arrays)
    a, _ = tpg.optimize(tg, TK(ba_iters=5))
    b, _ = tpg.optimize(tg, TK(ba_iters=5))
    assert torch.equal(a.poses, b.poses)


def test_se3_round_trip_used_by_the_graph():
    xi = np.array([[0.3, -0.2, 0.1, 0.2, -0.4, 0.3]], np.float32)
    T = tse3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(tse3.log(T).numpy(), xi, atol=1e-6)
