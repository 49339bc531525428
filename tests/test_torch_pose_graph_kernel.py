"""The plain versions of the pose-graph kernels (K13a ``pg_edge_blocks``,
K13b ``pg_cg_solve``, K13c ``pg_retract``, csrc/pose_graph.cu) against the
JAX package, on the CPU.

Graphs are made with numpy from seeds (K <= 64 poses): noisy odometry
edges near identity, exact-identity pads, a pose repeated and joined to
itself, and loop edges whose residual rotates by up to 2.5 rad.  The
same arrays go to both packages (``convert.pose_graph_from_numpy``), the
JAX side jitted.

Tolerances: the Jacobian J against ``jax.jacfwd`` of the JAX residual, and
the blocks, b and chi2 against JAX ``_edge_blocks`` /
``build_normal_equations``: rtol 1e-5, atol 1e-5 (float32 tangents through
the logarithm in another order); a CG step 1e-5; ``apply_update`` and the
retract 1e-5; optimized poses 1e-4 (8-10 Gauss-Newton iterations of
float32 solves); ``se3.exp`` / ``inverse`` bit for bit against the
bottom row made on the host.
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

TOL = dict(rtol=1e-5, atol=1e-5)
J_EXP = jax.jit(jax.vmap(jse3.exp))


def _exp(xi) -> np.ndarray:
    return np.asarray(J_EXP(jnp.asarray(np.asarray(xi, np.float32)
                                        .reshape(-1, 6))))


def _graph(K=12, cap_K=16, cap_E=40, seed=0, loop_rad=(0.3, 1.2, 2.5),
           false_edge=False):
    """numpy graph arrays: a noisy ring of ``K`` poses (odometry edges
    measured at the truth, so their residuals are the noise), pose 1
    repeated as pose K - 1 and joined to it by an identity edge, loop edges
    whose measurement is off the truth by a rotation of each angle in
    ``loop_rad`` (and a translation), optionally a false closure; pads are
    (0, 0, I, 0)."""
    rng = np.random.RandomState(seed)
    a = 2 * np.pi * np.arange(K) / K
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = np.cos(a), np.sin(a), a
    gt = _exp(xi).astype(np.float64)
    noise = np.concatenate([rng.normal(0, 0.02, (K, 3)),
                            rng.normal(0, 0.01, (K, 3))], 1)
    est = (gt.astype(np.float32) @ _exp(noise)).astype(np.float32)
    est[K - 1] = est[1]

    def rel(i, j):
        return (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32)

    edges = [(i, i + 1, rel(i, i + 1), 1.0) for i in range(K - 2)]
    edges.append((1, K - 1, np.eye(4, dtype=np.float32), 2.0))
    for n, ang in enumerate(loop_rad):
        axis = rng.normal(size=3)
        off = np.concatenate([rng.normal(0, 0.2, 3),
                              ang * axis / np.linalg.norm(axis)])
        i, j = n, K // 2 + n
        edges.append((i, j, (rel(i, j) @ _exp(off)[0]).astype(np.float32),
                      float(rng.uniform(0.5, 2.0))))
    if false_edge:
        edges.append((2, K - 3, _exp([0.5, -0.3, 0.2, 0.0, 0.3, 0.0])[0],
                      1.0))
    P = np.broadcast_to(np.eye(4, dtype=np.float32), (cap_K, 4, 4)).copy()
    P[:K] = est
    ij = np.zeros((cap_E, 2), np.int32)
    ET = np.broadcast_to(np.eye(4, dtype=np.float32), (cap_E, 4, 4)).copy()
    w = np.zeros((cap_E,), np.float32)
    for e, (i, j, T, wt) in enumerate(edges):
        ij[e], ET[e], w[e] = (i, j), T, wt
    return dict(poses=P, num_poses=np.int32(K), edges_ij=ij, edges_T=ET,
                edges_w=w, num_edges=np.int32(len(edges)))


def _both(arrays):
    jg = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jg, convert.pose_graph_from_numpy(arrays, device="cpu")


def _jax_J(jg):
    def r_of(xi, Ti, Tj, Z):
        return jse3.log(jse3.inverse(Z) @ jse3.inverse(
            Ti @ jse3.exp(xi[:6])) @ (Tj @ jse3.exp(xi[6:])))

    Ti = jg.poses[jg.edges_ij[:, 0]]
    Tj = jg.poses[jg.edges_ij[:, 1]]
    return np.asarray(jax.jit(jax.vmap(jax.jacfwd(r_of),
                                       in_axes=(None, 0, 0, 0)))(
        jnp.zeros((12,), jnp.float32), Ti, Tj, jg.edges_T))


GNC = [tpg.gnc_delta(TK(ba_iters=8, ba_gnc_init_scale=4.0), i)
       for i in (0, 7)]


@pytest.fixture(scope="module")
def graph():
    return _both(_graph())


def test_jacobian_matches_jacfwd(graph):
    """Forward-mode tangents (plain K13a) against ``jax.jacfwd`` on every
    edge: noisy odometry, the identity edge of a repeated pose, loop
    residuals of 0.3, 1.2 and 2.5 rad, and the identity pads (r = 0, J
    finite)."""
    jg, tg = graph
    s = tpg.edge_system(tg, "cg")
    J_j = _jax_J(jg)
    assert s.J.dtype == torch.float32 and torch.isfinite(s.J).all()
    np.testing.assert_allclose(s.J.numpy(), J_j, **TOL)
    r = s.r.numpy()
    ang = np.linalg.norm(r[:, 3:], axis=1)
    assert ang.max() > 2.4                       # the 2.5 rad loop edge
    assert (r[int(tg.num_edges):] == 0).all()    # the pads: r = 0 exactly
    np.testing.assert_allclose(
        r, np.asarray(jax.jit(jpg.edge_residuals)(jg.poses, jg.edges_ij,
                                                  jg.edges_T)), atol=1e-5)


@pytest.mark.parametrize("delta,kernel", [(None, "gm"), (0.1, "gm"),
                                          (0.1, "huber"), (GNC[0], "gm"),
                                          (GNC[1], "gm"), (GNC[0], "huber")])
def test_edge_blocks_match_jax(graph, delta, kernel):
    """The edge rows (Hii, Hij, Hjj), b and chi2 of plain K13a against JAX
    ``_edge_blocks``, the robust kernel off, Geman-McClure and Huber, at a
    fixed width and at GNC's first and last widths (``np.float32``)."""
    jg, tg = graph
    out_j = jax.jit(jpg._edge_blocks, static_argnums=(1, 2))(jg, delta,
                                                             kernel)
    out_t = tpg._edge_blocks(tg, delta, kernel)
    for name, a, b in zip(("i", "j", "Hii", "Hij", "Hjj", "b", "chi2"),
                          out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("delta", [None, 0.1, GNC[0]])
def test_normal_equations_match_jax(graph, delta):
    """The assembled dense H (6K, 6K) and b of plain K13a against JAX
    ``build_normal_equations``; with the diagonal, H + anchor + damping as
    ``apply_update`` forms it."""
    jg, tg = graph
    H_j, b_j, c_j = jax.jit(jpg.build_normal_equations,
                            static_argnums=(1, 2))(jg, delta, "gm")
    H_t, b_t, c_t = tpg.build_normal_equations(tg, delta, "gm")
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), **TOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), **TOL)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-5)
    s = tpg.edge_system(tg, "dense", delta, "gm", diag=True, damping=1e-4)
    K6 = H_t.shape[0]
    anchor = np.zeros(K6, np.float32)
    anchor[:6] = 1e6
    np.testing.assert_allclose(
        s.H.numpy(), np.asarray(H_j) + np.diag(anchor) + 1e-4 * np.eye(K6),
        **TOL)
    # the chi2 mode: base weights only
    np.testing.assert_allclose(
        float(tpg._chi2(tg)), float(jax.jit(jpg._chi2)(jg)), rtol=1e-5)


@pytest.mark.parametrize("case", ["early_stop", "all_iterations"])
def test_cg_step_matches_jax(case):
    """Plain K13b against JAX ``solve_delta_cg``: a run that stops on the
    tolerance, and one that runs all 64 iterations (tolerance 0)."""
    arrays = _graph(K=40, cap_K=48, cap_E=96, seed=2, false_edge=True)
    jg, tg = _both(arrays)
    tol = 1e-2 if case == "early_stop" else 0.0
    jk = JK(ba_cg_tol=tol, ba_cg_iters=64)
    tk = TK(ba_cg_tol=tol, ba_cg_iters=64)
    d_j = jax.jit(jpg.solve_delta_cg, static_argnums=(1, 2))(jg, 0.1, jk)
    s = tpg.edge_system(tg, "cg", 0.1, "gm", damping=tk.ba_damping)
    out, d_t, iters = tpg.cg_solve(s, tg, tk)
    assert (int(iters) < 64) == (case == "early_stop")
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    assert float(np.abs(np.asarray(d_j)).max()) > 1e-3
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax.vmap(lambda T, x: T @ jse3.exp(x))(
            jg.poses, d_j)), atol=1e-5)
    np.testing.assert_array_equal(d_t.numpy(),
                                  tpg.solve_delta_cg(tg, 0.1, tk).numpy())


@pytest.mark.parametrize("damping", [1e-4, -1e9])
def test_apply_update_matches_jax(graph, damping):
    """Plain K13c after the library's factorization against JAX
    ``apply_update``; a system that cannot be factored (damping -1e9)
    leaves the poses as they were."""
    jg, tg = graph
    H_j, b_j, _ = jax.jit(jpg.build_normal_equations)(jg)
    H_t, b_t, _ = tpg.build_normal_equations(tg)
    out_j = jax.jit(jpg.apply_update, static_argnums=(3,))(
        jg, H_j, b_j, JK(ba_damping=damping))
    out_t = tpg.apply_update(tg, H_t, b_t, TK(ba_damping=damping))
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-5)
    if damping < 0:
        np.testing.assert_array_equal(out_t.poses.numpy(),
                                      tg.poses.numpy())


def test_retract_and_guard_match_jax():
    """The plain retract (K13b's tail, K13c) against ``T @ exp(xi)`` in
    JAX; K13c's guard: info != 0 or a non-finite delta gives zero."""
    rng = np.random.RandomState(4)
    T = _exp(rng.normal(0, 1.0, (16, 6)))
    d = rng.normal(0, 0.2, (16, 6)).astype(np.float32)
    d[3, 3:] = 0.0                               # the small-angle branch
    ref = np.asarray(jax.vmap(lambda A, x: A @ jse3.exp(x))(T, d))
    Tt, dt = torch.from_numpy(T.copy()), torch.from_numpy(d).reshape(-1)
    ok = torch.zeros((), dtype=torch.int32)
    out, used = tpg.retract(dt, ok, Tt)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(used.numpy(), d)
    for info, dd in ((1, dt), (0, torch.where(torch.arange(96) == 5,
                                              float("inf"), dt))):
        out, used = tpg.retract(dd, torch.tensor(info, dtype=torch.int32),
                                Tt)
        np.testing.assert_array_equal(out.numpy(), T)
        assert not used.any()


@pytest.mark.parametrize("solver", ["dense", "cg", "auto"])
def test_optimize_matches_jax(solver):
    """``optimize`` through the plain versions against JAX, with a false
    closure and GNC (Geman-McClure 0.1, init scale 4): poses 1e-4;
    ``optimize_reference`` is the same code path on the CPU."""
    arrays = _graph(K=24, cap_K=32, cap_E=48, seed=5, loop_rad=(0.2, 0.6),
                    false_edge=True)
    jg, tg = _both(arrays)
    kw = dict(ba_iters=8, ba_solver=solver, ba_dense_max_k=16,
              ba_gnc_init_scale=4.0)
    out_j, info_j = jpg.optimize(jg, JK(**kw))
    out_t, info_t = tpg.optimize(tg, TK(**kw))
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses),
                               atol=1e-4)
    np.testing.assert_allclose(float(info_t.chi2_initial),
                               float(info_j.chi2_initial), rtol=1e-5)
    assert info_t.chi2_final.dim() == 0 and info_t.iters == 8
    ref, _ = tpg.optimize_reference(tg, TK(**kw))
    assert torch.equal(ref.poses, out_t.poses)
    np.testing.assert_array_equal(tg.poses.numpy(), arrays["poses"])


def test_order_of_sums_is_the_documented_one(graph):
    """The assembly's b is (sum of bi by i) + (sum of bj by j), each in
    edge order from 0 (csrc/pose_graph.cu's header), and chi2 is the
    warp-ordered sum: the plain version equals a loop that adds so."""
    _, tg = graph
    s = tpg.edge_system(tg, "cg")
    K = tg.poses.shape[0]
    rows = s.rows.numpy()
    ij = tg.edges_ij.numpy()
    bi = np.zeros((K, 6), np.float32)
    bj = np.zeros((K, 6), np.float32)
    for e in range(rows.shape[0]):
        bi[ij[e, 0]] += rows[e, tpg._BI:tpg._BI + 6]
        bj[ij[e, 1]] += rows[e, tpg._BJ:tpg._BJ + 6]
    np.testing.assert_array_equal(s.b.numpy(), bi + bj)
    t = np.zeros(32 * -(-rows.shape[0] // 32), np.float32)
    t[:rows.shape[0]] = rows[:, tpg._T]
    lanes = t.reshape(-1, 32)
    acc = lanes[0].copy()
    for row in lanes[1:]:
        acc = acc + row
    for off in (16, 8, 4, 2, 1):
        acc = acc[:off] + acc[off:2 * off]
    assert float(s.chi2) == float(acc[0])


def test_refused_modes_and_kernels_raise(graph):
    _, tg = graph
    with pytest.raises(ValueError, match="mode"):
        tpg.edge_system(tg, "lu")
    with pytest.raises(ValueError, match="robust kernel"):
        tpg.edge_system(tg, "cg", 0.1, "cauchy")


def test_se3_bottom_row_made_on_the_device_is_unchanged():
    """``se3.exp`` and ``se3.inverse`` give the same bits as with the
    bottom row uploaded from a host list."""
    rng = np.random.RandomState(9)
    xi = torch.from_numpy(rng.normal(0, 1.0, (64, 6)).astype(np.float32))
    T = tse3.exp(xi)
    Ti = tse3.inverse(T)
    row = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(64, 1, 4)
    top = T[:, :3]
    assert torch.equal(T, torch.cat([top, row], dim=1))
    assert torch.equal(Ti, torch.cat([Ti[:, :3], row], dim=1))
    assert torch.equal(tse3.exp(xi[0]), T[0])
    assert tse3.exp(xi).stride() == T.stride()
