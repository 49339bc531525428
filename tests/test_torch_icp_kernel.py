"""The ICP kernels K4 ``icp_gn_level`` and K4s ``icp_sums``
(csrc/icp.cu) on the CPU: their plain versions against the JAX package on
the same preprocessed 80x60 frames of the orbit sequence, under the
flagship ICP settings.

The kernels run only on the card; here the functions that compute what
they compute, in their order (``_partials_reference``, ``_sums_reference``,
``_solve_warp_reference``, ``_solve_update_reference``, the frozen-lane
loop ``_level_reference`` and ``_race_epilogue_reference``), stand in for
them.

Tolerances: ``normal_system``'s plain version against JAX
``build_normal_system(*associate(...))``: rtol 1e-4, atol 1e-7 (the tier of
tests/test_torch_icp.py).  The kernel-order sums (per-thread stride sums,
then the CTA's and the grid's trees) against JAX's system and against the
same per-pixel terms summed in float64: rtol 1e-5, atol 1e-7 (the trees
are closer to float64 than a running sum).  The score sums: rtol 1e-5,
counts equal.  One update (solve, exp(delta) T) against JAX
``solve_normal_system`` and ``se3.exp``: 1e-6.  The warp solve's
right-looking order against the left-looking one: bit for bit.  Whole
loops: transforms 1e-5, iteration counts equal, error and count rtol 1e-3;
a candidate of the frozen-lane loop equals its run alone on the same grid
bit for bit; the race keeps what ``pick_by_score`` keeps.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_sequence, tiny_flagship_gather_config, tt

from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import icp as jicp
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.ops import icp as ticp
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_ASSOC = jax.jit(jicp.associate, static_argnums=(3, 4))
J_SYSTEM = jax.jit(jicp.build_normal_system, static_argnums=(4,))
J_SOLVE = jax.jit(jicp.solve_normal_system, static_argnums=(1,))
J_SCORE = jax.jit(jicp.alignment_score_sums, static_argnums=(3, 4))
J_PYRAMID = jax.jit(jicp.icp_align_pyramid, static_argnums=(2, 3))
J_EXP = jax.jit(jse3.exp)

SYSTEM_FIELDS = ("JTJ", "JTr", "error", "count")


@pytest.fixture(scope="module")
def frames():
    """Configs and frames 0-4 of the 10-frame orbit (the pairs of
    tests/test_torch_icp.py), preprocessed by JAX, with the port's
    copies."""
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, _ = jax_sequence(jc.camera, 10)
    depths = depths[:5]
    fj = [J_PRE(jnp.asarray(d), jc.camera, jc.frontend) for d in depths]
    ft = [tpre.Frame(*(tt(x) for x in f)) for f in fj]
    return dict(jc=jc, tc=tc, fj=fj, ft=ft, depths=depths)


def _T(seed, scale=0.01):
    xi = np.random.default_rng(seed).normal(size=6).astype(np.float32)
    return np.asarray(J_EXP(jnp.asarray(xi * scale)))


def _cfgs(frames, **kw):
    return (dataclasses.replace(frames["jc"].icp, **kw),
            dataclasses.replace(frames["tc"].icp, **kw))


def _jax_system(frames, T, i, j, cfg_j):
    out = J_ASSOC(jnp.asarray(T), frames["fj"][i], frames["fj"][j],
                  frames["jc"].camera, cfg_j)
    return J_SYSTEM(*out, cfg_j.huber_delta)


def _assert_system(got, want, rtol, atol=1e-7):
    for name in SYSTEM_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name), np.float64),
            np.asarray(getattr(want, name), np.float64),
            rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("huber", [0.0, 0.01])
@pytest.mark.parametrize("seed", [1, 2])
def test_normal_system_plain_matches_jax(frames, huber, seed):
    cfg_j, cfg_t = _cfgs(frames, huber_delta=huber)
    T = _T(seed)
    want = _jax_system(frames, T, 1, 0, cfg_j)
    got = ticp.normal_system(tt(T), frames["ft"][1],
                             ticp.pack_target(frames["ft"][0]),
                             frames["tc"].camera, cfg_t)
    assert float(got.count) > 500
    _assert_system(got, want, rtol=1e-4)


@pytest.mark.parametrize("huber", [0.0, 0.01])
@pytest.mark.parametrize("pair", [(1, 0), (3, 2)])
def test_kernel_order_sums_match_jax_and_float64(frames, huber, pair):
    """``_partials_reference`` (each thread's stride sum, the CTA's lanes
    and tree) summed over the CTAs as every CTA of K4 sums them gives JAX's
    system to rtol 1e-5, and the float64 sum of its own per-pixel terms to
    rtol 1e-5; a thread past the image adds nothing."""
    i, j = pair
    cfg_j, cfg_t = _cfgs(frames, huber_delta=huber)
    T = _T(10 + i)
    src, packed = frames["ft"][i], ticp.pack_target(frames["ft"][j])
    cam = frames["tc"].camera
    parts = ticp._partials_reference(tt(T), src, packed, cam, cfg_t)
    n = src.depth.numel()
    assert parts.shape == (ticp.N_SUMS, ticp._ctas(n))
    got = ticp._system_from_sums(ticp._sums_reference(parts))
    _assert_system(got, _jax_system(frames, T, i, j, cfg_j), rtol=1e-5)
    terms = ticp._terms_reference(tt(T), src, packed, cam, cfg_t, False)
    exact = ticp._system_from_sums(terms.double().sum(0))
    _assert_system(got, exact, rtol=1e-5)
    # the count column holds the inlier mask; the JTr columns J * rw
    assert float(got.count) == float(terms[:, 28].sum())


@pytest.mark.parametrize("n_cta", [1, 4, 7])
def test_kernel_order_stride_sums_match_float64(frames, n_cta):
    """Fewer CTAs than pixels / 256 (a thread sums several pixels at the
    grid's stride, the last round ragged): the sums still match the
    float64 sum of the terms to rtol 1e-5, and JAX's system."""
    cfg_j, cfg_t = _cfgs(frames, huber_delta=0.01)
    T = _T(14)
    src, packed = frames["ft"][2], ticp.pack_target(frames["ft"][1])
    cam = frames["tc"].camera
    parts = ticp._partials_reference(tt(T), src, packed, cam, cfg_t,
                                     n_cta=n_cta)
    assert parts.shape == (ticp.N_SUMS, n_cta)
    assert src.depth.numel() > n_cta * ticp.CTA_THREADS
    got = ticp._system_from_sums(ticp._sums_reference(parts))
    terms = ticp._terms_reference(tt(T), src, packed, cam, cfg_t, False)
    _assert_system(got, ticp._system_from_sums(terms.double().sum(0)),
                   rtol=1e-5)
    _assert_system(got, _jax_system(frames, T, 2, 1, cfg_j), rtol=1e-5)


@pytest.mark.parametrize("n_pixels,n_cands,want", [
    (19200, 1, 75), (76800, 1, 128), (19200, 2, 75), (19200, 4, 64),
    (4800, 4, 19), (19200, 16, 16), (19200, 300, 1)])
def test_grid_rule(n_pixels, n_cands, want):
    """CTAs a candidate: min(ceil(pixels / 256), 128, max(1, 256 / C)), a
    function of the pixels and the candidates alone; the whole grid stays
    within 256 CTAs up to 256 candidates."""
    got = ticp._ctas(n_pixels, n_cands)
    assert got == want
    assert n_cands > ticp.MAX_GRID or got * n_cands <= ticp.MAX_GRID


@pytest.mark.parametrize("seed", [3, 4])
def test_kernel_order_score_sums_match_jax(frames, seed):
    cfg_j, cfg_t = _cfgs(frames)
    T = _T(seed, 0.03)
    nj, dj = J_SCORE(jnp.asarray(T), frames["fj"][2], frames["fj"][1],
                     frames["jc"].camera, cfg_j)
    parts = ticp._partials_reference(
        tt(T), frames["ft"][2], ticp.pack_target(frames["ft"][1]),
        frames["tc"].camera, cfg_t, score=True)
    assert parts.shape[0] == ticp.N_SCORE_SUMS
    num, den = ticp._sums_reference(parts)
    np.testing.assert_allclose(float(num), float(nj), rtol=1e-5)
    assert float(den) == float(dj)


def _one_cta(system) -> torch.Tensor:
    """A system's 29 sums as the partials of a single CTA."""
    JTJ = np.asarray(system.JTJ, np.float32)
    rows, cols = np.triu_indices(6)
    s = np.concatenate([JTJ[rows, cols], np.asarray(system.JTr, np.float32),
                        [np.float32(system.error),
                         np.float32(system.count)]])
    return tt(s.astype(np.float32)[:, None])


def _systems(frames):
    """(name, JAX NormalSystem): a real one, an empty one, one of <= 6
    inliers (extra unit damping), one whose solve is not finite."""
    cfg_j, _ = _cfgs(frames)
    real = _jax_system(frames, _T(5), 1, 0, cfg_j)
    z = jnp.zeros((6, 6), jnp.float32)
    empty = jicp.NormalSystem(JTJ=z, JTr=jnp.zeros(6, jnp.float32),
                              error=jnp.float32(0), count=jnp.float32(0))
    few = real._replace(JTJ=real.JTJ * 1e-3, JTr=real.JTr * 1e-3,
                        count=jnp.float32(5))
    bad = real._replace(JTr=real.JTr.at[2].set(jnp.inf))
    return [("real", real), ("empty", empty), ("count<=6", few),
            ("not_finite", bad)]


@pytest.mark.parametrize("case", ["real", "empty", "count<=6",
                                  "not_finite"])
def test_solve_update_reference_matches_jax(frames, case):
    """One K4b update from a system's sums: delta as JAX
    ``solve_normal_system`` (0 for the empty and the non-finite system),
    T <- exp(delta) T, and the loop state (it + 1, done, dnorm, err, count,
    JTJ) as the JAX loop body writes it."""
    system = dict(_systems(frames))[case]
    damping = frames["tc"].icp.damping
    T = _T(6)
    delta = np.asarray(J_SOLVE(system, damping))
    want_T = np.asarray(J_EXP(jnp.asarray(delta))) @ T
    if case in ("empty", "not_finite"):
        assert not delta.any()
    tol2 = float(np.float32(1e-5 ** 2))
    T_new, ist, fst = ticp._solve_update_reference(
        _one_cta(system), tt(T), torch.tensor([2, 0], dtype=torch.int32),
        torch.zeros(39), damping, tol2, 8)
    np.testing.assert_allclose(T_new.numpy(), want_T, atol=1e-6)
    dnorm = float(np.sum(delta.astype(np.float64) ** 2))
    assert int(ist[0]) == 3 and bool(ist[1]) == (not dnorm > tol2)
    np.testing.assert_allclose(float(fst[0]), dnorm, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(
        float(fst[1]), float(system.error) / max(float(system.count), 1.0),
        rtol=1e-6)
    assert float(fst[2]) == float(system.count)
    np.testing.assert_array_equal(fst[3:].numpy().reshape(6, 6),
                                  np.asarray(system.JTJ))


def _spd_sums(seed: int) -> torch.Tensor:
    """29 sums of a seeded SPD system (JTJ of 40 random rows, JTr, error,
    count) in float32."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(40, 6)) * rng.uniform(0.01, 3.0, size=6)
    r = rng.normal(size=40) * 0.01
    JTJ = (J.T @ J).astype(np.float32)
    rows, cols = np.triu_indices(6)
    return tt(np.concatenate([JTJ[rows, cols], (J.T @ r).astype(np.float32),
                              [np.float32(r @ r), np.float32(40)]])
              .astype(np.float32))


@pytest.mark.parametrize("case", ["real", "empty", "count<=6", "not_finite",
                                  "spd0", "spd1", "spd2", "spd3"])
def test_warp_solve_reference_bit_equal_left_looking(frames, case):
    """The warp's right-looking Cholesky order (``_solve_warp_reference``)
    equals the left-looking ``_solve_reference`` bit for bit, on the
    step's systems (a real one, the empty, the <= 6-inlier and the
    non-finite one) and on seeded SPD systems; and the delta is JAX's."""
    damping = frames["tc"].icp.damping
    if case.startswith("spd"):
        s = _spd_sums(int(case[3:]))
    else:
        s = _one_cta(dict(_systems(frames))[case])[:, 0]
    left = ticp._solve_reference(s, damping)
    right = ticp._solve_warp_reference(s, damping)
    assert torch.equal(left.view(torch.int32), right.view(torch.int32))
    if case.startswith("spd"):
        want = np.asarray(J_SOLVE(jicp.NormalSystem(*(
            jnp.asarray(x.numpy()) for x in ticp._system_from_sums(s))),
            damping))
        np.testing.assert_allclose(right.numpy(), want, rtol=1e-4,
                                   atol=1e-7)


def test_solve_update_reference_stops(frames):
    """The done flag: nothing changes once it is set, and it is set after
    the last iteration whatever the update."""
    system = _systems(frames)[0][1]
    parts, T = _one_cta(system), tt(_T(7))
    state = (torch.tensor([4, 1], dtype=torch.int32), torch.zeros(39))
    out = ticp._solve_update_reference(parts, T, *state, 1e-6, 1e-10, 8)
    assert out[0] is T and out[1] is state[0] and out[2] is state[1]
    _, ist, _ = ticp._solve_update_reference(
        parts, T, torch.tensor([7, 0], dtype=torch.int32), torch.zeros(39),
        1e-6, 1e-10, 8)
    assert ist.tolist() == [8, 1]


def _device_loop(src, tgt, cam, cfg, init_T):
    """``icp_align``'s one K4 launch (C = 1) with the kernel's in-order
    references in its place: (T, (it, done), (dnorm, err, count))."""
    rows, iters = ticp._level_reference([src], [tgt], cam, cfg, [init_T])
    row = rows[0]
    return (row[:16].view(4, 4), torch.stack([iters[0], iters[0] * 0 + 1]),
            row[ticp._ROW_DNORM:ticp._ROW_COUNT + 1])


@pytest.mark.parametrize("pair,seed", [((1, 0), None), ((2, 1), 8),
                                       ((4, 3), 9)])
def test_device_loop_matches_jax_icp_align(frames, pair, seed):
    """The kernel's loop (early exit on the device) against the JAX
    ``icp_align`` at the flagship's coarse-level budget of 8 iterations:
    transform 1e-5, iterations equal, error and count rtol 1e-3; the CPU
    ``icp_align`` (its plain version) agrees too."""
    i, j = pair
    cfg_j, cfg_t = _cfgs(frames, max_iters=8)
    init = np.eye(4, dtype=np.float32) if seed is None else _T(seed)
    rj = jicp.icp_align(frames["fj"][i], frames["fj"][j],
                        frames["jc"].camera, cfg_j, init_T=jnp.asarray(init))
    T, ist, fst = _device_loop(frames["ft"][i], frames["ft"][j],
                               frames["tc"].camera, cfg_t, tt(init))
    assert int(ist[0]) == int(rj.iters)
    np.testing.assert_allclose(T.numpy(), np.asarray(rj.transform),
                               atol=1e-5)
    np.testing.assert_allclose(float(fst[1]), float(rj.error), rtol=1e-3)
    np.testing.assert_allclose(float(fst[2]), float(rj.count), rtol=1e-3)
    rt = ticp.icp_align(frames["ft"][i], frames["ft"][j],
                        frames["tc"].camera, cfg_t, init_T=tt(init))
    assert int(rt.iters) == int(rj.iters)
    np.testing.assert_allclose(rt.transform.numpy(), T.numpy(), atol=1e-5)


def test_device_loop_zero_iterations(frames):
    """max_iters 0: the JAX loop's initial state, from the plain loop and
    in the kernel's row (T, dnorm inf, error inf, count 0, JTJ 0)."""
    _, cfg_t = _cfgs(frames, max_iters=0)
    T = tt(_T(11))
    out = ticp.icp_align(frames["ft"][1], frames["ft"][0],
                         frames["tc"].camera, cfg_t, init_T=T)
    assert int(out.iters) == 0 and float(out.error) == float("inf")
    assert torch.equal(out.transform, T)
    rows, iters = ticp._level_reference([frames["ft"][1]], [frames["ft"][0]],
                                        frames["tc"].camera, cfg_t, [T])
    res = ticp._row_result(rows[0], iters[0])
    assert int(res.iters) == 0 and torch.equal(res.transform, T)
    assert float(res.error) == float("inf") and float(res.count) == 0
    assert not res.JTJ.any()


# (source, target, start seed) of the candidates of one launch
CANDIDATES = [(1, 0, None), (2, 1, 8), (4, 3, 9), (3, 2, 15)]


def test_frozen_lane_loop_equals_separate_runs(frames):
    """Four candidates in one launch (their own pairs and starts, so they
    stop at their own iterations): each equals its run alone on the same
    grid bit for bit, and the plain loop ``icp_align_reference`` with the
    same iteration count and transform within 1e-5."""
    _, cfg = _cfgs(frames, max_iters=8)
    cam, ft = frames["tc"].camera, frames["ft"]
    srcs = [ft[i] for i, _, _ in CANDIDATES]
    tgts = [ft[j] for _, j, _ in CANDIDATES]
    inits = [None if s is None else tt(_T(s)) for _, _, s in CANDIDATES]
    n = srcs[0].depth.numel()
    assert ticp._ctas(n, len(srcs)) == ticp._ctas(n, 1)
    rows, iters = ticp._level_reference(srcs, tgts, cam, cfg, inits)
    assert rows.shape == (len(srcs), ticp.ROW)
    for c, (s, t, i) in enumerate(zip(srcs, tgts, inits)):
        alone, it_alone = ticp._level_reference([s], [t], cam, cfg, [i])
        assert torch.equal(rows[c], alone[0]) and int(iters[c]) == int(
            it_alone[0])
        ref = ticp.icp_align_reference(s, t, cam, cfg, init_T=i)
        got = ticp._row_result(rows[c], iters[c])
        assert int(got.iters) == int(ref.iters)
        np.testing.assert_allclose(got.transform.numpy(),
                                   ref.transform.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(got.count), float(ref.count),
                                   rtol=1e-3)
    assert len({int(i) for i in iters}) > 1, "the candidates stop apart"


@pytest.mark.parametrize("pair,prior_seed", [((1, 0), 12), ((3, 2), 13),
                                             ((2, 1), None)])
def test_race_epilogue_matches_pick_by_score(frames, pair, prior_seed):
    """The race (C = 2: identity start, prior start, the epilogue's pick)
    against the plain race (two ``icp_align`` runs, their score sums and
    ``pick_by_score``): the same candidate kept, iterations equal,
    transform within 1e-5; a prior equal to the base start ties, and the
    tie goes to the base."""
    i, j = pair
    _, cfg = _cfgs(frames, max_iters=8)
    cam, src, tgt = frames["tc"].camera, frames["ft"][i], frames["ft"][j]
    prior = torch.eye(4) if prior_seed is None else tt(_T(prior_seed))
    rows, iters = ticp._level_reference([src, src], [tgt, tgt], cam, cfg,
                                        [None, prior], race=True)
    assert rows.shape == (3, ticp.ROW)
    want = ticp._race_plain(src, tgt, cam, cfg, prior)
    got = ticp._row_result(rows[2], iters[2])
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(got.transform.numpy(), want.transform.numpy(),
                               atol=1e-5)
    s0, s1 = float(rows[0, ticp._ROW_SCORE]), float(rows[1, ticp._ROW_SCORE])
    kept = 1 if s1 < s0 else 0
    assert torch.equal(rows[2, :16], rows[kept, :16])
    if prior_seed is None:
        assert s0 == s1 and kept == 0


@pytest.mark.parametrize("case", ["tie", "challenger_lower",
                                  "challenger_higher", "challenger_nan_T",
                                  "challenger_nan_score"])
def test_race_epilogue_reference_rule(case):
    """The epilogue's rule on made-up rows against ``pick_by_score``: a
    tie and a non-finite challenger go to the base."""
    rng = np.random.default_rng(3)
    rows = tt(rng.normal(size=(2, ticp.ROW)).astype(np.float32))
    iters = torch.tensor([3, 5], dtype=torch.int32)
    base, chal = (torch.tensor(0.5), torch.tensor(10.0)), (
        torch.tensor(0.5), torch.tensor(10.0))
    if case == "challenger_lower":
        chal = (torch.tensor(0.4), torch.tensor(10.0))
    elif case == "challenger_higher":
        chal = (torch.tensor(0.6), torch.tensor(10.0))
    elif case == "challenger_nan_T":
        chal = (torch.tensor(0.1), torch.tensor(10.0))
        rows[1, 5] = float("nan")
    elif case == "challenger_nan_score":
        chal = (torch.tensor(float("nan")), torch.tensor(10.0))
    got_rows, got_iters = ticp._race_epilogue_reference(rows, iters,
                                                        [base, chal])
    res = [ticp._row_result(rows[k], iters[k]) for k in (0, 1)]
    want = ticp.pick_by_score(res[1], res[0], chal[0] / chal[1],
                              base[0] / base[1])
    got = ticp._row_result(got_rows[2], got_iters[2])
    for name in ("transform", "error", "count", "iters", "JTJ"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    kept = 1 if case == "challenger_lower" else 0
    assert torch.equal(got_rows[2, :ticp._ROW_SCORE],
                       rows[kept, :ticp._ROW_SCORE])


def test_align_candidates_refuses_what_the_kernel_does_not_take(frames):
    """Sources of two shapes, a race of other than two candidates, or more
    candidates than a launch takes raise before anything is launched."""
    cam, cfg = frames["tc"].camera, frames["tc"].icp
    f = frames["ft"][1]
    small = tpre.Frame(*(x[:30] for x in f))
    with pytest.raises(ValueError, match="every source"):
        ticp._align_candidates([f, small], [f, f], cam, cfg, [None, None])
    with pytest.raises(ValueError, match="candidates"):
        ticp._align_candidates([f] * 3, [f] * 3, cam, cfg, [None] * 3,
                               race=True)
    n = ticp.MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="candidates"):
        ticp._align_candidates([f] * n, [f] * n, cam, cfg, [None] * n)


@pytest.mark.parametrize("pair,prior_seed", [((1, 0), 12), ((3, 2), 13)])
def test_icp_align_pyramid_flagship_settings(frames, pair, prior_seed):
    """The flagship pyramid (4, 2, 1), 8 / 4 / 2 iterations, the fine
    source pooled by 2, Huber 0.01, the prior raced at the coarsest level:
    transform 1e-5 and iterations equal against JAX."""
    i, j = pair
    jc, tc = frames["jc"], frames["tc"]
    prior = _T(prior_seed)
    fj, ft = frames["fj"], frames["ft"]
    rj = J_PYRAMID(fj[i].depth, fj[j].depth, jc.camera, jc.icp,
                   src_full=fj[i], tgt_full=fj[j],
                   prior_T=jnp.asarray(prior))
    rt = ticp.icp_align_pyramid(ft[i].depth, ft[j].depth, tc.camera,
                                tc.icp, src_full=ft[i], tgt_full=ft[j],
                                prior_T=tt(prior))
    assert tc.icp.pyramid == (4, 2, 1) and tc.icp.huber_delta == 0.01
    np.testing.assert_allclose(rt.transform.numpy(),
                               np.asarray(rj.transform), atol=1e-5)
    assert int(rt.iters) == int(rj.iters)


def test_kernel_inputs_refuse_cpu_tensors(frames):
    """The CUDA half of the wrappers refuses what the kernels do not take;
    CPU tensors never reach it (the plain versions run)."""
    src, cam = frames["ft"][1], frames["tc"].camera
    packed = ticp.pack_target(frames["ft"][0])
    with pytest.raises(ValueError, match="CUDA device"):
        ticp._kernel_inputs(torch.eye(4), src, packed, cam)


def test_module_imports_and_runs_without_nvcc(tmp_path):
    """No compiler is needed to import the module or to run its plain
    versions: nothing is built or bound until a CUDA tensor comes."""
    code = (
        "import os, sys, torch\n"
        "os.environ['PATH'] = ''\n"
        "os.environ.pop('CUDA_HOME', None)\n"
        "from voxelhashing_demo_tpu_torch import kernels\n"
        "from voxelhashing_demo_tpu_torch.ops import icp\n"
        "from voxelhashing_demo_tpu_torch.config import tiny_config\n"
        "from voxelhashing_demo_tpu_torch.ops import preprocess as pre\n"
        "cfg = tiny_config()\n"
        "f = pre.preprocess(torch.full((60, 80), 1500, dtype=torch.int32),"
        " cfg.camera, cfg.frontend)\n"
        "r = icp.icp_align(f, f, cfg.camera, cfg.icp)\n"
        "assert int(r.iters) >= 1 and not kernels._FUNCTIONS\n"
        "try:\n"
        "    kernels.nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": root, "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc"


def test_build_all_builds_the_icp_source_once(monkeypatch):
    """Both ICP kernels live in csrc/icp.cu: one nvcc job for it."""
    built = []
    monkeypatch.setattr(kernels, "build", lambda n: built.append(n) or n)
    monkeypatch.setattr(kernels, "build_host", lambda n: n)
    kernels.build_all()
    assert built.count("icp") == 1
    assert "icp_gn_level" not in built and "icp_sums" not in built
    assert (kernels.source_of("icp_gn_level")
            == kernels.source_of("icp_sums") == "icp")
    assert (kernels.SRC_DIR / "icp.cu").is_file()
