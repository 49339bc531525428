"""PyTorch port of ops/icp.py against the JAX package on the same
preprocessed 80x60 frames (frame 1 of the 10-frame orbit sequence
registered to frame 0), flagship ICP settings.

Tolerances: the octahedral bf16 normal packing is bit-exact; its decode
agrees within 1e-6 (the normalization differs in the last ulp); association
masks are equal; the 6x6 system agrees within rtol 1e-4 (float sums over
~4k pixels in another order); final transforms within 1e-5.  The
backend's additions (the matched target points of ``associate``,
``observability``, the batched pair ICP) state theirs in the tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_sequence, tiny_flagship_gather_config, tt

from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import icp as jicp
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch.ops import icp as ticp
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

# the JAX side runs jitted (one compile per function, not per primitive)
J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_ASSOC = jax.jit(jicp.associate, static_argnums=(3, 4))
J_SYSTEM = jax.jit(jicp.build_normal_system, static_argnums=(4,))
J_SOLVE = jax.jit(jicp.solve_normal_system, static_argnums=(1,))
J_SCORE = jax.jit(jicp.alignment_score_sums, static_argnums=(3, 4))
J_PYRAMID = jax.jit(jicp.icp_align_pyramid, static_argnums=(2, 3))


@pytest.fixture(scope="module")
def setup():
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, _ = jax_sequence(jc.camera, 10)
    src_j = J_PRE(jnp.asarray(depths[1]), jc.camera, jc.frontend)
    tgt_j = J_PRE(jnp.asarray(depths[0]), jc.camera, jc.frontend)

    def port(f):
        return tpre.Frame(*(tt(x) for x in f))

    return dict(jc=jc, tc=tc, src_j=src_j, tgt_j=tgt_j, src_t=port(src_j),
                tgt_t=port(tgt_j), depths=depths)


def _T(seed):
    xi = np.random.default_rng(seed).normal(size=6).astype(np.float32) * 0.01
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def test_oct_codec_and_pack_target(setup):
    rng = np.random.default_rng(0)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:5] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0], [0, 0, 0]]
    bj = np.asarray(jicp.oct_encode_bits(jnp.asarray(n)))
    bt = ticp.oct_encode_bits(tt(n)).numpy()
    np.testing.assert_array_equal(bt.view(np.int32), bj.view(np.int32))
    np.testing.assert_allclose(
        ticp.oct_decode_bits(tt(bj)).numpy(),
        np.asarray(jicp.oct_decode_bits(jnp.asarray(bj))), atol=1e-6)
    pj = np.asarray(jicp.pack_target(setup["tgt_j"]))
    pt = ticp.pack_target(setup["tgt_t"]).numpy()
    np.testing.assert_array_equal(pt.view(np.int32), pj.view(np.int32))


def test_associate_and_normal_system(setup):
    jc, tc = setup["jc"], setup["tc"]
    T = _T(1)
    pj, nj, rj, vj = J_ASSOC(jnp.asarray(T), setup["src_j"],
                                    setup["tgt_j"], jc.camera, jc.icp)
    pt, nt, rt, vt = ticp.associate(tt(T), setup["src_t"], setup["tgt_t"],
                                    tc.camera, tc.icp)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.sum() > 500
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
    sj = J_SYSTEM(pj, nj, rj, vj, jc.icp.huber_delta)
    st = ticp.build_normal_system(tt(np.asarray(pj)), tt(np.asarray(nj)),
                                  tt(np.asarray(rj)), tt(np.asarray(vj)),
                                  tc.icp.huber_delta)
    for name in ("JTJ", "JTr", "error", "count"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    dj = np.asarray(J_SOLVE(sj, jc.icp.damping))
    dt = ticp.solve_normal_system(
        ticp.NormalSystem(*(tt(np.asarray(x)) for x in sj)),
        tc.icp.damping).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-7)


def test_empty_system_gives_zero_update():
    z = np.zeros((6, 6), np.float32)
    sys_t = ticp.NormalSystem(JTJ=tt(z), JTr=tt(np.zeros(6, np.float32)),
                              error=tt(np.float32(0)),
                              count=tt(np.float32(0)))
    assert (ticp.solve_normal_system(sys_t, 1e-6).numpy() == 0).all()


@pytest.mark.parametrize("init_seed", [None, 2])
def test_icp_align(setup, init_seed):
    jc, tc = setup["jc"], setup["tc"]
    cfg_j = dataclasses.replace(jc.icp, max_iters=8)
    cfg_t = dataclasses.replace(tc.icp, max_iters=8)
    init = None if init_seed is None else _T(init_seed)
    rj = jicp.icp_align(setup["src_j"], setup["tgt_j"], jc.camera, cfg_j,
                        init_T=None if init is None else jnp.asarray(init))
    rt = ticp.icp_align(setup["src_t"], setup["tgt_t"], tc.camera, cfg_t,
                        init_T=None if init is None else tt(init))
    assert int(rt.iters) == int(rj.iters)
    np.testing.assert_allclose(rt.transform.numpy(),
                               np.asarray(rj.transform), atol=1e-5)
    np.testing.assert_allclose(float(rt.count), float(rj.count), rtol=1e-3)
    np.testing.assert_allclose(rt.JTJ.numpy(), np.asarray(rj.JTJ),
                               rtol=1e-3, atol=1e-4)


def test_score_pick_and_motion_gate(setup):
    jc, tc = setup["jc"], setup["tc"]
    T = _T(3)
    nj, dj = J_SCORE(jnp.asarray(T), setup["src_j"],
                                       setup["tgt_j"], jc.camera, jc.icp)
    nt, dt = ticp.alignment_score_sums(tt(T), setup["src_t"],
                                       setup["tgt_t"], tc.camera, tc.icp)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-4)
    assert float(dt) == float(dj)
    a = ticp.ICPResult(tt(T), tt(np.float32(1)), tt(np.float32(2)),
                       torch.tensor(3, dtype=torch.int32), tt(np.eye(6, dtype=np.float32)))
    b = ticp.ICPResult(tt(np.eye(4, dtype=np.float32)), tt(np.float32(4)),
                       tt(np.float32(5)), torch.tensor(6, dtype=torch.int32),
                       tt(np.zeros((6, 6), np.float32)))
    assert int(ticp.pick_by_score(a, b, tt(np.float32(0.1)),
                                  tt(np.float32(0.2))).iters) == 3
    assert int(ticp.pick_by_score(a, b, tt(np.float32(0.2)),
                                  tt(np.float32(0.2))).iters) == 6
    bad = a._replace(transform=a.transform * float("nan"))
    assert int(ticp.pick_by_score(bad, b, tt(np.float32(0.1)),
                                  tt(np.float32(0.2))).iters) == 6
    for xi in ([0.1, 0, 0, 0, 0, 0], [0.31, 0, 0, 0, 0, 0],
               [0, 0, 0, 0, 0.43, 0], [0, 0, 0, 0, 0.45, 0]):
        Tm = np.asarray(jse3.exp(jnp.asarray(xi, jnp.float32)))
        assert (bool(ticp.motion_plausible(tt(Tm), tc.icp))
                == bool(jicp.motion_plausible(jnp.asarray(Tm), jc.icp)))


def test_icp_align_pyramid_with_prior(setup):
    jc, tc = setup["jc"], setup["tc"]
    prior = _T(4)
    rj = J_PYRAMID(
        setup["src_j"].depth, setup["tgt_j"].depth, jc.camera, jc.icp,
        src_full=setup["src_j"], tgt_full=setup["tgt_j"],
        prior_T=jnp.asarray(prior))
    rt = ticp.icp_align_pyramid(
        setup["src_t"].depth, setup["tgt_t"].depth, tc.camera, tc.icp,
        src_full=setup["src_t"], tgt_full=setup["tgt_t"], prior_T=tt(prior))
    np.testing.assert_allclose(rt.transform.numpy(),
                               np.asarray(rj.transform), atol=1e-5)
    assert int(rt.iters) == int(rj.iters)


def test_associate_with_points(setup):
    """The fifth return, the matched target vertex map: 1e-6 against JAX
    (the same ray formula on the same gathered depth)."""
    jc, tc = setup["jc"], setup["tc"]
    T = _T(5)
    out_j = jax.jit(jicp.associate, static_argnums=(3, 4),
                    static_argnames=("with_points",))(
        jnp.asarray(T), setup["src_j"], setup["tgt_j"], jc.camera, jc.icp,
        with_points=True)
    out_t = ticp.associate(tt(T), setup["src_t"], setup["tgt_t"], tc.camera,
                           tc.icp, with_points=True)
    assert len(out_t) == len(out_j) == 5
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]),
                               atol=1e-6)
    assert len(ticp.associate(tt(T), setup["src_t"], setup["tgt_t"],
                              tc.camera, tc.icp)) == 4


def _wall_pair(cam_j, cam_t):
    """A flat wall seen from two poses 5 cm apart along the wall, rendered
    by the port on the CPU; preprocessed by each package."""
    from voxelhashing_demo_tpu_torch.utils import synthetic

    def flat_sdf(p):
        return 2.0 - p[..., 2]

    T1 = np.asarray(jse3.exp(jnp.asarray(
        np.array([0.05, 0, 0, 0, 0, 0], np.float32))))
    raws = [synthetic.depth_to_raw(synthetic.render_depth(
        tt(T), cam_t, sdf=flat_sdf), cam_t)
        for T in (np.eye(4, dtype=np.float32), T1)]
    pre = jax.jit(jpre.preprocess, static_argnums=(1,))
    return ([pre(jnp.asarray(r), cam_j) for r in raws],
            [tpre.preprocess(tt(r.astype(np.int32)), cam_t) for r in raws],
            T1)


def test_observability_wall_vs_structure(setup):
    """``observability`` against JAX on a sliding-degenerate wall (~0) and
    on the structured orbit pair (>= 1e-2): rtol 1e-3 on the structured
    value, atol 1e-6 on the wall's."""
    from voxelhashing_demo_tpu.config import tiny_config as jtiny
    from voxelhashing_demo_tpu_torch.config import tiny_config as ttiny

    jcfg, tcfg = jtiny(), ttiny()
    (g0j, g1j), (g0t, g1t), T1 = _wall_pair(jcfg.camera, tcfg.camera)
    rj = jicp.icp_align(g1j, g0j, jcfg.camera, jcfg.icp,
                        init_T=jnp.asarray(T1))
    rt = ticp.icp_align(g1t, g0t, tcfg.camera, tcfg.icp, init_T=tt(T1))
    obs_j, obs_t = float(jicp.observability(rj)), float(
        ticp.observability(rt))
    assert float(rt.count) > 1000
    assert obs_t < 1e-4
    np.testing.assert_allclose(obs_t, obs_j, atol=1e-6)

    # the structured pair of tests/test_loop_gating.py: two orbit frames,
    # plain (unweighted) ICP started at the true relative pose
    from voxelhashing_demo_tpu_torch.utils import synthetic

    depths, poses = synthetic.make_sequence(tcfg.camera, 2, trans_amp=0.06,
                                            rot_amp_deg=3.0, device="cpu")
    init = (np.linalg.inv(np.asarray(poses[0]))
            @ np.asarray(poses[1])).astype(np.float32)
    pre = jax.jit(jpre.preprocess, static_argnums=(1,))
    f0j, f1j = (pre(jnp.asarray(d), jcfg.camera) for d in depths)
    f0t, f1t = (tpre.preprocess(tt(d.astype(np.int32)), tcfg.camera)
                for d in depths)
    sj = jicp.icp_align(f1j, f0j, jcfg.camera, jcfg.icp,
                        init_T=jnp.asarray(init))
    st = ticp.icp_align(f1t, f0t, tcfg.camera, tcfg.icp, init_T=tt(init))
    s_j, s_t = float(jicp.observability(sj)), float(ticp.observability(st))
    assert s_t > 1e-2
    assert s_t > 100 * max(obs_t, 1e-12)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-3)
    # a batch of JTJ stacks: the last axes are the matrix
    stacked = ticp.ICPResult(*(torch.stack([a, b])
                               for a, b in zip(rt, st)))
    np.testing.assert_allclose(ticp.observability(stacked).numpy(),
                               [obs_t, s_t], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_batched_pair_icp_lane_for_lane(setup, direction):
    """The port's candidate batch against the JAX package's vmapped pair
    ICP (padded to width 4 there with zero frames and identity starts,
    whose lanes the port never runs): every real lane equals the unbatched
    ``icp_align`` on that pair, iteration count included; transforms 1e-5,
    counts equal, error and observability rtol 1e-3.  The lanes stop at
    different iteration counts (frozen lanes in the vmapped loop)."""
    from voxelhashing_demo_tpu.models import keyframe_slam as jkf

    jc, tc = setup["jc"], setup["tc"]
    depths = setup["depths"]
    small_j, small_t = setup["src_j"], setup["src_t"]
    cands_j = [J_PRE(jnp.asarray(depths[i]), jc.camera, jc.frontend)
               for i in (0, 2, 5)]
    cands_t = [tpre.Frame(*(tt(x) for x in f)) for f in cands_j]
    inits = [_T(10 + i) for i in range(3)]
    icfg_j = dataclasses.replace(jc.icp, max_iters=10)
    icfg_t = dataclasses.replace(tc.icp, max_iters=10)

    fwd, rev = jkf._make_batch_icps(jc.camera, jc.icp, 10)
    zero = jpre.Frame(*(jnp.zeros_like(x) for x in small_j))
    frames = tuple(cands_j) + (zero,)
    inits_j = jnp.asarray(np.stack(inits + [np.eye(4, dtype=np.float32)]))
    out_j = np.asarray(fwd(small_j, frames, inits_j) if direction == "fwd"
                       else rev(frames, small_j, inits_j))
    # the pad lane solves to identity in the JAX batch
    np.testing.assert_allclose(out_j[3, :16].reshape(4, 4), np.eye(4),
                               atol=1e-6)

    smalls = [small_t] * 3
    srcs, tgts = ((smalls, cands_t) if direction == "fwd"
                  else (cands_t, smalls))
    out_t = ticp.icp_align_batch(srcs, tgts, tc.camera, icfg_t,
                                 [tt(T) for T in inits]).numpy()
    assert out_t.shape == (3, 19)
    np.testing.assert_allclose(out_t[:, :16], out_j[:3, :16], atol=1e-5)
    np.testing.assert_array_equal(out_t[:, 17], out_j[:3, 17])
    np.testing.assert_allclose(out_t[:, 16], out_j[:3, 16], rtol=1e-3)
    np.testing.assert_allclose(out_t[:, 18], out_j[:3, 18], rtol=1e-3)

    iters = []
    for lane in range(3):
        s_j, t_j = ((small_j, cands_j[lane]) if direction == "fwd"
                    else (cands_j[lane], small_j))
        one_j = jicp.icp_align(s_j, t_j, jc.camera, icfg_j,
                               init_T=jnp.asarray(inits[lane]))
        one_t = ticp.icp_align(srcs[lane], tgts[lane], tc.camera, icfg_t,
                               init_T=tt(inits[lane]))
        assert int(one_t.iters) == int(one_j.iters)
        iters.append(int(one_t.iters))
        np.testing.assert_array_equal(
            ticp.pack_result(one_t).numpy(), out_t[lane])
        np.testing.assert_allclose(np.asarray(one_j.transform).reshape(16),
                                   out_j[lane, :16], atol=1e-6)
    assert len(set(iters)) > 1, iters
