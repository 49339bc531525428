"""The whole keyframe backend of the PyTorch port against the JAX package.

Scenario (tests/torch_port_helpers.py, ``backend_*``): 24 frames of the
orbit sequence at 80x60 (rendered by the port's synthetic module on the
CPU, the same uint16 frames to both packages) through ``KeyframeSLAM`` under
the tiny flagship-gather configuration, with one drift injected into the
live pose before frame 12 (3 / 2 / 2 cm and 1.5 degrees).  The orbit returns
over itself, so loop edges, BA events, one full rebuild and several
incremental reintegrations all happen.

The gates decide with margin, and ``test_gates_decide_with_margin`` holds
the scenario to it: every candidate registration is at least 20 % away
from each acceptance threshold (inliers, error, observability), and every
keyframe decision at least 1 % from its motion thresholds (3e-4 m, 0.02
degrees; the packages' poses differ by ~1e-6 there).  The pyramid ICP
with fixed small iteration counts (8, 4, 2) is what keeps the two packages
together over 24 frames; the single-level 20-iteration ICP of
``tiny_config`` amplifies one inlier flip into 1e-3 m within a few frames.

Tolerances against JAX: keyframe frame indices, the edge list (i, j), BA
event frames, ``rebuild_mode``s, moved-entry counts, tracked flags and
capacity events equal; graph poses 1e-4; trajectory 1e-3 m per frame; ATE
within 1 mm.  The other settings of the backend are in
tests/test_torch_keyframe_variants.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import (BACKEND_DISCRETE, BACKEND_FRAMES,
                                BACKEND_INJECT_AT, assert_same_backend_run,
                                backend_config, backend_drive,
                                backend_frames, backend_inject,
                                backend_summary)

from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf
from voxelhashing_demo_tpu_torch.utils import metrics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return backend_frames()


@pytest.fixture(scope="module")
def base(frames):
    depths, gt = frames
    js, jt = backend_drive("jax", depths)
    gates = {"edge": [], "insert": []}
    cfg = backend_config("torch")
    slam = tkf.KeyframeSLAM(cfg, device="cpu")
    edge_ok, should = slam._edge_ok_np, slam._should_insert

    def edge_ok_rec(T, err, cnt, obs):
        gates["edge"].append((float(err), float(cnt), float(obs)))
        return edge_ok(T, err, cnt, obs)

    def should_rec(pose_np):
        if slam.keyframes:
            rel = np.linalg.inv(
                slam._poses_np[slam.keyframes[-1].index]) @ pose_np
            gates["insert"].append((tkf._rot_deg_np(rel),
                                    float(np.linalg.norm(rel[:3, 3]))))
        return should(pose_np)

    slam._edge_ok_np, slam._should_insert = edge_ok_rec, should_rec
    for i, d in enumerate(depths):
        if i == BACKEND_INJECT_AT:
            backend_inject("torch", slam)
        slam.process(d)
    return dict(js=js, jt=jt, ts=slam, tt=slam.trajectory(), gt=gt,
                gates=gates)


def test_discrete_decisions_equal_jax(base):
    a = backend_summary(base["js"], base["jt"], base["gt"])
    b = backend_summary(base["ts"], base["tt"], base["gt"])
    for k in BACKEND_DISCRETE:
        assert a[k] == b[k], (k, a[k], b[k])
    # the scenario exercises what it is meant to
    assert len(b["keyframe_frames"]) >= 10
    assert any(j - i > 1 for i, j in b["edges"])
    modes = [m for m in b["ba_modes"] if m]
    assert modes[0] == "full" and "incremental" in modes[1:]
    assert sum(b["moved"]) > 0
    assert b["tracked"] == [False] + [True] * (BACKEND_FRAMES - 1)


def test_graph_and_trajectory_match_jax(base):
    assert_same_backend_run(base["js"], base["jt"], base["ts"], base["tt"],
                     base["gt"])
    ts = base["ts"]
    n = ts._n_poses
    assert (ts.graph.num_poses, ts.graph.num_edges) == (n, ts._n_edges)
    np.testing.assert_allclose(ts.graph.poses[:n].numpy(), ts._poses_np[:n],
                               atol=1e-6)
    kt = ts.keyframe_trajectory()
    assert len(kt) == len(ts.keyframes)
    np.testing.assert_array_equal(kt[-1], ts._poses_np[n - 1])


def test_backend_beats_frontend_on_injected_drift(base, frames):
    from voxelhashing_demo_tpu_torch.models import hash_slam

    depths, gt = frames
    front = hash_slam.HashSLAM(backend_config("torch"), device="cpu")
    for i, d in enumerate(depths):
        if i == BACKEND_INJECT_AT:
            backend_inject("torch", front)
        front.process(d)
    # frame-to-model tracking pulls most of this small drift back by
    # itself (the model did not move), so the backend's gain is small here;
    # chip_smoke.py shows the large one at full size
    ate_front = metrics.ate_rmse(front.trajectory, gt, align=False)
    ate_back = metrics.ate_rmse(base["tt"], gt, align=False)
    assert ate_back < ate_front, (ate_back, ate_front)


def test_ba_events_have_the_jax_keys(base):
    for ej, et in zip(base["js"].ba_events, base["ts"].ba_events):
        assert set(ej) == set(et), set(ej) ^ set(et)
        if "rebuild_detail" in ej:
            assert set(ej["rebuild_detail"]) == set(et["rebuild_detail"])
        for k, atol in (("chi2_initial", 1e-6), ("chi2_final", 1e-6),
                        ("correction_trans_m", 1e-4),
                        ("correction_rot_deg", 1e-2)):
            np.testing.assert_allclose(et[k], ej[k], rtol=2e-2, atol=atol,
                                       err_msg=k)
        assert (et["keyframes"], et["edges"]) == (ej["keyframes"],
                                                  ej["edges"])


def test_gates_decide_with_margin(base):
    k = backend_config("torch").keyframes
    for err, cnt, obs in base["gates"]["edge"]:
        assert abs(cnt - k.min_loop_inliers) > 0.2 * k.min_loop_inliers
        assert abs(err - k.max_loop_error) > 0.2 * k.max_loop_error
        assert abs(obs - k.min_loop_obs) > 0.2 * k.min_loop_obs
    assert len(base["gates"]["edge"]) > 30
    for rot, trans in base["gates"]["insert"]:
        inserted = rot > k.min_rotation_deg or trans > k.min_translation
        if inserted:
            assert (rot > 1.01 * k.min_rotation_deg
                    or trans > 1.01 * k.min_translation), (rot, trans)
        else:
            assert (rot < 0.99 * k.min_rotation_deg
                    and trans < 0.99 * k.min_translation), (rot, trans)


def test_ledger_and_ring_state(base):
    js, ts = base["js"], base["ts"]
    assert ts._map_ledgered and not ts._ring_overflow
    assert ts._map_epoch == js._map_epoch == 1
    assert len(ts._ring) == len(js._ring)
    assert [e.frame_index for e in ts._ring] == [e.frame_index
                                                 for e in js._ring]
    for et, ej in zip(ts._ring, js._ring):
        np.testing.assert_allclose(et.map_pose, ej.map_pose, atol=1e-3)
    assert ([r.map_pose is None for r in ts.keyframes]
            == [r.map_pose is None for r in js.keyframes])
    rec = ts.keyframes[0]
    assert rec.depth_np().dtype == np.uint16
    np.testing.assert_array_equal(
        rec.depth_np(), np.asarray(js.keyframes[0].depth_np()))


def test_kf_async_stays_off_per_closure(base):
    """A per-closure configuration (ba_defer 1 / 0) keeps inserts
    synchronous even with the flag on (it is on by default)."""
    assert backend_config("torch").keyframes.kf_async_edges
    assert not base["ts"]._kf_pending


def test_settle_lands_without_forcing_ba(frames):
    depths, _ = frames
    cfg = backend_config("torch", ba_defer_edges=999, sync_every=4)
    slam = tkf.KeyframeSLAM(cfg, device="cpu")
    for d in depths[:10]:
        slam.process(d)
    assert slam._pending
    slam.settle()
    assert not slam._pending and not slam._kf_pending
    assert slam._pending_ba_edges > 0 and not slam.ba_events
    slam.flush()
    assert slam._pending_ba_edges == 0 and len(slam.ba_events) == 1


def test_warm_compile_leaves_the_state_alone(frames):
    depths, _ = frames
    cfg = backend_config("torch")
    slam = tkf.KeyframeSLAM(cfg, device="cpu")
    before = {f: getattr(slam.state.hmap, f).clone()
              for f in slam.state.hmap._fields}
    slam.warm_compile(depths[0])
    for f, v in before.items():
        assert torch.equal(getattr(slam.state.hmap, f), v), f
    assert slam._frame_idx == 0 and not slam.keyframes and not slam.infos
    assert slam.graph.num_poses == 0 and slam._n_poses == 0
    assert torch.equal(slam.state.pose, torch.eye(4))
    # and a warmed instance runs the same run
    for d in depths[:6]:
        slam.process(d)
    cold = tkf.KeyframeSLAM(cfg, device="cpu")
    for d in depths[:6]:
        cold.process(d)
    for a, b in zip(slam.trajectory(), cold.trajectory()):
        np.testing.assert_array_equal(a, b)


def test_unsupported_options_raise(frames):
    """A mesh builds the sharded driver: on a one-rank mesh it decides as
    the JAX package's ``KeyframeSLAM(mesh=make_mesh(1))`` over the first 8
    frames (two ranks: tests/test_torch_sharded_backend.py; the sharded
    ICP pools the source by minimum where one device averages, so a mesh
    does not decide as one device).  A streaming configuration builds a
    streaming driver, on one device and over a mesh (two streaming ranks
    against JAX: tests/test_torch_sharded_streaming.py)."""
    import jax.numpy as jnp

    from voxelhashing_demo_tpu.models import keyframe_slam as jkf
    from voxelhashing_demo_tpu.parallel import sharded as jsharded
    from voxelhashing_demo_tpu_torch.parallel import launch, ranks

    depths = [np.asarray(d) for d in frames[0]][:8]
    cfg = backend_config("torch")
    (one,) = launch.spawn(ranks.run_keyframe, 1, None, "cpu", 300, cfg,
                          depths)
    jcfg = backend_config("jax")
    jcfg = dataclasses.replace(
        jcfg, hash=dataclasses.replace(jcfg.hash, use_pallas_gather=False))
    js = jkf.KeyframeSLAM(jcfg, mesh=jsharded.make_mesh(1))
    for d in depths:
        js.process(jnp.asarray(d))
    traj = js.trajectory()
    assert one["keyframe_frames"] == [r.frame_index for r in js.keyframes]
    assert one["tracked"] == [bool(i.tracked) for i in js.infos]
    np.testing.assert_allclose(one["trajectory"][:, :3, 3],
                               np.stack(traj)[:, :3, 3], atol=1e-4)
    streaming = dataclasses.replace(
        cfg, stream=dataclasses.replace(cfg.stream, enabled=True))
    assert tkf.KeyframeSLAM(streaming, device="cpu")._inner.store is not None
    # streaming over a mesh (nothing ages out in 8 frames: the same run)
    (st,) = launch.spawn(ranks.run_keyframe, 1, None, "cpu", 300, streaming,
                         depths)
    assert st["keyframe_frames"] == one["keyframe_frames"]
    np.testing.assert_array_equal(st["trajectory"], one["trajectory"])


def test_default_device_is_the_card():
    """Without a device the backend goes to the CUDA card and, here where
    there is none, raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to raise")
    with pytest.raises((RuntimeError, AssertionError)):
        tkf.KeyframeSLAM(backend_config("torch"))
