"""Out-of-core streaming in the PyTorch port (the streaming ``HashSLAM``,
its cycle, the rebuild spill, and ``KeyframeSLAM`` on a streaming map)
against the JAX package.

The scenario (tests/torch_port_helpers.py): the tiny flagship-gather
configuration cut to 1024 device blocks, streaming every 2 frames with
eviction at age 6, on a noise-free 90-degree room pan out and back (39
frames at 80x60).  The heap runs out on the way out and the way back
restores what was evicted.

Tolerances:
- With the JAX poses fed to both packages (a step that fuses at a given
  pose and velocity), after EVERY frame: the map's integer state (keys,
  ptrs, bucket_fill, free_list, free_top, last_seen, born) and the store's
  keys, row layout, free rows and counters are equal; of the map and store
  payload (tsdf, weight) and band_min at least 99.9 % of the entries agree
  within 1e-5 (as in tests/test_torch_slice.py: a rounding difference moves
  the odd voxel's projection onto the neighbouring pixel).
- On their own poses: positions within 1e-4 m for the first 8 frames,
  then looser (see ``test_own_poses_track_as_jax``: the frame step's own
  float drift, not streaming).
- ``process_chunk`` with the fed poses: as the first item, chunk by chunk.
- A state carried mid-cycle from JAX into both packages continues as above.
- ``spill_finish_async`` leaves the same store and map as ``spill_finish``
  (port only, bit for bit).
- ``KeyframeSLAM`` on a streaming map (the keyframe parity scenario of
  tests/test_torch_keyframe_slam.py with streaming on): the same
  keyframes, edges, BA events, map-update modes, moved counts, tracked
  flags and store counters as JAX; graph poses within 1e-4, trajectory
  within 1e-3 m.  A streaming incremental move matches a from-scratch fuse at the
  corrected poses (the JAX test's own bound: median depth difference below
  one voxel on > 40 % shared pixels).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (BACKEND_INJECT_AT, assert_same_backend_run,
                                backend_config, backend_frames,
                                backend_inject, jax_stream_from_numpy,
                                jax_stream_state, np_tree, stream_config,
                                stream_frames)

from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.utils import metrics as jmetrics
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.models import hash_slam as ths
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre
from voxelhashing_demo_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
              "last_seen", "born")
FLOAT_FIELDS = ("tsdf", "weight", "band_min")
CUT = 24    # the carried state: after frame 23's completion, mid-cycle
OWN_EXACT = 8   # own-pose frames held to 1e-4 m (see test_own_poses_...)


# --------------------------------------------------------------------------
# a frame step that fuses at a given pose (both packages)
# --------------------------------------------------------------------------

def _jax_fed_step(cfg):
    def fed(state, depth_raw, pose, vel):
        frame = jpre.preprocess(depth_raw, cfg.camera, cfg.frontend)
        gc = cfg.gc
        hmap, n_freed = jax.lax.cond(
            state.frame_idx % gc.interval == gc.interval - 1,
            lambda m: jho.garbage_collect(
                m, cfg.hash, gc.min_weight, gc.max_blocks_per_gc,
                frame_idx=state.frame_idx, min_age=gc.min_age),
            lambda m: (m, jnp.int32(0)), state.hmap)
        hmap, active, n_alloc = jho.fuse_frame(
            hmap, frame, pose, cfg.camera, cfg.hash, cfg.fusion,
            frame_idx=state.frame_idx)
        z = jnp.int32(0)
        info = jhs.StepInfo(pose=pose, icp_error=jnp.float32(0),
                            icp_count=z, icp_iters=z, tracked=True,
                            blocks_allocated=n_alloc,
                            blocks_active=active.count, blocks_freed=n_freed,
                            free_blocks=hmap.free_top, valid_px=z)
        return state._replace(hmap=hmap, pose=pose, vel=vel,
                              frame_idx=state.frame_idx + 1), info

    return jax.jit(fed)


def _torch_fed_step(feed):
    def fed(state, depth_raw, cfg):
        pose, vel = (torch.from_numpy(a.copy()) for a in next(feed))
        frame = tpre.preprocess(depth_raw, cfg.camera, cfg.frontend)
        hmap, n_freed = state.hmap, torch.zeros((), dtype=torch.int32)
        gc = cfg.gc
        if state.frame_idx % gc.interval == gc.interval - 1:
            hmap, n_freed = tho.garbage_collect(
                hmap, cfg.hash, gc.min_weight, gc.max_blocks_per_gc,
                frame_idx=state.frame_idx, min_age=gc.min_age)
        hmap, active, n_alloc = tho.fuse_frame(
            hmap, frame, pose, cfg.camera, cfg.hash, cfg.fusion,
            frame_idx=state.frame_idx)
        z = torch.zeros((), dtype=torch.int32)
        info = ths.StepInfo(pose=pose, icp_error=z.float(), icp_count=z,
                            icp_iters=z, tracked=torch.tensor(True),
                            blocks_allocated=n_alloc,
                            blocks_active=active.count, blocks_freed=n_freed,
                            free_blocks=hmap.free_top.clone(), valid_px=z)
        return state._replace(hmap=hmap, pose=pose, vel=vel,
                              frame_idx=state.frame_idx + 1), info

    return fed


def _snapshot(hmap: dict, store) -> dict:
    n = store._n
    return dict(map=hmap, n=n, keys=store._keys[:n].copy(),
                free=list(store._free), index=dict(store._index),
                tsdf=store._tsdf[:n].copy(), weight=store._weight[:n].copy(),
                born=store._born[:n].copy(),
                counters=(store.total_evicted, store.total_restored,
                          len(store)))


def _jax_snapshot(slam):
    slam._join_complete()     # the completion runs on a worker thread
    return _snapshot(np_tree(slam.state.hmap), slam.store)


def _torch_snapshot(slam):
    return _snapshot(convert.hashmap_to_numpy(slam.state.hmap), slam.store)


def _assert_same(a: dict, b: dict, what: str) -> None:
    for f in INT_FIELDS:
        np.testing.assert_array_equal(a["map"][f], b["map"][f],
                                      err_msg=f"{what} map.{f}")
    for f in FLOAT_FIELDS:
        _assert_mostly_close(a["map"][f], b["map"][f], f"{what} map.{f}")
    assert a["n"] == b["n"], what
    np.testing.assert_array_equal(a["keys"], b["keys"], err_msg=what)
    np.testing.assert_array_equal(a["born"], b["born"], err_msg=what)
    assert a["free"] == b["free"] and a["index"] == b["index"], what
    assert a["counters"] == b["counters"], what
    for f in ("tsdf", "weight"):
        _assert_mostly_close(a[f], b[f], f"{what} store.{f}")


def _assert_mostly_close(x, y, what: str) -> None:
    """At least 99.9 % of the entries within 1e-5 (inf equal to inf)."""
    if x.size == 0:
        return
    close = np.isclose(x, y, rtol=0.0, atol=1e-5)
    assert close.mean() >= 0.999, (what, close.mean())


def _feed(traj):
    """(pose, velocity) per frame from a trajectory, float32 numpy."""
    out, prev = [], np.eye(4, dtype=np.float32)
    for T in traj:
        T = np.asarray(T, np.float32)
        out.append((T, (np.linalg.inv(prev) @ T).astype(np.float32)))
        prev = T
    return out


@pytest.fixture(scope="module")
def scenario():
    depths, gt = stream_frames()
    jc, tc = stream_config("jax"), stream_config("torch")
    # each package on its own poses
    jown = jhs.HashSLAM(jc)
    for d in depths:
        jown.process(d)
    jown._join_complete()
    town = ths.HashSLAM(tc, device="cpu")
    for d in depths:
        town.process(d)
    feed = _feed(jown.trajectory)

    # both packages fed the JAX poses, snapshots after every frame
    jfed_step = _jax_fed_step(jc)
    jfed = jhs.HashSLAM(jc)
    jsnaps, carried = [], None
    for i, d in enumerate(depths):
        pose, vel = feed[i]
        jfed._step = (lambda s, x, p=pose, v=vel:
                      jfed_step(s, x, jnp.asarray(p), jnp.asarray(v)))
        jfed.process(d)
        jsnaps.append(_jax_snapshot(jfed))
        if i + 1 == CUT:
            carried = jax_stream_state(jfed)
    return dict(depths=depths, gt=gt, jc=jc, tc=tc, jown=jown, town=town,
                feed=feed, jfed_step=jfed_step, jsnaps=jsnaps,
                carried=carried)


def _run_fed(slam, depths, feed, start=0):
    """Drive a port HashSLAM with the fed step; snapshot after every
    frame."""
    it = iter(feed[start:])
    real = ths.step
    ths.step = _torch_fed_step(it)
    try:
        snaps = []
        for d in depths[start:]:
            slam.process(d)
            snaps.append(_torch_snapshot(slam))
    finally:
        ths.step = real
    return snaps


def test_fed_poses_map_and_store_equal_every_frame(scenario):
    s = scenario
    tfed = ths.HashSLAM(s["tc"], device="cpu")
    tsnaps = _run_fed(tfed, s["depths"], s["feed"])
    for i, (a, b) in enumerate(zip(s["jsnaps"], tsnaps)):
        _assert_same(a, b, f"frame {i}")
    ev, rs, n = s["jsnaps"][-1]["counters"]
    assert ev > s["tc"].hash.num_blocks // 2 and rs > 100, (ev, rs, n)


def test_own_poses_track_as_jax(scenario):
    """Each package on its own tracking.  Positions agree within 1e-4 m
    for the first OWN_EXACT frames; after that the frame step's own float
    drift (which the non-streaming runs show as well, with the same ICP
    counts and iterations in both packages) grows, so the whole run is held
    to the same tracked flags on all but one frame and, on the frames
    whose flags agree, positions within 2 cm and unaligned ATE within
    5 mm; store counters and size within 2 % (before the final sync,
    whose restore follows the last frame's pose)."""
    s = scenario
    jown, town = s["jown"], s["town"]
    jt = [bool(i.tracked) for i in jown.infos]
    tt_ = [bool(i.tracked) for i in town.infos]
    assert sum(a != b for a, b in zip(jt, tt_)) <= 1
    for i, (jp, tp) in enumerate(zip(jown.trajectory, town.trajectory)):
        if jt[i] != tt_[i]:
            continue
        tol = 1e-4 if i < OWN_EXACT else 2e-2
        np.testing.assert_allclose(tp.numpy()[:3, 3], np.asarray(jp)[:3, 3],
                                   atol=tol, err_msg=f"frame {i}")
    same = [i for i in range(len(jt)) if jt[i] == tt_[i]]
    gt = [s["gt"][i] for i in same]
    ate_j = jmetrics.ate_rmse([jown.trajectory[i] for i in same], gt,
                              align=False)
    ate_t = tmetrics.ate_rmse([town.trajectory[i] for i in same], gt,
                              align=False)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)
    for a, b in ((jown.store.total_evicted, town.store.total_evicted),
                 (jown.store.total_restored, town.store.total_restored),
                 (len(jown.store), len(town.store))):
        assert abs(a - b) <= 0.02 * a, (a, b)
    # the heap ran out: the scene is beyond the device map
    assert min(int(i.free_blocks) for i in town.infos) == 0
    dev = {int(k) for k in town.state.hmap.keys.numpy()
           if k != tho.EMPTY_KEY}
    assert len(dev | set(town.store._index)) > s["tc"].hash.num_blocks


def test_carried_mid_cycle_state_continues_as_jax(scenario):
    """The JAX state after frame CUT (a prefetch and evicted rows pending)
    carried into both packages by convert's layout; both continue on the
    fed poses and agree after every frame."""
    s = scenario
    d = s["carried"]
    assert d["prefetch.keys"].size and d["pending_evict.keys"].size
    jslam = jax_stream_from_numpy(d, s["jc"])
    tslam = convert.stream_state_from_numpy(d, s["tc"], device="cpu")
    back = convert.stream_state_to_numpy(tslam)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    tsnaps = _run_fed(tslam, s["depths"], s["feed"], start=CUT)
    for i in range(CUT, len(s["depths"])):
        pose, vel = s["feed"][i]
        jslam._step = (lambda st, x, p=pose, v=vel: s["jfed_step"](
            st, x, jnp.asarray(p), jnp.asarray(v)))
        jslam.process(s["depths"][i])
        _assert_same(_jax_snapshot(jslam), tsnaps[i - CUT], f"frame {i}")


def test_process_chunk_matches_jax(scenario):
    """Chunks of 3 frames (one cycle per chunk, restore horizon 3 +
    interval) over the first 18 frames, then 4 frames through ``process``,
    both packages fed the JAX poses: map and store equal after every
    chunk and frame."""
    s = scenario
    depths, feed = s["depths"], s["feed"]
    fed = s["jfed_step"]
    scan = jax.jit(lambda st, ds, ps, vs: jax.lax.scan(
        lambda c, x: fed(c, *x), st, (ds, ps, vs)))
    jslam = jhs.HashSLAM(s["jc"])
    tslam = ths.HashSLAM(s["tc"], device="cpu")
    it = iter(feed)
    real = ths.step
    ths.step = _torch_fed_step(it)
    try:
        for k in range(0, 18, 3):
            ps = jnp.asarray(np.stack([p for p, _ in feed[k:k + 3]]))
            vs = jnp.asarray(np.stack([v for _, v in feed[k:k + 3]]))
            jslam._scan_step = (lambda st, ds, ps=ps, vs=vs:
                                scan(st, ds, ps, vs))
            jslam.process_chunk(jnp.stack([jnp.asarray(x)
                                           for x in depths[k:k + 3]]))
            ti = tslam.process_chunk(np.stack(depths[k:k + 3]))
            assert ti.pose.shape == (3, 4, 4)
            _assert_same(_jax_snapshot(jslam), _torch_snapshot(tslam),
                         f"chunk at {k}")
        for i in range(18, 22):
            pose, vel = feed[i]
            jslam._step = (lambda st, x, p=pose, v=vel: fed(
                st, x, jnp.asarray(p), jnp.asarray(v)))
            jslam.process(depths[i])
            tslam.process(depths[i])
            _assert_same(_jax_snapshot(jslam), _torch_snapshot(tslam),
                         f"frame {i}")
    finally:
        ths.step = real
    assert jslam.store.total_evicted > 0


def test_spill_finish_async_matches_sync(scenario):
    """A rebuild-style spill session (fuse, evict into the spill after
    every frame) landed by spill_finish_async and by spill_finish: the same
    store rows and the same device map."""
    s = scenario
    tc = s["tc"]
    fuse_frames = s["depths"][:16:3]

    def session(async_path: bool):
        slam = ths.HashSLAM(tc, device="cpu")
        hmap = tho.create(tc.hash, device="cpu")
        spill = slam.spill_begin()
        for i, d in enumerate(fuse_frames):
            frame = tpre.preprocess(torch.from_numpy(d.astype(np.int32)),
                                    tc.camera, tc.frontend)
            pose = torch.from_numpy(s["feed"][3 * i][0].copy())
            hmap, _, _ = tho.fuse_frame(hmap, frame, pose, tc.camera,
                                        tc.hash, tc.fusion,
                                        frame_idx=8 * i)
            hmap = slam.spill_evict(hmap, 8 * i, spill)
        store = type(slam.store)(tc.hash)
        if async_path:
            slam.spill_finish_async(spill, store)
            assert len(store) == 0          # deferred to the join
            slam.stream_sync()
        else:
            assert slam.spill_finish(spill, store) == 0
        return store, convert.hashmap_to_numpy(hmap)

    (sa, ma), (ss, ms) = session(True), session(False)
    assert len(sa) > 0
    assert sa._index == ss._index
    for f in ("_keys", "_tsdf", "_weight", "_born"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(ss, f))
    for f in ma:
        np.testing.assert_array_equal(ma[f], ms[f])


def test_spill_overflow_is_counted(scenario):
    """Rows past the spill capacity are dropped and reported."""
    tc = scenario["tc"]
    slam = ths.HashSLAM(tc, device="cpu")
    spill = slam.spill_begin()
    spill["cap"] = 4            # a tiny buffer: its sentinel row is row 4
    for name in ("keys", "tsdf", "weight", "born"):
        spill[name] = spill[name][:5].clone()
    hmap = tho.create(tc.hash, device="cpu")
    blocks = torch.tensor([[i, 0, 0] for i in range(7)], dtype=torch.int32)
    from voxelhashing_demo_tpu_torch.geometry import coords

    hmap, _ = tho.insert_blocks(hmap, tc.hash,
                                coords.pack_block_key(blocks, tc.hash.key_bits))
    hmap = slam.spill_evict(hmap, 100, spill)
    store = type(slam.store)(tc.hash)
    assert slam.spill_finish(spill, store) == 3
    assert len(store) == 4


def test_warm_stream_leaves_the_instance_alone(scenario):
    s = scenario
    slam = ths.HashSLAM(s["tc"], device="cpu")
    for d in s["depths"][:12]:      # ends on a completion
        slam.process(d)
    before = convert.stream_state_to_numpy(slam)
    assert before["store.keys"].size
    slam.warm_stream()
    after = convert.stream_state_to_numpy(slam)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_convert_takes_a_snapshot():
    """``convert.*_to_numpy`` of a CPU state copies: the map is updated in
    place, and a flattened state must not follow it (as JAX's copies do
    not)."""
    tc = stream_config("torch")
    hmap = tho.create(tc.hash, device="cpu")
    flat = convert.hashmap_to_numpy(hmap)
    hmap.keys.fill_(7)
    hmap.free_top.fill_(3)
    assert (flat["keys"] == tho.EMPTY_KEY).all()
    assert int(flat["free_top"]) == tc.hash.num_blocks


# --------------------------------------------------------------------------
# KeyframeSLAM on a streaming map
# --------------------------------------------------------------------------

# the keyframe parity scenario (24 orbit frames, a drift injected before
# frame 12: loop edges, a full rebuild, then incremental moves) with
# streaming on: blocks unseen for 2 frames leave the device every 2 frames
KF_STREAM = dict(enabled=True, interval=2, max_age=2, max_evict=512,
                 max_restore=512)


def _kf_config(pkg):
    cfg = backend_config(pkg)
    return dataclasses.replace(
        cfg, stream=dataclasses.replace(cfg.stream, **KF_STREAM))


@pytest.fixture(scope="module")
def kf_runs():
    from voxelhashing_demo_tpu.models import keyframe_slam as jkf
    from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf

    depths, gt = backend_frames()
    out = {}
    for pkg, slam in (("jax", jkf.KeyframeSLAM(_kf_config("jax"))),
                      ("torch", tkf.KeyframeSLAM(_kf_config("torch"),
                                                 device="cpu"))):
        for i, d in enumerate(depths):
            if i == BACKEND_INJECT_AT:
                backend_inject(pkg, slam)
            slam.process(d)
        out[pkg] = (slam, slam.trajectory())
    return out, gt


def test_keyframe_streaming_decisions_match_jax(kf_runs):
    """Keyframes, edges, BA events, map-update modes, moved counts, tracked
    flags and capacity events equal to JAX; the trajectory within 1e-3 m
    (the keyframe parity tests' bounds)."""
    (runs, gt) = kf_runs
    js, jt = runs["jax"]
    ts, tt_ = runs["torch"]
    a, b = assert_same_backend_run(js, jt, ts, tt_, gt)
    assert "full" in a["ba_modes"] and "incremental" in a["ba_modes"]
    jd, td = js._driver, ts._inner
    jd.stream_sync()
    td.stream_sync()
    assert td.store.total_evicted > 0 and td.store.total_restored > 0
    assert (jd.store.total_evicted, jd.store.total_restored,
            len(jd.store)) == (td.store.total_evicted,
                               td.store.total_restored, len(td.store))
    assert not ts.saturated


def test_streaming_incremental_reintegration(kf_runs):
    """A rigid correction on the streaming map takes the incremental path:
    moved frames restore their frustums from the store, then de- and
    re-integrate; the result renders like a map fused from scratch at the
    corrected poses (the JAX test's bounds)."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf

    (runs, _) = kf_runs
    slam = runs["torch"][0]
    slam.flush()
    d = slam._inner
    d.stream_sync()
    # the orbit has brought every block back: send up to max_evict of
    # them to the store, so that the move has to restore them
    d.state = d.state._replace(hmap=d._evict_into(
        d.state.hmap, d.state.frame_idx + KF_STREAM["max_age"] + 1,
        d.store))
    assert slam._map_ledgered and len(d.store) > 100
    D = se3.exp(torch.tensor([0.04, -0.03, 0.02, 0.0, np.deg2rad(2.0), 0.0],
                             dtype=torch.float32))
    Dn = D.numpy()
    slam._poses_np[: slam._n_poses] = Dn @ slam._poses_np[: slam._n_poses]
    slam.graph = slam.graph._replace(
        poses=torch.einsum("ij,kjl->kil", D, slam.graph.poses))
    slam.state = slam.state._replace(pose=D @ slam.state.pose)
    n, n_sat = slam._incremental_reintegrate()
    assert n > 0 and d.store.total_restored > 0

    cfg = slam.config
    ref_cfg = dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, num_blocks=8192,
                                      num_buckets=8192),
        stream=dataclasses.replace(cfg.stream, enabled=False))
    fuse = tkf.make_fuse_only(ref_cfg)
    poses = slam._poses_np
    ref = tho.create(ref_cfg.hash, device="cpu")
    for rec in slam.keyframes:
        if rec.map_pose is not None:
            ref = fuse(ref, rec.depth_dev,
                       torch.from_numpy(poses[rec.index].copy()),
                       rec.frame_index)
    for ent in slam._ring:
        target = (poses[ent.kf] @ ent.rel).astype(np.float32)
        ref = fuse(ref, ent.depth, torch.from_numpy(target),
                   ent.frame_index)
    a = slam._render_model(slam.state.hmap, slam.state.pose)
    b = tkf.make_render_model(ref_cfg)(ref, slam.state.pose)
    da, db = a.depth.numpy(), b.depth.numpy()
    both = (da > 0) & (db > 0)
    assert both.mean() > 0.4
    assert np.median(np.abs(da - db)[both]) < cfg.fusion.voxel_size
