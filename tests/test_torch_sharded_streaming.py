"""PyTorch port: out-of-core streaming over a mesh (parallel/sharded.py:
per-rank eviction into the rank's own store shard, owner-routed restore)
on two Gloo ranks on the CPU, against the JAX package's streaming
``ShardedHashSLAM`` on a 2-device mesh of conftest's virtual CPU devices.

Scenario (tests/torch_port_helpers.py ``stream_*``): the 80x60 room sweep
out and back (39 frames) through a 1 024-block map, streaming every 2
frames at age 6.  Both packages fuse frame i at its ground-truth pose and
take the velocity between consecutive ground-truth poses (float32 numpy),
so the cycle's frustum predictions agree (own-pose runs part after ~8
frames, ROADMAP Queue 3 F2).  The JAX side runs the window gather off (its
Pallas kernel does not trace under shard_map's replication check; at 80x60
the window covers the image).

The JAX run keeps one store for both devices (one process); each port rank
keeps its own shard, the JAX package's multi-process layout.  So after
every frame, exactly: each rank's integer map state (keys, ptrs,
bucket_fill, free_list, free_top, last_seen, born) equals the JAX shard's
rows; each rank's stored keys and their born stamps equal the JAX store's
keys that the rank owns; at the end the evicted / restored totals summed
over the ranks.  The stored rows (tsdf, weight) by key are the float map
tier: within 1e-5 (XLA:CPU contracts the fusion's multiply-adds).  The
run's checkpoint (the union of the stores) crosses to the JAX package and
back key by key, and each rank reloads the rows it owns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_files_equal, stream_config,
                                stream_frames)

from voxelhashing_demo_tpu.models.hash_slam import StepInfo as JStepInfo
from voxelhashing_demo_tpu.parallel import sharded as js
from voxelhashing_demo_tpu.utils import checkpoint as jck
from voxelhashing_demo_tpu_torch.parallel import launch, ranks, sharded
from voxelhashing_demo_tpu_torch.utils.blockstore import unpack_keys_np

torch.set_num_threads(1)

TIMEOUT_S = 300
INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
              "last_seen", "born")


def _owned(keys, r):
    owner = sharded._owner_np(unpack_keys_np(np.asarray(keys), 10),
                              stream_config("torch").hash.num_buckets, 2)
    return owner == r


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    depths, gt = stream_frames()
    poses = [np.asarray(p, np.float32) for p in gt]
    vels = [np.eye(4, dtype=np.float32)] + [
        (np.linalg.inv(a) @ b).astype(np.float32)
        for a, b in zip(poses[:-1], poses[1:])]
    jcfg = stream_config("jax")
    jcfg = dataclasses.replace(
        jcfg, hash=dataclasses.replace(jcfg.hash, use_pallas_gather=False))
    mesh = js.make_mesh(2)
    slam = js.ShardedHashSLAM(jcfg, mesh)
    fuse = js.make_sharded_fuse_only(jcfg, mesh)

    def fed(state, depth):
        i = int(state.frame_idx)
        hmap = fuse(state.hmap, depth, jnp.asarray(poses[i]), jnp.int32(i))
        zero = jnp.int32(0)
        info = JStepInfo(jnp.asarray(poses[i]),
                         *([zero] * (len(JStepInfo._fields) - 1)))
        return state._replace(hmap=hmap, pose=jnp.asarray(poses[i]),
                              vel=jnp.asarray(vels[i]),
                              frame_idx=state.frame_idx + 1), info

    slam._step = fed
    jax_frames = []
    for d in depths:
        slam.process(jnp.asarray(d))
        st = slam.store.state_arrays()
        jax_frames.append({
            **{f: np.asarray(getattr(slam.state.hmap, f))
               for f in INT_FIELDS},
            "store.keys": st["keys"], "store.born": st["born"]})
    path = str(tmp_path_factory.mktemp("sharded_stream") / "map.npz")
    port = launch.spawn(ranks.run_streaming, 2, None, "cpu", TIMEOUT_S,
                        stream_config("torch"), depths, poses, vels, path)
    return dict(jax=jax_frames, jstore=slam.store.state_arrays(),
                jtotals=(slam.store.total_evicted,
                         slam.store.total_restored), port=port, path=path)


def test_map_shards_match_jax_after_every_frame(runs):
    for i, j in enumerate(runs["jax"]):
        for r, out in enumerate(runs["port"]):
            t = out["per_frame"][i]
            for f in INT_FIELDS:
                np.testing.assert_array_equal(
                    t[f], np.split(j[f], 2)[r], err_msg=f"frame {i} rank {r} {f}")


def test_store_shards_match_jax_after_every_frame(runs):
    for i, j in enumerate(runs["jax"]):
        for r, out in enumerate(runs["port"]):
            t = out["per_frame"][i]
            mine = _owned(j["store.keys"], r)
            jk, jb = j["store.keys"][mine], j["store.born"][mine]
            order_t, order_j = np.argsort(t["store.keys"]), np.argsort(jk)
            np.testing.assert_array_equal(t["store.keys"][order_t],
                                          jk[order_j], err_msg=f"frame {i}")
            np.testing.assert_array_equal(t["store.born"][order_t],
                                          jb[order_j], err_msg=f"frame {i}")


def test_store_rows_and_totals(runs):
    js_ = runs["jstore"]
    assert js_["keys"].size > 0
    for r, out in enumerate(runs["port"]):
        st = out["store"]
        mine = _owned(js_["keys"], r)
        ot, oj = np.argsort(st["keys"]), np.argsort(js_["keys"][mine])
        for k in ("tsdf", "weight"):
            np.testing.assert_allclose(st[k][ot], js_[k][mine][oj],
                                       atol=1e-5, err_msg=k)
    ev = sum(o["evicted"] for o in runs["port"])
    rs = sum(o["restored"] for o in runs["port"])
    assert (ev, rs) == runs["jtotals"]
    assert ev > 0 and rs > 0


def test_checkpoint_of_a_streaming_mesh(runs, tmp_path):
    """The port's file holds the union of the ranks' stores; the JAX
    package loads it on its 2-device mesh and saves the same file back;
    the port's ranks load it back each with the rows it owns."""
    path = runs["path"]
    jslam = jck.load_sharded_slam(path, js.make_mesh(2))
    again = str(tmp_path / "again.npz")
    jck.save_slam(again, jslam)
    assert_files_equal(path, again)
    with np.load(path) as z:
        keys = np.asarray(z["store.keys"])
        rows = {f: np.asarray(z[f"state.hmap.{f}"]) for f in INT_FIELDS}
    # save_slam quiesced the cycle: the file holds the stores after it
    assert sorted(keys.tolist()) == sorted(np.concatenate(
        [o["saved_store"]["keys"] for o in runs["port"]]).tolist())
    loaded = launch.spawn(ranks.load_runs, 2, None, "cpu", TIMEOUT_S,
                          [(path, None)])
    for r, (res,) in enumerate(loaded):
        np.testing.assert_array_equal(
            np.sort(res["store"]["keys"]), np.sort(keys[_owned(keys, r)]))
        for f in INT_FIELDS:
            np.testing.assert_array_equal(res["state"][f"hmap.{f}"],
                                          np.split(rows[f], 2)[r],
                                          err_msg=f)


def test_keyframe_slam_streaming_on_a_mesh(tmp_path):
    """tests/test_torch_streaming.py's keyframe scenario (24 orbit frames,
    a drift before frame 12, blocks unseen for 2 frames streamed out every
    2 frames) through ``KeyframeSLAM(mesh)`` on two ranks: the decisions
    (keyframes, edges, BA frames, map-update modes, moved counts, tracked,
    capacity, saturation) equal to JAX's ``KeyframeSLAM(mesh=make_mesh(2))``
    and the trajectory within 1e-3 m (the single-device scenario's bounds);
    the store counters summed over the ranks within one block or 1 % of
    JAX's: on its own poses the run sits up to 5.8e-4 m from JAX's at
    frame 15 (ROADMAP Queue 3 F2), enough to stream one block more or
    less."""
    from torch_port_helpers import (BACKEND_DISCRETE, BACKEND_INJECT_AT,
                                    backend_config, backend_drift,
                                    backend_frames, backend_summary)

    from voxelhashing_demo_tpu.models import keyframe_slam as jkf

    kf_stream = dict(enabled=True, interval=2, max_age=2, max_evict=512,
                     max_restore=512)

    def config(pkg):
        cfg = backend_config(pkg)
        return dataclasses.replace(
            cfg, stream=dataclasses.replace(cfg.stream, **kf_stream),
            hash=dataclasses.replace(cfg.hash,
                                     use_pallas_gather=pkg == "torch"))

    depths, gt = backend_frames()
    depths = [np.asarray(d) for d in depths]
    slam = jkf.KeyframeSLAM(config("jax"), mesh=js.make_mesh(2))
    D = jnp.asarray(backend_drift())
    for i, d in enumerate(depths):
        if i == BACKEND_INJECT_AT:
            slam.state = slam.state._replace(pose=D @ slam.state.pose)
        slam.process(jnp.asarray(d))
    traj = slam.trajectory()
    j = backend_summary(slam, traj, gt)
    slam._driver.stream_sync()
    store = slam._driver.store
    a, b = launch.spawn(ranks.run_keyframe, 2, None, "cpu", TIMEOUT_S,
                        config("torch"), depths,
                        {BACKEND_INJECT_AT: backend_drift()})
    for k in BACKEND_DISCRETE:
        assert a[k] == j[k] == b[k], (k, a[k], j[k])
    assert "full" in a["ba_modes"] and "incremental" in a["ba_modes"]
    # own poses: one block more or less streamed (the integer map and store
    # are held exactly by the fed-pose tests above)
    jstream = [store.total_evicted, store.total_restored, len(store)]
    assert all(abs(x - y) <= max(1, 0.01 * y)
               for x, y in zip(a["stream"], jstream)), (a["stream"], jstream)
    assert a["stream"][0] > 0 and a["stream"][1] > 0
    np.testing.assert_allclose(
        a["trajectory"][:, :3, 3],
        np.stack([np.asarray(p) for p in traj])[:, :3, 3], atol=1e-3)
