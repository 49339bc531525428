"""Rank entry points for ``launch.spawn``: each takes the mesh first, runs
one piece of the sharded stack on every rank, and returns host data (numpy
and Python values) that the launching process compares across ranks and
against other runs.  They live in the package so that a rank process
imports nothing but the port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import convert
from ..device import host_array
from ..ops import hash_ops, icp
from ..ops import preprocess as pre_ops
from ..ops import splat as splat_ops
from . import distributed, sharded


def _tensor(a, dtype, mesh) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype), device=mesh.device)


def kernel_check(mesh, config, hmap, depth_raw, pose) -> dict:
    """The integrate kernel (K7, which does the window gather's work on the
    frame step) against the plain integrate on this rank's own rows
    (``tools/probe.integrate_check``: the visible rows of ``hmap`` at
    ``pose`` fused with ``depth_raw``).  Returns the row count, whether
    tsdf, weight and band_min are bit-exact, and the largest tsdf
    difference.  Its launches are not counted."""
    from ..tools.probe import integrate_check

    lcfg = sharded.local_hash_config(config.hash, mesh.size)
    depth = pre_ops.preprocess(_tensor(depth_raw, np.int32, mesh),
                               config.camera, config.frontend).depth
    return integrate_check(hmap, lcfg, config.camera, config.fusion, depth,
                           pose)


def run_slam(mesh, config, frames, fed_poses=None, render_poses=(),
             timed=False) -> dict:
    """Drive ``frames`` through the sharded stack.  Without ``fed_poses``
    a ``ShardedHashSLAM`` tracks them; with them, ``make_sharded_fuse_only``
    fuses frame i at ``fed_poses[i]`` (no tracking).  Then the model is
    rendered (this rank's rows) at each of ``render_poses``.

    Returns ``infos`` (one dict of numpy per tracked frame), ``state``
    (this rank's shard, flattened as ``convert`` does), ``models`` (per
    render pose, this rank's rows), ``launches`` (K7's window-gather
    launches per frame), ``icp_launches`` (the ICP kernels' K4 and K4s
    launches over the run), ``k3_launches`` (K3a and K3b's),
    ``splat_launches`` (K8 and K9's), ``fuse_launches`` (K6 and K7's),
    ``alloc_launches`` (K5a and K5b's) and, with ``timed``, per-frame
    host ms on a synchronised clock, the peak device memory, the
    collective counters, the live render's hit mask (this rank's rows)
    and ``kernel_check`` on the last frame."""
    hash_ops.LAUNCHES_INTEGRATE_WINDOW = 0
    hash_ops.LAUNCHES_COMPACT = hash_ops.LAUNCHES_INTEGRATE = 0
    hash_ops.LAUNCHES_ALLOC_CANDIDATES = hash_ops.LAUNCHES_INSERT = 0
    icp.LAUNCHES_LEVEL = icp.LAUNCHES_SUMS = 0
    pre_ops.LAUNCHES_FRAME = pre_ops.LAUNCHES_LEVELS = 0
    splat_ops.LAUNCHES_ZBUFFER = splat_ops.LAUNCHES_FINALIZE = 0
    launches, frame_ms, infos = [], [], []
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    if fed_poses is None:
        slam = sharded.ShardedHashSLAM(config, mesh)
    else:
        fuse = sharded.make_sharded_fuse_only(config, mesh)
        hmap = sharded.create_map(config, mesh)
    bytes0, coll0 = mesh.collective_host_bytes, mesh.collectives
    for i, d in enumerate(frames):
        before = hash_ops.LAUNCHES_INTEGRATE_WINDOW
        if cuda:
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        if fed_poses is None:
            info = slam.process(d)
            infos.append({k: host_array(v)
                          for k, v in info._asdict().items()})
        else:
            hmap = fuse(hmap, _tensor(d, np.int32, mesh),
                        _tensor(fed_poses[i], np.float32, mesh), i)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(hash_ops.LAUNCHES_INTEGRATE_WINDOW - before)
    out = {"infos": infos, "launches": launches,
           "icp_launches": [icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS],
           "k3_launches": [pre_ops.LAUNCHES_FRAME, pre_ops.LAUNCHES_LEVELS],
           "splat_launches": [splat_ops.LAUNCHES_ZBUFFER,
                              splat_ops.LAUNCHES_FINALIZE],
           "fuse_launches": [hash_ops.LAUNCHES_COMPACT,
                             hash_ops.LAUNCHES_INTEGRATE],
           "alloc_launches": [hash_ops.LAUNCHES_ALLOC_CANDIDATES,
                              hash_ops.LAUNCHES_INSERT]}
    if fed_poses is None:
        out["state"] = convert.state_to_numpy(slam.state)
        hmap = slam.state.hmap
    else:
        out["state"] = convert.hashmap_to_numpy(hmap, "hmap")
    render = sharded.make_sharded_render_model(config, mesh)
    out["models"] = [
        {k: host_array(v) for k, v in render(
            hmap, _tensor(p, np.float32, mesh))._asdict().items()}
        for p in render_poses]
    if timed:
        n = max(len(frames), 1)
        if fed_poses is None:
            out["hit_rows"] = host_array(slam.render().hit)
            out["kernel"] = kernel_check(mesh, config, hmap, frames[-1],
                                         slam.state.pose)
        out["frame_ms"] = frame_ms
        out["collective_host_bytes_per_frame"] = (
            mesh.collective_host_bytes - bytes0) / n
        out["collectives_per_frame"] = (mesh.collectives - coll0) / n
        out["peak_mem_bytes"] = (int(torch.cuda.max_memory_allocated(
            mesh.device)) if cuda else None)
    return out


def run_keyframe(mesh, config, frames, inject=None, timed=False) -> dict:
    """Drive ``frames`` through ``KeyframeSLAM(config, mesh)``; before
    each frame i of ``inject`` ({i: (4, 4) drift}) the live pose is
    left-multiplied by its drift.  Returns the backend's decisions (keyframe frames, edges, BA
    frames, rebuild modes, moves, tracked flags, capacity events,
    saturation), the trajectory, the graph poses, this rank's map shard,
    K7's window-gather launches, the kernels' launches (``icp_launches``:
    K4, K4s; ``k3_launches``: K3a, K3b; ``splat_launches``: K8, K9;
    ``fuse_launches``: K6, K7; ``alloc_launches``: K5a, K5b), with
    streaming the store counters
    (evicted, restored, stored) summed over the ranks, and, with
    ``timed``, the host seconds of
    each BA solve and the collective counters."""
    from ..models import keyframe_slam

    hash_ops.LAUNCHES_INTEGRATE_WINDOW = 0
    hash_ops.LAUNCHES_COMPACT = hash_ops.LAUNCHES_INTEGRATE = 0
    hash_ops.LAUNCHES_ALLOC_CANDIDATES = hash_ops.LAUNCHES_INSERT = 0
    icp.LAUNCHES_LEVEL = icp.LAUNCHES_SUMS = 0
    pre_ops.LAUNCHES_FRAME = pre_ops.LAUNCHES_LEVELS = 0
    splat_ops.LAUNCHES_ZBUFFER = splat_ops.LAUNCHES_FINALIZE = 0
    bytes0, coll0 = mesh.collective_host_bytes, mesh.collectives
    slam = keyframe_slam.KeyframeSLAM(config, mesh=mesh)
    for i, d in enumerate(frames):
        if inject and i in inject:
            slam.state = slam.state._replace(
                pose=_tensor(inject[i], np.float32, mesh) @ slam.state.pose)
        slam.process(d)
    traj = slam.trajectory()
    n_e = slam.graph.num_edges
    out = {
        "keyframe_frames": [r.frame_index for r in slam.keyframes],
        "edges": host_array(slam.graph.edges_ij)[:n_e].tolist(),
        "ba_frames": [e["frame"] for e in slam.ba_events],
        "ba_modes": [e["rebuild_mode"] for e in slam.ba_events],
        "moved": [e["keyframes_reintegrated"] for e in slam.ba_events],
        "tracked": [bool(i.tracked) for i in slam.infos],
        "capacity": slam.capacity_events,
        "saturated": slam.saturated,
        "trajectory": np.stack(traj),
        "graph_poses": host_array(slam.graph.poses).copy(),
        "state": convert.hashmap_to_numpy(slam.state.hmap, "hmap"),
        "launches": hash_ops.LAUNCHES_INTEGRATE_WINDOW,
        "icp_launches": [icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS],
        "k3_launches": [pre_ops.LAUNCHES_FRAME, pre_ops.LAUNCHES_LEVELS],
        "splat_launches": [splat_ops.LAUNCHES_ZBUFFER,
                           splat_ops.LAUNCHES_FINALIZE],
        "fuse_launches": [hash_ops.LAUNCHES_COMPACT,
                          hash_ops.LAUNCHES_INTEGRATE],
        "alloc_launches": [hash_ops.LAUNCHES_ALLOC_CANDIDATES,
                           hash_ops.LAUNCHES_INSERT],
        "rebuild_fuses": sum(e["keyframes"] for e in slam.ba_events
                             if e["rebuild_mode"] == "full"),
    }
    store = slam._inner.store
    if store is not None:
        # this rank's shard, quiesced; counters summed over the ranks
        slam._inner.stream_sync()
        out["stream"] = [distributed.psum_host(mesh, c) for c in (
            store.total_evicted, store.total_restored, len(store))]
    if timed:
        n = max(len(frames), 1)
        out["ba_s"] = [e["ba_s"] for e in slam.ba_events]
        out["collective_host_bytes_per_frame"] = (
            mesh.collective_host_bytes - bytes0) / n
        out["collectives_per_frame"] = (mesh.collectives - coll0) / n
    return out


_INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
               "last_seen", "born")


def run_streaming(mesh, config, frames, poses, vels,
                  save_to: str | None = None) -> dict:
    """Drive ``frames`` through a streaming ``ShardedHashSLAM`` whose step
    fuses frame i at ``poses[i]`` and sets the velocity to ``vels[i]``
    (``make_sharded_fuse_only``, no tracking); the streaming cycle runs as
    in ``process``.  Returns, after every frame, this rank's integer map
    state and its store's keys and born stamps (``per_frame``), and at the
    end the store's rows and counters; with ``save_to`` the run is then
    checkpointed there (``save_slam``)."""
    from ..models.hash_slam import StepInfo

    slam = sharded.ShardedHashSLAM(config, mesh)
    fuse = sharded.make_sharded_fuse_only(config, mesh)
    zero = torch.zeros((), dtype=torch.int32, device=mesh.device)

    def fed(state, depth):
        i = state.frame_idx
        pose = _tensor(poses[i], np.float32, mesh)
        hmap = fuse(state.hmap, depth, pose, i)
        info = StepInfo(pose, *([zero] * (len(StepInfo._fields) - 1)))
        return state._replace(hmap=hmap, pose=pose, frame_idx=i + 1,
                              vel=_tensor(vels[i], np.float32, mesh)), info

    slam._step = fed
    per_frame = []
    for d in frames:
        slam.process(d)
        st = slam.store.state_arrays()
        per_frame.append({
            **{f: host_array(getattr(slam.state.hmap, f)).copy()
               for f in _INT_FIELDS},
            "store.keys": st["keys"], "store.born": st["born"]})
    out = {"per_frame": per_frame, "store": slam.store.state_arrays(),
           "evicted": slam.store.total_evicted,
           "restored": slam.store.total_restored}
    if save_to is not None:
        from ..utils import checkpoint as ck

        ck.save_slam(save_to, slam)   # quiesces the cycle first
        out["saved_store"] = slam.store.state_arrays()
    return out


def _keyframe_view(slam) -> dict:
    """A KeyframeSLAM's trajectory and graph poses, on the host."""
    return {"trajectory": np.stack(slam.trajectory()),
            "graph_poses": host_array(slam.graph.poses).copy()}


def save_run(mesh, config, frames, saves, keyframe=False) -> dict:
    """Drive ``frames`` through a ``ShardedHashSLAM`` (or, with
    ``keyframe``, a ``KeyframeSLAM``) on ``mesh``, then save it to each
    ``(path, per_process)`` of ``saves`` (utils/checkpoint.py).  Returns
    this rank's state shard (flattened) and the trajectory."""
    from ..models import keyframe_slam
    from ..utils import checkpoint as ck

    slam = (keyframe_slam.KeyframeSLAM(config, mesh=mesh) if keyframe
            else sharded.ShardedHashSLAM(config, mesh))
    for d in frames:
        slam.process(d)
    for path, per_process in saves:
        if keyframe:
            ck.save_keyframe_slam(path, slam, per_process=per_process)
        else:
            ck.save_slam(path, slam, per_process=per_process)
    out = {"state": convert.state_to_numpy(slam.state)}
    if keyframe:
        out.update(_keyframe_view(slam))
    else:
        out["trajectory"] = host_array(torch.stack(slam.trajectory))
    return out


def load_runs(mesh, loads, frames=(), keyframe=False) -> list:
    """For each ``(path, resave)`` of ``loads``: restore the run on
    ``mesh`` (``load_sharded_slam`` / ``load_keyframe_slam``), save it
    again to ``resave`` (unless None), then drive ``frames`` on.  Returns,
    per load, this rank's state shard as loaded (flattened), its store's
    contents after the frames (streaming) and the poses of the frames
    driven after it."""
    from ..utils import checkpoint as ck

    out = []
    for path, resave in loads:
        if keyframe:
            slam = ck.load_keyframe_slam(path, mesh)
            inner = slam._inner
        else:
            slam = inner = ck.load_sharded_slam(path, mesh)
        loaded = convert.state_to_numpy(inner.state)
        if resave is not None:
            if keyframe:
                ck.save_keyframe_slam(resave, slam)
            else:
                ck.save_slam(resave, slam)
        poses = [host_array(slam.process(d).pose) for d in frames]
        res = {"state": loaded, "poses": poses}
        if inner.store is not None:
            res["store"] = inner.store.state_arrays()
        if keyframe:
            res.update(_keyframe_view(slam))
        out.append(res)
    return out


def run_ba(mesh, graph_np: dict, kcfg) -> dict:
    """``optimize_graph_sharded`` of a graph given as numpy arrays
    (``convert.pose_graph_to_numpy`` layout); returns the poses and chi2."""
    g = convert.pose_graph_from_numpy(graph_np, device=mesh.device)
    out, info = sharded.optimize_graph_sharded(g, kcfg, mesh)
    return {"poses": host_array(out.poses),
            "chi2": [float(info.chi2_initial), float(info.chi2_final)]}


def collectives(mesh, seed: int) -> dict:
    """Every collective helper of parallel/distributed.py on seeded data
    (rank r's values are a function of the seed and r): the parent checks
    each against the numpy result."""
    rng = np.random.default_rng(seed + mesh.rank)
    dev = mesh.device
    x = torch.as_tensor(rng.standard_normal((3, 4)).astype(np.float32),
                        device=dev)
    ints = torch.as_tensor(rng.integers(-9, 9, 5).astype(np.int32),
                           device=dev)
    rows = rng.standard_normal((mesh.rank + 1, 2)).astype(np.float32)
    return {
        "x": host_array(x), "ints": host_array(ints), "rows": rows,
        "psum": host_array(distributed.psum(mesh, x)),
        "psum_int": host_array(distributed.psum(mesh, ints)),
        "pmin": host_array(distributed.pmin(mesh, x)),
        "tiled": host_array(distributed.all_gather(mesh, x)),
        "stacked": host_array(distributed.all_gather(mesh, x, tiled=False)),
        "fetch": distributed.fetch(mesh, x),
        "gather_concat": distributed.gather_concat(mesh, rows),
        "gather_many": distributed.gather_concat_many(
            mesh, {"a": rows, "b": rows[:, 0].copy()}),
        "psum_host": distributed.psum_host(mesh, mesh.rank + 7),
        "owner_mask": distributed.owner_process_mask(
            mesh, np.arange(2 * mesh.size) % mesh.size),
        "rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
        "host_bytes": mesh.collective_host_bytes,
    }
