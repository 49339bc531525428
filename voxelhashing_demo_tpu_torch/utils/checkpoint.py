"""Checkpoint / resume: the full SLAM state in one npz (port of
utils/checkpoint.py).

The file is the JAX package's: the same keys, dtypes and
``FORMAT_VERSION``, so each package opens the other's checkpoints.  One
``.npz`` holds every leaf of the state (``state.hmap.*``, ``state.pose``,
``state.model.*``, ``state.frame_idx``, ``state.vel``), ``mesh_n``, the
pose graph (``graph.*``, its counts as 0-d int32 as in the JAX package),
the trajectory, the config as JSON, the streaming store (``store.*``) and
a keyframe backend's extras (``extra.*``).  Pure numpy on the host: the
device state is fetched once per leaf, and restored onto ``device``
(None: the CUDA card).

A sharded run (parallel/sharded.py, one rank per mesh position) saves the
global layout, the ranks' shards concatenated in rank order, with
``mesh_n = n``: the file the JAX package writes from the same state on an
n-device mesh.  Every rank calls ``save_slam`` together (the shards are
all-gathered) and rank 0 writes.  ``per_process=True`` writes one shard
file per rank instead (``per_process_path``): its own rows of the sharded
leaves, the replicated ones in full, no gather.  ``load_sharded_slam``
restores a sharded run on a mesh of the same size from either; ``load_slam``
converts a sharded file to the single-device layout.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import host_array, resolve
from ..models import hash_slam
from ..models import keyframe_slam as km
from ..ops import hash_ops, pose_graph
from ..ops import preprocess as pre_ops
from .blockstore import BlockStore, unpack_keys_np

FORMAT_VERSION = 1


def config_to_json(config: PipelineConfig) -> str:
    return json.dumps(
        {
            f.name: dataclasses.asdict(getattr(config, f.name))
            for f in dataclasses.fields(config)
        }
    )


def config_from_json(text: str) -> PipelineConfig:
    raw = json.loads(text)
    defaults = PipelineConfig()
    kwargs = {}
    for f in dataclasses.fields(PipelineConfig):
        sub_type = type(getattr(defaults, f.name))
        sub_fields = {sf.name for sf in dataclasses.fields(sub_type)}
        # forward/backward compatible: missing sections/fields take
        # defaults, unknown ones are ignored
        sub_kwargs = {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in raw.get(f.name, {}).items()
            if k in sub_fields
        }
        kwargs[f.name] = sub_type(**sub_kwargs)
    return PipelineConfig(**kwargs)


# the state leaves a sharded run holds row-sharded over the mesh (the rest
# are replicated)
_SHARDED_PREFIXES = ("state.hmap.", "state.model.")


def _flatten(prefix: str, tree, mesh=None, local: bool = False,
             sharded_keys: Optional[list] = None) -> dict:
    """``{prefix.field: numpy}`` of a NamedTuple of tensors (nested ones
    dotted); host integers become 0-d int32 as the JAX leaves are.  Under
    a ``mesh`` the sharded leaves are all-gathered to the global layout
    (collective) or, with ``local``, kept as this rank's rows and their
    keys appended to ``sharded_keys``."""
    from ..parallel import distributed

    out = {}
    for name, leaf in zip(tree._fields, tree):
        key = f"{prefix}.{name}"
        if hasattr(leaf, "_fields"):
            out.update(_flatten(key, leaf, mesh, local, sharded_keys))
        elif isinstance(leaf, int):
            out[key] = np.int32(leaf)
        elif mesh is None or not key.startswith(_SHARDED_PREFIXES):
            out[key] = host_array(leaf)
        elif local:
            out[key] = host_array(leaf)
            sharded_keys.append(key)
        else:
            out[key] = distributed.fetch(mesh, leaf)
    return out


def per_process_path(path: str, mesh=None) -> str:
    """The shard file this rank writes and reads with ``per_process=True``
    (rank 0 of 1 without a mesh)."""
    import os

    base, ext = os.path.splitext(path)
    r, n = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    return f"{base}.proc{r}of{n}{ext or '.npz'}"


def save_slam(
    path: str,
    slam: "hash_slam.HashSLAM",
    graph: Optional[pose_graph.PoseGraph] = None,
    extra: Optional[dict] = None,
    per_process: bool = False,
) -> None:
    """Checkpoint a HashSLAM or a ShardedHashSLAM (or a KeyframeSLAM's
    inner one, with its ``graph`` and ``extra`` arrays).  A streaming map
    is quiesced first: an in-flight evicted payload lives on neither the
    device map nor the store yet and would be lost by a snapshot taken
    mid-cycle.  A sharded run is saved by every rank together; see the
    module docstring for ``per_process``."""
    mesh = getattr(slam, "mesh", None)
    if slam.store is not None:
        slam.stream_sync()
    sharded_keys: list = []
    arrays = _flatten("state", slam.state, mesh, per_process, sharded_keys)
    if per_process:
        path = per_process_path(path, mesh)
        arrays["pp_process_index"] = np.int64(0 if mesh is None
                                              else mesh.rank)
        arrays["pp_process_count"] = np.int64(1 if mesh is None
                                              else mesh.size)
        arrays["pp_sharded_keys"] = np.frombuffer(
            json.dumps(sharded_keys).encode(), dtype=np.uint8)
    arrays["mesh_n"] = np.int64(1 if mesh is None else mesh.size)
    if graph is not None:
        arrays.update(_flatten("graph", graph))
    if slam.trajectory:
        # stacked on the device, fetched once
        arrays["trajectory"] = host_array(torch.stack(slam.trajectory))
    arrays["config_json"] = np.frombuffer(
        config_to_json(slam.config).encode(), dtype=np.uint8
    )
    arrays["format_version"] = np.int64(FORMAT_VERSION)
    if slam.store is not None:
        # the out-of-frustum half of the map; a sharded run's global file
        # holds the union of the ranks' stores
        store_arrays = slam.store.state_arrays()
        if mesh is not None and not per_process:
            from ..parallel import distributed

            store_arrays = distributed.gather_concat_many(mesh, store_arrays)
        if store_arrays["keys"].shape[0]:
            for k, v in store_arrays.items():
                arrays[f"store.{k}"] = v
    if extra:
        for k, v in extra.items():
            arrays[f"extra.{k}"] = np.asarray(v)
    if mesh is None or per_process or mesh.rank == 0:
        np.savez_compressed(path, **arrays)


def _sharded_map_to_single(hmap_np: dict, config: PipelineConfig, n: int,
                           device) -> hash_ops.HashMap:
    """Canonical conversion of a gathered sharded map (n local tables,
    local row pointers) into the single-device layout: every occupied
    block's (key, payload) re-inserted into a fresh table by
    ``restore_blocks`` in chunks of 4 096.  The result is content-equal,
    not slot-equal; every consumer of the table is order-independent."""
    cfg = config.hash
    keys = hmap_np["keys"]
    ptrs = hmap_np["ptrs"]
    localT = keys.shape[0] // n
    localB = hmap_np["tsdf"].shape[0] // n
    occ = np.nonzero(ptrs >= 0)[0]
    rows = (occ // localT) * localB + ptrs[occ]
    okeys = keys[occ]
    otsdf = hmap_np["tsdf"][rows]
    oweight = hmap_np["weight"][rows]
    olast = hmap_np["last_seen"][rows]
    oborn = hmap_np["born"][rows]

    def padded(a, pad, fill=0):
        return torch.from_numpy(np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])).to(device)

    out = hash_ops.create(cfg, device=device)
    C = 4096
    for i in range(0, len(occ), C):
        pad = C - okeys[i: i + C].shape[0]
        k = padded(okeys[i: i + C], pad, hash_ops.EMPTY_KEY)
        out, acc = hash_ops.restore_blocks(
            out, cfg, k, padded(otsdf[i: i + C], pad),
            padded(oweight[i: i + C], pad), 0,
            max_weight=config.fusion.max_weight,
            born_rows=padded(oborn[i: i + C], pad),
        )
        if not bool(acc[: C - pad].all()):
            raise ValueError(
                "sharded->single conversion overflowed the single-device "
                "table (raise hash.num_buckets/bucket_size)"
            )
        # restore_blocks stamps last_seen = frame 0; put the real values
        # back (the JAX mode="drop" scatter: found keys' rows are distinct)
        p, _ = hash_ops.lookup_keys(out, cfg, k)
        hash_ops._scatter_drop(out.last_seen, p, p >= 0,
                               padded(olast[i: i + C], pad))
    return out


def _hashmap_arrays(z) -> dict:
    """The file's ``state.hmap.*`` arrays, with the defaults for files
    written before ``last_seen``, ``band_min`` or ``born`` existed."""
    hmap_np = {
        n: np.asarray(z[f"state.hmap.{n}"])
        for n in hash_ops.HashMap._fields
        if f"state.hmap.{n}" in z
    }
    n_rows = z["state.hmap.free_list"].shape
    if "last_seen" not in hmap_np:
        hmap_np["last_seen"] = np.zeros(n_rows, dtype=np.int32)
    if "band_min" not in hmap_np:
        # recomputed from the rows
        w, t = hmap_np["weight"], hmap_np["tsdf"]
        hmap_np["band_min"] = np.where(
            w > 0, np.abs(t), np.inf
        ).min(axis=1).astype(np.float32)
    if "born" not in hmap_np:
        # age 0: old maps predate incremental reintegration; a full
        # rebuild restamps it
        hmap_np["born"] = np.zeros(n_rows, dtype=np.int32)
    return hmap_np


def load_slam(
    path: str, device=None,
) -> Tuple["hash_slam.HashSLAM", Optional[pose_graph.PoseGraph]]:
    """Restore a HashSLAM (and the pose graph, if the file has one) on
    ``device`` (None: the CUDA card).  A map written by a device mesh
    (``mesh_n > 1``) is converted to the single-device layout."""
    device = resolve(device)
    with np.load(path) as z:
        if "pp_sharded_keys" in z and json.loads(
                bytes(z["pp_sharded_keys"]).decode()):
            raise ValueError(
                f"{path} is a per-process shard: load it with "
                "load_sharded_slam on the ranks that wrote it")
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than "
                             f"supported {FORMAT_VERSION}")
        config = config_from_json(bytes(z["config_json"]).decode())

        def leaf(key):
            return torch.from_numpy(np.array(z[key])).to(device)

        hmap_np = _hashmap_arrays(z)
        mesh_n = int(z["mesh_n"]) if "mesh_n" in z else 1
        if mesh_n > 1:
            hmap = _sharded_map_to_single(hmap_np, config, mesh_n, device)
        else:
            hmap = hash_ops.HashMap(**{
                k: torch.from_numpy(np.array(v)).to(device)
                for k, v in hmap_np.items()})
        state = hash_slam.HashSLAMState(
            hmap=hmap,
            pose=leaf("state.pose"),
            model=pre_ops.Frame(**{n: leaf(f"state.model.{n}")
                                   for n in pre_ops.Frame._fields}),
            frame_idx=int(z["state.frame_idx"]),
            # fields added after format v1 default sanely on old files
            vel=(leaf("state.vel") if "state.vel" in z
                 else torch.eye(4, dtype=torch.float32, device=device)),
        )
        store = None
        if config.stream.enabled and "store.keys" in z:
            store = BlockStore.from_arrays(
                config.hash, z["store.keys"], z["store.tsdf"],
                z["store.weight"],
                z["store.born"] if "store.born" in z else None,
                born_default=state.frame_idx,
            )
        trajectory = (list(leaf("trajectory").unbind(0))
                      if "trajectory" in z else [])
        slam = hash_slam.HashSLAM._restore(config, state, trajectory, store,
                                           device)
        graph = _graph(z, device)
    return slam, graph


def _graph(z, device) -> Optional[pose_graph.PoseGraph]:
    """The file's pose graph on ``device``, or None."""
    if "graph.poses" not in z:
        return None

    def leaf(key):
        return torch.from_numpy(np.array(z[key])).to(device)

    return pose_graph.PoseGraph(
        poses=leaf("graph.poses"),
        num_poses=int(z["graph.num_poses"]),
        edges_ij=leaf("graph.edges_ij"),
        edges_T=leaf("graph.edges_T"),
        edges_w=leaf("graph.edges_w"),
        num_edges=int(z["graph.num_edges"]),
    )


def _sharded_file(path: str, mesh) -> str:
    """``path``, or this rank's shard file when only that exists."""
    import os

    pp = per_process_path(path, mesh)
    return pp if not os.path.exists(path) and os.path.exists(pp) else path


def load_sharded_slam(path: str, mesh):
    """Restore a sharded run on ``mesh`` (every rank calls it): each rank
    takes its own rows of the file's global layout, or reads its own shard
    file (``per_process_path``) when ``path`` itself is absent.  The mesh
    must have the size the file was written from (``mesh_n``); a shard file
    must have been written by this rank of a mesh of this size.  The
    streaming store keeps the rows this rank owns."""
    from ..parallel import distributed, sharded

    path = _sharded_file(path, mesh)
    n, r, device = mesh.size, mesh.rank, mesh.device
    with np.load(path) as z:
        config = config_from_json(bytes(z["config_json"]).decode())
        mesh_n = int(z["mesh_n"]) if "mesh_n" in z else 1
        if mesh_n != n:
            raise ValueError(
                f"checkpoint was saved from a {mesh_n}-device mesh; got "
                f"{n} (load_slam gives the single-device view)")
        local = set()
        if "pp_sharded_keys" in z:
            local = set(json.loads(bytes(z["pp_sharded_keys"]).decode()))
            who = (int(z["pp_process_index"]), int(z["pp_process_count"]))
            if who != (r, n):
                raise ValueError(
                    f"per-process shard {path} was written by rank "
                    f"{who[0]} of {who[1]}; this is rank {r} of {n}")

        def mine(key, a):
            a = np.asarray(a)
            if key in local:
                return a
            h = a.shape[0] // n
            return a[r * h:(r + 1) * h]

        def tensor(a):
            return torch.from_numpy(np.array(a)).to(device)

        hmap = hash_ops.HashMap(**{
            k: tensor(mine(f"state.hmap.{k}", v))
            for k, v in _hashmap_arrays(z).items()})
        model = pre_ops.Frame(**{
            k: tensor(mine(f"state.model.{k}", z[f"state.model.{k}"]))
            for k in pre_ops.Frame._fields})
        state = hash_slam.HashSLAMState(
            hmap=hmap, pose=tensor(z["state.pose"]), model=model,
            frame_idx=int(z["state.frame_idx"]),
            vel=(tensor(z["state.vel"]) if "state.vel" in z
                 else torch.eye(4, dtype=torch.float32, device=device)))
        store = None
        if config.stream.enabled and "store.keys" in z:
            # a global file holds the union of the ranks' stores (a shard
            # file this rank's own): this rank keeps the rows it owns
            keys = np.asarray(z["store.keys"])
            keep = distributed.owner_process_mask(mesh, sharded._owner_np(
                unpack_keys_np(keys, config.hash.key_bits),
                config.hash.num_buckets, n))
            store = BlockStore.from_arrays(
                config.hash, keys[keep], np.asarray(z["store.tsdf"])[keep],
                np.asarray(z["store.weight"])[keep],
                np.asarray(z["store.born"])[keep] if "store.born" in z
                else None, born_default=state.frame_idx)
        trajectory = ([tensor(p) for p in z["trajectory"]]
                      if "trajectory" in z else [])
    return sharded.ShardedHashSLAM._restore(config, mesh, state, trajectory,
                                            store)


def save_keyframe_slam(path: str, kslam, per_process: bool = False) -> None:
    """Checkpoint a KeyframeSLAM: the inner state, the pose graph, and what
    the backend needs to keep closing loops after a restart:

    - keyframe raw depths (uint16) and frame indices; the downsampled ICP
      frames are recomputed on load,
    - per-frame keyframe references, so the corrected trajectory stays
      reconstructible,
    - the BA / capacity / relocalization logs, the saturation flag and the
      BA deferral counters (``events_json``)."""
    kslam.settle()  # land in-flight work; deferred BA stays deferred
    extra = {}
    if kslam.keyframes:
        extra["kf_depths"] = np.stack(
            [r.depth_np() for r in kslam.keyframes]
        )
        extra["kf_frame_indices"] = np.array(
            [r.frame_index for r in kslam.keyframes], np.int64
        )
    if kslam._frame_refs:
        extra["refs_k"] = np.array(
            [k for k, _ in kslam._frame_refs], np.int64
        )
        extra["refs_rel"] = np.stack(
            [np.asarray(rel) for _, rel in kslam._frame_refs]
        ).astype(np.float32)
    events = {
        "ba_events": kslam.ba_events,
        "capacity_events": kslam.capacity_events,
        "relocalizations": kslam.relocalizations,
        "saturated": bool(kslam.saturated),
        "frame_idx": int(kslam._frame_idx),
        # the BA deferral counters survive the checkpoint (settle does not
        # force pending closures to solve), so a resumed run fires BA at
        # the frame the uninterrupted run would have
        "pending_ba_edges": int(kslam._pending_ba_edges),
        "pending_ba_since": int(kslam._pending_ba_since),
        # the contribution ledger is not persisted: a resumed run starts
        # unledgered and its first significant correction rebuilds fully
    }
    extra["events_json"] = np.frombuffer(
        json.dumps(events).encode(), dtype=np.uint8
    )
    save_slam(path, kslam._inner, graph=kslam.graph, extra=extra,
              per_process=per_process)


def load_keyframe_slam(path: str, mesh=None, device=None):
    """Restore a KeyframeSLAM on ``device`` (None: the CUDA card), or a
    sharded one on ``mesh`` (every rank calls it; ``load_sharded_slam``),
    for a full-capability resume: loop closures against pre-checkpoint
    keyframes still fire and map rebuilds still work."""
    if mesh is None:
        inner, graph = load_slam(path, device=device)
    else:
        inner = load_sharded_slam(path, mesh)
        # the graph and the extras are replicated: a shard file holds them
        path = _sharded_file(path, mesh)
        with np.load(path) as z:
            graph = _graph(z, mesh.device)
    if graph is None:
        raise ValueError(f"{path} is not a keyframe checkpoint")
    k = km.KeyframeSLAM._restore(inner, graph)
    with np.load(path) as z:
        if "extra.kf_depths" in z:
            depths = np.asarray(z["extra.kf_depths"])
            fidx = np.asarray(z["extra.kf_frame_indices"])
            # the downsampled ICP frames come from the same make_kf_pre
            # function the live run uses
            for i in range(depths.shape[0]):
                dev = hash_slam.depth_tensor(depths[i], k.device)
                k.keyframes.append(km._KeyframeRecord(
                    index=i, frame_index=int(fidx[i]), frame=k._kf_pre(dev),
                    depth_raw=depths[i], depth_dev=dev))
        if "extra.refs_k" in z:
            refs_k = np.asarray(z["extra.refs_k"])
            refs_rel = np.asarray(z["extra.refs_rel"])
            k._frame_refs = [
                (int(refs_k[i]), refs_rel[i]) for i in range(len(refs_k))
            ]
        if "extra.events_json" in z:
            events = json.loads(bytes(z["extra.events_json"]).decode())
            k.ba_events = events.get("ba_events", [])
            k.capacity_events = events.get("capacity_events", [])
            k.relocalizations = events.get("relocalizations", [])
            k.saturated = bool(events.get("saturated", False))
            k._frame_idx = int(events.get("frame_idx", len(k._frame_refs)))
            k._pending_ba_edges = int(events.get("pending_ba_edges", 0))
            k._pending_ba_since = int(
                events.get("pending_ba_since", k._frame_idx)
            )
    return k


def export_trajectory_tum(path: str, poses: List, timestamps=None) -> None:
    """Write a trajectory in TUM format: ``t tx ty tz qx qy qz qw``
    (timestamps default to the frame index).  Poses: (4, 4) numpy arrays
    or tensors (fetched in one copy)."""
    from .tum import matrix_to_quat

    if poses and isinstance(poses[0], torch.Tensor):
        poses = list(host_array(torch.stack(list(poses))))
    lines = []
    for i, T in enumerate(poses):
        T = np.asarray(T)
        t = timestamps[i] if timestamps is not None else float(i)
        qx, qy, qz, qw = matrix_to_quat(T[:3, :3])
        lines.append(
            f"{t:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def dump_sdf(path: str, hmap: hash_ops.HashMap, cfg) -> int:
    """Text dump of occupied blocks and their TSDF values, in the format of
    the reference's printSDFdata (SDF_dump.txt).  Returns the number of
    occupied blocks written."""
    keys = host_array(hmap.keys)
    ptrs = host_array(hmap.ptrs)
    occ = np.nonzero(ptrs >= 0)[0]
    blocks = unpack_keys_np(keys[occ], cfg.key_bits)
    tsdf = host_array(hmap.tsdf)
    weight = host_array(hmap.weight)
    with open(path, "w") as f:
        f.write(f"# occupied blocks: {len(occ)}\n")
        for b, slot in enumerate(occ):
            p = ptrs[slot]
            f.write(
                f"block {tuple(int(x) for x in blocks[b])} ptr {int(p)} "
                f"maxw {weight[p].max():.3f}\n"
            )
            nz = np.nonzero(weight[p] > 0)[0]
            for v in nz:
                f.write(f"  {v} {tsdf[p, v]:.5f} {weight[p, v]:.2f}\n")
    return len(occ)
