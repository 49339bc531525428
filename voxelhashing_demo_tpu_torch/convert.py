"""Carry SLAM state between the JAX package and this one as numpy arrays.

The state is flattened to ``{name: np.ndarray}`` with the JAX field names;
nested structures use dotted names (``"hmap.keys"``, ``"model.depth"``).
``state_to_numpy`` of a port state and the same flattening of a JAX state
(``{f"hmap.{k}": np.asarray(v) for k, v in s.hmap._asdict().items()}``
and so on) give the same keys, so the tests can start both packages from
one state.  Arrays are copied onto ``device`` (None: the CUDA card), and
copied off it: a flattened state is a snapshot.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import host_array, resolve
from .models.dense_slam import DenseSLAMState
from .models.hash_slam import HashSLAM, HashSLAMState
from .ops.hash_ops import ActiveSet, HashMap
from .ops.pose_graph import PoseGraph
from .ops.preprocess import Frame
from .ops.tsdf import DenseTSDF
from .utils.blockstore import BlockStore


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy of the tensor's values: a CPU tensor's ``numpy()`` shares its
    memory, and the map is updated in place."""
    return np.array(host_array(t), copy=True)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(resolve(device))


def _sub(d: dict, prefix: str) -> dict:
    if not prefix:
        return d
    n = len(prefix) + 1
    return {k[n:]: v for k, v in d.items() if k.startswith(prefix + ".")}


def _prefixed(d: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}" if prefix else k: v for k, v in d.items()}


def hashmap_from_numpy(d: dict, device=None, prefix: str = "") -> HashMap:
    d = _sub(d, prefix)
    return HashMap(*(_t(d[f], device) for f in HashMap._fields))


def hashmap_to_numpy(hmap: HashMap, prefix: str = "") -> dict:
    return _prefixed({f: _np(getattr(hmap, f)) for f in HashMap._fields},
                     prefix)


def frame_from_numpy(d: dict, device=None, prefix: str = "") -> Frame:
    d = _sub(d, prefix)
    return Frame(*(_t(d[f], device) for f in Frame._fields))


def frame_to_numpy(frame: Frame, prefix: str = "") -> dict:
    return _prefixed({f: _np(getattr(frame, f)) for f in Frame._fields},
                     prefix)


def active_from_numpy(d: dict, device=None, prefix: str = "") -> ActiveSet:
    d = _sub(d, prefix)
    return ActiveSet(*(_t(d[f], device) for f in ActiveSet._fields))


def active_to_numpy(active: ActiveSet, prefix: str = "") -> dict:
    return _prefixed({f: _np(getattr(active, f)) for f in ActiveSet._fields},
                     prefix)


def pose_graph_from_numpy(d: dict, device=None,
                          prefix: str = "") -> PoseGraph:
    """Flat ``{name: array}`` (JAX field names) -> PoseGraph; the two
    counts, device scalars in the JAX package, become host integers."""
    d = _sub(d, prefix)
    return PoseGraph(
        poses=_t(d["poses"], device),
        num_poses=int(d["num_poses"]),
        edges_ij=_t(d["edges_ij"], device),
        edges_T=_t(d["edges_T"], device),
        edges_w=_t(d["edges_w"], device),
        num_edges=int(d["num_edges"]),
    )


def pose_graph_to_numpy(graph: PoseGraph, prefix: str = "") -> dict:
    """PoseGraph -> flat ``{name: array}`` (inverse of
    ``pose_graph_from_numpy``; the counts come out as int32 scalars)."""
    out = {}
    for f in PoseGraph._fields:
        v = getattr(graph, f)
        out[f] = np.int32(v) if isinstance(v, int) else _np(v)
    return _prefixed(out, prefix)


def dense_tsdf_from_numpy(d: dict, device=None,
                          prefix: str = "") -> DenseTSDF:
    d = _sub(d, prefix)
    return DenseTSDF(*(_t(d[f], device) for f in DenseTSDF._fields))


def dense_tsdf_to_numpy(tsdf: DenseTSDF, prefix: str = "") -> dict:
    return _prefixed({f: _np(getattr(tsdf, f)) for f in DenseTSDF._fields},
                     prefix)


def dense_state_from_numpy(d: dict, device=None) -> DenseSLAMState:
    """Flat ``{name: array}`` (JAX field names) -> DenseSLAMState."""
    return DenseSLAMState(
        tsdf=dense_tsdf_from_numpy(d, device, "tsdf"),
        pose=_t(d["pose"], device),
        model=frame_from_numpy(d, device, "model"),
        frame_idx=int(d["frame_idx"]),
    )


def dense_state_to_numpy(state: DenseSLAMState) -> dict:
    """DenseSLAMState -> flat ``{name: array}`` (inverse of
    ``dense_state_from_numpy``)."""
    out = dense_tsdf_to_numpy(state.tsdf, "tsdf")
    out["pose"] = _np(state.pose)
    out.update(frame_to_numpy(state.model, "model"))
    out["frame_idx"] = np.int32(state.frame_idx)
    return out


def state_from_numpy(d: dict, device=None) -> HashSLAMState:
    """Flat ``{name: array}`` (JAX field names) -> HashSLAMState."""
    return HashSLAMState(
        hmap=hashmap_from_numpy(d, device, "hmap"),
        pose=_t(d["pose"], device),
        model=frame_from_numpy(d, device, "model"),
        frame_idx=int(d["frame_idx"]),
        vel=_t(d["vel"], device),
    )


def state_to_numpy(state: HashSLAMState) -> dict:
    """HashSLAMState -> flat ``{name: array}`` (inverse of
    ``state_from_numpy``)."""
    out = {}
    out.update(hashmap_to_numpy(state.hmap, "hmap"))
    out["pose"] = _np(state.pose)
    out.update(frame_to_numpy(state.model, "model"))
    out["frame_idx"] = np.int32(state.frame_idx)
    out["vel"] = _np(state.vel)
    return out


STREAM_ROWS = ("keys", "tsdf", "weight", "born")


def stream_state_to_numpy(slam: HashSLAM) -> dict:
    """A streaming HashSLAM's state, flat by the JAX field names, taken
    between a cycle's completion and the next dispatch: the frame state
    (``state_to_numpy``), the store's live rows in store-row order and its
    counters (``store.keys`` ... ``store.total_restored``), the prefetched
    restore keys (``prefetch.keys``), the evicted rows waiting for the next
    completion (``pending_evict.keys`` ...), and the trajectory
    (``trajectory`` (N, 4, 4)), whose length fixes the cycle's phase."""
    if slam._inflight is not None or slam._completing is not None:
        raise ValueError("a cycle is in flight; carry the state after its "
                         "completion")
    out = state_to_numpy(slam.state)
    out.update(_prefixed(slam.store.state_arrays(), "store"))
    out["store.total_evicted"] = np.int64(slam.store.total_evicted)
    out["store.total_restored"] = np.int64(slam.store.total_restored)
    out["prefetch.keys"] = (np.zeros(0, np.int32) if slam._prefetch is None
                            else np.asarray(slam._prefetch, np.int32))
    V = slam.config.hash.voxels_per_block
    pend = slam._pending_evict or (
        np.zeros(0, np.int32), np.zeros((0, V), np.float32),
        np.zeros((0, V), np.float32), np.zeros(0, np.int32))
    out.update(_prefixed(dict(zip(STREAM_ROWS, pend)), "pending_evict"))
    out["trajectory"] = np.stack(
        [_np(p) for p in slam.trajectory]
        or [np.zeros((0, 4, 4), np.float32)]).reshape(-1, 4, 4)
    return out


def stream_state_from_numpy(d: dict, config, device=None) -> HashSLAM:
    """A streaming HashSLAM (``config.stream.enabled``) at the state of
    ``d`` (the layout of ``stream_state_to_numpy``): the store is rebuilt
    from its live rows (``BlockStore.from_arrays``, so its rows are
    compacted), the prefetched batch is packed and uploaded again from it,
    and the infos start empty."""
    slam = HashSLAM(config, device=device)
    slam.state = state_from_numpy(d, device)
    st = _sub(d, "store")
    slam.store = BlockStore.from_arrays(
        config.hash, *(np.asarray(st[k]) for k in STREAM_ROWS))
    slam.store.total_evicted = int(st["total_evicted"])
    slam.store.total_restored = int(st["total_restored"])
    keys = np.asarray(d["prefetch.keys"], np.int32)
    if keys.size:
        slam._pack_restore(keys)
        slam._prefetch = keys
    pend = _sub(d, "pending_evict")
    if np.asarray(pend["keys"]).size:
        slam._pending_evict = tuple(np.array(pend[k]) for k in STREAM_ROWS)
    slam.trajectory = [_t(p, device) for p in np.asarray(d["trajectory"])]
    return slam
