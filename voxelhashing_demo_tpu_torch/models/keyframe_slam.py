"""Keyframe SLAM: voxel-hash frame-to-model tracking + pose graph BA (port
of models/keyframe_slam.py: one device, with or without out-of-core
streaming, or the sharded pipeline over a mesh of ranks).

Composes the HashSLAM pipeline with the backend that bounds its drift:

- keyframe selection by relative-motion thresholds;
- odometry edges between consecutive keyframes, refined by pair ICP on the
  stored downsampled keyframe frames;
- loop-closure edges: older keyframes within ``loop_radius`` are
  re-registered by ICP and constrain the graph if the registration passes
  the inlier / error / observability gates (and, optionally, a reverse
  registration that must compose to identity);
- pose graph optimization (ops/pose_graph.py) when a loop edge is accepted
  (or when the deferral window fires); the correction goes to the live
  pose, every non-keyframe pose is stored relative to its keyframe so the
  whole trajectory follows, and so does the map: full rebuild on the first
  significant correction, exact de-integrate / re-integrate of only the
  moved contributions after (hash_ops.defuse_frame);
- tracking-lost recovery: after a streak of failed frames the live frame
  re-registers against stored keyframes from a Procrustes seed and the
  pose, model and velocity reset.

With ``config.stream.enabled`` the wrapped HashSLAM streams blocks to its
host store; a move first restores the stored blocks of both its frustums,
and a full rebuild streams the fresh map into a fresh store.  The wrapped
HashSLAM is ``self._inner`` (the JAX package calls it ``_driver``).

With a ``mesh`` (parallel/sharded.py) the frame step, the rebuild fuses,
the moves and the model renders run sharded over the ranks, and BA runs
edge-sharded (``optimize_graph_sharded``); the keyframe logic is the same
on every rank, fed by replicated values, so every rank takes the same
decisions and calls the collectives together.

Host / device split: the frame step runs on the device; the bookkeeping
(keyframe decisions, refs, lost streak) runs on the host against numpy
mirrors of the graph, every ``sync_every`` frames from one fetch of the
pending frames' poses, tracked flags and valid-pixel counts.  The gates
are numpy float32 as in the JAX package, so they decide as it does.  Two
orders of landing are kept from there although no stream forces them
here: with ``kf_async_edges`` under BA deferral a keyframe's edges land at
the next drain, and with ``ba_async`` a correction lands one drain after
its solve and re-bases the poses appended meanwhile.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import host_array
from ..geometry import procrustes as proc
from ..ops import hash_ops
from ..ops import icp as icp_ops
from ..ops import pose_graph
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..utils.blockstore import BlockStore
from . import hash_slam


def _pose_tensor(T, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(T, dtype=np.float32), device=device)


def make_fuse_only(config: PipelineConfig):
    """Fuse-only step (no tracking): integrate one raw depth frame at a
    given pose, in place.  ``fuse(hmap, depth_raw, pose, frame_idx)``
    returns the map; ``pose`` is a (4, 4) tensor on the map's device."""

    def fuse(hmap, depth_raw, pose, frame_idx):
        frame = pre_ops.preprocess(depth_raw, config.camera, config.frontend)
        hmap, _, _ = hash_ops.fuse_frame(
            hmap, frame, pose, config.camera, config.hash, config.fusion,
            frame_idx=int(frame_idx))
        return hmap

    return fuse


def make_reintegrate(config: PipelineConfig):
    """De-integrate at the old pose + re-integrate at the new pose of one
    stored frame depth, in place.  Both passes are gated to rows that
    existed when the frame was first fused (born <= ``frame_born``) and
    allocate nothing.  Returns (map, max visible-set count (tensor)): a
    count at ``max_active`` means the frustum compaction truncated and the
    move was not exact; the caller surfaces it."""

    def reint(hmap, depth_raw, T_old, T_new, frame_born):
        frame = pre_ops.preprocess(depth_raw, config.camera, config.frontend)
        a_old = hash_ops.compact_visible(
            hmap, config.hash, T_old, config.camera, config.fusion)
        hmap = hash_ops.integrate(
            hmap, a_old, config.hash, frame.depth, T_old, config.camera,
            config.fusion, sign=-1, max_born=int(frame_born))
        a_new = hash_ops.compact_visible(
            hmap, config.hash, T_new, config.camera, config.fusion)
        hmap = hash_ops.integrate(
            hmap, a_new, config.hash, frame.depth, T_new, config.camera,
            config.fusion, max_born=int(frame_born))
        return hmap, torch.maximum(a_old.count, a_new.count)

    return reint


def make_render_model(config: PipelineConfig):
    """Surface prediction at an arbitrary pose as a tracking Frame (the
    model the next step needs after a map update)."""

    def render(hmap, pose):
        active = hash_ops.compact_visible(
            hmap, config.hash, pose, config.camera, config.fusion)
        return rc_ops.model_frame(
            hash_slam._predict_surface(hmap, active, pose, config))

    return render


def make_kf_pre(cam, frontend, downsample: int, lcam):
    """Preprocess + downsample for keyframe insertion: raw depth -> the
    Frame pair ICP runs on."""

    def kf_pre(depth_raw):
        frame = pre_ops.preprocess(depth_raw, cam, frontend)
        if downsample == 1:
            return frame
        return pre_ops.preprocess_metric(frame.depth, lcam,
                                         pool_factor=downsample)

    return kf_pre


def _make_laps():
    """Wall-clock lap recorder: returns ``(laps, lap)`` where ``lap(name)``
    adds the time since the previous lap to ``laps[name]``."""
    laps = {}
    state = {"t": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(laps.get(name, 0.0) + (now - state["t"]), 4)
        state["t"] = now

    return laps, lap


def _rot_deg_np(T: np.ndarray) -> float:
    """Rotation angle of a 4x4 (or 3x3) transform, degrees, numpy."""
    c = (float(np.trace(np.asarray(T)[:3, :3])) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@dataclass
class _KeyframeRecord:
    index: int                 # keyframe id == pose index in the graph
    frame_index: int           # global frame number
    frame: pre_ops.Frame       # downsampled preprocessed frame (for ICP)
    depth_raw: np.ndarray = None       # host uint16 copy, made on demand
    depth_dev: torch.Tensor = None     # device int32 depth (re-fused)
    # ledger: the pose at which this keyframe's contribution sits in the
    # TSDF (set by a full rebuild, updated by incremental reintegration;
    # None = not individually tracked in the map)
    map_pose: np.ndarray = None

    def depth_np(self) -> np.ndarray:
        if self.depth_raw is None:
            self.depth_raw = host_array(self.depth_dev).astype(np.uint16)
        return self.depth_raw


@dataclass
class _RingEntry:
    """One live-fused frame in the post-rebuild contribution ledger: the
    TSDF holds its samples at ``map_pose`` (the pose the step fused at,
    which differs from the corrected trajectory pose when a correction or
    relocalization landed later); its corrected pose is always
    ``graph_pose[kf] @ rel``."""

    frame_index: int
    kf: int                    # reference keyframe id
    rel: np.ndarray            # pose relative to that keyframe
    depth: torch.Tensor        # device int32 depth
    map_pose: np.ndarray       # where its contribution sits


class KeyframeSLAM:
    """Host-side orchestrator around the frame step and BA.

    ``KeyframeSLAM(config, device)`` owns a ``HashSLAM`` on ``device``
    (None: the CUDA card) and a pose graph beside it;
    ``KeyframeSLAM(config, mesh)`` owns this rank's ``ShardedHashSLAM``
    instead (every rank of the mesh builds one and feeds it the same
    frames).  ``process`` steps
    one raw depth frame, ``trajectory`` returns every frame's pose with all
    corrections applied, ``ba_events`` / ``capacity_events`` /
    ``relocalizations`` record what the backend did."""

    def __init__(self, config: PipelineConfig, mesh=None, device=None):
        if mesh is None:
            inner = hash_slam.HashSLAM(config, device=device)
        else:
            from ..parallel import sharded

            inner = sharded.ShardedHashSLAM(config, mesh)
        self._setup(inner, pose_graph.create(
            config.keyframes.max_keyframes, config.keyframes.max_edges,
            device=inner.device))

    @classmethod
    def _restore(cls, inner: hash_slam.HashSLAM,
                 graph: pose_graph.PoseGraph) -> "KeyframeSLAM":
        """A KeyframeSLAM around a restored HashSLAM and pose graph
        (checkpoint restore, utils/checkpoint.py), with fresh bookkeeping
        and the host mirrors of the graph; the caller restores the
        keyframes, frame refs and event logs."""
        k = cls.__new__(cls)
        k._setup(inner, graph)
        k._poses_np = host_array(graph.poses).astype(np.float32).copy()
        k._n_poses = graph.num_poses
        k._n_edges = graph.num_edges
        return k

    def _setup(self, inner, graph: pose_graph.PoseGraph) -> None:
        self.config = inner.config
        self.kcfg = inner.config.keyframes
        self._inner = inner
        self.mesh = getattr(inner, "mesh", None)
        self.device = inner.device
        self.graph = graph
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        """Fresh bookkeeping; requires config / kcfg / graph / device."""
        self.keyframes: List[_KeyframeRecord] = []
        # per-frame: (keyframe id, relative pose in that keyframe's frame)
        self._frame_refs: List[tuple] = []
        self.infos = []
        self.ba_events = []
        self._last_rebuild_detail = None
        self._t_count_moved = None
        # per-insert wall-clock laps (pre / cand / fwd)
        self._kf_insert_s: List[dict] = []
        # deferred keyframe candidate batches (kcfg.kf_async_edges)
        self._kf_pending: List[dict] = []
        # graph capacity growth / saturation record (never silent)
        self.capacity_events: List[dict] = []
        self.saturated = False
        self.relocalizations: List[dict] = []
        self._lost_streak = 0
        self._lcam = self.config.camera.scaled(self.kcfg.icp_downsample)
        self._frame_idx = 0
        cfg = self.config
        if self.mesh is None:
            self._fuse_only = make_fuse_only(cfg)
            self._render_model = make_render_model(cfg)
            self._reintegrate = make_reintegrate(cfg)
        else:
            from ..parallel import sharded

            self._fuse_only = sharded.make_sharded_fuse_only(cfg, self.mesh)
            self._render_model = sharded.make_sharded_render_model(
                cfg, self.mesh)
            self._reintegrate = sharded.make_sharded_reintegrate(
                cfg, self.mesh)
        self._kf_pre = make_kf_pre(cfg.camera, cfg.frontend,
                                   self.kcfg.icp_downsample, self._lcam)
        self._pair_icfg = dataclasses.replace(
            cfg.icp, max_iters=self.kcfg.loop_icp_max_iters)
        # contribution ledger: valid once a full rebuild has accounted for
        # every TSDF contribution (keyframe map_poses) and the ring has
        # tracked every live-fused frame since; ring overflow invalidates
        # it until the next full rebuild
        self._map_ledgered = False
        self._ring: List[_RingEntry] = []
        self._ring_overflow = False
        # a frame fused into an older epoch's map has no contribution in
        # the current one (the rebuild dropped it)
        self._map_epoch = 0
        self._pending: List[tuple] = []
        # BA scheduling (kcfg.ba_defer_edges / ba_defer_frames)
        self._pending_ba_edges = 0
        self._pending_ba_since = 0
        self._ba_inflight = None       # kcfg.ba_async
        self._poses_np = np.broadcast_to(
            np.eye(4, dtype=np.float32),
            (self.graph.poses.shape[0], 4, 4),
        ).copy()
        self._n_poses = 0
        self._n_edges = 0

    # -- the wrapped HashSLAM -----------------------------------------------

    @property
    def state(self):
        return self._inner.state

    @state.setter
    def state(self, value) -> None:
        self._inner.state = value

    def _apply_correction(self, correction: np.ndarray) -> None:
        st = self._inner.state
        self._inner.state = st._replace(
            pose=_pose_tensor(correction, self.device) @ st.pose)

    def _run_ba(self):
        if self.mesh is None:
            return pose_graph.optimize(self.graph, self.kcfg)
        from ..parallel import sharded

        return sharded.optimize_graph_sharded(self.graph, self.kcfg,
                                              self.mesh)

    def _new_map(self) -> hash_ops.HashMap:
        """An empty map (this rank's shard under a mesh)."""
        if self.mesh is None:
            return hash_ops.create(self.config.hash, device=self.device)
        from ..parallel import sharded

        return sharded.create_map(self.config, self.mesh)

    # -- graph capacity -----------------------------------------------------

    def _mark_saturated(self, kind: str) -> None:
        self.saturated = True
        if not any(e.get("kind") == f"saturated_{kind}"
                   for e in self.capacity_events):
            self.capacity_events.append({
                "frame": self._frame_idx,
                "kind": f"saturated_{kind}",
                "capacity": (self.graph.poses.shape[0] if kind == "keyframes"
                             else self.graph.edges_ij.shape[0]),
            })

    def _ensure_pose_capacity(self) -> bool:
        """True if a pose slot is available (growing the graph if
        allowed); counts come from the host mirrors."""
        K = self.graph.poses.shape[0]
        if self._n_poses < K:
            return True
        if not self.kcfg.grow_on_capacity:
            self._mark_saturated("keyframes")
            return False
        self.graph = pose_graph.grow(
            self.graph, K * 2, self.graph.edges_ij.shape[0])
        self._poses_np = np.concatenate([
            self._poses_np,
            np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)),
        ])
        self.capacity_events.append({
            "frame": self._frame_idx, "kind": "grow_keyframes",
            "capacity": K * 2,
        })
        return True

    def _ensure_edge_capacity(self) -> bool:
        E = self.graph.edges_ij.shape[0]
        if self._n_edges < E:
            return True
        if not self.kcfg.grow_on_capacity:
            self._mark_saturated("edges")
            return False
        self.graph = pose_graph.grow(
            self.graph, self.graph.poses.shape[0], E * 2)
        self.capacity_events.append({
            "frame": self._frame_idx, "kind": "grow_edges",
            "capacity": E * 2,
        })
        return True

    def _add_pose(self, T_np: np.ndarray) -> None:
        self.graph = pose_graph.add_pose(
            self.graph, np.asarray(T_np, dtype=np.float32))
        self._poses_np[self._n_poses] = T_np
        self._n_poses += 1

    def _add_edge(self, i: int, j: int, T_np, weight: float) -> None:
        self.graph = pose_graph.add_edge(
            self.graph, i, j, np.asarray(T_np, dtype=np.float32), weight)
        self._n_edges += 1

    # -- keyframe helpers ---------------------------------------------------

    def _should_insert(self, pose_np: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        last = self._poses_np[self.keyframes[-1].index]
        rel = np.linalg.inv(last) @ pose_np
        return (
            _rot_deg_np(rel) > self.kcfg.min_rotation_deg
            or float(np.linalg.norm(rel[:3, 3])) > self.kcfg.min_translation
        )

    # -- batched pair ICP ---------------------------------------------------

    def _dispatch_batch(self, direction, small, cand_frames, inits):
        """Pair ICP of ``small`` against every candidate frame
        (``"fwd"``: small onto candidate; ``"rev"``: candidate onto
        small); returns the (C, 19) device tensor, not fetched."""
        inits_t = [_pose_tensor(T, self.device) for T in inits]
        smalls = [small] * len(cand_frames)
        srcs, tgts = ((smalls, cand_frames) if direction == "fwd"
                      else (cand_frames, smalls))
        return icp_ops.icp_align_batch(srcs, tgts, self._lcam,
                                       self._pair_icfg, inits_t)

    @staticmethod
    def _unpack_batch(out_np):
        C = out_np.shape[0]
        return (out_np[:, :16].reshape(C, 4, 4), out_np[:, 16],
                out_np[:, 17], out_np[:, 18])

    def _run_batch(self, direction, small, cand_frames, inits):
        """Run the candidate pair ICPs and return (transforms (C, 4, 4),
        errors (C,), counts (C,), observability (C,)) as numpy: one fetch
        for the whole candidate set."""
        return self._unpack_batch(host_array(
            self._dispatch_batch(direction, small, cand_frames, inits)))

    def _edge_ok_np(self, T, err, cnt, obs) -> bool:
        return (
            bool(np.isfinite(T).all())
            and cnt >= self.kcfg.min_loop_inliers
            and err <= self.kcfg.max_loop_error
            and obs >= self.kcfg.min_loop_obs
        )

    def _mutual_ok_np(self, comp) -> bool:
        return (
            float(np.linalg.norm(comp[:3, 3]))
            <= self.kcfg.loop_mutual_max_trans
            and _rot_deg_np(comp) <= self.kcfg.loop_mutual_max_rot_deg
        )

    def _insert_keyframe(self, pose_np: np.ndarray, depth_raw):
        _t, _lap = _make_laps()
        k = len(self.keyframes)
        if not self._ensure_pose_capacity():
            return None
        small = self._kf_pre(depth_raw)
        self._add_pose(pose_np)
        rec = _KeyframeRecord(index=k, frame_index=self._frame_idx,
                              frame=small, depth_dev=depth_raw)
        _lap("pre_s")

        if k > 0:
            # candidate set: [0] = odometry edge to the previous keyframe,
            # [1:] = loop candidates passing the position / angle gates
            # (host numpy, no device fetch)
            prev = self.keyframes[-1]
            cands = [prev]
            inits = [np.linalg.inv(self._poses_np[prev.index]) @ pose_np]
            p_new = pose_np[:3, 3]
            dir_new = pose_np[:3, 2]
            cos_gate = np.cos(np.deg2rad(self.kcfg.loop_max_angle_deg))
            scored = []
            for r in self.keyframes[
                : max(0, k - self.kcfg.min_loop_separation)
            ]:
                old = self._poses_np[r.index]
                dist = float(np.linalg.norm(old[:3, 3] - p_new))
                if dist > self.kcfg.loop_radius:
                    continue
                if float(old[:3, 2] @ dir_new) < cos_gate:
                    continue
                scored.append((dist, r))
            scored.sort(key=lambda e: e[0])
            width = max(self.kcfg.loop_max_batch, 1)
            for _, r in scored[: width - 1]:
                cands.append(r)
                inits.append(
                    np.linalg.inv(self._poses_np[r.index]) @ pose_np)

            _lap("cand_s")
            pending = {
                "k": k,
                "frame_idx": self._frame_idx,
                "small": small,
                "cand_idx": [c.index for c in cands],
                "cand_frames": [c.frame for c in cands],
                "inits": inits,
                "out": self._dispatch_batch(
                    "fwd", small, [c.frame for c in cands], inits),
            }
            defer_on = (self.kcfg.ba_defer_edges > 1
                        or self.kcfg.ba_defer_frames > 0)
            if self.kcfg.kf_async_edges and defer_on:
                # the batch's results land at the next drain; edge
                # insertion, the mutual check and the BA trigger move with
                # it.  Only under BA deferral: a per-closure configuration
                # chose correction latency first
                self._kf_pending.append(pending)
            else:
                self._complete_one_kf(pending)
            _lap("fwd_s")

        self.keyframes.append(rec)
        self._kf_insert_s.append(_t)
        return self._maybe_optimize()

    def _complete_one_kf(self, p: dict) -> None:
        """Land one keyframe's candidate batch: fetch the forward pair-ICP
        results, apply the acceptance gates, run the mutual check, and
        insert the odometry + accepted loop edges into the graph."""
        k = p["k"]
        inits = p["inits"]
        Ts, errs, cnts, obs = self._unpack_batch(host_array(p["out"]))
        # odometry edge: the pair-ICP refinement, or the tracked relative
        # pose on a failed / degenerate solve (or by kcfg.odometry_source)
        meas = (Ts[0]
                if self.kcfg.odometry_source == "icp"
                and self._edge_ok_np(Ts[0], errs[0], cnts[0], obs[0])
                else inits[0])
        if self._ensure_edge_capacity():
            self._add_edge(p["cand_idx"][0], k, meas,
                           self.kcfg.odometry_weight)
        n_c = len(p["cand_idx"])
        passing = [
            i for i in range(1, n_c)
            if self._edge_ok_np(Ts[i], errs[i], cnts[i], obs[i])
        ]
        if passing and self.kcfg.loop_mutual_check:
            rT, _, _, _ = self._run_batch(
                "rev", p["small"],
                [p["cand_frames"][i] for i in passing],
                [np.linalg.inv(Ts[i]) for i in passing],
            )
            passing = [
                i for j, i in enumerate(passing)
                if np.isfinite(rT[j]).all()
                and self._mutual_ok_np(Ts[i] @ rT[j])
            ]
        loop_closed = False
        for i in passing:
            if not self._ensure_edge_capacity():
                break
            self._add_edge(p["cand_idx"][i], k, Ts[i],
                           self.kcfg.loop_weight)
            loop_closed = True
        if loop_closed:
            if self._pending_ba_edges == 0:
                # BA deferral ages from when the closure was found
                self._pending_ba_since = p["frame_idx"]
            self._pending_ba_edges += 1

    def _complete_kf_edges(self) -> None:
        """Land every deferred keyframe candidate batch, in insert order:
        at each drain, before any BA solve, and at flush / settle."""
        while self._kf_pending:
            self._complete_one_kf(self._kf_pending.pop(0))

    def _maybe_optimize(self, force: bool = False):
        """Run BA if the deferral trigger fires (``ba_defer_edges``
        accepted closures accumulated, or the oldest pending one waited
        ``ba_defer_frames`` frames, or ``force``).  With ``ba_async`` the
        solve is dispatched here and completed at the next drain; while
        one is in flight new triggers wait.  Returns the applied
        correction (numpy) or None."""
        corr = None
        if force:
            self._complete_kf_edges()
        if self._ba_inflight is not None:
            if not force:
                return None
            corr = self._complete_ba()
        if self._pending_ba_edges <= 0:
            return corr
        waited = self._frame_idx - self._pending_ba_since
        if not (
            force
            or self._pending_ba_edges >= max(self.kcfg.ba_defer_edges, 1)
            or (self.kcfg.ba_defer_frames > 0
                and waited >= self.kcfg.ba_defer_frames)
        ):
            return corr
        # the trigger fired: land any still-deferred batches so the solve
        # includes every found edge
        self._complete_kf_edges()
        self._pending_ba_edges = 0
        if self.kcfg.ba_async and not force:
            self._dispatch_ba()
            return corr
        c2 = self._optimize()
        if corr is None:
            return c2
        return (c2 @ corr).astype(np.float32) if c2 is not None else corr

    def _fetch_ba(self, info):
        """One transfer for a BA solve's outputs: (poses (K, 4, 4) numpy,
        chi2 (2,) numpy)."""
        K = self.graph.poses.shape[0]
        arr = host_array(torch.cat([
            self.graph.poses.reshape(-1),
            torch.stack([info.chi2_initial, info.chi2_final]),
        ]))
        return arr[: K * 16].reshape(K, 4, 4), arr[K * 16:]

    def _optimize(self) -> np.ndarray:
        """Run BA, propagate the last keyframe's correction to the live
        pose and, when the correction is significant, resolve the map
        (``_post_ba``).  Returns the correction (numpy) so a pending drain
        can apply it to the frames still in flight."""
        t0 = time.perf_counter()
        last_idx = self.keyframes[-1].index
        old_last = self._poses_np[last_idx].copy()
        self.graph, info = self._run_ba()
        poses_all, chi2_np = self._fetch_ba(info)
        self._poses_np[: self._n_poses] = poses_all[: self._n_poses]
        t_ba = time.perf_counter() - t0
        new_last = self._poses_np[last_idx]
        correction = (new_last @ np.linalg.inv(old_last)).astype(np.float32)
        self._apply_correction(correction)
        return self._post_ba(correction, last_idx, t_ba, chi2_np)

    def _dispatch_ba(self) -> None:
        """Async BA (``ba_async``): solve now, fetch nothing; the
        correction lands at the next drain (``_complete_ba``).  On the
        card ``optimize`` reads nothing back, so this returns once the
        solve's launches are queued, without waiting on the card.  Poses
        and edges appended meanwhile sit at rows >= n0 of the optimized
        graph and are re-based on completion."""
        last_idx = self.keyframes[-1].index
        old_last = self._poses_np[last_idx].copy()
        n0 = self._n_poses
        self.graph, info = self._run_ba()
        self._ba_inflight = {
            "info": info, "n0": n0, "last_idx": last_idx,
            "old_last": old_last, "t0": time.perf_counter(),
        }

    def _complete_ba(self) -> np.ndarray:
        """Fetch the in-flight solve, merge (optimized rows < n0, re-based
        rows appended since), propagate the correction, resolve the map."""
        fl = self._ba_inflight
        self._ba_inflight = None
        n0 = fl["n0"]
        opt, chi2_np = self._fetch_ba(fl["info"])
        t_ba = time.perf_counter() - fl["t0"]
        new_last = opt[fl["last_idx"]]
        correction = (
            new_last @ np.linalg.inv(fl["old_last"])
        ).astype(np.float32)
        self._poses_np[: n0] = opt[:n0]
        for i in range(n0, self._n_poses):
            self._poses_np[i] = (
                correction @ self._poses_np[i]
            ).astype(np.float32)
        if self._n_poses > n0:
            # push the re-based appended rows back to the device graph
            # (padding rows in the mirror are identity, as in create)
            self.graph.poses.copy_(torch.from_numpy(self._poses_np))
        self._apply_correction(correction)
        return self._post_ba(correction, fl["last_idx"], t_ba, chi2_np)

    def _post_ba(self, correction, last_idx, t_ba, chi2) -> np.ndarray:
        """Shared post-solve tail: map resolution (cost-based full vs
        incremental) + the BA event record."""
        trans = float(np.linalg.norm(correction[:3, 3]))
        rot = _rot_deg_np(correction)
        rebuilt = False
        mode = None
        n_reint = 0
        n_sat = 0
        self._t_count_moved = None   # never leak a prior event's lap
        t1 = time.perf_counter()
        if self.kcfg.rebuild_map and (
            trans > self.kcfg.rebuild_min_trans
            or rot > self.kcfg.rebuild_min_rot_deg
        ):
            use_incremental = (
                self.kcfg.rebuild_incremental
                and self._map_ledgered
                and not self._ring_overflow
            )
            if use_incremental and self.kcfg.rebuild_incremental_cost > 0:
                # a correction that moves most of the ledger resolves
                # cheaper as a fresh rebuild (one fuse per keyframe) than
                # as per-entry de / re-integration
                _tc = time.perf_counter()
                moved = self._count_moved()
                self._t_count_moved = round(time.perf_counter() - _tc, 4)
                if (
                    moved * self.kcfg.rebuild_incremental_cost
                    > max(len(self.keyframes), 1)
                ):
                    use_incremental = False
            if use_incremental:
                n_reint, n_sat = self._incremental_reintegrate()
                mode = "incremental"
            else:
                self._rebuild_map()
                mode = "full"
            rebuilt = True

        event = {
            "frame": self._frame_idx,
            "keyframes": last_idx + 1,
            "edges": self._n_edges,
            "chi2_initial": float(chi2[0]),
            "chi2_final": float(chi2[1]),
            "correction_trans_m": trans,
            "correction_rot_deg": rot,
            "map_rebuilt": rebuilt,
            "rebuild_mode": mode,
            "keyframes_reintegrated": n_reint,
            # host wall-clock of the solve + fetch and of the map update
            "ba_s": round(t_ba, 4),
            "rebuild_s": round(time.perf_counter() - t1, 4),
        }
        if rebuilt and mode == "full" and self._last_rebuild_detail:
            d = dict(self._last_rebuild_detail)
            # the chi2 pair came with the pose fetch: no fetch of its own
            d["chi2_fetch_s"] = 0.0
            if self._t_count_moved is not None:
                d["count_moved_s"] = self._t_count_moved
                self._t_count_moved = None
            event["rebuild_detail"] = d
        if n_sat:
            # the visible set saturated during de / re-integration:
            # compact_visible capped at max_active, so some rows the frame
            # touched may not have been moved: not exact, never silent
            event["reintegration_saturated"] = n_sat
        self.ba_events.append(event)
        return correction

    def _count_moved(self) -> int:
        """How many ledger entries (keyframes + ring frames) the current
        graph poses would move (host only)."""
        new_poses = self._poses_np
        n = 0
        for rec in self.keyframes:
            if rec.map_pose is not None and self._moved(
                rec.map_pose, new_poses[rec.index]
            ):
                n += 1
        for ent in self._ring:
            if self._moved(ent.map_pose, new_poses[ent.kf] @ ent.rel):
                n += 1
        return n

    def _moved(self, a: np.ndarray, b: np.ndarray) -> bool:
        delta = np.linalg.inv(a) @ b
        return (
            float(np.linalg.norm(delta[:3, 3]))
            > self.kcfg.rebuild_move_min_trans
            or _rot_deg_np(delta) > self.kcfg.rebuild_move_min_rot_deg
        )

    def _incremental_reintegrate(self):
        """Move only the TSDF contributions whose corrected pose differs
        from where they sit, by the contribution ledger: keyframe
        ``map_pose`` entries (placed by the last full rebuild) plus the
        ring of every frame live-fused since.  De-integration at the
        ledger pose (what was actually fused) keeps the inverse exact.
        Returns (n_reintegrated, n_visible_set_saturations).

        On a streaming map the rows a moved frame touched may sit in the
        host store: they are restored (with their original born stamps) for
        the old and the new frustum before the move, and stored rows that
        could not come back (device capacity) count as saturations.  Across
        streaming the move is exact up to the born-stamp residency caveat
        of ``hash_ops.restore_blocks``."""
        new_poses = self._poses_np
        d = self._inner
        streaming = d.store is not None
        n = 0
        A = self.config.hash.max_active
        # saturation count accumulated on the device: one fetch at the end
        sat_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        miss = 0   # stored keys a restore could not bring back

        def restore_frustums(from_pose, to_pose):
            nonlocal miss
            s = self.config.stream
            # land any deferred spill and the cycle first: the query reads
            # the store
            d.stream_sync()
            for pose in (from_pose, to_pose):
                keys = (d.store.query_frustum(
                    np.asarray(pose, np.float32), self.config.camera,
                    self.config.fusion, s.restore_margin_px, s.max_restore,
                ) if len(d.store) else np.zeros(0, np.int32))
                d._restore_keys(keys)
                miss += sum(1 for k in keys if int(k) in d.store._index)

        def move(depth_dev, frame_idx, from_pose, to_pose):
            nonlocal n, sat_dev
            if streaming:
                restore_frustums(from_pose, to_pose)
            hmap, cnt = self._reintegrate(
                d.state.hmap, depth_dev,
                _pose_tensor(from_pose, self.device),
                _pose_tensor(to_pose, self.device),
                int(frame_idx),
            )
            d.state = d.state._replace(hmap=hmap)
            sat_dev = sat_dev + (cnt >= A).to(torch.int32)
            n += 1

        for rec in self.keyframes:
            if rec.map_pose is None:
                continue   # post-rebuild keyframe: a ring entry holds it
            target = new_poses[rec.index]
            if not self._moved(rec.map_pose, target):
                continue
            move(rec.depth_dev, rec.frame_index, rec.map_pose, target)
            rec.map_pose = target.copy()
        for ent in self._ring:
            target = new_poses[ent.kf] @ ent.rel
            if not self._moved(ent.map_pose, target):
                continue
            move(ent.depth, ent.frame_index, ent.map_pose, target)
            ent.map_pose = target.astype(np.float32)
        if n == 0:
            # nothing moved: the model rendered by the last step is still
            # valid
            return 0, 0
        if streaming and self.mesh is not None:
            # each rank misses in its own store: the recorded count is the
            # ranks' total, the same on every rank (n is rank-symmetric, so
            # every rank reaches this collective)
            from ..parallel import distributed

            miss = distributed.psum_host(self.mesh, miss)
        n_sat = int(sat_dev) + miss
        model = self._render_model(d.state.hmap, d.state.pose)
        d.state = d.state._replace(model=model)
        return n, n_sat

    def _rebuild_map(self) -> None:
        """Re-integrate every stored keyframe depth at its corrected pose
        into a fresh map, then re-render the tracking model at the
        corrected live pose.  Non-keyframe observations are dropped: a
        thinner weight field for globally consistent geometry.

        On a streaming map the old store holds geometry fused at the old
        poses, so the rebuild streams into a FRESH store: each keyframe's
        fuse is followed by an eviction into a device spill buffer, whose
        rows land in the new store at the next cycle join
        (``spill_finish_async``); an overflow of the buffer is recorded as
        a ``rebuild_spill_overflow`` capacity event."""
        _t, _lap = _make_laps()
        # one fetch, and resync the host mirror (callers may have edited
        # the device graph)
        poses = host_array(self.graph.poses)
        self._poses_np[: self._n_poses] = poses[: self._n_poses]
        _lap("pose_fetch_s")
        d = self._inner
        streaming = d.store is not None
        if streaming:
            # an in-flight prefetch or evicted payload belongs to the OLD
            # store
            d.stream_sync()
            _lap("stream_sync_s")
            new_store = BlockStore(self.config.hash)
            spill = d.spill_begin()
        hmap = self._new_map()
        for rec in self.keyframes:
            hmap = self._fuse_only(
                hmap, rec.depth_dev,
                _pose_tensor(poses[rec.index], self.device),
                rec.frame_index,
            )
            rec.map_pose = poses[rec.index].astype(np.float32).copy()
            if streaming:
                hmap = d.spill_evict(hmap, rec.frame_index, spill)
        _lap("fuse_dispatch_s")
        model = self._render_model(hmap, self.state.pose)
        self.state = self.state._replace(hmap=hmap, model=model)
        if streaming:
            # the run's evict / restore totals survive the swap
            new_store.total_evicted += d.store.total_evicted
            new_store.total_restored += d.store.total_restored
            d.store = new_store
            frame = self._frame_idx

            def _overflow(n):
                self.capacity_events.append({
                    "frame": frame,
                    "kind": "rebuild_spill_overflow",
                    "capacity": n,
                })

            d.spill_finish_async(spill, new_store, on_overflow=_overflow)
            _lap("spill_finish_s")
        # the ledger now accounts for every contribution in the map;
        # fusions into the pre-rebuild map are gone with it
        self._ring = []
        self._ring_overflow = False
        self._map_ledgered = True
        self._map_epoch += 1
        self._last_rebuild_detail = _t

    # -- tracking-lost recovery ----------------------------------------------

    def _relocalize(self, depth_raw, valid_px=None):
        """Re-register the live frame against stored keyframes and reset
        the live pose to the best match passing the loop acceptance gates;
        returns the recovered pose (numpy) or None.  Frame-to-model ICP
        has diverged, so the model rendered at the stale pose shares no
        surface with the live frame; keyframes are absolutely posed
        snapshots, and registering against them (from a Procrustes seed or
        identity) recovers an absolute pose.  On success the live pose and
        velocity reset and the model is re-rendered there."""
        f = self.kcfg.icp_downsample
        small = self._kf_pre(depth_raw)
        # blackout gate: nothing to register on a (near-)empty frame.  The
        # full-resolution count from the drain's fetch stands in for the
        # downsampled one (~ valid_px / f^2)
        if valid_px is None:
            valid_small = int(torch.sum(small.depth > 0))
        else:
            valid_small = valid_px // (f * f)
        if valid_small < self.kcfg.min_loop_inliers:
            return None
        cands = self.keyframes[-self.kcfg.reloc_max_candidates:]
        eye = np.eye(4, dtype=np.float32)
        inits = [eye] * len(cands)
        if self.kcfg.reloc_procrustes:
            # closed-form Procrustes seed per candidate, one fetch: the
            # exact rotation solve reaches basins an identity start cannot
            Ts0 = host_array(torch.stack([
                proc.procrustes_init_raced(
                    small, c.frame, self._lcam, self.config.icp,
                    rounds=self.kcfg.reloc_procrustes_rounds)
                for c in cands]))
            inits = [Ts0[i] for i in range(len(cands))]
        Ts, errs, cnts, obs = self._run_batch(
            "fwd", small, [c.frame for c in cands], inits)
        passing = [
            i for i in range(len(cands))
            if self._edge_ok_np(Ts[i], errs[i], cnts[i], obs[i])
        ]
        if passing and self.kcfg.loop_mutual_check:
            rT, _, _, _ = self._run_batch(
                "rev", small, [cands[i].frame for i in passing],
                [np.linalg.inv(Ts[i]) for i in passing],
            )
            passing = [
                i for j, i in enumerate(passing)
                if np.isfinite(rT[j]).all()
                and self._mutual_ok_np(Ts[i] @ rT[j])
            ]
        if not passing:
            return None
        best = max(passing, key=lambda i: (cnts[i], -errs[i]))
        rec = cands[best]
        pose_np = (self._poses_np[rec.index] @ Ts[best]).astype(np.float32)
        d = self._inner
        pose = _pose_tensor(pose_np, self.device)
        model = self._render_model(d.state.hmap, pose)
        d.state = d.state._replace(
            pose=pose, model=model,
            vel=torch.eye(4, dtype=torch.float32, device=self.device))
        self._lost_streak = 0
        self.relocalizations.append({
            "frame": self._frame_idx,
            "keyframe": rec.index,
            "inliers": int(cnts[best]),
            "error": float(errs[best]),
        })
        return pose_np

    # -- warmup --------------------------------------------------------------

    def warm_compile(self, depth_raw) -> None:
        """Touch every backend path once on scratch inputs: keyframe
        preprocess, candidate / relocalization pair ICP, the Procrustes
        seed, BA at the current graph capacity and its fetch, fuse-only /
        reintegrate / model render, and with streaming the inner HashSLAM's
        ``warm_stream``.  This loads the gather kernel and the
        solver and BLAS handles and sizes the allocator's pools before a
        timed run; this instance's SLAM state is not touched (``optimize``
        returns a new graph, the map work runs on a scratch map)."""
        d = hash_slam.depth_tensor(depth_raw, self.device)
        I = torch.eye(4, dtype=torch.float32, device=self.device)
        hm = self._fuse_only(self._new_map(), d, I, 0)
        hm, wcnt = self._reintegrate(hm, d, I, I, 0)
        int(wcnt >= self.config.hash.max_active)
        model = self._render_model(hm, I)
        small = self._kf_pre(d)
        eye = np.eye(4, dtype=np.float32)
        self._run_batch("fwd", small, [small], [eye])
        self._run_batch("rev", small, [small], [eye])
        if self.kcfg.reloc_procrustes:
            host_array(proc.procrustes_init_raced(
                small, small, self._lcam, self.config.icp,
                rounds=self.kcfg.reloc_procrustes_rounds))
        g, wi = self._run_ba()
        host_array(torch.cat([
            g.poses.reshape(-1),
            torch.stack([wi.chi2_initial, wi.chi2_final])]))
        self._inner.warm_stream()     # a no-op without streaming
        float(model.depth.reshape(-1)[0])

    # -- main entry ----------------------------------------------------------

    def process(self, depth_raw) -> hash_slam.StepInfo:
        """One frame: run the frame step, and defer the host-side keyframe
        bookkeeping until ``sync_every`` frames of poses can be fetched in
        one transfer (1 = fetch per frame)."""
        d = hash_slam.depth_tensor(depth_raw, self.device)
        info = self._inner.process(d)
        self.infos.append(info)
        self._frame_idx += 1
        self._pending.append((d, info, self._map_epoch))
        if len(self._pending) >= max(self.kcfg.sync_every, 1):
            self._drain()
        return info

    def flush(self) -> None:
        """Run deferred bookkeeping for all in-flight frames, then any BA
        the deferral window is still holding back."""
        if self._pending:
            self._drain()
        self._maybe_optimize(force=True)

    def settle(self) -> None:
        """Land all in-flight work (pending frames, deferred keyframe
        candidate batches, an async BA solve) without forcing the
        deferred-BA trigger."""
        if self._pending:
            self._drain()
        self._complete_kf_edges()
        if self._ba_inflight is not None:
            self._complete_ba()

    def _drain(self) -> None:
        pend = self._pending
        self._pending = []
        # one host fetch for the whole batch: pose, tracked, valid_px
        arr = host_array(torch.stack([
            torch.cat([i.pose.reshape(16),
                       i.tracked.to(torch.float32).reshape(1),
                       i.valid_px.to(torch.float32).reshape(1)])
            for _, i, _e in pend]))
        frame0 = self._frame_idx - len(pend)
        saved = self._frame_idx
        corr = None   # correction accumulated within this batch
        # previous drains' deferred keyframe batches land here
        self._complete_kf_edges()
        if self._ba_inflight is not None:
            # async BA completion; its correction applies to this whole
            # batch
            corr = self._complete_ba()
        try:
            for b, (d, info, epoch) in enumerate(pend):
                raw_pose = arr[b, :16].reshape(4, 4).astype(np.float32)
                pose_np = raw_pose if corr is None else (
                    corr @ raw_pose
                ).astype(np.float32)
                tracked = arr[b, 16] > 0.5
                valid_px = int(arr[b, 17])
                # event logs inside the per-frame logic stamp the frame's
                # own index, not the batch-end counter
                self._frame_idx = frame0 + b
                c = self._per_frame(d, pose_np, raw_pose, tracked, epoch,
                                    valid_px=valid_px)
                if c is not None:
                    corr = c if corr is None else c @ corr
        finally:
            self._frame_idx = saved

    def _per_frame(self, depth_raw, pose_np, raw_pose, tracked, epoch=None,
                   valid_px=None):
        """Deferred per-frame bookkeeping.  ``raw_pose`` is the pose the
        step actually fused at (before any in-batch correction or
        relocalization): the contribution ledger needs it to de-integrate
        exactly.  Returns a BA correction to apply to later in-flight
        frames, or None."""
        correction = None
        if tracked:
            self._lost_streak = 0
        else:
            self._lost_streak += 1
            r = self.kcfg
            if (
                r.relocalize
                and self.keyframes
                and self._lost_streak >= r.reloc_after
                and (self._lost_streak - r.reloc_after) % r.reloc_interval
                == 0
            ):
                new_pose = self._relocalize(depth_raw, valid_px=valid_px)
                if new_pose is not None:
                    pose_np = new_pose
        if self._should_insert(pose_np):
            correction = self._insert_keyframe(pose_np, depth_raw)
        else:
            # the deferred-BA age trigger can fire between inserts
            correction = self._maybe_optimize()
        if correction is not None:
            pose_np = (correction @ pose_np).astype(np.float32)
        kf = self.keyframes[-1]
        rel = np.linalg.inv(self._poses_np[kf.index]) @ pose_np
        rel = rel.astype(np.float32)
        self._frame_refs.append((kf.index, rel))
        # contribution ledger: the step fused this frame at raw_pose;
        # remember it (bounded window) so incremental corrections can move
        # the contribution exactly.  Overflow invalidates the ledger.  A
        # frame fused into an older map epoch has nothing to track.
        if epoch is None or epoch == self._map_epoch:
            if len(self._ring) < self.kcfg.rebuild_window:
                self._ring.append(_RingEntry(
                    frame_index=self._frame_idx, kf=kf.index, rel=rel,
                    depth=depth_raw, map_pose=raw_pose,
                ))
            else:
                self._ring_overflow = True
        return correction

    def render(self, pose=None):
        """Render the current map (default: from the current pose); under
        a mesh, this rank's rows (``sharded.fetch_output`` assembles the
        image)."""
        return self._inner.render(pose)

    def trajectory(self) -> List[np.ndarray]:
        """Full trajectory with all BA corrections applied retroactively."""
        self.flush()
        poses = self._poses_np
        return [poses[k] @ rel for k, rel in self._frame_refs]

    def keyframe_trajectory(self) -> List[np.ndarray]:
        self.flush()
        return [self._poses_np[rec.index] for rec in self.keyframes]
