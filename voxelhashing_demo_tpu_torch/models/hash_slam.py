"""Voxel-hash SLAM pipeline, the flagship model (port of
models/hash_slam.py, out-of-core streaming included; the JAX package's
``lax.scan`` chunk step is a loop over ``step`` here).

One frame: preprocess -> pyramid ICP (motion prior raced at the coarsest
level) -> motion gate -> periodic GC -> allocate / compact / touch /
integrate -> surface prediction -> model frame for the next frame's
tracking.  The surface prediction is the splat (surface filter / splat /
finalize) or, with ``raycast.mode = "march"``, the sphere-traced march of
a view-local dense cache (ops/hash_raycast.py).

The state is preallocated tensors updated IN PLACE: the map (hundreds of
MB at the flagship size) is written where the JAX version returns new
arrays from a donated state (``make_step``).  ``frame_idx`` is a host
integer, so the GC schedule is a host ``if`` (the JAX ``lax.cond``).

With ``config.stream.enabled`` the wrapper also runs the out-of-core
streaming cycle around the step (see ``HashSLAM``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import HashConfig, PipelineConfig, StreamConfig
from ..device import host_array, resolve
from ..geometry import se3
from ..ops import hash_ops
from ..ops import hash_raycast
from ..ops import icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..utils.blockstore import BlockStore


class HashSLAMState(NamedTuple):
    hmap: hash_ops.HashMap
    pose: torch.Tensor           # (4, 4) camera-to-world of last frame
    model: pre_ops.Frame         # predicted model maps in last camera frame
    frame_idx: int               # frames processed so far (host counter)
    vel: torch.Tensor            # (4, 4) last tracked frame-to-frame motion


class StepInfo(NamedTuple):
    pose: torch.Tensor
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    icp_iters: torch.Tensor
    tracked: torch.Tensor
    blocks_allocated: torch.Tensor   # this frame
    blocks_active: torch.Tensor      # visible set size
    blocks_freed: torch.Tensor       # by GC this frame
    free_blocks: torch.Tensor        # heap headroom
    valid_px: torch.Tensor           # valid depth pixels after prefilter


def create(config: PipelineConfig, device=None) -> HashSLAMState:
    """Fresh state on ``device`` (None: the CUDA card): empty map,
    identity pose, empty model."""
    device = resolve(device)
    cam = config.camera
    H, W = cam.height, cam.width
    f32 = dict(dtype=torch.float32, device=device)
    empty = pre_ops.Frame(
        vertices=torch.zeros((H, W, 3), **f32),
        normals=torch.zeros((H, W, 3), **f32),
        depth=torch.zeros((H, W), **f32),
    )
    return HashSLAMState(
        hmap=hash_ops.create(config.hash, device=device),
        pose=se3.identity(device=device),
        model=empty,
        frame_idx=0,
        vel=se3.identity(device=device),
    )


def _check_supported(config: PipelineConfig) -> None:
    if config.raycast.mode not in ("splat", "march"):
        raise ValueError(f"unknown raycast mode {config.raycast.mode!r} "
                         "(expected 'splat' or 'march')")


def _predict_surface(hmap, active, pose, config: PipelineConfig):
    """The map's surface seen from ``pose``, by the configured mode."""
    if config.raycast.mode == "splat":
        return splat_ops.splat_raycast(
            hmap, active, config.hash, pose, config.camera, config.raycast,
            config.fusion)
    return hash_raycast.raycast_hash(
        hmap, active, config.hash, pose, config.camera, config.raycast,
        config.fusion, cache_dims=config.raycast.cache_dims)


def step(state: HashSLAMState, depth_raw: torch.Tensor,
         config: PipelineConfig):
    """One SLAM frame (updates ``state.hmap`` in place).  depth_raw: (H, W)
    integer depth in camera units, on the state's device.  Returns
    (new_state, StepInfo)."""
    _check_supported(config)
    cam = config.camera
    hcfg = config.hash
    frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

    # --- track (frame-to-model) -------------------------------------------
    model_valid = torch.sum(state.model.depth > 0) > 100
    prior = state.vel if config.icp.use_motion_prior else None
    if len(config.icp.pyramid) > 1:
        result = icp_ops.icp_align_pyramid(
            frame.depth, state.model.depth, cam, config.icp,
            src_full=frame, tgt_full=state.model, prior_T=prior,
        )
    elif prior is not None:
        result = icp_ops.icp_align_raced(frame, state.model, cam, config.icp,
                                         prior)
    else:
        result = icp_ops.icp_align(frame, state.model, cam, config.icp)
    ok = (
        model_valid
        & (result.count > 100)
        & torch.all(torch.isfinite(result.transform))
        & icp_ops.motion_plausible(result.transform, config.icp)
    )
    T_rel = torch.where(ok, result.transform, se3.identity(device=ok.device))
    pose_new = state.pose @ T_rel

    # --- periodic garbage collection (before fusion) -----------------------
    hmap = state.hmap
    n_freed = torch.zeros((), dtype=torch.int32, device=ok.device)
    gc = config.gc
    if gc.enabled and state.frame_idx % gc.interval == gc.interval - 1:
        hmap, n_freed = hash_ops.garbage_collect(
            hmap, hcfg, gc.min_weight, gc.max_blocks_per_gc,
            frame_idx=state.frame_idx, min_age=gc.min_age,
        )

    # --- map update: alloc -> compact -> integrate ------------------------
    hmap, active, n_alloc = hash_ops.fuse_frame(
        hmap, frame, pose_new, cam, hcfg, config.fusion,
        frame_idx=state.frame_idx,
    )

    # --- surface prediction for the next frame's tracking ------------------
    rc = _predict_surface(hmap, active, pose_new, config)
    model = rc_ops.model_frame(rc)

    new_state = HashSLAMState(
        hmap=hmap,
        pose=pose_new,
        model=model,
        frame_idx=state.frame_idx + 1,
        vel=T_rel,
    )
    info = StepInfo(
        pose=pose_new,
        icp_error=result.error,
        icp_count=result.count,
        icp_iters=result.iters,
        tracked=ok,
        blocks_allocated=n_alloc,
        blocks_active=active.count,
        blocks_freed=n_freed,
        free_blocks=hmap.free_top.clone(),
        valid_px=torch.sum(frame.depth > 0).to(torch.int32),
    )
    return new_state, info


def depth_tensor(depth_raw, device) -> torch.Tensor:
    """Host uint16 frame (numpy) or integer tensor -> int32 tensor on
    ``device`` (the frame is widened on the host: uint16 kernels are thin
    in torch)."""
    if isinstance(depth_raw, torch.Tensor):
        return depth_raw.to(device=device, dtype=torch.int32)
    arr = np.asarray(depth_raw)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"depth_raw must be an integer image, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int32)).to(device)




class _Transfers:
    """The streaming cycle's copies between the card and the host.

    Buffers are allocated once: pinned host memory for the cycle record
    (pose | vel, and n_evicted | accepted), ``max_evict`` evicted rows and
    ``max_restore`` restore rows (int32 keys, float32 (R, V) tsdf and
    weight, int32 born), and device buffers for the restore batch.  On a
    CUDA device every copy runs on one side stream: ``pull`` makes it wait
    for the work queued so far on the main stream, copies device->pinned
    without blocking and records ``_pulled``, which ``pulled`` (the
    completion's one blocking wait) synchronizes; ``upload`` copies
    pinned->device the same way and ``uploaded`` makes the main stream wait
    for it.  Device tensors read on the side stream are marked with
    ``record_stream`` so the allocator does not hand their memory out while
    the copy may still read it; a pinned buffer is rewritten only after the
    copy out of it is known to be done (the completion has read the pulled
    rows before the next ``pull``; ``upload`` synchronizes the previous
    upload first).  On the CPU the same calls are plain copies.

    ``log`` collects (direction, bytes, milliseconds) per copy batch, timed
    by CUDA events on the side stream (empty on the CPU)."""

    def __init__(self, device: torch.device, hcfg: HashConfig,
                 scfg: StreamConfig, side=None):
        V = hcfg.voxels_per_block
        E, R = scfg.max_evict, scfg.max_restore
        self.cuda = device.type == "cuda"
        i32 = dict(dtype=torch.int32, pin_memory=self.cuda)
        f32 = dict(dtype=torch.float32, pin_memory=self.cuda)
        self.rec_f = torch.empty(32, **f32)
        self.rec_i = torch.empty(1 + R, **i32)
        self.ev = (torch.empty(E, **i32), torch.empty((E, V), **f32),
                   torch.empty((E, V), **f32), torch.empty(E, **i32))
        self.up = (torch.empty(R, **i32), torch.empty((R, V), **f32),
                   torch.empty((R, V), **f32), torch.empty(R, **i32))
        self.dev = tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                         for t in self.up)
        self.log = []
        self._timing = []      # (direction, bytes, start, end) not yet read
        self.side = self._pulled = self._uploaded = None
        if self.cuda:
            self.side = side if side is not None else torch.cuda.Stream(
                device)
            self._pulled = torch.cuda.Event()
            self._uploaded = torch.cuda.Event()

    def pinned_bytes(self) -> int:
        bufs = (self.rec_f, self.rec_i) + self.ev + self.up
        return sum(t.numel() * t.element_size() for t in bufs)

    def _copies(self, direction: str, pairs, done) -> None:
        """dst.copy_(src) for each pair; on the card on the side stream
        after the main stream's queued work, then ``done`` recorded."""
        if not self.cuda:
            for dst, src in pairs:
                dst.copy_(src)
            return
        main = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.side):
            self.side.wait_stream(main)
            start.record(self.side)
            for dst, src in pairs:
                if src.is_cuda:
                    src.record_stream(self.side)
                dst.copy_(src, non_blocking=True)
            end.record(self.side)
            done.record(self.side)
        nbytes = sum(s.numel() * s.element_size() for _, s in pairs)
        self._timing.append((direction, nbytes, start, end))

    def _read_timing(self) -> None:
        for direction, nbytes, start, end in self._timing:
            end.synchronize()
            self.log.append((direction, nbytes, start.elapsed_time(end)))
        self._timing = []

    def pull(self, rec_f, rec_i, rows) -> None:
        """Start the device->host copy of the cycle record and the evicted
        rows (keys, tsdf, weight, born)."""
        pairs = [(self.rec_f, rec_f), (self.rec_i[:rec_i.shape[0]], rec_i)]
        pairs += list(zip(self.ev, rows))
        self._copies("d2h", pairs, self._pulled)

    def pulled(self):
        """Wait for the last ``pull``; returns (pose | vel float32 (32,),
        n_evicted | accepted int32 (1 + R,)) as numpy views of the pinned
        record."""
        if self.cuda:
            self._pulled.synchronize()
            self._read_timing()
        return self.rec_f.numpy(), self.rec_i.numpy()

    def evicted(self, n: int):
        """Copies of the first ``n`` pulled evicted rows, as numpy (keys,
        tsdf, weight, born); call after ``pulled``."""
        return tuple(t[:n].numpy().copy() for t in self.ev)

    def upload(self, rows) -> None:
        """Start the host->device copy of a restore batch (numpy keys,
        tsdf, weight, born of m rows)."""
        m = rows[0].shape[0]
        if self.cuda:
            self._uploaded.synchronize()   # the pinned rows are free again
        for buf, a in zip(self.up, rows):
            buf[:m].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        self._copies("h2d", [(d[:m], u[:m])
                             for d, u in zip(self.dev, self.up)],
                     self._uploaded)

    def uploaded(self, m: int):
        """The last upload's m rows on the device, with the main stream
        ordered after the copy."""
        if self.cuda:
            torch.cuda.current_stream().wait_event(self._uploaded)
        return tuple(d[:m] for d in self.dev)


class HashSLAM:
    """Host-side wrapper accumulating the trajectory.

    ``HashSLAM(config, device)`` owns one state on ``device`` (None: the
    CUDA card; the CPU only when asked for); ``process`` steps one raw
    depth frame, ``process_chunk`` a stack of them, ``render`` predicts the
    surface from any pose, ``trajectory`` and ``infos`` collect each frame's
    pose and StepInfo (device tensors).

    With ``config.stream.enabled`` the device map holds only the working
    set: blocks out of view for more than ``stream.max_age`` frames go to a
    host ``BlockStore`` (``self.store``) and come back when the camera
    returns.  Each ``stream.interval``-frame cycle is split in two halves,
    on the schedule of the JAX package (which decides the results):

    - at the boundary (frames processed % interval == 0, before the step),
      ``_cycle_dispatch``: the restore of the batch prepared last cycle at
      ``state.frame_idx``, then the eviction scan at ``state.frame_idx``;
      the cycle record [n_evicted, pose, vel, accepted] and the evicted
      rows start their copy to the host;
    - at ``max(interval // 2, 1)``, ``_cycle_complete``: the one wait on
      that copy, ``store.take`` of the restored keys the device accepted,
      ``store.add`` of the PREVIOUS cycle's evicted rows (this cycle's wait
      for the next completion: between its eviction and then a block is on
      neither side), and the next restore batch: the store's keys in the
      frustum at ``pose @ vel ** (2 * interval)``, packed and uploaded.

    The JAX package runs the completion on a worker thread; here it runs on
    the calling thread (a frame on the card already waits on the host at
    every ICP iteration).  ``_join_complete`` stays the one serialization
    point: a deferred landing (``spill_finish_async``) runs there."""

    def __init__(self, config: PipelineConfig, device=None):
        device = resolve(device)
        self._setup(config, device, create(config, device=device), [],
                    BlockStore(config.hash) if config.stream.enabled
                    else None)

    @classmethod
    def _restore(cls, config: PipelineConfig, state: HashSLAMState,
                 trajectory, store: BlockStore | None,
                 device) -> "HashSLAM":
        """A HashSLAM at a given state (checkpoint restore,
        utils/checkpoint.py): ``trajectory`` the poses so far (tensors on
        ``device``), ``store`` the streaming store (None: an empty one when
        the config streams).  The streaming cycle starts quiesced and the
        infos empty."""
        slam = cls.__new__(cls)
        if store is None and config.stream.enabled:
            store = BlockStore(config.hash)
        slam._setup(config, resolve(device), state, list(trajectory),
                    store if config.stream.enabled else None)
        return slam

    def _setup(self, config, device, state, trajectory, store) -> None:
        _check_supported(config)
        self.config = config
        self.device = device
        self.state = state
        self.trajectory = trajectory
        self.infos = []
        self.store = store
        if store is not None:
            self._init_stream_runtime()

    def _init_stream_runtime(self) -> None:
        """The streaming cycle's state and its transfer buffers."""
        # keys of the restore batch uploaded at the last completion,
        # dispatched at the next boundary
        self._prefetch = None
        # numpy rows (keys, tsdf, weight, born) evicted last cycle; they
        # land in the store at the next completion
        self._pending_evict = None
        # (restored keys, rows to land) between a dispatch and its
        # completion
        self._inflight = None
        # deferred landing run by _join_complete (spill_finish_async)
        self._completing = None
        self._xfer = _Transfers(self.device, self.config.hash,
                                self.config.stream)

    # -- the streaming cycle -------------------------------------------------

    def _pack_restore(self, keys: np.ndarray) -> None:
        """Pack the stored rows of ``keys`` and start their upload."""
        tsdf, weight, born = self.store.rows_for(keys)
        self._xfer.upload((keys.astype(np.int32), tsdf, weight, born))

    def _restore_uploaded(self, keys: np.ndarray) -> torch.Tensor:
        """Restore the uploaded batch of ``keys`` into the map at
        ``state.frame_idx``; returns the device's accepted mask."""
        k, t, w, b = self._xfer.uploaded(keys.shape[0])
        hmap, accepted = hash_ops.restore_blocks(
            self.state.hmap, self.config.hash, k, t, w, self.state.frame_idx,
            max_weight=self.config.fusion.max_weight, born_rows=b)
        self.state = self.state._replace(hmap=hmap)
        return accepted

    def _join_complete(self) -> None:
        """Run a deferred landing, if any; afterwards the store,
        ``_prefetch`` and ``_pending_evict`` are current."""
        if self._completing is not None:
            work = self._completing
            self._completing = None
            work()

    def stream_sync(self) -> None:
        """Quiesce the streaming pipeline: complete any in-flight cycle,
        restore any prefetched batch (taking its accepted keys out of the
        store), and land any pending evicted rows.  Callers that swap the
        store, snapshot it, or need the device map fully current
        (incremental reintegration) run this first."""
        if self.store is None:
            return
        self._cycle_complete()
        self._join_complete()
        if self._prefetch is not None:
            keys = self._prefetch
            self._prefetch = None
            accepted = self._restore_uploaded(keys)
            self.store.take(keys, host_array(accepted))
        if self._pending_evict is not None:
            rows = self._pending_evict
            self._pending_evict = None
            self.store.add(*rows)

    def warm_stream(self) -> None:
        """Touch every streaming path once against scratch state: the
        eviction scan, a restore, the rebuild spill (evict, append, land)
        and both copy directions at the configured batch sizes, through a
        scratch set of buffers on this instance's side stream.  This
        instance's map, store and buffers are left as they were."""
        if self.store is None:
            return
        cfg, s = self.config, self.config.stream
        hm = hash_ops.create(cfg.hash, device=self.device)
        hm, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hm, cfg.hash, 0, s.max_age, s.max_evict)
        xfer = _Transfers(self.device, cfg.hash, s, side=self._xfer.side)
        xfer.pull(self.state.pose.new_zeros(32),
                  torch.cat([n.reshape(1), n.reshape(1)]),
                  (keys, tsdf, weight, born))
        xfer.pulled()
        m = min(s.max_evict, s.max_restore)
        xfer.upload(xfer.evicted(m))   # EMPTY_KEY rows: restores nothing
        k, t, w, b = xfer.uploaded(m)
        hm, accepted = hash_ops.restore_blocks(
            hm, cfg.hash, k, t, w, 0, max_weight=cfg.fusion.max_weight,
            born_rows=b)
        spill = self.spill_begin()
        hm = self.spill_evict(hm, 0, spill)
        self.spill_finish(spill, BlockStore(cfg.hash))
        host_array(accepted)

    def _cycle_dispatch(self) -> None:
        """Interval-boundary half of the cycle: the prefetched restore, the
        eviction scan, and the start of the record's copy to the host."""
        self._join_complete()
        st = self.state
        s = self.config.stream
        taken = None
        accepted = torch.zeros(0, dtype=torch.bool, device=self.device)
        if self._prefetch is not None:
            taken = self._prefetch
            self._prefetch = None
            accepted = self._restore_uploaded(taken)
            st = self.state
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            st.hmap, self.config.hash, st.frame_idx, s.max_age, s.max_evict)
        self.state = st._replace(hmap=hmap)
        self._xfer.pull(
            torch.cat([st.pose.reshape(16), st.vel.reshape(16)]),
            torch.cat([n.reshape(1), accepted.to(torch.int32)]),
            (keys, tsdf, weight, born))
        # last cycle's evicted rows land with this cycle's completion
        self._inflight = (taken, self._pending_evict)
        self._pending_evict = None

    def _cycle_complete(self, horizon: int | None = None) -> None:
        """Mid-interval half of the cycle: the one wait on the record, the
        store's bookkeeping, and the next restore batch's query and upload.
        ``horizon``: frames ahead of the boundary pose at which the next
        restore frustum is predicted (default 2 x interval)."""
        if self._inflight is None:
            return
        taken, rows = self._inflight
        self._inflight = None
        self._join_complete()
        self._complete_work(taken, rows, horizon)

    def _complete_work(self, taken, rows, horizon: int | None) -> None:
        s = self.config.stream
        rec_f, rec_i = self._xfer.pulled()
        n = int(rec_i[0])
        pose = rec_f[:16].reshape(4, 4)
        vel = rec_f[16:].reshape(4, 4)
        if taken is not None:
            self.store.take(taken, rec_i[1:1 + taken.shape[0]] > 0)
        if rows is not None:
            self.store.add(*rows)
        if n > 0:
            self._pending_evict = self._xfer.evicted(n)
        # the next restore batch: the frustum at the constant-velocity pose
        # ``horizon`` frames past the boundary (the restore dispatches one
        # interval after the boundary and covers the interval beyond it)
        if len(self.store):
            hor = 2 * s.interval if horizon is None else horizon
            pred = pose @ np.linalg.matrix_power(vel, hor)
            keys = self.store.query_frustum(
                pred, self.config.camera, self.config.fusion,
                s.restore_margin_px, s.max_restore)
            if keys.size:
                self._pack_restore(keys)
                self._prefetch = keys

    def _restore_keys(self, keys: np.ndarray) -> None:
        """Restore the given stored keys onto the device now (the keyframe
        backend pulls a moved frame's frustums back before de-integrating).
        Quiesces the pipeline first; keys that the quiesce already brought
        back are dropped from the batch."""
        self.stream_sync()
        if keys.size:
            keys = keys[np.fromiter(
                (int(k) in self.store._index for k in keys), bool,
                keys.shape[0])]
        if keys.size == 0:
            return
        self._pack_restore(keys)
        accepted = self._restore_uploaded(keys)
        self.store.take(keys, host_array(accepted))

    def _evict_into(self, hmap, frame_idx: int, store: BlockStore):
        """Evict from ``hmap`` and move the evicted rows into ``store``,
        synchronously."""
        s = self.config.stream
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hmap, self.config.hash, frame_idx, s.max_age, s.max_evict)
        n = int(n)
        if n > 0:
            store.add(*(host_array(t[:n]) for t in (keys, tsdf, weight,
                                                    born)))
        return hmap

    # -- rebuild spill session (the keyframe backend's streaming rebuild) ----

    def spill_begin(self) -> dict:
        """A fresh device spill buffer for a streaming map rebuild: the
        rebuild's per-keyframe evictions append to it on the device and
        land in the host store at once (``spill_finish``).  It holds
        ``4 x num_blocks`` rows, plus one row that takes the dropped
        writes."""
        cap = 4 * self.config.hash.num_blocks
        V = self.config.hash.voxels_per_block
        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "cap": cap,
            "keys": torch.full((cap + 1,), hash_ops.EMPTY_KEY, **i32),
            "tsdf": torch.zeros((cap + 1, V), **f32),
            "weight": torch.zeros((cap + 1, V), **f32),
            "born": torch.zeros((cap + 1,), **i32),
            "count": torch.zeros((), **i32),
        }

    def spill_evict(self, hmap, frame_idx: int, spill: dict):
        """Evict stale blocks from ``hmap`` into the spill buffer (device
        work only, no host sync).  Rows past the capacity are dropped; the
        count keeps growing so ``spill_finish`` reports the overflow."""
        s = self.config.stream
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hmap, self.config.hash, int(frame_idx), s.max_age, s.max_evict)
        cap = spill["cap"]
        pos = torch.arange(keys.shape[0], device=keys.device)
        idx = torch.where(pos < n, spill["count"] + pos, cap).clamp(max=cap)
        for name, rows in (("keys", keys), ("tsdf", tsdf),
                           ("weight", weight), ("born", born)):
            spill[name][idx] = rows       # row cap collects the drops
        spill["count"] = spill["count"] + n
        return hmap

    def spill_finish(self, spill: dict, store: BlockStore) -> int:
        """Copy the spill buffer's rows into ``store``.  Returns the number
        of rows dropped to buffer overflow (0 normally; the caller surfaces
        it)."""
        n = int(spill["count"])
        if n == 0:
            return 0
        cap = spill["cap"]
        m = min(n, cap)
        store.add(*(host_array(spill[k][:m])
                    for k in ("keys", "tsdf", "weight", "born")))
        return max(0, n - cap)

    def spill_finish_async(self, spill: dict, store: BlockStore,
                           on_overflow=None) -> None:
        """Defer ``spill_finish`` to the next ``stream_sync`` / cycle join:
        the device map is already rebuilt, and every consumer of the store
        joins first, so the store and map come out as with the synchronous
        call.  ``on_overflow`` (optional) gets the dropped-row count."""
        self._join_complete()

        def work():
            overflow = self.spill_finish(spill, store)
            if overflow and on_overflow is not None:
                on_overflow(overflow)

        self._completing = work

    # -- frames --------------------------------------------------------------

    def process(self, depth_raw) -> StepInfo:
        if self.store is not None:
            s = self.config.stream
            i = len(self.trajectory) % s.interval
            if i == 0:
                # catch-up completion for interval 1 and after a chunk
                # (a no-op when already done)
                self._cycle_complete()
                self._cycle_dispatch()
            elif i == max(s.interval // 2, 1):
                self._cycle_complete()
        self.state, info = step(
            self.state, depth_tensor(depth_raw, self.device), self.config)
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info

    def process_chunk(self, depths_raw) -> StepInfo:
        """Process a (K, H, W) chunk of frames; per-frame results equal K
        ``process`` calls without streaming.  Returns the StepInfo fields
        stacked along axis 0.

        With streaming, ONE cycle runs at the chunk boundary, as in the JAX
        package's scanned chunk: the chunk's frames share one restore
        prediction, ``K + interval`` frames ahead, and the cycle completes
        at the next chunk boundary."""
        frames = [depth_tensor(d, self.device) for d in depths_raw]
        if self.store is not None:
            self._cycle_complete(horizon=len(frames)
                                 + self.config.stream.interval)
            self._cycle_dispatch()
        infos = []
        for d in frames:
            self.state, info = step(self.state, d, self.config)
            self.trajectory.append(info.pose)
            self.infos.append(info)
            infos.append(info)
        return StepInfo(*(torch.stack(f) for f in zip(*infos)))

    def render(self, pose=None) -> rc_ops.RaycastOutput:
        """Predict the surface from ``pose`` (default: the current pose),
        by the configured mode (splat or march)."""
        if pose is None:
            pose = self.state.pose
        else:
            pose = torch.as_tensor(pose, dtype=torch.float32,
                                   device=self.device)
        cfg = self.config
        active = hash_ops.compact_visible(
            self.state.hmap, cfg.hash, pose, cfg.camera, cfg.fusion)
        return _predict_surface(self.state.hmap, active, pose, cfg)
