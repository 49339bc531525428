"""Voxel-hash SLAM pipeline, the flagship model (port of
models/hash_slam.py without streaming or the scanned multi-frame step).

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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve
from ..geometry import se3
from ..ops import hash_ops
from ..ops import hash_raycast
from ..ops import icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops


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
    if config.stream.enabled:
        raise NotImplementedError("streaming is not ported yet")
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
    else:
        result = icp_ops.icp_align(frame, state.model, cam, config.icp)
        if prior is not None:
            raced = icp_ops.icp_align(frame, state.model, cam, config.icp,
                                      init_T=prior)
            packed = icp_ops.pack_target(state.model)
            sn, sd = icp_ops.alignment_score_sums(
                raced.transform, frame, state.model, cam, config.icp, packed)
            bn, bd = icp_ops.alignment_score_sums(
                result.transform, frame, state.model, cam, config.icp,
                packed)
            result = icp_ops.pick_by_score(
                raced, result,
                sn / torch.clamp(sd, min=1.0), bn / torch.clamp(bd, min=1.0),
            )
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


class HashSLAM:
    """Host-side wrapper accumulating the trajectory.

    ``HashSLAM(config, device)`` owns one state on ``device`` (None: the
    CUDA card; the CPU only when asked for); ``process`` steps one raw
    depth frame, ``render`` predicts the surface from any pose,
    ``trajectory`` and ``infos`` collect each frame's pose and StepInfo
    (device tensors)."""

    def __init__(self, config: PipelineConfig, device=None):
        _check_supported(config)
        self.config = config
        self.device = resolve(device)
        self.state = create(config, device=self.device)
        self.trajectory = []
        self.infos = []

    def process(self, depth_raw) -> StepInfo:
        self.state, info = step(
            self.state, depth_tensor(depth_raw, self.device), self.config)
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info

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
