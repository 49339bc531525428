"""Dense-grid SLAM pipeline (port of models/dense_slam.py): every frame
runs

    preprocess -> ICP against the raycast model -> integrate -> raycast

on one dense TSDF volume.  Frame-to-model tracking (the raycast maps as
the ICP target) drifts far less than frame-to-frame.  ``frame_idx`` is a
host integer, as in the port's HashSLAMState.

On the card a step is hand kernels and a little pose glue, with no host
read: K3a (preprocess), K3b's pack job (the model packed as the ICP
target), K4 (ICP, one level), K20 (fusion) and K11 (the raycast).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..device import resolve
from ..geometry import se3
from ..ops import icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import tsdf as tsdf_ops
from .hash_slam import depth_tensor


class DenseSLAMState(NamedTuple):
    tsdf: tsdf_ops.DenseTSDF
    pose: torch.Tensor         # (4, 4) camera-to-world of last frame
    model: pre_ops.Frame       # raycast model maps in last camera frame
    frame_idx: int             # frames processed so far (host counter)


class StepInfo(NamedTuple):
    pose: torch.Tensor
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    icp_iters: torch.Tensor
    tracked: torch.Tensor      # bool: ICP ran and its motion was accepted


def create(config: PipelineConfig, device=None) -> DenseSLAMState:
    """Fresh state on ``device`` (None: the CUDA card)."""
    device = resolve(device)
    cam = config.camera
    H, W = cam.height, cam.width
    f32 = dict(dtype=torch.float32, device=device)
    empty = pre_ops.Frame(
        vertices=torch.zeros((H, W, 3), **f32),
        normals=torch.zeros((H, W, 3), **f32),
        depth=torch.zeros((H, W), **f32),
    )
    return DenseSLAMState(
        tsdf=tsdf_ops.create_dense(config.grid, config.fusion, device),
        pose=se3.identity(device=device),
        model=empty,
        frame_idx=0,
    )


def step(state: DenseSLAMState, depth_raw: torch.Tensor,
         config: PipelineConfig):
    """One SLAM frame.  depth_raw: (H, W) integer depth in camera units,
    on the state's device.  Returns (new_state, StepInfo)."""
    cam = config.camera
    frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

    # --- track (frame-to-model) -------------------------------------------
    model_valid = torch.sum(state.model.depth > 0) > 100
    result = icp_ops.icp_align(
        frame, None, cam, config.icp,
        tgt_packed=pre_ops.pack_model(state.model, cam))
    # ICP maps new-frame camera coords into last-frame camera coords, so
    # pose_new = pose_prev @ T_icp; constant position when the model is
    # empty (first frame) or tracking failed
    ok = (
        model_valid
        & (result.count > 100)
        & torch.all(torch.isfinite(result.transform))
        & icp_ops.motion_plausible(result.transform, config.icp)
    )
    T_rel = torch.where(ok, result.transform, se3.identity(device=ok.device))
    pose_new = state.pose @ T_rel

    # --- fuse, then raycast the model for the next frame -------------------
    tsdf_new = tsdf_ops.integrate_dense(
        state.tsdf, frame.depth, pose_new, cam, config.fusion)
    rc = rc_ops.raycast_dense(
        tsdf_new, pose_new, cam, config.raycast, config.fusion)

    new_state = DenseSLAMState(
        tsdf=tsdf_new,
        pose=pose_new,
        model=rc_ops.model_frame(rc),
        frame_idx=state.frame_idx + 1,
    )
    info = StepInfo(
        pose=pose_new,
        icp_error=result.error,
        icp_count=result.count,
        icp_iters=result.iters,
        tracked=ok,
    )
    return new_state, info


class DenseSLAM:
    """Host-side wrapper accumulating the trajectory; the state lives on
    ``device`` (None: the CUDA card)."""

    def __init__(self, config: PipelineConfig, device=None):
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

    def render(self) -> rc_ops.RaycastOutput:
        cfg = self.config
        return rc_ops.raycast_dense(
            self.state.tsdf, self.state.pose, cfg.camera, cfg.raycast,
            cfg.fusion)
