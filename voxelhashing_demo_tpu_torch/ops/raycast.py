"""Sphere-traced raycasting of the dense TSDF (port of ops/raycast.py):
rendering, and the model maps for frame-to-model tracking.

The whole image of rays marches in lockstep for ``rc.max_steps`` steps,
sampling the TSDF trilinearly.  Stepping is adaptive per ray: coarse
steps through unobserved space, |sdf|-sized steps near the surface, then
a secant refinement at the zero crossing.

Kept from the JAX version on purpose: ``prev_sdf`` starts at +inf, so a
ray whose FIRST known sample is already <= 0 counts as crossed and its
secant step is ``inf / inf`` = NaN; the final ``t_hit > near`` test
rejects that ray (a comparison with NaN is false).  The NaN is not
cleaned up, or the hit masks would differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraConfig, FusionConfig, RaycastConfig
from ..geometry import camera as cam_geom
from .preprocess import Frame, _norm, compute_normals
from .tsdf import DenseTSDF, sdf_gradient, trilinear_sample


class RaycastOutput(NamedTuple):
    depth: torch.Tensor     # (H, W) z-depth in camera frame; 0 = miss
    points: torch.Tensor    # (H, W, 3) camera-space hit positions
    normals: torch.Tensor   # (H, W, 3) camera-space unit normals
    hit: torch.Tensor       # (H, W) bool


def raycast_dense(
    state: DenseTSDF,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Render depth/normal maps of the dense TSDF from pose ``T_wc``
    (camera-to-world)."""
    rays = cam_geom.pixel_rays(cam, device=state.sdf.device)
    return raycast_rays(state, T_wc, rays, rc)


def raycast_rays(
    state: DenseTSDF,
    T_wc: torch.Tensor,
    rays_cam: torch.Tensor,
    rc: RaycastConfig,
) -> RaycastOutput:
    """Sphere-trace an (h, w, 3) bundle of camera-space rays (z-depth
    parameterized)."""
    R = T_wc[:3, :3]
    origin = T_wc[:3, 3]
    dirs = rays_cam @ R.T                                 # world, z-depth param
    inv_len = 1.0 / _norm(dirs)                           # meters per unit t
    vox = state.voxel_size
    min_step = rc.min_step * vox
    coarse_step = rc.coarse_step * vox

    zero = torch.zeros(rays_cam.shape[:2], dtype=torch.float32,
                       device=rays_cam.device)
    t = zero + rc.near
    t_hit = zero
    hit = torch.zeros_like(zero, dtype=torch.bool)
    prev_sdf = zero + math.inf                            # +inf = none yet
    prev_t = t
    for _ in range(rc.max_steps):
        s, w = trilinear_sample(state, origin + dirs * t[..., None])
        known = w > 0

        crossed = known & (s <= 0) & (prev_sdf > 0)
        # secant refinement between prev_t and t
        diff = prev_sdf - s
        denom = torch.where(torch.abs(diff) > 1e-12, diff, 1e-12)
        t_ref = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = torch.where(crossed & ~hit, t_ref, t_hit)
        hit = hit | crossed

        # step: sphere trace when known, coarse through unknown space
        step_m = torch.where(
            known,
            torch.maximum(rc.step_scale * torch.abs(s), min_step),
            coarse_step,
        )
        prev_sdf = torch.where(known, s, prev_sdf)
        prev_t = torch.where(known, t, prev_t)
        t = torch.where(hit, t, t + step_m * inv_len)
    hit = hit & (t_hit > rc.near) & (t_hit < rc.far)

    depth = torch.where(hit, t_hit, 0.0)
    points = rays_cam * depth[..., None]                  # camera frame

    if rc.normal_mode == "gradient":
        g = sdf_gradient(state, origin + dirs * t_hit[..., None])
        glen = _norm(g, keepdim=True)
        n_world = torch.where(glen > 1e-9, g / torch.clamp(glen, min=1e-9),
                              0.0)
        n_cam = n_world @ R                               # R^T n (world->cam)
        # orient toward the camera
        flip = torch.sum(n_cam * rays_cam, dim=-1, keepdim=True) > 0
        n_cam = torch.where(flip, -n_cam, n_cam)
    else:
        n_cam = compute_normals(points)
    normals = torch.where(hit[..., None], n_cam, 0.0)
    points = torch.where(hit[..., None], points, 0.0)
    return RaycastOutput(depth=depth, points=points, normals=normals, hit=hit)


def model_frame(out: RaycastOutput) -> Frame:
    """Package a raycast as a tracking Frame (frame-to-model target)."""
    return Frame(vertices=out.points, normals=out.normals, depth=out.depth)


def shade(out: RaycastOutput, light_dir=(0.0, 0.0, -1.0)) -> torch.Tensor:
    """Lambertian shading of a raycast for visualization, (H, W) in
    [0, 1]."""
    l = torch.tensor(light_dir, dtype=torch.float32, device=out.hit.device)
    l = l / _norm(l)
    lam = torch.clamp(torch.sum(out.normals * l, dim=-1), 0.0, 1.0)
    return torch.where(out.hit, 0.1 + 0.9 * lam, 0.0)
