"""Dense TSDF volume: Curless-Levoy depth fusion on a regular grid (port
of ops/tsdf.py).

    sdf   = depth(project(voxel)) - voxel_camera.z
    fuse if sdf > -truncation, clamped to [-truncation, +truncation]
    voxel.sdf    = (old.sdf * old.w + sdf * w_new) / (old.w + w_new)
    voxel.weight = min(max_weight, old.w + w_new)

with the depth-dependent truncation band (truncation + trunc_scale *
depth) and the depth-falloff sample weight.  The volume also serves as
the view-local cache the hash raycaster marches (ops/hash_raycast.py).

``DenseTSDF.voxel_size`` is a 0-d float32 tensor on the volume's device,
as it is an array in the JAX version: ``x / state.voxel_size`` is then a
true division on both devices, which is what the jitted JAX code does
with a traced scalar (a division by a Python constant would be a
reciprocal multiply, see geometry/f32.py).  A ``floor`` follows, so the
difference would move samples to the next voxel.

``integrate_dense`` returns a new volume (the inputs are not written).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig, DenseGridConfig, FusionConfig
from ..device import resolve
from ..geometry import camera as cam_geom
from ..geometry import se3
from ..geometry.f32 import recip


class DenseTSDF(NamedTuple):
    """Dense TSDF volume state."""

    sdf: torch.Tensor         # (X, Y, Z) float32, truncated signed distance
    weight: torch.Tensor      # (X, Y, Z) float32, accumulated confidence
    origin: torch.Tensor      # (3,) world position of voxel (0,0,0) center
    voxel_size: torch.Tensor  # () float32


def create_dense(grid: DenseGridConfig, fusion: FusionConfig,
                 device=None) -> DenseTSDF:
    """Fresh volume on ``device`` (None: the CUDA card)."""
    f32 = dict(dtype=torch.float32, device=resolve(device))
    return DenseTSDF(
        sdf=torch.full(grid.dims, fusion.truncation, **f32),
        weight=torch.zeros(grid.dims, **f32),
        origin=torch.tensor(grid.origin, **f32),
        voxel_size=torch.tensor(fusion.voxel_size, **f32),
    )


def voxel_world_positions(state: DenseTSDF) -> torch.Tensor:
    """World-space centers of every voxel, (X, Y, Z, 3)."""
    X, Y, Z = state.sdf.shape
    f32 = dict(dtype=torch.float32, device=state.sdf.device)
    ix, iy, iz = torch.meshgrid(
        torch.arange(X, **f32), torch.arange(Y, **f32),
        torch.arange(Z, **f32), indexing="ij")
    grid = torch.stack([ix, iy, iz], dim=-1)
    return state.origin + grid * state.voxel_size


def sample_weight(
    depth: torch.Tensor, cam: CameraConfig, fusion: FusionConfig
) -> torch.Tensor:
    """Per-observation fusion weight: with depth_weight_falloff, closer
    depth gets higher confidence, floored at 1."""
    if not fusion.depth_weight_falloff:
        return torch.full_like(depth, fusion.weight_sample)
    depth01 = torch.clamp(
        (depth - cam.depth_min) * recip(cam.depth_max - cam.depth_min),
        0.0, 1.0,
    )
    return torch.clamp(fusion.weight_sample * 1.5 * (1.0 - depth01), min=1.0)


def integrate_dense(
    state: DenseTSDF,
    depth_m: torch.Tensor,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
) -> DenseTSDF:
    """Fuse one metric depth map taken at camera-to-world pose ``T_wc``,
    over the whole volume at once."""
    world = voxel_world_positions(state)                  # (X, Y, Z, 3)
    pc = se3.apply(se3.inverse(T_wc), world)              # camera frame
    ij, in_img = cam_geom.project_nearest(pc, cam)

    u = torch.clamp(ij[..., 0], 0, cam.width - 1).long()
    v = torch.clamp(ij[..., 1], 0, cam.height - 1).long()
    depth = depth_m[v, u]                                 # (X, Y, Z) gather

    z = pc[..., 2]
    sdf = depth - z
    trunc = fusion.truncation + fusion.trunc_scale * depth
    valid = in_img & (depth > 0) & (z > 0) & (sdf > -trunc)
    sdf = torch.minimum(torch.maximum(sdf, -trunc), trunc)

    w_new = torch.where(valid, sample_weight(depth, cam, fusion), 0.0)
    w_old = state.weight
    w_sum = w_old + w_new
    fused = torch.where(
        w_sum > 0,
        (state.sdf * w_old + sdf * w_new) / torch.clamp(w_sum, min=1e-12),
        state.sdf,
    )
    return state._replace(
        sdf=torch.where(valid, fused, state.sdf),
        weight=torch.where(
            valid, torch.clamp(w_sum, max=fusion.max_weight), w_old),
    )


def trilinear_sample(
    state: DenseTSDF, pos_world: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinearly interpolated (sdf, weight) at world positions (..., 3).
    Out-of-volume samples, and samples with an unobserved corner, return
    weight 0 (unknown)."""
    g = (pos_world - state.origin) / state.voxel_size     # continuous voxel
    base = torch.floor(g).to(torch.int32)                 # (..., 3)
    frac = g - base

    X, Y, Z = state.sdf.shape
    dims = torch.tensor([X, Y, Z], dtype=torch.int32, device=base.device)
    inside = torch.all((base >= 0) & (base + 1 <= dims - 1), dim=-1)
    b = torch.minimum(torch.clamp(base, min=0), dims - 2).long()
    flat0 = (b[..., 0] * Y + b[..., 1]) * Z + b[..., 2]
    sdf_flat = state.sdf.reshape(-1)
    wgt_flat = state.weight.reshape(-1)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    acc_s = 0.0
    acc_w = 0.0
    min_w = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = flat0 + ((dx * Y + dy) * Z + dz)
                s = sdf_flat[idx]
                w = wgt_flat[idx]
                wt = (
                    (fx if dx else 1 - fx)
                    * (fy if dy else 1 - fy)
                    * (fz if dz else 1 - fz)
                )
                acc_s = acc_s + wt * s
                acc_w = acc_w + wt * w
                min_w = w if min_w is None else torch.minimum(min_w, w)

    # a corner with zero weight means the interpolation crosses unknown
    # space; report weight 0 so the raycaster treats it as unobserved
    known = inside & (min_w > 0)
    return torch.where(known, acc_s, 0.0), torch.where(known, acc_w, 0.0)


def sdf_gradient(state: DenseTSDF, pos_world: torch.Tensor) -> torch.Tensor:
    """Central-difference SDF gradient (world frame) at (..., 3) positions."""
    h = state.voxel_size
    grads = []
    for axis in range(3):
        e = torch.zeros((3,), dtype=torch.float32, device=h.device)
        e[axis] = h
        sp, _ = trilinear_sample(state, pos_world + e)
        sm, _ = trilinear_sample(state, pos_world - e)
        grads.append((sp - sm) / (2.0 * h))
    return torch.stack(grads, dim=-1)
