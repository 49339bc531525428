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
On CUDA tensors it is one launch of the hand-written kernel K20
``integrate_dense`` (``csrc/dense.cu``): a thread a run of voxels along
z, the pose's inverse computed in the kernel, no host read.  CPU tensors
run ``integrate_dense_reference``, the plain version, which the tests and
the card checks also call on the card.  A launch that the kernel does not
take raises; nothing falls back.  ``LAUNCHES_DENSE`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..config import CameraConfig, DenseGridConfig, FusionConfig
from ..device import resolve
from ..geometry import camera as cam_geom
from ..geometry import se3
from ..geometry.f32 import recip

LAUNCHES_DENSE = 0      # K20 integrate_dense

# K20's host tables a camera, fusion configuration and volume shape:
# (id(cam), id(fusion), X, Y, Z) -> (cam, fusion, tables), kept by the
# objects' identity (``_dense_tables``)
_DENSE_TABLES: dict = {}


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
    over the whole volume at once: one K20 launch on CUDA tensors,
    ``integrate_dense_reference`` on CPU tensors."""
    if all(t.device.type == "cpu" for t in (*state, depth_m, T_wc)):
        return integrate_dense_reference(state, depth_m, T_wc, cam, fusion)
    return _launch_dense(state, depth_m, T_wc, cam, fusion)


def integrate_dense_reference(
    state: DenseTSDF,
    depth_m: torch.Tensor,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
) -> DenseTSDF:
    """Plain version of ``integrate_dense``, on any device."""
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


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _dense_tables(cam: CameraConfig, fusion: FusionConfig,
                  dims: tuple) -> tuple:
    """K20's host tables for ``cam``, ``fusion`` and a volume of ``dims``:
    ints (X, Y, Z, H, W, falloff) and floats (fx, fy, cx, cy, truncation,
    trunc_scale, weight_sample, weight_sample * 1.5, depth_min,
    recip(depth_max - depth_min), max_weight; ctypes rounds each to its
    float32, as torch does with a Python double against a float32 tensor),
    built once and kept by the objects' identity; or raise."""
    key = (id(cam), id(fusion), *dims)
    got = _DENSE_TABLES.get(key)
    if got is not None and got[0] is cam and got[1] is fusion:
        return got[2]
    X, Y, Z = dims
    if min(dims) < 1 or cam.width < 1 or cam.height < 1:
        raise ValueError(f"integrate_dense: a volume and an image of at "
                         f"least one voxel and pixel expected, got {dims}, "
                         f"{(cam.height, cam.width)}")
    if X * Y * Z >= 2 ** 31:
        raise ValueError(f"integrate_dense: a volume below 2^31 voxels "
                         f"expected (32-bit indexing), got {dims}")
    tables = ((ctypes.c_int * 6)(X, Y, Z, cam.height, cam.width,
                                 int(fusion.depth_weight_falloff)),
              (ctypes.c_float * 11)(
                  cam.fx, cam.fy, cam.cx, cam.cy, fusion.truncation,
                  fusion.trunc_scale, fusion.weight_sample,
                  fusion.weight_sample * 1.5, cam.depth_min,
                  recip(cam.depth_max - cam.depth_min), fusion.max_weight))
    if len(_DENSE_TABLES) >= 64:
        _DENSE_TABLES.clear()
    _DENSE_TABLES[key] = (cam, fusion, tables)
    return tables


def _launch_dense(state: DenseTSDF, depth_m: torch.Tensor,
                  T_wc: torch.Tensor, cam: CameraConfig,
                  fusion: FusionConfig) -> DenseTSDF:
    """K20 on the current stream: the new volume of a float32 volume (sdf
    and weight (X, Y, Z), origin (3,), voxel_size ()), depth (H, W) and
    pose (4, 4), all contiguous on one CUDA device; or raise."""
    sdf, weight, origin, vox = state
    dev = sdf.device
    tensors = (sdf, weight, origin, vox, depth_m, T_wc)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("integrate_dense: the volume, the depth and the "
                         "pose must lie on one CUDA device (or all on the "
                         "CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("integrate_dense: float32 volume, depth and pose "
                         "expected")
    if (sdf.dim() != 3 or weight.shape != sdf.shape
            or tuple(origin.shape) != (3,) or vox.numel() != 1
            or tuple(depth_m.shape) != (cam.height, cam.width)
            or tuple(T_wc.shape) != (4, 4)):
        raise ValueError(
            f"integrate_dense: an (X, Y, Z) sdf and weight, a (3,) origin, "
            f"a 0-d voxel size, a ({cam.height}, {cam.width}) depth and a "
            f"(4, 4) pose expected, got {tuple(sdf.shape)}, "
            f"{tuple(weight.shape)}, {tuple(origin.shape)}, "
            f"{tuple(vox.shape)}, {tuple(depth_m.shape)}, "
            f"{tuple(T_wc.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("integrate_dense: contiguous volume, depth and "
                         "pose expected")
    ints, floats = _dense_tables(cam, fusion, tuple(sdf.shape))
    sdf_out = torch.empty_like(sdf)
    weight_out = torch.empty_like(weight)
    kernels.launch("integrate_dense", dev.index, sdf.data_ptr(),
                   weight.data_ptr(), depth_m.data_ptr(), T_wc.data_ptr(),
                   origin.data_ptr(), vox.data_ptr(), sdf_out.data_ptr(),
                   weight_out.data_ptr(), ints, floats)
    global LAUNCHES_DENSE
    LAUNCHES_DENSE += 1
    return state._replace(sdf=sdf_out, weight=weight_out)
