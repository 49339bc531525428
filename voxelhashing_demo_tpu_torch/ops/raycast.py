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

On CUDA tensors ``raycast_rays`` is one launch of the hand-written kernel
K11 ``raycast_march`` (``csrc/raycast.cu``): a thread a ray, the whole
step loop, the secant step and the gradient normals in the kernel, no
host read.  In image mode (``normal_mode`` other than "gradient") K11
writes depth, points and hit, and the plain ``compute_normals`` runs
after it.  CPU tensors run ``raycast_rays_reference``, the plain version
(``trilinear_sample`` / ``sdf_gradient`` of ops/tsdf.py), which the
tests and the card checks also call on the card.  A launch that the
kernel does not take raises; nothing falls back.  ``LAUNCHES_MARCH``
counts the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import kernels
from ..config import CameraConfig, FusionConfig, RaycastConfig
from ..geometry import camera as cam_geom
from .preprocess import Frame, _norm, compute_normals
from .tsdf import DenseTSDF, sdf_gradient, trilinear_sample

LAUNCHES_MARCH = 0      # K11 raycast_march

# K11's host tables a configuration and volume shape: (id(rc), X, Y, Z) ->
# (rc, tables), kept by the object's identity (``_march_tables``)
_MARCH_TABLES: dict = {}


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
    parameterized): one K11 launch on CUDA tensors (in image mode followed
    by the plain ``compute_normals``), ``raycast_rays_reference`` on CPU
    tensors."""
    if state.sdf.device.type == "cpu":
        return raycast_rays_reference(state, T_wc, rays_cam, rc)
    return _launch_march(state, T_wc, rays_cam, rc)


def raycast_rays_reference(
    state: DenseTSDF,
    T_wc: torch.Tensor,
    rays_cam: torch.Tensor,
    rc: RaycastConfig,
) -> RaycastOutput:
    """Plain version of ``raycast_rays``, on any device."""
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


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

def _march_tables(rc: RaycastConfig, dims: tuple) -> tuple:
    """K11's host tables for ``rc`` and a volume of ``dims``: ints (X, Y,
    Z, max_steps, gradient mode) and floats (step_scale, min_step,
    coarse_step, near, far; ctypes rounds each to its float32, as torch
    does with a Python double against a float32 tensor), built once and
    kept by the configuration's identity; or raise."""
    key = (id(rc), *dims)
    got = _MARCH_TABLES.get(key)
    if got is not None and got[0] is rc:
        return got[1]
    if min(dims) < 2:
        raise ValueError(f"raycast: every volume dimension must be >= 2, "
                         f"got {dims}")
    if rc.max_steps < 0:
        raise ValueError(f"raycast: max_steps >= 0 expected, got "
                         f"{rc.max_steps}")
    tables = ((ctypes.c_int * 5)(*dims, rc.max_steps,
                                 int(rc.normal_mode == "gradient")),
              (ctypes.c_float * 5)(rc.step_scale, rc.min_step,
                                   rc.coarse_step, rc.near, rc.far))
    if len(_MARCH_TABLES) >= 64:
        _MARCH_TABLES.clear()
    _MARCH_TABLES[key] = (rc, tables)
    return tables


def _launch_march(state: DenseTSDF, T_wc: torch.Tensor,
                  rays_cam: torch.Tensor,
                  rc: RaycastConfig) -> RaycastOutput:
    """K11 on the current stream: the RaycastOutput of float32 rays (h, w,
    3), pose (4, 4) and volume (sdf and weight (X, Y, Z), origin (3,),
    voxel_size ()) on one CUDA device; or raise."""
    sdf, weight, origin, vox = state
    dev = sdf.device
    tensors = (sdf, weight, origin, vox, T_wc, rays_cam)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("raycast: the volume, the pose and the rays must "
                         "lie on one CUDA device (or the volume on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("raycast: float32 volume, pose and rays expected")
    if (sdf.dim() != 3 or weight.shape != sdf.shape
            or tuple(origin.shape) != (3,) or vox.numel() != 1
            or tuple(T_wc.shape) != (4, 4) or rays_cam.dim() != 3
            or rays_cam.shape[2] != 3):
        raise ValueError(
            f"raycast: an (X, Y, Z) sdf and weight, a (3,) origin, a 0-d "
            f"voxel size, a (4, 4) pose and (h, w, 3) rays expected, got "
            f"{tuple(sdf.shape)}, {tuple(weight.shape)}, "
            f"{tuple(origin.shape)}, {tuple(vox.shape)}, "
            f"{tuple(T_wc.shape)}, {tuple(rays_cam.shape)}")
    ints, floats = _march_tables(rc, tuple(sdf.shape))
    keep = tuple(t.contiguous() for t in (rays_cam, T_wc, sdf, weight,
                                          origin, vox))
    h, w = rays_cam.shape[:2]
    n = h * w
    buf = torch.empty(7 * n, dtype=torch.float32, device=dev)
    hit = torch.empty((h, w), dtype=torch.bool, device=dev)
    kernels.launch("raycast_march", dev.index,
                   *(t.data_ptr() for t in keep), buf.data_ptr(),
                   hit.data_ptr(), h, w, ints, floats)
    global LAUNCHES_MARCH
    LAUNCHES_MARCH += 1
    maps = ((h, w, 3), (3 * w, 3, 1))
    points = buf.as_strided(*maps, n)
    normals = buf.as_strided(*maps, 4 * n)
    if rc.normal_mode != "gradient":
        normals = torch.where(hit[..., None], compute_normals(points), 0.0)
    return RaycastOutput(depth=buf.as_strided((h, w), (w, 1), 0),
                         points=points, normals=normals, hit=hit)
