"""Splat surface prediction (port of ops/splat.py): every surface-band
voxel of the visible blocks projects to a pixel, where the surface along
that pixel's ray sits at z + sdf (the TSDF is projective); a scatter-min
z-buffer keeps the nearest estimate, then a 3x3 valid-min hole fill and an
edge-preserving smoothing pass finish the depth map.

The scatter-min is order independent, so the one-pass walk over
``active[:count]`` gives the JAX version's chunked result exactly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import CameraConfig, FusionConfig, HashConfig, RaycastConfig
from ..geometry import camera as cam_geom
from ..geometry import coords, se3
from .hash_ops import FREE_PTR, ActiveSet, HashMap, _local_offsets, _set_rows
from .preprocess import compute_normals
from .raycast import RaycastOutput


def _min_fill(depth: torch.Tensor, rounds: int) -> torch.Tensor:
    """Fill invalid (0) pixels with the 3x3 minimum of valid neighbours;
    ``rounds`` passes.  The window pads with +inf, as reduce_window's SAME
    padding does."""
    for _ in range(rounds):
        big = torch.where(depth > 0, depth, math.inf)
        neigh = -F.max_pool2d(-big[None, None], 3, stride=1, padding=1)[0, 0]
        fill = torch.where(torch.isfinite(neigh), neigh, 0.0)
        depth = torch.where(depth > 0, depth, fill)
    return depth


def _edge_preserving_smooth(depth: torch.Tensor,
                            sigma_z: float) -> torch.Tensor:
    """One 3x3 average over valid neighbours within ``sigma_z`` of the
    center depth (border wraps, as in the JAX version)."""
    acc = torch.zeros_like(depth)
    cnt = torch.zeros_like(depth)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = torch.roll(depth, (dy, dx), dims=(0, 1))
            ok = (n > 0) & (torch.abs(n - depth) < sigma_z)
            acc = acc + torch.where(ok, n, 0.0)
            cnt = cnt + ok.to(depth.dtype)
    return torch.where((depth > 0) & (cnt > 0),
                       acc / torch.clamp(cnt, min=1.0), depth)


def _splat_rows_into(
    zbuf: torch.Tensor,        # (H*W + 1,) running min buffer (+inf init)
    blocks: torch.Tensor,
    sdf_rows: torch.Tensor,
    w_rows: torch.Tensor,
    row_valid: torch.Tensor,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Scatter-min the rows' surface-depth estimates into ``zbuf`` (in
    place; its last entry collects the dropped updates)."""
    local = _local_offsets(cfg.block_size, device=blocks.device)
    vox = coords.block2voxel(blocks, cfg.block_size)[:, None, :] + local
    world = coords.voxel2world(vox, fusion.voxel_size)
    T_cw = se3.inverse(T_wc)
    pc = world @ T_cw[:3, :3].T + T_cw[:3, 3]

    z = pc[..., 2]
    band = rc.splat_band * fusion.voxel_size
    surf = (
        row_valid[:, None]
        & (w_rows > 0)
        & (torch.abs(sdf_rows) < band)
        & (z > rc.near)
        & (z < rc.far)
    )
    z_surf = z + sdf_rows
    ij, in_img = cam_geom.project_nearest(pc, cam)
    ok = surf & in_img & (z_surf > rc.near) & (z_surf < rc.far)
    flat = ij[..., 1].long() * cam.width + ij[..., 0].long()
    flat = torch.where(ok, flat, cam.height * cam.width)
    return zbuf.scatter_reduce_(
        0, flat.reshape(-1), torch.where(ok, z_surf, math.inf).reshape(-1),
        reduce="amin",
    )


def splat_depth_estimates(
    blocks: torch.Tensor,      # (A, 3) block coords
    sdf_rows: torch.Tensor,    # (A, V)
    w_rows: torch.Tensor,      # (A, V)
    row_valid: torch.Tensor,   # (A,)
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Raw splat depth (H, W) of explicit block rows (0 = no estimate):
    the multi-device path splats each rank's rows and merges the buffers
    with one ``pmin`` (parallel/sharded.py)."""
    zbuf = torch.full((cam.height * cam.width + 1,), math.inf,
                      dtype=torch.float32, device=sdf_rows.device)
    zbuf = _splat_rows_into(zbuf, blocks, sdf_rows, w_rows, row_valid, cfg,
                            T_wc, cam, rc, fusion)
    depth = zbuf[:-1].reshape(cam.height, cam.width)
    return torch.where(torch.isfinite(depth), depth, 0.0)


def splat_depth_from_map(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Raw splat depth (H, W) of ``active[:count]`` (0 = no estimate)."""
    n = int(active.count)
    ptrs = active.ptrs[:n]
    safe = torch.clamp(ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    return splat_depth_estimates(
        active.blocks[:n], hmap.tsdf[safe], hmap.weight[safe],
        ptrs != FREE_PTR, cfg, T_wc, cam, rc, fusion)


def finalize_depth(
    depth: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Hole fill + smoothing + vertex/normal maps from a raw splat buffer."""
    depth = _min_fill(depth, rc.splat_fill_rounds)
    depth = _edge_preserving_smooth(
        depth, rc.splat_smooth_sigma * fusion.voxel_size)
    rays = cam_geom.pixel_rays(cam, device=depth.device)
    points = rays * depth[..., None]
    normals = compute_normals(points)
    hit = depth > 0
    return RaycastOutput(
        depth=depth,
        points=torch.where(hit[..., None], points, 0.0),
        normals=normals,
        hit=hit,
    )


def surface_filter(hmap: HashMap, active: ActiveSet,
                   band: float) -> ActiveSet:
    """Compact the active set to blocks holding at least one surface-band
    voxel (``band_min`` < band); the others add no splat update."""
    safe = torch.clamp(active.ptrs, 0, hmap.band_min.shape[0] - 1).long()
    live = (active.ptrs != FREE_PTR) & (hmap.band_min[safe] < band)
    rank = torch.cumsum(live, dim=0) - 1
    blocks = torch.zeros_like(active.blocks)
    ptrs = torch.full_like(active.ptrs, FREE_PTR)
    _set_rows(blocks, rank, live, active.blocks)
    _set_rows(ptrs, rank, live, active.ptrs)
    return ActiveSet(blocks=blocks, ptrs=ptrs,
                     count=torch.sum(live).to(torch.int32))


def splat_raycast(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Surface prediction of the hashed TSDF from pose ``T_wc``."""
    surf = surface_filter(hmap, active, rc.splat_band * fusion.voxel_size)
    depth = splat_depth_from_map(hmap, surf, cfg, T_wc, cam, rc, fusion)
    return finalize_depth(depth, cam, rc, fusion)
