"""Raycasting the voxel-hashed TSDF (port of ops/hash_raycast.py).

The march goes through a view-local dense cache: the visible blocks (the
compacted set fusion uses) are scattered into a camera-centered dense
grid, rebuilt per view, and the dense sphere tracer (raycast.py) marches
it with no hash probes per step.  ``sample_hash_trilinear`` is the direct
per-sample hash-probe sampler, the semantics reference for tests.

Held to the JAX version:

- ``sample_hash_trilinear`` divides by the config constant
  ``fusion.voxel_size``, which the jitted JAX code compiles as a multiply
  by the float32 reciprocal (``recip``); the cache's own sampler
  (tsdf.trilinear_sample) divides by a tensor, a true division.
- ``densify_rows`` scatters with out-of-cache and invalid voxels dropped
  (JAX ``mode="drop"``): they are sent to one extra cell past the end of
  a buffer that is then cut off.  In-cache indices are unique.
- The cache origin snaps to the block grid.  ``cam_pos + forward * k``
  rounds twice here and once (FMA) under XLA, so on a block boundary the
  two packages may place the cache one block apart; the rendered result
  is the same wherever both caches hold the block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import CameraConfig, FusionConfig, HashConfig, RaycastConfig
from ..geometry import coords
from ..geometry.f32 import recip
from .hash_ops import FREE_PTR, ActiveSet, HashMap, _local_offsets
from .raycast import RaycastOutput, raycast_dense
from .tsdf import DenseTSDF


def sample_hash_trilinear(
    hmap: HashMap,
    cfg: HashConfig,
    fusion: FusionConfig,
    pos_world: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct trilinear (sdf, weight) sampling through the hash table: per
    sample 8 corner voxels, 8 block lookups, 8 voxel gathers."""
    g = pos_world * recip(fusion.voxel_size)
    base = torch.floor(g).to(torch.int32)
    frac = g - base
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    acc_s = 0.0
    acc_w = 0.0
    min_w = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                vox = base + torch.tensor([dx, dy, dz], dtype=torch.int32,
                                          device=base.device)
                block = coords.voxel2block(vox, cfg.block_size)
                keys = coords.pack_block_key(block, cfg.key_bits)
                bucket = coords.spatial_hash(block, cfg.num_buckets)
                bidx = bucket.long() * cfg.bucket_size
                ptr = torch.full_like(keys, FREE_PTR)
                for s in range(cfg.bucket_size):
                    hit = hmap.keys[bidx + s] == keys
                    ptr = torch.where(hit, hmap.ptrs[bidx + s], ptr)
                found = ptr != FREE_PTR
                local = vox - coords.block2voxel(block, cfg.block_size)
                lin = coords.linearize_voxel(local, cfg.block_size).long()
                safe_ptr = torch.clamp(ptr, 0, hmap.tsdf.shape[0] - 1).long()
                s_val = torch.where(found, hmap.tsdf[safe_ptr, lin], 0.0)
                w_val = torch.where(found, hmap.weight[safe_ptr, lin], 0.0)
                wt = (
                    (fx if dx else 1 - fx)
                    * (fy if dy else 1 - fy)
                    * (fz if dz else 1 - fz)
                )
                acc_s = acc_s + wt * s_val
                acc_w = acc_w + wt * w_val
                min_w = w_val if min_w is None else torch.minimum(min_w,
                                                                  w_val)

    known = min_w > 0
    return torch.where(known, acc_s, 0.0), torch.where(known, acc_w, 0.0)


def densify_active(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: torch.Tensor,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Scatter the visible blocks into a view-local dense cache, centered
    ahead of the camera along its optical axis and snapped to the block
    grid.  Blocks outside the cache are dropped (beyond raycast range).
    Only ``active[:count]`` is walked; the padded rows past it are invalid
    and would be dropped anyway."""
    n = int(active.count)
    ptrs = active.ptrs[:n]
    safe_ptr = torch.clamp(ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    return densify_rows(
        active.blocks[:n],
        hmap.tsdf[safe_ptr],
        hmap.weight[safe_ptr],
        ptrs != FREE_PTR,
        cfg,
        fusion,
        T_wc,
        cache_dims,
    )


def densify_rows(
    blocks: torch.Tensor,      # (A, 3) block coords
    src_sdf: torch.Tensor,     # (A, V) tsdf rows
    src_w: torch.Tensor,       # (A, V) weight rows
    row_valid: torch.Tensor,   # (A,) bool
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: torch.Tensor,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Build the cache from explicit block rows."""
    dev = T_wc.device
    B = cfg.block_size
    dims = torch.tensor(cache_dims, dtype=torch.int32, device=dev)
    # float32 constants as the JAX version folds them
    extent = np.float32(min(cache_dims)) * np.float32(fusion.voxel_size)
    ahead = float(np.float32(0.45) * extent)
    cam_pos = T_wc[:3, 3]
    forward = T_wc[:3, 2]  # camera +z axis in world frame
    center = cam_pos + forward * ahead
    # snap origin so voxel indices align with global voxel coords
    center_block = coords.world2block(center, fusion.voxel_size, B)
    origin_block = center_block - torch.div(dims, 2 * B,
                                            rounding_mode="floor")
    origin_voxel = coords.block2voxel(origin_block, B)

    local = _local_offsets(B, device=dev)                       # (V, 3)
    vox = coords.block2voxel(blocks, B)[:, None, :] + local     # (A, V, 3)
    rel = vox - origin_voxel                                    # cache coords
    in_cache = row_valid[:, None] & torch.all(
        (rel >= 0) & (rel < dims), dim=-1)

    rel = rel.long()
    flat = (
        rel[..., 0] * (cache_dims[1] * cache_dims[2])
        + rel[..., 1] * cache_dims[2]
        + rel[..., 2]
    )
    n_cells = cache_dims[0] * cache_dims[1] * cache_dims[2]
    flat = torch.where(in_cache, flat, n_cells).reshape(-1)     # OOB -> drop

    f32 = dict(dtype=torch.float32, device=dev)
    sdf = torch.full((n_cells + 1,), fusion.truncation, **f32)
    wgt = torch.zeros((n_cells + 1,), **f32)
    sdf[flat] = src_sdf.reshape(-1)         # cell n_cells collects the drops
    wgt[flat] = src_w.reshape(-1)

    return DenseTSDF(
        sdf=sdf[:n_cells].view(cache_dims),
        weight=wgt[:n_cells].view(cache_dims),
        origin=coords.voxel2world(origin_voxel, fusion.voxel_size),
        voxel_size=torch.tensor(fusion.voxel_size, **f32),
    )


def raycast_hash(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
    cache_dims: Tuple[int, int, int] = (256, 256, 256),
) -> RaycastOutput:
    """Render the hashed TSDF from pose T_wc via the dense-cache path."""
    cache = densify_active(hmap, active, cfg, fusion, T_wc, cache_dims)
    return raycast_dense(cache, T_wc, cam, rc, fusion)
