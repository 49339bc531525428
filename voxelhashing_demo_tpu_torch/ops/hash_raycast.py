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

On CUDA tensors ``densify_active`` and ``densify_rows`` are one call of
the hand-written kernel K12 ``densify_cache`` (``csrc/raycast.cu``; two
device kernels: the origin, a block grid of the rows in the cache, then
one pass that writes every cell), the count read on the device, no host
read; ``raycast_hash`` is K12 then K11 (ops/raycast.py).  CPU tensors run
``densify_active_reference`` / ``densify_rows_reference``, the plain
versions (the count compared on the device, not read), which the tests
and the card checks also call on the card.  A launch that the kernel does
not take raises; nothing falls back.  ``LAUNCHES_DENSIFY`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..config import CameraConfig, FusionConfig, HashConfig, RaycastConfig
from ..geometry import coords
from ..geometry.f32 import recip
from .hash_ops import FREE_PTR, ActiveSet, HashMap, _local_offsets
from .raycast import RaycastOutput, raycast_dense
from .tsdf import DenseTSDF

LAUNCHES_DENSIFY = 0    # K12 densify_cache

# the cache's voxel_size tensor a (device, value): made once, so that a
# call uploads nothing
_VOXEL_SIZES: dict = {}


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


def _cache_ahead(fusion: FusionConfig,
                 cache_dims: Tuple[int, int, int]) -> float:
    """The cache centre's distance ahead of the camera along its optical
    axis (float32 constants as the JAX version folds them)."""
    extent = np.float32(min(cache_dims)) * np.float32(fusion.voxel_size)
    return float(np.float32(0.45) * extent)


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
    and would be dropped anyway.  One K12 call on CUDA tensors (the map's
    rows read in place, the count on the device),
    ``densify_active_reference`` on CPU tensors."""
    if hmap.tsdf.device.type == "cpu":
        return densify_active_reference(hmap, active, cfg, fusion, T_wc,
                                        cache_dims)
    blocks, ptrs, count = active
    return _launch_densify(blocks, hmap.tsdf, hmap.weight, cfg, fusion,
                           T_wc, cache_dims, ptrs=ptrs, count=count)


def densify_active_reference(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: torch.Tensor,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Plain version of ``densify_active``, on any device: every row of
    the set with the rows at or past ``count`` marked invalid (the count
    compared on the device, not read on the host)."""
    ptrs = active.ptrs
    walked = (torch.arange(ptrs.shape[0], device=ptrs.device)
              < active.count)
    safe_ptr = torch.clamp(ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    return densify_rows_reference(
        active.blocks,
        hmap.tsdf[safe_ptr],
        hmap.weight[safe_ptr],
        (ptrs != FREE_PTR) & walked,
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
    """Build the cache from explicit block rows (the multi-device path's
    all-gathered rows): one K12 call on CUDA tensors,
    ``densify_rows_reference`` on CPU tensors."""
    if src_sdf.device.type == "cpu":
        return densify_rows_reference(blocks, src_sdf, src_w, row_valid,
                                      cfg, fusion, T_wc, cache_dims)
    return _launch_densify(blocks, src_sdf, src_w, cfg, fusion, T_wc,
                           cache_dims, valid=row_valid)


def densify_rows_reference(
    blocks: torch.Tensor,      # (A, 3) block coords
    src_sdf: torch.Tensor,     # (A, V) tsdf rows
    src_w: torch.Tensor,       # (A, V) weight rows
    row_valid: torch.Tensor,   # (A,) bool
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: torch.Tensor,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Plain version of ``densify_rows``, on any device."""
    dev = T_wc.device
    B = cfg.block_size
    dims = torch.tensor(cache_dims, dtype=torch.int32, device=dev)
    cam_pos = T_wc[:3, 3]
    forward = T_wc[:3, 2]  # camera +z axis in world frame
    center = cam_pos + forward * _cache_ahead(fusion, cache_dims)
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


# --------------------------------------------------------------------------
# the kernel's wrapper
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _densify_tables(cfg: HashConfig, fusion: FusionConfig,
                    cache_dims: Tuple[int, int, int]) -> tuple:
    """K12's host tables: ints (block size, X, Y, Z) and floats (ahead,
    recip(voxel size), voxel size, truncation); or raise."""
    B = cfg.block_size
    if not 1 <= B <= 10:
        raise ValueError(f"densify: block sizes 1-10 taken, got {B}")
    if (len(cache_dims) != 3 or min(cache_dims) < 1
            or int(np.prod(cache_dims)) > 2 ** 31 - 1):
        raise ValueError(f"densify: a cache of 1 to 2^31 - 1 cells "
                         f"expected, got {cache_dims}")
    return ((ctypes.c_int * 4)(B, *cache_dims),
            (ctypes.c_float * 4)(_cache_ahead(fusion, cache_dims),
                                 recip(fusion.voxel_size),
                                 fusion.voxel_size, fusion.truncation))


def _voxel_size(fusion: FusionConfig, dev: torch.device) -> torch.Tensor:
    key = (dev, fusion.voxel_size)
    vox = _VOXEL_SIZES.get(key)
    if vox is None:
        vox = _VOXEL_SIZES[key] = torch.tensor(
            fusion.voxel_size, dtype=torch.float32, device=dev)
    return vox


def _launch_densify(blocks: torch.Tensor, src_sdf: torch.Tensor,
                    src_w: torch.Tensor, cfg: HashConfig,
                    fusion: FusionConfig, T_wc: torch.Tensor,
                    cache_dims: Tuple[int, int, int], ptrs=None,
                    count=None, valid=None) -> DenseTSDF:
    """K12 on the current stream: the cache of the map rows ``ptrs[:count]``
    point at (``src_*`` the map's (N, V) rows) or of explicit rows
    (``src_*`` (A, V), ``valid`` (A,) bool); or raise."""
    ints, floats = _densify_tables(cfg, fusion, tuple(cache_dims))
    dev = src_sdf.device
    idx = (ptrs, count) if valid is None else (valid,)
    tensors = (blocks, src_sdf, src_w, T_wc) + idx
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("densify: the rows, the blocks and the pose must "
                         "lie on one CUDA device (or the rows on the CPU)")
    V = cfg.voxels_per_block
    A = blocks.shape[0]
    if (blocks.dtype != torch.int32 or src_sdf.dtype != torch.float32
            or src_w.dtype != torch.float32 or T_wc.dtype != torch.float32
            or tuple(blocks.shape) != (A, 3) or src_sdf.dim() != 2
            or src_sdf.shape[1] != V or src_w.shape != src_sdf.shape
            or tuple(T_wc.shape) != (4, 4)):
        raise ValueError(f"densify: int32 blocks (A, 3), float32 rows "
                         f"(N, {V}) and a float32 (4, 4) pose expected")
    if valid is None:
        if (ptrs.dtype != torch.int32 or tuple(ptrs.shape) != (A,)
                or count.dtype != torch.int32 or count.numel() != 1):
            raise ValueError("densify: int32 ptrs (A,) and a one-element "
                             "int32 count expected")
    elif (valid.dtype != torch.bool or tuple(valid.shape) != (A,)
          or src_sdf.shape[0] != A):
        raise ValueError("densify: (A, V) rows and an (A,) bool mask "
                         "expected")
    keep = tuple(t.contiguous() for t in (blocks, src_sdf, src_w, T_wc)
                 + idx)
    blocks_c, sdf_c, w_c, T_c = keep[:4]
    if valid is None:
        ptr_p, count_p, valid_p = keep[4].data_ptr(), keep[5].data_ptr(), None
    else:
        ptr_p, count_p, valid_p = None, None, keep[4].data_ptr()
    B = cfg.block_size
    X, Y, Z = cache_dims
    grid = torch.empty(-(-X // B) * -(-Y // B) * -(-Z // B),
                       dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    sdf = torch.empty(cache_dims, **f32)
    wgt = torch.empty(cache_dims, **f32)
    origin = torch.empty(3, **f32)
    kernels.launch("densify_cache", dev.index, blocks_c.data_ptr(), ptr_p,
                   count_p, valid_p, T_c.data_ptr(), sdf_c.data_ptr(),
                   w_c.data_ptr(), grid.data_ptr(), sdf.data_ptr(),
                   wgt.data_ptr(), origin.data_ptr(), A, sdf_c.shape[0],
                   ints, floats)
    global LAUNCHES_DENSIFY
    LAUNCHES_DENSIFY += 1
    return DenseTSDF(sdf=sdf, weight=wgt, origin=origin,
                     voxel_size=_voxel_size(fusion, dev))
