"""Voxel block hash table as deterministic batched tensor ops (port of
ops/hash_ops.py: the per-frame path, de-integration, and the eviction and
restore of out-of-core streaming).

The map is preallocated tensors that the per-frame functions update IN
PLACE, where the JAX version returns new arrays from a donated state
(models/hash_slam.make_step donates it).  A caller that needs the old map
clones its tensors first.  Functions return the map (scalars such as
``free_top`` are updated in place too) so call sites read like the JAX ones.

Semantics held to the JAX version:

- ``.at[idx].set(..., mode="drop")`` drops out-of-bounds indices; here the
  indices are masked first (``_set_rows``, which reads the mask on the
  host), written into a buffer one row longer whose last row is sliced off,
  or, where neither may sync the host nor copy the map (the free stack,
  eviction and restore), redirected by ``_scatter_drop``;
- sorts of keys and buckets are stable (``stable=True``);
- int32 cumsums come out int64 in torch; they only index, or compare
  with int32 values (exact under type promotion);
- the segmented scan ``associative_scan(maximum)`` is ``torch.cummax``.

Integrate and splat walk ``active[:count]`` in one pass instead of the
JAX version's ``integrate_chunk`` chunks: rows are distinct, so the result
is the same.

Two hand-written kernels (``csrc/fuse.cu``) serve CUDA tensors: K6
``compact_visible`` (the frustum test of the whole table and the
compaction in table order in one launch, its tiles' counts exchanged
without a grid barrier through a scratch that persists from call to call,
one a device and stream; the count left on the device) and K7
``integrate_rows`` (the update of ``active[:count]`` with the window
gather's coverage and ``touch_active``'s stamp fused in).  On
CUDA tensors ``compact_visible`` is K6 and ``integrate`` K7, so the frame's
compact -> touch -> integrate (``fuse_frame``: ``integrate(...,
stamp=frame_idx)``) is two launches and no host read; CPU tensors run the
plain versions ``compact_visible_reference`` and ``integrate_reference``
(with ``touch_active`` for a stamp), which the tests and the card checks
also call on the card.  What the kernels do not take raises; nothing
falls back.  ``LAUNCHES_COMPACT``, ``LAUNCHES_INTEGRATE`` and
``LAUNCHES_INTEGRATE_WINDOW`` (K7 in the window-gather mode, the work of
the window gather K1 on the frame step) count the launches.

Two more (``csrc/alloc.cu``) allocate: K5a ``alloc_candidates`` (the
frame's candidate keys) and K5b ``insert_blocks`` (unique, cap, probe,
bucket rank, free-list pop and scatter in one cooperative launch, the
count left on the device, on a scratch that persists from call to call,
one a device and stream).  On CUDA tensors ``frame_candidate_keys`` is
K5a and ``insert_blocks`` K5b, so ``allocate_from_frame`` is two launches
and no host read, and ``fuse_frame`` four; CPU tensors run the plain
versions ``frame_candidate_keys_reference`` and
``insert_blocks_reference``.  K5b takes its bucket function as a
``BucketHash``; any other callable raises there.
``LAUNCHES_ALLOC_CANDIDATES`` and ``LAUNCHES_INSERT`` count the launches.
K5b and K7 take their stamp as an int or as a 0-d int32 tensor on the
card, read by the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref
from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..config import CameraConfig, FusionConfig, HashConfig
from ..device import resolve
from ..geometry import camera as cam_geom
from ..geometry import coords, se3
from ..geometry.f32 import recip
from . import window_gather
from .preprocess import Frame, _norm
from .tsdf import sample_weight

FREE_PTR = -1
EMPTY_KEY = coords.EMPTY_KEY

LAUNCHES_COMPACT = 0            # K6 compact_visible
LAUNCHES_INTEGRATE = 0          # K7 integrate_rows, either gather mode
LAUNCHES_INTEGRATE_WINDOW = 0   # K7 in the window-gather mode
LAUNCHES_ALLOC_CANDIDATES = 0   # K5a alloc_candidates
LAUNCHES_INSERT = 0             # K5b insert_blocks

MAX_VOXELS = 1024       # the voxels a block K7 takes (kMaxVoxels)
COMPACT_TILE = 2048     # table entries a K6 tile (kTile)
COMPACT_MIN_TILES = 128    # the statuses of K6's smallest scratch
COMPACT_STATUS_WORDS = 16  # 64-bit words a K6 status takes (kStatusStride)
MAX_KEY_BITS = 10       # three coordinates in a non-negative int32 key
MAX_NEW = 4096          # the new keys K5b sorts in one CTA (kMaxNew)
MAX_BUCKET_SIZE = 65535    # a bucket's fill as K5b keeps it (uint16)
INSERT_HDR_INTS = 128      # K5b's scratch header (kHdrInts)
INSERT_HDR_ZERO = 64       # its counts' and arrival's lines (kHdrEpoch)
INSERT_MIN_CAPACITY = 1024     # the keys of K5b's smallest scratch

# K5b's persistent scratch: (device index, raw stream) -> (tensor,
# capacity, set_bits), and the scratches it replaced (a captured graph may
# use one); a capture that finds none makes its own (_insert_scratch)
_INSERT_SCRATCH: dict = {}
_INSERT_RETIRED: list = []
# K6's persistent scratch: (device index, raw stream) -> (tensor, tiles),
# and the scratches it replaced (a captured graph may use one)
_COMPACT_SCRATCH: dict = {}
_COMPACT_RETIRED: list = []
# K6's host tables: (id(cfg), id(cam), id(fusion)) -> (the three objects,
# the tables)
_COMPACT_PLANS: dict = {}
# maps K5b checked: id(keys) -> (weak references to the tensors, the
# configuration, the bucket function, the host tables)
_MAP_CHECKED: dict = {}
# maps K7 checked: id(tsdf) -> (weak references to the row tensors, the
# configuration, camera and fusion settings, the host tables)
_INTEGRATE_TABLES: dict = {}
# K5a's host tables: (id(cfg), id(fusion)) -> (the two objects, the tables)
_CANDIDATE_TABLES: dict = {}


class HashMap(NamedTuple):
    """Voxel block hash map state (preallocated, updated in place)."""

    keys: torch.Tensor         # [T] int32 packed block keys; EMPTY_KEY free
    ptrs: torch.Tensor         # [T] int32 block row index; -1 free
    bucket_fill: torch.Tensor  # [num_buckets] int32 occupied prefix length
    free_list: torch.Tensor    # [num_blocks] int32 stack of free rows
    free_top: torch.Tensor     # () int32 number of free rows
    tsdf: torch.Tensor         # [num_blocks, 512] float32
    weight: torch.Tensor       # [num_blocks, 512] float32
    last_seen: torch.Tensor    # [num_blocks] int32 frame idx last in frustum
    band_min: torch.Tensor     # [num_blocks] float32 min |sdf| of weighted voxels
    born: torch.Tensor         # [num_blocks] int32 frame idx of allocation


class ActiveSet(NamedTuple):
    """Padded visible-block set."""

    blocks: torch.Tensor   # [max_active, 3] int32 block coords (zero pad)
    ptrs: torch.Tensor     # [max_active] int32 block rows; -1 pad
    count: torch.Tensor    # () int32


def create(cfg: HashConfig, device=None) -> HashMap:
    """Fresh empty map on ``device`` (None: the CUDA card)."""
    device = resolve(device)
    T = cfg.table_size
    V = cfg.voxels_per_block
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return HashMap(
        keys=torch.full((T,), EMPTY_KEY, **i32),
        ptrs=torch.full((T,), FREE_PTR, **i32),
        bucket_fill=torch.zeros((cfg.num_buckets,), **i32),
        free_list=torch.arange(cfg.num_blocks, **i32),
        free_top=torch.tensor(cfg.num_blocks, **i32),
        tsdf=torch.zeros((cfg.num_blocks, V), **f32),
        weight=torch.zeros((cfg.num_blocks, V), **f32),
        last_seen=torch.zeros((cfg.num_blocks,), **i32),
        band_min=torch.full((cfg.num_blocks,), math.inf, **f32),
        born=torch.zeros((cfg.num_blocks,), **i32),
    )


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
              src) -> None:
    """dst[idx[keep]] = src[keep] (src may be a scalar or a 0-d tensor):
    the ``mode="drop"`` scatter with the dropped indices masked out
    first."""
    sel = idx[keep].long()
    dst[sel] = src if not torch.is_tensor(src) or src.dim() == 0 \
        else src[keep]


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                  src) -> None:
    """dst[idx[keep]] = src[keep] (src may be a scalar or a 0-d tensor),
    in place and without reading ``keep`` on the host: every dropped entry
    writes again what the first kept entry writes, to the same row (with
    none kept, row 0's own value back to row 0), so no row is given two
    different values.
    The kept rows must be distinct, as they are in every JAX call it
    stands for."""
    n = idx.shape[0]
    if n == 0:
        return
    idx = idx.long()
    # one-element index tensors throughout: no value is read on the host
    first = torch.argmax(keep.to(torch.uint8)).reshape(1)  # 0: none kept
    any_kept = keep.index_select(0, first)
    spare = torch.where(any_kept, idx.index_select(0, first), 0)
    row_shape = dst.shape[1:]
    if not torch.is_tensor(src):
        src = torch.full((n,) + row_shape, src, dtype=dst.dtype,
                         device=dst.device)
    elif src.dim() == 0:
        src = src.to(dst.dtype).expand((n,) + row_shape)
    lead = (1,) + (1,) * len(row_shape)
    fill = torch.where(any_kept.reshape(lead), src.index_select(0, first),
                       dst.index_select(0, spare))
    mask = keep.reshape((n,) + (1,) * len(row_shape))
    dst[torch.where(keep, idx, spare)] = torch.where(mask, src, fill)


# --------------------------------------------------------------------------
# lookup
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketHash:
    """Block coords (..., 3) -> bucket index: ``spatial_hash(blocks,
    num_buckets) // divisor``.  The table's own buckets take divisor 1;
    the sharded step's owner-local bucket is the global hash // mesh size
    (parallel/sharded.py).  A value, not a closure, so that K5b can take
    it as two integers."""

    num_buckets: int
    divisor: int

    def __call__(self, blocks: torch.Tensor) -> torch.Tensor:
        return coords.spatial_hash(blocks, self.num_buckets) // self.divisor


def default_bucket_fn(cfg: HashConfig) -> BucketHash:
    """The table's bucket function: the spatial hash over its buckets."""
    return BucketHash(cfg.num_buckets, 1)


def lookup_keys(hmap: HashMap, cfg: HashConfig, query_keys: torch.Tensor,
                bucket_fn=None):
    """Vectorized probe: packed keys (N,) -> (ptr (N,), found (N,))."""
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    blocks = coords.unpack_block_key(query_keys, cfg.key_bits)
    base = bucket_fn(blocks).long() * cfg.bucket_size
    ptr = torch.full(query_keys.shape, FREE_PTR, dtype=torch.int32,
                     device=query_keys.device)
    found = torch.zeros(query_keys.shape, dtype=torch.bool,
                        device=query_keys.device)
    for s in range(cfg.bucket_size):
        slot_key = hmap.keys[base + s]
        hit = (slot_key == query_keys) & (query_keys != EMPTY_KEY)
        ptr = torch.where(hit, hmap.ptrs[base + s], ptr)
        found = found | hit
    return ptr, found


def lookup_blocks(hmap: HashMap, cfg: HashConfig, blocks: torch.Tensor):
    """Block coords (..., 3) -> (ptr, found), flattened to (N,)."""
    keys = coords.pack_block_key(blocks, cfg.key_bits)
    return lookup_keys(hmap, cfg, keys.reshape(-1))


# --------------------------------------------------------------------------
# candidate generation
# --------------------------------------------------------------------------

def frame_candidate_keys(
    frame: Frame,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Packed block keys touched by the frame's truncation band:
    ``band_steps`` samples along each (strided) pixel ray spanning
    +-truncation around the measured surface, a flat (band, h, w) int32
    array; invalid rays give EMPTY_KEY.  One K5a launch on CUDA tensors
    (a fresh output); ``frame_candidate_keys_reference`` on CPU tensors."""
    if frame.depth.device.type == "cpu":
        return frame_candidate_keys_reference(frame, T_wc, cam, cfg, fusion)
    return _launch_candidates(frame, T_wc, cfg, fusion)


def frame_candidate_keys_reference(
    frame: Frame,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Plain version of ``frame_candidate_keys``, on any device."""
    stride = cfg.candidate_stride
    verts = frame.vertices[::stride, ::stride]
    depth = frame.depth[::stride, ::stride]
    valid = depth > 0

    ray_len = _norm(verts)
    inv_len = torch.where(valid, 1.0 / torch.clamp(ray_len, min=1e-9), 0.0)
    ray_dir = verts * inv_len[..., None]

    trunc = fusion.truncation + fusion.trunc_scale * depth
    steps = torch.linspace(-1.0, 1.0, cfg.band_steps, dtype=torch.float32,
                           device=depth.device)
    samples = (
        verts[None]
        + ray_dir[None] * (steps[:, None, None, None] * trunc[None, ..., None])
    )
    world = se3.apply(T_wc, samples.reshape(-1, 3))
    blocks = coords.world2block(world, fusion.voxel_size, cfg.block_size)
    keys = coords.pack_block_key(blocks, cfg.key_bits)
    valid_flat = valid[None].expand((cfg.band_steps,) + valid.shape)
    return torch.where(valid_flat.reshape(-1), keys, EMPTY_KEY)


# --------------------------------------------------------------------------
# insert (allocation)
# --------------------------------------------------------------------------

def _unique_compact(keys: torch.Tensor, max_out: int) -> torch.Tensor:
    """Sort + adjacent-diff unique + cumsum compaction of packed keys into
    (max_out,) padded with EMPTY_KEY; overflow drops the largest keys."""
    s = torch.sort(keys, stable=True).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s != EMPTY_KEY
    pos = torch.cumsum(first, dim=0) - 1
    idx = torch.where(first, pos, max_out).clamp(max=max_out)
    out = torch.full((max_out + 1,), EMPTY_KEY, dtype=torch.int32,
                     device=keys.device)
    out[idx] = s            # row max_out collects the drops
    return out[:max_out]


def _segment_rank(b_sorted: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its run of equal (sorted) values."""
    n = b_sorted.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=b_sorted.device)
    seg_start = torch.ones_like(b_sorted, dtype=torch.bool)
    seg_start[1:] = b_sorted[1:] != b_sorted[:-1]
    start_pos = torch.cummax(torch.where(seg_start, pos, 0), dim=0).values
    return pos - start_pos


def insert_blocks(
    hmap: HashMap, cfg: HashConfig, cand_keys: torch.Tensor,
    frame_idx: int | torch.Tensor = 0, bucket_fn=None,
) -> Tuple[HashMap, torch.Tensor]:
    """Insert up to max_new unique candidate keys (in place); returns
    (map, n_inserted as a 0-d int32 tensor).  The new rows are stamped
    ``frame_idx`` (an int or a 0-d int32 tensor).  ``bucket_fn`` maps
    block coords to buckets (default: ``default_bucket_fn``).  One K5b
    launch on CUDA tensors (no host read; ``bucket_fn`` a ``BucketHash``);
    ``insert_blocks_reference`` on CPU tensors."""
    if hmap.keys.device.type == "cpu":
        return insert_blocks_reference(hmap, cfg, cand_keys, frame_idx,
                                       bucket_fn)
    return _launch_insert(hmap, cfg, cand_keys, frame_idx, bucket_fn)


def insert_blocks_reference(
    hmap: HashMap, cfg: HashConfig, cand_keys: torch.Tensor,
    frame_idx: int | torch.Tensor = 0, bucket_fn=None,
) -> Tuple[HashMap, torch.Tensor]:
    """Plain version of ``insert_blocks``, on any device.  Bucket ranks
    come from a segmented scan over the bucket-sorted keys, heap rows
    from a cumsum over the free stack; bucket overflow and heap
    exhaustion drop keys deterministically.  Its masked scatters read the
    host (``_set_rows``)."""
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    uniq = _unique_compact(cand_keys, cfg.max_new_per_frame)
    _, found = lookup_keys(hmap, cfg, uniq, bucket_fn)
    new_mask = (~found) & (uniq != EMPTY_KEY)

    blocks = coords.unpack_block_key(uniq, cfg.key_bits)
    bucket = bucket_fn(blocks)
    bucket = torch.where(new_mask, bucket, cfg.num_buckets)

    order = torch.argsort(bucket, stable=True)
    b_sorted = bucket[order]
    rank_sorted = _segment_rank(b_sorted)
    valid_sorted = b_sorted < cfg.num_buckets

    b_safe = torch.clamp(b_sorted, 0, cfg.num_buckets - 1).long()
    slot_sorted = hmap.bucket_fill[b_safe] + rank_sorted
    ok = valid_sorted & (slot_sorted < cfg.bucket_size)

    alloc_rank = torch.cumsum(ok, dim=0) - 1
    ok = ok & (alloc_rank < hmap.free_top)
    n_alloc = torch.sum(ok).to(torch.int32)

    new_ptrs = hmap.free_list[
        torch.clamp(hmap.free_top - 1 - alloc_rank, 0,
                    hmap.free_list.shape[0] - 1)
    ]
    table_idx = b_safe * cfg.bucket_size + torch.clamp(
        slot_sorted, 0, cfg.bucket_size - 1)
    keys_sorted = uniq[order]

    _set_rows(hmap.keys, table_idx, ok, keys_sorted)
    _set_rows(hmap.ptrs, table_idx, ok, new_ptrs)
    hmap.bucket_fill.index_add_(
        0, b_safe[ok], torch.ones_like(b_safe[ok], dtype=torch.int32))
    # zero-init the fresh rows (they may hold a freed block's data)
    _set_rows(hmap.tsdf, new_ptrs, ok, 0.0)
    _set_rows(hmap.weight, new_ptrs, ok, 0.0)
    _set_rows(hmap.last_seen, new_ptrs, ok, frame_idx)
    _set_rows(hmap.band_min, new_ptrs, ok, math.inf)
    _set_rows(hmap.born, new_ptrs, ok, frame_idx)
    hmap.free_top.sub_(n_alloc)
    return hmap, n_alloc


# --------------------------------------------------------------------------
# visible-set compaction
# --------------------------------------------------------------------------

FRUSTUM_MARGIN_PX = 4.0   # block_in_frustum's margin as compaction uses it


def block_in_frustum(
    blocks: torch.Tensor,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    margin_px: float = FRUSTUM_MARGIN_PX,
) -> torch.Tensor:
    """Conservative frustum test of block centers with a z-adaptive pixel
    margin (the block's projected bounding-sphere radius)."""
    half = 0.5 * cfg.block_size * fusion.voxel_size
    radius = half * 1.7320508
    center = coords.block2world(blocks, fusion.voxel_size,
                                cfg.block_size) + half
    pc = se3.apply(se3.inverse(T_wc), center)
    z = pc[..., 2]
    safe_z = torch.clamp(z, min=1e-6)
    u = pc[..., 0] / safe_z * cam.fx + cam.cx
    v = pc[..., 1] / safe_z * cam.fy + cam.cy
    zm = torch.clamp(z, min=0.05)
    mu = margin_px + radius * cam.fx / zm
    mv = margin_px + radius * cam.fy / zm
    near = cam.depth_min - 2.0 * half
    far = cam.depth_max + 2.0 * half
    return (
        (z > near)
        & (z < far)
        & (u >= -mu)
        & (u < cam.width + mu)
        & (v >= -mv)
        & (v < cam.height + mv)
    )


def compact_visible(
    hmap: HashMap,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
) -> ActiveSet:
    """Stream-compact allocated, in-frustum entries (in table order) into a
    padded ActiveSet (rows past ``count`` hold 0 / FREE_PTR): one K6
    launch on CUDA tensors, whose outputs are fresh tensors on every call
    and whose count stays on the device; ``compact_visible_reference`` on
    CPU tensors."""
    if hmap.keys.device.type == "cpu":
        return compact_visible_reference(hmap, cfg, T_wc, cam, fusion)
    return _launch_compact(hmap, cfg, T_wc, cam, fusion)


def compact_visible_reference(
    hmap: HashMap,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
) -> ActiveSet:
    """Plain version of ``compact_visible``, on any device."""
    blocks_all = coords.unpack_block_key(hmap.keys, cfg.key_bits)
    mask = (hmap.ptrs != FREE_PTR) & block_in_frustum(
        blocks_all, T_wc, cam, cfg, fusion)
    pos = torch.cumsum(mask, dim=0) - 1
    idx = torch.where(mask & (pos < cfg.max_active), pos, cfg.max_active)
    dev = hmap.keys.device
    out_blocks = torch.zeros((cfg.max_active + 1, 3), dtype=torch.int32,
                             device=dev)
    out_ptrs = torch.full((cfg.max_active + 1,), FREE_PTR, dtype=torch.int32,
                          device=dev)
    _set_rows(out_blocks, idx, mask, blocks_all)
    _set_rows(out_ptrs, idx, mask, hmap.ptrs)
    count = torch.clamp(torch.sum(mask), max=cfg.max_active).to(torch.int32)
    return ActiveSet(blocks=out_blocks[:-1], ptrs=out_ptrs[:-1], count=count)


# --------------------------------------------------------------------------
# TSDF fusion over the active set
# --------------------------------------------------------------------------

def _local_offsets(block_size: int, device=None) -> torch.Tensor:
    """(V, 3) in-block voxel offsets in linearization order (z-major)."""
    return coords.delinearize_voxel(
        torch.arange(block_size ** 3, dtype=torch.int32, device=device),
        block_size)


def _jax_chunk(cfg: HashConfig) -> int:
    """The JAX version's integrate chunk size for this config."""
    A = cfg.max_active
    C = min(cfg.integrate_chunk, A)
    while A % C:
        C //= 2
    return C


def _window_mode(cfg: HashConfig) -> bool:
    """The integrate depth read goes through the window gather exactly
    when the JAX version calls its Pallas kernel: ``use_pallas_gather``
    and a JAX chunk size divisible by 8."""
    return cfg.use_pallas_gather and _jax_chunk(cfg) % 8 == 0


def project_rows(
    blocks: torch.Tensor,    # (C, 3)
    ptrs: torch.Tensor,      # (C,)
    cfg: HashConfig,
    T_cw: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
):
    """Every voxel of the given block rows projected into the image: the
    window gather's inputs.  Returns (z (C, V) camera depth, v, u (C, V)
    int32 pixel coords clamped in-image, in_img (C, V) bool, row_valid
    (C,) bool)."""
    C = ptrs.shape[0]
    V = cfg.voxels_per_block
    local = _local_offsets(cfg.block_size, device=blocks.device)
    vox = coords.block2voxel(blocks, cfg.block_size)[:, None, :] + local
    world = coords.voxel2world(vox, fusion.voxel_size)
    pc = se3.apply(T_cw, world.reshape(-1, 3)).reshape(C, V, 3)
    ij, in_img = cam_geom.project_nearest(pc, cam)
    u = torch.clamp(ij[..., 0], 0, cam.width - 1)
    v = torch.clamp(ij[..., 1], 0, cam.height - 1)
    return pc[..., 2], v, u, in_img, ptrs != FREE_PTR


def _integrate_rows(
    hmap: HashMap,
    blocks: torch.Tensor,    # (C, 3)
    ptrs: torch.Tensor,      # (C,)
    cfg: HashConfig,
    depth_m: torch.Tensor,
    T_cw: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
    sign: int = 1,
    max_born: int | None = None,
) -> HashMap:
    """Curless-Levoy fusion of the given block rows (in place).

    ``sign=-1`` de-integrates: the running average is invertible below the
    weight cap, so regenerating the same samples (same depth frame, same
    pose) and subtracting removes that frame's contribution.  ``max_born``
    limits the update to rows allocated at or before that frame index
    (``HashMap.born``).

    The per-voxel depth read goes through the window gather's plain
    version under ``_window_mode``, on any device: this body is the plain
    twin that K7 is held against, so it launches no kernel."""
    z, v, u, in_img, row_valid = project_rows(blocks, ptrs, cfg, T_cw, cam,
                                              fusion)
    if _window_mode(cfg):
        # v, u and the mask are fresh results, contiguous as they are
        depth, in_img = window_gather.gather_depth_window_reference(
            depth_m.contiguous(), v, u, in_img & row_valid[:, None])
    else:
        depth = depth_m[v.long(), u.long()]

    sdf = depth - z
    trunc = fusion.truncation + fusion.trunc_scale * depth
    safe_ptr = torch.clamp(ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    valid = (
        row_valid[:, None]
        & in_img
        & (depth > 0)
        & (z > 0)
        & (sdf > -trunc)
    )
    if max_born is not None:
        valid = valid & (hmap.born[safe_ptr] <= max_born)[:, None]
    sdf = torch.minimum(torch.maximum(sdf, -trunc), trunc)
    w_new = torch.where(valid, sample_weight(depth, cam, fusion), 0.0)

    old_sdf = hmap.tsdf[safe_ptr]
    old_w = hmap.weight[safe_ptr]
    if sign > 0:
        w_sum = old_w + w_new
        fused = torch.where(
            w_new > 0,
            (old_sdf * old_w + sdf * w_new) / torch.clamp(w_sum, min=1e-12),
            old_sdf,
        )
        new_w = torch.where(
            w_new > 0, torch.clamp(w_sum, max=fusion.max_weight), old_w)
    else:
        # inverse update; a voxel whose weight falls to ~0 returns to the
        # unobserved state (sdf 0, weight 0)
        w_rem = torch.clamp(old_w - w_new, min=0.0)
        fused = torch.where(
            w_new > 0,
            torch.where(
                w_rem > 1e-6,
                (old_sdf * old_w - sdf * w_new)
                / torch.clamp(w_rem, min=1e-12),
                0.0,
            ),
            old_sdf,
        )
        new_w = torch.where(w_new > 0, w_rem, old_w)
        # float error at a tiny w_rem can push the recovered value out of
        # the band: clamp to the global truncation bound
        tmax = fusion.truncation + fusion.trunc_scale * cam.depth_max
        fused = torch.clamp(fused, -tmax, tmax)

    _set_rows(hmap.tsdf, ptrs, row_valid, fused)
    _set_rows(hmap.weight, ptrs, row_valid, new_w)
    row_min = torch.where(new_w > 0, torch.abs(fused), math.inf).amin(dim=1)
    _set_rows(hmap.band_min, ptrs, row_valid, row_min)
    return hmap


def integrate(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    depth_m: torch.Tensor,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
    sign: int = 1,
    max_born: int | None = None,
    stamp: int | torch.Tensor | None = None,
) -> HashMap:
    """Curless-Levoy fusion over ``active[:count]`` in one pass
    (``sign=-1``: de-integration; ``max_born``: see ``_integrate_rows``);
    with ``stamp`` (an int or a 0-d int32 tensor),
    ``touch_active(hmap, active, stamp)`` too (integration
    never reads ``last_seen``, so the order of the two is free).  One K7
    launch on CUDA tensors (no host read; the window gather's coverage
    inside it under ``_window_mode``); ``touch_active`` and
    ``integrate_reference`` on CPU tensors."""
    if hmap.tsdf.device.type == "cpu":
        if stamp is not None:
            touch_active(hmap, active, stamp)
        return integrate_reference(hmap, active, cfg, depth_m, T_wc, cam,
                                   fusion, sign, max_born)
    return _launch_integrate(hmap, active, cfg, depth_m, T_wc, cam, fusion,
                             sign, max_born, stamp)


def integrate_reference(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    depth_m: torch.Tensor,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    fusion: FusionConfig,
    sign: int = 1,
    max_born: int | None = None,
) -> HashMap:
    """Plain version of ``integrate`` (no stamp), on any device.  Reading
    ``count`` is one device-to-host read."""
    n = int(active.count)
    return _integrate_rows(
        hmap, active.blocks[:n], active.ptrs[:n], cfg, depth_m,
        se3.inverse(T_wc), cam, fusion, sign, max_born,
    )


# --------------------------------------------------------------------------
# garbage collection
# --------------------------------------------------------------------------

def _free_marked(
    hmap: HashMap, cfg: HashConfig, stale: torch.Tensor, max_free: int
) -> Tuple[HashMap, torch.Tensor, torch.Tensor]:
    """Free up to ``max_free`` marked table slots (in place): push their
    rows on the free stack, clear the entries, re-compact every bucket to a
    prefix (stable).  Returns (map, freeing_mask (T,), n_freed)."""
    T = hmap.keys.shape[0]
    stale_rank = torch.cumsum(stale, dim=0) - 1
    freeing = stale & (stale_rank < max_free)
    n_free = torch.sum(freeing).to(torch.int32)

    stack_idx = hmap.free_top + stale_rank
    keep_idx = freeing & (stack_idx < hmap.free_list.shape[0])
    _scatter_drop(hmap.free_list, stack_idx, keep_idx, hmap.ptrs)

    keys = torch.where(freeing, EMPTY_KEY, hmap.keys)
    ptrs = torch.where(freeing, FREE_PTR, hmap.ptrs)

    S = cfg.bucket_size
    kb = keys.reshape(cfg.num_buckets, S)
    pb = ptrs.reshape(cfg.num_buckets, S)
    keep = kb != EMPTY_KEY
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    hmap.keys.copy_(torch.gather(kb, 1, order).reshape(T))
    hmap.ptrs.copy_(torch.gather(pb, 1, order).reshape(T))
    hmap.bucket_fill.copy_(torch.sum(keep, dim=1).to(torch.int32))
    hmap.free_top.add_(n_free)
    return hmap, freeing, n_free


def garbage_collect(
    hmap: HashMap,
    cfg: HashConfig,
    min_weight: float,
    max_free: int,
    frame_idx: int | None = None,
    min_age: int = 0,
) -> Tuple[HashMap, torch.Tensor]:
    """Free blocks whose maximum voxel weight is below ``min_weight``
    (blocks seen within the last ``min_age`` frames are kept).  Returns
    (map, n_freed)."""
    allocated = hmap.ptrs != FREE_PTR
    safe_ptr = torch.clamp(hmap.ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    row_max_w = hmap.weight.amax(dim=-1)
    stale = allocated & (row_max_w[safe_ptr] < min_weight)
    if frame_idx is not None and min_age > 0:
        age = frame_idx - hmap.last_seen[safe_ptr]
        stale = stale & (age >= min_age)
    hmap, _, n_free = _free_marked(hmap, cfg, stale, max_free)
    return hmap, n_free


def touch_active(hmap: HashMap, active: ActiveSet, frame_idx: int) -> HashMap:
    """Stamp the visible set's rows with the current frame index (the
    set's rows are distinct, so the scatter reads nothing on the host)."""
    _scatter_drop(hmap.last_seen, active.ptrs, active.ptrs != FREE_PTR,
                  frame_idx)
    return hmap


# --------------------------------------------------------------------------
# out-of-core streaming: eviction and restore
# --------------------------------------------------------------------------

def evict_stale(
    hmap: HashMap,
    cfg: HashConfig,
    frame_idx: int,
    max_age: int,
    max_evict: int,
) -> Tuple[HashMap, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Evict blocks out of the frustum for more than ``max_age`` frames
    (in place): copy their payload out and free them.

    Returns (map, keys (max_evict,), tsdf (max_evict, V), weight
    (max_evict, V), born (max_evict,), n_evicted (device scalar)); key
    EMPTY_KEY marks padding, and the evicted rows come first, in table
    order.  The host moves the payload into a BlockStore
    (utils/blockstore.py) and restores it on revisit.  ``born`` rides along
    so a restore can reinstate the row's original allocation stamp, which
    keeps born-gated incremental reintegration (models/keyframe_slam) exact
    across evict / restore cycles.  Unlike garbage_collect this keeps
    well-observed geometry: weight does not gate eviction, only recency
    does.  No host synchronization."""
    allocated = hmap.ptrs != FREE_PTR
    safe_ptr = torch.clamp(hmap.ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    age = frame_idx - hmap.last_seen[safe_ptr]
    stale = allocated & (age > max_age)

    # the rows _free_marked will free (same rank and cap), gathered from
    # the table BEFORE it clears their entries; freeing leaves the payload
    # rows themselves untouched
    rank = torch.cumsum(stale, dim=0) - 1
    freeing = stale & (rank < max_evict)
    out_idx = torch.where(freeing, rank, max_evict)
    dev = hmap.keys.device
    out_keys = torch.full((max_evict + 1,), EMPTY_KEY, dtype=torch.int32,
                          device=dev)
    out_ptrs = torch.zeros((max_evict + 1,), dtype=torch.int64, device=dev)
    out_keys[out_idx] = hmap.keys       # row max_evict collects the drops
    out_ptrs[out_idx] = safe_ptr
    out_keys, out_ptrs = out_keys[:max_evict], out_ptrs[:max_evict]
    pad = out_keys == EMPTY_KEY
    out_tsdf = torch.where(pad[:, None], 0.0, hmap.tsdf[out_ptrs])
    out_weight = torch.where(pad[:, None], 0.0, hmap.weight[out_ptrs])
    out_born = torch.where(pad, 0, hmap.born[out_ptrs])

    hmap, _, n_evict = _free_marked(hmap, cfg, stale, max_evict)
    return hmap, out_keys, out_tsdf, out_weight, out_born, n_evict


def restore_blocks(
    hmap: HashMap,
    cfg: HashConfig,
    keys: torch.Tensor,          # (R,) unique packed keys; EMPTY_KEY pad
    tsdf_rows: torch.Tensor,     # (R, V)
    weight_rows: torch.Tensor,   # (R, V)
    frame_idx: int,
    bucket_fn=None,
    max_weight: float = 255.0,
    born_rows: torch.Tensor | None = None,   # (R,) original born stamps
) -> Tuple[HashMap, torch.Tensor]:
    """Re-insert evicted blocks with their stored payload (in place).

    Keys not in the table are inserted and their rows written verbatim
    (bit-exact restore).  Keys already present (the block was re-allocated
    fresh after eviction because the camera revisited before the store's
    frustum prediction fired) are weight-MERGED (Curless-Levoy combine of
    the two weighted averages).  Returns (map, accepted (R,) bool, in input
    order): accepted keys are now fully on the device and the host drops
    its copy; rejected ones (bucket overflow, heap exhaustion) stay in the
    store for a later try.  No host synchronization.

    ``born_rows`` reinstates each row's ORIGINAL allocation stamp (carried
    out by evict_stale): inserted rows take it verbatim; merged rows take
    the MIN of the stored and live stamps (the merged payload holds samples
    from both histories, so de-integration gated at either epoch must
    reach the row).  Without it born is stamped "now", which keeps the map
    safe but makes frames fused before the eviction invisible to the born
    gate.

    RESIDENCY CAVEAT (a bounded approximation, as in the JAX package): the
    born stamp records the row's allocation EPOCH, not its device-residency
    history.  A frame whose frustum covered this block while it was
    off-device (evicted, and a fresh allocation skipped, e.g.
    max_new_per_frame exhausted) fused nothing into it, yet passes the
    born <= frame de-integration gate once the block is restored with its
    original stamp: de-integrating that frame then subtracts a contribution
    that was never added.  The window is narrow (the block must be evicted
    AND revisited AND un-allocatable in the same frames) and each
    occurrence perturbs only that frame's per-voxel sample, but incremental
    reintegration across streaming is therefore exact only up to
    restore-lag frames, not bit-exact in every interleaving.  Callers that
    need strict exactness use a full rebuild (which re-fuses from the
    durable keyframe depths and re-stamps everything)."""
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    R = keys.shape[0]
    N = hmap.tsdf.shape[0]
    dev = keys.device

    ptr_found, found = lookup_keys(hmap, cfg, keys, bucket_fn)

    # --- merge payload into rows that already exist ------------------------
    m_ptr = torch.clamp(ptr_found, 0, N - 1).long()
    old_t = hmap.tsdf[m_ptr]
    old_w = hmap.weight[m_ptr]
    w_sum = old_w + weight_rows
    merged_t = torch.where(
        weight_rows > 0,
        (old_t * old_w + tsdf_rows * weight_rows)
        / torch.clamp(w_sum, min=1e-12),
        old_t,
    )
    merged_w = torch.clamp(w_sum, max=max_weight)
    m_min = torch.where(merged_w > 0, torch.abs(merged_t),
                        math.inf).amin(dim=1)
    merged_born = (torch.minimum(hmap.born[m_ptr], born_rows)
                   if born_rows is not None else None)
    _scatter_drop(hmap.tsdf, m_ptr, found, merged_t)
    _scatter_drop(hmap.weight, m_ptr, found, merged_w)
    _scatter_drop(hmap.band_min, m_ptr, found, m_min)
    if merged_born is not None:
        _scatter_drop(hmap.born, m_ptr, found, merged_born)

    # --- insert the genuinely new keys, payload following the sort ---------
    want = (keys != EMPTY_KEY) & ~found
    blocks = coords.unpack_block_key(keys, cfg.key_bits)
    bucket = torch.where(want, bucket_fn(blocks), cfg.num_buckets)
    order = torch.argsort(bucket, stable=True)
    b_sorted = bucket[order]
    rank_sorted = _segment_rank(b_sorted)
    valid_sorted = b_sorted < cfg.num_buckets

    b_safe = torch.clamp(b_sorted, 0, cfg.num_buckets - 1).long()
    slot_sorted = hmap.bucket_fill[b_safe] + rank_sorted
    ok = valid_sorted & (slot_sorted < cfg.bucket_size)
    alloc_rank = torch.cumsum(ok, dim=0) - 1
    ok = ok & (alloc_rank < hmap.free_top)
    n_alloc = torch.sum(ok).to(torch.int32)

    new_ptrs = hmap.free_list[
        torch.clamp(hmap.free_top - 1 - alloc_rank, 0,
                    hmap.free_list.shape[0] - 1)
    ]
    table_idx = b_safe * cfg.bucket_size + torch.clamp(
        slot_sorted, 0, cfg.bucket_size - 1)
    _scatter_drop(hmap.keys, table_idx, ok, keys[order])
    _scatter_drop(hmap.ptrs, table_idx, ok, new_ptrs)
    hmap.bucket_fill.index_add_(0, b_safe, ok.to(torch.int32))

    t_sorted = tsdf_rows[order]
    w_sorted = weight_rows[order]
    _scatter_drop(hmap.tsdf, new_ptrs, ok, t_sorted)
    _scatter_drop(hmap.weight, new_ptrs, ok, w_sorted)
    _scatter_drop(hmap.last_seen, new_ptrs, ok, frame_idx)
    ins_min = torch.where(w_sorted > 0, torch.abs(t_sorted),
                          math.inf).amin(dim=1)
    _scatter_drop(hmap.band_min, new_ptrs, ok, ins_min)
    # inserted rows reinstate their original allocation stamp when the
    # store carried it; otherwise they are stamped "now"
    _scatter_drop(hmap.born, new_ptrs, ok,
                  born_rows[order] if born_rows is not None else frame_idx)
    hmap.free_top.sub_(n_alloc)

    # accepted mask back in input order: inserted now, or merged
    ok_in = torch.zeros((R,), dtype=torch.bool, device=dev)
    ok_in[order] = ok
    return hmap, ok_in | (found & (keys != EMPTY_KEY))


# --------------------------------------------------------------------------
# whole-frame map update
# --------------------------------------------------------------------------

def allocate_from_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    frame_idx: int = 0,
    bucket_fn=None,
) -> Tuple[HashMap, torch.Tensor]:
    """Per-frame allocation of the frame's truncation-band blocks (on
    CUDA tensors K5a then K5b, no host read)."""
    cand = frame_candidate_keys(frame, T_wc, cam, cfg, fusion)
    return insert_blocks(hmap, cfg, cand, frame_idx, bucket_fn)


def fuse_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    frame_idx: int = 0,
) -> Tuple[HashMap, ActiveSet, torch.Tensor]:
    """alloc -> compact -> touch -> integrate (on CUDA tensors K5a, K5b,
    K6 and K7 with the stamp: four launches, no host read).  Returns (map,
    active_set, n_allocated)."""
    hmap, n_alloc = allocate_from_frame(
        hmap, frame, T_wc, cam, cfg, fusion, frame_idx=frame_idx)
    active = compact_visible(hmap, cfg, T_wc, cam, fusion)
    hmap = integrate(hmap, active, cfg, frame.depth, T_wc, cam, fusion,
                     stamp=frame_idx)
    return hmap, active, n_alloc


def defuse_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    frame_born: int,
) -> HashMap:
    """Remove a previously fused frame's contribution (in place):
    regenerate its samples at the same pose and depth and apply the
    inverse update to the rows that existed when it was fused (born <=
    ``frame_born``).  Exact below the weight cap provided the visible set
    at this pose fits ``max_active``; callers check ``ActiveSet.count``.
    No allocation, no visibility stamping."""
    active = compact_visible(hmap, cfg, T_wc, cam, fusion)
    return integrate(hmap, active, cfg, frame.depth, T_wc, cam, fusion,
                     sign=-1, max_born=int(frame_born))


# --------------------------------------------------------------------------
# the kernels' wrappers (csrc/fuse.cu)
# --------------------------------------------------------------------------

def _on_cuda(dev: torch.device, *tensors) -> bool:
    return dev.type == "cuda" and all(t.device == dev for t in tensors)


def _compact_plan(cfg: HashConfig, cam: CameraConfig,
                  fusion: FusionConfig) -> tuple:
    """K6's host tables (ctypes arrays): ints (max_active, key bits, block
    size) and floats (``block_in_frustum``'s constants as the plain
    version computes them in Python doubles: voxel size, half a block,
    fx, fy, cx, cy, width, height, margin, radius * fx, radius * fy, near,
    far), built once a configuration (kept by the objects' identity,
    which costs less than hashing them); or raise."""
    key = (id(cfg), id(cam), id(fusion))
    got = _COMPACT_PLANS.get(key)
    if (got is not None and got[0] is cfg and got[1] is cam
            and got[2] is fusion):
        return got[3]
    if not 1 <= cfg.key_bits <= MAX_KEY_BITS:
        raise ValueError(f"compact_visible: key bits 1..{MAX_KEY_BITS} "
                         f"expected, got {cfg.key_bits}")
    half = 0.5 * cfg.block_size * fusion.voxel_size
    radius = half * 1.7320508
    floats = (fusion.voxel_size, half, cam.fx, cam.fy, cam.cx, cam.cy,
              float(cam.width), float(cam.height), FRUSTUM_MARGIN_PX,
              radius * cam.fx, radius * cam.fy, cam.depth_min - 2.0 * half,
              cam.depth_max + 2.0 * half)
    tables = ((ctypes.c_int * 3)(cfg.max_active, cfg.key_bits,
                                 cfg.block_size),
              (ctypes.c_float * len(floats))(*floats))
    if len(_COMPACT_PLANS) >= 64:
        _COMPACT_PLANS.clear()
    _COMPACT_PLANS[key] = (cfg, cam, fusion, tables)
    return tables


def _compact_scratch(dev: torch.device, stream: int, tiles: int) -> tuple:
    """K6's scratch for a table of ``tiles`` tiles on ``dev`` and
    ``stream`` (a raw stream handle): (int64 tensor, its statuses), zeroed
    when made: the epoch word, then a status a tile, COMPACT_STATUS_WORDS
    words apart.  Every launch tags its statuses with the epoch and raises
    it, so nothing clears the scratch between launches.  One persists a
    device and stream: made at first use (at least COMPACT_MIN_TILES
    statuses, a power of two), replaced by a larger one when a table
    outgrows it; a
    replaced one is kept alive, since a CUDA graph captured with it still
    runs on it.  None is made persistent while the stream is being
    captured (its zeroing would run only in the graph): a capture that
    finds none large enough takes a scratch of its own, zeroed in the
    graph before each replay's launch and kept nowhere else."""
    key = (dev.index, stream)
    got = _COMPACT_SCRATCH.get(key)
    if got is not None and got[1] >= tiles:
        return got
    n = max(COMPACT_MIN_TILES, 1 << max(tiles - 1, 0).bit_length())
    fresh = (torch.zeros((1 + COMPACT_STATUS_WORDS * n,), dtype=torch.int64,
                         device=dev), n)
    if _capturing(dev):
        return fresh
    if got is not None:
        _COMPACT_RETIRED.append(got[0])
    _COMPACT_SCRATCH[key] = fresh
    return fresh


def _launch_compact(hmap: HashMap, cfg: HashConfig, T_wc: torch.Tensor,
                    cam: CameraConfig, fusion: FusionConfig) -> ActiveSet:
    """K6 on the current stream: a fresh ActiveSet (its three tensors
    share one allocation) computed on the stream's persistent scratch, or
    raise."""
    keys, ptrs = hmap.keys, hmap.ptrs
    dev = keys.device
    if not _on_cuda(dev, ptrs, T_wc):
        raise ValueError("compact_visible: the table and the pose must lie "
                         "on one CUDA device (or all on the CPU)")
    if (keys.dtype != torch.int32 or ptrs.dtype != torch.int32
            or T_wc.dtype != torch.float32):
        raise ValueError("compact_visible: int32 keys and ptrs and a "
                         "float32 pose expected")
    T = keys.shape[0]
    if (keys.dim() != 1 or ptrs.shape != keys.shape or T < 1
            or tuple(T_wc.shape) != (4, 4)):
        raise ValueError("compact_visible: (T,) keys and ptrs and a (4, 4) "
                         "pose expected")
    ints, floats = _compact_plan(cfg, cam, fusion)
    A = cfg.max_active
    keys, ptrs, pose = keys.contiguous(), ptrs.contiguous(), \
        T_wc.contiguous()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, _ = _compact_scratch(dev, stream, -(-T // COMPACT_TILE))
    buf = torch.empty(4 * A + 1, dtype=torch.int32, device=dev)
    kernels.launch("compact_visible", dev.index, keys.data_ptr(),
                   ptrs.data_ptr(), pose.data_ptr(), buf.data_ptr(),
                   scratch.data_ptr(), scratch.shape[0] - 1, T, ints, floats)
    global LAUNCHES_COMPACT
    LAUNCHES_COMPACT += 1
    return ActiveSet(blocks=buf[:3 * A].view(A, 3), ptrs=buf[3 * A:4 * A],
                     count=buf[4 * A])


@functools.lru_cache(maxsize=64)
def _integrate_plan(cfg: HashConfig, cam: CameraConfig,
                    fusion: FusionConfig) -> tuple:
    """K7's constant arguments, as two tuples around the per-call ones:
    (block size, H, W, the window's h and w, window mode) and (falloff,
    voxel size, fx, fy, cx, cy, truncation, its depth scale,
    weight_sample, weight_sample * 1.5, depth_min, recip(depth_max -
    depth_min), max_weight, the inverse update's clamp) as the plain
    version computes them in Python doubles; or raise."""
    if cfg.voxels_per_block > MAX_VOXELS:
        raise ValueError(f"integrate: at most {MAX_VOXELS} voxels a block, "
                         f"got {cfg.voxels_per_block}")
    wh, ww = window_gather._win(cam.height, cam.width)
    head = (cfg.block_size, cam.height, cam.width, wh, ww,
            int(_window_mode(cfg)))
    tail = (int(fusion.depth_weight_falloff), fusion.voxel_size, cam.fx,
            cam.fy, cam.cx, cam.cy, fusion.truncation, fusion.trunc_scale,
            fusion.weight_sample, fusion.weight_sample * 1.5, cam.depth_min,
            recip(cam.depth_max - cam.depth_min), fusion.max_weight,
            fusion.truncation + fusion.trunc_scale * cam.depth_max)
    return head, tail


def _integrate_tables(hmap: HashMap, cfg: HashConfig, cam: CameraConfig,
                      fusion: FusionConfig) -> tuple:
    """K7's host tables for this map and configuration: (the row tensors'
    addresses: tsdf, weight, band_min, born, last_seen; the ints: map
    rows, block size, H, W, the window's h and w, window mode, falloff;
    the floats of ``_integrate_plan``'s tail) as ctypes arrays, after
    checking the rows against what K7 takes (one CUDA device, float32
    tsdf, weight and band_min, int32 born and last_seen, (N, V) and (N,),
    contiguous), or raise.  Built once: a map whose row tensors are the
    same objects, with the same configuration objects, is not checked
    again (the map is updated in place)."""
    rows = (hmap.tsdf, hmap.weight, hmap.band_min, hmap.born,
            hmap.last_seen)
    got = _INTEGRATE_TABLES.get(id(hmap.tsdf))
    if got is not None:
        refs, c, cm, fu, tables = got
        if (c is cfg and cm is cam and fu is fusion
                and all(r() is t for r, t in zip(refs, rows))):
            return tables
    head, tail = _integrate_plan(cfg, cam, fusion)
    dev = hmap.tsdf.device
    if not _on_cuda(dev, *rows):
        raise ValueError("integrate: the map, the active set, the depth and "
                         "the pose must lie on one CUDA device (or all on "
                         "the CPU)")
    if (any(t.dtype != torch.float32 for t in rows[:3])
            or any(t.dtype != torch.int32 for t in rows[3:])):
        raise ValueError("integrate: an int32 active set, born and "
                         "last_seen, and float32 map rows, depth and pose "
                         "expected")
    N, V = hmap.tsdf.shape[0], cfg.voxels_per_block
    if (hmap.tsdf.dim() != 2 or hmap.tsdf.shape[1] != V
            or hmap.weight.shape != hmap.tsdf.shape
            or any(tuple(t.shape) != (N,) for t in rows[2:])):
        raise ValueError(
            f"integrate: (N, {V}) map rows with (N,) band_min, born and "
            f"last_seen expected")
    if not all(t.is_contiguous() for t in rows):
        raise ValueError("integrate: the map's rows must be contiguous (they "
                         "are updated in place)")
    block_size, H, W, wh, ww, window = head
    falloff, *floats = tail
    tables = ((ctypes.c_void_p * 5)(*(t.data_ptr() for t in rows)),
              (ctypes.c_int * 8)(N, block_size, H, W, wh, ww, window,
                                 falloff),
              (ctypes.c_float * len(floats))(*floats), window)
    if len(_INTEGRATE_TABLES) >= 16:
        _INTEGRATE_TABLES.clear()
    _INTEGRATE_TABLES[id(hmap.tsdf)] = (
        tuple(weakref.ref(t) for t in rows), cfg, cam, fusion, tables)
    return tables


def _launch_integrate(hmap: HashMap, active: ActiveSet, cfg: HashConfig,
                      depth_m: torch.Tensor, T_wc: torch.Tensor,
                      cam: CameraConfig, fusion: FusionConfig, sign: int,
                      max_born: int | None,
                      stamp: int | torch.Tensor | None) -> HashMap:
    """K7 on the current stream, the map updated in place; or raise."""
    map_ptrs, ints, floats, window = _integrate_tables(hmap, cfg, cam,
                                                       fusion)
    blocks, ptrs, count = active
    dev = hmap.tsdf.device
    if not _on_cuda(dev, blocks, ptrs, count, depth_m, T_wc):
        raise ValueError("integrate: the map, the active set, the depth and "
                         "the pose must lie on one CUDA device (or all on "
                         "the CPU)")
    if (blocks.dtype != torch.int32 or ptrs.dtype != torch.int32
            or count.dtype != torch.int32 or depth_m.dtype != torch.float32
            or T_wc.dtype != torch.float32):
        raise ValueError("integrate: an int32 active set, born and "
                         "last_seen, and float32 map rows, depth and pose "
                         "expected")
    rows = ptrs.shape[0]
    if (ptrs.dim() != 1 or tuple(blocks.shape) != (rows, 3)
            or count.numel() != 1 or tuple(T_wc.shape) != (4, 4)
            or tuple(depth_m.shape) != (cam.height, cam.width)):
        raise ValueError(
            f"integrate: blocks (A, 3), ptrs (A,), one count, a (4, 4) pose "
            f"and a {(cam.height, cam.width)} depth expected")
    if sign not in (1, -1):
        raise ValueError(f"integrate: sign +1 or -1 expected, got {sign}")
    stamp_ptr, stamp_int = _stamp_arg(stamp, dev, "integrate")
    blocks, ptrs, depth, pose = (t.contiguous() for t in (blocks, ptrs,
                                                          depth_m, T_wc))
    kernels.launch(
        "integrate_rows", dev.index, blocks.data_ptr(), ptrs.data_ptr(),
        count.data_ptr(), map_ptrs, depth.data_ptr(), pose.data_ptr(),
        stamp_ptr, rows, sign, int(max_born is not None),
        0 if max_born is None else int(max_born), int(stamp is not None),
        stamp_int, ints, floats)
    global LAUNCHES_INTEGRATE, LAUNCHES_INTEGRATE_WINDOW
    LAUNCHES_INTEGRATE += 1
    LAUNCHES_INTEGRATE_WINDOW += window
    return hmap


# --------------------------------------------------------------------------
# the allocation kernels' wrappers (csrc/alloc.cu)
# --------------------------------------------------------------------------

def _stamp_arg(stamp, dev: torch.device, what: str) -> tuple:
    """(pointer or None, int) of a stamp given as an int (or None: 0) or as
    a 0-d int32 tensor on ``dev``, which the kernel reads; or raise."""
    if not torch.is_tensor(stamp):
        return None, 0 if stamp is None else int(stamp)
    if (stamp.device != dev or stamp.dtype != torch.int32
            or stamp.numel() != 1):
        raise ValueError(f"{what}: a stamp tensor must be one int32 on the "
                         f"map's CUDA device")
    return stamp.data_ptr(), 0


def _candidate_tables(cfg: HashConfig, fusion: FusionConfig) -> tuple:
    """K5a's host tables (ctypes arrays): ints (stride, band steps, key
    bits, block size) and floats (truncation, its depth scale,
    recip(voxel size), and torch.linspace(-1, 1, band steps)'s step
    2 / (band steps - 1) divided in float32 as linspace divides it; 0 for
    one step), built once a configuration (kept by the objects' identity,
    which costs less than hashing them); or raise."""
    got = _CANDIDATE_TABLES.get((id(cfg), id(fusion)))
    if got is not None and got[0] is cfg and got[1] is fusion:
        return got[2]
    if not 1 <= cfg.key_bits <= MAX_KEY_BITS:
        raise ValueError(f"frame_candidate_keys: key bits 1..{MAX_KEY_BITS} "
                         f"expected, got {cfg.key_bits}")
    n = cfg.band_steps
    step = float(torch.tensor(2.0) / (n - 1)) if n > 1 else 0.0
    floats = (fusion.truncation, fusion.trunc_scale,
              recip(fusion.voxel_size), step)
    tables = ((ctypes.c_int * 4)(cfg.candidate_stride, cfg.band_steps,
                                 cfg.key_bits, cfg.block_size),
              (ctypes.c_float * len(floats))(*floats))
    if len(_CANDIDATE_TABLES) >= 64:
        _CANDIDATE_TABLES.clear()
    _CANDIDATE_TABLES[(id(cfg), id(fusion))] = (cfg, fusion, tables)
    return tables


def _launch_candidates(frame: Frame, T_wc: torch.Tensor, cfg: HashConfig,
                       fusion: FusionConfig) -> torch.Tensor:
    """K5a on the current stream: a fresh (band_steps * h * w,) key array,
    or raise."""
    verts, depth = frame.vertices, frame.depth
    dev = depth.device
    if not _on_cuda(dev, verts, T_wc):
        raise ValueError("frame_candidate_keys: the frame and the pose must "
                         "lie on one CUDA device (or all on the CPU)")
    if (verts.dtype != torch.float32 or depth.dtype != torch.float32
            or T_wc.dtype != torch.float32):
        raise ValueError("frame_candidate_keys: float32 vertices, depth and "
                         "pose expected")
    H, W = depth.shape if depth.dim() == 2 else (0, 0)
    if (depth.dim() != 2 or verts.shape != (H, W, 3)
            or T_wc.shape != (4, 4) or H * W == 0):
        raise ValueError("frame_candidate_keys: (H, W, 3) vertices, an (H, "
                         "W) depth and a (4, 4) pose expected")
    ints, floats = _candidate_tables(cfg, fusion)
    s = cfg.candidate_stride
    out = torch.empty(cfg.band_steps * (-(-H // s)) * (-(-W // s)),
                      dtype=torch.int32, device=dev)
    verts, depth, pose = verts.contiguous(), depth.contiguous(), \
        T_wc.contiguous()
    kernels.launch("alloc_candidates", dev.index, verts.data_ptr(),
                   depth.data_ptr(), pose.data_ptr(), out.data_ptr(), H, W,
                   ints, floats)
    global LAUNCHES_ALLOC_CANDIDATES
    LAUNCHES_ALLOC_CANDIDATES += 1
    return out


def _insert_plan(cfg: HashConfig, bucket_fn) -> tuple:
    """K5b's configuration ints after the map's rows: key bits, the hash's
    buckets and divisor, max_new; or raise."""
    fn = bucket_fn or default_bucket_fn(cfg)
    if not isinstance(fn, BucketHash):
        raise ValueError("insert_blocks: on the card the bucket function "
                         "must be a hash_ops.BucketHash, got "
                         f"{type(fn).__name__}")
    if fn.num_buckets < 1 or fn.divisor < 1:
        raise ValueError(f"insert_blocks: {fn}: num_buckets and divisor "
                         f"must be positive")
    if not 0 <= cfg.max_new_per_frame <= MAX_NEW:
        raise ValueError(f"insert_blocks: max_new_per_frame 0..{MAX_NEW} "
                         f"(one CTA's shared memory), got "
                         f"{cfg.max_new_per_frame}")
    if not 1 <= cfg.key_bits <= MAX_KEY_BITS:
        raise ValueError(f"insert_blocks: key bits 1..{MAX_KEY_BITS} "
                         f"expected, got {cfg.key_bits}")
    if not 1 <= cfg.bucket_size <= MAX_BUCKET_SIZE:
        raise ValueError(f"insert_blocks: bucket_size 1..{MAX_BUCKET_SIZE} "
                         f"expected, got {cfg.bucket_size}")
    return (cfg.key_bits, fn.num_buckets, fn.divisor, cfg.max_new_per_frame)


def insert_scratch_size(M: int) -> tuple:
    """(capacity, set_bits, ints) of a K5b scratch that takes ``M`` keys:
    the capacity the next power of two >= M (at least
    ``INSERT_MIN_CAPACITY``), a set of 2 x capacity slots, and the int32
    count that csrc/alloc.cu lays out (kHdrInts + 5 capacity + 2^set_bits
    + kMaxNew)."""
    capacity = max(INSERT_MIN_CAPACITY, 1 << max(M - 1, 0).bit_length())
    set_bits = capacity.bit_length()            # 2^set_bits = 2 capacity
    return (capacity, set_bits,
            INSERT_HDR_INTS + 5 * capacity + (1 << set_bits) + MAX_NEW)


def _capturing(dev: torch.device) -> bool:
    """Whether ``dev``'s current stream is being captured into a CUDA
    graph."""
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _insert_scratch(dev: torch.device, stream: int, M: int) -> tuple:
    """K5b's scratch for ``M`` keys on ``dev`` and ``stream`` (a raw
    stream handle): (tensor, capacity, set_bits), its set EMPTY_KEY and
    its counts 0 (every launch leaves them so).  One persists a device and
    stream: made at first use, replaced by a larger one when M outgrows
    it; a replaced one is kept alive, since a CUDA graph captured with it
    still runs on it.  A persistent scratch is never made while the stream
    is being captured (its fill would run only in the graph): a capture
    that finds none large enough takes a scratch of its own, filled in the
    graph before each replay's launch and kept nowhere else."""
    key = (dev.index, stream)
    got = _INSERT_SCRATCH.get(key)
    if got is not None and got[1] >= M:
        return got
    capacity, set_bits, ints = insert_scratch_size(M)
    fresh = (torch.empty((ints,), dtype=torch.int32, device=dev), capacity,
             set_bits)
    hdr, st = insert_scratch_parts(*fresh)
    hdr.zero_()
    st.fill_(EMPTY_KEY)
    if _capturing(dev):
        return fresh
    if got is not None:
        _INSERT_RETIRED.append(got[0])
    _INSERT_SCRATCH[key] = fresh
    return fresh


def insert_scratch_parts(scratch: torch.Tensor, capacity: int,
                         set_bits: int) -> tuple:
    """(counts, set) views of a K5b scratch: the header's key counts and
    arrival count, and the set; between launches both as the wrapper made
    them, 0 and EMPTY_KEY (the header's epoch and what it hands the
    waiting CTAs, past them, run on)."""
    s0 = INSERT_HDR_INTS + 2 * capacity
    return scratch[:INSERT_HDR_ZERO], scratch[s0:s0 + (1 << set_bits)]


def _insert_tables(hmap: HashMap, cfg: HashConfig, bucket_fn) -> tuple:
    """K5b's host tables for this map, configuration and bucket function:
    (the map's tensors' addresses in HashMap order, the ints nb, S, N, V,
    key bits, the hash's buckets and divisor, max_new) as ctypes arrays,
    after checking the map against what K5b takes (one CUDA device, int32
    integer state, float32 rows, the table's shapes, contiguous), or
    raise.  Built once: a map whose tensors are the same objects, with the
    same configuration and bucket function, is not checked again (the map
    is updated in place; nothing in the port swaps a tensor's storage)."""
    got = _MAP_CHECKED.get(id(hmap.keys))
    if got is not None:
        refs, c, fn, tables = got
        if (c is cfg and fn == bucket_fn
                and all(r() is t for r, t in zip(refs, hmap))):
            return tables
    plan = _insert_plan(cfg, bucket_fn)
    dev = hmap.keys.device
    ints = (hmap.keys, hmap.ptrs, hmap.bucket_fill, hmap.free_list,
            hmap.free_top, hmap.last_seen, hmap.born)
    floats = (hmap.tsdf, hmap.weight, hmap.band_min)
    if not _on_cuda(dev, *ints, *floats):
        raise ValueError("insert_blocks: the map and the keys must lie on "
                         "one CUDA device (or all on the CPU)")
    if (any(t.dtype != torch.int32 for t in ints)
            or any(t.dtype != torch.float32 for t in floats)):
        raise ValueError("insert_blocks: int32 keys and integer map state "
                         "and float32 map rows expected")
    S, nb = cfg.bucket_size, cfg.num_buckets
    N, V = hmap.tsdf.shape[0], cfg.voxels_per_block
    if (tuple(hmap.keys.shape) != (nb * S,)
            or hmap.ptrs.shape != hmap.keys.shape
            or tuple(hmap.bucket_fill.shape) != (nb,)
            or hmap.free_top.numel() != 1
            or tuple(hmap.tsdf.shape) != (N, V) or N < 1
            or hmap.weight.shape != hmap.tsdf.shape
            or any(tuple(t.shape) != (N,) for t in (
                hmap.free_list, hmap.last_seen, hmap.band_min, hmap.born))):
        raise ValueError(
            f"insert_blocks: (M,) keys, a ({nb * S},) table, ({nb},) "
            f"bucket_fill, one free_top and (N, {V}) map rows with (N,) "
            f"free_list, last_seen, band_min and born expected")
    if not all(t.is_contiguous() for t in ints + floats):
        raise ValueError("insert_blocks: the map must be contiguous (it is "
                         "updated in place)")
    ptrs = tuple(t.data_ptr() for t in hmap)
    key_bits, hash_buckets, divisor, max_new = plan
    tables = ((ctypes.c_void_p * len(ptrs))(*ptrs),
              (ctypes.c_int * 8)(nb, S, N, V, key_bits, hash_buckets,
                                 divisor, max_new))
    if len(_MAP_CHECKED) >= 16:
        _MAP_CHECKED.clear()
    _MAP_CHECKED[id(hmap.keys)] = (tuple(weakref.ref(t) for t in hmap),
                                   cfg, bucket_fn, tables)
    return tables


def _launch_insert(hmap: HashMap, cfg: HashConfig, cand_keys: torch.Tensor,
                   frame_idx, bucket_fn) -> Tuple[HashMap, torch.Tensor]:
    """K5b on the current stream, the map updated in place: (map, a fresh
    0-d int32 n_alloc); or raise.  The scratch persists (one a device and
    stream); n_alloc stays a fresh tensor, since callers keep it a frame
    (``StepInfo.blocks_allocated``)."""
    map_ptrs, ints = _insert_tables(hmap, cfg, bucket_fn)
    dev = hmap.keys.device
    if cand_keys.device != dev:
        raise ValueError("insert_blocks: the map and the keys must lie on "
                         "one CUDA device (or all on the CPU)")
    if cand_keys.dtype != torch.int32 or cand_keys.dim() != 1:
        raise ValueError("insert_blocks: (M,) int32 keys expected")
    stamp_ptr, stamp_int = _stamp_arg(frame_idx, dev, "insert_blocks")
    M = cand_keys.shape[0]
    cand = cand_keys.contiguous()
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch, capacity, set_bits = _insert_scratch(dev, stream, M)
    n_alloc = torch.empty((), dtype=torch.int32, device=dev)
    kernels.launch("insert_blocks", dev.index, cand.data_ptr(), M,
                   n_alloc.data_ptr(), stamp_ptr, stamp_int,
                   scratch.data_ptr(), capacity, set_bits, map_ptrs, ints)
    global LAUNCHES_INSERT
    LAUNCHES_INSERT += 1
    return hmap, n_alloc
