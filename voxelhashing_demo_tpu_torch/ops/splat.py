"""Splat surface prediction (port of ops/splat.py): every surface-band
voxel of the visible blocks projects to a pixel, where the surface along
that pixel's ray sits at z + sdf (the TSDF is projective); a scatter-min
z-buffer keeps the nearest estimate, then a 3x3 valid-min hole fill and an
edge-preserving smoothing pass finish the depth map.

The scatter-min is order independent, so the one-pass walk over
``active[:count]`` gives the JAX version's chunked result exactly.

Two hand-written kernels (``csrc/splat.cu``) serve CUDA tensors: K8
``splat_zbuffer`` scatters the visible set's voxels into a z-buffer (the
row count read on the device, ``surface_filter`` a row's skip), K9
``splat_finalize`` turns a raw buffer into the ``RaycastOutput`` (fill,
smooth, points and normals in shared memory).  ``splat_raycast`` is a
buffer reset, K8 and K9; ``splat_depth_from_map`` a reset, K8 and one
pass that writes 0 where nothing landed; ``finalize_depth`` K9.  None
reads a value back to the host.  CPU tensors run the plain versions
(``splat_raycast_reference``, ``splat_depth_from_map_reference``,
``finalize_depth_reference``), which the tests and the card checks also
call on the card.  A launch that the kernels do not take raises; nothing
falls back.  ``LAUNCHES_ZBUFFER`` and ``LAUNCHES_FINALIZE`` count the
launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch
import torch.nn.functional as F

from .. import kernels
from ..config import CameraConfig, FusionConfig, HashConfig, RaycastConfig
from ..geometry import camera as cam_geom
from ..geometry import coords, se3
from ..geometry.f32 import recip
from .hash_ops import (FREE_PTR, ActiveSet, HashMap, _local_offsets,
                       _on_cuda, _set_rows)
from .preprocess import compute_normals
from .raycast import RaycastOutput

LAUNCHES_ZBUFFER = 0    # K8 splat_zbuffer
LAUNCHES_FINALIZE = 0   # K9 splat_finalize

MAX_FILL_ROUNDS = 16    # the hole-fill rounds K9 takes (kMaxFillRounds)
MAX_VOXELS = 1024       # the voxels a block K8 takes (kMaxVoxels)

# K9's host tables a configuration: (id(cam), id(rc), id(fusion)) -> (cam,
# rc, fusion, tables), kept by the objects' identity (``_finalize_tables``)
_FINALIZE_TABLES: dict = {}
# K8's host tables a map and configuration: id(tsdf) -> (weak references to
# the row tensors, the configuration objects, the tables)
# (``_zbuffer_tables``)
_ZBUFFER_TABLES: dict = {}


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
    """Raw splat depth (H, W) of ``active[:count]`` (0 = no estimate), as
    the multi-device path ``pmin``s it: a buffer reset, K8 and one pass
    on CUDA tensors, ``splat_depth_from_map_reference`` on CPU tensors."""
    if hmap.tsdf.device.type == "cpu":
        return splat_depth_from_map_reference(hmap, active, cfg, T_wc, cam,
                                              rc, fusion)
    zbuf = _launch_zbuffer(hmap, active, cfg, T_wc, cam, rc, fusion,
                           band_filter=False)
    return torch.nan_to_num(zbuf.view(cam.height, cam.width), nan=0.0,
                            posinf=0.0, neginf=0.0)


def splat_depth_from_map_reference(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> torch.Tensor:
    """Plain version of ``splat_depth_from_map``, on any device."""
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
    """Hole fill + smoothing + vertex/normal maps from a raw splat buffer
    (H, W) (0 = no estimate): one K9 launch on a CUDA tensor,
    ``finalize_depth_reference`` on a CPU tensor.  K9 also reads a value
    that is not finite as no estimate, so ``splat_raycast`` hands it K8's
    buffer (+inf where nothing landed) as it is."""
    if depth.device.type == "cpu":
        return finalize_depth_reference(depth, cam, rc, fusion)
    return _launch_finalize(depth, cam, rc, fusion)


def finalize_depth_reference(
    depth: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Plain version of ``finalize_depth``, on any device."""
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
    """Surface prediction of the hashed TSDF from pose ``T_wc``: a buffer
    reset, K8 (rows outside the surface band skipped) and K9 on CUDA
    tensors, ``splat_raycast_reference`` on CPU tensors."""
    if hmap.tsdf.device.type == "cpu":
        return splat_raycast_reference(hmap, active, cfg, T_wc, cam, rc,
                                       fusion)
    zbuf = _launch_zbuffer(hmap, active, cfg, T_wc, cam, rc, fusion,
                           band_filter=True)
    return _launch_finalize(zbuf.view(cam.height, cam.width), cam, rc,
                            fusion)


def splat_raycast_reference(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Plain version of ``splat_raycast``, on any device."""
    surf = surface_filter(hmap, active, rc.splat_band * fusion.voxel_size)
    depth = splat_depth_from_map_reference(hmap, surf, cfg, T_wc, cam, rc,
                                           fusion)
    return finalize_depth_reference(depth, cam, rc, fusion)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

_ZBUFFERS: dict = {}    # (device index, stream, pixels) -> K8's z-buffer


@functools.lru_cache(maxsize=64)
def _zbuffer_plan(cfg: HashConfig, cam: CameraConfig, rc: RaycastConfig,
                  fusion: FusionConfig) -> tuple:
    """K8's constants (``_zbuffer_tables`` makes its host tables of
    them): block size, H, W, then the floats voxel size, fx, fy, cx, cy,
    near, far, band; or raise."""
    if cfg.voxels_per_block > MAX_VOXELS:
        raise ValueError(f"splat: at most {MAX_VOXELS} voxels a block, got "
                         f"{cfg.voxels_per_block}")
    if not rc.near >= 0.0:
        raise ValueError(f"splat: near >= 0 expected (the z-buffer orders "
                         f"positive floats by their bits), got {rc.near}")
    return (cfg.block_size, cam.height, cam.width, fusion.voxel_size,
            cam.fx, cam.fy, cam.cx, cam.cy, rc.near, rc.far,
            rc.splat_band * fusion.voxel_size)


def _zbuffer_tables(hmap: HashMap, cfg: HashConfig, cam: CameraConfig,
                    rc: RaycastConfig, fusion: FusionConfig) -> tuple:
    """K8's host tables for this map and configuration: (the row arrays'
    addresses: tsdf, weight, band_min; the ints: map rows, block size, H,
    W; the floats of ``_zbuffer_plan``: voxel size, fx, fy, cx, cy, near,
    far, band) as ctypes arrays, the map's device, and the rows as the
    kernel reads them where they are copies (else None), after checking
    the rows against what K8 takes (float32 (N, V) tsdf and weight and
    (N,) band_min on one CUDA device), or raise.  Built once: a map whose
    row tensors are the same objects, with the same configuration
    objects, is not checked again (the map is updated in place).  Rows
    that are not contiguous are read as contiguous copies, made again at
    every call."""
    rows = (hmap.tsdf, hmap.weight, hmap.band_min)
    got = _ZBUFFER_TABLES.get(id(hmap.tsdf))
    if got is not None:
        refs, c, cm, r, fu, tables = got
        if (c is cfg and cm is cam and r is rc and fu is fusion
                and all(x() is t for x, t in zip(refs, rows))):
            return tables
    bs, H, W, *floats = _zbuffer_plan(cfg, cam, rc, fusion)
    dev = hmap.tsdf.device
    if dev.type != "cuda" or any(t.device != dev for t in rows):
        raise ValueError("splat: the map, the active set and the pose must "
                         "lie on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in rows):
        raise ValueError("splat: an int32 active set and a float32 map and "
                         "pose expected")
    N, V = hmap.tsdf.shape[0], cfg.voxels_per_block
    if (hmap.tsdf.dim() != 2 or hmap.tsdf.shape[1] != V
            or hmap.weight.shape != hmap.tsdf.shape
            or tuple(hmap.band_min.shape) != (N,)):
        raise ValueError(
            f"splat: blocks (A, 3), ptrs (A,), one count, a (4, 4) pose and "
            f"(N, {V}) map rows with (N,) band_min expected")
    flat = tuple(t.contiguous() for t in rows)
    copies = None if all(f is t for f, t in zip(flat, rows)) else flat
    tables = ((ctypes.c_void_p * 3)(*(t.data_ptr() for t in flat)),
              (ctypes.c_int * 4)(N, bs, H, W),
              (ctypes.c_float * len(floats))(*floats), dev, copies)
    if copies is None:
        if len(_ZBUFFER_TABLES) >= 16:
            _ZBUFFER_TABLES.clear()
        _ZBUFFER_TABLES[id(hmap.tsdf)] = (
            tuple(weakref.ref(t) for t in rows), cfg, cam, rc, fusion,
            tables)
    return tables


def _zbuffer_args(hmap: HashMap, active: ActiveSet, cfg: HashConfig,
                  T_wc: torch.Tensor, cam: CameraConfig, rc: RaycastConfig,
                  fusion: FusionConfig, band_filter: bool) -> tuple:
    """(K8's C arguments after the device index and the z-buffer, the
    tensors they point into) for a launch over ``active[:count]``; or
    raise on what the kernel does not take.  The tensors must stay alive
    until the launch."""
    map_ptrs, ints, floats, dev, copies = _zbuffer_tables(hmap, cfg, cam,
                                                          rc, fusion)
    blocks, ptrs, count = active
    if not _on_cuda(dev, blocks, ptrs, count, T_wc):
        raise ValueError("splat: the map, the active set and the pose must "
                         "lie on one CUDA device (or all on the CPU)")
    if (blocks.dtype != torch.int32 or ptrs.dtype != torch.int32
            or count.dtype != torch.int32 or T_wc.dtype != torch.float32):
        raise ValueError("splat: an int32 active set and a float32 map and "
                         "pose expected")
    rows = ptrs.shape[0]
    if (ptrs.dim() != 1 or tuple(blocks.shape) != (rows, 3)
            or count.numel() != 1 or tuple(T_wc.shape) != (4, 4)):
        raise ValueError(
            f"splat: blocks (A, 3), ptrs (A,), one count, a (4, 4) pose and "
            f"(N, {cfg.voxels_per_block}) map rows with (N,) band_min "
            f"expected")
    keep = (blocks.contiguous(), ptrs.contiguous(), count.contiguous(),
            T_wc.contiguous(), copies)
    return (*(t.data_ptr() for t in keep[:4]), rows, int(band_filter),
            map_ptrs, ints, floats), keep


def _launch_zbuffer(hmap: HashMap, active: ActiveSet, cfg: HashConfig,
                    T_wc: torch.Tensor, cam: CameraConfig,
                    rc: RaycastConfig, fusion: FusionConfig,
                    band_filter: bool) -> torch.Tensor:
    """A reset and K8 on the current stream: the (H * W,) z-buffer of
    ``active[:count]`` (+inf where nothing landed), the wrapper's own
    buffer for this device and stream (valid until its next call there);
    ``band_filter`` skips the rows that ``surface_filter`` drops.  Raises
    on what the kernel does not take."""
    args, keep = _zbuffer_args(hmap, active, cfg, T_wc, cam, rc, fusion,
                               band_filter)      # keep: alive to the launch
    index = hmap.tsdf.device.index
    key = (index, torch._C._cuda_getCurrentRawStream(index),
           cam.height * cam.width)
    zbuf = _ZBUFFERS.get(key)
    if zbuf is None:
        zbuf = _ZBUFFERS[key] = torch.empty(key[2], dtype=torch.float32,
                                            device=hmap.tsdf.device)
    zbuf.fill_(math.inf)
    kernels.launch("splat_zbuffer", index, zbuf.data_ptr(), *args)
    global LAUNCHES_ZBUFFER
    LAUNCHES_ZBUFFER += 1
    return zbuf


@functools.lru_cache(maxsize=64)
def _finalize_plan(cam: CameraConfig, rc: RaycastConfig,
                   fusion: FusionConfig) -> tuple:
    """K9's arguments after the pointers and the image size: fill rounds,
    smooth sigma, cx, cy, 1/fx, 1/fy; or raise."""
    rounds = rc.splat_fill_rounds
    if not 0 <= rounds <= MAX_FILL_ROUNDS:
        raise ValueError(f"splat: fill rounds {rounds} outside the "
                         f"kernel's 0..{MAX_FILL_ROUNDS}")
    return (rounds, rc.splat_smooth_sigma * fusion.voxel_size, cam.cx,
            cam.cy, recip(cam.fx), recip(cam.fy))


def _finalize_tables(cam: CameraConfig, rc: RaycastConfig,
                     fusion: FusionConfig) -> tuple:
    """K9's arguments after the pointers and the image size: (fill rounds,
    a host table of floats: smooth sigma, cx, cy, 1/fx, 1/fy), built once a
    configuration and kept by the objects' identity (which costs less than
    hashing them); or raise."""
    key = (id(cam), id(rc), id(fusion))
    got = _FINALIZE_TABLES.get(key)
    if (got is not None and got[0] is cam and got[1] is rc
            and got[2] is fusion):
        return got[3]
    rounds, *floats = _finalize_plan(cam, rc, fusion)
    tables = (rounds, (ctypes.c_float * len(floats))(*floats))
    if len(_FINALIZE_TABLES) >= 64:
        _FINALIZE_TABLES.clear()
    _FINALIZE_TABLES[key] = (cam, rc, fusion, tables)
    return tables


def _launch_finalize(depth: torch.Tensor, cam: CameraConfig,
                     rc: RaycastConfig,
                     fusion: FusionConfig) -> RaycastOutput:
    """K9 on the current stream: the RaycastOutput of a float32 (H, W) raw
    depth on a CUDA device, or raise."""
    H, W = cam.height, cam.width
    if (depth.device.type != "cuda" or depth.dtype != torch.float32
            or tuple(depth.shape) != (H, W)):
        raise ValueError(
            f"splat: a float32 {(H, W)} depth buffer on a CUDA device (or "
            f"any on the CPU) expected, got {depth.dtype} "
            f"{tuple(depth.shape)} on {depth.device}")
    rounds, floats = _finalize_tables(cam, rc, fusion)
    raw = depth.contiguous()
    n = H * W
    buf = torch.empty(7 * n, dtype=torch.float32, device=raw.device)
    hit = torch.empty((H, W), dtype=torch.bool, device=raw.device)
    kernels.launch("splat_finalize", raw.get_device(), raw.data_ptr(),
                   buf.data_ptr(), hit.data_ptr(), H, W, rounds, floats)
    global LAUNCHES_FINALIZE
    LAUNCHES_FINALIZE += 1
    maps = ((H, W, 3), (3 * W, 3, 1))
    return RaycastOutput(depth=buf.as_strided((H, W), (W, 1), 0),
                         points=buf.as_strided(*maps, n),
                         normals=buf.as_strided(*maps, 4 * n), hit=hit)
