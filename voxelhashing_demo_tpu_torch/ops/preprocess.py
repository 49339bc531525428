"""Depth-frame preprocessing (port of ops/preprocess.py): range gate,
flying-pixel rejection, bilateral filter, back-projection, normals, and
the ICP pyramid's level inputs.

Every stencil wraps at the image border with ``torch.roll``, as the JAX
version's ``jnp.roll`` does, and the pooling windows pad with +-inf like
its ``reduce_window``.  Invalid vertices have z == 0; invalid normals are
the zero vector.

Two hand-written kernels (``csrc/preprocess.cu``) serve CUDA tensors:
``preprocess`` is one launch of K3a ``preprocess_frame`` (every stage in
shared memory), ``pyramid_inputs`` one launch of K3b ``pyramid_levels``
for every pyramid level's source Frame and packed ICP target,
``preprocess_metric`` one K3b job and ``pack_model`` one K3b pack job
(a model Frame packed as the ICP target).  CPU tensors run the plain versions
(``preprocess_reference``, ``preprocess_metric_reference``,
``_pyramid_reference``), which the tests and the card checks also call on
the card.  A launch that the kernel does not take raises; nothing falls
back.  ``LAUNCHES_FRAME`` and ``LAUNCHES_LEVELS`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import kernels
from ..config import CameraConfig
from ..geometry import camera as cam_geom
from ..geometry.f32 import recip

LAUNCHES_FRAME = 0      # K3a preprocess_frame
LAUNCHES_LEVELS = 0     # K3b pyramid_levels

MAX_RADIUS = 7          # the bilateral radius K3a takes (kMaxRadius)
MAX_DEPTH = 1e29        # the depths K3a's bilateral takes (kMaxDepth)
MAX_JOBS = 8            # level inputs a K3b launch (kMaxJobs)
EDGE_BAND = 0.05        # downsample_depth_mean's default edge band

# K3a's host tables: (id(camera), id(frontend)) -> (camera, frontend,
# (ints, floats))
_FRAME_PLANS: dict = {}
# K3b's plans: (id(camera), id(icp config), src_full given, tgt_full
# given, mean sources) -> (camera, config, jobs, levels)
_LEVEL_PLANS: dict = {}
# K3b's layouts: (id(jobs), the shapes of the source and target depths and
# of the target Frame's depth and normals) -> (jobs, _Layout)
_LAYOUTS: dict = {}


class Frame(NamedTuple):
    """Preprocessed depth frame: camera-space geometry maps, all (H, W, ...)."""

    vertices: torch.Tensor   # (H, W, 3) camera-space positions; z==0 invalid
    normals: torch.Tensor    # (H, W, 3) unit normals; zero vector invalid
    depth: torch.Tensor      # (H, W) metric depth; 0 invalid


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as sqrt(sum(x * x))."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def depth_to_meters(depth_raw: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Integer depth image -> metric depth, gated to [depth_min, depth_max]."""
    d = depth_raw.to(torch.float32) * recip(cam.depth_scale)
    valid = (d >= cam.depth_min) & (d <= cam.depth_max)
    return torch.where(valid, d, 0.0)


def compute_vertices(depth_m: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Back-project metric depth to camera-space vertices."""
    rays = cam_geom.pixel_rays(cam, dtype=depth_m.dtype, device=depth_m.device)
    return rays * depth_m[..., None]


def compute_normals(vertices: torch.Tensor) -> torch.Tensor:
    """Central-difference cross-product normals, zero at the border and
    wherever a participating vertex is invalid."""
    up = torch.roll(vertices, 1, dims=0)      # v[y-1, x]
    down = torch.roll(vertices, -1, dims=0)   # v[y+1, x]
    left = torch.roll(vertices, 1, dims=1)    # v[y, x-1]
    right = torch.roll(vertices, -1, dims=1)  # v[y, x+1]

    n = torch.linalg.cross(down - up, right - left, dim=-1)
    length = _norm(n, keepdim=True)
    n = torch.where(length > 1e-12, n / torch.clamp(length, min=1e-12), 0.0)

    H, W = vertices.shape[:2]
    vy = torch.arange(H, device=vertices.device)[:, None]
    vx = torch.arange(W, device=vertices.device)[None, :]
    interior = (vy > 0) & (vy < H - 1) & (vx > 0) & (vx < W - 1)
    valid = (
        interior
        & (vertices[..., 2] != 0)
        & (up[..., 2] != 0)
        & (down[..., 2] != 0)
        & (left[..., 2] != 0)
        & (right[..., 2] != 0)
    )
    return torch.where(valid[..., None], n, 0.0)


def reject_outliers(
    depth_m: torch.Tensor,
    band_base: float = 0.03,
    band_quad: float = 0.007,
    min_support: int = 3,
) -> torch.Tensor:
    """Flying-pixel rejection: keep a sample only if >= ``min_support`` of
    its 8 neighbours agree within band_base + band_quad * z^2."""
    valid = depth_m > 0
    band = band_base + band_quad * depth_m * depth_m
    support = torch.zeros(depth_m.shape, dtype=torch.int32,
                          device=depth_m.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = torch.roll(depth_m, (dy, dx), dims=(0, 1))
            agree = (n > 0) & (torch.abs(n - depth_m) < band)
            support = support + agree.to(torch.int32)
    return torch.where(valid & (support >= min_support), depth_m, 0.0)


def bilateral_filter(
    depth_m: torch.Tensor,
    radius: int = 2,
    sigma_space: float = 1.5,
    sigma_depth: float = 0.03,
) -> torch.Tensor:
    """Edge-preserving bilateral filter on metric depth; invalid (0)
    pixels neither contribute nor get filled."""
    acc = torch.zeros_like(depth_m)
    wacc = torch.zeros_like(depth_m)
    inv_2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv_2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            n = torch.roll(depth_m, (dy, dx), dims=(0, 1))
            dz = n - depth_m
            w = _spatial_weight(dy, dx, inv_2ss) * torch.exp(
                -dz * dz * inv_2sd)
            w = torch.where(n > 0, w, 0.0)
            acc = acc + w * n
            wacc = wacc + w
    out = acc / torch.clamp(wacc, min=1e-12)
    return torch.where((depth_m > 0) & (wacc > 0), out, depth_m)


def preprocess(
    depth_raw: torch.Tensor, cam: CameraConfig, frontend=None
) -> Frame:
    """Full frontend: raw integer depth -> Frame.  One K3a launch on a
    CUDA tensor (int32 (H, W)), ``preprocess_reference`` on a CPU
    tensor."""
    if depth_raw.device.type == "cpu":
        return preprocess_reference(depth_raw, cam, frontend)
    return _launch_frame(depth_raw, cam, frontend)


def preprocess_reference(
    depth_raw: torch.Tensor, cam: CameraConfig, frontend=None
) -> Frame:
    """Plain version of ``preprocess``, on any device."""
    depth_m = depth_to_meters(depth_raw, cam)
    if frontend is not None and frontend.outlier_reject:
        depth_m = reject_outliers(
            depth_m, frontend.outlier_band_base,
            frontend.outlier_band_quad, frontend.outlier_min_support,
        )
    if frontend is not None and frontend.bilateral:
        depth_m = bilateral_filter(
            depth_m, frontend.bilateral_radius,
            frontend.bilateral_sigma_space, frontend.bilateral_sigma_depth,
        )
    vertices = compute_vertices(depth_m, cam)
    normals = compute_normals(vertices)
    return Frame(vertices=vertices, normals=normals, depth=depth_m)


def preprocess_metric(depth_m: torch.Tensor, cam: CameraConfig,
                      pool_factor: int = 1) -> Frame:
    """Frontend for already-metric depth (e.g. raycast model maps); with
    ``pool_factor`` > 1 the depth is min-pooled first
    (``downsample_depth``) and ``cam`` is the pooled image's camera.  One
    K3b job on a CUDA tensor, ``preprocess_metric_reference`` on a CPU
    tensor."""
    jobs = _metric_jobs(cam, pool_factor)
    if depth_m.device.type == "cpu":
        return _job_reference(jobs[0], {"src": depth_m}, None)
    return _launch_levels(jobs, {"src": depth_m}, None)[0]


@functools.lru_cache(maxsize=64)
def _metric_jobs(cam: CameraConfig, pool_factor: int) -> tuple:
    """``preprocess_metric``'s one K3b job, the same tuple for equal
    arguments (K3b's layouts are kept by the tuple's identity)."""
    pool = _MIN if pool_factor > 1 else _NONE
    return (_Job(_SOURCE, "src", pool, max(pool_factor, 1), cam),)


def pack_model(tgt: Frame, cam: CameraConfig) -> torch.Tensor:
    """A model Frame (its own normals, e.g. a raycast's) packed as the ICP
    target, (H, W, 2) in ``icp.pack_target``'s layout: one K3b pack job on
    CUDA tensors, ``pack_target`` on CPU tensors."""
    if tgt.depth.device.type == "cpu":
        from .icp import pack_target    # ops/icp.py imports this module

        return pack_target(tgt)
    return _launch_levels(_pack_jobs(cam), {}, tgt)[0]


@functools.lru_cache(maxsize=64)
def _pack_jobs(cam: CameraConfig) -> tuple:
    """``pack_model``'s one K3b job, the same tuple for equal arguments."""
    return (_Job(_PACK, "tgt", _NONE, 1, cam),)


def preprocess_metric_reference(depth_m: torch.Tensor,
                                cam: CameraConfig) -> Frame:
    """Plain version of ``preprocess_metric`` (no pooling), on any
    device."""
    valid = (depth_m >= cam.depth_min) & (depth_m <= cam.depth_max)
    depth_m = torch.where(valid, depth_m, 0.0)
    vertices = compute_vertices(depth_m, cam)
    normals = compute_normals(vertices)
    return Frame(vertices=vertices, normals=normals, depth=depth_m)


def _windows(x: torch.Tensor, factor: int):
    """The factor x factor VALID windows of x as factor^2 strided views, in
    row-major window order (the order reduce_window visits them)."""
    h, w = x.shape[0] // factor, x.shape[1] // factor
    x = x[: h * factor, : w * factor]
    return [x[i::factor, j::factor] for i in range(factor)
            for j in range(factor)]


def downsample_depth(depth_m: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth pyramid level: valid-aware min-pooling by ``factor``."""
    if factor <= 1:
        return depth_m
    big = torch.where(depth_m > 0, depth_m, math.inf)
    m = torch.stack(_windows(big, factor)).amin(dim=0)
    return torch.where(torch.isfinite(m), m, 0.0)


def downsample_depth_mean(
    depth_m: torch.Tensor, factor: int, edge_band: float = 0.05
) -> torch.Tensor:
    """Valid-aware average pooling; windows spanning a depth edge
    (max - min > ``edge_band``) or holding no valid pixel become invalid.
    The window sum is taken in reduce_window's row-major order."""
    if factor <= 1:
        return depth_m
    valid = depth_m > 0
    vals = _windows(torch.where(valid, depth_m, 0.0), factor)
    s = torch.zeros_like(vals[0])
    for x in vals:
        s = s + x
    c = torch.stack(_windows(valid.to(torch.float32), factor)).sum(dim=0)
    mn = torch.stack(
        _windows(torch.where(valid, depth_m, math.inf), factor)).amin(dim=0)
    mx = torch.stack(
        _windows(torch.where(valid, depth_m, -math.inf), factor)).amax(dim=0)
    ok = (c > 0) & ((mx - mn) <= edge_band)
    return torch.where(ok, s / torch.clamp(c, min=1.0), 0.0)


# --------------------------------------------------------------------------
# the ICP pyramid's level inputs
# --------------------------------------------------------------------------

_SOURCE, _TARGET, _PACK = 0, 1, 2     # job kinds (csrc/preprocess.cu)
_NONE, _MIN, _MEAN = 0, 1, 2          # pool modes


class _Job(NamedTuple):
    """One level input: a source Frame (``_SOURCE``) or a packed target
    (``_TARGET``) of the pooled ``image`` ("src" or "tgt"), or the packed
    target of the given target Frame (``_PACK``); ``cam`` is the level
    image's camera."""

    kind: int
    image: str
    pool: int
    factor: int
    cam: CameraConfig


def _level_pools(cfg) -> list:
    """The pyramid's (factor, source pool) a level, coarsest first, as
    ``icp_align_pyramid`` reads an ICPConfig."""
    levels = sorted(set(cfg.pyramid), reverse=True)
    pools = cfg.source_pools
    if len(pools) != len(levels):
        pools = (1,) * len(levels)
    return list(zip(levels, pools))


@functools.lru_cache(maxsize=64)
def _plan(cam: CameraConfig, cfg, has_src_full: bool, has_tgt_full: bool,
          mean_sources: bool):
    """(jobs, [(source job, or None for ``src_full``, target job)] a
    level, coarsest first); a job two levels share is made once."""
    jobs, levels = [], []

    def job(*spec):
        spec = _Job(*spec)
        if spec not in jobs:
            jobs.append(spec)
        return jobs.index(spec)

    for factor, pool in _level_pools(cfg):
        sfactor = factor * pool
        if sfactor > 1:
            mode = _MEAN if pool > 1 and mean_sources else _MIN
            src = job(_SOURCE, "src", mode, sfactor, cam.scaled(sfactor))
        elif has_src_full:
            src = None
        else:
            src = job(_SOURCE, "src", _NONE, 1, cam)
        if factor > 1:
            tgt = job(_TARGET, "tgt", _MIN, factor, cam.scaled(factor))
        else:
            tgt = job(_PACK if has_tgt_full else _TARGET, "tgt", _NONE, 1,
                      cam)
        levels.append((src, tgt))
    return tuple(jobs), tuple(levels)


def pyramid_inputs(depth_src_m: torch.Tensor, depth_tgt_m: torch.Tensor,
                   cam: CameraConfig, cfg, src_full: Frame | None = None,
                   tgt_full: Frame | None = None, mean_sources: bool = True):
    """Every ICP pyramid level's inputs of one frame, coarsest level first:
    (sources, packed targets), a source Frame and a packed (h, w, 2)
    target (``icp.pack_target``'s layout) a level, as
    ``icp_align_pyramid`` builds them.  A level's target is
    ``preprocess_metric(downsample_depth(depth_tgt_m, factor))``, or at
    factor 1 ``tgt_full`` (its own normals) when given; its source is
    pooled by factor x source pool (``downsample_depth_mean`` where the
    source pool is > 1, min-pooled with ``mean_sources=False`` as the
    sharded step does), or at factor 1 ``src_full`` when given.  One K3b
    launch on CUDA tensors, ``_pyramid_reference`` on CPU tensors."""
    if depth_src_m.device.type == "cpu" and depth_tgt_m.device.type == "cpu":
        return _pyramid_reference(depth_src_m, depth_tgt_m, cam, cfg,
                                  src_full, tgt_full, mean_sources)
    key = (id(cam), id(cfg), src_full is not None, tgt_full is not None,
           mean_sources)
    got = _LEVEL_PLANS.get(key)
    if got is None or got[0] is not cam or got[1] is not cfg:
        got = (cam, cfg, *_plan(cam, cfg, *key[2:]))
        if len(_LEVEL_PLANS) >= 64:
            _LEVEL_PLANS.clear()
        _LEVEL_PLANS[key] = got
    out = _launch_levels(got[2], {"src": depth_src_m, "tgt": depth_tgt_m},
                         tgt_full)
    return _assemble(got[3], out, src_full)


def _pyramid_reference(depth_src_m, depth_tgt_m, cam: CameraConfig, cfg,
                       src_full=None, tgt_full=None,
                       mean_sources: bool = True):
    """Plain version of ``pyramid_inputs``, on any device."""
    jobs, levels = _plan(cam, cfg, src_full is not None,
                         tgt_full is not None, mean_sources)
    images = {"src": depth_src_m, "tgt": depth_tgt_m}
    out = [_job_reference(job, images, tgt_full) for job in jobs]
    return _assemble(levels, out, src_full)


def _assemble(levels, out: list, src_full):
    return ([src_full if s is None else out[s] for s, _ in levels],
            [out[t] for _, t in levels])


def _job_reference(job: _Job, images: dict, tgt_full):
    """One level input by the plain functions."""
    from .icp import pack_target    # ops/icp.py imports this module

    if job.kind == _PACK:
        return pack_target(tgt_full)
    d = images[job.image]
    if job.pool == _MIN:
        d = downsample_depth(d, job.factor)
    elif job.pool == _MEAN:
        d = downsample_depth_mean(d, job.factor, EDGE_BAND)
    frame = preprocess_metric_reference(d, job.cam)
    return frame if job.kind == _SOURCE else pack_target(frame)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _spatial_weight(dy: int, dx: int, inv_2ss: float) -> float:
    """The bilateral's spatial weight of tap (dy, dx), a float32 constant
    as in the JAX graph."""
    return float(torch.exp(torch.tensor(-(dy * dy + dx * dx) * inv_2ss,
                                        dtype=torch.float32)))


def _spatial_weights(radius: int, sigma_space: float) -> list:
    """K3a's (2r + 1)^2 spatial weights in (dy, dx) order."""
    inv_2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    return [_spatial_weight(dy, dx, inv_2ss)
            for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]


def _unmasked_taps(outlier: bool, floats) -> bool:
    """Whether K3a's bilateral can take its taps unmasked on these float32
    tables (csrc/preprocess.cu): every pixel it reads that is not > 0 is
    exactly 0 in the plain version (the outlier stage makes it so, or a
    range gate that passes no negative depth and no -0), 1 / (2
    sigma_depth^2) > 0, and no depth reaches MAX_DEPTH."""
    rscale, dmin, dmax, inv2sd = floats[0], floats[1], floats[2], floats[9]
    cap = 2.0 ** 31 * abs(rscale)
    vmax = cap if math.isnan(dmax) else min(dmax, cap)    # as fminf
    return ((outlier or (dmin >= 0 and rscale > 0)) and inv2sd > 0
            and vmax < MAX_DEPTH)


def _frame_plan(cam: CameraConfig, frontend) -> tuple:
    """K3a's host tables (ctypes arrays of ints and floats) for the camera
    and the frontend's stages, built once a configuration (kept by the
    objects' identity, which costs less than hashing them), or raise."""
    got = _FRAME_PLANS.get((id(cam), id(frontend)))
    if got is not None and got[0] is cam and got[1] is frontend:
        return got[2]
    f = frontend
    outlier = f is not None and f.outlier_reject
    bilateral = f is not None and f.bilateral
    radius = f.bilateral_radius if bilateral else 0
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"preprocess: bilateral radius {radius} outside "
                         f"the kernel's 0..{MAX_RADIUS}")
    ints = [int(outlier), f.outlier_min_support if outlier else 0,
            int(bilateral), radius]
    floats = [recip(cam.depth_scale), cam.depth_min, cam.depth_max, cam.cx,
              cam.cy, recip(cam.fx), recip(cam.fy),
              f.outlier_band_base if outlier else 0.0,
              f.outlier_band_quad if outlier else 0.0,
              1.0 / (2.0 * f.bilateral_sigma_depth * f.bilateral_sigma_depth)
              if bilateral else 0.0]
    if bilateral:
        floats += _spatial_weights(radius, f.bilateral_sigma_space)
    plan = ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))
    if bilateral and not _unmasked_taps(outlier, plan[1]):
        raise ValueError(
            "preprocess: on the card the bilateral filter takes the outlier "
            "stage or depth_min >= 0 and depth_scale > 0, a sigma_depth "
            "whose 1 / (2 sigma^2) is a positive float32, and depths below "
            f"{MAX_DEPTH:g}")
    if len(_FRAME_PLANS) >= 64:
        _FRAME_PLANS.clear()
    _FRAME_PLANS[(id(cam), id(frontend))] = (cam, frontend, plan)
    return plan


def _launch_frame(depth_raw: torch.Tensor, cam: CameraConfig,
                  frontend) -> Frame:
    """K3a on the current stream: the Frame of an int32 (H, W) depth
    image on a CUDA device, or raise."""
    if (depth_raw.device.type != "cuda" or depth_raw.dtype != torch.int32
            or depth_raw.dim() != 2 or depth_raw.numel() == 0):
        raise ValueError(
            f"preprocess: an int32 (H, W) depth image on a CUDA device (or "
            f"any on the CPU) expected, got {depth_raw.dtype} "
            f"{tuple(depth_raw.shape)} on {depth_raw.device}")
    ints, floats = _frame_plan(cam, frontend)
    raw = depth_raw.contiguous()
    H, W = raw.shape
    n = H * W
    buf = torch.empty(7 * n, dtype=torch.float32, device=raw.device)
    kernels.launch("preprocess_frame", raw.get_device(), raw.data_ptr(),
                   buf.data_ptr(), H, W, ints, floats)
    global LAUNCHES_FRAME
    LAUNCHES_FRAME += 1
    return Frame(vertices=buf.as_strided((H, W, 3), (3 * W, 3, 1), n),
                 normals=buf.as_strided((H, W, 3), (3 * W, 3, 1), 4 * n),
                 depth=buf.as_strided((H, W), (W, 1), 0))


class _Layout(NamedTuple):
    """K3b's outputs and host tables for a plan's jobs on given input
    shapes: the floats of the one output buffer, each job's output views
    as (size, stride, offset), the inputs the jobs read (indices into
    (source depth, target depth, target Frame depth, its normals)), and
    the host tables of ints (8 a job) and floats (6 a job)."""

    total: int
    views: tuple
    reads: tuple
    ints: object
    floats: object


_IMAGE_INDEX = {"src": 0, "tgt": 1}    # csrc/preprocess.cu's image field


def _layout(jobs, shapes) -> _Layout:
    """K3b's ``_Layout`` for ``jobs`` on inputs of ``shapes`` (of the
    source depth, the target depth, the target Frame's depth and its
    normals; None where absent), or raise.  Every job's outputs start at a
    multiple of 4 floats (16 bytes, as K3b's 16-byte stores need), the
    packed targets first."""
    reads, sizes = set(), []
    for job in jobs:
        k = 2 if job.kind == _PACK else _IMAGE_INDEX[job.image]
        reads.update((2, 3) if job.kind == _PACK else (k,))
        shape = shapes[k]
        if shape is None or (job.kind == _PACK and shapes[3] is None):
            raise ValueError("pyramid inputs: a level input reads an image "
                             "(or a target Frame) that was not given")
        if len(shape) != 2 or (job.kind == _PACK
                               and tuple(shapes[3]) != (*shape, 3)):
            raise ValueError("pyramid inputs: (H, W) depth images (and (H, "
                             "W, 3) normals) expected")
        H, W = shape
        h, w = H // job.factor, W // job.factor
        if h < 1 or w < 1:
            raise ValueError(f"pyramid inputs: a depth image of at least "
                             f"the factor {job.factor} a side expected, got "
                             f"{(H, W)}")
        sizes.append((k, W, h, w))
    per = [h * w * (7 if job.kind == _SOURCE else 2)
           for job, (_, _, h, w) in zip(jobs, sizes)]
    starts, at = {}, 0
    for k in sorted(range(len(jobs)), key=lambda k: jobs[k].kind == _SOURCE):
        starts[k], at = at, -(-(at + per[k]) // 4) * 4
    views, ints, floats = [], [], []
    for k, (job, (image, W, h, w)) in enumerate(zip(jobs, sizes)):
        o = starts[k]
        maps = ((h, w, 3), (3 * w, 3, 1))
        views.append(((h, w, 2), (2 * w, 2, 1), o) if job.kind != _SOURCE
                     else ((*maps, o + h * w), (*maps, o + 4 * h * w),
                           ((h, w), (w, 1), o)))  # vertices, normals, depth
        c = job.cam
        ints += [job.kind, job.pool, job.factor, W, h, w, image, o]
        floats += [c.cx, c.cy, recip(c.fx), recip(c.fy), c.depth_min,
                   c.depth_max]
    return _Layout(at, tuple(views), tuple(sorted(reads)),
                   (ctypes.c_int * len(ints))(*ints),
                   (ctypes.c_float * len(floats))(*floats))


def _launch_levels(jobs: tuple, images: dict, tgt_full) -> list:
    """K3b over ``jobs`` (a plan's tuple: its layout is kept by the
    tuple's identity and the inputs' shapes) in one launch on the current
    stream: a fresh Frame a source job, a fresh packed (h, w, 2) target a
    target or pack job, all views of one fresh buffer.  Raises on what the
    kernel does not take."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"pyramid inputs: 1 to {MAX_JOBS} level inputs a "
                         f"launch, got {len(jobs)}")
    inputs = (images.get("src"), images.get("tgt"),
              *((None, None) if tgt_full is None
                else (tgt_full.depth, tgt_full.normals)))
    key = (id(jobs), *(None if t is None else t.shape for t in inputs))
    got = _LAYOUTS.get(key)
    if got is None or got[0] is not jobs:
        got = (jobs, _layout(jobs, key[1:]))
        if len(_LAYOUTS) >= 64:
            _LAYOUTS.clear()
        _LAYOUTS[key] = got
    lay = got[1]
    read = [inputs[k] for k in lay.reads]
    dev = read[0].device
    if dev.type != "cuda" or any(t.device != dev for t in read):
        raise ValueError("pyramid inputs: the depth images (and the target "
                         "Frame) must lie on one CUDA device (or all on the "
                         "CPU)")
    if any(t.dtype != torch.float32 for t in read):
        raise ValueError("pyramid inputs: float32 depth (and normals) "
                         "expected")
    # the inputs as the kernel reads them, alive until the launch
    read = [t.contiguous() for t in read]
    ptrs = [None] * 4
    for k, t in zip(lay.reads, read):
        ptrs[k] = t.data_ptr()
    buf = torch.empty(lay.total, dtype=torch.float32, device=dev)
    outs = [buf.as_strided(*v) if job.kind != _SOURCE
            else Frame(*(buf.as_strided(*x) for x in v))
            for job, v in zip(jobs, lay.views)]
    kernels.launch("pyramid_levels", dev.index, *ptrs, buf.data_ptr(),
                   lay.ints, lay.floats, len(jobs), EDGE_BAND)
    global LAUNCHES_LEVELS
    LAUNCHES_LEVELS += 1
    return outs
