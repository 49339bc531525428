"""Point-to-plane ICP tracking by damped Gauss-Newton (port of ops/icp.py).

On CUDA tensors a pyramid level's whole Gauss-Newton loop runs on the
device in one cooperative launch of the hand-written kernel K4
``icp_gn_level`` (``csrc/icp.cu``), for C candidates side by side:
``icp_align`` is one launch (C = 1) that makes no host read, the raced
coarsest level (``icp_align_raced``, inside ``icp_align_pyramid`` and
``hash_slam.step``) one launch with C = 2 that scores both results and
keeps the better (``pick_by_score``'s rule), and ``icp_align_batch`` one
launch over its candidates (``_align_candidates`` serves all three).  A
candidate stops when the JAX loop would (after ``max_iters``, or once
|delta|^2 <= update_tol^2) and is then frozen; the kernel returns once all
are done.  ``normal_system`` and ``alignment_score_sums`` run one pass of
the same association in K4s ``icp_sums``.  A refused launch raises;
nothing falls back.  ``icp_align_pyramid`` takes every level's source and
packed target from one ``preprocess.pyramid_inputs`` call (K3b on CUDA
tensors) and hands the packed targets on (``tgt_packed`` / ``packed``),
so no target is packed twice.

On CPU tensors each function runs its plain version: ``icp_align_reference``
(a host-checked Python loop, one device-to-host read of the update norm
per iteration), ``build_normal_system(*associate(...))``,
``_score_sums_reference``, ``pick_by_score``.  ``_partials_reference``,
``_sums_reference``, ``_solve_warp_reference``, ``_solve_update_reference``
and ``_level_reference`` compute what the kernels compute, in their order,
for the tests and the card checks.  ``LAUNCHES_LEVEL`` and
``LAUNCHES_SUMS`` count the kernels' launches.

The plain 6x6 normal equations are formed and solved in float32.  Their
JTJ/JTr products run with ``torch.backends.cuda.matmul.allow_tf32 = False``
(set around the product by ``_f32_matmul``): TF32 keeps ~3 decimal digits,
which would bend the solve.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import CameraConfig, ICPConfig
from ..geometry import camera as cam_geom
from ..geometry import se3
from ..geometry.f32 import recip
from .preprocess import Frame, _norm, pyramid_inputs


LAUNCHES_LEVEL = 0      # K4 icp_gn_level
LAUNCHES_SUMS = 0       # K4s icp_sums

CTA_THREADS = 256       # csrc/icp.cu kThreads
MAX_CTAS = 128          # CTAs a candidate (kMaxCtas)
MAX_GRID = 256          # CTAs of all candidates, the grid rule's ceiling
MAX_CANDIDATES = 32     # candidates a launch (kMaxCands)
N_SUMS = 29             # 21 upper-triangle JTJ, 6 JTr, error, count
N_SCORE_SUMS = 2        # num, den
# a result row of K4: T (16), dnorm, error, count, score, JTJ (36)
ROW = 56
_ROW_DNORM, _ROW_ERR, _ROW_COUNT, _ROW_SCORE, _ROW_JTJ = 16, 17, 18, 19, 20


class NormalSystem(NamedTuple):
    """Packed 6x6 Gauss-Newton normal equations and diagnostics."""

    JTJ: torch.Tensor     # (6, 6)
    JTr: torch.Tensor     # (6,)
    error: torch.Tensor   # sum of squared residuals over inliers
    count: torch.Tensor   # number of inlier correspondences (float)


class ICPResult(NamedTuple):
    transform: torch.Tensor   # (4, 4) src -> tgt camera transform
    error: torch.Tensor       # mean squared point-to-plane residual
    count: torch.Tensor       # inliers at the final iteration
    iters: torch.Tensor       # iterations executed (int32)
    JTJ: torch.Tensor         # final-iteration normal matrix (6, 6)


def _sign_nz(x: torch.Tensor) -> torch.Tensor:
    """sign() that maps 0 -> +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its round-to-nearest-even bf16 bit pattern, int32 in
    [0, 0xFFFF] (uint16 arithmetic is thin in torch, so int32 masks)."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def _bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 holding a bf16 bit pattern in its low 16 bits -> float32."""
    return (bits & 0xFFFF).to(torch.int16).view(torch.bfloat16).to(
        torch.float32)


def oct_encode_bits(normals: torch.Tensor) -> torch.Tensor:
    """Unit normals (..., 3) -> one float32 of bits: two bf16 octahedral
    coordinates (x in the low half, y in the high half)."""
    n = normals
    an = torch.sum(torch.abs(n), dim=-1, keepdim=True)
    p = n[..., :2] / torch.clamp(an, min=1e-12)
    fold = (1.0 - torch.abs(p.flip(-1))) * _sign_nz(p)
    oct2 = torch.where(n[..., 2:] < 0, fold, p)
    u = _bf16_bits(oct2)
    bits = u[..., 0] | (u[..., 1] << 16)
    return bits.view(torch.float32)


def oct_decode_bits(bits_f32: torch.Tensor) -> torch.Tensor:
    """Inverse of oct_encode_bits: (...,) float32 bits -> (..., 3) unit
    normals.  All-zero bits decode to (0, 0, 1)."""
    bits = bits_f32.view(torch.int32)
    x = _bf16_from_bits(bits)
    y = _bf16_from_bits(bits >> 16)
    z = 1.0 - torch.abs(x) - torch.abs(y)
    xy = torch.stack([x, y], dim=-1)
    fold = (1.0 - torch.abs(xy.flip(-1))) * _sign_nz(xy)
    xy = torch.where(z[..., None] < 0, fold, xy)
    n = torch.cat([xy, z[..., None]], dim=-1)
    ln = _norm(n, keepdim=True)
    return n / torch.clamp(ln, min=1e-12)


def pack_target(tgt: Frame) -> torch.Tensor:
    """Association target as (H, W, 2) float32: [depth, oct-normal bits];
    pixels without a valid normal store depth 0."""
    usable = (tgt.depth > 0) & (
        torch.sum(tgt.normals * tgt.normals, dim=-1) > 0.5
    )
    d = torch.where(usable, tgt.depth, 0.0)
    return torch.stack([d, oct_encode_bits(tgt.normals)], dim=-1)


def _gather_target(tgt_packed: torch.Tensor, p: torch.Tensor,
                   cam: CameraConfig):
    """Project ``p`` and read the packed target there: returns
    (in_image, d_t, n_t, p_t)."""
    ij, in_image = cam_geom.project_nearest(p, cam)
    u = torch.clamp(ij[..., 0], 0, cam.width - 1)
    v = torch.clamp(ij[..., 1], 0, cam.height - 1)
    g = tgt_packed[v.long(), u.long()]                 # (H, W, 2) gather
    d_t = g[..., 0]
    n_t = oct_decode_bits(g[..., 1])
    # target vertex = ray(u, v) * depth, the formula preprocess used
    p_t = torch.stack(
        [
            (u.to(torch.float32) - cam.cx) * recip(cam.fx) * d_t,
            (v.to(torch.float32) - cam.cy) * recip(cam.fy) * d_t,
            d_t,
        ],
        dim=-1,
    )
    return in_image, d_t, n_t, p_t


def associate(
    T: torch.Tensor,
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    tgt_packed: torch.Tensor | None = None,
    with_points: bool = False,
):
    """Projective data association under estimate T.  Returns
    (p_src_transformed, n_tgt, residual, valid_mask); with ``with_points``
    the matched target vertex map is appended."""
    p = se3.apply(T, src.vertices)
    n_src = se3.apply_rotation(T, src.normals)
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    in_image, d_t, n_t, p_t = _gather_target(tgt_packed, p, cam)
    r = torch.sum((p - p_t) * n_t, dim=-1)
    valid = (
        (src.vertices[..., 2] != 0)
        & in_image
        & (d_t > 0)
        & (torch.sum(n_src * n_t, dim=-1) > cfg.normal_thresh)
        & (torch.abs(r) < cfg.dist_thresh)
    )
    if with_points:
        return p, n_t, r, valid, p_t
    return p, n_t, r, valid


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 on the card (TF32 off for this product)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def build_normal_system(
    p: torch.Tensor,
    n_t: torch.Tensor,
    r: torch.Tensor,
    valid: torch.Tensor,
    huber_delta: float = 0.0,
) -> NormalSystem:
    """JTJ / JTr from the association maps; J row = [n, p x n], IRLS
    Huber-weighted when ``huber_delta`` > 0."""
    w = valid.to(torch.float32)
    if huber_delta > 0:
        w = w * torch.clamp(
            huber_delta / torch.clamp(torch.abs(r), min=1e-12), max=1.0)
    w_sqrt = torch.sqrt(w)
    cross = torch.linalg.cross(p, n_t, dim=-1)
    J = torch.cat([n_t, cross], dim=-1)
    J = (J * w_sqrt[..., None]).reshape(-1, 6)
    rw = (r * w_sqrt).reshape(-1)
    JTJ = _f32_matmul(J.T, J)
    JTr = _f32_matmul(J.T, rw)
    error = torch.sum(rw * rw)
    count = torch.sum(valid.to(torch.float32))
    return NormalSystem(JTJ=JTJ, JTr=JTr, error=error, count=count)


def solve_normal_system(sys: NormalSystem, damping: float) -> torch.Tensor:
    """Damped float32 Cholesky solve of (JTJ + lambda I) delta = -JTr, with
    an extra unit damping when the system holds <= 6 inliers.  A failed
    factorization or a non-finite solve gives no update."""
    eye = torch.eye(6, dtype=sys.JTJ.dtype, device=sys.JTJ.device)
    A = sys.JTJ + damping * eye
    A = A + torch.where(sys.count > 6, 0.0, 1.0) * eye
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(-sys.JTr[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(delta))
    return torch.where(ok, delta, 0.0)


def _tol2(cfg: ICPConfig) -> float:
    """The JAX loop's float32 bound on |delta|^2."""
    return float(np.float32(cfg.update_tol ** 2))


def icp_align_reference(
    src: Frame,
    tgt: Frame | None,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: torch.Tensor | None = None,
    tgt_packed: torch.Tensor | None = None,
) -> ICPResult:
    """Plain version of ``icp_align``, on any device: the JAX loop as a
    host-checked Python loop (one device-to-host read per iteration)."""
    dev = src.depth.device
    T = se3.identity(device=dev) if init_T is None else init_T
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    tol2 = _tol2(cfg)
    it = 0
    dnorm = math.inf
    err = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    JTJ = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    while it < cfg.max_iters and dnorm > tol2:
        p, n_t, r, valid = associate(T, src, tgt, cam, cfg, tgt_packed)
        sys = build_normal_system(p, n_t, r, valid, cfg.huber_delta)
        delta = solve_normal_system(sys, cfg.damping)
        T = se3.exp(delta) @ T
        it += 1
        err = sys.error / torch.clamp(sys.count, min=1.0)
        cnt, JTJ = sys.count, sys.JTJ
        dnorm = float(torch.sum(delta * delta))
    return ICPResult(transform=T, error=err, count=cnt,
                     iters=torch.tensor(it, dtype=torch.int32, device=dev),
                     JTJ=JTJ)


def icp_align(
    src: Frame,
    tgt: Frame | None,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: torch.Tensor | None = None,
    tgt_packed: torch.Tensor | None = None,
) -> ICPResult:
    """Align src onto tgt: returns T such that T @ src ~= tgt.  With
    ``tgt_packed`` (``pack_target(tgt)``, e.g. from
    ``preprocess.pyramid_inputs``) ``tgt`` may be None.  One K4 launch
    (C = 1) on CUDA tensors, ``icp_align_reference`` on CPU tensors."""
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    if _on_cpu(src.vertices, tgt_packed):
        return icp_align_reference(src, tgt, cam, cfg, init_T, tgt_packed)
    rows, iters = _align_candidates([src], None, cam, cfg, [init_T],
                                    packed=[tgt_packed])
    return _row_result(rows[0], iters[0])


def icp_align_raced(
    src: Frame,
    tgt: Frame | None,
    cam: CameraConfig,
    cfg: ICPConfig,
    prior_T: torch.Tensor,
    init_T: torch.Tensor | None = None,
    tgt_packed: torch.Tensor | None = None,
) -> ICPResult:
    """ICP from ``init_T`` (the identity by default) and from ``prior_T``;
    the prior's result only when it scores strictly lower
    (``pick_by_score``).  ``tgt_packed`` as in ``icp_align``.  One K4
    launch (C = 2 and the race epilogue) on CUDA tensors; on CPU tensors
    ``_race_plain``."""
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    if _on_cpu(src.vertices, tgt_packed):
        return _race_plain(src, tgt, cam, cfg, prior_T, init_T, tgt_packed)
    rows, iters = _align_candidates([src, src], None, cam, cfg,
                                    [init_T, prior_T], race=True,
                                    packed=[tgt_packed] * 2)
    return _row_result(rows[2], iters[2])


def _race_plain(src: Frame, tgt: Frame | None, cam: CameraConfig,
                cfg: ICPConfig, prior_T: torch.Tensor,
                init_T: torch.Tensor | None = None,
                tgt_packed: torch.Tensor | None = None) -> ICPResult:
    """Plain version of ``icp_align_raced``: two ``icp_align`` runs, their
    ``alignment_score_sums`` and ``pick_by_score``."""
    packed = pack_target(tgt) if tgt_packed is None else tgt_packed
    result = icp_align(src, tgt, cam, cfg, init_T=init_T, tgt_packed=packed)
    raced = icp_align(src, tgt, cam, cfg, init_T=prior_T, tgt_packed=packed)
    sn, sd = alignment_score_sums(raced.transform, src, tgt, cam, cfg,
                                  packed)
    bn, bd = alignment_score_sums(result.transform, src, tgt, cam, cfg,
                                  packed)
    return pick_by_score(raced, result, sn / torch.clamp(sd, min=1.0),
                         bn / torch.clamp(bd, min=1.0))


def normal_system(T: torch.Tensor, src: Frame, tgt_packed: torch.Tensor,
                  cam: CameraConfig, cfg: ICPConfig) -> NormalSystem:
    """The Gauss-Newton system of ``src`` against the packed target under
    ``T``: K4s in system mode on CUDA tensors,
    ``build_normal_system(*associate(...))`` on CPU tensors."""
    if _on_cpu(T, src.vertices, tgt_packed):
        p, n_t, r, valid = associate(T, src, None, cam, cfg, tgt_packed)
        return build_normal_system(p, n_t, r, valid, cfg.huber_delta)
    out = _launch_sums(T, src, tgt_packed, cam, cfg, score=False)
    return NormalSystem(JTJ=out[:36].view(6, 6), JTr=out[36:42],
                        error=out[42], count=out[43])


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _kernel_inputs(T, src: Frame, tgt_packed, cam: CameraConfig):
    """Check what K4 takes and return contiguous (vertices, normals,
    packed target, T), or raise."""
    dev = src.vertices.device
    tensors = (T, src.vertices, src.normals, tgt_packed)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ICP: T, the source frame and the packed target "
                         "must lie on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("ICP: T, the source frame and the packed target "
                         "must be float32")
    hw = tuple(src.vertices.shape[:-1])
    if (tuple(T.shape) != (4, 4) or len(hw) != 2
            or src.vertices.shape[-1] != 3
            or tuple(src.normals.shape) != (*hw, 3)
            or tuple(tgt_packed.shape) != (cam.height, cam.width, 2)):
        raise ValueError(
            f"ICP: T (4, 4), source (H, W, 3) maps and a packed target "
            f"({cam.height}, {cam.width}, 2) expected, got T "
            f"{tuple(T.shape)}, vertices {tuple(src.vertices.shape)}, "
            f"normals {tuple(src.normals.shape)}, target "
            f"{tuple(tgt_packed.shape)}")
    packed = tgt_packed.contiguous()
    if packed.data_ptr() % 8:
        raise ValueError("ICP: the packed target must be 8-byte aligned")
    return (src.vertices.contiguous(), src.normals.contiguous(), packed,
            T.contiguous())


def _ctas(n_pixels: int, n_cands: int = 1) -> int:
    """CTAs a candidate, the grid rule of csrc/icp.cu: a function of the
    pixel count and the candidates alone."""
    return min(-(-n_pixels // CTA_THREADS), MAX_CTAS,
               max(1, MAX_GRID // n_cands))


def _table(entries) -> ctypes.Array:
    """The kernel's candidate table: (vertices, normals, packed target,
    T) pointers a candidate, as a host array."""
    ptrs = [t.data_ptr() for entry in entries for t in entry]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _packed_targets(tgts, packed):
    """``packed``, or each target Frame of ``tgts`` packed (a Frame that
    recurs packed once)."""
    if packed is not None:
        return list(packed)
    packs = {}
    for tgt in tgts:
        if id(tgt) not in packs:
            packs[id(tgt)] = pack_target(tgt)
    return [packs[id(tgt)] for tgt in tgts]


def _align_candidates(srcs, tgts, cam: CameraConfig, cfg: ICPConfig, inits,
                      race: bool = False, packed=None):
    """K4 over C candidates (lists of Frames and start transforms, None
    for the identity; every source of one shape; the targets as Frames,
    or already packed as ``packed`` with ``tgts`` None) in one launch on
    the current stream: (rows (C + race, ROW), iters (C + race,) int32),
    row c candidate c's T, dnorm, error, count, score and JTJ; row C of a
    race (C = 2) the picked result.  Raises on anything the kernel does
    not take."""
    C = len(srcs)
    n_tgt = len(packed if tgts is None else tgts)
    if (not 1 <= C <= MAX_CANDIDATES or n_tgt != C or len(inits) != C
            or (race and C != 2)):
        raise ValueError(f"ICP candidates: 1 to {MAX_CANDIDATES} sources, "
                         f"as many targets and starts (2 for a race), got "
                         f"{C}, {n_tgt}, {len(inits)}")
    shapes = {tuple(src.vertices.shape) for src in srcs}
    if len(shapes) != 1:
        raise ValueError(f"ICP candidates: every source must have one "
                         f"shape, got {sorted(shapes)}")
    dev = srcs[0].vertices.device
    entries = []
    for src, pk, init in zip(srcs, _packed_targets(tgts, packed), inits):
        T0 = (se3.identity(device=dev) if init is None
              else init.to(torch.float32))
        entries.append(_kernel_inputs(T0, src, pk, cam))
    return _launch_level(entries, cam, cfg, race)


def _launch_level(entries, cam: CameraConfig, cfg: ICPConfig, race: bool):
    """K4 on the current stream over checked (vertices, normals, packed
    target, T) entries, one a candidate: (rows, iters)."""
    C = len(entries)
    verts = entries[0][0]
    n = verts.numel() // 3
    n_cta = _ctas(n, C)
    n_rows = C + int(race)
    n_part, n_score = 2 * C * N_SUMS * n_cta, C * N_SCORE_SUMS * n_cta
    floats = torch.empty(n_part + n_score + n_rows * ROW,
                         dtype=torch.float32, device=verts.device)
    ints = torch.empty(2 * C + n_rows, dtype=torch.int32,
                       device=verts.device)
    rows = floats[n_part + n_score:].view(n_rows, ROW)
    iters = ints[2 * C:]
    kernels.launch(
        "icp_gn_level", verts.get_device(), _table(entries), C, int(race),
        n, cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
        recip(cam.fx), recip(cam.fy), cfg.normal_thresh, cfg.dist_thresh,
        cfg.huber_delta, cfg.damping, _tol2(cfg), cfg.max_iters, n_cta,
        floats.data_ptr(), floats[n_part:].data_ptr(), ints.data_ptr(),
        rows.data_ptr(), iters.data_ptr())
    global LAUNCHES_LEVEL
    LAUNCHES_LEVEL += 1
    return rows, iters


def _launch_sums(T, src: Frame, tgt_packed, cam: CameraConfig,
                 cfg: ICPConfig, score: bool) -> torch.Tensor:
    """K4s on the current stream: (44,) JTJ, JTr, error, count, or with
    ``score`` (2,) num, den."""
    verts, normals, packed, T = _kernel_inputs(T, src, tgt_packed, cam)
    n = verts.numel() // 3
    n_cta = _ctas(n)
    n_sums = N_SCORE_SUMS if score else N_SUMS
    buf = torch.empty(n_sums * n_cta + (N_SCORE_SUMS if score else 44),
                      dtype=torch.float32, device=verts.device)
    out = buf[n_sums * n_cta:]
    kernels.launch(
        "icp_sums", verts.get_device(), _table([(verts, normals, packed, T)]),
        int(score), n, cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
        recip(cam.fx), recip(cam.fy), cfg.normal_thresh, cfg.dist_thresh,
        cfg.huber_delta, n_cta, buf.data_ptr(), out.data_ptr())
    global LAUNCHES_SUMS
    LAUNCHES_SUMS += 1
    return out


def _row_result(rows: torch.Tensor, iters: torch.Tensor) -> ICPResult:
    """The ICPResult of K4 result rows (..., ROW) and their iterations."""
    lead = rows.shape[:-1]
    return ICPResult(transform=rows[..., :16].reshape(*lead, 4, 4),
                     error=rows[..., _ROW_ERR], count=rows[..., _ROW_COUNT],
                     iters=iters,
                     JTJ=rows[..., _ROW_JTJ:].reshape(*lead, 6, 6))


# --------------------------------------------------------------------------
# what the kernels compute, in their order (tests and card checks)
# --------------------------------------------------------------------------

def _rot_row(T, i: int, x, y, z):
    return (T[i, 0] * x + T[i, 1] * y) + T[i, 2] * z


def _terms_reference(T, src: Frame, tgt_packed, cam: CameraConfig,
                     cfg: ICPConfig, score: bool) -> torch.Tensor:
    """K4's per-pixel terms, (pixels, 29) or (pixels, 2), each operation
    rounded once in the kernel's order."""
    x, y, z = src.vertices.reshape(-1, 3).unbind(-1)
    px = _rot_row(T, 0, x, y, z) + T[0, 3]
    py = _rot_row(T, 1, x, y, z) + T[1, 3]
    pz = _rot_row(T, 2, x, y, z) + T[2, 3]
    safe_z = torch.where(pz.abs() > 1e-12, pz, 1e-12)
    u = px / safe_z * cam.fx + cam.cx
    v = py / safe_z * cam.fy + cam.cy
    # round half to even, clamped as the kernel's saturating conversion
    # is (NaN: pixel 0)
    ru, rv = torch.round(u), torch.round(v)
    in_image = ((pz > 0) & (u >= 0) & (u <= cam.width - 1) & (v >= 0)
                & (v <= cam.height - 1) & (ru >= 0) & (ru < cam.width)
                & (rv >= 0) & (rv < cam.height))
    uc = torch.clamp(torch.nan_to_num(ru, nan=0.0), 0, cam.width - 1)
    vc = torch.clamp(torch.nan_to_num(rv, nan=0.0), 0, cam.height - 1)
    g = tgt_packed.reshape(-1, 2)[vc.to(torch.int64) * cam.width
                                  + uc.to(torch.int64)]
    d_t = g[:, 0]
    bits = g[:, 1].contiguous().view(torch.int32)
    ox, oy = _bf16_from_bits(bits), _bf16_from_bits(bits >> 16)
    oz = (1.0 - ox.abs()) - oy.abs()
    fold = oz < 0
    ox, oy = (torch.where(fold, (1.0 - oy.abs()) * _sign_nz(ox), ox),
              torch.where(fold, (1.0 - ox.abs()) * _sign_nz(oy), oy))
    ln = torch.sqrt((ox * ox + oy * oy) + oz * oz)
    lc = torch.where(ln < 1e-12, 1e-12, ln)
    ntx, nty, ntz = ox / lc, oy / lc, oz / lc
    ptx = (uc - cam.cx) * recip(cam.fx) * d_t
    pty = (vc - cam.cy) * recip(cam.fy) * d_t
    r = ((px - ptx) * ntx + (py - pty) * nty) + (pz - d_t) * ntz
    ar = r.abs()
    src_valid = z != 0
    cap = cfg.dist_thresh
    if score:
        matched = in_image & (d_t > 0)
        pen = torch.where(matched, torch.where(ar > cap, cap, ar), cap)
        return torch.stack([torch.where(src_valid, pen, 0.0),
                            src_valid.to(torch.float32)], dim=-1)
    sx, sy, sz = src.normals.reshape(-1, 3).unbind(-1)
    ndot = ((_rot_row(T, 0, sx, sy, sz) * ntx
             + _rot_row(T, 1, sx, sy, sz) * nty)
            + _rot_row(T, 2, sx, sy, sz) * ntz)
    valid = (src_valid & in_image & (d_t > 0) & (ndot > cfg.normal_thresh)
             & (ar < cap))
    w = valid.to(torch.float32)
    if cfg.huber_delta > 0:
        q = torch.div(torch.full_like(ar, cfg.huber_delta),
                      torch.where(ar < 1e-12, 1e-12, ar))
        w = w * torch.where(q > 1.0, 1.0, q)
    ws = torch.sqrt(w)
    J = [ntx * ws, nty * ws, ntz * ws, (py * ntz - pz * nty) * ws,
         (pz * ntx - px * ntz) * ws, (px * nty - py * ntx) * ws]
    rw = r * ws
    cols = [J[a] * J[b] for a in range(6) for b in range(a, 6)]
    cols += [J[a] * rw for a in range(6)]
    cols += [rw * rw, valid.to(torch.float32)]
    return torch.stack(cols, dim=-1)


def _halve(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """The shuffle-down tree over ``width`` lanes along ``dim``: lane l
    adds lane l + off for off = width / 2, ..., 1."""
    off = width // 2
    while off:
        x = x.narrow(dim, 0, off) + x.narrow(dim, off, off)
        off //= 2
    return x.squeeze(dim)


def _partials_reference(T, src: Frame, tgt_packed, cam: CameraConfig,
                        cfg: ICPConfig, score: bool = False,
                        n_cta: int | None = None) -> torch.Tensor:
    """What a K4 CTA writes for one candidate: (29 or 2, CTAs).  Thread g
    of the n_cta x 256 (``_ctas(pixels)`` CTAs by default) sums pixels g,
    g + stride, ... in order from 0; then lane l of each warp adds the
    CTA's threads l, l + 32, ..., l + 224 in order, and the shuffle-down
    tree over the 32 lanes."""
    terms = _terms_reference(T, src, tgt_packed, cam, cfg, score)
    n, n_sums = terms.shape
    n_cta = _ctas(n) if n_cta is None else n_cta
    stride = n_cta * CTA_THREADS
    rounds = -(-n // stride)
    pad = rounds * stride - n
    if pad:
        terms = torch.cat([terms, terms.new_zeros((pad, n_sums))])
    per_round = terms.reshape(rounds, n_cta, CTA_THREADS // 32, 32, n_sums)
    per_thread = terms.new_zeros(per_round.shape[1:])
    for r in range(rounds):
        per_thread = per_thread + per_round[r]
    per_lane = terms.new_zeros((n_cta, 32, n_sums))
    for j in range(CTA_THREADS // 32):
        per_lane = per_lane + per_thread[:, j]
    return _halve(per_lane, 32, 1).T.contiguous()


def _sums_reference(partials: torch.Tensor) -> torch.Tensor:
    """The sums of ``partials`` (sums, CTAs) over the CTAs, as every CTA
    of a candidate forms them after the barrier: lane l of a warp adds
    CTAs l, l + 32, ... in order, then the shuffle-down tree."""
    n_sums, n_cta = partials.shape
    pad = -n_cta % 32
    if pad:
        partials = torch.cat([partials, partials.new_zeros((n_sums, pad))],
                             dim=1)
    cols = partials.reshape(n_sums, -1, 32)
    acc = partials.new_zeros((n_sums, 32))
    for j in range(cols.shape[1]):
        acc = acc + cols[:, j]
    return _halve(acc, 32, 1)


def _damped(s: torch.Tensor, damping: float):
    """A = JTJ + damping I (+ I when count <= 6) from the 29 sums, as a
    6x6 list of scalars."""
    A = [[None] * 6 for _ in range(6)]
    k = 0
    for a in range(6):
        for b in range(a, 6):
            A[a][b] = A[b][a] = s[k]
            k += 1
    extra = torch.where(s[28] > 6, 0.0, 1.0)
    for a in range(6):
        A[a][a] = (A[a][a] + damping) + extra
    return A


def _triangular_solves(L, s: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """L y = -JTr, then L^T delta = y, row by row in ascending order;
    delta, or 0 unless ``ok`` and delta is finite."""
    y = []
    for i in range(6):
        t = -s[21 + i]
        for q in range(i):
            t = t - L[i][q] * y[q]
        y.append(t / L[i][i])
    delta = [None] * 6
    for i in range(5, -1, -1):
        t = y[i]
        for q in range(i + 1, 6):
            t = t - L[q][i] * delta[q]
        delta[i] = t / L[i][i]
    delta = torch.stack(delta)
    ok = ok & torch.all(torch.isfinite(delta))
    return torch.where(ok, delta, 0.0)


def _solve_reference(s: torch.Tensor, damping: float) -> torch.Tensor:
    """The damped 6x6 Cholesky solve of the summed system ``s`` (29,) in
    the left-looking order (column j: its pivot and entries minus
    L[.][q] L[j][q] for q = 0 ... j - 1): delta, or 0 when a pivot is not
    positive or delta is not finite."""
    A = _damped(s, damping)
    L = [[None] * 6 for _ in range(6)]
    ok = torch.ones((), dtype=torch.bool, device=s.device)
    for j in range(6):
        d = A[j][j]
        for q in range(j):
            d = d - L[j][q] * L[j][q]
        ok = ok & (d > 0)
        L[j][j] = torch.sqrt(d)
        for i in range(j + 1, 6):
            t = A[i][j]
            for q in range(j):
                t = t - L[i][q] * L[j][q]
            L[i][j] = t / L[j][j]
    return _triangular_solves(L, s, ok)


def _solve_warp_reference(s: torch.Tensor, damping: float) -> torch.Tensor:
    """K4's warp solve of ``s`` (29,): the right-looking Cholesky, one
    lane an entry of the lower triangle (step q: the pivot's square root,
    column q divided by it, every entry (i, j) with j > q minus
    L[i][q] L[j][q]), then the triangular solves.  Each entry sees
    ``_solve_reference``'s operations in its order: bit for bit equal."""
    A = _damped(s, damping)
    W = [[A[i][j] if i >= j else None for j in range(6)] for i in range(6)]
    ok = torch.ones((), dtype=torch.bool, device=s.device)
    for q in range(6):
        ok = ok & (W[q][q] > 0)
        W[q][q] = torch.sqrt(W[q][q])
        for i in range(q + 1, 6):
            W[i][q] = W[i][q] / W[q][q]
        for j in range(q + 1, 6):
            for i in range(j, 6):
                W[i][j] = W[i][j] - W[i][q] * W[j][q]
    return _triangular_solves(W, s, ok)


def _exp_reference(xi: torch.Tensor) -> torch.Tensor:
    """K4's exp(xi) as a (3, 4): geometry/se3.exp in the kernel's order."""
    w0, w1, w2 = xi[3], xi[4], xi[5]
    theta2 = (w0 * w0 + w1 * w1) + w2 * w2
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-2
    t4 = theta2 * theta2
    A = torch.where(small, (1.0 - theta2 * recip(6.0)) + t4 * recip(120.0),
                    torch.sin(theta) / theta)
    half = 0.5 * theta
    s_half = torch.sin(half) / half
    B = 0.5 * s_half * s_half
    C = torch.where(small,
                    (1.0 / 6.0 - theta2 * recip(120.0)) + t4 * recip(5040.0),
                    (1.0 - A) / theta2)
    zero = torch.zeros_like(w0)
    K = [[zero, -w2, w1], [w2, zero, -w0], [-w1, w0, zero]]
    K2 = [[(K[i][0] * K[0][j] + K[i][1] * K[1][j]) + K[i][2] * K[2][j]
           for j in range(3)] for i in range(3)]
    rows = []
    for i in range(3):
        R = [(float(i == j) + A * K[i][j]) + B * K2[i][j] for j in range(3)]
        V = [(float(i == j) + B * K[i][j]) + C * K2[i][j] for j in range(3)]
        t = (V[0] * xi[0] + V[1] * xi[1]) + V[2] * xi[2]
        rows.append(torch.stack(R + [t]))
    return torch.stack(rows)


def _system_from_sums(s: torch.Tensor) -> NormalSystem:
    """The NormalSystem of K4's 29 sums (JTJ from its upper triangle)."""
    rows, cols = torch.triu_indices(6, 6, device=s.device)
    JTJ = s.new_zeros((6, 6))
    JTJ[rows, cols] = s[:21]
    JTJ[cols, rows] = s[:21]
    return NormalSystem(JTJ=JTJ, JTr=s[21:27], error=s[27], count=s[28])


def _solve_update_reference(partials, T, istate, fstate, damping: float,
                            tol2: float, max_iters: int):
    """One K4 iteration of a candidate after the barrier, as new tensors:
    (T, istate, fstate) after one Gauss-Newton update from ``partials``
    (29, CTAs), istate = (it, done), fstate = (dnorm, err, count, JTJ); or
    the inputs when the done flag is set (a frozen candidate)."""
    if int(istate[1]):
        return T, istate, fstate
    s = _sums_reference(partials)
    delta = _solve_warp_reference(s, damping)
    E = _exp_reference(delta)
    top = torch.stack([torch.stack([
        ((E[i, 0] * T[0, j] + E[i, 1] * T[1, j]) + E[i, 2] * T[2, j])
        + E[i, 3] * T[3, j] for j in range(4)]) for i in range(3)])
    dnorm = s.new_zeros(())
    for q in range(6):
        dnorm = dnorm + delta[q] * delta[q]
    count = s[28]
    err = s[27] / torch.clamp(count, min=1.0)
    it = int(istate[0]) + 1
    done = not (it < max_iters and float(dnorm) > tol2)
    istate_new = torch.tensor([it, int(done)], dtype=torch.int32,
                              device=T.device)
    fstate_new = torch.cat([torch.stack([dnorm, err, count]),
                            _system_from_sums(s).JTJ.reshape(36)])
    return torch.cat([top, T[3:]]), istate_new, fstate_new


def _level_reference(srcs, tgts, cam: CameraConfig, cfg: ICPConfig, inits,
                     race: bool = False, packed=None):
    """What one K4 launch computes, as (rows, iters) in its layout: the
    frozen-lane loop (each candidate iterates until its own done test,
    then keeps its state while the others go on) from
    ``_partials_reference`` at the launch's grid and
    ``_solve_update_reference``; with ``race`` the epilogue
    (``_race_epilogue_reference``) on the score sums of both final
    transforms.  Targets as in ``_align_candidates``."""
    C = len(srcs)
    n = srcs[0].vertices.numel() // 3
    n_cta = _ctas(n, C)
    dev = srcs[0].vertices.device
    packed = _packed_targets(tgts, packed)
    tol2 = _tol2(cfg)
    T = [se3.identity(device=dev) if i is None else i.to(torch.float32)
         for i in inits]
    istate = [torch.tensor([0, int(cfg.max_iters <= 0)], dtype=torch.int32,
                           device=dev)] * C
    fstate = [torch.cat([torch.tensor([math.inf, math.inf, 0.0],
                                      device=dev),
                         torch.zeros(36, device=dev)])] * C
    while not all(int(s[1]) for s in istate):
        for c in range(C):
            if int(istate[c][1]):
                continue
            parts = _partials_reference(T[c], srcs[c], packed[c], cam, cfg,
                                        n_cta=n_cta)
            T[c], istate[c], fstate[c] = _solve_update_reference(
                parts, T[c], istate[c], fstate[c], cfg.damping, tol2,
                cfg.max_iters)
    rows = torch.stack([torch.cat([T[c].reshape(16), fstate[c][:3],
                                   fstate[c].new_zeros(1), fstate[c][3:]])
                        for c in range(C)])
    iters = torch.stack([s[0] for s in istate])
    if not race:
        return rows, iters
    score_sums = [_sums_reference(_partials_reference(
        T[c], srcs[c], packed[c], cam, cfg, score=True, n_cta=n_cta))
        for c in range(C)]
    return _race_epilogue_reference(rows, iters, score_sums)


def _race_epilogue_reference(rows, iters, score_sums):
    """The race's last step on the two candidates' result rows: score c =
    num / max(den, 1); candidate 1 (the challenger) is kept only when its
    transform and score are finite and its score is strictly lower, else
    candidate 0 (the base).  Returns the rows with the scores in their
    score column and the kept row appended, and the iterations likewise."""
    scores = [num / torch.clamp(den, min=1.0) for num, den in score_sums]
    rows = rows.clone()
    rows[0, _ROW_SCORE], rows[1, _ROW_SCORE] = scores
    take = bool(torch.all(torch.isfinite(rows[1, :16]))
                & torch.isfinite(scores[1]) & (scores[1] < scores[0]))
    k = int(take)
    return (torch.cat([rows, rows[k:k + 1]]),
            torch.cat([iters, iters[k:k + 1]]))


def observability(res: ICPResult) -> torch.Tensor:
    """Smallest eigenvalue of the final normal matrix over the inlier
    count: ~0 when some twist direction is unconstrained (a flat wall
    slides), >= ~1e-2 on structured scenes.  The count is a tensor, so the
    division is a true one, as in the JAX version."""
    E = res.JTJ / torch.clamp(res.count, min=1.0)[..., None, None]
    return torch.linalg.eigvalsh(E)[..., 0]


def pack_result(res: ICPResult) -> torch.Tensor:
    """One pair-ICP result as a (19,) row: transform (16), error, count,
    observability."""
    return torch.cat([res.transform.reshape(16), res.error.reshape(1),
                      res.count.reshape(1), observability(res).reshape(1)])


def icp_align_batch(
    srcs, tgts, cam: CameraConfig, cfg: ICPConfig, inits,
) -> torch.Tensor:
    """Pair ICP over a list of candidates -> (C, 19) rows of
    ``pack_result``.  ``srcs`` / ``tgts`` are lists of Frames of equal
    length (one side usually the same frame repeated), ``inits`` the
    start transforms.  Each candidate stops on its own early exit, which
    is what a batched loop with frozen lanes computes.  On CUDA tensors
    one K4 launch for up to ``MAX_CANDIDATES`` candidates (every source of
    one shape) and one ``eigvalsh`` over the (C, 6, 6) stack; on CPU
    tensors ``_batch_plain``."""
    if _on_cpu(srcs[0].vertices, tgts[0].depth):
        return _batch_plain(srcs, tgts, cam, cfg, inits)
    rows = torch.cat([
        _align_candidates(srcs[k:k + MAX_CANDIDATES],
                          tgts[k:k + MAX_CANDIDATES], cam, cfg,
                          inits[k:k + MAX_CANDIDATES])[0]
        for k in range(0, len(srcs), MAX_CANDIDATES)])
    res = _row_result(rows, None)
    return torch.cat([rows[:, :16], rows[:, _ROW_ERR:_ROW_COUNT + 1],
                      observability(res)[:, None]], dim=1)


def _batch_plain(srcs, tgts, cam: CameraConfig, cfg: ICPConfig,
                 inits) -> torch.Tensor:
    """Plain version of ``icp_align_batch``: ``icp_align`` a candidate."""
    return torch.stack([pack_result(icp_align(s, t, cam, cfg, init_T=i))
                        for s, t, i in zip(srcs, tgts, inits)])


def alignment_score_sums(
    T: torch.Tensor,
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    tgt_packed: torch.Tensor | None = None,
):
    """(sum, count) of the clamped |point-to-plane residual| of ``T`` over
    every source-valid pixel; unmatched pixels cost the full clamp.  K4s
    in score mode on CUDA tensors, the plain version on CPU tensors."""
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    if _on_cpu(T, src.vertices, tgt_packed):
        return _score_sums_reference(T, src, cam, cfg, tgt_packed)
    out = _launch_sums(T, src, tgt_packed, cam, cfg, score=True)
    return out[0], out[1]


def _score_sums_reference(T, src: Frame, cam: CameraConfig, cfg: ICPConfig,
                          tgt_packed: torch.Tensor):
    """Plain version of ``alignment_score_sums``, on any device."""
    p = se3.apply(T, src.vertices)
    in_image, d_t, n_t, p_t = _gather_target(tgt_packed, p, cam)
    r = torch.sum((p - p_t) * n_t, dim=-1)
    src_valid = src.vertices[..., 2] != 0
    matched = in_image & (d_t > 0)
    cap = cfg.dist_thresh
    pen = torch.where(matched, torch.clamp(torch.abs(r), max=cap), cap)
    num = torch.sum(torch.where(src_valid, pen, 0.0))
    den = torch.sum(src_valid.to(torch.float32))
    return num, den


def pick_by_score(
    challenger: ICPResult,
    base: ICPResult,
    challenger_score: torch.Tensor,
    base_score: torch.Tensor,
) -> ICPResult:
    """Choose between two raced ICP results by their common-domain scores;
    ties and non-finite challengers go to the base result."""
    c_ok = (torch.all(torch.isfinite(challenger.transform))
            & torch.isfinite(challenger_score))
    take_c = c_ok & (challenger_score < base_score)
    return ICPResult(*(torch.where(take_c, x, y)
                       for x, y in zip(challenger, base)))


def motion_plausible(T: torch.Tensor, cfg: ICPConfig) -> torch.Tensor:
    """Gate a per-frame transform against the plausible motion envelope."""
    if cfg.max_motion_trans <= 0:
        return torch.ones((), dtype=torch.bool, device=T.device)
    t_ok = _norm(T[:3, 3]) <= cfg.max_motion_trans
    max_rot = float(np.deg2rad(np.float32(cfg.max_motion_rot_deg)))
    r_ok = se3.rotation_angle(T) <= max_rot
    return t_ok & r_ok


def icp_align_pyramid(
    depth_src_m: torch.Tensor,
    depth_tgt_m: torch.Tensor,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: torch.Tensor | None = None,
    src_full: Frame | None = None,
    tgt_full: Frame | None = None,
    prior_T: torch.Tensor | None = None,
) -> ICPResult:
    """Coarse-to-fine ICP over a depth pyramid.  Every level's source and
    packed target come from one ``pyramid_inputs`` call (one K3b launch on
    CUDA tensors).  With ``prior_T`` the coarsest level runs twice
    (identity start and prior start, ``icp_align_raced``) and the
    better-scoring result seeds the finer levels: on CUDA tensors one K4
    launch a level."""
    dev = depth_src_m.device
    T = se3.identity(device=dev) if init_T is None else init_T
    result = None
    n_levels = len(set(cfg.pyramid))
    iters = cfg.pyramid_iters
    if len(iters) != n_levels:
        iters = (cfg.max_iters,) * n_levels
    sources, packed = pyramid_inputs(depth_src_m, depth_tgt_m, cam, cfg,
                                     src_full, tgt_full)
    factors = sorted(set(cfg.pyramid), reverse=True)
    for li, (factor, max_it, src, tgt_packed) in enumerate(
            zip(factors, iters, sources, packed)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        lcfg = dataclasses.replace(cfg, max_iters=max_it)
        if li == 0 and prior_T is not None:
            result = icp_align_raced(src, None, lcam, lcfg, prior_T,
                                     init_T=T, tgt_packed=tgt_packed)
        else:
            result = icp_align(src, None, lcam, lcfg, init_T=T,
                               tgt_packed=tgt_packed)
        T = result.transform
    return result
