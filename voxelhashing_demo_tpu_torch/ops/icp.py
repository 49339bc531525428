"""Point-to-plane ICP tracking by damped Gauss-Newton (port of ops/icp.py).

The Gauss-Newton loop keeps the JAX version's early exit (stop once
|delta|^2 <= update_tol^2 or after max_iters) as a host-checked Python
loop: one device-to-host read of the update norm per iteration.

The 6x6 normal equations are formed and solved in float32.  The JTJ/JTr
products run with ``torch.backends.cuda.matmul.allow_tf32 = False``
(set around the product by ``_f32_matmul``): TF32 keeps ~3 decimal digits,
which would bend the solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraConfig, ICPConfig
from ..geometry import camera as cam_geom
from ..geometry import se3
from ..geometry.f32 import recip
from .preprocess import (Frame, _norm, downsample_depth,
                         downsample_depth_mean, preprocess_metric)


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


def icp_align(
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: torch.Tensor | None = None,
) -> ICPResult:
    """Align src onto tgt: returns T such that T @ src ~= tgt."""
    dev = src.depth.device
    T = se3.identity(device=dev) if init_T is None else init_T
    tgt_packed = pack_target(tgt)
    # the JAX loop compares the float32 update norm with a float32 bound
    tol2 = float(np.float32(cfg.update_tol ** 2))
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
    start transforms.  Each candidate runs ``icp_align`` on its own pair
    with its own early exit, which is what a batched loop with frozen
    lanes computes; no padding lane is run."""
    rows = [pack_result(icp_align(s, t, cam, cfg, init_T=i))
            for s, t, i in zip(srcs, tgts, inits)]
    return torch.stack(rows)


def alignment_score_sums(
    T: torch.Tensor,
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    tgt_packed: torch.Tensor | None = None,
):
    """(sum, count) of the clamped |point-to-plane residual| of ``T`` over
    every source-valid pixel; unmatched pixels cost the full clamp."""
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
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
    """Coarse-to-fine ICP over a depth pyramid.  With ``prior_T`` the
    coarsest level runs twice (identity start and prior start) and the
    better-scoring result seeds the finer levels."""
    dev = depth_src_m.device
    T = se3.identity(device=dev) if init_T is None else init_T
    result = None
    levels = sorted(set(cfg.pyramid), reverse=True)
    iters = cfg.pyramid_iters
    if len(iters) != len(levels):
        iters = (cfg.max_iters,) * len(levels)
    pools = cfg.source_pools
    if len(pools) != len(levels):
        pools = (1,) * len(levels)
    for li, (factor, max_it, pool) in enumerate(zip(levels, iters, pools)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        lcfg = dataclasses.replace(cfg, max_iters=max_it)
        if factor > 1:
            tgt = preprocess_metric(downsample_depth(depth_tgt_m, factor),
                                    lcam)
        else:
            tgt = (tgt_full if tgt_full is not None
                   else preprocess_metric(depth_tgt_m, lcam))
        sfactor = factor * pool
        if pool > 1:
            src = preprocess_metric(
                downsample_depth_mean(depth_src_m, sfactor),
                cam.scaled(sfactor),
            )
        elif sfactor > 1:
            src = preprocess_metric(downsample_depth(depth_src_m, sfactor),
                                    cam.scaled(sfactor))
        else:
            src = (src_full if src_full is not None
                   else preprocess_metric(depth_src_m, lcam))
        result = icp_align(src, tgt, lcam, lcfg, init_T=T)
        if li == 0 and prior_T is not None:
            raced = icp_align(src, tgt, lcam, lcfg, init_T=prior_T)
            packed = pack_target(tgt)
            sn, sd = alignment_score_sums(raced.transform, src, tgt, lcam,
                                          lcfg, packed)
            bn, bd = alignment_score_sums(result.transform, src, tgt, lcam,
                                          lcfg, packed)
            result = pick_by_score(
                raced, result,
                sn / torch.clamp(sd, min=1.0), bn / torch.clamp(bd, min=1.0),
            )
        T = result.transform
    return result
