"""Closed-form weighted rigid alignment, Kabsch / Procrustes (port of
geometry/procrustes.py).

Given matched point pairs, the SE(3) transform minimizing the weighted
point-to-point error in one SVD.  The relocalizer seeds its candidate
registrations with it (models/keyframe_slam._relocalize) before the
point-to-plane refinement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CameraConfig, ICPConfig
from ..ops import icp as icp_ops

YAWS_DEG = (-60.0, -40.0, -20.0, 0.0, 20.0, 40.0, 60.0)


def procrustes(
    src: torch.Tensor,
    tgt: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """T in SE(3) minimizing ``sum_i w_i ||T @ src_i - tgt_i||^2``.

    ``src`` / ``tgt``: (N, 3) matched points; ``weights``: (N,) >= 0 (None:
    uniform).  ``R = U diag(1, 1, det(U Vt)) Vt`` never returns a
    reflection and does not depend on the SVD's sign convention while the
    covariance has rank >= 2.  A total weight ~ 0 or a non-finite solve
    gives the identity; a rank-deficient covariance gives a finite
    best-effort rotation.
    """
    src = src.reshape(-1, 3).to(torch.float32)
    tgt = tgt.reshape(-1, 3).to(torch.float32)
    if weights is None:
        weights = torch.ones(src.shape[:1], dtype=torch.float32,
                             device=src.device)
    w = weights.reshape(-1).to(torch.float32)
    wsum = torch.sum(w)
    ok = wsum > 1e-6
    # the divisor is a tensor in the JAX version too: a true division
    wn = w / torch.where(ok, wsum, 1.0)

    mu_s = torch.sum(src * wn[:, None], dim=0)
    mu_t = torch.sum(tgt * wn[:, None], dim=0)
    C = icp_ops._f32_matmul((tgt - mu_t).T, (src - mu_s) * wn[:, None])

    U, _, Vt = torch.linalg.svd(C)
    d = torch.linalg.det(U @ Vt)
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    t = mu_t - R @ mu_s

    T = torch.eye(4, dtype=torch.float32, device=src.device)
    T[:3, :3] = R
    T[:3, 3] = t
    eye = torch.eye(4, dtype=torch.float32, device=src.device)
    return torch.where(torch.all(torch.isfinite(T)) & ok, T, eye)


def procrustes_init(
    src_frame,
    tgt_frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    rounds: int = 2,
    init_T: torch.Tensor | None = None,
    tgt_packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse rigid init by closed-form point-to-point rounds: projective
    association under the current estimate with the distance and normal
    gates opened wide, then one Procrustes solve on the matched vertex
    pairs.  The result is an initializer; callers refine by ICP and apply
    their own gates."""
    wide = dataclasses.replace(cfg, dist_thresh=1e6, normal_thresh=-1.0)
    dev = src_frame.depth.device
    T = (torch.eye(4, dtype=torch.float32, device=dev)
         if init_T is None else init_T)
    if tgt_packed is None:
        tgt_packed = icp_ops.pack_target(tgt_frame)
    for _ in range(rounds):
        p, _, _, valid, p_t = icp_ops.associate(
            T, src_frame, tgt_frame, cam, wide, tgt_packed=tgt_packed,
            with_points=True)
        delta = procrustes(p.reshape(-1, 3), p_t.reshape(-1, 3),
                           valid.reshape(-1).to(torch.float32))
        T = delta @ T
    return T


def yaw_starts(yaws_deg=YAWS_DEG, device=None) -> torch.Tensor:
    """(Y, 4, 4) pure-yaw start transforms (rotation about +y)."""
    yaws = np.deg2rad(np.asarray(yaws_deg, dtype=np.float32))
    c, s = np.cos(yaws), np.sin(yaws)
    T0 = np.broadcast_to(np.eye(4, dtype=np.float32),
                         (len(yaws), 4, 4)).copy()
    T0[:, 0, 0], T0[:, 0, 2] = c, s
    T0[:, 2, 0], T0[:, 2, 2] = -s, c
    return torch.from_numpy(T0).to(device)


def procrustes_init_raced(
    src_frame,
    tgt_frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    rounds: int = 3,
    yaws_deg: tuple = YAWS_DEG,
) -> torch.Tensor:
    """Race ``procrustes_init`` from a fan of yaw starts and keep the
    hypothesis with the most gated inliers (the first on a tie).
    Projective association from a start tens of degrees off locks into a
    local basin that closed-form rounds cannot leave; a nearer start does
    not."""
    packed = icp_ops.pack_target(tgt_frame)
    Ts, scores = [], []
    for T_init in yaw_starts(yaws_deg, device=src_frame.depth.device):
        T = procrustes_init(src_frame, tgt_frame, cam, cfg, rounds=rounds,
                            init_T=T_init, tgt_packed=packed)
        valid = icp_ops.associate(T, src_frame, tgt_frame, cam, cfg,
                                  tgt_packed=packed)[3]
        Ts.append(T)
        scores.append(torch.sum(valid.to(torch.float32)))
    return torch.stack(Ts)[torch.argmax(torch.stack(scores))]
