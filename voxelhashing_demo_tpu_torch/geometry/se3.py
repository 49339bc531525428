"""SE(3) Lie group operations in closed form (port of geometry/se3.py).

Twist convention: ``xi = [v, w]`` (translation first, rotation second).
All functions take and return float32 tensors on the caller's device.
"""

from __future__ import annotations

import torch

from .f32 import recip

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: skew-symmetric 3x3 -> 3-vector."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc_factors(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), float32-stable, with the
    same half-angle and Taylor guards as the JAX version."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-2
    A = torch.where(small,
                    1.0 - theta2 * recip(6.0)
                    + theta2 * theta2 * recip(120.0),
                    torch.sin(theta) / theta)
    half = 0.5 * theta
    s_half = torch.sin(half) / half
    B = 0.5 * s_half * s_half
    C = torch.where(small,
                    1.0 / 6.0 - theta2 * recip(120.0)
                    + theta2 * theta2 * recip(5040.0),
                    (1.0 - A) / theta2)
    return A, B, C


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """[0, 0, 0, 1] under ``top``, made on its device (row 3 of an eye):
    no upload from the host, so no host sync on the card."""
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return row.expand(top.shape[:-2] + (1, 4))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: twist (..., 6) -> (..., 4, 4) (Rodrigues)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = hat(w)
    K2 = K @ K
    I = torch.eye(3, dtype=xi.dtype, device=xi.device)
    A, B, C = _sinc_factors(theta2)
    R = I + A * K + B * K2
    V = I + B * K + C * K2
    t = torch.einsum("...ij,...j->...i", V, v)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6); the angle comes
    from atan2 as in the JAX version (finite derivative at identity)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w_sin = vee(0.5 * (R - R.transpose(-1, -2)))
    s2 = torch.sum(w_sin * w_sin, dim=-1)
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    s = torch.sqrt(s2 + 1e-24)
    theta = torch.atan2(s, c)
    theta2 = (theta * theta)[..., None, None]
    w = (theta / s)[..., None] * w_sin
    K = hat(w)
    K2 = K @ K
    I = torch.eye(3, dtype=T.dtype, device=T.device)
    A, B, _ = _sinc_factors(theta2)
    coef = torch.where(
        theta2 < 1e-2,
        1.0 / 12.0 + theta2 * recip(720.0)
        + theta2 * theta2 * recip(30240.0),
        (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=_EPS),
    )
    V_inv = I - 0.5 * K + coef * K2
    v = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([v, w], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse without a generic 4x4 inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Group composition A @ B."""
    return A @ B


def apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply one rigid transform (4, 4) to (..., 3) points."""
    return points @ T[:3, :3].T + T[:3, 3]


def apply_rotation(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by one (4, 4) transform (for normals)."""
    return vecs @ T[:3, :3].T


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude (radians) of a rigid transform."""
    tr = T[..., :3, :3].diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
