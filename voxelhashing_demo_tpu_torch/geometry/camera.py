"""Pinhole camera projection and back-projection (port of
geometry/camera.py)."""

from __future__ import annotations

import torch

from ..config import CameraConfig
from .f32 import recip


def intrinsic_matrix(cam: CameraConfig, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The 3x3 pinhole matrix K."""
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device)


def inv_intrinsic_matrix(cam: CameraConfig, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """K^-1, its entries computed in double precision and rounded once."""
    return torch.tensor(
        [[1.0 / cam.fx, 0.0, -cam.cx / cam.fx],
         [0.0, 1.0 / cam.fy, -cam.cy / cam.fy],
         [0.0, 0.0, 1.0]],
        dtype=dtype, device=device)


def pixel_rays(cam: CameraConfig, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Unnormalized camera-space rays K^-1 [u, v, 1] per pixel, (H, W, 3);
    times depth z they give the camera-space vertex."""
    u = torch.arange(cam.width, dtype=dtype, device=device)
    v = torch.arange(cam.height, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    x = (uu - cam.cx) * recip(cam.fx)
    y = (vv - cam.cy) * recip(cam.fy)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(points: torch.Tensor, cam: CameraConfig):
    """Camera-space points (..., 3) -> continuous pixel coords (..., 2) and
    a validity mask (z > 0, inside the image)."""
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, 1e-12)
    u = points[..., 0] / safe_z * cam.fx + cam.cx
    v = points[..., 1] / safe_z * cam.fy + cam.cy
    valid = (
        (z > 0)
        & (u >= 0)
        & (u <= cam.width - 1)
        & (v >= 0)
        & (v <= cam.height - 1)
    )
    return torch.stack([u, v], dim=-1), valid


def project_nearest(points: torch.Tensor, cam: CameraConfig):
    """project() with int32 pixel coords; ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    uv, valid = project(points, cam)
    ij = torch.round(uv).to(torch.int32)
    valid = (
        valid
        & (ij[..., 0] >= 0)
        & (ij[..., 0] < cam.width)
        & (ij[..., 1] >= 0)
        & (ij[..., 1] < cam.height)
    )
    return ij, valid
