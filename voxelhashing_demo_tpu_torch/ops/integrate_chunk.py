"""Integrate-chunk probe (port of ``tools/exp_pallas_integrate.py``): one
chunk of C blocks x V voxels projected into a depth image, a gather per
voxel and a simplified Curless-Levoy fuse.

- ``project_indices(blocks)``: each voxel's clamped flat pixel index,
  in-image flag and depth z (the probe's ``project_indices``: rounding half
  to even, a true division by ``max(z, 1e-6)``).
- ``integrate_chunk(depth, flatw, tsdf_rows, w_rows, trunc)``: the gather
  and the fuse on a packed ``flatw`` (3, C * V) float32 of (flat index,
  z, valid), in the kernel ``csrc/integrate_chunk.cu`` on CUDA tensors
  (``LAUNCHES``) or its plain version ``integrate_chunk_reference`` on CPU
  tensors.  Per voxel: ``d = depth.flat[int(flat)]``, ``sdf = d - z``,
  ``ok = valid & (d > 0) & (sdf > -trunc)``, ``sdf`` clipped to
  ``+-trunc``; where ok, ``tsdf = (t * w + sdf) / max(w + 1, 1e-12)``;
  ``w = min(w + ok, 255)``.  A flat index outside the image reads NaN, so
  the voxel is left as it was.  Returns new rows; the inputs are not
  changed.
- ``integrate_blocks`` (the probe's ``pallas_integrate``: project, pack,
  the kernel) and ``integrate_blocks_plain`` (its ``xla_integrate``, plain
  ops only).

The probe works on a fixed 640x480 camera with 8^3-voxel blocks of 2 cm;
so does this module (``H``, ``W``, ``FX`` ... ``VOXEL``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .image_gather import _check_card, _on_cpu, take_flat_reference

H, W = 480, 640
BS = 8
VOXEL = 0.02
FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3
TRUNC = 0.1

LAUNCHES = 0


def _local_offsets(device):
    i = torch.arange(BS ** 3, dtype=torch.int32, device=device)
    return torch.stack([i % BS, (i // BS) % BS, i // (BS * BS)], dim=-1)


def project_indices(blocks):
    """blocks (C, 3) int32 block coordinates -> (flat (C, V) int32 pixel
    index clamped into the H x W image, in_img (C, V) bool, z (C, V)
    float32) with V = BS ** 3, through the probe's fixed camera."""
    vox = blocks[:, None, :] * BS + _local_offsets(blocks.device)
    world = vox.to(torch.float32) * VOXEL
    z = world[..., 2]
    zc = torch.clamp_min(z, 1e-6)
    u = torch.round(world[..., 0] / zc * FX + CX).to(torch.int32)
    v = torch.round(world[..., 1] / zc * FY + CY).to(torch.int32)
    in_img = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
    flat = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    return flat, in_img, z


def pack_flatw(flat, in_img, z):
    """(3, C * V) float32 rows: flat index, z, valid (1.0 / 0.0)."""
    return torch.stack([flat.to(torch.float32).reshape(-1), z.reshape(-1),
                        in_img.to(torch.float32).reshape(-1)])


def fuse(d, z, valid, tsdf_rows, w_rows, trunc: float):
    """The probe's fuse in plain ops, on gathered depths ``d``: new
    (tsdf, weight) rows."""
    sdf = d - z
    ok = valid & (d > 0) & (sdf > -trunc)
    sdf = sdf.clamp(-trunc, trunc)
    w_new = torch.where(ok, 1.0, 0.0)
    w_sum = w_rows + w_new
    fused = torch.where(
        w_new > 0, (tsdf_rows * w_rows + sdf * w_new)
        / torch.clamp_min(w_sum, 1e-12), tsdf_rows)
    return fused, torch.clamp_max(w_sum, 255.0)


def integrate_chunk_reference(depth, flatw, tsdf_rows, w_rows,
                              trunc: float = TRUNC):
    """Plain version of ``integrate_chunk``: one rounding per operation,
    as the kernel's round-to-nearest intrinsics."""
    shape = tsdf_rows.shape
    flat = flatw[0].to(torch.int32)                # truncates, as astype
    d = take_flat_reference(depth, flat).reshape(shape)
    return fuse(d, flatw[1].reshape(shape), flatw[2].reshape(shape) > 0,
                tsdf_rows, w_rows, trunc)


def integrate_chunk(depth, flatw, tsdf_rows, w_rows, trunc: float = TRUNC):
    """Gather and fuse one chunk: depth (H, W) float32, flatw (3, N)
    float32, tsdf_rows and w_rows float32 with N elements.  Returns new
    (tsdf, weight) rows of their shape."""
    tensors = (depth, flatw, tsdf_rows, w_rows)
    n = tsdf_rows.numel()
    if flatw.dim() != 2 or flatw.shape != (3, n) or w_rows.shape != \
            tsdf_rows.shape:
        raise ValueError(
            f"flatw must be (3, {n}) and w_rows {tuple(tsdf_rows.shape)}, "
            f"got {tuple(flatw.shape)} and {tuple(w_rows.shape)}")
    if _on_cpu(*tensors):
        return integrate_chunk_reference(depth, flatw, tsdf_rows, w_rows,
                                         trunc)
    _check_card("integrate_chunk", *tensors)
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in tensors):
        raise ValueError("integrate_chunk: depth, flatw, tsdf_rows and "
                         "w_rows must be contiguous float32")
    tsdf_out = torch.empty_like(tsdf_rows)
    w_out = torch.empty_like(w_rows)
    if n == 0:
        return tsdf_out, w_out
    kernels.launch("integrate_chunk", depth.get_device(), depth.data_ptr(),
                   flatw.data_ptr(), tsdf_rows.data_ptr(), w_rows.data_ptr(),
                   tsdf_out.data_ptr(), w_out.data_ptr(), depth.numel(), n,
                   float(trunc))
    global LAUNCHES
    LAUNCHES += 1
    return tsdf_out, w_out


def integrate_blocks(depth, blocks, tsdf_rows, w_rows, trunc: float = TRUNC):
    """The probe's ``pallas_integrate``: project the blocks, pack
    ``flatw`` and run ``integrate_chunk``."""
    flat, in_img, z = project_indices(blocks)
    return integrate_chunk(depth, pack_flatw(flat, in_img, z), tsdf_rows,
                           w_rows, trunc)


def integrate_blocks_plain(depth, blocks, tsdf_rows, w_rows,
                           trunc: float = TRUNC):
    """The probe's ``xla_integrate`` in plain ops: project, gather with
    the in-image flag as validity, fuse."""
    flat, in_img, z = project_indices(blocks)
    d = depth.reshape(-1)[flat.long()]
    return fuse(d, z, in_img, tsdf_rows, w_rows, trunc)
