"""Window depth gather for TSDF integration (port of ops/pallas_gather.py).

``gather_depth_window(depth_m, v, u, valid)`` returns ``depth_m[v, u]``
for every voxel its block's window covers, 0 elsewhere, plus the
``covered`` mask.  A block's window is WIN x WIN pixels (capped by the
image) anchored at the minimum (v, u) of its valid voxels; voxels of
near-range blocks whose footprint is wider than the window come back
uncovered and are not integrated.

On CUDA tensors the wrapper launches the hand-written kernel
``csrc/window_gather.cu`` (built by ``kernels.py``) or raises; on CPU
tensors it runs the plain PyTorch version
``gather_depth_window_reference``.  ``LAUNCHES`` counts kernel launches.

``gather_depth_window_streamed`` is the same contract for any number of
rows and any row length (port of ``gather_depth_window_streamed``).  It
has a kernel of its own (``csrc/window_gather_streamed.cu``: one warp per
block row, where the first kernel gives a row a CTA of two voxels a thread
and takes row lengths up to 1024), its own plain
version ``gather_depth_window_streamed_reference``, written from the
streamed JAX body (window slice, row pick, column pick), and its own
counter ``LAUNCHES_STREAMED``.  Nothing in the frame step calls it; it is
a public entry point, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import kernels

WIN = 256   # max image window per block (px)

LAUNCHES = 0
LAUNCHES_STREAMED = 0

# block rows per pass of the streamed plain version (bounds its
# (rows, V, ww) temporary)
_STREAMED_ROWS = 32


def _win(height: int, width: int):
    """Window dims: WIN capped by the image (small/test cameras)."""
    return min(WIN, height), min(WIN, width)


def window_origins(v, u, valid, height: int, width: int):
    """Per-block window origins and in-window offsets.

    v, u: (C, V) int32 pixel coords, clamped in-image; valid: (C, V) bool.
    Returns (v0, u0, dv, du, in_win), with dv/du clipped into the window
    and in_win marking the voxels the window covers.  Invalid voxels count
    as (height, width) so their clamped coords cannot stretch the window.
    """
    wh, ww = _win(height, width)
    big_v = torch.where(valid, v, height)
    big_u = torch.where(valid, u, width)
    v0 = torch.clamp(big_v.amin(dim=1), 0, max(height - wh, 0))
    u0 = torch.clamp(big_u.amin(dim=1), 0, max(width - ww, 0))
    dv = v - v0[:, None]
    du = u - u0[:, None]
    in_win = (dv >= 0) & (dv < wh) & (du >= 0) & (du < ww)
    dv = torch.clamp(dv, 0, wh - 1)
    du = torch.clamp(du, 0, ww - 1)
    return v0, u0, dv, du, in_win


def _empty_result(v):
    return (torch.zeros(v.shape, dtype=torch.float32, device=v.device),
            torch.zeros(v.shape, dtype=torch.bool, device=v.device))


def gather_depth_window_reference(depth_m, v, u, valid):
    """Plain PyTorch version of the kernel: (values (C, V) f32, covered
    (C, V) bool)."""
    H, W = depth_m.shape
    if v.shape[0] == 0:
        return _empty_result(v)
    v0, u0, dv, du, in_win = window_origins(v, u, valid, H, W)
    vals = depth_m[(v0[:, None] + dv).long(), (u0[:, None] + du).long()]
    covered = valid & in_win
    return torch.where(covered, vals, 0.0), covered


def gather_depth_window_streamed_reference(depth_m, v, u, valid):
    """Plain PyTorch version of the streamed kernel, in the steps of the
    JAX body: slice each block's (wh, ww) window out of the image, pick
    one window row per voxel through ``dv`` (a (V, ww) strip), then one
    column of that strip through ``du``.  Returns (values (C, V) f32,
    covered (C, V) bool)."""
    H, W = depth_m.shape
    C, V = v.shape
    if C == 0 or V == 0:
        return _empty_result(v)
    dev = v.device
    wh, ww = _win(H, W)
    v0, u0, dv, du, in_win = window_origins(v, u, valid, H, W)
    win_r = torch.arange(wh, device=dev)
    win_c = torch.arange(ww, device=dev)
    vals = torch.empty((C, V), dtype=torch.float32, device=dev)
    for s in range(0, C, _STREAMED_ROWS):
        e = min(s + _STREAMED_ROWS, C)
        rows_idx = (v0[s:e, None] + win_r).long()            # (c, wh)
        cols_idx = (u0[s:e, None] + win_c).long()            # (c, ww)
        patch = depth_m[rows_idx[:, :, None], cols_idx[:, None, :]]
        dv_b = dv[s:e, :, None].long().expand(e - s, V, ww)
        strip = torch.take_along_dim(patch, dv_b, dim=1)     # (c, V, ww)
        picked = torch.take_along_dim(strip, du[s:e, :, None].long(), dim=2)
        vals[s:e] = picked[..., 0]
    covered = valid & in_win
    return torch.where(covered, vals, 0.0), covered


def _check(name, depth_m, v, u, valid, max_v):
    """Raise on what the kernels do not take.  Straight-line tests: this
    runs on every launch of a host-bound step."""
    dev = v.device
    if not (dev.type == "cuda" and depth_m.device == dev and u.device == dev
            and valid.device == dev):
        raise ValueError(f"{name}: all tensors must be on one CUDA device "
                         "(or all on the CPU)")
    if depth_m.dim() != 2 or depth_m.dtype != torch.float32:
        raise ValueError(f"depth_m must be (H, W) float32, got "
                         f"{tuple(depth_m.shape)} {depth_m.dtype}")
    if v.dim() != 2 or (max_v is not None and v.shape[1] > max_v):
        limit = "" if max_v is None else f" with V <= {max_v}"
        raise ValueError(f"v must be (C, V){limit}, got {tuple(v.shape)}")
    if (v.dtype != torch.int32 or u.dtype != torch.int32
            or valid.dtype != torch.bool or u.shape != v.shape
            or valid.shape != v.shape):
        raise ValueError(
            f"v, u must be {tuple(v.shape)} int32 and valid bool of that "
            f"shape, got v {v.dtype}, u {tuple(u.shape)} {u.dtype}, valid "
            f"{tuple(valid.shape)} {valid.dtype}")
    if not (depth_m.is_contiguous() and v.is_contiguous()
            and u.is_contiguous() and valid.is_contiguous()):
        raise ValueError("depth_m, v, u and valid must be contiguous")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _launch(name: str, depth_m, v, u, valid, max_v):
    """The CUDA half of both wrappers: check the inputs, allocate the
    outputs and launch kernel ``name`` on the current stream, or raise.
    Returns (values, covered, launches made: 0 or 1)."""
    _check(name, depth_m, v, u, valid, max_v)
    H, W = depth_m.shape
    C, V = v.shape
    out = torch.empty((C, V), dtype=torch.float32, device=v.device)
    covered = torch.empty((C, V), dtype=torch.bool, device=v.device)
    if C == 0 or V == 0:
        return out, covered, 0
    kernels.launch(name, v.get_device(), depth_m.data_ptr(), v.data_ptr(),
                   u.data_ptr(), valid.data_ptr(), out.data_ptr(),
                   covered.data_ptr(), H, W, C, V, min(WIN, H), min(WIN, W))
    return out, covered, 1


def gather_depth_window(depth_m, v, u, valid):
    """depth_m[v, u] where each block's window covers the voxel, else 0.

    depth_m: (H, W) f32; v, u: (C, V) int32 clamped in-image; valid
    (C, V) bool.  Returns (values (C, V) f32, covered (C, V) bool).
    """
    if _on_cpu(depth_m, v, u, valid):
        return gather_depth_window_reference(depth_m, v, u, valid)
    out, covered, n = _launch("window_gather", depth_m, v, u, valid,
                              max_v=1024)
    global LAUNCHES
    LAUNCHES += n
    return out, covered


def gather_depth_window_streamed(depth_m, v, u, valid):
    """Same contract as ``gather_depth_window`` for any C and V: the
    one-warp-per-row kernel on CUDA tensors (or raise), its own plain
    version on CPU tensors."""
    if _on_cpu(depth_m, v, u, valid):
        return gather_depth_window_streamed_reference(depth_m, v, u, valid)
    out, covered, n = _launch("window_gather_streamed", depth_m, v, u,
                              valid, max_v=None)
    global LAUNCHES_STREAMED
    LAUNCHES_STREAMED += n
    return out, covered
