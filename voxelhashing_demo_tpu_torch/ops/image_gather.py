"""Image gathers of the TPU gather probes (port of the Pallas kernels in
``tools/exp_pallas_vmem_gather.py``, ``exp_pallas_gather.py``,
``exp_pallas_gather2.py`` and the gathers of ``exp_pallas_integrate.py``).

Three functions on tensors, each with its plain PyTorch version
(``*_reference``) and a launch counter:

- ``take_flat(img, idx, cols=None)``: ``img.flat[idx]``; with ``cols``,
  ``idx`` is a pair ``(r, c)`` and the flat index ``r * cols + c`` is
  formed in the kernel (``csrc/take_flat.cu``, ``LAUNCHES_TAKE_FLAT``).
- ``take_along_axis(src, idx, axis)``: numpy's ``take_along_axis`` for a
  2-D float32 source and int32 indices whose length along ``axis`` may
  differ from the source's (``csrc/take_along.cu``,
  ``LAUNCHES_TAKE_ALONG``).
- ``gather_window_two_step(img, v0, u0, dv, du, keep=128)``:
  ``out[b, i, j] = img[v0[b] + dv[b, i, du[b, i, j]], u0[b] + du[b, i, j]]``
  for ``j < keep`` (``csrc/window_gather_two_step.cu``,
  ``LAUNCHES_TWO_STEP``).

Out-of-range indices (the probes make none): an index outside its range
gives NaN, in the kernels and in the plain versions alike.  For
``take_flat`` the range is ``[0, img.numel())`` (negative indices do not
wrap; the ``(r, c)`` form's index is formed in 64 bits); for
``take_along_axis`` ``[0, src.shape[axis])``; for the two-step gather a
column or a window row outside ``[0, S)`` (S = ``dv.shape[-1]``, the side
of the square window) or a pixel outside the image.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels

LAUNCHES_TAKE_FLAT = 0
LAUNCHES_TAKE_ALONG = 0
LAUNCHES_TWO_STEP = 0


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_card(name: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device "
                         "(or all on the CPU)")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _nan_where(ok, vals):
    return torch.where(ok, vals, torch.full_like(vals, float("nan")))


def take_flat_reference(img, idx, cols=None):
    """Plain version of ``take_flat``: ``img.flat[i]`` for each index,
    NaN outside ``[0, img.numel())``."""
    flat = img.reshape(-1)
    if cols is None:
        f = idx.long()
    else:
        r, c = idx
        f = r.long() * cols + c.long()
    if flat.numel() == 0:
        return torch.full(f.shape, float("nan"), device=img.device)
    ok = (f >= 0) & (f < flat.numel())
    return _nan_where(ok, flat[f.clamp(0, flat.numel() - 1)])


def take_flat(img, idx, cols=None):
    """``img.flat[idx]`` (float32 image of any shape, int32 indices of any
    shape; the result has the indices' shape).  With ``cols``, ``idx`` is
    a pair ``(r, c)`` of int32 tensors of one shape and the index is
    ``r * cols + c``.  NaN where the index is out of range."""
    parts = (idx,) if cols is None else tuple(idx)
    if _on_cpu(img, *parts):
        return take_flat_reference(img, idx, cols)
    _check_card("take_flat", img, *parts)
    _check(img.dtype == torch.float32 and img.is_contiguous(),
           f"img must be contiguous float32, got {img.dtype}")
    _check(all(p.dtype == torch.int32 and p.is_contiguous()
               and p.shape == parts[0].shape for p in parts),
           "indices must be contiguous int32 tensors of one shape")
    out = torch.empty(parts[0].shape, dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    col = 0 if cols is None else parts[1].data_ptr()
    kernels.launch("take_flat", img.get_device(), img.data_ptr(),
                   parts[0].data_ptr(), col, out.data_ptr(), img.numel(),
                   out.numel(), 0 if cols is None else int(cols))
    global LAUNCHES_TAKE_FLAT
    LAUNCHES_TAKE_FLAT += 1
    return out


def take_along_axis_reference(src, idx, axis: int):
    """Plain version of ``take_along_axis``: NaN where an index is outside
    ``[0, src.shape[axis])``."""
    n = src.shape[axis]
    k = idx.long()
    if n == 0:
        return torch.full(idx.shape, float("nan"), device=src.device)
    ok = (k >= 0) & (k < n)
    if axis == 0:
        vals = src[k.clamp(0, n - 1), torch.arange(idx.shape[1],
                                                   device=src.device)]
    else:
        vals = src[torch.arange(idx.shape[0], device=src.device)[:, None],
                   k.clamp(0, n - 1)]
    return _nan_where(ok, vals)


def take_along_axis(src, idx, axis: int):
    """numpy's ``take_along_axis(src, idx, axis)`` for a 2-D float32
    ``src`` (a view with a row stride is taken as it is) and 2-D int32
    ``idx`` whose other dimension equals the source's.  NaN where an index
    is out of range."""
    _check(axis in (0, 1), f"axis must be 0 or 1, got {axis}")
    _check(src.dim() == 2 and idx.dim() == 2
           and idx.shape[1 - axis] == src.shape[1 - axis],
           f"src and idx must be 2-D and agree off axis {axis}, got "
           f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if _on_cpu(src, idx):
        return take_along_axis_reference(src, idx, axis)
    _check_card("take_along_axis", src, idx)
    _check(src.dtype == torch.float32 and src.stride(1) == 1
           and src.stride(0) >= src.shape[1],
           "src must be float32 with unit column stride")
    _check(idx.dtype == torch.int32 and idx.is_contiguous(),
           "idx must be contiguous int32")
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    if out.numel() == 0 or src.numel() == 0:
        return out.fill_(float("nan"))
    kernels.launch("take_along", src.get_device(), src.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), idx.shape[0],
                   idx.shape[1], src.shape[0], src.shape[1], src.stride(0),
                   axis)
    global LAUNCHES_TAKE_ALONG
    LAUNCHES_TAKE_ALONG += 1
    return out


def gather_window_two_step_reference(img, v0, u0, dv, du, keep: int = 128):
    """Plain version of ``gather_window_two_step``, written as the
    function (one dv pick and one pixel per output)."""
    H, W = img.shape
    S = dv.shape[-1]
    c = du[..., :keep].long()
    c_ok = (c >= 0) & (c < S)
    r = torch.take_along_dim(dv, c.clamp(0, S - 1), dim=2).long()
    y = v0.long()[:, None, None] + r
    x = u0.long()[:, None, None] + c
    ok = (c_ok & (r >= 0) & (r < S) & (y >= 0) & (y < H) & (x >= 0)
          & (x < W))
    vals = img.reshape(-1)[y.clamp(0, H - 1) * W + x.clamp(0, W - 1)]
    return _nan_where(ok, vals)


def gather_window_two_step(img, v0, u0, dv, du, keep: int = 128):
    """For each block b, the S x S window of ``img`` (H, W) at
    ``(v0[b], u0[b])`` (S = ``dv.shape[-1]``): ``out[b, i, j] =
    window_b[dv[b, i, du[b, i, j]], du[b, i, j]]`` for ``j < keep``.
    v0, u0 (NB,) int32; dv, du (NB, R, S) int32.  Returns (NB, R, keep)
    float32; NaN where a column, a window row or the pixel is out of
    range."""
    _check(img.dim() == 2 and dv.dim() == 3 and du.shape == dv.shape
           and v0.shape == (dv.shape[0],) and u0.shape == v0.shape,
           f"img must be (H, W), dv and du (NB, R, S) and v0, u0 (NB,), "
           f"got {tuple(img.shape)}, {tuple(dv.shape)}, {tuple(du.shape)}, "
           f"{tuple(v0.shape)}, {tuple(u0.shape)}")
    _check(0 < keep <= dv.shape[-1], f"keep must be in [1, S], got {keep}")
    if _on_cpu(img, v0, u0, dv, du):
        return gather_window_two_step_reference(img, v0, u0, dv, du, keep)
    _check_card("gather_window_two_step", img, v0, u0, dv, du)
    _check(img.dtype == torch.float32 and img.is_contiguous(),
           "img must be contiguous float32")
    _check(all(t.dtype == torch.int32 and t.is_contiguous()
               for t in (v0, u0, dv, du)),
           "v0, u0, dv and du must be contiguous int32")
    NB, R, S = dv.shape
    H, W = img.shape
    out = torch.empty((NB, R, keep), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    kernels.launch("window_gather_two_step", img.get_device(),
                   img.data_ptr(), v0.data_ptr(), u0.data_ptr(),
                   dv.data_ptr(), du.data_ptr(), out.data_ptr(), H, W, NB,
                   R, S, keep)
    global LAUNCHES_TWO_STEP
    LAUNCHES_TWO_STEP += 1
    return out
