"""Port of ``tools/bench_micro.py``: microbenchmarks of the primitive ops
that dominate the SLAM frame (gathers, scatters, sorts, an elementwise
pass, a row reduction, J^T J), the JAX tool's sixteen at its sizes, as
plain PyTorch ops.

Per op: host wall time per call over ``n`` back-to-back calls closed by
one synchronise (the JAX tool's value fetch), and beside it the device
time per call by CUDA-graph replay, warm L2 (``tools/probe.device_ms``).
Nothing runs when the module is imported.

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.bench_micro``;
``main(device="cpu", n=1)`` runs every op on the CPU, host clock only.
"""

from __future__ import annotations

import torch

from ..bench import device_name
from ..device import resolve
from . import probe
from .roofline import timeit

N_RAYS = 640 * 480
TABLE = 256 ** 3


def _ops(device, gen) -> list:
    """(label, fn) of the sixteen ops, on inputs drawn from ``gen``."""
    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    idx = randint(TABLE, (N_RAYS,))
    idx2d = idx.reshape(480, 640)
    flat = torch.arange(TABLE, dtype=torch.float32, device=device)
    flat2 = torch.stack([flat, flat], dim=-1)              # (TABLE, 2)
    flat_bf16 = flat.to(torch.bfloat16)
    rows = torch.ones((16384, 512), dtype=torch.float32, device=device)
    row_idx = randint(16384, (16384,))
    small_tab = torch.arange(64 ** 3, dtype=torch.int32, device=device)
    idx_small = randint(64 ** 3, (N_RAYS,))
    vals = normal((N_RAYS,))
    big = torch.zeros((TABLE,), dtype=torch.float32, device=device)
    img = torch.full((480 * 640,), float("inf"), device=device)
    sidx = randint(480 * 640, (262144,))
    svals = normal((262144,))
    bigidx = randint(TABLE, (8 * 1024 * 1024,))
    bigvals = normal((8 * 1024 * 1024,))
    keys_s = randint(2 ** 30, (921600,)).to(torch.int32)
    keys_m = randint(2 ** 30, (230400,)).to(torch.int32)
    a = normal((480, 640, 3))
    J = normal((N_RAYS, 6))
    return [
        ("gather 307k from 16.7M f32", lambda: flat[idx]),
        ("gather 307k from 16.7M f32 (2d idx)", lambda: flat[idx2d]),
        ("gather 307k from 16.7M bf16", lambda: flat_bf16[idx]),
        ("gather 307k pairs from (16.7M,2)", lambda: flat2[idx]),
        ("gather 307k from 262k i32 table", lambda: small_tab[idx_small]),
        ("gather 16k rows (512) from (16k,512)", lambda: rows[row_idx]),
        ("8x gather 307k (trilinear-ish)",
         lambda: sum(flat[(idx + k) % TABLE] for k in range(8))),
        ("scatter-set 307k into 16.7M",
         lambda: big.index_put((idx,), vals)),
        ("scatter-min 307k into 16.7M",
         lambda: torch.scatter_reduce(big, 0, idx, vals, "amin")),
        ("scatter-min 262k into 307k img",
         lambda: torch.scatter_reduce(img, 0, sidx, svals, "amin")),
        ("scatter-set 8.4M into 16.7M",
         lambda: big.index_put((bigidx,), bigvals)),
        ("sort 921k i32", lambda: torch.sort(keys_s).values),
        ("sort 230k i32", lambda: torch.sort(keys_m).values),
        ("elementwise image pass (3ch)", lambda: a * 2 + 1),
        ("rowmax (16k,512)", lambda: torch.amax(rows, dim=-1)),
        ("JTJ 307kx6", lambda: J.T @ J),
    ]


def measure(device=None, n: int = 10) -> dict:
    """{label: {"ms": host ms per call, "device_ms": device ms per call
    (CUDA-graph replay; None on the CPU)}}, printed a line each."""
    device = resolve(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for label, fn in _ops(device, gen):
        ms = timeit(fn, device=device, n=n)
        dev_ms = (probe.device_ms([fn] * n) if device.type == "cuda"
                  else None)
        out[label] = {"ms": ms, "device_ms": dev_ms}
        dev = ("not measured" if dev_ms is None
               else f"{dev_ms * 1e3:9.1f} us device")
        print(f"{label:45s} {ms:9.4f} ms   {dev}", flush=True)
    print(f"device: {device_name(device)}", flush=True)
    return out


def main(device=None, n: int = 10) -> dict:
    """The sixteen ops on ``device`` (None: the CUDA card); returns
    {label: host ms per call}."""
    return {k: v["ms"] for k, v in measure(device, n).items()}


if __name__ == "__main__":
    main()
