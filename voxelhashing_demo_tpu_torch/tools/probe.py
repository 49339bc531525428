"""What the probe tools share: the variant runner and the card timers.

A ``Probe`` runs each variant once, holds its output against a reference
output (bit for bit, NaN bits included) and, on a CUDA device, times it
three ways:

- ``ms``: device time per call, warm L2: the calls are captured into one
  CUDA graph (no host work between launches) and the graph is replayed
  and timed with CUDA events;
- ``cold_ms``: the same on copies of the inputs rotated through more than
  the card's 50 MB L2, so every call finds its inputs in device memory;
- ``wrapper_ms``: CUDA events around a loop of Python calls, the median of
  5 batches: what a caller pays, host work included.

On the CPU (only when the caller names it) nothing is timed: the lines say
"not measured".  ``device_line`` is the card's name and power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import device_name
from ..device import resolve

L2_BYTES = 50 * 2 ** 20
WARM_CALLS = 20


def device_ms(calls, replays: int = 10) -> float:
    """Device time per call of ``calls`` (callables), captured into one
    CUDA graph and replayed ``replays`` times."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def launch_floor_ms() -> float:
    """Device time per launch of the empty kernel (csrc/launch_floor.cu)
    through ``kernels.launch`` on the current card, timed as the probe
    tools time every kernel (a CUDA graph of ``WARM_CALLS`` launches,
    replayed): the launch floor of that harness."""
    from .. import kernels

    index = torch.cuda.current_device()
    return device_ms([lambda: kernels.launch("launch_floor", index)]
                     * WARM_CALLS)


def host_ms(fn, iters: int = 50, batches: int = 5) -> float:
    """Per-call time of ``fn`` as the host sends it: CUDA events around a
    loop of Python calls, the median of ``batches`` loops."""
    for _ in range(3):
        fn()
    per_batch = max(iters // batches, 1)
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return float(np.median(times))


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


def cold_args(args) -> list:
    """Copies of ``args`` (tensors cloned, other values shared), enough
    that together they exceed the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(args))
    n = L2_BYTES // max(nbytes, 1) + 2
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(n)]


def timings(fn, args) -> dict:
    """{"ms", "cold_ms", "wrapper_ms"} of ``fn(*args)`` on the card."""
    copies = cold_args(args)
    warm = [lambda: fn(*args)] * WARM_CALLS
    cold = [(lambda a=a: fn(*a)) for a in copies] * 2
    return {"ms": device_ms(warm), "cold_ms": device_ms(cold),
            "wrapper_ms": host_ms(warm[0])}


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(got, ref) -> dict:
    """{"bit_exact", "max_abs_err"} of two outputs (tensors or tuples of
    tensors); NaNs must sit at the same places, with the same bits."""
    exact, err = True, 0.0
    for g, r in zip(_leaves(got), _leaves(ref)):
        g, r = g.detach(), r.detach()
        if g.dtype == torch.float32:
            exact &= bool(torch.equal(g.view(torch.int32),
                                      r.view(torch.int32)))
            both = ~(torch.isnan(g) | torch.isnan(r))
            nan_same = bool(torch.equal(torch.isnan(g), torch.isnan(r)))
            diff = (g[both] - r[both]).abs()
            e = float(diff.max()) if diff.numel() else 0.0
            err = max(err, e if nan_same else float("inf"))
        else:
            same = bool(torch.equal(g, r))
            exact &= same
            err = max(err, 0.0 if same else float("inf"))
    return {"bit_exact": exact, "max_abs_err": err}


def to_device(arrays: dict, device) -> dict:
    """numpy arrays -> tensors on ``device``, same dtypes."""
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in arrays.items()}


class Probe:
    """Runs a probe's variants on one device and keeps their results."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self.card = self.device.type == "cuda"
        if self.card:
            torch.cuda.init()      # no card: torch's own error, here
        self.results: dict = {}

    def device_line(self) -> str:
        return device_name(self.device)

    def run(self, name: str, fn, args, ref=None):
        """Run ``fn(*args)``, compare with ``ref`` (an output), time it on
        the card and print one line; returns the output."""
        out = fn(*args)
        entry = {}
        if ref is not None:
            entry.update(compare(out, ref))
        if self.card:
            torch.cuda.synchronize()
            entry.update(timings(fn, args))
        self.results[name] = entry
        if "ms" in entry:
            line = (f"{entry['ms']:9.4f} ms warm  {entry['cold_ms']:9.4f} ms "
                    f"cold  {entry['wrapper_ms']:9.4f} ms wrapper")
        else:
            line = "not measured (no card)"
        print(f"{name:52s} {line}", flush=True)
        if ref is not None:
            print(f"  max |err| vs plain: {entry['max_abs_err']:.2e}  "
                  f"bit-exact: {entry['bit_exact']}", flush=True)
        return out
