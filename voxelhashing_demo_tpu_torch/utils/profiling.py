"""Profiling and observability: stage timers, device traces, metric logs
(port of utils/profiling.py).

- ``StageTimer``: times named stages.  On the card each stage records a
  pair of CUDA events on the current stream and nothing waits while the
  stages run; the events are read once, when ``summary`` (or ``report``)
  is called.  On the CPU it reads the host clock (CPU ops are synchronous).
- ``device_trace``: ``torch.profiler`` around a block, written as a
  Chrome trace (Perfetto or chrome://tracing).
- ``MetricsLog``: append-only JSONL of per-frame records.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from ..device import resolve


class StageTimer:
    """Accumulates per-stage times on ``device`` (None: the CUDA card).

    Usage::

        timer = StageTimer()
        with timer.stage("icp"):
            out = icp(...)
        print(timer.summary())

    ``records`` maps each stage to its times in seconds, complete after
    ``summary``.  ``sync_on`` and the yielded holder's ``"out"`` are
    accepted as in the JAX package and not needed: the events mark the
    stage's place on the stream."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self.records: Dict[str, List[float]] = {}
        self._events: List[tuple] = []      # (name, start, end) not read

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        holder: dict = {}
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield holder
            finally:
                end.record()
                self._events.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            self.records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def _read_events(self) -> None:
        for name, start, end in self._events:
            end.synchronize()
            self.records.setdefault(name, []).append(
                start.elapsed_time(end) * 1e-3)
        self._events = []

    def summary(self) -> Dict[str, Dict[str, float]]:
        self._read_events()
        out = {}
        for name, ts in self.records.items():
            n = len(ts)
            mean = sum(ts) / n
            out[name] = {
                "count": n,
                "mean_ms": round(mean * 1e3, 3),
                "min_ms": round(min(ts) * 1e3, 3),
                "max_ms": round(max(ts) * 1e3, 3),
                "total_s": round(sum(ts), 4),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>6s} {'mean':>9s} {'min':>9s} "
                 f"{'max':>9s}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:24s} {s['count']:6d} {s['mean_ms']:8.2f}m "
                f"{s['min_ms']:8.2f}m {s['max_ms']:8.2f}m"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Profile the block with ``torch.profiler`` (host and, on the card,
    CUDA activity) and write ``log_dir/trace.json`` (Chrome trace format).
    Yields the profiler, whose ``key_averages()`` sums the events.  Wrap
    steady-state frames, not the first ones (kernel builds, allocator)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricsLog:
    """Append-only JSONL metrics file with an in-memory tail."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rows: List[dict] = []
        self._fh = open(path, "a") if path else None

    def log(self, **fields) -> None:
        row = {k: _jsonable(v) for k, v in fields.items()}
        self.rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def log_step_info(self, frame: int, info) -> None:
        """Record a models.hash_slam.StepInfo (its scalars fetched in one
        copy)."""
        names = ("tracked", "icp_error", "icp_iters", "icp_count",
                 "blocks_allocated", "blocks_active", "blocks_freed",
                 "free_blocks")
        vals = torch.stack([getattr(info, n).to(torch.float64).reshape(())
                            for n in names]).cpu().tolist()
        row = dict(zip(names, vals))
        self.log(
            frame=frame,
            tracked=bool(row["tracked"]),
            icp_error=float(row["icp_error"]),
            **{n: int(row[n]) for n in names[2:]},
        )

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _jsonable(v):
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v
