#!/usr/bin/env python3
"""Where an iteration of the ICP level kernel (K4, csrc/icp.cu) goes: a
phase trace on one card.

Run from the repository root:

    python3 chip_icp_trace.py [--out DIR]

Copies the port's package into ``DIR`` (default ``_trees/icp_trace``,
which .gitignore lists) and edits the copy's csrc/icp.cu: thread 0 of CTA
(0, 0) reads ``clock64()`` at each phase boundary of every round of the
level loop (round start; its own thread sums; the CTA's transpose, which
waits for the CTA's slowest warp; the grid barrier, which waits for the
slowest CTA; the sums over the CTAs; the warp solve; the update; the
closing ``__syncthreads``), and an entry point reads the readings back.
It builds the copy, runs the flagship step's three K4 launches on their
own inputs (``chip_smoke.icp_calls``: the L4 race, L2, L1), a few times
each, and prints one JSON line per launch: the cycles of each phase in
each round of the last run.  The SM clock is printed first (nvidia-smi);
the readings are cycles of that clock.  The copy computes what the
kernel computes (the readings are its only addition).  Needs a CUDA card
and exits nonzero without one.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_icp_compare
import chip_smoke

PKG = "voxelhashing_demo_tpu_torch"
PHASES = ("thread_sums", "cta_sums", "barrier", "grid_sums", "solve",
          "update", "sync")
# (text of csrc/icp.cu, the same with the reading k after or around it)
MARKS = [
    ("      const bool done = st.done;\n",
     "      const bool done = st.done;\n      MARK(0);\n"),
    ("        thread_sums<false>(P, cd, res, g, stride, st.T, acc);\n"
     "        cta_sums<kSums>(",
     "        thread_sums<false>(P, cd, res, g, stride, st.T, acc);\n"
     "        MARK(1);\n        cta_sums<kSums>("),
    ("      if (b == 0 && tid == 0) P.flags[buf * C + c] = done ? 1 : 0;\n"
     "      grid.sync();\n",
     "      MARK(2);\n"
     "      if (b == 0 && tid == 0) P.flags[buf * C + c] = done ? 1 : 0;\n"
     "      grid.sync();\n      MARK(3);\n"),
    ("      if (C > 1 && __syncthreads_and(flag)) break;\n",
     "      MARK(4);\n      if (C > 1 && __syncthreads_and(flag)) break;\n"),
    ("        if (tid == 0) update(P, st, delta);\n",
     "        if (tid == 0) { MARK(5); update(P, st, delta); MARK(6); }\n"),
    ("      __syncthreads();\n      if (st.done) {\n",
     "      __syncthreads();\n      MARK(7);\n      if (st.done) {\n"),
]
TRACE = (
    "__device__ long long g_trace[1024];\n"
    "#define MARK(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && "
    "threadIdx.x == 0 && round < 128) g_trace[round * 8 + (k)] = "
    "clock64(); } while (0)\n")
READER = """
extern "C" int icp_trace_read(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace,
                                                sizeof(g_trace)));
}
"""


def make_copy(out: Path) -> Path:
    """The instrumented copy of the package under ``out``."""
    root = Path(__file__).resolve().parent
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / PKG, out / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = out / PKG / "csrc" / "icp.cu"
    text = src.read_text()
    anchor = "namespace cg = cooperative_groups;\n"
    for old, new in [(anchor, anchor + TRACE)] + MARKS:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/icp.cu changed: cannot place {old!r}")
        text = text.replace(old, new)
    src.write_text(text + READER)
    kern = out / PKG / "kernels.py"
    text = kern.read_text()
    text = text.replace('SOURCES = {', 'SOURCES = {"icp_trace_read": "icp", ')
    text = text.replace('KERNELS = {', 'KERNELS = {\n    "icp_trace_read": [_P],')
    kern.write_text(text)
    return out


def rounds(trace: np.ndarray, n: int) -> list:
    """Cycles of each phase in each of the first ``n`` rounds."""
    out = []
    for r in range(n):
        row = trace[r]
        d = {PHASES[k - 1]: int(row[k] - row[k - 1])
             for k in range(1, 8) if row[k] and row[k - 1]}
        if r + 1 < n and trace[r + 1][0]:
            d["round"] = int(trace[r + 1][0] - row[0])
        out.append(d)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=Path("_trees/icp_trace"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_icp_trace.py needs a CUDA card", file=sys.stderr)
        return 2
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    icp = chip_icp_compare._load_tree("trace_port",
                                      make_copy(args.out).resolve())
    kernels = sys.modules["trace_port.kernels"]
    _, sweep, _ = chip_smoke.room_sweep()
    calls, _, _ = chip_smoke.icp_calls(
        torch, flagship_gather_config(),
        sweep[:chip_smoke.N_STEP_FRAMES + 1])
    for name, srcs, tgts, lcam, lcfg, inits, race in calls:
        for _ in range(5):
            _, iters = icp._align_candidates(srcs, tgts, lcam, lcfg, inits,
                                             race)
        torch.cuda.synchronize()
        buf = np.zeros(1024, np.int64)
        chip_smoke._require(
            kernels.function("icp_trace_read")(buf.ctypes.data) == 0,
            "the trace is read back")
        n = int(iters.max()) + (1 if len(srcs) > 1 else 0)
        print(json.dumps({"case": name, "iters": iters.tolist(),
                          "cycles": rounds(buf.reshape(-1, 8), n)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
