#!/usr/bin/env python3
"""Where a launch of a flagship-step kernel goes: a phase trace of every
CTA on one card, for K6 ``compact_visible`` (csrc/fuse.cu) or K3b
``pyramid_levels`` (csrc/preprocess.cu).

Run from the repository root:

    python3 chip_phase_trace.py {k6,k3b} [--out DIR] [--src TREE]

Copies the port's package (this repository's, or the one under ``TREE``:
a design tree) into ``DIR`` (default ``_trees/<kernel>_trace``, which
.gitignore lists) and edits the copy's source: thread 0 of each CTA reads
the global nanosecond timer (``%globaltimer``) at each phase boundary,
and an entry point reads the readings back.  K6's boundaries (of a CTA's
last tile): entry; its entries loaded and tested; its segments scanned,
the tile's count about to be published; the counts before it known (the
snapshot or the look-back); its pad rows written where a snapshot gave
the set's size; its rows written; its end.  K3b's: entry; the
CTA's job found; thread 0's pool windows loaded and pooled; the level
tile complete (the barrier); thread 0's outputs computed; the staged
outputs complete (the barrier); the CTA's stores issued (a target's and
a pack CTA's at their end), with the CTA's job.  It builds the copy, runs
the kernel a few times on the flagship step's own inputs (K6: the table
after the step's allocation at the step's pose,
``chip_splat_breakdown._fuse_inputs``, and an all-free table of its
size; K3b: the step's level inputs, both full-resolution Frames given, as
``chip_splat_breakdown._k3b_breakdown`` makes them) and prints one JSON
line a case: for each boundary the spread over the CTAs (min, median,
max ns after the first CTA's entry) and the median / max ns a CTA spent
in each phase (K3b: also each job's), with the timer's smallest step
seen.  The card's name and power limit come first (nvidia-smi).  The
copy computes what the kernel computes (the readings are its only
addition).  Needs a CUDA card and exits nonzero without one.
"""

import argparse
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_icp_compare
import chip_smoke
import chip_splat_breakdown

PKG = "voxelhashing_demo_tpu_torch"
TRACE_CTAS = 4096


def _after(line: str, k: int, indent: str = "  ") -> tuple:
    return (line, f"{line}{indent}MARK({k});\n")


SPECS = {
    "k6": {
        "source": "fuse",
        "anchor": "constexpr int kFreePtr = -1;\n",
        "bounds": ("entry", "tested", "scanned", "counted", "padded",
                   "rows", "end"),
        "marks": [
            _after("compact_visible_kernel(const __grid_constant__ "
                   "CompactParams P) {\n", 0),
            _after("  const unsigned bits = test_tile(P, tile, key, ptr);\n",
                   1),
            _after("    const int n = __shfl_sync(kFull, incl, 31);\n", 2,
                   "    "),
            _after("      sh[0] = before;\n", 3, "      "),
            ("  const unsigned below = (1u << lane) - 1u;\n",
             "  MARK(4);\n  const unsigned below = (1u << lane) - 1u;\n"),
            _after("  __syncthreads();                     // seg and sh are "
                   "rewritten next\n", 5),
            ("  if (P.snap) return;",
             "  if (P.snap) { MARK(6); return; }"),
            ("  fill_ints(P.out, 3 * P.A + count, 4 * P.A, kFreePtr, gtid, "
             "gsize);\n}\n",
             "  fill_ints(P.out, 3 * P.A + count, 4 * P.A, kFreePtr, gtid, "
             "gsize);\n  MARK(6);\n}\n"),
        ],
    },
    "k3b": {
        "source": "preprocess",
        "anchor": "constexpr int kPoolNone = 0, kPoolMin = 1, kPoolMean = "
                  "2;\n",
        "bounds": ("entry", "job", "pooled", "level_tile", "computed",
                   "staged", "stored"),
        "marks": [
            _after("pyramid_levels_kernel(const __grid_constant__ JobTable T) "
                   "{\n", 0),
            ("  const int t = blockIdx.x - J.first_cta;\n",
             "  const int t = blockIdx.x - J.first_cta;\n  MARK(1);\n"
             "  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas) "
             "g_trace[blockIdx.x * 8 + 7] = j + 1;\n"),
            ("    pack_pixels(J, t);\n    return;\n",
             "    pack_pixels(J, t);\n    MARK(6);\n    return;\n"),
            ("    level_tile_scalar(J, T.edge_band, ty0, tx0, tile);\n"
             "  __syncthreads();\n",
             "    level_tile_scalar(J, T.edge_band, ty0, tx0, tile);\n"
             "  MARK(2);\n  __syncthreads();\n  MARK(3);\n"),
            ("  if (J.kind == kKindTarget) return;\n  __syncthreads();\n",
             "  MARK(4);\n  if (J.kind == kKindTarget) { MARK(6); return; }\n"
             "  __syncthreads();\n  MARK(5);\n"),
            _after("             stage + 3 * kTileN, 3 * kJobTileW, rows, "
                   "3 * cols, J.vec_out);\n", 6),
        ],
    },
}
TRACE = (
    f"constexpr int kTraceCtas = {TRACE_CTAS};\n"
    "__device__ unsigned long long g_trace[kTraceCtas * 8];\n"
    "__device__ __forceinline__ unsigned long long trace_now() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n"
    "}\n"
    "#define MARK(k) do { if (threadIdx.x == 0 && "
    "blockIdx.x < kTraceCtas) g_trace[blockIdx.x * 8 + (k)] = "
    "trace_now(); } while (0)\n")
READER = """
extern "C" int phase_trace_read(unsigned long long* host, int clear) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
  if (err == cudaSuccess && clear) {
    static unsigned long long zero[kTraceCtas * 8];
    err = cudaMemcpyToSymbol(g_trace, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
"""


def make_copy(kernel: str, out: Path, root: Path | None = None) -> Path:
    """The copy of the package under ``root`` (this repository by
    default) under ``out``, ``kernel`` instrumented."""
    spec = SPECS[kernel]
    root = root or Path(__file__).resolve().parent
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(root / PKG, out / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = out / PKG / "csrc" / f"{spec['source']}.cu"
    text = src.read_text()
    for old, new in [(spec["anchor"], spec["anchor"] + TRACE)] + spec["marks"]:
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name} changed: cannot place {old!r}")
        text = text.replace(old, new)
    src.write_text(text + READER)
    kern = out / PKG / "kernels.py"
    text = kern.read_text()
    text = text.replace(
        'SOURCES = {', f'SOURCES = {{"phase_trace_read": "{spec["source"]}", ')
    text = text.replace('KERNELS = {',
                        'KERNELS = {\n    "phase_trace_read": [_P, _I],')
    kern.write_text(text)
    return out


def spread(rows: np.ndarray, bounds) -> dict:
    """Readings of CTAs (rows; entry read), in ns after the first entry
    of ``t0``: each boundary's min / median / max over the CTAs, and each
    phase's median / max a CTA (between consecutive boundaries both
    read)."""
    out = {"ctas": int(len(rows)), "bounds_ns": {}, "phases_ns": {}}
    t0 = rows[:, 0].min()
    for k, name in enumerate(bounds):
        got = rows[:, k][rows[:, k] != 0] - t0
        if len(got):
            out["bounds_ns"][name] = [int(got.min()), float(np.median(got)),
                                      int(got.max())]
    for k in range(1, len(bounds)):
        prev = max((i for i in range(k) if (rows[:, i] != 0).any()),
                   default=0)
        ok = (rows[:, k] != 0) & (rows[:, prev] != 0)
        d = rows[ok, k] - rows[ok, prev]
        if len(d):
            out["phases_ns"][f"{bounds[prev]}->{bounds[k]}"] = [
                float(np.median(d)), int(d.max())]
    return out


def traced(kernels, torch, fn, bounds, by_job: bool) -> dict:
    """Run ``fn`` five times, the last with a cleared trace; its spread
    (and each job's, by the job recorded in slot 7)."""
    buf = np.zeros(TRACE_CTAS * 8, np.uint64)
    read = kernels.function("phase_trace_read")
    for clear in (1, 1, 1, 1, 0):
        fn()
        torch.cuda.synchronize()
        chip_smoke._require(read(buf.ctypes.data, clear) == 0,
                            "the trace is read back")
    rows = buf.reshape(-1, 8).astype(np.int64)
    rows = rows[rows[:, 0] != 0]
    marks = rows[:, :len(bounds)]
    out = spread(marks, bounds)
    steps = np.diff(np.unique(marks[marks != 0]))
    out["timer_step_ns"] = int(steps.min()) if len(steps) else None
    if by_job:
        t0 = marks[:, 0].min()
        out["jobs"] = {}
        for j in np.unique(rows[:, 7]):
            sub = marks[rows[:, 7] == j].copy()
            one = spread(sub, bounds)
            shift = int(sub[:, 0].min() - t0)
            one["bounds_ns"] = {k: [v[0] + shift, v[1] + shift, v[2] + shift]
                                for k, v in one["bounds_ns"].items()}
            out["jobs"][int(j) - 1] = one
    return out


def trace_k6(torch, sweep, kernels) -> list:
    hash_ops = importlib.import_module("trace_port.ops.hash_ops")
    base, _, T_wc, cam, hcfg, fusion, _ = chip_splat_breakdown._fuse_inputs(
        sweep)
    free = base._replace(
        keys=torch.full_like(base.keys, hash_ops.EMPTY_KEY),
        ptrs=torch.full_like(base.ptrs, hash_ops.FREE_PTR))
    out = []
    for name, table in (("step", base), ("all_free", free)):
        got = traced(kernels, torch, lambda t=table: hash_ops.compact_visible(
            t, hcfg, T_wc, cam, fusion), SPECS["k6"]["bounds"], False)
        out.append({"case": name, "table": int(table.keys.shape[0]), **got})
    return out


def trace_k3b(torch, sweep, kernels) -> list:
    pre = importlib.import_module("trace_port.ops.preprocess")
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam

    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:chip_smoke.N_STEP_FRAMES]:
        slam.process(d)
    raw = hash_slam.depth_tensor(sweep[chip_smoke.N_STEP_FRAMES],
                                 slam.device)
    frame = pre.preprocess(raw, cfg.camera, cfg.frontend)
    model = slam.state.model
    jobs, _ = pre._plan(cfg.camera, cfg.icp, True, True, True)
    images = {"src": frame.depth, "tgt": model.depth}
    got = traced(kernels, torch, lambda: pre._launch_levels(jobs, images,
                                                            model),
                 SPECS["k3b"]["bounds"], True)
    return [{"case": "step", "jobs_spec": [list(j[:1]) + list(j[2:4])
                                           for j in jobs], **got}]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("kernel", choices=sorted(SPECS))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--src", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_phase_trace.py needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out = args.out or Path(f"_trees/{args.kernel}_trace")
    chip_icp_compare._load_tree(
        "trace_port", make_copy(args.kernel, out, args.src).resolve())
    kernels = sys.modules["trace_port.kernels"]
    _, sweep, _ = chip_smoke.room_sweep()
    run = trace_k6 if args.kernel == "k6" else trace_k3b
    for line in run(torch, sweep, kernels):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
