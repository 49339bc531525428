#!/usr/bin/env python3
"""The bundle-adjustment solve of this tree against another checkout's,
in one call on the card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_ba_compare.py --parent DIR [--log FILE]

DIR is another checkout of the repository (e.g. ``git archive <commit> |
tar -x -C _parent``; ``_parent/`` is git-ignored).  Each tree's kernels
are built first.  Then, for each tree in turns parent / this / this /
parent, two fresh processes started in that tree run the same code
(``CHILD``, only APIs that both trees have; ``chip_smoke.py``'s
``ring_graph``, ``backend_config``, ``backend_drive`` and
``count_syncs`` from the tree's own copy):

- ``cold``: the CUDA context, then the first ``pose_graph.optimize`` of
  the process on a ring graph of capacity 32 (24 poses, 64 edges) under
  the backend phase's keyframe settings (``BACKEND_KEYFRAMES``: 8
  iterations, Geman-McClure with GNC, the dense solver), then a second:
  the first solve of a fresh process, whole.
- ``split``: the CUDA context; loading the tree's pose-graph kernels
  (``kernels.function`` of every ``pg_*`` C function; none in a tree
  without them); the library's first dense factor and solve (a 192 x 192
  ``cholesky_ex`` + ``cholesky_solve``: cuSOLVER's load and handle) and a
  second; then the first and a second ``optimize`` as above.  Then
  ``optimize`` at K = 32, 64 (dense) and 512 (CG, 128 poses with chords,
  ``chip_smoke.phase_backend_ba``'s graphs): median ms of 5 and host
  syncs; then the backend scenario (``KeyframeSLAM`` at the flagship
  gather width on the 48 sweep frames with the two injected drifts,
  after ``warm_compile``, timed): each BA event's ms, their median and
  maximum, and the frame ms p50 and maximum.

One JSON line a turn, then the summary as the last line (min / median
over each tree's turns).  ``--log FILE`` keeps every line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TURNS = ("parent", "this", "this", "parent")
TIMEOUT_S = 900

CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
torch.cuda.init()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
ctx_s = time.perf_counter() - t0
import chip_smoke as cs
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.config import KeyframeConfig
from voxelhashing_demo_tpu_torch.ops import pose_graph

MODE = sys.argv[1]
kcfg = KeyframeConfig(**cs.BACKEND_KEYFRAMES)
K32 = cs.ring_graph(torch, 24, 32, 7, False, "cuda")
torch.cuda.synchronize()


def wall(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


out = {"mode": MODE, "ctx_s": ctx_s}
if MODE == "split":
    names = [n for n in kernels.KERNELS if n.startswith("pg_")]
    _, out["kernel_load_s"] = wall(lambda: [kernels.function(n)
                                            for n in names])
    out["kernels_loaded"] = names
    rng = np.random.RandomState(0)
    M = rng.normal(size=(192, 192)).astype(np.float32)
    A = torch.as_tensor(M @ M.T + 192 * np.eye(192, dtype=np.float32),
                        device="cuda")
    b = torch.ones((192, 1), device="cuda")

    def solve():
        L, info = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b, L)

    _, out["linalg_first_s"] = wall(solve)
    _, out["linalg_second_s"] = wall(solve)
_, out["first_solve_s"] = wall(lambda: pose_graph.optimize(K32, kcfg))
_, out["second_solve_s"] = wall(lambda: pose_graph.optimize(K32, kcfg))
if MODE == "split":
    solves = {}
    for name, g, kc in (
            ("K32_backend", K32, kcfg),
            ("K64_dense", cs.ring_graph(torch, 64, 64, 7, False, "cuda"),
             KeyframeConfig(ba_iters=10, ba_solver="dense")),
            ("K512_cg", cs.ring_graph(torch, 128, 512, 7, True, "cuda"),
             KeyframeConfig(ba_iters=10, ba_solver="cg"))):
        times = [wall(lambda: pose_graph.optimize(g, kc))[1] * 1e3
                 for _ in range(6)][1:]
        solves[name] = {"ms": float(np.median(times)),
                        "ms_min": float(np.min(times)),
                        "host_syncs": cs.count_syncs(
                            torch, lambda: pose_graph.optimize(g, kc))}
    out["optimize"] = solves
    from voxelhashing_demo_tpu_torch.models import keyframe_slam
    from voxelhashing_demo_tpu_torch.utils import synthetic
    cfg = cs.backend_config()
    depths, gt = synthetic.make_room_sweep(
        cfg.camera, cs.N_BACKEND, sweep_deg=cs.BACKEND_SWEEP_DEG,
        noise_seed=1)
    slam = keyframe_slam.KeyframeSLAM(cfg)
    _, out["warm_compile_s"] = wall(lambda: slam.warm_compile(depths[0]))
    frame_ms = cs.backend_drive(torch, slam, depths)
    slam.trajectory()
    ev = [e["ba_s"] * 1e3 for e in slam.ba_events]
    out["backend"] = {"ba_events": len(ev), "event_ba_ms": ev,
                      "event_ba_ms_p50": float(np.median(ev)),
                      "event_ba_ms_max": float(np.max(ev)),
                      "frame_ms_p50": float(np.percentile(frame_ms, 50)),
                      "frame_ms_max": float(np.max(frame_ms))}
print(json.dumps(out))
"""


def _child(tree: str, mode: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, mode], cwd=tree,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} {mode}: rc {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads([ln for ln in proc.stdout.splitlines()
                       if ln.startswith("{")][-1])


def _build(tree: str) -> None:
    subprocess.run([sys.executable, "-c", "from voxelhashing_demo_tpu_torch "
                    "import kernels; kernels.build_all()"], cwd=tree,
                   check=True, timeout=TIMEOUT_S)


def _spread(xs) -> dict:
    return {"min": float(np.min(xs)), "median": float(np.median(xs))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--log")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ba_compare.py needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(args.parent), "this": here}
    log = open(args.log, "w") if args.log else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"device": smi})
    for tree in trees.values():
        _build(tree)
    runs = {"parent": [], "this": []}
    for k, which in enumerate(TURNS):
        r = {"cold": _child(trees[which], "cold"),
             "split": _child(trees[which], "split")}
        runs[which].append(r)
        emit({"turn": k, "tree": which, **r})
    summary = {}
    for which, rs in runs.items():
        sp = [r["split"] for r in rs]
        summary[which] = {
            "first_solve_cold_s": _spread([r["cold"]["first_solve_s"]
                                           for r in rs]),
            "second_solve_ms": _spread([r["cold"]["second_solve_s"] * 1e3
                                        for r in rs]),
            "split_s": {k: _spread([s[k] for s in sp]) for k in (
                "ctx_s", "kernel_load_s", "linalg_first_s",
                "linalg_second_s", "first_solve_s", "second_solve_s",
                "warm_compile_s")},
            "optimize_ms": {n: _spread([s["optimize"][n]["ms"] for s in sp])
                            for n in sp[0]["optimize"]},
            "optimize_host_syncs": {n: sp[0]["optimize"][n]["host_syncs"]
                                    for n in sp[0]["optimize"]},
            "backend": {k: _spread([s["backend"][k] for s in sp]) for k in (
                "event_ba_ms_p50", "event_ba_ms_max", "frame_ms_p50",
                "frame_ms_max")},
            "ba_events": [s["backend"]["ba_events"] for s in sp],
        }
    emit({"summary": summary, "device": smi})
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
