#!/usr/bin/env python3
"""The slice and the frame step's stages of this tree against another
checkout's, in one call on the card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_slice_compare.py --parent DIR [--log FILE]

DIR is another checkout of the repository (e.g. ``git archive <commit> |
tar -x -C _parent``; ``_parent/`` is git-ignored).  For each tree in turns
parent / this / this / parent, a fresh process started in that tree
builds its kernels, runs its own ``chip_smoke.py`` ``slice`` phase (12
flagship 640x480 frames through ``HashSLAM(flagship_gather_config())``:
ATE, p50 and max frame ms) and its own ``tools/roofline.measure_stages``
under ``flagship_gather_config()`` (host ms of each stage of the step
after 24 noisy sweep frames).  One JSON line a turn, then the summary as
the last line: each tree's ATEs (equal bit for bit between the trees when
their kernels are bit-exact against the same plain versions), and its
p50 and stage ms as min / median over its turns.  ``--log FILE`` keeps
every line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TURNS = ("parent", "this", "this", "parent")
TIMEOUT_S = 600

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.config import flagship_gather_config
from voxelhashing_demo_tpu_torch.tools import roofline

kernels.build_all()
cs.phase_slice(torch)
stages, n_active = roofline.measure_stages(flagship_gather_config(), "cuda")
print(json.dumps({"phase": "roofline_stages", "stages_ms": stages,
                  "n_active_blocks": n_active}), flush=True)
"""


def _turn(tree: str) -> dict:
    """One fresh process in ``tree``: its slice line and its stage ms."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    lines = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            lines[obj.get("phase")] = obj
    s = lines["slice"]
    return {"ate_mm": s["ate_mm"], "tracked": s["tracked"],
            "frame_ms_p50": s["frame_ms_p50"],
            "frame_ms_max": s["frame_ms_max"],
            "blocks_allocated": s["blocks_allocated"],
            "stages_ms": lines["roofline_stages"]["stages_ms"]}


def _spread(xs) -> dict:
    return {"min": float(np.min(xs)), "median": float(np.median(xs))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--log")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_slice_compare.py needs a CUDA card", file=sys.stderr)
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
    runs = {"parent": [], "this": []}
    for k, which in enumerate(TURNS):
        r = _turn(trees[which])
        runs[which].append(r)
        emit({"turn": k, "tree": which, **r})
    summary = {}
    for which, rs in runs.items():
        stages = sorted(rs[0]["stages_ms"])
        summary[which] = {
            "ate_mm": [r["ate_mm"] for r in rs],
            "frame_ms_p50": _spread([r["frame_ms_p50"] for r in rs]),
            "stages_ms": {s: _spread([r["stages_ms"][s] for r in rs])
                          for s in stages}}
    ates = summary["parent"]["ate_mm"] + summary["this"]["ate_mm"]
    summary["ate_equal_bit_for_bit"] = len(set(ates)) == 1
    emit({"summary": summary, "device": smi})
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
