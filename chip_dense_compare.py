#!/usr/bin/env python3
"""Time the dense fusion kernel K20 (csrc/dense.cu) against another
checkout's, in one call on the card.

Run from the repository root on a machine with a CUDA card:

    python3 chip_dense_compare.py --parent DIR [--log FILE]

DIR is another checkout of the repository (e.g. ``git archive <commit> |
tar -x -C _parent``; ``_parent/`` is git-ignored).  Each tree's kernels
are built first.  Then, for each tree in turns parent / this / this /
parent, a fresh process started in that tree times its own K20 on the two
cases of its own ``chip_smoke.py`` ``dense`` phase, through that phase's
``_k20_case`` (held bit for bit against ``integrate_dense_reference``
first; then device time by CUDA-graph replay, warm and L2-cold, the
wrapper's time and host µs to issue a call, the plain version's time and
the bound):

- ``grid_final``: the phase's 160 x 128 x 160 grid after ``DenseSLAM``
  has run the orbit's 20 frames, fused again with the last frame at the
  final pose;
- ``big_512``: a 512^3 volume over a 3 m cube, fused from the room
  sweep's first frame, then timed on its second.

One JSON line a turn, then the summary as the last line (min / median
over each tree's turns) with each tree's K20 registers.  ``--log FILE``
keeps every line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TURNS = ("parent", "this", "this", "parent")
TIMEOUT_S = 900
FIGURES = ("ms", "cold_ms", "wrapper_ms", "issue_us", "plain_ms")

CHILD = r"""
import json
import numpy as np
import torch
import chip_smoke as cs
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.models import dense_slam
from voxelhashing_demo_tpu_torch.models.hash_slam import depth_tensor
from voxelhashing_demo_tpu_torch.ops import preprocess as pre
from voxelhashing_demo_tpu_torch.ops import tsdf
from voxelhashing_demo_tpu_torch.tools import probe
from voxelhashing_demo_tpu_torch.utils import synthetic

cfg = cs.dense_config()
cam = cfg.camera
floor_ms = probe.launch_floor_ms()
depths, _ = synthetic.make_sequence(cam, cs.N_DENSE, trans_amp=0.05,
                                    rot_amp_deg=2.5)
slam = dense_slam.DenseSLAM(cfg)
for d in depths:
    slam.process(d)
st = slam.state
last = pre.preprocess(depth_tensor(depths[-1], "cuda"), cam,
                      cfg.frontend).depth
cases = {"grid_final": cs._k20_case(torch, probe, kernels, "grid_final",
                                    st.tsdf, last, st.pose, cam, cfg.fusion,
                                    floor_ms)[0]}
del slam, st
_, sweep, sweep_gt = cs.room_sweep()
big = tsdf.DenseTSDF(
    sdf=torch.full((cs.DENSE_BIG,) * 3, cfg.fusion.truncation,
                   device="cuda"),
    weight=torch.zeros((cs.DENSE_BIG,) * 3, device="cuda"),
    origin=torch.tensor(cs.DENSE_BIG_ORIGIN, device="cuda"),
    voxel_size=torch.tensor(cs.DENSE_BIG_EDGE_M / cs.DENSE_BIG,
                            device="cuda"))
g0 = np.linalg.inv(sweep_gt[0])
big_in = [(pre.preprocess(depth_tensor(sweep[k], "cuda"), cam,
                          cfg.frontend).depth,
           torch.as_tensor(g0 @ sweep_gt[k], dtype=torch.float32,
                           device="cuda")) for k in (0, 1)]
first, big = cs._k20_case(torch, probe, kernels, "big_first", big,
                          *big_in[0], cam, cfg.fusion, floor_ms, timed=False)
name = f"big_{cs.DENSE_BIG}"
cases[name] = cs._k20_case(torch, probe, kernels, name, big, *big_in[1],
                           cam, cfg.fusion, floor_ms)[0]
cases[name]["first_bit_exact"] = first["bit_exact"]
for c in cases.values():
    c.pop("work", None)
print(json.dumps({"cases": cases,
                  "ptxas": kernels.ptxas_report("dense")}))
"""


def _child(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
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
        print("chip_dense_compare.py needs a CUDA card", file=sys.stderr)
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
        r = _child(trees[which])
        runs[which].append(r)
        emit({"turn": k, "tree": which, **r})
    summary, exact = {}, True
    for which, rs in runs.items():
        summary[which] = {
            case: {f: _spread([r["cases"][case][f] for r in rs])
                   for f in FIGURES}
            for case in rs[0]["cases"]}
        summary[which]["ptxas"] = rs[0]["ptxas"]
        exact &= all(c["bit_exact"] and c["inputs_untouched"]
                     and c.get("first_bit_exact", True)
                     for r in rs for c in r["cases"].values())
    emit({"summary": summary, "bit_exact": exact, "device": smi})
    if log:
        log.close()
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
