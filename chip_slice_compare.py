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
after 24 noisy sweep frames), then its own ``preprocess``, ``splat``,
``fuse`` and ``alloc`` phases (K3a ``preprocess_frame``, K3b
``pyramid_levels``, K9 ``splat_finalize``, K6 ``compact_visible``, K7
``integrate_rows`` and K5b ``insert_blocks`` on the step's own inputs:
warm and L2-cold device µs, each checked bit for bit against its plain
version by the phase: device µs of a CUDA-graph replay over its
launches) and, measured by the same code in both trees (``WRAPPERS``),
the six wrappers' host µs to issue a call and the six kernels' own
device µs a launch by torch.profiler, launched one by one, queued back
to back and from a CUDA graph.  One JSON
line a turn, then the summary as the last line: each tree's ATEs (equal
bit for bit between the trees when their kernels are bit-exact against
the same plain versions), and its p50, stage ms and kernel µs as min /
median over its turns.  ``--log FILE`` keeps every line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

TURNS = ("parent", "this", "this", "parent")
TIMEOUT_S = 900
KERNELS = ("preprocess_frame", "insert_blocks", "splat_finalize",
           "integrate_rows", "pyramid_levels",
           "compact_visible")                # K3a, K5b, K9, K7, K3b, K6

# on the step's inputs, by the same code for every tree (only the APIs
# that both trees have): the wrappers' host µs to issue one call (the
# median of 50, synchronised before each), and each kernel's own device
# µs a launch (torch.profiler, min and median over 8 launches; K5b's each
# on a copy of the map's integer state, K7's on a copy of its float rows
# and last_seen, restored first) in three modes:
# "isolated" (the queue drained before each call, as the host-bound step
# launches them), "queued" (every call queued behind a ~1 ms sleep kernel,
# so the launches run back to back) and "graph" (one CUDA graph of the 8,
# replayed); with CUDA events around the queued launches, over their
# count; and K5b's keys there (M, the distinct U, the new ones).  These
# inputs are frame N_STEP_FRAMES's depth at the pose the step starts it
# from, on the map before it: not the step's own allocation, whose pose
# ICP has moved (that is the ``alloc`` phase's).  K9 finalizes the splat
# buffer of that map, visible set and pose; K7 fuses the frame into that
# map after its allocation, on the set K6 gives; K3b makes the level inputs
# of that frame against the map's model (both full-resolution Frames
# given, as the step's pyramid does); K6 compacts the map after that
# allocation at that pose
WRAPPERS = r"""
def _own_us(torch, name, fn, restore):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):              # a first profile has come back empty
        restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sorted(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA and name in e.name)
        if us:
            break
    return {"min": us[0], "median": float(np.median(us))}


def _modes(torch, name, calls, restore):
    def isolated():
        for c in calls:
            c()
            torch.cuda.synchronize()

    def queued():
        torch.cuda._sleep(2_000_000)
        for c in calls:
            c()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for c in calls:
                c()
    torch.cuda.current_stream().wait_stream(side)
    out = {m: _own_us(torch, name, fn, restore) for m, fn in (
        ("isolated", isolated), ("queued", queued),
        ("graph", graph.replay))}
    restore()
    torch.cuda._sleep(2_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for c in calls:
        c()
    b.record()
    torch.cuda.synchronize()
    out["queued_events"] = 1e3 * a.elapsed_time(b) / len(calls)
    return out


def wrapper_us(torch, cs, sweep):
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.ops import splat
    from voxelhashing_demo_tpu_torch.tools import probe

    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:cs.N_STEP_FRAMES]:
        slam.process(d)
    raw = hash_slam.depth_tensor(sweep[cs.N_STEP_FRAMES], slam.device)
    cam, front = cfg.camera, cfg.frontend
    frame = pre.preprocess(raw, cam, front)
    cand = hash_ops.frame_candidate_keys(frame, slam.state.pose, cam,
                                         cfg.hash, cfg.fusion)
    m = probe.map_copy(slam.state.hmap)
    pose, rc, fus = slam.state.pose, cfg.raycast, cfg.fusion
    visible = hash_ops.compact_visible(slam.state.hmap, cfg.hash, pose, cam,
                                       fus)
    zbuf = splat.splat_depth_from_map(slam.state.hmap, visible, cfg.hash,
                                      pose, cam, rc, fus)
    fused = probe.map_copy(slam.state.hmap)
    hash_ops.allocate_from_frame(fused, frame, pose, cam, cfg.hash, fus,
                                 frame_idx=cs.N_STEP_FRAMES)
    active = hash_ops.compact_visible(fused, cfg.hash, pose, cam, fus)
    rows = ("tsdf", "weight", "band_min", "last_seen")
    copies = [probe.map_copy(fused, rows) for _ in range(8)]

    def k7(x):
        return lambda: hash_ops.integrate(x, active, cfg.hash, frame.depth,
                                          pose, cam, fus,
                                          stamp=cs.N_STEP_FRAMES)

    def restore_rows():
        for x in copies:
            for f in rows:
                getattr(x, f).copy_(getattr(fused, f))

    model, icfg = slam.state.model, cfg.icp

    def k3b():
        return pre.pyramid_inputs(frame.depth, model.depth, cam, icfg,
                                  src_full=frame, tgt_full=model)

    def k6():
        return hash_ops.compact_visible(fused, cfg.hash, pose, cam, fus)

    reps = 50
    issue = {"pyramid_levels": cs.host_issue_us(k3b, reps=reps),
             "compact_visible": cs.host_issue_us(k6, reps=reps),
             "preprocess_frame": cs.host_issue_us(
                 lambda: pre.preprocess(raw, cam, front), reps=reps),
             "insert_blocks": cs.host_issue_us(
                 lambda: hash_ops.insert_blocks(m, cfg.hash, cand, 7),
                 reps=reps),
             "splat_finalize": cs.host_issue_us(
                 lambda: splat.finalize_depth(zbuf, cam, rc, fus),
                 reps=reps),
             "integrate_rows": cs.host_issue_us(k7(copies[0]), reps=reps)}
    ints = ("keys", "ptrs", "bucket_fill", "free_top")    # rows shared
    maps = [probe.map_copy(slam.state.hmap, ints) for _ in range(8)]

    def restore():
        for x in maps:
            for f in ints:
                getattr(x, f).copy_(getattr(slam.state.hmap, f))

    own = {"pyramid_levels": _modes(torch, "pyramid_levels", [k3b] * 8,
                                    lambda: None),
           "compact_visible": _modes(torch, "compact_visible", [k6] * 8,
                                     lambda: None),
           "preprocess_frame": _modes(
               torch, "preprocess_frame",
               [lambda: pre.preprocess(raw, cam, front)] * len(maps),
               lambda: None),
           "insert_blocks": _modes(
               torch, "insert_blocks",
               [lambda x=x: hash_ops.insert_blocks(x, cfg.hash, cand, 7)
                for x in maps], restore),
           "splat_finalize": _modes(
               torch, "splat_finalize",
               [lambda: splat.finalize_depth(zbuf, cam, rc, fus)] * 8,
               lambda: None),
           "integrate_rows": _modes(
               torch, "integrate_rows", [k7(x) for x in copies],
               restore_rows)}
    uniq = torch.unique(cand[cand != hash_ops.EMPTY_KEY])
    _, found = hash_ops.lookup_keys(slam.state.hmap, cfg.hash, uniq)
    keys = {"M": cand.numel(), "U": uniq.numel(),
            "new": int((~found).sum())}
    return issue, own, keys
"""

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np
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
sweep = cs.room_sweep()[1]
k3 = cs.phase_preprocess(torch, "", sweep)
k9 = cs.phase_splat(torch, "", sweep)
k7 = cs.phase_fuse(torch, "", sweep)
k5 = cs.phase_alloc(torch, "", sweep)
us = {k: {"us": 1e3 * d[k]["ms"], "cold_us": 1e3 * d[k]["cold_ms"]}
      for k, d in (("preprocess_frame", k3), ("insert_blocks", k5),
                   ("splat_finalize", k9), ("integrate_rows", k7),
                   ("pyramid_levels", k3), ("compact_visible", k7))}
""" + WRAPPERS + r"""
issue, own, keys = wrapper_us(torch, cs, sweep)
us["insert_blocks"]["keys"] = keys
for k in us:
    us[k]["issue_us"] = issue[k]
    us[k]["queued_events_us"] = own[k].pop("queued_events")
    for mode, v in own[k].items():
        us[k][mode + "_us"] = v["median"]
print(json.dumps({"phase": "kernels", "kernels": us}), flush=True)
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
            "stages_ms": lines["roofline_stages"]["stages_ms"],
            "kernels": lines["kernels"]["kernels"],
            "k5b_graph_copies": lines.get("alloc", {}).get(
                "insert_blocks", {}).get("graph_copies")}


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
                          for s in stages},
            "kernels": {k: {f: _spread([r["kernels"][k][f] for r in rs])
                            for f in ("us", "cold_us", "issue_us",
                                      "isolated_us", "queued_us",
                                      "graph_us", "queued_events_us")}
                        for k in KERNELS}}
    ates = summary["parent"]["ate_mm"] + summary["this"]["ate_mm"]
    summary["ate_equal_bit_for_bit"] = len(set(ates)) == 1
    emit({"summary": summary, "device": smi})
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
