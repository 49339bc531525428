#!/usr/bin/env python3
"""Time the ICP stage's kernels against another checkout's on one card.

Run from the repository root:

    python3 chip_icp_compare.py --parent DIR [--log FILE]

``DIR`` is a checkout of another commit (e.g. unpacked with ``git
archive`` into a directory that .gitignore lists).  Both trees' ICP runs
on the same inputs, the flagship step's own pyramid after chip_smoke's
first N_STEP_FRAMES noisy sweep frames (``chip_smoke.icp_calls``): each
level through the public entry points (``icp_align``; the coarsest
level's race as ``icp_align_raced`` where the tree has it, else the
composition the pyramid used before: two ``icp_align`` runs, two
``alignment_score_sums`` and ``pick_by_score``), the whole
``icp_align_pyramid`` and the frontend (``preprocess`` of the next raw
frame).  In turns parent / this / this / parent, after a
first turn of this tree that is not kept: per level, the device time (a
CUDA graph of 20 calls replayed, warm L2, ``pack_target``'s plain ops
included in both trees) and the host time as the caller pays it (CUDA
events around a loop of Python calls), the ICP kernels' launches a call;
per pyramid and per frontend call, the median ms (CUDA events,
synchronised) and the host µs that issue it, and the tree's kernel
launches a call.  The trees' results are held against each other
(transform within 1e-5, iterations equal; the frontend's Frame bit for
bit).

Prints the card's name and power limit, then JSON lines: the launch floor,
one line per turn, and last each tree's times as minimum and median over
its turns with the ratio of this tree's minimum to the parent's.  With
``--log FILE`` the same lines also go to that file.  It needs a CUDA card
and exits nonzero without one.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke

PKG = "voxelhashing_demo_tpu_torch"


def _load_tree(name: str, root: Path):
    """The ops.icp module of the checkout at ``root``, imported under the
    package name ``name`` beside this tree's."""
    pkg = root / PKG
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.icp")


def _race(icp, src, tgt, cam, cfg, prior, init):
    """The raced coarsest level in tree ``icp``'s own way."""
    if hasattr(icp, "icp_align_raced"):
        return icp.icp_align_raced(src, tgt, cam, cfg, prior, init_T=init)
    import torch

    result = icp.icp_align(src, tgt, cam, cfg, init_T=init)
    raced = icp.icp_align(src, tgt, cam, cfg, init_T=prior)
    packed = icp.pack_target(tgt)
    sn, sd = icp.alignment_score_sums(raced.transform, src, tgt, cam, cfg,
                                      packed)
    bn, bd = icp.alignment_score_sums(result.transform, src, tgt, cam, cfg,
                                      packed)
    return icp.pick_by_score(raced, result, sn / torch.clamp(sd, min=1.0),
                             bn / torch.clamp(bd, min=1.0))


def _launches(module) -> int:
    """A module's kernel launches so far, all its kernels together."""
    return sum(v for k, v in vars(module).items()
               if k.startswith("LAUNCHES_") and isinstance(v, int))


def _frontend(icp):
    """The ``ops.preprocess`` module of the tree whose ``ops.icp`` is
    ``icp``."""
    return importlib.import_module(icp.__name__.rsplit(".", 1)[0]
                                   + ".preprocess")


def level_call(icp, call):
    """A callable running one pyramid launch's inputs in tree ``icp``."""
    _, srcs, tgts, lcam, lcfg, inits, race = call
    if race:
        return lambda: _race(icp, srcs[0], tgts[0], lcam, lcfg, inits[1],
                             inits[0])
    return lambda: icp.icp_align(srcs[0], tgts[0], lcam, lcfg,
                                 init_T=inits[0])


def _turn(torch, probe, label, icp, calls, pyramid_args) -> dict:
    """Time tree ``icp`` on every level, on the pyramid and on the
    frontend."""
    line = {"tree": label}
    for call in calls:
        fn = level_call(icp, call)
        before = _launches(icp)
        fn()
        launches = _launches(icp) - before
        line[call[0]] = {
            "device_us": 1e3 * probe.device_ms([fn] * probe.WARM_CALLS),
            "host_us": 1e3 * probe.host_ms(fn, iters=20),
            "launches": launches}
    args, kw, front_args = pyramid_args

    def pyramid():
        return icp.icp_align_pyramid(*args, **kw)

    pre = _frontend(icp)

    def frontend():
        return pre.preprocess(*front_args)

    before = _launches(pre)
    frontend()
    launches = _launches(pre) - before
    line["preprocess"] = {
        "ms": chip_smoke.median_ms(torch, frontend),
        "host_issue_us": chip_smoke.host_issue_us(frontend),
        "launches": launches}

    before = _launches(icp)
    pyramid()
    launches = _launches(icp) - before
    line["pyramid"] = {
        "ms": chip_smoke.median_ms(torch, pyramid),
        "host_issue_us": chip_smoke.host_issue_us(pyramid),
        "launches": launches}
    return line


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--log", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_icp_compare.py needs a CUDA card", file=sys.stderr)
        return 2
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.tools import probe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    lines = []
    if args.log is not None:
        args.log.parent.mkdir(parents=True, exist_ok=True)

    def emit(obj) -> None:
        print(json.dumps(obj), flush=True)
        lines.append(json.dumps(obj))
        if args.log is not None:
            args.log.write_text("\n".join(lines) + "\n")

    emit({"device": smi})
    parent = _load_tree("parent_port", args.parent.resolve())
    _, sweep, _ = chip_smoke.room_sweep()
    cfg = flagship_gather_config()
    calls, pargs, kw = chip_smoke.icp_calls(
        torch, cfg, sweep[:chip_smoke.N_STEP_FRAMES + 1])
    front_args = (hash_slam.depth_tensor(sweep[chip_smoke.N_STEP_FRAMES],
                                         "cuda"), cfg.camera, cfg.frontend)
    a, b = (_frontend(t).preprocess(*front_args) for t in (icp, parent))
    same = all(bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
               for x, y in zip(a, b))
    emit({"case": "preprocess", "bit_equal": same})
    chip_smoke._require(same, "preprocess: this tree == the parent")
    # the trees agree on every level before anything is timed
    for call in calls:
        a, b = level_call(icp, call)(), level_call(parent, call)()
        err = float((a.transform - b.transform).abs().max())
        emit({"case": call[0], "transform_max_abs_diff": err,
              "iters": [int(a.iters), int(b.iters)]})
        chip_smoke._require(err <= chip_smoke.ICP_T_ATOL
                            and int(a.iters) == int(b.iters),
                            f"{call[0]}: this tree == the parent")
    floors = [1e3 * probe.launch_floor_ms()]
    emit({"launch_floor_us": floors[0]})
    trees = {"this": icp, "parent": parent}
    _turn(torch, probe, "warm-up", icp, calls, (pargs, kw, front_args))
    readings: dict = {}
    for label in ("parent", "this", "this", "parent"):
        line = _turn(torch, probe, label, trees[label], calls,
                     (pargs, kw, front_args))
        emit(line)
        for case, entry in line.items():
            if case == "tree":
                continue
            for key, value in entry.items():
                if key != "launches":
                    readings.setdefault(label, {}).setdefault(
                        case, {}).setdefault(key, []).append(value)
    floors.append(1e3 * probe.launch_floor_ms())
    emit({"launch_floor_us": floors[1], "what": "again, after the turns"})
    summary = {}
    for label, by_case in readings.items():
        summary[label] = {}
        for case, by_key in by_case.items():
            summary[label][case] = {
                key: {"min": min(v), "median": float(np.median(v)),
                      "vs_parent": min(v) / min(readings["parent"][case][key])}
                for key, v in by_key.items()}
    emit({"summary": summary, "floor_us": floors,
          "what": "min / median over each tree's turns; vs_parent = the "
                  "tree's min over the parent's"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
