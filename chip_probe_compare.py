#!/usr/bin/env python3
"""Time the flat gather (K16) and take_along_axis (K17) against other
checkouts' on one card.

Run from the repository root:

    python3 chip_probe_compare.py --parent DIR [--tree NAME=DIR ...]
        [--log FILE]

``DIR`` is a checkout of another commit (e.g. unpacked with ``git
archive`` into a directory that .gitignore lists); ``--tree`` adds more
checkouts under their own names (a design to weigh against this one).
Every tree's wrappers are built and timed in the same call, in turns
(parent, the named trees, this tree, this tree, the named trees again,
parent), on the probe tools' own inputs (voxelhashing_demo_tpu_torch/
tools/): K16 at 65 536 flat gathers, the same as (512, 128), the (row,
column) form, 524 288 gathers and the integrate chunk's projected voxels;
K17 on axis 0 at (512, 256) from the strided (256, 256) patch and on axis
1 at (512, 128) and (512, 256); and, to show what locality does to K16,
the 524 288 gathers confined to the image's first 32 KB and sorted.
Every result is first held bit-exact against this tree's plain version.
Times are chip_smoke's: device time by CUDA-graph replay of 20 calls, warm
and L2-cold, and the wrapper's time as the host sends it; a first turn of
this tree runs before the others and is not kept.

Prints the card's name and power limit, then JSON lines: each case's bound
(chip_smoke._probe_bounds), the launch floor (this tree's empty kernel,
csrc/launch_floor.cu, timed the same way) before and after the turns, one
line per turn, and last each tree's warm and cold time per case as minimum
and median over its turns, with the ratio of each tree's minimum to the
parent's.  With ``--log FILE`` the same lines also go to that file.  It
needs a CUDA card and exits nonzero without one.
"""

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke

PKG = "voxelhashing_demo_tpu_torch"
# case -> (kernel, chip_smoke._probe_bounds key; None: counted here)
CASES = {
    "K16 n65536": ("take_flat", "n65536"),
    "K16 (512,128)": ("take_flat", "n65536"),
    "K16 (r,c)": ("take_flat", "rc"),
    "K16 n524288": ("take_flat", "n524288"),
    "K16 chunk": ("take_flat", "chunk"),
    "K16 n524288 in 32 KB": ("take_flat", None),
    "K16 n524288 sorted": ("take_flat", None),
    "K17 axis0": ("take_along_axis", "axis0"),
    "K17 axis1 (512,128)": ("take_along_axis", "axis1"),
    "K17 axis1 (512,256)": ("take_along_axis", "axis1b"),
}


def _load_tree(name: str, root: Path):
    """The ops.image_gather module of the checkout at ``root``, imported
    under the package name ``name`` beside this tree's."""
    pkg = root / PKG
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.image_gather")


def case_args(torch, tools, device) -> dict:
    """{case: (form, args)} on the probe tools' own inputs; ``form`` is
    "flat", "rc" (the (row, column) form, cols = 640) or "taa"."""
    from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic

    on = tools["probe"].to_device
    vm = on(tools["exp_vmem_gather"].inputs(), device)
    ga = on(tools["exp_gather"].inputs(), device)
    g2 = on(tools["exp_gather2"].inputs(), device)
    it = on(tools["exp_integrate"].inputs(), device)
    flat = ic.project_indices(it["blocks"])[0]
    return {
        "K16 n65536": ("flat", (vm["img"], vm["idx"])),
        "K16 (512,128)": ("flat", (vm["img"], vm["idx2d"])),
        "K16 (r,c)": ("rc", (vm["img2"], vm["r"], vm["c"])),
        "K16 n524288": ("flat", (ga["img"], ga["idx"])),
        "K16 chunk": ("flat", (it["depth"], flat)),
        # the 524 288 gathers' locality changed, nothing else: all within
        # the image's first 32 KB (an L1 holds them), or in sorted order
        "K16 n524288 in 32 KB": ("flat", (ga["img"], ga["idx"] % 8192)),
        "K16 n524288 sorted": ("flat", (ga["img"],
                                        torch.sort(ga["idx"])[0])),
        "K17 axis0": ("taa", (g2["img"][:256, :256], g2["v_idx"], 0)),
        "K17 axis1 (512,128)": ("taa", (g2["src"], g2["u_idx"], 1)),
        "K17 axis1 (512,256)": ("taa", (g2["src256"], g2["u256"], 1)),
    }


def bounds_us(tools, cases) -> dict:
    """{case: bound in us}: chip_smoke's probe bounds, and for the cases
    that are not the probes' own the same count on their indices."""
    bounds = chip_smoke._probe_bounds({n: tools[n]
                                       for n in chip_smoke.PROBE_TOOLS})
    out = {}
    for case, (kname, key) in CASES.items():
        if key is None:
            idx = cases[case][1][1].cpu().numpy()
            ms = chip_smoke._probe_bound(
                idx.size * 8 + chip_smoke._sector_bytes(idx), idx.size * 4)
        else:
            ms = bounds[kname][key]
        out[case] = ms[0] * 1e3
    return out


def form_fn(ig, form: str, plain: bool = False):
    """The callable of module ``ig`` (an ops.image_gather) for ``form``;
    its plain version with ``plain``."""
    suffix = "_reference" if plain else ""
    if form == "taa":
        return getattr(ig, "take_along_axis" + suffix)
    take = getattr(ig, "take_flat" + suffix)
    if form == "flat":
        return take
    return lambda img, r, c: take(img, (r, c), img.shape[1])


def _turn(torch, probe, label, ig, cases, refs) -> dict:
    """Check tree ``ig`` bit-exact on every case and time it there."""
    line = {"tree": label}
    for case, (form, args) in cases.items():
        fn = form_fn(ig, form)
        got = fn(*args)
        torch.cuda.synchronize()
        chip_smoke._require(probe.compare(got, refs[case])["bit_exact"],
                            f"{label} {case} == plain version")
        t = probe.timings(fn, args)
        line[case] = {k: round(t[k] * 1e3, 4)
                      for k in ("ms", "cold_ms", "wrapper_ms")}
    line["unit"] = "us: ms = warm, cold_ms = L2-cold, wrapper_ms = host"
    return line


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--log", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_probe_compare.py needs a CUDA card", file=sys.stderr)
        return 2
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    tools = {n: importlib.import_module(f"{PKG}.tools.{n}")
             for n in ("probe", *chip_smoke.PROBE_TOOLS)}
    probe = tools["probe"]
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
    others = []
    if args.parent is not None:
        others.append(("parent", args.parent))
    for spec in args.tree:
        name, _, root = spec.partition("=")
        others.append((name, Path(root)))
    loaded = {name: _load_tree(f"tree_{i}_port", root.resolve())
              for i, (name, root) in enumerate(others)}
    # every tree's kernels module, each building into its own tree
    modules = [kernels] + [sys.modules[m.__name__.split(".")[0] + ".kernels"]
                           for m in loaded.values()]
    names = ("take_flat", "take_along", "launch_floor")
    with concurrent.futures.ThreadPoolExecutor(3 * len(modules)) as pool:
        for f in [pool.submit(k.build, n) for k in modules for n in names
                  if (k.SRC_DIR / f"{n}.cu").exists()]:
            f.result()

    dev = torch.device("cuda")
    cases = case_args(torch, tools, dev)
    refs = {case: form_fn(ig, form, plain=True)(*a)
            for case, (form, a) in cases.items()}
    emit({"bound_us": bounds_us(tools, cases)})

    floors = [1e3 * chip_smoke.launch_floor_ms()]
    emit({"launch_floor_us": floors[0], "what": "an empty kernel "
          "(csrc/launch_floor.cu), graph of 20 launches replayed"})
    order = list(loaded)                         # the parent first
    turns = order + ["this", "this"] + order[::-1]
    # a first turn of this tree, not kept: the first readings of a process
    # come out up to 0.15 us low
    _turn(torch, probe, "warm-up", ig, cases, refs)
    readings: dict = {}
    for label in turns:
        line = _turn(torch, probe, label, ig if label == "this"
                     else loaded[label], cases, refs)
        emit(line)
        for case in cases:
            for key in ("ms", "cold_ms"):
                readings.setdefault(label, {}).setdefault(
                    case, {}).setdefault(key, []).append(line[case][key])
    floors.append(1e3 * chip_smoke.launch_floor_ms())
    emit({"launch_floor_us": floors[1], "what": "again, after the turns"})
    summary = {}
    for label, by_case in readings.items():
        summary[label] = {}
        for case, by_key in by_case.items():
            entry = {}
            for key, us in by_key.items():
                entry[key] = {"min": min(us), "median": float(np.median(us))}
                if "parent" in readings:
                    entry[key]["vs_parent"] = min(us) / min(
                        readings["parent"][case][key])
            summary[label][case] = entry
    emit({"summary_us": summary, "floor_us": floors,
          "what": "min / median over each tree's turns; vs_parent = this "
                  "tree's min over the parent's"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
