#!/usr/bin/env python3
"""Where the splat kernels' device time goes, on the flagship step's own
splat (csrc/splat.cu: K8 ``splat_zbuffer``, K9 ``splat_finalize``).

Run from the repository root on a machine with a CUDA card:

    python3 chip_splat_breakdown.py

It runs the first N_STEP_FRAMES + 1 frames of chip_smoke.py's room sweep
through ``HashSLAM(flagship_gather_config())``, keeps the arguments of the
last frame's ``splat_raycast`` call and times, each by CUDA-graph replay
(``tools/probe.device_ms``, µs a launch, warm L2):

- K8 as the step runs it (band filter on), without the filter, and with
  the row count 0 (its grid's launch and exit alone);
- K9 on the step's raw buffer with 0, 1 and 2 fill rounds, and on a
  buffer with no hole (the fill's fast path everywhere);
- the empty kernel (the launch floor).

One JSON line, with the card's name and power limit first.
"""

import json
import os
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_splat_breakdown.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import chip_smoke
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import splat
    from voxelhashing_demo_tpu_torch.tools import probe

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _, sweep, _ = chip_smoke.room_sweep()
    slam = hash_slam.HashSLAM(flagship_gather_config())
    last = []
    for d in sweep[:chip_smoke.N_STEP_FRAMES + 1]:
        with chip_smoke._wrapped(splat, "splat_raycast",
                                 chip_smoke._recorded(last)):
            slam.process(d)
    hmap, active, hcfg, T_wc, cam, rc, fusion = last
    index = torch.cuda.current_device()
    plan = splat._zbuffer_plan(hcfg, cam, rc, fusion)
    zbuf = torch.full((cam.height * cam.width,), float("inf"),
                      device=T_wc.device)
    none = torch.zeros((), dtype=torch.int32, device=T_wc.device)

    def k8(count, band_filter: int):
        return lambda: kernels.launch(
            "splat_zbuffer", index, active.blocks.data_ptr(),
            active.ptrs.data_ptr(), count.data_ptr(), hmap.tsdf.data_ptr(),
            hmap.weight.data_ptr(), hmap.band_min.data_ptr(),
            T_wc.data_ptr(), zbuf.data_ptr(), active.ptrs.shape[0],
            hmap.tsdf.shape[0], *plan, band_filter)

    def us(fn) -> float:
        return 1e3 * probe.device_ms([fn] * probe.WARM_CALLS)

    raw = splat.splat_depth_from_map_reference(*last)
    full = torch.where(raw > 0, raw, raw[raw > 0].median())
    out = {"rows": active.ptrs.shape[0], "count": int(active.count),
           "live_rows": int(splat.surface_filter(
               hmap, active, rc.splat_band * fusion.voxel_size).count),
           "holes": float((raw == 0).float().mean()),
           "floor_us": 1e3 * probe.launch_floor_ms(),
           "k8_us": {"filtered": us(k8(active.count, 1)),
                     "unfiltered": us(k8(active.count, 0)),
                     "count_0": us(k8(none, 1))},
           "k9_us": {}}
    for rounds in (0, 1, 2):
        rcr = dataclasses.replace(rc, splat_fill_rounds=rounds)
        out["k9_us"][f"rounds_{rounds}"] = us(
            lambda r=rcr: splat.finalize_depth(raw, cam, r, fusion))
    out["k9_us"]["no_hole"] = us(
        lambda: splat.finalize_depth(full, cam, rc, fusion))
    out["floor_us_after"] = 1e3 * probe.launch_floor_ms()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
