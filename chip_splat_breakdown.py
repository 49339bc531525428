#!/usr/bin/env python3
"""Where the device time of the flagship step's kernels goes, on the
step's own inputs: the splat kernels (csrc/splat.cu: K8
``splat_zbuffer``, K9 ``splat_finalize``), the pyramid's level inputs
(csrc/preprocess.cu: K3b ``pyramid_levels``), the fuse kernels
(csrc/fuse.cu: K6 ``compact_visible``, K7 ``integrate_rows``) and the
candidate keys (csrc/alloc.cu: K5a ``alloc_candidates``).

Run from the repository root on a machine with a CUDA card:

    python3 chip_splat_breakdown.py [--tree NAME=DIR ...]

``--tree`` times design trees too (copies of the package with a ``.cu``
edited, e.g. under the git-ignored ``_trees/``): each tree, then this one,
in a fresh process of its own started in the tree (the tree's package
first on ``sys.path``, this repository second for ``chip_smoke.py``), one
JSON line each with its name.

It runs the first N_STEP_FRAMES + 1 frames of chip_smoke.py's room sweep
through ``HashSLAM(flagship_gather_config())``, keeps the arguments of the
last frame's ``splat_raycast`` call and times, each by CUDA-graph replay
(``tools/probe.device_ms``, µs a launch, warm L2):

- K8 as the step runs it (band filter on), without the filter, with
  the row count 0 (its grid's launch and exit alone), and on the step's
  band rows repeated to fill all 4 096 rows of the set (row groups walk
  several rows);
- K9 on the step's raw buffer with 0, 1, 2 and 3 fill rounds, and on
  a buffer with no hole (the fill's fast path everywhere) and one with
  no estimate (every cell a hole);
- K7 on the step's own fuse (the map after the step's allocation, the
  visible set K6 gives): as the step runs it (window gather, stamp),
  without the window, de-integrating, and with the row count cut to
  one wave's worth (the multiprocessors) and to 1, and on every live row
  of the map at once (more rows than the step's);
- K3b on the step's level inputs (the frame's depth after
  ``preprocess``, the model after the first N_STEP_FRAMES frames, both
  full-resolution Frames given, as ``icp_align_pyramid`` calls it): the
  whole launch of the plan's 6 jobs, and each job alone;
- K6 through its wrapper on the step's table (the map after the step's
  allocation, the step's pose), on an all-free table of the same size, on
  the step's table tiled 8 times (2^21 entries, 1 024 tiles of 2 048;
  the set overflows max_active), and on a one-entry free table with no
  set row (the launch and its fixed cost, nothing to test or write);
  beside them the empty kernel on the step's grid of 128 CTAs, without
  and with one grid barrier (csrc/launch_floor.cu), what a cooperative
  launch and its barrier cost; K6 is timed from a CUDA graph captured on
  a stream that has already run it (a kernel that keeps a persistent
  scratch a stream replays on it, as the step's would);
- the empty kernel (the launch floor);

- K5a on the step's frame and pose (``allocate_from_frame``'s in the
  step's fuse), through its wrapper: as the step runs it, at stride 1,
  with 1 and 7 band steps, and on a frame of no valid depth;

and what ptxas says of every kernel of splat.cu, preprocess.cu, fuse.cu
and alloc.cu (registers, spills: ``kernels.ptxas_report``).

One JSON line, with the card's name and power limit first.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TREE_TIMEOUT_S = 600
CHILD = ("import sys; sys.path[:0] = [{tree!r}, {root!r}]; "
         "import chip_splat_breakdown as b; sys.exit(b.measure())")


def _fuse_inputs(sweep) -> tuple:
    """The step's fuse of frame N_STEP_FRAMES: (the map before it with the
    step's allocation applied, frame, pose, camera, hash, fusion, frame
    index) as ``fuse_frame`` takes them."""
    import chip_smoke
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    slam = hash_slam.HashSLAM(flagship_gather_config())
    for d in sweep[:chip_smoke.N_STEP_FRAMES]:
        slam.process(d)
    last = []

    def record(real):
        def fn(hmap, frame, T_wc, cam, hcfg, fusion, frame_idx=0):
            last[:] = [probe.map_copy(hmap), frame, T_wc, cam, hcfg, fusion,
                       frame_idx]
            return real(hmap, frame, T_wc, cam, hcfg, fusion,
                        frame_idx=frame_idx)
        return fn

    with chip_smoke._wrapped(hash_ops, "fuse_frame", record):
        slam.process(sweep[chip_smoke.N_STEP_FRAMES])
    base, frame, T_wc, cam, hcfg, fusion, frame_idx = last
    hash_ops.allocate_from_frame(base, frame, T_wc, cam, hcfg, fusion,
                                 frame_idx=frame_idx)
    return base, frame, T_wc, cam, hcfg, fusion, frame_idx


def _side_us(torch, fn) -> float:
    """Device µs a call of ``fn`` from a CUDA graph of WARM_CALLS calls
    captured on a side stream that ran ``fn`` first (so that a kernel
    keeping a persistent scratch a stream replays on it), replayed 10
    times between CUDA events."""
    from voxelhashing_demo_tpu_torch.tools import probe

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(probe.WARM_CALLS):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(10):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return 1e3 * a.elapsed_time(b) / (10 * probe.WARM_CALLS)


def _k6_breakdown(torch, inputs, us) -> dict:
    """K6's µs a launch (its wrapper, ``_side_us``) on the step's table
    and the variants the module docstring lists, beside the empty kernel
    on the step's grid (``us``)."""
    import dataclasses

    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    base, _, T_wc, cam, hcfg, fusion, _ = inputs
    index = torch.cuda.current_device()
    T = base.keys.shape[0]
    tiles = -(-T // 2048)

    def table(keys, ptrs):
        return hash_ops.HashMap(keys=keys, ptrs=ptrs, **{
            f: None for f in hash_ops.HashMap._fields
            if f not in ("keys", "ptrs")})

    def k6(m, h=hcfg):
        return _side_us(torch, lambda: hash_ops.compact_visible(
            m, h, T_wc, cam, fusion))

    free = table(torch.full_like(base.keys, hash_ops.EMPTY_KEY),
                 torch.full_like(base.ptrs, hash_ops.FREE_PTR))
    tiled = table(base.keys.repeat(8), base.ptrs.repeat(8))
    one = table(free.keys[:1].clone(), free.ptrs[:1].clone())
    return {"table": T, "tiles": tiles,
            "live": int((base.ptrs != hash_ops.FREE_PTR).sum()),
            "count": int(hash_ops.compact_visible(base, hcfg, T_wc, cam,
                                                  fusion).count),
            "step": k6(base), "all_free": k6(free),
            "tiled_x8": k6(tiled),
            "one_free_entry_no_rows": k6(one, dataclasses.replace(
                hcfg, max_active=0)),
            "empty_grid_128": us(lambda: kernels.launch(
                "grid_sync_floor", index, tiles, 0)),
            "empty_grid_128_one_barrier": us(lambda: kernels.launch(
                "grid_sync_floor", index, tiles, 1))}


def _k3b_breakdown(torch, sweep, us) -> dict:
    """K3b's µs a launch (``us``) on the step's level inputs: the whole
    plan in one launch and each job alone."""
    import chip_smoke
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    cfg = flagship_gather_config()
    slam = hash_slam.HashSLAM(cfg)
    for d in sweep[:chip_smoke.N_STEP_FRAMES]:
        slam.process(d)
    cam = cfg.camera
    raw = hash_slam.depth_tensor(sweep[chip_smoke.N_STEP_FRAMES],
                                 slam.device)
    frame = pre.preprocess(raw, cam, cfg.frontend)
    model = slam.state.model
    jobs, _ = pre._plan(cam, cfg.icp, True, True, True)
    images = {"src": frame.depth, "tgt": model.depth}
    kinds = {pre._SOURCE: "source", pre._TARGET: "target",
             pre._PACK: "pack"}
    pools = {pre._NONE: "", pre._MIN: "min", pre._MEAN: "mean"}
    out = {"whole": us(lambda: pre._launch_levels(jobs, images, model))}
    H, W = frame.depth.shape
    for k, job in enumerate(jobs):
        name = (f"{k}_{kinds[job.kind]}_{pools[job.pool]}{job.factor}_"
                f"{H // job.factor}x{W // job.factor}")
        out[name] = us(lambda j=job: pre._launch_levels((j,), images, model))
    return out


def _k7_breakdown(torch, inputs, us) -> dict:
    """K7's µs a launch (``us``) on the step's fuse of frame
    N_STEP_FRAMES: the map before it with the step's allocation applied,
    the visible set of K6, each variant on a copy of the map's rows."""
    import dataclasses

    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.tools import probe

    base, frame, T_wc, cam, hcfg, fusion, frame_idx = inputs
    active = hash_ops.compact_visible(base, hcfg, T_wc, cam, fusion)
    n = int(active.count)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plain = dataclasses.replace(hcfg, use_pallas_gather=False)

    def k7(h=hcfg, act=active, sign=1, stamp=frame_idx):
        m = probe.map_copy(base, probe.MAP_FIELDS)
        return lambda: hash_ops.integrate(m, act, h, frame.depth, T_wc, cam,
                                          fusion, sign=sign, stamp=stamp)

    def cut(k):
        return active._replace(count=torch.tensor(
            k, dtype=torch.int32, device=T_wc.device))

    # every live row of the map as one set (more rows than the step's)
    live = (base.ptrs != hash_ops.FREE_PTR).nonzero().flatten()
    live = live[:hcfg.max_active]
    n_all = live.numel()
    every = hash_ops.ActiveSet(
        blocks=torch.zeros_like(active.blocks),
        ptrs=torch.full_like(active.ptrs, hash_ops.FREE_PTR),
        count=torch.tensor(n_all, dtype=torch.int32, device=T_wc.device))
    every.blocks[:n_all] = coords.unpack_block_key(base.keys[live],
                                                   hcfg.key_bits)
    every.ptrs[:n_all] = base.ptrs[live]
    return {"rows": n, "sms": sms, "rows_all": n_all,
            "step": us(k7()), "no_window": us(k7(h=plain)),
            "deintegrate": us(k7(sign=-1, stamp=None)),
            f"rows_{sms}": us(k7(act=cut(min(sms, n)))),
            "rows_1": us(k7(act=cut(1))), "all_rows": us(k7(act=every))}


def _k8_band_rows(torch, splat, kernels, last, zbuf):
    """K8 (band filter on) on a set of ``rows`` rows all in ``count``, all
    in the band: the step's band rows repeated (so row groups walk
    several rows); a launch into ``zbuf``."""
    hmap, active, hcfg, T_wc, cam, rc, fusion = last
    band = splat.surface_filter(hmap, active,
                                rc.splat_band * fusion.voxel_size)
    n = int(band.count)
    rows = active.ptrs.shape[0]
    take = torch.arange(rows, device=T_wc.device) % n
    full = band._replace(blocks=band.blocks[take].contiguous(),
                         ptrs=band.ptrs[take].contiguous(),
                         count=torch.tensor(rows, dtype=torch.int32,
                                            device=T_wc.device))
    args, keep = splat._zbuffer_args(hmap, full, hcfg, T_wc, cam, rc,
                                     fusion, True)
    index = torch.cuda.current_device()
    return lambda keep=keep: kernels.launch("splat_zbuffer", index,
                                            zbuf.data_ptr(), *args)


def _k5a_breakdown(torch, inputs, us) -> dict:
    """K5a's µs a launch (``us``, through its wrapper) on the step's frame
    and pose (``allocate_from_frame``'s in the step's fuse): as the step
    runs it (stride 3, 3 band steps), at stride 1, with 1 and 7 band
    steps, and on a frame of no valid depth."""
    import dataclasses

    from voxelhashing_demo_tpu_torch.ops import hash_ops

    _, frame, T_wc, cam, hcfg, fusion, _ = inputs

    def k5a(h=hcfg, f=frame):
        return lambda: hash_ops.frame_candidate_keys(f, T_wc, cam, h, fusion)

    def cfg(**kw):
        return dataclasses.replace(hcfg, **kw)

    empty = frame._replace(depth=torch.zeros_like(frame.depth))
    return {"rays": -(-frame.depth.shape[0] // hcfg.candidate_stride)
            * -(-frame.depth.shape[1] // hcfg.candidate_stride),
            "step": us(k5a()), "stride_1": us(k5a(cfg(candidate_stride=1))),
            "band_steps_1": us(k5a(cfg(band_steps=1))),
            "band_steps_7": us(k5a(cfg(band_steps=7))),
            "no_valid_depth": us(k5a(f=empty))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_splat_breakdown.py needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not args.tree:
        return measure()
    trees = [t.split("=", 1) for t in args.tree] + [["this", ROOT]]
    for name, tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD.format(tree=tree, root=ROOT)],
            cwd=tree, capture_output=True, text=True,
            timeout=TREE_TIMEOUT_S)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(json.dumps({"tree": name, "rc": proc.returncode,
                              "err": proc.stderr[-3000:]}), flush=True)
            continue
        print(json.dumps({"tree": name, **json.loads(lines[-1])}),
              flush=True)
    return 0


def measure() -> int:
    """The breakdown in this process, one JSON line; the package is the
    one first on ``sys.path``."""
    import dataclasses

    import torch

    import chip_smoke
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import splat
    from voxelhashing_demo_tpu_torch.tools import probe

    kernels.build_all()
    _, sweep, _ = chip_smoke.room_sweep()
    slam = hash_slam.HashSLAM(flagship_gather_config())
    last = []
    for d in sweep[:chip_smoke.N_STEP_FRAMES + 1]:
        with chip_smoke._wrapped(splat, "splat_raycast",
                                 chip_smoke._recorded(last)):
            slam.process(d)
    hmap, active, hcfg, T_wc, cam, rc, fusion = last
    index = torch.cuda.current_device()
    zbuf = torch.full((cam.height * cam.width,), float("inf"),
                      device=T_wc.device)
    none = torch.zeros((), dtype=torch.int32, device=T_wc.device)

    def k8(count, band_filter: int):
        args, keep = splat._zbuffer_args(
            hmap, active._replace(count=count), hcfg, T_wc, cam, rc, fusion,
            band_filter)
        return lambda keep=keep: kernels.launch("splat_zbuffer", index,
                                                zbuf.data_ptr(), *args)

    def us(fn) -> float:
        return 1e3 * probe.device_ms([fn] * probe.WARM_CALLS)

    raw = splat.splat_depth_from_map_reference(*last)
    full = torch.where(raw > 0, raw, raw[raw > 0].median())
    empty = torch.zeros_like(raw)
    out = {"rows": active.ptrs.shape[0], "count": int(active.count),
           "live_rows": int(splat.surface_filter(
               hmap, active, rc.splat_band * fusion.voxel_size).count),
           "holes": float((raw == 0).float().mean()),
           "floor_us": 1e3 * probe.launch_floor_ms(),
           "k8_us": {"filtered": us(k8(active.count, 1)),
                     "unfiltered": us(k8(active.count, 0)),
                     "count_0": us(k8(none, 1)),
                     "band_rows_x4096": us(_k8_band_rows(
                         torch, splat, kernels, last, zbuf))},
           "k9_us": {}}
    for rounds in (0, 1, 2, 3):
        rcr = dataclasses.replace(rc, splat_fill_rounds=rounds)
        out["k9_us"][f"rounds_{rounds}"] = us(
            lambda r=rcr: splat.finalize_depth(raw, cam, r, fusion))
    out["k9_us"]["no_hole"] = us(
        lambda: splat.finalize_depth(full, cam, rc, fusion))
    out["k9_us"]["no_estimate"] = us(
        lambda: splat.finalize_depth(empty, cam, rc, fusion))
    inputs = _fuse_inputs(sweep)
    out["k7_us"] = _k7_breakdown(torch, inputs, us)
    out["k5a_us"] = _k5a_breakdown(torch, inputs, us)
    out["k6_us"] = _k6_breakdown(torch, inputs, us)
    out["k3b_us"] = _k3b_breakdown(torch, sweep, us)
    srcs = ("splat", "preprocess", "fuse", "alloc")
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        out["ptxas"] = dict(zip(srcs, pool.map(kernels.ptxas_report, srcs)))
    out["floor_us_after"] = 1e3 * probe.launch_floor_ms()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
