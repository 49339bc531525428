#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card; without one (or without the repository beside it)
it exits nonzero and prints no result.  Phases, one JSON line each:

1. ``device``: the card's name and power limit (nvidia-smi).
2. ``build``: builds every kernel source under csrc/ for sm_90a into the
   package's _build/ directory, one nvcc process each, started together.
3. ``kernel``: both window-gather kernels (one CTA per block row; one warp
   per block row, "streamed") against their plain PyTorch versions on the
   card at 480x640, V=512: spread 120, spread 400 and the invalid corner
   at C=4096, spread 120 at C=832 (the slice's last-frame row count), and
   for the streamed kernel spread 120 at C=4099.  Values and covered must
   be bit-exact, and the two kernels equal to each other (the streamed
   kernel also at row lengths 510 and 1000, untimed).  Per case and
   kernel: the wrapper's time (CUDA events around Python calls), the
   kernel's device time (a CUDA graph of launches replayed, per launch;
   once on the same inputs, once on inputs rotated through more than the
   L2 cache holds), the plain version's time and the byte bound.
4. ``parity``: the port on the card (kernel) against the port on the CPU
   (plain gather) over 10 frames at 80x60: per-frame pose translation
   within 1e-4 m.
5. ``slice``: 12 synthetic 640x480 frames through
   ``HashSLAM(flagship_gather_config())`` (splat prediction); asserts the
   kernel launched on every frame, >= 11/12 frames tracked, finite poses,
   unaligned ATE and render hit fraction inside their bounds.
6. ``march``: 24 frames of the noisy room sweep through the same
   configuration with ``raycast.mode = "march"``; asserts the kernel
   launched on every frame, >= 23/24 tracked, finite poses, ATE and hit
   fraction inside bounds set from the JAX package on the same frames;
   then ``render`` from the last pose, the surface point cloud and the
   mesh of the card's map (non-empty, finite, points on the room's
   surface).  Prints per-frame times, the march stage alone at the final
   state (``march_stage_ms``) beside the frame, peak memory.
7. ``streamed_entry``: the streamed gather's public entry point on the
   frame step's own gather inputs (the last sweep frame's visible rows,
   any row count), with its launch count set to 0 just before.

Then the kernel summary line (``launches`` is the count of the last path
that drives the kernel, ``launches_by_path`` has each path's own count;
``bound_ms`` is 14 bytes per voxel plus the depth image once over the
card's memory rate) and, last, the contract line
``{"ok": true, "device": {...}}``.  Any failed check raises (exit 1).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W, C, V = 480, 640, 4096, 512
# rows at the slice's last frame (JAX reference); timed beside C = 4096
C_SLICE = 832
C_ODD = 4099          # not a multiple of 8: the streamed kernel only
N_FRAMES = 12
N_MARCH = 24
# The JAX package on the CPU (Pallas kernel in interpret mode) on the same
# frames at flagship_gather_config(), from tests/torch_port_reference.py:
# accuracy references, not speeds.
JAX_REFERENCE = {"frames": 20, "tracked": 19, "ate_mm": 3.757,
                 "hit_frac": 0.9282, "active_blocks": 832,
                 "blocks_freed": 0}
JAX_REFERENCE_MARCH = {"frames": 24, "tracked": 23, "ate_mm": 21.857,
                       "hit_frac": 0.9845, "active_blocks": 896,
                       "blocks_freed": 0}
ATE_BOUND_MM = 7.5
HIT_BOUND = 0.8
PARITY_ATOL_M = 1e-4
# H100 SXM data sheet: device memory rate and float32 rate outside the
# tensor cores (the gather's few integer operations are counted at it)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# v 4, u 4, valid 1 read; value 4, covered 1 written.  The depth image is
# the function's fourth input and is counted once, whole, in _bound.
BYTES_PER_VOXEL = 14
OPS_PER_VOXEL = 10        # 2 min, 2 subtract, 4 compare, 2 address
L2_BYTES = 50 * 2 ** 20

KERNEL_META = {
    "gather_depth_window": {
        "route": "cuda",
        "source": "voxelhashing_demo_tpu_torch/csrc/window_gather.cu",
        "replaces": "voxelhashing_demo_tpu/ops/pallas_gather.py:88",
    },
    "gather_depth_window_streamed": {
        "route": "cuda",
        "source":
            "voxelhashing_demo_tpu_torch/csrc/window_gather_streamed.cu",
        "replaces": "voxelhashing_demo_tpu/ops/pallas_gather.py:143",
    },
}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _gather_cases(rng):
    """(name, v, u, valid) numpy cases, as in tests/test_pallas_gather.py
    but at C=4096 rows, plus spread 120 at the slice's row count and at a
    row count that is no multiple of 8."""
    cases = []
    for name, spread, rows in (("spread120", 120, C),
                               ("spread400", 400, C),
                               ("spread120_c832", 120, C_SLICE),
                               ("spread120_c4099", 120, C_ODD)):
        v0 = rng.integers(0, H - spread, size=(rows, 1))
        u0 = rng.integers(0, W - spread, size=(rows, 1))
        v = v0 + rng.integers(0, spread, size=(rows, V))
        u = u0 + rng.integers(0, spread, size=(rows, V))
        valid = rng.random((rows, V)) > 0.15
        cases.append((name, v, u, valid))
    v = np.full((C, V), 100)
    u = np.full((C, V), 200)
    valid = np.ones((C, V), bool)
    v[:, 0], u[:, 0], valid[:, 0] = H - 1, W - 1, False
    cases.append(("invalid_corner", v, u, valid))
    return cases


def _time_ms(torch, fn, iters: int = 50) -> float:
    """Per-call time of ``fn`` as the host sends it (CUDA events around a
    loop of Python calls): the wrapper's time, not the kernel's."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, calls, replays: int = 10) -> float:
    """Device time per call: the calls are captured into one CUDA graph
    (no host work between launches on replay), the graph is replayed and
    timed with CUDA events."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def _bound(rows: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    (every input read once, the depth image included, every output
    written once) and operations over the float32 rate, for ``rows``
    block rows."""
    n = rows * V
    by_bytes = (n * BYTES_PER_VOXEL + H * W * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = n * OPS_PER_VOXEL / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _time_kernel(torch, wrapper, depth, vt, ut, mt) -> dict:
    rows = int(vt.shape[0])
    n_copies = L2_BYTES // (rows * V * 9) + 2      # inputs exceed the L2
    copies = [(vt.clone(), ut.clone(), mt.clone()) for _ in range(n_copies)]
    warm = [lambda: wrapper(depth, vt, ut, mt)] * 20
    cold = [(lambda a=a, b=b, c=c: wrapper(depth, a, b, c))
            for a, b, c in copies] * 2
    return {
        "ms": _device_ms(torch, warm),
        "cold_ms": _device_ms(torch, cold),
        "wrapper_ms": _time_ms(torch, warm[0]),
    }


def _check_odd_rows(torch, wg, depth, rng) -> None:
    """The streamed kernel's other paths, checked and not timed: a row
    length that is no multiple of 4 (scalar loop) and one longer than a
    lane keeps in registers (reread loop)."""
    for rows, vlen in ((37, 510), (16, 1000)):
        v = torch.as_tensor(rng.integers(0, H, (rows, vlen)),
                            dtype=torch.int32, device=depth.device)
        u = torch.as_tensor(rng.integers(0, W, (rows, vlen)),
                            dtype=torch.int32, device=depth.device)
        m = torch.as_tensor(rng.random((rows, vlen)) > 0.15,
                            device=depth.device)
        got, got_cov = wg.gather_depth_window_streamed(depth, v, u, m)
        ref, ref_cov = wg.gather_depth_window_streamed_reference(depth, v,
                                                                 u, m)
        torch.cuda.synchronize()
        _require(bool(torch.equal(got, ref)
                      and torch.equal(got_cov, ref_cov)),
                 f"streamed kernel == plain version at V = {vlen}")


def phase_kernel(torch, wg):
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    depth = torch.as_tensor(rng.random((H, W), dtype=np.float32) + 0.5,
                            device=dev)
    kernels = (
        ("gather_depth_window", wg.gather_depth_window,
         wg.gather_depth_window_reference),
        ("gather_depth_window_streamed", wg.gather_depth_window_streamed,
         wg.gather_depth_window_streamed_reference),
    )
    rows = []
    worst = {name: 0.0 for name, _, _ in kernels}
    for case, v, u, valid in _gather_cases(rng):
        vt = torch.as_tensor(v, dtype=torch.int32, device=dev)
        ut = torch.as_tensor(u, dtype=torch.int32, device=dev)
        mt = torch.as_tensor(valid, device=dev)
        n_rows = int(vt.shape[0])
        bound_ms, bound_by = _bound(n_rows)
        row = {"case": case, "C": n_rows, "valid": int(mt.sum()),
               "bound_ms": bound_ms, "bound_by": bound_by}
        outs = {}
        for name, wrapper, plain in kernels:
            got, got_cov = wrapper(depth, vt, ut, mt)
            ref, ref_cov = plain(depth, vt, ut, mt)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            worst[name] = max(worst[name], err)
            exact = bool(torch.equal(got, ref)
                         and torch.equal(got_cov, ref_cov))
            _require(exact, f"{name} == its plain version bit for bit "
                            f"({case})")
            outs[name] = (got, got_cov)
            row[name] = {
                "bit_exact": exact, "max_abs_err": err,
                "covered": int(got_cov.sum()),
                **_time_kernel(torch, wrapper, depth, vt, ut, mt),
                "plain_ms": _time_ms(
                    torch, lambda: plain(depth, vt, ut, mt), iters=10),
            }
        (a, a_cov), (b, b_cov) = outs.values()
        _require(bool(torch.equal(a, b) and torch.equal(a_cov, b_cov)),
                 f"the two kernels agree bit for bit ({case})")
        rows.append(row)
    _check_odd_rows(torch, wg, depth, rng)
    clipped = rows[1]["gather_depth_window"]["covered"]
    _require(clipped < rows[1]["valid"], "spread-400 case clips something")
    _emit({"phase": "kernel", "H": H, "W": W, "V": V, "cases": rows})
    return rows, worst


def _run_port(torch, cfg, depths, device):
    from voxelhashing_demo_tpu_torch.models import hash_slam

    slam = hash_slam.HashSLAM(cfg, device=device)
    for d in depths:
        slam.process(d)
    return slam


def phase_parity(torch):
    """Port on the card vs the port on the CPU, tiny flagship config."""
    from voxelhashing_demo_tpu_torch.config import (flagship_gather_config,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, camera=tiny_config().camera,
        hash=dataclasses.replace(base.hash, num_buckets=4096,
                                 num_blocks=4096, max_active=2048,
                                 max_new_per_frame=2048),
    )
    depths, _ = synthetic.make_sequence(cfg.camera, 10, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    cpu = _run_port(torch, cfg, depths, "cpu")
    gpu = _run_port(torch, cfg, depths, "cuda")
    diff = max(float((a.cpu() - b)[:3, 3].abs().max())
               for a, b in zip(gpu.trajectory, cpu.trajectory))
    same_tracked = all(bool(a.tracked) == bool(b.tracked)
                       for a, b in zip(gpu.infos, cpu.infos))
    _emit({"phase": "parity", "frames": len(depths),
           "max_pose_trans_diff_m": diff, "atol_m": PARITY_ATOL_M,
           "same_tracked": same_tracked})
    _require(same_tracked, "same tracked flags on card and CPU")
    _require(diff <= PARITY_ATOL_M, "card pose within 1e-4 m of CPU pose")


def _drive(torch, wg, slam, depths):
    """Process the frames; returns (per-frame ms, K1 launches per frame).
    The launch count starts at 0 here."""
    wg.LAUNCHES = 0
    frame_ms, launches = [], []
    for d in depths:
        before = wg.LAUNCHES
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        slam.process(d)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        launches.append(wg.LAUNCHES - before)
    return frame_ms, launches


def _run_stats(slam, gt, frame_ms, launches) -> dict:
    from voxelhashing_demo_tpu_torch.utils import metrics

    poses = [p.cpu().numpy() for p in slam.trajectory]
    return {
        "frames": len(poses),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "finite_poses": all(np.isfinite(p).all() for p in poses),
        "ate_mm": metrics.ate_rmse(poses, gt, align=False) * 1000.0,
        "active_blocks": int(slam.infos[-1].blocks_active),
        "blocks_allocated": int(sum(int(i.blocks_allocated)
                                    for i in slam.infos)),
        "blocks_freed": int(sum(int(i.blocks_freed) for i in slam.infos)),
        "kernel_launches": sum(launches),
        "launches_per_frame": launches,
        "frame_ms_p50": float(np.percentile(frame_ms, 50)),
        "frame_ms_max": float(np.max(frame_ms)),
        "frame_ms": frame_ms,
    }


def _check_run(stats: dict, hit: float, ate_bound_mm: float,
               hit_bound: float) -> None:
    n = stats["frames"]
    _require(all(k > 0 for k in stats["launches_per_frame"]),
             "kernel launched on every integrating frame")
    _require(stats["tracked"] >= n - 1, f">= {n - 1}/{n} frames tracked")
    _require(stats["finite_poses"], "finite poses")
    _require(stats["ate_mm"] < ate_bound_mm,
             f"unaligned ATE < {ate_bound_mm} mm")
    _require(hit > hit_bound, f"render hit fraction > {hit_bound}")


def phase_slice(torch, wg):
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = flagship_gather_config()
    # the first N_FRAMES of the 20-frame orbit the JAX reference ran
    depths, gt = synthetic.make_sequence(
        cfg.camera, JAX_REFERENCE["frames"], trans_amp=0.05,
        rot_amp_deg=2.5)
    depths, gt = depths[:N_FRAMES], gt[:N_FRAMES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = hash_slam.HashSLAM(cfg)
    frame_ms, launches = _drive(torch, wg, slam, depths)
    hit = float(slam.render().hit.float().mean())
    stats = _run_stats(slam, gt, frame_ms, launches)
    _emit({"phase": "slice", "H": H, "W": W, **stats, "hit_frac": hit,
           "note": f"first {N_FRAMES} of the reference's 20 frames",
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "jax_reference": JAX_REFERENCE})
    _check_run(stats, hit, ATE_BOUND_MM, HIT_BOUND)
    return stats["kernel_launches"]


def median_ms(torch, fn, reps: int = 5) -> float:
    """Median time of ``fn`` over ``reps`` runs after one warm-up (CUDA
    events, synchronised after each run)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def march_stage_ms(torch, cfg, state, active) -> dict:
    """The march prediction alone on ``state``: the cache build, and the
    cache build plus the sphere trace.  chip_profile.py times the same
    stage through this function."""
    from voxelhashing_demo_tpu_torch.ops import hash_raycast

    dims = cfg.raycast.cache_dims
    return {
        "densify": median_ms(torch, lambda: hash_raycast.densify_active(
            state.hmap, active, cfg.hash, cfg.fusion, state.pose, dims)),
        "densify_and_march": median_ms(
            torch, lambda: hash_raycast.raycast_hash(
                state.hmap, active, cfg.hash, state.pose, cfg.camera,
                cfg.raycast, cfg.fusion, cache_dims=dims)),
    }


def phase_march(torch, wg):
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.utils import (meshing, pointcloud,
                                                   synthetic)

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, raycast=dataclasses.replace(base.raycast, mode="march"))
    depths, gt = synthetic.make_room_sweep(
        cfg.camera, N_MARCH, sweep_deg=40.0, noise_seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slam = hash_slam.HashSLAM(cfg)
    frame_ms, launches = _drive(torch, wg, slam, depths)
    stats = _run_stats(slam, gt, frame_ms, launches)
    peak = int(torch.cuda.max_memory_allocated())

    out = slam.render(slam.state.pose)
    hit = float(out.hit.float().mean())
    _require(bool(torch.isfinite(out.depth).all()
                  and torch.isfinite(out.normals).all()),
             "finite render")
    st = slam.state
    stage_ms = march_stage_ms(
        torch, cfg, st, hash_ops.compact_visible(
            st.hmap, cfg.hash, st.pose, cfg.camera, cfg.fusion))

    t0 = time.perf_counter()
    pts, normals, _ = pointcloud.extract_surface_points(
        slam.state.hmap, cfg.hash, cfg.fusion, with_normals=True)
    t1 = time.perf_counter()
    verts, faces = meshing.extract_mesh(slam.state.hmap, cfg.hash,
                                        cfg.fusion)
    t2 = time.perf_counter()
    # the map's world frame is the first camera frame; room_sdf lives in
    # the sweep's own frame
    T0 = synthetic.room_sweep_pose(0.0, 40.0).astype(np.float64)
    room_pts = pts.astype(np.float64) @ T0[:3, :3].T + T0[:3, 3]
    dist = synthetic.room_sdf(
        torch.as_tensor(room_pts, dtype=torch.float32)).abs().numpy()
    median_dist = float(np.median(dist)) if len(dist) else float("nan")
    _emit({
        "phase": "march", "H": H, "W": W, **stats, "hit_frac": hit,
        "stage_ms": stage_ms,
        "frame_ms_p50_less_march":
            stats["frame_ms_p50"] - stage_ms["densify_and_march"],
        "peak_mem_bytes": peak,
        "points": int(len(pts)), "vertices": int(len(verts)),
        "faces": int(len(faces)),
        "points_median_dist_m": median_dist,
        "extract_points_s": t1 - t0, "extract_mesh_s": t2 - t1,
        "jax_reference": JAX_REFERENCE_MARCH,
    })
    _check_run(stats, hit, 2.0 * JAX_REFERENCE_MARCH["ate_mm"],
               JAX_REFERENCE_MARCH["hit_frac"] - 0.1)
    _require(len(pts) > 0 and len(verts) > 0 and len(faces) > 0,
             "non-empty point cloud and mesh")
    _require(bool(np.isfinite(pts).all() and np.isfinite(normals).all()
                  and np.isfinite(verts).all()),
             "finite points, normals and vertices")
    _require(len(verts) == 3 * len(faces), "triangle soup: V == 3 F")
    _require(median_dist < 3 * cfg.fusion.voxel_size,
             "median point distance to the room's surface < 3 voxels")
    return slam, depths[-1], stats["kernel_launches"]


def phase_streamed_entry(torch, wg, slam, depth_raw):
    """The streamed gather through its public entry point, on the gather
    inputs the frame step itself produces: the visible rows at the final
    pose (a row count no one chose), projected as integrate projects
    them.  Its result must equal the first kernel's on the same inputs."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models.hash_slam import depth_tensor
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops

    cfg, st = slam.config, slam.state
    frame = pre_ops.preprocess(depth_tensor(depth_raw, slam.device),
                               cfg.camera, cfg.frontend)
    active = hash_ops.compact_visible(st.hmap, cfg.hash, st.pose,
                                      cfg.camera, cfg.fusion)
    n = int(active.count)
    _, v, u, in_img, row_valid = hash_ops.project_rows(
        active.blocks[:n], active.ptrs[:n], cfg.hash, se3.inverse(st.pose),
        cfg.camera, cfg.fusion)
    args = (frame.depth.contiguous(), v.contiguous(), u.contiguous(),
            (in_img & row_valid[:, None]).contiguous())
    wg.LAUNCHES_STREAMED = 0
    calls = 4
    for _ in range(calls):
        got, got_cov = wg.gather_depth_window_streamed(*args)
    torch.cuda.synchronize()
    launches = wg.LAUNCHES_STREAMED
    ref, ref_cov = wg.gather_depth_window(*args)
    plain, plain_cov = wg.gather_depth_window_streamed_reference(*args)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref) and torch.equal(got_cov, ref_cov)
                and torch.equal(got, plain)
                and torch.equal(got_cov, plain_cov))
    _emit({"phase": "streamed_entry", "rows": n, "calls": calls,
           "launches": launches, "covered": int(got_cov.sum()),
           "equals_first_kernel_and_plain": same})
    _require(launches == calls, "one streamed launch per call")
    _require(same, "streamed entry point == first kernel == plain version")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import window_gather as wg

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _emit({"phase": "device", "name": name, "nvidia_smi": smi,
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build_all()
    for lib in kernels.KERNELS:
        kernels.load(lib)
    _emit({"phase": "build", "kernels": sorted(built),
           "seconds": time.perf_counter() - t0})

    rows, worst = phase_kernel(torch, wg)
    phase_parity(torch)
    # launches per path, each counted from 0 by the phase that drives it;
    # "launches" in the summary is the last path's count
    by_path = {"gather_depth_window": {"slice": phase_slice(torch, wg)}}
    slam, last_depth, march_launches = phase_march(torch, wg)
    by_path["gather_depth_window"]["march"] = march_launches
    by_path["gather_depth_window_streamed"] = {
        "streamed_entry": phase_streamed_entry(torch, wg, slam, last_depth)}

    full = rows[0]        # C = 4096, spread 120
    _emit({"kernels": [{
        "name": kname, **meta,
        "launches": list(by_path[kname].values())[-1],
        "launches_by_path": by_path[kname],
        "max_abs_err": worst[kname],
        "ms": full[kname]["ms"],
        "cold_ms": full[kname]["cold_ms"],
        "wrapper_ms": full[kname]["wrapper_ms"],
        "plain_ms": full[kname]["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
    } for kname, meta in KERNEL_META.items()]})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
