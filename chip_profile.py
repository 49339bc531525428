#!/usr/bin/env python3
"""Where a frame's time goes in the PyTorch port, on one CUDA card.

Run from the repository root: ``python3 chip_profile.py
[splat|march|backend|stream]`` (default: splat and march).  ``backend``
and ``stream`` are described at the end.  For each surface-prediction mode it drives 24 frames of
the noisy room sweep (``make_room_sweep(cam, 24, sweep_deg=40,
noise_seed=1)``, the frames of chip_smoke's ``march`` phase) through
``HashSLAM(flagship_gather_config())`` and prints one JSON line with:

- ``frame_ms``: per-frame time of frames 8-15, unprofiled (CUDA events
  around ``process``, synchronised per frame);
- ``profile``: ``torch.profiler`` over frames 16-23: device kernels and
  copies per frame, device busy time per frame, the idle share of the
  device against the unprofiled p50 frame, the largest entries by device
  time, and the window-gather kernel's own entry (its duration alone, at
  the row count the frames give it);
- ``stages``: each stage of the step timed alone on frame 16 against a
  copy of the state after frame 15, before the profiler is started
  (median of 5 runs, CUDA events, synchronised): preprocess, ICP, fuse
  (allocate / compact + touch / integrate), and the surface prediction
  (splat, or cache build + march through chip_smoke's
  ``march_stage_ms``, the one timer of that stage: K12 and K11 beside
  their plain versions on the same state), with the
  window-gather launches made by one fuse.

``backend`` drives chip_smoke's backend scenario (48 noisy room-sweep
frames with two injected drifts through ``KeyframeSLAM``) twice: once
unprofiled for host times (per frame by class: plain, keyframe insert, BA
event), once under ``torch.profiler`` for the device's events and busy time
over the whole run, the idle share against the unprofiled wall time, and
the window-gather kernel's launches.

``stream`` drives chip_smoke's ``stream`` regime (the 201-frame noisy
out-and-back through the streaming ``HashSLAM`` with a 2048-block map)
twice.  First with the streaming cycle's pieces timed on the host clock,
the device synchronised before and after each piece: frame ms by class
(the frame whose ``process`` runs the cycle's dispatch, the one that runs
its completion, the rest) and, per class, the pieces (dispatch: restore,
eviction scan, start of the copy out; completion: the wait on that copy,
the store's take / add, the frustum query, packing and upload), the rest
of the frame being the step.  Then, on a fresh instance, frames up to
``STREAM_PROFILE_AT`` unprofiled and the next cycle (``interval`` frames)
under ``torch.profiler`` frame by frame: device events and busy ms of each
class's frame.

It needs a CUDA card and exits nonzero without one.  The card's name and
power limit are printed first.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np

from chip_smoke import march_stage_ms, median_ms

N_FRAMES = 24
WARM, PROFILED = 8, 16        # frames [8, 16) timed, [16, 24) profiled


def _copy_state(state):
    """The state with its map's tensors cloned: the stage timings update
    the copy in place and leave the run's own map alone."""
    hmap = type(state.hmap)(*(t.clone() for t in state.hmap))
    return state._replace(hmap=hmap)


def _stages(torch, slam, depth_raw) -> dict:
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import icp as icp_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.ops import splat as splat_ops

    cfg, st = slam.config, _copy_state(slam.state)
    cam, hcfg, fus = cfg.camera, cfg.hash, cfg.fusion
    raw = hash_slam.depth_tensor(depth_raw, slam.device)
    frame = pre_ops.preprocess(raw, cam, cfg.frontend)
    active = hash_ops.compact_visible(st.hmap, hcfg, st.pose, cam, fus)
    out = {
        "preprocess": median_ms(
            torch, lambda: pre_ops.preprocess(raw, cam, cfg.frontend)),
        "icp": median_ms(torch, lambda: icp_ops.icp_align_pyramid(
            frame.depth, st.model.depth, cam, cfg.icp, src_full=frame,
            tgt_full=st.model, prior_T=st.vel)),
        "allocate": median_ms(torch, lambda: hash_ops.allocate_from_frame(
            st.hmap, frame, st.pose, cam, hcfg, fus, st.frame_idx)),
        "compact_touch": median_ms(torch, lambda: hash_ops.touch_active(
            st.hmap, hash_ops.compact_visible(st.hmap, hcfg, st.pose, cam,
                                              fus), st.frame_idx)),
        "integrate": median_ms(torch, lambda: hash_ops.integrate(
            st.hmap, active, hcfg, frame.depth, st.pose, cam, fus)),
    }
    before = hash_ops.LAUNCHES_INTEGRATE_WINDOW
    hash_ops.fuse_frame(st.hmap, frame, st.pose, cam, hcfg, fus,
                        st.frame_idx)
    # the window gather runs inside K7 (csrc/fuse.cu) on the card
    out["gather_launches_per_fuse"] = (hash_ops.LAUNCHES_INTEGRATE_WINDOW
                                       - before)
    if cfg.raycast.mode == "splat":
        out["splat"] = median_ms(torch, lambda: splat_ops.splat_raycast(
            st.hmap, active, hcfg, st.pose, cam, cfg.raycast, fus))
    else:
        out.update(march_stage_ms(torch, cfg, st, active))
    out["active_blocks"] = int(active.count)
    return out


def _profile(torch, slam, depths, frame_p50_ms: float, run=None) -> dict:
    """Profile ``run()`` (default: ``slam.process`` over ``depths``);
    per-frame figures divide by ``len(depths)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if run is None:
            for d in depths:
                slam.process(d)
        else:
            run()
        torch.cuda.synchronize()
    by_name, n_events, busy_us = {}, 0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        n_events += 1
        busy_us += us
        cnt, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, tot + us)
    n = len(depths)
    busy_ms = busy_us / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    gather = [{"name": k[:80], "per_frame": c / n, "us_per_launch": t / c}
              for k, (c, t) in by_name.items()
              if "window_gather" in k or "integrate_rows" in k]
    return {
        "frames": n,
        "window_gather": gather,
        "device_events_per_frame": n_events / n,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1.0 - busy_ms / frame_p50_ms,
        "top": [{"name": k[:80], "per_frame": c / n,
                 "ms_per_frame": t / 1e3 / n,
                 "share_of_busy": t / busy_us} for k, (c, t) in top],
    }


def run_mode(torch, mode: str, depths) -> None:
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, raycast=dataclasses.replace(base.raycast, mode=mode))
    slam = hash_slam.HashSLAM(cfg)
    frame_ms = []
    for i, d in enumerate(depths[:PROFILED]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        slam.process(d)
        end.record()
        torch.cuda.synchronize()
        if i >= WARM:
            frame_ms.append(start.elapsed_time(end))
    p50 = float(np.percentile(frame_ms, 50))
    stages = _stages(torch, slam, depths[PROFILED])
    prof = _profile(torch, slam, depths[PROFILED:], p50)
    print(json.dumps({
        "mode": mode,
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "frame_ms": {"p50": p50, "max": float(np.max(frame_ms)),
                     "frames": frame_ms},
        "profile": prof, "stages": stages,
    }), flush=True)


def run_backend(torch) -> None:
    import time

    import chip_smoke
    from voxelhashing_demo_tpu_torch.models import keyframe_slam
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = chip_smoke.backend_config()
    depths, _ = synthetic.make_room_sweep(
        cfg.camera, chip_smoke.N_BACKEND,
        sweep_deg=chip_smoke.BACKEND_SWEEP_DEG, noise_seed=1)

    def warmed():
        slam = keyframe_slam.KeyframeSLAM(cfg)
        slam.warm_compile(depths[0])
        torch.cuda.synchronize()
        return slam

    def drive(slam):
        t0 = time.perf_counter()
        frame_ms = chip_smoke.backend_drive(torch, slam, depths)
        slam.flush()
        torch.cuda.synchronize()
        return frame_ms, (time.perf_counter() - t0) * 1e3

    slam = warmed()
    frame_ms, wall_ms = drive(slam)
    kf = {r.frame_index for r in slam.keyframes}
    ba = {e["frame"] for e in slam.ba_events}
    cls = {"plain": [], "keyframe_insert": [], "ba_event": []}
    for i, ms in enumerate(frame_ms):
        cls["ba_event" if i in ba else "keyframe_insert" if i in kf
            else "plain"].append(ms)
    n = len(depths)
    second = warmed()
    prof = _profile(torch, None, depths, wall_ms / n,
                    run=lambda: drive(second))
    print(json.dumps({
        "mode": "backend", "frames": n, "wall_ms": wall_ms,
        "keyframes": len(kf), "ba_events": len(ba),
        "map_updates": [(e["frame"], e["rebuild_mode"],
                         e["keyframes_reintegrated"])
                        for e in slam.ba_events if e["map_rebuilt"]],
        "frame_ms_by_class": {k: {"n": len(v),
                                  "p50": float(np.median(v)),
                                  "max": float(np.max(v))}
                              for k, v in cls.items() if v},
        "profile": prof,
    }), flush=True)


STREAM_PROFILE_AT = 120     # the return leg: restores are running


def run_stream(torch) -> None:
    import time

    import chip_smoke
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg = chip_smoke.stream_config(chip_smoke.STREAM)
    s = cfg.stream
    depths, _ = chip_smoke.out_and_back(cfg.camera)

    def frame_class(slam):
        i = len(slam.trajectory) % s.interval
        return ("dispatch" if i == 0 else
                "completion" if i == max(s.interval // 2, 1) else "plain")

    laps = {}

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            laps.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, wrapper)
        return fn

    slam = hash_slam.HashSLAM(cfg)
    slam.warm_stream()
    timed(slam, "_restore_uploaded", "dispatch.restore")
    real_evict = timed(hash_ops, "evict_stale", "dispatch.evict")
    timed(slam._xfer, "pull", "dispatch.copy_out_start")
    timed(slam._xfer, "pulled", "completion.wait_copy_out")
    timed(slam.store, "take", "completion.store_take")
    timed(slam.store, "add", "completion.store_add")
    timed(slam.store, "query_frustum", "completion.query")
    timed(slam, "_pack_restore", "completion.pack_upload")
    timed(slam, "_cycle_dispatch", "dispatch.total")
    timed(slam, "_complete_work", "completion.total")
    frames = {"dispatch": [], "completion": [], "plain": []}
    try:
        for d in depths:
            cls = frame_class(slam)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam.process(d)
            torch.cuda.synchronize()
            frames[cls].append((time.perf_counter() - t0) * 1e3)
    finally:
        hash_ops.evict_stale = real_evict

    def pct(v):
        return {"n": len(v), "p50": float(np.median(v)),
                "p99": float(np.percentile(v, 99)), "max": float(np.max(v))}

    second = hash_slam.HashSLAM(cfg)
    second.warm_stream()
    for d in depths[:STREAM_PROFILE_AT]:
        second.process(d)
    torch.cuda.synchronize()
    prof = {}
    for d in depths[STREAM_PROFILE_AT:STREAM_PROFILE_AT + s.interval]:
        cls = frame_class(second)
        p = _profile(torch, second, [d], float(np.median(frames[cls])))
        prof.setdefault(cls, []).append({
            k: p[k] for k in ("device_events_per_frame",
                              "device_busy_ms_per_frame",
                              "device_idle_share", "window_gather")})
        if cls != "plain":
            prof[cls][-1]["top"] = p["top"][:8]
    print(json.dumps({
        "mode": "stream", "frames": len(depths),
        "evicted": slam.store.total_evicted,
        "restored": slam.store.total_restored,
        "frame_ms_by_class": {k: pct(v) for k, v in frames.items()},
        "pieces_ms": {k: pct(v) for k, v in sorted(laps.items())},
        "profile_at": STREAM_PROFILE_AT, "profile": prof,
    }), flush=True)


def main(modes) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA card; none is available",
              file=sys.stderr)
        return 2
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import CameraConfig
    from voxelhashing_demo_tpu_torch.utils import synthetic

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    kernels.build_all()
    depths, _ = synthetic.make_room_sweep(CameraConfig(), N_FRAMES,
                                          sweep_deg=40.0, noise_seed=1)
    for mode in modes:
        if mode == "backend":
            run_backend(torch)
        elif mode == "stream":
            run_stream(torch)
        else:
            run_mode(torch, mode, depths)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["splat", "march"]))
