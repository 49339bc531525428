"""Command-line entry point, the port's application layer (port of cli.py).

    python -m voxelhashing_demo_tpu_torch demo  t0.png t1.png --out out/
        two-frame pipeline: preprocess, align, fuse, dump, render
    python -m voxelhashing_demo_tpu_torch run   --dataset DIR | --synthetic N
        full SLAM over a TUM / ICL-NUIM / ScanNet sequence or a synthetic
        scene; trajectory, metrics, checkpoint, renders; ``--resume``
    python -m voxelhashing_demo_tpu_torch render --checkpoint ck.npz --orbit 12
        offline orbit renders of a saved map, PLY point cloud and mesh
    python -m voxelhashing_demo_tpu_torch info  --checkpoint ck.npz
        checkpoint summary (map occupancy, trajectory length)
    python -m voxelhashing_demo_tpu_torch evaluate --est T.txt --gt G.txt
        ATE / RPE of a TUM-format trajectory

The subcommands take the JAX CLI's flags and defaults and print its one
JSON line, with the same keys.  ``--device`` (default ``cuda``) is the
device everything runs on; ``--device cpu`` runs on the CPU.  ``run
--devices N`` shards the map over N ranks (parallel/sharded.py), one
process each (parallel/launch.py): over NCCL with a CUDA card per rank
(fewer cards exit with a message naming both counts), over Gloo with
``--device cpu``.  Rank 0 alone writes the outputs and the JSON line.
``bench [--quick]`` runs the package's benchmark (its bench.py) on
``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time

import numpy as np

# Standard TUM RGB-D camera calibrations (ROS defaults per sequence
# family, vision.in.tum.de/data/datasets/rgbd-dataset/file_formats).
INTRINSIC_PRESETS = {
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
}


def _default_config(args) -> "PipelineConfig":
    from .config import (CameraConfig, GCConfig, HashConfig, ICPConfig,
                         KeyframeConfig, PipelineConfig, StreamConfig)

    cam = CameraConfig()
    preset = getattr(args, "preset", "")
    if preset:
        fx, fy, cx, cy = INTRINSIC_PRESETS[preset]
        cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy)
    if getattr(args, "intrinsics", ""):
        vals = [float(v) for v in args.intrinsics.split(",")]
        if len(vals) != 4:
            raise SystemExit("--intrinsics expects FX,FY,CX,CY")
        cam = dataclasses.replace(cam, fx=vals[0], fy=vals[1], cx=vals[2],
                                  cy=vals[3])
    if args.small:
        # quarter resolution of whatever calibration was selected above
        cam = cam.scaled(4)
    stream = StreamConfig(enabled=bool(getattr(args, "stream", False)))
    kf = KeyframeConfig()
    if getattr(args, "kf_rotation", None) is not None:
        kf = dataclasses.replace(kf, min_rotation_deg=args.kf_rotation)
    if getattr(args, "kf_translation", None) is not None:
        kf = dataclasses.replace(kf, min_translation=args.kf_translation)
    return PipelineConfig(
        camera=cam,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(10, 5, 4)),
        hash=HashConfig(num_buckets=65536, bucket_size=4, num_blocks=65536,
                        max_active=4096, max_new_per_frame=4096,
                        candidate_stride=2),
        gc=GCConfig(enabled=True, interval=8),
        keyframes=kf,
        stream=stream,
    )


def _emit(result: dict) -> None:
    print(json.dumps(result))


# --------------------------------------------------------------------------
# demo: two-frame pipeline
# --------------------------------------------------------------------------

def cmd_demo(args) -> None:
    import torch

    from .device import host_array, resolve
    from .models import hash_slam
    from .ops import icp as icp_ops
    from .ops import preprocess as pre_ops
    from .utils import checkpoint as ck
    from .utils import io as depth_io
    from .utils import synthetic, viz

    device = resolve(args.device)
    config = _default_config(args)
    cam = config.camera
    os.makedirs(args.out, exist_ok=True)

    if args.frames:
        t0 = depth_io.read_depth_png(args.frames[0])
        t1 = depth_io.read_depth_png(args.frames[1])
    else:
        depths, _ = synthetic.make_sequence(cam, 2, trans_amp=0.04,
                                            rot_amp_deg=2.0, device=device)
        t0, t1 = depths[0], depths[1]

    d0 = hash_slam.depth_tensor(t0, device)
    d1 = hash_slam.depth_tensor(t1, device)
    f0 = pre_ops.preprocess(d0, cam)
    f1 = pre_ops.preprocess(d1, cam)
    res = icp_ops.icp_align(f1, f0, cam, config.icp)

    slam = hash_slam.HashSLAM(config, device=device)
    slam.process(d0)
    slam.process(d1)

    n_blocks = ck.dump_sdf(
        os.path.join(args.out, "SDF_dump.txt"), slam.state.hmap, config.hash
    )
    out = slam.render()
    viz.write_png_rgb(os.path.join(args.out, "render.png"),
                      viz.shade_rgb(out))
    viz.write_png_rgb(os.path.join(args.out, "normals.png"),
                      viz.normal_rgb(out.normals, out.hit))
    vals = host_array(torch.cat([
        res.transform[:3, 3], res.count.to(torch.float32).reshape(1),
        res.error.to(torch.float32).reshape(1)]))
    _emit({
        "command": "demo",
        "icp_inliers": int(vals[3]),
        "icp_error": float(vals[4]),
        "relative_translation_m": [float(x) for x in vals[:3]],
        "occupied_blocks": n_blocks,
        "outputs": ["SDF_dump.txt", "render.png", "normals.png"],
    })


# --------------------------------------------------------------------------
# run: full SLAM over a sequence
# --------------------------------------------------------------------------

def _load_dataset(args, config):
    """(config, frames, gt poses | None, timestamps | None, TUM paths |
    None) of ``--dataset``: TUM (depth.txt), extracted ScanNet (depth/) or
    native ICL-NUIM (*.depth), detected in that order.  A TUM sequence is
    returned as its paths (streamed later); the others as frames."""
    cam = config.camera
    root = args.dataset
    has_tum_list = os.path.exists(os.path.join(root, "depth.txt"))
    is_scannet = not has_tum_list and os.path.isdir(
        os.path.join(root, "depth"))
    is_icl = not has_tum_list and not is_scannet and bool(
        glob.glob(os.path.join(root, "*.depth")))
    if is_scannet:
        # the per-scene intrinsic file is authoritative: it carries the mm
        # depth scale and calibration the engine must run with
        from .utils import scannet as scannet_mod

        seq = scannet_mod.ScanNetSequence(root, max_frames=args.max_frames)
        config = dataclasses.replace(config, camera=seq.cam)
        depths, gt = seq.load_all()
        if not seq.has_gt or any(p is None for p in gt):
            gt = None
        return config, depths, gt, None, None
    if is_icl:
        # the configured camera is kept when its resolution matches the
        # files; a 640x480 dataset takes the ICL calibration
        from .utils import icl as icl_mod

        first = sorted(glob.glob(os.path.join(root, "*.depth")))[0]
        with open(first) as f:
            n_vals = len(f.read().split())
        if n_vals != cam.width * cam.height:
            icam = icl_mod.icl_camera()
            if n_vals != icam.width * icam.height:
                raise SystemExit(
                    f"{first}: {n_vals} values match neither the "
                    f"configured {cam.width}x{cam.height} nor ICL's "
                    f"{icam.width}x{icam.height}"
                )
            config = dataclasses.replace(config, camera=icam)
            cam = icam
        seq = icl_mod.ICLSequence(root, cam=cam, max_frames=args.max_frames)
        depths, gt = seq.load_all()
        return config, depths, gt, None, None
    from .utils import tum as tum_mod

    seq = tum_mod.TUMSequence(root, max_frames=args.max_frames)
    paths = [os.path.join(root, rel) for _, rel, _ in seq.entries]
    timestamps = [t for t, _, _ in seq.entries]
    gt = [p for _, _, p in seq.entries] if seq.has_gt else None
    return config, None, gt, timestamps, paths


def cmd_run(args) -> None:
    if args.devices <= 1:
        _emit(_run(args))
        return
    from .parallel import distributed, launch

    try:
        backend = distributed.choose_backend(args.devices, None, args.device)
    except ValueError as e:
        raise SystemExit(f"--devices {args.devices}: {e}") from None
    _emit(launch.spawn(_run_rank, args.devices, backend, args.device, None,
                       args)[0])


def _run_rank(mesh, args) -> dict:
    """One rank of ``run --devices N`` (parallel/launch.py)."""
    return _run(args, mesh)


def _run(args, mesh=None) -> dict:
    """The ``run`` command on one device or, under ``mesh``, on this rank;
    returns the JSON line's dict.  Only rank 0 writes files."""
    import torch

    from .device import host_array, resolve
    from .models import hash_slam, keyframe_slam
    from .parallel import sharded
    from .utils import checkpoint as ck
    from .utils import metrics, stream, synthetic, viz

    device = resolve(args.device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    config = _default_config(args)
    if writer:
        os.makedirs(args.out, exist_ok=True)

    timestamps = paths = None
    if args.dataset:
        config, depths, gt, timestamps, paths = _load_dataset(args, config)
    else:
        n = args.synthetic or 30
        depths, gt = synthetic.make_sequence(config.camera, n,
                                             trans_amp=0.10,
                                             rot_amp_deg=5.0, device=device)

    resumed_frames = 0
    if args.resume:
        # restart from a checkpoint: the remaining frames of the sequence
        # continue the restored state (gt stays whole: the final ATE
        # compares the restored + new trajectory against it)
        if args.backend == "keyframe":
            slam = ck.load_keyframe_slam(args.resume, mesh, device=device)
            resumed_frames = len(slam._frame_refs)
        else:
            slam = (ck.load_slam(args.resume, device=device)[0]
                    if mesh is None
                    else ck.load_sharded_slam(args.resume, mesh))
            resumed_frames = len(slam.trajectory)
        config = slam.config
        if depths is not None:
            depths = depths[resumed_frames:]
    elif args.backend == "keyframe":
        slam = keyframe_slam.KeyframeSLAM(config, mesh=mesh, device=device)
    elif mesh is not None:
        slam = sharded.ShardedHashSLAM(config, mesh)
    else:
        slam = hash_slam.HashSLAM(config, device=device)
    cam = config.camera
    if paths is not None:
        # TUM: decoded and staged on the device by the pipeline's producer
        depths = stream.FramePipeline(paths[resumed_frames:], cam.width,
                                      cam.height, device=device)

    def _save(name):
        # every rank saves together (the shards are gathered)
        if args.backend == "keyframe":
            ck.save_keyframe_slam(os.path.join(args.out, name), slam)
        else:
            ck.save_slam(os.path.join(args.out, name), slam)

    # the per-frame scalars are stacked on the device (no fetch) and
    # fetched once, after the clock stops
    infos = []
    sat_frames = set()
    live_frames = []
    t0 = time.perf_counter()
    for i, d in enumerate(depths):
        info = slam.process(d)
        infos.append(torch.stack([
            info.tracked.to(torch.float32), info.icp_error.to(torch.float32),
            info.icp_iters.to(torch.float32),
            info.blocks_allocated.to(torch.float32),
            info.blocks_active.to(torch.float32),
            info.blocks_freed.to(torch.float32),
        ]))
        if getattr(slam, "saturated", False):
            sat_frames.add(i)
        if args.render_every and (i + 1) % args.render_every == 0:
            name = f"live_{resumed_frames + i:05d}.png"
            out = _render(slam, mesh)
            if writer:
                viz.write_png_rgb(os.path.join(args.out, name),
                                  viz.shade_rgb(out))
            live_frames.append(name)
        if (
            args.checkpoint_every
            and args.checkpoint
            and (i + 1) % args.checkpoint_every == 0
        ):
            _save(args.checkpoint)
    if hasattr(slam, "flush"):
        slam.flush()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    stats = (host_array(torch.stack(infos)) if infos
             else np.zeros((0, 6), np.float32))
    records = []
    for i in range(stats.shape[0]):
        rec = {
            "frame": resumed_frames + i,
            "tracked": bool(stats[i, 0] > 0.5),
            "icp_error": float(stats[i, 1]),
            "icp_iters": int(stats[i, 2]),
            "blocks_allocated": int(stats[i, 3]),
            "blocks_active": int(stats[i, 4]),
            "blocks_freed": int(stats[i, 5]),
        }
        if i in sat_frames:
            # keyframe backend at graph capacity with growth disabled
            rec["backend_saturated"] = True
        records.append(rec)

    if args.backend == "keyframe":
        trajectory = slam.trajectory()
    else:
        trajectory = (list(host_array(torch.stack(slam.trajectory)))
                      if slam.trajectory else [])
    if writer:
        ck.export_trajectory_tum(
            os.path.join(args.out, "trajectory.txt"), trajectory,
            timestamps=timestamps[: len(trajectory)] if timestamps else None,
        )
        with open(os.path.join(args.out, "metrics.jsonl"), "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")

    result = {
        "command": "run",
        "frames": len(depths),
        "fps": round(len(depths) / dt, 2),
        "tracked_frames": sum(r["tracked"] for r in records),
    }
    if gt is not None and all(p is not None for p in gt):
        gt_np = [np.asarray(p) for p in gt]
        result["ate_rmse_m"] = round(metrics.ate_rmse(trajectory, gt_np), 5)
        result["ate_rmse_unaligned_m"] = round(
            metrics.ate_rmse(trajectory, gt_np, align=False), 5
        )
        if len(trajectory) > 1:
            rpe_t, rpe_r = metrics.rpe(trajectory, gt_np, delta=1)
            result["rpe_trans_rmse_m"] = round(float(rpe_t), 6)
            result["rpe_rot_rmse_deg"] = round(float(rpe_r), 6)
    # the HashSLAM's store (the keyframe backend reports none, as in JAX)
    store = getattr(slam, "store", None)
    if store is not None:
        counts = [len(store), store.total_evicted, store.total_restored]
        if mesh is not None:
            # each rank holds its own store shard: report the ranks' total
            from .parallel import distributed

            counts = [distributed.psum_host(mesh, c) for c in counts]
        result["stream"] = dict(zip(("stored_blocks", "evicted", "restored"),
                                    counts))
    if args.backend == "keyframe":
        result["keyframes"] = len(slam.keyframes)
        result["graph_edges"] = int(slam.graph.num_edges)
        result["ba_runs"] = len(slam.ba_events)
        result["graph_capacity"] = {
            "keyframes": int(slam.graph.poses.shape[0]),
            "edges": int(slam.graph.edges_ij.shape[0]),
        }
        result["backend_saturated"] = bool(slam.saturated)
        if slam.capacity_events:
            result["capacity_events"] = slam.capacity_events
        if slam.relocalizations:
            result["relocalizations"] = slam.relocalizations
    if args.checkpoint:
        _save(args.checkpoint)
        result["checkpoint"] = args.checkpoint
    if live_frames:
        result["live_frames"] = len(live_frames)
    if args.render_last:
        out = _render(slam, mesh)
        if writer:
            viz.write_png_rgb(os.path.join(args.out, "final.png"),
                              viz.shade_rgb(out))
            viz.write_png_rgb(os.path.join(args.out, "final_depth.png"),
                              viz.depth_rgb(out.depth))
        result["renders"] = ["final.png", "final_depth.png"]
    return result


def _render(slam, mesh):
    """The live render at the current pose (the full image, assembled
    from the ranks' rows under a mesh: every rank calls this)."""
    from .parallel import sharded

    out = slam.render()
    return out if mesh is None else sharded.fetch_output(mesh, out)


# --------------------------------------------------------------------------
# render: offline orbit of a checkpointed map
# --------------------------------------------------------------------------

def cmd_render(args) -> None:
    from .device import host_array
    from .utils import checkpoint as ck
    from .utils import viz

    slam, _ = ck.load_slam(args.checkpoint, device=args.device)
    os.makedirs(args.out, exist_ok=True)

    pose0 = host_array(slam.state.pose)
    if args.orbit > 1:
        center = pose0[:3, 3] + pose0[:3, 2] * args.orbit_distance
        poses = viz.orbit_poses(center, args.orbit_distance,
                                height=-0.2, n_frames=args.orbit,
                                sweep_deg=args.sweep)
    else:
        poses = [pose0]

    names = []
    for i, T in enumerate(poses):
        name = f"orbit_{i:03d}.png"
        viz.write_png_rgb(os.path.join(args.out, name),
                          viz.shade_rgb(slam.render(T)))
        names.append(name)
    result = {"command": "render", "frames": names}
    if args.ply:
        from .utils import pointcloud

        n = pointcloud.export_map_ply(
            os.path.join(args.out, args.ply), slam.state.hmap,
            slam.config.hash, slam.config.fusion,
        )
        result["ply"] = {"file": args.ply, "points": n}
    if args.mesh:
        from .utils import meshing

        n = meshing.export_mesh_ply(
            os.path.join(args.out, args.mesh), slam.state.hmap,
            slam.config.hash, slam.config.fusion,
        )
        result["mesh"] = {"file": args.mesh, "faces": n}
    _emit(result)


def cmd_info(args) -> None:
    from .device import host_array
    from .utils import checkpoint as ck

    slam, graph = ck.load_slam(args.checkpoint, device=args.device)
    hmap = slam.state.hmap
    result = {
        "command": "info",
        "config": json.loads(ck.config_to_json(slam.config)),
        "occupied_blocks": int(np.sum(host_array(hmap.ptrs) >= 0)),
        "free_blocks": int(hmap.free_top),
        "frames_processed": int(slam.state.frame_idx),
        "trajectory_poses": len(slam.trajectory),
    }
    if graph is not None:
        result["graph"] = {
            "keyframes": int(graph.num_poses),
            "edges": int(graph.num_edges),
        }
    _emit(result)


def cmd_evaluate(args) -> None:
    """TUM-tooling-style trajectory evaluation: associate two TUM-format
    trajectory files by timestamp, report ATE RMSE and RPE."""
    from .utils import metrics, tum

    est_list = tum._parse_list(args.est)
    gt_list = tum._parse_list(args.gt)
    pairs = tum.associate(est_list, gt_list, max_dt=args.max_dt)
    if len(pairs) < 2:
        raise SystemExit(
            f"only {len(pairs)} timestamp associations (need >= 2)"
        )
    est = [tum.TUMSequence._pose_from(d) for _, d, _, _ in pairs]
    gt = [tum.TUMSequence._pose_from(g) for _, _, _, g in pairs]
    result = {
        "command": "evaluate",
        "pairs": len(pairs),
        "ate_rmse_m": round(metrics.ate_rmse(est, gt, align=True), 6),
        "ate_rmse_unaligned_m": round(
            metrics.ate_rmse(est, gt, align=False), 6
        ),
    }
    rpe_t, rpe_r = metrics.rpe(est, gt, delta=args.rpe_delta)
    result["rpe_trans_rmse_m"] = round(float(rpe_t), 6)
    result["rpe_rot_rmse_deg"] = round(float(rpe_r), 6)
    _emit(result)


def cmd_bench(args) -> None:
    from . import bench

    bench.main(["--quick"] if args.quick else [], device=args.device)


# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxelhashing_demo_tpu_torch",
        description="Dense SLAM engine, PyTorch + CUDA port",
    )
    p.add_argument("--small", action="store_true",
                   help="160x120 config for quick runs")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' for the CPU)")
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demo", help="two-frame pipeline (reference demo)")
    d.add_argument("frames", nargs="*", help="two 16-bit depth PNGs")
    d.add_argument("--out", default="demo_out")
    d.set_defaults(fn=cmd_demo)

    r = sub.add_parser("run", help="full SLAM over a sequence")
    r.add_argument("--preset", choices=sorted(INTRINSIC_PRESETS),
                   default="",
                   help="TUM camera calibration preset (freiburg1/2/3 "
                        "sequence families)")
    r.add_argument("--intrinsics", default="", metavar="FX,FY,CX,CY",
                   help="override the camera intrinsics (applied after "
                        "--preset; dataset-provided calibration, e.g. "
                        "ScanNet's intrinsic/ file, still wins)")
    r.add_argument("--dataset",
                   help="sequence directory: TUM (depth.txt), native "
                        "ICL-NUIM (*.depth), or extracted ScanNet "
                        "(depth/ + pose/ + intrinsic/), auto-detected")
    r.add_argument("--synthetic", type=int, metavar="N",
                   help="use N synthetic frames instead of a dataset")
    r.add_argument("--max-frames", type=int, default=None)
    r.add_argument("--backend", choices=("hash", "keyframe"),
                   default="hash")
    r.add_argument("--kf-rotation", type=float, default=None,
                   metavar="DEG",
                   help="keyframe insertion rotation threshold (degrees)")
    r.add_argument("--kf-translation", type=float, default=None,
                   metavar="M",
                   help="keyframe insertion translation threshold (meters)")
    r.add_argument("--devices", type=int, default=1,
                   help="devices to shard the map over, one rank each "
                        "(NCCL: a CUDA card per rank; Gloo with --device "
                        "cpu)")
    r.add_argument("--stream", action="store_true",
                   help="out-of-frustum block streaming to a host store "
                        "(scene size bounded by host RAM, not num_blocks)")
    r.add_argument("--out", default="run_out")
    r.add_argument("--checkpoint", default="map.npz",
                   help="checkpoint filename (empty to skip)")
    r.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N frames (restart story)")
    r.add_argument("--resume", default="",
                   help="restore a checkpoint and continue the sequence "
                        "from the frame after its last pose")
    r.add_argument("--render-last", action="store_true")
    r.add_argument("--render-every", type=int, default=0, metavar="N",
                   help="write a live view (live_FFFFF.png shaded render "
                        "of the current map) every N frames")
    r.set_defaults(fn=cmd_run)

    v = sub.add_parser("render", help="offline renders of a checkpoint")
    v.add_argument("--checkpoint", required=True)
    v.add_argument("--out", default="render_out")
    v.add_argument("--orbit", type=int, default=1)
    v.add_argument("--orbit-distance", type=float, default=1.5)
    v.add_argument("--sweep", type=float, default=60.0)
    v.add_argument("--ply", default="",
                   help="also export the surface point cloud (filename)")
    v.add_argument("--mesh", default="",
                   help="also export a triangle mesh (marching tetrahedra)")
    v.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="checkpoint summary")
    i.add_argument("--checkpoint", required=True)
    i.set_defaults(fn=cmd_info)

    e = sub.add_parser("evaluate",
                       help="ATE/RPE of a TUM-format trajectory vs GT")
    e.add_argument("--est", required=True,
                   help="estimated trajectory (TUM format, e.g. the run "
                        "command's trajectory.txt)")
    e.add_argument("--gt", required=True, help="ground truth (TUM format)")
    e.add_argument("--max-dt", type=float, default=0.02)
    e.add_argument("--rpe-delta", type=int, default=1)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench", help="run the throughput benchmark")
    b.add_argument("--quick", action="store_true",
                   help="the steady-state loop only")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)
