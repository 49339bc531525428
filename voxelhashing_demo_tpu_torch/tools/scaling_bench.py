"""Port of ``tools/scaling_bench.py``: frames/s of the sharded pipeline at
power-of-two rank counts, and the efficiency against one rank.

Each count ``n`` is one ``parallel/launch.spawn`` of ``n`` ranks (NCCL, a
CUDA card per rank; Gloo on the CPU with ``--cpu``).  Every rank builds
``ShardedHashSLAM`` under the JAX tool's configuration, uploads four
orbit frames, steps ``--warmup`` frames, then times ``--frames`` frames
(host clock, the card synchronised); the count's fps is frames over the
slowest rank's time.  Prints one JSON line per count:
``{"devices": n, "fps": ..., "efficiency_vs_1": ...}``.

The efficiency means what it says only with a card per rank.
``run_count(n, ..., backend="gloo")`` runs ``n`` Gloo ranks that share
one card: that checks the partition and the collectives, not the speed
of ``n`` cards.

Run: ``python -m voxelhashing_demo_tpu_torch.tools.scaling_bench`` on the
cards present, ``--cpu`` for Gloo ranks on the CPU (absolute fps is then
meaningless).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import (CameraConfig, FusionConfig, GCConfig, HashConfig,
                      ICPConfig, PipelineConfig, RaycastConfig)

COUNTS = (1, 2, 4, 8, 16, 32)
TIMEOUT_S = 900.0


def scaling_config(width: int, height: int) -> PipelineConfig:
    """The JAX tool's configuration at ``width`` x ``height`` (TUM fr1
    intrinsics scaled to the width)."""
    scale = width / 640.0
    cam = CameraConfig(width=width, height=height, fx=517.3 * scale,
                       fy=516.5 * scale, cx=(width - 1) / 2,
                       cy=(height - 1) / 2)
    return PipelineConfig(
        camera=cam,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
        hash=HashConfig(num_buckets=65536, bucket_size=4,
                        num_blocks=65536, max_active=4096,
                        max_new_per_frame=4096, candidate_stride=3),
        raycast=RaycastConfig(mode="splat"),
        gc=GCConfig(enabled=True, interval=16),
    )


def _rank(mesh, config, frames: int, warmup: int) -> float:
    """One rank's timed frames: returns its seconds."""
    from ..models.hash_slam import depth_tensor
    from ..parallel import sharded
    from ..utils import synthetic

    dev = mesh.device
    slam = sharded.ShardedHashSLAM(config, mesh)
    depths, _ = synthetic.make_sequence(config.camera, 4, trans_amp=0.06,
                                        rot_amp_deg=3.0, device=dev)
    depths = [depth_tensor(d, dev) for d in depths]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(warmup):
        slam.process(depths[i % len(depths)])
    sync()
    t0 = time.perf_counter()
    for i in range(frames):
        slam.process(depths[(warmup + i) % len(depths)])
    sync()
    return time.perf_counter() - t0


def run_count(n: int, width: int = 640, height: int = 480, frames: int = 12,
              warmup: int = 3, backend: str | None = None,
              device: str = "cuda") -> float:
    """fps of ``n`` ranks (one spawn): frames over the slowest rank's
    seconds.  ``backend`` None: NCCL with a card per rank on CUDA, Gloo
    on the CPU."""
    from ..parallel import launch

    secs = launch.spawn(_rank, n, backend, device, TIMEOUT_S,
                        scaling_config(width, height), frames, warmup)
    return frames / max(secs)


def main(argv=None) -> list:
    """Parse the JAX tool's arguments, run each count, print and return
    the lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--max-devices", type=int, default=0,
                    help="0 = all available")
    ap.add_argument("--cpu", action="store_true",
                    help="Gloo ranks on the CPU (one per core available)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    n_avail = os.cpu_count() if args.cpu else torch.cuda.device_count()
    if n_avail == 0:
        raise RuntimeError("no CUDA card: pass --cpu for Gloo ranks on the "
                           "CPU")
    max_dev = args.max_devices or n_avail
    counts = [n for n in COUNTS if n <= min(max_dev, n_avail)]
    lines = []
    base_fps = None
    for n in counts:
        if args.height % n or 65536 % n:
            continue
        fps = run_count(n, args.width, args.height, args.frames,
                        args.warmup, device=device)
        if base_fps is None:
            base_fps = fps
        line = {"devices": n, "fps": fps,
                "efficiency_vs_1": fps / (base_fps * n)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    # the package's own module object, so the spawned ranks import the
    # rank function by its package name
    from voxelhashing_demo_tpu_torch.tools.scaling_bench import main as _main

    _main()
