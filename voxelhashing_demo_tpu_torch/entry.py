"""Top-level entry points of the port (twin of ``__graft_entry__.py``).

``entry(device)`` returns the flagship frame step and its example
arguments; ``dryrun_multichip(n)`` runs the whole multi-device stack on
tiny shapes over an ``n``-rank mesh, one process per rank
(``parallel/launch.spawn``), with the JAX function's sequence and checks.

Run on the card::

    python -m voxelhashing_demo_tpu_torch.entry

runs ``entry()``'s step once and ``dryrun_multichip`` over every card
present (NCCL, a card per rank).  On the CPU call
``entry(device="cpu")`` and ``dryrun_multichip(n, backend="gloo",
device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import (CameraConfig, FusionConfig, GCConfig, HashConfig,
                     KeyframeConfig, PipelineConfig, RaycastConfig,
                     StreamConfig, flagship_config)
from .device import host_array, resolve

__all__ = ["flagship_config", "entry", "dryrun_config", "dryrun_multichip"]

# the rigid correction the dry run applies after its rebuild (se(3) twist:
# translation, then rotation in radians)
DRYRUN_CORRECTION = (0.03, -0.02, 0.02, 0.0, 0.03, 0.0)
DRYRUN_TIMEOUT_S = 600.0


def entry(device=None):
    """(fn, (state, depth)): the flagship frame step ``hash_slam.step``
    under ``flagship_config()``, a fresh state on ``device`` (None: the
    CUDA card) and a zero 480x640 frame in the integer dtype the step
    takes for raw depth (int32)."""
    from .models import hash_slam

    config = flagship_config()
    device = resolve(device)
    state = hash_slam.create(config, device)
    depth = torch.zeros((config.camera.height, config.camera.width),
                        dtype=torch.int32, device=device)

    def fn(state, depth_raw):
        return hash_slam.step(state, depth_raw, config)

    return fn, (state, depth)


def dryrun_config(n: int) -> PipelineConfig:
    """The dry run's configuration for an ``n``-rank mesh: 64 columns,
    64 rows (8n when 64 does not split over n), streaming on."""
    H = 8 * n if 64 % n else 64          # image rows divisible by mesh
    W = 64
    return PipelineConfig(
        camera=CameraConfig(width=W, height=H, fx=52.0, fy=52.0,
                            cx=(W - 1) / 2, cy=(H - 1) / 2),
        fusion=FusionConfig(voxel_size=0.05, truncation=0.2),
        hash=HashConfig(num_buckets=128 * n, bucket_size=4,
                        num_blocks=128 * n, max_active=64 * n,
                        max_new_per_frame=64 * n),
        raycast=RaycastConfig(max_steps=32, cache_dims=(64, 64, 64)),
        gc=GCConfig(enabled=True, interval=2),
        stream=StreamConfig(enabled=True, interval=2, max_age=4,
                            max_evict=32 * n, max_restore=32 * n),
        keyframes=KeyframeConfig(
            min_rotation_deg=2.0, min_translation=0.02,
            min_loop_separation=0, loop_radius=10.0,
            min_loop_inliers=50, max_loop_error=5e-3,
            icp_downsample=1, sync_every=2,
        ),
    )


def _require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {what}")


def _dryrun_rank(mesh, n: int) -> dict:
    """The dry run on one rank (every rank runs it together).  Returns
    what it checked, all replicated across the ranks."""
    from .geometry import se3
    from .models import keyframe_slam
    from .ops import pose_graph
    from .parallel import sharded
    from .utils import synthetic

    config = dryrun_config(n)
    cam = config.camera
    dev = mesh.device
    slam = sharded.ShardedHashSLAM(config, mesh)
    depth = torch.full((cam.height, cam.width), 7500, dtype=torch.int32,
                       device=dev)                      # 1.5 m plane
    info = slam.process(depth)
    blocks = int(info.blocks_allocated)
    _require(blocks > 0, "allocated no blocks")
    _require(bool(torch.all(torch.isfinite(info.pose))), "pose not finite")

    # keyframe backend + streaming over the mesh
    depths, _ = synthetic.make_room_sweep(cam, 6, sweep_deg=30.0,
                                          device=dev)
    kf = keyframe_slam.KeyframeSLAM(config, mesh=mesh)
    for d in depths:
        kf.process(d)
    kf.flush()
    _require(len(kf.keyframes) >= 2, "pan must insert keyframes")
    _require(all(np.isfinite(t).all() for t in kf.trajectory()),
             "trajectory not finite")

    # the sharded rebuild streams into a fresh store, then a rigid
    # correction takes the owner-local incremental path
    kf._rebuild_map()
    _require(kf._map_ledgered, "rebuild left the map unledgered")
    D_t = se3.exp(torch.tensor(DRYRUN_CORRECTION, dtype=torch.float32))
    D = host_array(D_t)
    kf._poses_np[: kf._n_poses] = D @ kf._poses_np[: kf._n_poses]
    D_t = D_t.to(dev)
    kf.graph = kf.graph._replace(
        poses=torch.einsum("ij,kjl->kil", D_t, kf.graph.poses))
    kf.state = kf.state._replace(pose=D_t @ kf.state.pose)
    moved, _sat = kf._incremental_reintegrate()
    _require(moved > 0, "correction must take the incremental path")
    _require(bool(torch.all(torch.isfinite(kf.state.model.depth))),
             "model depth not finite")

    # live render over the sharded map (per-rank splat + pmin merge)
    out = sharded.fetch_output(mesh, kf.render())
    hit = float(out.hit.float().mean())
    _require(hit > 0.1, f"sharded render miss (hit {hit})")

    # edge-sharded bundle adjustment on a 3-pose graph
    graph = pose_graph.create(4, 2 * n, device=dev)
    for _ in range(3):
        graph = pose_graph.add_pose(graph, info.pose)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    graph = pose_graph.add_edge(graph, 0, 1, eye)
    graph = pose_graph.add_edge(graph, 1, 2, eye)
    graph, _ba = sharded.optimize_graph_sharded(graph, config.keyframes,
                                                mesh)
    _require(bool(torch.all(torch.isfinite(graph.poses))),
             "BA poses not finite")
    return {"blocks_allocated": blocks, "keyframes": len(kf.keyframes),
            "moved": int(moved), "hit": hit,
            "pose": host_array(info.pose).tolist()}


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device=None) -> list:
    """Run the full multi-device stack over an ``n_devices``-rank mesh on
    tiny shapes, one process per rank: the sharded step on a 1.5 m plane,
    six room-sweep frames through the sharded keyframe backend with
    streaming on, a sharded rebuild into a fresh store, a rigid
    correction through the incremental reintegration, a live render and
    an edge-sharded BA.  Any failed check raises.

    ``backend`` None: NCCL with a CUDA card per rank (raises with fewer
    cards than ranks); "gloo": the ranks may share one card, or run on the
    CPU with ``device="cpu"``.  Returns the ranks' results (rank order),
    which agree."""
    from .parallel import launch

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a dry run needs at least one rank, got {n}")
    device = resolve(device)
    outs = launch.spawn(_dryrun_rank, n, backend, device.type,
                        DRYRUN_TIMEOUT_S, n)
    for r, out in enumerate(outs[1:], 1):
        if out != outs[0]:
            raise RuntimeError(f"dry run: rank {r} disagrees with rank 0: "
                               f"{out} != {outs[0]}")
    return outs


def main() -> None:
    fn, args = entry()
    _state, info = fn(*args)
    _require(bool(torch.all(torch.isfinite(info.pose))), "entry pose")
    print("entry() run OK", flush=True)
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK", flush=True)


if __name__ == "__main__":
    # the package's own module object, so the spawned ranks import the
    # rank function by its package name
    from voxelhashing_demo_tpu_torch.entry import main as _main

    _main()
