"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

``tiny_flagship_gather_config`` is the flagship configuration cut to the
80x60 test camera with a hash large enough for 2 cm voxels (the plain
tiny hash saturates there), and the window gather switched on.  It is
built for either package from one description, so both run the same
numbers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

TINY_HASH = dict(num_buckets=4096, bucket_size=4, num_blocks=4096,
                 max_active=2048, max_new_per_frame=2048)


def tiny_flagship_gather_config(pkg: str):
    """``pkg`` is "jax" or "torch"; returns that package's PipelineConfig."""
    if pkg == "jax":
        from __graft_entry__ import flagship_config
        from voxelhashing_demo_tpu.config import tiny_config
    else:
        from voxelhashing_demo_tpu_torch.config import (flagship_config,
                                                        tiny_config)
    cfg = flagship_config()
    return dataclasses.replace(
        cfg,
        camera=tiny_config().camera,
        hash=dataclasses.replace(cfg.hash, use_pallas_gather=True,
                                 **TINY_HASH),
    )


def tt(a):
    """numpy / JAX array -> a CPU torch tensor holding its own copy."""
    import torch

    return torch.from_numpy(np.array(a, copy=True))


def np_tree(nt, prefix: str = "") -> dict:
    """Flatten a (nested) NamedTuple of JAX arrays into ``{dotted name:
    np.ndarray}``, the layout of voxelhashing_demo_tpu_torch.convert."""
    out = {}
    for name, val in nt._asdict().items():
        key = f"{prefix}.{name}" if prefix else name
        if hasattr(val, "_asdict"):
            out.update(np_tree(val, key))
        else:
            out[key] = np.asarray(val)
    return out


def jax_sequence(cam_jax, n: int):
    """The JAX package's synthetic orbit sequence (uint16 numpy frames and
    numpy poses) used by the slice tests."""
    from voxelhashing_demo_tpu.utils import synthetic

    depths, poses = synthetic.make_sequence(cam_jax, n, trans_amp=0.05,
                                            rot_amp_deg=2.5)
    return [np.asarray(d) for d in depths], [np.asarray(p) for p in poses]


# --------------------------------------------------------------------------
# the keyframe backend's parity scenario (tests/test_torch_keyframe_*.py)
# --------------------------------------------------------------------------

BACKEND_FRAMES = 24
BACKEND_INJECT_AT = 12
# the drift left-multiplied into the live pose before frame 12:
# 3 / -2 / 2 cm and 1.5 degrees of yaw
BACKEND_DRIFT_TWIST = (0.03, -0.02, 0.02, 0.0, float(np.deg2rad(1.5)), 0.0)
BACKEND_KF = dict(
    min_rotation_deg=2.0, min_translation=0.03, icp_downsample=2,
    min_loop_inliers=150, max_loop_error=5e-4, loop_radius=1.0,
    min_loop_separation=2, ba_iters=5, rebuild_min_trans=0.01,
    sync_every=1, ba_defer_edges=1, ba_defer_frames=0, rebuild_window=64,
    rebuild_incremental_cost=0.0,
)
BACKEND_DISCRETE = ("keyframe_frames", "edges", "ba_frames", "ba_modes",
                    "moved", "tracked", "capacity", "saturated")
# bounds of the variant runs (see assert_same_backend_run)
BACKEND_VARIANT = dict(graph_atol=1e-3, traj_atol=2e-3)


def backend_config(pkg: str, **overrides):
    """tiny_flagship_gather_config with the scenario's keyframe settings
    (and ``overrides`` on top)."""
    cfg = tiny_flagship_gather_config(pkg)
    kw = dict(BACKEND_KF)
    kw.update(overrides)
    return dataclasses.replace(
        cfg, keyframes=dataclasses.replace(cfg.keyframes, **kw))


def backend_frames():
    """(uint16 frames, ground-truth poses): 24 frames of the orbit at 80x60
    from the port's synthetic module on the CPU."""
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cam = tiny_flagship_gather_config("torch").camera
    return synthetic.make_sequence(cam, BACKEND_FRAMES, trans_amp=0.10,
                                   rot_amp_deg=5.0, device="cpu")


def backend_drift():
    """The injected drift as a (4, 4) float32 array."""
    import torch

    from voxelhashing_demo_tpu_torch.geometry import se3

    return se3.exp(torch.tensor(BACKEND_DRIFT_TWIST,
                                dtype=torch.float32)).numpy()


def backend_inject(pkg: str, slam) -> None:
    """Left-multiply the live pose of ``slam`` by the drift."""
    if pkg == "jax":
        import jax.numpy as jnp

        D = jnp.asarray(backend_drift())
    else:
        import torch

        D = torch.from_numpy(backend_drift())
    slam.state = slam.state._replace(pose=D @ slam.state.pose)


def backend_drive(pkg: str, depths, n=None, on_frame=None, **overrides):
    """Run the scenario through one package's KeyframeSLAM; returns the
    flushed slam and its trajectory."""
    cfg = backend_config(pkg, **overrides)
    if pkg == "jax":
        from voxelhashing_demo_tpu.models import keyframe_slam

        slam = keyframe_slam.KeyframeSLAM(cfg)
    else:
        from voxelhashing_demo_tpu_torch.models import keyframe_slam

        slam = keyframe_slam.KeyframeSLAM(cfg, device="cpu")
    for i, d in enumerate(depths[:n]):
        if i == BACKEND_INJECT_AT:
            backend_inject(pkg, slam)
        slam.process(d)
        if on_frame is not None:
            on_frame(i, slam)
    return slam, slam.trajectory()


def backend_summary(slam, traj, gt) -> dict:
    from voxelhashing_demo_tpu_torch.utils import metrics

    n_e = int(slam.graph.num_edges)
    return dict(
        keyframe_frames=[r.frame_index for r in slam.keyframes],
        edges=np.asarray(slam.graph.edges_ij)[:n_e].tolist(),
        ba_frames=[e["frame"] for e in slam.ba_events],
        ba_modes=[e["rebuild_mode"] for e in slam.ba_events],
        moved=[e["keyframes_reintegrated"] for e in slam.ba_events],
        tracked=[bool(i.tracked) for i in slam.infos],
        capacity=slam.capacity_events,
        saturated=slam.saturated,
        ate=metrics.ate_rmse(traj, gt[:len(traj)], align=False),
    )


def assert_same_backend_run(js, jt, ts, tt_, gt, graph_atol=1e-4,
                            traj_atol=1e-3):
    """JAX run (js, jt) against port run (ts, tt_): discrete decisions
    equal; graph poses within ``graph_atol``; every frame's position within
    ``traj_atol`` m (its rotation entries within 5 x that); ATE within
    1 mm.  The defaults are the main scenario's bounds.  The variants pass
    looser ones (``BACKEND_VARIANT``): their corrections land at other
    frames, the frame-to-model chain then tracks against other maps, and
    the same float noise has more ways to grow."""
    a, b = backend_summary(js, jt, gt), backend_summary(ts, tt_, gt)
    for k in BACKEND_DISCRETE:
        assert a[k] == b[k], (k, a[k], b[k])
    np.testing.assert_allclose(ts.graph.poses.numpy(),
                               np.asarray(js.graph.poses), atol=graph_atol)
    for i, (x, y) in enumerate(zip(jt, tt_)):
        x, y = np.asarray(x), np.asarray(y)
        np.testing.assert_allclose(y[:3, 3], x[:3, 3], atol=traj_atol,
                                   err_msg=f"frame {i} position")
        np.testing.assert_allclose(y[:3, :3], x[:3, :3], atol=5 * traj_atol,
                                   err_msg=f"frame {i} rotation")
    assert abs(a["ate"] - b["ate"]) < 1e-3
    return a, b


# --------------------------------------------------------------------------
# the streaming parity scenario (tests/test_torch_streaming.py)
# --------------------------------------------------------------------------

# 1024 device blocks against the ~870 a single 80x60 view touches at 2 cm:
# the heap runs out on the way out, and eviction (age 6) and restore stay
# active over a 90-degree pan out and back (20 frames each way)
STREAM_HASH = dict(num_buckets=2048, bucket_size=4, num_blocks=1024,
                   max_active=1024, max_new_per_frame=1024)
STREAM = dict(enabled=True, interval=2, max_age=6, max_evict=512,
              max_restore=512)
STREAM_HALF = 20
STREAM_SWEEP_DEG = 90.0
STREAM_ROWS = ("keys", "tsdf", "weight", "born")


def stream_config(pkg: str, **stream_overrides):
    """tiny_flagship_gather_config with the scenario's hash cut and
    streaming on (``stream_overrides`` on top)."""
    cfg = tiny_flagship_gather_config(pkg)
    return dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, **STREAM_HASH),
        stream=dataclasses.replace(cfg.stream,
                                   **dict(STREAM, **stream_overrides)))


def stream_frames():
    """(uint16 numpy frames, ground-truth poses): the noise-free room sweep
    out and back at 80x60, from the port's synthetic module on the CPU."""
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cam = tiny_flagship_gather_config("torch").camera
    fwd, gt = synthetic.make_room_sweep(cam, STREAM_HALF,
                                        sweep_deg=STREAM_SWEEP_DEG,
                                        device="cpu")
    fwd = [np.asarray(d) for d in fwd]
    return fwd + fwd[-2::-1], gt + gt[-2::-1]


def jax_stream_state(slam) -> dict:
    """A JAX streaming HashSLAM's state in the layout of the port's
    ``convert.stream_state_to_numpy`` (taken between a completion and the
    next dispatch)."""
    slam._join_complete()
    assert slam._inflight is None
    V = slam.config.hash.voxels_per_block
    out = np_tree(slam.state)
    for k, v in slam.store.state_arrays().items():
        out[f"store.{k}"] = v
    out["store.total_evicted"] = np.int64(slam.store.total_evicted)
    out["store.total_restored"] = np.int64(slam.store.total_restored)
    out["prefetch.keys"] = (np.zeros(0, np.int32) if slam._prefetch is None
                            else np.asarray(slam._prefetch[0], np.int32))
    keys = np.zeros(0, np.int32)
    pay = np.zeros((0, 2 * V + 1), np.float32)
    if slam._pending_evict is not None:
        keys = np.asarray(slam._pending_evict[0])
        pay = np.asarray(slam._pending_evict[1])
        live = keys != int(0x7FFFFFFF)
        keys, pay = keys[live], pay[live]
    out.update({"pending_evict.keys": keys,
                "pending_evict.tsdf": pay[:, :V],
                "pending_evict.weight": pay[:, V:2 * V],
                "pending_evict.born": pay[:, 2 * V].astype(np.int32)})
    out["trajectory"] = np.stack(
        [np.asarray(p) for p in slam.trajectory]).reshape(-1, 4, 4)
    return out


def jax_stream_from_numpy(d: dict, config):
    """A JAX streaming HashSLAM at the state of ``d`` (the inverse of
    ``jax_stream_state``, with the store compacted by
    ``BlockStore.from_arrays`` as the port's loader does)."""
    import jax.numpy as jnp

    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.ops import hash_ops, preprocess
    from voxelhashing_demo_tpu.utils.blockstore import BlockStore

    slam = hash_slam.HashSLAM(config)
    slam.state = hash_slam.HashSLAMState(
        hmap=hash_ops.HashMap(**{f: jnp.asarray(d[f"hmap.{f}"])
                                 for f in hash_ops.HashMap._fields}),
        pose=jnp.asarray(d["pose"]),
        model=preprocess.Frame(**{f: jnp.asarray(d[f"model.{f}"])
                                  for f in preprocess.Frame._fields}),
        frame_idx=jnp.int32(d["frame_idx"]),
        vel=jnp.asarray(d["vel"]))
    slam.store = BlockStore.from_arrays(
        config.hash, *(np.asarray(d[f"store.{k}"]) for k in STREAM_ROWS))
    slam.store.total_evicted = int(d["store.total_evicted"])
    slam.store.total_restored = int(d["store.total_restored"])
    keys = np.asarray(d["prefetch.keys"], np.int32)
    if keys.size:
        packed, b = slam._pack_restore(keys)
        slam._prefetch = (keys, jnp.asarray(packed), b)
    n = np.asarray(d["pending_evict.keys"]).shape[0]
    if n:
        b = hash_slam._bucket(n, config.stream.max_evict, floor=128)
        V = config.hash.voxels_per_block
        keys_p = np.full(b, 0x7FFFFFFF, np.int32)
        keys_p[:n] = d["pending_evict.keys"]
        pay = np.zeros((b, 2 * V + 1), np.float32)
        pay[:n, :V] = d["pending_evict.tsdf"]
        pay[:n, V:2 * V] = d["pending_evict.weight"]
        pay[:n, 2 * V] = d["pending_evict.born"]
        slam._pending_evict = (jnp.asarray(keys_p), jnp.asarray(pay), b)
    slam.trajectory = [jnp.asarray(p) for p in np.asarray(d["trajectory"])]
    return slam


# --------------------------------------------------------------------------
# the sharded stack (tests/test_torch_sharded*.py)
# --------------------------------------------------------------------------

def sharded_config(pkg: str, mode: str = "splat", gather: bool = False):
    """tests/test_sharded.py's 80x64 ``CFG`` with the flagship's pyramid
    ICP (4, 2, 1), for either package (see tests/test_torch_sharded.py
    for why the pyramid)."""
    if pkg == "jax":
        from voxelhashing_demo_tpu import config as m
    else:
        from voxelhashing_demo_tpu_torch import config as m
    return m.PipelineConfig(
        camera=m.CameraConfig(width=80, height=64, fx=64.6, fy=64.6,
                              cx=39.65, cy=31.8),
        icp=m.ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=m.FusionConfig(voxel_size=0.04, truncation=0.16),
        hash=m.HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                          max_active=1024, max_new_per_frame=1024,
                          use_pallas_gather=gather),
        raycast=m.RaycastConfig(mode=mode, max_steps=96,
                                cache_dims=(128, 128, 128)),
        gc=m.GCConfig(enabled=True, interval=4),
    )


def sharded_frames(n: int):
    """tests/test_sharded.py's orbit frames (uint16 numpy) at 80x64."""
    from voxelhashing_demo_tpu.utils import synthetic

    depths, _ = synthetic.make_sequence(sharded_config("jax").camera, n,
                                        trans_amp=0.04, rot_amp_deg=2.0)
    return [np.asarray(d) for d in depths]


# --------------------------------------------------------------------------
# the benchmark twin (tests/test_torch_bench*.py)
# --------------------------------------------------------------------------

# the bench sections' room sweeps are rendered this many times slower than
# asked: n frames are the head of an (n x SLOW_PAN)-frame sweep, so a cut
# run moves as little per frame (~2 degrees) as the full-length one
SLOW_PAN = 20


def bench_config(pkg: str):
    """tests/test_bench_smoke.py's tiny 80x60 ``CFG`` in either package."""
    if pkg == "jax":
        from voxelhashing_demo_tpu import config as m
    else:
        from voxelhashing_demo_tpu_torch import config as m
    return m.PipelineConfig(
        camera=m.CameraConfig(width=80, height=60, fx=64.6625, fy=64.5625,
                              cx=39.7, cy=29.8),
        icp=m.ICPConfig(pyramid=(2, 1), pyramid_iters=(6, 3)),
        fusion=m.FusionConfig(voxel_size=0.04, truncation=0.16),
        hash=m.HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                          max_active=1024, max_new_per_frame=1024),
        raycast=m.RaycastConfig(max_steps=48, cache_dims=(96, 96, 96)),
        gc=m.GCConfig(enabled=True, interval=8),
        keyframes=m.KeyframeConfig(sync_every=4, icp_downsample=2,
                                   min_loop_inliers=100),
    )


def _port_synthetic():
    """The port's synthetic module, by its import name (a test may put
    SlowPanFrames in its place as the package's attribute)."""
    import importlib

    return importlib.import_module("voxelhashing_demo_tpu_torch.utils."
                                   "synthetic")


@functools.lru_cache(maxsize=None)
def _sweep_head(cam, n: int, sweep_deg: float, noise_seed):
    import torch

    synthetic = _port_synthetic()
    gen = (None if noise_seed is None
           else torch.Generator().manual_seed(int(noise_seed)))
    T0_inv = np.linalg.inv(synthetic.room_sweep_pose(0.0, sweep_deg))
    depths, poses = [], []
    for i in range(n):
        T = synthetic.room_sweep_pose(i / (n * SLOW_PAN), sweep_deg)
        d = synthetic.render_depth(torch.as_tensor(T, dtype=torch.float32),
                                   cam, sdf=synthetic.room_sdf)
        if gen is not None:
            d = synthetic.add_sensor_noise(d, gen)
        depths.append(synthetic.depth_to_raw(d, cam))
        poses.append((T0_inv @ T).astype(np.float32))
    return tuple(depths), tuple(poses)


class SlowPanFrames:
    """A ``synthetic`` module for either bench (its sections take the
    module as an argument): ``make_room_sweep(cam, n, sweep_deg, ...)`` is
    the port's noisy room sweep on the CPU, cut to the head of a sweep
    ``SLOW_PAN`` times as long (made once per argument set, so both
    benches get the same uint16 frames); ``make_sequence`` is the port's
    orbit on the CPU."""

    @staticmethod
    def _cam(cam):
        from voxelhashing_demo_tpu_torch.config import CameraConfig

        return CameraConfig(**dataclasses.asdict(cam))

    @classmethod
    def make_room_sweep(cls, cam, num_frames, sweep_deg=360.0,
                        noise_seed=None, device=None):
        depths, poses = _sweep_head(cls._cam(cam), num_frames,
                                    float(sweep_deg), noise_seed)
        return list(depths), list(poses)

    @classmethod
    def make_sequence(cls, cam, num_frames, device=None, **kw):
        return _port_synthetic().make_sequence(cls._cam(cam), num_frames,
                                       device="cpu", **kw)


# --------------------------------------------------------------------------
# checkpoint parity (tests/test_torch_checkpoint*.py)
# --------------------------------------------------------------------------

# pose bound of the frames run after a load (test_torch_checkpoint.py)
POSE_ATOL = 1e-5


def _np(x):
    """numpy view of a CPU tensor or a JAX / numpy array."""
    import torch

    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_states_equal(t_state, j_state):
    for f in t_state.hmap._fields:
        np.testing.assert_array_equal(_np(getattr(t_state.hmap, f)),
                                      np.asarray(getattr(j_state.hmap, f)),
                                      err_msg=f)
    for f in t_state.model._fields:
        np.testing.assert_array_equal(_np(getattr(t_state.model, f)),
                                      np.asarray(getattr(j_state.model, f)))
    np.testing.assert_array_equal(_np(t_state.pose), np.asarray(j_state.pose))
    np.testing.assert_array_equal(_np(t_state.vel), np.asarray(j_state.vel))
    assert int(t_state.frame_idx) == int(j_state.frame_idx)


def assert_trajectories_equal(t_traj, j_traj):
    assert len(t_traj) == len(j_traj)
    for a, b in zip(t_traj, j_traj):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def assert_files_equal(a, b):
    """Same keys, dtypes, shapes and values."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def assert_stores_equal(t_store, j_store):
    ta, ja = t_store.state_arrays(), j_store.state_arrays()
    assert sorted(ta) == sorted(ja)
    for k in ta:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert len(t_store) == len(j_store)


def continue_both(t_slam, j_slam, frames):
    """The next frames through both loaded slams; poses within
    POSE_ATOL."""
    import jax.numpy as jnp

    for d in frames:
        t = t_slam.process(d)
        j = j_slam.process(jnp.asarray(d))
        np.testing.assert_allclose(_np(t.pose), np.asarray(j.pose),
                                   atol=POSE_ATOL)
