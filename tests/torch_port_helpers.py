"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

``tiny_flagship_gather_config`` is the flagship configuration cut to the
80x60 test camera with a hash large enough for 2 cm voxels (the plain
tiny hash saturates there), and the window gather switched on.  It is
built for either package from one description, so both run the same
numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from pathlib import Path

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


def depth_scene(h: int, w: int, seed: int, border_edges: bool = True):
    """uint16 raw depth (5000 units a metre) of a tilted wall with a box in
    front; with ``border_edges`` the first rows and columns are far and
    the last near, so every wrapped stencil crosses a depth edge."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 2.0 + 0.01 * x - 0.006 * y + 0.05 * np.sin(0.3 * x + seed)
    box = ((y > h * 0.3) & (y < h * 0.7) & (x > w * 0.35) & (x < w * 0.65))
    d[box] -= 0.6
    if border_edges:
        d[:2, :] = 3.5
        d[:, :2] = 3.6
        d[-2:, :] = 0.9
        d[:, -3:] = 0.8
    d += rng.normal(scale=0.002, size=d.shape)
    raw = np.round(d * 5000.0).astype(np.int64)
    raw[rng.random(raw.shape) < 0.05] = 0                       # dropouts
    fly = rng.random(raw.shape) < 0.02                           # flying px
    raw[fly] = rng.integers(2000, 20000, size=int(fly.sum()))
    return np.clip(raw, 0, 65535).astype(np.uint16)


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


@contextlib.contextmanager
def pallas_probe(name: str, *argv: str):
    """Run the Pallas probe script ``tools/<name>.py`` (it executes at
    module level) with every ``pallas_call`` in interpret mode, ``argv``
    as its command-line switches and the repository root as the working
    directory; yields its namespace.  The interpret switch stays on while
    the context is open, so the probe's functions can be called again."""
    import runpy
    import sys

    import pytest
    from jax.experimental import pallas as pl

    root = Path(__file__).resolve().parent.parent
    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        mp.setattr(sys, "argv", [f"{name}.py", *argv])
        mp.setattr(sys, "path", list(sys.path))
        mp.chdir(root)
        yield runpy.run_path(str(root / "tools" / f"{name}.py"),
                             run_name="pallas_probe")


def assert_bits_equal(got, want):
    """Two float32 arrays (numpy, JAX or torch) equal bit for bit."""
    g = np.asarray(got, dtype=np.float32)
    w = np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def splat_map_case(voxel_size: float, band: float, seed: int = 0,
                   block_size: int = 8):
    """numpy inputs of the splat z-buffer (K8 and its plain version): a
    tilted wall 0.7-1.8 m in front of a camera that looks along +z,
    fused as a projective TSDF into ``block_size``^3-voxel rows (the
    candidate blocks span the same space whatever the block size).

    Returns {"tsdf", "weight", "band_min"} of the map's rows, {"blocks",
    "ptrs", "count"} of an active set and "pose" (T_wc, float32 4x4).
    The active set holds, in order: rows on the surface; every seventh
    of them FREE_PTR inside ``count``; empty-space rows whose band_min
    (their true one) lies at or past ``band``; "stale" rows whose
    band_min says the same although they hold voxels inside the band
    (surface_filter drops them, splat_depth_from_map splats them).  Past
    ``count`` lie rows with real map rows ("ptrs"), which only the port
    ignores by ``count``; "ptrs_padded" is the same set padded with
    FREE_PTR there, as compact_visible pads it (the JAX package reads
    rows past ``count`` in its last chunk)."""
    rng = np.random.default_rng(seed)
    bs, trunc = block_size, 4 * voxel_size
    if band > trunc:
        raise ValueError("the empty rows' band_min (the truncation) must "
                         "lie at or past the band")
    ang = np.deg2rad(4.0)
    R = np.array([[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                  [-np.sin(ang), 0.0, np.cos(ang)]])
    t = np.array([0.03, -0.02, 0.01])
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = R, t

    def wall(pc):                 # the wall's depth along each ray
        return 1.2 + 0.5 * pc[..., 0] / pc[..., 2] + 0.3 * pc[..., 1] / \
            pc[..., 2]

    local = np.stack(np.meshgrid(np.arange(bs), np.arange(bs),
                                 np.arange(bs), indexing="ij"), -1)
    local = local.transpose(2, 1, 0, 3).reshape(-1, 3)   # x fastest
    span = np.arange(-(64 // bs), 64 // bs)
    cand = np.stack(np.meshgrid(span, span, np.arange(16 // bs, 112 // bs),
                                indexing="ij"), -1).reshape(-1, 3)
    world = ((cand[:, None, :] * bs + local) * voxel_size)
    pc = (world - t) @ R                    # camera coordinates
    sdf_true = wall(pc) - pc[..., 2]
    near_surface = np.abs(sdf_true).min(axis=1) < 0.5 * voxel_size
    empty = (np.abs(sdf_true).min(axis=1) > 2 * trunc) & \
        (pc[..., 2].min(axis=1) > 0.3)
    surf_idx = rng.permutation(np.flatnonzero(near_surface))[:120]
    empty_idx = rng.permutation(np.flatnonzero(empty))[:12]
    stale_idx = surf_idx[-8:]
    live_idx = surf_idx[:-8]
    past_idx = rng.permutation(np.flatnonzero(near_surface
                                              & ~np.isin(np.arange(len(cand)),
                                                         surf_idx)))[:16]
    order = np.concatenate([live_idx, empty_idx, stale_idx, past_idx])
    n_rows = len(order)
    sdf = np.clip(sdf_true[order] + rng.normal(scale=0.2 * voxel_size,
                                               size=(n_rows, bs ** 3)),
                  -trunc, trunc).astype(np.float32)
    weight = rng.integers(1, 6, size=sdf.shape).astype(np.float32)
    weight[rng.random(sdf.shape) < 0.1] = 0.0
    weight[np.abs(sdf_true[order]) > trunc] = 0.0
    weight[len(live_idx):len(live_idx) + len(empty_idx)] = 2.0
    sdf[len(live_idx):len(live_idx) + len(empty_idx)] = trunc
    band_min = np.where(weight > 0, np.abs(sdf), np.inf).min(axis=1)
    band_min = band_min.astype(np.float32)
    n_stale0 = len(live_idx) + len(empty_idx)
    band_min[n_stale0:n_stale0 + len(stale_idx)] = np.float32(np.inf)
    # the map's rows are a permutation of the set's
    rows = rng.permutation(n_rows).astype(np.int32)
    ptrs = rows.copy()
    count = n_rows - len(past_idx)
    ptrs[:count][::7] = -1
    pad = 8
    blocks = np.concatenate([cand[order], np.zeros((pad, 3))]).astype(
        np.int32)
    ptrs = np.concatenate([ptrs, np.full(pad, -1)]).astype(np.int32)
    padded = ptrs.copy()
    padded[count:] = -1
    padded_blocks = blocks.copy()
    padded_blocks[count:] = 0
    inv = np.empty_like(rows)
    inv[rows] = np.arange(n_rows, dtype=np.int32)
    return {"tsdf": sdf[inv], "weight": weight[inv],
            "band_min": band_min[inv], "blocks": blocks, "ptrs": ptrs,
            "blocks_padded": padded_blocks, "ptrs_padded": padded,
            "count": np.int32(count), "pose": pose.astype(np.float32)}


def splat_depth_case(h: int, w: int, seed: int = 0, pmin: bool = False):
    """A raw splat depth buffer (float32 (h, w), 0 = no estimate) with
    holes: 30 % of the pixels, the top two rows, a 3x3 hole in each corner
    and a hole run along the left column.  The right column and the
    bottom row lie 1-2 cm nearer than the opposite border, so a fill that
    wrapped would take them and the smooth, which wraps, averages them in.
    ``pmin``: the element-wise minimum of two such buffers, as the
    multi-device path merges its ranks' buffers (0 where both are 0)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    d = 1.5 + 0.0004 * x - 0.0003 * y + 0.004 * np.sin(0.7 * x + 0.3 * y)
    d[:, -1] -= 0.012
    d[-1, :] -= 0.018
    d += rng.normal(scale=0.002, size=d.shape)
    d[rng.random(d.shape) < 0.3] = 0.0
    d[:2, :] = 0.0
    for cy in (0, h - 3):
        for cx in (0, w - 3):
            d[cy:cy + 3, cx:cx + 3] = 0.0
    d[h // 3:h // 2, 0] = 0.0
    d = d.astype(np.float32)
    if pmin:
        other = splat_depth_case(h, w, seed + 1000)
        big = np.where(d > 0, d, np.inf)
        m = np.minimum(big, np.where(other > 0, other, np.inf))
        d = np.where(np.isfinite(m), m, 0.0).astype(np.float32)
    return d
