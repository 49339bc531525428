"""Accuracy references for chip_smoke.py from the JAX package on the CPU.

Not a test (pytest does not collect it); run it from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_port_reference.py \\
        [orbit|march|dense|backend|stream|stream_twin|stream_backend|cli|
         fixture|bench]

``orbit``: the 20-frame noise-free orbit of chip_smoke's ``slice`` phase
(``JAX_REFERENCE``).  ``march``: the 24-frame noisy room sweep of its
``march`` phase (``JAX_REFERENCE_MARCH``).  ``dense``: the same 20-frame
orbit through the JAX ``DenseSLAM`` (BASELINE.json config 1's pipeline)
on the 160 x 128 x 160 grid of 2 cm voxels of chip_smoke's ``dense``
phase (``JAX_REFERENCE_DENSE``; asked for by name).  ``backend``: the 48-frame
noisy 150-degree room sweep with two injected drifts of its ``backend``
phase through the JAX ``KeyframeSLAM`` with chip_smoke's keyframe settings
(``JAX_REFERENCE_BACKEND``: keyframe frame indices, edges, BA event modes,
unaligned ATE; not run by default, it takes about a quarter of an hour).
``stream``: the 201-frame noisy 170-degree out-and-back of its ``stream``
phase through the JAX streaming ``HashSLAM`` (``JAX_REFERENCE_STREAM``:
tracked frames, unaligned ATE, store counters); ``stream_twin``: the same
frames without streaming; ``stream_backend``: the same frames through the
streaming ``KeyframeSLAM`` of its ``stream_backend`` phase
(``JAX_REFERENCE_STREAM_BACKEND``: the decisions too).  These three are
asked for by name; run them in one process (the frames are made once).
``cli``: its ``cli`` phase through the JAX package's application layer
(``JAX_REFERENCE_CLI``): the same frames exported as a TUM directory, the
first ``N_CLI_LIBRARY`` through ``stream.FramePipeline`` into the
``KeyframeSLAM`` of the CLI's default configuration with the window
gather on, ``save_keyframe_slam``, then the JAX CLI's ``run --resume`` on
the directory; prints the run's JSON line and the saved graph's
keyframes and loop edges (asked for by name; about ten minutes).
``fixture``: the JAX CLI's ``run`` (hash backend, ``--render-last``) over
the real PNG16 fixture ``tests/fixtures/kinect_png16`` and ``demo`` on its
first two files, as the ``cli`` phase runs them (``JAX_REFERENCE_FIXTURE``).
``bench``: chip_smoke's ``bench`` phase, the JAX ``bench.py``'s sections
at the phase's cut frame counts (``BENCH_SECTIONS``, ``BENCH_GATHER``;
``JAX_REFERENCE_BENCH``): each section's fields but its timings (asked
for by name).
The frames come from the
PORT's synthetic module on the CPU, with the arguments chip_smoke uses,
and go through the JAX package's ``HashSLAM`` under the flagship gather
configuration (Pallas kernel in interpret mode), so both packages see the
same frames.  Prints one JSON line per run: tracked frames, unaligned ATE,
render hit fraction, active blocks at the last frame, blocks freed.  These
are accuracy figures; nothing here is a speed.
"""

import dataclasses
import functools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import __graft_entry__  # noqa: E402
from voxelhashing_demo_tpu.models import hash_slam  # noqa: E402
from voxelhashing_demo_tpu.utils import metrics  # noqa: E402
from voxelhashing_demo_tpu_torch.config import CameraConfig  # noqa: E402
from voxelhashing_demo_tpu_torch.utils import synthetic  # noqa: E402


def _config(mode: str):
    cfg = __graft_entry__.flagship_config()
    return dataclasses.replace(
        cfg,
        hash=dataclasses.replace(cfg.hash, use_pallas_gather=True),
        raycast=dataclasses.replace(cfg.raycast, mode=mode),
    )


def _run(name: str, cfg, depths, gt) -> dict:
    slam = hash_slam.HashSLAM(cfg)
    for d in depths:
        slam.process(d)
    out = {
        "run": name, "frames": len(depths),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "ate_mm": metrics.ate_rmse(slam.trajectory, gt, align=False) * 1e3,
        "hit_frac": float(np.asarray(slam.render().hit).mean()),
        "active_blocks": int(slam.infos[-1].blocks_active),
        "blocks_freed": sum(int(i.blocks_freed) for i in slam.infos),
    }
    print(json.dumps(out), flush=True)
    return out


def dense_config():
    """chip_smoke's ``dense`` configuration in the JAX package's types:
    the default camera, frontend and ICP, the fusion and raycast settings
    of tests/test_dense_pipeline.py and its grid, which holds the orbit's
    scene."""
    from voxelhashing_demo_tpu import config as jcfg

    return jcfg.PipelineConfig(
        fusion=jcfg.FusionConfig(voxel_size=0.02, truncation=0.08),
        grid=jcfg.DenseGridConfig(dims=(160, 128, 160),
                                  origin=(-1.6, -0.7, 0.0)),
        raycast=jcfg.RaycastConfig(max_steps=128),
    )


def _run_dense(depths, gt) -> dict:
    from voxelhashing_demo_tpu.models import dense_slam

    slam = dense_slam.DenseSLAM(dense_config())
    for i, d in enumerate(depths):
        slam.process(d)
        _progress(i)
    out = {
        "run": "dense", "frames": len(depths),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "ate_mm": metrics.ate_rmse(slam.trajectory, gt, align=False) * 1e3,
        "hit_frac": float(np.asarray(slam.render().hit).mean()),
    }
    print(json.dumps(out), flush=True)
    return out


def _run_backend() -> dict:
    """chip_smoke's ``backend`` scenario through the JAX KeyframeSLAM."""
    import chip_smoke
    from voxelhashing_demo_tpu.config import KeyframeConfig
    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.models import keyframe_slam

    cfg = dataclasses.replace(
        _config("splat"),
        keyframes=KeyframeConfig(**chip_smoke.BACKEND_KEYFRAMES))
    depths, gt = synthetic.make_room_sweep(
        CameraConfig(), chip_smoke.N_BACKEND,
        sweep_deg=chip_smoke.BACKEND_SWEEP_DEG, noise_seed=1, device="cpu")
    slam = keyframe_slam.KeyframeSLAM(cfg)
    for i, d in enumerate(depths):
        if i in chip_smoke.BACKEND_INJECT:
            tw = np.array(chip_smoke.BACKEND_INJECT[i], np.float32)
            tw[3:] = np.deg2rad(tw[3:])
            D = se3.exp(jax.numpy.asarray(tw))
            slam.state = slam.state._replace(pose=D @ slam.state.pose)
        slam.process(d)
    traj = slam.trajectory()
    n_e = int(slam.graph.num_edges)
    edges = np.asarray(slam.graph.edges_ij)[:n_e].tolist()
    out = {
        "run": "backend", "frames": len(depths),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "keyframe_frames": [r.frame_index for r in slam.keyframes],
        "edges": n_e,
        "loop_edges": [e for e in edges if e[1] - e[0] > 1],
        "ba_frames": [e["frame"] for e in slam.ba_events],
        "ba_modes": [e["rebuild_mode"] for e in slam.ba_events],
        "keyframes_reintegrated": [e["keyframes_reintegrated"]
                                   for e in slam.ba_events],
        "saturated": any(e.get("reintegration_saturated")
                         for e in slam.ba_events),
        "ring_overflow": bool(slam._ring_overflow),
        "ate_mm": metrics.ate_rmse(traj, gt, align=False) * 1e3,
    }
    print(json.dumps(out), flush=True)
    return out


def _stream_config(stream, keyframes=None):
    """chip_smoke's streaming configuration: the flagship gather
    configuration with the hash cut to 2048 blocks and ``stream`` on."""
    import chip_smoke

    cfg = _config("splat")
    cfg = dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, **chip_smoke.STREAM_HASH),
        stream=dataclasses.replace(cfg.stream, **stream))
    if keyframes is not None:
        cfg = dataclasses.replace(
            cfg, keyframes=dataclasses.replace(cfg.keyframes, **keyframes))
    return cfg


@functools.lru_cache(maxsize=None)
def _out_and_back():
    """chip_smoke's streaming frames: the sweep forward, then back (made
    once per process: the three streaming runs share them)."""
    import chip_smoke

    fwd, gt = synthetic.make_room_sweep(
        CameraConfig(), chip_smoke.N_STREAM_HALF,
        sweep_deg=chip_smoke.STREAM_SWEEP_DEG, noise_seed=1, device="cpu")
    return fwd + fwd[-2::-1], gt + gt[-2::-1]


def _progress(i: int) -> None:
    if i % 25 == 0:
        print(f"frame {i}", file=sys.stderr, flush=True)


def _store_counts(store) -> dict:
    return {"evicted": store.total_evicted, "restored": store.total_restored,
            "store_blocks": len(store)}


def _run_stream(twin: bool) -> dict:
    """chip_smoke's ``stream`` phase (or its non-streaming twin)."""
    import chip_smoke

    stream = dict(chip_smoke.STREAM, enabled=not twin)
    depths, gt = _out_and_back()
    slam = hash_slam.HashSLAM(_stream_config(stream))
    for i, d in enumerate(depths):
        slam.process(d)
        _progress(i)
    out = {
        "run": "stream_twin" if twin else "stream", "frames": len(depths),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "ate_mm": metrics.ate_rmse(slam.trajectory, gt, align=False) * 1e3,
        "min_free_blocks": min(int(i.free_blocks) for i in slam.infos),
    }
    if not twin:
        slam.stream_sync()
        out.update(_store_counts(slam.store))
    print(json.dumps(out), flush=True)
    return out


def _run_stream_backend() -> dict:
    """chip_smoke's ``stream_backend`` phase through the JAX KeyframeSLAM."""
    import chip_smoke
    from voxelhashing_demo_tpu.models import keyframe_slam

    depths, gt = _out_and_back()
    slam = keyframe_slam.KeyframeSLAM(_stream_config(
        chip_smoke.STREAM_BACKEND, chip_smoke.STREAM_BACKEND_KEYFRAMES))
    for i, d in enumerate(depths):
        slam.process(d)
        _progress(i)
    slam.flush()
    slam._driver.stream_sync()
    traj = slam.trajectory()
    n_e = int(slam.graph.num_edges)
    edges = np.asarray(slam.graph.edges_ij)[:n_e].tolist()
    out = {
        "run": "stream_backend", "frames": len(depths),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "keyframe_frames": [r.frame_index for r in slam.keyframes],
        "edges": n_e,
        "loop_edges": [e for e in edges if e[1] - e[0] > 1],
        "ba_frames": [e["frame"] for e in slam.ba_events],
        "ba_modes": [e["rebuild_mode"] for e in slam.ba_events],
        "keyframes_reintegrated": [e["keyframes_reintegrated"]
                                   for e in slam.ba_events],
        "saturated": any(e.get("reintegration_saturated")
                         for e in slam.ba_events),
        "capacity_events": [e["kind"] for e in slam.capacity_events],
        **_store_counts(slam._driver.store),
        "ate_mm": metrics.ate_rmse(traj, gt, align=False) * 1e3,
    }
    print(json.dumps(out), flush=True)
    return out


def _run_cli() -> dict:
    """chip_smoke's ``cli`` phase through the JAX CLI."""
    import contextlib
    import io
    import tempfile

    import chip_smoke
    from voxelhashing_demo_tpu import cli
    from voxelhashing_demo_tpu.models import keyframe_slam
    from voxelhashing_demo_tpu.utils import checkpoint, stream, tum

    depths, gt = _out_and_back()
    root = tempfile.mkdtemp(prefix="cli_reference_")
    data = os.path.join(root, "tum")
    tum.export_sequence(data, [np.asarray(d) for d in depths],
                        [np.asarray(p) for p in gt])
    cfg = cli._default_config(cli.build_parser().parse_args(["run"]))
    cfg = dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, use_pallas_gather=True))
    seq = tum.TUMSequence(data)
    paths = [os.path.join(data, rel) for _, rel, _ in seq.entries]
    slam = keyframe_slam.KeyframeSLAM(cfg)
    n_lib = chip_smoke.N_CLI_LIBRARY
    for d in stream.FramePipeline(paths[:n_lib], cfg.camera.width,
                                  cfg.camera.height):
        slam.process(d)
    ck = os.path.join(root, "library.npz")
    checkpoint.save_keyframe_slam(ck, slam)
    library_keyframes = len(slam.keyframes)
    out_dir = os.path.join(root, "run")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["run", "--dataset", data, "--backend", "keyframe",
                  "--resume", ck, "--render-last", "--render-every",
                  str(chip_smoke.CLI_RENDER_EVERY), "--out", out_dir])
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    with np.load(os.path.join(out_dir, "map.npz")) as z:
        n_e = int(z["graph.num_edges"])
        edges = z["graph.edges_ij"][:n_e].tolist()
        kf_frames = z["extra.kf_frame_indices"].tolist()
    out = {
        "run": "cli", "frames": len(depths), "library_frames": n_lib,
        "library_keyframes": library_keyframes, "result": result,
        "keyframe_frames": kf_frames,
        "loop_edges": [e for e in edges if e[1] - e[0] > 1],
        "ate_mm": result["ate_rmse_unaligned_m"] * 1e3,
    }
    print(json.dumps(out), flush=True)
    return out


def _cli_line(cli, argv) -> dict:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _run_fixture() -> dict:
    """chip_smoke's ``cli`` phase on the fixture through the JAX CLI."""
    import tempfile

    from voxelhashing_demo_tpu import cli

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "kinect_png16")
    root = tempfile.mkdtemp(prefix="fixture_reference_")
    names = sorted(os.listdir(os.path.join(fix, "depth")))[:2]
    out = {
        "run": "fixture",
        "result": _cli_line(cli, ["run", "--dataset", fix, "--render-last",
                                  "--out", os.path.join(root, "run")]),
        "demo": _cli_line(cli, ["demo", *(os.path.join(fix, "depth", n)
                                          for n in names),
                                "--out", os.path.join(root, "demo")]),
    }
    print(json.dumps(out), flush=True)
    return out


class _BenchFrames:
    """A ``synthetic`` module for the JAX bench's sections: the port's
    room sweep on the CPU with the arguments the section passes (made once
    per argument set: sections that share frames share them)."""

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _sweep(cam, n, sweep_deg, noise_seed):
        return synthetic.make_room_sweep(cam, n, sweep_deg=sweep_deg,
                                         noise_seed=noise_seed, device="cpu")

    @classmethod
    def make_room_sweep(cls, cam, num_frames, sweep_deg=360.0,
                        noise_seed=None):
        depths, gt = cls._sweep(CameraConfig(**dataclasses.asdict(cam)),
                                num_frames, float(sweep_deg), noise_seed)
        return list(depths), list(gt)


# timing fields of the bench's sections: CPU figures, not references
_BENCH_TIMINGS = ("fps", "_s", "_ms", "speedup", "dispatch_mode", "hitches")


def _run_bench() -> dict:
    """chip_smoke's ``bench`` phase: the JAX bench.py's sections at its
    cut frame counts (``BENCH_SECTIONS``, the stages aside: timings only),
    on the port's frames, under ``__graft_entry__.flagship_config()``; and
    ``_long_run`` at ``BENCH_GATHER`` with the Pallas gather on.  Prints
    each section's non-timing fields."""
    import bench
    import chip_smoke

    cfg = __graft_entry__.flagship_config()
    runs = [(name, fn, cfg, kw)
            for name, (fn, kw) in chip_smoke.BENCH_SECTIONS.items()
            if fn != "_stage_breakdown"]
    runs.append(("gather", "_long_run", _config("splat"),
                 chip_smoke.BENCH_GATHER))
    out = {}
    for name, fn, c, kw in runs:
        res = getattr(bench, fn)(c, hash_slam, _BenchFrames, metrics, **kw)
        out[name] = {k: v for k, v in res.items()
                     if not any(t in k for t in _BENCH_TIMINGS)}
        print(json.dumps({"run": "bench", "section": name, **out[name]}),
              flush=True)
    return out


def main(which) -> None:
    cam = CameraConfig()
    if "orbit" in which:
        depths, gt = synthetic.make_sequence(
            cam, 20, trans_amp=0.05, rot_amp_deg=2.5, device="cpu")
        _run("orbit", _config("splat"), depths, gt)
    if "dense" in which:
        depths, gt = synthetic.make_sequence(
            cam, 20, trans_amp=0.05, rot_amp_deg=2.5, device="cpu")
        _run_dense(depths, gt)
    if "march" in which:
        depths, gt = synthetic.make_room_sweep(
            cam, 24, sweep_deg=40.0, noise_seed=1, device="cpu")
        _run("march", _config("march"), depths, gt)
    if "backend" in which:
        _run_backend()
    if "stream" in which:
        _run_stream(twin=False)
    if "stream_twin" in which:
        _run_stream(twin=True)
    if "stream_backend" in which:
        _run_stream_backend()
    if "cli" in which:
        _run_cli()
    if "fixture" in which:
        _run_fixture()
    if "bench" in which:
        _run_bench()


if __name__ == "__main__":
    main(sys.argv[1:] or ["orbit", "march"])
