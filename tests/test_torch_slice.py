"""The PyTorch port's flagship frame step (models/hash_slam) against the
JAX package, end to end, under the tiny flagship-gather config (80x60
camera, flagship frontend/ICP/fusion/GC/splat, window gather on; the JAX
side runs its Pallas kernel in interpret mode).

Tolerances:
- 10 frames of the orbit sequence through both HashSLAMs: the same
  tracked flags; per-frame pose translation within 1e-4 m; unaligned ATE
  within 0.5 mm of the JAX value and below 11 mm; render hit fraction
  within 0.01 of the JAX value and above 0.5.
- One step from a carried JAX state: pose within 1e-5; integer map state
  and the step's counters bit-exact.  Each package fuses at its own
  tracked pose here, and a pose difference of ~1e-6 moves the odd voxel's
  projection onto the neighbouring pixel, so the float rows (tsdf, weight,
  band_min) and the model maps are compared by their share of entries
  within atol 1e-5 (>= 99.9%).  With the JAX pose given to both, the map
  rows agree everywhere (tests/test_torch_hash_ops.py).
- Synthetic frames: poses within 1e-6; raw depth equal on >= 99% of the
  pixels and within 1 unit (0.2 mm) everywhere (sphere tracing in float32
  with another op order can stop one step apart).
- ``raycast.mode = "march"`` (the view-local cache and the sphere tracer
  as the model), 10 frames, and ``DenseSLAM`` on a 160x128x160 dense grid,
  8 frames: tracked flags equal, pose translation within 1e-4 m per frame,
  unaligned ATE within 0.5 mm of the JAX value.  The 96 march steps
  (128 on the dense grid) accumulate rounding differences, so this is a
  tolerance, not equality.
- Default device: every entry point takes the CUDA card when none is
  named and does not fall back; without a card it raises torch's error.
  All runs here pass ``device="cpu"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_sequence, np_tree,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu import config as jcfg_mod
from voxelhashing_demo_tpu.models import dense_slam as jds
from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.utils import metrics as jmetrics
from voxelhashing_demo_tpu.utils import synthetic as jsyn
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch import config as tcfg_mod
from voxelhashing_demo_tpu_torch.models import dense_slam as tds
from voxelhashing_demo_tpu_torch.models import hash_slam as ths
from voxelhashing_demo_tpu_torch.utils import metrics as tmetrics
from voxelhashing_demo_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

N = 10
CARRY_K = 6


@pytest.fixture(scope="module")
def runs():
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, gt = jax_sequence(jc.camera, N)
    state = jhs.create(jc)
    jstates, jinfos = [], []
    for d in depths:
        jstates.append(np_tree(state))
        state, info = jhs.step(state, jnp.asarray(d), jc)
        jinfos.append(np_tree(info))
    js = jhs.HashSLAM(jc)
    js.state = state
    jhit = float(np.asarray(js.render().hit).mean())

    ts = ths.HashSLAM(tc, device="cpu")
    for d in depths:
        ts.process(d)
    thit = float(ts.render().hit.float().mean())
    return dict(jc=jc, tc=tc, depths=depths, gt=gt, jstates=jstates,
                jinfos=jinfos, jhit=jhit, ts=ts, thit=thit)


def test_slice_tracking_matches_jax(runs):
    jinfos, ts = runs["jinfos"], runs["ts"]
    assert ([bool(i["tracked"]) for i in jinfos]
            == [bool(i.tracked) for i in ts.infos])
    assert sum(bool(i.tracked) for i in ts.infos) >= N - 1
    for ji, ti in zip(jinfos, ts.infos):
        np.testing.assert_allclose(ti.pose.numpy()[:3, 3],
                                   ji["pose"][:3, 3], atol=1e-4)
        assert np.isfinite(ti.pose.numpy()).all()


def test_slice_map_counters_match_jax(runs):
    for ji, ti in zip(runs["jinfos"], runs["ts"].infos):
        for f in ("blocks_allocated", "blocks_active", "blocks_freed",
                  "free_blocks", "valid_px", "icp_iters"):
            assert int(getattr(ti, f)) == int(ji[f]), f


def test_slice_ate_and_render_match_jax(runs):
    gt = runs["gt"]
    ate_j = jmetrics.ate_rmse([i["pose"] for i in runs["jinfos"]], gt,
                              align=False)
    ate_t = tmetrics.ate_rmse(runs["ts"].trajectory, gt, align=False)
    assert abs(ate_t - ate_j) < 0.5e-3
    assert ate_t < 11e-3
    assert abs(runs["thit"] - runs["jhit"]) < 0.01
    assert runs["thit"] > 0.5


def test_step_from_carried_jax_state(runs):
    jc, tc = runs["jc"], runs["tc"]
    d = runs["depths"][CARRY_K]
    js_np = runs["jstates"][CARRY_K]
    jstate = jhs.HashSLAMState(
        hmap=jhs.hash_ops.HashMap(**{
            f: jnp.asarray(js_np[f"hmap.{f}"])
            for f in jhs.hash_ops.HashMap._fields}),
        pose=jnp.asarray(js_np["pose"]),
        model=jhs.pre_ops.Frame(**{
            f: jnp.asarray(js_np[f"model.{f}"])
            for f in jhs.pre_ops.Frame._fields}),
        frame_idx=jnp.int32(js_np["frame_idx"]),
        vel=jnp.asarray(js_np["vel"]),
    )
    jnew, jinfo = jhs.step(jstate, jnp.asarray(d), jc)
    tnew, tinfo = ths.step(convert.state_from_numpy(js_np, device="cpu"),
                           torch.from_numpy(d.astype(np.int32)), tc)
    np.testing.assert_allclose(tinfo.pose.numpy(), np.asarray(jinfo.pose),
                               atol=1e-5)
    jn, tn = np_tree(jnew), convert.state_to_numpy(tnew)
    assert set(jn) == set(tn)
    for k in jn:
        if jn[k].dtype == np.int32:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
        elif k in ("pose", "vel"):
            np.testing.assert_allclose(tn[k], jn[k], atol=1e-5, err_msg=k)
        else:
            close = np.isclose(tn[k], jn[k], rtol=0.0, atol=1e-5)
            assert close.mean() >= 0.999, (k, close.mean())
    for f in ("tracked", "blocks_allocated", "blocks_active",
              "blocks_freed", "free_blocks", "valid_px", "icp_iters"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f


def test_convert_roundtrip(runs):
    d = runs["jstates"][3]
    back = convert.state_to_numpy(convert.state_from_numpy(d, device="cpu"))
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    act = dict(blocks=np.ones((4, 3), np.int32), ptrs=np.arange(4, dtype=np.int32),
               count=np.int32(3))
    back = convert.active_to_numpy(
        convert.active_from_numpy(act, device="cpu"))
    for k in act:
        np.testing.assert_array_equal(back[k], act[k])


def test_synthetic_matches_jax(runs):
    tc = runs["tc"]
    jd, jp = runs["depths"][:3], runs["gt"][:3]
    td, tp = tsyn.make_sequence(tc.camera, N, trans_amp=0.05,
                                rot_amp_deg=2.5, device="cpu")
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(td[:3], jd):
        assert a.dtype == np.uint16 and a.shape == b.shape
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert (diff == 0).mean() >= 0.99 and diff.max() <= 1
    T = jp[1]
    np.testing.assert_allclose(
        tsyn.scene_sdf(tt(T[:3, :3])).numpy(),
        np.asarray(jsyn.scene_sdf(jnp.asarray(T[:3, :3]))), atol=1e-6)


def test_metrics_match_jax(runs):
    rng = np.random.default_rng(0)
    est = [np.eye(4) + np.pad(rng.normal(size=(3, 4)) * 1e-2, ((0, 1), (0, 0)))
           for _ in range(6)]
    gt = runs["gt"][:6]
    for align in (False, True):
        assert (tmetrics.ate_rmse(est, gt, align=align)
                == jmetrics.ate_rmse(est, gt, align=align))
    assert tmetrics.rpe(est, gt, 2) == jmetrics.rpe(est, gt, 2)


def test_unported_options_raise(runs):
    """An unknown prediction mode is refused; streaming, ported since,
    builds a host block store."""
    tc = runs["tc"]
    assert ths.HashSLAM(dataclasses.replace(
        tc, stream=dataclasses.replace(tc.stream, enabled=True)),
        device="cpu").store is not None
    with pytest.raises(ValueError):
        ths.HashSLAM(dataclasses.replace(
            tc, raycast=dataclasses.replace(tc.raycast, mode="sweep")),
            device="cpu")


def _march(cfg):
    """The flagship march settings as they are (96 steps, 256^3 cache):
    at 2 cm voxels a smaller cache does not reach the scene."""
    return dataclasses.replace(
        cfg, raycast=dataclasses.replace(cfg.raycast, mode="march"))


def _compare_runs(jslam, tslam, gt):
    n = len(gt)
    jt = [bool(i.tracked) for i in jslam.infos]
    assert jt == [bool(i.tracked) for i in tslam.infos]
    assert sum(jt) >= n - 1
    for jp, tp in zip(jslam.trajectory, tslam.trajectory):
        assert np.isfinite(tp.numpy()).all()
        np.testing.assert_allclose(tp.numpy()[:3, 3],
                                   np.asarray(jp)[:3, 3], atol=1e-4)
    ate_j = jmetrics.ate_rmse(jslam.trajectory, gt, align=False)
    ate_t = tmetrics.ate_rmse(tslam.trajectory, gt, align=False)
    assert abs(ate_t - ate_j) < 0.5e-3, (ate_t, ate_j)


@pytest.fixture(scope="module")
def march_runs(runs):
    jc, tc = _march(runs["jc"]), _march(runs["tc"])
    js, ts = jhs.HashSLAM(jc), ths.HashSLAM(tc, device="cpu")
    for d in runs["depths"]:
        js.process(d)
        ts.process(d)
    return js, ts


def test_march_slice_tracking_matches_jax(runs, march_runs):
    js, ts = march_runs
    _compare_runs(js, ts, runs["gt"])
    for ji, ti in zip(js.infos, ts.infos):
        for f in ("blocks_allocated", "blocks_active", "blocks_freed"):
            assert int(getattr(ti, f)) == int(getattr(ji, f)), f


def test_march_render_matches_jax(march_runs):
    js, ts = march_runs
    jo, to = js.render(), ts.render()
    jh, th = np.asarray(jo.hit), to.hit.numpy()
    assert (jh == th).mean() >= 0.999
    assert th.mean() > 0.5
    both = jh & th
    close = np.abs(to.depth.numpy() - np.asarray(jo.depth))[both] <= 1e-4
    assert close.mean() >= 0.999
    # another viewpoint than the tracked one
    pose = np.array(js.trajectory[3])
    jh2 = np.asarray(js.render(pose).hit)
    th2 = ts.render(pose).hit.numpy()
    assert (jh2 == th2).mean() >= 0.999


def _dense_cfg(mod):
    """The 80x60 test camera over a dense grid that holds the scene (the
    grid of tests/test_dense_pipeline.py), for either package."""
    return mod.PipelineConfig(
        camera=mod.tiny_config().camera,
        fusion=mod.FusionConfig(voxel_size=0.02, truncation=0.08),
        grid=mod.DenseGridConfig(dims=(160, 128, 160),
                                 origin=(-1.6, -0.7, 0.0)),
        raycast=mod.RaycastConfig(max_steps=128),
    )


def test_dense_slam_matches_jax(runs):
    n = 8
    jc, tc = _dense_cfg(jcfg_mod), _dense_cfg(tcfg_mod)
    js = jds.DenseSLAM(jc)
    ts = tds.DenseSLAM(tc, device="cpu")
    for d in runs["depths"][:n]:
        js.process(jnp.asarray(d))
        ts.process(d)
    _compare_runs(js, ts, runs["gt"][:n])
    jo, to = js.render(), ts.render()
    assert (np.asarray(jo.hit) == to.hit.numpy()).mean() >= 0.999
    assert ts.state.frame_idx == n
    back = convert.dense_state_to_numpy(convert.dense_state_from_numpy(
        convert.dense_state_to_numpy(ts.state), device="cpu"))
    jn = np_tree(js.state)
    assert set(back) == set(jn)
    for k in ("tsdf.origin", "tsdf.voxel_size"):
        np.testing.assert_array_equal(back[k], jn[k])
    close = np.isclose(back["tsdf.sdf"], jn["tsdf.sdf"], rtol=0, atol=1e-4)
    assert close.mean() >= 0.999


ENTRY_POINTS = {
    "HashSLAM": lambda c: ths.HashSLAM(c),
    "hash_slam.create": lambda c: ths.create(c),
    "DenseSLAM": lambda c: tds.DenseSLAM(c),
    "dense_slam.create": lambda c: tds.create(c),
    "make_sequence": lambda c: tsyn.make_sequence(c.camera, 1),
    "make_room_sweep": lambda c: tsyn.make_room_sweep(c.camera, 1),
    "make_ramp_sequence": lambda c: tsyn.make_ramp_sequence(c.camera, 1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    """No device named: the entry point goes to the CUDA card.  Where
    there is none it raises torch's own error; it never runs on the CPU."""
    from voxelhashing_demo_tpu_torch.device import default_device

    assert default_device() == torch.device("cuda")
    cfg = tcfg_mod.tiny_config()
    if torch.cuda.is_available():
        out = ENTRY_POINTS[name](cfg)
        dev = getattr(out, "device", None) or getattr(out, "pose").device
        assert torch.device(dev).type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ENTRY_POINTS[name](cfg)
