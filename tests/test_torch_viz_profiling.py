"""PyTorch port: offline visualization (utils/viz.py) against the JAX
package, and the profiling utilities (utils/profiling.py) on the CPU.

Tolerances: PNG bytes of the shaded, depth and normal images are equal
for the same render (the port gets tensors, JAX numpy; both shade in
numpy float32); camera paths, frustum corners and the frustum overlay are
equal (numpy float32 in both)."""

import json
import os

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import CameraConfig as JCam
from voxelhashing_demo_tpu.utils import profiling as jprof
from voxelhashing_demo_tpu.utils import viz as jviz
from voxelhashing_demo_tpu_torch.config import CameraConfig as TCam
from voxelhashing_demo_tpu_torch.models import hash_slam
from voxelhashing_demo_tpu_torch.ops import raycast as trc
from voxelhashing_demo_tpu_torch.utils import profiling as tprof
from voxelhashing_demo_tpu_torch.utils import viz as tviz

torch.set_num_threads(1)


def _render(seed=0, h=30, w=40):
    """A seeded stand-in for a render: (numpy fields, the port's
    RaycastOutput of the same values)."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0.3, 4.5, (h, w))
    hit = rng.random((h, w)) < 0.8
    depth = np.where(hit, pts[..., 2], 0.0).astype(np.float32)
    fields = dict(depth=depth, points=pts, normals=n, hit=hit)
    out = trc.RaycastOutput(**{k: torch.from_numpy(v.copy())
                               for k, v in fields.items()})
    return fields, out


class _NpOut:
    def __init__(self, d):
        self.__dict__.update(d)


@pytest.mark.parametrize("kind", ["shade", "depth", "normal",
                                  "normal_no_hit"])
def test_png_bytes_equal_jax(tmp_path, kind):
    fields, out = _render(seed=["shade", "depth", "normal",
                                "normal_no_hit"].index(kind))
    j = _NpOut(fields)
    if kind == "shade":
        a, b = jviz.shade_rgb(j), tviz.shade_rgb(out)
    elif kind == "depth":
        a, b = jviz.depth_rgb(j.depth), tviz.depth_rgb(out.depth)
    elif kind == "normal":
        a, b = (jviz.normal_rgb(j.normals, j.hit),
                tviz.normal_rgb(out.normals, out.hit))
    else:
        a, b = jviz.normal_rgb(j.normals), tviz.normal_rgb(out.normals)
    assert b.dtype == np.uint8 and b.shape == fields["depth"].shape + (3,)
    np.testing.assert_array_equal(a, b)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    jviz.write_png_rgb(pa, a)
    tviz.write_png_rgb(pb, b)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    # numpy inputs give the same image as tensors
    if kind == "shade":
        np.testing.assert_array_equal(tviz.shade_rgb(j), b)


def test_shade_of_a_real_render_matches_jax():
    """A render of a fused map (port, CPU) shaded by both packages."""
    from voxelhashing_demo_tpu_torch.config import tiny_config
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = tiny_config()
    depths, _ = synthetic.make_sequence(cfg.camera, 2, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device="cpu")
    for d in depths:
        slam.process(d)
    out = slam.render()
    j = _NpOut({k: getattr(out, k).numpy() for k in out._fields})
    assert out.hit.float().mean() > 0.3
    np.testing.assert_array_equal(tviz.shade_rgb(out), jviz.shade_rgb(j))
    np.testing.assert_array_equal(tviz.depth_rgb(out.depth),
                                  jviz.depth_rgb(j.depth))


def test_camera_paths_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        eye, target = rng.normal(size=3), rng.normal(size=3)
        np.testing.assert_array_equal(tviz.look_at(eye, target),
                                      jviz.look_at(eye, target))
    a = tviz.orbit_poses((0.1, -0.2, 1.5), 1.2, -0.3, 7, sweep_deg=120)
    b = jviz.orbit_poses((0.1, -0.2, 1.5), 1.2, -0.3, 7, sweep_deg=120)
    assert len(a) == 7
    np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_frustum_overlay_matches_jax():
    cam = dict(width=80, height=60, fx=64.6, fy=64.5, cx=39.6, cy=31.7)
    tc, jc = TCam(**cam), JCam(**cam)
    view = tviz.look_at((0.0, -0.5, -2.0), (0.0, 0.0, 1.0))
    fr = tviz.look_at((0.3, 0.0, 0.0), (0.0, 0.2, 2.0))
    np.testing.assert_array_equal(tviz.frustum_corners(tc, fr, 0.2, 2.0),
                                  jviz.frustum_corners(jc, fr, 0.2, 2.0))
    img = np.zeros((60, 80, 3), np.uint8)
    a = tviz.draw_frustum(img, tc, view, tc, fr)
    b = jviz.draw_frustum(img, jc, view, jc, fr)
    assert a.any() and not img.any()
    np.testing.assert_array_equal(a, b)


def test_stage_timer_on_the_cpu():
    t = tprof.StageTimer(device="cpu")
    for _ in range(3):
        with t.stage("work") as h:
            h["out"] = torch.ones((8, 8)) * 2
    with t.stage("other"):
        pass
    s = t.summary()
    assert s["work"]["count"] == 3 and s["other"]["count"] == 1
    jt = jprof.StageTimer()
    with jt.stage("work"):
        pass
    assert set(s["work"]) == set(jt.summary()["work"])
    assert 0 <= s["work"]["min_ms"] <= s["work"]["mean_ms"] \
        <= s["work"]["max_ms"]
    assert len(t.records["work"]) == 3
    assert "work" in t.report() and "other" in t.report()


def test_metrics_log_and_step_info(tmp_path):
    from voxelhashing_demo_tpu_torch.config import tiny_config
    from voxelhashing_demo_tpu_torch.utils import synthetic

    path = str(tmp_path / "m.jsonl")
    log = tprof.MetricsLog(path)
    log.log(frame=0, err=torch.tensor(0.5), ok=True, xs=(torch.tensor(1),
                                                        2))
    log.log(frame=1, err=0.25, ok=False)
    cfg = tiny_config()
    depths, _ = synthetic.make_sequence(cfg.camera, 2, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device="cpu")
    for i, d in enumerate(depths):
        log.log_step_info(i + 2, slam.process(d))
    log.close()
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == 4 == len(log.rows)
    assert rows[0] == {"frame": 0, "err": 0.5, "ok": True, "xs": [1, 2]}
    assert rows[1]["ok"] is False
    info = slam.infos[-1]
    assert rows[3] == {
        "frame": 3, "tracked": bool(info.tracked),
        "icp_error": float(info.icp_error),
        "icp_iters": int(info.icp_iters),
        "icp_count": int(info.icp_count),
        "blocks_allocated": int(info.blocks_allocated),
        "blocks_active": int(info.blocks_active),
        "blocks_freed": int(info.blocks_freed),
        "free_blocks": int(info.free_blocks),
    }
    # the JAX log writes the same keys for the same step
    jrow = jprof.MetricsLog()
    jrow.log_step_info(3, info._replace(**{
        k: getattr(info, k).numpy() for k in info._fields}))
    assert jrow.rows[0] == rows[3]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
