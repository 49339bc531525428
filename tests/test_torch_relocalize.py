"""Tracking-lost recovery of the PyTorch port's ``KeyframeSLAM`` against
the JAX package: the kidnapped-camera scenario of
tests/test_backend_robustness.py at 160x120.

Sweep a room for 16 frames, black the sensor out for 3, resume at a much
earlier part of the sweep.  Frame-to-model ICP diverges against the stale
model; the relocalizer seeds a registration against each stored keyframe
with the raced Procrustes init, refines it by pair ICP and resets pose,
model and velocity.  The frames are rendered by the port's synthetic module
on the CPU and go to both packages.

The relocalizer's gates decide with margin here: the accepted candidate has
several times ``min_loop_inliers`` (asserted below).  Against JAX: the
tracked flags, the keyframe frame indices and each relocalization's frame
and keyframe are equal, its inlier count within 2 %, the recovered tail
within 5 mm of JAX's and within 0.10 m of the ground truth (the JAX test's
bound).
"""

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu.models import keyframe_slam as jkf
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf
from voxelhashing_demo_tpu_torch.utils import synthetic

torch.set_num_threads(1)

SWEEP, N1 = 90.0, 16


def _reloc_cfg(c):
    return c.PipelineConfig(
        camera=c.CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                              cx=79.65, cy=59.8),
        icp=c.ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=c.FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=c.HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                          max_active=2048, max_new_per_frame=2048),
        raycast=c.RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=c.GCConfig(enabled=False),
        keyframes=c.KeyframeConfig(
            max_keyframes=64, max_edges=256,
            min_rotation_deg=4.0, min_translation=0.05,
            icp_downsample=2, loop_radius=0.6, min_loop_separation=6,
            min_loop_inliers=800, max_loop_error=1e-4, ba_iters=8,
            relocalize=True, reloc_after=2, reloc_interval=1,
            reloc_max_candidates=32,
        ),
    )


@pytest.fixture(scope="module")
def runs():
    cam = _reloc_cfg(tcfg).camera

    def room_frame(phase):
        T = synthetic.room_sweep_pose(phase, SWEEP)
        d = synthetic.render_depth(torch.as_tensor(T, dtype=torch.float32),
                                   cam, sdf=synthetic.room_sdf)
        return synthetic.depth_to_raw(d, cam), T

    T0_inv = np.linalg.inv(synthetic.room_sweep_pose(0.0, SWEEP))
    seq, gt = [], []
    for i in range(N1):                       # sweep 0 -> ~84 degrees
        d, T = room_frame(i / N1)
        seq.append(d)
        gt.append((T0_inv @ T).astype(np.float32))
    for _ in range(3):                        # sensor blackout
        seq.append(np.zeros_like(seq[0]))
        gt.append(None)
    for i in range(6):                        # kidnapped back to ~13 deg
        d, T = room_frame(0.145 + 0.02 * i)
        seq.append(d)
        gt.append((T0_inv @ T).astype(np.float32))

    js = jkf.KeyframeSLAM(_reloc_cfg(jcfg))
    ts = tkf.KeyframeSLAM(_reloc_cfg(tcfg), device="cpu")
    vel_after = []
    for d in seq:
        js.process(d)
        ts.process(d)
        vel_after.append(ts.state.vel.clone())
    return dict(js=js, ts=ts, jt=js.trajectory(), tt=ts.trajectory(), gt=gt,
                n=len(seq), vel_after=vel_after)


def test_relocalization_fires_and_recovers(runs):
    ts, tt_, gt, n = runs["ts"], runs["tt"], runs["gt"], runs["n"]
    assert len(ts.keyframes) >= 6
    assert len(ts.relocalizations) >= 1, "relocalization must fire"
    lost = [i for i, info in enumerate(ts.infos) if not bool(info.tracked)]
    assert len(lost) >= 3
    assert all(bool(i.tracked) for i in ts.infos[-3:])
    err = [float(np.linalg.norm(tt_[i][:3, 3] - gt[i][:3, 3]))
           for i in range(n - 3, n)]
    assert max(err) < 0.10, err
    # margin: the accepted registration is far above the inlier gate
    k = ts.kcfg
    for r in ts.relocalizations:
        assert r["inliers"] > 2 * k.min_loop_inliers
        assert r["error"] < 0.5 * k.max_loop_error


def test_relocalization_equals_jax(runs):
    js, ts = runs["js"], runs["ts"]
    assert ([bool(i.tracked) for i in ts.infos]
            == [bool(i.tracked) for i in js.infos])
    assert ([r.frame_index for r in ts.keyframes]
            == [r.frame_index for r in js.keyframes])
    assert len(ts.relocalizations) == len(js.relocalizations)
    for rt, rj in zip(ts.relocalizations, js.relocalizations):
        assert (rt["frame"], rt["keyframe"]) == (rj["frame"], rj["keyframe"])
        np.testing.assert_allclose(rt["inliers"], rj["inliers"], rtol=2e-2)
    for i in range(runs["n"] - 3, runs["n"]):
        np.testing.assert_allclose(runs["tt"][i][:3, 3],
                                   np.asarray(runs["jt"][i])[:3, 3],
                                   atol=5e-3)


def test_pose_model_and_velocity_reset(runs):
    """Right after the relocalizing frame the velocity is the identity
    (the JAX reset), and the next frame tracks against the re-rendered
    model."""
    ts = runs["ts"]
    f = ts.relocalizations[0]["frame"]
    assert torch.equal(runs["vel_after"][f], torch.eye(4))
    assert bool(ts.infos[f + 1].tracked)
    assert ts._lost_streak == 0


def test_blackout_frame_is_not_registered(runs):
    """The blackout gate: a frame with (nearly) no valid pixel gives None
    before any registration runs, with the drained count or without."""
    ts = runs["ts"]
    black = torch.zeros((120, 160), dtype=torch.int32)
    n_before = len(ts.relocalizations)
    assert ts._relocalize(black, valid_px=0) is None
    assert ts._relocalize(black) is None
    assert len(ts.relocalizations) == n_before
