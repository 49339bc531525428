"""PyTorch port: the streaming frame pipeline (utils/stream.py), the checks
of the JAX package's tests/test_stream.py with ``device="cpu"``, against
the JAX pipeline on the same TUM directory.

Tolerances: frames equal to direct reads and to the JAX pipeline's frames;
a HashSLAM fed by the pipeline tracks as one fed the decoded frames
(poses equal: the same int32 frames go through the same code)."""

import glob
import os
import threading

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.utils import stream as jstream
from voxelhashing_demo_tpu_torch.config import tiny_config
from voxelhashing_demo_tpu_torch.utils import io as depth_io
from voxelhashing_demo_tpu_torch.utils import stream, synthetic, tum

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    cfg = tiny_config()
    root = str(tmp_path_factory.mktemp("tum_seq"))
    depths, poses = synthetic.make_sequence(cfg.camera, 6, trans_amp=0.04,
                                            rot_amp_deg=2.0, device="cpu")
    tum.export_sequence(root, depths, poses)
    return root, cfg, depths, poses


def test_stream_matches_direct_reads_and_jax(tum_dir):
    root, cfg, depths, _ = tum_dir
    pipe, gt = stream.stream_tum(root, cfg.camera.width, cfg.camera.height,
                                 device="cpu")
    assert gt is not None and len(gt) == 6
    got = list(pipe)
    assert len(got) == 6 == len(pipe)
    jpipe, jgt = jstream.stream_tum(root, cfg.camera.width,
                                    cfg.camera.height)
    for a, b, j in zip(got, depths, jpipe):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    for p, q in zip(gt, jgt):
        np.testing.assert_array_equal(p, q)


def test_small_decode_batches_and_prefetch(tum_dir):
    root, cfg, depths, _ = tum_dir
    paths = sorted(glob.glob(os.path.join(root, "depth", "*.png")))
    pipe = stream.FramePipeline(paths, cfg.camera.width, cfg.camera.height,
                                prefetch=1, decode_batch=4, device="cpu")
    for a, b in zip(pipe, depths):
        np.testing.assert_array_equal(a.numpy(), b)
    assert pipe.consumer_waits >= 0


def test_stream_propagates_decode_errors(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    pipe = stream.FramePipeline([str(bad)], 80, 60, device="cpu")
    with pytest.raises(ValueError):
        list(pipe)


def test_batch_decode_rejects_wrong_size(tum_dir):
    root, cfg, _, _ = tum_dir
    paths = sorted(glob.glob(os.path.join(root, "depth", "*.png")))[:2]
    with pytest.raises(ValueError):
        depth_io.read_depth_batch(paths, cfg.camera.width * 2,
                                  cfg.camera.height * 2)
    pipe = stream.FramePipeline(paths, cfg.camera.width * 2,
                                cfg.camera.height * 2, device="cpu")
    with pytest.raises(ValueError):
        list(pipe)


def test_stream_close_stops_abandoned_producer(tum_dir):
    root, cfg, _, _ = tum_dir
    pipe, _ = stream.stream_tum(root, cfg.camera.width, cfg.camera.height,
                                prefetch=1, device="cpu")
    it = iter(pipe)
    next(it)                      # consume one; the producer blocks on put
    pipe.close()
    assert not pipe._thread.is_alive()
    assert threading.active_count() < 50


def test_stream_drives_slam(tum_dir):
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.utils import metrics

    root, cfg, depths, _ = tum_dir
    pipe, gt = stream.stream_tum(root, cfg.camera.width, cfg.camera.height,
                                 device="cpu")
    slam = hash_slam.HashSLAM(cfg, device="cpu")
    for d in pipe:
        slam.process(d)
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    assert ate < 0.02, f"streamed SLAM ATE {ate}"
    direct = hash_slam.HashSLAM(cfg, device="cpu")
    for d in depths:
        direct.process(d)
    for a, b in zip(slam.trajectory, direct.trajectory):
        assert torch.equal(a, b)


def test_default_device_is_the_card(tum_dir, monkeypatch):
    """``device=None`` resolves to the CUDA card: without one the pipeline
    fails with torch's own error and starts no producer."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    root, cfg, _, _ = tum_dir
    before = threading.active_count()
    with pytest.raises((RuntimeError, AssertionError)):
        stream.stream_tum(root, cfg.camera.width, cfg.camera.height)
    assert threading.active_count() == before
