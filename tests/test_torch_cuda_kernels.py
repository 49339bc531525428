"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips (with its reason) where no CUDA
card is present.  This file imports no JAX, so it also runs on a machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: both window gathers are bit-exact (values and covered); the
frame step on the card agrees with the step on the CPU within 1e-4 m of
pose translation per frame over 10 frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu_torch.ops import window_gather as wg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.parametrize("spread", [120, 400, None])
def test_window_gather_kernel_bit_exact(cuda, spread):
    H, W, C, V = 480, 640, 4096, 512
    rng = np.random.default_rng(0)
    depth = torch.as_tensor(rng.random((H, W), dtype=np.float32) + 0.5,
                            device=cuda)
    if spread is None:                       # invalid far-corner voxel
        v, u = np.full((C, V), 100), np.full((C, V), 200)
        valid = np.ones((C, V), bool)
        v[:, 0], u[:, 0], valid[:, 0] = H - 1, W - 1, False
    else:
        v = rng.integers(0, H - spread, (C, 1)) + rng.integers(0, spread,
                                                                (C, V))
        u = rng.integers(0, W - spread, (C, 1)) + rng.integers(0, spread,
                                                                (C, V))
        valid = rng.random((C, V)) > 0.15
    vt = torch.as_tensor(v, dtype=torch.int32, device=cuda)
    ut = torch.as_tensor(u, dtype=torch.int32, device=cuda)
    mt = torch.as_tensor(valid, device=cuda)
    before = wg.LAUNCHES
    got, got_cov = wg.gather_depth_window(depth, vt, ut, mt)
    assert wg.LAUNCHES == before + 1
    ref, ref_cov = wg.gather_depth_window_reference(depth, vt, ut, mt)
    torch.cuda.synchronize()
    assert torch.equal(got_cov, ref_cov)
    assert torch.equal(got, ref)


def _streamed_case(rng, rows, vlen, spread, H=480, W=640):
    v = rng.integers(0, H - spread, (rows, 1)) + rng.integers(
        0, spread, (rows, vlen))
    u = rng.integers(0, W - spread, (rows, 1)) + rng.integers(
        0, spread, (rows, vlen))
    return v, u, rng.random((rows, vlen)) > 0.15


# (rows, row length, spread): full width; clipped; rows % 8 != 0; a row
# length that is no multiple of 4 (scalar path); a row longer than what a
# lane keeps in registers; a row longer than one CTA of the first kernel
@pytest.mark.parametrize("rows,vlen,spread", [
    (4096, 512, 120), (4096, 512, 400), (4099, 512, 120), (37, 510, 120),
    (64, 1000, 400), (9, 4096, 300)])
def test_streamed_kernel_bit_exact(cuda, rows, vlen, spread):
    rng = np.random.default_rng(1)
    depth = torch.as_tensor(rng.random((480, 640), dtype=np.float32) + 0.5,
                            device=cuda)
    v, u, valid = _streamed_case(rng, rows, vlen, spread)
    vt = torch.as_tensor(v, dtype=torch.int32, device=cuda)
    ut = torch.as_tensor(u, dtype=torch.int32, device=cuda)
    mt = torch.as_tensor(valid, device=cuda)
    before = wg.LAUNCHES_STREAMED
    got, got_cov = wg.gather_depth_window_streamed(depth, vt, ut, mt)
    assert wg.LAUNCHES_STREAMED == before + 1
    ref, ref_cov = wg.gather_depth_window_streamed_reference(depth, vt, ut,
                                                             mt)
    torch.cuda.synchronize()
    assert torch.equal(got_cov, ref_cov)
    assert torch.equal(got, ref)
    if spread == 400:
        assert int(got_cov.sum()) < int(mt.sum())


def test_streamed_kernel_unaligned_rows(cuda):
    """Rows that do not start on a 16-byte boundary (a slice one element
    into a buffer) take the scalar path and still agree."""
    rng = np.random.default_rng(2)
    depth = torch.as_tensor(rng.random((480, 640), dtype=np.float32) + 0.5,
                            device=cuda)
    v, u, valid = _streamed_case(rng, 16, 512, 120)

    def shifted(a, dtype):
        buf = torch.empty(a.size + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(torch.as_tensor(a, dtype=dtype))
        return view

    vt, ut = shifted(v, torch.int32), shifted(u, torch.int32)
    mt = torch.as_tensor(valid, device=cuda)
    got, got_cov = wg.gather_depth_window_streamed(depth, vt, ut, mt)
    ref, ref_cov = wg.gather_depth_window_reference(depth, vt, ut, mt)
    torch.cuda.synchronize()
    assert torch.equal(got_cov, ref_cov) and torch.equal(got, ref)


def test_streamed_mixed_devices_raise(cuda):
    d = torch.ones((60, 80), device=cuda)
    v = torch.zeros((8, 512), dtype=torch.int32)
    with pytest.raises(ValueError):
        wg.gather_depth_window_streamed(
            d, v, v, torch.ones_like(v, dtype=torch.bool))
    with pytest.raises(ValueError):
        wg.gather_depth_window(d, v, v, torch.ones_like(v, dtype=torch.bool))


def test_window_gather_rejects_bad_input(cuda):
    d = torch.ones((60, 80), device=cuda)
    v = torch.zeros((8, 512), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        wg.gather_depth_window(d, v, v, torch.ones_like(v, dtype=torch.bool))


def test_frame_step_card_matches_cpu(cuda):
    from voxelhashing_demo_tpu_torch.config import (flagship_gather_config,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, camera=tiny_config().camera,
        hash=dataclasses.replace(base.hash, num_buckets=4096,
                                 num_blocks=4096, max_active=2048,
                                 max_new_per_frame=2048))
    depths, _ = synthetic.make_sequence(cfg.camera, 10, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    runs = []
    for dev in ("cpu", cuda):
        slam = hash_slam.HashSLAM(cfg, device=dev)
        for d in depths:
            slam.process(d)
        runs.append(slam)
    cpu, gpu = runs
    for a, b in zip(cpu.infos, gpu.infos):
        assert bool(a.tracked) == bool(b.tracked)
        np.testing.assert_allclose(b.pose.cpu().numpy()[:3, 3],
                                   a.pose.numpy()[:3, 3], atol=1e-4)
