"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips (with its reason) where no CUDA
card is present.  This file imports no JAX, so it also runs on a machine
that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: both window gathers are bit-exact (values and covered), on
de-integration rows too; the frame step on the card agrees with the step on
the CPU within 1e-4 m of pose translation per frame over 10 frames;
``pose_graph.optimize`` repeats bit for bit on the card and agrees with the
CPU within 1e-4; the streaming cycle's copies (pinned buffers, side
stream) return what was sent, bit for bit; the probe kernels K16 and K17
equal their plain versions bit for bit over index counts, pointer
alignments, strip widths, strided views, the direct path of a tall source
and out-of-range indices.  The ICP kernels (K4 ``icp_gn_level``, K4s
``icp_sums``) at the flagship's three pyramid levels: bit for bit against
their in-order references (K4s's system and score sums, one K4 iteration,
whole levels, the L4 race as C = 2 and a batch of 4), the system within
rtol 1e-5 of the float64 sum of its own terms (and within 1e-4 of the
plain one in norm), the score sums within rtol 1e-5 of the plain ones, the
flagship pyramid within 1e-5 of the plain loops with equal iteration
counts in 3 launches; a level makes no host sync and replays from a CUDA
graph bit for bit; a refused launch raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu_torch.ops import window_gather as wg

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


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


def _on_card(cuda, depth, v, u, valid):
    return (torch.as_tensor(depth, device=cuda),
            torch.as_tensor(v, dtype=torch.int32, device=cuda),
            torch.as_tensor(u, dtype=torch.int32, device=cuda),
            torch.as_tensor(valid, device=cuda))


def _assert_both_kernels(args):
    """Both kernels against the first plain version, bit-exact; one
    launch each."""
    ref, ref_cov = wg.gather_depth_window_reference(*args)
    n1, n2 = wg.LAUNCHES, wg.LAUNCHES_STREAMED
    for fn in (wg.gather_depth_window, wg.gather_depth_window_streamed):
        got, got_cov = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(got_cov, ref_cov), fn.__name__
        assert torch.equal(got, ref), fn.__name__
    assert (wg.LAUNCHES, wg.LAUNCHES_STREAMED) == (n1 + 1, n2 + 1)
    return ref_cov


# The cases of tests/test_torch_window_gather.py's contract sweep, on the
# card: one row, row counts that are no multiple of 8 (131 is under the
# SM count of a 132-SM card, 265 just over twice it), row lengths that fill
# the first kernel's 256-thread CTAs (512), need its 512-thread ones (520,
# 1000), leave threads idle (8, 510) and take the streamed kernel's scalar
# loops (510, 1000).
@pytest.mark.parametrize("vlen", [8, 510, 512, 520, 1000])
@pytest.mark.parametrize("rows", [1, 7, 131, 265])
def test_both_kernels_over_shapes(cuda, rows, vlen):
    H, W = 300, 320
    rng = np.random.default_rng(1000 * rows + vlen)
    depth = rng.random((H, W), dtype=np.float32) + 0.5
    v = rng.integers(0, H - 280, (rows, 1)) + rng.integers(0, 280,
                                                           (rows, vlen))
    u = rng.integers(0, W - 280, (rows, 1)) + rng.integers(0, 280,
                                                           (rows, vlen))
    valid = rng.random((rows, vlen)) > 0.15
    cov = _assert_both_kernels(_on_card(cuda, depth, v, u, valid))
    if vlen >= 510:
        assert int(cov.sum()) < int(valid.sum())     # the window clipped


@pytest.mark.parametrize("kind", ["all_invalid_row", "wide_footprint",
                                  "small_image", "two_chunks_per_thread"])
def test_both_kernels_special_rows(cuda, kind):
    rng = np.random.default_rng(31)
    H, W = (60, 80) if kind == "small_image" else (480, 640)
    vlen = 1024 if kind == "two_chunks_per_thread" else 512
    depth = rng.random((H, W), dtype=np.float32) + 0.5
    v = rng.integers(0, H, (9, vlen))
    u = rng.integers(0, W, (9, vlen))
    valid = rng.random((9, vlen)) > 0.15
    if kind == "all_invalid_row":
        v, u = v // 4, u // 4
        valid[2] = False
        valid[8] = False
    cov = _assert_both_kernels(_on_card(cuda, depth, v, u, valid))
    if kind in ("all_invalid_row", "small_image"):
        assert int(cov.sum()) == int(valid.sum())
    else:
        assert int(cov.sum()) < int(valid.sum())


def test_both_kernels_on_a_frame_steps_rows(cuda):
    """The gather inputs a tiny frame step produces on the card."""
    from voxelhashing_demo_tpu_torch.config import (flagship_gather_config,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = flagship_gather_config()
    cfg = dataclasses.replace(
        base, camera=tiny_config().camera,
        hash=dataclasses.replace(base.hash, num_buckets=4096,
                                 num_blocks=4096, max_active=2048,
                                 max_new_per_frame=2048))
    depths, _ = synthetic.make_sequence(cfg.camera, 3, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device=cuda)
    for d in depths:
        slam.process(d)
    st = slam.state
    frame = pre_ops.preprocess(hash_slam.depth_tensor(depths[-1], cuda),
                               cfg.camera, cfg.frontend)
    active = hash_ops.compact_visible(st.hmap, cfg.hash, st.pose,
                                      cfg.camera, cfg.fusion)
    n = int(active.count)
    _, v, u, in_img, row_valid = hash_ops.project_rows(
        active.blocks[:n], active.ptrs[:n], cfg.hash, se3.inverse(st.pose),
        cfg.camera, cfg.fusion)
    assert n > 0
    _assert_both_kernels((frame.depth.contiguous(), v, u,
                          in_img & row_valid[:, None]))


def test_first_kernel_unaligned_rows(cuda):
    """Rows off a 16-byte boundary: the first kernel reads them with the
    same 4-byte loads as aligned ones and still agrees."""
    rng = np.random.default_rng(3)
    depth = torch.as_tensor(rng.random((480, 640), dtype=np.float32) + 0.5,
                            device=cuda)
    v, u, valid = _streamed_case(rng, 300, 512, 120)

    def shifted(a, dtype):
        buf = torch.empty(a.size + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(a.shape)
        view.copy_(torch.as_tensor(a, dtype=dtype))
        return view

    _assert_both_kernels((depth, shifted(v, torch.int32),
                          shifted(u, torch.int32),
                          shifted(valid, torch.bool)))


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


def _tiny_gather_config():
    from voxelhashing_demo_tpu_torch.config import (flagship_gather_config,
                                                    tiny_config)

    base = flagship_gather_config()
    return dataclasses.replace(
        base, camera=tiny_config().camera,
        hash=dataclasses.replace(base.hash, num_buckets=4096,
                                 num_blocks=4096, max_active=2048,
                                 max_new_per_frame=2048))


def test_first_kernel_on_deintegration_rows(cuda):
    """The gather inputs of a de-integration call: the rows an earlier
    frame's depth sees at the pose it was fused at, on a map that has
    grown since.  Bit-exact against the plain version, and the move
    (``make_reintegrate``: sign -1 at the old pose, +1 at the new) launches
    the kernel exactly twice."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.models import hash_slam, keyframe_slam
    from voxelhashing_demo_tpu_torch.ops import hash_ops
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = _tiny_gather_config()
    depths, _ = synthetic.make_sequence(cfg.camera, 6, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device=cuda)
    for d in depths:
        slam.process(d)
    old_pose = slam.trajectory[2]
    depth_raw = hash_slam.depth_tensor(depths[2], cuda)
    frame = pre_ops.preprocess(depth_raw, cfg.camera, cfg.frontend)
    hmap = slam.state.hmap
    active = hash_ops.compact_visible(hmap, cfg.hash, old_pose, cfg.camera,
                                      cfg.fusion)
    n = int(active.count)
    assert n > 0
    _, v, u, in_img, row_valid = hash_ops.project_rows(
        active.blocks[:n], active.ptrs[:n], cfg.hash, se3.inverse(old_pose),
        cfg.camera, cfg.fusion)
    _assert_both_kernels((frame.depth.contiguous(), v.contiguous(),
                          u.contiguous(),
                          (in_img & row_valid[:, None]).contiguous()))

    new_pose = se3.exp(torch.tensor([0.01, 0.0, -0.01, 0.0, 0.01, 0.0],
                                    device=cuda)) @ old_pose
    before = wg.LAUNCHES
    w_before = hmap.weight.clone()
    hmap, cnt = keyframe_slam.make_reintegrate(cfg)(
        hmap, depth_raw, old_pose, new_pose, 2)
    torch.cuda.synchronize()
    assert wg.LAUNCHES == before + 2
    assert 0 < int(cnt) < cfg.hash.max_active
    assert not torch.equal(hmap.weight, w_before)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_repeatable_on_the_card(cuda, solver):
    """Two runs of one solve on the card give the same bits (the
    scatter-adds with repeated indices sort instead of using float
    atomics), and they agree with the CPU within 1e-4."""
    from voxelhashing_demo_tpu_torch.config import KeyframeConfig
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    K = 24
    rng = np.random.RandomState(5)
    ang = 2 * np.pi * np.arange(K) / K
    xi = np.zeros((K, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = np.cos(ang), np.sin(ang), ang
    gt = se3.exp(torch.from_numpy(xi)).numpy().astype(np.float64)
    noise = np.concatenate([rng.normal(0, 0.02, (K, 3)),
                            rng.normal(0, 0.01, (K, 3))], 1).astype(
                                np.float32)
    est = gt.astype(np.float32) @ se3.exp(torch.from_numpy(noise)).numpy()

    def build(device):
        g = pose_graph.create(32, 64, device=device)
        for T in est:
            g = pose_graph.add_pose(g, T)
        for i in range(K):
            for j in ((i + 1) % K, (i + 5) % K):
                g = pose_graph.add_edge(
                    g, i, j,
                    (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32))
        return g

    kcfg = KeyframeConfig(ba_iters=6, ba_solver=solver)
    g = build(cuda)
    a, info = pose_graph.optimize(g, kcfg)
    b, _ = pose_graph.optimize(g, kcfg)
    torch.cuda.synchronize()
    assert torch.equal(a.poses, b.poses)
    assert float(info.chi2_final) < float(info.chi2_initial)
    cpu, _ = pose_graph.optimize(build("cpu"), kcfg)
    assert float((a.poses.cpu() - cpu.poses).abs().max()) < 1e-4


def test_stream_transfers_round_trip_under_churn(cuda):
    """The streaming cycle's copies (pinned buffers, side stream, events)
    return what was sent, while the main stream keeps allocating and
    freeing: a copy reading memory the allocator handed out again, or a
    pinned buffer rewritten under a running copy, would show here."""
    from voxelhashing_demo_tpu_torch.config import tiny_config
    from voxelhashing_demo_tpu_torch.models.hash_slam import _Transfers

    cfg = tiny_config()
    s = dataclasses.replace(cfg.stream, max_evict=64, max_restore=48)
    xfer = _Transfers(cuda, cfg.hash, s)
    gen = torch.Generator(device=cuda).manual_seed(0)
    V = cfg.hash.voxels_per_block
    for rnd in range(20):
        rows = (torch.randint(0, 1 << 30, (64,), device=cuda,
                              dtype=torch.int32, generator=gen),
                torch.rand((64, V), device=cuda, generator=gen),
                torch.rand((64, V), device=cuda, generator=gen),
                torch.randint(0, 500, (64,), device=cuda, dtype=torch.int32,
                              generator=gen))
        rec_f = torch.rand(32, device=cuda, generator=gen)
        rec_i = torch.randint(0, 9, (1 + rnd,), device=cuda,
                              dtype=torch.int32, generator=gen)
        want = [t.cpu() for t in rows + (rec_f, rec_i)]
        xfer.pull(rec_f, rec_i, rows)
        del rows, rec_f, rec_i           # the allocator may reuse them
        junk = [torch.full((64, V), -1.0, device=cuda) for _ in range(8)]
        got_f, got_i = xfer.pulled()
        ev = xfer.evicted(64)
        for a, b in zip(ev, want[:4]):
            np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(got_f, want[4].numpy())
        np.testing.assert_array_equal(got_i[:1 + rnd], want[5].numpy())
        m = 1 + rnd * 2
        up = tuple(a[:m] for a in ev)
        xfer.upload(up)
        del junk
        got = xfer.uploaded(m)
        for a, b in zip(got, up):
            np.testing.assert_array_equal(a.cpu().numpy(), b)
    assert [d for d, _, _ in xfer.log].count("d2h") == 20
    assert xfer.pinned_bytes() > 0


def test_frame_pipeline_on_the_card(cuda, tmp_path):
    """The pipeline's staging (two pinned buffers, a side stream, an event
    per frame, record_stream) hands over the frames the codec decodes,
    while the consumer's stream keeps allocating and overwriting memory:
    a frame read before its copy landed, a pinned buffer rewritten under a
    running copy, or a device tensor handed out again while the consumer
    still reads it would show here.  Also: the native codec built and
    loaded on this machine."""
    from voxelhashing_demo_tpu_torch.utils import io as depth_io
    from voxelhashing_demo_tpu_torch.utils import stream

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 60000, (48, 64)).astype(np.uint16)
              for _ in range(24)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"{i:03d}.png"))
        depth_io.write_depth_png(paths[-1], f)
    pipe = stream.FramePipeline(paths, 64, 48, prefetch=1, decode_batch=5)
    kept = []
    for i, d in enumerate(pipe):
        assert d.device.type == "cuda" and d.dtype == torch.int32
        junk = torch.full((48, 64), -7, dtype=torch.int32, device=cuda)
        kept.append((d * 1).sum())           # read on the consumer stream
        del junk
        np.testing.assert_array_equal(d.cpu().numpy(), frames[i])
    assert len(kept) == 24
    sums = torch.stack(kept).cpu().numpy()
    np.testing.assert_array_equal(
        sums, [int(f.astype(np.int64).sum()) for f in frames])


def test_stage_timer_reads_cuda_events(cuda):
    from voxelhashing_demo_tpu_torch.utils import profiling

    t = profiling.StageTimer()
    a = torch.rand((2048, 2048), device=cuda)
    for _ in range(3):
        with t.stage("mm"):
            a = a @ a / 2048.0
    assert t._events and not t.records      # nothing read yet
    s = t.summary()
    assert s["mm"]["count"] == 3 and s["mm"]["min_ms"] > 0


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A map on the card saved and loaded back onto the card: bit-exact,
    and the same file loaded on the CPU holds the same values."""
    from voxelhashing_demo_tpu_torch.config import tiny_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.utils import checkpoint, synthetic

    cfg = tiny_config()
    depths, _ = synthetic.make_sequence(cfg.camera, 3)
    slam = hash_slam.HashSLAM(cfg)
    for d in depths:
        slam.process(d)
    path = str(tmp_path / "map.npz")
    checkpoint.save_slam(path, slam)
    back, _ = checkpoint.load_slam(path)
    cpu, _ = checkpoint.load_slam(path, device="cpu")
    assert back.state.hmap.keys.device.type == "cuda"
    for f in slam.state.hmap._fields:
        assert torch.equal(getattr(back.state.hmap, f),
                           getattr(slam.state.hmap, f)), f
        assert torch.equal(getattr(cpu.state.hmap, f),
                           getattr(slam.state.hmap, f).cpu()), f
    assert torch.equal(torch.stack(back.trajectory),
                       torch.stack(slam.trajectory))


@pytest.mark.parametrize("name", ["exp_vmem_gather", "exp_gather",
                                  "exp_gather2", "exp_integrate"])
def test_probe_kernels_bit_exact_at_the_probes_shapes(cuda, name):
    """K16-K19 against their plain versions on the probe tools' own
    inputs (K19 also on rows that already carry weight), bit for bit."""
    import importlib

    from voxelhashing_demo_tpu_torch.tools.probe import Probe, to_device

    tool = importlib.import_module(
        f"voxelhashing_demo_tpu_torch.tools.{name}")
    probe = Probe(cuda)
    results = tool.run(probe, to_device(tool.inputs(), cuda))
    compared = {k: v for k, v in results.items() if "bit_exact" in v}
    assert compared and all(v["bit_exact"] for v in compared.values()), \
        compared


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_probe_gathers_out_of_range(cuda):
    """The out-of-range contract (NaN) in the kernels as in the plain
    versions: negative and too-large flat indices, (r, c) pairs, indices
    off either axis of a strided source, and two-step columns, window rows
    and pixels off the image."""
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.random((48, 64), dtype=np.float32),
                          device=cuda)
    n = img.numel()
    idx = torch.tensor([0, -1, n - 1, n, 7, -n, 2 ** 31 - 1],
                       dtype=torch.int32, device=cuda)
    assert _bits_equal(ig.take_flat(img, idx),
                       ig.take_flat_reference(img, idx))
    r = torch.tensor([0, 47, 48, -1, 3], dtype=torch.int32, device=cuda)
    c = torch.tensor([0, 63, 0, 5, 70], dtype=torch.int32, device=cuda)
    assert _bits_equal(ig.take_flat(img, (r, c), cols=64),
                       ig.take_flat_reference(img, (r, c), cols=64))
    big = torch.as_tensor(rng.random((40, 80), dtype=np.float32),
                          device=cuda)
    src = big[5:37, 3:35]                                  # row stride 80
    for axis, shape in ((0, (50, 32)), (1, (32, 45))):
        k = torch.as_tensor(rng.integers(-3, 36, shape), dtype=torch.int32,
                            device=cuda)
        got = ig.take_along_axis(src, k, axis)
        assert _bits_equal(got, ig.take_along_axis_reference(src, k, axis))
        assert bool(torch.isnan(got).any())
    S = 16
    dv = torch.as_tensor(rng.integers(-2, S + 2, (3, 8, S)),
                         dtype=torch.int32, device=cuda)
    du = torch.as_tensor(rng.integers(-2, S + 2, (3, 8, S)),
                         dtype=torch.int32, device=cuda)
    v0 = torch.tensor([0, 40, -5], dtype=torch.int32, device=cuda)
    u0 = torch.tensor([0, 55, 20], dtype=torch.int32, device=cuda)
    for keep in (1, 5, S):
        got = ig.gather_window_two_step(img, v0, u0, dv, du, keep)
        assert _bits_equal(got, ig.gather_window_two_step_reference(
            img, v0, u0, dv, du, keep))
        assert got.shape == (3, 8, keep)


def test_integrate_chunk_edge_voxels(cuda):
    """K19 against its plain version on the voxels its branches split on:
    flat indices off the image or fractional (truncated), zero and
    negative depth, invalid voxels, sdf below -trunc and above +trunc,
    weights at and near 255."""
    from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic

    rng = np.random.default_rng(4)
    H, W, n = 48, 64, 4096
    depth = rng.uniform(-0.5, 3.0, (H, W)).astype(np.float32)
    depth[::7, ::5] = 0.0
    flat = rng.uniform(-50, H * W + 50, n).astype(np.float32)
    flat[::3] = np.floor(flat[::3])
    flatw = np.stack([flat, rng.uniform(0.5, 3.0, n),
                      (rng.random(n) > 0.2).astype(np.float32)]).astype(
        np.float32)
    tsdf = rng.uniform(-0.1, 0.1, (64, 64)).astype(np.float32)
    w = rng.integers(0, 256, (64, 64)).astype(np.float32)
    w[0, :8] = 254.0
    t_cpu = [torch.as_tensor(a) for a in (depth, flatw, tsdf, w)]
    t_gpu = [a.to(cuda) for a in t_cpu]
    before = ic.LAUNCHES
    got = ic.integrate_chunk(*t_gpu, 0.1)
    assert ic.LAUNCHES == before + 1
    ref = ic.integrate_chunk_reference(*t_gpu, 0.1)
    cpu = ic.integrate_chunk(*t_cpu, 0.1)
    for g, r, c in zip(got, ref, cpu):
        assert _bits_equal(g, r)
        assert _bits_equal(g.cpu(), c)
    assert float(got[1].max()) == 255.0


def test_probe_wrappers_count_and_refuse(cuda):
    """One launch per wrapper call; mixed devices and wrong types raise
    (no quiet fallback to the plain version)."""
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig
    from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic

    img = torch.rand((8, 8), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = ig.LAUNCHES_TAKE_FLAT
    ig.take_flat(img, idx)
    assert ig.LAUNCHES_TAKE_FLAT == before + 1
    k = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    before = ig.LAUNCHES_TAKE_ALONG
    ig.take_along_axis(img, k, 0)
    assert ig.LAUNCHES_TAKE_ALONG == before + 1
    with pytest.raises(ValueError):
        ig.take_flat(img.cpu(), idx)
    with pytest.raises(ValueError):
        ig.take_flat(img, idx.long())
    with pytest.raises(ValueError):
        ig.take_along_axis(img.double(), k, 0)
    flatw = torch.zeros((3, 64), device=cuda)
    rows = torch.zeros((8, 8), device=cuda)
    with pytest.raises(ValueError):
        ic.integrate_chunk(img, flatw, rows, rows.cpu())


def _int32_on(cuda, a, offset: int = 0):
    """``a`` as a contiguous int32 tensor on the card whose data starts
    ``offset`` elements into its buffer (offset 1: not 16-byte aligned)."""
    a = np.asarray(a, np.int32)
    buf = torch.empty(a.size + offset, dtype=torch.int32, device=cuda)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.as_tensor(a))
    assert view.is_contiguous()
    return view


# index counts around the 4-wide groups (1, 3, 4 095, 65 537) and one that
# takes the grid-stride loop past the CTAs an H100 holds at once; index
# pointers aligned, one element in, and (the (r, c) form) rows and columns
# off by different amounts
@pytest.mark.parametrize("n", [1, 3, 4, 4095, 65537, 2_500_003])
@pytest.mark.parametrize("form,offsets", [
    ("flat", (0,)), ("flat", (1,)), ("rc", (0, 0)), ("rc", (1, 1)),
    ("rc", (0, 3))])
def test_take_flat_counts_and_alignment(cuda, n, form, offsets):
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    rng = np.random.default_rng(n)
    H, W = 480, 640
    img = torch.as_tensor(rng.standard_normal((H, W), dtype=np.float32),
                          device=cuda)
    if form == "flat":
        idx = _int32_on(cuda, rng.integers(-50, H * W + 50, n), offsets[0])
        args, cols = (idx,), None
    else:
        r = _int32_on(cuda, rng.integers(-2, H + 2, n), offsets[0])
        c = _int32_on(cuda, rng.integers(0, W, n), offsets[1])
        args, cols = ((r, c),), W
    before = ig.LAUNCHES_TAKE_FLAT
    got = ig.take_flat(img, *args, cols)
    assert ig.LAUNCHES_TAKE_FLAT == before + 1
    ref = ig.take_flat_reference(img, *args, cols)
    torch.cuda.synchronize()
    assert got.shape == (n,)
    assert _bits_equal(got, ref)
    assert bool(torch.isnan(got).any()) == bool(torch.isnan(ref).any())


def test_take_flat_empty(cuda):
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    img = torch.rand((48, 64), device=cuda)
    for shape in ((0,), (3, 0)):
        idx = torch.empty(shape, dtype=torch.int32, device=cuda)
        before = ig.LAUNCHES_TAKE_FLAT
        assert ig.take_flat(img, idx).shape == shape
        assert ig.take_flat(img, (idx, idx), cols=64).shape == shape
        assert ig.LAUNCHES_TAKE_FLAT == before


def _taa_source(cuda, rng, rows, cols, ld=None, col0=0):
    """A (rows, cols) float32 source on the card: a view of a wider buffer
    (row stride ``ld``, starting ``col0`` columns in) where given; a few
    NaNs with their own payload bits among its values."""
    ld = cols if ld is None else ld
    vals = rng.random((rows, ld), dtype=np.float32)
    vals.view(np.int32)[rng.random((rows, ld)) < 0.02] = 0x7FC0BEEF
    buf = torch.as_tensor(vals, device=cuda)
    src = buf[:, col0:col0 + cols]
    assert src.stride() == (ld, 1)
    return src


# axis 0: (source rows, cols, index rows, row stride, first column):
# cols no multiple of the 32-column strip; the probe's strided (256, 256)
# patch of a 640-wide image; a view whose rows start off 16 bytes (ld not a
# multiple of 4, first column 3); the tallest source the strip budget
# stages (384 rows) and one row more (the direct path); 1 000 rows
# (direct); one output row; one column
TAA0_CASES = {
    "cols70": (256, 70, 100, None, 0),
    "probe_patch": (256, 256, 512, 640, 0),
    "ld102_col3": (120, 64, 96, 102, 3),
    "ld100_aligned": (300, 64, 77, 100, 0),
    "budget384": (384, 40, 130, None, 0),
    "direct385": (385, 40, 130, None, 0),
    "direct1000": (1000, 64, 200, 80, 8),
    "one_row": (40, 50, 1, None, 0),
    "one_col": (40, 1, 37, None, 0),
}


@pytest.mark.parametrize("case", sorted(TAA0_CASES))
def test_take_along_axis0_paths(cuda, case):
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    src_rows, cols, rows, ld, col0 = TAA0_CASES[case]
    rng = np.random.default_rng(len(case))
    src = _taa_source(cuda, rng, src_rows, cols, ld, col0)
    idx = _int32_on(cuda, rng.integers(-3, src_rows + 3, (rows, cols)))
    before = ig.LAUNCHES_TAKE_ALONG
    got = ig.take_along_axis(src, idx, 0)
    assert ig.LAUNCHES_TAKE_ALONG == before + 1
    ref = ig.take_along_axis_reference(src, idx, 0)
    torch.cuda.synchronize()
    assert got.shape == (rows, cols)
    assert _bits_equal(got, ref)
    assert bool(torch.isnan(got).any())


# axis 1: (rows, source cols, index cols, row stride, first column, index
# offset): the probes' two shapes; cols no multiple of 4 (scalar path);
# an index pointer off 16 bytes; a strided view; one row; one column; a
# row longer than a CTA's threads take in one pass
TAA1_CASES = {
    "probe_128": (512, 128, 128, None, 0, 0),
    "probe_256": (512, 256, 256, None, 0, 0),
    "cols30": (33, 64, 30, None, 0, 0),
    "idx_offset": (20, 64, 64, None, 0, 1),
    "strided": (40, 60, 90, 70, 5, 0),
    "one_row": (1, 64, 30, None, 0, 0),
    "one_col": (30, 64, 1, None, 0, 0),
    "long_row": (3, 2000, 1200, None, 0, 0),
}


@pytest.mark.parametrize("case", sorted(TAA1_CASES))
def test_take_along_axis1_paths(cuda, case):
    from voxelhashing_demo_tpu_torch.ops import image_gather as ig

    rows, src_cols, cols, ld, col0, off = TAA1_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    src = _taa_source(cuda, rng, rows, src_cols, ld, col0)
    idx = _int32_on(cuda, rng.integers(-3, src_cols + 3, (rows, cols)), off)
    before = ig.LAUNCHES_TAKE_ALONG
    got = ig.take_along_axis(src, idx, 1)
    assert ig.LAUNCHES_TAKE_ALONG == before + 1
    ref = ig.take_along_axis_reference(src, idx, 1)
    torch.cuda.synchronize()
    assert got.shape == (rows, cols)
    assert _bits_equal(got, ref)
    assert bool(torch.isnan(got).any())


# --------------------------------------------------------------------------
# ICP (K4: csrc/icp.cu)
# --------------------------------------------------------------------------

def _icp_level(cuda, level: str):
    """(src, tgt, cam, cfg, T0) at 640x480 from frames 6 and 5 of
    chip_smoke.py's noisy room sweep (24 frames over 40 degrees), as the
    flagship pyramid builds a level: "L4", "L2", or "L1" (the source
    pooled by 2 against the full-size target)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = flagship_config()
    cam = cfg.camera
    depths, _ = synthetic.make_room_sweep(cam, 24, sweep_deg=40.0,
                                          noise_seed=1, device=cuda)
    d_src, d_tgt = (pre.depth_to_meters(
        torch.as_tensor(np.asarray(depths[i]).astype(np.int32),
                        device=cuda), cam)
        for i in (6, 5))
    factor, pool = {"L4": (4, 1), "L2": (2, 1), "L1": (1, 2)}[level]
    lcam = cam.scaled(factor) if factor > 1 else cam
    tgt = pre.preprocess_metric(pre.downsample_depth(d_tgt, factor), lcam)
    if pool > 1:
        src = pre.preprocess_metric(pre.downsample_depth_mean(d_src, pool),
                                    cam.scaled(pool))
    else:
        src = pre.preprocess_metric(pre.downsample_depth(d_src, factor),
                                    lcam)
    T0 = se3.exp(torch.tensor([0.01, -0.004, 0.006, 0.002, -0.01, 0.003],
                              device=cuda))
    icfg = dataclasses.replace(cfg.icp, max_iters=8)
    return src, tgt, lcam, icfg, T0


@pytest.mark.parametrize("level", ["L4", "L2", "L1"])
def test_icp_kernels_match_plain(cuda, level):
    """K4s's system against the float64 sum of its own per-pixel terms
    (rtol 1e-5, atol 1e-7: the fixed trees) and against
    ``build_normal_system(*associate(...))`` in norm (1e-4 of each field's
    norm: cuBLAS's float32 sums err by up to 2e-4 on an entry that
    cancels, such as a JTr entry 3 000 x smaller than the largest), and
    bit for bit against its in-order reference; the score sums bit for bit
    against theirs and within rtol 1e-5 of the plain ones (count equal);
    one K4 iteration bit for bit against ``_level_reference``."""
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, level)
    packed = icp.pack_target(tgt)
    before = (icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS)
    got = icp.normal_system(T0, src, packed, cam, cfg)
    assert (icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS) == (before[0],
                                                       before[1] + 1)
    want = icp.build_normal_system(
        *icp.associate(T0, src, None, cam, cfg, packed), cfg.huber_delta)
    assert float(want.count) > 1000
    exact = icp._system_from_sums(icp._terms_reference(
        T0, src, packed, cam, cfg, False).double().sum(0))
    ordered = icp._system_from_sums(icp._sums_reference(
        icp._partials_reference(T0, src, packed, cam, cfg)))
    for name in ("JTJ", "JTr", "error", "count"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.allclose(g.double(), getattr(exact, name), rtol=1e-5,
                              atol=1e-7), name
        assert float(torch.linalg.norm(g - w)) <= 1e-4 * float(
            torch.linalg.norm(w)), name
        assert _bits_equal(g, getattr(ordered, name)), name
    num, den = icp.alignment_score_sums(T0, src, None, cam, cfg, packed)
    rnum, rden = icp._score_sums_reference(T0, src, cam, cfg, packed)
    assert torch.allclose(num, rnum, rtol=1e-5) and bool(den == rden)
    onum, oden = icp._sums_reference(icp._partials_reference(
        T0, src, packed, cam, cfg, score=True))
    assert _bits_equal(num, onum) and _bits_equal(den, oden)
    one = dataclasses.replace(cfg, max_iters=1)
    rows, iters = icp._align_candidates([src], [tgt], cam, one, [T0])
    rrows, riters = icp._level_reference([src], [tgt], cam, one, [T0])
    assert _bits_equal(rows, rrows) and torch.equal(iters, riters)


@pytest.mark.parametrize("level", ["L4_race", "L4", "L2", "L1", "batch"])
def test_icp_level_bit_exact_against_reference(cuda, level):
    """A whole level in one K4 launch equals the frozen-lane loop of the
    in-order references bit for bit: the L4 race (C = 2, identity and a
    prior start, the epilogue's pick in row 2), each level from T0, and a
    pair-ICP batch of 4 candidates from four starts."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, level.split("_")[0]
                                        if level != "batch" else "L4")
    race = level == "L4_race"
    if race:
        inits = [None, T0]
    elif level == "batch":
        inits = [T0, None, se3.exp(torch.tensor(
            [0.02, 0.0, -0.01, 0.0, 0.02, 0.0], device=cuda)), T0 @ T0]
    else:
        inits = [T0]
    C = len(inits)
    before = icp.LAUNCHES_LEVEL
    rows, iters = icp._align_candidates([src] * C, [tgt] * C, cam, cfg,
                                        inits, race=race)
    assert icp.LAUNCHES_LEVEL == before + 1
    rrows, riters = icp._level_reference([src] * C, [tgt] * C, cam, cfg,
                                         inits, race=race)
    assert _bits_equal(rows, rrows)
    assert torch.equal(iters, riters)


@pytest.mark.parametrize("candidates,race", [(1, False), (2, True),
                                             (3, False)])
def test_icp_level_zero_iterations(cuda, candidates, race):
    """max_iters 0: one launch returns every candidate's start state (T,
    error inf, count 0, JTJ 0, 0 iterations), as the reference does."""
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, "L4")
    cfg = dataclasses.replace(cfg, max_iters=0)
    inits = [T0, None, T0][:candidates]
    rows, iters = icp._align_candidates([src] * candidates,
                                        [tgt] * candidates, cam, cfg, inits,
                                        race=race)
    rrows, riters = icp._level_reference([src] * candidates,
                                         [tgt] * candidates, cam, cfg,
                                         inits, race=race)
    assert _bits_equal(rows, rrows) and torch.equal(iters, riters)
    assert not iters.any() and torch.equal(rows[0, :16].view(4, 4), T0)


def test_icp_pyramid_matches_plain(cuda, monkeypatch):
    """The flagship pyramid (identity start, the prior raced at the
    coarsest level) on two consecutive sweep frames, three K4 launches
    against the plain loops: transform within 1e-5, iterations equal,
    inlier count and error within rtol 1e-3 (an inlier on a gate's edge
    may flip between the two float orders)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = flagship_config()
    depths, _ = synthetic.make_room_sweep(cfg.camera, 24, sweep_deg=40.0,
                                          noise_seed=1, device=cuda)
    d_src, d_tgt = (pre.depth_to_meters(
        torch.as_tensor(np.asarray(depths[i]).astype(np.int32),
                        device=cuda), cfg.camera) for i in (6, 5))
    prior = se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.03, 0.0],
                                 device=cuda))
    args = (d_src, d_tgt, cfg.camera, cfg.icp)
    before = (icp.LAUNCHES_LEVEL, icp.LAUNCHES_SUMS)
    res = icp.icp_align_pyramid(*args, prior_T=prior)
    assert (icp.LAUNCHES_LEVEL - before[0],
            icp.LAUNCHES_SUMS - before[1]) == (len(cfg.icp.pyramid), 0)
    monkeypatch.setattr(icp, "icp_align", icp.icp_align_reference)
    monkeypatch.setattr(
        icp, "alignment_score_sums",
        lambda T, src, tgt, cam, c, packed=None: icp._score_sums_reference(
            T, src, cam, c, icp.pack_target(tgt) if packed is None
            else packed))
    monkeypatch.setattr(icp, "icp_align_raced", icp._race_plain)
    plain = icp.icp_align_pyramid(*args, prior_T=prior)
    assert int(res.iters) == int(plain.iters)
    assert float((res.transform - plain.transform).abs().max()) <= 1e-5
    assert torch.allclose(res.count, plain.count, rtol=1e-3)
    assert torch.allclose(res.error, plain.error, rtol=1e-3)


def test_icp_align_makes_no_host_sync_and_replays_in_a_graph(cuda):
    """A level reads nothing back: under sync-debug "error" mode it runs;
    captured into a CUDA graph (the cooperative launch as a graph node)
    it replays to the eager result, the race too."""
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, "L4")
    icp.icp_align(src, tgt, cam, cfg, init_T=T0)      # built and bound
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = icp.icp_align(src, tgt, cam, cfg, init_T=T0)
        raced = icp.icp_align_raced(src, tgt, cam, cfg, T0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        icp.icp_align(src, tgt, cam, cfg, init_T=T0)
        icp.icp_align_raced(src, tgt, cam, cfg, T0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = icp.icp_align(src, tgt, cam, cfg, init_T=T0)
        captured_race = icp.icp_align_raced(src, tgt, cam, cfg, T0)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured + captured_race, res + raced):
        assert torch.equal(a, b)


def test_icp_batch_is_one_launch(cuda):
    """``icp_align_batch`` of 4 candidates is one K4 launch; its rows
    equal the plain version's within 1e-5 (transforms) and rtol 1e-3
    (error, count), observability from one eigvalsh."""
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, "L4")
    before = icp.LAUNCHES_LEVEL
    out = icp.icp_align_batch([src] * 4, [tgt] * 4, cam, cfg, [T0] * 4)
    assert icp.LAUNCHES_LEVEL == before + 1 and out.shape == (4, 19)
    plain = icp._batch_plain([src] * 4, [tgt] * 4, cam, cfg, [T0] * 4)
    assert float((out[:, :16] - plain[:, :16]).abs().max()) <= 1e-5
    assert torch.allclose(out[:, 16:18], plain[:, 16:18], rtol=1e-3)


def test_icp_refused_launch_raises(cuda, monkeypatch):
    """A launch that CUDA refuses raises out of ``icp_align``; the plain
    loop never runs in its place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import icp

    src, tgt, cam, cfg, T0 = _icp_level(cuda, "L4")
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))

    def no_plain(*a, **k):
        raise AssertionError("the plain loop ran on CUDA tensors")

    monkeypatch.setattr(icp, "icp_align_reference", no_plain)
    with pytest.raises(RuntimeError, match="icp_gn_level kernel launch"):
        icp.icp_align(src, tgt, cam, cfg, init_T=T0)
    with pytest.raises(RuntimeError, match="icp_sums kernel launch"):
        icp.normal_system(T0, src, icp.pack_target(tgt), cam, cfg)
    with pytest.raises(ValueError, match="one CUDA device"):
        icp.normal_system(T0.cpu(), src, icp.pack_target(tgt), cam, cfg)
