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
graph bit for bit; a refused launch raises.  The splat kernels (K8
``splat_zbuffer``, K9 ``splat_finalize``) equal their plain versions bit
for bit on every field (maps with FREE_PTR rows, band cuts and rows past
``count``, 48 poses, the near / far gates, fill rounds 0-5 and 16, odd
sizes, an image smaller than one tile, buffers with no hole, no estimate
and negative values, the ``pmin``-ed buffer; K8 also, filter on and
off, at block sizes 5, 7 and 10, count 0, 4 096 rows all in the band,
every ptr FREE_PTR and rows off a 16-byte boundary), make no host sync
and replay from a CUDA graph; K8's host tables are kept by identity;
each K9 and K7 instantiation reports its registers and resident CTAs.
The fuse kernels (K6 ``compact_visible``, K7 ``integrate_rows``) equal
their plain versions bit for bit: the visible set, its order and count
from 48 poses of a room sweep, on a set that overflows ``max_active``, on
tables of 1, 2, 127, 128, 129, 1 024 and 2 048 tiles (T a multiple of the
tile or not; the last more than the card holds CTAs), an all-free table
and one whose every entry is visible (capped; max_active 0); two launches
agree, a CUDA graph replays on its stream's persistent scratch and a
capture on a fresh stream on a scratch of its own, every scratch left
clean; tsdf, weight,
band_min, born and last_seen after an update in both gather modes and
both signs (the ``max_born`` gate, rows at the weight cap, near-range
rows the window clips, block sizes 3, 4 and 5); the frame's compact -> touch ->
integrate makes no host sync, ``fuse_frame`` none outside allocation, and
both replay from a CUDA graph; a refused build or launch raises.  The
allocation kernels (K5a ``alloc_candidates``, K5b ``insert_blocks``) equal
their plain versions bit for bit: the candidate keys at 48 poses of a
room sweep and past the key range, strides 1-3 and band steps 1-7, the
frame cut to 479 x 637 at strides 1-4, valid depths whose vertices are
not finite; every
map field and n_alloc after an insert of the step's keys at four poses
(the step's map, the cap, a heap run dry, a 512-bucket table filled to 3
and 4), of random key sets of 100 to 60 000 distinct keys (the cap path
above 4 096; three runs equal), of the sharded step's owner-routed keys
with ``BucketHash(num_buckets, 2)``; the stamp as an int and as a 0-d
tensor alike (K5b and K7); consecutive K5b launches on one stream
sharing its persistent scratch while M shrinks and grows (the cap path
and a frame of no key among them), the scratch clean after each and
after a graph of two of them replayed twice; ``allocate_from_frame`` and
``fuse_frame`` make no host sync, and K5a + K5b replay from a CUDA graph;
what they do not take and a refused launch raise, and no plain version
runs instead.  K3a bit for bit on each of its stage sets (radius 0-7,
outlier on and off, the bilateral off; depth_min 0 too) at 640x480 and
97 x 61.  K3b bit for bit on the flagship, plain, sharded, two-level and
odd-sized plans, with 1 and 8 jobs, at pool factor 3, on inputs 641 and
642 wide and 4 bytes off an alignment (no vector rows), on an all-zero
frame and on one whose every mean-pooled window the edge band rejects.
The pose-graph kernels (K13a ``pg_edge_blocks``, K13b ``pg_cg_solve``,
K13c ``pg_retract``) within 1e-6 of each tensor's scale of their plain
versions (J, r, the edge rows, b, chi2, the dense H and Hd; the retract),
the CG step within 1e-5 with the same iteration count (an early stop, all
64, capacity 512); ``optimize`` makes no host sync, repeats bit for bit
and lands within 1e-5 of ``optimize_reference`` on the card; ``se3.exp``
and ``inverse`` make no host sync; what the kernels do not take raises.
The map-maintenance kernels (K10 ``gc_free``, K14 ``evict_free``, K15
``restore_rows``) equal their plain versions bit for bit on every map
field and output (merged rows too): GC and eviction on the flagship map
after the sweep and on random maps, at the caps, with the age gates, on
tables of 129 and 300 tiles (the look-back), free_top near the stack's
end, the frame as a 0-d tensor; restores of 1 to 4 096 keys (found keys
merged, evicted keys back, full buckets, a heap cut short, padding only,
no born rows, the sharded BucketHash); the three make no host sync and
replay from CUDA graphs captured on a fresh stream and on a warm one;
more than 4 096 keys, a bucket function that is not a BucketHash and a
refused launch raise, and no plain version runs instead.  The march
kernels (K11 ``raycast_march``, K12 ``densify_cache``) equal their plain
versions bit for bit: K11 (depth, points, normals, hit) on the flagship's
256^3 cache in both normal modes, a non-cubic dense volume (also in image
mode), rays that start inside the surface (the NaN secant step), rays
that leave the volume sideways, ``far`` before the surface, max_steps 3
and 0, and a row slice of the rays; K12 (sdf, weight, origin, voxel size)
on the visible set, count 0, count = A with every row live, blocks
outside the cache, rows past the count holding valid rows, FREE_PTR and
negative ptrs, odd cache dims, another pose, and explicit rows with a
mask (some, all or no rows invalid); ``raycast_hash`` is one K12 and one
K11 launch with no host sync; what they do not take and a refused launch
raise, and no plain version runs instead.  The dense fusion kernel (K20
``integrate_dense``) equals ``integrate_dense_reference`` bit for bit
(sdf and weight; a new volume, the inputs untouched) on a non-cubic
volume, with the falloff off, a sample weight of 0, the weight cap, Z not
a multiple of 4, arrays off a 16-byte boundary, inf / NaN / 0 depths, a
camera turned away, the identity pose and the dense phase's 640x480 grid;
it makes no host sync and replays from a CUDA graph; ``DenseSLAM`` on the
card agrees with the CPU (poses 1e-4 m over 6 frames) and a step launches
K3a, K3b, K4, K20 and K11 once each with no host sync; what K20 does not
take and a refused launch raise, and no plain version runs instead.
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
    (``make_reintegrate``: sign -1 at the old pose, +1 at the new) does
    the window gather's work exactly twice (inside K7, the integrate
    kernel, since the gather was fused into it)."""
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
    before = hash_ops.LAUNCHES_INTEGRATE_WINDOW
    w_before = hmap.weight.clone()
    hmap, cnt = keyframe_slam.make_reintegrate(cfg)(
        hmap, depth_raw, old_pose, new_pose, 2)
    torch.cuda.synchronize()
    assert hash_ops.LAUNCHES_INTEGRATE_WINDOW == before + 2
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


# --------------------------------------------------------------------------
# K3: the depth frontend (K3a) and the pyramid's level inputs (K3b)
# --------------------------------------------------------------------------

def _assert_k3_equal(got, plain, what: str):
    """A K3 output (a Frame or a packed target) bit for bit its plain
    version's on the card."""
    if isinstance(got, torch.Tensor):
        assert _bits_equal(got, plain), what
        return
    for name in ("depth", "vertices", "normals"):
        assert _bits_equal(getattr(got, name), getattr(plain, name)), \
            f"{what} {name}"


def _k3_frame(cuda, which: str):
    """(raw int32 depth on the card, camera): "sweep" is frame 6 of the
    noisy room sweep at 640x480; "odd" a 37 x 53 frame whose depth edges
    cross the border (the stencils' wrap)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.utils import synthetic
    from torch_port_helpers import depth_scene

    cam = flagship_config().camera
    if which == "sweep":
        depths, _ = synthetic.make_room_sweep(cam, 8, sweep_deg=40.0,
                                              noise_seed=1, device=cuda)
        raw = torch.as_tensor(np.asarray(depths[6]).astype(np.int32),
                              device=cuda)
        return raw, cam
    cam = dataclasses.replace(cam, width=53, height=37, cx=26.3, cy=17.8)
    return torch.as_tensor(depth_scene(37, 53, seed=5).astype(np.int32),
                           device=cuda), cam


@pytest.mark.parametrize("which", ["sweep", "odd"])
@pytest.mark.parametrize("outlier,bilateral,radius", [
    (True, True, 2), (True, True, 1), (True, True, 3), (False, True, 2),
    (True, False, 2), (False, False, 2), (None, None, None)])
def test_preprocess_frame_matches_plain(cuda, which, outlier, bilateral,
                                        radius):
    """K3a with the frontend's stages on and off (None: no frontend) and
    bilateral radius 1-3, at 640x480 and on an odd-sized frame with depth
    edges across the border: one launch a call."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    raw, cam = _k3_frame(cuda, which)
    front = None if outlier is None else dataclasses.replace(
        flagship_config().frontend, outlier_reject=outlier,
        bilateral=bilateral, bilateral_radius=radius)
    before = pre.LAUNCHES_FRAME
    got = pre.preprocess(raw, cam, front)
    assert pre.LAUNCHES_FRAME == before + 1
    _assert_k3_equal(got, pre.preprocess_reference(raw, cam, front), "K3a")


@pytest.mark.parametrize("size", ["sweep", "odd97"])
@pytest.mark.parametrize("outlier", [True, False])
@pytest.mark.parametrize("radius", [None, 0, 1, 2, 3, 4, 5, 6, 7])
def test_preprocess_frame_every_instantiation(cuda, size, outlier, radius):
    """K3a bit for bit against the plain version on each stage set (the
    bilateral off (None) or at radius 0-7, the outlier stage on and off;
    depth_min > 0), at 640x480 and
    on a 97 x 61 frame (no multiple of the 32 x 20 tile) with depth edges
    across the border and dropouts along it: interior tiles that skip the
    wrap, border tiles that wrap, ragged tiles."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from torch_port_helpers import depth_scene

    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    if size == "sweep":
        raw, cam = _k3_frame(cuda, "sweep")
    else:
        cam = dataclasses.replace(flagship_config().camera, width=97,
                                  height=61, cx=48.2, cy=30.4)
        d = depth_scene(61, 97, seed=13).astype(np.int32)
        d[0, ::2] = d[-1, 1::3] = d[::3, 0] = d[1::2, -1] = 0
        raw = torch.as_tensor(d, device=cuda)
    front = dataclasses.replace(
        flagship_config().frontend, outlier_reject=outlier,
        bilateral=radius is not None,
        bilateral_radius=2 if radius is None else radius)
    before = pre.LAUNCHES_FRAME
    got = pre.preprocess(raw, cam, front)
    assert pre.LAUNCHES_FRAME == before + 1
    _assert_k3_equal(got, pre.preprocess_reference(raw, cam, front),
                     f"K3a {size} outlier {outlier} radius {radius}")


@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("size", ["sweep", "odd"])
def test_preprocess_frame_masked_taps(cuda, size, radius):
    """K3a's bilateral without the outlier stage at depth_min 0, the
    range gate's edge (its invalid pixels are exactly 0 there, as the
    unmasked taps need), bit for bit against the plain version."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    raw, cam = _k3_frame(cuda, size)
    cam = dataclasses.replace(cam, depth_min=0.0)
    front = dataclasses.replace(flagship_config().frontend,
                                outlier_reject=False, bilateral=True,
                                bilateral_radius=radius)
    got = pre.preprocess(raw, cam, front)
    _assert_k3_equal(got, pre.preprocess_reference(raw, cam, front),
                     f"K3a masked {size} radius {radius}")


def _k3_levels_case(cuda, case: str):
    """(depth_src_m, depth_tgt_m, cam, icp config, keywords) of a K3b
    case: the flagship pyramid on a preprocessed sweep frame against a
    model Frame (nonzero at every level) with src_full / tgt_full given
    ("flagship"), neither given ("plain"), min-pooled sources ("sharded"),
    a (4, 2) pyramid with source pools (1, 2) ("two_level"), and the
    flagship pyramid on the odd-sized frame ("odd")."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    cfg = flagship_config()
    raw, cam = _k3_frame(cuda, "odd" if case == "odd" else "sweep")
    frame = pre.preprocess(raw, cam, cfg.frontend)
    model = pre.preprocess_reference(torch.roll(raw, (3, -5), (0, 1)), cam,
                                     cfg.frontend)
    icfg, kw = cfg.icp, {}
    if case in ("flagship", "odd"):
        kw = dict(src_full=frame, tgt_full=model)
    elif case == "sharded":
        kw = dict(mean_sources=False)
    elif case == "two_level":
        icfg = dataclasses.replace(icfg, pyramid=(4, 2), pyramid_iters=(8, 4),
                                   source_pools=(1, 2))
    return frame.depth, model.depth, cam, icfg, kw


@pytest.mark.parametrize("case", ["flagship", "plain", "sharded",
                                  "two_level", "odd"])
def test_pyramid_levels_match_plain(cuda, case):
    """K3b's sources and packed targets, level by level, in one launch;
    every level of the model is nonzero."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    d_src, d_tgt, cam, icfg, kw = _k3_levels_case(cuda, case)
    before = pre.LAUNCHES_LEVELS
    srcs, tgts = pre.pyramid_inputs(d_src, d_tgt, cam, icfg, **kw)
    assert pre.LAUNCHES_LEVELS == before + 1
    ps, pt = pre._pyramid_reference(d_src, d_tgt, cam, icfg, **kw)
    for k, (s, t) in enumerate(zip(srcs, tgts)):
        assert bool((t[..., 0] > 0).any()), (case, k)
        _assert_k3_equal(s, ps[k], f"{case} source {k}")
        _assert_k3_equal(t, pt[k], f"{case} target {k}")


def _k3b_job(kind: int, pool: int, factor: int, cam, image: str = "src"):
    """A K3b job of the level image pooled by ``factor`` (its camera
    scaled so)."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    return pre._Job(kind, image, pool, factor,
                    cam.scaled(factor) if factor > 1 else cam)


def _k3b_images(cuda, width: int = 640):
    """(source depth, target depth, target Frame, camera) at 480 x
    ``width``: the preprocessed sweep frame (its first columns repeated
    past 640) and a model Frame of it rolled by (3, -5)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    cfg = flagship_config()
    raw, cam = _k3_frame(cuda, "sweep")
    raw = torch.cat([raw, raw[:, :width - 640]], 1) if width > 640 else raw
    cam = dataclasses.replace(cam, width=width)
    frame = pre.preprocess(raw, cam, cfg.frontend)
    model = pre.preprocess_reference(torch.roll(raw, (3, -5), (0, 1)), cam,
                                     cfg.frontend)
    return frame.depth, model.depth, model, cam


def _k3b_check(jobs, src, tgt, full, what: str):
    """One K3b launch of ``jobs`` against each job's plain version, bit
    for bit."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    images = {"src": src, "tgt": tgt}
    before = pre.LAUNCHES_LEVELS
    got = pre._launch_levels(tuple(jobs), images, full)
    assert pre.LAUNCHES_LEVELS == before + 1
    assert len(got) == len(jobs)
    for k, job in enumerate(jobs):
        _assert_k3_equal(got[k], pre._job_reference(job, images, full),
                         f"{what} job {k}")


@pytest.mark.parametrize("n_jobs", [1, 8])
def test_pyramid_levels_job_counts(cuda, n_jobs):
    """K3b with one job (a mean-pooled source) and with the most a launch
    takes, 8: sources pooled min 2, mean 2, min 4, mean 4 and not at all,
    targets min 2 and not pooled, the target Frame packed."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    src, tgt, model, cam = _k3b_images(cuda)
    S, T, P = pre._SOURCE, pre._TARGET, pre._PACK
    spec = [(S, pre._MEAN, 2, "src"), (S, pre._MIN, 2, "src"),
            (S, pre._MIN, 4, "src"), (S, pre._MEAN, 4, "src"),
            (S, pre._NONE, 1, "src"), (T, pre._MIN, 2, "tgt"),
            (T, pre._NONE, 1, "tgt"), (P, pre._NONE, 1, "tgt")][:n_jobs]
    jobs = [_k3b_job(k, p, f, cam, i) for k, p, f, i in spec]
    assert len(jobs) == n_jobs <= pre.MAX_JOBS
    _k3b_check(jobs, src, tgt, model, f"{n_jobs} jobs")


def test_pyramid_levels_factor_three(cuda):
    """K3b at pool factor 3 (no vector rows: one float a load), min and
    mean sources and a min target, on the sweep frame (640 / 3 leaves a
    ragged column)."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    src, tgt, model, cam = _k3b_images(cuda)
    jobs = [_k3b_job(pre._SOURCE, pre._MIN, 3, cam),
            _k3b_job(pre._SOURCE, pre._MEAN, 3, cam),
            _k3b_job(pre._TARGET, pre._MIN, 3, cam, "tgt")]
    _k3b_check(jobs, src, tgt, model, "factor 3")


@pytest.mark.parametrize("case", ["w641", "w642", "offset"])
def test_pyramid_levels_unaligned_inputs(cuda, case):
    """K3b where the vector rows do not apply: an input 641 wide (no
    float2 or float4 row), 642 wide (float2 rows at factor 2, none at 4;
    levels 321 and 160 wide, the first storing a float at a time), and
    640-wide inputs that start 4 bytes past an alignment (every job on
    its scalar loads, the pack job on one pixel at a time): the flagship's
    six kinds of job."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    width = {"w641": 641, "w642": 642, "offset": 640}[case]
    src, tgt, model, cam = _k3b_images(cuda, width)
    if case == "offset":
        def shifted(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            out = flat[1:].view(t.shape)
            out.copy_(t)
            assert out.data_ptr() % 16 != 0
            return out

        src, tgt = shifted(src), shifted(tgt)
        model = pre.Frame(model.vertices, shifted(model.normals),
                          shifted(model.depth))
    S, T = pre._SOURCE, pre._TARGET
    jobs = [_k3b_job(S, pre._MIN, 4, cam), _k3b_job(T, pre._MIN, 4, cam,
                                                     "tgt"),
            _k3b_job(S, pre._MIN, 2, cam), _k3b_job(T, pre._MIN, 2, cam,
                                                     "tgt"),
            _k3b_job(S, pre._MEAN, 2, cam),
            _k3b_job(pre._PACK, pre._NONE, 1, cam, "tgt")]
    _k3b_check(jobs, src, tgt, model, case)


@pytest.mark.parametrize("case", ["zero", "edge_band"])
def test_pyramid_levels_degenerate_frames(cuda, case):
    """K3b's flagship plan on an all-zero frame and model (every output 0)
    and on a checkerboard of 1.0 m and 1.2 m (every 2 x 2 window spans
    more than the mean pool's edge band, so every mean-pooled pixel is
    rejected while the min pools keep theirs)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    cfg = flagship_config()
    cam = cfg.camera
    if case == "zero":
        d = torch.zeros((480, 640), device=cuda)
    else:
        yy, xx = torch.meshgrid(torch.arange(480, device=cuda),
                                torch.arange(640, device=cuda),
                                indexing="ij")
        d = torch.where((yy + xx) % 2 == 0, 1.0, 1.2).float()
    model = pre.preprocess_metric_reference(d, cam)
    kw = dict(src_full=None, tgt_full=model)
    srcs, tgts = pre.pyramid_inputs(d, d.clone(), cam, cfg.icp, **kw)
    ps, pt = pre._pyramid_reference(d, d.clone(), cam, cfg.icp, **kw)
    for k, (a, b) in enumerate(zip(srcs + tgts, ps + pt)):
        _assert_k3_equal(a, b, f"{case} output {k}")
    assert not bool(srcs[2].depth.any())     # L1's source: mean-pooled
    if case == "edge_band":
        assert bool(srcs[0].depth.all())


@pytest.mark.parametrize("factor", [1, 2, 3, 4])
def test_preprocess_metric_one_job(cuda, factor):
    """``preprocess_metric`` on the card: one K3b job, min-pooled by
    ``factor`` first (the keyframe pair ICP's downsample)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    raw, cam = _k3_frame(cuda, "sweep")
    d = pre.preprocess(raw, cam, flagship_config().frontend).depth
    lcam = cam.scaled(factor) if factor > 1 else cam
    before = pre.LAUNCHES_LEVELS
    got = pre.preprocess_metric(d, lcam, pool_factor=factor)
    assert pre.LAUNCHES_LEVELS == before + 1
    pooled = pre.downsample_depth(d, factor)
    _assert_k3_equal(got, pre.preprocess_metric_reference(pooled, lcam),
                     f"pool {factor}")


def test_k3_no_sync_graph_replay_and_refusals(cuda, monkeypatch):
    """Neither kernel reads back to the host; both replay from a CUDA
    graph bit for bit; what the kernels do not take raises, a refused
    launch raises, and the plain versions never run in their place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre

    cfg = flagship_config()
    raw, cam = _k3_frame(cuda, "sweep")
    d_src, d_tgt, _, icfg, kw = _k3_levels_case(cuda, "flagship")

    def both():
        f = pre.preprocess(raw, cam, cfg.frontend)
        s, t = pre.pyramid_inputs(d_src, d_tgt, cam, icfg, **kw)
        return [*f, *(x for fr in s for x in fr), *t]

    eager = both()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        both()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = both()
    graph.replay()
    torch.cuda.synchronize()
    assert all(_bits_equal(a, b) for a, b in zip(captured, eager))

    with pytest.raises(ValueError, match="int32"):
        pre.preprocess(raw.float(), cam, cfg.frontend)
    with pytest.raises(ValueError, match="radius"):
        pre.preprocess(raw, cam, dataclasses.replace(cfg.frontend,
                                                     bilateral_radius=8))
    with pytest.raises(ValueError, match="depth_min >= 0"):
        pre.preprocess(raw, dataclasses.replace(cam, depth_min=-0.1),
                       dataclasses.replace(cfg.frontend,
                                           outlier_reject=False))
    with pytest.raises(ValueError, match="one CUDA device"):
        pre.pyramid_inputs(d_src, d_tgt.cpu(), cam, icfg)
    with pytest.raises(ValueError, match="float32"):
        pre.preprocess_metric(d_src.double(), cam)
    with pytest.raises(ValueError, match="level inputs"):
        pre.pyramid_inputs(d_src, d_tgt, cam, dataclasses.replace(
            icfg, pyramid=(16, 8, 4, 2, 1), pyramid_iters=(1,) * 5,
            source_pools=(2,) * 5))
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(pre, "preprocess_reference", no_plain)
    monkeypatch.setattr(pre, "_job_reference", no_plain)
    with pytest.raises(RuntimeError, match="preprocess_frame kernel launch"):
        pre.preprocess(raw, cam, cfg.frontend)
    with pytest.raises(RuntimeError, match="pyramid_levels kernel launch"):
        pre.pyramid_inputs(d_src, d_tgt, cam, icfg, **kw)


# --------------------------------------------------------------------------
# K8 / K9: the splat z-buffer and its finalize pass
# --------------------------------------------------------------------------

def _splat_cfg(size: str, **raycast):
    """The flagship config at 640x480 ("full") or at 80x60 with a small
    map ("tiny"), its raycast settings replaced by ``raycast``."""
    from voxelhashing_demo_tpu_torch.config import flagship_config, tiny_config

    cfg = flagship_config()
    if size == "tiny":
        cfg = dataclasses.replace(cfg, camera=tiny_config().camera)
    return dataclasses.replace(cfg, raycast=dataclasses.replace(
        cfg.raycast, **raycast))


def _splat_inputs(cuda, cfg, padded: bool):
    """(map, active set, pose) of ``torch_port_helpers.splat_map_case`` on
    the card: FREE_PTR rows inside ``count``, band_min cuts (true and
    stale), rows past ``count`` (real rows, or padding with ``padded``)."""
    from torch_port_helpers import splat_map_case
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    c = splat_map_case(cfg.fusion.voxel_size,
                       cfg.raycast.splat_band * cfg.fusion.voxel_size, seed=3)
    on = {k: torch.as_tensor(np.asarray(v), device=cuda)
          for k, v in c.items()}
    key = "_padded" if padded else ""
    hmap = hash_ops.HashMap(*([None] * 5), tsdf=on["tsdf"],
                            weight=on["weight"], last_seen=None,
                            band_min=on["band_min"], born=None)
    active = hash_ops.ActiveSet(blocks=on["blocks" + key],
                                ptrs=on["ptrs" + key], count=on["count"])
    return hmap, active, on["pose"]


def _assert_splat_equal(got, plain, what: str):
    """A RaycastOutput bit for bit its plain version's (hit equal)."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(plain, name)
        same = torch.equal(a, b) if a.dtype == torch.bool else \
            _bits_equal(a, b)
        assert same, f"{what} {name}"


@pytest.mark.parametrize("gates", [None, (1.0, 1.45)])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_splat_zbuffer_matches_plain(cuda, size, gates):
    """K8 (``splat_depth_from_map``: a reset, one launch, one pass) bit
    for bit against ``splat_depth_from_map_reference``, rows past
    ``count`` holding real rows; with the near / far gates cutting the
    wall on both sides."""
    from voxelhashing_demo_tpu_torch.ops import splat

    over = {} if gates is None else dict(near=gates[0], far=gates[1])
    cfg = _splat_cfg(size, **over)
    hmap, active, pose = _splat_inputs(cuda, cfg, padded=False)
    args = (hmap, active, cfg.hash, pose, cfg.camera, cfg.raycast,
            cfg.fusion)
    before = splat.LAUNCHES_ZBUFFER
    got = splat.splat_depth_from_map(*args)
    assert splat.LAUNCHES_ZBUFFER == before + 1
    plain = splat.splat_depth_from_map_reference(*args)
    assert _bits_equal(got, plain)
    assert int((got > 0).sum()) > 300


def test_splat_zbuffer_over_poses(cuda):
    """K8 bit for bit against its plain version from 48 poses around the
    case's (the pose's inverse and the product round as torch's CUDA
    matmul and einsum do; one differing rounding shows in most poses)."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import splat

    cfg = _splat_cfg("full")
    hmap, active, pose = _splat_inputs(cuda, cfg, padded=False)
    rng = np.random.default_rng(7)
    for k in range(48):
        xi = rng.normal(size=6) * np.array([0.05, 0.05, 0.05, 0.03, 0.03,
                                            0.03])
        T = se3.exp(torch.as_tensor(xi, dtype=torch.float32,
                                    device=cuda)) @ pose
        args = (hmap, active, cfg.hash, T, cfg.camera, cfg.raycast,
                cfg.fusion)
        got = splat.splat_depth_from_map(*args)
        assert _bits_equal(got, splat.splat_depth_from_map_reference(
            *args)), k
        assert int((got > 0).sum()) > 300, k


# K8's edges: block sizes whose rows are not 16-byte multiples (5, 7) and
# the largest it takes (10: 1 000 voxels); count 0; a set of 4 096 rows,
# every one in `count` and in the band, so that row groups walk several
# rows; every ptr FREE_PTR; 8^3 rows 4 bytes off a 16-byte boundary (the
# scalar instantiation at the flagship's block size)
K8_EDGES = ("block_size_5", "block_size_7", "block_size_10", "count_0",
            "every_row_in_band_x4096", "every_ptr_free", "unaligned_rows")


def _k8_edge(cuda, which: str) -> tuple:
    """(config, map, active set, pose) of K8 edge ``which`` at 640x480,
    from ``torch_port_helpers.splat_map_case``."""
    from torch_port_helpers import splat_map_case
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    bs = int(which.rsplit("_", 1)[1]) if which.startswith("block_size_") \
        else 8
    cfg = _splat_cfg("full")
    cfg = dataclasses.replace(cfg, hash=dataclasses.replace(cfg.hash,
                                                            block_size=bs))
    band = cfg.raycast.splat_band * cfg.fusion.voxel_size
    c = splat_map_case(cfg.fusion.voxel_size, band, seed=3, block_size=bs)
    on = {k: torch.as_tensor(np.asarray(v), device=cuda)
          for k, v in c.items()}
    tsdf, weight, band_min = on["tsdf"], on["weight"], on["band_min"]
    blocks, ptrs, count = on["blocks"], on["ptrs"], on["count"]
    if which == "count_0":
        count = torch.zeros_like(count)
    elif which == "every_ptr_free":
        ptrs = torch.full_like(ptrs, hash_ops.FREE_PTR)
    elif which == "every_row_in_band_x4096":
        n = int(count)
        live = (ptrs[:n] >= 0) & (band_min[ptrs[:n].clamp(min=0).long()]
                                  < band)
        idx = live.nonzero().flatten()
        take = idx[torch.arange(4096, device=cuda) % idx.numel()]
        blocks, ptrs = blocks[take].contiguous(), ptrs[take].contiguous()
        count = torch.tensor(4096, dtype=torch.int32, device=cuda)
    elif which == "unaligned_rows":
        def shifted(t):
            out = torch.empty(t.numel() + 1, dtype=t.dtype,
                              device=cuda)[1:].view(t.shape)
            out.copy_(t)
            assert out.is_contiguous() and out.data_ptr() % 16 == 4
            return out

        tsdf, weight = shifted(tsdf), shifted(weight)
    hmap = hash_ops.HashMap(*([None] * 5), tsdf=tsdf, weight=weight,
                            last_seen=None, band_min=band_min, born=None)
    return cfg, hmap, hash_ops.ActiveSet(blocks=blocks, ptrs=ptrs,
                                         count=count), on["pose"]


@pytest.mark.parametrize("which", K8_EDGES)
def test_splat_zbuffer_edges(cuda, which):
    """K8 bit for bit against its plain version on its edges
    (``K8_EDGES``), with the band filter off and on (against the plain
    version on ``surface_filter``'s set); one launch a call."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops, splat

    cfg, hmap, active, pose = _k8_edge(cuda, which)
    cam, rc, fus = cfg.camera, cfg.raycast, cfg.fusion
    args = (hmap, active, cfg.hash, pose, cam, rc, fus)
    before = splat.LAUNCHES_ZBUFFER
    got = splat.splat_depth_from_map(*args)
    assert splat.LAUNCHES_ZBUFFER == before + 1
    assert _bits_equal(got, splat.splat_depth_from_map_reference(*args))
    filtered = torch.nan_to_num(splat._launch_zbuffer(
        *args, band_filter=True).view(cam.height, cam.width), posinf=0.0)
    assert splat.LAUNCHES_ZBUFFER == before + 2
    # surface_filter reads every row: the set padded past `count` with
    # FREE_PTR, as compact_visible pads it
    rows = torch.arange(active.ptrs.shape[0], device=cuda)
    padded = active._replace(ptrs=torch.where(
        rows < active.count, active.ptrs, hash_ops.FREE_PTR).to(torch.int32))
    surf = splat.surface_filter(hmap, padded, rc.splat_band * fus.voxel_size)
    assert _bits_equal(filtered, splat.splat_depth_from_map_reference(
        hmap, surf, *args[2:]))
    hits = int((got > 0).sum())
    if which in ("count_0", "every_ptr_free"):
        assert hits == 0
    else:
        assert hits > 100 and int((filtered > 0).sum()) > 100


def test_splat_zbuffer_tables_kept_by_identity(cuda):
    """K8's host tables are built once a map and configuration: the same
    tables for the same row tensors and configuration objects, new ones
    for another row tensor or an equal copy of a configuration, none kept
    for rows that are not contiguous (read as copies)."""
    from voxelhashing_demo_tpu_torch.ops import splat

    cfg = _splat_cfg("full")
    hmap, _, _ = _splat_inputs(cuda, cfg, padded=False)
    a = (cfg.hash, cfg.camera, cfg.raycast, cfg.fusion)
    t = splat._zbuffer_tables(hmap, *a)
    assert splat._zbuffer_tables(hmap, *a) is t and t[4] is None
    assert list(t[0]) == [x.data_ptr() for x in (hmap.tsdf, hmap.weight,
                                                   hmap.band_min)]
    assert list(t[1]) == [hmap.tsdf.shape[0], 8, 480, 640]
    assert splat._zbuffer_tables(hmap, cfg.hash, cfg.camera,
                                 dataclasses.replace(cfg.raycast),
                                 cfg.fusion) is not t
    other = hmap._replace(weight=hmap.weight.clone())
    assert splat._zbuffer_tables(other, *a)[0][1] == other.weight.data_ptr()
    strided = hmap._replace(tsdf=hmap.tsdf.t().contiguous().t())
    got = splat._zbuffer_tables(strided, *a)
    assert got[4] is not None and got[4][0].is_contiguous()
    assert splat._zbuffer_tables(strided, *a) is not got


@pytest.mark.parametrize("rounds", [0, 1, 2])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_splat_raycast_matches_plain(cuda, size, rounds):
    """K8 with the band filter then K9 (``splat_raycast``) bit for bit
    against ``splat_raycast_reference`` (``surface_filter`` and the plain
    chain), every field, fill rounds 0-2."""
    from voxelhashing_demo_tpu_torch.ops import splat

    cfg = _splat_cfg(size, splat_fill_rounds=rounds)
    hmap, active, pose = _splat_inputs(cuda, cfg, padded=True)
    args = (hmap, active, cfg.hash, pose, cfg.camera, cfg.raycast,
            cfg.fusion)
    before = (splat.LAUNCHES_ZBUFFER, splat.LAUNCHES_FINALIZE)
    got = splat.splat_raycast(*args)
    assert (splat.LAUNCHES_ZBUFFER, splat.LAUNCHES_FINALIZE) == (
        before[0] + 1, before[1] + 1)
    _assert_splat_equal(got, splat.splat_raycast_reference(*args),
                        f"{size} rounds {rounds}")
    assert bool(got.hit.any())


@pytest.mark.parametrize("pmin", [False, True])
@pytest.mark.parametrize("rounds", [0, 1, 2, 5])
@pytest.mark.parametrize("hw", [(60, 80), (37, 53), (480, 640)])
def test_splat_finalize_matches_plain(cuda, hw, rounds, pmin):
    """K9 (``finalize_depth``) bit for bit against
    ``finalize_depth_reference`` on buffers with holes along the border
    and in the corners (the fill's +inf padding, the smooth's wrap), the
    multi-device path's ``pmin``-ed buffer (0 for none) too, on odd
    sizes; a buffer with +inf for none (K8's) gives the same."""
    from torch_port_helpers import splat_depth_case
    from voxelhashing_demo_tpu_torch.ops import splat

    h, w = hw
    cfg = _splat_cfg("full", splat_fill_rounds=rounds)
    cam = dataclasses.replace(cfg.camera, height=h, width=w,
                              cx=(w - 1) / 2 + 0.3, cy=(h - 1) / 2 - 0.2)
    raw = torch.as_tensor(splat_depth_case(h, w, seed=rounds, pmin=pmin),
                          device=cuda)
    before = splat.LAUNCHES_FINALIZE
    got = splat.finalize_depth(raw, cam, cfg.raycast, cfg.fusion)
    assert splat.LAUNCHES_FINALIZE == before + 1
    _assert_splat_equal(got, splat.finalize_depth_reference(
        raw, cam, cfg.raycast, cfg.fusion), f"{hw} rounds {rounds}")
    inf = torch.where(raw > 0, raw, float("inf"))
    _assert_splat_equal(splat.finalize_depth(inf, cam, cfg.raycast,
                                             cfg.fusion), got, "+inf")


SPLAT_BUFFERS = ("no_hole", "no_estimate", "signed", "smaller_than_a_tile",
                 "width_228")


def _splat_buffer(case: str):
    """(h, w, raw float32 numpy buffer) of a K9 instantiation case: the
    640x480 buffer with every hole filled ("no_hole") or all holes
    ("no_estimate"); negative values among its holes ("signed": no fill
    round keeps them, and the normals take them); a 9 x 13 image (smaller
    than one tile: every staged cell wraps, some more than once) and a
    36 x 228 one (a multiple of 4 wide, not of the tile)."""
    from torch_port_helpers import splat_depth_case

    h, w = {"smaller_than_a_tile": (9, 13), "width_228": (36, 228)}.get(
        case, (480, 640))
    raw = splat_depth_case(h, w, seed=4)
    if case == "no_hole":
        raw = np.where(raw > 0, raw, np.float32(1.4))
    elif case == "no_estimate":
        raw = np.zeros_like(raw)
    elif case == "signed":
        rng = np.random.default_rng(5)
        neg = (raw == 0) & (rng.random(raw.shape) < 0.5)
        raw = np.where(neg, -rng.random(raw.shape).astype(np.float32), raw)
    return h, w, raw.astype(np.float32)


@pytest.mark.parametrize("case", SPLAT_BUFFERS)
@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4, 16])
def test_splat_finalize_instantiations(cuda, rounds, case):
    """K9's instantiations (fill rounds 0-3, and the one that reads the
    count at run time: 4, 16) bit for bit against
    ``finalize_depth_reference``, every field, on buffers with no hole, no
    estimate and negative values, and on images smaller than one tile and
    not a multiple of its width (the interior and border tiles, the 16-byte
    and the scalar stores)."""
    from voxelhashing_demo_tpu_torch.ops import splat

    h, w, raw = _splat_buffer(case)
    cfg = _splat_cfg("full", splat_fill_rounds=rounds)
    cam = dataclasses.replace(cfg.camera, height=h, width=w,
                              cx=(w - 1) / 2 + 0.3, cy=(h - 1) / 2 - 0.2)
    raw = torch.as_tensor(raw, device=cuda)
    got = splat.finalize_depth(raw, cam, cfg.raycast, cfg.fusion)
    _assert_splat_equal(got, splat.finalize_depth_reference(
        raw, cam, cfg.raycast, cfg.fusion), f"{case} rounds {rounds}")


def test_kernel_info(cuda):
    """Each K9 and K7 instantiation reports its registers, spills and
    resident CTAs (``splat_finalize_info``, ``integrate_rows_info``): at
    least one CTA fits a multiprocessor."""
    import ctypes

    from voxelhashing_demo_tpu_torch import kernels

    for name, args in (("splat_finalize_info", range(17)),
                       ("integrate_rows_info", (2, 3, 4, 5, 8, 10))):
        for a in args:
            out = (ctypes.c_int * 5)()
            assert kernels.function(name)(a, out) == 0, (name, a)
            regs, spill, resident, threads, smem = out
            assert 0 < regs <= 255 and resident >= 1, (name, a, list(out))
            assert threads % 32 == 0 and smem <= 48 * 1024, (name, a)
    assert kernels.function("splat_finalize_info")(17, out) != 0
    assert kernels.function("integrate_rows_info")(11, out) != 0


def test_splat_no_sync_graph_replay_and_refusals(cuda, monkeypatch):
    """The stage reads nothing back to the host and replays from a CUDA
    graph bit for bit; what the kernels do not take raises, a refused
    launch raises, and the plain versions never run in their place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import splat

    cfg = _splat_cfg("full")
    hmap, active, pose = _splat_inputs(cuda, cfg, padded=True)
    args = (hmap, active, cfg.hash, pose, cfg.camera, cfg.raycast,
            cfg.fusion)
    eager = splat.splat_raycast(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        splat.splat_raycast(*args)
        splat.splat_depth_from_map(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        splat.splat_raycast(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = splat.splat_raycast(*args)
    graph.replay()
    torch.cuda.synchronize()
    _assert_splat_equal(captured, eager, "graph")

    with pytest.raises(ValueError, match="one CUDA device"):
        splat.splat_raycast(hmap, active, cfg.hash, pose.cpu(), cfg.camera,
                            cfg.raycast, cfg.fusion)
    with pytest.raises(ValueError, match="int32"):
        splat.splat_raycast(hmap, active._replace(
            count=active.count.long()), *args[2:])
    with pytest.raises(ValueError, match="float32"):
        splat.finalize_depth(eager.depth.double(), cfg.camera, cfg.raycast,
                             cfg.fusion)
    with pytest.raises(ValueError, match="fill rounds"):
        splat.finalize_depth(eager.depth, cfg.camera, dataclasses.replace(
            cfg.raycast, splat_fill_rounds=splat.MAX_FILL_ROUNDS + 1),
            cfg.fusion)
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("splat_raycast_reference", "splat_depth_from_map_reference",
                 "finalize_depth_reference", "surface_filter"):
        monkeypatch.setattr(splat, name, no_plain)
    with pytest.raises(RuntimeError, match="splat_zbuffer kernel launch"):
        splat.splat_raycast(*args)
    with pytest.raises(RuntimeError, match="splat_finalize kernel launch"):
        splat.finalize_depth(eager.depth, cfg.camera, cfg.raycast,
                             cfg.fusion)


# --------------------------------------------------------------------------
# K6 / K7: visible-set compaction and integration
# --------------------------------------------------------------------------

FUSE_FRAMES = 6          # room-sweep frames that grow the map
MAP_FIELDS = ("tsdf", "weight", "band_min", "born", "last_seen")


@pytest.fixture(scope="module")
def fuse_case():
    """(config, map, pose, the sweep's 48 poses, the next frame): a
    flagship map grown on the card by ``HashSLAM(flagship_gather_config())``
    over FUSE_FRAMES noisy room-sweep frames, and the preprocessed Frame
    of the sweep's next frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    from voxelhashing_demo_tpu_torch.config import flagship_gather_config
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = flagship_gather_config()
    depths, gt = synthetic.make_room_sweep(cfg.camera, 48, sweep_deg=150.0,
                                           noise_seed=1)
    slam = hash_slam.HashSLAM(cfg)
    for d in depths[:FUSE_FRAMES]:
        slam.process(d)
    frame = pre_ops.preprocess(
        hash_slam.depth_tensor(depths[FUSE_FRAMES], slam.device),
        cfg.camera, cfg.frontend)
    poses = [torch.as_tensor(np.asarray(p), dtype=torch.float32,
                             device="cuda") for p in gt]
    return cfg, slam.state.hmap, slam.state.pose, poses, frame


def _map_clone(hmap):
    return hmap._replace(**{f: getattr(hmap, f).clone() for f in (
        "keys", "ptrs", "bucket_fill", "free_list", "free_top") + MAP_FIELDS})


def _assert_active_equal(got, want, what: str):
    assert int(got.count) == int(want.count), what
    assert torch.equal(got.ptrs, want.ptrs), what
    assert torch.equal(got.blocks, want.blocks), what


def _assert_map_equal(got, want, what: str):
    for f in MAP_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        same = _bits_equal(a, b) if a.dtype == torch.float32 else \
            torch.equal(a, b)
        assert same, f"{what}: {f}"


def test_compact_visible_matches_plain_over_poses(fuse_case):
    """K6 bit for bit against ``compact_visible_reference`` (blocks, ptrs,
    count, and so the order) at each of the sweep's 48 poses, one launch
    each; rows past the count are padding."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, _, poses, _ = fuse_case
    seen = 0
    for k, T in enumerate(poses):
        args = (hmap, cfg.hash, T, cfg.camera, cfg.fusion)
        before = hash_ops.LAUNCHES_COMPACT
        got = hash_ops.compact_visible(*args)
        assert hash_ops.LAUNCHES_COMPACT == before + 1
        want = hash_ops.compact_visible_reference(*args)
        _assert_active_equal(got, want, f"pose {k}")
        n = int(got.count)
        assert bool((got.ptrs[n:] == hash_ops.FREE_PTR).all()), k
        assert not bool(got.blocks[n:].any()), k
        seen += n > 0
    assert seen >= 6


def test_compact_visible_overflow(fuse_case):
    """More visible entries than ``max_active``: the count is capped and
    the set holds the first ``max_active`` in table order, as the plain
    version's; a fresh output on every call."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, _ = fuse_case
    small = dataclasses.replace(cfg.hash, max_active=100)
    full = hash_ops.compact_visible_reference(hmap, cfg.hash, pose,
                                              cfg.camera, cfg.fusion)
    assert int(full.count) > 100
    args = (hmap, small, pose, cfg.camera, cfg.fusion)
    got = hash_ops.compact_visible(*args)
    _assert_active_equal(got, hash_ops.compact_visible_reference(*args),
                         "overflow")
    assert int(got.count) == 100
    assert torch.equal(got.ptrs, full.ptrs[:100])
    again = hash_ops.compact_visible(*args)
    assert again.ptrs.data_ptr() != got.ptrs.data_ptr()


def test_compact_visible_table_larger_than_the_grid(fuse_case):
    """A table of 2^21 entries is 1 024 tiles, about as many as the card
    holds CTAs at once, 70 % of them live (most entries visible): bit for
    bit against the plain version, and overflowing max_active."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, _, pose, _, _ = fuse_case
    rng = np.random.default_rng(11)
    big = dataclasses.replace(cfg.hash, num_buckets=2 ** 19)
    T = big.table_size
    blocks = np.stack([rng.integers(-24, 24, T), rng.integers(-24, 24, T),
                       rng.integers(-3, 30, T)], -1)
    b = blocks + (1 << (big.key_bits - 1))
    keys = ((b[:, 0] << (2 * big.key_bits)) | (b[:, 1] << big.key_bits)
            | b[:, 2]).astype(np.int32)
    ptrs = rng.integers(0, big.num_blocks, T).astype(np.int32)
    free = rng.random(T) < 0.3
    keys[free], ptrs[free] = hash_ops.EMPTY_KEY, hash_ops.FREE_PTR
    hmap = hash_ops.HashMap(
        keys=torch.as_tensor(keys, device="cuda"),
        ptrs=torch.as_tensor(ptrs, device="cuda"), **{
            f: None for f in hash_ops.HashMap._fields if f not in (
                "keys", "ptrs")})
    for A in (big.max_active, 64):
        h = dataclasses.replace(big, max_active=A)
        args = (hmap, h, pose, cfg.camera, cfg.fusion)
        got = hash_ops.compact_visible(*args)
        want = hash_ops.compact_visible_reference(*args)
        _assert_active_equal(got, want, f"max_active {A}")
        assert int(want.count) == A, A


def _compact_scratch_clean() -> bool:
    """Every K6 scratch as each launch leaves it: its epoch word's low
    half 0 (the epoch in the high half)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    torch.cuda.synchronize()
    return all(int(t[0]) & 0xFFFFFFFF == 0
               for t, _ in hash_ops._COMPACT_SCRATCH.values())


def _k6_table(fuse_case, T: int, live: int, seed: int = 0):
    """A table of T entries (keys and ptrs only), ``live`` of them at
    random places holding the fuse case's live entries (cycled; most are
    visible from its pose), the rest free."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    _, hmap, _, _, _ = fuse_case
    rng = np.random.default_rng(seed)
    src = (hmap.ptrs != hash_ops.FREE_PTR).nonzero().flatten().cpu().numpy()
    at = torch.as_tensor(rng.choice(T, live, replace=False), device="cuda")
    pick = torch.as_tensor(src[np.arange(live) % src.size], device="cuda")
    keys = torch.full((T,), hash_ops.EMPTY_KEY, dtype=torch.int32,
                      device="cuda")
    ptrs = torch.full((T,), hash_ops.FREE_PTR, dtype=torch.int32,
                      device="cuda")
    keys[at] = hmap.keys[pick]
    ptrs[at] = hmap.ptrs[pick]
    return hash_ops.HashMap(keys=keys, ptrs=ptrs, **{
        f: None for f in hash_ops.HashMap._fields if f not in ("keys",
                                                                "ptrs")})


def _k6_pair(hmap, hcfg, pose, cfg, what: str):
    """K6 against the plain version bit for bit on ``hmap``, one launch;
    every row past the count padding; the scratch left clean."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    args = (hmap, hcfg, pose, cfg.camera, cfg.fusion)
    before = hash_ops.LAUNCHES_COMPACT
    got = hash_ops.compact_visible(*args)
    assert hash_ops.LAUNCHES_COMPACT == before + 1
    want = hash_ops.compact_visible_reference(*args)
    _assert_active_equal(got, want, what)
    n = int(got.count)
    assert bool((got.ptrs[n:] == hash_ops.FREE_PTR).all()), what
    assert not bool(got.blocks[n:].any()), what
    assert _compact_scratch_clean(), what
    return got


@pytest.mark.parametrize("T", [1, 2048, 4089, 127 * 2048, 128 * 2048,
                               128 * 2048 + 5, 1024 * 2048, 2048 * 2048],
                         ids=["tiles1_T1", "tiles1", "tiles2_ragged",
                              "tiles127", "tiles128", "tiles129_ragged",
                              "tiles1024", "tiles2048"])
def test_compact_visible_tile_counts(fuse_case, T):
    """K6 on tables of 1, 2, 127, 128, 129, 1 024 and 2 048 tiles (the
    last more than the card holds CTAs at once, so the CTAs take tiles in
    a loop), T a multiple of the 2 048-entry tile or not, ~800 live
    entries (one in a one-entry table): bit for bit against the plain
    version, the pad rows, the scratch clean."""
    cfg, _, pose, _, _ = fuse_case
    hmap = _k6_table(fuse_case, T, min(T, 800), seed=T % 97)
    got = _k6_pair(hmap, cfg.hash, pose, cfg, f"T {T}")
    if T > 1:
        assert 0 < int(got.count) < cfg.hash.max_active


def test_compact_visible_all_free(fuse_case):
    """An all-free table: count 0, every row padding (the step's table
    size and one tile)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, _ = fuse_case
    for T in (hmap.keys.shape[0], 2048):
        free = _k6_table(fuse_case, T, 0)
        got = _k6_pair(free, cfg.hash, pose, cfg, f"free T {T}")
        assert int(got.count) == 0
        assert bool((got.ptrs == hash_ops.FREE_PTR).all())


def test_compact_visible_every_entry_visible(fuse_case):
    """Every entry of a 3-tile table live and visible, more than
    max_active: the count is capped and the set holds the first
    max_active entries in table order; at max_active 0 no row at all."""
    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, _ = fuse_case
    h = cfg.hash
    mask = (hmap.ptrs != hash_ops.FREE_PTR) & hash_ops.block_in_frustum(
        coords.unpack_block_key(hmap.keys, h.key_bits), pose, cfg.camera, h,
        cfg.fusion)
    idx = mask.nonzero().flatten()
    T = 3 * 2048 - 100
    idx = idx[torch.arange(T, device="cuda") % idx.numel()]
    table = hash_ops.HashMap(keys=hmap.keys[idx].contiguous(),
                             ptrs=hmap.ptrs[idx].contiguous(), **{
                                 f: None for f in hash_ops.HashMap._fields
                                 if f not in ("keys", "ptrs")})
    for A in (h.max_active, 0):
        got = _k6_pair(table, dataclasses.replace(h, max_active=A), pose,
                       cfg, f"every entry, A {A}")
        assert int(got.count) == A, A


def test_compact_visible_repeats_replays_and_scratch(fuse_case):
    """Two launches give the same set bit for bit; a CUDA graph captured
    on a stream that ran K6 replays on that stream's persistent scratch
    and equals the eager launch, twice; one captured on a fresh stream
    takes a scratch of its own (no persistent one is made for it) and
    equals it too; every persistent scratch is clean after each."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, _ = fuse_case
    args = (hmap, cfg.hash, pose, cfg.camera, cfg.fusion)
    eager = hash_ops.compact_visible(*args)
    again = hash_ops.compact_visible(*args)
    _assert_active_equal(again, eager, "repeat")
    assert _compact_scratch_clean()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hash_ops.compact_visible(*args)
    torch.cuda.synchronize()
    n_scratch = len(hash_ops._COMPACT_SCRATCH)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = hash_ops.compact_visible(*args)
    assert len(hash_ops._COMPACT_SCRATCH) == n_scratch
    for k in range(2):
        graph.replay()
        torch.cuda.synchronize()
        _assert_active_equal(captured, eager, f"graph replay {k}")
        assert _compact_scratch_clean()
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    g2 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g2, stream=fresh):
        own = hash_ops.compact_visible(*args)
    key = (torch.cuda.current_device(), fresh.cuda_stream)
    assert key not in hash_ops._COMPACT_SCRATCH
    for k in range(2):
        g2.replay()
        torch.cuda.synchronize()
        _assert_active_equal(own, eager, f"fresh-stream replay {k}")
    assert _compact_scratch_clean()


def test_integrate_small_blocks(cuda):
    """K7 at block size 4 (64 voxels a row, most of a CTA idle) and at the
    tiny camera, both signs, bit for bit against the plain integrate on a
    map grown on the card at that block size."""
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = _tiny_gather_config()
    cfg = dataclasses.replace(base, hash=dataclasses.replace(
        base.hash, block_size=4))
    depths, _ = synthetic.make_sequence(cfg.camera, 4, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device=cuda)
    for d in depths[:3]:
        slam.process(d)
    depth = pre_ops.preprocess(hash_slam.depth_tensor(depths[3], cuda),
                               cfg.camera, cfg.frontend).depth
    for sign, max_born, stamp in ((1, None, 5), (-1, 1, None)):
        got, want, active = _integrate_pair(cfg, slam.state.hmap,
                                            slam.state.pose, depth, sign,
                                            max_born, stamp)
        _assert_map_equal(got, want, f"block size 4, sign {sign}")
        assert int(active.count) > 0


@pytest.mark.parametrize("block_size", [3, 5])
def test_integrate_blocks_not_a_multiple_of_four(cuda, block_size):
    """K7's instantiation of one voxel a thread (V = 27, 125: no 16-byte
    rows) bit for bit against the plain integrate, both signs, the born
    gate and the stamp as a 0-d tensor on the card, on a map grown on the
    card at that block size; window on and off."""
    from voxelhashing_demo_tpu_torch.models import hash_slam
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    base = _tiny_gather_config()
    cfg = dataclasses.replace(base, hash=dataclasses.replace(
        base.hash, block_size=block_size))
    depths, _ = synthetic.make_sequence(cfg.camera, 4, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    slam = hash_slam.HashSLAM(cfg, device=cuda)
    for d in depths[:3]:
        slam.process(d)
    depth = pre_ops.preprocess(hash_slam.depth_tensor(depths[3], cuda),
                               cfg.camera, cfg.frontend).depth
    stamp = torch.tensor(6, dtype=torch.int32, device=cuda)
    for window in (True, False):
        c = dataclasses.replace(cfg, hash=dataclasses.replace(
            cfg.hash, use_pallas_gather=window))
        for sign, max_born, st in ((1, None, stamp), (-1, 1, None)):
            got, want, active = _integrate_pair(
                c, slam.state.hmap, slam.state.pose, depth, sign, max_born,
                st)
            _assert_map_equal(got, want, f"block size {block_size}, "
                                         f"window {window}, sign {sign}")
            assert int(active.count) > 0


def _integrate_pair(cfg, hmap, pose, depth, sign, max_born, stamp):
    """(kernel map, plain map) after one update from copies of ``hmap``:
    ``integrate`` against ``integrate_reference`` and ``touch_active``."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    got, want = _map_clone(hmap), _map_clone(hmap)
    active = hash_ops.compact_visible(got, cfg.hash, pose, cfg.camera,
                                      cfg.fusion)
    before = (hash_ops.LAUNCHES_INTEGRATE, hash_ops.LAUNCHES_INTEGRATE_WINDOW)
    hash_ops.integrate(got, active, cfg.hash, depth, pose, cfg.camera,
                       cfg.fusion, sign=sign, max_born=max_born, stamp=stamp)
    window = int(hash_ops._window_mode(cfg.hash))
    assert (hash_ops.LAUNCHES_INTEGRATE,
            hash_ops.LAUNCHES_INTEGRATE_WINDOW) == (before[0] + 1,
                                                    before[1] + window)
    if stamp is not None:
        hash_ops.touch_active(want, active, stamp)
    hash_ops.integrate_reference(want, active, cfg.hash, depth, pose,
                                 cfg.camera, cfg.fusion, sign, max_born)
    return got, want, active


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("window", [True, False])
def test_integrate_matches_plain(fuse_case, window, sign):
    """K7 bit for bit against ``integrate_reference`` (+ ``touch_active``
    with a stamp) on every map field: both gather modes, both signs, the
    ``max_born`` gate cutting rows out, rows at the weight cap, at the
    step's pose and at a pose 0.9 m closer to the wall, where the window
    clips near-range rows."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    cfg, hmap, pose, _, frame = fuse_case
    depth = frame.depth
    cfg = dataclasses.replace(cfg, hash=dataclasses.replace(
        cfg.hash, use_pallas_gather=window))
    hmap = _map_clone(hmap)
    hmap.weight[::7] = torch.where(hmap.weight[::7] > 0, 254.75, 0.0)
    closer = pose @ se3.exp(torch.tensor([0.0, 0.0, 0.9, 0.0, 0.0, 0.0],
                                         device=pose.device))
    max_born = FUSE_FRAMES // 2 if sign < 0 else None
    stamp = 41 if sign > 0 else None
    for name, T in (("step", pose), ("closer", closer)):
        got, want, active = _integrate_pair(cfg, hmap, T, depth, sign,
                                            max_born, stamp)
        _assert_map_equal(got, want, f"{name} window={window} sign={sign}")
        assert int(active.count) > 0, name
        assert not torch.equal(got.weight, hmap.weight), name
        if stamp is not None:
            n = int(active.count)
            rows = active.ptrs[:n].long()
            assert bool((got.last_seen[rows] == stamp).all()), name


def test_fuse_no_sync_and_graph_replay(fuse_case, monkeypatch):
    """compact -> touch -> integrate (K6, K7 with the stamp) reads nothing
    on the host, ``fuse_frame`` nothing outside allocation, and K6 + K7
    captured in a CUDA graph replay what they do eagerly, bit for bit."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, frame = fuse_case

    def stage(m):
        a = hash_ops.compact_visible(m, cfg.hash, pose, cfg.camera,
                                     cfg.fusion)
        hash_ops.integrate(m, a, cfg.hash, frame.depth, pose, cfg.camera,
                           cfg.fusion, stamp=9)

    eager = _map_clone(hmap)
    stage(eager)
    torch.cuda.synchronize()
    m = _map_clone(hmap)
    torch.cuda.set_sync_debug_mode("error")
    try:
        stage(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_map_equal(m, eager, "no-sync run")

    real_alloc = hash_ops.allocate_from_frame

    def alloc_may_sync(*a, **k):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_alloc(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(hash_ops, "allocate_from_frame", alloc_may_sync)
    torch.cuda.set_sync_debug_mode("error")
    try:
        hash_ops.fuse_frame(_map_clone(hmap), frame, pose, cfg.camera,
                            cfg.hash, cfg.fusion, frame_idx=9)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    g = _map_clone(hmap)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stage(g)
    torch.cuda.current_stream().wait_stream(side)
    for f in MAP_FIELDS:
        getattr(g, f).copy_(getattr(hmap, f))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stage(g)
    graph.replay()
    torch.cuda.synchronize()
    _assert_map_equal(g, eager, "graph")


def test_fuse_refusals(fuse_case, monkeypatch):
    """What the kernels do not take raises; a refused build and a refused
    launch raise; the plain versions never run in their place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, frame = fuse_case
    hmap = _map_clone(hmap)
    active = hash_ops.compact_visible(hmap, cfg.hash, pose, cfg.camera,
                                      cfg.fusion)
    args = (cfg.hash, frame.depth, pose, cfg.camera, cfg.fusion)
    with pytest.raises(ValueError, match="one CUDA device"):
        hash_ops.compact_visible(hmap, cfg.hash, pose.cpu(), cfg.camera,
                                 cfg.fusion)
    with pytest.raises(ValueError, match="one CUDA device"):
        hash_ops.integrate(hmap, active, cfg.hash, frame.depth.cpu(),
                           *args[2:])
    with pytest.raises(ValueError, match="int32"):
        hash_ops.integrate(hmap, active._replace(count=active.count.long()),
                           *args)
    with pytest.raises(ValueError, match="depth"):
        hash_ops.integrate(hmap, active, cfg.hash, frame.depth[1:],
                           *args[2:])
    with pytest.raises(ValueError, match="voxels a block"):
        hash_ops.integrate(hmap, active, dataclasses.replace(
            cfg.hash, block_size=16), *args[1:])

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("compact_visible_reference", "integrate_reference",
                 "_integrate_rows", "block_in_frustum", "touch_active"):
        monkeypatch.setattr(hash_ops, name, no_plain)
    monkeypatch.setattr(kernels, "_FUNCTIONS", {})

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(kernels, "build", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        hash_ops.compact_visible(hmap, cfg.hash, pose, cfg.camera,
                                 cfg.fusion)
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="compact_visible kernel launch"):
        hash_ops.compact_visible(hmap, cfg.hash, pose, cfg.camera,
                                 cfg.fusion)
    with pytest.raises(RuntimeError, match="integrate_rows kernel launch"):
        hash_ops.integrate(hmap, active, *args, stamp=3)


# --------------------------------------------------------------------------
# K5a / K5b: block allocation
# --------------------------------------------------------------------------

ALL_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top") + \
    MAP_FIELDS


def _assert_all_fields_equal(got, want, what: str):
    for f in ALL_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        same = _bits_equal(a, b) if a.dtype == torch.float32 else \
            torch.equal(a, b)
        assert same, f"{what}: {f}"


def _insert_pair(hcfg, hmap, cand, stamp=7, bucket_fn=None):
    """(kernel map, plain map, kernel n_alloc, plain n_alloc) after one
    insert of ``cand`` into copies of ``hmap``, one K5b launch."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    got, want = _map_clone(hmap), _map_clone(hmap)
    before = hash_ops.LAUNCHES_INSERT
    _, n_got = hash_ops.insert_blocks(got, hcfg, cand, stamp, bucket_fn)
    assert hash_ops.LAUNCHES_INSERT == before + 1
    _, n_want = hash_ops.insert_blocks_reference(want, hcfg, cand, stamp,
                                                 bucket_fn)
    return got, want, n_got, n_want


def _pose_far(pose):
    """``pose`` moved 90 m along x: most band blocks leave the key range."""
    far = pose.clone()
    far[0, 3] += 90.0
    return far


def test_candidate_keys_match_plain(fuse_case):
    """K5a bit for bit against ``frame_candidate_keys_reference``: the
    step's frame at the sweep's 48 poses and at a pose whose blocks leave
    the key range; strides 1, 2, 3 and band steps 1, 3, 4, 5, 7; one
    launch a call, a fresh output each."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, _, pose, poses, frame = fuse_case
    args = (cfg.camera, cfg.hash, cfg.fusion)
    for k, T in enumerate(poses + [pose, _pose_far(pose)]):
        before = hash_ops.LAUNCHES_ALLOC_CANDIDATES
        got = hash_ops.frame_candidate_keys(frame, T, *args)
        assert hash_ops.LAUNCHES_ALLOC_CANDIDATES == before + 1
        want = hash_ops.frame_candidate_keys_reference(frame, T, *args)
        assert torch.equal(got, want), f"pose {k}"
    far = hash_ops.frame_candidate_keys(frame, _pose_far(pose), *args)
    assert bool((far == hash_ops.EMPTY_KEY).any())
    for stride, steps in ((1, 3), (2, 5), (3, 1), (3, 4), (3, 7)):
        h = dataclasses.replace(cfg.hash, candidate_stride=stride,
                                band_steps=steps)
        got = hash_ops.frame_candidate_keys(frame, pose, cfg.camera, h,
                                            cfg.fusion)
        want = hash_ops.frame_candidate_keys_reference(
            frame, pose, cfg.camera, h, cfg.fusion)
        assert torch.equal(got, want), (stride, steps)
    again = hash_ops.frame_candidate_keys(frame, pose, *args)
    assert again.data_ptr() != got.data_ptr()


# K5a's edges on the step's frame: cut to 479 x 637 (no side a multiple
# of strides 2-4) at strides 1-4; band steps 2; valid depths whose
# vertices are not finite (inf, -inf, NaN in one coordinate or all
# three); 7 band steps at a pose whose keys leave the key range
K5A_EDGES = ("stride_1_odd", "stride_2_odd", "stride_3_odd", "stride_4_odd",
             "band_steps_2", "nonfinite_vertices", "far_pose_steps_7")


@pytest.mark.parametrize("which", K5A_EDGES)
def test_candidate_keys_edges(fuse_case, which):
    """K5a bit for bit against ``frame_candidate_keys_reference`` on its
    edges (``K5A_EDGES``); one launch a call."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, _, pose, _, frame = fuse_case
    h = cfg.hash
    if which.startswith("stride_"):
        s = int(which.split("_")[1])
        h = dataclasses.replace(h, candidate_stride=s)
        frame = frame._replace(**{f: getattr(frame, f)[:479, :637]
                                  .contiguous() for f in frame._fields})
        assert s == 1 or (479 % s and 637 % s)
    elif which == "band_steps_2":
        h = dataclasses.replace(h, band_steps=2)
    elif which == "nonfinite_vertices":
        v = frame.vertices.clone()
        at = (frame.depth > 0).nonzero()[::97][:40]
        v[at[:10, 0], at[:10, 1], 0] = float("inf")
        v[at[10:20, 0], at[10:20, 1], 1] = -float("inf")
        v[at[20:30, 0], at[20:30, 1], 2] = float("nan")
        v[at[30:, 0], at[30:, 1]] = float("nan")
        frame = frame._replace(vertices=v)
    else:
        h = dataclasses.replace(h, band_steps=7)
        pose = _pose_far(pose)
    before = hash_ops.LAUNCHES_ALLOC_CANDIDATES
    got = hash_ops.frame_candidate_keys(frame, pose, cfg.camera, h,
                                        cfg.fusion)
    assert hash_ops.LAUNCHES_ALLOC_CANDIDATES == before + 1
    want = hash_ops.frame_candidate_keys_reference(frame, pose, cfg.camera,
                                                   h, cfg.fusion)
    assert got.shape == want.shape and torch.equal(got, want)
    if which == "far_pose_steps_7":
        assert bool((got == hash_ops.EMPTY_KEY).any())


@pytest.mark.parametrize("case", ["step", "cap", "heap", "full_buckets"])
def test_insert_blocks_matches_plain(fuse_case, case):
    """K5b bit for bit against ``insert_blocks_reference`` on every map
    field and n_alloc, the step's candidates at four of the sweep's poses:
    into the step's map; with max_new_per_frame cut to 256 (the cap);
    with free_top below the new keys (the heap runs dry mid-bucket); into
    a table of 512 buckets already filled to 3 and 4 by another pose (the
    in-bucket rank overflows)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, poses, frame = fuse_case
    hcfg = cfg.hash
    if case == "cap":
        hcfg = dataclasses.replace(hcfg, max_new_per_frame=256)
    if case == "full_buckets":
        hcfg = dataclasses.replace(hcfg, num_buckets=512)
        hmap = hash_ops.create(hcfg, device="cuda")
        hash_ops.insert_blocks_reference(hmap, hcfg, hash_ops.
                                         frame_candidate_keys_reference(
                                             frame, poses[20], cfg.camera,
                                             hcfg, cfg.fusion), 3)
        assert bool((hmap.bucket_fill == 3).any())
        assert bool((hmap.bucket_fill == 4).any())
    for T in (pose, poses[0], poses[12], poses[30]):
        cand = hash_ops.frame_candidate_keys_reference(frame, T, cfg.camera,
                                                       hcfg, cfg.fusion)
        m = hmap
        if case == "heap":
            probe = _map_clone(hmap)
            _, n = hash_ops.insert_blocks_reference(probe, hcfg, cand, 7)
            m = _map_clone(hmap)
            m.free_top.fill_(max(int(n) // 2, 1))
        got, want, n_got, n_want = _insert_pair(hcfg, m, cand)
        _assert_all_fields_equal(got, want, case)
        assert int(n_got) == int(n_want), case
    assert int(n_want) > 0


@pytest.mark.parametrize("unique", [100, 3000, 4096, 4097, 20000, 60000])
def test_insert_blocks_random_keys(cuda, unique):
    """K5b bit for bit against the plain version on ``unique`` distinct
    random keys, each repeated 1-4 times in a shuffled array with
    EMPTY_KEY and a tenth of them negative (compared as signed int32),
    into a map that holds some of them already; U above max_new takes
    the cap path.  Three runs give the same map (the atomics' order does
    not show)."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg = flagship_config().hash
    rng = np.random.default_rng(unique)
    keys = rng.choice(2 ** 30, unique, replace=False).astype(np.int64)
    neg = rng.random(unique) < 0.1
    keys[neg] = -keys[neg] - 1
    keys = keys.astype(np.int32)
    cand = np.concatenate([np.repeat(keys, rng.integers(1, 5, unique)),
                           np.full(unique // 3, hash_ops.EMPTY_KEY,
                                   np.int32)])
    rng.shuffle(cand)
    hmap = hash_ops.create(hcfg, device="cuda")
    pre = torch.as_tensor(keys[rng.random(unique) < 0.2], device="cuda")
    hash_ops.insert_blocks_reference(hmap, hcfg, pre, 2)
    cand = torch.as_tensor(cand, device="cuda")
    runs = [_insert_pair(hcfg, hmap, cand) for _ in range(3)]
    for got, want, n_got, n_want in runs:
        _assert_all_fields_equal(got, want, f"U={unique}")
        assert int(n_got) == int(n_want)
        _assert_all_fields_equal(got, runs[0][0], "repeat")
    assert int(runs[0][3]) > 0


def _scratch_clean(cuda) -> bool:
    """Every K5b scratch as each launch leaves it: header 0, set empty."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    torch.cuda.synchronize()
    for t, capacity, set_bits in hash_ops._INSERT_SCRATCH.values():
        hdr, st = hash_ops.insert_scratch_parts(t, capacity, set_bits)
        if hdr.any() or not bool((st == hash_ops.EMPTY_KEY).all()):
            return False
    return True


def _random_cand(rng, unique: int, device):
    """``unique`` distinct random keys (a tenth negative), each 1-4 times,
    shuffled with EMPTY_KEY, on ``device``."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    keys = rng.choice(2 ** 30, unique, replace=False).astype(np.int64)
    neg = rng.random(unique) < 0.1
    keys[neg] = -keys[neg] - 1
    cand = np.concatenate([np.repeat(keys.astype(np.int32),
                                     rng.integers(1, 5, unique)),
                           np.full(unique // 3 + 1, hash_ops.EMPTY_KEY,
                                   np.int32)])
    rng.shuffle(cand)
    return torch.as_tensor(cand, device=device)


def test_insert_blocks_shared_scratch(cuda):
    """Consecutive K5b launches on one stream share its persistent
    scratch while M shrinks and grows (a larger M replaces it; the
    replaced one stays alive), across the cap path (U above max_new) and
    a frame with no key: each bit for bit against the plain version on
    the map the last one left, and the scratch clean after each.  Then
    two inserts of different M captured in one CUDA graph on that stream
    replay bit for bit, twice, and leave the scratch clean."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg = flagship_config().hash
    rng = np.random.default_rng(7)
    got = hash_ops.create(hcfg, device="cuda")
    want = _map_clone(got)
    stream = torch.cuda.Stream()
    key = (torch.cuda.current_device(), stream.cuda_stream)
    seen = []
    with torch.cuda.stream(stream):
        for step, unique in enumerate((3000, 40, 30000, 6000, 0, 500)):
            cand = _random_cand(rng, unique, cuda)
            _, n_got = hash_ops.insert_blocks(got, hcfg, cand, step)
            _, n_want = hash_ops.insert_blocks_reference(want, hcfg, cand,
                                                         step)
            stream.synchronize()
            _assert_all_fields_equal(got, want, f"U={unique}")
            assert int(n_got) == int(n_want), unique
            assert _scratch_clean(cuda), unique
            seen.append(hash_ops._INSERT_SCRATCH[key])
    assert seen[1] is seen[0] and seen[2] is not seen[1]
    assert seen[3] is seen[2] and seen[5] is seen[2]
    assert any(t is seen[0][0] for t in hash_ops._INSERT_RETIRED)
    assert int(n_want) > 0

    a = _random_cand(rng, 2000, cuda)
    b = _random_cand(rng, 9000, cuda)
    base = _map_clone(got)
    g = _map_clone(got)
    with torch.cuda.stream(stream):
        hash_ops.insert_blocks(_map_clone(got), hcfg, b, 9)    # warm
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            hash_ops.insert_blocks(g, hcfg, a, 8)
            hash_ops.insert_blocks(g, hcfg, b, 9)
    hash_ops.insert_blocks_reference(want, hcfg, a, 8)
    hash_ops.insert_blocks_reference(want, hcfg, b, 9)
    for _ in range(2):
        for fld in ALL_FIELDS:
            getattr(g, fld).copy_(getattr(base, fld))
        graph.replay()
        torch.cuda.synchronize()
        _assert_all_fields_equal(g, want, "graph")
        assert _scratch_clean(cuda)


def test_insert_blocks_graphs_on_a_fresh_stream(cuda):
    """Two K5b launches captured into two CUDA graphs on a stream that has
    no scratch yet each take a scratch of their own (none is kept for the
    stream); an eager launch on that stream before either graph has run
    makes the stream's scratch; then the second graph replays before the
    first, and a third graph captured on the stream's scratch replays
    twice: each bit for bit against the plain version, every scratch
    left clean."""
    from voxelhashing_demo_tpu_torch.config import flagship_config
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg = flagship_config().hash
    rng = np.random.default_rng(11)
    base = hash_ops.create(hcfg, device="cuda")
    hash_ops.insert_blocks_reference(base, hcfg,
                                     _random_cand(rng, 4000, cuda), 1)
    a, b = _random_cand(rng, 2500, cuda), _random_cand(rng, 9000, cuda)
    hash_ops.insert_blocks(_map_clone(base), hcfg, a, 2)   # built, loaded
    want = {}
    for name, cand in (("a", a), ("b", b)):
        want[name] = _map_clone(base)
        hash_ops.insert_blocks_reference(want[name], hcfg, cand, 2)
    stream = torch.cuda.Stream()
    key = (torch.cuda.current_device(), stream.cuda_stream)
    stream.wait_stream(torch.cuda.current_stream())
    maps, graphs = {}, {}
    with torch.cuda.stream(stream):
        for name, cand in (("a", a), ("b", b)):
            maps[name] = _map_clone(base)
            graphs[name] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[name], stream=stream):
                hash_ops.insert_blocks(maps[name], hcfg, cand, 2)
        assert key not in hash_ops._INSERT_SCRATCH
        eager = _map_clone(base)
        hash_ops.insert_blocks(eager, hcfg, b, 2)
        assert key in hash_ops._INSERT_SCRATCH
        for name in ("b", "a"):
            graphs[name].replay()
    stream.synchronize()
    _assert_all_fields_equal(eager, want["b"], "eager")
    for name in ("b", "a"):
        _assert_all_fields_equal(maps[name], want[name], f"graph {name}")
    assert _scratch_clean(cuda)

    third = _map_clone(base)
    with torch.cuda.stream(stream):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            hash_ops.insert_blocks(third, hcfg, a, 2)
    for _ in range(2):
        with torch.cuda.stream(stream):
            for fld in ALL_FIELDS:
                getattr(third, fld).copy_(getattr(base, fld))
            graph.replay()
        stream.synchronize()
        _assert_all_fields_equal(third, want["a"], "graph on the scratch")
        assert _scratch_clean(cuda)


def test_insert_blocks_sharded_bucket(fuse_case):
    """K5b with ``BucketHash(num_buckets, 2)`` (the sharded step's
    owner-local bucket) on the keys rank 1 of two owns, into a half-size
    table, bit for bit against the plain version."""
    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, _, pose, _, frame = fuse_case
    g = cfg.hash
    local = dataclasses.replace(
        g, num_buckets=g.num_buckets // 2, num_blocks=g.num_blocks // 2,
        max_new_per_frame=g.max_new_per_frame // 2)
    cand = hash_ops.frame_candidate_keys(frame, pose, cfg.camera, local,
                                         cfg.fusion)
    blocks = coords.unpack_block_key(cand, g.key_bits)
    mine = (coords.spatial_hash(blocks, g.num_buckets) % 2 == 1) & (
        cand != hash_ops.EMPTY_KEY)
    routed = torch.where(mine, cand, hash_ops.EMPTY_KEY)
    fn = hash_ops.BucketHash(g.num_buckets, 2)
    hmap = hash_ops.create(local, device="cuda")
    got, want, n_got, n_want = _insert_pair(local, hmap, routed, 4, fn)
    _assert_all_fields_equal(got, want, "sharded")
    assert int(n_got) == int(n_want) > 0


def test_stamp_from_a_device_scalar(fuse_case):
    """K5b and K7 stamp the same rows with an int and with a 0-d int32
    tensor on the card."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, frame = fuse_case
    cand = hash_ops.frame_candidate_keys(frame, pose, cfg.camera, cfg.hash,
                                         cfg.fusion)
    stamp = torch.tensor(23, dtype=torch.int32, device="cuda")
    a, b = _map_clone(hmap), _map_clone(hmap)
    hash_ops.insert_blocks(a, cfg.hash, cand, 23)
    hash_ops.insert_blocks(b, cfg.hash, cand, stamp)
    _assert_all_fields_equal(a, b, "insert stamp")
    for m, s in ((a, 23), (b, stamp)):
        active = hash_ops.compact_visible(m, cfg.hash, pose, cfg.camera,
                                          cfg.fusion)
        hash_ops.integrate(m, active, cfg.hash, frame.depth, pose,
                           cfg.camera, cfg.fusion, stamp=s)
    _assert_all_fields_equal(a, b, "integrate stamp")
    assert bool((a.last_seen == 23).any())


def test_alloc_no_sync_and_graph_replay(fuse_case):
    """``allocate_from_frame`` (K5a, K5b) and ``fuse_frame`` (K5a, K5b,
    K6, K7) read nothing on the host; K5a + K5b captured in a CUDA graph
    replay what they do eagerly, bit for bit."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, frame = fuse_case
    args = (frame, pose, cfg.camera, cfg.hash, cfg.fusion)
    eager = _map_clone(hmap)
    _, n_eager = hash_ops.allocate_from_frame(eager, *args, frame_idx=9)
    torch.cuda.synchronize()
    a, f = _map_clone(hmap), _map_clone(hmap)
    torch.cuda.set_sync_debug_mode("error")
    try:
        hash_ops.allocate_from_frame(a, *args, frame_idx=9)
        hash_ops.fuse_frame(f, *args, frame_idx=9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_all_fields_equal(a, eager, "no-sync run")
    g = _map_clone(hmap)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hash_ops.allocate_from_frame(_map_clone(hmap), *args, frame_idx=9)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, n_graph = hash_ops.allocate_from_frame(g, *args, frame_idx=9)
    for fld in ALL_FIELDS:
        getattr(g, fld).copy_(getattr(hmap, fld))
    graph.replay()
    torch.cuda.synchronize()
    _assert_all_fields_equal(g, eager, "graph")
    assert int(n_graph) == int(n_eager) > 0


def test_alloc_refusals(fuse_case, monkeypatch):
    """What K5a and K5b do not take raises (a bucket function that is not
    a BucketHash, max_new past one CTA's shared memory, tensors on two
    devices, a stamp tensor of another type); a refused launch raises; the
    plain versions never run in their place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.geometry import coords
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, pose, _, frame = fuse_case
    hmap = _map_clone(hmap)
    cand = hash_ops.frame_candidate_keys(frame, pose, cfg.camera, cfg.hash,
                                         cfg.fusion)
    with pytest.raises(ValueError, match="BucketHash"):
        hash_ops.insert_blocks(hmap, cfg.hash, cand, 1, lambda b: coords.
                               spatial_hash(b, cfg.hash.num_buckets))
    with pytest.raises(ValueError, match="max_new_per_frame"):
        hash_ops.insert_blocks(hmap, dataclasses.replace(
            cfg.hash, max_new_per_frame=4097), cand, 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        hash_ops.insert_blocks(hmap, cfg.hash, cand.cpu(), 1)
    with pytest.raises(ValueError, match="stamp"):
        hash_ops.insert_blocks(hmap, cfg.hash, cand, torch.tensor(
            1, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError, match="one CUDA device"):
        hash_ops.frame_candidate_keys(frame, pose.cpu(), cfg.camera,
                                      cfg.hash, cfg.fusion)

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("frame_candidate_keys_reference", "insert_blocks_reference",
                 "_unique_compact", "lookup_keys", "_set_rows"):
        monkeypatch.setattr(hash_ops, name, no_plain)
    hash_ops.allocate_from_frame(hmap, frame, pose, cfg.camera, cfg.hash,
                                 cfg.fusion, frame_idx=2)
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="alloc_candidates kernel launch"):
        hash_ops.frame_candidate_keys(frame, pose, cfg.camera, cfg.hash,
                                      cfg.fusion)
    with pytest.raises(RuntimeError, match="insert_blocks kernel launch"):
        hash_ops.insert_blocks(hmap, cfg.hash, cand, 1)


# --------------------------------------------------------------------------
# K13: pose-graph bundle adjustment (K13a pg_edge_blocks, K13b pg_cg_solve,
# K13c pg_retract)
# --------------------------------------------------------------------------

def _pg_ring(device, real: int, cap: int, seed: int = 3, chords: bool = True,
             false_edge: bool = False):
    """A seeded ring pose graph of ``real`` poses in capacity ``cap`` (edges
    2 cap): noisy-odometry estimates, the true odometry and closure, a
    chord every 8 poses and, with ``false_edge``, a closure wrong by ~0.5 m
    and 0.3 rad."""
    from voxelhashing_demo_tpu_torch.geometry import se3
    from voxelhashing_demo_tpu_torch.ops import pose_graph

    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(real) / real
    xi = np.zeros((real, 6), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = np.cos(ang), np.sin(ang), ang
    gt = se3.exp(torch.from_numpy(xi)).numpy().astype(np.float64)
    noise = np.concatenate([rng.normal(0, 0.02, (real, 3)),
                            rng.normal(0, 0.01, (real, 3))], 1).astype(
                                np.float32)
    est = (gt.astype(np.float32) @ se3.exp(torch.from_numpy(noise)).numpy())
    g = pose_graph.create(cap, 2 * cap, device=device)
    for T in est:
        g = pose_graph.add_pose(g, T)
    pairs = [(i, (i + 1) % real) for i in range(real)]
    pairs += [(i, (i + real // 2) % real) for i in range(0, real, 8)]
    for i, j in pairs if chords else pairs[:real]:
        g = pose_graph.add_edge(
            g, i, j, (np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32),
            float(rng.uniform(0.5, 2.0)))
    if false_edge:
        bad = se3.exp(torch.tensor([0.5, -0.3, 0.2, 0.0, 0.3, 0.0])).numpy()
        g = pose_graph.add_edge(g, 2, real // 2, bad, 1.0)
    return g


def _pg_close(got, plain, what: str, rtol: float = 1e-6):
    """Within ``rtol`` of the plain tensor's largest magnitude (bit for bit
    where the orders agree)."""
    assert got.shape == plain.shape, what
    scale = max(1.0, float(plain.abs().max()))
    err = float((got.float() - plain.float()).abs().max())
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("robust", [(None, "gm"), (0.1, "gm"),
                                    (np.float32(0.3), "gm"), (0.1, "huber")])
@pytest.mark.parametrize("mode", ["chi2", "dense", "cg"])
def test_pg_edge_blocks_match_plain(cuda, mode, robust):
    """K13a against its plain version on the same graph: J, r, the rows
    (blocks, gradients, w |r|^2, w), b, chi2 and the dense H (with and
    without the diagonal) or Hd, within 1e-6 of each tensor's scale; a pad
    edge (weight 0) adds nothing."""
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    g = _pg_ring(cuda, 24, 32, false_edge=True)
    for diag in ((False, True) if mode == "dense" else (False,)):
        got = pg.edge_system(g, mode, *robust, diag=diag, damping=1e-4)
        plain = pg.edge_system_reference(g, mode, *robust, diag=diag,
                                         damping=1e-4)
        torch.cuda.synchronize()
        _pg_close(got.r, plain.r, "r")
        _pg_close(got.chi2, plain.chi2, "chi2")
        cols = [pg._T] if mode == "chi2" else list(range(pg._EW + 1))
        _pg_close(got.rows[:, cols], plain.rows[:, cols], "rows")
        if mode != "chi2":
            _pg_close(got.J, plain.J, "J")
            _pg_close(got.b, plain.b, "b")
            _pg_close(got.H, plain.H, f"H diag={diag}")
            assert torch.isfinite(got.J).all()


@pytest.mark.parametrize("case", ["early_stop", "all_iterations",
                                  "capacity_512"])
def test_pg_cg_solve_matches_plain(cuda, case):
    """K13b against the plain CG on the same K13a system: the retracted
    poses and the step within 1e-5, the same iteration count (an early
    stop by the tolerance, or every one of ba_cg_iters), two launches
    equal bit for bit, and no host sync."""
    from voxelhashing_demo_tpu_torch.config import KeyframeConfig
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    real, cap = (128, 512) if case == "capacity_512" else (48, 64)
    kcfg = KeyframeConfig(ba_cg_tol={"early_stop": 1e-3,
                                     "all_iterations": 0.0}.get(case, 1e-6),
                          ba_cg_iters=64)
    g = _pg_ring(cuda, real, cap)
    s = pg.edge_system(g, "cg", 0.1, "gm", damping=kcfg.ba_damping)
    pg.cg_solve(s, g, kcfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, delta, iters = pg.cg_solve(s, g, kcfg)
        out2, _, _ = pg.cg_solve(s, g, kcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    p_out, p_delta, p_iters = pg.cg_reference(s, g, kcfg)
    assert torch.equal(out, out2)
    assert int(iters) == int(p_iters)
    if case != "capacity_512":
        assert (int(iters) == 64) == (case == "all_iterations")
    _pg_close(delta, p_delta, "delta", 1e-5)
    _pg_close(out, p_out, "poses", 1e-5)
    assert float(delta.abs().max()) > 1e-3


def test_pg_retract_matches_plain(cuda):
    """K13c against its plain version: the retract bit for bit (within
    1e-6), and no update when info != 0 or a delta is not finite."""
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    g = _pg_ring(cuda, 24, 32)
    rng = np.random.RandomState(1)
    delta = torch.from_numpy(rng.normal(0, 0.05, 32 * 6).astype(
        np.float32)).to(cuda)
    for info, d in ((0, delta), (2, delta),
                    (0, torch.where(torch.arange(192, device=cuda) == 7,
                                    float("nan"), delta))):
        info_t = torch.full((), info, dtype=torch.int32, device=cuda)
        out, used = pg.retract(d, info_t, g.poses)
        p_out, p_used = pg.retract_reference(d, info_t, g.poses)
        _pg_close(out, p_out, "poses")
        assert torch.equal(used, p_used)
        if info or not torch.isfinite(d).all():
            assert torch.equal(out, g.poses) and not used.any()


@pytest.mark.parametrize("solver,real,cap", [("dense", 24, 32),
                                             ("auto", 48, 64),
                                             ("cg", 128, 512)])
def test_optimize_on_the_card_no_sync_matches_plain(cuda, solver, real,
                                                     cap):
    """``optimize`` on the card makes no host sync (sync-debug "error"),
    launches K13a and K13b or K13c each iteration, repeats bit for bit,
    moves the poses and lands within 1e-5 of ``optimize_reference`` on the
    card (a false closure and GNC: the robust cost falls, chi2 of the base
    weights need not)."""
    from voxelhashing_demo_tpu_torch.config import KeyframeConfig
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    kcfg = KeyframeConfig(ba_iters=8, ba_solver=solver,
                          ba_gnc_init_scale=4.0)
    g = _pg_ring(cuda, real, cap, false_edge=True)
    pg.optimize(g, kcfg)
    torch.cuda.synchronize()
    before = (pg.LAUNCHES_EDGE_BLOCKS, pg.LAUNCHES_CG, pg.LAUNCHES_RETRACT)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, info = pg.optimize(g, kcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = (pg.LAUNCHES_EDGE_BLOCKS, pg.LAUNCHES_CG, pg.LAUNCHES_RETRACT)
    use_cg = solver == "cg"
    assert [y - x for x, y in zip(before, after)] == [
        8 + 2, 8 if use_cg else 0, 0 if use_cg else 8]
    b, _ = pg.optimize(g, kcfg)
    plain, p_info = pg.optimize_reference(g, kcfg)
    assert torch.equal(a.poses, b.poses)
    _pg_close(a.poses, plain.poses, "poses", 1e-5)
    _pg_close(info.chi2_final, p_info.chi2_final, "chi2", 1e-5)
    assert float((a.poses - g.poses).abs().max()) > 1e-3


def test_se3_exp_and_inverse_make_no_host_sync(cuda):
    """``se3.exp`` / ``se3.inverse`` build their bottom row on the card:
    no upload, so no host sync."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    xi = torch.tensor([[0.1, -0.2, 0.3, 0.2, 0.1, -0.3]], device=cuda)
    se3.exp(xi)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = se3.exp(xi)
        Ti = se3.inverse(T)
        se3.log(Ti @ T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.allclose(Ti @ T, torch.eye(4, device=cuda), atol=1e-6)


def test_pg_refused_inputs_raise(cuda, monkeypatch):
    """What K13a-c do not take raises (a dense H past MAX_DENSE_POSES,
    int64 indices, tensors on two devices, a CG step without a CG-mode
    system); a refused launch raises; no plain version runs instead."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import KeyframeConfig
    from voxelhashing_demo_tpu_torch.ops import pose_graph as pg

    g = _pg_ring(cuda, 8, 16)
    big = pg.create(pg.MAX_DENSE_POSES + 1, 4, device=cuda)
    with pytest.raises(ValueError, match="dense H"):
        pg.edge_system(big, "dense")
    pg.edge_system(big, "chi2")                     # other modes take it
    with pytest.raises(ValueError, match="int32"):
        pg.edge_system(g._replace(edges_ij=g.edges_ij.long()), "cg")
    with pytest.raises(ValueError, match="one CUDA device"):
        pg.edge_system(g._replace(edges_w=g.edges_w.cpu()), "cg")
    with pytest.raises(ValueError, match="CG-mode"):
        pg.cg_solve(pg.edge_system(g, "dense"), g, KeyframeConfig())
    with pytest.raises(ValueError, match="pg_retract"):
        pg.retract(torch.zeros(6, device=cuda),
                   torch.zeros((), dtype=torch.int32, device=cuda), g.poses)

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("edge_system_reference", "cg_reference",
                 "retract_reference"):
        monkeypatch.setattr(pg, name, no_plain)
    pg.optimize(g, KeyframeConfig(ba_iters=2, ba_solver="cg"))
    pg.optimize(g, KeyframeConfig(ba_iters=2, ba_solver="dense"))
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="pg_edge_blocks kernel launch"):
        pg.optimize(g, KeyframeConfig(ba_iters=2))


# --------------------------------------------------------------------------
# K10 gc_free, K14 evict_free, K15 restore_rows (csrc/maintain.cu)
# --------------------------------------------------------------------------

GC_MIN_WEIGHT = 0.5


def _maint_map(hcfg, seed: int, live: int, stamp_hi: int = 40):
    """A map on the card with ``live`` random keys inserted by the plain
    insert (capped by their buckets and the heap), then a random payload:
    a third of the rows with every weight below GC_MIN_WEIGHT (zeros among
    them), the rest with some above; last_seen in 0..stamp_hi, born below
    it."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    rng = np.random.default_rng(seed)
    hmap = hash_ops.create(hcfg, device="cuda")
    big = dataclasses.replace(hcfg, max_new_per_frame=4096)
    left = live
    while left > 0:
        cand = _random_cand(rng, min(left, 4096), "cuda")
        hash_ops.insert_blocks_reference(hmap, big, cand, 0)
        left -= 4096
    N, V = hmap.tsdf.shape
    w = rng.uniform(0.0, 3.0, (N, V)).astype(np.float32)
    low = rng.random(N) < 1 / 3
    w[low] = rng.uniform(0.0, 0.49, (int(low.sum()), V))
    w[low, :7] = 0.0
    seen = rng.integers(0, stamp_hi + 1, N).astype(np.int32)
    for name, a in (("tsdf", rng.uniform(-1, 1, (N, V)).astype(np.float32)),
                    ("weight", w), ("last_seen", seen), ("born", seen // 2),
                    ("band_min", rng.uniform(0, 0.1, N).astype(np.float32))):
        getattr(hmap, name).copy_(torch.as_tensor(a))
    return hmap


def _maint_case(fuse_case, which: str):
    """(hash config, map): the fuse case's flagship map, or a random one
    at the flagship's size, or on a table of 129 or 300 tiles of 512
    buckets (past one snapshot: the look-back)."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, *_ = fuse_case
    h = cfg.hash
    if which == "flagship":
        return h, hmap
    if which == "random":
        return h, _maint_map(h, 21, 30000)
    tiles = {"tiles129": 129, "tiles300": 300}[which]
    small = dataclasses.replace(h, num_buckets=tiles * hash_ops.MAINTAIN_TILE,
                                num_blocks=8192, block_size=4)
    return small, _maint_map(small, 22 + tiles, 12000)


# (map, max_free, frame, min_age)
GC_CARD_CASES = [("flagship", 1024, None, 0), ("flagship", 3, None, 0),
                 ("flagship", 1024, 30, 16), ("random", 100, 35, 16),
                 ("random", 10 ** 6, None, 0), ("tiles129", 500, 30, 8),
                 ("tiles300", 10 ** 6, None, 0)]


@pytest.mark.parametrize("which,max_free,frame,min_age", GC_CARD_CASES)
def test_gc_matches_plain(fuse_case, which, max_free, frame, min_age):
    """K10 against garbage_collect_reference bit for bit on every map
    field and n_freed: the flagship map after the sweep and random maps,
    the cap, the age gate, tables that take the look-back; one launch."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, which)
    got, want = _map_clone(base), _map_clone(base)
    before = hash_ops.LAUNCHES_GC
    _, n_got = hash_ops.garbage_collect(got, hcfg, GC_MIN_WEIGHT, max_free,
                                        frame, min_age)
    assert hash_ops.LAUNCHES_GC == before + 1
    _, n_want = hash_ops.garbage_collect_reference(
        want, hcfg, GC_MIN_WEIGHT, max_free, frame, min_age)
    torch.cuda.synchronize()
    _assert_all_fields_equal(got, want, which)
    assert int(n_got) == int(n_want), which
    if which != "flagship" or max_free == 3:
        assert int(n_want) > 0, which


def test_gc_stack_drop_and_tensor_stamp(fuse_case):
    """K10 with free_top near the stack's end (the late pushes dropped)
    and with the frame as a 0-d int32 tensor, bit for bit."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, "random")
    base = _map_clone(base)
    base.free_top.fill_(base.free_list.shape[0] - 5)
    for stamp in (35, torch.tensor(35, dtype=torch.int32, device="cuda")):
        got, want = _map_clone(base), _map_clone(base)
        _, n_got = hash_ops.garbage_collect(got, hcfg, GC_MIN_WEIGHT, 4000,
                                            stamp, 16)
        _, n_want = hash_ops.garbage_collect_reference(
            want, hcfg, GC_MIN_WEIGHT, 4000, 35, 16)
        _assert_all_fields_equal(got, want, "stack drop")
        assert int(n_got) == int(n_want) > 5


def _evict_pair(hcfg, base, frame, max_age, max_evict):
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    got, want = _map_clone(base), _map_clone(base)
    before = hash_ops.LAUNCHES_EVICT
    out = hash_ops.evict_stale(got, hcfg, frame, max_age, max_evict)
    assert hash_ops.LAUNCHES_EVICT == before + 1
    ref = hash_ops.evict_stale_reference(want, hcfg, frame, max_age,
                                         max_evict)
    torch.cuda.synchronize()
    _assert_all_fields_equal(got, want, "evict map")
    for name, a, b in zip(("keys", "tsdf", "weight", "born", "n"), out[1:],
                          ref[1:]):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    return out


# (map, frame, max_age, max_evict)
EVICT_CARD_CASES = [("flagship", 30, 24, 2048), ("flagship", 6, 2, 100),
                    ("random", 40, 16, 64), ("random", 40, 16, 20000),
                    ("random", 40, 40, 2048), ("tiles129", 40, 12, 3000),
                    ("tiles300", 40, 20, 512)]


@pytest.mark.parametrize("which,frame,max_age,max_evict", EVICT_CARD_CASES)
def test_evict_matches_plain(fuse_case, which, frame, max_age, max_evict):
    """K14 against evict_stale_reference bit for bit: every map field and
    the six outputs (the evicted rows in table order, padding past n), on
    the flagship map and random maps, the cap, nothing stale (max_age
    40), tables that take the look-back; one launch."""
    hcfg, base = _maint_case(fuse_case, which)
    out = _evict_pair(hcfg, base, frame, max_age, max_evict)
    n = int(out[-1])
    assert (n == 0) == (max_age >= 40), which


def _restore_pair(hcfg, base, keys, tsdf, weight, frame, born, fn=None):
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    got, want = _map_clone(base), _map_clone(base)
    before = hash_ops.LAUNCHES_RESTORE
    _, acc = hash_ops.restore_blocks(got, hcfg, keys, tsdf, weight, frame,
                                     fn, 255.0, born)
    assert hash_ops.LAUNCHES_RESTORE == before + 1
    _, ref = hash_ops.restore_blocks_reference(want, hcfg, keys, tsdf,
                                               weight, frame, fn, 255.0,
                                               born)
    torch.cuda.synchronize()
    _assert_all_fields_equal(got, want, "restore map")
    assert torch.equal(acc, ref)
    return got, acc


def _restore_batch(hcfg, base, seed: int, R: int, found: int):
    """(map, keys, tsdf, weight, born): ``base`` after a plain eviction
    of up to R / 2 rows (frame 40, age 30), and R rows for it: ``found``
    of its keys (to merge), the evicted keys (new again), random keys
    (some into full buckets), then EMPTY_KEY padding, shuffled; random
    payload (a fifth of the weights 0) and born stamps."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    rng = np.random.default_rng(seed)
    hmap = _map_clone(base)
    gone = hash_ops.evict_stale_reference(hmap, hcfg, 40, 30, R // 2)[1]
    gone = gone[gone != hash_ops.EMPTY_KEY]
    live = hmap.keys[hmap.keys != hash_ops.EMPTY_KEY]
    pick = live[torch.as_tensor(rng.choice(
        live.numel(), min(found, live.numel()), replace=False),
        device="cuda")]
    extra = _random_cand(rng, R, "cuda").unique()
    extra = extra[extra != hash_ops.EMPTY_KEY]
    keys = torch.cat([pick, gone, extra])[:R - R // 8]
    keys = torch.cat([keys, torch.full((R - keys.numel(),),
                                       hash_ops.EMPTY_KEY,
                                       dtype=torch.int32, device="cuda")])
    keys = keys[torch.as_tensor(rng.permutation(R), device="cuda")]
    V = hcfg.voxels_per_block
    w = rng.uniform(0, 4, (R, V)).astype(np.float32)
    w[rng.random((R, V)) < 0.2] = 0.0
    rows = [torch.as_tensor(a, device="cuda") for a in (
        rng.uniform(-1, 1, (R, V)).astype(np.float32), w,
        rng.integers(0, 30, R).astype(np.int32))]
    return hmap, keys.contiguous(), *rows


# (map, R, found keys, free_top cut, born rows, bucket function divisor)
RESTORE_CARD_CASES = [("flagship", 2048, 300, None, True, 1),
                      ("flagship", 4096, 1000, None, False, 1),
                      ("random", 2048, 200, 150, True, 1),
                      ("random", 1, 1, None, True, 1),
                      ("random", 700, 0, None, True, 2),
                      ("tiles129", 4096, 2000, None, True, 1)]


@pytest.mark.parametrize("which,R,found,top,born,divisor",
                         RESTORE_CARD_CASES)
def test_restore_matches_plain(fuse_case, which, R, found, top, born,
                               divisor):
    """K15 against restore_blocks_reference bit for bit on every map field
    (merged rows too: the merge rounds as the plain version on the card)
    and accepted: found keys merged, evicted keys back, random keys (some
    into full buckets), EMPTY_KEY padding, a heap cut below the new keys,
    born rows or none, the sharded BucketHash(num_buckets, 2) over half
    the buckets, R from 1 to MAX_RESTORE; one launch."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, which)
    fn = None
    if divisor != 1:
        fn = hash_ops.BucketHash(hcfg.num_buckets * divisor, divisor)
    base, keys, tsdf, weight, b = _restore_batch(hcfg, base, 31 + R, R,
                                                 found)
    if top is not None:
        base.free_top.fill_(top)
    got, acc = _restore_pair(hcfg, base, keys, tsdf, weight, 41,
                             b if born else None, fn)
    assert bool(acc.any())
    if top is not None:
        assert int(got.free_top) == 0


def test_restore_padding_only_and_tensor_stamp(fuse_case):
    """K15 on EMPTY_KEY padding writes nothing and accepts nothing (the
    warm-up's restore); a batch with the frame as a 0-d int32 tensor
    equals the int's."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, "flagship")
    V = hcfg.voxels_per_block
    pad = torch.full((512,), hash_ops.EMPTY_KEY, dtype=torch.int32,
                     device="cuda")
    z = torch.zeros((512, V), device="cuda")
    got, acc = _restore_pair(hcfg, base, pad, z, z, 3,
                             torch.zeros(512, dtype=torch.int32,
                                         device="cuda"))
    assert not bool(acc.any())
    _assert_all_fields_equal(got, base, "padding")
    base, keys, tsdf, weight, born = _restore_batch(hcfg, base, 5, 1024, 100)
    a, b = _map_clone(base), _map_clone(base)
    hash_ops.restore_blocks(a, hcfg, keys, tsdf, weight, 41, born_rows=born)
    hash_ops.restore_blocks(b, hcfg, keys, tsdf, weight, torch.tensor(
        41, dtype=torch.int32, device="cuda"), born_rows=born)
    _assert_all_fields_equal(a, b, "tensor stamp")


def test_maintain_no_sync_and_graphs(fuse_case):
    """garbage_collect, evict_stale and restore_blocks read nothing on the
    host; the three captured in one CUDA graph on a fresh stream (each on
    a scratch of its own) and on a stream that ran them (its persistent
    scratches) replay bit for bit, twice, what they do eagerly."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, "random")
    batch = _restore_batch(hcfg, base, 8, 2048, 300)[1:]

    def run(m):
        hash_ops.garbage_collect(m, hcfg, GC_MIN_WEIGHT, 500, 35, 16)
        out = hash_ops.evict_stale(m, hcfg, 38, 20, 2048)
        _, acc = hash_ops.restore_blocks(m, hcfg, *batch[:3], 39,
                                         born_rows=batch[3])
        return out[1:], acc

    eager = _map_clone(base)
    want_out, want_acc = run(eager)
    torch.cuda.synchronize()
    quiet = _map_clone(base)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(quiet)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_all_fields_equal(quiet, eager, "no-sync run")
    for warm in (False, True):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        g = _map_clone(base)
        with torch.cuda.stream(side):
            if warm:
                run(_map_clone(base))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                got_out, got_acc = run(g)
        for _ in range(2):
            with torch.cuda.stream(side):
                for fld in ALL_FIELDS:
                    getattr(g, fld).copy_(getattr(base, fld))
                graph.replay()
            side.synchronize()
            _assert_all_fields_equal(g, eager, f"graph warm={warm}")
            for a, b in zip(got_out, want_out):
                assert torch.equal(a, b)
            assert torch.equal(got_acc, want_acc)


def test_maintain_refusals(fuse_case, monkeypatch):
    """What K10, K14 and K15 do not take raises (more than MAX_RESTORE
    keys, a bucket function that is not a BucketHash, rows on two
    devices, a stamp tensor of another type); a refused build and a
    refused launch raise; the plain versions never run in their place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    hcfg, base = _maint_case(fuse_case, "flagship")
    m = _map_clone(base)
    V = hcfg.voxels_per_block
    R = hash_ops.MAX_RESTORE + 1
    keys = torch.full((R,), hash_ops.EMPTY_KEY, dtype=torch.int32,
                      device="cuda")
    rows = torch.zeros((R, V), device="cuda")
    with pytest.raises(ValueError, match=f"at most {hash_ops.MAX_RESTORE}"):
        hash_ops.restore_blocks(m, hcfg, keys, rows, rows, 1)
    with pytest.raises(ValueError, match="BucketHash"):
        hash_ops.restore_blocks(m, hcfg, keys[:8], rows[:8], rows[:8], 1,
                                lambda b: b[..., 0])
    with pytest.raises(ValueError, match="one CUDA device"):
        hash_ops.restore_blocks(m, hcfg, keys[:8], rows[:8].cpu(), rows[:8],
                                1)
    with pytest.raises(ValueError, match="stamp"):
        hash_ops.evict_stale(m, hcfg, torch.tensor(1, device="cuda"), 2, 8)

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("garbage_collect_reference", "evict_stale_reference",
                 "restore_blocks_reference", "_free_marked", "lookup_keys",
                 "_scatter_drop", "_segment_rank"):
        monkeypatch.setattr(hash_ops, name, no_plain)
    hash_ops.garbage_collect(m, hcfg, GC_MIN_WEIGHT, 100, 30, 16)
    hash_ops.evict_stale(m, hcfg, 30, 24, 64)
    hash_ops.restore_blocks(m, hcfg, keys[:8], rows[:8], rows[:8], 31)
    torch.cuda.synchronize()

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(kernels, "_FUNCTIONS", {})
    monkeypatch.setattr(kernels, "build", no_build)
    for call in (lambda: hash_ops.garbage_collect(m, hcfg, GC_MIN_WEIGHT, 9),
                 lambda: hash_ops.evict_stale(m, hcfg, 30, 24, 64),
                 lambda: hash_ops.restore_blocks(m, hcfg, keys[:8], rows[:8],
                                                 rows[:8], 31)):
        with pytest.raises(RuntimeError, match="nvcc failed for maintain"):
            call()
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="gc_free kernel launch"):
        hash_ops.garbage_collect(m, hcfg, GC_MIN_WEIGHT, 100)
    with pytest.raises(RuntimeError, match="evict_free kernel launch"):
        hash_ops.evict_stale(m, hcfg, 30, 24, 64)
    with pytest.raises(RuntimeError, match="restore_rows kernel launch"):
        hash_ops.restore_blocks(m, hcfg, keys[:8], rows[:8], rows[:8], 31)


# --------------------------------------------------------------------------
# the march prediction: K11 raycast_march and K12 densify_cache
# (csrc/raycast.cu)
# --------------------------------------------------------------------------

RC_FIELDS = ("depth", "points", "normals", "hit")


def _assert_render_bits(got, want, what: str):
    for f in RC_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        same = _bits_equal(a, b) if a.dtype == torch.float32 else \
            torch.equal(a, b)
        assert same, f"{what}: {f}"


def _assert_cache_bits(got, want, what: str):
    for f in ("sdf", "weight", "origin", "voxel_size"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and _bits_equal(a, b), f"{what}: {f}"


@pytest.fixture(scope="module")
def march_case(fuse_case):
    """(config, map, the visible set, pose, the plain cache at that pose,
    a non-cubic dense volume fused on the card, its config): the flagship
    map of ``fuse_case`` and a 64 x 56 x 72 volume at 4 cm fused from three
    80x60 orbit frames."""
    from voxelhashing_demo_tpu_torch.config import (DenseGridConfig,
                                                    FusionConfig,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.ops import hash_ops, hash_raycast
    from voxelhashing_demo_tpu_torch.ops import tsdf as tsdf_ops
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg, hmap, pose, _, _ = fuse_case
    active = hash_ops.compact_visible(hmap, cfg.hash, pose, cfg.camera,
                                      cfg.fusion)
    cache = hash_raycast.densify_active_reference(
        hmap, active, cfg.hash, cfg.fusion, pose, cfg.raycast.cache_dims)
    dcfg = dataclasses.replace(
        tiny_config(), fusion=FusionConfig(voxel_size=0.04, truncation=0.16),
        grid=DenseGridConfig(dims=(64, 56, 72), origin=(-1.28, -1.0, 0.0)))
    depths, poses = synthetic.make_sequence(dcfg.camera, 3, as_raw=False,
                                            device="cuda")
    vol = tsdf_ops.create_dense(dcfg.grid, dcfg.fusion, device="cuda")
    for d, T in zip(depths, poses):
        vol = tsdf_ops.integrate_dense(
            vol, d, torch.as_tensor(T, dtype=torch.float32, device="cuda"),
            dcfg.camera, dcfg.fusion)
    return cfg, hmap, active, pose, cache, vol, dcfg, poses


MARCH_CASES = ("hash_gradient", "hash_image", "dense_noncubic",
               "dense_image", "start_inside", "leave_volume", "past_far",
               "max_steps_3", "max_steps_0", "row_slice")


@pytest.mark.parametrize("case", MARCH_CASES)
def test_march_matches_plain(march_case, case):
    """K11 equals ``raycast_rays_reference`` bit for bit (depth, points,
    normals, hit): on the flagship's 256^3 cache at its pose in both
    normal modes, on a non-cubic dense volume, with ``near`` past the
    surface (rays whose first known sample is inside: the NaN secant
    step), from a pose whose rays leave the volume sideways, with ``far``
    before the surface, with max_steps 3 and 0, and on a row slice of
    the rays (the sharded shape)."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    cfg, _, _, pose, cache, vol, dcfg, poses = march_case
    rc, cam, state, T = cfg.raycast, cfg.camera, cache, pose
    if case.startswith("dense"):
        rc, cam, state = dcfg.raycast, dcfg.camera, vol
        T = torch.as_tensor(poses[1], dtype=torch.float32, device="cuda")
    if case.endswith("image"):
        rc = dataclasses.replace(rc, normal_mode="image")
    elif case == "start_inside":
        rc = dataclasses.replace(rc, near=2.5)
    elif case == "leave_volume":
        turn = torch.tensor([[0.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                             [-1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                            device="cuda")
        T = T @ turn
    elif case == "past_far":
        rc = dataclasses.replace(rc, far=0.6)
    elif case.startswith("max_steps"):
        rc = dataclasses.replace(rc, max_steps=int(case.rsplit("_", 1)[1]))
    rays = cam_geom.pixel_rays(cam, device="cuda")
    if case == "row_slice":
        rays = rays[130:370]
    before = rc_ops.LAUNCHES_MARCH
    got = rc_ops.raycast_rays(state, T, rays, rc)
    assert rc_ops.LAUNCHES_MARCH == before + 1
    want = rc_ops.raycast_rays_reference(state, T, rays, rc)
    _assert_render_bits(got, want, case)
    hits = float(want.hit.float().mean())
    if case in ("hash_gradient", "row_slice"):
        assert hits > 0.3, hits
    elif case == "dense_noncubic":
        assert hits > 0.1, hits
    elif case == "max_steps_0":
        assert hits == 0.0


def _densify_case(march_case, which):
    """(the wrapper's arguments, the plain version's) of a K12 case on the
    flagship map: local (blocks, ptrs, count) or explicit rows."""
    from voxelhashing_demo_tpu_torch.ops import hash_ops

    cfg, hmap, active, pose, _, _, _, _ = march_case
    blocks, ptrs, count = (t.clone() for t in active)
    n, A = int(count), ptrs.shape[0]
    if which == "count_0":
        count = torch.zeros_like(count)
    elif which == "count_all":
        # every row a live map row: the set's rows repeated with shifted
        # blocks, so the blocks stay distinct
        reps = -(-A // n)
        ptrs = ptrs[:n].repeat(reps)[:A].contiguous()
        blocks = torch.cat([blocks[:n] + torch.tensor(
            [40 * k, 0, 0], dtype=torch.int32, device="cuda")
            for k in range(reps)])[:A].contiguous()
        count = torch.full_like(count, A)
    elif which == "outside":
        blocks[: n // 2] += torch.tensor([0, 1000, 0], dtype=torch.int32,
                                         device="cuda")
        blocks[n // 2: n // 2 + 8] = torch.tensor(
            [-2 ** 20, 2 ** 20, 7], dtype=torch.int32, device="cuda")
    elif which == "past_count":
        # rows past the count hold valid-looking rows of in-cache blocks
        half = n // 2
        count = torch.full_like(count, half)
        blocks[n: n + half] = blocks[:half] + torch.tensor(
            [0, 0, 1], dtype=torch.int32, device="cuda")
        ptrs[n: n + half] = ptrs[half: 2 * half]
    elif which == "free_rows":
        ptrs[::3] = hash_ops.FREE_PTR
        ptrs[1::7] = -5                    # not FREE_PTR: clamped to row 0
    return cfg, hmap, hash_ops.ActiveSet(blocks, ptrs, count), pose


@pytest.mark.parametrize("which", ["step", "count_0", "count_all",
                                   "outside", "past_count", "free_rows",
                                   "odd_dims", "step_pose"])
def test_densify_active_matches_plain(march_case, which):
    """K12 (the local form: the map's rows through ``ptrs``, the count on
    the device) equals ``densify_active_reference`` bit for bit (sdf,
    weight, origin, voxel size): the visible set at its pose, count 0,
    count = A with every row live, blocks outside the cache (and far
    outside the int32 voxel range of a cache-relative index), rows past
    the count holding valid rows, FREE_PTR and negative ptrs, a cache of
    odd dims (the scalar fill; not a multiple of the block size), and
    another pose."""
    from voxelhashing_demo_tpu_torch.ops import hash_raycast

    case = "step" if which in ("odd_dims", "step_pose") else which
    cfg, hmap, active, pose = _densify_case(march_case, case)
    dims = (100, 90, 77) if which == "odd_dims" else cfg.raycast.cache_dims
    if which == "step_pose":
        pose = pose.clone()
        pose[:3, 3] += torch.tensor([0.37, -0.21, 0.55], device="cuda")
    before = hash_raycast.LAUNCHES_DENSIFY
    got = hash_raycast.densify_active(hmap, active, cfg.hash, cfg.fusion,
                                      pose, dims)
    assert hash_raycast.LAUNCHES_DENSIFY == before + 1
    want = hash_raycast.densify_active_reference(
        hmap, active, cfg.hash, cfg.fusion, pose, dims)
    _assert_cache_bits(got, want, which)
    if which == "step":
        assert float((got.weight > 0).float().mean()) > 0.001


@pytest.mark.parametrize("which", ["random_mask", "all_invalid", "empty"])
def test_densify_rows_matches_plain(march_case, which):
    """K12's explicit form (the sharded path's all-gathered rows and mask)
    equals ``densify_rows_reference`` bit for bit, with invalid rows that
    hold valid-looking data, all rows invalid, and no rows."""
    from voxelhashing_demo_tpu_torch.ops import hash_raycast

    cfg, hmap, active, pose, _, _, _, _ = march_case
    safe = torch.clamp(active.ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    blocks, sdf, w = active.blocks, hmap.tsdf[safe], hmap.weight[safe]
    gen = torch.Generator(device="cuda").manual_seed(5)
    valid = torch.rand(blocks.shape[0], device="cuda", generator=gen) < 0.7
    if which == "all_invalid":
        valid = torch.zeros_like(valid)
    elif which == "empty":
        blocks, sdf, w, valid = blocks[:0], sdf[:0], w[:0], valid[:0]
    args = (blocks, sdf, w, valid, cfg.hash, cfg.fusion, pose,
            cfg.raycast.cache_dims)
    got = hash_raycast.densify_rows(*args)
    want = hash_raycast.densify_rows_reference(*args)
    _assert_cache_bits(got, want, which)


def test_raycast_hash_k12_then_k11_no_sync(march_case):
    """``raycast_hash`` on the card is one K12 and one K11 launch and reads
    nothing on the host; it equals the plain densify + march bit for
    bit."""
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    cfg, hmap, active, pose, cache, _, _, _ = march_case
    args = (hmap, active, cfg.hash, pose, cfg.camera, cfg.raycast,
            cfg.fusion, cfg.raycast.cache_dims)
    hash_raycast.raycast_hash(*args)              # first use: uploads
    torch.cuda.synchronize()
    n11, n12 = rc_ops.LAUNCHES_MARCH, hash_raycast.LAUNCHES_DENSIFY
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hash_raycast.raycast_hash(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rc_ops.LAUNCHES_MARCH == n11 + 1
    assert hash_raycast.LAUNCHES_DENSIFY == n12 + 1
    want = rc_ops.raycast_rays_reference(
        cache, pose, cam_geom.pixel_rays(cfg.camera, device="cuda"),
        cfg.raycast)
    _assert_render_bits(got, want, "raycast_hash")


def test_march_refusals(march_case, monkeypatch):
    """What K11 and K12 do not take raises (a volume dimension below 2,
    float64 rays, mixed devices, block size 11, a cache of 2^31 cells);
    a refused launch raises; the plain versions never run in their
    place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import HashConfig
    from voxelhashing_demo_tpu_torch.geometry import camera as cam_geom
    from voxelhashing_demo_tpu_torch.ops import hash_raycast
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops

    cfg, hmap, active, pose, cache, _, _, _ = march_case
    rays = cam_geom.pixel_rays(cfg.camera, device="cuda")[:8]
    flat = cache._replace(sdf=cache.sdf[:, :, :1], weight=cache.weight[:, :, :1])
    with pytest.raises(ValueError, match=">= 2"):
        rc_ops.raycast_rays(flat, pose, rays, cfg.raycast)
    with pytest.raises(ValueError, match="float32"):
        rc_ops.raycast_rays(cache, pose, rays.double(), cfg.raycast)
    with pytest.raises(ValueError, match="one CUDA device"):
        rc_ops.raycast_rays(cache, pose.cpu(), rays, cfg.raycast)
    with pytest.raises(ValueError, match="block sizes"):
        hash_raycast.densify_active(hmap, active, HashConfig(block_size=11),
                                    cfg.fusion, pose, (64, 64, 64))
    with pytest.raises(ValueError, match="2\\^31"):
        hash_raycast.densify_active(hmap, active, cfg.hash, cfg.fusion, pose,
                                    (2048, 1024, 1024))

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("raycast_rays_reference", "trilinear_sample",
                 "sdf_gradient"):
        monkeypatch.setattr(rc_ops, name, no_plain)
    for name in ("densify_active_reference", "densify_rows_reference"):
        monkeypatch.setattr(hash_raycast, name, no_plain)
    hash_raycast.raycast_hash(hmap, active, cfg.hash, pose, cfg.camera,
                              cfg.raycast, cfg.fusion,
                              cfg.raycast.cache_dims)
    torch.cuda.synchronize()
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="densify_cache kernel launch"):
        hash_raycast.densify_active(hmap, active, cfg.hash, cfg.fusion, pose,
                                    cfg.raycast.cache_dims)
    with pytest.raises(RuntimeError, match="raycast_march kernel launch"):
        rc_ops.raycast_rays(cache, pose, rays, cfg.raycast)


# --------------------------------------------------------------------------
# the dense fusion: K20 integrate_dense (csrc/dense.cu)
# --------------------------------------------------------------------------

DENSE_CASES = ("orbit_noncubic", "no_falloff", "zero_sample_weight",
               "weight_cap", "odd_z", "unaligned", "depth_holes",
               "facing_away", "identity_pose", "flagship_grid")


def _dense_case(case):
    """(volume, metric depth, pose, camera, fusion) of a K20 case on the
    card: a non-cubic 64 x 56 x 72 volume at 4 cm with two 80x60 orbit
    frames fused by the plain version, and the third frame; or the
    ``dense`` phase's 640x480 camera and 160 x 128 x 160 grid."""
    from voxelhashing_demo_tpu_torch.config import (CameraConfig,
                                                    DenseGridConfig,
                                                    FusionConfig,
                                                    tiny_config)
    from voxelhashing_demo_tpu_torch.ops import tsdf
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cam = tiny_config().camera
    fusion = FusionConfig(voxel_size=0.04, truncation=0.16)
    grid = DenseGridConfig(dims=(64, 56, 72), origin=(-1.28, -1.0, 0.0))
    if case == "flagship_grid":
        cam = CameraConfig()
        fusion = FusionConfig(voxel_size=0.02, truncation=0.08)
        grid = DenseGridConfig(dims=(160, 128, 160), origin=(-1.6, -0.7, 0.0))
    elif case == "odd_z":
        grid = dataclasses.replace(grid, dims=(64, 56, 70))
    elif case == "no_falloff":
        fusion = dataclasses.replace(fusion, depth_weight_falloff=False,
                                     weight_sample=2.5)
    elif case == "zero_sample_weight":
        fusion = dataclasses.replace(fusion, depth_weight_falloff=False,
                                     weight_sample=0.0)
    elif case == "weight_cap":
        fusion = dataclasses.replace(fusion, max_weight=2.5)
    depths, poses = synthetic.make_sequence(cam, 3, as_raw=False,
                                            device="cuda")
    poses = [torch.as_tensor(T, dtype=torch.float32, device="cuda")
             for T in poses]
    vol = tsdf.create_dense(grid, fusion, device="cuda")
    for d, T in zip(depths[:2], poses[:2]):
        vol = tsdf.integrate_dense_reference(vol, d, T, cam, fusion)
    depth, T = depths[2], poses[2]
    if case == "unaligned":
        # every array one element into a buffer: contiguous, off the
        # 16-byte boundary (the scalar instantiation)
        def shifted(t):
            buf = torch.empty(t.numel() + 1, device="cuda")
            view = buf[1:].view(t.shape)
            view.copy_(t)
            return view
        vol = vol._replace(sdf=shifted(vol.sdf), weight=shifted(vol.weight))
    elif case == "depth_holes":
        g = torch.Generator(device="cuda").manual_seed(3)
        holes = torch.rand(depth.shape, generator=g, device="cuda")
        depth = torch.where(holes < 0.3, 0.0, depth)
        depth = torch.where(holes > 0.995, float("inf"), depth)
        depth = torch.where((holes > 0.99) & (holes <= 0.995),
                            float("nan"), depth)
    elif case == "facing_away":
        turn = torch.tensor([[-1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                             [0.0, 0.0, -1.0, 1.2], [0.0, 0.0, 0.0, 1.0]],
                            device="cuda")
        T = T @ turn
    elif case == "identity_pose":
        T = torch.eye(4, device="cuda")
    return vol, depth, T, cam, fusion


@pytest.mark.parametrize("case", DENSE_CASES)
def test_integrate_dense_matches_plain(cuda, case):
    """K20 equals ``integrate_dense_reference`` bit for bit (sdf and
    weight), one launch, a new volume, the inputs untouched: a non-cubic
    volume fused from the orbit, the falloff off, a sample weight of 0
    (w_sum 0 keeps the old sdf), the weight cap reached, Z not a multiple
    of 4 and arrays off a 16-byte boundary (the scalar instantiation),
    depth holes with inf and NaN pixels, a camera turned away (voxels
    behind it), the identity pose, and the dense phase's 640x480 grid."""
    from voxelhashing_demo_tpu_torch.ops import tsdf

    vol, depth, T, cam, fusion = _dense_case(case)
    keep = [t.clone() for t in (*vol, depth, T)]
    before = tsdf.LAUNCHES_DENSE
    got = tsdf.integrate_dense(vol, depth, T, cam, fusion)
    assert tsdf.LAUNCHES_DENSE == before + 1
    want = tsdf.integrate_dense_reference(vol, depth, T, cam, fusion)
    torch.cuda.synchronize()
    assert _bits_equal(got.sdf, want.sdf), case
    assert _bits_equal(got.weight, want.weight), case
    assert got.origin is vol.origin and got.voxel_size is vol.voxel_size
    assert got.sdf.data_ptr() != vol.sdf.data_ptr()
    for a, b in zip(keep, (*vol, depth, T)):
        assert _bits_equal(a, b), f"{case}: an input was written"
    changed = int((got.weight != vol.weight).sum())
    if case == "zero_sample_weight":
        assert changed == 0
    else:
        assert changed > 100, (case, changed)
    if case == "weight_cap":
        assert float(got.weight.max()) == 2.5


def test_integrate_dense_makes_no_host_sync_and_replays_in_a_graph(cuda):
    """K20 reads nothing back (sync-debug "error" mode), and captured into
    a CUDA graph it replays to the eager result."""
    from voxelhashing_demo_tpu_torch.ops import tsdf

    vol, depth, T, cam, fusion = _dense_case("orbit_noncubic")
    want = tsdf.integrate_dense(vol, depth, T, cam, fusion)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tsdf.integrate_dense(vol, depth, T, cam, fusion)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tsdf.integrate_dense(vol, depth, T, cam, fusion)
    graph.replay()
    torch.cuda.synchronize()
    assert _bits_equal(got.sdf, want.sdf)
    assert _bits_equal(got.weight, want.weight)


def _dense_slam_config():
    from voxelhashing_demo_tpu_torch.config import (DenseGridConfig,
                                                    FusionConfig,
                                                    tiny_config)

    return dataclasses.replace(
        tiny_config(), fusion=FusionConfig(voxel_size=0.04, truncation=0.16),
        grid=DenseGridConfig(dims=(64, 56, 72), origin=(-1.28, -1.0, 0.0)))


def test_dense_slam_step_on_the_card(cuda):
    """``DenseSLAM`` on the card against the port on the CPU over 6 orbit
    frames at 80x60: tracked flags equal, poses within 1e-4 m; a step
    makes no host sync and launches K3a, K3b (the model's pack), K4, K20
    and K11 once each."""
    from voxelhashing_demo_tpu_torch.models import dense_slam
    from voxelhashing_demo_tpu_torch.ops import icp
    from voxelhashing_demo_tpu_torch.ops import preprocess as pre
    from voxelhashing_demo_tpu_torch.ops import raycast as rc_ops
    from voxelhashing_demo_tpu_torch.ops import tsdf
    from voxelhashing_demo_tpu_torch.utils import synthetic

    cfg = _dense_slam_config()
    depths, _ = synthetic.make_sequence(cfg.camera, 6, trans_amp=0.05,
                                        rot_amp_deg=2.5, device="cpu")
    gpu = dense_slam.DenseSLAM(cfg)
    cpu = dense_slam.DenseSLAM(cfg, device="cpu")
    for d in depths:
        gpu.process(d)
        cpu.process(d)
    for a, b in zip(gpu.infos, cpu.infos):
        assert bool(a.tracked) == bool(b.tracked)
        assert float((a.pose.cpu() - b.pose)[:3, 3].abs().max()) <= 1e-4
    assert sum(bool(i.tracked) for i in gpu.infos) == len(depths) - 1
    raw = torch.as_tensor(depths[-1].astype(np.int32), device="cuda")
    dense_slam.step(gpu.state, raw, cfg)
    torch.cuda.synchronize()
    counts = (pre.LAUNCHES_FRAME, pre.LAUNCHES_LEVELS, icp.LAUNCHES_LEVEL,
              tsdf.LAUNCHES_DENSE, rc_ops.LAUNCHES_MARCH)
    torch.cuda.set_sync_debug_mode("error")
    try:
        dense_slam.step(gpu.state, raw, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = (pre.LAUNCHES_FRAME, pre.LAUNCHES_LEVELS, icp.LAUNCHES_LEVEL,
             tsdf.LAUNCHES_DENSE, rc_ops.LAUNCHES_MARCH)
    assert [b - a for a, b in zip(counts, after)] == [1] * 5


def test_dense_refusals(cuda, monkeypatch):
    """What K20 does not take raises before a launch (float64 depth, a
    pose on the CPU, a non-contiguous depth, a depth of another shape);
    a refused build and a refused launch raise; the plain version never
    runs in its place."""
    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.ops import tsdf

    vol, depth, T, cam, fusion = _dense_case("orbit_noncubic")
    before = tsdf.LAUNCHES_DENSE
    with pytest.raises(ValueError, match="float32"):
        tsdf.integrate_dense(vol, depth.double(), T, cam, fusion)
    with pytest.raises(ValueError, match="one CUDA device"):
        tsdf.integrate_dense(vol, depth, T.cpu(), cam, fusion)
    strided = torch.empty(depth.shape[::-1], device="cuda").t()
    strided.copy_(depth)
    with pytest.raises(ValueError, match="contiguous"):
        tsdf.integrate_dense(vol, strided, T, cam, fusion)
    with pytest.raises(ValueError, match="expected"):
        tsdf.integrate_dense(vol, depth[:-1], T, cam, fusion)
    assert tsdf.LAUNCHES_DENSE == before

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("integrate_dense_reference", "voxel_world_positions",
                 "sample_weight"):
        monkeypatch.setattr(tsdf, name, no_plain)
    tsdf.integrate_dense(vol, depth, T, cam, fusion)
    torch.cuda.synchronize()

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(kernels, "_FUNCTIONS", {})
    monkeypatch.setattr(kernels, "build", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed for dense"):
        tsdf.integrate_dense(vol, depth, T, cam, fusion)
    monkeypatch.setattr(kernels, "function", lambda name: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="integrate_dense kernel launch"):
        tsdf.integrate_dense(vol, depth, T, cam, fusion)
