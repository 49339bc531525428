"""The plain versions of the allocation kernels (``ops/hash_ops.py``: K5a
``alloc_candidates``' ``frame_candidate_keys_reference`` and K5b
``insert_blocks``' ``insert_blocks_reference``) against the JAX package
on numpy inputs made from a seed.

Candidate keys: the 80x60 test camera's preprocessed frames of
``depth_scene`` (its dropouts and flying pixels included) at strides 1
and 3 and band steps 3 and 5, and cut to 79x59 at strides 1-4 and band
steps 1, 2, 3 and 7, at a pose near the origin and at one 81.7 m out
along x, where part of the band leaves the 10-bit key range.  K5a's host
tables: what they refuse, and that they are kept by identity.
Inserts: an empty map with max_new below the unique count (the cap);
a 256-bucket table whose buckets a first insert filled to 3 and 4 (the
in-bucket rank overflows); free_top below the new keys (the heap runs dry
mid-bucket); the sharded step's owner-local ``BucketHash(num_buckets,
2)`` on keys routed to rank 1 of two, against JAX's ``_local_bucket_fn``;
random keys with duplicates, EMPTY_KEY and negative values; U = max_new
and max_new + 1; every key already in the table, and every key new; a run
of inserts whose key counts grow and shrink; the stamp as an int and as a
0-d tensor.  On CPU tensors the public functions run exactly these plain
versions.  K5b's persistent scratch: its size and growth, and its layout
against csrc/alloc.cu.

Tolerances (PERF.md §2's tiers): everything here is integer state or rows
that allocation writes whole (zeros, inf), so all of it is bit-exact.  The
kernels themselves run only on the card (tests/test_torch_cuda_kernels.py);
here their wrappers refuse CPU tensors.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import depth_scene, tiny_flagship_gather_config, tt

from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.parallel import sharded as jsh
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.geometry import coords
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre
from voxelhashing_demo_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(1)

STAMP = 6
FIELDS = tho.HashMap._fields
FAR_X = 81.7      # metres: the key range ends at 512 blocks of 0.16 m

J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_CAND = jax.jit(jho.frame_candidate_keys, static_argnums=(2, 3, 4))
J_INSERT = jax.jit(jho.insert_blocks, static_argnums=(1,),
                   static_argnames=("bucket_fn",))


def _cfgs(**hash_overrides):
    """(JAX config, port config): the tiny flagship gather config with
    ``hash_overrides``."""
    return tuple(dataclasses.replace(c, hash=dataclasses.replace(
        c.hash, **hash_overrides)) for c in (
            tiny_flagship_gather_config("jax"),
            tiny_flagship_gather_config("torch")))


def _pose(far: bool = False) -> np.ndarray:
    """T_wc: turned 7 degrees about y and 3 about x, near the origin or
    FAR_X out along x."""
    a, b = np.deg2rad(7.0), np.deg2rad(3.0)
    Ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    T = np.eye(4)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = [FAR_X if far else 0.05, -0.03, 0.02]
    return T.astype(np.float32)


def _frame(jc, seed: int) -> dict:
    """numpy Frame fields: the JAX frontend on ``depth_scene``."""
    raw = depth_scene(jc.camera.height, jc.camera.width, seed)
    f = J_PRE(jnp.asarray(raw), jc.camera, jc.frontend)
    return {k: np.asarray(v) for k, v in f._asdict().items()}


def _keys(jc, tc, frame: dict, pose: np.ndarray):
    """(JAX keys, port keys) of ``frame`` at ``pose``, as numpy."""
    kj = J_CAND(jpre.Frame(**{k: jnp.asarray(v) for k, v in frame.items()}),
                jnp.asarray(pose), jc.camera, jc.hash, jc.fusion)
    kt = tho.frame_candidate_keys(tpre.Frame(**{k: tt(v) for k, v in
                                                frame.items()}),
                                  tt(pose), tc.camera, tc.hash, tc.fusion)
    return np.asarray(kj), kt.numpy()


# (stride, band steps, frame cut to ODD_HW: neither side a multiple of
# strides 2-4)
ODD_HW = (59, 79)


@pytest.mark.parametrize("stride,steps,odd", [
    pytest.param(1, 3, False, id="1-3"), pytest.param(3, 3, False, id="3-3"),
    pytest.param(1, 5, False, id="1-5"), pytest.param(3, 5, False, id="3-5"),
    pytest.param(1, 1, True, id="1-1-odd"),
    pytest.param(2, 2, True, id="2-2-odd"),
    pytest.param(3, 7, True, id="3-7-odd"),
    pytest.param(4, 3, True, id="4-3-odd")])
def test_candidate_keys_match_jax(stride, steps, odd):
    """Bit-exact keys, in (band, h, w) order, at both poses; the far pose
    gives EMPTY_KEY for part of the band, the dropouts for every band
    sample of their ray.  K5a's edges that a CPU runs: band steps 1, 2
    and 7, and a 79 x 59 frame (cut from the 80 x 60 one), whose sides no
    stride from 2 to 4 divides.  (A valid depth with non-finite vertices
    is a card case only: the CPU's float-to-int32 conversion takes NaN
    and inf elsewhere than XLA's and the card's.)"""
    jc, tc = _cfgs(candidate_stride=stride, band_steps=steps)
    frame = _frame(jc, seed=stride + steps)
    if odd:
        frame = {k: v[:ODD_HW[0], :ODD_HW[1]] for k, v in frame.items()}
    counts = tho.LAUNCHES_ALLOC_CANDIDATES
    near_j, near_t = _keys(jc, tc, frame, _pose())
    far_j, far_t = _keys(jc, tc, frame, _pose(far=True))
    assert tho.LAUNCHES_ALLOC_CANDIDATES == counts
    np.testing.assert_array_equal(near_t, near_j)
    np.testing.assert_array_equal(far_t, far_j)
    H, W = frame["depth"].shape
    assert not odd or (H % stride and W % stride) or stride == 1
    h = -(-H // stride)
    w = -(-W // stride)
    assert near_t.shape == (steps * h * w,)
    invalid = frame["depth"][::stride, ::stride] <= 0
    assert invalid.any()
    by_band = near_t.reshape(steps, h, w)
    assert (by_band[:, invalid] == tho.EMPTY_KEY).all()
    assert (by_band[:, ~invalid] != tho.EMPTY_KEY).all()
    out = (far_t.reshape(steps, h, w)[:, ~invalid] == tho.EMPTY_KEY).mean()
    assert 0.05 < out < 0.95
    assert len(np.unique(near_t)) > 50


def _maps(jc, tc, rng, free_top=None):
    """The same empty map in both packages with random rows (so that the
    rows allocation resets show) and, with ``free_top``, a shorter heap."""
    jm = jho.create(jc.hash)
    N, V = tc.hash.num_blocks, tc.hash.voxels_per_block
    rows = {"tsdf": rng.uniform(-0.1, 0.1, (N, V)).astype(np.float32),
            "weight": rng.integers(0, 9, (N, V)).astype(np.float32),
            "band_min": rng.random(N).astype(np.float32),
            "last_seen": rng.integers(0, 5, N).astype(np.int32),
            "born": rng.integers(0, 5, N).astype(np.int32),
            "free_list": rng.permutation(N).astype(np.int32)}
    if free_top is not None:
        rows["free_top"] = np.int32(free_top)
    jm = jm._replace(**{k: jnp.asarray(v) for k, v in rows.items()})
    tm = tho.HashMap(**{f: tt(np.array(getattr(jm, f))) for f in FIELDS})
    return jm, tm


def _insert_both(jc, tc, jm, tm, keys: np.ndarray, stamp=STAMP, jfn=None,
                 tfn=None, tstamp=None):
    """One insert of ``keys`` in both packages (the port's stamp
    ``tstamp`` when given): (JAX map, port map, JAX n_alloc, port
    n_alloc); the port's on CPU tensors launches nothing."""
    counts = tho.LAUNCHES_INSERT
    jm, nj = J_INSERT(jm, jc.hash, jnp.asarray(keys), bucket_fn=jfn,
                      frame_idx=stamp)
    tm, nt = tho.insert_blocks(tm, tc.hash, tt(keys),
                               stamp if tstamp is None else tstamp, tfn)
    assert tho.LAUNCHES_INSERT == counts
    assert nt.dtype == torch.int32 and nt.dim() == 0
    return jm, tm, int(nj), int(nt)


def _assert_maps_equal(tm, jm):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


def _unique(keys: np.ndarray) -> int:
    return len(np.unique(keys[keys != tho.EMPTY_KEY]))


def test_insert_cap_on_an_empty_map():
    """max_new below the frame's unique keys: both keep the smallest
    max_new keys, and allocate them all."""
    jc, tc = _cfgs(max_new_per_frame=64)
    frame = _frame(jc, seed=1)
    keys = _keys(jc, tc, frame, _pose())[1]
    assert _unique(keys) > 64
    jm, tm = _maps(jc, tc, np.random.default_rng(1))
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, keys)
    _assert_maps_equal(tm, jm)
    assert nt == nj == 64
    kept = np.sort(tm.keys.numpy()[tm.keys.numpy() != tho.EMPTY_KEY])
    np.testing.assert_array_equal(kept, np.unique(keys)[:64])


def test_insert_into_full_buckets():
    """A 256-bucket table: the first pose's insert fills buckets to 3 and
    4; the second pose's keys then overflow them (dropped by rank) and
    fill others, and both packages drop the same keys."""
    jc, tc = _cfgs(num_buckets=256, max_new_per_frame=2048)
    frame = _frame(jc, seed=2)
    jm, tm = _maps(jc, tc, np.random.default_rng(2))
    first = _keys(jc, tc, frame, _pose())[1]
    jm, tm, _, _ = _insert_both(jc, tc, jm, tm, first, stamp=1)
    fill = tm.bucket_fill.numpy()
    assert (fill == 3).any() and (fill == 4).any()
    second_pose = _pose()
    second_pose[:3, 3] += [0.4, 0.1, -0.3]
    second = _keys(jc, tc, frame, second_pose)[1]
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, second)
    _assert_maps_equal(tm, jm)
    assert nt == nj > 0
    new = np.setdiff1d(np.unique(second), np.unique(first))
    assert nt < len(new[new != tho.EMPTY_KEY])


def test_insert_runs_the_heap_dry():
    """free_top below the new keys: the keys past the heap in (bucket,
    key) order are dropped, mid-bucket, and free_top ends at 0."""
    jc, tc = _cfgs()
    frame = _frame(jc, seed=3)
    keys = _keys(jc, tc, frame, _pose())[1]
    jm, tm = _maps(jc, tc, np.random.default_rng(3), free_top=37)
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, keys)
    _assert_maps_equal(tm, jm)
    assert nt == nj == 37 and int(tm.free_top) == 0


def test_insert_sharded_bucket():
    """The sharded step's owner-local buckets: ``_local_bucket_fn`` is a
    ``BucketHash(num_buckets, 2)`` that gives what JAX's lambda gives, and
    the insert of the keys rank 1 of two owns into a half-size table
    equals JAX's."""
    jc, tc = _cfgs()
    n = 2
    frame = _frame(jc, seed=4)
    keys = _keys(jc, tc, frame, _pose())[1]
    blocks = coords.unpack_block_key(tt(keys), tc.hash.key_bits)
    owner = coords.spatial_hash(blocks, tc.hash.num_buckets) % n
    routed = np.where((owner.numpy() == 1) & (keys != tho.EMPTY_KEY), keys,
                      tho.EMPTY_KEY).astype(np.int32)
    tfn = tsh._local_bucket_fn(tc.hash, n)
    jfn = jsh._local_bucket_fn(jc.hash, n)
    assert tfn == tho.BucketHash(tc.hash.num_buckets, n)
    np.testing.assert_array_equal(
        tfn(blocks).numpy(),
        np.asarray(jfn(jnp.asarray(blocks.numpy()))))
    jl, tl = (dataclasses.replace(c, hash=dataclasses.replace(
        c.hash, num_buckets=c.hash.num_buckets // n,
        num_blocks=c.hash.num_blocks // n,
        max_new_per_frame=c.hash.max_new_per_frame // n)) for c in (jc, tc))
    jm, tm = _maps(jl, tl, np.random.default_rng(4))
    jm, tm, nj, nt = _insert_both(jl, tl, jm, tm, routed, jfn=jfn, tfn=tfn)
    _assert_maps_equal(tm, jm)
    assert nt == nj > 0


@pytest.mark.parametrize("max_new", [2048, 300])
def test_insert_random_keys(max_new):
    """Random keys, a tenth negative, each 1-4 times, shuffled with
    EMPTY_KEY, into a map that already holds a fifth of them: with
    max_new 300 the cap keeps the smallest in signed order."""
    jc, tc = _cfgs(max_new_per_frame=max_new)
    rng = np.random.default_rng(max_new)
    U = 1200
    keys = rng.choice(2 ** 30, U, replace=False).astype(np.int64)
    neg = rng.random(U) < 0.1
    keys[neg] = -keys[neg] - 1
    keys = keys.astype(np.int32)
    cand = np.concatenate([np.repeat(keys, rng.integers(1, 5, U)),
                           np.full(U // 3, tho.EMPTY_KEY, np.int32)])
    rng.shuffle(cand)
    jm, tm = _maps(jc, tc, rng)
    jm, tm, _, _ = _insert_both(jc, tc, jm, tm, keys[rng.random(U) < 0.2],
                                stamp=2)
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, cand)
    _assert_maps_equal(tm, jm)
    assert nt == nj > 0


def test_stamp_as_a_tensor():
    """The stamp as a 0-d int32 tensor gives the map the int gives, in
    ``insert_blocks`` and in ``integrate``'s stamp (``touch_active``), as
    JAX's traced frame index does."""
    jc, tc = _cfgs()
    frame = _frame(jc, seed=5)
    keys = _keys(jc, tc, frame, _pose())[1]
    rng = np.random.default_rng(5)
    jm, tm = _maps(jc, tc, rng)
    _, tm2 = _maps(jc, tc, np.random.default_rng(5))
    j0 = jm
    jm, tm, nj, nt = _insert_both(jc, tc, j0, tm, keys,
                                  stamp=jnp.int32(STAMP), tstamp=STAMP)
    _, tm2, _, nt2 = _insert_both(jc, tc, j0, tm2, keys, tstamp=torch.tensor(
        STAMP, dtype=torch.int32))
    _assert_maps_equal(tm, jm)
    _assert_maps_equal(tm2, jm)
    assert nt == nt2 == nj > 0
    pose = tt(_pose())
    depth = tt(frame["depth"])
    for m, s in ((tm, STAMP + 1), (tm2, torch.tensor(STAMP + 1,
                                                       dtype=torch.int32))):
        active = tho.compact_visible(m, tc.hash, pose, tc.camera, tc.fusion)
        tho.integrate(m, active, tc.hash, depth, pose, tc.camera, tc.fusion,
                      stamp=s)
    for f in FIELDS:
        assert torch.equal(getattr(tm, f), getattr(tm2, f)), f
    assert bool((tm.last_seen == STAMP + 1).any())


def test_public_functions_run_plain_on_cpu():
    """On CPU tensors ``frame_candidate_keys``, ``insert_blocks`` and
    ``allocate_from_frame`` return the plain versions' results and launch
    nothing; the kernels' wrappers refuse CPU tensors, bucket functions
    that are not a ``BucketHash``, max_new past one CTA and stamp tensors
    of another type."""
    jc, tc = _cfgs()
    frame = _frame(jc, seed=6)
    f = tpre.Frame(**{k: tt(v) for k, v in frame.items()})
    pose = tt(_pose())
    args = (tc.camera, tc.hash, tc.fusion)
    counts = (tho.LAUNCHES_ALLOC_CANDIDATES, tho.LAUNCHES_INSERT)
    keys = tho.frame_candidate_keys(f, pose, *args)
    assert torch.equal(keys, tho.frame_candidate_keys_reference(f, pose,
                                                                 *args))
    _, tm = _maps(jc, tc, np.random.default_rng(6))
    a = tm._replace(**{k: getattr(tm, k).clone() for k in FIELDS})
    b = tm._replace(**{k: getattr(tm, k).clone() for k in FIELDS})
    _, na = tho.allocate_from_frame(a, f, pose, *args, frame_idx=3)
    _, nb = tho.insert_blocks_reference(b, tc.hash, keys, 3)
    for fld in FIELDS:
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld
    assert int(na) == int(nb) > 0
    assert (tho.LAUNCHES_ALLOC_CANDIDATES, tho.LAUNCHES_INSERT) == counts
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_candidates(f, pose, tc.hash, tc.fusion)
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_insert(tm, tc.hash, keys, 1, None)
    with pytest.raises(ValueError, match="BucketHash"):
        tho._launch_insert(tm, tc.hash, keys, 1, lambda blocks: blocks[..., 0])
    with pytest.raises(ValueError, match="max_new_per_frame"):
        tho._launch_insert(tm, dataclasses.replace(
            tc.hash, max_new_per_frame=tho.MAX_NEW + 1), keys, 1, None)
    with pytest.raises(ValueError, match="stamp"):
        tho._stamp_arg(torch.tensor(1), torch.device("cpu"), "insert_blocks")
    assert tho._stamp_arg(7, torch.device("cpu"), "x") == (None, 7)
    assert tho.default_bucket_fn(tc.hash) == tho.BucketHash(
        tc.hash.num_buckets, 1)


def test_candidate_tables_refuse_and_are_kept_by_identity():
    """K5a's host tables raise on key bits outside 1..MAX_KEY_BITS (as
    its wrapper did on every call); they are built once a configuration
    and kept by the objects' identity (the same tables for the same
    objects, new ones for an equal copy): the stride, band steps, key bits
    and block size, and the truncation, its depth scale, recip(voxel
    size) and torch.linspace(-1, 1, steps)'s step as float32."""
    from voxelhashing_demo_tpu_torch.geometry.f32 import recip

    _, tc = _cfgs(candidate_stride=3, band_steps=5)
    for bits in (0, tho.MAX_KEY_BITS + 1):
        with pytest.raises(ValueError, match="key bits"):
            tho._candidate_tables(dataclasses.replace(tc.hash,
                                                      key_bits=bits),
                                  tc.fusion)
    ints, floats = tho._candidate_tables(tc.hash, tc.fusion)
    assert tho._candidate_tables(tc.hash, tc.fusion)[0] is ints
    assert list(ints) == [3, 5, tc.hash.key_bits, tc.hash.block_size]
    fus = tc.fusion
    assert list(floats) == [float(np.float32(x)) for x in (
        fus.truncation, fus.trunc_scale, recip(fus.voxel_size))] + [
        float(np.float32(2.0) / np.float32(4.0))]
    for n in (2, 3, 7):
        step = tho._candidate_tables(dataclasses.replace(
            tc.hash, band_steps=n), fus)[1][3]
        assert step == float(np.float32(2.0) / np.float32(n - 1))
    assert tho._candidate_tables(dataclasses.replace(
        tc.hash, band_steps=1), fus)[1][3] == 0.0
    again = tho._candidate_tables(dataclasses.replace(tc.hash), fus)
    assert again[0] is not ints and list(again[0]) == list(ints)


def test_kernel_arguments_match_the_sources():
    """Each allocation kernel's ctypes argument list (kernels.KERNELS) has
    as many entries as its C entry point in csrc/alloc.cu has parameters,
    the pointers where the C function takes pointers, ints where it takes
    ints; both build from that one source."""
    src = (Path(kernels.SRC_DIR) / "alloc.cu").read_text()
    for name in ("alloc_candidates", "insert_blocks"):
        assert kernels.source_of(name) == "alloc"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)
            if "*" not in p:
                assert p.startswith("float") == (t is kernels._F), (name, p)
    assert re.search(r"constexpr int kMaxNew = (\d+);", src).group(1) == \
        str(tho.MAX_NEW)


def _random_keys(rng, U: int, repeats: int = 4) -> tuple:
    """(U distinct random keys, a tenth negative; those keys each 1 to
    ``repeats`` times, shuffled with EMPTY_KEY) as int32 numpy arrays."""
    keys = rng.choice(2 ** 30, U, replace=False).astype(np.int64)
    neg = rng.random(U) < 0.1
    keys[neg] = -keys[neg] - 1
    keys = keys.astype(np.int32)
    cand = np.concatenate([np.repeat(keys, rng.integers(1, repeats + 1, U)),
                           np.full(U // 3 + 1, tho.EMPTY_KEY, np.int32)])
    rng.shuffle(cand)
    return keys, cand


@pytest.mark.parametrize("over", [0, 1])
def test_insert_at_the_cap(over):
    """U = max_new (no cap: every distinct key kept) and U = max_new + 1
    (the cap drops exactly the largest key in signed order), into a map
    that holds some of the keys: K5b takes its cap path only in the
    second case."""
    max_new = 300
    jc, tc = _cfgs(max_new_per_frame=max_new)
    rng = np.random.default_rng(40 + over)
    keys, cand = _random_keys(rng, max_new + over)
    jm, tm = _maps(jc, tc, rng)
    jm, tm, _, _ = _insert_both(jc, tc, jm, tm, keys[:40], stamp=2)
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, cand)
    _assert_maps_equal(tm, jm)
    kept = np.sort(keys)[:max_new]
    pre = set(keys[:40].tolist())
    assert nt == nj == sum(int(k) not in pre for k in kept)
    largest = int(np.sort(keys)[-1])
    stored = set(tm.keys.numpy().tolist())
    assert (largest in stored) == (not over or largest in pre)


@pytest.mark.parametrize("which", ["all_existing", "all_new"])
def test_insert_all_existing_or_all_new(which):
    """Every candidate key already in the table (nothing allocated,
    nothing changes) and every key new (each one allocated), against
    JAX."""
    jc, tc = _cfgs(max_new_per_frame=2048)
    rng = np.random.default_rng(50)
    keys, cand = _random_keys(rng, 700)
    jm, tm = _maps(jc, tc, rng)
    if which == "all_existing":
        jm, tm, _, _ = _insert_both(jc, tc, jm, tm, keys, stamp=2)
        before = {f: getattr(tm, f).clone() for f in FIELDS}
    jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, cand)
    _assert_maps_equal(tm, jm)
    if which == "all_existing":
        assert nt == nj == 0
        for f in FIELDS:
            assert torch.equal(getattr(tm, f), before[f]), f
    else:
        assert nt == nj == int((tm.keys != tho.EMPTY_KEY).sum()) > 600


def test_insert_sequence_of_sizes():
    """A run of inserts whose key counts M grow and shrink (the sizes K5b's
    persistent scratch must serve one after another), each against JAX on
    the map the last left."""
    jc, tc = _cfgs(max_new_per_frame=1024)
    rng = np.random.default_rng(60)
    jm, tm = _maps(jc, tc, rng)
    for U in (900, 40, 2500, 7):
        _, cand = _random_keys(rng, U)
        jm, tm, nj, nt = _insert_both(jc, tc, jm, tm, cand, stamp=U)
        _assert_maps_equal(tm, jm)
        assert nt == nj


def test_insert_scratch_size_and_growth():
    """K5b's scratch: the capacity the next power of two >= M (at least
    INSERT_MIN_CAPACITY), a set of twice that, the int count csrc/alloc.cu
    lays out; one scratch a device and stream, made with its set empty
    and its header 0, kept while M fits, replaced when M outgrows it, the
    replaced one kept alive."""
    lo = tho.INSERT_MIN_CAPACITY
    assert tho.insert_scratch_size(0)[:2] == (lo, lo.bit_length())
    assert tho.insert_scratch_size(lo)[0] == lo
    cap, bits, ints = tho.insert_scratch_size(102720)
    assert cap == 131072 and 1 << bits == 2 * cap
    assert ints == tho.INSERT_HDR_INTS + 5 * cap + (1 << bits) + tho.MAX_NEW
    assert tho.insert_scratch_size(lo + 1)[0] == 2 * lo
    dev = torch.device("cpu")
    saved = dict(tho._INSERT_SCRATCH), list(tho._INSERT_RETIRED)
    try:
        tho._INSERT_SCRATCH.clear()
        a = tho._insert_scratch(dev, 11, 100)
        assert tho._insert_scratch(dev, 11, lo) is a
        hdr, st = tho.insert_scratch_parts(*a)
        assert a[0].numel() == tho.insert_scratch_size(100)[2]
        assert not hdr.any() and bool((st == tho.EMPTY_KEY).all())
        b = tho._insert_scratch(dev, 12, 100)
        assert b[0] is not a[0]
        c = tho._insert_scratch(dev, 11, 5000)
        assert c[1] == 8192 and tho._INSERT_SCRATCH[(dev.index, 11)] is c
        assert tho._INSERT_RETIRED[-1] is a[0]
        assert tho._insert_scratch(dev, 11, 300) is c
    finally:
        tho._INSERT_SCRATCH.clear()
        tho._INSERT_SCRATCH.update(saved[0])
        tho._INSERT_RETIRED[:] = saved[1]


def test_insert_scratch_during_capture(monkeypatch):
    """While the stream is being captured into a CUDA graph, a scratch
    that exists and fits is the persistent one; one that is missing or
    too small is the capture's own, made empty (set EMPTY_KEY, counts 0)
    and neither kept nor replacing the persistent one."""
    dev = torch.device("cpu")
    saved = dict(tho._INSERT_SCRATCH), list(tho._INSERT_RETIRED)
    try:
        tho._INSERT_SCRATCH.clear()
        kept = tho._insert_scratch(dev, 21, 3000)
        monkeypatch.setattr(tho, "_capturing", lambda d: True)
        assert tho._insert_scratch(dev, 21, 100) is kept
        retired = list(tho._INSERT_RETIRED)
        for stream, M in ((21, 5000), (22, 100)):
            own = tho._insert_scratch(dev, stream, M)
            hdr, st = tho.insert_scratch_parts(*own)
            assert own[1] >= M and own[0] is not kept[0]
            assert not hdr.any() and bool((st == tho.EMPTY_KEY).all())
        assert tho._INSERT_SCRATCH == {(dev.index, 21): kept}
        assert tho._INSERT_RETIRED == retired
        monkeypatch.setattr(tho, "_capturing", lambda d: False)
        grown = tho._insert_scratch(dev, 21, 5000)
        assert tho._INSERT_SCRATCH[(dev.index, 21)] is grown
        assert tho._INSERT_RETIRED[-1] is kept[0]
    finally:
        tho._INSERT_SCRATCH.clear()
        tho._INSERT_SCRATCH.update(saved[0])
        tho._INSERT_RETIRED[:] = saved[1]


def test_kernel_scratch_layout_matches_the_source():
    """The scratch header, the rows list and the fill limit the wrapper
    counts with are the kernel's (csrc/alloc.cu)."""
    src = (Path(kernels.SRC_DIR) / "alloc.cu").read_text()
    hdr = re.search(r"kHdrEpoch = (\d+),\s+kHdrInfo = \d+, kHdrInts = (\d+);",
                    src)
    assert int(hdr.group(1)) == tho.INSERT_HDR_ZERO
    assert int(hdr.group(2)) == tho.INSERT_HDR_INTS
    assert re.search(r"S > (\d+)", src).group(1) == str(tho.MAX_BUCKET_SIZE)
    assert "uint16_t fill[kMaxNew]" in src
