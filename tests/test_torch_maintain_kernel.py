"""The plain versions of the map-maintenance kernels (``ops/hash_ops.py``:
K10 ``gc_free``'s ``garbage_collect_reference``, K14 ``evict_free``'s
``evict_stale_reference``, K15 ``restore_rows``'s
``restore_blocks_reference``) against the JAX package on maps made from a
numpy seed and carried to both packages by ``convert``.

Every case uses one table shape (64 buckets of 4 slots, 160 rows of 4^3
voxels), so each JAX function compiles once for each static argument.
Garbage collection: more stale entries than ``max_free``; the middle slots
of a full bucket freed; free-stack pushes past its end dropped; the age
gate off (``min_age`` 0) and on, with ages on both sides of it; the frame
as a 0-d tensor.  Eviction: more stale entries than ``max_evict``; the
strict age gate (an age equal to ``max_age`` stays, where GC's ``>=``
frees it); nothing stale (every output row padding); the frame as a 0-d
tensor.  Restore: keys merged into rows re-allocated since their eviction
beside new ones; full buckets and a heap that runs dry mid-batch;
EMPTY_KEY padding only (nothing written); ``born_rows=None``; the sharded
step's ``BucketHash(num_buckets, 2)`` against JAX's ``_local_bucket_fn``;
the frame as a 0-d tensor.  On CPU tensors the public functions run
exactly these plain versions; the kernels' wrappers refuse CPU tensors,
buckets past ``MAX_SLOTS`` and restores past ``MAX_RESTORE``.

Tolerances (PERF.md §2's streaming tier): the integer map state (keys,
ptrs, bucket_fill, free_list, free_top, last_seen, born), the evicted
outputs, the accepted mask and every row that is only copied are
bit-exact; a weight-merged tsdf row and the band_min taken from it are
within 1e-6 (the jitted JAX merge contracts to a fused multiply-add, the
port's plain version does not).  The kernels themselves run only on the
card (tests/test_torch_cuda_kernels.py).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import HashConfig as JHashConfig
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.parallel import sharded as jsh
from voxelhashing_demo_tpu_torch import convert, kernels
from voxelhashing_demo_tpu_torch.config import HashConfig as THashConfig
from voxelhashing_demo_tpu_torch.geometry import coords
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho

torch.set_num_threads(1)

SHAPE = dict(num_buckets=64, bucket_size=4, num_blocks=160, block_size=4,
             max_active=256, max_new_per_frame=256)
CJ, CT = JHashConfig(**SHAPE), THashConfig(**SHAPE)
NB, S, N, V = 64, 4, 160, 64
EMPTY = int(tho.EMPTY_KEY)
INTS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
        "last_seen", "born")
MIN_WEIGHT = 0.5
MAX_AGE = 12
R = 48                    # keys a restore batch

J_GC = jax.jit(jho.garbage_collect, static_argnums=(1,),
               static_argnames=("min_age",))
J_EVICT = jax.jit(jho.evict_stale, static_argnums=(1, 3, 4))
J_RESTORE = jax.jit(jho.restore_blocks, static_argnums=(1,),
                    static_argnames=("bucket_fn", "max_weight"))


def _blocks(rng, n: int) -> np.ndarray:
    """``n`` distinct random block coordinates inside the key range."""
    flat = rng.choice(40 ** 3, n, replace=False)
    return (np.stack([flat // 1600, flat // 40 % 40, flat % 40], -1)
            - 20).astype(np.int32)


def _keys_buckets(blocks: np.ndarray, bucket_fn=None):
    """(packed keys, buckets) of ``blocks`` by the port's coords."""
    b = torch.from_numpy(blocks)
    keys = coords.pack_block_key(b, CT.key_bits)
    fn = bucket_fn or tho.default_bucket_fn(CT)
    return keys.numpy(), fn(b).numpy()


def _np_map(rng, n: int, low: float = 0.4) -> dict:
    """A consistent map of ``n`` blocks at random places: each bucket's
    occupied slots a prefix (a block whose bucket is full is left out),
    rows from a shuffled heap, the free stack's first free_top entries the
    free rows; payload: a ``low`` share of the rows with every weight
    below MIN_WEIGHT (zeros among them), the others with some above;
    last_seen in 0..40, born below it."""
    keys, buckets = _keys_buckets(_blocks(rng, n))
    tkeys = np.full(NB * S, EMPTY, np.int32)
    tptrs = np.full(NB * S, -1, np.int32)
    fill = np.zeros(NB, np.int32)
    rows = rng.permutation(N).astype(np.int32)
    used = 0
    for k, b in zip(keys, buckets):
        if fill[b] < S:
            tkeys[b * S + fill[b]] = k
            tptrs[b * S + fill[b]] = rows[used]
            fill[b] += 1
            used += 1
    free = rows[used:]
    weight = rng.uniform(0.0, 3.0, (N, V)).astype(np.float32)
    lows = rng.random(N) < low
    weight[lows] = rng.uniform(0.0, MIN_WEIGHT * 0.99, (lows.sum(), V))
    weight[lows, :5] = 0.0
    last_seen = rng.integers(0, 41, N).astype(np.int32)
    return {
        "keys": tkeys, "ptrs": tptrs, "bucket_fill": fill,
        "free_list": np.concatenate([rng.permutation(free),
                                     rng.permutation(rows[:used])]),
        "free_top": np.asarray(N - used, np.int32),
        "tsdf": rng.uniform(-1.0, 1.0, (N, V)).astype(np.float32),
        "weight": weight,
        "last_seen": last_seen,
        "band_min": rng.uniform(0.0, 0.1, N).astype(np.float32),
        "born": (last_seen // 2).astype(np.int32),
    }


def _both(d: dict):
    """(JAX map, port map on the CPU) of the numpy map ``d``."""
    jmap = jho.HashMap(**{k: jnp.asarray(v) for k, v in d.items()})
    return jmap, convert.hashmap_from_numpy(d, device="cpu")


def _assert_maps(tmap, jmap, merged: bool = False):
    """Integer state and copied rows bit for bit; with ``merged`` the tsdf
    and band_min within 1e-6."""
    got = convert.hashmap_to_numpy(tmap)
    for f in tho.HashMap._fields:
        want = np.asarray(getattr(jmap, f))
        if merged and f in ("tsdf", "band_min"):
            np.testing.assert_allclose(got[f], want, atol=1e-6, rtol=0,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


def _stamp(frame: int, as_tensor: bool):
    return torch.tensor(frame, dtype=torch.int32) if as_tensor else frame


# --------------------------------------------------------------------------
# K10: garbage collection
# --------------------------------------------------------------------------

# case -> (max_free, frame, min_age, frame as a tensor)
GC_CASES = {
    "cap": (5, None, 0, False),
    "all": (1000, None, 0, False),
    "age_gate": (1000, 30, 16, False),
    "age_gate_tensor_stamp": (7, 30, 16, True),
}


@pytest.mark.parametrize("case", list(GC_CASES))
def test_gc_matches_jax(case):
    """garbage_collect_reference == JAX garbage_collect, bit for bit: the
    map and n_freed; the cap case frees exactly max_free of more stale
    entries, the gate keeps rows seen within min_age frames (ages equal to
    it freed)."""
    max_free, frame, min_age, as_tensor = GC_CASES[case]
    rng = np.random.default_rng(3)
    d = _np_map(rng, 150)
    if min_age:
        d["last_seen"][:20] = frame - min_age      # exactly at the gate
    jmap, tmap = _both(d)
    jm, jn = J_GC(jmap, CJ, MIN_WEIGHT, max_free, frame, min_age=min_age)
    counts = (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT, tho.LAUNCHES_RESTORE)
    tm, tn = tho.garbage_collect(tmap, CT, MIN_WEIGHT, max_free,
                                 _stamp(frame, as_tensor) if frame else None,
                                 min_age)
    assert (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT,
            tho.LAUNCHES_RESTORE) == counts
    _assert_maps(tm, jm)
    assert tn.dtype == torch.int32 and tn.dim() == 0
    assert int(tn) == int(jn) > 0
    if case == "cap":
        assert int(tn) == max_free
        stale = (d["ptrs"] >= 0) & (d["weight"].max(1)[d["ptrs"]]
                                    < MIN_WEIGHT)
        assert stale.sum() > max_free


def test_gc_frees_the_middle_of_a_full_bucket():
    """A full bucket whose slots 1 and 2 are stale: the survivors move to
    the front in their order, the freed rows are pushed in table order."""
    rng = np.random.default_rng(5)
    d = _np_map(rng, 150, low=0.0)
    full = int(np.flatnonzero(d["bucket_fill"] == S)[0])
    slots = d["ptrs"][full * S:(full + 1) * S].copy()
    keys = d["keys"][full * S:(full + 1) * S].copy()
    d["weight"][slots[1:3]] = 0.1
    jmap, tmap = _both(d)
    jm, jn = J_GC(jmap, CJ, MIN_WEIGHT, 1000, None, min_age=0)
    tm, tn = tho.garbage_collect(tmap, CT, MIN_WEIGHT, 1000)
    _assert_maps(tm, jm)
    assert int(tn) == int(jn) == 2
    assert tm.keys[full * S:(full + 1) * S].tolist() == [
        keys[0], keys[3], EMPTY, EMPTY]
    assert tm.ptrs[full * S:(full + 1) * S].tolist() == [
        slots[0], slots[3], -1, -1]
    assert int(tm.bucket_fill[full]) == 2
    top = int(d["free_top"])
    assert tm.free_list[top:top + 2].tolist() == slots[1:3].tolist()


def test_gc_drops_pushes_past_the_stack():
    """free_top so high that the pushes of the later freed rows fall past
    the free stack's end: they are dropped, free_top still counts them."""
    rng = np.random.default_rng(6)
    d = _np_map(rng, 150)
    d["free_top"] = np.asarray(N - 3, np.int32)
    jmap, tmap = _both(d)
    jm, jn = J_GC(jmap, CJ, MIN_WEIGHT, 1000, None, min_age=0)
    tm, tn = tho.garbage_collect(tmap, CT, MIN_WEIGHT, 1000)
    _assert_maps(tm, jm)
    assert int(tn) == int(jn) > 3
    assert int(tm.free_top) == N - 3 + int(tn)


# --------------------------------------------------------------------------
# K14: eviction
# --------------------------------------------------------------------------

# case -> (max_evict, frame, frame as a tensor)
EVICT_CASES = {
    "cap": (16, 40, False),
    "all": (128, 40, False),
    "nothing_stale": (16, 5, False),
    "tensor_stamp": (16, 40, True),
}


@pytest.mark.parametrize("case", list(EVICT_CASES))
def test_evict_matches_jax(case):
    """evict_stale_reference == JAX evict_stale, bit for bit: the map, the
    evicted keys, tsdf, weight and born rows (padding past n) and n; ages
    equal to max_age stay (the strict gate)."""
    max_evict, frame, as_tensor = EVICT_CASES[case]
    rng = np.random.default_rng(8)
    d = _np_map(rng, 150)
    d["last_seen"][:30] = frame - MAX_AGE          # age == max_age: kept
    jmap, tmap = _both(d)
    jout = J_EVICT(jmap, CJ, frame, MAX_AGE, max_evict)
    counts = (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT, tho.LAUNCHES_RESTORE)
    tout = tho.evict_stale(tmap, CT, _stamp(frame, as_tensor), MAX_AGE,
                           max_evict)
    assert (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT,
            tho.LAUNCHES_RESTORE) == counts
    _assert_maps(tout[0], jout[0])
    for name, a, b in zip(("keys", "tsdf", "weight", "born", "n"),
                          tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    n = int(tout[-1])
    live = d["ptrs"] >= 0
    ages = frame - d["last_seen"][d["ptrs"][live]]
    assert n == min(int((ages > MAX_AGE).sum()), max_evict)
    assert (tout[1][n:] == EMPTY).all() and not tout[2][n:].any()
    if case == "nothing_stale":
        assert n == 0
    elif case != "all":
        assert n == max_evict
    gone = set(tout[1][:n].tolist())
    at_gate = d["keys"][np.isin(d["ptrs"], np.flatnonzero(
        d["last_seen"] == frame - MAX_AGE)) & live]
    assert not gone & set(at_gate.tolist())


# --------------------------------------------------------------------------
# K15: restore
# --------------------------------------------------------------------------

def _batch(rng, d: dict, n_found: int, n_new: int, n_full: int = 0,
           bucket_fn=None) -> dict:
    """A restore batch of R rows: ``n_found`` keys the map holds, ``n_new``
    keys it lacks (the first ``n_full`` of them in full buckets, the
    others where their bucket has room), the rest EMPTY_KEY, in a shuffled
    order; random payload (a fifth of the weights 0) and born stamps."""
    live = np.flatnonzero(d["keys"] != EMPTY)
    found = d["keys"][rng.choice(live, n_found, replace=False)]
    blocks = _blocks(rng, 400)
    keys, buckets = _keys_buckets(blocks, bucket_fn)
    fresh = ~np.isin(keys, d["keys"])
    full = fresh & (d["bucket_fill"][buckets] == S)
    room = S - d["bucket_fill"]
    fits = []
    for k, bk in zip(keys[fresh & ~full], buckets[fresh & ~full]):
        if len(fits) < n_new - n_full and room[bk] > 0:
            room[bk] -= 1
            fits.append(k)
    pick = np.concatenate([keys[full][:n_full],
                           np.asarray(fits, np.int32)]).astype(np.int32)
    assert pick.size == n_new
    out = np.full(R, EMPTY, np.int32)
    out[:n_found + n_new] = np.concatenate([found, pick])
    rng.shuffle(out)
    w = rng.uniform(0.0, 4.0, (R, V)).astype(np.float32)
    w[rng.random((R, V)) < 0.2] = 0.0
    return {"keys": out,
            "tsdf": rng.uniform(-1.0, 1.0, (R, V)).astype(np.float32),
            "weight": w,
            "born": rng.integers(0, 30, R).astype(np.int32)}


def _restore_both(d, b, frame, born=True, bucket_fn=None, cfgs=(CJ, CT),
                  as_tensor=False):
    jmap, tmap = _both(d)
    jfn = None if bucket_fn is None else bucket_fn[0]
    tfn = None if bucket_fn is None else bucket_fn[1]
    jm, jacc = J_RESTORE(jmap, cfgs[0], jnp.asarray(b["keys"]),
                         jnp.asarray(b["tsdf"]), jnp.asarray(b["weight"]),
                         frame, bucket_fn=jfn, max_weight=64.0,
                         born_rows=jnp.asarray(b["born"]) if born else None)
    counts = (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT, tho.LAUNCHES_RESTORE)
    tm, tacc = tho.restore_blocks(
        tmap, cfgs[1], torch.from_numpy(b["keys"]),
        torch.from_numpy(b["tsdf"]), torch.from_numpy(b["weight"]),
        _stamp(frame, as_tensor), tfn, 64.0,
        torch.from_numpy(b["born"]) if born else None)
    assert (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT,
            tho.LAUNCHES_RESTORE) == counts
    _assert_maps(tm, jm, merged=True)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    return tm, tacc.numpy()


# case -> (found, new, of them in full buckets, free_top, born rows,
# frame as a tensor)
RESTORE_CASES = {
    "merge_realloc": (12, 20, 0, None, True, False),
    "full_buckets_heap_dry": (6, 30, 6, 10, True, False),
    "padding_only": (0, 0, 0, None, True, False),
    "born_none": (12, 20, 0, None, False, False),
    "tensor_stamp": (12, 20, 3, None, True, True),
}


@pytest.mark.parametrize("case", list(RESTORE_CASES))
def test_restore_matches_jax(case):
    """restore_blocks_reference == JAX restore_blocks: the map (merged
    tsdf and band_min within 1e-6, the rest bit for bit) and accepted.
    Found keys merge into their rows (born the min of both with born
    rows); new keys take rows in stable bucket order; keys of full
    buckets and those past a heap run dry are refused; EMPTY_KEY padding
    writes nothing."""
    n_found, n_new, n_full, top, born, as_tensor = RESTORE_CASES[case]
    rng = np.random.default_rng(11)
    d = _np_map(rng, 120)
    if top is not None:
        d["free_top"] = np.asarray(top, np.int32)
    b = _batch(rng, d, n_found, n_new, n_full)
    tm, acc = _restore_both(d, b, 33, born=born, as_tensor=as_tensor)
    is_found = np.isin(b["keys"], d["keys"]) & (b["keys"] != EMPTY)
    assert acc[is_found].all() and not acc[b["keys"] == EMPTY].any()
    inserted = int(acc.sum()) - n_found
    assert inserted == int(d["free_top"]) - int(tm.free_top)
    if case == "padding_only":
        _assert_maps(tm, _both(d)[0])
    elif case == "full_buckets_heap_dry":
        assert inserted == top and n_new - n_full > top
    else:
        assert inserted == n_new - n_full


def test_restore_sharded_bucket():
    """The sharded step's owner-local buckets: ``BucketHash(num_buckets,
    2)`` against JAX's ``_local_bucket_fn`` over a table of half the
    buckets, bit for bit."""
    gj = dataclasses.replace(CJ, num_buckets=2 * NB)
    local = (CJ, CT)
    fns = (jsh._local_bucket_fn(gj, 2), tho.BucketHash(2 * NB, 2))
    rng = np.random.default_rng(12)
    d = _np_map(rng, 100)
    b = _batch(rng, d, 0, 24, bucket_fn=fns[1])
    tm, acc = _restore_both(d, b, 9, bucket_fn=fns, cfgs=local)
    assert int(acc.sum()) == 24


# --------------------------------------------------------------------------
# the wrappers on the CPU
# --------------------------------------------------------------------------

def test_public_functions_run_plain_on_cpu():
    """On CPU tensors garbage_collect, evict_stale and restore_blocks
    return their plain versions' results and launch nothing; the kernels'
    wrappers refuse CPU tensors, buckets past MAX_SLOTS (K10, K14),
    restores past MAX_RESTORE and bucket functions that are not a
    BucketHash (K15), and stamp tensors of another type."""
    rng = np.random.default_rng(14)
    d = _np_map(rng, 150)
    counts = (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT, tho.LAUNCHES_RESTORE)
    a, b = _both(d)[1], _both(d)[1]
    _, na = tho.garbage_collect(a, CT, MIN_WEIGHT, 9, 30, 16)
    _, nb = tho.garbage_collect_reference(b, CT, MIN_WEIGHT, 9, 30, 16)
    for f in tho.HashMap._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(na) == int(nb) > 0
    ea = tho.evict_stale(a, CT, 40, MAX_AGE, 16)
    eb = tho.evict_stale_reference(b, CT, 40, MAX_AGE, 16)
    for x, y in zip(ea, eb):
        for f in (x._fields if hasattr(x, "_fields") else [None]):
            u, v = (getattr(x, f), getattr(y, f)) if f else (x, y)
            assert torch.equal(u, v), f
    batch = _batch(rng, convert.hashmap_to_numpy(a), 5, 10)
    args = [torch.from_numpy(batch[k]) for k in ("keys", "tsdf", "weight")]
    _, ra = tho.restore_blocks(a, CT, *args, 41,
                               born_rows=torch.from_numpy(batch["born"]))
    _, rb = tho.restore_blocks_reference(
        b, CT, *args, 41, born_rows=torch.from_numpy(batch["born"]))
    for f in tho.HashMap._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ra, rb) and int(ra.sum()) == 15
    assert (tho.LAUNCHES_GC, tho.LAUNCHES_EVICT,
            tho.LAUNCHES_RESTORE) == counts

    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_gc(a, CT, MIN_WEIGHT, 9, 30, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_evict(a, CT, 40, MAX_AGE, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_restore(a, CT, *args, 41, None, 64.0, None)
    wide = dataclasses.replace(CT, bucket_size=tho.MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="bucket_size"):
        tho._launch_gc(a, wide, MIN_WEIGHT, 9, 30, 16)
    with pytest.raises(ValueError, match="bucket_size"):
        tho._launch_evict(a, wide, 40, MAX_AGE, 16)
    big = torch.full((tho.MAX_RESTORE + 1,), EMPTY, dtype=torch.int32)
    rows = torch.zeros((tho.MAX_RESTORE + 1, V))
    with pytest.raises(ValueError, match=f"at most {tho.MAX_RESTORE}"):
        tho._launch_restore(a, CT, big, rows, rows, 41, None, 64.0, None)
    with pytest.raises(ValueError, match="BucketHash"):
        tho._launch_restore(a, CT, *args, 41, lambda blocks: blocks[..., 0],
                            64.0, None)


def test_kernel_arguments_match_the_source():
    """Each maintenance kernel's ctypes argument list (kernels.KERNELS) has
    as many entries as its C entry point in csrc/maintain.cu has
    parameters, pointers where it takes pointers, floats where it takes
    floats; all three build from that one source; the constants the
    wrappers count with are the kernels'."""
    src = (Path(kernels.SRC_DIR) / "maintain.cu").read_text()
    for name in ("gc_free", "evict_free", "restore_rows"):
        assert kernels.source_of(name) == "maintain"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)
            if "*" not in p:
                assert p.startswith("float") == (t is kernels._F), (name, p)

    def const(name):
        return int(re.search(rf"{name} = (\d+)", src).group(1))

    assert const("kMaxSlots") == tho.MAX_SLOTS
    assert const("kMaxRestore") == tho.MAX_RESTORE
    assert const("kSnapTiles") == tho.EVICT_MIN_TILES
    assert const("kStatusStride") == tho.COMPACT_STATUS_WORDS
    assert const("kHdrInts") == tho.RESTORE_HDR_INTS
    assert const("kThreadsF") * const("kBucketsPerThread") == \
        tho.MAINTAIN_TILE
    assert "new_fill = scratch + kHdrInts + 2 * kMaxRestore" in src
    assert "found_src = P.found_row + kMaxRestore" in src
    assert tho.RESTORE_SCRATCH_INTS == tho.RESTORE_HDR_INTS + (
        2 + 5) * tho.MAX_RESTORE


def test_scratches_persist_a_stream_and_not_under_capture(monkeypatch):
    """K10's and K14's scratch: K6's layout, a dict of its own, grown and
    retired as K6's; K15's: made with its header 0, one a device and
    stream; while the stream is captured neither is made persistent."""
    dev = torch.device("cpu")
    saved = (dict(tho._MAINTAIN_SCRATCH), list(tho._MAINTAIN_RETIRED),
             dict(tho._RESTORE_SCRATCH), dict(tho._COMPACT_SCRATCH))
    try:
        tho._MAINTAIN_SCRATCH.clear()
        tho._RESTORE_SCRATCH.clear()
        a = tho._maintain_scratch(dev, 31, 16)
        assert a[1] == tho.COMPACT_MIN_TILES and not a[0].any()
        assert a[0].numel() == 1 + tho.COMPACT_STATUS_WORDS * a[1]
        assert tho._maintain_scratch(dev, 31, 128) is a
        grown = tho._maintain_scratch(dev, 31, 129)
        assert grown[1] == 256 and tho._MAINTAIN_RETIRED[-1] is a[0]
        assert tho._COMPACT_SCRATCH == saved[3]
        r = tho._restore_scratch(dev, 31)
        assert r.numel() == tho.RESTORE_SCRATCH_INTS and not r.any()
        assert tho._restore_scratch(dev, 31) is r
        assert tho._restore_scratch(dev, 32) is not r
        monkeypatch.setattr(tho, "_capturing", lambda d: True)
        own = tho._restore_scratch(dev, 33)
        assert not own.any() and (dev.index, 33) not in tho._RESTORE_SCRATCH
        assert tho._maintain_scratch(dev, 34, 4)[0] is not grown[0]
        assert (dev.index, 34) not in tho._MAINTAIN_SCRATCH
    finally:
        tho._MAINTAIN_SCRATCH.clear()
        tho._MAINTAIN_SCRATCH.update(saved[0])
        tho._MAINTAIN_RETIRED[:] = saved[1]
        tho._RESTORE_SCRATCH.clear()
        tho._RESTORE_SCRATCH.update(saved[2])


@pytest.mark.parametrize("header,users", [
    ("hash_table.cuh", ("alloc", "maintain")),
    ("tile_status.cuh", ("fuse", "maintain"))])
def test_library_names_cover_the_shared_headers(tmp_path, monkeypatch,
                                                header, users):
    """csrc/alloc.cu and csrc/maintain.cu include csrc/hash_table.cuh,
    csrc/fuse.cu and csrc/maintain.cu csrc/tile_status.cuh: an edit of a
    header renames the CUDA libraries that include it (so they rebuild),
    and the host codec's name does not depend on it."""
    for f in ("alloc.cu", "fuse.cu", "maintain.cu", "hash_table.cuh",
              "tile_status.cuh", "depthio.cpp"):
        (tmp_path / f).write_bytes((kernels.SRC_DIR / f).read_bytes())
    monkeypatch.setattr(kernels, "SRC_DIR", tmp_path)
    before = [kernels.library_path(n) for n in users]
    host = kernels.host_library_path("depthio")
    with open(tmp_path / header, "a") as fh:
        fh.write("\n// edited\n")
    after = [kernels.library_path(n) for n in users]
    assert all(a != b for a, b in zip(before, after))
    assert kernels.host_library_path("depthio") == host
    for n in users:
        assert f'#include "{header}"' in (tmp_path / f"{n}.cu").read_text()
