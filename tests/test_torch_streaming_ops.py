"""Eviction and restore of out-of-core streaming in the PyTorch port
(``hash_ops.evict_stale`` / ``restore_blocks``) against the JAX package.

Every case starts both packages from one JAX map (carried across with
``convert``) and gives both the same numpy payload, so only the update is
compared.  Tolerances: the integer state (keys, ptrs, bucket_fill,
free_list, free_top, last_seen, born), band_min and the evicted / restored
payload are bit-exact; a weight-merged tsdf row, and the band_min taken
from it, are within 1e-6 (the merge ``(t w + t' w') / (w + w')``
contracts to a fused multiply-add in the jitted JAX function and not in
PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_sequence, np_tree, tt

from voxelhashing_demo_tpu.config import HashConfig as JHashConfig
from voxelhashing_demo_tpu.config import tiny_config as jtiny
from voxelhashing_demo_tpu.geometry import coords as jcoords
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.config import HashConfig as THashConfig
from voxelhashing_demo_tpu_torch.config import tiny_config as ttiny
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

EXACT = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
         "last_seen", "born", "band_min", "tsdf", "weight")
EMPTY = int(jho.EMPTY_KEY)

# the JAX side jitted, as the JAX package's streaming cycle runs it
J_EVICT = jax.jit(jho.evict_stale, static_argnums=(1, 3, 4))
J_RESTORE = jax.jit(jho.restore_blocks, static_argnums=(1,))
J_INSERT = jax.jit(jho.insert_blocks, static_argnums=(1,))
J_LOOKUP = jax.jit(jho.lookup_keys, static_argnums=(1,))
J_FUSE = jax.jit(jho.fuse_frame, static_argnums=(3, 4, 5))
J_DEFUSE = jax.jit(jho.defuse_frame, static_argnums=(3, 4, 5))
J_PRE = jax.jit(jpre.preprocess, static_argnums=(1,))


MERGED = ("tsdf", "band_min")


def _assert_merged(tmap, jmap):
    """A weight-merged row's tsdf, and the band_min taken from it."""
    for f in MERGED:
        np.testing.assert_allclose(getattr(tmap, f).numpy(),
                                   np.asarray(getattr(jmap, f)), atol=1e-6,
                                   rtol=0, err_msg=f)


def _tmap(jmap):
    return convert.hashmap_from_numpy(np_tree(jmap), device="cpu")


def _assert_maps(tmap, jmap, skip=()):
    got = convert.hashmap_to_numpy(tmap)
    want = np_tree(jmap)
    for f in EXACT:
        if f not in skip:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _seed_map(cfg, n, rng, frame_idx=0, last_seen=None):
    """A JAX map with ``n`` blocks in a 7-wide strip and random payload."""
    hmap = jho.create(cfg)
    blocks = jnp.array([[i % 7, i // 7, 0] for i in range(n)], jnp.int32)
    keys = jcoords.pack_block_key(blocks, cfg.key_bits)
    hmap, _ = J_INSERT(hmap, cfg, keys, frame_idx=frame_idx)
    ptrs, _ = J_LOOKUP(hmap, cfg, keys)
    V = cfg.voxels_per_block
    t = jnp.asarray(rng.uniform(-1, 1, (n, V)).astype(np.float32))
    w = jnp.asarray(rng.uniform(0, 9, (n, V)).astype(np.float32))
    w = w.at[:, :40].set(0.0)         # unobserved voxels: band_min ignores
    hmap = hmap._replace(tsdf=hmap.tsdf.at[ptrs].set(t),
                         weight=hmap.weight.at[ptrs].set(w))
    if last_seen is not None:
        hmap = hmap._replace(
            last_seen=hmap.last_seen.at[ptrs].set(jnp.asarray(last_seen)),
            born=hmap.born.at[ptrs].set(jnp.asarray(last_seen) // 2))
    return hmap, np.asarray(keys)


def _evict_both(jmap, cfg_j, cfg_t, frame_idx, max_age, max_evict):
    tmap = _tmap(jmap)
    jout = J_EVICT(jmap, cfg_j, frame_idx, max_age, max_evict)
    tout = tho.evict_stale(tmap, cfg_t, frame_idx, max_age, max_evict)
    _assert_maps(tout[0], jout[0])
    for name, a, b in zip(("keys", "tsdf", "weight", "born", "n"),
                          tout[1:], jout[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    return jout, tout


def _restore_both(jmap, cfg_j, cfg_t, keys, tsdf, weight, frame_idx,
                  born=None, skip=()):
    tmap = _tmap(jmap)
    jm, jacc = J_RESTORE(
        jmap, cfg_j, jnp.asarray(keys), jnp.asarray(tsdf),
        jnp.asarray(weight), frame_idx,
        born_rows=None if born is None else jnp.asarray(born))
    tm, tacc = tho.restore_blocks(
        tmap, cfg_t, tt(keys), tt(tsdf), tt(weight), frame_idx,
        born_rows=None if born is None else tt(born))
    _assert_maps(tm, jm, skip)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    return jm, tm, np.asarray(jacc)


@pytest.mark.parametrize("max_evict", [64, 16])
def test_evict_restore_round_trip(max_evict):
    """The JAX round trip (tests/test_streaming.py): 30 blocks evicted at
    frame 40 and restored at 41, with every stale block taken (64) and with
    more stale blocks than ``max_evict`` (16: the first 16 in table order
    go, the rest stay)."""
    cj, ct = jtiny().hash, ttiny().hash
    rng = np.random.default_rng(1)
    jmap, keys = _seed_map(cj, 30, rng)
    (jm, *jout), (tm, *tout) = _evict_both(jmap, cj, ct, 40, 30, max_evict)
    n = int(jout[-1])
    assert n == min(30, max_evict)
    ekeys, etsdf, eweight, eborn = (np.asarray(a) for a in jout[:4])
    assert (ekeys[:n] != EMPTY).all() and (ekeys[n:] == EMPTY).all()
    jm2, tm2, acc = _restore_both(jm, cj, ct, ekeys, etsdf, eweight, 41,
                                  born=eborn)
    assert acc[:n].all() and not acc[n:].any()
    # the restored rows hold the seeded payload bit for bit
    ptrs, found = J_LOOKUP(jm2, cj, jnp.asarray(keys))
    assert bool(jnp.all(found))
    tp, tf = tho.lookup_keys(tm2, ct, tt(keys))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(ptrs))
    np.testing.assert_array_equal(
        tm2.tsdf[tp.long()].numpy(),
        np.asarray(jmap.tsdf)[np.asarray(J_LOOKUP(
            jmap, cj, jnp.asarray(keys))[0])])


def test_evict_age_gate_and_born():
    """Only rows older than ``max_age`` go; ``born`` rides out with them."""
    cj, ct = jtiny().hash, ttiny().hash
    rng = np.random.default_rng(2)
    seen = rng.integers(0, 40, 30).astype(np.int32)
    jmap, _ = _seed_map(cj, 30, rng, last_seen=seen)
    (_, *jout), _ = _evict_both(jmap, cj, ct, 40, 20, 64)
    assert int(jout[-1]) == int((40 - seen > 20).sum()) > 0
    assert np.asarray(jout[3])[: int(jout[-1])].max() > 0


def test_restore_merges_reallocated_block():
    """A key re-allocated fresh after eviction weight-merges with the stored
    payload (tests/test_streaming.py), beside a key inserted new; merged
    born is the min of the two stamps."""
    cj, ct = jtiny().hash, ttiny().hash
    V = cj.voxels_per_block
    blocks = jnp.array([[1, 2, 3], [4, -5, 6]], jnp.int32)
    keys = np.asarray(jcoords.pack_block_key(blocks, cj.key_bits))
    hmap, _ = J_INSERT(jho.create(cj), cj, jnp.asarray(keys[:1]),
                                frame_idx=10)
    ptr, _ = J_LOOKUP(hmap, cj, jnp.asarray(keys[:1]))
    rng = np.random.default_rng(3)
    live_w = rng.uniform(0, 3, V).astype(np.float32)
    live_w[:64] = 0.0
    hmap = hmap._replace(
        tsdf=hmap.tsdf.at[ptr].set(jnp.asarray(
            rng.uniform(-1, 1, V).astype(np.float32))),
        weight=hmap.weight.at[ptr].set(jnp.asarray(live_w)))
    tsdf = rng.uniform(-1, 1, (2, V)).astype(np.float32)
    weight = rng.uniform(0, 5, (2, V)).astype(np.float32)
    weight[:, 32:48] = 0.0
    born = np.array([4, 7], np.int32)
    jm, tm, acc = _restore_both(hmap, cj, ct, keys, tsdf, weight, 11,
                                born=born, skip=MERGED)
    assert acc.all()
    _assert_merged(tm, jm)
    fused = ((np.asarray(hmap.tsdf)[int(ptr[0])] * live_w
              + tsdf[0] * weight[0]) / np.maximum(live_w + weight[0], 1e-12))
    got = tm.tsdf[int(ptr[0])].numpy()
    merged = weight[0] > 0
    np.testing.assert_allclose(got[merged], fused[merged], atol=1e-6)
    assert int(tm.born[int(ptr[0])]) == 4      # min(10, 4)


def test_restore_full_bucket_and_exhausted_heap():
    """More keys than one bucket holds, and more than the heap has rows:
    the overflow comes back ``accepted=False`` in input order, the map as
    in JAX."""
    hc = dict(num_buckets=8, bucket_size=2, num_blocks=10, max_active=16,
              max_new_per_frame=16)
    cj, ct = JHashConfig(**hc), THashConfig(**hc)
    V = cj.voxels_per_block
    rng = np.random.default_rng(4)
    blocks = np.stack([rng.integers(-20, 20, 24), rng.integers(-20, 20, 24),
                       rng.integers(-20, 20, 24)], -1).astype(np.int32)
    keys = np.unique(np.asarray(jcoords.pack_block_key(
        jnp.asarray(blocks), cj.key_bits)))[:20]
    rng.shuffle(keys)
    # three blocks already live (one of them restored again: a merge)
    jmap, _ = J_INSERT(jho.create(cj), cj, jnp.asarray(keys[:3]),
                                frame_idx=1)
    tsdf = rng.uniform(-1, 1, (20, V)).astype(np.float32)
    weight = rng.uniform(0, 5, (20, V)).astype(np.float32)
    jm, tm, acc = _restore_both(jmap, cj, ct, keys[2:], tsdf[2:], weight[2:],
                                5, born=np.arange(18, dtype=np.int32),
                                skip=MERGED)
    _assert_merged(tm, jm)
    assert acc[0] and not acc.all()
    assert int(tm.free_top) == 0


def test_restore_born_rows_none_stamps_now():
    cj, ct = jtiny().hash, ttiny().hash
    rng = np.random.default_rng(5)
    jmap, keys = _seed_map(cj, 12, rng)
    (jm, *jout), _ = _evict_both(jmap, cj, ct, 50, 10, 64)
    jm2, tm2, acc = _restore_both(jm, cj, ct, *(np.asarray(a)
                                                for a in jout[:3]), 51)
    ptrs, _ = tho.lookup_keys(tm2, ct, tt(keys))
    assert (tm2.born[ptrs.long()].numpy() == 51).all()


def test_restore_padding_changes_nothing():
    """EMPTY_KEY rows (any payload) change nothing: a batch of exactly n
    rows and the same batch padded give the same map and accepted mask."""
    cj, ct = jtiny().hash, ttiny().hash
    rng = np.random.default_rng(6)
    jmap, _ = _seed_map(cj, 20, rng)
    (jm, *jout), _ = _evict_both(jmap, cj, ct, 40, 30, 64)
    n = int(jout[-1])
    keys, tsdf, weight, born = (np.asarray(a) for a in jout[:4])
    pad_t = rng.uniform(-1, 1, tsdf.shape).astype(np.float32)
    tsdf_p = np.where((keys == EMPTY)[:, None], pad_t, tsdf)
    _, tm_p, acc_p = _restore_both(jm, cj, ct, keys, tsdf_p, weight, 41,
                                   born=born)
    tm_n, acc_n = tho.restore_blocks(_tmap(jm), ct, tt(keys[:n]),
                                     tt(tsdf[:n]), tt(weight[:n]), 41,
                                     born_rows=tt(born[:n]))
    assert not acc_p[n:].any()
    np.testing.assert_array_equal(acc_n.numpy(), acc_p[:n])
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tm_n, f).numpy(),
                                      getattr(tm_p, f).numpy(), err_msg=f)


def test_fused_evicted_restored_then_defused():
    """A frame fused, everything evicted and restored (original born
    stamps), then the frame de-integrated: the port equals JAX at every
    step, and the de-integration reaches the restored rows (born gate) as
    in the JAX test."""
    jc, tc = jtiny(), ttiny()
    depths, poses = jax_sequence(jc.camera, 2)
    jf = [J_PRE(jnp.asarray(d), jc.camera) for d in depths]
    tf = [tpre.Frame(*(tt(x) for x in f)) for f in jf]
    jm = jho.create(jc.hash)
    for i in range(2):
        jm, _, _ = J_FUSE(jm, jf[i], jnp.asarray(poses[i]), jc.camera,
                                  jc.hash, jc.fusion, frame_idx=i)
    (jm, *jout), _ = _evict_both(jm, jc.hash, tc.hash, 50, 0, 512)
    assert int(jout[-1]) > 0
    jm, tm, acc = _restore_both(jm, jc.hash, tc.hash,
                                *(np.asarray(a) for a in jout[:3]), 51,
                                born=np.asarray(jout[3]))
    assert acc[np.asarray(jout[0]) != EMPTY].all()
    jd = J_DEFUSE(jm, jf[1], jnp.asarray(poses[1]), jc.camera,
                          jc.hash, jc.fusion, frame_born=1)
    td = tho.defuse_frame(tm, tf[1], tt(poses[1]), tc.camera, tc.hash,
                          tc.fusion, frame_born=1)
    _assert_maps(td, jd, skip=("tsdf", "weight", "band_min"))
    for f in ("tsdf", "weight"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), atol=1e-5)
    # frame 1's rows went back to zero weight or to frame 0's weight
    only_a, _, _ = J_FUSE(jho.create(jc.hash), jf[0],
                                  jnp.asarray(poses[0]), jc.camera, jc.hash,
                                  jc.fusion, frame_idx=0)
    keys_a = np.asarray(only_a.keys)
    occ = np.asarray(only_a.ptrs) >= 0
    pa = np.asarray(only_a.ptrs)[occ]
    pu, found = tho.lookup_keys(td, tc.hash, tt(keys_a[occ]))
    assert bool(found.all())
    np.testing.assert_allclose(td.weight[pu.long()].numpy(),
                               np.asarray(only_a.weight)[pa], atol=1e-4)


def test_scatter_drop_matches_masked_set():
    """The sync-free masked scatter equals the boolean-mask one, with none,
    some and all entries kept, for rows and scalars."""
    rng = np.random.default_rng(7)
    for keep_p in (0.0, 0.4, 1.0):
        dst = torch.from_numpy(rng.normal(size=(12, 3)).astype(np.float32))
        idx = torch.from_numpy(rng.permutation(12)[:8].astype(np.int64))
        keep = torch.from_numpy(rng.random(8) < keep_p)
        src = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
        for s in (src, 2.5):
            a, b = dst.clone(), dst.clone()
            tho._scatter_drop(a, idx, keep, s)
            tho._set_rows(b, idx, keep, s)
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gc_free_stack_unchanged_by_sync_free_scatter():
    """garbage_collect (which shares _free_marked with eviction) still
    equals JAX on a map with low-weight rows."""
    cj, ct = jtiny().hash, ttiny().hash
    rng = np.random.default_rng(8)
    jmap, keys = _seed_map(cj, 25, rng)
    ptrs, _ = J_LOOKUP(jmap, cj, jnp.asarray(keys[:10]))
    jmap = jmap._replace(weight=jmap.weight.at[ptrs].set(0.1))
    tm, tn = tho.garbage_collect(_tmap(jmap), ct, 0.5, 6)
    jm, jn = jho.garbage_collect(jmap, cj, 0.5, 6)
    _assert_maps(tm, jm)
    assert int(tn) == int(jn) == 6
