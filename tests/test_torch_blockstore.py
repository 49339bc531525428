"""The PyTorch port's own copy of the host block store
(``voxelhashing_demo_tpu_torch.utils.blockstore``) against the JAX
package's, over one sequence of calls: batches added (with EMPTY_KEY
padding and keys stored again), taken (holes reused last-in first-out),
frustum queries (in store-row order, cut nearest-first past ``max_n``),
payload reads, growth past the initial capacity and the checkpoint arrays.
Everything is equal: state, answers, and the order of the answers.
"""

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import tiny_config as jtiny
from voxelhashing_demo_tpu.utils import blockstore as jbs
from voxelhashing_demo_tpu_torch.config import tiny_config as ttiny
from voxelhashing_demo_tpu_torch.geometry import coords
from voxelhashing_demo_tpu_torch.utils import blockstore as tbs

torch.set_num_threads(1)

EMPTY = int(jbs.EMPTY_KEY)


def _keys(rng, n, key_bits):
    import torch

    blocks = rng.integers(-12, 12, (n, 3)).astype(np.int32)
    blocks[:, 2] = np.abs(blocks[:, 2]) + 2        # in front of the camera
    keys = coords.pack_block_key(torch.from_numpy(blocks), key_bits).numpy()
    return np.unique(keys)


def _batch(rng, keys, V, pad):
    n = keys.shape[0]
    k = np.concatenate([keys, np.full(pad, EMPTY, np.int32)])
    t = rng.normal(size=(n + pad, V)).astype(np.float32)
    w = rng.uniform(0, 5, (n + pad, V)).astype(np.float32)
    b = rng.integers(0, 50, n + pad).astype(np.int32)
    return k, t, w, b


def _assert_same(a, b):
    assert len(a) == len(b)
    assert a._index == b._index
    assert a._n == b._n and a._free == b._free
    assert (a.total_evicted, a.total_restored) == (b.total_evicted,
                                                   b.total_restored)
    for f in ("_keys", "_blocks", "_tsdf", "_weight", "_born"):
        np.testing.assert_array_equal(getattr(a, f)[: a._n],
                                      getattr(b, f)[: b._n], err_msg=f)


@pytest.mark.parametrize("capacity", [4096, 8])
def test_store_sequence_matches_jax(capacity):
    jc, tc = jtiny(), ttiny()
    V = jc.hash.voxels_per_block
    rng = np.random.default_rng(0)
    keys = _keys(rng, 400, jc.hash.key_bits)
    rng.shuffle(keys)
    js = jbs.BlockStore(jc.hash, capacity=capacity)
    ts = tbs.BlockStore(tc.hash, capacity=capacity)
    poses = [np.eye(4, dtype=np.float32)]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.1, -0.05, 0.2)
    poses.append(T)

    def both(name, *args):
        a = getattr(js, name)(*args)
        b = getattr(ts, name)(*args)
        return a, b

    batches = [keys[:120], keys[100:220], keys[220:300]]   # 20 stored again
    for i, bk in enumerate(batches):
        args = _batch(rng, bk, V, pad=7 * i)
        a, b = both("add", *args)
        assert a == b
        _assert_same(js, ts)
    for pose in poses:
        for max_n in (1000, 37):       # all of them, and the nearest 37
            a, b = both("query_frustum", pose, jc.camera, jc.fusion, 64.0,
                        max_n)
            np.testing.assert_array_equal(a, b)
            assert a.size
    # take every third queried key, refuse the rest: holes in row order
    q = js.query_frustum(poses[1], jc.camera, jc.fusion, 64.0, 1000)
    acc = np.arange(q.size) % 3 == 0
    a, b = both("take", q, acc)
    assert a == b == int(acc.sum())
    _assert_same(js, ts)
    # new keys land in the holes, last freed first
    args = _batch(rng, keys[300:330], V, pad=3)
    both("add", *args)
    _assert_same(js, ts)
    for pose in poses:
        a, b = both("query_frustum", pose, jc.camera, jc.fusion, 64.0, 50)
        np.testing.assert_array_equal(a, b)
    got = both("rows_for", q[~acc][:25])
    for x, y in zip(*got):
        np.testing.assert_array_equal(x, y)
    a, b = js.state_arrays(), ts.state_arrays()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ja = jbs.BlockStore.from_arrays(jc.hash, **a)
    ta = tbs.BlockStore.from_arrays(tc.hash, **b)
    _assert_same(ja, ta)


def test_frustum_and_unpack_helpers_match_jax():
    jc = jtiny()
    rng = np.random.default_rng(1)
    keys = _keys(rng, 300, jc.hash.key_bits)
    np.testing.assert_array_equal(
        tbs.unpack_keys_np(keys, jc.hash.key_bits),
        jbs.unpack_keys_np(keys, jc.hash.key_bits))
    blocks = jbs.unpack_keys_np(keys, jc.hash.key_bits)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.05, 0.0, -0.1)
    for margin in (0.0, 64.0):
        np.testing.assert_array_equal(
            tbs.blocks_in_frustum_np(blocks, T, jc.camera, jc.hash,
                                     jc.fusion, margin),
            jbs.blocks_in_frustum_np(blocks, T, jc.camera, jc.hash,
                                     jc.fusion, margin))


def test_empty_store_answers_nothing():
    ts = tbs.BlockStore(ttiny().hash)
    cfg = ttiny()
    assert ts.query_frustum(np.eye(4, dtype=np.float32), cfg.camera,
                            cfg.fusion, 64.0, 10).shape == (0,)
    assert ts.add(np.full(4, EMPTY, np.int32),
                  np.zeros((4, 512), np.float32),
                  np.zeros((4, 512), np.float32)) == 0
    assert len(ts) == 0 and ts.total_evicted == 0
