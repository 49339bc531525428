"""PyTorch port of ops/hash_ops.py against the JAX package.

Both packages start from one map: the JAX state after 4 frames of the
orbit sequence (tiny flagship-gather config), carried across with
voxelhashing_demo_tpu_torch.convert, and both get the same preprocessed
frame and the JAX pose for frame 4.  That keeps tracking drift out of the
map comparison.

Tolerances: integer map state is bit-exact (keys, ptrs, bucket_fill,
free_list, free_top, last_seen, born, the ActiveSet and its order, n_alloc,
n_freed); float rows (tsdf, weight, band_min) agree within atol 1e-5
(float op order in the Curless-Levoy update).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_sequence, np_tree,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import window_gather

torch.set_num_threads(1)

K = 4
INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
              "last_seen", "born")
FLOAT_FIELDS = ("tsdf", "weight", "band_min")

# the JAX side runs jitted (one compile per function instead of one per
# primitive in eager mode)
J_CAND = jax.jit(jho.frame_candidate_keys, static_argnums=(2, 3, 4))
J_INSERT = jax.jit(jho.insert_blocks, static_argnums=(1,))
J_COMPACT = jax.jit(jho.compact_visible, static_argnums=(1, 3, 4))
J_FUSE = jax.jit(jho.fuse_frame, static_argnums=(3, 4, 5))
J_INTEGRATE = jax.jit(jho.integrate, static_argnums=(2, 5, 6))
J_UNIQUE = jax.jit(jho._unique_compact, static_argnums=(1,))
J_LOOKUP = jax.jit(jho.lookup_keys, static_argnums=(1,))
J_TOUCH = jax.jit(jho.touch_active)
J_FREE = jax.jit(jho._free_marked, static_argnums=(1, 3))
J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_GC = jax.jit(jho.garbage_collect, static_argnums=(1, 2, 3),
               static_argnames=("min_age",))


@pytest.fixture(scope="module")
def carried():
    """JAX state after K frames, frame K preprocessed, and frame K's pose."""
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, _ = jax_sequence(jc.camera, 10)
    state = jhs.create(jc)
    for d in depths[:K]:
        state, _ = jhs.step(state, jnp.asarray(d), jc)
    nxt, _ = jhs.step(state, jnp.asarray(depths[K]), jc)
    frame = J_PRE(jnp.asarray(depths[K]), jc.camera, jc.frontend)
    return dict(jc=jc, tc=tc, state=np_tree(state),
                frame=np_tree(frame), pose=np.asarray(nxt.pose))


def _jmap(c):
    return jho.HashMap(**{f: jnp.asarray(c["state"][f"hmap.{f}"])
                          for f in jho.HashMap._fields})


def _tmap(c):
    return convert.hashmap_from_numpy(c["state"], device="cpu",
                                      prefix="hmap")


def _jframe(c):
    return jpre.Frame(**{f: jnp.asarray(v) for f, v in c["frame"].items()})


def _tframe(c):
    return convert.frame_from_numpy(c["frame"], device="cpu")


def assert_maps_equal(tmap, jmap, float_atol=1e-5):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tmap, f).numpy(),
                                      np.asarray(getattr(jmap, f)),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tmap, f).numpy(),
                                   np.asarray(getattr(jmap, f)),
                                   atol=float_atol, err_msg=f)


def assert_active_equal(ta, ja):
    for f in ("blocks", "ptrs", "count"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)


def test_candidate_keys_and_unique(carried):
    c = carried
    kj = J_CAND(_jframe(c), jnp.asarray(c["pose"]),
                                  c["jc"].camera, c["jc"].hash,
                                  c["jc"].fusion)
    kt = tho.frame_candidate_keys(_tframe(c), tt(c["pose"]), c["tc"].camera,
                                  c["tc"].hash, c["tc"].fusion)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    for max_out in (c["tc"].hash.max_new_per_frame, 100):
        np.testing.assert_array_equal(
            tho._unique_compact(kt, max_out).numpy(),
            np.asarray(J_UNIQUE(kj, max_out)))


@pytest.mark.parametrize("start,max_new", [("carried", 2048),
                                           ("empty", 16)])
def test_insert_blocks(carried, start, max_new):
    """Into the carried map, and into an empty one with max_new capping
    the unique keys (the drop path)."""
    c = carried
    jh = dataclasses.replace(c["jc"].hash, max_new_per_frame=max_new)
    th = dataclasses.replace(c["tc"].hash, max_new_per_frame=max_new)
    kj = J_CAND(_jframe(c), jnp.asarray(c["pose"]),
                                  c["jc"].camera, jh, c["jc"].fusion)
    jm = _jmap(c) if start == "carried" else jho.create(jh)
    tm = _tmap(c) if start == "carried" else tho.create(th, device="cpu")
    mj, nj = J_INSERT(jm, jh, kj, frame_idx=K)
    mt, nt = tho.insert_blocks(tm, th, tt(np.asarray(kj)), frame_idx=K)
    assert int(nt) == int(nj) and int(nj) > 0
    assert_maps_equal(mt, mj, float_atol=0.0)


def test_lookup_keys(carried):
    c = carried
    keys = c["state"]["hmap.keys"]
    present = keys[keys != tho.EMPTY_KEY][:50]
    rng = np.random.default_rng(0)
    q = np.concatenate([present, rng.integers(0, 2**30, 50).astype(np.int32),
                        [tho.EMPTY_KEY]]).astype(np.int32)
    pj, fj = J_LOOKUP(_jmap(c), c["jc"].hash, jnp.asarray(q))
    pt, ft = tho.lookup_keys(_tmap(c), c["tc"].hash, tt(q))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft[:50].all()


def test_lookup_blocks(carried):
    """Block coordinates: present blocks, absent ones, and coordinates
    outside the key range (EMPTY_KEY, never found); any leading shape."""
    from voxelhashing_demo_tpu_torch.geometry import coords as tco

    c = carried
    keys = c["state"]["hmap.keys"]
    present = tco.unpack_block_key(
        tt(keys[keys != tho.EMPTY_KEY][:40]), c["tc"].hash.key_bits).numpy()
    rng = np.random.default_rng(3)
    absent = rng.integers(-300, 300, (39, 3)).astype(np.int32)
    out_of_range = np.array([[4000, 0, 0]], np.int32)
    blocks = np.concatenate([present, absent, out_of_range]).reshape(
        4, 20, 3)
    pj, fj = jax.jit(jho.lookup_blocks, static_argnums=(1,))(
        _jmap(c), c["jc"].hash, jnp.asarray(blocks))
    pt, ft = tho.lookup_blocks(_tmap(c), c["tc"].hash, tt(blocks))
    assert pt.shape == (80,)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert ft[:40].all() and not ft[-1]


def test_compact_visible_and_touch(carried):
    c = carried
    aj = J_COMPACT(_jmap(c), c["jc"].hash, jnp.asarray(c["pose"]),
                             c["jc"].camera, c["jc"].fusion)
    tmap = _tmap(c)
    at = tho.compact_visible(tmap, c["tc"].hash, tt(c["pose"]),
                             c["tc"].camera, c["tc"].fusion)
    assert_active_equal(at, aj)
    assert int(at.count) > 0
    mj = J_TOUCH(_jmap(c), aj, K)
    mt = tho.touch_active(tmap, at, K)
    np.testing.assert_array_equal(mt.last_seen.numpy(),
                                  np.asarray(mj.last_seen))


def test_fuse_frame(carried):
    c = carried
    mj, aj, nj = J_FUSE(_jmap(c), _jframe(c), jnp.asarray(c["pose"]),
                        c["jc"].camera, c["jc"].hash, c["jc"].fusion, K)
    mt, at, nt = tho.fuse_frame(_tmap(c), _tframe(c), tt(c["pose"]),
                                c["tc"].camera, c["tc"].hash, c["tc"].fusion,
                                frame_idx=K)
    assert int(nt) == int(nj)
    assert_active_equal(at, aj)
    assert_maps_equal(mt, mj)


@pytest.mark.parametrize("use_gather,max_active,expect_calls", [
    (True, 2048, 1),      # JAX chunk 128, divisible by 8: kernel path
    (True, 12, 0),        # JAX chunk 12: JAX skips the kernel, so do we
    (False, 2048, 0),
])
def test_integrate_gather_dispatch(carried, monkeypatch, use_gather,
                                   max_active, expect_calls):
    """The window gather runs exactly when the JAX version calls its
    Pallas kernel, and both depth paths give the JAX map."""
    c = carried
    jh = dataclasses.replace(c["jc"].hash, use_pallas_gather=use_gather,
                             max_active=max_active)
    th = dataclasses.replace(c["tc"].hash, use_pallas_gather=use_gather,
                             max_active=max_active)
    calls = []
    real = window_gather.gather_depth_window_reference

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(window_gather, "gather_depth_window_reference",
                        counting)
    aj = J_COMPACT(_jmap(c), jh, jnp.asarray(c["pose"]),
                             c["jc"].camera, c["jc"].fusion)
    mj = J_INTEGRATE(_jmap(c), aj, jh, _jframe(c).depth,
                       jnp.asarray(c["pose"]), c["jc"].camera,
                       c["jc"].fusion)
    at = convert.active_from_numpy(np_tree(aj), device="cpu")
    mt = tho.integrate(_tmap(c), at, th, _tframe(c).depth, tt(c["pose"]),
                       c["tc"].camera, c["tc"].fusion)
    assert len(calls) == expect_calls
    assert_maps_equal(mt, mj)


@pytest.mark.parametrize("min_weight,max_free", [(5.0, 4096), (5.0, 37),
                                                 (1e9, 4096)])
def test_garbage_collect(carried, min_weight, max_free):
    """GC never fires in a 10-frame run (interval 16, min_age 16), so it
    runs here directly, with min_age=0 and a weight bar that frees."""
    c = carried
    mj, nj = J_GC(_jmap(c), c["jc"].hash, min_weight,
                                 max_free, frame_idx=K, min_age=0)
    mt, nt = tho.garbage_collect(_tmap(c), c["tc"].hash, min_weight,
                                 max_free, frame_idx=K, min_age=0)
    assert int(nt) == int(nj) > 0
    assert int(nt) <= max_free
    assert_maps_equal(mt, mj, float_atol=0.0)


def test_garbage_collect_min_age_protects(carried):
    c = carried
    mt, nt = tho.garbage_collect(_tmap(c), c["tc"].hash, 1e9, 4096,
                                 frame_idx=K, min_age=16)
    assert int(nt) == 0


def test_free_marked_random_mask(carried):
    c = carried
    alloc = c["state"]["hmap.ptrs"] != -1
    stale = alloc & (np.random.default_rng(1).random(alloc.shape) < 0.3)
    mj, fj, nj = J_FREE(_jmap(c), c["jc"].hash,
                                  jnp.asarray(stale), 50)
    mt, ft, nt = tho._free_marked(_tmap(c), c["tc"].hash, tt(stale), 50)
    assert int(nt) == int(nj) == 50
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert_maps_equal(mt, mj, float_atol=0.0)


def test_create_matches(carried):
    c = carried
    assert_maps_equal(tho.create(c["tc"].hash, device="cpu"), jho.create(c["jc"].hash),
                      float_atol=0.0)
