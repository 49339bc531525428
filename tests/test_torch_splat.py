"""PyTorch port of ops/splat.py and ops/raycast.model_frame against the
JAX package, on the JAX map after 5 frames of the orbit sequence (tiny
flagship-gather config) carried across, rendered from the JAX pose.

Tolerances: the surface filter (an integer compaction) is bit-exact; the
raw splat depth is bit-exact (a scatter-min of z + sdf: same floats, order
independent); hole fill is exact (minima only); the smoothed depth, points
and normals agree within atol 1e-5 (float op order); hit masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_sequence, np_tree,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import raycast as jrc
from voxelhashing_demo_tpu.ops import splat as jsp
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import raycast as trc
from voxelhashing_demo_tpu_torch.ops import splat as tsp

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, _ = jax_sequence(jc.camera, 10)
    state = jhs.create(jc)
    for d in depths[:5]:
        state, _ = jhs.step(state, jnp.asarray(d), jc)
    active = jax.jit(jho.compact_visible, static_argnums=(1, 3, 4))(
        state.hmap, jc.hash, state.pose, jc.camera, jc.fusion)
    return dict(jc=jc, tc=tc, hmap=state.hmap, active=active,
                pose=np.asarray(state.pose),
                np_map=np_tree(state.hmap), np_active=np_tree(active))


def _t(c):
    return (convert.hashmap_from_numpy(c["np_map"], device="cpu"),
            convert.active_from_numpy(c["np_active"], device="cpu"))


def test_surface_filter_exact(carried):
    c = carried
    band = c["jc"].raycast.splat_band * c["jc"].fusion.voxel_size
    sj = jsp.surface_filter(c["hmap"], c["active"], band)
    tmap, tact = _t(c)
    st = tsp.surface_filter(tmap, tact, band)
    for f in ("blocks", "ptrs", "count"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    assert 0 < int(st.count) < int(tact.count)


def test_splat_depth_exact(carried):
    c = carried
    jc, tc = c["jc"], c["tc"]
    dj = jax.jit(jsp.splat_depth_from_map, static_argnums=(2, 4, 5, 6))(
        c["hmap"], c["active"], jc.hash, jnp.asarray(c["pose"]), jc.camera,
        jc.raycast, jc.fusion)
    tmap, tact = _t(c)
    dt = tsp.splat_depth_from_map(tmap, tact, tc.hash, tt(c["pose"]),
                                  tc.camera, tc.raycast, tc.fusion)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (dt > 0).float().mean() > 0.3


def test_splat_raycast_and_model_frame(carried):
    c = carried
    jc, tc = c["jc"], c["tc"]
    oj = jsp.splat_raycast(c["hmap"], c["active"], jc.hash,
                           jnp.asarray(c["pose"]), jc.camera, jc.raycast,
                           jc.fusion)
    tmap, tact = _t(c)
    ot = tsp.splat_raycast(tmap, tact, tc.hash, tt(c["pose"]), tc.camera,
                           tc.raycast, tc.fusion)
    np.testing.assert_array_equal(ot.hit.numpy(), np.asarray(oj.hit))
    for f in ("depth", "points", "normals"):
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oj, f)), atol=ATOL,
                                   err_msg=f)
    fj, ft = jrc.model_frame(oj), trc.model_frame(ot)
    assert ft._fields == fj._fields
    np.testing.assert_array_equal(ft.depth.numpy(), ot.depth.numpy())


@pytest.mark.parametrize("rounds", [1, 2])
def test_min_fill_and_smooth(rounds):
    rng = np.random.default_rng(rounds)
    depth = (rng.random((30, 41)) * 2 + 0.5).astype(np.float32)
    depth[rng.random(depth.shape) < 0.4] = 0.0
    depth[0, :] = 0.0
    fj = np.asarray(jsp._min_fill(jnp.asarray(depth), rounds))
    ft = tsp._min_fill(tt(depth), rounds).numpy()
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(
        tsp._edge_preserving_smooth(tt(fj), 0.06).numpy(),
        np.asarray(jsp._edge_preserving_smooth(jnp.asarray(fj), 0.06)),
        atol=ATOL)


def test_render_pose_without_blocks(carried):
    """An empty visible set splats nothing (hit fraction 0)."""
    c = carried
    tc = c["tc"]
    tmap = tho.create(tc.hash, device="cpu")
    act = tho.compact_visible(tmap, tc.hash, tt(c["pose"]), tc.camera,
                              tc.fusion)
    out = tsp.splat_raycast(tmap, act, tc.hash, tt(c["pose"]), tc.camera,
                            tc.raycast, tc.fusion)
    assert int(act.count) == 0 and not out.hit.any()
