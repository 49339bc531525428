"""De-integration in the PyTorch port (``integrate(sign=-1, max_born)``,
``defuse_frame``, ``make_reintegrate``) against the JAX package.

Both packages start from one JAX map (two frames of the orbit sequence
fused at their ground-truth poses, tiny flagship-gather config, carried
across with ``convert``) and get the same frame and the JAX pose, so only
the update itself is compared.

Tolerances: inside the port ``fuse(A); fuse(B); defuse(B)`` returns A's map
with the JAX test's own bounds (weight 1e-4, tsdf 5e-4 on live voxels);
rows born after the frame are untouched bit for bit; against JAX tsdf
and weight agree within atol 1e-5 (the inverse update
``(old w_old - sdf w_new) / w_rem`` contracts to a fused multiply-add in
one package and not the other), band_min within 1e-5 on every row whose
weight > 0 pattern is the same in both (at most 1 % of rows differ in it,
by a remainder below 1e-5), integer state is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_sequence, np_tree,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu.models import keyframe_slam as jkf
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

ATOL = 1e-5
INT_FIELDS = ("keys", "ptrs", "bucket_fill", "free_list", "free_top",
              "last_seen", "born")

J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_FUSE = jax.jit(jho.fuse_frame, static_argnums=(3, 4, 5))
J_DEFUSE = jax.jit(jho.defuse_frame, static_argnums=(3, 4, 5))
J_COMPACT = jax.jit(jho.compact_visible, static_argnums=(1, 3, 4))
J_INTEGRATE = jax.jit(jho.integrate, static_argnums=(2, 5, 6),
                      static_argnames=("sign",))


@pytest.fixture(scope="module")
def setup():
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    depths, poses = jax_sequence(jc.camera, 10)
    # frames 0 and 6: overlapping views with rows only the later one sees
    ia, ib = 0, 6
    fa = J_PRE(jnp.asarray(depths[ia]), jc.camera, jc.frontend)
    fb = J_PRE(jnp.asarray(depths[ib]), jc.camera, jc.frontend)
    only_a, _, _ = J_FUSE(jho.create(jc.hash), fa, jnp.asarray(poses[ia]),
                          jc.camera, jc.hash, jc.fusion, frame_idx=0)
    both, _, _ = J_FUSE(only_a, fb, jnp.asarray(poses[ib]), jc.camera,
                        jc.hash, jc.fusion, frame_idx=1)
    return dict(jc=jc, tc=tc, fa=fa, fb=fb, pa=poses[ia], pb=poses[ib],
                only_a=np_tree(only_a), both=np_tree(both),
                depth_b=depths[ib])


def _tmap(d):
    return convert.hashmap_from_numpy(d, device="cpu")


def _jmap(d):
    return jho.HashMap(**{f: jnp.asarray(d[f]) for f in jho.HashMap._fields})


def _tframe(f):
    return tpre.Frame(*(tt(x) for x in f))


def _rows_by_key(keys, ptrs):
    occ = ptrs >= 0
    return {int(k): int(p) for k, p in zip(keys[occ], ptrs[occ])}


def _assert_maps_close(t_map, j_map, atol=ATOL):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(t_map, f).numpy(), np.asarray(getattr(j_map, f)), f)
    for f in ("tsdf", "weight"):
        np.testing.assert_allclose(
            getattr(t_map, f).numpy(), np.asarray(getattr(j_map, f)),
            atol=atol, err_msg=f)
    # band_min is a minimum over the voxels with weight > 0: a voxel whose
    # weight comes back as 0 in one package and as a last-ulp remainder in
    # the other (both < atol, checked above) enters one minimum only.  Such
    # rows are rare; the others agree.
    tw, jw = t_map.weight.numpy(), np.asarray(j_map.weight)
    flipped = ((tw > 0) != (jw > 0)).any(axis=1)
    assert flipped.mean() < 0.01, flipped.sum()
    np.testing.assert_allclose(
        t_map.band_min.numpy()[~flipped],
        np.asarray(j_map.band_min)[~flipped], atol=atol, err_msg="band_min")


def test_defuse_is_exact_inverse_inside_port(setup):
    """fuse(A); fuse(B); defuse(B) == fuse(A), voxel for voxel, all in the
    port (bounds of tests/test_reintegration.py)."""
    s = setup
    tc = s["tc"]
    only_a = tho.fuse_frame(
        tho.create(tc.hash, device="cpu"), _tframe(s["fa"]), tt(s["pa"]),
        tc.camera, tc.hash, tc.fusion, frame_idx=0)[0]
    both = tho.fuse_frame(
        tho.create(tc.hash, device="cpu"), _tframe(s["fa"]), tt(s["pa"]),
        tc.camera, tc.hash, tc.fusion, frame_idx=0)[0]
    both = tho.fuse_frame(both, _tframe(s["fb"]), tt(s["pb"]), tc.camera,
                          tc.hash, tc.fusion, frame_idx=1)[0]
    undone = tho.defuse_frame(both, _tframe(s["fb"]), tt(s["pb"]),
                              tc.camera, tc.hash, tc.fusion, frame_born=1)
    rows_a = _rows_by_key(only_a.keys.numpy(), only_a.ptrs.numpy())
    rows_u = _rows_by_key(undone.keys.numpy(), undone.ptrs.numpy())
    t_a, w_a = only_a.tsdf.numpy(), only_a.weight.numpy()
    t_u, w_u = undone.tsdf.numpy(), undone.weight.numpy()
    bm = undone.band_min.numpy()
    assert set(rows_a) <= set(rows_u)
    assert len(rows_u) > len(rows_a)       # B allocated rows of its own
    for key, pa in rows_a.items():
        pu = rows_u[key]
        np.testing.assert_allclose(w_u[pu], w_a[pa], atol=1e-4)
        live = w_a[pa] > 0
        np.testing.assert_allclose(t_u[pu][live], t_a[pa][live], atol=5e-4)
        assert np.abs(w_u[pu][~live]).max(initial=0.0) < 1e-4
    for key, pu in rows_u.items():
        if key not in rows_a:
            assert w_u[pu].max() < 1e-4
        live = w_u[pu] > 0
        expect = np.abs(t_u[pu][live]).min() if live.any() else np.inf
        assert bm[pu] == np.float32(expect)


def test_born_gate_skips_younger_rows(setup):
    """Rows allocated after the defused frame stay bit for bit."""
    s = setup
    tc = s["tc"]
    hmap = _tmap(s["both"])
    before_t = hmap.tsdf.numpy().copy()
    before_w = hmap.weight.numpy().copy()
    # defuse frame A "as of time 0": rows born at 1 (frame B's) are skipped
    undone = tho.defuse_frame(hmap, _tframe(s["fa"]), tt(s["pa"]),
                              tc.camera, tc.hash, tc.fusion, frame_born=0)
    born = undone.born.numpy()
    young = np.zeros(born.shape, bool)
    young[undone.ptrs.numpy()[undone.ptrs.numpy() >= 0]] = True
    young &= born > 0
    assert young.any()
    np.testing.assert_array_equal(undone.tsdf.numpy()[young],
                                  before_t[young])
    np.testing.assert_array_equal(undone.weight.numpy()[young],
                                  before_w[young])
    old = ~young
    assert (undone.weight.numpy()[old] != before_w[old]).any()


def test_defuse_frame_matches_jax(setup):
    s = setup
    jc, tc = s["jc"], s["tc"]
    j_out = J_DEFUSE(_jmap(s["both"]), s["fb"], jnp.asarray(s["pb"]),
                     jc.camera, jc.hash, jc.fusion, frame_born=1)
    t_out = tho.defuse_frame(_tmap(s["both"]), _tframe(s["fb"]),
                             tt(s["pb"]), tc.camera, tc.hash, tc.fusion,
                             frame_born=1)
    _assert_maps_close(t_out, j_out)
    # something was removed
    assert float(np.abs(np.asarray(j_out.weight)
                        - s["both"]["weight"]).max()) > 0.5


@pytest.mark.parametrize("sign,max_born", [(1, 0), (-1, 0), (-1, None)])
def test_integrate_sign_and_born_match_jax(setup, sign, max_born):
    s = setup
    jc, tc = s["jc"], s["tc"]
    jm, tm = _jmap(s["both"]), _tmap(s["both"])
    ja = J_COMPACT(jm, jc.hash, jnp.asarray(s["pb"]), jc.camera, jc.fusion)
    ta = tho.compact_visible(tm, tc.hash, tt(s["pb"]), tc.camera, tc.fusion)
    jb = None if max_born is None else jnp.int32(max_born)
    j_out = J_INTEGRATE(jm, ja, jc.hash, s["fb"].depth,
                        jnp.asarray(s["pb"]), jc.camera, jc.fusion,
                        sign=sign, max_born=jb)
    t_out = tho.integrate(tm, ta, tc.hash, tt(s["fb"].depth), tt(s["pb"]),
                          tc.camera, tc.fusion, sign=sign, max_born=max_born)
    _assert_maps_close(t_out, j_out)


def test_make_reintegrate_and_fuse_only_match_jax(setup):
    """One move (de-integrate at the old pose, re-integrate at a pose
    2 cm / 1 degree away) and one fuse-only step, through the factories
    ``KeyframeSLAM`` uses; the returned visible-set count is equal."""
    from voxelhashing_demo_tpu.geometry import se3 as jse3

    s = setup
    jc, tc = s["jc"], s["tc"]
    tw = np.array([0.02, -0.01, 0.015, 0.0, np.deg2rad(1.0), 0.0],
                  np.float32)
    T_new = (np.asarray(jse3.exp(jnp.asarray(tw))) @ s["pb"]).astype(
        np.float32)
    d = s["depth_b"]
    j_out, j_cnt = jkf.make_reintegrate(jc)(
        _jmap(s["both"]), jnp.asarray(d), jnp.asarray(s["pb"]),
        jnp.asarray(T_new), jnp.int32(1))
    t_out, t_cnt = tkf.make_reintegrate(tc)(
        _tmap(s["both"]), tt(d.astype(np.int32)), tt(s["pb"]), tt(T_new), 1)
    assert int(t_cnt) == int(j_cnt)
    _assert_maps_close(t_out, j_out)

    j_f = jkf.make_fuse_only(jc)(_jmap(s["only_a"]), jnp.asarray(d),
                                 jnp.asarray(s["pb"]), jnp.int32(1))
    t_f = tkf.make_fuse_only(tc)(_tmap(s["only_a"]),
                                 tt(d.astype(np.int32)), tt(s["pb"]), 1)
    _assert_maps_close(t_f, j_f)
    _assert_maps_close(t_f, _jmap(s["both"]))

    j_m = jkf.make_render_model(jc)(j_f, jnp.asarray(s["pb"]))
    t_m = tkf.make_render_model(tc)(t_f, tt(s["pb"]))
    jd, td = np.asarray(j_m.depth), t_m.depth.numpy()
    np.testing.assert_array_equal(jd > 0, td > 0)
    np.testing.assert_allclose(td, jd, atol=1e-4)
