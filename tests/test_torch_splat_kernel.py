"""The plain versions of the splat kernels (``ops/splat.py``: K8
``splat_zbuffer``'s ``splat_depth_from_map_reference`` and, with
``surface_filter``, ``splat_raycast_reference``; K9 ``splat_finalize``'s
``finalize_depth_reference``) against the JAX package at 80x60, on numpy
inputs made from a seed (``torch_port_helpers.splat_map_case`` /
``splat_depth_case``): a map whose active set holds FREE_PTR rows inside
``count``, rows that ``band_min`` cuts off (true and stale), rows past
``count``, many voxels a pixel, and surface depths on both sides of the
near and far gates; raw depth buffers with holes along the image border
and in its corners (where the fill pads with +inf and the smooth wraps),
fill rounds 0, 1 and 2, and the multi-device path's ``pmin``-ed buffer.
On CPU tensors the public functions run exactly these plain versions.

Tolerances (PERF.md §2's "Float map / pixel maps" tier): the raw z-buffer
is bit-exact (a scatter-min of z + sdf: the same floats, order
independent), the hole fill exact (minima only); the smoothed depth, the
points and the normals agree within atol 1e-5 (float op order); hit masks
are equal.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py); here their wrappers refuse CPU
tensors.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (splat_depth_case, splat_map_case,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import splat as jsp
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import splat as tsp

torch.set_num_threads(1)

ATOL = 1e-5

J_FROM_MAP = jax.jit(jsp.splat_depth_from_map, static_argnums=(2, 4, 5, 6))
J_FINALIZE = jax.jit(jsp.finalize_depth, static_argnums=(1, 2, 3))

# the gates: the flagship's near / far, and a pair that cuts the wall
# (0.7-1.8 m) on both sides
GATES = {"flagship": None, "near_far": (1.0, 1.45)}


def _cfgs(gates: str, rounds: int | None = None):
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    over = {}
    if GATES[gates] is not None:
        over.update(near=GATES[gates][0], far=GATES[gates][1])
    if rounds is not None:
        over.update(splat_fill_rounds=rounds)
    return (dataclasses.replace(jc, raycast=dataclasses.replace(
                jc.raycast, **over)),
            dataclasses.replace(tc, raycast=dataclasses.replace(
                tc.raycast, **over)))


def _band(cfg) -> float:
    return cfg.raycast.splat_band * cfg.fusion.voxel_size


@pytest.fixture(scope="module")
def case():
    jc, _ = _cfgs("flagship")
    return splat_map_case(jc.fusion.voxel_size, _band(jc), seed=3)


def _jax_inputs(jc, c):
    hmap = jho.create(jc.hash)._replace(
        tsdf=jnp.asarray(c["tsdf"]), weight=jnp.asarray(c["weight"]),
        band_min=jnp.asarray(c["band_min"]))
    active = jho.ActiveSet(blocks=jnp.asarray(c["blocks_padded"]),
                           ptrs=jnp.asarray(c["ptrs_padded"]),
                           count=jnp.asarray(c["count"]))
    return hmap, active, jnp.asarray(c["pose"])


def _port_inputs(tc, c, padded: bool = False):
    hmap = tho.create(tc.hash, device="cpu")._replace(
        tsdf=tt(c["tsdf"]), weight=tt(c["weight"]),
        band_min=tt(c["band_min"]))
    key = "_padded" if padded else ""
    active = tho.ActiveSet(blocks=tt(c["blocks" + key]),
                           ptrs=tt(c["ptrs" + key]), count=tt(c["count"]))
    return hmap, active, tt(c["pose"])


def _voxels_in_band(c, band: float) -> int:
    """Voxels of the live rows inside ``count`` with weight > 0 and
    |sdf| < band (each a candidate z-buffer update)."""
    ptrs = c["ptrs"][:int(c["count"])]
    rows = ptrs[ptrs >= 0]
    ok = (c["weight"][rows] > 0) & (np.abs(c["tsdf"][rows]) < band)
    return int(ok.sum())


@pytest.mark.parametrize("gates", list(GATES))
def test_zbuffer_matches_jax(case, gates):
    """The raw z-buffer (K8's plain version, no band filter) bit for bit:
    FREE_PTR rows inside ``count`` and rows past it add nothing, stale
    rows splat, and many voxels land on one pixel."""
    jc, tc = _cfgs(gates)
    want = np.asarray(J_FROM_MAP(*_jax_inputs(jc, case)[:2], jc.hash,
                                 _jax_inputs(jc, case)[2], jc.camera,
                                 jc.raycast, jc.fusion))
    hmap, active, pose = _port_inputs(tc, case)
    got = tsp.splat_depth_from_map(hmap, active, tc.hash, pose, tc.camera,
                                   tc.raycast, tc.fusion)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert torch.equal(got, tsp.splat_depth_from_map_reference(
        hmap, active, tc.hash, pose, tc.camera, tc.raycast, tc.fusion))
    hits = int((got > 0).sum())
    assert hits > 300
    assert _voxels_in_band(case, _band(tc)) > 3 * hits     # shared pixels
    if GATES[gates] is not None:
        near, far = GATES[gates]
        d = got[got > 0]
        assert bool((d > near).all() and (d < far).all())
        full, _ = _cfgs("flagship")
        wide = np.asarray(J_FROM_MAP(*_jax_inputs(full, case)[:2], full.hash,
                                     _jax_inputs(full, case)[2], full.camera,
                                     full.raycast, full.fusion))
        assert ((wide > 0) & (wide <= near)).any()       # gated off: near
        assert ((wide > 0) & (wide >= far)).any()        # and far


@pytest.mark.parametrize("gates", list(GATES))
def test_splat_raycast_matches_jax(case, gates):
    """The whole prediction (``surface_filter`` then the z-buffer and the
    finalize pass) on the set padded past ``count``, as compact_visible
    pads it (``surface_filter`` reads every row): the filter cuts the
    stale rows, so the result differs from the unfiltered buffer's."""
    jc, tc = _cfgs(gates)
    jh, ja, jp = _jax_inputs(jc, case)
    want = jsp.splat_raycast(jh, ja, jc.hash, jp, jc.camera, jc.raycast,
                             jc.fusion)
    hmap, active, pose = _port_inputs(tc, case, padded=True)
    got = tsp.splat_raycast(hmap, active, tc.hash, pose, tc.camera,
                            tc.raycast, tc.fusion)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    for f in ("depth", "points", "normals"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)
    filt = tsp.surface_filter(hmap, active, _band(tc))
    jfilt = jsp.surface_filter(jh, ja, _band(jc))
    np.testing.assert_array_equal(filt.ptrs.numpy(), np.asarray(jfilt.ptrs))
    assert int(filt.count) == int(jfilt.count) < int(case["count"])
    unfiltered = tsp.finalize_depth(
        tsp.splat_depth_from_map(hmap, active, tc.hash, pose, tc.camera,
                                 tc.raycast, tc.fusion),
        tc.camera, tc.raycast, tc.fusion)
    assert not torch.equal(unfiltered.depth, got.depth)
    assert got.hit.float().mean() > 0.2


def _shifts(d, pad):
    """{(dy, dx): d[y - dy, x - dx]} over the 3x3 taps; ``pad`` None
    wraps, else the value outside the image."""
    out = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if pad is None:
                out[dy, dx] = np.roll(d, (dy, dx), axis=(0, 1))
            else:
                p = np.pad(d, 1, constant_values=pad)
                out[dy, dx] = p[1 - dy:1 - dy + d.shape[0],
                                1 - dx:1 - dx + d.shape[1]]
    return out


def _fill_wrapped(d, rounds):
    """The hole fill with a window that wraps (not the reference's)."""
    for _ in range(rounds):
        big = np.where(d > 0, d, np.inf)
        neigh = np.min(np.stack(list(_shifts(big, None).values())), axis=0)
        d = np.where(d > 0, d, np.where(np.isfinite(neigh), neigh, 0.0))
    return d.astype(np.float32)


def _smooth_zero_padded(d, sigma):
    """The edge-preserving smooth with 0 outside the image (not the
    reference's wrap)."""
    acc = np.zeros_like(d)
    cnt = np.zeros_like(d)
    for n in _shifts(d, 0.0).values():
        ok = (n > 0) & (np.abs(n - d) < sigma)
        acc += np.where(ok, n, 0.0)
        cnt += ok
    return np.where((d > 0) & (cnt > 0), acc / np.maximum(cnt, 1.0), d)


@pytest.mark.parametrize("pmin", [False, True])
@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_finalize_matches_jax(rounds, pmin):
    """The finalize pass on a buffer with holes at the border and in the
    corners: the fill pads with +inf (exact), the smooth wraps."""
    jc, tc = _cfgs("flagship", rounds)
    cam = tc.camera
    raw = splat_depth_case(cam.height, cam.width, seed=rounds, pmin=pmin)
    want = J_FINALIZE(jnp.asarray(raw), jc.camera, jc.raycast, jc.fusion)
    got = tsp.finalize_depth(tt(raw), tc.camera, tc.raycast, tc.fusion)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    for f in ("depth", "points", "normals"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=ATOL,
                                   err_msg=f)
    filled = tsp._min_fill(tt(raw), rounds)
    np.testing.assert_array_equal(
        filled.numpy(), np.asarray(jsp._min_fill(jnp.asarray(raw), rounds)))
    # the case shows both border rules: a fill that wrapped, and a smooth
    # that did not, would give other maps
    sigma = tc.raycast.splat_smooth_sigma * tc.fusion.voxel_size
    if rounds:
        assert not np.array_equal(_fill_wrapped(raw, rounds), filled.numpy())
    smooth = np.asarray(jsp._edge_preserving_smooth(
        jnp.asarray(filled.numpy()), sigma))
    assert not np.allclose(_smooth_zero_padded(filled.numpy(), sigma),
                           smooth, atol=ATOL)
    assert got.hit.float().mean() > 0.5


def test_public_functions_run_plain_on_cpu(case):
    """On CPU tensors each public function returns its plain version's
    result; the kernels' wrappers refuse CPU tensors (the kernels run only
    on the card)."""
    _, tc = _cfgs("flagship")
    hmap, active, pose = _port_inputs(tc, case)
    args = (hmap, active, tc.hash, pose, tc.camera, tc.raycast, tc.fusion)
    a, b = tsp.splat_raycast(*args), tsp.splat_raycast_reference(*args)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    raw = tt(splat_depth_case(tc.camera.height, tc.camera.width))
    a = tsp.finalize_depth(raw, tc.camera, tc.raycast, tc.fusion)
    b = tsp.finalize_depth_reference(raw, tc.camera, tc.raycast, tc.fusion)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    before = (tsp.LAUNCHES_ZBUFFER, tsp.LAUNCHES_FINALIZE)
    with pytest.raises(ValueError, match="CUDA device"):
        tsp._launch_zbuffer(*args, band_filter=True)
    with pytest.raises(ValueError, match="CUDA device"):
        tsp._launch_finalize(raw, tc.camera, tc.raycast, tc.fusion)
    assert (tsp.LAUNCHES_ZBUFFER, tsp.LAUNCHES_FINALIZE) == before


def test_kernel_arguments_match_the_sources():
    """Each splat kernel's ctypes argument list (kernels.KERNELS), and K9's
    instantiation report's, has as many entries as its C entry point in
    csrc/splat.cu has parameters, the pointers where the C function takes
    pointers."""
    src = (Path(kernels.SRC_DIR) / "splat.cu").read_text()
    for name in ("splat_zbuffer", "splat_finalize",
                 "splat_finalize_info"):
        assert kernels.source_of(name) == "splat"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)


def test_wrapper_plans_refuse_what_the_kernels_do_not_take():
    """The plans raise on fill rounds outside 0..MAX_FILL_ROUNDS, a
    negative near plane and blocks of more than MAX_VOXELS voxels."""
    _, tc = _cfgs("flagship")
    rc = tc.raycast
    tsp._finalize_plan(tc.camera, dataclasses.replace(
        rc, splat_fill_rounds=tsp.MAX_FILL_ROUNDS), tc.fusion)
    with pytest.raises(ValueError, match="fill rounds"):
        tsp._finalize_plan(tc.camera, dataclasses.replace(
            rc, splat_fill_rounds=tsp.MAX_FILL_ROUNDS + 1), tc.fusion)
    with pytest.raises(ValueError, match="near"):
        tsp._zbuffer_plan(tc.hash, tc.camera,
                          dataclasses.replace(rc, near=-0.1), tc.fusion)
    with pytest.raises(ValueError, match="voxels a block"):
        tsp._zbuffer_plan(dataclasses.replace(tc.hash, block_size=16),
                          tc.camera, rc, tc.fusion)


def test_finalize_tables_are_kept_by_identity():
    """K9's host tables are built once a configuration and kept by the
    objects' identity: the same table for the same objects, a new one for
    an equal copy; the fill rounds are the plan's and the floats its
    constants as float32."""
    _, tc = _cfgs("flagship")
    cam, rc, fus = tc.camera, tc.raycast, tc.fusion
    rounds, floats = tsp._finalize_tables(cam, rc, fus)
    assert tsp._finalize_tables(cam, rc, fus)[1] is floats
    plan = tsp._finalize_plan(cam, rc, fus)
    assert rounds == plan[0] == rc.splat_fill_rounds
    assert list(floats) == [float(np.float32(x)) for x in plan[1:]]
    assert tsp._finalize_tables(cam, dataclasses.replace(rc), fus)[1] \
        is not floats

