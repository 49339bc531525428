"""The plain versions of the fuse kernels (``ops/hash_ops.py``: K6
``compact_visible``'s ``compact_visible_reference``; K7
``integrate_rows``'s ``integrate_reference`` with ``touch_active`` for the
stamp) against the JAX package on numpy maps made from a seed
(``table_case``, ``rows_case``): a table of blocks around the camera, so
that entries lie on every face of the frustum (the near and far planes,
u and v at the z-adaptive margins), entries whose key is set but whose
ptr is FREE_PTR, more visible entries than ``max_active``; map rows with
random tsdf, weight (some at the weight cap), born, last_seen and a
band_min that no row's voxels give.  Two cameras: the 80x60 test camera,
and a 320x48 strip with fx 600 where blocks 0.2-0.5 m away span more
than the window gather's 256 px, so the window drops voxels.  Both gather
modes, both signs (``max_born`` gating rows out of de-integration), the
stamp against ``touch_active``.  On CPU tensors the public functions run
exactly these plain versions.

Tolerances (PERF.md §2's tiers): the visible set, its order and count and
the integer map state (born, last_seen) are bit-exact; the float rows
(tsdf, weight, band_min) agree within atol 1e-5 (float op order).  The
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
from voxelhashing_demo_tpu_torch import kernels
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.ops import window_gather as twg

torch.set_num_threads(1)

ATOL = 1e-5
INT_FIELDS = ("born", "last_seen")
FLOAT_FIELDS = ("tsdf", "weight", "band_min")
STAMP, MAX_BORN = 9, 4
# a strip camera whose near blocks span more than the 256 px window
WIDE = dict(width=320, height=48, fx=600.0, fy=600.0, cx=159.5, cy=23.5)

J_COMPACT = jax.jit(jho.compact_visible, static_argnums=(1, 3, 4))
J_INTEGRATE = jax.jit(jho.integrate, static_argnums=(2, 5, 6),
                      static_argnames=("sign",))
J_TOUCH = jax.jit(jho.touch_active)


def _cfgs(cam: str = "tiny", max_active: int = 2048, gather: bool = True):
    """(JAX config, port config): the tiny flagship gather config, its
    camera (the 80x60 one or WIDE) and max_active replaced."""
    out = []
    for pkg in ("jax", "torch"):
        c = tiny_flagship_gather_config(pkg)
        camera = c.camera if cam == "tiny" else dataclasses.replace(
            c.camera, **WIDE)
        out.append(dataclasses.replace(c, camera=camera, hash=dataclasses.
                                       replace(c.hash, max_active=max_active,
                                               use_pallas_gather=gather)))
    return tuple(out)


def _pose() -> np.ndarray:
    """T_wc: a camera near the origin looking along +z, turned 4 degrees."""
    ang = np.deg2rad(4.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                 [-np.sin(ang), 0.0, np.cos(ang)]]
    T[:3, 3] = [0.03, -0.02, 0.01]
    return T


def _grid(x, y, z) -> np.ndarray:
    return np.stack(np.meshgrid(np.arange(*x), np.arange(*y), np.arange(*z),
                                indexing="ij"), -1).reshape(-1, 3)


NEAR_BOX = ((-4, 4), (-1, 1), (1, 4))    # blocks 0.16-0.64 m ahead


def table_case(hcfg, seed: int, n_entries: int = 3000, n_keyed_free: int = 40,
               near: bool = False):
    """numpy (keys, ptrs) of a (T,) table: ``n_entries`` blocks drawn from
    a box around the camera (x, y in +-3.8 m, z from -0.5 to 4.8 m, in
    block units of 0.16 m) in random slots with distinct ptrs, and
    ``n_keyed_free`` more whose key is set but whose ptr is FREE_PTR.
    With ``near``, the first of them (in the lowest slots, so a capped
    set keeps them) are every block of NEAR_BOX."""
    rng = np.random.default_rng(seed)
    box = _grid((-24, 24), (-18, 18), (-3, 30))
    n = n_entries + n_keyed_free
    if near:
        close = _grid(*NEAR_BOX)
        rest = box[~(np.abs(box[:, None, :] - close[None]).sum(-1) == 0)
                   .any(1)]
        blocks = np.concatenate([close, rest[rng.choice(
            len(rest), n - len(close), replace=False)]])
    else:
        blocks = box[rng.choice(len(box), n, replace=False)]
    bias = 1 << (hcfg.key_bits - 1)
    b = blocks + bias
    packed = (b[:, 0] << (2 * hcfg.key_bits)) | (b[:, 1] << hcfg.key_bits) \
        | b[:, 2]
    keys = np.full(hcfg.table_size, tho.EMPTY_KEY, np.int32)
    ptrs = np.full(hcfg.table_size, tho.FREE_PTR, np.int32)
    slots = rng.choice(hcfg.table_size, n, replace=False)
    if near:
        low = np.sort(slots)
        slots = np.concatenate([low[:len(close)],
                                rng.permutation(low[len(close):])])
    keys[slots] = packed
    ptrs[slots[:n_entries]] = rng.permutation(hcfg.num_blocks)[:n_entries]
    return keys, ptrs


def rows_case(hcfg, seed: int) -> dict:
    """numpy map rows: tsdf in +-0.12 m; weight 1-6 with a third 0 and
    every ninth live row at 254.75 (the cap is 255); born 0-8; last_seen
    0-20; band_min uniform in [0, 1), which no row's voxels give."""
    rng = np.random.default_rng(seed)
    N, V = hcfg.num_blocks, hcfg.voxels_per_block
    weight = rng.integers(1, 7, (N, V)).astype(np.float32)
    weight[rng.random((N, V)) < 0.33] = 0.0
    weight[::9] = np.where(weight[::9] > 0, 254.75, 0.0)
    return {"tsdf": rng.uniform(-0.12, 0.12, (N, V)).astype(np.float32),
            "weight": weight,
            "born": rng.integers(0, 9, N).astype(np.int32),
            "last_seen": rng.integers(0, 21, N).astype(np.int32),
            "band_min": rng.random(N).astype(np.float32)}


def depth_case(cam, seed: int) -> np.ndarray:
    """Metric depth (H, W) float32 of ``depth_scene`` (0 where none)."""
    d = depth_scene(cam.height, cam.width, seed).astype(np.float32) / 5000.0
    d[d > cam.depth_max] = 0.0
    return d


def _maps(jc, case: dict):
    """The same map in both packages (JAX arrays; CPU tensors)."""
    jm = jho.create(jc.hash)._replace(**{k: jnp.asarray(v)
                                         for k, v in case.items()})
    tm = tho.HashMap(**{f: tt(np.asarray(getattr(jm, f)))
                        for f in tho.HashMap._fields})
    return jm, tm


def _assert_active_equal(ta, ja):
    for f in ("blocks", "ptrs", "count"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)


def _assert_rows_equal(tm, jm):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), atol=ATOL,
                                   err_msg=f)


def _frustum_margins(keys, ptrs, hcfg, cam, fusion, T_wc) -> dict:
    """How many allocated entries lie within 0.1 m of the near / far
    planes and within 2 px of a z-adaptive pixel margin (float64)."""
    live = ptrs != tho.FREE_PTR
    bias, mask = 1 << (hcfg.key_bits - 1), (1 << hcfg.key_bits) - 1
    k = keys[live].astype(np.int64)
    blocks = np.stack([(k >> (2 * hcfg.key_bits)) & mask,
                       (k >> hcfg.key_bits) & mask, k & mask], -1) - bias
    half = 0.5 * hcfg.block_size * fusion.voxel_size
    pc = (blocks * hcfg.block_size * fusion.voxel_size + half
          - T_wc[:3, 3]) @ T_wc[:3, :3].astype(np.float64)
    z = pc[:, 2]
    u = pc[:, 0] / np.maximum(z, 1e-6) * cam.fx + cam.cx
    v = pc[:, 1] / np.maximum(z, 1e-6) * cam.fy + cam.cy
    zm = np.maximum(z, 0.05)
    mu = 4.0 + half * 1.7320508 * cam.fx / zm
    mv = 4.0 + half * 1.7320508 * cam.fy / zm
    inside = (z > 0.3) & (z < cam.depth_max)
    return {"near": int((np.abs(z - (cam.depth_min - 2 * half)) < 0.1).sum()),
            "far": int((np.abs(z - (cam.depth_max + 2 * half)) < 0.1).sum()),
            "u": int((inside & ((np.abs(u + mu) < 2)
                                | (np.abs(u - cam.width - mu) < 2))).sum()),
            "v": int((inside & ((np.abs(v + mv) < 2)
                                | (np.abs(v - cam.height - mv) < 2))).sum())}


@pytest.mark.parametrize("cam,max_active", [("tiny", 2048), ("tiny", 256),
                                            ("wide", 2048)])
def test_compact_visible_matches_jax(cam, max_active):
    """The visible set, its order and count equal the JAX package's, the
    table's entries lying on every face of the frustum; with max_active
    256 the set overflows and both keep the first 256 in table order."""
    jc, tc = _cfgs(cam, max_active)
    keys, ptrs = table_case(tc.hash, seed=1)
    T_wc = _pose()
    jm, tm = _maps(jc, {"keys": keys, "ptrs": ptrs})
    aj = J_COMPACT(jm, jc.hash, jnp.asarray(T_wc), jc.camera, jc.fusion)
    at = tho.compact_visible_reference(tm, tc.hash, tt(T_wc), tc.camera,
                                       tc.fusion)
    _assert_active_equal(at, aj)
    n = int(at.count)
    assert 0 < n <= max_active
    assert bool((at.ptrs[n:] == tho.FREE_PTR).all())
    assert not bool(at.blocks[n:].any())
    margins = _frustum_margins(keys, ptrs, tc.hash, tc.camera, tc.fusion,
                               T_wc)
    assert min(margins.values()) > 0, margins
    full = tho.compact_visible_reference(
        tm, dataclasses.replace(tc.hash, max_active=4096), tt(T_wc),
        tc.camera, tc.fusion)
    if max_active == 256:
        assert int(full.count) > 256
    assert torch.equal(at.ptrs[:n], full.ptrs[:n])
    keyed_free = (keys != tho.EMPTY_KEY) & (ptrs == tho.FREE_PTR)
    assert keyed_free.sum() == 40
    assert not np.isin(keys[keyed_free], keys[ptrs != tho.FREE_PTR]).any()


def _integrate_both(cam, gather, sign, seed=2):
    """(port map, JAX map, port active set, the map before) after one
    update of the case's visible rows: the port's ``integrate`` (with
    the stamp for sign +1) on CPU tensors against the JAX package's
    ``touch_active`` and ``integrate``."""
    jc, tc = _cfgs(cam, 256, gather)
    keys, ptrs = table_case(tc.hash, seed=seed, near=cam == "wide")
    case = {"keys": keys, "ptrs": ptrs, **rows_case(tc.hash, seed)}
    depth = depth_case(tc.camera, seed)
    T_wc = _pose()
    jm, tm = _maps(jc, case)
    aj = J_COMPACT(jm, jc.hash, jnp.asarray(T_wc), jc.camera, jc.fusion)
    at = tho.compact_visible(tm, tc.hash, tt(T_wc), tc.camera, tc.fusion)
    _assert_active_equal(at, aj)
    max_born = MAX_BORN if sign < 0 else None
    stamp = STAMP if sign > 0 else None
    if stamp is not None:
        jm = J_TOUCH(jm, aj, stamp)
    jm = J_INTEGRATE(jm, aj, jc.hash, jnp.asarray(depth), jnp.asarray(T_wc),
                     jc.camera, jc.fusion, sign=sign,
                     max_born=None if max_born is None
                     else jnp.int32(max_born))
    before = {f: getattr(tm, f).clone() for f in FLOAT_FIELDS + INT_FIELDS}
    counts = (tho.LAUNCHES_COMPACT, tho.LAUNCHES_INTEGRATE)
    tm = tho.integrate(tm, at, tc.hash, tt(depth), tt(T_wc), tc.camera,
                       tc.fusion, sign=sign, max_born=max_born, stamp=stamp)
    assert (tho.LAUNCHES_COMPACT, tho.LAUNCHES_INTEGRATE) == counts
    return tm, jm, at, before, tc, depth, T_wc


@pytest.mark.parametrize("cam,gather,sign", [
    ("tiny", True, 1), ("tiny", True, -1), ("tiny", False, 1),
    ("tiny", False, -1), ("wide", True, 1), ("wide", False, -1)])
def test_integrate_matches_jax(cam, gather, sign):
    """The update (both gather modes, both signs) equals the JAX
    package's on every field, the stamp included; the case holds rows at
    the weight cap, valid rows that take no sample (their band_min is
    rewritten from the old voxels), rows the max_born gate cuts out of a
    de-integration and, on the strip camera, voxels the window drops."""
    tm, jm, at, before, tc, depth, T_wc = _integrate_both(cam, gather, sign)
    _assert_rows_equal(tm, jm)
    n = int(at.count)
    rows = at.ptrs[:n].long()
    changed = (tm.weight[rows] != before["weight"][rows]).any(dim=1)
    assert 0 < int(changed.sum()) < n
    old_w = before["weight"][rows]
    if sign > 0:
        assert bool((tm.weight[rows] == tc.fusion.max_weight).any())
        assert bool((tm.last_seen[rows] == STAMP).all())
    else:
        gated = before["born"][rows] > MAX_BORN
        assert bool(gated.any()) and not bool(changed[gated].any())
        assert torch.equal(tm.last_seen, before["last_seen"])
    # a valid row without a sample keeps its voxels and gets band_min anew
    quiet = ~changed
    want = torch.where(old_w > 0, before["tsdf"][rows].abs(),
                       float("inf")).amin(dim=1)
    if sign < 0:
        tmax = tc.fusion.truncation + tc.fusion.trunc_scale * \
            tc.camera.depth_max
        want = torch.where(old_w > 0, before["tsdf"][rows].clamp(
            -tmax, tmax).abs(), float("inf")).amin(dim=1)
    assert bool(quiet.any())
    assert torch.equal(tm.band_min[rows][quiet], want[quiet])
    assert not torch.equal(before["band_min"][rows][quiet], want[quiet])
    if cam == "wide" and gather:
        _, v, u, in_img, _ = tho.project_rows(
            at.blocks[:n], at.ptrs[:n], tc.hash,
            torch.linalg.inv(tt(T_wc)), tc.camera, tc.fusion)
        _, cov = twg.gather_depth_window_reference(tt(depth), v, u, in_img)
        assert int(cov.sum()) < int(in_img.sum())


def test_stamp_is_touch_active():
    """The stamp writes last_seen exactly at the set's rows below
    ``count`` (the rows past it are FREE_PTR padding), as ``touch_active``
    does over the whole padded set."""
    _, tc = _cfgs("tiny", 256)
    keys, ptrs = table_case(tc.hash, seed=5)
    case = rows_case(tc.hash, 5)
    tm = tho.create(tc.hash, device="cpu")._replace(
        keys=tt(keys), ptrs=tt(ptrs), last_seen=tt(case["last_seen"]))
    at = tho.compact_visible(tm, tc.hash, tt(_pose()), tc.camera, tc.fusion)
    n = int(at.count)
    want = case["last_seen"].copy()
    want[at.ptrs[:n].numpy()] = STAMP
    touched = tho.touch_active(tm._replace(last_seen=tm.last_seen.clone()),
                               at, STAMP)
    np.testing.assert_array_equal(touched.last_seen.numpy(), want)
    depth = tt(depth_case(tc.camera, 5))
    fused = tho.integrate(tm, at, tc.hash, depth, tt(_pose()), tc.camera,
                          tc.fusion, stamp=STAMP)
    np.testing.assert_array_equal(fused.last_seen.numpy(), want)


def test_public_functions_run_plain_on_cpu():
    """On CPU tensors ``compact_visible``, ``integrate``, ``fuse_frame``
    and ``defuse_frame`` return the plain versions' results and launch
    nothing; the kernels' wrappers refuse CPU tensors."""
    from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

    _, tc = _cfgs("tiny", 256)
    keys, ptrs = table_case(tc.hash, seed=3)
    case = {"keys": tt(keys), "ptrs": tt(ptrs),
            **{k: tt(v) for k, v in rows_case(tc.hash, 3).items()}}
    base = tho.create(tc.hash, device="cpu")._replace(**case)

    def fresh():
        return base._replace(**{f: getattr(base, f).clone()
                                for f in tho.HashMap._fields})

    pose, depth = tt(_pose()), tt(depth_case(tc.camera, 3))
    args = (tc.hash, pose, tc.camera, tc.fusion)
    counts = (tho.LAUNCHES_COMPACT, tho.LAUNCHES_INTEGRATE,
              tho.LAUNCHES_INTEGRATE_WINDOW)
    a = tho.compact_visible(base, *args)
    _assert_active_equal(a, tho.compact_visible_reference(base, *args))
    got = tho.integrate(fresh(), a, tc.hash, depth, pose, tc.camera,
                        tc.fusion, sign=-1, max_born=MAX_BORN)
    want = tho.integrate_reference(fresh(), a, tc.hash, depth, pose,
                                   tc.camera, tc.fusion, -1, MAX_BORN)
    for f in tho.HashMap._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    frame = tpre.Frame(vertices=None, normals=None, depth=depth)
    got = tho.defuse_frame(fresh(), frame, pose, tc.camera, tc.hash,
                           tc.fusion, MAX_BORN)
    for f in tho.HashMap._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (tho.LAUNCHES_COMPACT, tho.LAUNCHES_INTEGRATE,
            tho.LAUNCHES_INTEGRATE_WINDOW) == counts
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_compact(base, *args)
    with pytest.raises(ValueError, match="CUDA device"):
        tho._launch_integrate(base, a, tc.hash, depth, pose, tc.camera,
                              tc.fusion, 1, None, STAMP)


def test_kernel_arguments_match_the_sources():
    """Each fuse kernel's ctypes argument list (kernels.KERNELS), and K7's
    instantiation report's, has as many entries as its C entry point in
    csrc/fuse.cu has parameters, the pointers where the C function takes
    pointers, ints where it takes ints."""
    src = (Path(kernels.SRC_DIR) / "fuse.cu").read_text()
    for name in ("compact_visible", "integrate_rows",
                 "integrate_rows_info"):
        assert kernels.source_of(name) == "fuse"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)
            if "*" not in p:
                assert p.startswith("float") == (t is kernels._F), (name, p)


def test_plans_hold_the_plain_constants():
    """The wrappers' constant arguments are the plain versions' Python
    doubles (block_in_frustum's margin, planes and radius, in K6's host
    table as their float32; the update's truncations and weights), and the
    plans raise on what the kernels do not take."""
    _, tc = _cfgs("tiny")
    cam, fus, h = tc.camera, tc.fusion, tc.hash
    ints, floats = tho._compact_plan(h, cam, fus)
    half = 0.5 * h.block_size * fus.voxel_size
    assert list(ints) == [h.max_active, h.key_bits, h.block_size]
    assert list(floats)[:2] == [np.float32(fus.voxel_size), np.float32(half)]
    np.testing.assert_array_equal(
        np.asarray(list(floats)[-4:], np.float32),
        np.float32([half * 1.7320508 * cam.fx, half * 1.7320508 * cam.fy,
                    cam.depth_min - 2.0 * half, cam.depth_max + 2.0 * half]))
    head, tail = tho._integrate_plan(h, cam, fus)
    assert head == (h.block_size, cam.height, cam.width, 60, 80, 1)
    assert tail[-1] == fus.truncation + fus.trunc_scale * cam.depth_max
    off = tho._integrate_plan(dataclasses.replace(h, use_pallas_gather=False),
                              cam, fus)[0]
    assert off[-1] == 0
    with pytest.raises(ValueError, match="key bits"):
        tho._compact_plan(dataclasses.replace(h, key_bits=11), cam, fus)
    with pytest.raises(ValueError, match="voxels a block"):
        tho._integrate_plan(dataclasses.replace(h, block_size=16), cam, fus)


def test_integrate_tables_refuse_what_k7_does_not_take():
    """K7's host tables are built from the plan (a block of more than
    MAX_VOXELS voxels raises first) and only for map rows on a CUDA device:
    CPU rows raise before any launch, and nothing is kept for them."""
    _, tc = _cfgs()
    hmap = tho.create(tc.hash, device="cpu")
    before = dict(tho._INTEGRATE_TABLES)
    with pytest.raises(ValueError, match="voxels a block"):
        tho._integrate_tables(hmap, dataclasses.replace(
            tc.hash, block_size=16), tc.camera, tc.fusion)
    with pytest.raises(ValueError, match="one CUDA device"):
        tho._integrate_tables(hmap, tc.hash, tc.camera, tc.fusion)
    assert tho._INTEGRATE_TABLES == before



def test_compact_tables_hold_the_float32_of_block_in_frustums_doubles():
    """K6's host table of floats holds, in CompactParams' order, the
    float32 of each Python double that ``block_in_frustum`` meets a
    float32 tensor with (the voxel size, half a block, the camera, the
    pixel margin, radius * fx and radius * fy, the near and far planes),
    on both test cameras; the tables are built once a configuration (the
    same objects give the same tables; an equal configuration made anew
    gets equal tables; another max_active other ints)."""
    for cam_name in ("tiny", "wide"):
        _, tc = _cfgs(cam_name)
        cam, fus, h = tc.camera, tc.fusion, tc.hash
        ints, floats = tho._compact_plan(h, cam, fus)
        half = 0.5 * h.block_size * fus.voxel_size
        radius = half * 1.7320508
        want = [fus.voxel_size, half, cam.fx, cam.fy, cam.cx, cam.cy,
                cam.width, cam.height, tho.FRUSTUM_MARGIN_PX,
                radius * cam.fx, radius * cam.fy,
                cam.depth_min - 2.0 * half, cam.depth_max + 2.0 * half]
        got = list(floats)
        assert len(got) == len(want) == 13
        for g, w in zip(got, want):
            assert g == float(np.float32(w)), (cam_name, g, w)
        assert tho._compact_plan(h, cam, fus)[1] is floats
        again = tho._compact_plan(dataclasses.replace(h), cam, fus)
        assert again[1] is not floats and list(again[1]) == got
        other = tho._compact_plan(dataclasses.replace(h, max_active=7), cam,
                                  fus)[0]
        assert list(other) == [7, h.key_bits, h.block_size]


def test_compact_scratch_sizes():
    """K6's persistent scratch a device and stream: zeroed when made, the
    epoch word and at least COMPACT_MIN_TILES statuses (a power of two),
    COMPACT_STATUS_WORDS words each; the same one while a
    table fits it; a larger one when a table outgrows it, the old one kept
    alive (a CUDA graph captured with it may still run on it).  Made here
    on the CPU device, which only a test hands it.  The words a status
    takes are csrc/fuse.cu's kStatusStride."""
    src = (Path(kernels.SRC_DIR) / "fuse.cu").read_text()
    assert int(re.search(r"constexpr int kStatusStride = (\d+);",
                         src).group(1)) == tho.COMPACT_STATUS_WORDS
    dev, stream = torch.device("cpu"), 12345
    key = (dev.index, stream)
    retired = len(tho._COMPACT_RETIRED)
    try:
        t, n = tho._compact_scratch(dev, stream, 1)
        assert n == tho.COMPACT_MIN_TILES and t.dtype == torch.int64
        assert t.shape == (1 + tho.COMPACT_STATUS_WORDS * n,)
        assert not bool(t.any())
        assert tho._compact_scratch(dev, stream, 128)[0] is t
        t2, n2 = tho._compact_scratch(dev, stream, 129)
        assert n2 == 256 and t2 is not t
        assert tho._COMPACT_RETIRED[-1] is t
        assert tho._compact_scratch(dev, stream, 1024)[1] == 1024
        assert tho._compact_scratch(dev, stream, 5)[1] == 1024
    finally:
        tho._COMPACT_SCRATCH.pop(key, None)
        del tho._COMPACT_RETIRED[retired:]
