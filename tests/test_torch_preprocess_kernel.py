"""The ICP pyramid's level inputs (``preprocess.pyramid_inputs``, the plain
version of K3b ``pyramid_levels``) and the depth frontend (``preprocess``,
the plain version of K3a ``preprocess_frame``) against the JAX package at
80x60, on numpy frames from a seed: a tilted wall with a box in front, depth
edges across the image border (which the stencils' wrap reaches), dropouts
and flying pixels; and each stage set K3a instantiates on a 97 x 61 frame
with dropouts along its border.

Tolerances (PERF.md's "Float map / pixel maps" tier): the range gate and
min pooling are exact; mean-pooled depth, bilateral depth, vertices and
normals agree within atol 1e-5 (float op order, XLA's exp), except the
normals of a bilateral-filtered noisy frame, 5e-5 (measured 1.2e-5: its
depth agrees to 7.2e-7, 3 ulp at 2-3 m, and a normal divides a difference
of neighbouring vertices a few mm apart by its length, which amplifies
that ~20 times); the packed targets' depth column within 1e-5 with the
same usable pixels, and their oct-normal bits equal wherever the two
packages' normals are equal (the bf16 rounding of a normal that differs in
the last ulp may differ).
``icp_align_pyramid`` on CPU tensors returns bit for bit what the chain of
plain functions it called before K3b returns, and the JAX pose within
1e-5 with equal iterations.  The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py); here their wrappers' checks refuse CPU
tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (depth_scene, jax_sequence,
                                tiny_flagship_gather_config, tt)

from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.ops import icp as jicp
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch.ops import icp as ticp
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)

ATOL = 1e-5
NORMAL_ATOL_BILATERAL = 5e-5

J_PRE = jax.jit(jpre.preprocess, static_argnums=(1, 2))
J_METRIC = jax.jit(jpre.preprocess_metric, static_argnums=(1,))
J_DOWN = jax.jit(jpre.downsample_depth, static_argnums=(1,))
J_DOWN_MEAN = jax.jit(jpre.downsample_depth_mean, static_argnums=(1,))
J_PACK = jax.jit(jicp.pack_target)
J_PYRAMID = jax.jit(jicp.icp_align_pyramid, static_argnums=(2, 3))

# (pyramid, source pools): the flagship's and a two-level one
PYRAMIDS = {"flagship": ((4, 2, 1), (8, 4, 2), (1, 1, 2)),
            "two_level": ((4, 2), (8, 4), (1, 2))}


def _cfgs(pyramid: str):
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    levels, iters, pools = PYRAMIDS[pyramid]

    def icp(c):
        return dataclasses.replace(c.icp, pyramid=levels, pyramid_iters=iters,
                                   source_pools=pools)

    return (dataclasses.replace(jc, icp=icp(jc)),
            dataclasses.replace(tc, icp=icp(tc)))


def _frames(jc, seed: int):
    """(source Frame, model Frame) as JAX arrays: the preprocessed frame of
    one scene and a model Frame (depth and its normals) of another."""
    cam = jc.camera
    src = J_PRE(jnp.asarray(depth_scene(cam.height, cam.width, seed)), cam,
                jc.frontend)
    model = J_METRIC(jnp.asarray(
        depth_scene(cam.height, cam.width, seed + 100, border_edges=False)
        .astype(np.float32) / 5000.0), cam)
    return src, model


def _port(frame):
    return tpre.Frame(*(tt(x) for x in frame))


def _jax_level_inputs(jc, src, model, src_full, tgt_full, mean_sources):
    """icp_align_pyramid's level inputs by the JAX functions: (sources,
    packed targets), coarsest first."""
    cam, cfg = jc.camera, jc.icp
    sources, targets = [], []
    for factor, pool in zip(sorted(set(cfg.pyramid), reverse=True),
                            cfg.source_pools):
        lcam = cam.scaled(factor) if factor > 1 else cam
        if factor > 1:
            tgt = J_METRIC(J_DOWN(model.depth, factor), lcam)
        else:
            tgt = model if tgt_full else J_METRIC(model.depth, lcam)
        sf = factor * pool
        if pool > 1 and mean_sources:
            s = J_METRIC(J_DOWN_MEAN(src.depth, sf), cam.scaled(sf))
        elif sf > 1:
            s = J_METRIC(J_DOWN(src.depth, sf), cam.scaled(sf))
        else:
            s = src if src_full else J_METRIC(src.depth, lcam)
        sources.append(s)
        targets.append(J_PACK(tgt))
    return sources, targets


def assert_frame_close(got, want, what: str, normal_atol: float = ATOL):
    np.testing.assert_array_equal(got.depth.numpy() > 0,
                                  np.asarray(want.depth) > 0, err_msg=what)
    for name in ("depth", "vertices", "normals"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            atol=normal_atol if name == "normals" else ATOL,
            err_msg=f"{what} {name}")


def assert_packed_close(got, want, normals_equal, what: str):
    """Packed targets: depth column within 1e-5 on the same usable pixels;
    oct bits equal where both packages' normals are equal."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0,
                                  err_msg=what)
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=ATOL,
                               err_msg=what)
    bits_g = got[..., 1].view(np.int32)
    bits_w = want[..., 1].view(np.int32)
    np.testing.assert_array_equal(bits_g[normals_equal],
                                  bits_w[normals_equal], err_msg=what)
    assert normals_equal.mean() > 0.5, what


@pytest.mark.parametrize("mean_sources", [True, False])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_pyramid_inputs_match_jax(pyramid, full, mean_sources):
    """Every level's source Frame and packed target against the JAX
    chain icp_align_pyramid runs (``full``: the step's src_full / tgt_full
    given; ``mean_sources=False``: the sharded step's min-pooled
    sources)."""
    jc, tc = _cfgs(pyramid)
    src, model = _frames(jc, seed=3)
    src_t, model_t = _port(src), _port(model)
    got_s, got_t = tpre.pyramid_inputs(
        src_t.depth, model_t.depth, tc.camera, tc.icp,
        src_full=src_t if full else None, tgt_full=model_t if full else None,
        mean_sources=mean_sources)
    want_s, want_t = _jax_level_inputs(jc, src, model, full, full,
                                       mean_sources)
    assert len(got_s) == len(got_t) == len(PYRAMIDS[pyramid][0])
    factors = sorted(PYRAMIDS[pyramid][0], reverse=True)
    for k, (gs, gt, ws, wt) in enumerate(zip(got_s, got_t, want_s, want_t)):
        what = f"level {factors[k]}"
        assert_frame_close(gs, ws, f"{what} source")
        # the target Frame the packing read (the plain chain's own)
        lcam = tc.camera.scaled(factors[k])
        if factors[k] > 1:
            tf = tpre.preprocess_metric(
                tpre.downsample_depth(model_t.depth, factors[k]), lcam)
        else:
            tf = model_t if full else tpre.preprocess_metric(model_t.depth,
                                                             tc.camera)
        torch.testing.assert_close(gt, ticp.pack_target(tf), rtol=0, atol=0)
        jf = (J_METRIC(J_DOWN(model.depth, factors[k]), lcam)
              if factors[k] > 1 else model if full
              else J_METRIC(model.depth, jc.camera))
        same = (tf.normals.numpy() == np.asarray(jf.normals)).all(-1)
        assert_packed_close(gt, wt, same, f"{what} target")


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_pooling_ragged_sizes(factor):
    """VALID pooling on sizes ``factor`` does not divide (83 x 61): the
    ragged edge is cropped, as reduce_window's VALID padding does."""
    jc = tiny_flagship_gather_config("jax")
    tc = tiny_flagship_gather_config("torch")
    jcam = dataclasses.replace(jc.camera, width=83, height=61)
    tcam = dataclasses.replace(tc.camera, width=83, height=61)
    dm = np.asarray(J_PRE(jnp.asarray(depth_scene(61, 83, seed=7)), jcam,
                          jc.frontend).depth)
    lj, lt = jcam.scaled(factor), tcam.scaled(factor)
    got = tpre.preprocess_metric(tt(dm), lt, pool_factor=factor)
    assert tuple(got.depth.shape) == (61 // factor, 83 // factor)
    want = J_METRIC(J_DOWN(jnp.asarray(dm), factor), lj)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    assert_frame_close(got, want, f"min pool {factor}")
    cfg = dataclasses.replace(tc.icp, pyramid=(factor,), pyramid_iters=(4,),
                              source_pools=(2,))
    (src,), (packed,) = tpre.pyramid_inputs(tt(dm), tt(dm), tcam, cfg)
    want_src = J_METRIC(J_DOWN_MEAN(jnp.asarray(dm), 2 * factor),
                        jcam.scaled(2 * factor))
    assert_frame_close(src, want_src, f"mean pool {2 * factor}")
    assert tuple(packed.shape) == (61 // factor, 83 // factor, 2)


def test_all_invalid_frame():
    """An all-zero and an all-saturated frame: every depth, vertex, normal
    and packed target is zero, on every level, as in JAX."""
    jc, tc = _cfgs("flagship")
    cam = jc.camera
    for fill in (0, 65535):
        raw = np.full((cam.height, cam.width), fill, np.uint16)
        fj = J_PRE(jnp.asarray(raw), cam, jc.frontend)
        ft = tpre.preprocess(tt(raw.astype(np.int32)), tc.camera,
                             tc.frontend)
        for name in ("depth", "vertices", "normals"):
            assert not getattr(ft, name).any(), (fill, name)
            assert not np.asarray(getattr(fj, name)).any(), (fill, name)
        srcs, tgts = tpre.pyramid_inputs(ft.depth, ft.depth, tc.camera,
                                         tc.icp, src_full=ft, tgt_full=ft)
        assert all(not t.any() for s in srcs for t in s)
        assert all(not t.any() for t in tgts)


@pytest.mark.parametrize("outlier,bilateral,radius", [
    (True, True, 1), (True, True, 2), (True, True, 3), (False, True, 2),
    (True, False, 2), (False, False, 2)])
def test_preprocess_frontends_border_wrap(outlier, bilateral, radius):
    """``preprocess`` with the frontend's stages switched on and off and
    bilateral radius 1-3, on a frame whose depth edges cross the border
    (the rolls wrap them in): against JAX's preprocess."""
    jc, tc = _cfgs("flagship")

    def front(c):
        return dataclasses.replace(c.frontend, outlier_reject=outlier,
                                   bilateral=bilateral,
                                   bilateral_radius=radius)

    raw = depth_scene(jc.camera.height, jc.camera.width, seed=11)
    fj = J_PRE(jnp.asarray(raw), jc.camera, front(jc))
    ft = tpre.preprocess(tt(raw.astype(np.int32)), tc.camera, front(tc))
    assert_frame_close(ft, fj, f"frontend {outlier} {bilateral} {radius}",
                       NORMAL_ATOL_BILATERAL if bilateral else ATOL)
    ref = tpre.preprocess_reference(tt(raw.astype(np.int32)), tc.camera,
                                    front(tc))
    for a, b in zip(ft, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _pyramid_before_k3b(depth_src_m, depth_tgt_m, cam, cfg, src_full,
                        tgt_full, prior_T):
    """icp_align_pyramid as it was before its level inputs became one
    pyramid_inputs call: the plain chain a level, then icp_align."""
    T, result = torch.eye(4), None
    levels = sorted(set(cfg.pyramid), reverse=True)
    for li, (factor, max_it, pool) in enumerate(zip(
            levels, cfg.pyramid_iters, cfg.source_pools)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        lcfg = dataclasses.replace(cfg, max_iters=max_it)
        tgt = (tpre.preprocess_metric(tpre.downsample_depth(depth_tgt_m,
                                                            factor), lcam)
               if factor > 1 else tgt_full)
        sf = factor * pool
        if pool > 1:
            src = tpre.preprocess_metric(
                tpre.downsample_depth_mean(depth_src_m, sf), cam.scaled(sf))
        elif sf > 1:
            src = tpre.preprocess_metric(
                tpre.downsample_depth(depth_src_m, sf), cam.scaled(sf))
        else:
            src = src_full
        if li == 0:
            result = ticp.icp_align_raced(src, tgt, lcam, lcfg, prior_T,
                                          init_T=T)
        else:
            result = ticp.icp_align(src, tgt, lcam, lcfg, init_T=T)
        T = result.transform
    return result


@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_icp_align_pyramid_on_cpu_unchanged(pyramid):
    """icp_align_pyramid on CPU tensors (frame 1 onto frame 0 of the orbit,
    with the motion prior): bit for bit the pre-K3b chain's result, and
    the JAX pose within 1e-5 with equal iterations."""
    jc, tc = _cfgs(pyramid)
    depths, _ = jax_sequence(jc.camera, 2)
    fj = [J_PRE(jnp.asarray(d), jc.camera, jc.frontend) for d in depths]
    ft = [_port(f) for f in fj]
    xi = np.random.default_rng(4).normal(size=6).astype(np.float32) * 0.01
    prior = np.asarray(jse3.exp(jnp.asarray(xi)))
    rt = ticp.icp_align_pyramid(ft[1].depth, ft[0].depth, tc.camera, tc.icp,
                                src_full=ft[1], tgt_full=ft[0],
                                prior_T=tt(prior))
    before = _pyramid_before_k3b(ft[1].depth, ft[0].depth, tc.camera, tc.icp,
                                 ft[1], ft[0], tt(prior))
    for a, b in zip(rt, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rj = J_PYRAMID(fj[1].depth, fj[0].depth, jc.camera, jc.icp,
                   src_full=fj[1], tgt_full=fj[0],
                   prior_T=jnp.asarray(prior))
    np.testing.assert_allclose(rt.transform.numpy(), np.asarray(rj.transform),
                               atol=1e-5)
    assert int(rt.iters) == int(rj.iters)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: called on CPU tensors
    (which the public functions never hand them) they raise before any
    build; a table past the kernel's jobs or a radius past its reach
    raises too."""
    tc = tiny_flagship_gather_config("torch")
    raw = torch.zeros((60, 80), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpre._launch_frame(raw, tc.camera, tc.frontend)
    jobs, _ = tpre._plan(tc.camera, tc.icp, False, False, True)
    images = {"src": raw.float(), "tgt": raw.float()}
    with pytest.raises(ValueError, match="CUDA"):
        tpre._launch_levels(jobs, images, None)
    with pytest.raises(ValueError, match="level inputs"):
        tpre._launch_levels(jobs * 2, images, None)
    assert (tpre.LAUNCHES_FRAME, tpre.LAUNCHES_LEVELS) == (0, 0)


def test_level_plan_shares_jobs():
    """The flagship pyramid is 6 jobs (3 sources, 3 targets; the L1
    target packs the model's own normals); two levels that read the same
    pooled source share its job."""
    tc = tiny_flagship_gather_config("torch")
    cam = tc.camera
    jobs, levels = tpre._plan(cam, tc.icp, False, True, True)
    assert [(j.kind, j.pool, j.factor) for j in jobs] == [
        (tpre._SOURCE, tpre._MIN, 4), (tpre._TARGET, tpre._MIN, 4),
        (tpre._SOURCE, tpre._MIN, 2), (tpre._TARGET, tpre._MIN, 2),
        (tpre._SOURCE, tpre._MEAN, 2), (tpre._PACK, tpre._NONE, 1)]
    assert levels == ((0, 1), (2, 3), (4, 5))
    cfg = dataclasses.replace(tc.icp, pyramid=(2, 1), pyramid_iters=(4, 2),
                              source_pools=(2, 4))
    jobs, levels = tpre._plan(cam, cfg, False, False, True)
    assert levels[0][0] == levels[1][0] and len(jobs) == 3


def test_level_layout():
    """K3b's output layout for the flagship plan at 640x480: one buffer,
    the packed targets first at even offsets (8-byte aligned), every
    view inside the buffer and none overlapping; an image smaller than a
    level's factor raises."""
    from voxelhashing_demo_tpu_torch.config import flagship_config

    cfg = flagship_config()
    jobs, _ = tpre._plan(cfg.camera, cfg.icp, False, True, True)
    total, views, ints, floats = tpre._layout(jobs, ((480, 640),) * 6)
    spans = []
    for job, view in zip(jobs, views):
        for size, stride, offset in view:
            n = int(np.prod(size))
            assert stride[-1] == 1 and offset + n <= total
            spans.append((offset, offset + n))
            if job.kind != tpre._SOURCE:
                assert offset % 2 == 0 and size[-1] == 2
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert sum(b - a for a, b in spans) == total
    assert list(ints)[:6] == [tpre._SOURCE, tpre._MIN, 4, 640, 120, 160]
    assert len(floats) == 6 * len(jobs)
    with pytest.raises(ValueError, match="factor 4"):
        tpre._layout(jobs, ((3, 640),) * 6)


def _border_dropouts(raw: np.ndarray) -> np.ndarray:
    """``raw`` with dropouts (0) along the border rows and columns: the
    pixels a wrapped stencil reads across the edge."""
    raw = raw.copy()
    raw[0, ::2] = 0
    raw[-1, 1::3] = 0
    raw[::3, 0] = 0
    raw[1::2, -1] = 0
    raw[1, :5] = 0
    return raw


@pytest.mark.parametrize("outlier", [True, False])
@pytest.mark.parametrize("radius", [None, 0, 1, 3, 7])
def test_preprocess_stage_sets_match_jax(outlier, radius):
    """The plain frontend against JAX's on each stage set K3a instantiates
    (the bilateral off (None), or at radius 0, 1, 3 or 7; the outlier
    stage on and off), on a 97 x 61 frame (no multiple of K3a's 32 x 20
    tile) with depth edges across the border and dropouts along it."""
    jc, tc = _cfgs("flagship")
    H, W = 61, 97

    def cfg(c):
        cam = dataclasses.replace(c.camera, width=W, height=H, cx=48.2,
                                  cy=30.4)
        front = dataclasses.replace(
            c.frontend, outlier_reject=outlier, bilateral=radius is not None,
            bilateral_radius=2 if radius is None else radius)
        return cam, front

    raw = _border_dropouts(depth_scene(H, W, seed=13))
    jcam, jfront = cfg(jc)
    tcam, tfront = cfg(tc)
    fj = J_PRE(jnp.asarray(raw), jcam, jfront)
    ft = tpre.preprocess(tt(raw.astype(np.int32)), tcam, tfront)
    assert_frame_close(ft, fj, f"outlier {outlier} radius {radius}",
                       NORMAL_ATOL_BILATERAL if radius else ATOL)
    assert (ft.depth.numpy()[0] == 0).any() and (ft.depth.numpy() > 0).any()


def test_kernel_arguments_match_the_sources():
    """K3a's and K3b's ctypes argument lists (kernels.KERNELS) have as
    many entries as their C entry points in csrc/preprocess.cu have
    parameters: pointers where it takes pointers, floats where it takes
    floats; the radius K3a takes is the kernel's."""
    import re
    from pathlib import Path

    from voxelhashing_demo_tpu_torch import kernels

    src = (Path(kernels.SRC_DIR) / "preprocess.cu").read_text()
    for name in ("preprocess_frame", "pyramid_levels"):
        assert kernels.source_of(name) == "preprocess"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)
            if "*" not in p:
                assert p.startswith("float") == (t is kernels._F), (name, p)
    assert re.search(r"constexpr int kMaxRadius = (\d+);", src).group(1) == \
        str(tpre.MAX_RADIUS)
    assert src.count("K3A_ROW(") == tpre.MAX_RADIUS + 2   # the macro, 0..7


@pytest.mark.parametrize("case,ok", [
    ({}, True),
    ({"depth_min": 0.0}, True),
    ({"depth_max": float("inf")}, True),
    ({"depth_min": -0.1, "outlier_reject": True}, True),
    ({"depth_min": -0.1, "bilateral": False}, True),
    ({"depth_min": -0.1}, False),
    ({"depth_min": 0.0, "depth_scale": -1000.0}, False),
    ({"depth_min": 0.0, "depth_scale": float("inf")}, False),
    ({"bilateral_sigma_depth": 1e30}, False),
    ({"depth_scale": 1e-25, "depth_max": float("inf")}, False),
])
def test_bilateral_settings_the_card_takes(case, ok):
    """K3a's host tables (built only for CUDA tensors) refuse a bilateral
    whose taps the kernel cannot take unmasked: an invalid pixel that is
    not exactly 0 (a negative depth_min or a depth_scale <= 0 without the
    outlier stage), a 1 / (2 sigma_depth^2) that is 0 in float32, or
    depths that reach MAX_DEPTH; the flagship settings and depth_min 0
    pass.  The bound the kernel checks is MAX_DEPTH."""
    import re
    from pathlib import Path

    from voxelhashing_demo_tpu_torch import kernels
    from voxelhashing_demo_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cam = dataclasses.replace(cfg.camera, **{
        k: v for k, v in case.items() if hasattr(cfg.camera, k)})
    front = dataclasses.replace(cfg.frontend, **{
        "outlier_reject": False,
        **{k: v for k, v in case.items() if hasattr(cfg.frontend, k)}})
    if ok:
        tpre._frame_plan(cam, front)
    else:
        with pytest.raises(ValueError, match="bilateral filter"):
            tpre._frame_plan(cam, front)
    src = (Path(kernels.SRC_DIR) / "preprocess.cu").read_text()
    assert float(re.search(r"kMaxDepth = ([0-9e.]+)f;", src).group(1)) == \
        tpre.MAX_DEPTH
