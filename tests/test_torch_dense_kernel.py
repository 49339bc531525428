"""K20's plain version (``ops/tsdf.py integrate_dense_reference``, which
the hand-written kernel ``csrc/dense.cu`` repeats bit for bit on the card)
against the JAX package's ``integrate_dense`` (jitted, as the JAX step
runs it), on seeded numpy inputs at 80x60 on small non-cubic grids.

Cases: three fused orbit frames with the depth falloff on and off; a
volume that reaches behind the camera and past the image on every side;
depth-0 pixels (a third of the image); voxel centres that project to
pixel centres exactly halfway between two pixels (round half to even;
exact in both packages: the identity pose, power-of-two voxel sizes and
depths); voxels whose sdf is exactly -truncation (not fused) beside ones
just inside the band; the weight cap reached.

Tolerances: sdf and weight within 1e-5 everywhere (XLA contracts
multiply-adds into FMAs, ROADMAP Queue 3's FMA tier); the voxels each
frame fuses (its validity mask) equal.  On CPU tensors ``integrate_dense``
is ``integrate_dense_reference`` bit for bit.  What K20 does not take
raises in its wrapper before any launch; its ctypes argument list matches
its C entry point; ``pack_model`` (K3b's pack job on the card) is
``pack_target`` on CPU tensors; chip_smoke.py's dense configuration is
the JAX reference's.  K20 itself runs only on the card
(tests/test_torch_cuda_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_sequence, tt

from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.ops import tsdf as jtsdf
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre
from voxelhashing_demo_tpu_torch.ops import tsdf as ttsdf

torch.set_num_threads(1)

ATOL = 1e-5
_JINT = jax.jit(jtsdf.integrate_dense, static_argnames=("cam", "fusion"))


def _both(make):
    """``make(mod)`` for the JAX config module and the port's."""
    return make(jcfg), make(tcfg)


def _volumes(dims, grid):
    """(JAX, port) fresh DenseTSDF (sdf 0.16, weight 0) of ``dims`` voxels
    on ``grid`` = (origin of voxel (0, 0, 0), voxel size)."""
    o, vs = grid
    s = np.full(dims, 0.16, np.float32)
    w = np.zeros(dims, np.float32)
    j = jtsdf.DenseTSDF(sdf=jnp.asarray(s), weight=jnp.asarray(w),
                        origin=jnp.asarray(o, jnp.float32),
                        voxel_size=jnp.float32(vs))
    t = ttsdf.DenseTSDF(sdf=tt(s), weight=tt(w),
                        origin=tt(np.asarray(o, np.float32)),
                        voxel_size=torch.tensor(vs, dtype=torch.float32))
    return j, t


def _fuse_both(jvol, tvol, depth_m, T, cams, fusions):
    """One frame through both packages: (JAX volume, port volume, JAX
    mask, port mask), a mask the voxels the frame fuses (the weight a
    fresh volume takes with the falloff on, > 0: every fused sample
    weighs at least 1 there)."""
    jc, tc = cams
    jf, tf = fusions
    jd, td = jnp.asarray(depth_m), tt(depth_m)
    jT, tT = jnp.asarray(T, jnp.float32), tt(np.asarray(T, np.float32))
    jnew = _JINT(jvol, jd, jT, jc, jf)
    tnew = ttsdf.integrate_dense_reference(tvol, td, tT, tc, tf)
    # the wrapper on CPU tensors is the plain version, bit for bit
    same = ttsdf.integrate_dense(tvol, td, tT, tc, tf)
    assert torch.equal(same.sdf, tnew.sdf)
    assert torch.equal(same.weight, tnew.weight)
    jm_f = dataclasses.replace(jf, depth_weight_falloff=True,
                               max_weight=1e9)
    tm_f = dataclasses.replace(tf, depth_weight_falloff=True,
                               max_weight=1e9)
    jz = jvol._replace(weight=jnp.zeros_like(jvol.weight))
    tz = tvol._replace(weight=torch.zeros_like(tvol.weight))
    jmask = np.asarray(_JINT(jz, jd, jT, jc, jm_f).weight) > 0
    tmask = ttsdf.integrate_dense_reference(tz, td, tT, tc,
                                            tm_f).weight.numpy() > 0
    return jnew, tnew, jmask, tmask


def _assert_close(jvol, tvol, jmask, tmask, what):
    np.testing.assert_array_equal(tmask, jmask, err_msg=f"{what}: mask")
    np.testing.assert_allclose(tvol.sdf.numpy(), np.asarray(jvol.sdf),
                               atol=ATOL, err_msg=f"{what}: sdf")
    np.testing.assert_allclose(tvol.weight.numpy(), np.asarray(jvol.weight),
                               atol=ATOL, err_msg=f"{what}: weight")


@pytest.fixture(scope="module")
def orbit():
    """Three metric 80x60 orbit frames and their poses."""
    jc = jcfg.tiny_config().camera
    raw, poses = jax_sequence(jc, 3)
    depths = [np.asarray(jpre.depth_to_meters(jnp.asarray(d), jc))
              for d in raw]
    return depths, poses


@pytest.mark.parametrize("falloff", [True, False])
def test_three_frames_match(orbit, falloff):
    """Three orbit frames fused into a 56 x 48 x 60 grid (4 cm voxels),
    falloff on and off (off: weight_sample 1.5, so the cap of 4 is reached
    on the third frame); max_weight 4 either way."""
    depths, poses = orbit
    cams = _both(lambda m: m.tiny_config().camera)
    fusions = _both(lambda m: m.FusionConfig(
        voxel_size=0.04, truncation=0.16, max_weight=4.0,
        depth_weight_falloff=falloff, weight_sample=1.0 if falloff else 1.5))
    jvol, tvol = _volumes((56, 48, 60), ((-1.1, -0.9, 0.2), 0.04))
    fused = 0
    for k, (d, T) in enumerate(zip(depths, poses)):
        jvol, tvol, jm, tm = _fuse_both(jvol, tvol, d, T, cams, fusions)
        _assert_close(jvol, tvol, jm, tm, f"frame {k}")
        fused = max(fused, int(tm.sum()))
    assert fused > 0.02 * tm.size
    if not falloff:
        assert float(tvol.weight.max()) == 4.0        # the cap reached


def test_behind_camera_outside_image_and_depth_holes(orbit):
    """A volume from 1.5 m behind the camera to 2.5 m ahead and 2.5 m to
    each side (voxels behind it, and past every image edge), at the
    orbit's second pose, with a third of the pixels at depth 0."""
    depths, poses = orbit
    rng = np.random.default_rng(11)
    depth = depths[1].copy()
    depth[rng.random(depth.shape) < 0.33] = 0.0
    cams = _both(lambda m: m.tiny_config().camera)
    fusions = _both(lambda m: m.FusionConfig(voxel_size=0.08,
                                             truncation=0.24))
    dims = (64, 40, 52)
    jvol, tvol = _volumes(dims, ((-2.5, -1.6, -1.5), 0.08))
    for k in range(2):
        jvol, tvol, jm, tm = _fuse_both(jvol, tvol, depth, poses[1], cams,
                                        fusions)
        _assert_close(jvol, tvol, jm, tm, f"pass {k}")
    # voxels behind the camera and outside the image were in the volume,
    # and none of them was fused
    T = np.asarray(poses[1], np.float64)
    ijk = np.stack(np.meshgrid(*(np.arange(n) for n in dims),
                               indexing="ij"), -1)
    world = np.array((-2.5, -1.6, -1.5)) + ijk * 0.08
    pc = (world - T[:3, 3]) @ T[:3, :3]
    behind = pc[..., 2] < 0
    assert behind.any() and not tm[behind].any()
    assert 0 < tm.sum() < (~behind).sum()


def _exact_camera(mod):
    """A camera under which the identity pose puts voxel centres at x, y =
    -1 + k / 16 and z = 1 m exactly halfway between an even pixel and the
    odd one after it (fx = fy = 64, cx = 38.5, cy = 28.5: u = 4 i - 25.5),
    where round half to even and round half up part."""
    return mod.CameraConfig(width=80, height=60, fx=64.0, fy=64.0, cx=38.5,
                            cy=28.5, depth_min=0.1, depth_max=4.0)


def test_half_pixel_centres_round_to_even():
    """Voxel centres at x, y = -1 + k / 16 and z = 1 project to u, v =
    2 n + 1/2 exactly in both packages; a depth that differs between even
    and odd pixels shows which way each rounds (half to even: down)."""
    cams = _both(_exact_camera)
    fusions = _both(lambda m: m.FusionConfig(
        voxel_size=0.0625, truncation=0.5, trunc_scale=0.0))
    v, u = np.mgrid[0:60, 0:80]
    depth = (1.25 + 0.0625 * ((u % 2) + 2 * (v % 2))).astype(np.float32)
    dims = (32, 32, 32)
    jvol, tvol = _volumes(dims, ((-1.0, -1.0, 0.5), 0.0625))
    jvol, tvol, jm, tm = _fuse_both(jvol, tvol, depth, np.eye(4), cams,
                                    fusions)
    _assert_close(jvol, tvol, jm, tm, "half pixels")
    # at z = 1 (k = 8) every voxel in view sits on a half pixel: u = 4 i -
    # 25.5 and v = 4 j - 35.5 round down to their even neighbours, where
    # the depth is 1.25 (sdf 0.25); rounding up would read the odd pixels'
    # 1.3125-1.4375
    s = tvol.sdf.numpy()[:, :, 8]
    seen = tm[:, :, 8]
    assert seen.sum() > 50
    assert set(np.unique(np.round(s[seen], 6))) == {0.25}


def test_sdf_at_minus_truncation_is_not_fused():
    """A flat depth of 1.0 m, truncation 0.25, no depth scale and a sample
    weight of 1: the voxel at z = 1.25 has sdf = -0.25 = -truncation
    exactly and takes no sample, the one at z = 1.1875 (sdf -0.1875) does,
    in both packages."""
    cams = _both(_exact_camera)
    fusions = _both(lambda m: m.FusionConfig(
        voxel_size=0.0625, truncation=0.25, trunc_scale=0.0,
        depth_weight_falloff=False))
    depth = np.ones((60, 80), np.float32)
    jvol, tvol = _volumes((32, 32, 24), ((-1.0, -1.0, 0.5), 0.0625))
    jvol, tvol, jm, tm = _fuse_both(jvol, tvol, depth, np.eye(4), cams,
                                    fusions)
    _assert_close(jvol, tvol, jm, tm, "band edge")
    k_edge, k_in = 12, 11            # z = 0.5 + k / 16
    centre = (16, 16)
    assert not tm[centre + (k_edge,)] and not jm[centre + (k_edge,)]
    assert tm[centre + (k_in,)]
    assert float(tvol.sdf[centre + (k_in,)]) == -0.1875


def test_wrapper_refusals_before_launch():
    """What K20 does not take raises in the wrapper, before any launch:
    tensors not on a CUDA device (or mixed), a volume of 2^31 voxels or
    more, an empty volume; the host tables hold the float32 of the plain
    version's doubles."""
    cam = tcfg.tiny_config().camera
    fusion = tcfg.FusionConfig(voxel_size=0.04, truncation=0.16)
    _, vol = _volumes((8, 6, 4), ((0.0, 0.0, 0.5), 0.04))
    depth, T = torch.zeros(60, 80), torch.eye(4)
    with pytest.raises(ValueError, match="one CUDA device"):
        ttsdf._launch_dense(vol, depth, T, cam, fusion)
    with pytest.raises(ValueError, match="2\\^31"):
        ttsdf._dense_tables(cam, fusion, (2048, 1024, 1024))
    with pytest.raises(ValueError, match="at least one voxel"):
        ttsdf._dense_tables(cam, fusion, (8, 0, 4))
    ints, floats = ttsdf._dense_tables(cam, fusion, (8, 6, 4))
    assert list(ints) == [8, 6, 4, 60, 80, 1]
    want = (cam.fx, cam.fy, cam.cx, cam.cy, fusion.truncation,
            fusion.trunc_scale, fusion.weight_sample,
            fusion.weight_sample * 1.5, cam.depth_min,
            1.0 / np.float32(cam.depth_max - cam.depth_min),
            fusion.max_weight)
    assert list(floats) == [np.float32(x) for x in want]
    assert ttsdf._dense_tables(cam, fusion, (8, 6, 4))[0] is ints


def test_dense_kernel_arguments_match_the_source():
    """K20's ctypes argument list (kernels.KERNELS) has as many entries as
    its C entry point in csrc/dense.cu has parameters, pointers where it
    takes pointers, built from that source."""
    import re
    from pathlib import Path

    from voxelhashing_demo_tpu_torch import kernels

    src = (Path(kernels.SRC_DIR) / "dense.cu").read_text()
    assert kernels.source_of("integrate_dense") == "dense"
    m = re.search(r'extern "C" int integrate_dense\(([^)]*)\)', src)
    assert m
    params = [p.strip() for p in m.group(1).split(",")]
    types = kernels.KERNELS["integrate_dense"]
    assert len(params) == len(types)
    for p, t in zip(params, types):
        assert ("*" in p) == (t is kernels._P), p
        if "*" not in p:
            assert p.startswith("float") == (t is kernels._F), p


def test_pack_model_is_pack_target_on_cpu(orbit):
    """``pack_model`` (the dense step's ICP target; one K3b pack job on the
    card) is ``icp.pack_target`` on CPU tensors."""
    from voxelhashing_demo_tpu_torch.ops import icp

    cam = tcfg.tiny_config().camera
    model = tpre.preprocess_metric(tt(orbit[0][0]), cam)
    assert torch.equal(tpre.pack_model(model, cam), icp.pack_target(model))


def test_chip_smoke_dense_config_is_the_reference_one():
    """chip_smoke.py's dense configuration is the one the JAX reference
    figures were taken at (tests/torch_port_reference.py)."""
    import chip_smoke
    import torch_port_reference

    j, t = torch_port_reference.dense_config(), chip_smoke.dense_config()
    for field in ("camera", "frontend", "icp", "fusion", "grid", "raycast"):
        assert (dataclasses.asdict(getattr(j, field))
                == dataclasses.asdict(getattr(t, field))), field
    assert tuple(t.grid.dims) == chip_smoke.DENSE_DIMS
