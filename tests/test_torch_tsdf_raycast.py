"""The port's dense TSDF (ops/tsdf.py) and sphere tracer (ops/raycast.py)
against the JAX package's, on one small volume: the 80x60 test camera and
tiny_config's 64^3 grid at 4 cm voxels, placed so that it holds the
synthetic scene.  The JAX functions run jitted, as the JAX step runs them
(a jitted division by a config constant is a reciprocal multiply; by the
volume's ``voxel_size`` array it is a true division).

Tolerances:
- ``integrate_dense``, three frames at the ground-truth poses: sdf and
  weight within 1e-5 everywhere (XLA contracts multiply-adds into FMAs).
- ``trilinear_sample`` / ``sdf_gradient`` on random positions, a third of
  them outside the volume: ``known`` masks equal, values within 1e-5.
- ``raycast_dense``, both normal modes: hit masks equal on >= 99.9% of
  the pixels; where both hit, depth within 1e-4 m and normals within 1e-3
  on >= 99.9% (64 adaptive march steps feed per-step rounding back into
  the next position).
- the NaN secant step of a ray that starts inside the surface is kept: no
  output is NaN and such rays miss in both packages.
- ``shade``: 1e-5.
- On CPU tensors ``raycast_rays`` is ``raycast_rays_reference`` bit for
  bit, in both normal modes (K11 runs only on the card); K11's and K12's
  ctypes argument lists match their C entry points; what they do not take
  raises before any launch.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_sequence, np_tree, tt

from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.ops import raycast as jrc
from voxelhashing_demo_tpu.ops import tsdf as jtsdf
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.ops import preprocess as tpre
from voxelhashing_demo_tpu_torch.ops import raycast as trc
from voxelhashing_demo_tpu_torch.ops import tsdf as ttsdf

torch.set_num_threads(1)

N_FUSE = 3


def _cfg(mod):
    base = mod.tiny_config()
    return dataclasses.replace(
        base,
        fusion=mod.FusionConfig(voxel_size=0.04, truncation=0.16),
        grid=mod.DenseGridConfig(dims=(64, 64, 64),
                                 origin=(-1.28, -1.0, 0.0)),
    )


@pytest.fixture(scope="module")
def fused():
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    depths, poses = jax_sequence(jc.camera, 6)
    jint = jax.jit(jtsdf.integrate_dense, static_argnames=("cam", "fusion"))
    jvol = jtsdf.create_dense(jc.grid, jc.fusion)
    tvol = ttsdf.create_dense(tc.grid, tc.fusion, device="cpu")
    for d, T in list(zip(depths, poses))[:N_FUSE]:
        jd = jpre.depth_to_meters(jnp.asarray(d), jc.camera)
        td = tpre.depth_to_meters(tt(d.astype(np.int32)), tc.camera)
        jvol = jint(jvol, jd, jnp.asarray(T), jc.camera, jc.fusion)
        tvol = ttsdf.integrate_dense(tvol, td, tt(T), tc.camera, tc.fusion)
    return dict(jc=jc, tc=tc, jvol=jvol, tvol=tvol, poses=poses)


def test_create_dense_matches(fused):
    j = np_tree(jtsdf.create_dense(fused["jc"].grid, fused["jc"].fusion))
    t = convert.dense_tsdf_to_numpy(
        ttsdf.create_dense(fused["tc"].grid, fused["tc"].fusion,
                           device="cpu"))
    assert set(j) == set(t)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_voxel_world_positions_match(fused):
    np.testing.assert_allclose(
        ttsdf.voxel_world_positions(fused["tvol"]).numpy(),
        np.asarray(jtsdf.voxel_world_positions(fused["jvol"])), atol=1e-6)


def test_integrate_dense_matches(fused):
    j, t = fused["jvol"], fused["tvol"]
    assert float(t.weight.max()) > 0 and (t.weight > 0).float().mean() > 0.02
    np.testing.assert_allclose(t.sdf.numpy(), np.asarray(j.sdf), atol=1e-5)
    np.testing.assert_allclose(t.weight.numpy(), np.asarray(j.weight),
                               atol=1e-5)


def test_dense_tsdf_roundtrip(fused):
    d = np_tree(fused["jvol"])
    back = convert.dense_tsdf_to_numpy(
        convert.dense_tsdf_from_numpy(d, device="cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])


def _positions():
    rng = np.random.default_rng(3)
    inside = rng.uniform([-1.2, -0.9, 0.1], [1.2, 1.4, 2.5], size=(4000, 3))
    outside = rng.uniform([-3.0, -3.0, -1.0], [3.0, 3.0, 4.0],
                          size=(2000, 3))
    return np.concatenate([inside, outside]).astype(np.float32)


def test_trilinear_sample_matches(fused):
    # the JAX volume carried across, so that only the sampler differs
    tvol = convert.dense_tsdf_from_numpy(np_tree(fused["jvol"]),
                                         device="cpu")
    p = _positions()
    js, jw = jax.jit(jtsdf.trilinear_sample)(fused["jvol"], jnp.asarray(p))
    ts, tw = ttsdf.trilinear_sample(tvol, tt(p))
    jk, tk = np.asarray(jw) > 0, tw.numpy() > 0
    np.testing.assert_array_equal(tk, jk)
    assert 0.05 < tk.mean() < 0.9          # known and unknown both occur
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_sdf_gradient_matches(fused):
    tvol = convert.dense_tsdf_from_numpy(np_tree(fused["jvol"]),
                                         device="cpu")
    p = _positions()
    jg = jax.jit(jtsdf.sdf_gradient)(fused["jvol"], jnp.asarray(p))
    tg = ttsdf.sdf_gradient(tvol, tt(p))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5)
    assert np.abs(np.asarray(jg)).max() > 0.5


def test_sample_weight_matches(fused):
    jc, tc = fused["jc"], fused["tc"]
    d = np.linspace(0.0, 5.0, 501, dtype=np.float32)
    jw = jax.jit(partial(jtsdf.sample_weight, cam=jc.camera,
                         fusion=jc.fusion))(jnp.asarray(d))
    np.testing.assert_allclose(
        ttsdf.sample_weight(tt(d), tc.camera, tc.fusion).numpy(),
        np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("normal_mode", ["gradient", "image"])
@pytest.mark.parametrize("volume", ["carried", "own"])
def test_raycast_dense_matches(fused, normal_mode, volume):
    jc, tc = fused["jc"], fused["tc"]
    jrcfg = dataclasses.replace(jc.raycast, normal_mode=normal_mode)
    trcfg = dataclasses.replace(tc.raycast, normal_mode=normal_mode)
    tvol = (fused["tvol"] if volume == "own" else
            convert.dense_tsdf_from_numpy(np_tree(fused["jvol"]),
                                          device="cpu"))
    T = fused["poses"][1]
    jo = jrc.raycast_dense(fused["jvol"], jnp.asarray(T), jc.camera, jrcfg,
                           jc.fusion)
    to = trc.raycast_dense(tvol, tt(T), tc.camera, trcfg, tc.fusion)
    jh, th = np.asarray(jo.hit), to.hit.numpy()
    assert (jh == th).mean() >= 0.999
    assert th.mean() > 0.3          # the back wall lies outside the grid
    both = jh & th
    for f in ("depth", "points", "normals"):
        assert np.isfinite(getattr(to, f).numpy()).all(), f
    d_ok = np.abs(to.depth.numpy() - np.asarray(jo.depth))[both] <= 1e-4
    assert d_ok.mean() >= 0.999
    n_ok = np.abs(to.normals.numpy() - np.asarray(jo.normals))[both].max(
        axis=-1) <= 1e-3
    assert n_ok.mean() >= 0.999
    p_ok = np.abs(to.points.numpy() - np.asarray(jo.points))[both].max(
        axis=-1) <= 1e-4
    assert p_ok.mean() >= 0.999
    # model_frame packs the same maps
    m = trc.model_frame(to)
    assert m.depth is to.depth and m.vertices is to.points

    np.testing.assert_allclose(trc.shade(to).numpy()[both],
                               np.asarray(jrc.shade(jo))[both], atol=1e-3)


def test_shade_matches(fused):
    """shade on the SAME raycast maps (the JAX output carried across)."""
    jc = fused["jc"]
    jo = jrc.raycast_dense(fused["jvol"], jnp.asarray(fused["poses"][0]),
                           jc.camera, jc.raycast, jc.fusion)
    to = trc.RaycastOutput(*(tt(np.asarray(x)) for x in jo))
    for light in ((0.0, 0.0, -1.0), (0.3, -0.5, -1.0)):
        np.testing.assert_allclose(trc.shade(to, light).numpy(),
                                   np.asarray(jrc.shade(jo, light)),
                                   atol=1e-5)


def test_ray_starting_inside_the_surface_misses(fused):
    """A camera pushed into the wall band: the first known sample is
    already <= 0, the secant step is inf/inf = NaN, and the ray is
    rejected, in both packages, with no NaN in the output."""
    jc, tc = fused["jc"], fused["tc"]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.0, 0.1, 1.35)            # inside the sphere's band
    tvol = convert.dense_tsdf_from_numpy(np_tree(fused["jvol"]),
                                         device="cpu")
    jo = jrc.raycast_dense(fused["jvol"], jnp.asarray(T), jc.camera,
                           jc.raycast, jc.fusion)
    to = trc.raycast_dense(tvol, tt(T), tc.camera, tc.raycast, tc.fusion)
    jh, th = np.asarray(jo.hit), to.hit.numpy()
    assert (jh == th).mean() >= 0.999
    assert (~th).sum() > 0
    for x in to:
        assert not torch.isnan(x.float()).any()
    centre = (tc.camera.height // 2, tc.camera.width // 2)
    assert not th[centre] and not jh[centre]


@pytest.mark.parametrize("normal_mode", ["gradient", "image"])
def test_raycast_rays_on_cpu_is_the_plain_version(fused, normal_mode):
    from voxelhashing_demo_tpu_torch.geometry import camera as tcam

    tc = fused["tc"]
    rc = dataclasses.replace(tc.raycast, normal_mode=normal_mode)
    T = tt(fused["poses"][1])
    rays = tcam.pixel_rays(tc.camera, device="cpu")[10:40]
    before = trc.LAUNCHES_MARCH
    got = trc.raycast_rays(fused["tvol"], T, rays, rc)
    want = trc.raycast_rays_reference(fused["tvol"], T, rays, rc)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert trc.LAUNCHES_MARCH == before
    assert want.hit.float().mean() > 0.1


def test_march_kernel_arguments_match_the_source():
    """K11's and K12's ctypes argument lists (kernels.KERNELS) have as
    many entries as their C entry points in csrc/raycast.cu have
    parameters, pointers where they take pointers, both built from that
    one source."""
    import re
    from pathlib import Path

    from voxelhashing_demo_tpu_torch import kernels

    src = (Path(kernels.SRC_DIR) / "raycast.cu").read_text()
    for name in ("raycast_march", "densify_cache"):
        assert kernels.source_of(name) == "raycast"
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        types = kernels.KERNELS[name]
        assert len(params) == len(types), name
        for p, t in zip(params, types):
            assert ("*" in p) == (t is kernels._P), (name, p)
            if "*" not in p:
                assert p.startswith("float") == (t is kernels._F), (name, p)


def test_march_wrappers_refuse_before_launch(fused):
    """What K11 and K12 do not take raises in their wrappers: a volume
    dimension below 2, a negative max_steps, a block size above 10, a
    cache of 2^31 cells or more, tensors that are not on a CUDA device."""
    from voxelhashing_demo_tpu_torch.ops import hash_raycast as thr

    rc = fused["tc"].raycast
    with pytest.raises(ValueError, match=">= 2"):
        trc._march_tables(rc, (1, 64, 64))
    with pytest.raises(ValueError, match="max_steps"):
        trc._march_tables(dataclasses.replace(rc, max_steps=-1),
                          (64, 64, 64))
    ints, floats = trc._march_tables(rc, (64, 56, 72))
    assert list(ints) == [64, 56, 72, rc.max_steps, 1]
    assert list(floats) == [np.float32(x) for x in (
        rc.step_scale, rc.min_step, rc.coarse_step, rc.near, rc.far)]
    with pytest.raises(ValueError, match="one CUDA device"):
        trc._launch_march(fused["tvol"], torch.eye(4),
                          torch.zeros(2, 2, 3), rc)
    hcfg = tcfg.HashConfig()
    fus = fused["tc"].fusion
    with pytest.raises(ValueError, match="block sizes"):
        thr._densify_tables(dataclasses.replace(hcfg, block_size=11), fus,
                            (64, 64, 64))
    with pytest.raises(ValueError, match="2\\^31"):
        thr._densify_tables(hcfg, fus, (2048, 1024, 1024))
    ints, floats = thr._densify_tables(hcfg, fus, (64, 56, 72))
    assert list(ints) == [hcfg.block_size, 64, 56, 72]
    assert floats[1] == np.float32(1.0) / np.float32(fus.voxel_size)
    with pytest.raises(ValueError, match="one CUDA device"):
        thr._launch_densify(torch.zeros(4, 3, dtype=torch.int32),
                            torch.zeros(4, hcfg.voxels_per_block),
                            torch.zeros(4, hcfg.voxels_per_block), hcfg, fus,
                            torch.eye(4), (64, 64, 64),
                            valid=torch.ones(4, dtype=torch.bool))
