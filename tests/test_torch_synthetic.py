"""The port's synthetic data (utils/synthetic.py) against the JAX
package's: the room scene, its sphere-traced depth, the room-sweep and
ramp trajectories, and the sensor noise model.

Tolerances:
- ``room_sdf`` on random points: atol 1e-6.
- ``render_depth(sdf=room_sdf)``: metric depth within 1e-5 m on >= 99.9%
  of the pixels, raw uint16 equal on >= 99.9% (sphere tracing in float32
  with another op order can stop one step apart at a depth edge).
- poses (``room_sweep_pose``, ``make_room_sweep``, ``make_ramp_sequence``):
  atol 1e-6.
- the noise core: the five random fields are drawn with ``jax.random``
  from the split of one key, as ``add_sensor_noise`` splits it, and handed
  to the port's core as numpy; the result agrees with ``add_sensor_noise``
  within 1e-6 m, with and without ``disparity_quant`` (XLA contracts
  ``z + sigma * n`` into an FMA: one ulp of a depth up to 4 m).
- the wrapper that draws from a ``torch.Generator`` is held to the
  statistics tests/test_noise.py holds the JAX model to, and to
  determinism in its seed.  The two packages' random streams differ, so
  noisy frames are not compared pixel by pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tt

from voxelhashing_demo_tpu.config import CameraConfig as JCam
from voxelhashing_demo_tpu.utils import synthetic as jsyn
from voxelhashing_demo_tpu_torch.config import CameraConfig as TCam
from voxelhashing_demo_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM_KW = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.65, cy=59.8)
JCAM, TCAM = JCam(**CAM_KW), TCam(**CAM_KW)


def test_room_sdf_matches():
    rng = np.random.default_rng(0)
    p = rng.uniform([-2.5, -1.5, -1.5], [2.5, 1.2, 3.5],
                    size=(4096, 3)).astype(np.float32)
    np.testing.assert_allclose(tsyn.room_sdf(tt(p)).numpy(),
                               np.asarray(jsyn.room_sdf(jnp.asarray(p))),
                               atol=1e-6)


@pytest.mark.parametrize("phase", [0.0, 0.3, 0.8])
def test_room_render_matches(phase):
    T = jsyn.room_sweep_pose(phase, 360.0)
    np.testing.assert_allclose(tsyn.room_sweep_pose(phase, 360.0), T,
                               atol=1e-6)
    dj = jsyn.render_depth(jnp.asarray(T), JCAM, sdf=jsyn.room_sdf)
    dt = tsyn.render_depth(tt(T), TCAM, sdf=tsyn.room_sdf)
    close = np.abs(dt.numpy() - np.asarray(dj)) <= 1e-5
    assert close.mean() >= 0.999
    rj = np.asarray(jsyn.depth_to_raw(dj, JCAM))
    rt = tsyn.depth_to_raw(dt, TCAM)
    assert rt.dtype == np.uint16 and (rt == rj).mean() >= 0.999
    assert (rt > 0).mean() > 0.9          # the room fills the view


def test_room_sweep_poses_match():
    _, pj = jsyn.make_room_sweep(JCAM, 6, sweep_deg=70.0)
    dt, pt = tsyn.make_room_sweep(TCAM, 6, sweep_deg=70.0, device="cpu")
    for a, b in zip(pt, pj):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(pt[0], np.eye(4), atol=1e-6)
    assert dt[0].dtype == np.uint16 and dt[0].shape == (120, 160)


def test_ramp_sequence_matches():
    dj, pj = jsyn.make_ramp_sequence(JCAM, 5)
    dt, pt = tsyn.make_ramp_sequence(TCAM, 5, device="cpu")
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(dt, dj):
        assert (a == np.asarray(b)).mean() >= 0.99


def _jax_fields(key, shape):
    """The five fields as add_sensor_noise draws them from ``key``."""
    k_ax, k_edge, k_drop, k_out, k_outz = jax.random.split(key, 5)
    return (jax.random.normal(k_ax, shape, dtype=jnp.float32),
            jax.random.uniform(k_edge, shape),
            jax.random.uniform(k_drop, shape),
            jax.random.uniform(k_out, shape),
            jax.random.uniform(k_outz, shape, minval=0.4, maxval=4.0))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("scene", ["orbit", "room"])
def test_noise_core_matches_add_sensor_noise(scene, quant):
    if scene == "orbit":
        d = jsyn.render_depth(jnp.eye(4), JCAM)
    else:
        d = jsyn.render_depth(jnp.asarray(jsyn.room_sweep_pose(0.1)), JCAM,
                              sdf=jsyn.room_sdf)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsyn.add_sensor_noise(d, key, disparity_quant=quant))
    fields = [tt(f) for f in _jax_fields(key, d.shape)]
    got = tsyn.sensor_noise_core(tt(d), *fields,
                                 disparity_quant=quant).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert ((want == 0) & (np.asarray(d) > 0)).mean() > 0.005


def test_noise_wrapper_statistics():
    """The checks of tests/test_noise.py::test_sensor_noise_statistics on
    the port's generator-driven wrapper."""
    clean_t = tsyn.render_depth(torch.eye(4), TCAM)
    n1 = tsyn.add_sensor_noise(
        clean_t, torch.Generator().manual_seed(7)).numpy()
    n2 = tsyn.add_sensor_noise(
        clean_t, torch.Generator().manual_seed(7)).numpy()
    n3 = tsyn.add_sensor_noise(
        clean_t, torch.Generator().manual_seed(8)).numpy()
    np.testing.assert_array_equal(n1, n2)
    assert not np.array_equal(n1, n3)

    clean = clean_t.numpy()
    was_valid = clean > 0
    assert not np.any((~was_valid) & (n1 > 0)), "noise must not create depth"
    drop = np.mean((n1 == 0) & was_valid)
    assert 0.005 < drop < 0.25, f"dropout fraction {drop}"
    err = n1 - clean
    ok = (n1 > 0) & was_valid & (np.abs(err) < 0.05)
    near = ok & (clean < 1.8)
    far = ok & (clean > 2.2)
    assert err[near].std() < err[far].std()
    assert err[far].std() < 0.02
    outliers = np.mean(np.abs(err[(n1 > 0) & was_valid]) > 0.1)
    assert 0.0003 < outliers < 0.01, f"outlier fraction {outliers}"


def test_noise_fields_draw_order():
    """One documented draw order: normal, u_edge, u_drop, u_out, z_out."""
    g = torch.Generator().manual_seed(3)
    fields = tsyn.draw_noise_fields((4, 5), g)
    g2 = torch.Generator().manual_seed(3)
    want = [torch.randn((4, 5), generator=g2)] + [
        torch.rand((4, 5), generator=g2) for _ in range(4)]
    want[4] = 0.4 + 3.6 * want[4]
    for a, b in zip(fields, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert float(fields[4].min()) >= 0.4 and float(fields[4].max()) < 4.0


def test_noisy_sequences_are_functions_of_their_seed():
    a, _ = tsyn.make_room_sweep(TCAM, 3, sweep_deg=20.0, noise_seed=1,
                                device="cpu")
    b, _ = tsyn.make_room_sweep(TCAM, 3, sweep_deg=20.0, noise_seed=1,
                                device="cpu")
    c, _ = tsyn.make_room_sweep(TCAM, 3, sweep_deg=20.0, noise_seed=2,
                                device="cpu")
    clean, _ = tsyn.make_room_sweep(TCAM, 3, sweep_deg=20.0, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    assert not np.array_equal(a[0], a[1])      # frames draw on, not again
    dropped = np.mean((a[0] == 0) & (clean[0] > 0))
    assert 0.005 < dropped < 0.25
    d, _ = tsyn.make_sequence(TCAM, 2, noise_seed=5, device="cpu")
    e, _ = tsyn.make_sequence(TCAM, 2, noise_seed=5, device="cpu")
    np.testing.assert_array_equal(d[1], e[1])
