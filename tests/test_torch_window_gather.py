"""PyTorch port of the window depth gather (ops/window_gather.py) against
the JAX package's Pallas kernel run in interpret mode
(voxelhashing_demo_tpu/ops/pallas_gather.py), on the cases of
tests/test_pallas_gather.py at 480x640 (spread 120: full coverage; spread
400: clipped; invalid corner) and at the 80x60 test camera, where the
window is the whole image.

The streamed gather (``gather_depth_window_streamed``) goes through the
same cases against the JAX package's streamed Pallas kernel in interpret
mode, plus a row count that is no multiple of 8 (which the first JAX form
refuses), and its plain version is held against the first one's.

Tolerance: bit-exact on values and covered (the gather copies floats), and
equal window origins.  The CUDA kernels themselves are compared with these
plain versions on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tt

from voxelhashing_demo_tpu.ops import pallas_gather as pg
from voxelhashing_demo_tpu_torch.ops import window_gather as wg

torch.set_num_threads(1)

C, V = 16, 512


def _case(kind, H, W, seed, C=C):
    rng = np.random.default_rng(seed)
    depth = (rng.random((H, W), dtype=np.float32) + 0.5)
    if kind == "invalid_corner":
        v = np.full((C, V), min(100, H - 1))
        u = np.full((C, V), min(200, W - 1))
        valid = np.ones((C, V), bool)
        v[:, 0], u[:, 0], valid[:, 0] = H - 1, W - 1, False
    else:
        spread = min(kind, H - 1, W - 1)
        v0 = rng.integers(0, H - spread, size=(C, 1))
        u0 = rng.integers(0, W - spread, size=(C, 1))
        v = v0 + rng.integers(0, spread, size=(C, V))
        u = u0 + rng.integers(0, spread, size=(C, V))
        valid = rng.random((C, V)) > 0.15
    return depth, v.astype(np.int32), u.astype(np.int32), valid


CASES = [(120, 480, 640), (400, 480, 640), ("invalid_corner", 480, 640),
         (50, 60, 80), ("invalid_corner", 60, 80)]


@pytest.mark.parametrize("kind,H,W", CASES)
def test_matches_pallas_interpret_bit_exact(kind, H, W):
    depth, v, u, valid = _case(kind, H, W, seed=CASES.index((kind, H, W)))
    vj, cj = pg.gather_depth_window(jnp.asarray(depth), jnp.asarray(v),
                                    jnp.asarray(u), jnp.asarray(valid),
                                    interpret=True)
    before = wg.LAUNCHES
    vt, ct = wg.gather_depth_window(tt(depth), tt(v), tt(u), tt(valid))
    assert wg.LAUNCHES == before          # CPU tensors: plain version
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                  np.asarray(vj).view(np.int32))
    if kind == 400:
        assert ct.sum() < tt(valid).sum()   # something genuinely clipped
    else:
        assert bool(torch.equal(ct, tt(valid)))


@pytest.mark.parametrize("kind,H,W", CASES)
def test_window_origins_equal(kind, H, W):
    _, v, u, valid = _case(kind, H, W, seed=7)
    oj = pg.window_origins(jnp.asarray(v), jnp.asarray(u),
                           jnp.asarray(valid), H, W)
    ot = wg.window_origins(tt(v), tt(u), tt(valid), H, W)
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


STREAMED_CASES = [(kind, H, W, C) for kind, H, W in CASES] + [
    (120, 480, 640, 13), (50, 60, 80, 3)]      # C % 8 != 0


@pytest.mark.parametrize("kind,H,W,rows", STREAMED_CASES)
def test_streamed_matches_pallas_interpret_bit_exact(kind, H, W, rows):
    depth, v, u, valid = _case(kind, H, W, seed=11 + rows, C=rows)
    vj, cj = pg.gather_depth_window_streamed(
        jnp.asarray(depth), jnp.asarray(v), jnp.asarray(u),
        jnp.asarray(valid), interpret=True)
    before = wg.LAUNCHES_STREAMED
    vt, ct = wg.gather_depth_window_streamed(tt(depth), tt(v), tt(u),
                                             tt(valid))
    assert wg.LAUNCHES_STREAMED == before   # CPU tensors: plain version
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                  np.asarray(vj).view(np.int32))
    if kind == 400:
        assert ct.sum() < tt(valid).sum()
    else:
        assert bool(torch.equal(ct, tt(valid)))


@pytest.mark.parametrize("kind,H,W,rows", STREAMED_CASES)
def test_two_plain_versions_agree(kind, H, W, rows):
    """Two independent statements of one contract: the direct gather and
    the window-slice / row-pick / column-pick form."""
    depth, v, u, valid = _case(kind, H, W, seed=23 + rows, C=rows)
    a, a_cov = wg.gather_depth_window_reference(tt(depth), tt(v), tt(u),
                                                tt(valid))
    b, b_cov = wg.gather_depth_window_streamed_reference(
        tt(depth), tt(v), tt(u), tt(valid))
    assert torch.equal(a_cov, b_cov) and torch.equal(a, b)


def test_streamed_takes_any_row_length():
    """V that is no multiple of 4 (the kernel's scalar path); here only
    the plain versions run."""
    rng = np.random.default_rng(5)
    depth = tt(rng.random((60, 80), dtype=np.float32) + 0.5)
    v = tt(rng.integers(0, 60, (5, 30)).astype(np.int32))
    u = tt(rng.integers(0, 80, (5, 30)).astype(np.int32))
    valid = tt(rng.random((5, 30)) > 0.2)
    a, a_cov = wg.gather_depth_window_streamed(depth, v, u, valid)
    ref = torch.where(valid, depth[v.long(), u.long()], 0.0)
    assert torch.equal(a_cov, valid) and torch.equal(a, ref)


@pytest.mark.parametrize("fn", [wg.gather_depth_window,
                                wg.gather_depth_window_streamed])
def test_empty_rows(fn):
    z = torch.zeros((0, V), dtype=torch.int32)
    vals, cov = fn(torch.ones((60, 80)), z, z,
                   torch.zeros((0, V), dtype=torch.bool))
    assert vals.shape == (0, V) and cov.dtype == torch.bool


@pytest.mark.parametrize("fn", [wg.gather_depth_window,
                                wg.gather_depth_window_streamed])
def test_non_cpu_tensors_never_take_the_plain_version(fn):
    """Off the CPU the wrapper launches its kernel or raises; tensors on a
    device that is not CUDA (here: meta) are refused, not served by the
    plain version."""
    m = dict(device="meta")
    with pytest.raises(ValueError):
        fn(
            torch.empty((60, 80), **m), torch.empty((8, V), dtype=torch.int32, **m),
            torch.empty((8, V), dtype=torch.int32, **m),
            torch.empty((8, V), dtype=torch.bool, **m))
