"""K17 ``ops/image_gather.take_along_axis`` and K18
``gather_window_two_step`` against the Pallas probe
``tools/exp_pallas_gather2.py`` (``f_axis0``, ``f_axis1``, ``f_axis1b``,
``f_full``), on the CPU.

The probe is run once as it stands (its module-level timing loop
included, ~30 s), every ``pallas_call`` in interpret mode, and its own
arrays are fed to both packages.  Tolerance: bit-exact.  Also numpy's
``take_along_axis`` on lengths that differ along the axis, the
out-of-range contract (NaN) and the port's tool ``exp_gather2`` on the
CPU.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_bits_equal, pallas_probe, tt
from voxelhashing_demo_tpu_torch.ops import image_gather as ig
from voxelhashing_demo_tpu_torch.tools import exp_gather2

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def probe():
    with pallas_probe("exp_pallas_gather2") as ns:
        yield ns


@pytest.mark.parametrize("site", ["f_axis0", "f_axis1", "f_axis1b"])
def test_take_along_axis_matches_probe(probe, site):
    if site == "f_axis0":
        args = (probe["v_idx"],)
        src, idx, axis = tt(probe["img"])[:256, :256], tt(probe["v_idx"]), 0
    elif site == "f_axis1":
        args = (probe["src"], probe["u_idx"])
        src, idx, axis = tt(probe["src"]), tt(probe["u_idx"]), 1
    else:
        args = (probe["src256"], probe["u256"])
        src, idx, axis = tt(probe["src256"]), tt(probe["u256"]), 1
    want = jax.jit(probe[site])(*args)
    got = ig.take_along_axis(src, idx, axis)
    assert_bits_equal(got, want)
    assert_bits_equal(got, np.take_along_axis(src.numpy(), idx.numpy(),
                                              axis))


def test_two_step_window_gather_matches_probe(probe):
    args = (probe["v0s"], probe["u0s"], probe["dv"], probe["du"])
    want = jax.jit(probe["f_full"])(*args)
    got = ig.gather_window_two_step(tt(probe["img"]), *(tt(a) for a in args),
                                    keep=128)
    assert got.shape == (128, 512, 128)
    assert_bits_equal(got, want)


def test_two_step_window_gather_matches_probe_with_own_du(probe):
    # the probe draws dv and du from one key, so dv == du there and a
    # swap of the two would pass the test above: here du is drawn apart
    du = np.random.default_rng(1).integers(
        0, probe["du"].shape[-1], probe["du"].shape).astype(np.int32)
    assert not np.array_equal(du, np.asarray(probe["dv"]))
    args = (probe["v0s"], probe["u0s"], probe["dv"], du)
    want = jax.jit(probe["f_full"])(*args)
    got = ig.gather_window_two_step(tt(probe["img"]), *(tt(a) for a in args),
                                    keep=128)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("axis,shape", [(0, (37, 9)), (0, (3, 9)),
                                        (1, (20, 31)), (1, (20, 2))])
def test_take_along_axis_lengths_differ(axis, shape):
    rng = np.random.default_rng(axis * 10 + shape[axis])
    src = rng.random((20, 9), dtype=np.float32)
    idx = rng.integers(0, src.shape[axis], shape).astype(np.int32)
    got = ig.take_along_axis(torch.from_numpy(src), torch.from_numpy(idx),
                             axis)
    assert_bits_equal(got, np.take_along_axis(src, idx, axis))


def test_take_along_axis_out_of_range_and_shape_checks():
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([[0, 2, 3, -1], [1, 1, 1, 1]], dtype=torch.int32)
    got = ig.take_along_axis(src, idx, 0)
    assert got[1].tolist() == [4.0, 5.0, 6.0, 7.0]
    assert got[0, :2].tolist() == [0.0, 9.0]
    assert bool(torch.isnan(got[0, 2:]).all())
    with pytest.raises(ValueError):
        ig.take_along_axis(src, idx[:, :3], 0)       # columns differ
    with pytest.raises(ValueError):
        ig.take_along_axis(src, idx, 2)


def test_two_step_out_of_range_is_nan():
    """A column or window row outside the window, or a pixel outside the
    image, gives NaN; the rest is the function."""
    img = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    S = 4
    dv = torch.zeros((2, 1, S), dtype=torch.int32)
    du = torch.tensor([[[0, 3, 4, -1]], [[1, 2, 0, 3]]], dtype=torch.int32)
    dv[0, 0] = torch.tensor([1, 0, 0, 2])
    dv[1, 0] = torch.tensor([5, 3, 1, 0])
    v0 = torch.tensor([0, 3], dtype=torch.int32)
    u0 = torch.tensor([0, 5], dtype=torch.int32)
    got = ig.gather_window_two_step(img, v0, u0, dv, du, keep=4)
    row0, row1 = got[0, 0], got[1, 0]
    assert row0[:2].tolist() == [img[1, 0].item(), img[2, 3].item()]
    assert bool(torch.isnan(row0[2:]).all())          # column 4, column -1
    assert row1[1].item() == img[4, 7].item()          # window row 1
    assert bool(torch.isnan(row1[0]))                  # pixel row 6 >= H
    assert bool(torch.isnan(row1[2]))                  # window row 5 >= S
    assert bool(torch.isnan(row1[3]))                  # pixel column 8 >= W
    assert ig.gather_window_two_step(img, v0, u0, dv, du, keep=1).shape == \
        (2, 1, 1)
    with pytest.raises(ValueError):
        ig.gather_window_two_step(img, v0, u0, dv, du, keep=5)


def test_port_tool_runs_on_the_cpu(capsys):
    out = exp_gather2.main(device="cpu")
    compared = [v for v in out.values() if "bit_exact" in v]
    assert len(compared) == 7 and all(v["bit_exact"] for v in compared)
    assert "device: cpu" in capsys.readouterr().out
