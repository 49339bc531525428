"""K16 ``ops/image_gather.take_flat`` against the six Pallas gather probe
sites and their XLA baselines, on the CPU.

Each probe (``tools/exp_pallas_vmem_gather.py``, ``exp_pallas_gather.py``,
``exp_pallas_integrate.py``) is run once as it stands, every
``pallas_call`` in interpret mode, and its own arrays are fed to both
packages.  Tolerance: bit-exact (the one-hot lane sum of
``exp_pallas_gather.py`` returns +0.0 for a -0.0 pixel, so the port's
value is compared after adding +0.0).  Also: the out-of-range contract
(NaN), the port's tools ``exp_vmem_gather``, ``exp_gather`` and
``exp_landed`` on the CPU, and no quiet fallback for tensors off the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_bits_equal, pallas_probe, tt
from voxelhashing_demo_tpu_torch.ops import image_gather as ig
from voxelhashing_demo_tpu_torch.tools import (exp_gather, exp_landed,
                                               exp_vmem_gather)
from voxelhashing_demo_tpu_torch.tools import exp_integrate as t_integrate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vmem():
    with pallas_probe("exp_pallas_vmem_gather") as ns:
        yield ns


@pytest.fixture(scope="module")
def gather():
    with pallas_probe("exp_pallas_gather") as ns:
        yield ns


@pytest.fixture(scope="module")
def integrate():
    with pallas_probe("exp_pallas_integrate", "--interpret") as ns:
        yield ns


@pytest.mark.parametrize("site", ["pallas_take", "pallas_take2",
                                  "pallas_taa", "xla"])
def test_take_flat_matches_vmem_gather_sites(vmem, site):
    img, idx = tt(vmem["img"]), tt(vmem["idx"])
    if site == "pallas_take":
        want = jax.jit(vmem["pallas_take"])(vmem["idx"])
        got = ig.take_flat(img, idx)
    elif site == "pallas_take2":
        want = jax.jit(vmem["pallas_take2"])(vmem["idx2d"])
        got = ig.take_flat(img, tt(vmem["idx2d"]))
    elif site == "pallas_taa":
        want = jax.jit(vmem["pallas_taa"])(vmem["r"], vmem["c"])
        got = ig.take_flat(tt(vmem["img2"]), (tt(vmem["r"]), tt(vmem["c"])),
                           cols=vmem["W"])
    else:
        want = jax.jit(lambda i: vmem["img"][i])(vmem["idx"])
        got = ig.take_flat(img, idx)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("site", ["pallas_gather", "xla"])
def test_take_flat_matches_gather_sites(gather, site):
    img, idx = tt(gather["img"]), tt(gather["idx"])
    got = ig.take_flat(img, idx)
    if site == "pallas_gather":
        assert_bits_equal(got + 0.0,
                          gather["pallas_gather"](gather["img"],
                                                  gather["idx"]))
    else:
        assert_bits_equal(got, gather["ref"])


@pytest.mark.parametrize("site", ["pallas_take_all", "pallas_take_block",
                                  "xla_gather"])
def test_chunk_gather_matches_integrate_sites(integrate, site):
    """Project, K16, mask: the probe's whole-chunk, per-block and XLA
    gathers of one integrate chunk."""
    depth, blocks = integrate["depth"], integrate["blocks"]
    got = t_integrate.gather_chunk(tt(depth), tt(blocks))
    assert_bits_equal(got, integrate[site](depth, blocks))
    assert_bits_equal(t_integrate.gather_chunk_plain(tt(depth), tt(blocks)),
                      got)


def test_take_flat_out_of_range_is_nan():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([[0, 11], [-1, 12]], dtype=torch.int32)
    got = ig.take_flat(img, idx)
    assert got.shape == (2, 2)
    assert got[0].tolist() == [0.0, 11.0]
    assert bool(torch.isnan(got[1]).all())
    r = torch.tensor([0, 2, 3, 1], dtype=torch.int32)
    c = torch.tensor([1, 3, 0, 4], dtype=torch.int32)
    got = ig.take_flat(img, (r, c), cols=4)
    assert got[:2].tolist() == [1.0, 11.0] and bool(torch.isnan(got[2]))
    assert got[3].item() == 8.0          # r * cols + c = 8: in range
    assert bool(torch.isnan(ig.take_flat(torch.empty(0), idx)).all())


def test_take_flat_refuses_tensors_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    takes CUDA tensors only: no quiet fallback."""
    img = torch.zeros((4, 4), device="meta")
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ig.take_flat(img, idx)
    with pytest.raises(ValueError, match="CUDA"):
        ig.take_flat(torch.zeros((4, 4)), idx)


@pytest.mark.parametrize("tool", [exp_vmem_gather, exp_gather])
def test_port_tool_runs_on_the_cpu(tool, capsys):
    """The tool's variants on its own inputs: every one equal to the
    plain version; nothing is timed without a card."""
    out = tool.main(device="cpu")
    text = capsys.readouterr().out
    assert "not measured" in text and "device: cpu" in text
    compared = [v for v in out.values() if "bit_exact" in v]
    assert len(compared) >= 2 and all(v["bit_exact"] for v in compared)
    assert not any("ms" in v for v in out.values())


def test_port_tool_inputs_follow_the_probes():
    """Shapes, types and ranges of the tools' inputs are the probes'."""
    a = exp_vmem_gather.inputs()
    assert a["img"].shape == (480 * 640,) and a["img"].dtype == np.float32
    assert a["idx"].shape == (65536,) and a["idx"].dtype == np.int32
    assert a["r"].shape == (512, 128) and int(a["r"].max()) < 480
    np.testing.assert_array_equal(a["r"] * 640 + a["c"], a["idx2d"])
    b = exp_gather.inputs()
    assert b["idx"].shape == (1 << 19,) and int(b["idx"].max()) < 480 * 640
    c = exp_landed.inputs()
    assert c["v"].shape == (128, 512) and c["valid"].dtype == bool


def test_port_tools_default_to_the_card():
    """Without a device the tools go to the CUDA card; without one they
    fail before running anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for tool in (exp_vmem_gather, exp_gather):
        with pytest.raises((AssertionError, RuntimeError)):
            tool.main()


def test_landed_tool_runs_on_the_cpu(capsys):
    """K1 and K2 against their plain versions and the plain gather on the
    probe's footprints, then the frame step with the gather off and on,
    on the tiny camera."""
    from voxelhashing_demo_tpu_torch.config import tiny_config

    out = exp_landed.main(device="cpu", config=tiny_config())
    for k in ("window gather (compact) (K1)", "window gather (streamed) (K2)"):
        assert out[k]["bit_exact"] and out[k]["max_abs_err_vs_xla"] == 0.0
    assert set(out) >= {"full step (XLA gather)",
                        "full step (window gather K1)"}
    assert "device: cpu" in capsys.readouterr().out
