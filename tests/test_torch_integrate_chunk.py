"""``ops/integrate_chunk`` against the Pallas probe
``tools/exp_pallas_integrate.py`` (run with its own ``--interpret``
switch), on the CPU.

Tolerances: ``project_indices`` flat indices and in-image flags exact, z
within 1e-6; K19's plain version (``integrate_chunk``) and the plain
integrate (``integrate_blocks_plain``) against ``pallas_integrate`` and
``xla_integrate``: weights exact, tsdf within 1e-6 (the FMA tier: XLA:CPU
may contract ``t * w + sdf * w_new`` into one rounding, PyTorch rounds each
operation, as the CUDA kernel does with its ``_rn`` intrinsics).  On the
probe's zero rows and on rows from a numpy seed with weights 0-255 and
tsdf within +-0.1, so the ``old_w > 0`` branch and the 255 cap run.
"""

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import pallas_probe, tt
from voxelhashing_demo_tpu_torch.ops import integrate_chunk as ic
from voxelhashing_demo_tpu_torch.tools import exp_integrate

torch.set_num_threads(1)

TSDF_ATOL = 1e-6


@pytest.fixture(scope="module")
def probe():
    with pallas_probe("exp_pallas_integrate", "--interpret") as ns:
        yield ns


def _seen_rows(seed: int):
    rng = np.random.default_rng(seed)
    tsdf = rng.uniform(-0.1, 0.1, (128, 512)).astype(np.float32)
    w = rng.integers(0, 256, (128, 512)).astype(np.float32)
    w[:, :16] = 255.0          # at the cap
    w[:, 16:32] = 0.0          # first observation
    return tsdf, w


def _assert_rows(got, want):
    t_got, w_got = (np.asarray(a) for a in got)
    t_want, w_want = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(w_got, w_want)
    np.testing.assert_allclose(t_got, t_want, rtol=0, atol=TSDF_ATOL)


def test_probe_constants_match(probe):
    assert (ic.H, ic.W, ic.BS, ic.VOXEL, ic.TRUNC) == (
        probe["H"], probe["W"], probe["BS"], probe["VOXEL"], probe["TRUNC"])
    assert (ic.FX, ic.FY, ic.CX, ic.CY) == (probe["FX"], probe["FY"],
                                            probe["CX"], probe["CY"])
    assert (exp_integrate.C, exp_integrate.V) == (probe["C"], probe["V"])


def test_project_indices_matches_probe(probe):
    flat_j, in_j, z_j = jax.jit(probe["project_indices"])(probe["blocks"])
    flat, in_img, z = ic.project_indices(tt(probe["blocks"]))
    assert flat.dtype == torch.int32 and in_img.dtype == torch.bool
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    np.testing.assert_array_equal(in_img.numpy(), np.asarray(in_j))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=0,
                               atol=1e-6)
    assert 0 < int(in_img.sum()) < in_img.numel()   # both sides of the edge


@pytest.mark.parametrize("rows", ["zero", "seen"])
@pytest.mark.parametrize("site", ["pallas_integrate", "xla_integrate"])
def test_integrate_matches_probe(probe, site, rows):
    depth, blocks = probe["depth"], probe["blocks"]
    if rows == "zero":
        t, w = probe["tsdf_rows"], probe["w_rows"]
    else:
        t, w = _seen_rows(1)
    want = probe[site](depth, blocks, t, w)
    args = (tt(depth), tt(blocks), tt(t), tt(w))
    _assert_rows(ic.integrate_blocks(*args), want)
    _assert_rows(ic.integrate_blocks_plain(*args), want)
    if rows == "seen":
        w_new = np.asarray(want[1])
        assert (w_new == 255.0).sum() > 16 * 128 // 2      # the cap ran
        assert ((np.asarray(w) > 0) & (w_new > np.asarray(w))).any()


def test_integrate_chunk_on_the_probes_flatw(probe):
    """``integrate_chunk`` on the flatw the probe packs: the kernel body's
    inputs exactly, both row sets."""
    flat, in_img, z = jax.jit(probe["project_indices"])(probe["blocks"])
    flatw = np.stack([np.asarray(flat, np.float32).reshape(-1),
                      np.asarray(z).reshape(-1),
                      np.asarray(in_img, np.float32).reshape(-1)])
    port_flatw = ic.pack_flatw(*ic.project_indices(tt(probe["blocks"])))
    np.testing.assert_array_equal(port_flatw.numpy(), flatw)
    for t, w in ((probe["tsdf_rows"], probe["w_rows"]), _seen_rows(2)):
        want = probe["pallas_integrate"](probe["depth"], probe["blocks"], t,
                                         w)
        got = ic.integrate_chunk(tt(probe["depth"]), torch.from_numpy(flatw),
                                 tt(t), tt(w), ic.TRUNC)
        _assert_rows(got, want)


def test_integrate_chunk_edge_voxels():
    """Off-image or fractional flat indices, non-positive depth, invalid
    voxels and sdf beyond +-trunc: what is not integrated passes through
    unchanged (weights stay, +0.0 added); the rest is clipped."""
    depth = torch.tensor([[1.0, 0.0], [-1.0, 2.0]])
    flatw = torch.tensor([
        [-1.0, 4.0, 1.0, 2.0, 0.9, 3.7, 3.0, 3.0],       # flat
        [1.0, 1.0, 1.0, 1.0, 1.05, 1.5, 1.5, 2.5],       # z
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0]])       # valid
    t = torch.full((2, 4), 0.05)
    w = torch.tensor([[3.0, 3.0, 3.0, 3.0], [254.0, 255.0, 7.0, 7.0]])
    tsdf, wt = ic.integrate_chunk(depth, flatw, t, w, 0.1)
    assert wt.tolist() == [[3.0, 3.0, 3.0, 3.0], [255.0, 255.0, 7.0, 7.0]]
    assert tsdf[0].tolist() == t[0].tolist()          # off image, d <= 0
    # flat 0.9 -> 0: d = 1, sdf = 1 - 1.05; flat 3.7 -> 3: d = 2, sdf 0.5
    # clipped to 0.1; one rounding per operation, in float32
    f = np.float32
    sdf = f(1.0) - f(1.05)
    assert tsdf[1, 0].item() == (f(0.05) * f(254.0) + sdf) / f(255.0)
    assert tsdf[1, 1].item() == (f(0.05) * f(255.0) + f(0.1)) / f(256.0)
    assert tsdf[1, 2:].tolist() == t[1, 2:].tolist()  # invalid; sdf < -trunc
    with pytest.raises(ValueError):
        ic.integrate_chunk(depth, flatw[:, :7], t, w)


def test_port_tool_runs_on_the_cpu(capsys):
    out = exp_integrate.main(device="cpu")
    compared = [v for v in out.values() if "bit_exact" in v]
    assert len(compared) == 8 and all(v["bit_exact"] for v in compared)
    text = capsys.readouterr().out
    assert "K19 integrate_chunk, rows with weight" in text
    assert "device: cpu" in text
