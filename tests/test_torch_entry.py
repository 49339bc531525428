"""PyTorch port: the entry points (voxelhashing_demo_tpu_torch/entry.py)
against the root ``__graft_entry__.py``.

- ``entry(device="cpu")``'s example state has the JAX ``entry()``'s field
  names, shapes and dtypes (the port's state flattened by ``convert``, the
  JAX one by ``jax.eval_shape``, so nothing of full size runs in JAX); its
  frame is the JAX frame's shape in the port's raw-depth dtype (int32 for
  uint16); its ``fn`` is ``hash_slam.step`` under ``flagship_config()``
  (recorded, not run: no full-size step on the CPU).
- ``dryrun_multichip(2, backend="gloo", device="cpu")``: one spawn of two
  ranks runs the JAX dry run's sequence to its end with its checks, and
  the ranks agree on every value they return.
- ``dryrun_multichip(4)`` without four cards raises, as the JAX version
  asserts that it has the devices.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from voxelhashing_demo_tpu_torch import convert, entry
from voxelhashing_demo_tpu_torch.config import flagship_config
from voxelhashing_demo_tpu_torch.models import hash_slam as ths

torch.set_num_threads(1)


def _shapes(tree, prefix="") -> dict:
    """{dotted name: (shape, dtype)} of a (nested) NamedTuple of JAX
    shape structs: the layout of ``convert.state_to_numpy``."""
    out = {}
    for name, val in tree._asdict().items():
        key = f"{prefix}.{name}" if prefix else name
        if hasattr(val, "_asdict"):
            out.update(_shapes(val, key))
        else:
            out[key] = (tuple(val.shape), np.dtype(val.dtype))
    return out


@pytest.fixture(scope="module")
def jax_args():
    return jax.eval_shape(lambda: __graft_entry__.entry()[1])


def test_entry_state_matches_jax_entry(jax_args):
    jstate, jdepth = jax_args
    _, (state, depth) = entry.entry(device="cpu")
    flat = convert.state_to_numpy(state)
    got = {k: (v.shape, v.dtype) for k, v in flat.items()}
    assert got == _shapes(jstate)
    assert depth.device.type == "cpu"
    assert tuple(depth.shape) == tuple(jdepth.shape)
    assert jdepth.dtype == np.uint16 and depth.dtype == torch.int32
    assert not torch.any(depth)


def test_entry_fn_is_the_flagship_step(monkeypatch):
    calls = []

    def record(state, depth_raw, config):
        calls.append((state, depth_raw, config))
        return "stepped"

    monkeypatch.setattr(ths, "step", record)
    fn, (state, depth) = entry.entry(device="cpu")
    assert fn(state, depth) == "stepped"
    (s, d, config), = calls
    assert s is state and d is depth
    assert dataclasses.asdict(config) == dataclasses.asdict(
        flagship_config())
    assert (dataclasses.asdict(entry.flagship_config())
            == dataclasses.asdict(__graft_entry__.flagship_config()))


def test_dryrun_two_gloo_ranks_agree():
    outs = entry.dryrun_multichip(2, backend="gloo", device="cpu")
    assert len(outs) == 2 and outs[0] == outs[1]
    out = outs[0]
    assert out["blocks_allocated"] > 0
    assert out["keyframes"] >= 2 and out["moved"] > 0
    assert out["hit"] > 0.1
    assert np.isfinite(out["pose"]).all()


def test_dryrun_config_matches_jax_shapes():
    """H = 64 or 8n, W = 64, the map and stream sizes scaled by n."""
    for n, h in ((1, 64), (2, 64), (3, 24), (8, 64)):
        cfg = entry.dryrun_config(n)
        assert (cfg.camera.height, cfg.camera.width) == (h, 64)
        assert cfg.hash.num_blocks == 128 * n and cfg.stream.enabled
        assert cfg.stream.max_restore == 32 * n


def test_dryrun_without_the_cards_raises():
    with pytest.raises(ValueError, match="4 CUDA cards"):
        entry.dryrun_multichip(4)
