"""Port of ``tools/exp_pallas_gather2.py``: the 2-D gather forms the fused
integrate kernel would need, on the card.

- ``take_along_axis`` on axis 0 ((512, 256) indices into the (256, 256)
  top-left patch of the image, passed as a strided view), on axis 1 at
  (512, 128) and at (512, 256): K17 (``ops/image_gather.take_along_axis``,
  ``csrc/take_along.cu``), beside ``torch.gather``;
- the two-step per-block window gather over 128 blocks (a 256 x 256
  window at (v0, u0), a row pick by dv, a column pick by du, 128 columns
  kept): K18 (``ops/image_gather.gather_window_two_step``,
  ``csrc/window_gather_two_step.cu``); no PyTorch call computes it.

Each is timed warm and cold in the L2 and held against its plain version.

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.exp_gather2``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import image_gather as ig
from .probe import Probe, to_device

H, W = 480, 640
NB = 128
WIN = 256
KEEP = 128


def inputs(seed: int = 0) -> dict:
    """The probe's arrays (uniform images and sources, uniform indices),
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def ints(hi, shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    return {
        "img": rng.random((H, W), dtype=np.float32),
        "v_idx": ints(WIN, (512, 256)),
        "src": rng.random((512, 128), dtype=np.float32),
        "u_idx": ints(128, (512, 128)),
        "src256": rng.random((512, 256), dtype=np.float32),
        "u256": ints(256, (512, 256)),
        "v0": ints(H - WIN, NB), "u0": ints(W - WIN, NB),
        "dv": ints(WIN, (NB, 512, WIN)), "du": ints(WIN, (NB, 512, WIN)),
    }


def _take_along_forms(a: dict):
    """(name, src, idx, axis) of the three take_along_axis variants."""
    return (("taa axis=0 (512,256) from (256,256)",
             a["img"][:WIN, :WIN], a["v_idx"], 0),
            ("taa axis=1 (512,128) lanes", a["src"], a["u_idx"], 1),
            ("taa axis=1 (512,256) lanes", a["src256"], a["u256"], 1))


def run(probe: Probe, a: dict) -> dict:
    for name, src, idx, axis in _take_along_forms(a):
        ref = probe.run(f"plain {name}", ig.take_along_axis_reference,
                        (src, idx, axis))
        probe.run(f"torch.gather {name}",
                  lambda s, i, ax: torch.gather(s, ax, i),
                  (src, idx.long(), axis), ref=ref)
        probe.run(f"{name} (K17)", ig.take_along_axis, (src, idx, axis),
                  ref=ref)
    args = (a["img"], a["v0"], a["u0"], a["dv"], a["du"], KEEP)
    ref = probe.run("plain full per-block 2-step gather x128 blocks",
                    ig.gather_window_two_step_reference, args)
    probe.run("full per-block 2-step gather x128 blocks (K18)",
              ig.gather_window_two_step, args, ref=ref)
    return probe.results


def main(device=None) -> dict:
    """Run the probe on ``device`` (None: the card) and print its lines;
    returns {variant: {ms, cold_ms, wrapper_ms, bit_exact, max_abs_err}}."""
    probe = Probe(device)
    out = run(probe, to_device(inputs(), probe.device))
    print("\ndevice:", probe.device_line(), flush=True)
    return out


if __name__ == "__main__":
    main()
