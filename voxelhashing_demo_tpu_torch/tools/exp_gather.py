"""Port of ``tools/exp_pallas_gather.py``: 524 288 random gathers (the
integrate workload of a full active set) from a 640x480 float32 image on
the card.

The TPU probe gathered through a row gather and a one-hot lane sum
(``pallas_gather``; a -0.0 came back as +0.0).  Here the gather is K16
(``ops/image_gather.take_flat``, ``csrc/take_flat.cu``), which returns the
pixel's own bits, timed warm and cold in the L2 beside the plain version
and ``img.view(-1)[idx]``.

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.exp_gather``.
"""

from __future__ import annotations

import numpy as np

from ..ops import image_gather as ig
from .probe import Probe, to_device

H, W = 480, 640
M = 1 << 19


def inputs(seed: int = 0) -> dict:
    """The probe's arrays (normal image, uniform indices), from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal(H * W, dtype=np.float32),
            "idx": rng.integers(0, H * W, M).astype(np.int32)}


def run(probe: Probe, a: dict) -> dict:
    img, idx = a["img"], a["idx"]
    ref = probe.run("plain gather 524k from 1.2MB (XLA img[i])",
                    ig.take_flat_reference, (img, idx))
    probe.run("torch img.view(-1)[idx] 524k", lambda i, x: i.view(-1)[x],
              (img, idx), ref=ref)
    probe.run("take_flat 524k (K16; pallas_gather)", ig.take_flat,
              (img, idx), ref=ref)
    print("correct:", probe.results["take_flat 524k (K16; pallas_gather)"]
          ["bit_exact"], flush=True)
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
