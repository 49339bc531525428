"""Port of ``tools/exp_pallas_vmem_gather.py``: 65 536 random gathers
from a 640x480 float32 image (the integrate loop's per-chunk depth gather)
on the card.

The TPU probe asked whether a gather from an image held in VMEM beats one
from HBM.  Here every form goes through K16 (``ops/image_gather.take_flat``,
``csrc/take_flat.cu``), timed with the image and indices warm in the L2
and cold (rotated through more than the L2), beside the plain version and
the one PyTorch call (``img.view(-1)[idx]``).  Variants, as the probe's:

- flat (65 536,) indices (``pallas_take``);
- (512, 128) indices (``pallas_take2``);
- (row, column) pairs of (512, 128), the flat index formed in the kernel
  (``pallas_taa``).

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.exp_vmem_gather``.
"""

from __future__ import annotations

import numpy as np

from ..ops import image_gather as ig
from .probe import Probe, to_device

H, W = 480, 640
N = 128 * 512


def inputs(seed: int = 0) -> dict:
    """The probe's arrays (uniform image, uniform indices), from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    img = rng.random(H * W, dtype=np.float32)
    idx = rng.integers(0, H * W, N).astype(np.int32)
    idx2d = idx.reshape(N // 128, 128)
    return {"img": img, "idx": idx, "idx2d": idx2d,
            "img2": img.reshape(H, W), "r": idx2d // W, "c": idx2d % W}


def run(probe: Probe, a: dict) -> dict:
    """Every variant on ``a`` (tensors of ``inputs``)."""
    img, idx, idx2d, img2 = a["img"], a["idx"], a["idx2d"], a["img2"]
    ref = probe.run("plain gather 65k from 307k (XLA img[i])",
                    ig.take_flat_reference, (img, idx))
    probe.run("torch img.view(-1)[idx] 65k", lambda i, x: i.view(-1)[x],
              (img, idx), ref=ref)
    probe.run("take_flat flat 65k (K16; pallas_take)", ig.take_flat,
              (img, idx), ref=ref)
    probe.run("take_flat (512,128) idx (K16; pallas_take2)", ig.take_flat,
              (img, idx2d), ref=ref.reshape(idx2d.shape))
    probe.run("take_flat 2D->flat (r, c) (K16; pallas_taa)",
              lambda i, r, c: ig.take_flat(i, (r, c), cols=W),
              (img2, a["r"], a["c"]), ref=ref.reshape(idx2d.shape))
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
