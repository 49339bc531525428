"""Port of ``tools/exp_pallas_integrate.py``: one integrate chunk (128
blocks x 512 voxels on a wall 1.3-2.5 m away) gathered from and fused
against a 640x480 depth image, on the card.

Variants, as the probe's (each projects the blocks first, as there):

- the plain gather (``xla_gather``) and K16 on the chunk's flat indices
  (``pallas_take_all``, ``pallas_take_block``: one kernel here);
- the plain integrate (``xla_integrate``) and K19, gather and fuse in one
  kernel (``pallas_integrate``: project, pack, ``integrate_chunk``).

Then the question the probe was written for, the design input of a fused
integrate kernel: on the chunk's projected indices, K16 alone, K19 alone,
and K16 followed by the plain fuse (the gather and the fuse apart), with
``img.view(-1)[idx]`` as the one PyTorch call for the gather.  The
probe's rows are zero (every voxel's first observation); K19 is also held
against its plain version on rows that already carry weight.

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.exp_integrate``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import image_gather as ig
from ..ops import integrate_chunk as ic
from .probe import Probe, to_device

H, W = ic.H, ic.W
C = 128
V = ic.BS ** 3


def inputs(seed: int = 0) -> dict:
    """The probe's arrays (depth uniform in [1.5, 2.5), block coordinates
    x in [-20, 20), y in [-15, 15), z in [8, 15), zero rows), from
    ``np.random.default_rng(seed)``; plus ``tsdf_seen`` / ``w_seen``, rows
    already fused (weights 0-255, tsdf within +-trunc)."""
    rng = np.random.default_rng(seed)
    depth = rng.random((H, W), dtype=np.float32) + np.float32(1.5)
    blocks = np.stack([rng.integers(-20, 20, C), rng.integers(-15, 15, C),
                       rng.integers(8, 15, C)], axis=-1).astype(np.int32)
    return {
        "depth": depth, "blocks": blocks,
        "tsdf_rows": np.zeros((C, V), np.float32),
        "w_rows": np.zeros((C, V), np.float32),
        "tsdf_seen": rng.uniform(-ic.TRUNC, ic.TRUNC, (C, V)).astype(
            np.float32),
        "w_seen": rng.integers(0, 256, (C, V)).astype(np.float32),
    }


def gather_chunk_plain(depth, blocks):
    """The probe's ``xla_gather``: the in-image depth per voxel, 0
    elsewhere."""
    flat, in_img, _ = ic.project_indices(blocks)
    return torch.where(in_img, ig.take_flat_reference(depth, flat), 0.0)


def gather_chunk(depth, blocks):
    """The probe's ``pallas_take_all`` / ``pallas_take_block``: the same
    through K16."""
    flat, in_img, _ = ic.project_indices(blocks)
    return torch.where(in_img, ig.take_flat(depth, flat), 0.0)


def gather_then_fuse(depth, flat, flatw, tsdf_rows, w_rows):
    """K16 for the gather, then the fuse in plain ops: the two apart."""
    d = ig.take_flat(depth, flat)
    return ic.fuse(d, flatw[1].reshape(flat.shape), flatw[2].reshape(
        flat.shape) > 0, tsdf_rows, w_rows, ic.TRUNC)


def run(probe: Probe, a: dict) -> dict:
    depth, blocks = a["depth"], a["blocks"]
    rows = (a["tsdf_rows"], a["w_rows"])
    ref = probe.run("plain gather (C*V from image) (XLA)",
                    gather_chunk_plain, (depth, blocks))
    for name in ("take whole-chunk (K16; pallas_take_all)",
                 "take per-block grid (K16; pallas_take_block)"):
        probe.run(name, gather_chunk, (depth, blocks), ref=ref)
    ref = probe.run("plain integrate chunk (XLA)", ic.integrate_blocks_plain,
                    (depth, blocks, *rows))
    probe.run("integrate chunk (K19; pallas_integrate)", ic.integrate_blocks,
              (depth, blocks, *rows), ref=ref)

    flat, in_img, z = ic.project_indices(blocks)
    flatw = ic.pack_flatw(flat, in_img, z)
    ref = probe.run("plain gather alone", ig.take_flat_reference,
                    (depth, flat))
    probe.run("torch img.view(-1)[idx] alone", lambda d, f: d.view(-1)[f],
              (depth, flat), ref=ref)
    probe.run("K16 gather alone", ig.take_flat, (depth, flat), ref=ref)
    ref = probe.run("plain integrate_chunk alone",
                    ic.integrate_chunk_reference, (depth, flatw, *rows))
    probe.run("K19 integrate_chunk alone", ic.integrate_chunk,
              (depth, flatw, *rows), ref=ref)
    probe.run("K16 gather + plain fuse", gather_then_fuse,
              (depth, flat, flatw, *rows), ref=ref)
    seen = (a["tsdf_seen"], a["w_seen"])
    ref = probe.run("plain integrate_chunk, rows with weight",
                    ic.integrate_chunk_reference, (depth, flatw, *seen))
    probe.run("K19 integrate_chunk, rows with weight", ic.integrate_chunk,
              (depth, flatw, *seen), ref=ref)
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
