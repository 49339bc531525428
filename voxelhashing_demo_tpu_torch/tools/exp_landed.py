"""Port of ``tools/exp_pallas_landed.py``: the landed window gathers at the
flagship chunk shape (128 blocks x 512 voxels, 640x480 image) on the card,
then the frame step with the gather kernel off and on.

- the plain gather ``where(valid, depth[v, u], 0)`` (the default integrate
  path's lookup, the probe's XLA gather);
- K1 ``gather_depth_window`` (``csrc/window_gather.cu``) and K2
  ``gather_depth_window_streamed`` (``csrc/window_gather_streamed.cu``),
  each held bit for bit against its plain version and, on these
  footprints (every valid voxel covered), against the plain gather;
- ``HashSLAM`` on 24 noisy room-sweep frames under ``flagship_config()``
  with ``use_pallas_gather`` off and on, then 20 timed frames (host clock
  around ``process``, the card synchronised), as the probe times its
  donated-state step.

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.exp_landed``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops import window_gather as wg
from .probe import Probe, compare, to_device

H, W = 480, 640
C, V = 128, 512
FRAMES = 24          # sweep frames run before the clock
REPS = 20            # timed frames


def inputs(seed: int = 0) -> dict:
    """The probe's own arrays (it draws them with numpy): depth uniform in
    [0.5, 3.5) m, per-block footprints of 40-160 px."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.5, (H, W)).astype(np.float32)
    spread = rng.integers(40, 160, size=(C, 1))
    v0 = rng.integers(0, H - 170, size=(C, 1))
    u0 = rng.integers(0, W - 170, size=(C, 1))
    v = (v0 + rng.integers(0, spread, (C, V))
         % np.maximum(spread, 1)).astype(np.int32)
    u = (u0 + rng.integers(0, spread, (C, V))
         % np.maximum(spread, 1)).astype(np.int32)
    return {"depth": depth, "v": v, "u": u, "valid": rng.random((C, V)) > 0.1}


def plain_gather(depth, v, u, valid):
    """The probe's XLA gather: ``where(valid, depth[v, u], 0)``."""
    return torch.where(valid, depth[v.long(), u.long()], 0.0)


def gather_section(probe: Probe, a: dict) -> dict:
    args = (a["depth"], a["v"], a["u"], a["valid"])
    xla = probe.run("XLA gather (C,V) from image", plain_gather, args)
    for name, fn, plain in (
            ("window gather (compact) (K1)", wg.gather_depth_window,
             wg.gather_depth_window_reference),
            ("window gather (streamed) (K2)",
             wg.gather_depth_window_streamed,
             wg.gather_depth_window_streamed_reference)):
        ref = probe.run(f"plain {name}", plain, args)
        vals, covered = probe.run(name, fn, args, ref=ref)
        if int(covered.sum()) != int(a["valid"].sum()):
            raise RuntimeError("unexpected clipping at these footprints")
        err = compare(vals, xla)["max_abs_err"]
        probe.results[name]["max_abs_err_vs_xla"] = err
        print(f"  max |err| vs XLA: {err:.2e}", flush=True)
    return probe.results


def step_section(probe: Probe, config=None) -> dict:
    """The frame step under ``config`` (None: the flagship) with the
    gather off and on: {label: {ms, fps, k1_launches}} (host clock; "not
    measured" on the CPU)."""
    from ..config import flagship_config
    from ..models import hash_slam
    from ..utils import synthetic

    base = flagship_config() if config is None else config
    depths, _ = synthetic.make_room_sweep(base.camera, FRAMES, sweep_deg=40.0,
                                          noise_seed=1, device=probe.device)
    out = {}
    for label, flag in (("full step (XLA gather)", False),
                        ("full step (window gather K1)", True)):
        cfg = dataclasses.replace(
            base, hash=dataclasses.replace(base.hash, use_pallas_gather=flag))
        slam = hash_slam.HashSLAM(cfg, device=probe.device)
        for d in depths:
            slam.process(d)
        before = wg.LAUNCHES
        if probe.card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(REPS):
            slam.process(depths[-1 - (i % 2)])
        if probe.card:
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / REPS
        entry = {"k1_launches": wg.LAUNCHES - before}
        if probe.card:
            entry.update(ms=dt * 1e3, fps=1.0 / dt)
            print(f"{label:52s} {dt * 1e3:9.3f} ms  ({1.0 / dt:.1f} fps)",
                  flush=True)
        else:
            print(f"{label:52s} not measured (no card)", flush=True)
        out[label] = entry
    return out


def main(device=None, config=None) -> dict:
    """Run the probe on ``device`` (None: the card) and print its lines;
    ``config`` (None: the flagship) is the step section's.  Returns
    {variant: {...}}."""
    probe = Probe(device)
    print("device:", probe.device_line(), flush=True)
    out = dict(gather_section(probe, to_device(inputs(), probe.device)))
    out.update(step_section(probe, config))
    return out


if __name__ == "__main__":
    main()
