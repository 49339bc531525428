"""Port of ``tools/roofline.py``: the speed-of-light audit, measured stage
times against memory-bound estimates.

Times every stage of the frame step at a mid-sweep state (24 frames of the
noisy room sweep) and the memory primitives that bound them (random
gather from a 16 MB table and from the 1.2 MB image, contiguous row
gather, elementwise bandwidth, scatter-min into the image), then prints
one JSON object: stage ms, modelled memory-bound ms (``bounds_model``,
the JAX tool's arithmetic) and % of bound.

- Primitives: plain PyTorch ops, device time per call on the card by
  CUDA-graph replay, warm L2 (``tools/probe.device_ms``), beside the
  launch floor of the same harness (the empty kernel
  csrc/launch_floor.cu).  Eager PyTorch runs each primitive as separate
  kernels (``(x * 1.5 + 2.0).sum()`` is three), so the rates are what the
  port's unfused plain ops get, not the card's memory rate.
- Stages: host wall time per call over ``n`` calls closed by
  ``torch.cuda.synchronize()`` (the JAX tool's value fetch).  The
  map-updating stages (alloc, integrate) run in place on a clone of the
  map, each call on the previous call's map, as the step updates its map
  (the JAX tool's donated, rethreaded timing).

Run on the card: ``python -m voxelhashing_demo_tpu_torch.tools.roofline``
(``main(config=flagship_gather_config())`` for the integrate gather
through K1).  ``measure_stages(config, device="cpu", n=1)`` runs the
stages on the CPU; the primitives are timed only on the card.
"""

from __future__ import annotations

import json
import time

import torch

from ..bench import device_name
from ..config import flagship_config
from ..device import resolve
from . import probe

N_CALLS = 20          # timed calls per stage
SWEEP_FRAMES = 24     # frames run before the stages are timed
STAGES = ("preprocess", "icp_pyramid", "compact_visible", "splat_raycast",
          "alloc", "integrate", "full_step")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device, n: int = N_CALLS) -> float:
    """Wall ms per call of ``fn(*args)`` over ``n`` calls after one warm
    call, closed by a synchronise."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def timeit_in_place(fn, hmap, *args, device, n: int = N_CALLS) -> float:
    """``timeit`` of a map-updating stage ``fn(map, *args) -> map`` on a
    clone of ``hmap``, each call on the map the previous one returned."""
    m = fn(type(hmap)(*(t.clone() for t in hmap)), *args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        m = fn(m, *args)
    _sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def measure_primitives(device=None) -> dict:
    """Memory-system primitives that bound every stage (the JAX tool's
    five, at its sizes), device time on the card."""
    device = resolve(device)
    if device.type != "cuda":
        raise ValueError("the primitives are timed on a CUDA card "
                         f"(CUDA-graph replay), not on {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def uniform(n):
        return torch.rand(n, generator=gen, device=device)

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=gen, device=device)

    def ms(fn):
        return probe.device_ms([fn] * probe.WARM_CALLS)

    out = {}
    # random element gather from a 16 MB table
    src, idx = uniform(1 << 22), randint(1 << 22, 1 << 20)
    out["gather_random_ns_per_elem"] = (
        ms(lambda: src[idx].sum()) * 1e6 / (1 << 20))
    # random element gather from the 1.2 MB image (it stays in the L2)
    img, idx2 = uniform(480 * 640), randint(480 * 640, 1 << 20)
    out["gather_image_ns_per_elem"] = (
        ms(lambda: img[idx2].sum()) * 1e6 / (1 << 20))
    # contiguous row gather: 4096 rows of 512 from a (16384, 512) table
    rows = randint(16384, 4096)
    table = uniform(16384 * 512).reshape(16384, 512)
    out["gather_rows_GBps"] = (4096 * 512 * 4
                               / (ms(lambda: table[rows].sum()) * 1e-3) / 1e9)
    # elementwise bandwidth (2 reads + 1 write counted, as the JAX tool)
    a = uniform(1 << 24)
    out["elementwise_GBps"] = ((1 << 24) * 8
                               / (ms(lambda: (a * 1.5 + 2.0).sum()) * 1e-3)
                               / 1e9)
    # scatter-min of 256 Ki elements into the image
    vals, tgt = uniform(1 << 18), randint(480 * 640, 1 << 18)
    zbuf = torch.full((480 * 640,), float("inf"), device=device)
    out["scatter_min_256k_ms"] = ms(lambda: torch.scatter_reduce(
        zbuf, 0, tgt, vals, "amin").sum())
    return out


def measure_stages(config, device=None, n: int = N_CALLS):
    """The seven stages' ms (``STAGES``) at the state after
    ``SWEEP_FRAMES`` noisy room-sweep frames, and the visible-set size
    there.  Returns (stages, n_active)."""
    from ..models import hash_slam
    from ..ops import hash_ops
    from ..ops import icp as icp_ops
    from ..ops import preprocess as pre_ops
    from ..ops import splat as splat_ops
    from ..utils import synthetic

    device = resolve(device)
    cam, hcfg, fus = config.camera, config.hash, config.fusion
    depths, _ = synthetic.make_room_sweep(cam, SWEEP_FRAMES, sweep_deg=40.0,
                                          noise_seed=1, device=device)
    depths = [hash_slam.depth_tensor(d, device) for d in depths]
    slam = hash_slam.HashSLAM(config, device=device)
    for d in depths:
        slam.process(d)
    _sync(device)
    state = slam.state
    last = depths[-1]
    frame = pre_ops.preprocess(last, cam, config.frontend)
    active = hash_ops.compact_visible(state.hmap, hcfg, state.pose, cam, fus)
    n_active = int(active.count)

    stages = {}
    stages["preprocess"] = timeit(
        lambda d: pre_ops.preprocess(d, cam, config.frontend), last,
        device=device, n=n)
    stages["icp_pyramid"] = timeit(
        lambda f, m: icp_ops.icp_align_pyramid(
            f.depth, m.depth, cam, config.icp, src_full=f, tgt_full=m,
            prior_T=state.vel).transform,
        frame, state.model, device=device, n=n)
    stages["compact_visible"] = timeit(
        lambda h, T: hash_ops.compact_visible(h, hcfg, T, cam, fus).count,
        state.hmap, state.pose, device=device, n=n)
    stages["splat_raycast"] = timeit(
        lambda h, a, T: splat_ops.splat_raycast(
            h, a, hcfg, T, cam, config.raycast, fus).depth,
        state.hmap, active, state.pose, device=device, n=n)
    # the map-updating stages on clones of the map
    stages["alloc"] = timeit_in_place(
        lambda h, f, T: hash_ops.allocate_from_frame(
            h, f, T, cam, hcfg, fus)[0],
        state.hmap, frame, state.pose, device=device, n=n)
    stages["integrate"] = timeit_in_place(
        lambda h, a, d, T: hash_ops.integrate(h, a, hcfg, d, T, cam, fus),
        state.hmap, active, frame.depth, state.pose, device=device, n=n)
    # the whole step, each call on the state the previous one returned
    st, _ = hash_slam.step(state, last, config)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        st, _ = hash_slam.step(st, last, config)
    _sync(device)
    stages["full_step"] = (time.perf_counter() - t0) / n * 1e3
    return stages, n_active


def bounds_model(config, prim, n_active):
    """Memory-traffic lower bounds per stage, from the measured primitive
    costs and the known data volumes (the JAX tool's arithmetic, term for
    term)."""
    cam = config.camera
    px = cam.width * cam.height
    V = config.hash.voxels_per_block
    g_img = prim["gather_image_ns_per_elem"]
    rows_gbps = prim["gather_rows_GBps"]
    elem_gbps = prim["elementwise_GBps"]

    b = {}
    # integrate: per active block: depth gather (V elems) + 2 row reads +
    # 2 row writes of (V,) f32
    gather_ms = n_active * V * g_img * 1e-6
    rows_ms = n_active * V * 4 * 4 / (rows_gbps * 1e9) * 1e3
    b["integrate"] = gather_ms + rows_ms
    # ICP: per level/iteration one 8-byte gather per source pixel; sum over
    # schedule (approximate: level areas / pools, 2 iters fine + race)
    levels = sorted(set(config.icp.pyramid), reverse=True)
    iters = config.icp.pyramid_iters
    pools = config.icp.source_pools or (1,) * len(levels)
    total_gathers = 0
    for f, it, p in zip(levels, iters, pools):
        total_gathers += (px // (f * p) ** 2) * max(it // 2, 1)
    b["icp_pyramid"] = total_gathers * 2 * g_img * 1e-6
    # preprocess: ~40 elementwise passes over the image (bilateral 25 +
    # reject 8 + normals)
    b["preprocess"] = 40 * px * 4 / (elem_gbps * 1e9) * 1e3
    # splat: row gather of active rows + scatter of band voxels (~10%) +
    # image-space finalize passes
    b["splat_raycast"] = (
        n_active * V * 8 / (rows_gbps * 1e9) * 1e3
        + prim["scatter_min_256k_ms"] * (n_active * V * 0.1) / (1 << 18)
        + 10 * px * 4 / (elem_gbps * 1e9) * 1e3
    )
    return b


def main(device=None, config=None) -> dict:
    """The roofline on the card (None: the CUDA card) under ``config``
    (None: ``flagship_config()``, as the JAX tool); prints and returns
    {device, n_active_blocks, primitives, launch_floor_ms, stages_ms,
    bounds_ms, pct_of_bound}.  Numbers are not rounded."""
    device = resolve(device)
    config = flagship_config() if config is None else config
    prim = measure_primitives(device)
    floor = probe.launch_floor_ms()
    stages, n_active = measure_stages(config, device)
    bounds = bounds_model(config, prim, n_active)
    result = {
        "device": device_name(device),
        "n_active_blocks": n_active,
        "primitives": prim,
        "launch_floor_ms": floor,
        "stages_ms": stages,
        "bounds_ms": bounds,
        "pct_of_bound": {k: 100 * bounds[k] / stages[k]
                         for k in bounds if k in stages and stages[k] > 0},
    }
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    main()
