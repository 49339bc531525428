"""PyTorch port: the speed-of-light audit
(voxelhashing_demo_tpu_torch/tools/roofline.py) against the JAX tool
``tools/roofline.py`` (imported as its own scripts import it, the repo
root on ``sys.path``).

- ``bounds_model`` equals the JAX function exactly, on the same
  primitives dict, configuration and active-block count.
- ``measure_stages`` at 80x60 (``tiny_flagship_gather_config``) on the
  CPU, one timed call per stage: the seven JAX stage keys, each a finite
  positive host time, and its ``n_active`` equal to the JAX package's
  ``compact_visible`` count on the same frames with the port's own poses
  fed in (a JAX step that fuses at a given pose, with the GC on the
  step's schedule).  The JAX side runs the plain depth gather: it equals
  the window gather bit for bit (tests/test_pallas_gather.py) and the
  count depends only on the integer map.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import tiny_flagship_gather_config

import __graft_entry__
from tools import roofline as jroof
from voxelhashing_demo_tpu.config import tiny_config as jtiny
from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch.models import hash_slam as ths
from voxelhashing_demo_tpu_torch.tools import roofline as troof

torch.set_num_threads(1)

CONFIGS = {
    "flagship": (__graft_entry__.flagship_config, tcfg.flagship_config),
    "flagship_gather": (lambda: tiny_flagship_gather_config("jax"),
                        lambda: tiny_flagship_gather_config("torch")),
    "tiny": (jtiny, tcfg.tiny_config),
}


def _primitives(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    keys = ("gather_random_ns_per_elem", "gather_image_ns_per_elem",
            "gather_rows_GBps", "elementwise_GBps", "scatter_min_256k_ms")
    return {k: float(v) for k, v in zip(keys, rng.uniform(0.01, 3000, 5))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bounds_model_equals_jax(name):
    jc, tc = (make() for make in CONFIGS[name])
    for seed, n_active in ((0, 843), (1, 1), (2, 4096)):
        prim = _primitives(seed)
        want = jroof.bounds_model(jc, prim, n_active)
        got = troof.bounds_model(tc, dict(prim), n_active)
        assert got == want
        assert set(got) == {"integrate", "icp_pyramid", "preprocess",
                            "splat_raycast"}


def _jax_fed_step(cfg):
    def fed(state, depth_raw, pose):
        frame = jpre.preprocess(depth_raw, cfg.camera, cfg.frontend)
        gc = cfg.gc
        hmap, _ = jax.lax.cond(
            state.frame_idx % gc.interval == gc.interval - 1,
            lambda m: jho.garbage_collect(
                m, cfg.hash, gc.min_weight, gc.max_blocks_per_gc,
                frame_idx=state.frame_idx, min_age=gc.min_age),
            lambda m: (m, jnp.int32(0)), state.hmap)
        hmap, _, _ = jho.fuse_frame(hmap, frame, pose, cfg.camera, cfg.hash,
                                    cfg.fusion, frame_idx=state.frame_idx)
        return state._replace(hmap=hmap, pose=pose,
                              frame_idx=state.frame_idx + 1)

    return jax.jit(fed)


def test_measure_stages_keys_and_active_set_match_jax(monkeypatch):
    runs = []

    class Recorded(ths.HashSLAM):
        def process(self, depth_raw):
            if not runs or runs[-1][0] is not self:
                runs.append((self, []))
            runs[-1][1].append(depth_raw.clone())
            return super().process(depth_raw)

    monkeypatch.setattr(ths, "HashSLAM", Recorded)
    cfg = tiny_flagship_gather_config("torch")
    stages, n_active = troof.measure_stages(cfg, device="cpu", n=1)
    assert tuple(stages) == troof.STAGES
    assert all(math.isfinite(v) and v > 0 for v in stages.values())
    (slam, frames), = runs
    assert len(frames) == troof.SWEEP_FRAMES
    assert n_active > 0

    jc = tiny_flagship_gather_config("jax")
    jc = dataclasses.replace(
        jc, hash=dataclasses.replace(jc.hash, use_pallas_gather=False))
    fed = _jax_fed_step(jc)
    state = jhs.create(jc)
    for d, p in zip(frames, slam.trajectory):
        state = fed(state, jnp.asarray(d.numpy()), jnp.asarray(p.numpy()))
    active = jho.compact_visible(state.hmap, jc.hash, state.pose,
                                 jc.camera, jc.fusion)
    assert n_active == int(active.count)
