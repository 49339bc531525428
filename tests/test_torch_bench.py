"""PyTorch port: the benchmark twin (voxelhashing_demo_tpu_torch/bench.py)
against the JAX package's bench.py, section by section, on the CPU.

Both benches run each section on tests/test_bench_smoke.py's tiny 80x60
configuration (``torch_port_helpers.bench_config``) and on the SAME
uint16 frames: each is handed ``torch_port_helpers.SlowPanFrames`` as its
``synthetic`` module, the port's noisy room sweep cut to the head of a
sweep twenty times as long (about 2 degrees a frame, as the full-length
sections move; at 9 frames of the full 340-degree sweep neither package
tracks).  Sections and sizes: ``_long_run`` (9 frames, chunk 4),
``_backend_run`` (10 frames, with the frontend-only baseline and a
4-frame warm sweep; and the per-closure variant, ``kf_overrides`` with
deferral off), ``_streaming_run`` and ``_streaming_backend_run`` (8 asked
for: 9 frames out and back).  At most 10 frames: past ~8 frames each
package's own closed loop drifts from the other's (ROADMAP Queue 3, F2).

Tolerances: the output keys are equal; every decision is equal (tracked
frames, frames, keyframes, loop edges, BA runs, map-update modes,
keyframes reintegrated, blocks used and active, evicted, restored, store
blocks); every ATE field agrees within 0.5 mm (measured: 0.02 mm); timing
fields (fps, seconds, milliseconds, the dispatch mode they pick) are
checked as finite and positive only.
"""

import math
import pathlib
import re

import bench as jbench
import pytest
import torch
from torch_port_helpers import SlowPanFrames, bench_config

from voxelhashing_demo_tpu.models import hash_slam as jhash_slam
from voxelhashing_demo_tpu.utils import metrics as jmetrics
from voxelhashing_demo_tpu_torch import bench as tbench
from voxelhashing_demo_tpu_torch.models import hash_slam as thash_slam
from voxelhashing_demo_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

ATE_ATOL_M = 5e-4
PER_CLOSURE = dict(ba_defer_edges=1, ba_defer_frames=0)
SECTIONS = {
    "long_run": ("_long_run", dict(num_frames=9, chunk=4)),
    "backend": ("_backend_run", dict(num_frames=10, warm_frames=4)),
    "per_closure": ("_backend_run", dict(
        num_frames=10, warm_frames=0, frontend_baseline=False,
        kf_overrides=PER_CLOSURE)),
    "streaming": ("_streaming_run", dict(num_frames=8)),
    "streaming_backend": ("_streaming_backend_run", dict(num_frames=8)),
}
DECISIONS = ("tracked", "frames", "chunk", "sweep_deg", "keyframes",
             "loop_edges", "ba_runs", "rebuilds_full",
             "rebuilds_incremental", "keyframes_reintegrated",
             "blocks_used", "blocks_active_final", "device_blocks",
             "evicted", "restored", "store_blocks_final")
ATES = ("ate_rmse_m", "ate_aligned_m", "ate_frontend_only_m",
        "ate_frontend_aligned_m")
TIMINGS = ("fps", "fps_per_frame_dispatch", "fps_chunked", "fps_sustained",
           "fps_frontend_only", "fps_end_to_end", "max_frame_ms",
           "p50_frame_ms")


@pytest.fixture(scope="module")
def runs():
    """{section: (JAX output, port output)} on the same frames."""
    out = {}
    for name, (fn, kw) in SECTIONS.items():
        j = getattr(jbench, fn)(bench_config("jax"), jhash_slam,
                                SlowPanFrames, jmetrics, **kw)
        t = getattr(tbench, fn)(bench_config("torch"), thash_slam,
                                SlowPanFrames, tmetrics, device="cpu", **kw)
        out[name] = (j, t)
    return out


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_section_keys_equal_jax(runs, section):
    j, t = runs[section]
    assert sorted(t) == sorted(j)


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_section_decisions_equal_jax(runs, section):
    j, t = runs[section]
    held = [k for k in DECISIONS if k in j]
    assert held, section
    assert {k: t[k] for k in held} == {k: j[k] for k in held}
    # map-update modes: which ones ran, and when a mode ran at all
    for k in ("rebuild_s_full_mean", "rebuild_s_incremental_mean"):
        if k in j:
            assert (t[k] is None) == (j[k] is None), k
    assert t["tracked"] >= t["frames"] - 2


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_section_ate_within_tolerance_of_jax(runs, section):
    j, t = runs[section]
    for k in ATES:
        if k in j:
            assert math.isfinite(t[k]), k
            assert abs(t[k] - j[k]) < ATE_ATOL_M, (k, t[k], j[k])


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_section_timings_positive(runs, section):
    _, t = runs[section]
    for k in TIMINGS:
        if k in t:
            assert math.isfinite(t[k]) and t[k] > 0, (k, t[k])
    if "dispatch_mode" in t:
        assert t["dispatch_mode"] in ("per_frame", f"chunked_{t['chunk']}")
        assert t["fps"] == max(t["fps_per_frame_dispatch"], t["fps_chunked"])
    if "excluded_hitches" in t:
        assert t["excluded_hitches"] >= 0
        assert t["max_frame_ms"] >= t["p50_frame_ms"]
    if "final_drain_s" in t:
        assert t["final_drain_s"] >= 0
        assert t["fps_end_to_end"] <= t["fps"]


def test_sync_reads_one_scalar():
    """``_sync`` returns the first element of any tensor on the CPU."""
    assert tbench._sync(torch.tensor(2.5)) == 2.5
    assert tbench._sync(torch.arange(6.0).reshape(2, 3) + 1) == 1.0
    assert tbench.device_name("cpu") == "cpu"


_REFERENCE_IMPORT = re.compile(
    r"^\s*(import\s+(bench|__graft_entry__)\b"
    r"|from\s+(bench|__graft_entry__)\s+import)", re.M)


def test_twin_imports_neither_bench_py_nor_graft_entry():
    """The port and chip_smoke.py hold their own copies of what they take
    from the root bench.py and __graft_entry__.py (test_torch_config.py
    holds them to importing no JAX)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    paths = sorted((root / "voxelhashing_demo_tpu_torch").rglob("*.py"))
    paths += [root / "chip_smoke.py", root / "chip_profile.py"]
    assert root / "voxelhashing_demo_tpu_torch" / "bench.py" in paths
    for p in paths:
        assert not _REFERENCE_IMPORT.search(p.read_text()), p
