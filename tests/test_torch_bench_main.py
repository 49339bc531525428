"""PyTorch port: the benchmark twin's ``main`` (voxelhashing_demo_tpu_torch
/bench.py) and the CLI's ``bench`` against the JAX package's bench.py, on
the CPU.

Both ``main``s run whole, on tests/test_bench_smoke.py's tiny 80x60
configuration in place of the flagship one and on the same frames
(``torch_port_helpers.SlowPanFrames`` in place of each package's
``synthetic``), with every section's frame counts capped (``CAPS``: at
most 10 frames, 4 warm frames, 6 frames and 2 reps for the stages), so
the line they print has every key of the full run.

Held: the port's line has the JAX line's keys at every level, plus
``detail.device`` ("cpu" here), and chip_smoke.py's ``BENCH_KEYS`` are
the JAX line's, section by section; the headline rules (median of the three
backend samples, the frontend-only value from ``long_run``, vs_baseline
from the worse of the two); the localized-correction micro moves what the
JAX one moves, on as many keyframes; the stage breakdown has its four
stages, each >= 0; ``--quick`` prints the steady-state keys of the JAX
quick line plus ``detail.device``, from ``main`` and from
``python -m voxelhashing_demo_tpu_torch --device cpu bench --quick``.
Timings are CPU figures and are checked as positive only.
"""

import contextlib
import functools
import inspect
import io
import json

import __graft_entry__
import bench as jbench
import chip_smoke
import pytest
import torch
from torch_port_helpers import SlowPanFrames, bench_config

import voxelhashing_demo_tpu.utils.synthetic  # noqa: F401  (replaced below)
import voxelhashing_demo_tpu_torch.utils.synthetic  # noqa: F401
from voxelhashing_demo_tpu import utils as jutils
from voxelhashing_demo_tpu_torch import bench as tbench
from voxelhashing_demo_tpu_torch import cli as tcli
from voxelhashing_demo_tpu_torch import config as tconfig
from voxelhashing_demo_tpu_torch import utils as tutils

torch.set_num_threads(1)

CAPS = {"num_frames": 10, "warm_frames": 4, "frames": 6, "reps": 2}
SECTIONS = ("_long_run", "_backend_run", "_incremental_micro",
            "_streaming_run", "_streaming_backend_run", "_stage_breakdown")


def _capped(fn):
    """``fn`` with each argument named in CAPS held to its cap."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        b = sig.bind(*args, **kwargs)
        b.apply_defaults()
        for name, cap in CAPS.items():
            if name in b.arguments:
                b.arguments[name] = min(b.arguments[name], cap)
        return fn(*b.args, **b.kwargs)
    return run


def _bench_line(mp, pkg, argv):
    """Run one package's ``main`` at the tiny size (``mp``: a
    MonkeyPatch); the JSON line it prints, its only line."""
    mp.setattr(jutils, "synthetic", SlowPanFrames)
    mp.setattr(tutils, "synthetic", SlowPanFrames)
    if pkg == "jax":
        mp.setattr(__graft_entry__, "flagship_config",
                   lambda: bench_config("jax"))
        mp.setattr("sys.argv", ["bench.py", *argv])
        mod, main = jbench, jbench.main
    else:
        mp.setattr(tconfig, "flagship_config",
                   lambda: bench_config("torch"))
        mod = tbench
        main = functools.partial(tbench.main, argv, device="cpu")
    for name in SECTIONS:
        mp.setattr(mod, name, _capped(getattr(mod, name)))
    return _printed(main)


def _printed(fn) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def lines():
    """{pkg: the full (capped) line} of both benches."""
    with pytest.MonkeyPatch.context() as mp:
        return {pkg: _bench_line(mp, pkg, []) for pkg in ("jax", "port")}


def _keys(d, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_main_keys_equal_jax_at_every_level(lines):
    assert _keys(lines["port"]) == _keys(lines["jax"]) | {"detail.device"}
    assert lines["port"]["detail"]["device"] == "cpu"
    assert lines["port"]["metric"] == lines["jax"]["metric"]
    assert lines["port"]["detail"]["workload"] == (
        lines["jax"]["detail"]["workload"])


def test_main_headline_rules(lines):
    t = lines["port"]
    d = t["detail"]
    back = d["keyframe_backend"]
    assert back["fps_min"] <= back["fps_median_of_3"] <= back["fps_max"]
    assert t["value"] == back["fps_median_of_3"]
    assert t["value_frontend_only"] == d["long_run"]["fps"]
    assert t["vs_baseline"] == round(
        min(t["value"], t["value_frontend_only"]) / 30.0, 4)
    assert d["endurance_two_lap"]["sweep_deg"] == 720.0
    assert d["steady_state_fps"] > 0


def test_incremental_micro_moves_as_jax(lines):
    j = lines["jax"]["detail"]["per_closure_ba_incremental"]
    t = lines["port"]["detail"]["per_closure_ba_incremental"]
    jm, tm = j["localized_micro"], t["localized_micro"]
    assert sorted(tm) == sorted(jm)
    assert (tm["keyframes"], tm["moved"]) == (jm["keyframes"], jm["moved"])
    assert tm["moved"] >= 1
    assert tm["incremental_s"] > 0 and tm["full_rebuild_s"] > 0


def test_chip_smoke_key_sets_are_bench_py_keys(lines):
    """chip_smoke.py's bench phase holds each section to ``BENCH_KEYS``
    (it may not import bench.py): the JAX line's keys, section by section
    (the headline's median keys and the micro added by ``main`` aside)."""
    keys = chip_smoke.BENCH_KEYS
    j = lines["jax"]
    d = j["detail"]
    assert set(d["long_run"]) == keys["long_run"]
    assert set(d["keyframe_backend"]) == keys["keyframe_backend"] | {
        "fps_median_of_3", "fps_min", "fps_max"}
    assert set(d["endurance_two_lap"]) == keys["per_closure_ba_incremental"]
    assert set(d["per_closure_ba_incremental"]) == (
        keys["per_closure_ba_incremental"] | {"localized_micro"})
    assert (set(d["per_closure_ba_incremental"]["localized_micro"])
            == keys["localized_micro"])
    for name in ("streaming_beyond_capacity", "streaming_plus_backend",
                 "stages"):
        assert set(d[name]) == keys[name], name
    assert set(d) - set(keys) == {"workload", "endurance_two_lap",
                                  "steady_state_fps"}


def test_stage_breakdown_has_four_stages(lines):
    st = lines["port"]["detail"]["stages"]
    assert set(st) == {"preprocess_ms", "icp_ms", "fuse_ms", "raycast_ms"}
    assert all(v >= 0 for v in st.values())


def test_stage_timer_gives_each_call_fresh_arguments():
    """``_mean_ms`` makes one untimed call, then ``reps`` timed ones, each
    on arguments made by ``fresh`` (the fuse's copy of the map)."""
    made = []

    def fresh():
        made.append(torch.zeros(3))
        return (made[-1],)

    ms = tbench._mean_ms(lambda t: t.add_(1), torch.device("cpu"), 3,
                         fresh=fresh)
    assert ms >= 0
    assert len(made) == 4 and all(int(t[0]) == 1 for t in made)


def test_quick_line_and_cli_bench(monkeypatch):
    j = _bench_line(monkeypatch, "jax", ["--quick"])
    t = _bench_line(monkeypatch, "port", ["--quick"])
    assert _keys(t) == _keys(j) | {"detail", "detail.device"}
    assert t["detail"] == {"device": "cpu"}
    assert t["value"] > 0
    assert t["vs_baseline"] == round(t["value"] / 30.0, 4)
    # the CLI's bench runs the twin (no longer a message)
    c = _printed(lambda: tcli.main(["--device", "cpu", "bench", "--quick"]))
    assert _keys(c) == _keys(t)
