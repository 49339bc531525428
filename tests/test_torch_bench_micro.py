"""PyTorch port: the primitive microbenchmarks
(voxelhashing_demo_tpu_torch/tools/bench_micro.py) against the JAX tool
``tools/bench_micro.py``, which runs its ops when it is imported (so its
labels are read from its source here, not imported).  ``main(device="cpu",
n=1)`` runs every op once timed and returns every JAX label, in the JAX
order, each with a finite host ms; on the CPU no device time is taken."""

import math
import pathlib
import re

import torch

from voxelhashing_demo_tpu_torch.tools import bench_micro

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_labels() -> list:
    src = (ROOT / "tools" / "bench_micro.py").read_text()
    return re.findall(r'^timeit\("([^"]+)"', src, re.M)


def test_main_returns_every_jax_label_with_a_finite_ms(capsys):
    labels = _jax_labels()
    assert len(labels) == 16
    out = bench_micro.main(device="cpu", n=1)
    assert list(out) == labels
    assert all(isinstance(v, float) and math.isfinite(v) and v >= 0
               for v in out.values())
    text = capsys.readouterr().out
    assert text.count("not measured") == 16
    assert "device: cpu" in text
