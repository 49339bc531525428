"""PyTorch port: the scaling harness
(voxelhashing_demo_tpu_torch/tools/scaling_bench.py) with the JAX tool's
arguments.  ``--cpu --max-devices 2`` at 80x60, 2 timed frames after 1
warm-up: one spawn of one Gloo rank, then one of two, printing one JSON
line each with the JAX tool's keys, ``devices`` 1 and 2, ``fps > 0``, and
the efficiency of one rank against itself exactly 1.  The configuration is
the JAX tool's, held equal field by field (it builds it inline, so its
values are restated here from tools/scaling_bench.py)."""

import dataclasses
import json
import math

import torch

from voxelhashing_demo_tpu.config import (CameraConfig, FusionConfig,
                                          GCConfig, HashConfig, ICPConfig,
                                          PipelineConfig, RaycastConfig)
from voxelhashing_demo_tpu_torch.tools import scaling_bench

torch.set_num_threads(1)


def test_config_is_the_jax_tools():
    W, H = 80, 60
    scale = W / 640.0
    jax_cfg = PipelineConfig(
        camera=CameraConfig(width=W, height=H, fx=517.3 * scale,
                            fy=516.5 * scale, cx=(W - 1) / 2,
                            cy=(H - 1) / 2),
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
        hash=HashConfig(num_buckets=65536, bucket_size=4, num_blocks=65536,
                        max_active=4096, max_new_per_frame=4096,
                        candidate_stride=3),
        raycast=RaycastConfig(mode="splat"),
        gc=GCConfig(enabled=True, interval=16),
    )
    assert (dataclasses.asdict(scaling_bench.scaling_config(W, H))
            == dataclasses.asdict(jax_cfg))


def test_cpu_two_counts_print_the_jax_lines(capsys):
    lines = scaling_bench.main(["--cpu", "--max-devices", "2", "--width",
                                "80", "--height", "60", "--frames", "2",
                                "--warmup", "1"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed == lines
    assert [ln["devices"] for ln in lines] == [1, 2]
    for ln in lines:
        assert set(ln) == {"devices", "fps", "efficiency_vs_1"}
        assert math.isfinite(ln["fps"]) and ln["fps"] > 0
        assert math.isfinite(ln["efficiency_vs_1"])
    assert lines[0]["efficiency_vs_1"] == 1.0
