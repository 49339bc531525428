"""PyTorch port: configs equal the JAX package's, and the port imports no
JAX.  Exact equality (configs are plain Python values)."""

import dataclasses
import pathlib
import re

import pytest
import torch

import __graft_entry__
from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu_torch import config as tcfg

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

CLASSES = ["CameraConfig", "FrontendConfig", "ICPConfig", "FusionConfig",
           "DenseGridConfig", "HashConfig", "RaycastConfig", "GCConfig",
           "StreamConfig", "KeyframeConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf                      # names, order, annotations
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert t.__dataclass_params__.frozen


def test_named_configs_match():
    assert (dataclasses.asdict(tcfg.tiny_config())
            == dataclasses.asdict(jcfg.tiny_config()))
    assert (dataclasses.asdict(tcfg.flagship_config())
            == dataclasses.asdict(__graft_entry__.flagship_config()))
    g = tcfg.flagship_gather_config()
    assert g.hash.use_pallas_gather
    assert (dataclasses.asdict(dataclasses.replace(
        g, hash=dataclasses.replace(g.hash, use_pallas_gather=False)))
        == dataclasses.asdict(tcfg.flagship_config()))


def test_camera_scaled_matches():
    for f in (2, 4):
        assert (dataclasses.asdict(tcfg.CameraConfig().scaled(f))
                == dataclasses.asdict(jcfg.CameraConfig().scaled(f)))


def test_hash_properties_match():
    j, t = jcfg.HashConfig(), tcfg.HashConfig()
    assert (t.voxels_per_block, t.table_size) == (j.voxels_per_block,
                                                  j.table_size)


_JAX_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+voxelhashing_demo_tpu\b"
    r"|from\s+voxelhashing_demo_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "voxelhashing_demo_tpu_torch").rglob("*.py")
) + ["chip_smoke.py", "chip_profile.py", "chip_gather_compare.py",
   "chip_probe_compare.py", "chip_rounding_probe.py",
   "chip_splat_breakdown.py", "chip_slice_compare.py",
   "chip_phase_trace.py", "chip_ba_compare.py", "chip_dense_compare.py"])
def test_port_imports_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _JAX_IMPORT.search(src), path
