"""PyTorch port: the CLI (cli.py, ``python -m voxelhashing_demo_tpu_torch``)
against the JAX package's CLI, with ``--device cpu``.

Tolerances: ``run --small --synthetic 8`` prints the JAX CLI's JSON keys
(and per-frame record keys), the same frame and tracked counts, and an
unaligned ATE within 0.5 mm of JAX's on the same frames (each package
makes its own synthetic frames; they agree to the sensor's quantization);
``info`` and ``render``'s counts on one checkpoint are equal in both
packages; ``run --devices 2`` (two Gloo ranks) prints the JAX CLI's
``--devices 2`` keys with an unaligned ATE within 0.5 mm of it.
(``--resume`` and the dataset detection: tests/test_torch_cli_resume.py.)"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu import cli as jcli
from voxelhashing_demo_tpu_torch import cli as tcli
from voxelhashing_demo_tpu_torch.config import CameraConfig
from voxelhashing_demo_tpu_torch.utils import synthetic, tum

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _port(capsys, *args):
    tcli.main(["--device", "cpu", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax(capsys, *args):
    jcli.main(list(args))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``run --small --synthetic 8`` in both CLIs (render-every 4, render
    last); their output directories and JSON lines."""
    root = tmp_path_factory.mktemp("cli_runs")
    out = {}
    for pkg, main in (("port", lambda a: tcli.main(["--device", "cpu"] + a)),
                      ("jax", jcli.main)):
        d = str(root / pkg)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--small", "run", "--synthetic", "8", "--out", d,
                  "--render-last", "--render-every", "4"])
        out[pkg] = (d, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return out


def test_run_matches_jax_cli(runs):
    (td, t), (jd, j) = runs["port"], runs["jax"]
    assert sorted(t) == sorted(j)
    assert t["frames"] == j["frames"] == 8
    assert t["tracked_frames"] == j["tracked_frames"] >= 7
    assert abs(t["ate_rmse_unaligned_m"] - j["ate_rmse_unaligned_m"]) < 5e-4
    assert abs(t["ate_rmse_m"] - j["ate_rmse_m"]) < 5e-4
    assert t["live_frames"] == j["live_frames"] == 2
    assert t["renders"] == j["renders"]
    for name in ("trajectory.txt", "metrics.jsonl", "map.npz", "final.png",
                 "final_depth.png", "live_00003.png", "live_00007.png"):
        assert os.path.exists(os.path.join(td, name)), name
    rows = [json.loads(x) for x in open(os.path.join(td, "metrics.jsonl"))]
    jrows = [json.loads(x) for x in open(os.path.join(jd, "metrics.jsonl"))]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert [r["tracked"] for r in rows] == [r["tracked"] for r in jrows]
    assert len(open(os.path.join(td, "trajectory.txt")).readlines()) == 8


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_info_and_render_equal_across_packages(runs, tmp_path, capsys,
                                               writer):
    """The port's ``info`` / ``render`` on either package's checkpoint
    print what the JAX CLI prints on it."""
    ck = os.path.join(runs[writer][0], "map.npz")
    t = _port(capsys, "info", "--checkpoint", ck)
    j = _jax(capsys, "info", "--checkpoint", ck)
    assert t == j
    assert t["frames_processed"] == 8 and t["occupied_blocks"] > 0
    args = ["render", "--checkpoint", ck, "--orbit", "2", "--ply",
            "pts.ply", "--mesh", "mesh.ply"]
    t = _port(capsys, *args, "--out", str(tmp_path / "t"))
    j = _jax(capsys, *args, "--out", str(tmp_path / "j"))
    assert t == j
    assert t["ply"]["points"] > 0 and t["mesh"]["faces"] > 0
    for name in ("orbit_000.png", "orbit_001.png", "pts.ply", "mesh.ply"):
        assert os.path.getsize(tmp_path / "t" / name) > 0


def test_evaluate_equals_jax(runs, capsys):
    td, t = runs["port"]
    gt = os.path.join(td, "gt.txt")
    _, poses = synthetic.make_sequence(
        CameraConfig().scaled(4), 8, trans_amp=0.10, rot_amp_deg=5.0,
        device="cpu")
    from voxelhashing_demo_tpu_torch.utils import checkpoint

    checkpoint.export_trajectory_tum(gt, poses)
    args = ["evaluate", "--est", os.path.join(td, "trajectory.txt"),
            "--gt", gt]
    ev = _port(capsys, *args)
    assert ev == _jax(capsys, *args)
    assert ev["pairs"] == 8
    # the run's own figure, from the file's six decimals
    assert abs(ev["ate_rmse_unaligned_m"] - t["ate_rmse_unaligned_m"]) < 2e-5


def test_demo_on_fixture_pngs_matches_jax(tmp_path, capsys):
    seq = tum.TUMSequence(os.path.join(FIXTURES, "kinect_png16_loop"))
    root = os.path.join(FIXTURES, "kinect_png16_loop")
    f0, f1 = (os.path.join(root, seq.entries[i][1]) for i in (0, 1))
    t = _port(capsys, "--small", "demo", f0, f1, "--out",
              str(tmp_path / "t"))
    j = _jax(capsys, "--small", "demo", f0, f1, "--out", str(tmp_path / "j"))
    assert sorted(t) == sorted(j) and t["outputs"] == j["outputs"]
    assert t["occupied_blocks"] == j["occupied_blocks"] > 0
    assert abs(t["icp_inliers"] - j["icp_inliers"]) <= 0.01 * j[
        "icp_inliers"]
    np.testing.assert_allclose(t["relative_translation_m"],
                               j["relative_translation_m"], atol=1e-4)
    for name in t["outputs"]:
        assert os.path.getsize(tmp_path / "t" / name) > 0


def test_default_config_equals_jax():
    for args in (["run"], ["run", "--preset", "fr2"],
                 ["--small", "run", "--preset", "fr3", "--intrinsics",
                  "500.0,501.0,320.0,240.0"],
                 ["run", "--stream", "--kf-rotation", "3",
                  "--kf-translation", "0.2"], ["--small", "demo"]):
        t = tcli._default_config(tcli.build_parser().parse_args(args))
        j = jcli._default_config(jcli.build_parser().parse_args(args))
        assert dataclasses.asdict(t) == dataclasses.asdict(j), args
    assert tcli.build_parser().parse_args(["info", "--checkpoint",
                                           "x"]).device == "cuda"


def test_devices_and_bench_exit_with_their_messages(tmp_path):
    """``run --devices 2 --device cpu`` shards the map over two Gloo ranks
    and prints the JAX CLI's ``--devices 2`` JSON keys, the same frame and
    tracked counts and an unaligned ATE within 0.5 mm of it; rank 0 alone
    writes the outputs.  Over NCCL (``--device cuda``) two ranks need two
    cards: with fewer the command exits naming both counts.  ``bench``
    runs the benchmark twin on the card, so without one torch's own error
    stops it (no message: tests/test_torch_bench_main.py runs it on the
    CPU)."""
    args = ["--small", "run", "--synthetic", "8", "--devices", "2"]
    outs = {}
    for pkg, main in (("port", lambda a: tcli.main(["--device", "cpu"] + a)),
                      ("jax", jcli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(args + ["--out", str(tmp_path / pkg)])
        outs[pkg] = json.loads(buf.getvalue().strip().splitlines()[-1])
    t, j = outs["port"], outs["jax"]
    assert sorted(t) == sorted(j)
    assert t["frames"] == j["frames"] == 8
    assert t["tracked_frames"] == j["tracked_frames"] >= 7
    assert abs(t["ate_rmse_unaligned_m"] - j["ate_rmse_unaligned_m"]) < 5e-4
    for name in ("trajectory.txt", "metrics.jsonl", "map.npz"):
        assert os.path.exists(str(tmp_path / "port" / name)), name
    with np.load(str(tmp_path / "port" / "map.npz")) as z:
        assert int(z["mesh_n"]) == 2
    cards = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"need 2 CUDA cards.*{cards} "
                                         "present"):
        tcli.main(["run", "--synthetic", "2", "--devices", "2"])
    assert tcli.build_parser().parse_args(["bench"]).fn is tcli.cmd_bench
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tcli.main(["bench", "--quick"])


def test_without_a_card_the_default_device_fails(tmp_path):
    """No quiet CPU fallback: without ``--device cpu`` the CLI targets the
    card, and without one torch raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tcli.main(["--small", "run", "--synthetic", "2", "--out",
                   str(tmp_path / "o")])


def test_package_exports_as_jax():
    import voxelhashing_demo_tpu as jpkg

    import voxelhashing_demo_tpu_torch as tpkg
    from voxelhashing_demo_tpu_torch import config

    assert tpkg.__version__ == jpkg.__version__
    assert tpkg.PipelineConfig is config.PipelineConfig
    assert (dataclasses.asdict(tpkg.tiny_config())
            == dataclasses.asdict(jpkg.tiny_config()))
    assert not hasattr(tpkg, "release_compiled")
