"""PyTorch port: the CLI's ``run --resume`` (hash and keyframe backends)
and its dataset detection, with ``--device cpu``.

A resumed run ends within 1e-4 m (hash) / 1e-3 m (keyframe) ATE of the
uninterrupted one and reports the same keyframes and edges, the bounds of
the JAX package's own tests (tests/test_checkpoint_cli.py); ``evaluate``
on the resumed trajectory agrees with the run to 1e-3 m; ICL-NUIM and
ScanNet directories are detected and tracked."""

import json
import os

import torch

from voxelhashing_demo_tpu_torch import cli as tcli
from voxelhashing_demo_tpu_torch.config import CameraConfig
from voxelhashing_demo_tpu_torch.utils import synthetic, tum

torch.set_num_threads(1)


def _port(capsys, *args):
    tcli.main(["--device", "cpu", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _tum_dir(tmp_path, n, trans_amp, rot_amp_deg):
    cam = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                       cx=79.65, cy=59.8)
    depths, poses = synthetic.make_sequence(cam, n, trans_amp=trans_amp,
                                            rot_amp_deg=rot_amp_deg,
                                            device="cpu")
    root = str(tmp_path / "seq")
    tum.export_sequence(root, depths, poses)
    return root


def test_resume_continues_as_uninterrupted(tmp_path, capsys):
    root = _tum_dir(tmp_path, 7, 0.05, 2.5)
    full = _port(capsys, "--small", "run", "--dataset", root, "--out",
                 str(tmp_path / "full"), "--checkpoint-every", "3")
    assert full["frames"] == 7 and full["tracked_frames"] >= 6
    half = _port(capsys, "--small", "run", "--dataset", root,
                 "--max-frames", "4", "--out", str(tmp_path / "half"))
    assert half["frames"] == 4
    resumed = _port(capsys, "--small", "run", "--dataset", root, "--resume",
                    str(tmp_path / "half" / "map.npz"), "--out",
                    str(tmp_path / "resumed"))
    assert resumed["frames"] == 3
    assert abs(resumed["ate_rmse_m"] - full["ate_rmse_m"]) < 1e-4
    ev = _port(capsys, "evaluate", "--est",
               str(tmp_path / "resumed" / "trajectory.txt"), "--gt",
               os.path.join(root, "groundtruth.txt"))
    assert ev["pairs"] == 7
    assert abs(ev["ate_rmse_m"] - resumed["ate_rmse_m"]) < 1e-3


def test_keyframe_backend_resume(tmp_path, capsys):
    root = _tum_dir(tmp_path, 8, 0.10, 5.0)
    kf = ["--kf-rotation", "2.0", "--kf-translation", "0.03"]
    full = _port(capsys, "--small", "run", "--dataset", root, "--backend",
                 "keyframe", "--out", str(tmp_path / "full"), *kf)
    assert full["frames"] == 8 and full["keyframes"] >= 2
    half = _port(capsys, "--small", "run", "--dataset", root,
                 "--max-frames", "5", "--backend", "keyframe", "--out",
                 str(tmp_path / "half"), *kf)
    assert half["keyframes"] >= 2
    resumed = _port(capsys, "--small", "run", "--dataset", root,
                    "--backend", "keyframe", "--resume",
                    str(tmp_path / "half" / "map.npz"), "--out",
                    str(tmp_path / "res"))
    assert resumed["frames"] == 3
    assert sorted(resumed) == sorted(full)
    assert resumed["keyframes"] == full["keyframes"]
    assert resumed["graph_edges"] == full["graph_edges"]
    assert abs(resumed["ate_rmse_m"] - full["ate_rmse_m"]) < 1e-3
    info = _port(capsys, "info", "--checkpoint",
                 str(tmp_path / "res" / "map.npz"))
    assert info["graph"] == {"keyframes": full["keyframes"],
                             "edges": full["graph_edges"]}


def test_run_detects_icl_and_scannet(tmp_path, capsys):
    from voxelhashing_demo_tpu_torch.utils import icl, scannet

    cam = CameraConfig().scaled(4)
    depths, poses = synthetic.make_sequence(cam, 3, trans_amp=0.05,
                                            rot_amp_deg=2.5, device="cpu")
    icl.export_icl_sequence(str(tmp_path / "icl"), depths, poses, cam)
    scannet.export_scannet_sequence(str(tmp_path / "scannet"), depths,
                                    poses, cam)
    for name in ("icl", "scannet"):
        r = _port(capsys, "--small", "run", "--dataset",
                  str(tmp_path / name), "--out", str(tmp_path / f"o_{name}"))
        assert r["frames"] == 3 and r["tracked_frames"] >= 2, name
        assert r["ate_rmse_unaligned_m"] < 0.02, name
