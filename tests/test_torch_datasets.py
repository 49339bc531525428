"""PyTorch port: the ICL-NUIM and ScanNet dataset layers (utils/icl.py,
utils/scannet.py) against the JAX package.

Tolerances: files written by one package are byte-equal to the other's
and load to equal frames and poses in both; ``euclidean_to_z`` /
``z_to_euclidean`` agree to 1e-6 (float64 in both); the camera from a
ScanNet intrinsic file is equal field by field."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import CameraConfig as JCam
from voxelhashing_demo_tpu.utils import icl as jicl
from voxelhashing_demo_tpu.utils import scannet as jscan
from voxelhashing_demo_tpu_torch.config import CameraConfig as TCam
from voxelhashing_demo_tpu_torch.utils import icl as ticl
from voxelhashing_demo_tpu_torch.utils import scannet as tscan

torch.set_num_threads(1)

CAM = dict(width=40, height=30, fx=40.0, fy=41.0, cx=19.5, cy=14.5,
           depth_scale=5000.0)


def _frames(n, seed=0):
    """Raw uint16 depth (TUM units, holes included) and rigid poses."""
    from voxelhashing_demo_tpu_torch.geometry import se3

    rng = np.random.default_rng(seed)
    depths, poses = [], []
    for _ in range(n):
        d = rng.integers(2000, 15000, (CAM["height"], CAM["width"]))
        d[rng.random(d.shape) < 0.1] = 0
        depths.append(d.astype(np.uint16))
        poses.append(se3.exp(torch.tensor(rng.normal(size=6) * 0.3,
                                          dtype=torch.float32)).numpy())
    return depths, poses


def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_depth_conversions_match_jax():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.2, 5.0, (CAM["height"], CAM["width"]))
    jc, tc = JCam(**CAM), TCam(**CAM)
    np.testing.assert_allclose(ticl.euclidean_to_z(d, tc),
                               jicl.euclidean_to_z(d, jc), atol=1e-6)
    np.testing.assert_allclose(ticl.z_to_euclidean(d, tc),
                               jicl.z_to_euclidean(d, jc), atol=1e-6)
    np.testing.assert_allclose(
        ticl.euclidean_to_z(ticl.z_to_euclidean(d, tc), tc), d, atol=1e-6)
    assert (dataclasses.asdict(ticl.icl_camera())
            == dataclasses.asdict(jicl.icl_camera()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_icl_export_load_across_packages(tmp_path, writer):
    depths, poses = _frames(3)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    (jicl if writer == "jax" else ticl).export_icl_sequence(
        a, depths, poses, JCam(**CAM) if writer == "jax" else TCam(**CAM))
    (ticl if writer == "jax" else jicl).export_icl_sequence(
        b, depths, poses, TCam(**CAM) if writer == "jax" else JCam(**CAM))
    assert _tree_bytes(a) == _tree_bytes(b)

    ts = ticl.ICLSequence(a, cam=TCam(**CAM))
    js = jicl.ICLSequence(a, cam=JCam(**CAM))
    assert ts.entries == js.entries and len(ts) == 3
    td, tp = ts.load_all()
    jd, jp = js.load_all()
    for x, y, ref in zip(td, jd, depths):
        np.testing.assert_array_equal(x, y)
        # 6 decimals of euclidean metres: a few TUM units at most
        assert np.abs(x.astype(np.int64) - ref).max() <= 1
    for x, y, ref in zip(tp, jp, poses):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(x, ref, atol=1e-5)
    cam_file = os.path.join(a, "scene_00_1.txt")
    tparams = ticl.parse_cam_file(cam_file)
    jparams = jicl.parse_cam_file(cam_file)
    assert sorted(tparams) == sorted(jparams)
    for k in tparams:
        np.testing.assert_array_equal(tparams[k], jparams[k])
    np.testing.assert_array_equal(ticl.pose_from_cam(tparams),
                                  jicl.pose_from_cam(jparams))
    z = ticl.read_depth_file(os.path.join(a, "scene_00_2.depth"),
                             TCam(**CAM))
    np.testing.assert_array_equal(
        z, jicl.read_depth_file(os.path.join(a, "scene_00_2.depth"),
                                JCam(**CAM)))
    assert len(ticl.ICLSequence(a, cam=TCam(**CAM), max_frames=2)) == 2


def test_icl_wrong_size_raises(tmp_path):
    depths, poses = _frames(1)
    ticl.export_icl_sequence(str(tmp_path), depths, poses, TCam(**CAM))
    small = dataclasses.replace(TCam(**CAM), width=20)
    with pytest.raises(ValueError):
        ticl.read_depth_file(str(tmp_path / "scene_00_0.depth"), small)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ticl.ICLSequence(str(tmp_path / "empty"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scannet_export_load_across_packages(tmp_path, writer):
    depths, poses = _frames(3, seed=2)
    poses[1] = None                      # an untracked frame (-inf rows)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    (jscan if writer == "jax" else tscan).export_scannet_sequence(
        a, depths, poses, JCam(**CAM) if writer == "jax" else TCam(**CAM))
    (tscan if writer == "jax" else jscan).export_scannet_sequence(
        b, depths, poses, TCam(**CAM) if writer == "jax" else JCam(**CAM))
    assert _tree_bytes(a) == _tree_bytes(b)

    ts, js = tscan.ScanNetSequence(a), jscan.ScanNetSequence(a)
    assert dataclasses.asdict(ts.cam) == dataclasses.asdict(js.cam)
    assert ts.entries == js.entries and ts.has_gt == js.has_gt
    td, tp = ts.load_all()
    jd, jp = js.load_all()
    for x, y in zip(td, jd):
        np.testing.assert_array_equal(x, y)
    assert tp[1] is None and jp[1] is None
    for i in (0, 2):
        np.testing.assert_array_equal(tp[i], jp[i])
        np.testing.assert_allclose(tp[i], poses[i], atol=1e-6)


def test_camera_from_intrinsic_matches_jax(tmp_path):
    p = str(tmp_path / "intrinsic_depth.txt")
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 577.59, 578.73, 318.90, 242.68
    with open(p, "w") as f:
        for row in K:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    for scale in (1000.0, 5000.0):
        t = tscan.camera_from_intrinsic(p, 640, 480, depth_scale=scale)
        j = jscan.camera_from_intrinsic(p, 640, 480, depth_scale=scale)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert isinstance(t, TCam)
    np.testing.assert_array_equal(tscan.read_matrix_txt(p),
                                  jscan.read_matrix_txt(p))
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("1 2 3\n")
    with pytest.raises(ValueError):
        tscan.read_matrix_txt(bad)


def test_scannet_without_intrinsics_defaults_like_jax(tmp_path):
    depths, poses = _frames(2, seed=4)
    root = str(tmp_path / "scene")
    tscan.export_scannet_sequence(root, depths, poses, TCam(**CAM))
    os.remove(os.path.join(root, "intrinsic", "intrinsic_depth.txt"))
    assert (dataclasses.asdict(tscan.ScanNetSequence(root).cam)
            == dataclasses.asdict(jscan.ScanNetSequence(root).cam))
