"""The port's exporters (utils/pointcloud.py, utils/meshing.py) against
the JAX package's, on one map built by the JAX package and carried across
as numpy (the map of tests/test_pointcloud.py: a 160x120 camera, 2 cm
voxels, three fused views of the synthetic scene).

Both are host numpy code on the same values, so: equal counts; points,
normals, weights and vertices within 1e-6; faces equal.  PLY files round
trip, and a PLY written by the port is read by the JAX package's reader
(and the other way round).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import np_tree

from voxelhashing_demo_tpu import config as jcfg
from voxelhashing_demo_tpu.ops import hash_ops as jho
from voxelhashing_demo_tpu.ops import preprocess as jpre
from voxelhashing_demo_tpu.utils import meshing as jmesh
from voxelhashing_demo_tpu.utils import pointcloud as jpc
from voxelhashing_demo_tpu.utils import synthetic as jsyn
from voxelhashing_demo_tpu_torch import config as tcfg
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.ops import hash_ops as tho
from voxelhashing_demo_tpu_torch.utils import meshing as tmesh
from voxelhashing_demo_tpu_torch.utils import pointcloud as tpc
from voxelhashing_demo_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

CAM_KW = dict(width=160, height=120, fx=129.3, fy=129.1, cx=79.65, cy=59.8)
HASH_KW = dict(num_buckets=8192, bucket_size=4, num_blocks=8192,
               max_active=4096, max_new_per_frame=4096)
JCAM, TCAM = jcfg.CameraConfig(**CAM_KW), tcfg.CameraConfig(**CAM_KW)
JFUS = jcfg.FusionConfig(voxel_size=0.02, truncation=0.08)
TFUS = tcfg.FusionConfig(voxel_size=0.02, truncation=0.08)
JHASH, THASH = jcfg.HashConfig(**HASH_KW), tcfg.HashConfig(**HASH_KW)


@pytest.fixture(scope="module")
def maps():
    hmap = jho.create(JHASH)
    for t in (0.0, 0.5, 1.0):
        T = jnp.asarray(jsyn.orbit_pose(t, 0.05, 2.0))
        frame = jpre.preprocess_metric(jsyn.render_depth(T, JCAM), JCAM)
        hmap, _, _ = jho.fuse_frame(hmap, frame, T, JCAM, JHASH, JFUS)
    return hmap, convert.hashmap_from_numpy(np_tree(hmap), device="cpu")


@pytest.mark.parametrize("with_normals", [False, True])
def test_surface_points_match(maps, with_normals):
    jmap, tmap = maps
    jp, jn, jw = jpc.extract_surface_points(jmap, JHASH, JFUS,
                                            with_normals=with_normals)
    tp, tn, tw = tpc.extract_surface_points(tmap, THASH, TFUS,
                                            with_normals=with_normals)
    assert len(tp) == len(jp) > 1000
    assert tp.dtype == np.float32
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(tw, jw, atol=1e-6)
    if with_normals:
        np.testing.assert_allclose(tn, jn, atol=1e-6)
    else:
        assert tn is None and jn is None
    d = tsyn.scene_sdf(torch.from_numpy(tp)).abs().numpy()
    assert np.median(d) < TFUS.voxel_size


def test_mesh_matches(maps):
    jmap, tmap = maps
    jv, jf = jmesh.extract_mesh(jmap, JHASH, JFUS)
    tv, tf = tmesh.extract_mesh(tmap, THASH, TFUS)
    assert len(tv) == len(jv) > 1000 and len(tv) == 3 * len(tf)
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    np.testing.assert_array_equal(tf, jf)
    d = tsyn.scene_sdf(torch.from_numpy(tv)).abs().numpy()
    assert np.median(d) < TFUS.voxel_size


def test_empty_map_exports_nothing():
    empty = tho.create(THASH, device="cpu")
    p, n, w = tpc.extract_surface_points(empty, THASH, TFUS,
                                         with_normals=True)
    assert p.shape == (0, 3) and n.shape == (0, 3) and len(w) == 0
    v, f = tmesh.extract_mesh(empty, THASH, TFUS)
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_point_ply_roundtrip_across_packages(maps, tmp_path):
    jmap, tmap = maps
    tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    n = tpc.export_map_ply(tpath, tmap, THASH, TFUS)
    assert n == jpc.export_map_ply(jpath, jmap, JHASH, JFUS) > 1000
    want, _, _ = tpc.extract_surface_points(tmap, THASH, TFUS)
    for reader in (tpc.load_ply_points, jpc.load_ply_points):
        for path in (tpath, jpath):
            pts = reader(path)
            assert pts.shape == (n, 3) and np.isfinite(pts).all()
            np.testing.assert_allclose(pts, want, atol=1e-6)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    plain = str(tmp_path / "plain.ply")
    assert tpc.save_ply(plain, want) == n          # without normals
    np.testing.assert_array_equal(jpc.load_ply_points(plain), want)


def test_mesh_ply_matches_across_packages(maps, tmp_path):
    jmap, tmap = maps
    tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    nf = tmesh.export_mesh_ply(tpath, tmap, THASH, TFUS)
    assert nf == jmesh.export_mesh_ply(jpath, jmap, JHASH, JFUS) > 300
    tb, jb = open(tpath, "rb").read(), open(jpath, "rb").read()
    assert tb.startswith(b"ply\nformat binary_little_endian 1.0\n")
    head_t = tb[:tb.index(b"end_header\n")]
    assert head_t == jb[:jb.index(b"end_header\n")]
    assert f"element face {nf}".encode() in head_t
    assert len(tb) == len(jb)
    # the vertex block of a mesh PLY reads back through the point reader
    verts, _ = tmesh.extract_mesh(tmap, THASH, TFUS)
    np.testing.assert_array_equal(jpc.load_ply_points(tpath), verts)
