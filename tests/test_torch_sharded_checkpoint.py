"""PyTorch port: checkpoints of a sharded run (utils/checkpoint.py under a
mesh) on two Gloo ranks on the CPU, against the JAX package's files from
a 2-device mesh of conftest's virtual CPU devices, in both directions.

Equality here is exact:
- a file the JAX package wrote, loaded by the port's ``load_sharded_slam``
  on two ranks and saved again, equals it key by key (dtype, shape,
  value); each rank's restored shard equals the file's rows;
- a file the port's ranks wrote, loaded by the JAX package's
  ``load_sharded_slam`` and saved again, equals it key by key;
- per-process shard files (``per_process=True``): rank r's file holds its
  rows of the sharded leaves and the replicated leaves in full; loaded
  back on two ranks they restore the same state, and a run continued from
  them is bit-identical to one continued from the global file;
- ``load_slam`` of a sharded file gives the single-device map that the
  JAX package's ``load_slam`` gives (the same blocks, rows equal by key);
- the keyframe backend: the port's ``save_keyframe_slam`` of
  ``KeyframeSLAM(mesh)`` reloads in the JAX package and saves back to the
  same file; the port's runs resumed from the global file and from the
  per-process files continue bit-identically.
After a load both packages continue the same frames with poses within
1e-5 m (the single-device checkpoint tests' bound).
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (BACKEND_INJECT_AT, assert_files_equal,
                                backend_config, backend_frames,
                                sharded_config, sharded_frames)

from voxelhashing_demo_tpu.parallel import sharded as js
from voxelhashing_demo_tpu.utils import checkpoint as jck
from voxelhashing_demo_tpu_torch.parallel import launch, ranks
from voxelhashing_demo_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

TIMEOUT_S = 300
CUT, N = 4, 6
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def frames():
    return sharded_frames(N)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory, frames):
    """A JAX sharded run saved after CUT frames, and its continuation."""
    d = tmp_path_factory.mktemp("jax_sharded")
    mesh = js.make_mesh(2)
    slam = js.ShardedHashSLAM(sharded_config("jax"), mesh)
    for f in frames[:CUT]:
        slam.process(jnp.asarray(f))
    path = str(d / "jax.npz")
    jck.save_slam(path, slam)
    poses = [np.asarray(slam.process(jnp.asarray(f)).pose)
             for f in frames[CUT:]]
    return path, poses


@pytest.fixture(scope="module")
def port_files(tmp_path_factory, frames):
    """The port's two ranks: CUT frames saved as one global file and as
    per-process shards."""
    d = tmp_path_factory.mktemp("port_sharded")
    path, pp = str(d / "port.npz"), str(d / "pp.npz")
    out = launch.spawn(ranks.save_run, 2, None, "cpu", TIMEOUT_S,
                       sharded_config("torch"), frames[:CUT],
                       [(path, False), (pp, True)])
    return path, pp, out


def _split(z, key, r):
    return np.split(np.asarray(z[key]), 2)[r]


def test_port_loads_jax_file_and_saves_it_back(jax_file, frames, tmp_path):
    path, jposes = jax_file
    again = str(tmp_path / "again.npz")
    res = launch.spawn(ranks.load_runs, 2, None, "cpu", TIMEOUT_S,
                       [(path, again)], frames[CUT:])
    assert_files_equal(path, again)
    with np.load(path) as z:
        for r, (out,) in enumerate(res):
            for k, v in out["state"].items():
                key = f"state.{k}"
                if k.startswith(("hmap.", "model.")):
                    np.testing.assert_array_equal(v, _split(z, key, r), k)
                else:
                    np.testing.assert_array_equal(v, z[key], k)
    for t, j in zip(res[0][0]["poses"], jposes):
        np.testing.assert_allclose(t, j, atol=POSE_ATOL)


def test_jax_loads_port_file_and_saves_it_back(port_files, tmp_path):
    path, _, out = port_files
    slam = jck.load_sharded_slam(path, js.make_mesh(2))
    again = str(tmp_path / "again.npz")
    jck.save_slam(again, slam)
    assert_files_equal(path, again)
    with np.load(path) as z:
        assert int(z["mesh_n"]) == 2
        assert z["state.hmap.free_top"].shape == (2,)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(
                o["state"]["hmap.keys"], _split(z, "state.hmap.keys", r))


def test_per_process_shards(port_files, frames):
    path, pp, out = port_files
    assert not os.path.exists(pp)
    with np.load(path) as g:
        for r in range(2):
            with np.load(tck.per_process_path(pp, _Mesh(r))) as z:
                keys = set(json.loads(bytes(z["pp_sharded_keys"]).decode()))
                assert keys == {k for k in g.files
                                if k.startswith(("state.hmap.",
                                                 "state.model."))}
                assert (int(z["pp_process_index"]),
                        int(z["pp_process_count"])) == (r, 2)
                assert int(z["mesh_n"]) == 2
                for k in g.files:
                    if k in keys:
                        np.testing.assert_array_equal(z[k], _split(g, k, r))
                    else:
                        np.testing.assert_array_equal(z[k], g[k], k)
        with pytest.raises(ValueError, match="per-process shard"):
            tck.load_slam(tck.per_process_path(pp, _Mesh(1)), device="cpu")
    a, b = launch.spawn(ranks.load_runs, 2, None, "cpu", TIMEOUT_S,
                        [(pp, None), (path, None)], frames[CUT:])
    for r, res in enumerate((a, b)):
        for k, v in res[0]["state"].items():
            np.testing.assert_array_equal(v, res[1]["state"][k], k)
            np.testing.assert_array_equal(v, out[r]["state"][k], k)
        for p, q in zip(res[0]["poses"], res[1]["poses"]):
            np.testing.assert_array_equal(p, q)


def _Mesh(rank):
    """The (rank, size) a shard's file name is made of."""
    return types.SimpleNamespace(rank=rank, size=2)


def test_load_slam_converts_a_sharded_file(port_files):
    path = port_files[0]
    t, _ = tck.load_slam(path, device="cpu")
    j, _ = jck.load_slam(path)
    assert t.state.hmap.keys.shape == (2048 * 4,)

    def by_key(h):
        keys, ptrs = np.asarray(h.keys), np.asarray(h.ptrs)
        occ = ptrs >= 0
        order = np.argsort(keys[occ])
        rows = ptrs[occ][order]
        return (keys[occ][order], np.asarray(h.tsdf)[rows],
                np.asarray(h.weight)[rows], np.asarray(h.born)[rows])

    for a, b in zip(by_key(t.state.hmap), by_key(j.state.hmap)):
        np.testing.assert_array_equal(a, b)
    assert int(t.state.hmap.free_top) == int(j.state.hmap.free_top)


def test_keyframe_checkpoint_both_ways(tmp_path):
    depths, _ = backend_frames()
    depths = [np.asarray(d) for d in depths]
    path, pp = str(tmp_path / "kf.npz"), str(tmp_path / "kfpp.npz")
    cut = BACKEND_INJECT_AT
    (saved, _) = launch.spawn(ranks.save_run, 2, None, "cpu", TIMEOUT_S,
                              backend_config("torch"), depths[:cut],
                              [(path, False), (pp, True)], True)
    jslam = jck.load_keyframe_slam(path, js.make_mesh(2))
    again = str(tmp_path / "again.npz")
    jck.save_keyframe_slam(again, jslam)
    assert_files_equal(path, again)
    np.testing.assert_array_equal(
        np.stack([np.asarray(p) for p in jslam.trajectory()]),
        saved["trajectory"])
    a, _ = launch.spawn(ranks.load_runs, 2, None, "cpu", TIMEOUT_S,
                        [(path, None), (pp, None)], depths[cut:cut + 4],
                        True)
    for k, v in a[0]["state"].items():
        np.testing.assert_array_equal(v, a[1]["state"][k], k)
    np.testing.assert_array_equal(a[0]["trajectory"], a[1]["trajectory"])
    np.testing.assert_array_equal(a[0]["graph_poses"], a[1]["graph_poses"])
    assert len(a[0]["trajectory"]) == cut + 4
