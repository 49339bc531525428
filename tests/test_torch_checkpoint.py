"""PyTorch port: checkpoints (utils/checkpoint.py) cross between the packages.

A map saved by one package is opened by the other, for a plain map, a
streaming map with a non-empty host store and a ``KeyframeSLAM``:

- the loaded state equals the saved one bit for bit: the map's integer
  state (keys, ptrs, bucket_fill, free_list, free_top, last_seen, born)
  and float rows (tsdf, weight, band_min), pose, model, velocity, frame
  counter, trajectory, the store's keys and rows, the pose graph and the
  keyframe backend's records;
- the file a package writes from the other's loaded state has the same
  keys, dtypes, shapes and values as the file it was loaded from;
- 3 further frames from the loaded state, in each package, agree to
  1e-5 m per pose (inside the 7-10 frames over which the two packages'
  own trajectories agree that closely, ROADMAP Queue 3 F2).

(``KeyframeSLAM``: tests/test_torch_checkpoint_keyframe.py; a JAX map
written from a 2-device mesh: tests/test_torch_checkpoint_mesh.py; the
helpers are in tests/torch_port_helpers.py.)

Also: old files without ``last_seen`` /
``band_min`` / ``born`` / ``vel`` take the JAX defaults; one device's
per-process file (rank 0 of 1) crosses to the JAX package and back, and
``load_slam`` refuses a mesh rank's shard (tests/test_torch_sharded_
checkpoint.py loads those); the JSON config, the TUM trajectory and the SDF dump are
byte-equal to the JAX package's."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_files_equal, assert_states_equal,
                                assert_stores_equal,
                                assert_trajectories_equal, backend_config,
                                backend_frames, continue_both, stream_config,
                                stream_frames, tiny_flagship_gather_config)

from voxelhashing_demo_tpu.models import hash_slam as jhs
from voxelhashing_demo_tpu.utils import checkpoint as jck
from voxelhashing_demo_tpu_torch.config import PipelineConfig as TPipe
from voxelhashing_demo_tpu_torch.config import flagship_gather_config
from voxelhashing_demo_tpu_torch.models import hash_slam as ths
from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf
from voxelhashing_demo_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

def test_config_json_equal():
    from voxelhashing_demo_tpu import config as jcfg

    import __graft_entry__

    for t, j in ((TPipe(), jcfg.PipelineConfig()),
                 (tiny_flagship_gather_config("torch"),
                  tiny_flagship_gather_config("jax")),
                 (stream_config("torch"), stream_config("jax")),
                 (backend_config("torch"), backend_config("jax"))):
        s = tck.config_to_json(t)
        assert s == jck.config_to_json(j)
        assert tck.config_from_json(s) == t
    g = flagship_gather_config()
    jg = dataclasses.replace(
        __graft_entry__.flagship_config(),
        hash=dataclasses.replace(__graft_entry__.flagship_config().hash,
                                 use_pallas_gather=True))
    assert tck.config_to_json(g) == jck.config_to_json(jg)
    # unknown fields are ignored, missing ones take defaults
    raw = json.loads(tck.config_to_json(g))
    raw["hash"]["no_such_field"] = 3
    del raw["icp"]
    back = tck.config_from_json(json.dumps(raw))
    assert back.hash == g.hash and back.icp == TPipe().icp


@pytest.fixture(scope="module")
def frames():
    depths, gt = backend_frames()
    return [np.asarray(d) for d in depths], gt


def test_plain_map_port_to_jax(tmp_path, frames):
    depths, _ = frames
    cfg = tiny_flagship_gather_config("torch")
    slam = ths.HashSLAM(cfg, device="cpu")
    for d in depths[:4]:
        slam.process(d)
    path = str(tmp_path / "port.npz")
    tck.save_slam(path, slam)

    j, graph = jck.load_slam(path)
    assert graph is None and isinstance(j, jhs.HashSLAM)
    assert j.config == tiny_flagship_gather_config("jax")
    assert_states_equal(slam.state, j.state)
    assert_trajectories_equal(slam.trajectory, j.trajectory)
    resaved = str(tmp_path / "jax.npz")
    jck.save_slam(resaved, j)
    assert_files_equal(path, resaved)

    t, _ = tck.load_slam(path, device="cpu")
    assert_states_equal(t.state, j.state)
    continue_both(t, j, depths[4:7])


def test_plain_map_jax_to_port(tmp_path, frames):
    depths, _ = frames
    j = jhs.HashSLAM(tiny_flagship_gather_config("jax"))
    for d in depths[:4]:
        j.process(jnp.asarray(d))
    path = str(tmp_path / "jax.npz")
    jck.save_slam(path, j)

    t, graph = tck.load_slam(path, device="cpu")
    assert graph is None and t.config == tiny_flagship_gather_config("torch")
    assert t.device.type == "cpu" and t.state.hmap.keys.device.type == "cpu"
    assert_states_equal(t.state, j.state)
    assert_trajectories_equal(t.trajectory, j.trajectory)
    resaved = str(tmp_path / "port.npz")
    tck.save_slam(resaved, t)
    assert_files_equal(path, resaved)
    continue_both(t, j, depths[4:7])


def test_streaming_map_both_ways(tmp_path):
    depths, _ = stream_frames()
    slam = ths.HashSLAM(stream_config("torch"), device="cpu")
    for d in depths[:16]:
        slam.process(d)
    path = str(tmp_path / "port.npz")
    tck.save_slam(path, slam)           # quiesces the cycle first
    assert len(slam.store) > 0 and slam.store.total_evicted > 0

    j, _ = jck.load_slam(path)
    assert_states_equal(slam.state, j.state)
    assert_stores_equal(slam.store, j.store)
    resaved = str(tmp_path / "jax.npz")
    jck.save_slam(resaved, j)
    assert_files_equal(path, resaved)

    t, _ = tck.load_slam(resaved, device="cpu")
    assert_states_equal(t.state, j.state)
    assert_stores_equal(t.store, j.store)
    assert t._prefetch is None and t._pending_evict is None
    continue_both(t, j, depths[16:19])
    t.stream_sync()
    j.stream_sync()
    assert_stores_equal(t.store, j.store)


def test_old_format_defaults(tmp_path, frames):
    depths, _ = frames
    slam = ths.HashSLAM(tiny_flagship_gather_config("torch"), device="cpu")
    for d in depths[:2]:
        slam.process(d)
    path = str(tmp_path / "new.npz")
    tck.save_slam(path, slam)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files
               if k not in ("state.hmap.last_seen", "state.hmap.band_min",
                            "state.hmap.born", "state.vel", "mesh_n")}
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    t, _ = tck.load_slam(old_path, device="cpu")
    j, _ = jck.load_slam(old_path)
    assert_states_equal(t.state, j.state)
    assert not t.state.hmap.last_seen.any() and not t.state.hmap.born.any()
    np.testing.assert_array_equal(t.state.vel.numpy(), np.eye(4))
    np.testing.assert_array_equal(t.state.hmap.band_min.numpy(),
                                  slam.state.hmap.band_min.numpy())


def test_newer_format_and_shards_raise(tmp_path, frames):
    depths, _ = frames
    slam = ths.HashSLAM(tiny_flagship_gather_config("torch"), device="cpu")
    slam.process(depths[0])
    # one device's per-process file: rank 0 of 1, every leaf in full; the
    # JAX package reads it and writes the same file back
    tck.save_slam(str(tmp_path / "pp.npz"), slam, per_process=True)
    pp = str(tmp_path / "pp.proc0of1.npz")
    j, _ = jck.load_slam(pp)
    jck.save_slam(str(tmp_path / "jpp.npz"), j, per_process=True)
    assert_files_equal(pp, str(tmp_path / "jpp.proc0of1.npz"))
    assert_states_equal(tck.load_slam(pp, device="cpu")[0].state, j.state)
    k = tkf.KeyframeSLAM(backend_config("torch"), device="cpu")
    k.process(depths[0])
    tck.save_keyframe_slam(str(tmp_path / "pk.npz"), k, per_process=True)
    k2 = tck.load_keyframe_slam(str(tmp_path / "pk.proc0of1.npz"),
                                device="cpu")
    assert len(k2.keyframes) == len(k.keyframes) == 1
    path = str(tmp_path / "a.npz")
    tck.save_slam(path, slam)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    # one rank's shard of a mesh's per-process checkpoint holds only its
    # rows: load_slam sends it to load_sharded_slam
    shard = dict(arrays, pp_process_index=np.int64(0),
                 pp_process_count=np.int64(2),
                 pp_sharded_keys=np.frombuffer(b'["state.hmap.tsdf"]',
                                               np.uint8))
    np.savez_compressed(str(tmp_path / "shard.npz"), **shard)
    with pytest.raises(ValueError, match="per-process shard"):
        tck.load_slam(str(tmp_path / "shard.npz"), device="cpu")
    np.savez_compressed(str(tmp_path / "v2.npz"),
                        **dict(arrays, format_version=np.int64(2)))
    with pytest.raises(ValueError, match="newer"):
        tck.load_slam(str(tmp_path / "v2.npz"), device="cpu")
    with pytest.raises(ValueError, match="not a keyframe checkpoint"):
        tck.load_keyframe_slam(path, device="cpu")


def test_trajectory_and_sdf_dump_bytes_equal(tmp_path, frames):
    depths, gt = frames
    slam = ths.HashSLAM(tiny_flagship_gather_config("torch"), device="cpu")
    for d in depths[:2]:
        slam.process(d)
    a, b = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ts = [0.5 * i + 0.25 for i in range(len(gt))]
    for stamps in (None, ts):
        tck.export_trajectory_tum(a, gt, timestamps=stamps)
        jck.export_trajectory_tum(b, gt, timestamps=stamps)
        assert open(a).read() == open(b).read()
    # tensors (fetched once) give the numpy text
    tck.export_trajectory_tum(a, [torch.from_numpy(np.asarray(p))
                                  for p in gt])
    jck.export_trajectory_tum(b, gt)
    assert open(a).read() == open(b).read()

    from voxelhashing_demo_tpu.ops import hash_ops as jho

    jmap = jho.HashMap(**{f: jnp.asarray(getattr(slam.state.hmap, f).numpy())
                          for f in jho.HashMap._fields})
    n = tck.dump_sdf(a, slam.state.hmap, slam.config.hash)
    assert n == jck.dump_sdf(b, jmap, tiny_flagship_gather_config("jax").hash)
    assert n > 100
    assert open(a).read() == open(b).read()
