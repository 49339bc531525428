"""PyTorch port: a ``KeyframeSLAM`` checkpoint crosses between the packages
(utils/checkpoint.py ``save_keyframe_slam`` / ``load_keyframe_slam``).

The backend scenario's first 12 frames (tests/torch_port_helpers.py) run in
the port and are saved; the JAX package loads the file and the port loads
JAX's re-save of it.  Bit-exact: the map state, the pose graph (poses,
edges, host counts written as JAX's 0-d int32), keyframe depths and frame
indices, frame refs, event logs and BA deferral counters; the re-saved
file equals the original key by key; the keyframes' downsampled frames
recomputed on load equal the live run's (the same ``make_kf_pre``).  The
JAX run of the same frames writes the same keys and dtypes, and BA events
of the same JSON types.  3 further frames agree to 1e-5 m per pose, as in
tests/test_torch_checkpoint.py."""

import json

import jax.numpy as jnp
import numpy as np
import torch
from torch_port_helpers import (assert_files_equal, assert_states_equal,
                                backend_config, backend_frames,
                                continue_both)

from voxelhashing_demo_tpu.models import keyframe_slam as jkf
from voxelhashing_demo_tpu.utils import checkpoint as jck
from voxelhashing_demo_tpu_torch.models import keyframe_slam as tkf
from voxelhashing_demo_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


def _events_types(events):
    """The JSON type of every value of every event (nested dicts too)."""
    def types(v):
        if isinstance(v, dict):
            return {k: types(x) for k, x in v.items()}
        return type(v).__name__

    return [types(e) for e in events]


def test_keyframe_slam_both_ways(tmp_path):
    depths = [np.asarray(d) for d in backend_frames()[0]]
    n = 12
    slam = tkf.KeyframeSLAM(backend_config("torch"), device="cpu")
    for d in depths[:n]:
        slam.process(d)
    path = str(tmp_path / "port.npz")
    tck.save_keyframe_slam(path, slam)
    assert len(slam.keyframes) >= 3 and slam.ba_events

    j = jck.load_keyframe_slam(path)
    assert_states_equal(slam.state, j.state)
    assert int(j.graph.num_poses) == slam.graph.num_poses
    assert int(j.graph.num_edges) == slam.graph.num_edges
    for f in ("poses", "edges_ij", "edges_T", "edges_w"):
        np.testing.assert_array_equal(getattr(slam.graph, f).numpy(),
                                      np.asarray(getattr(j.graph, f)))
    assert ([r.frame_index for r in j.keyframes]
            == [r.frame_index for r in slam.keyframes])
    for a, b in zip(slam.keyframes, j.keyframes):
        np.testing.assert_array_equal(a.depth_np(), b.depth_raw)
    assert len(j._frame_refs) == n
    for (ka, ra), (kb, rb) in zip(slam._frame_refs, j._frame_refs):
        assert ka == kb
        np.testing.assert_array_equal(ra, rb)
    assert j.ba_events == slam.ba_events
    assert (j._frame_idx, j._pending_ba_edges, j._pending_ba_since) == (
        slam._frame_idx, slam._pending_ba_edges, slam._pending_ba_since)
    resaved = str(tmp_path / "jax.npz")
    jck.save_keyframe_slam(resaved, j)
    assert_files_equal(path, resaved)

    t = tck.load_keyframe_slam(resaved, device="cpu")
    assert isinstance(t, tkf.KeyframeSLAM)
    assert_states_equal(t.state, j.state)
    assert (t._n_poses, t._n_edges) == (slam.graph.num_poses,
                                        slam.graph.num_edges)
    np.testing.assert_array_equal(t._poses_np, slam._poses_np)
    for a, b in zip(t.keyframes, slam.keyframes):
        # recomputed through the live run's make_kf_pre: the same frame
        for f in a.frame._fields:
            assert torch.equal(getattr(a.frame, f), getattr(b.frame, f))
    assert t.ba_events == slam.ba_events
    for a, b in zip(t.trajectory(), slam.trajectory()):
        np.testing.assert_array_equal(a, b)

    # the JAX run of the same frames writes events of the same JSON types
    js = jkf.KeyframeSLAM(backend_config("jax"))
    for d in depths[:n]:
        js.process(jnp.asarray(d))
    jpath = str(tmp_path / "jax_run.npz")
    jck.save_keyframe_slam(jpath, js)
    with np.load(path) as zt, np.load(jpath) as zj:
        et = json.loads(bytes(zt["extra.events_json"]).decode())
        ej = json.loads(bytes(zj["extra.events_json"]).decode())
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype, k
    assert sorted(et) == sorted(ej)
    assert _events_types(et["ba_events"]) == _events_types(ej["ba_events"])

    continue_both(t, j, depths[n:n + 3])
