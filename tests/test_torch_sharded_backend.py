"""PyTorch port: the keyframe backend over a mesh (``KeyframeSLAM(config,
mesh)`` and ``optimize_graph_sharded``) on two Gloo ranks on the CPU
against the JAX package's on a 2-device mesh of conftest's virtual CPU
devices.

Tolerances:
- ``optimize_graph_sharded`` on tests/test_sharded.py's noisy 6-pose
  ring (11 edges: one padding edge on 2 ranks): poses within 1e-4 of the
  JAX package's sharded solve and of the port's single-device
  ``optimize``; chi2 within 1e-6; the two ranks' poses bit-identical (the
  summed systems are added in rank order on every rank).  An explicit
  ``ba_solver="cg"`` raises, as in JAX.
- The backend scenario of tests/test_torch_keyframe_slam.py (24 orbit
  frames at 80x60, a drift injected before frame 12, the tiny
  flagship-gather configuration): keyframe frames, edges, BA frames,
  rebuild modes, moved counts, tracked flags, capacity events and
  saturation equal to JAX's ``KeyframeSLAM(mesh=make_mesh(2))``; graph
  poses within 1e-4; every frame's position within 1e-3 m (the
  single-device scenario's bound); ATE within 1 mm; the ranks' decisions,
  trajectories and graphs bit-identical.  The JAX side runs the window
  gather off (its Pallas kernel does not trace under shard_map's
  replication check; at 80x60 the window covers the image, so the values
  are the same).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (BACKEND_DISCRETE, BACKEND_INJECT_AT,
                                backend_config, backend_drift,
                                backend_frames, backend_summary)

from voxelhashing_demo_tpu.config import KeyframeConfig as JKeyframeConfig
from voxelhashing_demo_tpu.geometry import se3 as jse3
from voxelhashing_demo_tpu.models import keyframe_slam as jkf
from voxelhashing_demo_tpu.ops import pose_graph as jpg
from voxelhashing_demo_tpu.parallel import sharded as js
from voxelhashing_demo_tpu_torch import convert
from voxelhashing_demo_tpu_torch.config import KeyframeConfig
from voxelhashing_demo_tpu_torch.ops import pose_graph as tpg
from voxelhashing_demo_tpu_torch.parallel import launch, ranks, sharded
from voxelhashing_demo_tpu_torch.utils import metrics

torch.set_num_threads(1)

TIMEOUT_S = 300


def ring_graph():
    """tests/test_sharded.py's ring: 6 poses on a circle, noisy odometry,
    one loop edge; capacity 11 edges."""
    rng = np.random.RandomState(1)
    K = 6
    gt = []
    for i in range(K):
        a = 2 * np.pi * i / K
        xi = np.array([np.cos(a), 0, np.sin(a), 0, a, 0], dtype=np.float32)
        gt.append(np.asarray(jse3.exp(jnp.asarray(xi))))
    g = jpg.create(K, 11)
    est = [gt[0]]
    for i in range(K - 1):
        z = np.linalg.inv(gt[i]) @ gt[i + 1]
        noise = np.concatenate([rng.normal(0, 0.02, 3),
                                rng.normal(0, 0.01, 3)]).astype(np.float32)
        est.append(est[-1] @ (z @ np.asarray(jse3.exp(jnp.asarray(noise)))))
    for T in est:
        g = jpg.add_pose(g, jnp.asarray(T, dtype=jnp.float32))
    for i in range(K - 1):
        z = (np.linalg.inv(gt[i]) @ gt[i + 1]).astype(np.float32)
        g = jpg.add_edge(g, i, i + 1, jnp.asarray(z))
    z = (np.linalg.inv(gt[K - 1]) @ gt[0]).astype(np.float32)
    return jpg.add_edge(g, K - 1, 0, jnp.asarray(z))


def test_sharded_ba_matches_jax():
    g = ring_graph()
    j_out, j_info = js.optimize_graph_sharded(g, JKeyframeConfig(ba_iters=6),
                                              js.make_mesh(2))
    g_np = {f: np.asarray(getattr(g, f)) for f in g._fields}
    kcfg = KeyframeConfig(ba_iters=6)
    a, b = launch.spawn(ranks.run_ba, 2, None, "cpu", TIMEOUT_S, g_np, kcfg)
    np.testing.assert_array_equal(a["poses"], b["poses"])
    assert a["chi2"] == b["chi2"]
    np.testing.assert_allclose(a["poses"], np.asarray(j_out.poses),
                               atol=1e-4)
    np.testing.assert_allclose(a["chi2"][1], float(j_info.chi2_final),
                               atol=1e-6)
    assert a["chi2"][1] < 0.01 * a["chi2"][0]
    single, _ = tpg.optimize(convert.pose_graph_from_numpy(g_np, "cpu"),
                             kcfg)
    np.testing.assert_allclose(a["poses"], single.poses.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="single-device"):
        sharded.optimize_graph_sharded(
            None, dataclasses.replace(kcfg, ba_solver="cg"), None)


@pytest.fixture(scope="module")
def scenario():
    depths, gt = backend_frames()
    depths = [np.asarray(d) for d in depths]
    jcfg = backend_config("jax")
    jcfg = dataclasses.replace(
        jcfg, hash=dataclasses.replace(jcfg.hash, use_pallas_gather=False))
    slam = jkf.KeyframeSLAM(jcfg, mesh=js.make_mesh(2))
    D = jnp.asarray(backend_drift())
    for i, d in enumerate(depths):
        if i == BACKEND_INJECT_AT:
            slam.state = slam.state._replace(pose=D @ slam.state.pose)
        slam.process(jnp.asarray(d))
    traj = slam.trajectory()
    port = launch.spawn(ranks.run_keyframe, 2, None, "cpu", TIMEOUT_S,
                        backend_config("torch"), depths,
                        {BACKEND_INJECT_AT: backend_drift()})
    return dict(gt=gt, jax=backend_summary(slam, traj, gt),
                jtraj=np.stack([np.asarray(p) for p in traj]),
                jgraph=np.asarray(slam.graph.poses), port=port)


def test_keyframe_slam_on_a_mesh_decides_as_jax(scenario):
    a, b = scenario["port"]
    j = scenario["jax"]
    for k in BACKEND_DISCRETE:
        assert a[k] == j[k], (k, a[k], j[k])
        assert a[k] == b[k], k
    # the scenario exercises the backend: loop edges, a full rebuild,
    # then incremental moves
    assert any(e[1] - e[0] > 1 for e in a["edges"])
    assert "full" in a["ba_modes"] and "incremental" in a["ba_modes"]


def test_keyframe_slam_on_a_mesh_poses(scenario):
    a, b = scenario["port"]
    np.testing.assert_array_equal(a["trajectory"], b["trajectory"])
    np.testing.assert_array_equal(a["graph_poses"], b["graph_poses"])
    np.testing.assert_allclose(a["graph_poses"], scenario["jgraph"],
                               atol=1e-4)
    np.testing.assert_allclose(a["trajectory"][:, :3, 3],
                               scenario["jtraj"][:, :3, 3], atol=1e-3)
    ate = metrics.ate_rmse(list(a["trajectory"]),
                           scenario["gt"][:len(a["trajectory"])],
                           align=False)
    assert abs(ate - scenario["jax"]["ate"]) < 1e-3
