"""PyTorch port: a JAX map written from a 2-device mesh (``mesh_n = 2``,
the virtual CPU mesh of tests/conftest.py) loads in the port converted to
the single-device layout (utils/checkpoint.py ``_sharded_map_to_single``).

Compared as (key -> payload) sets, not slots: the port's load holds the
same keys with bit-equal tsdf, weight, last_seen and born rows as the JAX
package's own load of the file and as the mesh's gathered arrays, the same
free-row count, and the same trajectory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_trajectories_equal, backend_frames

from voxelhashing_demo_tpu.utils import checkpoint as jck
from voxelhashing_demo_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    depths, gt = backend_frames()
    return [np.asarray(d) for d in depths], gt


def test_two_device_mesh_file_loads_content_equal(tmp_path, frames):
    from voxelhashing_demo_tpu.config import tiny_config
    from voxelhashing_demo_tpu.parallel import sharded

    depths, _ = frames
    cfg = tiny_config()
    s = sharded.ShardedHashSLAM(cfg, sharded.make_mesh(2))
    for d in depths[:3]:
        s.process(jnp.asarray(d))
    path = str(tmp_path / "mesh2.npz")
    jck.save_slam(path, s)
    with np.load(path) as z:
        assert int(z["mesh_n"]) == 2

    def content(keys, ptrs, tsdf, weight, last_seen, born):
        occ = np.nonzero(ptrs >= 0)[0]
        return {int(keys[i]): (tsdf[ptrs[i]], weight[ptrs[i]],
                               int(last_seen[ptrs[i]]), int(born[ptrs[i]]))
                for i in occ}

    j, _ = jck.load_slam(path)
    t, _ = tck.load_slam(path, device="cpu")
    jh, th = j.state.hmap, t.state.hmap
    jc = content(*(np.asarray(getattr(jh, f)) for f in
                   ("keys", "ptrs", "tsdf", "weight", "last_seen", "born")))
    tc = content(*(getattr(th, f).numpy() for f in
                   ("keys", "ptrs", "tsdf", "weight", "last_seen", "born")))
    assert sorted(tc) == sorted(jc) and len(tc) > 100
    for k in tc:
        for a, b in zip(tc[k], jc[k]):
            np.testing.assert_array_equal(a, b)
    assert int(th.free_top) == int(jh.free_top)
    # and against the mesh's own gathered arrays
    sh = s.state.hmap
    keys, ptrs = np.asarray(sh.keys), np.asarray(sh.ptrs)
    localT, localB = keys.shape[0] // 2, np.asarray(sh.tsdf).shape[0] // 2
    occ = np.nonzero(ptrs >= 0)[0]
    rows = (occ // localT) * localB + ptrs[occ]
    assert sorted(int(k) for k in keys[occ]) == sorted(tc)
    ts = np.asarray(sh.tsdf)
    for k, r in zip(keys[occ], rows):
        np.testing.assert_array_equal(tc[int(k)][0], ts[r])
    assert_trajectories_equal(t.trajectory, j.trajectory)
