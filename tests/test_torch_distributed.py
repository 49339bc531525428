"""PyTorch port: the multi-rank runtime (parallel/distributed.py and
parallel/launch.py) on two Gloo ranks on the CPU, and the sharded
layout's host helpers against the JAX package's.

Each launch spawns two ranks (``launch.spawn``: a ``file://`` rendezvous
in a fresh temporary directory, one intra-op thread per CPU rank, a join
timeout).  The collectives are exact here: ``psum`` adds the gathered
shards in rank order (so it equals numpy's ``a + b``), ``pmin`` and the
gathers move values unchanged.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelhashing_demo_tpu.config import HashConfig as JHashConfig
from voxelhashing_demo_tpu.parallel import sharded as jsharded
from voxelhashing_demo_tpu_torch.config import HashConfig
from voxelhashing_demo_tpu_torch.parallel import (distributed, launch, ranks,
                                                  sharded)

torch.set_num_threads(1)

TIMEOUT_S = 120


@pytest.fixture(scope="module")
def coll():
    return launch.spawn(ranks.collectives, 2, None, "cpu", TIMEOUT_S, 3)


def test_collectives_on_two_gloo_ranks(coll):
    a, b = coll
    assert [a["rank"], b["rank"]] == [0, 1]
    assert a["size"] == b["size"] == 2
    assert a["backend"] == b["backend"] == "gloo"
    for r in (a, b):
        np.testing.assert_array_equal(r["psum"], a["x"] + b["x"])
        np.testing.assert_array_equal(r["psum_int"], a["ints"] + b["ints"])
        assert r["psum_int"].dtype == np.int32
        np.testing.assert_array_equal(r["pmin"], np.minimum(a["x"], b["x"]))
        np.testing.assert_array_equal(r["tiled"],
                                      np.concatenate([a["x"], b["x"]]))
        np.testing.assert_array_equal(r["fetch"], r["tiled"])
        np.testing.assert_array_equal(r["stacked"], np.stack([a["x"],
                                                              b["x"]]))
        rows = np.concatenate([a["rows"], b["rows"]])
        np.testing.assert_array_equal(r["gather_concat"], rows)
        np.testing.assert_array_equal(r["gather_many"]["a"], rows)
        np.testing.assert_array_equal(r["gather_many"]["b"], rows[:, 0])
        assert r["psum_host"] == 7 + 8
        # only CUDA tensors over Gloo count as bytes through the host
        assert r["host_bytes"] == 0
    np.testing.assert_array_equal(a["owner_mask"], [True, False] * 2)
    np.testing.assert_array_equal(b["owner_mask"], [False, True] * 2)


def test_a_failing_rank_stops_the_launch():
    """Seed -1 fails rank 0 alone, before its first collective; rank 1
    then waits in that collective until the launch kills it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        launch.spawn(ranks.collectives, 2, None, "cpu", TIMEOUT_S, -1)
    assert time.monotonic() - t0 < 60


def test_a_mesh_is_never_cut_to_the_ranks_present(tmp_path):
    """A one-rank group gives a one-position mesh; asking it for two
    raises (JAX's devices[:n] would quietly shrink)."""
    with pytest.raises(RuntimeError, match="no process group"):
        sharded.make_mesh(1, device="cpu")
    distributed.initialize(init_method=f"file://{tmp_path}/rdzv", rank=0,
                           world_size=1, device="cpu")
    try:
        mesh = sharded.make_mesh(1, device="cpu")
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 ranks; the process "
                                             "group has 1"):
            sharded.make_mesh(2, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_nccl_needs_a_card_per_rank():
    """More ranks than cards over NCCL raise before anything starts,
    naming both counts; the CPU takes Gloo."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {cards + 1} CUDA cards.*"
                                         f"{cards} present"):
        distributed.choose_backend(cards + 1, None, "cuda")
    with pytest.raises(ValueError, match="present"):
        launch.spawn(ranks.collectives, cards + 1, None, "cuda", TIMEOUT_S,
                     0)
    assert distributed.choose_backend(2, None, "cpu") == "gloo"
    assert distributed.choose_backend(2, "gloo", "cuda") == "gloo"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_owner_np_matches_jax(n):
    rng = np.random.default_rng(n)
    blocks = rng.integers(-512, 512, (4096, 3)).astype(np.int32)
    ours = sharded._owner_np(blocks, 2048, n)
    np.testing.assert_array_equal(ours,
                                  jsharded._owner_np(blocks, 2048, n))
    dev = sharded._owner(torch.from_numpy(blocks), HashConfig(num_buckets=2048),
                         n).numpy()
    np.testing.assert_array_equal(dev, ours)
    jdev = np.asarray(jsharded._owner(jnp.asarray(blocks),
                                      JHashConfig(num_buckets=2048), n))
    np.testing.assert_array_equal(dev, jdev)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_hash_config_matches_jax(n):
    cfg = HashConfig(num_buckets=2048, num_blocks=1024, max_active=512,
                     max_new_per_frame=256)
    jcfg = JHashConfig(num_buckets=2048, num_blocks=1024, max_active=512,
                       max_new_per_frame=256)
    assert (dataclasses.asdict(sharded.local_hash_config(cfg, n))
            == dataclasses.asdict(jsharded.local_hash_config(jcfg, n)))
    with pytest.raises(ValueError, match="does not divide"):
        sharded.local_hash_config(cfg, 3)
