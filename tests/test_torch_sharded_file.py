"""PyTorch port: which file a sharded load reads (``utils/checkpoint.
_sharded_file``).  The global file alone, or this rank's per-process shard
alone, is read as before; both present raise ``ValueError`` naming the
shard file pattern, where a stale global file used to shadow newer shards
(the JAX package reads the global file whenever it exists).  Loading from
either file alone is covered by tests/test_torch_sharded_checkpoint.py."""

import types

import numpy as np
import pytest

from voxelhashing_demo_tpu_torch.utils import checkpoint as tck


def _mesh(rank, size=2):
    """The (rank, size) a shard's file name is made of."""
    return types.SimpleNamespace(rank=rank, size=size)


def _touch(path):
    np.savez(path, x=np.zeros(1))


@pytest.mark.parametrize("present", ["global", "shard"])
def test_one_file_alone_is_read(tmp_path, present):
    path = str(tmp_path / "run.npz")
    pp = tck.per_process_path(path, _mesh(1))
    _touch(path if present == "global" else pp)
    assert tck._sharded_file(path, _mesh(1)) == (
        path if present == "global" else pp)


def test_absent_files_leave_the_global_path(tmp_path):
    """Neither file: the global path, so ``np.load`` names it."""
    path = str(tmp_path / "run.npz")
    assert tck._sharded_file(path, _mesh(0)) == path


@pytest.mark.parametrize("rank", [0, 1])
def test_global_file_beside_this_ranks_shard_raises(tmp_path, rank):
    path = str(tmp_path / "run.npz")
    _touch(path)
    _touch(tck.per_process_path(path, _mesh(rank)))
    with pytest.raises(ValueError, match=r"run\.proc<rank>of<n>\.npz"):
        tck._sharded_file(path, _mesh(rank))
    # another rank's shard beside the global file shadows nothing here
    assert tck._sharded_file(path, _mesh(1 - rank)) == path


def test_load_sharded_slam_refuses_the_shadowed_shard(tmp_path):
    path = str(tmp_path / "run.npz")
    _touch(path)
    _touch(tck.per_process_path(path, _mesh(0)))
    with pytest.raises(ValueError, match=r"shard file .*proc0of2\.npz"):
        tck.load_sharded_slam(path, _mesh(0))
