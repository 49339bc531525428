"""Multi-rank runtime of the sharded stack (port of parallel/distributed.py)
on ``torch.distributed``.

The JAX package runs the sharded stack as SPMD over a 1-D device mesh.
PyTorch runs one process per device, so here each mesh position is one
RANK of the default process group: ``Mesh`` names the group, this rank's
position and its device.  A "global" tensor is the concatenation of the
ranks' shards in rank order (the JAX package's axis-0 sharded layout);
``fetch`` all-gathers it, ``local_rows`` is this rank's shard.

Backends (``initialize``): NCCL when every rank has a CUDA card of its
own (rank r takes ``cuda:r``); Gloo on the CPU.  More ranks than cards on
CUDA is refused: NCCL does not run two ranks on one device.  A caller that
wants several ranks on one card asks for ``backend="gloo"``; the map, the
frames and every kernel then stay on the card and only the collectives
cross the host: Gloo takes the CUDA tensors and copies them through host
memory for its transport (on an H100 it accepted every collective used
here: ``all_gather`` into a list or a tensor, ``all_reduce`` SUM and MIN).
``Mesh.collective_host_bytes`` counts those bytes.

Host-logic rules (the JAX package's two ground rules, hard rules here):

1. Every rank calls every collective, in the same order, with tensors of
   the same shape and dtype.  Every rank feeds the same frames and runs
   the same code, and every host decision that precedes a collective
   derives from replicated values, which are bit-identical on every rank
   (``psum`` sums the gathered shards in rank order on every rank, so
   even float sums agree bit for bit).
2. Nothing derived from per-rank state (a local count, a store shard)
   gates a collective.  A rank that skipped one would leave the others
   waiting until the group's timeout.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# a hung collective fails after this long instead of waiting forever
DEFAULT_TIMEOUT_S = 120.0


def choose_backend(world_size: int, backend: str | None = None,
                   device="cuda") -> str:
    """The backend ``initialize`` takes (see there); raises when NCCL
    would need more cards than are present."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size is None or world_size > cards:
            raise ValueError(
                f"{world_size} ranks over NCCL need {world_size} CUDA "
                f"cards, one per rank; {cards} present (several ranks on "
                "one card: backend='gloo')")
    return backend


def initialize(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout: float = DEFAULT_TIMEOUT_S,
               device="cuda") -> str:
    """Join the default process group (idempotent); returns the backend.

    ``device`` is the device type the ranks compute on.  With ``backend``
    None: CUDA takes NCCL and needs a card per rank (raises, naming both
    counts, when ``world_size`` exceeds the cards present), the CPU takes
    Gloo.  ``backend="gloo"`` with CUDA runs several ranks on one card."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = choose_backend(world_size, backend, device)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return backend


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass
class Mesh:
    """The 1-D mesh: ``size`` ranks, this process at position ``rank``,
    computing on ``device``.  ``collective_host_bytes`` counts the bytes
    of CUDA tensors handed to Gloo collectives and received from them
    (Gloo moves them through host memory); ``collectives`` counts the
    collectives."""

    size: int
    rank: int
    device: torch.device
    backend: str
    collective_host_bytes: int = 0
    collectives: int = 0

    def _count(self, x: torch.Tensor, out: torch.Tensor) -> None:
        self.collectives += 1
        if self.backend == "gloo" and x.is_cuda:
            self.collective_host_bytes += (x.numel() + out.numel()) * (
                x.element_size())


def global_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the initialized default group.  ``n_devices`` must
    equal the group's world size: a mesh is never cut to the ranks
    present.  ``device`` None: the CUDA card of this rank (``cuda:rank``
    modulo the cards present); "cpu" on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed.initialize "
                           "(or run under parallel.launch.spawn) first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a {n_devices}-position mesh needs {n_devices} "
                         f"ranks; the process group has {size}")
    backend = dist.get_backend()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA cards, not {dev}")
    if dev.type == "cuda":
        # the rank's card is its current device (this also initializes
        # CUDA in the rank's process)
        torch.cuda.set_device(dev)
    return Mesh(size=size, rank=rank, device=dev, backend=backend)


# --------------------------------------------------------------------------
# collectives (every rank calls each one, in the same order)
# --------------------------------------------------------------------------

def all_gather(mesh: Mesh, x: torch.Tensor, tiled: bool = True):
    """Every rank's ``x`` in rank order: concatenated along axis 0
    (``tiled``, the global layout of a sharded tensor) or stacked on a new
    leading axis of length ``mesh.size``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    out = torch.stack(parts)
    mesh._count(x, out)
    return out.reshape((-1,) + tuple(x.shape[1:])) if tiled and x.dim() else (
        out)


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks, added in rank order on every rank: the
    result is bit-identical everywhere (a ring all-reduce's order depends
    on the backend)."""
    parts = all_gather(mesh, x, tiled=False)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def pmin(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the ranks (exact in any order)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN)
    mesh._count(x, out)
    return out


def fetch(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """The global array of a row-sharded tensor, on the host (collective)."""
    return all_gather(mesh, x).cpu().numpy()


def local_rows(x) -> np.ndarray:
    """This rank's rows of a sharded tensor, on the host (no
    communication)."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().cpu().numpy()


def _gather_np(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """Stack equal-shaped host arrays of every rank: (size, ...)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    return all_gather(mesh, t, tiled=False).cpu().numpy()


def gather_concat(mesh: Mesh, local: np.ndarray) -> np.ndarray:
    """Concatenate the ranks' host arrays of varying axis-0 length in rank
    order (collective: every rank calls with its own, possibly empty,
    rows)."""
    return gather_concat_many(mesh, {"a": local})["a"]


def _gather_with_counts(mesh: Mesh, local: np.ndarray, counts) -> np.ndarray:
    """Data half of ``gather_concat`` given every rank's row count."""
    m = int(max(counts))
    if m == 0:
        return local
    pad = m - local.shape[0]
    padded = np.concatenate(
        [local, np.zeros((pad,) + local.shape[1:], local.dtype)]
    ) if pad else local
    stacked = _gather_np(mesh, padded)
    return np.concatenate([stacked[i, :int(c)] for i, c in enumerate(counts)])


def gather_concat_many(mesh: Mesh, arrays: dict) -> dict:
    """``gather_concat`` of several same-length host arrays with one
    gather of the counts."""
    lens = {v.shape[0] for v in arrays.values()}
    if len(lens) != 1:
        raise ValueError(f"mismatched lengths {lens}")
    counts = _gather_np(mesh, np.asarray([lens.pop()], np.int64)).reshape(-1)
    return {k: _gather_with_counts(mesh, v, counts)
            for k, v in arrays.items()}


def psum_host(mesh: Mesh, value: int) -> int:
    """Sum of a per-rank host integer over the ranks (collective)."""
    return int(_gather_np(mesh, np.asarray([value], np.int64)).sum())


def owner_process_mask(mesh: Mesh, owner_pos: np.ndarray) -> np.ndarray:
    """True where the mesh position in ``owner_pos`` is this rank."""
    return np.asarray(owner_pos) == mesh.rank


def shard_rows_to_global(local: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a sharded tensor, uploaded to its device (each
    rank holds only its own shard, so no communication)."""
    return torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)
