"""Launch one process per mesh position (the port's counterpart of running
the JAX package's SPMD program over a device mesh).

``spawn(fn, world_size, backend, device, timeout_s, *args)`` starts
``world_size`` processes with the ``spawn`` start method.  Each joins the
default process group through a ``file://`` rendezvous in a fresh
temporary directory (so concurrent launches never share a port), builds
its ``Mesh`` and returns ``fn(mesh, *args)``; ``spawn`` returns the ranks'
results in rank order.  ``fn`` must be importable by name (a module-level
function of this package: a child imports it fresh) and its arguments and
result picklable.

A rank that raises makes ``spawn`` stop every rank and raise with that
rank's traceback; so does ``timeout_s`` running out (the ranks are
killed).  CPU ranks run one intra-op thread each, so ``n`` ranks do not
oversubscribe the host.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from . import distributed


def _entry(rank, world_size, backend, device, init_method, fn, args, out):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        distributed.initialize(backend=backend, init_method=init_method,
                               rank=rank, world_size=world_size,
                               device=device)
        mesh = distributed.global_mesh(world_size, device=device)
        result = fn(mesh, *args)
        out.put((rank, True, result))
    except BaseException:      # reported to the parent, which stops all
        out.put((rank, False, traceback.format_exc()))
        return
    try:
        torch.distributed.destroy_process_group()
    except Exception:           # the parent has the result; exit anyway
        pass


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def spawn(fn, world_size: int, backend: str | None = None, device="cuda",
          timeout_s: float | None = 600.0, *args) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks; returns their
    results in rank order.  ``backend`` None: NCCL on CUDA (a card per
    rank), Gloo on the CPU (``distributed.initialize``).  ``timeout_s``
    None waits as long as the ranks run."""
    backend = distributed.choose_backend(world_size, backend, device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vh_rdzv_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, world_size, backend, str(device),
                               init_method, fn, args, out))
             for r in range(world_size)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            wait = 1.0 if deadline is None else min(
                1.0, deadline - time.monotonic())
            if wait <= 0:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within {timeout_s} "
                    f"s; {len(results)} returned")
            try:
                rank, ok, value = out.get(timeout=wait)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
