"""Run a function on a local group of ranks, with a bounded wait.

The entry points of ``sharded.py`` run inside a process group that their
caller creates.  ``run_ranks`` is such a caller for one host: it spawns one
process per rank, gives each a process group of the backend it is asked
for (rendezvous through a ``FileStore`` in a directory of the caller's, no
TCP port), runs the function in every rank and returns each rank's result.
A rank that raises fails the run and the others are stopped; ranks that do
not finish in time are killed and the run raises ``TimeoutError``, so a
deadlocked group never hangs its caller.
"""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist


def _rank_main(rank, fn, world_size, backend, workdir, timeout, args):
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        # Rank r works on card r mod the card count: on one card every
        # rank shares it (NCCL refuses that for more than one rank).
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(str(Path(workdir) / "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(workdir) / f"rank{rank}.pt")


def run_ranks(fn, world_size: int, args=(), *, workdir, backend: str = "gloo",
              timeout: float = 120.0):
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes,
    each rank ``rank`` of a ``backend`` process group; returns the list of
    their results (each passed back through a file in ``workdir``, which
    must be a fresh directory; ``fn`` and the results must pickle).

    ``fn`` must live in a module that the spawned processes can import.
    If a rank raises, the others are stopped and the error is raised here;
    if the ranks are not all done after ``timeout`` seconds (also each
    collective's timeout), every rank still running is killed and
    ``TimeoutError`` is raised."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, backend, str(workdir), timeout, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.05, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks were not done after "
                                   f"{timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    return [torch.load(workdir / f"rank{rank}.pt", weights_only=False)
            for rank in range(world_size)]
