"""Start a function on N ranks of a gloo process group on this host and
collect what each returns (the tests' and the smoke run's launcher; a
user launches with ``torchrun``, which ``create_mesh`` joins).

``run_ranks(fn, world, *args)`` spawns ``world`` processes (the spawn
context: each imports ``fn``'s module afresh, so ``fn`` must be a
module-level function), joins them to ``tcp://127.0.0.1:<free port>``
with rank r and world size ``world``, calls ``fn(rank, *args)`` and
returns the results in rank order. A rank that raises makes the call
raise with that rank's traceback; every process is joined (or killed at
``timeout``) before the call returns. ``start_ranks`` returns at once,
so the caller can work while the ranks run, and ``results()`` waits.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn, args, results) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        out = fn(rank, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Processes started by ``start_ranks``; ``results()`` waits for them
    and returns what each returned, in rank order."""

    def __init__(self, procs, queue_, world: int, timeout: float):
        self.procs, self.queue, self.world = procs, queue_, world
        self.timeout = timeout

    def results(self) -> list:
        got, errors = {}, []
        try:
            for _ in range(self.world):
                # after a failure, the others' reports come soon or never
                rank, ok, out = self.queue.get(
                    timeout=10 if errors else self.timeout)
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
        except queue.Empty:
            if not errors:
                errors.append(f"no result within {self.timeout} s")
        finally:
            for p in self.procs:
                p.join(timeout=5 if errors else 60)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r] for r in range(self.world)]


def start_ranks(fn, world: int, *args, timeout: float = 600.0) -> Ranks:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, fn, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, results, world, timeout)


def run_ranks(fn, world: int, *args, timeout: float = 600.0) -> list:
    return start_ranks(fn, world, *args, timeout=timeout).results()
