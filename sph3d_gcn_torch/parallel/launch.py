"""Run a function as R ranks of a process group on one host, each in a
spawned process (the tests' gloo ranks on the CPU, and ranks that share
one card): once (:func:`run_ranks`), or as jobs on ranks started once
(:class:`RankPool`). ``torchrun`` launches the command-line entry points
instead (``cli``)."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from collections.abc import Callable

import torch
import torch.distributed as dist

from sph3d_gcn_torch.parallel.mesh import (
    close_data_parallel,
    init_data_parallel,
)


def _failures(procs, results, failed: dict, pending: int,
              grace: float = 5.0) -> dict:
    """``failed`` and the failures the other pending ranks report within
    ``grace`` seconds: a rank that raises takes its peers' collectives
    down with it, and their reports may arrive first."""
    end = time.monotonic() + grace
    while len(failed) < pending and time.monotonic() < end:
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue_mod.Empty:
            if all(p.exitcode is not None for p in procs):
                break
            continue
        if not ok:
            failed[rank] = payload
    return failed


def run_ranks(fn: Callable[..., object], world_size: int,
              args: tuple = (), *, device: str = "cpu",
              backend: str | None = None, timeout: float = 120.0,
              threads: int | None = 1, store_dir: str | None = None
              ) -> list:
    """``fn(group: DataGroup, *args)`` on ``world_size`` spawned ranks;
    returns their results in rank order.

    ``fn``, ``args`` and the results are pickled: ``fn`` must be
    importable by its module path in a fresh interpreter. Each rank joins
    through a ``FileStore`` under ``store_dir`` (None: a temporary
    directory), runs on ``device`` with ``backend`` (None: NCCL on CUDA,
    gloo on the CPU) and ``threads`` torch threads (None: torch's
    default). A rank that raises, or a run that outlasts ``timeout``
    seconds (a collective that some rank never reached), kills every rank
    and raises here. One job on a :class:`RankPool`."""
    with RankPool(world_size, device=device, backend=backend,
                  timeout=timeout, threads=threads,
                  store_dir=store_dir) as pool:
        return pool.run(fn, *args)


def _pool_main(rank: int, world_size: int, store_path: str, device: str,
               backend: str | None, timeout: float, threads: int | None,
               jobs, results) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        store = dist.FileStore(store_path, world_size)
        group = init_data_parallel(
            device, backend, rank=rank, world_size=world_size, store=store,
            timeout=datetime.timedelta(seconds=timeout))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    try:
        while True:
            job = jobs.get()
            if job is None:
                break
            fn, args = job
            try:
                out = (True, pickle.dumps(fn(group, *args)))
            except BaseException:
                out = (False, traceback.format_exc())
            results.put((rank,) + out)
    finally:
        close_data_parallel()


class RankPool:
    """R ranks of a process group, spawned and joined once, that run jobs:
    :meth:`run` calls ``fn(group: DataGroup, *args)`` on every rank (as
    :func:`run_ranks` does) and returns the results in rank order. The
    ranks keep their state between jobs (imports, process groups that a
    job forms). A job that raises on any rank, or outlasts its time
    limit, kills every rank and raises; the pool is closed after it.
    A context manager: leaving it stops the ranks."""

    def __init__(self, world_size: int, *, device: str = "cpu",
                 backend: str | None = None, timeout: float = 120.0,
                 threads: int | None = 1, store_dir: str | None = None):
        ctx = mp.get_context("spawn")
        self.world_size, self.timeout = world_size, timeout
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world_size)]
        # daemons: the ranks die with the process that started them
        self._procs = [ctx.Process(
            daemon=True, target=_pool_main,
            args=(r, world_size, os.path.join(self._tmp.name, "store"),
                  device, backend, timeout, threads, self._jobs[r],
                  self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self._open = True

    def run(self, fn: Callable[..., object], *args,
            timeout: float | None = None) -> list:
        if not self._open:
            raise RuntimeError("the rank pool is closed")
        for q in self._jobs:
            q.put((fn, args))
        out: dict[int, object] = {}
        deadline = time.monotonic() + (timeout or self.timeout)
        try:
            while len(out) < self.world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__name__} on {self.world_size} ranks ran "
                        f"past its time limit (ranks {sorted(out)} "
                        "finished)")
                try:
                    rank, ok, payload = self._results.get(
                        timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{self._procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    failed = _failures(self._procs, self._results,
                                       {rank: payload},
                                       self.world_size - len(out))
                    raise RuntimeError("\n".join(
                        f"rank {r} failed:\n{m}"
                        for r, m in sorted(failed.items())))
                out[rank] = pickle.loads(payload)
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(self.world_size)]

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (``kill``: at once)."""
        if not self._open:
            return
        self._open = False
        for p, q in zip(self._procs, self._jobs):
            if kill:
                p.kill()
            elif p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._results.close()
        self._tmp.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
