"""Run a function as R ranks of a process group on one host, each in a
spawned process (the tests' gloo ranks on the CPU, and ranks that share
one card). ``torchrun`` launches the command-line entry points instead
(``cli``)."""

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


def _rank_main(fn, rank: int, world_size: int, store_path: str,
               device: str, backend: str | None, timeout: float,
               threads: int | None, args: tuple, results) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        store = dist.FileStore(store_path, world_size)
        group = init_data_parallel(
            device, backend, rank=rank, world_size=world_size, store=store,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(group, *args)
        finally:
            close_data_parallel()
        # plain pickle bytes: torch would pass a tensor's storage as a
        # file descriptor, which dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


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
    and raises here."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        results = ctx.Queue()
        # daemons: the ranks die with the process that started them
        procs = [ctx.Process(
            daemon=True, target=_rank_main,
            args=(fn, r, world_size, os.path.join(tmp, "store"), device,
                  backend, timeout, threads, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks ran past {timeout:g} s "
                        f"(ranks {sorted(out)} finished)")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    failed = _failures(procs, results, {rank: payload},
                                       world_size - len(out))
                    raise RuntimeError("\n".join(
                        f"rank {r} failed:\n{m}"
                        for r, m in sorted(failed.items())))
                out[rank] = pickle.loads(payload)
        finally:
            for p in procs:
                if p.is_alive() and len(out) < world_size:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world_size)]

