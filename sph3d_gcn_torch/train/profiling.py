"""Profiling and throughput instrumentation (counterpart of
``sph3d_gcn_tpu/train/profiling.py``).

The reference's only instrumentation is wall-clock ms around ``sess.run``
(ref train_modelnet.py:289-311). Here: a ``torch.profiler`` trace
written as a Chrome trace (Perfetto, ``chrome://tracing``) and a
host-side throughput tracker whose stop synchronises the current CUDA
stream, so a step's time covers the device's work.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Trace the host and, where there is one, the CUDA device; on exit
    the Chrome trace is written to ``log_dir/name``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class ThroughputTracker:
    """Accumulates step times (each ending when the current CUDA stream
    has drained) and reports points/sec/chip."""

    def __init__(self, points_per_batch: int, num_chips: int = 1):
        self.points_per_batch = points_per_batch
        self.num_chips = max(1, num_chips)
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        _sync()
        self.seconds += time.perf_counter() - self._t0
        self.steps += 1
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.seconds / max(1, self.steps)

    @property
    def points_per_sec_per_chip(self) -> float:
        if self.seconds == 0:
            return 0.0
        return (self.points_per_batch * self.steps / self.seconds
                / self.num_chips)

    def json_line(self, metric: str, baseline: float | None = None) -> str:
        payload = {
            "metric": metric,
            "value": round(self.points_per_sec_per_chip, 1),
            "unit": "points/sec/chip",
        }
        if baseline:
            payload["vs_baseline"] = round(
                self.points_per_sec_per_chip / baseline, 3
            )
        return json.dumps(payload)
