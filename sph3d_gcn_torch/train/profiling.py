"""Profiling and throughput instrumentation (counterpart of
``sph3d_gcn_tpu/train/profiling.py``).

The reference's only instrumentation is wall-clock ms around ``sess.run``
(ref train_modelnet.py:289-311). Here: a ``torch.profiler`` trace
written as a Chrome trace (Perfetto, ``chrome://tracing``), the reader of
such traces that ``chip_smoke.py`` and ``cli.profile_step`` share (each
profiled span's wall, its device busy time and idle share, the device
time by kernel name and by the layer that launched it), the layer spans
that name that layer, and a host-side throughput tracker whose stop
synchronises the current CUDA stream, so a step's time covers the
device's work.

The layer spans themselves live in ``nn.spans`` (re-exported here), so
that the models open them without depending on this module. A device
event is charged to the innermost layer span open on the host thread
that launched it; the backward's launches, made on autograd's thread,
to the autograd node (``autograd::engine::evaluate_function: ...``) that
made them.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

from sph3d_gcn_torch.nn.spans import (  # noqa: F401 (re-exported)
    LAYER_PREFIX,
    layer_span,
    layer_spans,
)

_BACKWARD = "autograd::engine::evaluate_function: "


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


def trace_events(prof) -> list:
    """The chrome-trace events of a finished ``torch.profiler`` session."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def span_device_work(events: list, span: str) -> list[tuple[float, list]]:
    """Per ``record_function`` span named ``span`` but the first (a
    profiler session can miss its first launches): (its host-clock wall
    in us, its device events), each event a dict with the kernel's or
    copy's ``name``, ``start`` and ``end`` (us) and the launch's host
    ``ts`` and ``tid``.

    A span's device work is found by the correlation ids of the launches
    made inside it (on any host thread: the backward launches from
    autograd's own thread), not by device timestamps: a trace aligns its
    host and device clocks only approximately."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == span
                   and e.get("cat") == "user_annotation")[1:]
    launches = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    out = []
    for s, e in spans:
        mine = []
        for d in device:
            ts, tid = launches.get(d["args"].get("correlation"), (None, None))
            if ts is not None and s <= ts < e:
                mine.append({"name": d["name"], "start": d["ts"],
                             "end": d["ts"] + d["dur"], "ts": ts,
                             "tid": tid})
        out.append((e - s, mine))
    return out


def report_trace(events: list, what: str, reps: int,
                 span: str = "serve_forward", top: int = 12,
                 min_us: float = 0.0) -> dict:
    """Print, per profiled span named ``span`` (the first is skipped, see
    :func:`span_device_work`), the host-clock wall of the span, the union
    of its kernel and copy intervals on the device timeline (busy) and the
    idle share ``1 - busy / wall``; then the device time a span by kernel
    name, of the events that last ``min_us`` or longer. Returns the means
    a span: ``wall_ms``, ``busy_ms``, ``idle`` and ``by_name`` (name ->
    [ms, launches], every event)."""
    work = span_device_work(events, span)
    if len(work) != reps or not any(mine for _, mine in work):
        raise AssertionError(
            f"profile of {what}: {len(work)} spans, "
            f"{sum(len(m) for _, m in work)} device events")
    walls, busys = [], []
    for i, (wall, mine) in enumerate(work):
        busy = union_us([(d["start"], d["end"]) for d in mine])
        walls.append(wall)
        busys.append(busy)
        print(f"profile {what} {i + 1}: wall {wall / 1e3:.3f} "
              f"ms (host clock, under the profiler), device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f}, "
              f"{len(mine)} device events", flush=True)
    print(f"profile {what}: device time per span by name (top {top})",
          flush=True)
    for name, (ms, n) in _by_name(work, min_us)[:top]:
        print(f"  {ms:8.3f} ms  {n:6.1f} x  {name[:90]}", flush=True)
    wall, busy = sum(walls) / reps, sum(busys) / reps
    return {"wall_ms": wall / 1e3, "busy_ms": busy / 1e3,
            "idle": 1 - busy / wall, "by_name": dict(_by_name(work))}


def _by_name(work: list, min_us: float = 0.0) -> list:
    """(name, [ms, events]) a span of the device events of ``work`` that
    last ``min_us`` or longer, by name, the longest first."""
    out: dict[str, list] = {}
    for _, mine in work:
        for d in mine:
            if d["end"] - d["start"] >= min_us:
                tot = out.setdefault(d["name"], [0.0, 0.0])
                tot[0] += (d["end"] - d["start"]) / 1e3 / len(work)
                tot[1] += 1 / len(work)
    return sorted(out.items(), key=lambda kv: -kv[1][0])


def device_time_by_layer(events: list, span: str) -> dict[str, list]:
    """The device time a span (all but the first named ``span``) by the
    layer that launched it: layer -> [ms, device events]. A launch is
    charged to the innermost ``layer:`` span open on its host thread at
    the launch, else to the autograd node running on that thread (named
    ``backward: <node>``), else to ``(no layer)``."""
    scopes = collections.defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X":
            continue
        if name.startswith(LAYER_PREFIX):
            scopes[e.get("tid")].append(
                (e["ts"], e["ts"] + e["dur"], name[len(LAYER_PREFIX):]))
        elif name.startswith(_BACKWARD):
            node = re.sub(r"\d+$", "", name[len(_BACKWARD):])
            # a node's span is wider than any layer span inside it
            scopes[e.get("tid")].append(
                (e["ts"], e["ts"] + e["dur"], "backward: " + node))
    work = span_device_work(events, span)
    out: dict[str, list] = {}
    for _, mine in work:
        for d in mine:
            owner = "(no layer)"
            inner = None
            for s, t, name in scopes.get(d["tid"], ()):
                if s <= d["ts"] < t and (inner is None or s >= inner):
                    inner, owner = s, name
            tot = out.setdefault(owner, [0.0, 0])
            tot[0] += (d["end"] - d["start"]) / 1e3 / len(work)
            tot[1] += 1 / len(work)
    return out


def host_time_by_layer(events: list, span: str) -> dict[str, list]:
    """The host time a span (all but the first named ``span``) of each
    layer span inside it, with the layers nested in it: layer -> [ms,
    spans]."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == span
                   and e.get("cat") == "user_annotation")[1:]
    out: dict[str, list] = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or not name.startswith(LAYER_PREFIX):
            continue
        if any(s <= e["ts"] < t for s, t in spans):
            tot = out.setdefault(name[len(LAYER_PREFIX):], [0.0, 0])
            tot[0] += e["dur"] / 1e3 / len(spans)
            tot[1] += 1 / len(spans)
    return out


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
