"""Device time of one train step by kernel and by layer, with each
hand-written kernel against its bound on the card (counterpart of the
JAX package's ``scripts/profile_step.py``)::

    python -m sph3d_gcn_torch.cli.profile_step --fast --dense
    python -m sph3d_gcn_torch.cli.profile_step --model s3dis --fast --dense
    python -m sph3d_gcn_torch.cli.profile_step --device cpu \\
        --batch_size 2 --num_input 1024

Builds the seeded batch of the JAX script (ModelNet: ``surface_clouds``
of ``default_rng(0)`` and integer labels; S3DIS: uniform points in
[-2, 2] with six columns, which the scene model reads as xyz alone, and
per-point and inner labels), stages it on the device once, warms one
step of ``classification_step_factory`` (Adam at 1e-3, the config's
weight decay) or ``segmentation_step_factory(inner_masked=True)``, times
three steps on the host clock, then traces two steps under
``torch.profiler`` alone and two more with the layer spans and the
kernels' call record on (in each session the first step is not counted:
a session can miss its first launches). It prints, a step:

- the host-clock wall of a step without the profiler (median of 3
  before the traces) and of each step traced without the layer spans,
  the device's busy time and its idle share, and the device time by
  kernel name with launches (``train.profiling``), all from the first
  session, which the spans' hooks do not slow;
- the device time by the layer that launched it (the model's modules
  and the graph building's spans, ``nn.spans.layer_spans``; the
  backward by its autograd node), from the second session;
- each hand-written kernel's device time and launches beside its bound:
  the bytes and operations of its calls recorded in the second session
  (``ops.costs``) over the H100's data-sheet rates, and its share of
  that bound. JAX's v5e roofline (MXU, VPU and HBM rates) has no part
  here.

On the CPU (``--device cpu``: the plain versions) there is no device
trace: it prints the step's host wall, the host time by op and by layer,
and the kernels' bounds on the card beside their calls.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

SPAN = "train_step"
SEED = 0               # the batch's, the model's and the dropout's
UNTRACED_STEPS = 3     # timed on the host clock before the traces
TRACED_STEPS = 2       # traced alone, the first not counted
LAYER_STEPS = 2        # traced with the layer spans, the first not counted


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="modelnet",
                        choices=["modelnet", "s3dis"])
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_input", type=int, default=None,
                        help="points a cloud (default: the config's)")
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--min_us", type=float, default=0.0,
                        help="leave device events shorter than this (us) "
                             "out of the table by kernel name")
    parser.add_argument("--fast", action="store_true",
                        help="profile the fast (bf16 + windowed) config")
    parser.add_argument("--dense", action="store_true",
                        help="with --fast: the dense windowed engine")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions, host times only)")
    return parser.parse_args(argv)


def build_step(args, device: torch.device):
    """(config, step factory, batch on ``device``, dropout generator) of
    the JAX script's seeded run."""
    from sph3d_gcn_torch import configs
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import (
        classification_step_factory,
        segmentation_step_factory,
    )

    rng = np.random.default_rng(SEED)
    b = args.batch_size
    kw = {} if args.num_input is None else {"num_input": args.num_input}
    gen = torch.Generator().manual_seed(SEED)
    if args.model == "modelnet":
        cfg = configs.modelnet_config(fast=args.fast, dense=args.dense, **kw)
        model = SPH3DModelNet(cfg, generator=gen).to(device)
        factory = classification_step_factory(
            model, *make_optimizer(model.parameters(), "adam", 1e-3),
            weight_decay=cfg.weight_decay)
        batch = {
            "points": surface_clouds(rng, b, cfg.num_input),
            "label": rng.integers(0, cfg.num_cls, (b,)),
        }
    else:
        cfg = configs.s3dis_config(fast=args.fast, dense=args.dense, **kw)
        model = SPH3DSceneSeg(cfg, generator=gen, in_columns=6).to(device)
        factory = segmentation_step_factory(
            model, *make_optimizer(model.parameters(), "adam", 1e-3),
            inner_masked=True)
        n = cfg.num_input
        batch = {
            "points": rng.uniform(-2, 2, (b, n, 6)).astype(np.float32),
            "label": rng.integers(0, cfg.num_cls, (b, n)),
            "inner_label": rng.integers(0, 2, (b, n)),
        }
    # staged once: a host batch would be copied in every traced step
    batch = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in batch.items()}
    dropout = torch.Generator(device=device).manual_seed(SEED + 1)
    return cfg, factory, batch, dropout


def kernel_table(by_name: dict, costs: dict, steps: int) -> list[dict]:
    """Per hand-written kernel: its device time and launches a step
    (``by_name`` of ``report_trace``, None on the CPU) beside the summed
    bound of its calls a step (``costs`` of ``ops.costs.step_costs`` over
    ``steps`` steps)."""
    from sph3d_gcn_torch.ops.costs import DEVICE_FUNCTIONS, kernel_of

    device = {}
    for name, (ms, n) in (by_name or {}).items():
        kernel = kernel_of(name)
        if kernel is not None:
            tot = device.setdefault(kernel, [0.0, 0.0])
            tot[0] += ms
            tot[1] += n
    rows = []
    for kernel in DEVICE_FUNCTIONS:
        if kernel not in costs and kernel not in device:
            continue
        c = costs.get(kernel, {"calls": 0, "bound_ms": 0.0,
                               "bound_by": "bytes"})
        ms, launches = device.get(kernel, (None, None))
        bound = c["bound_ms"] / steps
        rows.append({"kernel": kernel, "calls": c["calls"] / steps,
                     "launches": launches, "ms": ms, "bound_ms": bound,
                     "bound_by": c["bound_by"],
                     "share": bound / ms if ms else None})
    return rows


def print_kernel_table(rows: list[dict]) -> None:
    from sph3d_gcn_torch.ops.costs import F32_OPS_PER_S, MEM_BYTES_PER_S

    print(f"== hand-written kernels a step against their bounds (H100 SXM "
          f"data sheet: {MEM_BYTES_PER_S / 1e12:g} TB/s, "
          f"{F32_OPS_PER_S / 1e12:g} TFLOP/s f32; share = bound / device "
          f"time) ==", flush=True)
    for r in rows:
        launches = ("not measured" if r["launches"] is None
                    else f"{r['launches']:5.1f} launches")
        ms = ("device time not measured" if r["ms"] is None
              else f"{r['ms']:8.3f} ms")
        share = "" if r["share"] is None else f"  share {r['share']:.3f}"
        print(f"  {r['kernel']:18s} {r['calls']:5.1f} calls  {launches}  "
              f"{ms}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              f"{share}", flush=True)
    timed = [r for r in rows if r["ms"]]
    if timed:
        ms = sum(r["ms"] for r in timed)
        bound = sum(r["bound_ms"] for r in timed)
        print(f"  kernels together: {ms:.3f} ms on the device, bound "
              f"{bound:.4f} ms, share {bound / ms:.3f}", flush=True)


def main(argv=None) -> dict:
    """Prints the tables; returns the step's numbers: ``wall_ms``,
    ``busy_ms`` and ``idle`` (None on the CPU), ``by_name``, ``by_layer``
    and ``kernels`` (rows of :func:`kernel_table`), and ``steps_run``,
    the train steps it took in all."""
    args = parse_args(argv)

    from torch.profiler import ProfilerActivity, profile, record_function

    from sph3d_gcn_torch.cli import resolve_device
    from sph3d_gcn_torch.ops.costs import step_costs
    from sph3d_gcn_torch.train.profiling import (
        device_time_by_layer,
        host_time_by_layer,
        layer_spans,
        report_trace,
        trace_events,
    )

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg, factory, batch, dropout = build_step(args, device)
    name = type(factory.model).__name__
    where = torch.cuda.get_device_name(device) if on_card else "the CPU"
    print(f"profile_step: {name}, {args.model} fast={args.fast} "
          f"dense={args.dense} ({cfg.compute_dtype}, windows "
          f"{cfg.windows}), B={args.batch_size} N={cfg.num_input} on "
          f"{where}", flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    metrics = factory.train_step(batch, dropout)
    loss = float(metrics["loss"])
    print(f"warm step: loss {loss:.4f}, dense_ok "
          f"{bool(metrics['dense_ok'])} ({time.perf_counter() - t0:.2f} s "
          f"with the first calls)", flush=True)
    walls = []
    for _ in range(UNTRACED_STEPS):
        t0 = time.perf_counter()
        factory.train_step(batch, dropout)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"step without the profiler: {np.median(walls):.3f} ms (host "
          f"clock, synchronised; median of {UNTRACED_STEPS})", flush=True)

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)

    def traced(steps: int) -> tuple:
        """(profiler, its trace's events, the last step's metrics)"""
        with profile(activities=activities) as prof:
            for _ in range(steps):
                with record_function(SPAN):
                    metrics = factory.train_step(batch, dropout)
                    sync()
        return prof, trace_events(prof), metrics

    # the wall, busy time, idle share and table by kernel from steps under
    # the profiler alone; the layer spans' hooks and the call record add
    # host time, so the table by layer and the kernels' calls come from
    # steps of their own
    prof, events, _ = traced(TRACED_STEPS)
    with layer_spans(factory.model), step_costs() as recorded:
        _, layer_events, metrics = traced(LAYER_STEPS)
    if on_card:
        out = report_trace(events, "train step", TRACED_STEPS - 1, span=SPAN,
                           top=args.top, min_us=args.min_us)
        by_layer = device_time_by_layer(layer_events, SPAN)
        title = "device time"
    else:
        wall = _host_walls(events)
        out = {"wall_ms": wall, "busy_ms": None, "idle": None,
               "by_name": None}
        print(f"profile train step: wall {wall:.3f} ms a step (host "
              f"clock, under the profiler); no device trace on the CPU",
              flush=True)
        print(f"host time by op (self, a step; top {args.top}):",
              flush=True)
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for e in ops[:args.top]:
            print(f"  {e.self_cpu_time_total / TRACED_STEPS / 1e3:8.3f} ms  "
                  f"{e.count / TRACED_STEPS:6.1f} x  {e.key[:90]}", flush=True)
        by_layer = host_time_by_layer(layer_events, SPAN)
        title = "host time (with the layers inside it)"
    print(f"== {title} by layer, a step ==", flush=True)
    for layer, (ms, n) in sorted(by_layer.items(), key=lambda kv: -kv[1][0])[
            :args.top]:
        print(f"  {ms:8.3f} ms  {n:7.1f} x  {layer}", flush=True)
    # every traced step made the same calls on the same batch
    rows = kernel_table(out["by_name"], recorded.costs, LAYER_STEPS)
    print_kernel_table(rows)
    print(f"last step: loss {float(metrics['loss']):.4f}, dense_ok "
          f"{bool(metrics['dense_ok'])}", flush=True)
    return dict(out, by_layer=by_layer, kernels=rows,
                step_ms=float(np.median(walls)),
                dense_ok=bool(metrics["dense_ok"]),
                steps_run=1 + UNTRACED_STEPS + TRACED_STEPS + LAYER_STEPS)


def _host_walls(events: list) -> float:
    """Mean host-clock wall (ms) of the traced steps but the first."""
    walls = sorted((e["ts"], e["dur"]) for e in events
                   if e.get("name") == SPAN
                   and e.get("cat") == "user_annotation")[1:]
    return sum(d for _, d in walls) / max(1, len(walls)) / 1e3


if __name__ == "__main__":
    main()
