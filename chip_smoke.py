#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

Drives the port's serving path — ``SPH3DModelNet`` of the ModelNet40
dense fast-mode config (B=16, N=10000, full published width, random
weights from a seeded ``torch.Generator``) under ``vote_classify`` —
through the hand-written CUDA kernels, in phases:

1. header: the card's name and power limit, torch and CUDA versions;
2. build: compile ``sph3d_gcn_torch/csrc/*.cu`` (seconds);
3. per-kernel parity and timing: one forward of the plain versions on a
   ``surface_clouds`` batch records the operands of every kernel-wrapped
   call of the main path (``_build.record_calls``); each recorded call is
   replayed through the kernel and its plain version and the two are
   compared (FPS indices, query maps and pool outputs exactly, conv bf16
   outputs within rtol=atol=1e-2), with median CUDA-event times of both.
   Done once with the served model's ``"hard"`` windows (these go into
   the per-kernel JSON line) and once with the default ``"plain"``
   windows of ``modelnet_config(fast=True, dense=True)``;
4. serving: 2 batches x 3 votes through ``vote_classify``; logits
   (16, 40) and finite, ``dense_ok`` on every forward, launch counts of
   3 FPS, 6 query, 6 conv and 3 pool per forward; one forward's kernel
   logits against the plain versions' (argmax agreement >= 0.95, logits
   within 1% of their largest magnitude); forward time and points/s with
   both window families;
5. profile: ``torch.profiler`` over forwards of each window family;
   per forward the wall span, the device's busy time (union of kernel
   and copy intervals on the trace timeline) and idle share, and the
   device time by kernel name (:func:`report_trace`).

Serving runs the config's ``family="hard"`` windows (2304/1024/640 rows
at the encoder levels): the vote augmentation rotates each cloud about
z, and the ``"plain"`` windows (1536/896/640), calibrated on unrotated
ellipsoids, do not cover every rotated copy (level-0 slabs of up to 1579
rows were measured on these very votes), so the certificate would fail
and the eval entry raise. Weights do not depend on the windows.

Any failure raises and the script exits non-zero. The last two lines
are one JSON object of per-kernel results and the contract line
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, N = 16, 10000
BATCHES, VOTES = 2, 3
REPS = 5
CONV_TOL = 1e-2      # bf16 outputs: f32 sums in another order, one rounding
LOGIT_TOL = 1e-2     # of the largest |logit|: bf16 rounding may compound
PER_FORWARD = {"fps": 3, "dense_query": 6, "dense_conv": 6, "rank_pool": 3}
SOURCES = {
    "fps": ("sph3d_gcn_torch/csrc/fps.cu",
            "sph3d_gcn_tpu/ops/pallas/fps_kernel.py:44"),
    "dense_query": ("sph3d_gcn_torch/csrc/dense_query.cu",
                    "sph3d_gcn_tpu/ops/pallas/query_kernel.py:245"),
    "dense_conv": ("sph3d_gcn_torch/csrc/dense_conv.cu",
                   "sph3d_gcn_tpu/ops/dense.py:611 and :1132"),
    "rank_pool": ("sph3d_gcn_torch/csrc/rank_pool.cu",
                  "sph3d_gcn_tpu/ops/dense.py:1953"),
}


def median_ms(fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Non-trivial BN statistics and affine terms, from ``gen``."""
    from sph3d_gcn_torch.nn.layers import BatchNorm

    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            c = bn.scale.shape[0]
            with torch.no_grad():
                bn.scale.copy_(0.5 + torch.rand(c, generator=gen))
                bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
                bn.mean.copy_(0.1 * torch.randn(c, generator=gen))
                bn.var.copy_(0.5 + torch.rand(c, generator=gen))


def versions():
    """Per kernel: (kernel wrapper, plain version, tolerance or None for
    exact equality)."""
    from sph3d_gcn_torch.ops import dense as D
    from sph3d_gcn_torch.ops import query as Q
    from sph3d_gcn_torch.ops import sample as S

    return {
        "fps": (S.farthest_point_sample_kernel,
                S.farthest_point_sample_plain, None),
        "dense_query": (Q.dense_query_kernel, Q.dense_query_plain, None),
        "dense_conv": (D.dense_conv_kernel, D.dense_conv_plain, CONV_TOL),
        "rank_pool": (D.rank_pool_kernel, D.rank_pool_plain, None),
    }


def describe(name: str, args: tuple, kw: dict) -> str:
    """A recorded call's shapes, for the log."""
    if name == "fps":
        return f"{args[1].shape[1]} -> {args[0]} points"
    if name == "dense_query":
        kind = "ranks" if kw["kernel"] is None else "bins"
        return f"{kind} M_pad={args[1].shape[1]} W={kw['window']}"
    w = args[0].shape[-1]
    if name == "dense_conv":
        return f"C={args[2].shape[2]} r={args[3].shape[3]} W={w}"
    return f"C={args[3].shape[2]} W={w}"


class Results:
    """Per-kernel parity errors and times, summed over the main path's
    calls of one forward."""

    def __init__(self) -> None:
        self.err = {k: 0.0 for k in SOURCES}
        self.ms = {k: 0.0 for k in SOURCES}
        self.plain_ms = {k: 0.0 for k in SOURCES}

    def add(self, name, what, got, ref, ms, plain_ms, tol=None):
        err = (got.float() - ref.float()).abs().max().item()
        self.err[name] = max(self.err[name], err)
        self.ms[name] += ms
        self.plain_ms[name] += plain_ms
        print(f"  {name:12s} {what:30s} max_abs_err {err:.3g}  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
        if tol is None:
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} {what}: kernel != plain")
        else:
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=tol)


def kernel_parity(model, x: torch.Tensor, res: Results) -> None:
    """Record the kernel-wrapped calls of one plain forward of ``model`` on
    ``x``, then replay each through the kernel and its plain version:
    compare the two and time both."""
    from sph3d_gcn_torch import _build

    with _build.record_calls() as calls, torch.inference_mode():
        model(x, use_kernels=False)
    seen = {name: 0 for name in PER_FORWARD}
    for name, _, _ in calls:
        seen[name] += 1
    if seen != PER_FORWARD:
        raise AssertionError(f"recorded calls {seen}, want {PER_FORWARD}")
    table = versions()
    with torch.inference_mode():
        for name, args, kw in calls:
            kern, plain, tol = table[name]
            reps = 3 if name == "fps" else REPS
            res.add(name, describe(name, args, kw), kern(*args, **kw),
                    plain(*args, **kw),
                    median_ms(lambda: kern(*args, **kw), reps),
                    median_ms(lambda: plain(*args, **kw), reps), tol)


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_forward(model, x: torch.Tensor, family: str,
                    reps: int = 3) -> None:
    """``torch.profiler`` over 1 + ``reps`` synchronised forwards; see
    :func:`report_trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + reps):
                with record_function("serve_forward"):
                    model(x)
                    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    report_trace(events, family, reps)


def report_trace(events: list, family: str, reps: int,
                 top: int = 12) -> None:
    """Per profiled forward (the first is skipped: a profiler session can
    miss its first launches): the host-clock wall of its span, the union
    of its kernel and copy intervals on the device timeline (busy), the
    idle share ``1 - busy / wall``; then the device time by kernel name.

    A forward's device work is found by the correlation ids of the
    launches its host span made, not by timestamps: a trace aligns its
    host and device clocks only approximately."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "serve_forward"
                   and e.get("cat") == "user_annotation")[1:]
    launches = [(e["ts"], e["args"]["correlation"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})]
    device = [(e["args"]["correlation"], e["ts"], e["ts"] + e["dur"],
               e["name"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if len(spans) != reps or not device:
        raise AssertionError(f"profile of {family}: {len(spans)} forward "
                             f"spans, {len(device)} device events")
    by_name: dict[str, list[float]] = {}
    for i, (s, e) in enumerate(spans):
        ids = {c for t, c in launches if s <= t < e}
        mine = [(a, b, name) for c, a, b, name in device if c in ids]
        busy = union_us([(a, b) for a, b, _ in mine])
        for a, b, name in mine:
            tot = by_name.setdefault(name, [0.0, 0])
            tot[0] += b - a
            tot[1] += 1
        print(f"profile {family} forward {i + 1}: wall {(e - s) / 1e3:.3f} "
              f"ms (host clock, under the profiler), device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / (e - s):.3f}, "
              f"{len(mine)} device events", flush=True)
    print(f"profile {family}: device time per forward by name (top {top})",
          flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {us / reps / 1e3:8.3f} ms  {n / reps:6.1f} x  {name[:90]}",
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.eval import checked_forward, vote_classify

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(tf32 off for matmul and cudnn)", flush=True)
    dev = torch.device("cuda:0")

    # 2. build
    t0 = time.perf_counter()
    lib, nvcc_s = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s) "
          f"-> {lib}", flush=True)
    for line in (lib.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    cfg_plain = modelnet_config(fast=True, dense=True)
    cfg = modelnet_config(fast=True, dense=True, family="hard")
    gen = torch.Generator().manual_seed(0)
    model = SPH3DModelNet(cfg, generator=gen)
    randomize_bn(model, gen)
    model = model.to(dev).eval()
    model_plain = SPH3DModelNet(cfg_plain).to(dev).eval()
    model_plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    batches = [surface_clouds(rng, B, N) for _ in range(BATCHES)]

    # 3. per-kernel parity: the served shapes (reported), then the default
    # windows' shapes
    x = torch.from_numpy(batches[0]).to(dev)
    res, res_plain_win = Results(), Results()
    for family, m, r in (("hard", model, res),
                         ("plain", model_plain, res_plain_win)):
        c = m.config
        levels = range(len(c.radius))
        print(f"per-kernel parity, batch 0, {family} windows "
              f"{[c.enc_window(lv) for lv in levels]} / pool "
              f"{[c.pool_window(lv) for lv in levels]} "
              f"(times: median of CUDA events)", flush=True)
        kernel_parity(m, x, r)

    # 4. serving: vote_classify through the kernels
    forward = checked_forward(model, dev)
    reset_kernel_launches()
    for bi, batch in enumerate(batches):
        votes = vote_classify(forward, batch, num_votes=VOTES,
                              rng=np.random.default_rng(100 + bi))
        if votes.shape != (B, cfg.num_cls) or not np.isfinite(votes).all():
            raise AssertionError(f"bad vote logits {votes.shape}")
        print(f"batch {bi}: {VOTES} votes, summed logits finite "
              f"{votes.shape}, dense_ok on every forward", flush=True)
    launches = kernel_launches()
    n_fwd = BATCHES * VOTES
    print(f"launches over {n_fwd} forwards: {launches}", flush=True)
    for name, per in PER_FORWARD.items():
        if launches[name] != per * n_fwd:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {per} per forward"
            )

    with torch.inference_mode():
        got = model(x)
        ok_k = bool(model.dense_ok)
        ref = model(x, use_kernels=False)
        ok_p = bool(model.dense_ok)
        fwd_ms = median_ms(lambda: model(x))
        plain_fwd_ms = median_ms(lambda: model(x, use_kernels=False), reps=3)
        fwd_plain_win_ms = median_ms(lambda: model_plain(x))
        ok_w = bool(model_plain.dense_ok)
    if not (ok_k and ok_p and ok_w):
        raise AssertionError("dense_ok False on the comparison forward")
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"kernel vs plain logits: max_abs_err {diff:.4g}, argmax "
          f"agreement {agree:.4f} (|logits| <= {scale:.3g}, tolerance "
          f"{LOGIT_TOL:g} of that)", flush=True)
    if agree < 0.95:
        raise AssertionError(f"argmax agreement {agree} < 0.95")
    torch.testing.assert_close(got, ref, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * scale)
    print(f"forward B={B} N={N}, hard-family windows: {fwd_ms:.2f} ms "
          f"({B * N / fwd_ms * 1e3:.0f} points/s) with kernels, "
          f"{plain_fwd_ms:.2f} ms with the plain versions", flush=True)
    print(f"forward B={B} N={N}, plain-family windows: "
          f"{fwd_plain_win_ms:.2f} ms "
          f"({B * N / fwd_plain_win_ms * 1e3:.0f} points/s) with kernels",
          flush=True)

    # 5. profile: the served forward's device-busy time and idle share
    for family, m in (("hard", model), ("plain", model_plain)):
        profile_forward(m, x, family)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": max(res.err[name], res_plain_win.err[name]),
         "ms": res.ms[name], "plain_ms": res.plain_ms[name]}
        for name, (src, rep) in SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
