"""The cost model of the hand-written kernels: the bytes and operations
the function of one kernel-wrapped call needs, and the least time an
NVIDIA H100 could take for them.

For each call that a wrapper records (``_build.record_calls``, the
record of kernel calls; it costs nothing while no block is open),
:func:`work` counts its bytes (each input read once, each output written
once) and its operations on this call's data (live window columns of a
query, selected map entries of a conv or pool, valid edges of a gather),
and :func:`bound_of` turns them into the larger of the bytes over the
card's memory rate and the operations over its f32 rate: the card's
published rates (H100 SXM data sheet), 3.35 TB/s of device memory and 67
TFLOP/s of f32 outside the tensor cores, where every kernel here
computes (in f32 or integer arithmetic). ``chip_smoke.py`` prints each
replayed call's bound from these, and ``cli.profile_step`` sums them
over a profiled step's calls (:func:`step_costs`).
"""

from __future__ import annotations

import collections
import re

import torch

from sph3d_gcn_torch import _build

MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the plain-PyTorch window sums around K8/K9 (no kernel of their own)
UNPOOLS = ("mean_interpolate", "weighted_interpolate", "avg_pool")
# the kernel that a recorded call of another name launches: a dense
# unpool's or avg pool's backward is K9's form (b)
LAUNCHED_BY = {"mean_interpolate_bwd": "window_gather_bwd"}
# the device functions each kernel wrapper launches, as a trace names them
DEVICE_FUNCTIONS = {
    "fps": ("fps_kernel", "fps_stream_kernel"),
    "dense_query": ("dense_query_kernel",),
    "growth_query": ("growth_query_kernel",),
    "dense_conv": ("dense_conv_kernel",),
    "dense_conv_bwd": ("dfilt_tile_kernel", "dfilt_reduce_kernel",
                       "dx_kernel"),
    "rank_pool": ("rank_pool_kernel",),
    "rank_pool_bwd": ("rank_pool_bwd_kernel",),
    "window_gather": ("window_gather_kernel",),
    "window_gather_bwd": ("window_gather_bwd_kernel",
                          "window_sum_bwd_kernel"),
}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def live_candidates(q_p, u_end, window: int) -> int:
    """Query rows times the window columns a query must test: the tiles'
    slab ends (u_end chunks, clamped as the queries clamp them)."""
    return int(u_end.clamp(1, window // 128).sum().item()) * 128 * 128


def work(name: str, args: tuple, kw: dict) -> tuple[int, int]:
    """(bytes, operations) the function of one recorded call needs: each
    input read once and each output written once; operations counted for
    this call's data (live window columns of a query, selected map entries
    of a conv or pool)."""
    if name == "fps":
        num, xyz = args
        b, n, _ = xyz.shape
        # the x, y, z of every point read, the int64 indices written; per
        # step and point a distance (8), a running min (1) and argmax (1)
        return 12 * b * n + 8 * b * num, 10 * b * num * n
    if name in ("dense_query", "growth_query"):
        db_p, q_p, s_blk, u_end = args[:4]
        w = kw["window"]
        out = q_p.shape[0] * q_p.shape[1] * w
        live = live_candidates(q_p, u_end, w)
        if name == "dense_query":
            # distance 9, radius test 2, rank 1; bins ~20 compares more
            per = 12 + (20 if kw["kernel"] is not None else 0)
            extra = nbytes(args[4])                # the sort axes
        else:
            # distance 9, 3 per radius, rank 1; plus the per-row steps
            per = 10 + 3 * (kw["growth_steps"] + 1)
            extra = q_p.shape[0] * q_p.shape[1]
        # the f32 distance map: 4 more bytes per entry, and a square root
        # per live candidate
        out *= 5 if kw.get("need_dist") else 1
        per += 1 if kw.get("need_dist") else 0
        return nbytes(db_p, q_p, s_blk, u_end) + extra + out, per * live
    if name == "dense_conv":
        packed, s_blk, x, filt_b, inv = args
        c, r = filt_b.shape[2], filt_b.shape[3]
        nnz = int((packed != 0).sum().item())
        out = inv.numel() * c * r * x.element_size()
        # one filter expanded over the clouds (ungrouped maps) is read once
        filt = filt_b[0] if filt_b.stride(0) == 0 else filt_b
        return (nbytes(packed, s_blk, x, filt, inv) + out,
                2 * nnz * c * r + inv.numel() * c * r)
    if name == "rank_pool":
        # a bin map (no counts) selects every nonzero entry; arg and
        # max_index are int32 outputs beside the values
        packed, s_blk, counts, x = args
        batch, n_t, _, w = packed.shape
        c = x.shape[2]
        cnt = torch.full((batch, n_t * 128), 127, device=packed.device)
        if counts is not None:
            cnt = torch.nn.functional.pad(counts, (0, cnt.shape[1]
                                                   - counts.shape[1]))
        cnt = cnt.reshape(batch, n_t, 128, 1)
        sel = int(((packed >= 1) & (packed <= cnt)).sum().item())
        out = batch * n_t * 128 * c * (
            x.element_size() + 4 * (bool(kw.get("with_arg"))
                                    + bool(kw.get("with_index"))))
        return nbytes(packed, s_blk, counts, x) + out, sel * c
    if name == "dense_conv_bwd":
        packed, s_blk, x, filt_b, inv, dout = args
        c, r = filt_b.shape[2], filt_b.shape[3]
        nnz = int((packed != 0).sum().item())
        out = nbytes(x) + nbytes(filt_b)            # dx, dfilt_b
        return (nbytes(packed, s_blk, x, filt_b, inv, dout) + out,
                4 * nnz * c * r + inv.numel() * c * r)
    if name == "rank_pool_bwd":
        s_blk, arg, dout, num_in, _ = args
        out = arg.shape[0] * num_in * arg.shape[2] * dout.element_size()
        return (nbytes(s_blk, arg, dout) + out,
                int((arg >= 0).sum().item()))
    if name in UNPOOLS:
        # the weighted unpool reads the distance map, and per entry forms
        # its weight (a sum and a division)
        x, dnbh = args
        nnz = int((dnbh.packed != 0).sum().item())
        out = dnbh.num_query * x.shape[0] * x.shape[2] * x.element_size()
        weighted = name == "weighted_interpolate"
        return (nbytes(x, dnbh.packed, dnbh.count,
                       dnbh.dist if weighted else None) + out,
                2 * nnz * x.shape[2] + out // x.element_size()
                + (3 * dnbh.packed.numel() if weighted else 0))
    if name == "mean_interpolate_bwd":
        # K9's form (b), the dense window sums' backward: the map or the
        # weights, s_blk and dout read once, dx written in f32; a product
        # and an add per selected entry and channel
        packed, s_blk, dout, num_in = args
        lhs = kw.get("weights", packed)
        sel = lhs > 0 if lhs.dtype == torch.int8 else lhs != 0
        c = dout.shape[2]
        return (nbytes(lhs, s_blk, dout) + dout.shape[0] * num_in * c * 4,
                2 * int(sel.sum().item()) * c)
    if name == "window_gather":
        # a copy: no arithmetic; the idx of the valid lanes only, the whole
        # padded (B, M_pad, K, C) output (its zero lanes are outputs too)
        x, idx, count = args
        m_pad = -(-idx.shape[1] // 128) * 128
        out = x.shape[0] * m_pad * idx.shape[2] * x.shape[2]
        return (nbytes(x, count) + idx.element_size() * valid_edges(name, args)
                + out * x.element_size(), 0)
    if name == "mean_interpolate_bwd":
        # K9's form (b), the dense window sums' backward: the map or the
        # weights, s_blk and dout read once, dx written in f32; a product
        # and an add per selected entry and channel
        packed, s_blk, dout, num_in = args
        lhs = kw.get("weights", packed)
        sel = lhs > 0 if lhs.dtype == torch.int8 else lhs != 0
        c = dout.shape[2]
        return (nbytes(lhs, s_blk, dout) + dout.shape[0] * num_in * c * 4,
                2 * int(sel.sum().item()) * c)
    if name == "window_gather_bwd":
        # the valid edges' gradient rows and list entries only (invalid
        # lanes and padded rows add nothing); one add per edge and channel
        dg, order, starts, num_in = args
        n_valid = valid_edges(name, args)
        out = dg.shape[0] * num_in * dg.shape[3] * dg.element_size()
        return (n_valid * (dg.shape[3] * dg.element_size()
                           + order.element_size()) + nbytes(starts) + out,
                n_valid * dg.shape[3])
    raise KeyError(name)


def valid_edges(name: str, args: tuple) -> int:
    """The valid (k < count) edges of a recorded edge gather or its
    backward."""
    if name == "window_gather":
        return int(args[2].sum().item())
    return int(args[2][-1].item())


def bound_of(work_done: tuple[int, int]) -> tuple[float, str]:
    """The least time (ms) of a call, and the side that binds it: its
    bytes over the memory rate or its operations over the f32 rate,
    whichever is larger."""
    data, ops = work_done
    t_bytes = data / MEM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_of(device_name: str) -> str | None:
    """The kernel wrapper (a key of :data:`DEVICE_FUNCTIONS`) whose device
    function a trace's kernel name is, or None."""
    for name, functions in DEVICE_FUNCTIONS.items():
        if any(re.search(rf"(?<!\w){f}(?!\w)", device_name)
               for f in functions):
            return name
    return None


def call_costs(calls: list) -> dict[str, dict]:
    """Sum :func:`work` and :func:`bound_of` over recorded calls, by the
    kernel they launch: name -> {"calls", "bytes", "operations",
    "bound_ms", "bound_by"} (``bound_by`` the side that binds most of the
    summed bound). A dense unpool's or avg pool's backward launches K9
    (its form (b)); the unpools themselves launch no kernel."""
    out: dict[str, dict] = {}
    sides = collections.defaultdict(lambda: {"bytes": 0.0, "operations": 0.0})
    with torch.no_grad():
        for name, args, kw in calls:
            if name in UNPOOLS:
                continue
            data, ops = work(name, args, kw)
            name = LAUNCHED_BY.get(name, name)
            t, side = bound_of((data, ops))
            tot = out.setdefault(name, {"calls": 0, "bytes": 0,
                                        "operations": 0, "bound_ms": 0.0})
            tot["calls"] += 1
            tot["bytes"] += data
            tot["operations"] += ops
            tot["bound_ms"] += t
            sides[name][side] += t
    for name, tot in out.items():
        tot["bound_by"] = max(sides[name], key=sides[name].get)
    return out


class step_costs:
    """Context manager: records every kernel-wrapped call made while it
    is open (``_build.record_calls``); on exit :attr:`costs` holds their
    :func:`call_costs` and the records are dropped."""

    def __enter__(self) -> "step_costs":
        self._record = _build.record_calls()
        self._calls = self._record.__enter__()
        self.costs: dict[str, dict] = {}
        return self

    def __exit__(self, *exc) -> None:
        self._record.__exit__(*exc)
        if exc[0] is None:
            self.costs = call_costs(self._calls)
        self._calls = None
