"""K1, farthest-point sampling (``sph3d_gcn_torch/csrc/fps.cu``): its launch
plan, a numpy model of its partition and reductions, and the kernel
against its plain version on the card.

On the CPU: :func:`fps_plan` on every served (B, N), on small clouds,
on clouds beyond the registers (the device-memory plan), and when
clusters do not all fit one wave (a fake count of the clusters a device
runs at once); the plan's invariants over many N; and numpy models of
the kernel's two layouts (the same points per thread, warp and CTA, the
same parity slots, the same tie-break in the kernel's order: a thread's
first maximum, the warp's largest value bits, then the lowest index
among them, and in device memory the CTA's key before the cluster's)
equal to ``farthest_point_sample_plain`` on clouds full of exact ties.
Tests marked ``cuda`` need a card and skip elsewhere: ``python -m pytest
tests/test_torch_fps.py -m cuda --noconftest`` (this file imports no JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import sample as S
from sph3d_gcn_torch.ops.sample import FpsPlan

INT_MAX = np.iinfo(np.int32).max
SERVED = [(10000, 2500), (2500, 625), (625, 156),             # ModelNet
          (8192, 2048), (2048, 768), (768, 384), (384, 128)]  # S3DIS


def h100_active(plan: FpsPlan) -> int:
    """Clusters of each size that an H100 80GB HBM3 runs at once, one CTA
    an SM, as the kernel's occupancy query gave them on the card
    (``chip_smoke.py`` prints them before K1's adversarial operands)."""
    return {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}[plan.cluster]


def kernel_model(npoint: int, pts: np.ndarray, plan: FpsPlan) -> np.ndarray:
    """FPS as ``csrc/fps.cu`` computes it, in numpy: slot (r, k, t) of CTA
    r, thread t holds point r * T * P + k * T + t (padded: minimum -1); a
    step updates every slot, each thread takes its first maximal slot as
    the kernel does (a scan of each of up to 4 runs of slots, then a tree
    over the runs; a later slot or run wins only if strictly larger), each
    warp takes the largest value bits (as int32) and the
    lowest index among the lanes that hold them, writes its candidate into
    parity slot r * warps + w, and the cloud's winner is reduced from the
    slots the same way; its coordinates are read from the cloud."""
    xyz = np.ascontiguousarray(pts[..., :3], dtype=np.float32)
    b, n, _ = xyz.shape
    c, t, p = plan.cluster, plan.threads, plan.ppt
    nw = t // 32
    rank, k, th = np.meshgrid(np.arange(c), np.arange(p), np.arange(t),
                              indexing="ij")
    idx = rank * t * p + k * t + th                     # (C, P, T)
    valid = idx < n
    pos = xyz[:, np.where(valid, idx, 0)]               # (B, C, P, T, 3)
    md = np.broadcast_to(np.where(valid, np.float32(1e38), np.float32(-1)),
                         (b, c, p, t)).copy()
    slot_key = np.zeros((b, 2, 32), np.int32)
    slot_idx = np.zeros((b, 2, 32), np.int64)
    out = np.zeros((b, npoint), np.int64)
    old = xyz[:, 0]
    rows = np.arange(b)
    for j in range(1, npoint):
        d = pos - old[:, None, None, None, :]
        dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        md = np.fmin(md, dist)
        run = -(-p // 4)                    # the runs' scans, then a tree
        bv = [md[:, :, lo] for lo in range(0, p, run)]
        bk = [np.full(bv[0].shape, lo) for lo in range(0, p, run)]
        for kk in range(p):
            g = kk // run
            take = md[:, :, kk] > bv[g]
            bv[g] = np.where(take, md[:, :, kk], bv[g])
            bk[g] = np.where(take, kk, bk[g])
        s = 1
        while s < len(bv):
            for g in range(0, len(bv) - s, 2 * s):
                take = bv[g + s] > bv[g]
                bv[g] = np.where(take, bv[g + s], bv[g])
                bk[g] = np.where(take, bk[g + s], bk[g])
            s *= 2
        bi = rank[:, 0] * t * p + bk[0] * t + th[:, 0]         # (B, C, T)
        bits = bv[0].view(np.int32).reshape(b, c, nw, 32)
        bi = bi.reshape(b, c, nw, 32)
        wv = bits.max(-1)
        wi = np.where(bits == wv[..., None], bi, INT_MAX).min(-1)
        par, m = j & 1, c * nw
        slot_key[:, par, :m] = wv.reshape(b, m)
        slot_idx[:, par, :m] = wi.reshape(b, m)
        cv = slot_key[:, par, :m].max(-1)
        win = np.where(slot_key[:, par, :m] == cv[:, None],
                       slot_idx[:, par, :m], INT_MAX).min(-1)
        old = xyz[rows, win]
        out[:, j] = win
    return out


def stream_model(npoint: int, pts: np.ndarray,
                 plan: FpsPlan) -> np.ndarray:
    """FPS as ``csrc/fps.cu`` computes it with the cloud in device memory
    (``plan.ppt`` 0), in numpy: thread t of CTA r walks points r * T + t +
    k * C * T in order and keeps its first maximum; each warp takes the
    largest value bits (as int32; -1 for a thread without a point) and
    the lowest index among the lanes that hold them, each CTA the same
    over its warps, and the cloud's winner the same over the CTAs."""
    xyz = np.ascontiguousarray(pts[..., :3], dtype=np.float32)
    b, n, _ = xyz.shape
    c, t = plan.cluster, plan.threads
    steps = -(-n // (c * t))
    idx = (np.arange(c)[:, None, None] * t + np.arange(t)[None, :, None]
           + np.arange(steps)[None, None, :] * c * t)   # (C, T, K)
    valid = idx < n
    pos = xyz[:, np.where(valid, idx, 0)]                # (B, C, T, K, 3)
    md = np.broadcast_to(np.where(valid, np.float32(1e38), np.float32(-1)),
                         (b, c, t, steps)).copy()
    out = np.zeros((b, npoint), np.int64)
    old = xyz[:, 0]
    rows = np.arange(b)

    def reduce(bits, ids):                   # over the last axis
        top = bits.max(-1)
        return top, np.where(bits == top[..., None], ids, INT_MAX).min(-1)

    for j in range(1, npoint):
        d = pos - old[:, None, None, None, :]
        dist = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        md = np.where(valid, np.fmin(md, dist), md)
        first = md.argmax(-1)                            # (B, C, T)
        bv = np.take_along_axis(md, first[..., None], -1)[..., 0]
        bi = np.take_along_axis(np.broadcast_to(idx, md.shape),
                                first[..., None], -1)[..., 0]
        bits = bv.view(np.int32).reshape(b, c, t // 32, 32)
        wv, wi = reduce(bits, bi.reshape(b, c, t // 32, 32))
        cv, ci = reduce(wv, wi)
        _, win = reduce(cv, ci)
        old = xyz[rows, win]
        out[:, j] = win
    return out


def lattice(batch: int, side: int, seed: int) -> np.ndarray:
    """An integer lattice scaled by 1/8 (exact in f32), each cloud in its
    own order: exact distance ties at every step."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) / 8
    return np.stack([g[rng.permutation(len(g))] for _ in range(batch)])


def clouds(kind: str, batch: int = 2) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "lattice":
        return lattice(batch, 11, 6)                               # 1331
    if kind == "duplicated":
        return np.repeat(rng.random((batch, 300, 3), dtype=np.float32), 4,
                         axis=1)                                   # 1200
    if kind == "all-equal":
        return np.full((batch, 777, 3), 0.25, np.float32)
    if kind == "grid-6ch":
        six = rng.random((batch, 999, 6), dtype=np.float32)
        six[..., :3] = np.round(six[..., :3] * 4) / 4               # ties
        return six
    return rng.random((batch, 1001, 3), dtype=np.float32)


MODEL_PLANS = [FpsPlan(1, 32, 1), FpsPlan(1, 32, 16), FpsPlan(1, 128, 3),
               FpsPlan(1, 128, 12), FpsPlan(1, 1024, 2),
               FpsPlan(4, 128, 5), FpsPlan(8, 128, 2), FpsPlan(3, 320, 2),
               FpsPlan(6, 32, 14)]


@pytest.mark.parametrize("kind", ["lattice", "duplicated", "all-equal",
                                  "grid-6ch", "random"])
@pytest.mark.parametrize("plan", MODEL_PLANS, ids=str)
def test_kernel_model_matches_plain(kind, plan):
    pts = clouds(kind)
    n = min(pts.shape[1], plan.cluster * plan.threads * plan.ppt - 5)
    pts = pts[:, :n]
    npoint = min(n, 60)
    ref = S.farthest_point_sample_plain(npoint, torch.from_numpy(pts))
    np.testing.assert_array_equal(kernel_model(npoint, pts, plan),
                                  ref.numpy())


STREAM_PLANS = [FpsPlan(2, 32, 0), FpsPlan(3, 64, 0), FpsPlan(8, 96, 0),
                FpsPlan(2, 1024, 0)]


@pytest.mark.parametrize("kind", ["lattice", "duplicated", "all-equal",
                                  "grid-6ch", "random"])
@pytest.mark.parametrize("plan", STREAM_PLANS, ids=str)
def test_stream_model_matches_plain(kind, plan):
    pts = clouds(kind)
    npoint = min(pts.shape[1], 60)
    ref = S.farthest_point_sample_plain(npoint, torch.from_numpy(pts))
    np.testing.assert_array_equal(stream_model(npoint, pts, plan),
                                  ref.numpy())


def test_kernel_model_matches_plain_when_every_point_is_taken():
    pts = lattice(2, 5, 8)[:, :117]          # 117 = no multiple of a warp
    ref = S.farthest_point_sample_plain(117, torch.from_numpy(pts))
    for plan in (FpsPlan(1, 32, 4), FpsPlan(2, 64, 1)):
        np.testing.assert_array_equal(kernel_model(117, pts, plan),
                                      ref.numpy())
    assert sorted(ref[0].tolist()) == list(range(117))


@pytest.mark.parametrize("n,npoint", SERVED)
def test_plan_of_served_shapes(n, npoint):
    plan = S.fps_plan(16, n, h100_active)
    want = {10000: FpsPlan(6, 128, 14), 2500: FpsPlan(1, 512, 5),
            625: FpsPlan(1, 128, 5), 8192: FpsPlan(6, 128, 12),
            2048: FpsPlan(1, 384, 6), 768: FpsPlan(1, 128, 6),
            384: FpsPlan(1, 128, 3)}[n]
    assert plan == want


@pytest.mark.parametrize("n,want", [(1, FpsPlan(1, 128, 1)),
                                    (128, FpsPlan(1, 128, 1)),
                                    (129, FpsPlan(1, 128, 2)),
                                    (3072, FpsPlan(1, 512, 6)),
                                    (3073, FpsPlan(5, 128, 5))])
def test_plan_of_small_clouds(n, want):
    # a cloud up to BLOCK_MAX_POINTS takes one block of whole 4-warp
    # groups, however small; a larger one a cluster
    assert S.fps_plan(16, n, h100_active) == want


def test_plan_takes_a_smaller_cluster_when_waves_would_repeat():
    # 15 clusters of 8 or 7 at once: 16 clouds take 6-CTA clusters
    assert S.fps_plan(16, 10000, h100_active).cluster == 6
    assert S.fps_plan(15, 10000, h100_active).cluster == 8
    # 16 clusters of 8 at once: 16 clouds take them
    more = {**{c: 20 for c in range(2, 8)}, 8: 16}
    assert S.fps_plan(16, 10000, lambda p: more[p.cluster]) \
        == FpsPlan(8, 128, 10)
    # 64 clouds: only pairs fit one wave
    assert S.fps_plan(64, 10000, h100_active) == FpsPlan(2, 384, 14)
    # 200 clouds: no size fits one wave; the fewest waves (4 at C = 2)
    assert S.fps_plan(200, 10000, h100_active).cluster == 2


def test_plan_raises_when_no_cluster_runs():
    none = lambda plan: 0                        # noqa: E731
    assert S.fps_plan(16, 3072, none) == FpsPlan(1, 512, 6)
    with pytest.raises(RuntimeError, match="no cluster"):
        S.fps_plan(16, 3073, none)


@pytest.mark.parametrize("batch", [1, 16, 64])
def test_plan_invariants(batch):
    cap = S.REGISTER_MAX_POINTS
    for n in list(range(1, 300)) + list(range(300, cap + 1, 97)) + [cap]:
        plan = S.fps_plan(batch, n, h100_active)
        assert plan.ppt in S.PPT_SIZES
        assert plan.threads % 32 == 0
        assert 32 <= plan.threads <= S.max_threads(plan.ppt)
        assert plan.cluster * plan.threads * plan.ppt >= n
        if plan.cluster > 1:
            assert plan.cluster * plan.threads // 32 <= S.MAX_CANDIDATES
        # no CTA of a cluster is left without a point
        assert (plan.cluster - 1) * plan.threads * plan.ppt < n
    for n in (cap + 1, 40000, 131072, 10 ** 7):
        plan = S.fps_plan(batch, n, h100_active)
        assert plan.ppt == 0 and plan.threads == S.STREAM_THREADS
        assert 2 <= plan.cluster <= S.MAX_CLUSTER
        assert (plan.cluster - 1) * plan.threads < n


def test_plan_rejects_clouds_beyond_the_cap():
    # no cap: a cloud beyond the registers takes the device-memory plan,
    # in clusters of the same size as a register plan's at that B
    for n in (S.REGISTER_MAX_POINTS + 1, 200000):
        assert S.fps_plan(16, n, h100_active) == FpsPlan(6, 1024, 0)
        assert S.fps_plan(2, n, h100_active) == FpsPlan(8, 1024, 0)
    assert S.fps_plan(16, S.REGISTER_MAX_POINTS, h100_active).ppt == 16
    for n in (0, -1):
        with pytest.raises(ValueError, match="at least one point"):
            S.fps_plan(16, n, h100_active)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def assert_kernel_equals_plain(npoint, t, plan=None):
    got = S.farthest_point_sample_kernel(npoint, t, plan)
    assert got.dtype == torch.int64 and got.shape == (t.shape[0], npoint)
    assert torch.equal(got, S.farthest_point_sample_plain(npoint, t))


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", SERVED)
def test_served_shapes_match_plain_on_cuda(cuda_device, n, npoint):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    t = torch.rand((16, n, 3), generator=gen, device=cuda_device)
    assert_kernel_equals_plain(npoint, t)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None, FpsPlan(8, 128, 10)], ids=str)
def test_batch_of_64_matches_plain_on_cuda(cuda_device, plan):
    # FpsPlan(8, 128, 10): 64 clusters of 8 CTAs, more than one wave
    gen = torch.Generator(device=cuda_device).manual_seed(64)
    t = torch.rand((64, 10000, 3), generator=gen, device=cuda_device)
    assert_kernel_equals_plain(2500, t, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lattice", "duplicated", "all-equal",
                                  "grid-6ch", "random"])
def test_tied_clouds_match_plain_on_cuda(cuda_device, kind):
    t = torch.from_numpy(clouds(kind, batch=3)).to(cuda_device)
    for npoint in (1, 2, 300, t.shape[1]):
        assert_kernel_equals_plain(npoint, t)


@pytest.mark.cuda
def test_wide_strided_and_capped_databases_match_plain_on_cuda(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    six = torch.rand((2, 10000, 6), generator=gen, device=cuda_device)
    assert_kernel_equals_plain(2500, six)                 # read in place
    strided = six[..., :3].transpose(1, 2).contiguous().transpose(1, 2)
    assert_kernel_equals_plain(700, strided)              # converted
    assert_kernel_equals_plain(700, six.bfloat16())       # converted
    cap = torch.rand((2, S.REGISTER_MAX_POINTS + 1, 3), generator=gen,
                     device=cuda_device)
    assert_kernel_equals_plain(1024, cap[:, :-1])         # in registers
    assert_kernel_equals_plain(1024, cap)                 # in memory
    assert_kernel_equals_plain(700, cap.transpose(1, 2).contiguous()
                               .transpose(1, 2))          # converted


@pytest.mark.cuda
@pytest.mark.parametrize("ppt", S.PPT_SIZES)
def test_every_instance_matches_plain_on_cuda(cuda_device, ppt):
    pts = torch.from_numpy(lattice(3, 12, ppt)).to(cuda_device)
    for plan in (FpsPlan(1, 32, ppt), FpsPlan(1, 128, ppt),
                 FpsPlan(1, S.max_threads(ppt), ppt), FpsPlan(4, 128, ppt),
                 FpsPlan(8, 128, ppt), FpsPlan(2, 512, ppt)):
        n = min(plan.cluster * plan.threads * ppt - 3, pts.shape[1])
        assert_kernel_equals_plain(min(n, 300), pts[:, :n], plan)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,npoint", [(2, 16385, 1), (2, 16385, 4096),
                                            (3, 40000, 2500),
                                            (4, 131072, 1), (4, 131072, 600)])
def test_clouds_beyond_the_registers_match_plain_on_cuda(cuda_device, batch,
                                                         n, npoint):
    gen = torch.Generator(device=cuda_device).manual_seed(n + npoint)
    t = torch.rand((batch, n, 3), generator=gen, device=cuda_device)
    assert S.fps_plan(batch, n, S.max_active_clusters).ppt == 0
    assert_kernel_equals_plain(npoint, t)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [None] + STREAM_PLANS, ids=str)
def test_tied_clouds_in_memory_match_plain_on_cuda(cuda_device, plan):
    # a lattice of 26**3 = 17576 points beyond the registers (None: its
    # own plan), and every cloud of the CPU models through each
    # device-memory plan
    if plan is None:
        t = torch.from_numpy(lattice(2, 26, 9)).to(cuda_device)
        assert_kernel_equals_plain(3000, t)
        return
    for kind in ("lattice", "duplicated", "all-equal", "grid-6ch",
                 "random"):
        t = torch.from_numpy(clouds(kind, batch=3)).to(cuda_device)
        for npoint in (1, 300, t.shape[1]):
            assert_kernel_equals_plain(npoint, t, plan)
