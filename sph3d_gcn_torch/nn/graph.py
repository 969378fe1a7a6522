"""Graph construction for the SPH3D pyramids (counterpart of
``sph3d_gcn_tpu/nn/graph.py``: the per-edge level and decoder graphs,
the dense encoder, pool and decoder graphs and the global graph)."""

from __future__ import annotations

import torch

from sph3d_gcn_torch.ops.dense import (
    DenseNeighborhood,
    build_dense_graph,
    dense_ids_prob,
)
from sph3d_gcn_torch.ops.locality import sort_indices_small
from sph3d_gcn_torch.ops.neighbor import (
    build_sphere_neighbor,
    build_sphere_neighbor_and_bins,
)
from sph3d_gcn_torch.ops.sample import (
    farthest_point_sample,
    ids_uniform,
    inverse_density_sample,
    random_indices,
    random_sample,
)
from sph3d_gcn_torch.ops.types import Neighborhood
from sph3d_gcn_torch.parallel.mesh import active_group, draw_rows, spread


def _sample(xyz, num_sample, sample_method, prob_fn, generator, noise,
            use_kernels):
    """Subsample indices (B, S) int64 by ``sample_method`` (ref
    utils/sph3gcn_util.py:33-41): FPS, IDS on ``prob_fn()`` (the mean
    neighbor distance) or random with replacement; ``generator`` draws
    the noise of IDS and random sampling unless ``noise`` holds the
    draws ((B, N) uniforms in [tiny, 1) for IDS, (B, S) indices for
    random). Under ``parallel.data_parallel`` with more than one rank,
    the draws are this rank's rows of the global batch's
    (``parallel.draw_rows``)."""
    spread_draws = noise is None and spread(active_group())
    batch, num = xyz.shape[0], xyz.shape[1]
    if sample_method == "FPS":
        return farthest_point_sample(num_sample, xyz,
                                     use_kernels=use_kernels)
    if sample_method == "IDS":
        if spread_draws:
            noise = draw_rows(lambda shape: ids_uniform(
                shape, generator, xyz.device), (batch, num))
        return inverse_density_sample(num_sample, prob_fn(), generator,
                                      uniform=noise)
    if sample_method == "random":
        if spread_draws:
            noise = draw_rows(lambda shape: random_indices(
                shape, num, generator, xyz.device), (batch, num_sample))
        return random_sample(num_sample, xyz, generator, indices=noise)
    raise ValueError(f"Unknown sampling method: {sample_method!r}")


def build_graph(
    xyz: torch.Tensor,
    radius: float,
    nn_uplimit: int,
    num_sample: int | None,
    sample_method: str | None = None,
    kernel: tuple[int, int, int] = (8, 2, 2),
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    use_kernels: bool | None = None,
) -> tuple[Neighborhood, torch.Tensor, torch.Tensor | None]:
    """Intra-level sphere graph with its spherical bins fused into the
    query, plus subsample indices in the sampler's order (ref
    utils/sph3gcn_util.py:28-49): FPS, IDS (on the edges' sqrt-space
    distances) or random, their noise from ``generator`` or ``noise`` (see
    :func:`_sample`). Returns (Neighborhood, filt_index, sample_index or
    None)."""
    intra, filt = build_sphere_neighbor_and_bins(
        xyz, xyz, radius, nn_uplimit, kernel, self_graph=True)
    if num_sample is None:
        return intra, filt, None

    def prob():
        return intra.dist.sum(dim=-1) / torch.clamp_min(intra.count,
                                                        1).float()

    return intra, filt, _sample(xyz, num_sample, sample_method, prob,
                                generator, noise, use_kernels)


def build_graph_dense(
    xyz: torch.Tensor,
    radius: float,
    nn_uplimit: int,
    num_sample: int | None,
    sample_method: str | None = None,
    kernel: tuple[int, int, int] = (8, 2, 2),
    window: int = 1024,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    use_kernels: bool | None = None,
    query_shard: tuple[int, int] | None = None,
) -> tuple[DenseNeighborhood, torch.Tensor | None]:
    """Intra-level dense graph plus subsample indices (FPS, IDS or random,
    as :func:`build_graph`), returned SORTED so the coarser cloud stays
    axis-sorted. IDS asks the query for its distance map
    (``dense_ids_prob``). ``query_shard`` (rank, shards) builds that point
    rank's query tiles only (``ops.dense.build_dense_graph``); the
    sampling stays replicated (FPS is a greedy over the whole cloud, and
    every rank needs its indices). IDS, which reads every point's
    density, raises with it."""
    need_dist = sample_method == "IDS" and num_sample is not None
    if query_shard is not None and sample_method == "IDS":
        raise ValueError(
            "IDS sampling needs the full per-point density map and is not "
            "supported with a tile-sharded graph build (use FPS/random)")
    dnbh = build_dense_graph(
        xyz, xyz, radius, nn_uplimit, kernel, window=window,
        self_graph=True, need_dist=need_dist, use_kernels=use_kernels,
        query_shard=query_shard,
    )
    if num_sample is None:
        return dnbh, None
    idx = _sample(xyz, num_sample, sample_method,
                  lambda: dense_ids_prob(dnbh), generator, noise,
                  use_kernels)
    return dnbh, sort_indices_small(idx)


def build_pool_graph_dense(
    xyz: torch.Tensor,
    xyz_sampled: torch.Tensor,
    radius: float,
    nn_uplimit: int,
    window: int,
    use_kernels: bool | None = None,
    query_shard: tuple[int, int] | None = None,
) -> DenseNeighborhood:
    """Dense pooling graph: the sampled points re-query the level cloud
    (selection-only rank maps); ``query_shard``: that point rank's coarse
    query tiles only."""
    return build_dense_graph(
        xyz, xyz_sampled, radius, nn_uplimit, None, window=window,
        self_graph=False, use_kernels=use_kernels, query_shard=query_shard,
    )


def build_graph_deconv(
    xyz: torch.Tensor,
    xyz_unpool: torch.Tensor,
    radius: float,
    nn_uplimit: int,
    kernel: tuple[int, int, int] = (8, 2, 2),
) -> tuple[Neighborhood, torch.Tensor, Neighborhood]:
    """Decoder graphs of the per-edge engine (ref
    utils/sph3gcn_util.py:52-58): the coarse cloud's intra graph with its
    spherical bins fused into the query, and the inter graph for
    unpooling, whose queries are the *fine* points searching the *coarse*
    cloud (``inter.idx`` indexes coarse points), a lone fine point growing
    its radius by +0.05 until it finds one (ref tf_nnquery_gpu.cu:30-60);
    ``inter.dist`` holds the sqrt-space distances of the weighted unpool.
    Returns (intra, filt_index, inter)."""
    inter = build_sphere_neighbor(xyz, xyz_unpool, radius=radius,
                                  nn_sample=nn_uplimit)
    intra, filt = build_sphere_neighbor_and_bins(
        xyz, xyz, radius, nn_uplimit, kernel, self_graph=True)
    return intra, filt, inter


def build_graph_deconv_dense(
    xyz: torch.Tensor,
    xyz_unpool: torch.Tensor,
    radius: float,
    nn_uplimit: int,
    kernel: tuple[int, int, int],
    window: int,
    need_dist: bool = False,
    dec_margin: int = 384,
    growth_steps: int = 12,
    use_kernels: bool | None = None,
    intra_shard: tuple[int, int] | None = None,
    inter_shard: tuple[int, int] | None = None,
) -> tuple[DenseNeighborhood, DenseNeighborhood]:
    """Decoder graphs: the coarse cloud's intra graph (bin maps) and the
    fine->coarse inter graph for unpooling (rank maps, with its distance
    map when ``need_dist``: the weighted unpool). The inter graph
    reproduces the reference's +0.05 radius growth for fine points with
    no coarse neighbor (ref tf_nnquery_gpu.cu:30-60) in a window widened
    by ``dec_margin`` rows, re-certified at each tile's grown radius.
    ``intra_shard`` / ``inter_shard`` (rank, shards): that point rank's
    coarse / fine query tiles only."""
    intra = build_dense_graph(
        xyz, xyz, radius, nn_uplimit, kernel, window=window,
        self_graph=True, use_kernels=use_kernels, query_shard=intra_shard,
    )
    inter = build_dense_graph(
        xyz, xyz_unpool, radius, nn_uplimit, None,
        window=window + dec_margin, self_graph=False, need_dist=need_dist,
        growth_steps=growth_steps, use_kernels=use_kernels,
        query_shard=inter_shard,
    )
    return intra, inter


def build_global_graph(
    xyz: torch.Tensor, query: torch.Tensor, radius: float
) -> Neighborhood:
    """All-points-to-centroid edges with nn_sample = N
    (ref utils/sph3gcn_util.py:20-25)."""
    return build_sphere_neighbor(xyz, query, radius=radius,
                                 nn_sample=xyz.shape[1])


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Subsample along the point axis: (B, N, ...), (B, S) -> (B, S, ...)."""
    idx_b = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx_b.expand(idx.shape + x.shape[2:]))


def gather_neighborhood(nbh: Neighborhood, idx: torch.Tensor) -> Neighborhood:
    """Neighborhood rows at the sampled coarse points (the classic pooling
    graph)."""
    return Neighborhood(
        idx=gather_points(nbh.idx, idx),
        count=gather_points(nbh.count, idx),
        dist=None if nbh.dist is None else gather_points(nbh.dist, idx),
    )
