"""ModelNet40 classification network (counterpart of
``sph3d_gcn_tpu/models/modelnet.py``).

Axis sort -> unit-sphere normalization -> input MLP -> 3 levels of
{sphere graph -> separable conv block -> FPS -> pool graph -> max pool}
with xyz concatenated onto every level's input -> per-level global max
features -> global centroid conv (radius 100, kernel (8,2,1), 17 bins)
-> FC 512 -> dropout -> FC 256 -> dropout -> logits (ref
SPH3D_modelnet.py:33-108). ``self.training`` drives batch-statistics BN
and dropout (``model.train()`` / ``model.eval()``). The config's
``sample`` (FPS, IDS, random) and ``pool_method`` (max, avg) choose the
sampler and the pool of every level; IDS and random sampling draw their
noise in both modes, as the reference's sampling ops do.

Two engines, chosen by ``config.dense_graph`` as in JAX: the dense
windowed engine (graphs as packed maps, certified by ``dense_ok``) and
the per-edge engine (edge lists from the sphere query with fused bins,
the pool graph gathered at the sorted FPS indices, convs and pools
through the edge gather of ``ops/windowed.py`` at the config's windows,
or the plain gather without windows). Both hold the same parameters.

With ``config.point_axis`` (point sharding, ``parallel.spatial``) the
dense engine runs on the point group of the enclosing
``parallel.data_parallel``: coordinates, sampling and the pool graphs'
databases stay whole, each level whose rows split into whole tiles over
the ranks (``shardable_rows``) holds this rank's rows and builds its own
query tiles, its windows rebased for a halo of one window (intra graphs)
or ``halo_scale`` pool windows (pool graphs); pooling onto a level that
does not split gathers the rows (``all_rows``), each level's global max
is the max of the ranks' maxima, and the global conv and the head run
replicated. ``halo_ok`` then certifies the halos (False: a window left
its halo, which ``dense_ok`` folds in too), both agreed over the ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from sph3d_gcn_torch.configs.base import SPH3DConfig
from sph3d_gcn_torch.models.common import (
    SeparableConvBlock,
    agree_certificates,
    compute_dtype,
    normalize_unit_sphere,
    shard_inputs,
    shard_intra,
    sharding_of,
)
from sph3d_gcn_torch.nn.graph import (
    build_global_graph,
    build_graph,
    build_graph_dense,
    build_pool_graph_dense,
    gather_neighborhood,
    gather_points,
)
from sph3d_gcn_torch.nn.layers import (
    Dropout,
    FullyConnected,
    PointwiseConv3d,
    SeparableConv3d,
    pool3d,
)
from sph3d_gcn_torch.nn.spans import layer_span
from sph3d_gcn_torch.ops.kernelbin import spherical_kernel
from sph3d_gcn_torch.parallel import spatial
from sph3d_gcn_torch.ops.locality import (
    permute_points,
    sort_indices_small,
    spatial_sort,
)

_GLOBAL_RADIUS = 100.0       # ref SPH3D_modelnet.py:86 (connects all points)
_GLOBAL_KERNEL = (8, 2, 1)   # ref SPH3D_modelnet.py:89-90, binSize 17


class SPH3DModelNet(nn.Module):
    """Classification network: (B, N, 3) -> (B, num_cls) f32 logits.

    After each forward, ``dense_ok`` holds that forward's window-coverage
    certificate (a bool tensor): True iff every dense graph provably
    covered all in-range neighbors, so the logits equal the classic
    per-edge engine's; always True on the per-edge engine, which is
    exact for every cloud (``models.common.classic_clone`` re-runs a
    dense model there). ``halo_ok`` holds the halo certificate of a
    point-sharded forward (True otherwise).
    """

    def __init__(self, config: SPH3DConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        dt = compute_dtype(cfg)
        common = dict(with_bn=cfg.with_bn, with_bias=cfg.with_bias, dtype=dt,
                      generator=generator)
        self.mlp1 = PointwiseConv3d(3, cfg.mlp, **common)
        c = cfg.mlp
        feat = 0
        for level in range(len(cfg.radius)):
            c_in = c + 3 if cfg.use_raw else c
            self.add_module(f"conv{level + 1}", SeparableConvBlock(
                c_in, cfg.channels[level], cfg.bin_size,
                cfg.multiplier[level], **common,
            ))
            c = cfg.channels[level][-1]
            feat += c
        self.global_conv = SeparableConv3d(
            c, cfg.global_channels, 17, cfg.global_multiplier, **common
        )
        feat += cfg.global_channels
        self.fc1 = FullyConnected(feat, 512, **common)
        self.fc1_dp = Dropout(0.5)
        self.fc2 = FullyConnected(512, 256, **common)
        self.fc2_dp = Dropout(0.5)
        self.logits = FullyConnected(
            256, cfg.num_cls, with_bn=False, with_bias=cfg.with_bias,
            activation=False, generator=generator,
        )
        self.dense_ok: torch.Tensor | None = None
        self.halo_ok: torch.Tensor | None = None

    def forward(self, points: torch.Tensor,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``use_kernels``: None runs the CUDA kernels on a CUDA device and
        the plain versions on the CPU; False forces the plain versions
        (for comparing the two). ``generator`` draws the sampling noise of
        IDS and random sampling (level by level, before the dropout masks)
        and the dropout masks in train mode. ``sample_noise``: per level,
        the sampler's draws to use instead (``nn.graph.build_graph``)."""
        cfg = self.config
        if points.dim() != 3 or points.shape[1] != cfg.num_input:
            raise ValueError(
                f"expected (B, {cfg.num_input}, 3) points, got "
                f"{tuple(points.shape)}"
            )
        points = points.float()
        if cfg.spatial_sort:
            with layer_span("sort"):
                perm, _ = spatial_sort(points, cfg.radius[0])
                points = permute_points(points, perm)
        if cfg.normalize:
            points = normalize_unit_sphere(points)
        xyz = points
        query = xyz.mean(dim=1, keepdim=True)   # the global viewing point
        pts = sharding_of(cfg)
        cur_sh = pts is not None and spatial.shardable_rows(xyz.shape[1],
                                                            pts.size)

        def rows(x):
            """``x``'s rows that ``net`` holds."""
            return spatial.slice_rows_local(x, pts) if cur_sh else x

        net = self.mlp1(rows(xyz), sharded=cur_sh)

        global_feat = []
        dense_ok = halo_ok = torch.ones((), dtype=torch.bool,
                                        device=points.device)
        for level in range(len(cfg.radius)):
            if cfg.use_raw:
                net = torch.cat([net, rows(xyz).to(net.dtype)], dim=-1)
            sampling = dict(
                generator=generator,
                noise=None if sample_noise is None else sample_noise[level])
            if cfg.dense_graph:
                net, xyz, ok, h_ok, cur_sh = self._dense_level(
                    net, xyz, level, sampling, use_kernels, pts, cur_sh)
                dense_ok = dense_ok & ok
                halo_ok = halo_ok & h_ok
            else:
                net, xyz = self._classic_level(net, xyz, level, sampling,
                                               use_kernels)
            # multi-scale global max feature (ref SPH3D_modelnet.py:82-83);
            # amax splits the gradient evenly between tied maxima, as
            # jnp.max does (bf16 makes ties common); sharded, the max of
            # the ranks' maxima, the gradient routed to its rank
            local_max = net.amax(dim=1, keepdim=True)
            if cur_sh:
                local_max = spatial.all_rows(local_max, pts).amax(
                    dim=1, keepdim=True)
            global_feat.append(local_max)
        if cur_sh:
            # the remaining cloud feeds the replicated global conv
            net = spatial.all_rows(net, pts)
        self.dense_ok, self.halo_ok = agree_certificates(dense_ok, halo_ok,
                                                         pts)

        # all remaining points -> centroid (ref SPH3D_modelnet.py:85-94)
        with layer_span("global_graph"):
            gnbh = build_global_graph(xyz, query, _GLOBAL_RADIUS)
            gfilt = spherical_kernel(xyz, query, gnbh, _GLOBAL_RADIUS,
                                     _GLOBAL_KERNEL)
        net = self.global_conv(net, gnbh, gfilt)
        global_feat.append(net)
        net = torch.cat(global_feat, dim=2).reshape(net.shape[0], -1)
        net = self.fc1_dp(self.fc1(net), generator)
        net = self.fc2_dp(self.fc2(net), generator)
        return self.logits(net)

    def _dense_level(self, net, xyz, level, sampling, use_kernels, pts,
                     cur_sh):
        """One level on the dense engine: (net, coarse xyz, the level's
        certificate, its halo certificate, whether the coarse rows are
        sharded). ``pts``: the point group of a sharded forward, and
        ``cur_sh`` whether ``net`` holds this rank's rows of ``xyz``."""
        cfg = self.config
        with layer_span(f"level{level + 1}.graph"):
            nbh, sample_idx = build_graph_dense(
                xyz, cfg.radius[level], cfg.nn_uplimit[level],
                cfg.num_sample[level], sample_method=cfg.sample,
                kernel=cfg.kernel, window=cfg.enc_window(level),
                use_kernels=use_kernels,
                query_shard=(pts.rank, pts.size) if cur_sh else None,
                **sampling,
            )
            nbh, h_ok, halo = shard_intra(nbh, xyz, pts, cur_sh)
        ok = nbh.ok
        net = getattr(self, f"conv{level + 1}")(
            net, nbh, use_kernels=use_kernels, remat=cfg.remat_blocks,
            halo_rows=halo,
        )
        if cfg.num_sample[level] > 1:
            # the sample indices come back sorted: the coarse cloud stays
            # axis-sorted for the next dense level
            with layer_span(f"level{level + 1}.pool"):
                xyz_coarse = gather_points(xyz, sample_idx)
                nxt_sh = pts is not None and spatial.shardable_rows(
                    xyz_coarse.shape[1], pts.size)
                inter = build_pool_graph_dense(
                    xyz, xyz_coarse, cfg.radius[level],
                    cfg.nn_uplimit[level], window=cfg.pool_window(level),
                    use_kernels=use_kernels,
                    query_shard=(pts.rank, pts.size) if nxt_sh else None,
                )
                net, inter, p_ok = shard_inputs(net, inter, xyz, pts,
                                                cur_sh, nxt_sh,
                                                cfg.halo_scale)
                ok = ok & inter.ok
                h_ok = h_ok & p_ok
                net = pool3d(net, inter, method=cfg.pool_method,
                             use_kernels=use_kernels)
            xyz = xyz_coarse
            cur_sh = nxt_sh
        return net, xyz, ok, h_ok, cur_sh

    def _classic_level(self, net, xyz, level, sampling, use_kernels):
        """One level on the per-edge engine: (net, coarse xyz)."""
        cfg = self.config
        with layer_span(f"level{level + 1}.graph"):
            nbh, filt_idx, sample_idx = build_graph(
                xyz, cfg.radius[level], cfg.nn_uplimit[level],
                cfg.num_sample[level], sample_method=cfg.sample,
                kernel=cfg.kernel, use_kernels=use_kernels, **sampling,
            )
        net = getattr(self, f"conv{level + 1}")(
            net, nbh, filt_idx, window=cfg.enc_window(level),
            use_kernels=use_kernels, remat=cfg.remat_blocks,
        )
        if cfg.num_sample[level] > 1:
            with layer_span(f"level{level + 1}.pool"):
                if cfg.spatial_sort:
                    # ascending order keeps the coarse cloud axis-sorted
                    sample_idx = sort_indices_small(sample_idx)
                xyz_coarse = gather_points(xyz, sample_idx)
                inter = gather_neighborhood(nbh, sample_idx)
                net = pool3d(net, inter, method=cfg.pool_method,
                             window=cfg.pool_window(level),
                             use_kernels=use_kernels)
            xyz = xyz_coarse
        return net, xyz


def classification_item_loss(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Per-item softmax cross entropy, (B,), in f32. The label pick is a
    one-hot product, so its gradient is elementwise (no scatter)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    return -(logp * onehot).sum(dim=-1)


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy (ref SPH3D_modelnet.py:112-119)."""
    return classification_item_loss(logits, labels).mean()
