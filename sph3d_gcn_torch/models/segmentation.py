"""Segmentation models (counterpart of
``sph3d_gcn_tpu/models/segmentation.py``): ``SegEncoderDecoder`` and the
model families on it, ``SPH3DSceneSeg`` (S3DIS / ScanNet),
``SPH3DRueMonge``, ``SPH3DShapeNet`` and ``SPH3DShapeNetOnehot``.

Axis sort -> input normalization -> input MLP -> encoder {sphere
graph -> separable conv block -> sample -> pool graph -> pool} x L ->
mirrored decoder {coarse intra graph + fine->coarse inter graph with
radius growth -> conv block at the coarse level -> unpool to the finer
level -> skip concat} [-> mlp2 ++ the input MLP's features (ShapeNet)]
-> pointwise logits -> unsort to the input order (ref
SPH3D_s3dis.py:35-112, SPH3D_shapenet.py:33-113). The config's
``sample`` (FPS, IDS, random), ``pool_method`` (max, avg) and
``unpool_method`` (mean, or weighted: the inter graphs then carry
distances) choose the sampler, pool and unpool. The decoder indexes
reversed copies of the config lists (the reference reverses them in
place, ref SPH3D_s3dis.py:79-84).

Two engines, chosen by ``config.dense_graph`` as in JAX: the dense
windowed engine (graphs as packed maps, certified by ``dense_ok``) and
the per-edge engine (edge lists from the sphere query with fused bins,
the pool graph gathered at the sorted sample indices, the decoders'
inter graphs from the growing query; convs, pools and unpools through
the edge gather of ``ops/windowed.py`` at the config's windows, or the
plain gather without windows). Both hold the same parameters.

With ``config.point_axis`` the dense engine shards each level's rows
over the point group of the enclosing ``parallel.data_parallel``, as
``models.modelnet`` describes: the encoder's levels and pools as
there; the decoder's intra graphs on the coarse rows with a window of
halo, and its unpools from coarse rows haloed by ``halo_scale`` inter
windows (both sharded), from whole coarse rows onto this rank's fine
tiles (coarse level replicated), or from gathered rows (fine level
replicated); the logits of this rank's rows are gathered into the whole
cloud's before the unsort (JAX's ``_maybe_gather_rows``), so the
contract is unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from sph3d_gcn_torch.configs.base import SPH3DConfig
from sph3d_gcn_torch.models.common import (
    SeparableConvBlock,
    agree_certificates,
    compute_dtype,
    normalize_mean_center,
    normalize_unit_sphere,
    normalize_xy_center_z_floor,
    shard_inputs,
    shard_intra,
    sharding_of,
)
from sph3d_gcn_torch.nn.graph import (
    build_graph,
    build_graph_deconv,
    build_graph_deconv_dense,
    build_graph_dense,
    build_pool_graph_dense,
    gather_neighborhood,
    gather_points,
)
from sph3d_gcn_torch.nn.layers import PointwiseConv3d, pool3d, unpool3d
from sph3d_gcn_torch.nn.spans import layer_span
from sph3d_gcn_torch.ops.locality import (
    permute_points,
    sort_indices_small,
    spatial_sort,
)
from sph3d_gcn_torch.parallel import spatial

# the scene blocks' columns: xyz, block-relative xyz, rgb; the backbone
# reads the xy-centered xyz and the columns from 6 on (rgb)
_IN_COLUMNS = 9
# RueMonge2014's columns: xyz, normals, rgb (all read by the backbone)
_RUEMONGE_COLUMNS = 9
NUM_SHAPENET_CATEGORIES = 16  # ref models/SPH3D_shapenet_onehot.py:10


class SegEncoderDecoder(nn.Module):
    """mlp1 -> encoder pyramid -> decoder with skip concats [-> mlp2], on
    either engine, the dense one point-sharded under ``point_axis``.
    ``include_input_skip`` (the ShapeNet variant, ref
    SPH3D_shapenet.py:46,106-108) puts the mlp1 output first in the skip
    list and ends with ``mlp2`` (cfg.mlp channels) concatenated with it;
    the scene models run without both.

    ``forward`` returns (features (B, N, C) at the finest level, this
    point rank's rows of them when sharded, the forward's window-coverage
    certificate and its halo certificate as bool tensors)."""

    def __init__(self, config: SPH3DConfig, in_channels: int,
                 generator: torch.Generator | None = None,
                 include_input_skip: bool = False) -> None:
        super().__init__()
        cfg = config
        common = dict(with_bn=cfg.with_bn, with_bias=cfg.with_bias,
                      dtype=compute_dtype(cfg), generator=generator)
        self.config = cfg
        self.include_input_skip = include_input_skip
        self.mlp1 = PointwiseConv3d(in_channels, cfg.mlp, **common)
        c = cfg.mlp
        skips = []
        for level in range(len(cfg.radius)):
            self.add_module(f"conv{level + 1}", SeparableConvBlock(
                c, cfg.channels[level], cfg.bin_size, cfg.multiplier[level],
                **common,
            ))
            c = cfg.channels[level][-1]
            skips.append(c)
        for level, (chans, mults) in enumerate(
                zip(cfg.channels[::-1], cfg.multiplier[::-1])):
            self.add_module(f"deconv{level + 1}", SeparableConvBlock(
                c, chans, cfg.bin_size, mults, **common,
            ))
            c = chans[-1] + skips[::-1][level]
        if include_input_skip:
            self.mlp2 = PointwiseConv3d(c, cfg.mlp, **common)
            c = 2 * cfg.mlp
        self.out_channels = c

    def forward(self, net: torch.Tensor, xyz: torch.Tensor,
                config: SPH3DConfig | None = None,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``config``: the configuration to run (None: the module's own; a
        classic clone of the model passes its per-edge one). ``generator``
        draws the noise of IDS and random sampling, level by level, unless
        ``sample_noise`` holds each level's draws
        (``nn.graph.build_graph``)."""
        cfg = self.config if config is None else config
        num_levels = len(cfg.radius)
        pts = sharding_of(cfg)

        def sharded(rows: int) -> bool:
            return pts is not None and spatial.shardable_rows(rows, pts.size)

        def tiles(on: bool):
            return (pts.rank, pts.size) if on else None

        cur_sh = sharded(net.shape[1])
        if cur_sh:
            net = spatial.slice_rows_local(net, pts)
        net = self.mlp1(net, sharded=cur_sh)
        xyz_layers = [xyz]
        encoder = [net] if self.include_input_skip else []
        dense_ok = halo_ok = torch.ones((), dtype=torch.bool,
                                        device=xyz.device)

        # encoder (ref SPH3D_s3dis.py:53-77)
        for level in range(num_levels):
            graph = dict(
                sample_method=cfg.sample, kernel=cfg.kernel,
                generator=generator,
                noise=None if sample_noise is None else sample_noise[level],
                use_kernels=use_kernels)
            conv = getattr(self, f"conv{level + 1}")
            if cfg.dense_graph:
                with layer_span(f"level{level + 1}.graph"):
                    nbh, sample_idx = build_graph_dense(
                        xyz, cfg.radius[level], cfg.nn_uplimit[level],
                        cfg.num_sample[level], window=cfg.enc_window(level),
                        query_shard=tiles(cur_sh), **graph)
                    nbh, h_ok, halo = shard_intra(nbh, xyz, pts, cur_sh)
                dense_ok = dense_ok & nbh.ok
                halo_ok = halo_ok & h_ok
                net = conv(net, nbh, use_kernels=use_kernels,
                           remat=cfg.remat_blocks, halo_rows=halo)
            else:
                with layer_span(f"level{level + 1}.graph"):
                    nbh, filt_idx, sample_idx = build_graph(
                        xyz, cfg.radius[level], cfg.nn_uplimit[level],
                        cfg.num_sample[level], **graph)
                net = conv(net, nbh, filt_idx, window=cfg.enc_window(level),
                           use_kernels=use_kernels, remat=cfg.remat_blocks)
            encoder.append(net)
            if cfg.num_sample[level] > 1:
                with layer_span(f"level{level + 1}.pool"):
                    if cfg.dense_graph:
                        # the sample indices come back sorted: the coarse
                        # cloud stays axis-sorted for the next dense level
                        xyz_coarse = gather_points(xyz, sample_idx)
                        nxt_sh = sharded(xyz_coarse.shape[1])
                        inter = build_pool_graph_dense(
                            xyz, xyz_coarse, cfg.radius[level],
                            cfg.nn_uplimit[level],
                            window=cfg.pool_window(level),
                            use_kernels=use_kernels,
                            query_shard=tiles(nxt_sh),
                        )
                        net, inter, h_ok = shard_inputs(
                            net, inter, xyz, pts, cur_sh, nxt_sh,
                            cfg.halo_scale)
                        dense_ok = dense_ok & inter.ok
                        halo_ok = halo_ok & h_ok
                        net = pool3d(net, inter, method=cfg.pool_method,
                                     use_kernels=use_kernels)
                        cur_sh = nxt_sh
                    else:
                        if cfg.spatial_sort:
                            # ascending order keeps the coarse cloud
                            # axis-sorted
                            sample_idx = sort_indices_small(sample_idx)
                        xyz_coarse = gather_points(xyz, sample_idx)
                        inter = gather_neighborhood(nbh, sample_idx)
                        net = pool3d(net, inter, method=cfg.pool_method,
                                     window=cfg.pool_window(level),
                                     use_kernels=use_kernels)
                xyz = xyz_coarse
                xyz_layers.append(xyz)

        # decoder (ref SPH3D_s3dis.py:87-105) over reversed copies
        radius_r = cfg.radius[::-1]
        nn_uplimit_r = cfg.nn_uplimit[::-1]
        xyz_layers = xyz_layers[::-1]
        encoder = encoder[::-1]
        for level in range(num_levels):
            xyz_coarse = xyz_layers[level]
            xyz_fine = xyz_layers[level + 1]
            fine_sh = sharded(xyz_fine.shape[1])
            # decoder edges search the SAMPLED cloud of the mirrored
            # encoder level: its calibrated decoder window applies
            dec_win = cfg.dec_window(num_levels - 1 - level)
            deconv = getattr(self, f"deconv{level + 1}")
            span = f"decoder{level + 1}"
            if cfg.dense_graph:
                with layer_span(span + ".graph"):
                    intra, inter = build_graph_deconv_dense(
                        xyz_coarse, xyz_fine, radius_r[level],
                        nn_uplimit_r[level], kernel=cfg.kernel,
                        window=dec_win,
                        need_dist=cfg.unpool_method == "weighted",
                        dec_margin=cfg.dec_margin,
                        growth_steps=cfg.growth_steps,
                        use_kernels=use_kernels,
                        intra_shard=tiles(cur_sh),
                        inter_shard=tiles(fine_sh),
                    )
                    intra, h_ok, halo = shard_intra(intra, xyz_coarse, pts,
                                                    cur_sh)
                dense_ok = dense_ok & intra.ok
                halo_ok = halo_ok & h_ok
                net = deconv(net, intra, use_kernels=use_kernels,
                             remat=cfg.remat_blocks, halo_rows=halo)
                with layer_span(span + ".unpool"):
                    net, inter, h_ok = shard_inputs(
                        net, inter, xyz_coarse, pts, cur_sh, fine_sh,
                        cfg.halo_scale)
                    dense_ok = dense_ok & inter.ok
                    halo_ok = halo_ok & h_ok
                    net = unpool3d(net, inter, method=cfg.unpool_method,
                                   use_kernels=use_kernels)
                cur_sh = fine_sh
            else:
                with layer_span(span + ".graph"):
                    intra, filt_idx, inter = build_graph_deconv(
                        xyz_coarse, xyz_fine, radius_r[level],
                        nn_uplimit_r[level], kernel=cfg.kernel)
                net = deconv(net, intra, filt_idx, window=dec_win,
                             use_kernels=use_kernels, remat=cfg.remat_blocks)
                with layer_span(span + ".unpool"):
                    net = unpool3d(net, inter, method=cfg.unpool_method,
                                   window=dec_win, use_kernels=use_kernels)
            net = torch.cat([net, encoder[level]], dim=-1)
        if self.include_input_skip:
            # mlp2 ++ the mlp1 features (ref SPH3D_shapenet.py:106-108)
            net = torch.cat([self.mlp2(net, sharded=cur_sh), encoder[-1]],
                            dim=-1)
        dense_ok, halo_ok = agree_certificates(dense_ok, halo_ok, pts)
        return net, dense_ok, halo_ok


class _SegModel(nn.Module):
    """The frame the segmentation models share: the shape check, the axis
    sort, the model's input features (:meth:`_features`), the backbone,
    an optional head on its features (the ShapeNet one-hot), the f32
    pointwise logits (no activation, no BN: the JAX layer's default
    dtype) and the unsort back to the caller's point order.

    After each forward, ``dense_ok`` holds that forward's window-coverage
    certificate (a bool tensor): True iff every dense graph provably
    covered all its in-range neighbors (at its grown radius, for the
    decoders' inter graphs); always True on the per-edge engine, which is
    exact for every cloud (``models.common.classic_clone`` re-runs a dense
    model there). ``halo_ok``: the halo certificate of a point-sharded
    forward (True otherwise)."""

    def __init__(self, config: SPH3DConfig, num_cls: int, in_columns: int,
                 in_channels: int, generator: torch.Generator | None = None,
                 include_input_skip: bool = False,
                 head_channels: int = 0) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        self.in_columns = in_columns
        self.backbone = SegEncoderDecoder(cfg, in_channels, generator,
                                          include_input_skip)
        self.logits = PointwiseConv3d(
            self.backbone.out_channels + head_channels, num_cls,
            with_bn=False, with_bias=cfg.with_bias, activation=False,
            generator=generator,
        )
        self.dense_ok: torch.Tensor | None = None
        self.halo_ok: torch.Tensor | None = None

    def _features(self, points: torch.Tensor) -> torch.Tensor:
        """The backbone's input features of the sorted (B, N, D) points."""
        raise NotImplementedError

    def _segment(self, points: torch.Tensor, use_kernels: bool | None,
                 generator: torch.Generator | None,
                 sample_noise: list[torch.Tensor] | None,
                 head=None) -> torch.Tensor:
        """``use_kernels``: None runs the CUDA kernels on a CUDA device and
        the plain versions on the CPU; False forces the plain versions
        (for comparing the two). ``generator`` draws the noise of IDS and
        random sampling (the models have no dropout), unless
        ``sample_noise`` holds each level's draws. ``head`` maps the
        backbone's features to the logits layer's input."""
        cfg = self.config
        if points.shape[1:] != (cfg.num_input, self.in_columns):
            raise ValueError(
                f"expected (B, {cfg.num_input}, {self.in_columns}) points, "
                f"got {tuple(points.shape)}")
        points = points.float()
        perm = rank = None
        if cfg.spatial_sort:
            with layer_span("sort"):
                perm, rank = spatial_sort(points, cfg.radius[0])
                points = permute_points(points, perm)
        net, self.dense_ok, self.halo_ok = self.backbone(
            self._features(points), points[..., 0:3], cfg,
            use_kernels=use_kernels, generator=generator,
            sample_noise=sample_noise)
        if head is not None:
            net = head(net)
        logits = self.logits(net)
        if net.shape[1] != points.shape[1]:
            # this point rank's rows: the whole cloud's logits
            logits = spatial.all_rows(logits, sharding_of(cfg))
        # back to the caller's point order; ``perm`` rides along so the
        # backward gathers instead of scattering
        return (logits if rank is None
                else permute_points(logits, rank, inv=perm))


class SPH3DSceneSeg(_SegModel):
    """Scene segmentation (S3DIS / ScanNet): (B, N, 9) points (xyz,
    block-relative xyz, rgb) -> (B, N, num_cls) f32 logits in the input
    point order. The input features are the xy-centered xyz and the
    columns 6: (ref SPH3D_s3dis.py:35-49). ``in_columns`` is the points'
    column count: the reference's records hold xyz and rgb alone (6
    columns, ``data.datasets.load_scene_blocks``), so its model reads the
    xyz alone, as JAX's does on them."""

    def __init__(self, config: SPH3DConfig,
                 generator: torch.Generator | None = None,
                 in_columns: int = _IN_COLUMNS) -> None:
        super().__init__(config, config.num_cls, in_columns,
                         3 + max(in_columns - 6, 0), generator)

    def _features(self, points: torch.Tensor) -> torch.Tensor:
        xyz = points[..., 0:3]
        if self.config.normalize:
            xyz = normalize_xy_center_z_floor(xyz)
        return torch.cat([xyz, points[..., 6:]], dim=-1)

    def forward(self, points: torch.Tensor,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        return self._segment(points, use_kernels, generator, sample_noise)


class SPH3DRueMonge(_SegModel):
    """Facade segmentation (RueMonge2014): (B, N, 9) points (xyz, normals,
    rgb) -> (B, N, num_cls) f32 logits. The input features are the
    mean-centered xyz and the columns 3: (normals and rgb), 9 channels
    (ref SPH3D_ruemonge2014.py:35-47)."""

    def __init__(self, config: SPH3DConfig,
                 generator: torch.Generator | None = None,
                 in_columns: int = _RUEMONGE_COLUMNS) -> None:
        super().__init__(config, config.num_cls, in_columns, in_columns,
                         generator)

    def _features(self, points: torch.Tensor) -> torch.Tensor:
        xyz = points[..., 0:3]
        if self.config.normalize:
            xyz = normalize_mean_center(xyz)
        return torch.cat([xyz, points[..., 3:]], dim=-1)

    def forward(self, points: torch.Tensor,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        return self._segment(points, use_kernels, generator, sample_noise)


class SPH3DShapeNet(_SegModel):
    """Per-category part segmentation (ref models/SPH3D_shapenet.py:33-113):
    raw (B, N, 3) xyz (unit-sphere normalized offline; ``cfg.normalize``
    is False) -> (B, N, num_cls) f32 logits, ``num_cls`` the category's
    part count. The backbone runs with the input skip and ``mlp2``."""

    def __init__(self, config: SPH3DConfig, num_cls: int,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(config, num_cls, 3, 3, generator,
                         include_input_skip=True)

    def _features(self, points: torch.Tensor) -> torch.Tensor:
        return (normalize_unit_sphere(points) if self.config.normalize
                else points)

    def forward(self, points: torch.Tensor,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        return self._segment(points, use_kernels, generator, sample_noise)


class SPH3DShapeNetOnehot(_SegModel):
    """All-category part segmentation (ref SPH3D_shapenet_onehot.py:
    110-114): (B, N, 3) xyz and the category ``cls_label`` (B,) ->
    (B, N, num_cls) f32 logits over the 50 global parts. The category's
    one-hot over ``NUM_SHAPENET_CATEGORIES``, in the features' dtype and
    tiled over the points, is concatenated before the logits (128 + 16 =
    144 channels at published widths). The input is not normalized."""

    def __init__(self, config: SPH3DConfig, num_cls: int = 50,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(config, num_cls, 3, 3, generator,
                         include_input_skip=True,
                         head_channels=NUM_SHAPENET_CATEGORIES)

    def _features(self, points: torch.Tensor) -> torch.Tensor:
        return points

    def forward(self, points: torch.Tensor, cls_label: torch.Tensor,
                use_kernels: bool | None = None,
                generator: torch.Generator | None = None,
                sample_noise: list[torch.Tensor] | None = None
                ) -> torch.Tensor:
        def head(net: torch.Tensor) -> torch.Tensor:
            onehot = torch.nn.functional.one_hot(
                cls_label.long(), NUM_SHAPENET_CATEGORIES).to(net.dtype)
            return torch.cat(
                [net, onehot[:, None, :].expand(-1, net.shape[1], -1)],
                dim=-1)

        return self._segment(points, use_kernels, generator, sample_noise,
                             head)


def _nll_points(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-logp[..., label] per point by a one-hot product (its gradient is
    elementwise: no scatter)."""
    onehot = torch.nn.functional.one_hot(labels.long(), logp.shape[-1])
    return -(logp * onehot).sum(dim=-1)


def segmentation_item_loss(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Per-item mean CE over the item's points, (B,), in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _nll_points(logp, labels).mean(dim=1)


def segmentation_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Plain mean CE over all points (ref SPH3D_ruemonge2014.py:116-123):
    point counts are fixed per item, so the mean of the per-item losses."""
    return segmentation_item_loss(logits, labels).mean()


def inner_masked_item_loss(logits: torch.Tensor, labels: torch.Tensor,
                           inner_label: torch.Tensor) -> torch.Tensor:
    """Per-item mean CE over the inner (non-context) points, (B,); an item
    with no inner point gives 0 (ref SPH3D_s3dis.py:116-133)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = _nll_points(logp, labels)
    inner = (inner_label > 0).to(nll.dtype)
    per_item_sum = (nll * inner).sum(dim=1)
    per_item_cnt = inner.sum(dim=1)
    return torch.where(per_item_cnt > 0,
                       per_item_sum / torch.clamp_min(per_item_cnt, 1.0),
                       0.0)


def inner_masked_segmentation_loss(logits: torch.Tensor,
                                   labels: torch.Tensor,
                                   inner_label: torch.Tensor) -> torch.Tensor:
    """The inner-masked per-item losses SUMMED over the batch (the
    reference accumulates them with ``+=``, ref SPH3D_s3dis.py:116-133)."""
    return inner_masked_item_loss(logits, labels, inner_label).sum()
