"""Shared model components (counterpart of
``sph3d_gcn_tpu/models/common.py``)."""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sph3d_gcn_torch.configs.base import SPH3DConfig
from sph3d_gcn_torch.nn.layers import SeparableConv3d, frozen_running_stats
from sph3d_gcn_torch.ops.dense import DenseNeighborhood
from sph3d_gcn_torch.ops.query import TILE
from sph3d_gcn_torch.ops.types import Neighborhood
from sph3d_gcn_torch.ops.windowed import EdgeLists
from sph3d_gcn_torch.parallel import spatial
from sph3d_gcn_torch.parallel.mesh import (
    PointGroup,
    active_group,
    active_points,
    data_parallel,
)


def compute_dtype(cfg: SPH3DConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype`` ('float32' | 'bfloat16')."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def config_clone(model: nn.Module, **changes) -> nn.Module:
    """The model on the SAME parameters and buffers with its config's
    ``changes`` (flax's ``model.clone(config=...)``): the clone shares
    the submodules, so an update through either changes both; only
    ``config`` and the per-forward attributes (``dense_ok``) are its
    own."""
    clone = copy.copy(model)      # shares _parameters, _buffers, _modules
    clone.config = dataclasses.replace(model.config, **changes)
    return clone


def classic_clone(model: nn.Module) -> nn.Module:
    """The model on the SAME parameters and buffers with the dense engine
    off (``dense_graph=False``): the per-edge engine, exact for every
    cloud (counterpart of flax's ``model.clone(config=...)`` in
    ``StepFactory.classic_fallback``). The clone shares the submodules, so
    an update through either changes both; only ``config`` and the
    per-forward attributes (``dense_ok``) are its own (a model whose
    submodules read the config takes it from the model's forward, as the
    scene models' backbone does). The per-edge engine has no point
    sharding: the clone runs each rank's cloud whole (``point_axis`` and
    ``data_axis`` None, as JAX's ``classic_fallback``). A model already on
    the per-edge engine is returned as it is."""
    if not model.config.dense_graph:
        return model
    return config_clone(model, dense_graph=False, point_axis=None,
                        data_axis=None)


def halo_clone(model: nn.Module, scale: int = 2) -> nn.Module:
    """The point-sharded model on the same parameters with its inter-level
    halos ``scale`` times wider (``halo_scale``; JAX's
    ``StepFactory.halo_widened``): the first re-run of a batch whose only
    breach was a halo, which stays sharded. A model without point
    sharding is returned as it is."""
    if model.config.point_axis is None:
        return model
    return config_clone(model,
                        halo_scale=max(model.config.halo_scale, 1) * scale)


def normalize_unit_sphere(points: torch.Tensor) -> torch.Tensor:
    """Center and scale each cloud into the unit sphere
    (ref models/SPH3D_modelnet.py:11-17), guarded against all-identical
    clouds."""
    points = points - points.mean(dim=1, keepdim=True)
    scale = (points * points).sum(dim=-1, keepdim=True).amax(
        dim=1, keepdim=True
    )
    return points / torch.sqrt(torch.clamp_min(scale, 1e-12))


def normalize_xy_center_z_floor(points: torch.Tensor) -> torch.Tensor:
    """Center xy at the bounding-box center, keep z as it is
    (ref models/SPH3D_s3dis.py:11-19, identical in SPH3D_scannet.py)."""
    center = (points.amax(dim=1, keepdim=True)
              + points.amin(dim=1, keepdim=True)) / 2
    return torch.cat([points[..., 0:2] - center[..., 0:2],
                      points[..., 2:]], dim=-1)


def normalize_mean_center(points: torch.Tensor) -> torch.Tensor:
    """Subtract each cloud's mean (ref models/SPH3D_ruemonge2014.py:11-17)."""
    return points - points.mean(dim=1, keepdim=True)


def _remat_contexts():
    """The forward runs as it is; the backward's recompute (on autograd's
    thread) leaves the BN running statistics that the forward updated,
    under the forward's data-parallel and point groups."""
    return contextlib.nullcontext(), _recompute(active_group(),
                                                active_points())


@contextlib.contextmanager
def _recompute(group, points):
    with frozen_running_stats(), data_parallel(group, points):
        yield


class SeparableConvBlock(nn.Module):
    """A stack of separable convs sharing one neighborhood, named ``_1,
    _2, ...`` as the reference scopes them (ref SPH3D_modelnet.py:20-30).
    With ``remat`` (the config's ``remat_blocks``) each conv, BN included,
    keeps no activations for the backward and runs again there
    (``torch.utils.checkpoint``, as JAX's ``nn.remat``); the recompute
    does not move the BN running statistics a second time, so gradients
    and statistics equal the step without it. ``halo_rows`` (point
    sharding): ``net`` holds this point rank's rows and every conv of the
    stack exchanges that halo of its input (``nn.layers.SeparableConv3d``)."""

    def __init__(self, in_channels: int, list_channels: tuple[int, ...],
                 bin_size: int, depth_multiplier: tuple[int, ...],
                 with_bn: bool, with_bias: bool, dtype: torch.dtype,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        c = in_channels
        for i, num_out in enumerate(list_channels):
            self.add_module(f"_{i + 1}", SeparableConv3d(
                c, num_out, bin_size, depth_multiplier[i], with_bn=with_bn,
                with_bias=with_bias, dtype=dtype, generator=generator,
            ))
            c = num_out

    def forward(self, net: torch.Tensor,
                nbh: DenseNeighborhood | Neighborhood,
                filt_index: torch.Tensor | None = None,
                window: int | None = None,
                use_kernels: bool | None = None,
                remat: bool = False,
                halo_rows: int | None = None) -> torch.Tensor:
        lists = None
        if isinstance(nbh, Neighborhood) and window is not None:
            # the convs gather through one neighborhood: one set of
            # inverse edge lists for all their backwards
            lists = EdgeLists(nbh.idx, nbh.count)
        remat = remat and torch.is_grad_enabled()
        for conv in self.children():
            kw = dict(window=window, lists=lists, use_kernels=use_kernels,
                      halo_rows=halo_rows)
            if remat:
                net = checkpoint(conv, net, nbh, filt_index, **kw,
                                 use_reentrant=False,
                                 context_fn=_remat_contexts,
                                 preserve_rng_state=False)
            else:
                net = conv(net, nbh, filt_index, **kw)
        return net


def sharding_of(cfg: SPH3DConfig) -> PointGroup | None:
    """The point group a forward of ``cfg`` shards over: the enclosing
    ``parallel.data_parallel``'s when ``cfg.point_axis`` is set (which
    raises without one), else None."""
    if cfg.point_axis is None:
        return None
    pts = active_points()
    if pts is None:
        raise ValueError(
            f"point_axis={cfg.point_axis!r} needs a point group: run the "
            "forward under parallel.data_parallel(group, points)")
    return pts


def shard_intra(nbh, xyz, pts, sharded):
    """An intra-level graph built on this rank's tiles (``sharded``),
    rebased for a halo of one window: (graph, halo certificate, halo
    rows for the convs); unsharded (graph, True, None)."""
    if not sharded:
        return nbh, torch.ones((), dtype=torch.bool,
                               device=xyz.device), None
    halo_b = nbh.window // TILE
    nbh, h_ok = spatial.local_neighborhood(
        nbh, pts.rank, halo_b, (xyz.shape[1] // TILE) // pts.size)
    return nbh, h_ok, halo_b * TILE


def shard_inputs(net, inter, xyz_db, pts, db_sh, q_sh, halo_scale):
    """The rows an inter-level op (pool, unpool) reads, and its graph,
    under point sharding: with its database rows (of ``xyz_db``) and its
    query tiles both sharded, ``net`` haloed by ``halo_scale`` windows and
    the graph rebased (its certificate folded in); with the database
    rows alone sharded, every rank's rows gathered; otherwise as they
    are (query tiles from a sharded build read whole rows). Returns (rows,
    graph, halo certificate)."""
    ok = torch.ones((), dtype=torch.bool, device=xyz_db.device)
    if db_sh and q_sh:
        halo_b = (inter.window // TILE) * halo_scale
        inter, ok = spatial.local_neighborhood(
            inter, pts.rank, halo_b, (xyz_db.shape[1] // TILE) // pts.size)
        net = spatial.halo_exchange(net, halo_b * TILE, pts)
    elif db_sh:
        net = spatial.all_rows(net, pts)
    return net, inter, ok


def agree_certificates(dense_ok, halo_ok, pts):
    """The forward's certificates, each held on every point rank (one
    all-reduce of the failures over the group; JAX's ``pmin``)."""
    if pts is None or pts.size == 1:
        return dense_ok, halo_ok
    failed = torch.stack([~dense_ok, ~halo_ok]).to(torch.float32)
    pts.all_reduce_(failed)
    return failed[0] == 0, failed[1] == 0
