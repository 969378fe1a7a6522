"""Layer library (counterpart of ``sph3d_gcn_tpu/nn/layers.py``).

Reproduced behavioral details of the reference (utils/sph3gcn_util.py):
ELU activations; batch norm AFTER the activation, momentum 0.99 and
epsilon 1e-3, statistics and affine parameters in f32; Xavier/Glorot
uniform weights; parameter names ``depthwise_weights``, ``weights``,
``biases`` as the reference scopes them. ``dtype`` is the compute
dtype (parameters stay f32); matmuls accumulate in f32 and round once.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from sph3d_gcn_torch.ops.conv import depthwise_conv3d, einsum_f32
from sph3d_gcn_torch.ops.dense import (
    WEIGHT_EPS,
    DenseNeighborhood,
    dense_avg_pool3d,
    dense_depthwise_conv3d,
    dense_max_pool3d,
    dense_mean_interpolate,
    dense_weighted_interpolate,
)
from sph3d_gcn_torch.ops.pool import avg_pool3d, max_pool3d
from sph3d_gcn_torch.ops.types import Neighborhood
from sph3d_gcn_torch.ops.unpool import mean_interpolate, weighted_interpolate
from sph3d_gcn_torch.ops.windowed import EdgeLists
from sph3d_gcn_torch.parallel.mesh import (
    active_group,
    active_points,
    draw_rows,
    pmean,
    spread,
)


_STATS = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside this context (on this thread) every :class:`BatchNorm` in
    train mode normalises with its batch statistics but leaves its running
    statistics as they are: the recompute pass of a rematerialised block,
    whose forward already updated them once."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


def glorot_uniform(shape: tuple[int, ...],
                   generator: torch.Generator | None) -> nn.Parameter:
    """Xavier/Glorot uniform with flax's fan convention (receptive field =
    all but the last two dims)."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32)
    w.uniform_(-limit, limit, generator=generator)
    return nn.Parameter(w)


class BatchNorm(nn.Module):
    """TF-flavored batch norm with flax ``BatchNorm`` semantics:
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast once to
    the activation dtype. Eval mode reads the running statistics. Train
    mode (``self.training``) uses the batch statistics, reduced in f32
    over every axis but the last, with flax's fast biased variance
    ``max(0, mean(x^2) - mean^2)``, and updates the running statistics as
    ``momentum * running + (1 - momentum) * batch`` (momentum 0.99, eps
    1e-3; not ``F.batch_norm``, which keeps the unbiased variance and
    reads its momentum as ``1 - m``), except under
    :func:`frozen_running_stats`. Under ``parallel.data_parallel`` the
    per-channel means of x and x^2 are averaged over the group's ranks
    (``parallel.pmean``, whose backward averages the cotangent): every
    rank holds the same local batch size, so these are the global batch's
    statistics, and every rank's running statistics move alike. A layer
    on a point-sharded input (``sharded``) averages them over the point
    group too (JAX's ``_bn_axes``): each point rank holds as many rows
    of the same items."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 epsilon: float = 1e-3) -> None:
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, sharded: bool = False
                ) -> torch.Tensor:
        xf = x.float()
        if self.training:
            red = tuple(range(x.dim() - 1))
            mean, sq = xf.mean(dim=red), (xf * xf).mean(dim=red)
            groups = [active_group()]
            if sharded:
                groups.insert(0, active_points())
            moments = None
            for group in groups:
                if spread(group):
                    moments = pmean(torch.stack([mean, sq])
                                    if moments is None else moments, group)
            if moments is not None:
                mean, sq = moments.unbind(0)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            if not getattr(_STATS, "frozen", False):
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): in train mode each element
    is kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    its mask drawn from an explicit ``torch.Generator`` (on the tensor's
    device; None takes PyTorch's default generator; under
    ``parallel.data_parallel`` this rank's rows of the global batch's
    mask); the identity in eval mode or at rate 0."""

    def __init__(self, rate: float = 0.5) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = draw_rows(lambda shape: torch.rand(
            shape, generator=generator, device=x.device), x.shape)
        return torch.where(mask < keep, x / keep, torch.zeros_like(x))


# parameter names the reference's L2 weight decay collects: conv/FC kernels
# and BN beta/gamma, not the layers' ``biases``
_L2_NAMES = ("weights", "depthwise_weights", "scale", "bias")


def l2_regularization(model: nn.Module) -> torch.Tensor:
    """Sum of TF-style ``l2_loss`` (``sum(p^2) / 2``) over the regularized
    parameters (``sph3d_gcn_tpu/nn/layers.py:383-396``)."""
    return sum(0.5 * (p * p).sum() for name, p in model.named_parameters()
               if name.rsplit(".", 1)[-1] in _L2_NAMES)


class _Dense(nn.Module):
    """Shared tail of the conv/FC layers: optional bias, ELU, BN."""

    def __init__(self, num_out: int, with_bn: bool, with_bias: bool,
                 activation: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.activation = activation
        if with_bias:
            self.biases = nn.Parameter(torch.zeros(num_out))
        else:
            self.biases = None
        self.bn = BatchNorm(num_out) if with_bn else None

    def _tail(self, out: torch.Tensor, sharded: bool = False
              ) -> torch.Tensor:
        if self.biases is not None:
            out = out + self.biases.to(out.dtype)
        if self.activation:
            out = F.elu(out)
        if self.bn is not None:
            out = self.bn(out, sharded)
        return out


class SeparableConv3d(_Dense):
    """Depthwise spherical graph conv -> pointwise GEMM -> ELU -> BN
    (ref utils/sph3gcn_util.py:88-163)."""

    def __init__(self, in_channels: int, num_out_channels: int,
                 bin_size: int, depth_multiplier: int, with_bn: bool = False,
                 with_bias: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(num_out_channels, with_bn, with_bias, True, dtype)
        self.depthwise_weights = glorot_uniform(
            (bin_size, in_channels, depth_multiplier), generator
        )
        self.weights = glorot_uniform(
            (in_channels * depth_multiplier, num_out_channels), generator
        )

    def forward(
        self,
        inputs: torch.Tensor,
        nbh: DenseNeighborhood | Neighborhood,
        filt_index: torch.Tensor | None = None,
        window: int | None = None,
        lists: EdgeLists | None = None,
        use_kernels: bool | None = None,
        halo_rows: int | None = None,
    ) -> torch.Tensor:
        """``nbh`` a dense graph (bins in its maps), or an edge-list graph
        with its ``filt_index`` bins, the per-edge engine's ``window``
        (None: the plain gather) and the gather's shared ``lists``.
        ``halo_rows`` (point sharding): ``inputs`` are this point rank's
        rows and ``nbh`` its tiles with windows rebased for a halo of that
        many rows a side; the conv exchanges the halo of its own input
        (``parallel.spatial.halo_exchange``, so stacked convs hand each
        other local rows) and its BN averages over the point group."""
        inputs = inputs.to(self.dtype)
        if halo_rows is not None:
            from sph3d_gcn_torch.parallel.spatial import halo_exchange

            inputs = halo_exchange(inputs, halo_rows, active_points())
        if isinstance(nbh, DenseNeighborhood):
            # bins live in the packed maps; the pointwise GEMM is folded in
            out = dense_depthwise_conv3d(
                inputs, self.depthwise_weights, nbh, pointwise=self.weights,
                use_kernels=use_kernels,
            )
        else:
            out = depthwise_conv3d(
                inputs, self.depthwise_weights, nbh.idx, nbh.count,
                filt_index, window=window, lists=lists,
                use_kernels=use_kernels,
            )
            out = einsum_f32(
                "bmc,co->bmo", out, self.weights.to(self.dtype)
            ).to(self.dtype)
        return self._tail(out, halo_rows is not None)


class PointwiseConv3d(_Dense):
    """1x1 conv as a flattened matmul (ref utils/sph3gcn_util.py:166-222);
    ``activation=False`` drops the ELU (a classifier layer)."""

    def __init__(self, in_channels: int, num_out_channels: int,
                 with_bn: bool = False, with_bias: bool = False,
                 activation: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(num_out_channels, with_bn, with_bias, activation,
                         dtype)
        self.weights = glorot_uniform(
            (in_channels, num_out_channels), generator
        )

    def forward(self, inputs: torch.Tensor, sharded: bool = False
                ) -> torch.Tensor:
        """``sharded``: ``inputs`` are this point rank's rows (BN averages
        over the point group)."""
        out = einsum_f32(
            "bmc,co->bmo", inputs.to(self.dtype), self.weights.to(self.dtype)
        ).to(self.dtype)
        return self._tail(out, sharded)


class FullyConnected(_Dense):
    """Dense layer on (B, C) (ref utils/sph3gcn_util.py:225-273)."""

    def __init__(self, in_channels: int, num_out_channels: int,
                 with_bn: bool = False, with_bias: bool = False,
                 activation: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(num_out_channels, with_bn, with_bias, activation,
                         dtype)
        self.weights = glorot_uniform(
            (in_channels, num_out_channels), generator
        )

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        out = einsum_f32(
            "bc,co->bo", inputs.to(self.dtype), self.weights.to(self.dtype)
        ).to(self.dtype)
        return self._tail(out)


def pool3d(
    inputs: torch.Tensor,
    nbh: DenseNeighborhood | Neighborhood,
    method: str = "max",
    window: int | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Pooling dispatch (ref utils/sph3gcn_util.py:276-297): max or average
    pooling from a dense graph or an edge-list graph (``window``: the
    per-edge engine's gather; None: the plain gather)."""
    if method not in ("max", "avg"):
        raise ValueError(f"Unknown pooling method {method!r}")
    if isinstance(nbh, DenseNeighborhood):
        if method == "avg":
            return dense_avg_pool3d(inputs, nbh, use_kernels=use_kernels)
        out, _ = dense_max_pool3d(inputs, nbh, with_index=False,
                                  use_kernels=use_kernels)
        return out
    if method == "avg":
        return avg_pool3d(inputs, nbh.idx, nbh.count, window=window,
                          use_kernels=use_kernels)
    out, _ = max_pool3d(inputs, nbh.idx, nbh.count, window=window,
                        use_kernels=use_kernels)
    return out


def unpool3d(inputs: torch.Tensor, nbh: DenseNeighborhood | Neighborhood,
             method: str = "mean", window: int | None = None,
             use_kernels: bool | None = None) -> torch.Tensor:
    """Unpooling dispatch (ref utils/sph3gcn_util.py:300-325): the masked
    mean of each fine point's coarse neighbors, or their weighted sum with
    the reference's distance-*proportional* weights ``(dist + 1e-7) /
    (sum_k dist + 1e-7)`` over the sqrt-space distances (ref :317-321).
    From a dense graph (built with ``need_dist`` for the weighted one) or
    an edge-list graph (``window``: the per-edge engine's gather; None: the
    plain gather)."""
    if method not in ("mean", "weighted"):
        raise ValueError(f"Unknown unpooling method {method!r}")
    if isinstance(nbh, DenseNeighborhood):
        if method == "weighted":
            return dense_weighted_interpolate(inputs, nbh,
                                              use_kernels=use_kernels)
        return dense_mean_interpolate(inputs, nbh, use_kernels=use_kernels)
    if method == "weighted":
        sum_dist = nbh.dist.sum(dim=-1, keepdim=True)
        weight = (nbh.dist + WEIGHT_EPS) / (sum_dist + WEIGHT_EPS)
        return weighted_interpolate(inputs, weight, nbh.idx, nbh.count,
                                    window=window, use_kernels=use_kernels)
    return mean_interpolate(inputs, nbh.idx, nbh.count, window=window,
                            use_kernels=use_kernels)
