"""Immutable model configuration (counterpart of
``sph3d_gcn_tpu/configs/base.py``).

The fields the port's models read, under the JAX config's names, order
and defaults; ``tests/test_torch_configs_data.py`` holds every field and
window of the port's ``modelnet_config``, ``s3dis_config`` and
``scannet_config`` equal to the JAX package's, and a config snapshot of
either package loads in the other (``train.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class SPH3DConfig:
    """Architecture config of the SPH3D model families (field names of the
    reference config modules)."""

    num_input: int
    num_cls: int
    mlp: int
    num_sample: tuple[int, ...]
    radius: tuple[float, ...]
    nn_uplimit: tuple[int, ...]
    channels: tuple[tuple[int, ...], ...]
    multiplier: tuple[tuple[int, ...], ...]
    weight_decay: float | None
    kernel: tuple[int, int, int] = (8, 2, 2)
    normalize: bool = True
    pool_method: Literal["max", "avg"] = "max"
    unpool_method: Literal["mean", "weighted"] = "mean"
    # the reference's neighbor search (ref config nnsearch); as in JAX,
    # every model builds sphere graphs and none reads it
    nnsearch: Literal["sphere", "cube"] = "sphere"
    sample: Literal["FPS", "IDS", "random"] = "FPS"
    use_raw: bool = False
    with_bn: bool = True
    with_bias: bool = False
    # classification-only global-layer settings (ref modelnet_config.py:21-23)
    global_channels: int | None = None
    global_multiplier: int | None = None
    # 'float32' (reference parity) or 'bfloat16' (fast mode; graph
    # construction and BN statistics stay f32 either way)
    compute_dtype: str = "float32"
    # sort each input cloud along a per-cloud spatial axis, so that the
    # neighbors of a 128-query tile lie in a narrow window of rows
    spatial_sort: bool = False
    # per-encoder-level row-window widths of the dense engine
    windows: tuple[int, ...] | None = None
    # recompute each conv block's activations in the backward
    # (``torch.utils.checkpoint``): activation memory for conv FLOPs
    remat_blocks: bool = False
    # calibrated per-level decoder-graph windows (rows over the SAMPLED
    # cloud of each level); None scales ``windows`` by the sampling ratio
    dec_windows: tuple[int, ...] | None = None
    # decoder-inter window headroom (rows beyond dec_window) for the
    # +0.05-grown radii, and the most growth steps reproduced in-window
    # (ref tf_nnquery_gpu.cu:30-60; rows needing more flip dense_ok)
    dec_margin: int = 384
    growth_steps: int = 12
    # dense windowed engine (ops/dense.py): level graphs as (tile x
    # window) maps, exactness certified per graph (dense_ok)
    dense_graph: bool = False
    # point-axis sharding (parallel/spatial.py): the models split each
    # shardable level's rows over the point group of the enclosing
    # ``parallel.data_parallel`` with halo exchanges, build only their
    # own query tiles, run the coarse tail and the heads replicated and
    # gather the logits, so the model's contract is unchanged. The value
    # names the axis, as JAX's mesh axis ('points' from the CLIs).
    # Requires dense_graph.
    point_axis: str | None = None
    # the batch axis of a composed data x points run (JAX's 'data'): set
    # with point_axis by the CLIs; the port's BN syncs over the data group
    # whenever one is active, so nothing reads it but the snapshot
    data_axis: str | None = None
    # width multiplier of the INTER-level (pool / unpool) halos under
    # point sharding: intra-level halos provably suffice at 1x, while
    # inter-level windows live in the other cloud's rows, where a skewed
    # cloud can breach 1x (halo_ok False); fit() re-runs such batches at
    # 2x (``train.steps.StepFactory.halo_widened``) before the classic
    # engine
    halo_scale: int = 1

    def enc_window(self, level: int) -> int | None:
        """Row window for encoder level ``level`` (cloud size N_level)."""
        return None if self.windows is None else self.windows[level]

    def pool_window(self, level: int) -> int | None:
        """Row window for the pooling edges of ``level``: a 128-row tile
        of sampled points spans ~128 * N/S rows of the fine cloud, so the
        window needs that much room beyond the conv window."""
        w = self.enc_window(level)
        if w is None:
            return None
        n_l = self.num_input if level == 0 else self.num_sample[level - 1]
        s_l = self.num_sample[level]
        extra = 128 * (-(-n_l // s_l) - 1)
        return w + (-(-extra // 128) * 128 if extra else 0)

    def dec_window(self, level: int) -> int | None:
        """Row window for the decoder pass of original level ``level``:
        the calibrated ``dec_windows`` entry, else the encoder window
        scaled by the subsampling ratio (decoder edges search the SAMPLED
        cloud)."""
        if self.windows is None:
            return None
        if self.dec_windows is not None:
            return self.dec_windows[level]
        n_l = self.num_input if level == 0 else self.num_sample[level - 1]
        s_l = self.num_sample[level]
        w = -(-self.windows[level] * s_l // n_l)
        return -(-w // 128) * 128

    @property
    def bin_size(self) -> int:
        """n*p*q + 1, bin 0 reserved for the self-loop
        (ref modelnet_config.py:27-28)."""
        return int(math.prod(self.kernel)) + 1

    def __post_init__(self) -> None:
        num_levels = len(self.num_sample)
        if self.dense_graph and (self.windows is None or not self.spatial_sort):
            raise ValueError(
                "dense_graph requires spatial_sort=True and per-level windows"
            )
        if self.point_axis is not None and not self.dense_graph:
            raise ValueError(
                "point_axis sharding requires the dense windowed engine "
                "(dense_graph=True)"
            )
        if self.windows is not None and len(self.windows) != num_levels:
            raise ValueError(
                f"windows must have {num_levels} entries, got "
                f"{len(self.windows)}"
            )
        if (
            self.dec_windows is not None
            and len(self.dec_windows) != num_levels
        ):
            raise ValueError(
                f"dec_windows must have {num_levels} entries, got "
                f"{len(self.dec_windows)}"
            )
        for field in ("radius", "nn_uplimit", "channels", "multiplier"):
            if len(getattr(self, field)) != num_levels:
                raise ValueError(
                    f"{field} must have {num_levels} entries (one per level), "
                    f"got {len(getattr(self, field))}"
                )
        if len(self.kernel) != 3 or any(k < 1 for k in self.kernel):
            raise ValueError(
                f"kernel must be three positive ints (n, p, q), got "
                f"{self.kernel!r}"
            )
        if self.sample not in ("FPS", "IDS", "random"):
            raise ValueError(
                f"Unknown sampling method: {self.sample!r} "
                "(expected 'FPS', 'IDS' or 'random')"
            )
