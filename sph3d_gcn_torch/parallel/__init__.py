"""Data parallelism and point-axis sharding over ``torch.distributed``
(counterpart of ``sph3d_gcn_tpu/parallel``: ``mesh.py``'s groups and
``spatial.py``'s halo exchange, whose functions are in
``parallel.spatial``)."""

from sph3d_gcn_torch.parallel.launch import RankPool, run_ranks
from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    PointGroup,
    active_group,
    active_points,
    close_data_parallel,
    current_group,
    data_parallel,
    draw_rows,
    init_data_parallel,
    is_primary,
    local_batch_size,
    pmean,
    process_shard_files,
    shard_batch,
    split_groups,
    spread,
    world_group,
)

__all__ = [
    "DataGroup",
    "PointGroup",
    "RankPool",
    "active_group",
    "active_points",
    "close_data_parallel",
    "current_group",
    "data_parallel",
    "draw_rows",
    "init_data_parallel",
    "is_primary",
    "local_batch_size",
    "pmean",
    "process_shard_files",
    "run_ranks",
    "shard_batch",
    "split_groups",
    "spread",
    "world_group",
]
