"""Data parallelism over ``torch.distributed`` (counterpart of
``sph3d_gcn_tpu/parallel``'s data-parallel half, ``mesh.py``; the point
sharding of its ``spatial.py`` is not ported yet)."""

from sph3d_gcn_torch.parallel.launch import run_ranks
from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    active_group,
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
    spread,
)

__all__ = [
    "DataGroup",
    "active_group",
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
    "spread",
]
