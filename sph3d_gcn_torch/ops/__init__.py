"""Point-cloud operators: locality sort, FPS, the dense windowed query,
conv and pool, and the classic ops of the global conv; the sphere and
cube queries are exported here, as the JAX package's ``ops`` exports
them."""

from sph3d_gcn_torch.ops.neighbor import (
    build_cube_neighbor,
    build_sphere_neighbor,
)
from sph3d_gcn_torch.ops.types import CubeNeighborhood, Neighborhood

__all__ = [
    "CubeNeighborhood",
    "Neighborhood",
    "build_cube_neighbor",
    "build_sphere_neighbor",
]
