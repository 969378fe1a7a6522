"""SPH3D model families (counterparts of ``sph3d_gcn_tpu/models``)."""

from sph3d_gcn_torch.models.modelnet import SPH3DModelNet
from sph3d_gcn_torch.models.segmentation import (
    SPH3DRueMonge,
    SPH3DSceneSeg,
    SPH3DShapeNet,
    SPH3DShapeNetOnehot,
)

__all__ = ["SPH3DModelNet", "SPH3DRueMonge", "SPH3DSceneSeg",
           "SPH3DShapeNet", "SPH3DShapeNetOnehot"]
