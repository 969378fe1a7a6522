"""SPH3D model families (counterparts of ``sph3d_gcn_tpu/models``)."""

from sph3d_gcn_torch.models.modelnet import SPH3DModelNet
from sph3d_gcn_torch.models.segmentation import SPH3DSceneSeg

__all__ = ["SPH3DModelNet", "SPH3DSceneSeg"]
