"""Host-side data helpers (counterparts of ``sph3d_gcn_tpu/data``):
NumPy augmentations and synthetic clouds."""
