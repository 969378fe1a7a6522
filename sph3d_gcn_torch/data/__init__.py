"""Host-side data helpers (counterparts of ``sph3d_gcn_tpu/data``):
TFRecord files, dataset pipelines, NumPy augmentations and synthetic
clouds."""
