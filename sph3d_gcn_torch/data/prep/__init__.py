"""Offline data preparation (counterparts of ``sph3d_gcn_tpu/data/prep``,
the reference's MATLAB ``preprocesing/`` and ``io/make_tfrecord_*.py``):
grid-average voxelization and label transfer (``voxelize``), the scene
block cutter (``blocks``), a PLY reader (``ply``), and the per-dataset
steps of ModelNet40 (FPS on the caller's device), ScanNet, ShapeNet and
RueMonge2014. The ``cli.prepare_*`` entry points drive them. Host numpy,
but for ModelNet's sampling."""
