"""Data preparation (counterparts of ``sph3d_gcn_tpu/data/prep``): the
pieces the evaluation entry points read. The nearest-neighbour label
transfer (``voxelize.knn_transfer``), ScanNet's label maps and the
ShapeNet record reader; the writers and the scene preparation are not
ported yet."""
