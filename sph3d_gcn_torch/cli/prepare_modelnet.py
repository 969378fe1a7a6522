"""ModelNet40 record preparation (counterpart of the JAX package's
``scripts/prepare_modelnet.py``, ref io/make_tfrecord_modelnet.py)::

    python -m sph3d_gcn_torch.cli.prepare_modelnet \\
        --data_path modelnet40_normal_resampled --store_folder DIR

Reads the ``modelnet40_normal_resampled`` layout (``<class>/<shape>.txt``
rows of x,y,z,nx,ny,nz; ``modelnet40_train.txt``, ``modelnet40_test.txt``
and ``modelnet40_shape_names.txt``), farthest-point samples each shape to
``--num_point`` points on the card (K1; ``--device cpu`` runs the plain
version, with the same indices), normalizes it to the unit sphere and
writes 1024-shape record chunks and ``train_files.txt`` /
``test_files.txt``: the records ``cli.train_modelnet`` reads.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True,
                        help="modelnet40_normal_resampled-style directory")
    parser.add_argument("--store_folder", required=True)
    parser.add_argument("--num_point", type=int, default=10000)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the FPS kernel) or 'cpu' (its plain "
                             "version)")
    return parser.parse_args(argv)


def main(argv=None) -> list[str]:
    """Returns the record files written, train then test."""
    args = parse_args(argv)
    from sph3d_gcn_torch.cli import resolve_device
    from sph3d_gcn_torch.data.prep.modelnet import make_modelnet_records

    device = resolve_device(args.device)
    written = []
    for filelist in ("modelnet40_train", "modelnet40_test"):
        written += make_modelnet_records(
            args.data_path, filelist, "modelnet40_shape_names",
            args.store_folder, num_point=args.num_point, device=device)
    return written


if __name__ == "__main__":
    main()
