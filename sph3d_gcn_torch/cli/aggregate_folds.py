"""Aggregate per-fold scene-segmentation counts into the overall OA, mAcc
and mIoU (counterpart of the JAX package's ``scripts/aggregate_folds.py``,
ref post-merging/s3dis_merge_6Areas.m:15-45)::

    python -m sph3d_gcn_torch.cli.aggregate_folds \\
        log_area1/Area_1_metric.npz ... log_area6/Area_6_metric.npz

Each fold's ``cli.evaluate_scene_seg --scene_dir`` run saves its raw
intersect / union / seen counts to ``<log_dir>/Area_<k>_metric.npz``
(the same fields as the JAX package's, so either side's files load);
this sums them and prints each fold and the total. Any fold count and
any scene dataset. Host numpy only: it runs no model.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def aggregate(paths: list[str]):
    """The folds' ``SceneAccumulator`` counts summed (each fold's line
    printed)."""
    from sph3d_gcn_torch.data.merge import SceneAccumulator

    folds = [SceneAccumulator.load(p) for p in paths]
    total = SceneAccumulator(num_cls=folds[0].num_cls)
    for path, fold in zip(paths, folds):
        total.merge(fold)
        print(f"{os.path.basename(path)}: OA {fold.overall_accuracy * 100:.2f}"
              f"% mAcc {fold.mean_acc * 100:.2f}% mIoU "
              f"{fold.mean_iou * 100:.2f}%")
    return total


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("metric_files", nargs="+",
                        help="per-fold *_metric.npz files")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the summed ``SceneAccumulator``."""
    args = parse_args(argv)
    total = aggregate(args.metric_files)
    print("================== all-fold aggregate ==================")
    print(f"OA: {total.overall_accuracy * 100:.2f}%, "
          f"mAcc: {total.mean_acc * 100:.2f}%, "
          f"mIoU: {total.mean_iou * 100:.2f}%")
    print("class_iou:", np.array2string(total.class_iou, precision=4))
    print("class_acc:", np.array2string(total.class_acc, precision=4))
    return total


if __name__ == "__main__":
    main()
