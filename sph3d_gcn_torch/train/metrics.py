"""Evaluation metrics: overall and per-class accuracy, IoU (counterpart
of ``sph3d_gcn_tpu/train/metrics.py``; NumPy on the host).

Conventions of the reference eval scripts:
- per-class accuracy averages only over classes seen in the eval set
  (ref modelnet40_cls/evaluate_modelnet.py:204-218);
- ShapeNet per-shape IoU uses the union==0 -> IoU=1 rule
  (ref shapenet_seg/evaluate_shapenet.py:276-289);
- scene-level OA/mAcc/mIoU accumulate confusion counts like
  post-merging/s3dis_merge.m:77-99.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(
    pred: np.ndarray, label: np.ndarray, num_cls: int
) -> np.ndarray:
    """(num_cls, num_cls) counts, rows = ground truth, cols = prediction;
    labels outside [0, num_cls) are left out."""
    pred = np.asarray(pred).ravel()
    label = np.asarray(label).ravel()
    mask = (label >= 0) & (label < num_cls)
    idx = label[mask].astype(np.int64) * num_cls + pred[mask].astype(np.int64)
    return np.bincount(idx, minlength=num_cls * num_cls).reshape(
        num_cls, num_cls
    )


def overall_accuracy(cm: np.ndarray) -> float:
    total = cm.sum()
    return float(np.trace(cm) / total) if total else 0.0


def per_class_accuracy(cm: np.ndarray) -> np.ndarray:
    """Recall per class; NaN for classes with no ground-truth points."""
    seen = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(seen > 0, np.diag(cm) / seen, np.nan)


def mean_class_accuracy(cm: np.ndarray) -> float:
    return float(np.nanmean(per_class_accuracy(cm)))


def per_class_iou(cm: np.ndarray) -> np.ndarray:
    """IoU per class; NaN where the union is empty."""
    tp = np.diag(cm).astype(np.float64)
    union = cm.sum(axis=0) + cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, tp / union, np.nan)


def mean_iou(cm: np.ndarray) -> float:
    return float(np.nanmean(per_class_iou(cm)))


def shape_iou(
    pred: np.ndarray, label: np.ndarray, part_ids: np.ndarray
) -> float:
    """Mean IoU over ``part_ids`` for ONE shape, with the reference's
    union==0 -> IoU=1 rule (ref evaluate_shapenet.py:276-289)."""
    ious = []
    for part in part_ids:
        inter = np.sum((pred == part) & (label == part))
        union = np.sum((pred == part) | (label == part))
        ious.append(1.0 if union == 0 else inter / union)
    return float(np.mean(ious))
