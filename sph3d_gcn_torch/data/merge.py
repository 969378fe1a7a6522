"""Block -> scene merging and the scene metrics (counterpart of
``sph3d_gcn_tpu/data/merge.py``, which replaces the reference's MATLAB
``post-merging/`` step). Host numpy only: the merge reads the blocks'
accumulated logits, never the device.

Per scene (ref post-merging/s3dis_merge.m:40-99):
  1. For each evaluated block, take the inner points' accumulated logits,
     L2-normalize each row, softmax to probabilities (ref :45-47).
  2. Scatter-add the probabilities onto the voxelized scene cloud via the
     stored block->scene ``index`` (ref :49-56), argmax for voxel labels.
  3. knn-project voxel labels onto the full-resolution cloud (ref :73-76).
  4. Accumulate intersect/union/seen + overall correct counts (ref :77-99).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sph3d_gcn_torch.data.prep.voxelize import knn_transfer


@dataclasses.dataclass
class SceneAccumulator:
    """Running totals across scenes (ref s3dis_merge.m:20-25, 85-99)."""

    num_cls: int
    total_intersect: np.ndarray = None
    total_union: np.ndarray = None
    total_seen: np.ndarray = None
    merged_correct: int = 0
    merged_seen: int = 0

    def __post_init__(self):
        z = np.zeros(self.num_cls, np.int64)
        if self.total_intersect is None:
            self.total_intersect = z.copy()
        if self.total_union is None:
            self.total_union = z.copy()
        if self.total_seen is None:
            self.total_seen = z.copy()

    def add_scene(self, pred_label: np.ndarray, gt_label: np.ndarray) -> None:
        for c in range(self.num_cls):
            p = pred_label == c
            g = gt_label == c
            self.total_intersect[c] += int(np.sum(p & g))
            self.total_union[c] += int(np.sum(p | g))
            self.total_seen[c] += int(np.sum(g))
        self.merged_correct += int(np.sum(pred_label == gt_label))
        self.merged_seen += int(len(pred_label))

    @property
    def overall_accuracy(self) -> float:
        return self.merged_correct / (self.merged_seen + np.finfo(float).eps)

    @property
    def class_iou(self) -> np.ndarray:
        return self.total_intersect / (self.total_union + np.finfo(float).eps)

    @property
    def class_acc(self) -> np.ndarray:
        return self.total_intersect / (self.total_seen + np.finfo(float).eps)

    @property
    def mean_iou(self) -> float:
        return float(np.mean(self.class_iou))

    @property
    def mean_acc(self) -> float:
        return float(np.mean(self.class_acc))

    def save(self, path: str) -> None:
        """Persist the raw counts (the ref saves Area_*_metric.mat with the
        same five fields for 6-fold aggregation, s3dis_merge.m:96-99)."""
        np.savez(
            path,
            total_intersect=self.total_intersect,
            total_union=self.total_union,
            total_seen=self.total_seen,
            merged_correct=self.merged_correct,
            merged_seen=self.merged_seen,
        )

    @classmethod
    def load(cls, path: str) -> "SceneAccumulator":
        data = np.load(path)
        return cls(
            num_cls=len(data["total_intersect"]),
            total_intersect=data["total_intersect"].astype(np.int64),
            total_union=data["total_union"].astype(np.int64),
            total_seen=data["total_seen"].astype(np.int64),
            merged_correct=int(data["merged_correct"]),
            merged_seen=int(data["merged_seen"]),
        )

    def merge(self, other: "SceneAccumulator") -> None:
        """Accumulate another fold's counts
        (ref post-merging/s3dis_merge_6Areas.m:15-25)."""
        if other.num_cls != self.num_cls:
            raise ValueError(
                f"class count mismatch: {other.num_cls} vs {self.num_cls}"
            )
        self.total_intersect += other.total_intersect
        self.total_union += other.total_union
        self.total_seen += other.total_seen
        self.merged_correct += other.merged_correct
        self.merged_seen += other.merged_seen


def normalized_confidence(logits: np.ndarray) -> np.ndarray:
    """L2-normalize logit rows then softmax (ref s3dis_merge.m:45-47)."""
    logits = np.asarray(logits, np.float64)
    norm = np.sqrt(np.sum(logits**2, axis=1, keepdims=True))
    logits = logits / np.maximum(norm, np.finfo(float).tiny)
    e = np.exp(logits)
    return e / e.sum(axis=1, keepdims=True)


def merge_scene_predictions(
    num_scene_points: int,
    blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    num_cls: int,
) -> np.ndarray:
    """Accumulate per-block logits onto the scene cloud.

    Args:
      num_scene_points: voxelized scene point count.
      blocks: per evaluated block, (index (P,), inner (P,), logits (P, C))
        — index maps stored block points to scene points.
      num_cls: class count.

    Returns:
      (num_scene_points,) int32 argmax labels.
    """
    predictions = np.zeros((num_scene_points, num_cls), np.float64)
    for index, inner, logits in blocks:
        sel = np.asarray(inner) > 0
        conf = normalized_confidence(np.asarray(logits)[sel])
        np.add.at(predictions, np.asarray(index)[sel], conf)
    return predictions.argmax(axis=1).astype(np.int32)


def project_labels_to_full_cloud(
    voxel_xyz: np.ndarray, voxel_labels: np.ndarray, full_xyz: np.ndarray
) -> np.ndarray:
    """knn back-projection voxel -> full resolution (ref s3dis_merge.m:73-76)."""
    return knn_transfer(voxel_xyz, voxel_labels, full_xyz)
