"""Per-dataset train-time augmentation policies (counterparts of
``sph3d_gcn_tpu/train/augment_policies.py``: the ``augment_fn`` of each
reference training script). NumPy on the host, drawing from one
generator in the JAX package's order."""

from __future__ import annotations

import numpy as np

from sph3d_gcn_torch.data import augment as aug


def modelnet_train_augment(
    batch_xyz: np.ndarray,
    batch_label: np.ndarray,
    rng: np.random.Generator,
    augment_ratio: float = 0.5,
):
    """ref modelnet40_cls/train_modelnet.py:92-115: shuffle the items and
    the point order, then rotate/perturb/scale/shift the first half."""
    batch_xyz, batch_label, _ = aug.shuffle_data(batch_xyz, batch_label, rng)
    batch_xyz = aug.shuffle_points(batch_xyz, rng)
    aug_size = np.int32(augment_ratio * batch_xyz.shape[0])
    part = batch_xyz[:aug_size]
    part = aug.rotate_point_cloud(part, rng)
    part = aug.rotate_perturbation_point_cloud(part, rng)
    part = aug.random_scale_point_cloud(part, rng)
    part = aug.shift_point_cloud(part, rng)
    batch_xyz[:aug_size] = part
    return batch_xyz, batch_label


def _shuffle_scene(rng, *arrays):
    """One item permutation, then one point permutation, for every array."""
    order = rng.permutation(arrays[0].shape[0])
    arrays = [a[order] for a in arrays]
    pidx = rng.permutation(arrays[0].shape[1])
    return [a[:, pidx] for a in arrays]


def s3dis_train_augment(
    batch_input: np.ndarray,
    batch_label: np.ndarray,
    batch_inner: np.ndarray,
    rng: np.random.Generator,
):
    """ref s3dis_seg/train_s3dis.py:114-142: shuffle the items and the
    point order, rotate+perturb the first third, jitter the second."""
    batch_input, batch_label, batch_inner = _shuffle_scene(
        rng, batch_input, batch_label, batch_inner)
    third = np.int32(batch_input.shape[0] / 3.0)
    part = batch_input[:third, :, 0:3]
    part = aug.rotate_point_cloud(part, rng)
    part = aug.rotate_perturbation_point_cloud(part, rng)
    batch_input[:third, :, 0:3] = part
    part = aug.jitter_point_cloud(batch_input[third: 2 * third, :, 0:3], rng)
    batch_input[third: 2 * third, :, 0:3] = part
    return batch_input, batch_label, batch_inner


def scannet_train_augment(
    batch_input: np.ndarray,
    batch_label: np.ndarray,
    batch_inner: np.ndarray,
    rng: np.random.Generator,
):
    """ref scannet_seg/train_scannet.py:95-129: the first third
    rotate+perturb+scale+shift+jitter, the second the same without the
    full rotation."""
    batch_input, batch_label, batch_inner = _shuffle_scene(
        rng, batch_input, batch_label, batch_inner)
    third = np.int32(batch_input.shape[0] / 3.0)
    part = batch_input[:third, :, 0:3]
    part = aug.rotate_point_cloud(part, rng)
    part = aug.rotate_perturbation_point_cloud(part, rng)
    part = aug.random_scale_point_cloud(part, rng)
    part = aug.shift_point_cloud(part, rng)
    part = aug.jitter_point_cloud(part, rng)
    batch_input[:third, :, 0:3] = part
    part = batch_input[third: 2 * third, :, 0:3]
    part = aug.rotate_perturbation_point_cloud(part, rng)
    part = aug.random_scale_point_cloud(part, rng)
    part = aug.shift_point_cloud(part, rng)
    part = aug.jitter_point_cloud(part, rng)
    batch_input[third: 2 * third, :, 0:3] = part
    return batch_input, batch_label, batch_inner


def shapenet_train_augment(
    batch_xyz: np.ndarray, batch_label: np.ndarray, rng: np.random.Generator,
    batch_cls: np.ndarray | None = None,
):
    """ref shapenet_seg/train_shapenet.py:121-150: shuffle the items and
    the point order (with the labels), the first third
    rotate+perturb+scale+shift+jitter, the second scale+shift+jitter.
    ``batch_cls`` (B,), the one-hot model's categories, is shuffled with
    its items and returned third (the JAX policy takes none, and its
    one-hot CLI keeps the unshuffled categories); the draws are the same
    either way."""
    order = rng.permutation(batch_xyz.shape[0])
    pidx = rng.permutation(batch_xyz.shape[1])
    batch_xyz = batch_xyz[order][:, pidx]
    batch_label = batch_label[order][:, pidx]
    third = np.int32(batch_xyz.shape[0] / 3.0)
    part = batch_xyz[:third]
    part = aug.rotate_point_cloud(part, rng)
    part = aug.rotate_perturbation_point_cloud(part, rng)
    part = aug.random_scale_point_cloud(part, rng)
    part = aug.shift_point_cloud(part, rng)
    part = aug.jitter_point_cloud(part, rng)
    batch_xyz[:third] = part
    part = batch_xyz[third: 2 * third]
    part = aug.random_scale_point_cloud(part, rng)
    part = aug.shift_point_cloud(part, rng)
    part = aug.jitter_point_cloud(part, rng)
    batch_xyz[third: 2 * third] = part
    if batch_cls is None:
        return batch_xyz, batch_label
    return batch_xyz, batch_label, np.asarray(batch_cls)[order]
