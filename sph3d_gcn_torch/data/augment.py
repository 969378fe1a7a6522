"""On-the-fly NumPy augmentations (counterparts of
``sph3d_gcn_tpu/data/augment.py``, ref utils/data_util.py).

Every function takes an explicit ``numpy.random.Generator`` and draws
from it in the reference's order, so the same generator state gives the
same clouds as the JAX package's augmentations. Rotation conventions,
clip values and per-cloud vs per-point draws are the reference's.
"""

from __future__ import annotations

import numpy as np


def rot_x(angle: float) -> np.ndarray:
    """ref utils/data_util.py:207-213."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def rot_y(angle: float) -> np.ndarray:
    """ref utils/data_util.py:216-222."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def rot_z(angle: float) -> np.ndarray:
    """ref utils/data_util.py:225-232."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def shuffle_data(data, labels, rng: np.random.Generator):
    """Shuffle the items of a batch (ref data_util.py:8-19)."""
    idx = rng.permutation(len(labels))
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch_data, rng: np.random.Generator):
    """Shuffle the point order, one permutation for the whole batch
    (ref data_util.py:22-31)."""
    idx = rng.permutation(batch_data.shape[1])
    return batch_data[:, idx, :]


def shuffle_points_and_label(batch_data, batch_label,
                             rng: np.random.Generator):
    """ref data_util.py:34-44."""
    idx = rng.permutation(batch_data.shape[1])
    return batch_data[:, idx, :], batch_label[:, idx]


def rotate_point_cloud(batch_data, rng, max_angle=2 * np.pi):
    """Per-cloud random z-rotation (ref data_util.py:47-61)."""
    out = np.zeros(batch_data.shape, np.float32)
    for k in range(batch_data.shape[0]):
        r = rot_z(rng.uniform() * max_angle)
        out[k] = batch_data[k].reshape(-1, 3) @ r
    return out


def rotate_point_cloud_with_normal(batch, rng, max_angle=2 * np.pi):
    """Rotate xyz and normals together, in place (ref data_util.py:64-78);
    returns the same array."""
    for k in range(batch.shape[0]):
        r = rot_z(rng.uniform() * max_angle)
        batch[k, :, 0:3] = batch[k, :, 0:3] @ r
        batch[k, :, 3:6] = batch[k, :, 3:6] @ r
    return batch


def _perturbation_matrix(rng, angle_sigma, angle_clip):
    angles = np.clip(angle_sigma * rng.standard_normal(3), -angle_clip,
                     angle_clip)
    c = [np.cos(a) for a in angles]
    s = [np.sin(a) for a in angles]
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    return rz @ ry @ rx


def rotate_perturbation_point_cloud(
    batch_data, rng, angle_sigma=0.06, angle_clip=0.18
):
    """Small random 3-axis rotations (ref data_util.py:140-162)."""
    out = np.zeros(batch_data.shape, np.float32)
    for k in range(batch_data.shape[0]):
        r = _perturbation_matrix(rng, angle_sigma, angle_clip)
        out[k] = batch_data[k] @ r
    return out


def rotate_perturbation_point_cloud_with_normal(
    batch, rng, angle_sigma=0.06, angle_clip=0.18
):
    """ref data_util.py:81-105."""
    out = np.zeros(batch.shape, np.float32)
    for k in range(batch.shape[0]):
        r = _perturbation_matrix(rng, angle_sigma, angle_clip)
        out[k, :, 0:3] = batch[k, :, 0:3] @ r
        out[k, :, 3:6] = batch[k, :, 3:6] @ r
    return out


def rotate_point_cloud_by_angle(batch_data, rotation_angle):
    """Deterministic z-rotation of the voting eval
    (ref data_util.py:108-120)."""
    out = np.zeros(batch_data.shape, np.float32)
    for k in range(batch_data.shape[0]):
        out[k, :, 0:3] = batch_data[k, :, 0:3] @ rot_z(rotation_angle)
    return out


def rotate_point_cloud_by_angle_with_normal(batch, rotation_angle):
    """Deterministic z-rotation of xyz (columns 0:3) and normals (3:6)
    (ref data_util.py:123-137). The JAX package's version multiplies the
    whole 6-column row by the 3x3 matrix and raises on every input; this
    one rotates each group as its own ``rotate_point_cloud_by_angle``
    does."""
    out = np.zeros(batch.shape, np.float32)
    r = rot_z(rotation_angle)
    for k in range(batch.shape[0]):
        out[k, :, 0:3] = batch[k, :, 0:3] @ r
        out[k, :, 3:6] = batch[k, :, 3:6] @ r
    return out


def jitter_point_cloud(batch_data, rng, sigma=0.01, clip=0.02):
    """Per-point Gaussian jitter (ref data_util.py:165-176)."""
    if not clip > 0:
        raise ValueError(f"clip must be positive, got {clip}")
    noise = np.clip(
        sigma * rng.standard_normal(batch_data.shape), -clip, clip
    ).astype(np.float32)
    return batch_data + noise


def shift_point_cloud(batch_data, rng, shift_range=0.1):
    """Per-cloud random translation, in place (ref data_util.py:179-190)."""
    shifts = rng.uniform(-shift_range, shift_range, (batch_data.shape[0], 3))
    for k in range(batch_data.shape[0]):
        batch_data[k] += shifts[k]
    return batch_data


def random_scale_point_cloud(batch_data, rng, scale_low=0.8, scale_high=1.25):
    """Per-cloud random scale, in place (ref data_util.py:193-204)."""
    scales = rng.uniform(scale_low, scale_high, batch_data.shape[0])
    for k in range(batch_data.shape[0]):
        batch_data[k] *= scales[k]
    return batch_data
