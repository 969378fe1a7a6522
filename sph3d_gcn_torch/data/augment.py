"""On-the-fly NumPy augmentations of the vote eval (counterparts of
``sph3d_gcn_tpu/data/augment.py``, ref utils/data_util.py).

Every function takes an explicit ``numpy.random.Generator`` and draws
from it in the reference's order, so the same generator state gives the
same clouds as the JAX package's augmentations.
"""

from __future__ import annotations

import numpy as np


def rot_z(angle: float) -> np.ndarray:
    """ref utils/data_util.py:225-232."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def rotate_point_cloud(batch_data, rng, max_angle=2 * np.pi):
    """Per-cloud random z-rotation (ref data_util.py:47-61)."""
    out = np.zeros(batch_data.shape, np.float32)
    for k in range(batch_data.shape[0]):
        r = rot_z(rng.uniform() * max_angle)
        out[k] = batch_data[k].reshape(-1, 3) @ r
    return out


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
