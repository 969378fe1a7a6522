"""Classification eval protocol (counterpart of ``vote_classify`` in
``sph3d_gcn_tpu/train/eval.py``): ``num_votes`` forwards per batch —
vote 0 on the raw cloud, later votes on augmented copies — logits summed
(ref modelnet40_cls/evaluate_modelnet.py:181-198, augment at :71-79).

The dense engine's window-coverage certificate is enforced: a forward
whose ``dense_ok`` is False raises :class:`DenseCoverageError`. The exact
classic-engine fallback of the JAX package is not ported yet, so nothing
is silently re-routed.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from sph3d_gcn_torch.data import augment as aug


class DenseCoverageError(RuntimeError):
    """A dense graph's window did not provably cover its neighbors."""


def vote_augment(batch_xyz: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The classification vote augmentation (ref evaluate_modelnet.py:71-79)."""
    x = aug.rotate_point_cloud(batch_xyz, rng)
    x = aug.rotate_perturbation_point_cloud(x, rng)
    x = aug.random_scale_point_cloud(x, rng)
    x = aug.shift_point_cloud(x, rng)
    return x


def vote_classify(
    forward: Callable[[np.ndarray], np.ndarray],
    batch_xyz: np.ndarray,
    num_votes: int = 12,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Sum logits over augmented votes: (B, N, 3) -> (B, num_cls)."""
    if rng is None:
        rng = np.random.default_rng(0)
    total = None
    for vote in range(num_votes):
        x = batch_xyz if vote == 0 else vote_augment(batch_xyz.copy(), rng)
        logits = np.asarray(forward(x))
        total = logits if total is None else total + logits
    return total


def checked_forward(
    model: torch.nn.Module, device: torch.device | str
) -> Callable[[np.ndarray], np.ndarray]:
    """A ``vote_classify`` forward: numpy (B, N, 3) in, numpy logits out,
    run without gradients on ``device``; raises DenseCoverageError when
    the forward's ``dense_ok`` certificate is False."""

    def forward(points: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(points, np.float32), device=device)
        with torch.inference_mode():
            logits = model(x)
        if not bool(model.dense_ok):
            raise DenseCoverageError(
                "dense window coverage violated: the graph may be wrong, "
                "and the exact classic-engine fallback is not ported yet"
            )
        return logits.float().cpu().numpy()

    return forward
