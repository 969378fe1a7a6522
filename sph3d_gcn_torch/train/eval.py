"""Eval protocols (counterparts of ``sph3d_gcn_tpu/train/eval.py``):

- classification, :func:`vote_classify`: ``num_votes`` forwards per
  batch — vote 0 on the raw cloud, later votes on augmented copies —
  logits summed (ref modelnet40_cls/evaluate_modelnet.py:181-198, augment
  at :71-79);
- segmentation blocks, :func:`coverage_eval_blocks`: each variable-size
  block is resampled to the model's point count until every inner point
  has been sampled, logits accumulated per block point, with resamples of
  different blocks sharing a batch (ref
  s3dis_seg/evaluate_s3dis_with_overlap.py:270-302).

The dense engine's window-coverage certificate is enforced by
:func:`checked_eval_step` (JAX's, without the halo retry of point
sharding) and by :func:`checked_forward` (the same rule for the numpy
forwards of the two protocols): a batch whose ``dense_ok`` is False is
re-run on the model's per-edge (classic) engine, on the same parameters,
which is exact for every cloud.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from sph3d_gcn_torch.data import augment as aug
from sph3d_gcn_torch.models.common import classic_clone


def checked_eval_step(factory) -> Callable[[dict], dict]:
    """``factory.eval_step`` with the dense certificate enforced: returns
    ``batch -> metrics``. When the config runs the dense engine and a
    batch's ``dense_ok`` is False (a window did not provably cover its
    neighbors, so the graph may be wrong), the batch is re-run through
    the eval step of ``factory.classic_fallback()`` (the per-edge engine
    on the same parameters, built at the first such batch, which prints
    one line), so results are never silently wrong. A dense config pays
    one host read of the certificate a batch; a per-edge one none."""
    dense = bool(factory.model.config.dense_graph)
    fallback: list = []

    def run(batch: dict) -> dict:
        metrics = factory.eval_step(batch)
        if dense and not bool(metrics["dense_ok"]):
            if not fallback:
                print("dense window coverage violated at eval: re-running "
                      "on the classic per-edge engine", flush=True)
                fallback.append(factory.classic_fallback())
            metrics = fallback[0].eval_step(batch)
        return metrics

    return run


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
    model: torch.nn.Module, device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> Callable[..., np.ndarray]:
    """A forward for :func:`vote_classify` and :func:`coverage_eval_blocks`:
    numpy points in ((B, N, 3) clouds or (B, N, 9) scene blocks), numpy
    logits out ((B, num_cls) or (B, N, num_cls)), run without gradients on
    ``device`` (the card unless the caller asks for the CPU).

    When a forward's ``dense_ok`` certificate is False, the batch is
    re-run on ``models.common.classic_clone(model)`` (the per-edge
    engine on the same parameters; one line is printed the first time)
    and its logits are returned. ``generator`` (on ``device``;
    None: the device's default generator) draws the sampling noise of IDS
    or random sampling; the re-run starts from its state before the dense
    forward, so both answer for the same sample. ``block_ids`` (passed by
    :func:`coverage_eval_blocks`) is unused: these models take no
    per-block side input."""
    fallback: list[torch.nn.Module] = []
    gen = generator if generator is not None else _default_generator(device)

    def forward(points: np.ndarray, block_ids=None) -> np.ndarray:
        x = torch.as_tensor(np.asarray(points, np.float32), device=device)
        with torch.inference_mode():
            state = gen.get_state()
            logits = model(x, generator=gen)
            if not bool(model.dense_ok):
                first = not fallback
                if first:
                    fallback.append(classic_clone(model))
                gen.set_state(state)
                logits = fallback[0](x, generator=gen)
                if first:
                    print("dense window coverage violated at eval: "
                          "re-ran on the classic per-edge engine",
                          flush=True)
        return logits.float().cpu().numpy()

    return forward


def _default_generator(device: torch.device | str) -> torch.Generator:
    """The generator that draws a device's random numbers when none is
    given."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.default_generator
    torch.cuda.init()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return torch.cuda.default_generators[index]


def resample_block(
    num_points: int, target: int, rng: np.random.Generator
) -> np.ndarray:
    """The reference's resampling rule: with replacement only when the
    block has fewer points than the model takes (ref train_s3dis.py:343-346,
    evaluate_s3dis_with_overlap.py:274-277)."""
    if num_points < target:
        return rng.choice(num_points, target, replace=True)
    return rng.choice(num_points, target, replace=False)


def coverage_eval_blocks(
    forward: Callable[[np.ndarray, list[int]], np.ndarray],
    blocks: list[tuple[np.ndarray, np.ndarray]],
    num_model_points: int,
    batch_size: int,
    rng: np.random.Generator | None = None,
) -> list[np.ndarray]:
    """Coverage-vote many blocks with full batches: each forward mixes
    resamples of up to ``batch_size`` still-uncovered blocks (a padded
    final batch repeats its first block), and a block leaves the queue
    once each of its inner points has been sampled.

    Args:
      forward: (points (B, N, D), block_ids list[int]) -> (B, N, C) logits.
      blocks: per block, (points (P, D), inner (P,) mask: 1 = inner).
      num_model_points: the model's fixed point count N.
      batch_size: B.
      rng: the resampling generator.

    Returns:
      Per block, (P, C) f32 logits summed over its resamples.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(blocks)
    sums: list[np.ndarray | None] = [None] * n
    counts = [np.zeros(len(pts), np.int64) for pts, _ in blocks]
    need = list(range(n))

    def covered(i):
        inner_idx = np.asarray(blocks[i][1]) == 1
        return bool((counts[i][inner_idx] >= 1).all())

    while need:
        take = need[:batch_size]
        sels = [resample_block(len(blocks[i][0]), num_model_points, rng)
                for i in take]
        chunk = np.stack(
            [blocks[i][0][sel] for i, sel in zip(take, sels)]
        ).astype(np.float32)
        real = len(take)
        if real < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:1], batch_size - real, axis=0)])
        ids = take + [take[0]] * (batch_size - real)
        logits = np.asarray(forward(chunk, ids))[:real]
        for j, (i, sel) in enumerate(zip(take, sels)):
            if sums[i] is None:
                sums[i] = np.zeros((len(blocks[i][0]), logits.shape[-1]),
                                   np.float32)
            np.add.at(sums[i], sel, logits[j])
            counts[i][sel] += 1
        need = [i for i in need if not (i in take and covered(i))]
    return sums
