"""Eval protocols (counterparts of ``sph3d_gcn_tpu/train/eval.py``):

- classification, :func:`vote_classify`: ``num_votes`` forwards per
  batch — vote 0 on the raw cloud, later votes on augmented copies —
  logits summed (ref modelnet40_cls/evaluate_modelnet.py:181-198, augment
  at :71-79);
- segmentation blocks, :func:`coverage_eval_blocks`: each variable-size
  block is resampled to the model's point count until every inner point
  has been sampled (``min_count`` times: the ShapeNet eval takes more
  than 10, with an augmented second pass of each resample), logits
  accumulated per block point, with resamples of different blocks
  sharing a batch (ref s3dis_seg/evaluate_s3dis_with_overlap.py:270-302,
  shapenet_seg/evaluate_shapenet.py:228-247); :func:`coverage_eval_block`
  does it for one block, one resample a forward.

The dense engine's window-coverage certificate is enforced by
:func:`checked_eval_step` (JAX's) and by :func:`checked_forward` (the
same rule for the numpy forwards of the two protocols): a batch whose
``dense_ok`` is False is re-run on the model's per-edge (classic)
engine, on the same parameters, which is exact for every cloud. Under
point sharding a batch whose only breach was a halo first re-runs
sharded at twice the inter-level halos.

Under a data-parallel group (``parallel.DataGroup``) every rank runs the
same host loop on the same records, as JAX's single-host mesh eval
does: each rank's step serves its rows of each batch, the gathered
logits feed the votes, and the ranks agree on every fallback re-run.
"""

from __future__ import annotations

import warnings
from collections.abc import Callable

import numpy as np
import torch

from sph3d_gcn_torch.data import augment as aug
from sph3d_gcn_torch.data.datasets import pad_batch
from sph3d_gcn_torch.models.common import classic_clone, halo_clone
from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    PointGroup,
    data_parallel,
    is_primary,
    spread,
)


def checked_eval_step(factory) -> Callable[[dict], dict]:
    """``factory.eval_step`` with the dense certificate enforced: returns
    ``batch -> metrics``. When the config runs the dense engine and a
    batch's ``dense_ok`` is False (a window did not provably cover its
    neighbors, so the graph may be wrong), the batch is re-run through
    the eval step of ``factory.classic_fallback()`` (the per-edge engine
    on the same parameters, built at the first such batch, which prints
    one line), so results are never silently wrong. A dense config pays
    one host read of the certificate a batch; a per-edge one none. Under
    ``factory.group``, ``batch`` is this rank's rows and the certificate
    is the group's, so every rank re-runs together. Under point sharding
    (``factory.points``) a batch whose only breach was a halo first
    re-runs through ``factory.halo_widened()``'s eval step (JAX's,
    ``sph3d_gcn_tpu/train/eval.py:41-49``). ``run.reruns`` counts the
    re-runs of each kind."""
    dense = bool(factory.model.config.dense_graph)
    fallback: dict = {}
    reruns = {"halo": 0, "classic": 0}

    def rerun(kind: str, batch: dict) -> dict:
        if kind not in fallback:
            if is_primary(factory.group):
                print("dense window coverage violated at eval: re-running "
                      + ("sharded with 2x halos" if kind == "halo"
                         else "on the classic per-edge engine"),
                      flush=True)
            fallback[kind] = (factory.halo_widened() if kind == "halo"
                              else factory.classic_fallback())
        reruns[kind] += 1
        return fallback[kind].eval_step(batch)

    def run(batch: dict) -> dict:
        metrics = factory.eval_step(batch)
        if dense and not bool(metrics["dense_ok"]):
            if factory.points is not None and not bool(metrics["halo_ok"]):
                metrics = rerun("halo", batch)
                if bool(metrics["dense_ok"]):
                    return metrics
            metrics = rerun("classic", batch)
        return metrics

    run.reruns = reruns
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
    model_inputs: Callable[[list[int]], list[np.ndarray]] | None = None,
    group: DataGroup | None = None,
    points: PointGroup | None = None,
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
    forward, so both answer for the same sample. ``model_inputs`` maps the
    ``block_ids`` that :func:`coverage_eval_blocks` passes to the model's
    extra inputs after the points (the one-hot ShapeNet model's category
    labels, (B,)); None: the model takes none. With ``group`` every rank
    calls the forward on the same global batch: each runs its rows (the
    batch padded with repeats of its last item when it does not split
    over the ranks), the ranks re-run together when any certificate
    failed, and every rank returns the whole batch's logits. ``points``:
    the point group of a point-sharded model (its config's
    ``point_axis``): the point ranks of a replica run its rows together,
    and a batch whose only breach was a halo re-runs sharded at twice the
    inter-level halos (``models.common.halo_clone``) before the per-edge
    engine."""
    fallback: dict[str, torch.nn.Module] = {}
    gen = generator if generator is not None else _default_generator(device)
    point_group = points      # ``forward``'s own ``points`` are the clouds

    def rerun(kind: str, x, extra, state):
        first = kind not in fallback
        if first:
            fallback[kind] = (halo_clone(model) if kind == "halo"
                              else classic_clone(model))
        gen.set_state(state)
        logits = fallback[kind](x, *extra, generator=gen)
        if first and is_primary(group):
            print("dense window coverage violated at eval: re-ran "
                  + ("sharded with 2x halos" if kind == "halo"
                     else "on the classic per-edge engine"), flush=True)
        return logits

    def forward(points: np.ndarray, block_ids=None) -> np.ndarray:
        inputs = [np.asarray(points, np.float32)] + (
            [] if model_inputs is None else
            [np.asarray(a) for a in model_inputs(block_ids)])
        size = len(inputs[0])
        if spread(group):
            # a batch that does not split over the ranks is padded with
            # repeats of its last item, and the logits trimmed back
            padded, _ = pad_batch(dict(enumerate(inputs)),
                                  -(-size // group.size) * group.size)
            inputs = [group.local_rows(a) for a in padded.values()]
        x, *extra = [torch.as_tensor(a, device=device) for a in inputs]
        with torch.inference_mode(), data_parallel(group, point_group):
            state = gen.get_state()
            logits = model(x, *extra, generator=gen)
            if not _agreed(model.dense_ok, group):
                ok = False
                if point_group is not None \
                        and not _agreed(model.halo_ok, group):
                    logits = rerun("halo", x, extra, state)
                    ok = _agreed(fallback["halo"].dense_ok, group)
                if not ok:
                    logits = rerun("classic", x, extra, state)
            if spread(group):
                logits = group.all_gather_rows(logits)[:size]
        return logits.float().cpu().numpy()

    return forward


def _agreed(ok: torch.Tensor, group: DataGroup | None) -> bool:
    """Whether the certificate held on every rank (a host read)."""
    if not spread(group):
        return bool(ok)
    failed = (~ok).to(torch.float32).reshape(1)
    return bool(group.all_reduce_(failed) == 0)


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


def coverage_eval_block(
    forward: Callable[[np.ndarray], np.ndarray],
    block_points: np.ndarray,
    inner: np.ndarray,
    num_model_points: int,
    rng: np.random.Generator | None = None,
    max_rounds: int | None = None,
    min_count: int = 1,
    augment_fn: Callable[[np.ndarray, np.random.Generator], np.ndarray]
    | None = None,
) -> np.ndarray:
    """Accumulate logits for ONE block, one resample a forward, until each
    inner point has been sampled ``min_count`` times.

    Args:
      forward: (1, num_model_points, D) -> (1, num_model_points, C) logits.
      block_points: (P, D) stored block points (inner and context).
      inner: (P,) inner mask (1 = inner).
      num_model_points: the model's fixed point count N.
      rng: the resampling (and augmentation) generator.
      max_rounds: None loops until covered, as the reference does (ref
        evaluate_s3dis_with_overlap.py:270); a bound that runs out with
        inner points uncovered warns and returns the partial sums.
      min_count: samples each inner point needs: 1 for the scene evals
        (ref evaluate_s3dis_with_overlap.py:286), 11 for the ShapeNet eval
        (more than 10, ref evaluate_shapenet.py:239).
      augment_fn: a (B, N, 3) xyz augmentation; when given, each resample
        also runs an augmented pass whose logits add at the same points
        (ref evaluate_shapenet.py:245-247).

    Returns:
      (P, C) f32 logits summed over the block's passes.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    num = block_points.shape[0]
    inner_idx = np.asarray(inner) == 1
    inner_size = int(inner_idx.sum())
    sample_count = np.zeros(num, np.int64)
    pred_sum = None
    rounds_done = 0
    while max_rounds is None or rounds_done < max_rounds:
        rounds_done += 1
        sel = resample_block(num, num_model_points, rng)
        chunk = block_points[None, sel]
        logits = np.asarray(forward(chunk))[0]
        if pred_sum is None:
            pred_sum = np.zeros((num, logits.shape[-1]), np.float32)
        np.add.at(pred_sum, sel, logits)
        if augment_fn is not None:
            augmented = chunk.copy()
            augmented[..., 0:3] = augment_fn(augmented[..., 0:3], rng)
            np.add.at(pred_sum, sel, np.asarray(forward(augmented))[0])
        sample_count[sel] += 1
        if int((sample_count[inner_idx] >= min_count).sum()) >= inner_size:
            break
    else:
        uncovered = int((sample_count[inner_idx] < min_count).sum())
        warnings.warn(
            f"coverage_eval_block: max_rounds={max_rounds} exhausted with "
            f"{uncovered}/{inner_size} inner points uncovered; logits are "
            "partial (the reference loops unboundedly)",
            stacklevel=2,
        )
    return pred_sum


def coverage_eval_blocks(
    forward: Callable[[np.ndarray, list[int]], np.ndarray],
    blocks: list[tuple[np.ndarray, np.ndarray]],
    num_model_points: int,
    batch_size: int,
    rng: np.random.Generator | None = None,
    max_rounds: int | None = None,
    min_count: int = 1,
    augment_fn: Callable[[np.ndarray, np.random.Generator], np.ndarray]
    | None = None,
) -> list[np.ndarray]:
    """Coverage-vote many blocks with full batches: each forward mixes
    resamples of up to ``batch_size`` still-uncovered blocks (a padded
    final batch repeats its first block), and a block leaves the queue
    once each of its inner points has been sampled ``min_count`` times,
    or after ``max_rounds`` resamples (with a warning if then uncovered).
    The generator draws each round's resamples, then its augmentation.

    Args:
      forward: (points (B, N, D), block_ids list[int]) -> (B, N, C) logits;
        ``block_ids`` names each row's block (a padded row repeats the
        first), for per-block side inputs such as ShapeNet's category.
      blocks: per block, (points (P, D), inner (P,) mask: 1 = inner).
      num_model_points: the model's fixed point count N.
      batch_size: B.
      rng, max_rounds, min_count, augment_fn: as
        :func:`coverage_eval_block`.

    Returns:
      Per block, (P, C) f32 logits summed over its passes.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = len(blocks)
    sums: list[np.ndarray | None] = [None] * n
    counts = [np.zeros(len(pts), np.int64) for pts, _ in blocks]
    rounds = np.zeros(n, np.int64)
    need = list(range(n))

    def covered(i):
        inner_idx = np.asarray(blocks[i][1]) == 1
        return bool((counts[i][inner_idx] >= min_count).all())

    def exhausted(i):
        return max_rounds is not None and rounds[i] >= max_rounds

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
        passes = [np.asarray(forward(chunk, ids))[:real]]
        if augment_fn is not None:
            augmented = chunk.copy()
            augmented[..., 0:3] = augment_fn(augmented[..., 0:3], rng)
            passes.append(np.asarray(forward(augmented, ids))[:real])
        for j, (i, sel) in enumerate(zip(take, sels)):
            if sums[i] is None:
                sums[i] = np.zeros((len(blocks[i][0]), passes[0].shape[-1]),
                                   np.float32)
            for logits in passes:
                np.add.at(sums[i], sel, logits[j])
            counts[i][sel] += 1
            rounds[i] += 1
        for i in take:
            if exhausted(i) and not covered(i):
                inner_idx = np.asarray(blocks[i][1]) == 1
                uncovered = int((counts[i][inner_idx] < min_count).sum())
                warnings.warn(
                    f"coverage_eval_blocks: block {i} exhausted "
                    f"max_rounds={max_rounds} with {uncovered}/"
                    f"{int(inner_idx.sum())} inner points uncovered; logits "
                    "are partial (the reference loops unboundedly)",
                    stacklevel=2,
                )
        need = [i for i in need
                if not (i in take and (covered(i) or exhausted(i)))]
    return sums


def shapenet_eval_augment(
    batch_xyz: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """The ShapeNet eval's augmented pass (ref evaluate_shapenet.py:86-94)."""
    x = aug.rotate_perturbation_point_cloud(batch_xyz, rng)
    x = aug.random_scale_point_cloud(x, rng)
    x = aug.shift_point_cloud(x, rng)
    x = aug.jitter_point_cloud(x, rng)
    return x
