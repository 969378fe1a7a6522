"""Dataset pipelines over the reference's TFRecords (counterpart of
``sph3d_gcn_tpu/data/datasets.py``). Records are read by
``data.tfrecord.read_examples`` without CRC checks. The native reader
(``data.native_loader``) is not used here: without CRC checks it is the
slower of the two (about half the Python reader's rate for decoded
Examples, a third for records; ``chip_smoke.py`` phase 49). It is the
faster way to check a file's CRCs.

- ModelNet: records {xyz_raw, label}; the batches apply the xzy->xyz
  axis swap (ref train_modelnet.py:278).
- Scene blocks (S3DIS/ScanNet/RueMonge): variable-size blocks with labels
  and inner masks, resampled to the model's size with the
  replace=True/False rule (ref train_s3dis.py:343-346).

Batches are host numpy dicts; ``train.loop.fit`` moves them to the
device. Every function draws from its ``numpy.random.Generator`` in the
JAX package's order, so one generator state gives equal batches.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from sph3d_gcn_torch.data.tfrecord import read_examples


def _decode_raw(example: dict, key: str, dtype, width: int | None = None):
    arr = np.frombuffer(example[key][0], dtype=dtype)
    if width is not None:
        arr = arr.reshape(-1, width)
    return arr


@dataclasses.dataclass
class ModelNetExample:
    xyz: np.ndarray  # (N, 3) float32 (stored order; swap applied by batches)
    label: int


def load_modelnet_records(files: list[str]) -> list[ModelNetExample]:
    """Load {xyz_raw, label} records (ref train_modelnet.py:118-129)."""
    out = []
    for path in files:
        for ex in read_examples(path):
            xyz = _decode_raw(ex, "xyz_raw", np.float32, 3)
            out.append(ModelNetExample(xyz=xyz, label=int(ex["label"][0])))
    return out


def modelnet_batches(
    examples: list[ModelNetExample],
    batch_size: int,
    rng: np.random.Generator | None = None,
    shuffle: bool = True,
    drop_remainder: bool = False,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield {'points': (B, N, 3), 'label': (B,)} with the xzy->xyz swap
    applied (ref train_modelnet.py:278). The final short batch is yielded
    as it is (:func:`pad_batch` fills it)."""
    order = np.arange(len(examples))
    if shuffle:
        if rng is None:
            raise ValueError("shuffle=True needs a generator")
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        sel = order[start: start + batch_size]
        if drop_remainder and len(sel) < batch_size:
            return
        xyz = np.stack([examples[i].xyz for i in sel])
        label = np.array([examples[i].label for i in sel], np.int32)
        yield {"points": xyz[:, :, [0, 2, 1]], "label": label}


@dataclasses.dataclass
class SceneBlock:
    points: np.ndarray       # (P, D) features: xyz + rgb (+ normals)
    label: np.ndarray        # (P,) int32
    inner: np.ndarray        # (P,) int32
    index: np.ndarray | None = None   # (P,) block->scene map (eval only)
    scene: str | None = None


def load_scene_blocks(
    files: list[str], with_index: bool = False
) -> list[SceneBlock]:
    """Load S3DIS/ScanNet-style block records: xyz ++ rgb, as the
    reference's parse_fn (ref train_s3dis.py:144-171), or xyz ++ normals
    ++ rgb where the record holds normals (RueMonge)."""
    out = []
    for path in files:
        scene = str(path).rsplit("/", 1)[-1].replace(".tfrecord", "")
        for ex in read_examples(path):
            xyz = _decode_raw(ex, "xyz_raw", np.float32, 3)
            rgb = _decode_raw(ex, "rgb_raw", np.float32, 3)
            label = _decode_raw(ex, "seg_label", np.int32)
            inner = _decode_raw(ex, "inner_label", np.int32)
            index = (
                _decode_raw(ex, "index_label", np.int32) if with_index
                else None
            )
            cols = [xyz]
            if "normal_raw" in ex:
                cols.append(_decode_raw(ex, "normal_raw", np.float32, 3))
            cols.append(rgb)
            out.append(SceneBlock(points=np.concatenate(cols, axis=1),
                                  label=label, inner=inner, index=index,
                                  scene=scene))
    return out


def resample_indices(
    num: int, target: int, rng: np.random.Generator
) -> np.ndarray:
    """replace=True when short, False otherwise
    (ref train_s3dis.py:343-346)."""
    if num < target:
        return rng.choice(num, target, replace=True)
    return rng.choice(num, target, replace=False)


def scene_batches(
    blocks: list[SceneBlock],
    batch_size: int,
    num_point: int,
    rng: np.random.Generator,
    shuffle: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield {'points': (B, N, D), 'label': (B, N), 'inner_label': (B, N)}
    with each block resampled to the model's point count."""
    order = np.arange(len(blocks))
    if shuffle:
        rng.shuffle(order)
    dim = blocks[0].points.shape[1]
    for start in range(0, len(order), batch_size):
        sel = order[start: start + batch_size]
        bsize = len(sel)
        pts = np.zeros((bsize, num_point, dim), np.float32)
        lbl = np.zeros((bsize, num_point), np.int32)
        inner = np.zeros((bsize, num_point), np.int32)
        for j, i in enumerate(sel):
            blk = blocks[i]
            idx = resample_indices(len(blk.label), num_point, rng)
            pts[j] = blk.points[idx]
            lbl[j] = blk.label[idx]
            inner[j] = blk.inner[idx]
        yield {"points": pts, "label": lbl, "inner_label": inner}


def pad_batch(batch: dict[str, np.ndarray], batch_size: int
              ) -> tuple[dict, int]:
    """Pad a short final batch to ``batch_size`` by repeating its last
    item; returns (batch, the number of real items).

    Never pads with zeros: an all-zero cloud makes the per-cloud
    unit-sphere normalization divide by zero, and the NaNs reach every
    item through batch norm (the reference reuses a stale buffer,
    ref train_modelnet.py:262-283)."""
    bsize = len(next(iter(batch.values())))
    if bsize == batch_size:
        return batch, bsize
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], batch_size - bsize, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, bsize
