"""PyTorch port vs JAX: the scene evaluation's re-merge, its metrics and
its entry points.

- ``data.merge``: ``SceneAccumulator``'s counts and properties, its
  ``save`` / ``load`` / ``merge`` across the two packages (a fold file
  written by either loads in the other); ``normalized_confidence``,
  ``merge_scene_predictions`` and ``project_labels_to_full_cloud`` on
  seeded scenes, all equal to JAX's exactly.
- ScanNet's label maps, equal to JAX's.
- ``cli.evaluate_scene_seg`` end to end on the CPU on a two-scene S3DIS
  set the test writes (block records with ``index_label``, scene npz
  files with ``full_xyz``), from a checkpoint of an S3DIS model at N=512:
  its merged scene labels equal JAX's merge functions applied to the
  port's own block logits, its saved blocks and fold counts agree, and
  ``cli.aggregate_folds`` sums two fold files as the JAX script does;
  a ScanNet checkpoint's ``--submission_dir`` files equal JAX's label
  map and projection of its merged labels.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.data import merge as jax_merge
from sph3d_gcn_tpu.data.prep import scannet as jax_scannet
from sph3d_gcn_torch.cli import aggregate_folds, evaluate_scene_seg
from sph3d_gcn_torch.configs import s3dis_config, scannet_config
from sph3d_gcn_torch.data import merge
from sph3d_gcn_torch.data.prep import scannet
from sph3d_gcn_torch.data.tfrecord import TFRecordWriter
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.train.checkpoint import Checkpointer, snapshot_config
from sph3d_gcn_torch.train.schedule import make_optimizer
from test_torch_cli import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLS = 13


def _labels(rng, n):
    return rng.integers(0, NUM_CLS, n).astype(np.int32)


def _filled(module, rng, scenes=3):
    acc = module.SceneAccumulator(num_cls=NUM_CLS)
    for n in (50, 80, 33)[:scenes]:
        gt = _labels(rng, n)
        pred = np.where(rng.uniform(size=n) < 0.6, gt, _labels(rng, n))
        acc.add_scene(pred, gt)
    return acc


def _fields(acc):
    return (acc.total_intersect.tolist(), acc.total_union.tolist(),
            acc.total_seen.tolist(), acc.merged_correct, acc.merged_seen)


def test_scene_accumulator_matches_jax():
    got = _filled(merge, np.random.default_rng(30))
    ref = _filled(jax_merge, np.random.default_rng(30))
    assert _fields(got) == _fields(ref)
    for name in ("overall_accuracy", "mean_iou", "mean_acc"):
        assert getattr(got, name) == getattr(ref, name)
    for name in ("class_iou", "class_acc"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))
    assert np.isnan(got.class_iou).sum() == 0   # eps guards empty classes


def test_scene_accumulator_files_cross_both_ways(tmp_path):
    port = _filled(merge, np.random.default_rng(31))
    jax_side = _filled(jax_merge, np.random.default_rng(32), scenes=2)
    port.save(str(tmp_path / "port.npz"))
    jax_side.save(str(tmp_path / "jax.npz"))
    assert (sorted(np.load(tmp_path / "port.npz").files)
            == sorted(np.load(tmp_path / "jax.npz").files))
    assert _fields(jax_merge.SceneAccumulator.load(
        str(tmp_path / "port.npz"))) == _fields(port)
    assert _fields(merge.SceneAccumulator.load(
        str(tmp_path / "jax.npz"))) == _fields(jax_side)
    got = merge.SceneAccumulator.load(str(tmp_path / "port.npz"))
    got.merge(merge.SceneAccumulator.load(str(tmp_path / "jax.npz")))
    ref = jax_merge.SceneAccumulator.load(str(tmp_path / "port.npz"))
    ref.merge(jax_merge.SceneAccumulator.load(str(tmp_path / "jax.npz")))
    assert _fields(got) == _fields(ref)
    assert got.merged_seen == port.merged_seen + jax_side.merged_seen
    with pytest.raises(ValueError, match="class count"):
        got.merge(merge.SceneAccumulator(num_cls=7))


def _scene_blocks(rng, num_scene, num_blocks):
    """Blocks over one scene: (index, inner, logits) with overlaps, and a
    row of zero logits (the confidence's guard)."""
    blocks = []
    for _ in range(num_blocks):
        p = int(rng.integers(20, 60))
        index = rng.integers(0, num_scene, p).astype(np.int32)
        inner = (rng.uniform(size=p) < 0.7).astype(np.int32)
        logits = (rng.standard_normal((p, NUM_CLS)) * 3).astype(np.float32)
        blocks.append((index, inner, logits))
    blocks[0][2][0] = 0
    return blocks


def test_merge_functions_match_jax():
    rng = np.random.default_rng(33)
    logits = (rng.standard_normal((40, NUM_CLS)) * 5).astype(np.float32)
    logits[3] = 0
    np.testing.assert_array_equal(merge.normalized_confidence(logits),
                                  jax_merge.normalized_confidence(logits))
    for num_scene, num_blocks in ((120, 6), (30, 9)):
        blocks = _scene_blocks(rng, num_scene, num_blocks)
        got = merge.merge_scene_predictions(num_scene, blocks, NUM_CLS)
        ref = jax_merge.merge_scene_predictions(num_scene, blocks, NUM_CLS)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    voxel = rng.uniform(0, 3, (200, 3)).astype(np.float32)
    voxel[7] = voxel[3]                     # a tie between two sources
    labels = _labels(rng, 200)
    full = rng.uniform(0, 3, (1000, 3)).astype(np.float32)
    full[:5] = voxel[3]
    got = merge.project_labels_to_full_cloud(voxel, labels, full)
    ref = jax_merge.project_labels_to_full_cloud(voxel, labels, full)
    np.testing.assert_array_equal(got, ref)


def test_scannet_label_maps_match_jax():
    nyu = np.arange(-1, 42).repeat(2)
    got = scannet.nyu40_to_benchmark21(nyu)
    np.testing.assert_array_equal(got, jax_scannet.nyu40_to_benchmark21(nyu))
    assert got.dtype == np.int32 and got.max() == 20
    back = scannet.benchmark21_to_nyu40(np.arange(21))
    np.testing.assert_array_equal(
        back, jax_scannet.benchmark21_to_nyu40(np.arange(21)))
    np.testing.assert_array_equal(scannet.nyu40_to_benchmark21(back),
                                  np.arange(21))
    assert scannet.ALL_CLASS_NAMES == jax_scannet.ALL_CLASS_NAMES


N_MODEL = 512


@pytest.fixture(scope="module")
def scene_set(tmp_path_factory):
    """Two voxelized scenes (with full-resolution clouds) cut into
    overlapping block records, and an S3DIS checkpoint at N=512."""
    root = tmp_path_factory.mktemp("scenes")
    rng = np.random.default_rng(34)
    scene_dir = root / "scenes"
    scene_dir.mkdir()
    files = []
    for name, size in (("Area_5_office_1", 900), ("Area_5_hallway_2", 700)):
        xyz = rng.uniform(0, [3.0, 1.5, 3.0], (size, 3)).astype(np.float32)
        label = _labels(rng, size)
        full = xyz.repeat(2, axis=0) + rng.normal(
            0, 0.005, (2 * size, 3)).astype(np.float32)
        np.savez(scene_dir / f"{name}.npz", xyz=xyz, label=label,
                 full_xyz=full, full_label=label.repeat(2))
        path = root / f"{name}.tfrecord"
        with TFRecordWriter(path) as w:
            for lo in (0.0, 1.0, 2.0):      # 1.5 m blocks every metre in x
                index = np.flatnonzero((xyz[:, 0] >= lo)
                                       & (xyz[:, 0] < lo + 1.5))
                inner = (xyz[index, 0] < lo + 1.0).astype(np.int32)
                w.write_example({
                    "xyz_raw": xyz[index].tobytes(),
                    "rgb_raw": rng.random((len(index), 3)).astype(
                        np.float32).tobytes(),
                    "seg_label": label[index].tobytes(),
                    "inner_label": inner.tobytes(),
                    "index_label": index.astype(np.int32).tobytes()})
        files.append(str(path))
    (root / "test_files_fold5.txt").write_text("\n".join(files) + "\n")
    log = root / "log"
    # windows measured on these blocks (utils.windows, 10% margin): the
    # config's, scaled to 512 points, would send every batch to the
    # per-edge engine
    cfg = dataclasses.replace(
        s3dis_config(num_input=N_MODEL, fast=True, dense=True),
        windows=(384, 128, 128, 128), growth_steps=12)
    snapshot_config(log, cfg)
    model = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(3),
                          in_columns=6)
    ckpt = Checkpointer(log)
    ckpt.save(0, model, *make_optimizer(model.parameters()))
    return root, scene_dir, log


def test_evaluate_scene_seg_merges_as_jax(scene_set, capsys):
    root, scene_dir, log = scene_set
    out = evaluate_scene_seg.main([
        "--dataset", "s3dis", "--data_dir", str(root), "--log_dir", str(log),
        "--scene_dir", str(scene_dir), "--save_blocks", "--batch_size", "2",
        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "evaluating 6 blocks from 2 scenes" in printed
    # every batch served by the dense engine
    assert out["forwards"] >= 3 and out["reruns"] == 0
    saved = sorted(os.listdir(log / "block_results"))
    assert len(saved) == 6
    per_scene = {}
    for i, name in enumerate(saved):
        blk = np.load(log / "block_results" / name)
        scene = name.rsplit("_", 1)[0]
        assert blk["logits"].shape == (len(blk["index"]), NUM_CLS)
        assert np.isfinite(blk["logits"]).all()
        # every inner point was covered
        assert (np.abs(blk["logits"][blk["inner"] == 1]).sum(-1) > 0).all()
        per_scene.setdefault(scene, []).append(
            (int(name.rsplit("_", 1)[1][:-4]),
             (blk["index"], blk["inner"], blk["logits"])))
    acc = jax_merge.SceneAccumulator(num_cls=NUM_CLS)
    for scene in sorted(per_scene):
        blocks = [b for _, b in sorted(per_scene[scene],
                                       key=lambda t: t[0])]
        gt = np.load(scene_dir / f"{scene}.npz")
        ref = jax_merge.merge_scene_predictions(len(gt["label"]), blocks,
                                                NUM_CLS)
        np.testing.assert_array_equal(out["merged"][scene], ref)
        acc.add_scene(jax_merge.project_labels_to_full_cloud(
            gt["xyz"], ref, gt["full_xyz"]), gt["full_label"])
    assert _fields(out["accumulator"]) == _fields(acc)
    assert f"mIoU: {acc.mean_iou:.4f}" in printed
    fold = merge.SceneAccumulator.load(str(log / "Area_5_metric.npz"))
    assert _fields(fold) == _fields(acc)
    assert fold.merged_seen == 2 * (900 + 700)      # the full clouds


def test_evaluate_scene_seg_scannet_submission(scene_set):
    """ScanNet: the merged labels mapped to NYU-40 ids and projected onto
    the full cloud, one text file a scene, as JAX's functions give them
    from the port's merged labels."""
    root, scene_dir, _ = scene_set
    (root / "test_files.txt").write_text(
        (root / "test_files_fold5.txt").read_text())
    log = root / "log_scannet"
    cfg = dataclasses.replace(
        scannet_config(num_input=N_MODEL, fast=True, dense=True),
        windows=(384, 128, 128, 128), growth_steps=12)
    snapshot_config(log, cfg)
    model = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(4),
                          in_columns=6)
    Checkpointer(log).save(0, model)
    sub = root / "submission"
    out = evaluate_scene_seg.main([
        "--dataset", "scannet", "--data_dir", str(root), "--log_dir",
        str(log), "--scene_dir", str(scene_dir), "--submission_dir",
        str(sub), "--batch_size", "2", "--device", "cpu"])
    assert sorted(os.listdir(sub)) == ["Area_5_hallway_2.txt",
                                       "Area_5_office_1.txt"]
    for scene, labels in out["merged"].items():
        gt = np.load(scene_dir / f"{scene}.npz")
        ref = jax_merge.project_labels_to_full_cloud(
            gt["xyz"], jax_scannet.benchmark21_to_nyu40(labels),
            gt["full_xyz"])
        got = np.loadtxt(sub / f"{scene}.txt", dtype=np.int64)
        np.testing.assert_array_equal(got, ref)
        assert set(np.unique(got)) <= set(jax_scannet.SUBSET_LABEL_IDS) | {0}
    assert (log / "Area_5_metric.npz").is_file()


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_aggregate_folds_matches_jax(tmp_path, capsys):
    paths = [str(tmp_path / "Area_1_metric.npz"),
             str(tmp_path / "Area_2_metric.npz")]
    _filled(merge, np.random.default_rng(35)).save(paths[0])
    _filled(jax_merge, np.random.default_rng(36), scenes=2).save(paths[1])
    total = aggregate_folds.main(paths)
    printed = capsys.readouterr().out
    ref = _jax_script("aggregate_folds").aggregate(paths)
    ref_printed = capsys.readouterr().out
    assert _fields(total) == _fields(ref)
    assert printed.startswith(ref_printed)
    assert f"mIoU: {ref.mean_iou * 100:.2f}%" in printed
