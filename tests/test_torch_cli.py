"""The port's command-line entry points, run in process through
``main(argv)`` on the CPU (``--device cpu``) on records the port's
writer makes in a temporary directory.

- ``cli.train_modelnet``: one epoch at ``--num_input 512 --batch_size 2``
  in dense mode (config snapshot, log lines, metrics, checkpoint), then
  ``cli.evaluate_modelnet`` with 2 votes: the accuracies printed agree
  with the votes written to ``pred_votes.npz``, and every vote served by
  the dense engine.
- ``cli.train_scene_seg --dataset s3dis``: one epoch at N=512 on
  xyz+rgb block records (the model reads the xyz, as JAX's does on
  them); ``--dataset ruemonge2014``: one epoch at N=128 on xyz + normal
  + rgb records, its single train block repeated 100 times, the plain
  mean loss (no inner label in its batches).
- ``cli.train_shapenet`` (per category and ``--onehot``) then
  ``cli.evaluate_shapenet``, with ``shapenet_config`` cut to N=256 (the
  published size takes seconds a forward on the CPU) and each training
  epoch cut to its first two batches (the per-category class
  rebalancing makes 642 shapes of 2): the rebalancing, the checkpoint,
  11 samples of every point in raw and augmented passes, the shape IoUs
  printed and the ``pred/shape_<i>.txt`` files.
- ``--device`` defaults to ``cuda``: without a card every CLI that runs
  a model raises before it reads anything.
- ``cli.measure_windows``: its synthetic families equal the JAX
  script's draws, and its windows are ``utils.windows``' on them; for
  ShapeNet on the unit-sphere normalized surface families, for
  RueMonge2014 on the scene blocks.
"""

import dataclasses
import importlib.util
import itertools
import json
import os

import numpy as np
import pytest
import torch

from sph3d_gcn_torch import configs
from sph3d_gcn_torch.cli import (
    evaluate_modelnet,
    evaluate_scene_seg,
    evaluate_shapenet,
    measure_windows,
    train_modelnet,
    train_scene_seg,
    train_shapenet,
)
from sph3d_gcn_torch.configs import (
    modelnet_config,
    ruemonge2014_config,
    shapenet_config,
)
from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
from sph3d_gcn_torch.data.tfrecord import TFRecordWriter
from sph3d_gcn_torch.models import SPH3DRueMonge
from sph3d_gcn_torch.models.common import normalize_unit_sphere
from sph3d_gcn_torch.train import loop
from sph3d_gcn_torch.utils.windows import (
    derive_config_windows,
    measure_requirements,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Under pytest-xdist the workers share the machine's cores: torch
    takes its share of them (one thread with six workers on eight cores)
    instead of every core, whose threads would spin against the other
    workers' on these many small CPU ops; put back after the module. A
    run without workers keeps every thread."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


def _write(path, examples):
    with TFRecordWriter(path) as w:
        for ex in examples:
            w.write_example(ex)
    return str(path)


@pytest.fixture(scope="module")
def modelnet_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("modelnet")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 3)):
        clouds = surface_clouds(rng, n, 512)
        path = _write(d / f"{split}.tfrecord", [
            {"xyz_raw": c[:, [0, 2, 1]].tobytes(), "label": np.int64(i)}
            for i, c in enumerate(clouds)])
        (d / f"{split}_files.txt").write_text(path + "\n")
    return d


def test_train_then_evaluate_modelnet(modelnet_dir, capsys):
    log_dir = modelnet_dir / "log"
    train_modelnet.main([
        "--data_dir", str(modelnet_dir), "--log_dir", str(log_dir),
        "--num_input", "512", "--batch_size", "2", "--max_epoch", "1",
        "--mode", "dense", "--device", "cpu"])
    cfg = json.loads((log_dir / "config.json").read_text())
    assert cfg["dense_graph"] and cfg["num_input"] == 512
    log = (log_dir / "log_train.txt").read_text()
    for line in ("**** EPOCH 000 ****", "training one batch require",
                 "---- EPOCH 000 EVALUATION ----", "eval accuracy:",
                 "Model saved at epoch 0"):
        assert line in log
    assert "violated" not in log
    scalars = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert scalars[0]["step"] == 2 and np.isfinite(scalars[0]["train_loss"])
    assert (log_dir / "ckpt" / "0.pt").exists()
    capsys.readouterr()

    out = evaluate_modelnet.main([
        "--data_dir", str(modelnet_dir), "--log_dir", str(log_dir),
        "--batch_size", "2", "--num_votes", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    saved = np.load(log_dir / "pred_votes.npz")
    assert saved["votes"].shape == (3, 40) and np.isfinite(
        saved["votes"]).all()
    assert saved["label"].tolist() == [0, 1, 2]
    acc = float(np.mean(saved["votes"].argmax(-1) == saved["label"]))
    assert f"eval accuracy: {acc:f}" in printed
    assert "class 39: nan" in printed
    assert (out["forwards"], out["reruns"]) == (4, 0)


def test_train_scene_seg_s3dis(tmp_path):
    rng = np.random.default_rng(1)
    blocks = []
    for n in (1300, 900, 1100):
        blocks.append({
            "xyz_raw": rng.uniform(0, 1.5, (n, 3)).astype(np.float32)
            .tobytes(),
            "rgb_raw": rng.random((n, 3)).astype(np.float32).tobytes(),
            "seg_label": rng.integers(0, 13, n).astype(np.int32).tobytes(),
            "inner_label": rng.integers(0, 2, n).astype(np.int32).tobytes()})
    train = _write(tmp_path / "Area_1.tfrecord", blocks[:2])
    test = _write(tmp_path / "Area_5.tfrecord", blocks[2:])
    (tmp_path / "train_files_fold5.txt").write_text(train + "\n")
    (tmp_path / "test_files_fold5.txt").write_text(test + "\n")
    log_dir = tmp_path / "log"
    model = train_scene_seg.main([
        "--dataset", "s3dis", "--data_dir", str(tmp_path),
        "--log_dir", str(log_dir), "--num_input", "512",
        "--batch_size", "2", "--max_epoch", "1", "--device", "cpu"])
    assert model.in_columns == 6 and model.config.num_cls == 13
    log = (log_dir / "log_train.txt").read_text()
    assert "eval accuracy" in log and "Model saved at epoch 0" in log
    assert (log_dir / "ckpt" / "0.pt").exists()


def test_train_scene_seg_ruemonge(tmp_path, capsys):
    rng = np.random.default_rng(2)
    blocks = []
    for n in (400, 300):
        normal = rng.standard_normal((n, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        blocks.append({
            "xyz_raw": scene_blocks(rng, 1, n)[0, :, :3].tobytes(),
            "normal_raw": normal.tobytes(),
            "rgb_raw": rng.random((n, 3)).astype(np.float32).tobytes(),
            "seg_label": rng.integers(0, 7, n).astype(np.int32).tobytes(),
            "inner_label": np.ones(n, np.int32).tobytes()})
    train = _write(tmp_path / "facade_train.tfrecord", blocks[:1])
    test = _write(tmp_path / "facade_test.tfrecord", blocks[1:])
    (tmp_path / "train_files.txt").write_text(train + "\n")
    (tmp_path / "test_files.txt").write_text(test + "\n")
    log_dir = tmp_path / "log"
    model = train_scene_seg.main([
        "--dataset", "ruemonge2014", "--data_dir", str(tmp_path),
        "--log_dir", str(log_dir), "--num_input", "128",
        "--batch_size", "50", "--max_epoch", "1", "--device", "cpu"])
    assert isinstance(model, SPH3DRueMonge)
    assert model.in_columns == 9 and model.config.num_cls == 7
    assert model.backbone.mlp1.weights.shape[0] == 9
    assert "train blocks: 100, test blocks: 1" in capsys.readouterr().out
    scalars = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert scalars[0]["step"] == 2 and np.isfinite(scalars[0]["train_loss"])
    assert np.isfinite(scalars[1]["eval_loss"])
    assert json.loads((log_dir / "config.json").read_text())["num_cls"] == 7
    assert (log_dir / "ckpt" / "0.pt").exists()


SHAPENET_N = 256


def _cut_shapenet_config(num_input=2048, fast=False, dense=False):
    """``shapenet_config`` at 256 points (an eighth of each level), with
    windows that cover the test's shapes."""
    cfg = shapenet_config(fast=fast, dense=dense)
    return dataclasses.replace(
        cfg, num_input=SHAPENET_N, num_sample=(128, 96, 48, 16),
        **({"windows": (256, 128, 128, 128), "dec_windows": (128,) * 4,
            "dec_margin": 128, "growth_steps": 4} if fast else {}))


@pytest.fixture
def shapenet_dir(tmp_path, monkeypatch):
    """Shape records (two chairs, a table) and the file lists; the
    ShapeNet config cut to N=512 and each training epoch to its first
    two batches."""
    monkeypatch.setattr(configs, "shapenet_config", _cut_shapenet_config)
    fit = loop.fit
    monkeypatch.setattr(loop, "fit", lambda factory, batches, *a, **kw: fit(
        factory, lambda epoch: itertools.islice(batches(epoch), 2), *a,
        **kw))
    rng = np.random.default_rng(3)
    clouds = normalize_unit_sphere(torch.from_numpy(
        surface_clouds(rng, 3, SHAPENET_N))).numpy()
    examples = []
    for xyz, cls_id, offset in zip(clouds, (4, 4, 15), (12, 12, 47)):
        part = rng.integers(0, 3, SHAPENET_N).astype(np.int32)
        examples.append({"xyz_raw": xyz.tobytes(),
                         "part_label": part.tobytes(),
                         "seg_label": (part + offset).tobytes(),
                         "cls_label": np.int64(cls_id)})
    path = _write(tmp_path / "shapes.tfrecord", examples)
    for name in ("train_files.txt", "test_files.txt", "chair_train_files.txt",
                 "chair_test_files.txt"):
        (tmp_path / name).write_text(path + "\n")
    return tmp_path


@pytest.mark.parametrize("kind", ["category", "onehot"])
def test_train_then_evaluate_shapenet(shapenet_dir, kind, capsys):
    log_dir = shapenet_dir / f"log_{kind}"
    which = ["--onehot"] if kind == "onehot" else ["--category", "chair"]
    model = train_shapenet.main(which + [
        "--data_dir", str(shapenet_dir), "--log_dir", str(log_dir),
        "--mode", "dense", "--batch_size", "2", "--max_epoch", "1",
        "--device", "cpu"])
    printed = capsys.readouterr().out
    # class rebalancing: 2 chairs repeated int(640 / 2) + 1 times
    assert ("3 training shapes, decay_step=320000" if kind == "onehot"
            else "642 training shapes, decay_step=23112") in printed
    assert model.logits.weights.shape == (
        (144, 50) if kind == "onehot" else (128, 4))
    scalars = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert scalars[0]["step"] == 2 and np.isfinite(scalars[0]["train_loss"])
    assert "violated" not in (log_dir / "log_train.txt").read_text()
    assert json.loads((log_dir / "config.json").read_text())[
        "num_input"] == SHAPENET_N

    out = evaluate_shapenet.main(which + [
        "--data_dir", str(shapenet_dir), "--log_dir", str(log_dir),
        "--batch_size", "3", "--device", "cpu"])
    printed = capsys.readouterr().out
    shapes = 3 if kind == "onehot" else 2
    assert f"evaluating {shapes} shapes" in printed
    # each shape's 256 points all sampled each round: 11 rounds of a raw
    # and an augmented pass, all shapes in one batch, none re-run
    assert (out["forwards"], out["reruns"]) == (22, 0)
    assert len(out["shape_ious"]) == shapes
    assert f"instance mIoU: {np.mean(out['shape_ious']):.4f}" in printed
    for i in range(shapes):
        pred = np.loadtxt(log_dir / "pred" / f"shape_{i}.txt", dtype=int)
        assert pred.shape == (SHAPENET_N, 2)
        assert (pred[:, 0] == out["logits"][i].argmax(-1)).all()


@pytest.mark.parametrize("cli,argv", [
    (train_modelnet, ["--data_dir", "nowhere"]),
    (evaluate_modelnet, ["--data_dir", "nowhere"]),
    (train_scene_seg, ["--dataset", "s3dis", "--data_dir", "nowhere"]),
    (train_scene_seg, ["--dataset", "ruemonge2014", "--data_dir",
                       "nowhere"]),
    (evaluate_scene_seg, ["--dataset", "s3dis", "--data_dir", "nowhere"]),
    (train_shapenet, ["--data_dir", "nowhere", "--onehot"]),
    (evaluate_shapenet, ["--data_dir", "nowhere", "--category", "chair"]),
    (measure_windows, ["--dataset", "modelnet"]),
    (measure_windows, ["--dataset", "shapenet"]),
    (measure_windows, ["--dataset", "ruemonge2014"]),
])
def test_cuda_is_the_default_and_raises_without_a_card(cli, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--log_dir", str(tmp_path)]
                 if cli is not measure_windows else argv)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_measure_windows", os.path.join(REPO, "scripts",
                                            "measure_windows.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_measure_windows(capsys):
    script = _jax_script()
    for name in ("bumpy_ellipsoids", "scene_blocks_worst"):
        got = getattr(measure_windows, name)(np.random.default_rng(3), 2, 300)
        ref = getattr(script, name)(np.random.default_rng(3), 2, 300)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    derived = measure_windows.main([
        "--dataset", "modelnet", "--num_input", "1024", "--samples", "1",
        "--device", "cpu"])
    rng = np.random.default_rng(0)
    clouds = np.concatenate([
        measure_windows.bumpy_ellipsoids(rng, 1, 1024),
        surface_clouds(rng, 1, 1024)])
    cfg = modelnet_config(1024)
    reqs = measure_requirements(cfg, clouds, device="cpu",
                                normalize=normalize_unit_sphere)
    assert derived == derive_config_windows(cfg, reqs, 0.10)
    assert f"windows      = {derived[0]}" in capsys.readouterr().out


@pytest.mark.parametrize("dataset", ["shapenet", "ruemonge2014"])
def test_measure_windows_shapenet_and_ruemonge(dataset, monkeypatch, capsys):
    """ShapeNet (its config cut to N=256) on both surface families,
    normalized into the unit sphere first, then measured as the model
    builds its graphs on them (no normalization); RueMonge2014 on both
    scene-block families."""
    monkeypatch.setattr(configs, "shapenet_config", _cut_shapenet_config)
    argv = ["--dataset", dataset, "--samples", "1", "--device", "cpu"]
    if dataset == "ruemonge2014":
        argv += ["--num_input", "1024"]
    derived = measure_windows.main(argv)
    rng = np.random.default_rng(0)
    if dataset == "shapenet":
        cfg = _cut_shapenet_config()
        clouds = normalize_unit_sphere(torch.from_numpy(np.concatenate([
            measure_windows.bumpy_ellipsoids(rng, 1, SHAPENET_N),
            surface_clouds(rng, 1, SHAPENET_N)]))).numpy()
    else:
        cfg = ruemonge2014_config(1024)
        clouds = np.concatenate([
            measure_windows.scene_blocks_worst(rng, 1, 1024),
            scene_blocks(rng, 1, 1024)[..., :3]])
    reqs = measure_requirements(cfg, clouds, device="cpu")
    assert derived == derive_config_windows(cfg, reqs, 0.10)
    assert f"windows      = {derived[0]}" in capsys.readouterr().out
