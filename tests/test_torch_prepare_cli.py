"""The port's ``cli.prepare_*`` entry points against the JAX package's
``scripts/prepare_*.py`` on the same raw trees.

Each JAX script runs in process (``sys.argv`` set, its ``main()``) and
its port runs through ``main(argv)`` (``prepare_modelnet`` with
``--device cpu``: the plain farthest-point sampling, held to JAX's XLA
loop) on one seeded raw tree in the dataset's published layout
(``sph3d_gcn_torch.data.raw_trees``), each into a store folder of its
own. Every file written must match: record files byte for byte, the
scene ``.npz`` files array for array, ``log_block.txt`` line for line,
and the file lists by the base names they list (their directories
differ).

JAX's ``scripts/prepare_ruemonge2014.py`` raises ``TypeError`` on its
first block (``np.arange(len(sel), np.int32)`` passes the dtype as the
stop): the test shows that, then runs the script with that one call
mended (its module's ``np.arange`` taking a dtype in second place) and
compares with the port, which writes ``np.arange(n, dtype=np.int32)``.

Tests marked ``cuda`` need a card and skip elsewhere (this file imports
no JAX: ``python -m pytest tests/test_torch_prepare_cli.py -m cuda
--noconftest``): ``prepare_modelnet --device cuda`` launches K1 once for
each shape with more points than asked and writes the same bytes as
``--device cpu``, every K1 call equal to the plain FPS; a TF1 bundle of
a seeded ModelNet model's ``tf_variables`` loads into a fresh model on
the card with logits bitwise equal to the source model's.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from sph3d_gcn_torch import _build, kernel_launches, reset_kernel_launches
from sph3d_gcn_torch.cli import (
    prepare_modelnet,
    prepare_ruemonge2014,
    prepare_s3dis,
    prepare_scannet,
    prepare_shapenet,
)
from sph3d_gcn_torch.data import raw_trees
from sph3d_gcn_torch.data.datasets import load_modelnet_records
from test_torch_cli import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = path
    return out


def _same_outputs(got_dir, ref_dir):
    """Every file of the two store folders equal (see the module
    docstring); returns the relative names."""
    got, ref = _files(got_dir), _files(ref_dir)
    assert sorted(got) == sorted(ref)
    for rel in ref:
        if rel.endswith(".npz"):
            g, r = np.load(got[rel]), np.load(ref[rel])
            assert sorted(g.files) == sorted(r.files), rel
            for k in r.files:
                assert g[k].dtype == r[k].dtype, (rel, k)
                np.testing.assert_array_equal(g[k], r[k], err_msg=rel)
        elif rel.endswith("_files.txt") or "files_fold" in rel:
            lines = [open(p).read().splitlines() for p in (got[rel],
                                                           ref[rel])]
            assert ([os.path.basename(x) for x in lines[0]]
                    == [os.path.basename(x) for x in lines[1]]), rel
        else:
            with open(got[rel], "rb") as g, open(ref[rel], "rb") as r:
                assert g.read() == r.read(), rel
    return sorted(ref)


def test_prepare_modelnet(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    # 700 and 600 points: sampled to 256; 256 points: taken as they are
    names = raw_trees.write_modelnet_tree(
        raw, np.random.default_rng(0), points=[700, 600, 256])
    argv = ["--data_path", raw, "--num_point", "256"]
    _run_jax(_jax_script("prepare_modelnet"),
             argv + ["--store_folder", str(tmp_path / "jax")], monkeypatch)
    written = prepare_modelnet.main(
        argv + ["--store_folder", str(tmp_path / "port"), "--device", "cpu"])
    rel = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert rel == ["data_test0.tfrecord", "data_train0.tfrecord",
                   "test_files.txt", "train_files.txt"]
    assert [os.path.basename(p) for p in written] == [
        "data_train0.tfrecord", "data_test0.tfrecord"]
    shapes = load_modelnet_records(written)
    assert len(shapes) == len(names) == 9
    assert all(s.xyz.shape == (256, 3) for s in shapes)
    assert [s.label for s in shapes] == [0, 0, 1, 1, 2, 2, 0, 1, 2]


def test_prepare_s3dis(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    raw_trees.write_s3dis_tree(raw, np.random.default_rng(1),
                               dims=(4.0, 3.0, 2.5), points=8000)
    argv = ["--data_path", raw, "--voxel", "0.06", "--min_points", "700"]
    _run_jax(_jax_script("prepare_s3dis"),
             argv + ["--store_folder", str(tmp_path / "jax")], monkeypatch)
    written = prepare_s3dis.main(argv + ["--store_folder",
                                         str(tmp_path / "port")])
    rel = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert "scenes/Area_1_office_1.npz" in rel
    assert "scenes/Area_2_conferenceRoom_1.npz" in rel
    assert len(written) == 2
    log = (tmp_path / "port" / "log_block.txt").read_text().splitlines()
    assert len(log) >= 2 and log[0].startswith("Area_1, office_1, ")
    assert (tmp_path / "port" / "test_files_fold1.txt").read_text(
    ).count(".tfrecord") == 1


def test_prepare_scannet(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    raw_trees.write_scannet_tree(raw, np.random.default_rng(2),
                                 points=6000)
    argv = ["--data_path", raw, "--voxel", "0.06", "--min_points", "400"]
    _run_jax(_jax_script("prepare_scannet"),
             argv + ["--store_folder", str(tmp_path / "jax")], monkeypatch)
    out = prepare_scannet.main(argv + ["--store_folder",
                                       str(tmp_path / "port")])
    rel = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert {"scenes/scene0000_00.npz", "log_block.txt",
            "train_files.txt", "test_files.txt"} <= set(rel)
    assert [len(v) for v in out.values()] == [1, 1]
    label = np.load(tmp_path / "port" / "scenes" / "scene0000_00.npz")[
        "label"]
    assert label.max() <= 20


def test_prepare_shapenet(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    raw_trees.write_shapenet_tree(raw, np.random.default_rng(3),
                                  points=300)
    argv = ["--data_path", raw]
    _run_jax(_jax_script("prepare_shapenet"),
             argv + ["--store_folder", str(tmp_path / "jax")], monkeypatch)
    summary = prepare_shapenet.main(argv + ["--store_folder",
                                            str(tmp_path / "port")])
    rel = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert "Chair_test0.tfrecord" in rel and "train_files.txt" in rel
    # val joins train; the small part's far points were removed
    assert summary == {"Airplane": (3, 1, 4), "Chair": (3, 1, 3)}


class _MendedNumpy(types.ModuleType):
    """numpy, with ``arange(stop, dtype)`` taking a dtype in second
    place: the one call of JAX's RueMonge script that raises."""

    def __init__(self):
        super().__init__("numpy")
        self.__dict__.update(np.__dict__)

        def arange(*args, **kwargs):
            if len(args) == 2 and isinstance(args[1], type):
                return np.arange(args[0], dtype=args[1], **kwargs)
            return np.arange(*args, **kwargs)

        self.arange = arange


def test_prepare_ruemonge2014(tmp_path, monkeypatch):
    raw = str(tmp_path / "raw")
    raw_trees.write_ruemonge_tree(raw, np.random.default_rng(4),
                                  points=6000)
    argv = ["--data_path", raw, "--min_points", "300"]
    script = _jax_script("prepare_ruemonge2014")
    with pytest.raises(TypeError):
        _run_jax(script, argv + ["--store_folder",
                                 str(tmp_path / "raises")], monkeypatch)
    monkeypatch.setattr(script, "np", _MendedNumpy())
    _run_jax(script, argv + ["--store_folder", str(tmp_path / "jax")],
             monkeypatch)
    out = prepare_ruemonge2014.main(argv + ["--store_folder",
                                            str(tmp_path / "port")])
    rel = _same_outputs(tmp_path / "port", tmp_path / "jax")
    # two train facades and two test ones; the small split merged
    assert [len(v) for v in out.values()] == [2, 2]
    assert "scenes/test_facade_1.npz" in rel


def test_prepare_modelnet_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    raw = str(tmp_path / "raw")
    raw_trees.write_modelnet_tree(raw, np.random.default_rng(6),
                                  points=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_modelnet.main(["--data_path", raw, "--store_folder",
                               str(tmp_path / "out"), "--num_point", "256"])
    assert not (tmp_path / "out").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_prepare_modelnet_on_the_card(tmp_path, cuda_device):
    from sph3d_gcn_torch.ops.sample import (
        farthest_point_sample_kernel,
        farthest_point_sample_plain,
    )

    raw = str(tmp_path / "raw")
    sizes = [1300, 1025, 1024]         # two sampled, one taken as it is
    raw_trees.write_modelnet_tree(raw, np.random.default_rng(5),
                                  points=sizes)
    argv = ["--data_path", raw, "--num_point", "1024"]
    reset_kernel_launches()
    with _build.record_calls() as calls:
        prepare_modelnet.main(argv + ["--store_folder",
                                      str(tmp_path / "card")])
    assert kernel_launches()["fps"] == 6
    assert [c[0] for c in calls] == ["fps"] * 6
    for _, (npoint, cloud), _ in calls:
        assert cloud.is_cuda and cloud.shape[0] == 1
        assert torch.equal(
            farthest_point_sample_kernel(npoint, cloud),
            farthest_point_sample_plain(npoint, cloud.cpu()).to(cloud.device))
    prepare_modelnet.main(argv + ["--store_folder", str(tmp_path / "cpu"),
                                  "--device", "cpu"])
    _same_outputs(tmp_path / "card", tmp_path / "cpu")


@pytest.mark.cuda
def test_tf1_bundle_into_a_model_on_the_card(tmp_path, cuda_device):
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.utils.checkpoint_convert import (
        convert_checkpoint,
        tf_variables,
    )
    from sph3d_gcn_torch.utils.tf1_bundle import write_bundle

    cfg = modelnet_config(fast=True, dense=True, family="hard")
    source = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    source = source.to(cuda_device).eval()
    prefix = str(tmp_path / "model.ckpt-1")
    write_bundle(prefix, tf_variables(source.state_dict()))
    fresh = SPH3DModelNet(cfg).to(cuda_device).eval()
    fresh.load_state_dict(convert_checkpoint(fresh, prefix))
    x = torch.from_numpy(surface_clouds(np.random.default_rng(0), 4,
                                        10000)).to(cuda_device)
    with torch.inference_mode():
        assert torch.equal(fresh(x), source(x))
