"""The port's parity and profiling tools on the CPU.

- ``utils.numpy_reference``'s vectorized ops against the JAX package's
  loop oracle ``sph3d_gcn_tpu.ops._ref`` at small N, as
  ``tests/test_numpy_reference.py`` holds JAX's copy (indices and bins
  exact, values to 1e-6), and its forwards equal to JAX's copy
  (``scripts/numpy_reference.py``) where the two share a config.
- The port's models against the oracle forward, BN statistics
  calibrated (``cli.parity_check.calibrate_batch_norm``) so that the
  logits are of order 1: ModelNet on the per-edge engine and, on a cloud
  sorted beforehand, on the dense engine in f32; the scene model with
  the mean and the weighted unpool on the per-edge engine and on the
  dense engine at full width; all within rtol = atol = 1e-4.
- The per-edge query's in-range test (the matmul form, as JAX's) against
  the oracle's difference form: where they disagree, the point lies
  within the matmul form's rounding of the threshold.
- ``cli.parity_check --oracle --device cpu`` exits 0; checkpoint mode
  exits 0 on a TF1 bundle written from a seeded model with its captured
  logits, and 1 once one variable of the bundle is perturbed.
- ``cli.profile_step --device cpu`` prints its tables; the trace reader
  of ``train.profiling`` (busy time, idle share, the table by name with
  ``min_us``, the device time by layer and by autograd node) on a
  synthetic trace.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import _ref
from sph3d_gcn_torch.cli import parity_check, profile_step
from sph3d_gcn_torch.configs import SPH3DConfig, modelnet_config, s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
from sph3d_gcn_torch.models.common import normalize_unit_sphere
from sph3d_gcn_torch.ops.locality import permute_points, spatial_sort
from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor
from sph3d_gcn_torch.utils import numpy_reference as npref
from sph3d_gcn_torch.utils.checkpoint_convert import tf_variables
from sph3d_gcn_torch.utils.convert import flax_tree_from_torch
from sph3d_gcn_torch.utils.tf1_bundle import write_bundle
from test_torch_cli import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy_reference as jax_npref  # noqa: E402

TOL = 1e-4


def _cloud(rng, b, n, d=3):
    return rng.standard_normal((b, n, d)).astype(np.float32)


def test_sphere_query_matches_loop_oracle():
    rng = np.random.default_rng(0)
    db, q = _cloud(rng, 2, 120), _cloud(rng, 2, 40)
    for radius, k in [(0.5, 6), (0.9, 12)]:
        ri, rc, rd = _ref.sphere_neighbor(db, q, radius, k)
        gi, gc, gd = npref.sphere_neighbor(db, q, radius, k)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gc, rc)
        np.testing.assert_allclose(gd, rd, rtol=1e-6, atol=0)


def test_fps_and_kernel_match_loop_oracle():
    rng = np.random.default_rng(1)
    db = _cloud(rng, 2, 100)
    np.testing.assert_array_equal(npref.farthest_point_sample(30, db),
                                  _ref.farthest_point_sample(30, db))
    idx, cnt, dist = _ref.sphere_neighbor(db, db, 0.7, 8)
    np.testing.assert_array_equal(
        npref.spherical_kernel(db, db, idx, cnt, dist, 0.7, (8, 2, 2)),
        _ref.spherical_kernel(db, db, idx, cnt, dist, 0.7, (8, 2, 2)))


def test_conv_pool_unpools_match_loop_oracle():
    rng = np.random.default_rng(2)
    db, feats = _cloud(rng, 2, 90), _cloud(rng, 2, 90, 5)
    filt = rng.standard_normal((33, 5, 2)).astype(np.float32)
    idx, cnt, dist = _ref.sphere_neighbor(db, db, 0.7, 7)
    bins = _ref.spherical_kernel(db, db, idx, cnt, dist, 0.7, (8, 2, 2))
    np.testing.assert_allclose(
        npref.depthwise_conv3d(feats, filt, idx, cnt, bins),
        _ref.depthwise_conv3d(feats, filt, idx, cnt, bins),
        rtol=1e-6, atol=1e-6)
    out_v, arg_v = npref.max_pool3d(feats, idx, cnt)
    out_r, arg_r = _ref.max_pool3d(feats, idx, cnt)
    np.testing.assert_array_equal(out_v, out_r)
    np.testing.assert_array_equal(arg_v, arg_r)
    np.testing.assert_allclose(npref.mean_interpolate(feats, idx, cnt),
                               _ref.mean_interpolate(feats, idx, cnt),
                               rtol=1e-6, atol=1e-6)
    w = rng.random((2, 90, 7)).astype(np.float32)
    np.testing.assert_allclose(
        npref.weighted_interpolate(feats, w, idx, cnt),
        _ref.weighted_interpolate(feats, w, idx, cnt), rtol=1e-6, atol=1e-6)


def _scene_cfg(unpool, **kw):
    """JAX's narrow scene config of ``tests/test_numpy_reference.py``."""
    return SPH3DConfig(
        num_input=64, num_cls=5, mlp=8, num_sample=(32, 16),
        radius=(1.5, 3.0), nn_uplimit=(8, 8), channels=((8, 8), (16, 16)),
        multiplier=((2, 2), (2, 2)), weight_decay=None,
        unpool_method=unpool, **kw)


def _calibrated(model, calibration):
    parity_check.calibrate_batch_norm(model, torch.from_numpy(calibration))
    return model


def _logits(model, points):
    with torch.no_grad():
        return model(torch.from_numpy(points)).numpy()


def _oracle(cfg, model, points):
    return parity_check.oracle_forward(
        cfg, flax_tree_from_torch(model.state_dict()), points)


@pytest.mark.parametrize("unpool", ["mean", "weighted"])
def test_forwards_equal_the_jax_copy(unpool):
    rng = np.random.default_rng(3)
    cfg = modelnet_config(num_input=512)
    model = _calibrated(SPH3DModelNet(cfg, torch.Generator().manual_seed(0)),
                        surface_clouds(rng, 8, 512))
    pts = surface_clouds(rng, 2, 512)
    variables = flax_tree_from_torch(model.state_dict())
    np.testing.assert_array_equal(
        npref.forward_modelnet(variables, cfg, pts),
        jax_npref.forward_modelnet(variables, cfg, pts))
    cfg = _scene_cfg(unpool)
    model = _calibrated(SPH3DSceneSeg(cfg, torch.Generator().manual_seed(1)),
                        _cloud(rng, 8, 64, 9))
    pts = _cloud(rng, 2, 64, 9)
    variables = flax_tree_from_torch(model.state_dict())
    np.testing.assert_array_equal(
        npref.forward_scene_seg(variables, cfg, pts),
        jax_npref.forward_scene_seg(variables, cfg, pts))


def _sorted(points, cfg):
    """``points`` in the model's own sort order; the model's sort of them
    is then the identity."""
    x = torch.from_numpy(points)
    perm, _ = spatial_sort(x, cfg.radius[0])
    x = permute_points(x, perm)
    again, _ = spatial_sort(x, cfg.radius[0])
    assert torch.equal(again, torch.arange(x.shape[1]).expand_as(again))
    return x.numpy()


@pytest.mark.parametrize("dense", [False, True])
def test_modelnet_matches_the_oracle(dense):
    rng = np.random.default_rng(4)
    n = 512
    cfg = modelnet_config(num_input=n)
    if dense:
        cfg = dataclasses.replace(modelnet_config(num_input=n, fast=True,
                                                  dense=True),
                                  compute_dtype="float32")
    model = _calibrated(SPH3DModelNet(cfg, torch.Generator().manual_seed(2)),
                        surface_clouds(rng, 8, n))
    pts = surface_clouds(rng, 2, n)
    if dense:
        pts = _sorted(pts, cfg)
    got = _logits(model, pts)
    assert bool(model.dense_ok)
    ref = _oracle(cfg, model, pts)
    assert np.abs(ref).max() > 1.0         # calibrated: order-1 logits
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("unpool", ["mean", "weighted"])
def test_narrow_scene_model_matches_the_oracle(unpool):
    rng = np.random.default_rng(5)
    cfg = _scene_cfg(unpool)
    model = _calibrated(SPH3DSceneSeg(cfg, torch.Generator().manual_seed(3)),
                        _cloud(rng, 8, 64, 9))
    pts = _cloud(rng, 2, 64, 9)
    np.testing.assert_allclose(_logits(model, pts), _oracle(cfg, model, pts),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("unpool", ["mean", "weighted"])
def test_dense_scene_model_matches_the_oracle(unpool):
    rng = np.random.default_rng(6)
    n = 1024
    cfg = dataclasses.replace(s3dis_config(num_input=n, fast=True, dense=True),
                              compute_dtype="float32", unpool_method=unpool,
                              windows=(512, 256, 128, 128),
                              dec_windows=(256, 128, 128, 128),
                              growth_steps=8)
    model = _calibrated(SPH3DSceneSeg(cfg, torch.Generator().manual_seed(4)),
                        scene_blocks(rng, 2, n))
    pts = _sorted(scene_blocks(rng, 1, n), cfg)
    got = _logits(model, pts)
    assert bool(model.dense_ok)
    np.testing.assert_allclose(got, _oracle(cfg, model, pts), rtol=TOL,
                               atol=TOL)


def test_per_edge_in_range_test_differs_only_at_the_threshold():
    """The matmul form's in-range decisions (the per-edge query's, as the
    JAX op's) against the oracle's difference form on a cloud where they
    disagree (one pair of points of the 8.4e6, each in the other's row,
    5.7e-7 past the threshold in the difference form): every point decided
    differently lies within 4e-6 (the rounding of ``|q|^2 - 2 q.p +
    |p|^2`` at unit coordinates, over 2r) of the threshold ``r - 1e-6``."""
    radius, n = 0.1, 2048
    x = normalize_unit_sphere(torch.from_numpy(
        surface_clouds(np.random.default_rng(0), 2, n)))
    nbh = build_sphere_neighbor(x, x, radius=radius, nn_sample=n,
                                self_graph=True)
    port = np.zeros((2, n, n), bool)
    b, q, k = np.nonzero(np.arange(n) < nbh.count.numpy()[..., None])
    port[b, q, nbh.idx.numpy()[b, q, k]] = True
    pts = x.numpy()
    delta = pts[:, None, :, :] - pts[:, :, None, :]
    d = np.sqrt(np.sum(delta * delta, axis=-1, dtype=np.float32))
    oracle = (d < radius) & (np.abs(d - np.float32(radius)) > 1e-6)
    differ = port != oracle
    assert differ.sum() < 1e-5 * differ.size
    assert np.all(np.abs(d[differ] - (radius - 1e-6)) < 4e-6)


@pytest.mark.parametrize("model", ["modelnet", "s3dis"])
def test_parity_cli_oracle_on_the_cpu(model, capsys):
    with pytest.raises(SystemExit) as exit_:
        parity_check.main(["--model", model, "--oracle", "--num_input",
                           "512", "--batch_size", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert exit_.value.code == 0, out
    assert f"PARITY[{model}, oracle, N=512]: PASS" in out
    assert "max abs diff" in out and "argmax agreement: 1.0000" in out


def test_parity_cli_checkpoint_mode(tmp_path, capsys):
    rng = np.random.default_rng(7)
    n = 512
    model = _calibrated(SPH3DModelNet(modelnet_config(num_input=n),
                                      torch.Generator().manual_seed(5)),
                        surface_clouds(rng, 8, n))
    pts = surface_clouds(rng, 2, n)
    batch = tmp_path / "batch.npz"
    np.savez(batch, points=pts, logits=_logits(model, pts))
    variables = tf_variables(model.state_dict())
    argv = ["--model", "modelnet", "--batch", str(batch), "--device", "cpu"]
    write_bundle(str(tmp_path / "good" / "model.ckpt-1"), variables)
    with pytest.raises(SystemExit) as exit_:
        parity_check.main(argv + ["--ckpt",
                                  str(tmp_path / "good" / "model.ckpt-1")])
    out = capsys.readouterr().out
    assert exit_.value.code == 0, out
    assert "PARITY[modelnet, checkpoint, N=512]: PASS" in out
    # one BN offset of the head moved by 0.05: the logits move with it
    name = next(k for k in variables if k.startswith("fc2/") and
                k.endswith("beta"))
    variables[name] = variables[name] + np.float32(0.05)
    write_bundle(str(tmp_path / "bad" / "model.ckpt-1"), variables)
    with pytest.raises(SystemExit) as exit_:
        parity_check.main(argv + ["--ckpt",
                                  str(tmp_path / "bad" / "model.ckpt-1")])
    out = capsys.readouterr().out
    assert exit_.value.code == 1, out
    assert "PARITY[modelnet, checkpoint, N=512]: FAIL" in out


def test_profile_step_prints_its_tables_on_the_cpu(capsys):
    out = profile_step.main(["--device", "cpu", "--batch_size", "2",
                             "--num_input", "512", "--fast", "--dense",
                             "--top", "5"])
    text = capsys.readouterr().out
    assert "host time by op" in text and "by layer" in text
    assert "hand-written kernels a step against their bounds" in text
    kernels = {r["kernel"]: r for r in out["kernels"]}
    # a dense ModelNet step at one level: 1 FPS, 2 queries (intra, pool),
    # 2 convs and their backwards, 1 pool and its backward
    assert {k: r["calls"] for k, r in kernels.items()} == {
        "fps": 1, "dense_query": 2, "dense_conv": 2, "dense_conv_bwd": 2,
        "rank_pool": 1, "rank_pool_bwd": 1}
    assert all(r["bound_ms"] > 0 and r["ms"] is None
               for r in kernels.values())
    assert out["dense_ok"] and out["busy_ms"] is None
    assert {"conv1", "level1.graph", "level1.pool"} <= set(out["by_layer"])
    # a warm step, the timed ones, the traced ones, then the layer pass
    assert out["steps_run"] == (1 + profile_step.UNTRACED_STEPS
                                + profile_step.TRACED_STEPS
                                + profile_step.LAYER_STEPS)


def _trace():
    """A synthetic chrome trace of two spans ``step`` (the first is not
    counted): in the second, a forward launch inside ``layer:conv1`` on
    thread 1, a backward launch inside an autograd node on thread 2 and
    a launch outside any layer; device events by correlation id."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "step", "ts": 0,
           "dur": 50, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 100,
           "dur": 100, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "layer:conv1",
           "ts": 105, "dur": 20, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "tid": 2, "ts": 130, "dur": 30,
           "name": "autograd::engine::evaluate_function: "
                   "_DenseConvBackward0"}]
    for corr, ts, tid, name, start, dur in (
            (1, 10, 1, "void fps_kernel<4, true>(float const*)", 12, 5),
            (2, 110, 1, "void (anonymous namespace)::dense_conv_kernel<f>",
             112, 10),
            (3, 140, 2, "void dx_kernel<float, 1, 2>(signed char const*)",
             141, 20),
            (4, 170, 1, "void at::native::reduce_kernel<128, 4>", 165, 30)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": ts, "dur": 1, "tid": tid,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "args": {"correlation": corr}})
    return ev


def test_trace_reader_on_a_synthetic_trace(capsys):
    from sph3d_gcn_torch.ops.costs import kernel_of
    from sph3d_gcn_torch.train.profiling import (
        device_time_by_layer,
        report_trace,
    )

    out = report_trace(_trace(), "step", 1, span="step", min_us=15)
    text = capsys.readouterr().out
    # busy: [112, 122] + [141, 161] + [165, 195] = 60 us of a 100 us span
    assert out["wall_ms"] == pytest.approx(0.1)
    assert out["busy_ms"] == pytest.approx(0.06)
    assert out["idle"] == pytest.approx(0.4)
    assert "idle share 0.400, 3 device events" in text
    assert len(out["by_name"]) == 3 and "fps" not in text
    # min_us drops the 10 us conv from the printed table only
    assert "dense_conv_kernel" not in text and "dx_kernel" in text
    assert {kernel_of(n) for n in out["by_name"]} == {
        "dense_conv", "dense_conv_bwd", None}
    layers = device_time_by_layer(_trace(), "step")
    assert layers == {"conv1": [pytest.approx(0.01), 1.0],
                      "backward: _DenseConvBackward": [pytest.approx(0.02),
                                                       1.0],
                      "(no layer)": [pytest.approx(0.03), 1.0]}
