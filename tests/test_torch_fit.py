"""PyTorch port vs JAX: the training loop ``train.loop.fit`` and the BN
priming step.

- ``fit`` against JAX's ``fit``: a one-level f32 ModelNet classifier
  (``modelnet_config(num_input=512)``, the published channels) starts on
  both sides from one JAX ``init_state`` (carried across by
  ``utils.convert``), dropout the identity on both (a flax interceptor;
  rate 0 in the port), and runs one epoch of two batches of 2 plus an
  eval pass of 3 clouds (the short batch padded). Final parameters:
  relative L2 error per leaf within 2e-3 (test_torch_train.py's f32
  gradient tolerance; two Adam steps); BN statistics within 1e-5; the
  log lines equal but for the ms figure, their numbers within 1e-4
  relative (f32 losses summed in other orders), and ``metrics.jsonl``
  the same keys and values within that.
- ``StepFactory.prime_step`` against JAX's on the state after ``fit``:
  every BN statistic within 1e-4 relative L2 (a batch statistic
  recovered as (new - 0.99 old) / 0.01 magnifies f32 rounding by 100);
  the running statistics unchanged, bitwise.
- Port only, bitwise on the CPU: two epochs straight equal one epoch and
  a resume (dropout on: each step's generator comes from the seed and
  the step count); ``fit``'s in-loop fallback on a dense scene batch
  that its windows do not cover (the log names the classic re-run; the
  parameters equal a direct per-edge step from the same state; the eval
  batch re-runs too), and ``on_dense_violation="raise"``; BN priming
  changes the eval pass and leaves the trained model bitwise as it is.
- ``train.profiling``: the throughput line equals JAX's on the same
  counts; a ``fit`` under ``trace`` writes a Chrome trace holding its
  ``fit_step`` spans.

JAX's side is built once per module.
"""

import dataclasses
import json
import re

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_tpu.train.loop import fit as jax_fit
from sph3d_gcn_tpu.train.profiling import (
    ThroughputTracker as JaxThroughputTracker,
)
from sph3d_gcn_tpu.train.schedule import make_optimizer as jax_make_optimizer
from sph3d_gcn_tpu.train.steps import (
    classification_step_factory as jax_step_factory,
)
from sph3d_gcn_torch.configs import modelnet_config
from sph3d_gcn_torch.data.synthetic import surface_clouds
from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
from sph3d_gcn_torch.nn.layers import Dropout
from sph3d_gcn_torch.train.loop import fit, step_generator
from sph3d_gcn_torch.train.profiling import ThroughputTracker, trace
from sph3d_gcn_torch.train.schedule import exponential_decay_lr, make_optimizer
from sph3d_gcn_torch.train.steps import (
    classification_step_factory,
    segmentation_step_factory,
)
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_seg_per_edge import _edge_config, _tight_config, _torch_batch
from test_torch_train import _leaves, _no_dropout, _rel

N, BATCH = 512, 2
# narrow widths for the port-only runs: the loop is under test there,
# not the layers
NARROW = dict(mlp=8, channels=((16, 16),), multiplier=((1, 1),),
              global_channels=32, global_multiplier=1)
SCENE_NARROW = dict(mlp=16, channels=((16, 16),) * 4,
                    multiplier=((1, 1),) * 4)
PARAM_TOL, STATS_TOL, LOG_RTOL, PRIME_TOL = 2e-3, 1e-5, 1e-4, 1e-4


def _clouds():
    rng = np.random.default_rng(5)
    return (surface_clouds(rng, 7, N),
            rng.integers(0, 40, 7).astype(np.int32))


def _train_batches(epoch):
    pts, labels = _clouds()
    for i in range(0, 4, BATCH):
        yield {"points": pts[i:i + BATCH], "label": labels[i:i + BATCH]}


def _eval_batches():
    pts, labels = _clouds()
    for i in range(4, 7, BATCH):
        yield {"points": pts[i:i + BATCH], "label": labels[i:i + BATCH]}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's fit, its initial variables, log dir and prime step."""
    cfg = jax_modelnet_config(num_input=N)
    factory = jax_step_factory(
        JaxModelNet(cfg), jax_make_optimizer("adam", 1e-3),
        weight_decay=cfg.weight_decay)
    first = next(_train_batches(0))
    init = factory.init_state(jax.random.key(0), first)
    log_dir = tmp_path_factory.mktemp("jax_fit")
    with fnn.intercept_methods(_no_dropout):
        state = jax_fit(factory, _train_batches, _eval_batches, BATCH, 1,
                        str(log_dir), seed=0)
        prime = factory.prime_step()(state, first, jax.random.key(1))
    return {"init": {"params": init.params, "batch_stats": init.batch_stats},
            "state": state, "log_dir": log_dir, "prime": prime}


def _port_factory(variables, cfg=None, dropout=False):
    cfg = cfg or modelnet_config(num_input=N)
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(
            torch_state_dict_from_flax(variables, model.state_dict()))
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return classification_step_factory(
        model, *make_optimizer(model.parameters(), "adam", 1e-3),
        weight_decay=cfg.weight_decay)


_NUMBER = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def _log(log_dir):
    """The log lines with their decimal numbers taken out, and the
    numbers; the ms figure dropped."""
    lines, numbers = [], []
    for line in (log_dir / "log_train.txt").read_text().splitlines():
        if "milliseconds" in line:
            line = "training one batch require <ms> milliseconds"
        numbers += [float(x) for x in _NUMBER.findall(line)]
        lines.append(_NUMBER.sub("<x>", line))
    return lines, numbers


def test_fit_matches_jax(jax_run, tmp_path):
    factory = _port_factory(jax_run["init"])
    model = fit(factory, _train_batches, _eval_batches, BATCH, 1,
                str(tmp_path), seed=0)
    ours = flax_tree_from_torch(model.state_dict())
    ref = jax_run["state"]
    got_p, ref_p = dict(_leaves(ours["params"])), dict(_leaves(ref.params))
    assert set(got_p) == set(ref_p)
    errs = {k: _rel(got_p[k], ref_p[k]) for k in ref_p}
    assert max(errs.values()) < PARAM_TOL, max(errs.items(),
                                               key=lambda kv: kv[1])
    got_s = dict(_leaves(ours["batch_stats"]))
    for k, v in _leaves(ref.batch_stats):
        np.testing.assert_allclose(got_s[k], np.asarray(v), rtol=0,
                                   atol=STATS_TOL)
    lines, numbers = _log(tmp_path)
    ref_lines, ref_numbers = _log(jax_run["log_dir"])
    assert lines == ref_lines
    np.testing.assert_allclose(numbers, ref_numbers, rtol=LOG_RTOL)
    got = [json.loads(x) for x in
           (tmp_path / "metrics.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in
            (jax_run["log_dir"] / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    for g, w in zip(got, want):
        for k in w:
            if k != "ms_per_batch":
                np.testing.assert_allclose(g[k], w[k], rtol=LOG_RTOL)
    assert factory.scheduler.last_epoch == 2


def test_prime_step_matches_jax(jax_run):
    state = jax_run["state"]
    factory = _port_factory({"params": state.params,
                             "batch_stats": state.batch_stats})
    before = {k: v.clone() for k, v in factory.model.state_dict().items()}
    pts, labels = next(_train_batches(0)).values()
    stats = factory.prime_step({"points": torch.from_numpy(pts),
                                "label": torch.from_numpy(labels)})
    after = factory.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    got = dict(_leaves(flax_tree_from_torch(stats)["batch_stats"]))
    ref = dict(_leaves(jax_run["prime"]))
    assert set(got) == set(ref)
    errs = {k: _rel(got[k], ref[k]) for k in ref}
    assert max(errs.values()) < PRIME_TOL, errs


def _dense_factory():
    """A one-level dense classifier with dropout on and a decaying rate."""
    cfg = dataclasses.replace(modelnet_config(num_input=N, fast=True,
                                              dense=True), windows=(512,),
                              **NARROW)
    factory = _port_factory(None, cfg, dropout=True)
    factory.optimizer, factory.scheduler = make_optimizer(
        factory.model.parameters(), "adam",
        exponential_decay_lr(1e-3, batch_size=BATCH, decay_step=4))
    return factory


def test_resume_equals_an_uninterrupted_run(tmp_path):
    straight = fit(_dense_factory(), _train_batches, None, BATCH, 2,
                   str(tmp_path / "straight"), seed=3)
    fit(_dense_factory(), _train_batches, None, BATCH, 1,
        str(tmp_path / "resumed"), seed=3)
    factory = _dense_factory()
    resumed = fit(factory, _train_batches, None, BATCH, 2,
                  str(tmp_path / "resumed"), seed=3)
    log = (tmp_path / "resumed" / "log_train.txt").read_text()
    assert "resumed from epoch 0" in log and "EPOCH 001" in log
    ref = straight.state_dict()
    assert all(torch.equal(v, ref[k])
               for k, v in resumed.state_dict().items())
    assert factory.scheduler.last_epoch == 4
    assert factory.optimizer.param_groups[0]["lr"] == 1e-3 * 0.7 ** 2


def test_bn_priming_leaves_training_alone(tmp_path):
    """``bn_prime_steps``: the eval pass runs on primed statistics (its
    loss changes), the training statistics are put back (the trained
    model equals a run without priming, bitwise)."""
    runs = {}
    for prime in (0, 2):
        log_dir = tmp_path / str(prime)
        model = fit(_dense_factory(), _train_batches, _eval_batches, BATCH,
                    1, str(log_dir), seed=2, bn_prime_steps=prime)
        runs[prime] = (model.state_dict(),
                       (log_dir / "log_train.txt").read_text())
    (plain, log0), (primed, log2) = runs[0], runs[2]
    assert all(torch.equal(v, primed[k]) for k, v in plain.items())
    assert "primed BN stats over 2 batches" in log2
    assert "primed" not in log0
    eval_loss = [[x for x in log.splitlines() if "eval mean loss" in x]
                 for log in (log0, log2)]
    assert eval_loss[0] != eval_loss[1]


def _scene_factory(cfg, state):
    model = SPH3DSceneSeg(cfg)
    model.load_state_dict(state)
    return segmentation_step_factory(model, *make_optimizer(
        model.parameters(), "adam", 1e-3), inner_masked=True)


def test_fit_reruns_a_failed_dense_batch_on_the_per_edge_engine(tmp_path):
    tight = dataclasses.replace(_tight_config(), **SCENE_NARROW)
    model = SPH3DSceneSeg(tight,
                          generator=torch.Generator().manual_seed(0))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: v.numpy() for k, v in _torch_batch().items()}
    factory = _scene_factory(tight, state0)
    fit(factory, lambda epoch: iter([batch]), lambda: iter([batch]), 1, 1,
        str(tmp_path), seed=4)
    log = (tmp_path / "log_train.txt").read_text()
    assert log.count("building the classic-engine fallback") == 1
    assert "during epoch 0 batch 0 (violation #1); re-running via the " \
           "classic engine" in log
    assert "during epoch 0 eval (violation #2)" in log
    assert "violations total: 2 (all re-run" in log

    direct = _scene_factory(_edge_config(**SCENE_NARROW), state0)
    direct.train_step(_torch_batch(), step_generator(4, 0, "cpu"))
    ref = direct.model.state_dict()
    assert all(torch.equal(v, ref[k])
               for k, v in factory.model.state_dict().items())
    assert any(not torch.equal(v, state0[k]) for k, v in ref.items())
    assert factory.scheduler.last_epoch == 1
    assert len(factory.optimizer.state) == len(direct.optimizer.state)

    raising = _scene_factory(tight, state0)
    with pytest.raises(RuntimeError, match="coverage violated"):
        fit(raising, lambda epoch: iter([batch]), None, 1, 1,
            str(tmp_path / "raise"), on_dense_violation="raise")


def test_profiling(tmp_path):
    ours, theirs = ThroughputTracker(1024, 2), JaxThroughputTracker(1024, 2)
    for tracker in (ours, theirs):
        with tracker.step():
            pass
        tracker.steps, tracker.seconds = 3, 0.125
    assert ours.json_line("pts", 4000.0) == theirs.json_line("pts", 4000.0)
    assert ours.ms_per_step == theirs.ms_per_step
    with pytest.raises(RuntimeError):
        ours.stop()
    with trace(str(tmp_path)):
        fit(_dense_factory(), _train_batches, None, BATCH, 1,
            str(tmp_path / "log"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "fit_step" for e in events) == 2
