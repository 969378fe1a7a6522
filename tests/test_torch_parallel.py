"""PyTorch port vs JAX: the data-parallel plumbing of ``parallel``.

- ``process_shard_files`` and ``local_batch_size`` against JAX's on a
  grid of inputs (JAX's process count patched for the latter), and
  ``shard_batch``'s rows.
- The synced ``BatchNorm`` in train mode at R = 2 and 4 gloo ranks on
  the CPU, two steps, against the world-1 module on the concatenated
  batch: output and input gradient rows, parameter gradients (summed
  over the ranks) and running statistics, each within 1e-6 of its
  largest magnitude (f32 sums in another order); and under
  ``frozen_running_stats`` (the statistics stay put).
- A train step with IDS or random sampling (its draws and the dropout
  masks: each rank's rows of the global batch's) at R = 2 against the
  one-process step on the global batch: loss 1e-5 relative, logits
  1e-4 of their largest magnitude, each gradient leaf 2e-3 relative L2
  (test_torch_parallel_fit.py's).
- A group of one rank runs the one-process step: no collective (no
  process group is joined, so any would raise) and the same operators,
  each as many times, in a train and an eval step.
- A train step whose conv blocks recompute in the backward
  (``remat_blocks``: BN runs again there, synced, its statistics frozen)
  at R = 2, bitwise equal to the step without recompute on each rank.
- The group's collectives; a rank that never reaches a collective
  times out and a rank that raises fails the run, instead of hanging;
  no group forms without a launcher, and NCCL never runs on the CPU.
- The entry points' device and backend for a rank (``cli.rank_device``):
  NCCL for one card a rank, gloo for ranks that share a card or run on
  the CPU.

Every rank is a spawned process (``parallel.run_ranks``, a
``FileStore`` under the test's ``tmp_path``, one torch thread).
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.parallel import (
    local_batch_size as jax_local_batch_size,
    process_shard_files as jax_process_shard_files,
)
from sph3d_gcn_torch.cli import add_parallel_args, rank_device, setup_parallel
from sph3d_gcn_torch.parallel import (
    DataGroup,
    init_data_parallel,
    local_batch_size,
    process_shard_files,
    run_ranks,
    shard_batch,
    spread,
)

from test_torch_cli import one_torch_thread  # noqa: F401

import torch_parallel_workers as W

BN_TOL = 1e-6


@pytest.mark.parametrize("num_files", [0, 1, 5, 10, 13])
def test_process_shard_files_matches_jax(num_files):
    files = [f"f{i}.tfrecord" for i in range(num_files)]
    for count in range(1, 6):
        for index in range(count):
            assert (process_shard_files(files, index, count)
                    == jax_process_shard_files(files, index, count))
    # no process group: every file, as JAX's one process
    assert process_shard_files(files) == jax_process_shard_files(files)


def test_local_batch_size_matches_jax(monkeypatch):
    assert local_batch_size(16) == jax_local_batch_size(16) == 16
    for count in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jax, "process_count", lambda: count)
        for batch in (8, 12, 15, 16, 32):
            try:
                want = jax_local_batch_size(batch)
            except ValueError:
                with pytest.raises(ValueError, match="does not split"):
                    local_batch_size(batch, count)
            else:
                assert local_batch_size(batch, count) == want


def test_shard_batch_rows():
    batch = {"points": np.arange(24.0).reshape(4, 2, 3),
             "label": np.arange(4)}
    assert shard_batch(batch, None) is batch
    for rank in range(2):
        group = DataGroup(rank=rank, size=2, device=torch.device("cpu"))
        got = shard_batch(batch, group)
        np.testing.assert_array_equal(got["label"],
                                      [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(got["points"],
                                      batch["points"][2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, DataGroup(rank=0, size=3,
                                     device=torch.device("cpu")))


@pytest.mark.parametrize("ranks,frozen", [(2, False), (4, False),
                                          (2, True)])
def test_synced_batch_norm_matches_the_global_batch(ranks, frozen,
                                                    tmp_path):
    rng = np.random.default_rng(ranks)
    x = (rng.standard_normal((4, 96, 8)) * 3 + 2).astype(np.float32)
    ct = rng.standard_normal((4, 96, 8)).astype(np.float32)
    ref = W.batch_norm(None, x, ct, 2, frozen)
    if frozen:
        assert not ref["mean"].any() and (ref["var"] == 1).all()
    out = run_ranks(W.batch_norm, ranks, (x, ct, 2, frozen),
                    store_dir=str(tmp_path), timeout=90)
    for key, want in ref.items():
        if key in ("out", "dx"):
            got = np.concatenate([o[key] for o in out])
        else:
            got = out[0][key]
            for o in out[1:]:                 # every rank alike, bitwise
                np.testing.assert_array_equal(o[key], got)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < BN_TOL, (key, err)


@pytest.mark.parametrize("sample", ["IDS", "random"])
def test_sampling_draws_are_the_global_batch_rows(sample, tmp_path):
    from sph3d_gcn_torch.data.synthetic import surface_clouds

    rng = np.random.default_rng(9)
    batch = {"points": surface_clouds(rng, 2, 512).astype(np.float32),
             "label": rng.integers(0, 40, 2).astype(np.int32)}
    spec = W.narrow_modelnet_spec(sample=sample)
    ref = W.train_step(None, spec, batch, 5)
    ranks = run_ranks(W.train_step, 2, (spec, batch, 5),
                      store_dir=str(tmp_path), timeout=90)
    assert abs(ranks[0]["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    logits = np.concatenate([r["logits"] for r in ranks])
    np.testing.assert_allclose(logits, ref["logits"], rtol=0,
                               atol=1e-4 * np.abs(ref["logits"]).max())
    for k, want in ref["grads"].items():
        np.testing.assert_array_equal(ranks[0]["grads"][k],
                                      ranks[1]["grads"][k])
        err = np.linalg.norm(ranks[0]["grads"][k] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert err < 2e-3, (k, err)


def test_group_of_one_runs_the_one_process_ops():
    from torch.profiler import ProfilerActivity, profile

    from sph3d_gcn_torch.data.synthetic import surface_clouds

    rng = np.random.default_rng(3)
    batch = {"points": torch.from_numpy(
        surface_clouds(rng, 2, 512).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 40, 2).astype(np.int32))}
    spec = W.narrow_modelnet_spec()
    counts = []
    for group in (None, DataGroup(rank=0, size=1,
                                  device=torch.device("cpu"))):
        factory = W.build_factory(spec, group)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            factory.train_step(batch, torch.Generator().manual_seed(0))
            factory.eval_step(batch)
        counts.append({e.key: e.count for e in prof.key_averages()})
    assert counts[0] == counts[1]


def test_remat_step_under_a_group(tmp_path):
    from sph3d_gcn_torch.data.synthetic import surface_clouds

    rng = np.random.default_rng(8)
    batch = {"points": surface_clouds(rng, 2, 512).astype(np.float32),
             "label": rng.integers(0, 40, 2).astype(np.int32)}
    ranks = run_ranks(W.remat_equal, 2, (W.narrow_modelnet_spec(), batch, 2),
                      store_dir=str(tmp_path), timeout=90)
    assert ranks == [{"loss": True, "grads": True, "state": True}] * 2


def test_collectives(tmp_path):
    out = run_ranks(W.collectives, 2, store_dir=str(tmp_path), timeout=60)
    for o in out:
        assert o["sums"] == [2.0, 1.0]
        np.testing.assert_array_equal(
            o["gathered"], np.repeat([[0.0], [1.0]], 2, axis=0).repeat(3, 1))
        assert o["spread"]
    # a group of one rank, like none, runs no collective in a step
    assert not spread(DataGroup(rank=0, size=1, device=torch.device("cpu")))
    assert not spread(None)


@pytest.mark.parametrize("name,local_rank,local_ranks,cards,want", [
    ("cpu", 1, 4, 0, ("cpu", "gloo")),
    ("cuda", 0, 1, 1, ("cuda:0", "nccl")),
    ("cuda", 3, 4, 4, ("cuda:3", "nccl")),
    ("cuda", 1, 2, 1, ("cuda:0", "gloo")),     # two ranks, one card
    ("cuda", 5, 8, 4, ("cuda:1", "gloo")),
    ("cuda:0", 1, 2, 4, ("cuda:0", "gloo")),   # every rank names card 0
    ("cuda:2", 0, 1, 4, ("cuda:2", "nccl")),
])
def test_rank_device_picks_the_backend(name, local_rank, local_ranks, cards,
                                       want):
    device, backend = rank_device(name, local_rank, local_ranks, cards)
    assert (str(device), backend) == want


def test_a_stalled_or_failed_rank_raises(tmp_path):
    with pytest.raises(TimeoutError, match="ran past"):
        run_ranks(W.stall, 2, store_dir=str(tmp_path), timeout=15)
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        run_ranks(W.fail, 2, store_dir=str(tmp_path), timeout=60)


def test_no_silent_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_data_parallel("cpu")
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        init_data_parallel("cpu", "nccl")
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    add_parallel_args(parser)
    assert setup_parallel(parser.parse_args([])) == (torch.device("cpu"),
                                                      None)
    with pytest.raises(ValueError, match="torchrun"):
        setup_parallel(parser.parse_args(["--num_devices", "2"]))
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="process group has 2 ranks"):
        setup_parallel(parser.parse_args(["--num_devices", "4"]))
    # ranks that span hosts need no flag: the group is joined (here it
    # cannot form, and that raises)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        setup_parallel(parser.parse_args(["--multihost"]))
