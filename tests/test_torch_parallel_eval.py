"""The port's evaluation paths and its ModelNet entry points at R = 2
gloo ranks on the CPU (``parallel.run_ranks``) against one process (no
JAX).

- ``checked_forward`` under ``vote_classify`` and ``checked_eval_step``
  on a batch whose certificate fails on rank 1's rows only (the narrow
  dense classifier of test_torch_parallel_fit.py at 384-row windows):
  every rank re-runs on the per-edge engine and returns the whole
  batch's votes, logits and item losses, equal to one process's within
  1e-5 of their largest magnitude; rank 1 prints nothing.
- ``checked_forward`` on batches of 1 and 3 clouds, which do not split
  over two ranks: padded with repeats of the last cloud, the logits
  trimmed back, equal to one process's within 1e-5 of their largest
  magnitude.
- ``cli.train_modelnet --device cpu --mode parity`` (f32) as two ranks
  on three train files and one test file (ranks that split the files
  would leave one of them without a test file): every rank reads every
  record, so every shape is trained on and evaluated; the ranks end
  bitwise alike and as one process ends, each parameter leaf within
  ``CLI_TOL`` relative L2 (test_torch_parallel_fit.py's ``PARAM_TOL``:
  three Adam steps from f32 sums in another order; the same run in bf16
  moves BN biases of ~3e-3 by 2e-3 where a near-zero gradient's sign
  flips, so it is not compared); rank 0 writes one log and one
  checkpoint; ``cli.evaluate_modelnet`` on that checkpoint as two ranks
  against one process: votes within 1e-2 of their largest magnitude.

The same entry points as two ranks sharing the card are
test_torch_parallel_card.py's.
"""

import json

import numpy as np

from sph3d_gcn_torch.cli import evaluate_modelnet
from sph3d_gcn_torch.parallel import run_ranks
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_parallel_fit import N, _clouds, _same, failing_batch

import torch_parallel_workers as W

EVAL_TOL, VOTE_TOL, CLI_TOL = 1e-5, 1e-2, 2e-3


def test_checked_eval_paths_rerun_on_every_rank(tmp_path):
    spec, batch = W.narrow_modelnet_spec(windows=(384,)), failing_batch()
    ref = W.eval_paths(None, spec, batch)
    ranks = run_ranks(W.eval_paths, 2, (spec, batch),
                      store_dir=str(tmp_path), timeout=120)
    assert "re-ran on the classic per-edge engine" in ref["printed"]
    assert "re-ran on the classic per-edge engine" in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""
    for key in ("votes", "logits", "item_loss"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        scale = np.abs(ref[key]).max()
        np.testing.assert_allclose(ranks[0][key], ref[key], rtol=0,
                                   atol=EVAL_TOL * scale, err_msg=key)
    assert abs(ranks[0]["loss"] - ref["loss"]) <= EVAL_TOL * abs(ref["loss"])


def test_checked_forward_pads_a_batch_that_does_not_split(tmp_path):
    spec = W.narrow_modelnet_spec()
    pts, _ = _clouds(3, 11)
    batch = {"points": pts}
    ref = W.odd_forwards(None, spec, batch)
    ranks = run_ranks(W.odd_forwards, 2, (spec, batch),
                      store_dir=str(tmp_path), timeout=120)
    for key, want in ref.items():
        assert ranks[0][key].shape == want.shape == (len(want), 40)
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        np.testing.assert_allclose(ranks[0][key], want, rtol=0,
                                   atol=EVAL_TOL * np.abs(want).max(),
                                   err_msg=key)


def test_modelnet_cli_as_two_ranks(tmp_path):
    W.write_modelnet_records(tmp_path, "train", 3)
    W.write_modelnet_records(tmp_path, "test", 1)
    log_dir = tmp_path / "log"
    common = ["--data_dir", str(tmp_path), "--log_dir", str(log_dir),
              "--batch_size", "2", "--device", "cpu"]
    ranks = ["--num_devices", "2"]
    train = ["--num_input", str(N), "--max_epoch", "1", "--mode", "parity"]
    r0, r1 = run_ranks(W.cli_main, 2, ("train_modelnet",
                                       common + ranks + train),
                       store_dir=str(tmp_path), timeout=240)
    _same(r0, r1)
    log = (log_dir / "log_train.txt").read_text()
    assert log.count("**** EPOCH 000 ****") == 1
    assert "eval accuracy:" in log and "violated" not in log
    assert "WARNING" not in log
    scalars = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    # six shapes at a global batch of two: three steps, on every shape
    assert scalars[0]["step"] == 3 and np.isfinite(scalars[0]["train_loss"])
    assert sorted(p.name for p in (log_dir / "ckpt").iterdir()) == ["0.pt"]
    one = W.cli_main(None, "train_modelnet",
                     [*common[:3], str(tmp_path / "one"), *common[4:],
                      *train])
    for k, want in one.items():
        if not k.endswith(("mean", "var")):
            err = np.linalg.norm(r0[k] - want) / max(np.linalg.norm(want),
                                                     1e-30)
            assert err < CLI_TOL, (k, err)

    argv = common + ["--num_votes", "2"]
    e0, e1 = run_ranks(W.cli_main, 2, ("evaluate_modelnet", argv + ranks),
                       store_dir=str(tmp_path), timeout=240)
    one = evaluate_modelnet.main(argv)
    assert e0["forwards"] == one["forwards"] == 2
    assert e0["reruns"] == one["reruns"]
    np.testing.assert_array_equal(e0["votes"], e1["votes"])
    scale = np.abs(one["votes"]).max()
    np.testing.assert_allclose(e0["votes"], one["votes"], rtol=0,
                               atol=VOTE_TOL * scale)

