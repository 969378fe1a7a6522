"""The ModelNet entry points as two ranks sharing one card (no JAX: the
card's machine has none).

``torchrun --nproc_per_node 2`` with ``--device cuda`` on a host with one
card: the two ranks share it over gloo (``cli.rank_device``; NCCL
refuses two ranks on one device). ``cli.train_modelnet --mode dense``
(N=512, a global batch of 2) on three train files and one test file of
two shapes each: every rank reads every record, so each trains on the
six shapes in three steps and the evaluation runs on both test shapes;
rank 0 alone writes one log and one checkpoint. ``cli.evaluate_modelnet``
(2 votes) on that checkpoint: rank 0 alone reports and writes the votes.
Skipped without a card.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as W


@pytest.mark.cuda
def test_modelnet_cli_as_two_ranks_sharing_the_card(tmp_path):
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a host with one CUDA device: two ranks share it")
    W.write_modelnet_records(tmp_path, "train", 3)
    W.write_modelnet_records(tmp_path, "test", 1)
    log_dir = tmp_path / "log"
    root = str(Path(__file__).resolve().parents[1])
    common = ["--data_dir", str(tmp_path), "--log_dir", str(log_dir),
              "--batch_size", "2", "--device", "cuda", "--num_devices", "2"]

    def torchrun(module, *argv):
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", f"sph3d_gcn_torch.cli.{module}",
             *common, *argv], capture_output=True, text=True, timeout=600,
            cwd=root, env={**os.environ, "PYTHONPATH": root})
        assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
        return run.stdout

    out = torchrun("train_modelnet", "--num_input", "512", "--max_epoch",
                   "1", "--mode", "dense")
    assert out.count("train: 6 shapes, test: 2") == 2
    log = (log_dir / "log_train.txt").read_text()
    assert log.count("**** EPOCH 000 ****") == 1
    assert "eval accuracy:" in log and "WARNING" not in log
    scalars = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert scalars[0]["step"] == 3 and np.isfinite(scalars[0]["train_loss"])
    assert sorted(p.name for p in (log_dir / "ckpt").iterdir()) == ["0.pt"]

    out = torchrun("evaluate_modelnet", "--num_votes", "2")
    assert out.count("eval accuracy:") == 1
    assert re.search(r"forwards re-run on the per-edge engine: \d+ of 2",
                     out)
    votes = np.load(log_dir / "pred_votes.npz")["votes"]
    assert votes.shape == (2, 40) and np.isfinite(votes).all()
