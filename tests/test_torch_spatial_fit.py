"""PyTorch port: the re-runs of a point-sharded batch whose halos or
windows breached, and ``--point_devices``, on two gloo ranks against one
process.

One ``parallel.RankPool`` of two CPU ranks (one point group) serves the
file; the states are held as test_torch_spatial_seg.py's ``_near``
holds them.

- ``fit`` on a batch whose inter-level halos breach (the test narrows
  them to one block at 1x, ``narrow_inter_halos``): the step and the
  eval re-run sharded at 2x halos, no classic re-run, and the model
  ends where the one-process ``fit`` does; on a batch whose windows
  breach: the classic engine, bitwise the one-process run.
- ``checked_eval_step`` and ``checked_forward`` on that halo breach:
  one sharded 2x-halo re-run each, logits within 1e-5 of the
  one-process forward's (f32 sums in another order).
- ``cli.train_modelnet --mode dense --point_devices 2`` on two ranks
  (bf16, two steps) against one process: each leaf within 2e-2 relative
  L2, the BN biases (near 0) within 2 steps x 2 lr; then
  ``cli.evaluate_modelnet --point_devices 2`` on its checkpoint, the
  votes bitwise the one process's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.parallel import RankPool
from test_torch_spatial_seg import (
    LR,
    SEED,
    _near,
    _rel,
    _scene_batch,
    _scene_spec,
    _tiny_config,
)

import torch_parallel_workers as PW
import torch_spatial_workers as W
from test_torch_cli import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, timeout=300,
                  store_dir=str(tmp_path_factory.mktemp("store"))) as p:
        yield p


@pytest.mark.parametrize("case", ["halo", "window"])
def test_fit_reruns_a_breached_batch(pool, tmp_path, case):
    # 1x halos narrowed to a block breach the inter-level windows of
    # 640 rows; 128-row windows breach the graphs themselves
    windows = 512 if case == "halo" else 128
    cfg = dataclasses.replace(_tiny_config(1024, windows, radius=0.3),
                              compute_dtype="float32")
    state = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(1)
                          ).state_dict()
    spec, batch = _scene_spec(cfg, state), _scene_batch(7)
    fn = W.fit_narrow_halos if case == "halo" else W.fit_recovery
    ranks = pool.run(fn, spec, batch, str(tmp_path / "sharded"), SEED)
    one = _one_process_fit(spec, batch, tmp_path / "one")
    log = (tmp_path / "sharded" / "log_train.txt").read_text()
    np.testing.assert_array_equal(
        ranks[0]["state"]["logits.weights"],
        ranks[1]["state"]["logits.weights"])
    if case == "halo":
        assert log.count("re-running sharded with 2x halos") == 2
        assert "re-running via the classic engine" not in log
        assert "(re-runs: 2 sharded at 2x halos, 0 through the classic " \
            "engine)" in log
        assert "2x-halo retry still violated" not in log
        _near(ranks[0]["state"], one)
    else:
        assert log.count("re-running via the classic engine") == 2
        assert "(all re-run through the classic engine)" in log
        for k, v in one.items():
            np.testing.assert_array_equal(ranks[0]["state"][k], v,
                                          err_msg=k)


def test_eval_paths_rerun_a_halo_breach(pool):
    cfg = dataclasses.replace(_tiny_config(1024, 512, radius=0.3),
                              compute_dtype="float32")
    state = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(1)
                          ).state_dict()
    spec, batch = _scene_spec(cfg, state), _scene_batch(7)
    ranks = pool.run(W.eval_narrow_halos, spec, batch)
    model = PW.build_factory(spec).model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(batch["points"])).numpy()
    for r in ranks:
        assert r["dense_ok"] and r["reruns"] == {"halo": 1, "classic": 0}
        # f32 sums in another order (the BN statistics are the running
        # ones in eval mode: only the halo'd sums differ)
        for key in ("eval_logits", "forward_logits"):
            np.testing.assert_allclose(r[key], want, rtol=1e-5, atol=1e-5)
    assert "re-running sharded with 2x halos" in ranks[0]["printed"]
    assert "re-ran sharded with 2x halos" in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""


def _one_process_fit(spec, batch, log_dir):
    """``fit`` in this process, on one torch thread as each rank runs
    (its sums then run in the ranks' order)."""
    from sph3d_gcn_torch.train.loop import fit

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = fit(PW.build_factory(spec), lambda epoch: iter([batch]),
                    lambda: iter([batch]), len(batch["label"]), 1,
                    str(log_dir), seed=SEED)
    finally:
        torch.set_num_threads(threads)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def test_modelnet_cli_with_point_devices(pool, tmp_path):
    PW.write_modelnet_records(tmp_path, "train", 2)
    PW.write_modelnet_records(tmp_path, "test", 1)
    common = ["--data_dir", str(tmp_path), "--batch_size", "2",
              "--device", "cpu", "--num_input", "512", "--max_epoch", "1",
              "--mode", "dense"]
    log_dir = tmp_path / "sharded"
    ranks = pool.run(W.cli_main, "train_modelnet",
                     common + ["--log_dir", str(log_dir),
                               "--point_devices", "2"])
    one = PW.cli_main(None, "train_modelnet",
                      common + ["--log_dir", str(tmp_path / "one")])
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)
    # bf16 (the dense mode's) after two Adam steps: every leaf within
    # 2e-2 relative L2 (measured 1.3e-2 at most), but the BN biases, which
    # start at 0 and move by about lr a step, a cancelling gradient's
    # sign flipping: those within 2 steps x 2 lr
    for k, want in one.items():
        if k.endswith(".bn.bias"):
            assert np.abs(ranks[0][k] - want).max() <= 4 * LR + 1e-6, k
        else:
            assert _rel(ranks[0][k], want) < 2e-2, k
    snap = json.loads((log_dir / "config.json").read_text())
    assert snap["point_axis"] is None      # the architecture, as JAX's
    log = (log_dir / "log_train.txt").read_text()
    assert "eval accuracy:" in log and "WARNING" not in log

    argv = ["--data_dir", str(tmp_path), "--log_dir", str(log_dir),
            "--batch_size", "2", "--device", "cpu", "--num_votes", "2"]
    e0, e1 = pool.run(PW.cli_main, "evaluate_modelnet",
                      argv + ["--point_devices", "2"])
    ev = PW.cli_main(None, "evaluate_modelnet", argv)
    np.testing.assert_array_equal(e0["votes"], e1["votes"])
    assert e0["forwards"] == ev["forwards"] == 2
    assert e0["reruns"] == ev["reruns"]
    # eval mode (running statistics): a tile's sums are the unsharded
    # op's, so the votes are bitwise the one process's
    np.testing.assert_array_equal(e0["votes"], ev["votes"])
