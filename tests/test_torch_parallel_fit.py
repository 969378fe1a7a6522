"""The port's data-parallel training loop and checkpoints at R = 2 gloo
ranks on the CPU (``parallel.run_ranks``) against the one-process runs
on the same global batches (no JAX: the loop's parity with JAX's
``fit`` is test_torch_fit.py's).

Model: a one-level dense ModelNet classifier (``modelnet_config(
num_input=512, fast=True, dense=True)`` with narrow widths, f32, dropout
on), Adam at 1e-3. Tolerances: after the runs every parameter leaf
within 2e-3 relative L2 of the one-process run (test_torch_fit.py's for
two Adam steps; here four, whose sign-like first steps amplify f32
sum-order differences of vanishing gradients), BN statistics within
1e-5, the log lines equal but for the ms figure and their numbers within
1e-4 relative. Both ranks always end bitwise alike.

- A certificate that fails on rank 1's rows only: both ranks' steps
  return ``dense_ok`` False, and ``fit`` re-runs both through
  ``classic_fallback()``, equal to the one-process ``fit``.
- Two epochs of two steps with save and resume (the second batch short:
  rank 1 steps on one real item and one repeat of it), the eval passes on
  BN statistics primed over one batch: only rank 0 writes (its logger and
  its checkpoints; rank 1 prints nothing and saves nothing), the resumed
  run equals the straight one bitwise and the one-process run within
  the tolerances.

The evaluation paths and the entry points across ranks are
test_torch_parallel_eval.py's.
"""

import json

import numpy as np

from sph3d_gcn_torch.data.synthetic import surface_clouds
from sph3d_gcn_torch.parallel import run_ranks
from sph3d_gcn_torch.train.loop import fit
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_fit import _log

import torch_parallel_workers as W

N = 512
PARAM_TOL, STATS_TOL, LOG_RTOL = 2e-3, 1e-5, 1e-4


def _close(got: dict, ref: dict) -> None:
    for k, want in ref.items():
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(got[k], want, rtol=0, atol=STATS_TOL,
                                       err_msg=k)
        else:
            err = np.linalg.norm(got[k] - want) / max(np.linalg.norm(want),
                                                      1e-30)
            assert err < PARAM_TOL, (k, err)


def _same(a: dict, b: dict) -> None:
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def _clouds(n, seed):
    rng = np.random.default_rng(seed)
    return (surface_clouds(rng, n, N).astype(np.float32),
            rng.integers(0, 40, n).astype(np.int32))


def failing_batch():
    """Two clouds: the first covered by 384-row windows, the second, 400
    of its points crowded about one, not."""
    pts, labels = _clouds(2, 5)
    rng = np.random.default_rng(6)
    pts[1, :400] = pts[1, :1] + 0.01 * rng.standard_normal((400, 3))
    return {"points": pts.astype(np.float32), "label": labels}


def test_one_rank_failing_the_certificate_reruns_every_rank(tmp_path):
    spec, batch = W.narrow_modelnet_spec(windows=(384,)), failing_batch()
    ranks = run_ranks(W.certificate, 2, (spec, batch, 3),
                      store_dir=str(tmp_path), timeout=120)
    assert [r["own"] for r in ranks] == [True, False]
    assert [r["step"] for r in ranks] == [False, False]

    ref = fit(W.build_factory(spec), lambda epoch: iter([batch]),
              lambda: iter([batch]), 2, 1, str(tmp_path / "one"), seed=3)
    r0, r1 = run_ranks(W.fit_fallback, 2,
                       (spec, batch, str(tmp_path / "two"), 3),
                       store_dir=str(tmp_path), timeout=180)
    _same(r0, r1)
    _close(r0, {k: v.numpy() for k, v in ref.state_dict().items()})
    lines, numbers = _log(tmp_path / "two")
    ref_lines, ref_numbers = _log(tmp_path / "one")
    assert lines == ref_lines
    np.testing.assert_allclose(numbers, ref_numbers, rtol=LOG_RTOL)
    assert "during epoch 0 batch 0 (violation #1); re-running via the " \
           "classic engine" in (tmp_path / "two" / "log_train.txt").read_text()


def test_fit_with_resume_matches_one_process(tmp_path):
    spec = W.narrow_modelnet_spec()
    pts, labels = _clouds(7, 7)
    train = [{"points": pts[i:j], "label": labels[i:j]}
             for i, j in ((0, 4), (4, 7))]
    evals = [{"points": pts[:3], "label": labels[:3]}]
    ranks = run_ranks(W.fit_runs, 2,
                      (spec, train, evals, 4, str(tmp_path / "two"), 9),
                      store_dir=str(tmp_path), timeout=240)
    for r in ranks:
        _same(r["states"]["straight"], r["states"]["resumed"])
    _same(ranks[0]["states"]["straight"], ranks[1]["states"]["straight"])
    assert ranks[0]["saves"] == 2 + 2 and ranks[1]["saves"] == 0
    assert "**** EPOCH 001 ****" in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""

    ref = fit(W.build_factory(spec), lambda epoch: iter(train),
              lambda: iter(evals), 4, 2, str(tmp_path / "one"), seed=9,
              bn_prime_steps=1)
    _close(ranks[0]["states"]["straight"],
           {k: v.numpy() for k, v in ref.state_dict().items()})
    lines, numbers = _log(tmp_path / "two" / "straight")
    ref_lines, ref_numbers = _log(tmp_path / "one")
    assert lines == ref_lines
    np.testing.assert_allclose(numbers, ref_numbers, rtol=LOG_RTOL)
    resumed = (tmp_path / "two" / "resumed" / "log_train.txt").read_text()
    assert "resumed from epoch 0" in resumed
    got = [json.loads(x) for x in (tmp_path / "two" / "straight"
                                   / "metrics.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in
            (tmp_path / "one" / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(x) for x in got] == [sorted(x) for x in want]
    for g, w in zip(got, want):
        for k in w:
            if k != "ms_per_batch":
                np.testing.assert_allclose(g[k], w[k], rtol=LOG_RTOL)
