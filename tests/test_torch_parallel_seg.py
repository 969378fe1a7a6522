"""PyTorch port vs JAX: the S3DIS inner-masked train step,
data-parallel.

Two gloo ranks on the CPU (``parallel.run_ranks``), one block each, run
``segmentation_step_factory(..., inner_masked=True, group=...)``, whose
loss is summed over the batch's items (``loss_reduction="sum"``: the
ranks' gradients add without a 1/R); JAX runs
``segmentation_step_factory(..., mesh=make_mesh(jax.devices()[:2]),
inner_masked=True)``'s train step on the global batch. The config, the
numpy-seeded weights and the batch are test_torch_seg_train.py's (B=2,
N=1024, ``s3dis_config(fast=True, dense=True)`` at its published
channels with widened windows, f32), weight decay 0.05 (the replicated
term counted once over the ranks). JAX's gradients come from its Adam
state after the step.

Tolerances as test_torch_seg_train.py's f32 step: loss and data loss
1e-5 relative, logits 1e-4, each gradient leaf 1e-2 relative L2 (a
cancelling decoder BN bias) and the median leaf 1e-4, BN statistics
1e-5; the Adam update as test_torch_parallel_modelnet.py holds it. Both
ranks end bitwise alike.
"""

import jax
import numpy as np
import optax
import pytest

from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_tpu.models import SPH3DSceneSeg as JaxSceneSeg
from sph3d_gcn_tpu.parallel import make_mesh
from sph3d_gcn_tpu.parallel.mesh import replicated
from sph3d_gcn_tpu.train.steps import (
    TrainState,
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.parallel import run_ranks
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax
from test_torch_parallel_modelnet import check_against_mesh_step, jax_mesh_step
from test_torch_seg_train import _batch
from test_torch_segmentation import _config, _flax_variables, _points

import torch_parallel_workers as W

LR, DECAY, SEED = 1e-3, 0.05, 5
TOL = dict(loss=1e-5, logits=1e-4, grad=1e-2, grad_median=1e-4, stats=1e-5,
           resolved=0.1, unresolved_share=1e-3)


def _global_batch():
    pts, labels, inner = _batch()
    return {"points": pts, "label": labels, "inner_label": inner}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = _flax_variables(_points())
    mesh = make_mesh(jax.devices()[:2])
    sf = jax_seg_step_factory(
        JaxSceneSeg(_config("float32", jax_s3dis_config)), optax.adam(LR),
        weight_decay=DECAY, mesh=mesh, inner_masked=True)
    assert sf.loss_reduction == "sum"
    state = jax.device_put(TrainState.create(variables, sf.tx),
                           replicated(mesh))
    new_state, metrics, grads = jax_mesh_step(sf, state, mesh,
                                              _global_batch())

    model = SPH3DSceneSeg(_config("float32"))
    port_state = torch_state_dict_from_flax(variables, model.state_dict())
    spec = dict(model="scene", config=_config("float32"),
                state={k: v.numpy() for k, v in port_state.items()}, lr=LR,
                weight_decay=DECAY, inner_masked=True)
    ranks = run_ranks(W.train_step, 2, (spec, _global_batch(), SEED),
                      store_dir=str(tmp_path_factory.mktemp("store")),
                      timeout=240)
    return new_state, metrics, grads, ranks


def test_ranks_stay_replicated(runs):
    r0, r1 = runs[3]
    assert r0["loss"] == r1["loss"] and r0["data_loss"] == r1["data_loss"]
    for key in ("grads", "state"):
        for k, v in r0[key].items():
            np.testing.assert_array_equal(v, r1[key][k], err_msg=k)


def test_inner_masked_step_matches_jax_mesh_step(runs):
    check_against_mesh_step(*runs, TOL)
