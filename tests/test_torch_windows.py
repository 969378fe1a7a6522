"""PyTorch port vs JAX: window calibration (``utils.windows``), exactly.

- ``slab_requirement`` on random sorted keys (scalar and per-tile radii,
  growth blocks) and ``growth_steps_needed`` on clouds whose nearest
  distances straddle the grown radii: equal to JAX's.
- ``measure_requirements`` and ``derive_config_windows`` on a few small
  clouds (two ModelNet surfaces at N=1024, two scene blocks at N=1024,
  through the port's spatial sort and plain FPS on the CPU): every
  requirement and every derived window equal to JAX's.
- Port only: windows derived with no margin from vote-rotated clouds,
  measured in the model's order (sort, then normalize), cover them: the
  dense model's certificate holds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_tpu.utils import windows as jax_windows
from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.models.common import normalize_unit_sphere
from sph3d_gcn_torch.train.eval import vote_augment
from sph3d_gcn_torch.utils import windows
from test_torch_cli import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("growth_block", [False, True])
def test_slab_requirement_matches_jax(growth_block):
    rng = np.random.default_rng(0)
    db = np.sort(rng.random(1000))
    q = np.sort(rng.random(300))
    for radius in (0.01, 0.1, rng.uniform(0.0, 0.2, 3)):
        assert windows.slab_requirement(db, q, radius, growth_block) == \
            jax_windows.slab_requirement(db, q, radius, growth_block)


def test_growth_steps_match_jax():
    rng = np.random.default_rng(1)
    db = rng.random((700, 3)).astype(np.float32)
    q = (rng.random((1500, 3)) * 1.6 - 0.3).astype(np.float32)
    got = windows.growth_steps_needed(db, q, 0.02, max_steps=8)
    ref = jax_windows.growth_steps_needed(db, q, 0.02, max_steps=8)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert len(np.unique(got)) >= 4


@pytest.mark.parametrize("name", ["modelnet", "s3dis"])
def test_measured_and_derived_windows_match_jax(name):
    rng = np.random.default_rng(2)
    if name == "modelnet":
        cfg, ref_cfg = modelnet_config(1024), jax_modelnet_config(1024)
        clouds = surface_clouds(rng, 2, 1024)
    else:
        cfg, ref_cfg = s3dis_config(1024), jax_s3dis_config(1024)
        clouds = scene_blocks(rng, 2, 1024)
    got = windows.measure_requirements(cfg, clouds, device="cpu")
    ref = jax_windows.measure_requirements(ref_cfg, clouds)
    assert [dataclasses.astuple(r) for r in got] == [
        dataclasses.astuple(r) for r in ref]
    for margin in (0.0, 0.08, 0.5):
        assert windows.derive_config_windows(cfg, got, margin) == \
            jax_windows.derive_config_windows(ref_cfg, ref, margin)


def test_derived_windows_cover_the_measured_clouds():
    """Windows derived with no margin from vote-rotated clouds, measured
    as the ModelNet model builds its graphs (sort on the raw cloud, then
    ``normalize_unit_sphere``), are enough: the dense model's certificate
    holds on every one of those clouds."""
    rng = np.random.default_rng(3)
    clouds = vote_augment(surface_clouds(rng, 4, 2048), rng)
    cfg = modelnet_config(2048, fast=True, dense=True)
    reqs = windows.measure_requirements(cfg, clouds, device="cpu",
                                        normalize=normalize_unit_sphere)
    enc, dec, margin, growth = windows.derive_config_windows(cfg, reqs, 0.0)
    assert enc != cfg.windows
    model = SPH3DModelNet(dataclasses.replace(
        cfg, windows=enc, dec_windows=dec, dec_margin=margin,
        growth_steps=growth), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.eval()(torch.from_numpy(clouds))
    assert bool(model.dense_ok)
