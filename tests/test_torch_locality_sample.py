"""PyTorch port vs JAX: locality sort and farthest-point sampling (exact).

The same numpy-seeded clouds go through ``sph3d_gcn_tpu`` and
``sph3d_gcn_torch``; sort axes, permutations and FPS indices must be
equal. FPS is held against both the Pallas kernel (interpret mode) and
the XLA loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import locality as jloc
from sph3d_gcn_tpu.ops.pallas.fps_kernel import farthest_point_sample_pallas
from sph3d_gcn_tpu.ops.sample import farthest_point_sample_xla
from sph3d_gcn_torch.ops import locality as tloc
from sph3d_gcn_torch.ops.sample import farthest_point_sample


def _clouds(seed, b=3, n=700):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # anisotropic ellipsoids so the three clouds pick different axes
    axes = np.array([[0.9, 0.4, 0.3], [0.3, 0.9, 0.5], [0.4, 0.3, 0.9]],
                    np.float32)[:b, None, :]
    return v * axes


@pytest.mark.parametrize("radius", [0.1, 0.4])
def test_choose_sort_axis_and_spatial_sort(radius):
    pts = _clouds(0)
    ax_j = np.asarray(jloc.choose_sort_axis(jnp.asarray(pts), radius))
    ax_t = tloc.choose_sort_axis(torch.from_numpy(pts), radius).numpy()
    np.testing.assert_array_equal(ax_t, ax_j)
    assert len(set(ax_t.tolist())) > 1      # the clouds pick different axes
    perm_j, rank_j = jloc.spatial_sort(jnp.asarray(pts), radius)
    perm_t, rank_t = tloc.spatial_sort(torch.from_numpy(pts), radius)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(rank_t.numpy(), np.asarray(rank_j))
    np.testing.assert_array_equal(
        tloc.permute_points(torch.from_numpy(pts), perm_t).numpy(),
        np.asarray(jloc.permute_points(jnp.asarray(pts), perm_j)),
    )


def test_invert_and_sort_indices_small():
    rng = np.random.default_rng(2)
    perm = np.stack([rng.permutation(50) for _ in range(3)]).astype(np.int32)
    np.testing.assert_array_equal(
        tloc.invert_permutation(torch.from_numpy(perm).long()).numpy(),
        np.asarray(jloc.invert_permutation(jnp.asarray(perm))),
    )
    idx = rng.integers(0, 40, (3, 30)).astype(np.int32)   # with duplicates
    np.testing.assert_array_equal(
        tloc.sort_indices_small(torch.from_numpy(idx)).numpy(),
        np.asarray(jloc.sort_indices_small(jnp.asarray(idx))),
    )


@pytest.mark.parametrize("n,npoint", [(700, 175), (300, 300), (129, 7)])
def test_fps_matches_pallas_and_xla(n, npoint):
    pts = _clouds(3, n=n)
    ref_xla = np.asarray(farthest_point_sample_xla(npoint, jnp.asarray(pts)))
    ref_pl = np.asarray(
        farthest_point_sample_pallas(npoint, jnp.asarray(pts), interpret=True)
    )
    got = farthest_point_sample(npoint, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref_xla)
    np.testing.assert_array_equal(got, ref_pl)


def test_fps_ties_go_to_lowest_index():
    # a cube's corners: many exactly equal distances
    g = np.array(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"))
    pts = np.tile(g.reshape(3, -1).T[None].astype(np.float32), (2, 2, 1))
    ref = np.asarray(farthest_point_sample_xla(8, jnp.asarray(pts)))
    got = farthest_point_sample(8, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fps_rejects_bad_npoint():
    with pytest.raises(ValueError):
        farthest_point_sample(0, torch.zeros(1, 5, 3))
    with pytest.raises(ValueError):
        farthest_point_sample(6, torch.zeros(1, 5, 3))


def test_fps_beyond_the_kernel_registers_matches_xla():
    # a cloud larger than K1 holds in registers (the card walks it in
    # device memory): the plain version still equals JAX's XLA loop
    pts = _clouds(4, b=1, n=20000)
    ref = np.asarray(farthest_point_sample_xla(64, jnp.asarray(pts)))
    got = farthest_point_sample(64, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
