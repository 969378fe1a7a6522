"""PyTorch port vs JAX: the host-side augmentations, the per-dataset
augmentation policies and the eval metrics, all bitwise.

Each augmentation (but one: see ``test_rotation_by_angle_with_normal``)
and policy runs on copies of one numpy-seeded batch with two generators
in one state; outputs must be equal bit for bit
(and of the same dtype), the in-place ones must change their input as
JAX's do, and both generators must end in the same state. The metrics
run on seeded predictions and labels, with classes absent from the
labels (NaN entries) and labels outside the class range.
"""

import numpy as np
import pytest

from sph3d_gcn_tpu.data import augment as jax_aug
from sph3d_gcn_tpu.train import augment_policies as jax_policies
from sph3d_gcn_tpu.train import metrics as jax_metrics
from sph3d_gcn_torch.data import augment as aug
from sph3d_gcn_torch.train import augment_policies as policies
from sph3d_gcn_torch.train import metrics

B, N = 5, 64


def _batch(cols=3):
    rng = np.random.default_rng(11)
    return (rng.standard_normal((B, N, cols)).astype(np.float32),
            rng.integers(0, 13, (B, N)).astype(np.int32),
            rng.integers(0, 2, (B, N)).astype(np.int32))


# name -> (makes the args, takes a generator)
FUNCTIONS = {
    "rot_x": (lambda: (0.7,), False),
    "rot_y": (lambda: (-2.1,), False),
    "rot_z": (lambda: (1.3,), False),
    "shuffle_data": (lambda: (_batch()[0], _batch()[1][:, 0]), True),
    "shuffle_points": (lambda: (_batch()[0],), True),
    "shuffle_points_and_label": (lambda: _batch()[:2], True),
    "rotate_point_cloud": (lambda: (_batch()[0],), True),
    "rotate_point_cloud_with_normal": (lambda: (_batch(6)[0],), True),
    "rotate_perturbation_point_cloud": (lambda: (_batch()[0],), True),
    "rotate_perturbation_point_cloud_with_normal": (
        lambda: (_batch(6)[0],), True),
    "rotate_point_cloud_by_angle": (lambda: (_batch()[0], 0.9), False),
    "jitter_point_cloud": (lambda: (_batch()[0],), True),
    "shift_point_cloud": (lambda: (_batch()[0],), True),
    "random_scale_point_cloud": (lambda: (_batch()[0],), True),
}


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_augmentation_matches_jax(name):
    make, draws = FUNCTIONS[name]
    ours_in, theirs_in = make(), make()
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    ours_args = list(ours_in)
    theirs_args = list(theirs_in)
    if draws:   # the generator goes after the arrays, before the options
        k = sum(isinstance(a, np.ndarray) for a in ours_args)
        ours_args.insert(k, rngs[0])
        theirs_args.insert(k, rngs[1])
    got = getattr(aug, name)(*ours_args)
    ref = getattr(jax_aug, name)(*theirs_args)
    assert _same(got, ref)
    assert _same(ours_in, theirs_in)       # in-place changes agree
    assert rngs[0].random() == rngs[1].random()


def test_rotation_by_angle_with_normal():
    """JAX's version raises on every input (it multiplies a 6-column row
    by the 3x3 matrix); the port's rotates the xyz and the normal columns
    each as JAX's ``rotate_point_cloud_by_angle`` rotates xyz, bitwise."""
    x = _batch(6)[0]
    got = aug.rotate_point_cloud_by_angle_with_normal(x, 0.9)
    for cols in (slice(0, 3), slice(3, 6)):
        ref = jax_aug.rotate_point_cloud_by_angle(x[..., cols], 0.9)
        assert _same(got[..., cols], ref)
    with pytest.raises(ValueError):
        jax_aug.rotate_point_cloud_by_angle_with_normal(x, 0.9)


@pytest.mark.parametrize("name,cols", [
    ("modelnet_train_augment", 3),
    ("s3dis_train_augment", 9),
    ("scannet_train_augment", 9),
    ("shapenet_train_augment", 3),
])
def test_policy_matches_jax(name, cols):
    pts, label, inner = _batch(cols)
    args = {"modelnet_train_augment": (pts, label[:, 0]),
            "shapenet_train_augment": (pts, label)}.get(
        name, (pts, label, inner))
    rngs = [np.random.default_rng(6), np.random.default_rng(6)]
    got = getattr(policies, name)(*[a.copy() for a in args], rngs[0])
    ref = getattr(jax_policies, name)(*[a.copy() for a in args], rngs[1])
    assert _same(tuple(got), tuple(ref))
    assert not np.array_equal(got[0], args[0])
    assert rngs[0].random() == rngs[1].random()


def _predictions():
    rng = np.random.default_rng(12)
    label = rng.integers(0, 9, 500)          # classes 9, 10 never labeled
    label[:7] = [-1, 11, 12, 40, -3, 11, 15]  # outside [0, 11): left out
    pred = np.where(rng.random(500) < 0.6, label, rng.integers(0, 11, 500))
    return np.clip(pred, 0, 10), label


@pytest.mark.parametrize("name", [
    "overall_accuracy", "per_class_accuracy", "mean_class_accuracy",
    "per_class_iou", "mean_iou",
])
def test_metric_matches_jax(name):
    pred, label = _predictions()
    cm = metrics.confusion_matrix(pred, label, 11)
    ref_cm = jax_metrics.confusion_matrix(pred, label, 11)
    assert _same(cm, ref_cm) and cm.sum() == 493
    got = getattr(metrics, name)(cm)
    ref = getattr(jax_metrics, name)(ref_cm)
    assert type(got) is type(ref)
    np.testing.assert_array_equal(got, ref)


def test_shape_iou_matches_jax():
    pred, label = _predictions()
    for parts in ([0, 1, 2], [9, 10], [3, 10, 12]):
        assert metrics.shape_iou(pred, label, np.array(parts)) == \
            jax_metrics.shape_iou(pred, label, np.array(parts))
    assert metrics.overall_accuracy(np.zeros((3, 3), np.int64)) == 0.0
