"""TF1 checkpoints into the port: ``sph3d_gcn_torch/utils/tf1_bundle.py``
(numpy only) and ``utils/checkpoint_convert.py`` (the reference's names
for the port's ``state_dict`` keys) against the JAX package's.

- Bundles: one written by JAX's ``write_bundle`` reads equal through the
  port's ``read_bundle`` (every dtype the writer takes; a scalar comes
  back as shape (1,), as both writers store it), and
  the port's written bundle is byte-identical to JAX's for the same dict;
  a snappy-compressed table block reads, a flipped tensor byte raises.
- Names: for each of the five model families at full published width,
  the port's TF name set (and shapes), on both engines' configs, equals
  the one JAX's ``_tf_name_for_path`` gives over a ``jax.eval_shape``
  template of the same model (nothing compiles).
- Logits: for ModelNet (the dense engine) and the S3DIS scene model (the
  per-edge parity engine) at the small test width of
  ``tests/test_torch_modelnet.py`` / ``test_torch_segmentation.py``
  (B=2, N=1024, published channels), a seeded bundle under the
  reference's names (with optimizer slots, which both loaders drop)
  loads through JAX's ``convert_checkpoint`` + the Flax forward and
  through the port's ``convert_checkpoint`` + the torch forward: the
  parameters equal bit for bit, the f32 logits within rtol = atol =
  1e-4 (f32 sums in other orders, as those files state).
- Errors: a missing variable raises ``KeyError`` naming every one, a
  shape mismatch ``ValueError``; a key with no TF name keeps its value;
  ``tf_variables`` round-trips a state dict bitwise.
"""

import dataclasses
import struct

import jax
import numpy as np
import pytest
import torch

from sph3d_gcn_torch import configs as tconfigs
from sph3d_gcn_torch import models as tmodels
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.data.tfrecord import _masked_crc
from sph3d_gcn_torch.utils import checkpoint_convert as tconv
from sph3d_gcn_torch.utils import tf1_bundle as tb
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax
from sph3d_gcn_tpu import configs as jconfigs
from sph3d_gcn_tpu import models as jmodels
from sph3d_gcn_tpu.utils import checkpoint_convert as jconv
from sph3d_gcn_tpu.utils import tf1_bundle as jb
from test_torch_cli import one_torch_thread  # noqa: F401

B, N = 2, 1024


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "conv1_1/depthwise_weights": rng.standard_normal(
            (33, 16, 2)).astype(np.float32),
        "conv1_1/weights": rng.standard_normal((32, 64)).astype(np.float32),
        "conv1_1/bn/gamma": rng.standard_normal(64).astype(np.float32),
        "logits/biases": rng.standard_normal(40).astype(np.float64),
        "global_step": np.asarray(123, np.int64),
        "counts": rng.integers(-5, 5, (7, 2)).astype(np.int32),
        "flags": rng.random(5) < 0.5,
        "empty": np.zeros((0, 3), np.float32),
    }


def test_jax_bundle_reads_in_the_port(tmp_path):
    tensors = _tensors()
    jb.write_bundle(str(tmp_path / "model.ckpt-42"), tensors)
    got = tb.read_bundle(str(tmp_path / "model.ckpt-42"))
    assert sorted(got) == sorted(tensors)
    for name, value in tensors.items():
        assert got[name].dtype == value.dtype
        # both writers store a 0-d array as shape (1,)
        # (``np.ascontiguousarray``)
        assert got[name].shape == (value.shape or (1,))
        np.testing.assert_array_equal(got[name], value)
    header, entries = tb.read_index(str(tmp_path / "model.ckpt-42.index"))
    assert header["num_shards"] == 1 and sorted(entries) == sorted(tensors)


def test_port_bundle_bytes_equal_jax(tmp_path):
    tensors = _tensors(1)
    tb.write_bundle(str(tmp_path / "port" / "model.ckpt-7"), tensors)
    jb.write_bundle(str(tmp_path / "jax" / "model.ckpt-7"), tensors)
    for suffix in (".index", ".data-00000-of-00001"):
        port = (tmp_path / "port" / f"model.ckpt-7{suffix}").read_bytes()
        ref = (tmp_path / "jax" / f"model.ckpt-7{suffix}").read_bytes()
        assert port == ref, suffix
    got = jb.read_bundle(str(tmp_path / "port" / "model.ckpt-7"))
    for name, value in tensors.items():
        np.testing.assert_array_equal(got[name], value)


def _snappy_literal(data: bytes) -> bytes:
    """A valid snappy stream of literal chunks of at most 60 bytes."""
    out = bytearray(tb._write_varint(len(data)))
    for i in range(0, len(data), 60):
        chunk = data[i:i + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
    return bytes(out)


def test_snappy_block_and_corruption(tmp_path):
    tensors = {"a/weights": np.arange(12, dtype=np.float32).reshape(3, 4)}
    prefix = str(tmp_path / "model.ckpt-1")
    tb.write_bundle(prefix, tensors)
    # re-write the index with its data block snappy-compressed
    _, entries = tb.read_index(prefix + ".index")
    entry = entries["a/weights"]
    kv = [(b"", tb._key(1, 0) + tb._write_varint(1)),
          (b"a/weights", tb._encode_entry(1, (3, 4), 0, entry["offset"],
                                          entry["size"], entry["crc32c"]))]
    block = _snappy_literal(tb._make_block(kv)) + b"\x01"
    buf = block + struct.pack("<I", _masked_crc(block))
    meta = tb._block_with_trailer(tb._make_block([]))
    meta_off, index_off = len(buf), len(buf) + len(meta)
    handle = tb._write_varint(0) + tb._write_varint(len(block) - 1)
    index = tb._make_block([(b"\xff", handle)])
    footer = (tb._write_varint(meta_off) + tb._write_varint(len(meta) - 5)
              + tb._write_varint(index_off) + tb._write_varint(len(index)))
    footer += b"\x00" * (40 - len(footer)) + struct.pack("<Q",
                                                          tb._TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(buf + meta + tb._block_with_trailer(index) + footer)
    for read in (tb.read_bundle, jb.read_bundle):
        np.testing.assert_array_equal(read(prefix)["a/weights"],
                                      tensors["a/weights"])
    data = bytearray(open(prefix + ".data-00000-of-00001", "rb").read())
    data[5] ^= 0x01
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="crc32c mismatch"):
        tb.read_bundle(prefix)


def _jax_names(variables) -> dict[str, tuple]:
    names = {}

    def visit(path, leaf):
        key = tuple(p.key if hasattr(p, "key") else str(p) for p in path)
        mapped = jconv._tf_name_for_path(key)
        if mapped is not None:
            assert mapped[0] not in names
            names[mapped[0]] = tuple(leaf.shape)
        return leaf

    jax.tree_util.tree_map_with_path(visit, variables)
    return names


def _port_names(state_dict) -> dict[str, tuple]:
    names = {}
    for key, value in state_dict.items():
        name = tconv.tf_name(key)
        assert name is not None, key
        assert name not in names, name
        names[name] = tuple(value.shape)
    return names


# (model, config factory, points shape, extra inputs); full published width
FAMILIES = {
    "modelnet": ("SPH3DModelNet", "modelnet_config", (1, 10000, 3), ()),
    "s3dis": ("SPH3DSceneSeg", "s3dis_config", (1, 8192, 9), ()),
    "ruemonge": ("SPH3DRueMonge", "ruemonge2014_config", (1, 8192, 9), ()),
    "shapenet": ("SPH3DShapeNet", "shapenet_config", (1, 2048, 3), (4,)),
    "shapenet_onehot": ("SPH3DShapeNetOnehot", "shapenet_config",
                        (1, 2048, 3), ()),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tf_names_match_jax_at_full_width(family):
    model, factory, shape, args = FAMILIES[family]
    jcfg = getattr(jconfigs, factory)(fast=True, dense=True)
    jmodel = getattr(jmodels, model)(jcfg, *args)
    extra = ((np.zeros(shape[:1], np.int32),)
             if family == "shapenet_onehot" else ())
    template = jax.eval_shape(
        lambda p, *e: jmodel.init(jax.random.key(0), p, *e),
        np.zeros(shape, np.float32), *extra)
    ref = _jax_names(template)
    assert "logits/weights" in ref and "conv1_1/bn/moving_variance" in ref
    if family.startswith("shapenet"):
        assert "mlp2/bn/gamma" in ref
    for dense in (True, False):     # the dense and the per-edge engine
        cfg = getattr(tconfigs, factory)(fast=True, dense=dense)
        port = getattr(tmodels, model)(cfg, *args)
        assert _port_names(port.state_dict()) == ref


def _modelnet_config(factory):
    return dataclasses.replace(
        factory(), num_input=N, num_sample=(256, 64, 16),
        windows=(512, 256, 128), dense_graph=True, spatial_sort=True,
        compute_dtype="float32")


def _s3dis_config(factory):
    """The reference-parity per-edge engine (f32, edge lists): the
    converter fills both engines' modules alike, and this one compiles in
    half the time of the dense engine's interpret-mode kernels."""
    return dataclasses.replace(factory(num_input=N),
                               num_sample=(256, 96, 48, 16))


def _modelnet_points():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((B, N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rng.uniform(0.3, 1.0, (B, 1, 3)).astype(np.float32)


SMALL = {
    "modelnet": ("SPH3DModelNet", _modelnet_config, "modelnet_config",
                 _modelnet_points),
    "s3dis": ("SPH3DSceneSeg", _s3dis_config, "s3dis_config",
              lambda: scene_blocks(np.random.default_rng(3), B, N)),
}


def _seeded_tf_vars(names: dict[str, tuple]) -> dict[str, np.ndarray]:
    """He-scaled weights, BN terms near 1 / 0, from a numpy seed."""
    rng = np.random.default_rng(1)
    out = {}
    for name, shape in sorted(names.items()):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("weights", "depthwise_weights"):
            fan = shape[-2] * int(np.prod(shape[:-2]))
            out[name] = rng.standard_normal(shape).astype(
                np.float32) * np.float32(np.sqrt(2.0 / fan))
        elif leaf in ("gamma", "moving_variance"):
            out[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("family", list(SMALL))
def test_bundle_logits_match_jax(tmp_path, family):
    model, make_config, factory, points = SMALL[family]
    pts = points()
    jmodel = getattr(jmodels, model)(make_config(getattr(jconfigs, factory)))
    template = jax.eval_shape(
        lambda p: jmodel.init(jax.random.key(0), p), pts)
    tf_vars = _seeded_tf_vars(_jax_names(template))
    prefix = str(tmp_path / "model.ckpt-250")
    jb.write_bundle(prefix, {**tf_vars,
                             "conv1_1/weights/Adam": np.ones(3, np.float32),
                             "beta1_power": np.float32(0.9),
                             "global_step": np.int64(250)})
    # JAX's converter takes concrete leaves (it casts to each one's dtype)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   template)
    variables = jconv.convert_checkpoint(zeros, prefix)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, pts))

    port = getattr(tmodels, model)(make_config(getattr(tconfigs, factory)))
    state = tconv.convert_checkpoint(port.eval(), prefix)
    want = torch_state_dict_from_flax(variables, port.state_dict())
    assert sorted(state) == sorted(want)
    for key in want:
        assert torch.equal(state[key], want[key]), key
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(pts)).numpy()
    assert bool(getattr(port, "dense_ok", True))
    assert np.abs(ref).max() > 0.1          # logits are not vanishing
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_convert_errors_and_round_trip(tmp_path):
    cfg = tconfigs.modelnet_config(num_input=512, fast=True, dense=True)
    gen = torch.Generator().manual_seed(0)
    model = tmodels.SPH3DModelNet(cfg, generator=gen)
    state = model.state_dict()
    tf_vars = tconv.tf_variables(state)
    assert len(tf_vars) == len(state)
    prefix = str(tmp_path / "model.ckpt-3")
    tb.write_bundle(prefix, {**tf_vars, "fc1/weights/Momentum":
                             np.zeros(2, np.float32)})
    loaded = tconv.load_tf_checkpoint(prefix)
    assert sorted(loaded) == sorted(tf_vars)
    fresh = tmodels.SPH3DModelNet(cfg)
    out = tconv.convert_checkpoint(fresh, prefix)
    for key, value in state.items():
        assert torch.equal(out[key], value), key

    missing = dict(tf_vars)
    del missing["conv1_2/bn/moving_mean"], missing["logits/weights"]
    with pytest.raises(KeyError, match="conv1_2/bn/moving_mean, "
                                       "logits/weights"):
        tconv.convert_tf_variables(state, missing)
    bad = dict(tf_vars, **{"fc1/weights": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for fc1/weights"):
        tconv.convert_tf_variables(state, bad)
    extra = dict(state, **{"fc1.counter": torch.tensor([7])})
    out = tconv.convert_tf_variables(extra, tf_vars)
    assert torch.equal(out["fc1.counter"], torch.tensor([7]))
