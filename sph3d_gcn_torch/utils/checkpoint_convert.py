"""TF1 checkpoints into the port's models (counterpart of
``sph3d_gcn_tpu/utils/checkpoint_convert.py``, with no Flax tree in
between).

The reference saves TF1 checkpoints with variable names following the
scoping in `utils/sph3gcn_util.py` (e.g. ``conv1_1/depthwise_weights``,
``conv1_1/weights``, ``conv1_2/bn/gamma``, ``fc1/weights``,
``logits/weights``; see :125-161,328-332). The port names its modules
after the same scopes, so the map is by rule on its ``state_dict`` keys:
the scene models' ``backbone.`` level is dropped, a conv block's ``_k``
level joins its scope (``conv1._2`` -> ``conv1_2``), the BN leaves
``scale``/``bias``/``mean``/``var`` become ``gamma``/``beta``/
``moving_mean``/``moving_variance``, and ``weights``,
``depthwise_weights`` and ``biases`` keep their names. Shapes carry over
unchanged: pointwise and FC kernels are (in, out), depthwise filters
(bin_size, in, multiplier), the BN vectors (channels,).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_BN_NAMES = {"scale": "gamma", "bias": "beta", "mean": "moving_mean",
             "var": "moving_variance"}
_LEAVES = ("weights", "depthwise_weights", "biases")
# optimizer slots and counters a TF1 Saver writes beside the variables
_SLOTS = ("/Adam", "/Momentum", "beta1_power", "beta2_power", "global_step")


def tf_name(key: str) -> str | None:
    """The TF1 variable name of a port ``state_dict`` key, or None where
    the key has no TF counterpart."""
    parts = [p for p in key.split(".") if p != "backbone"]
    leaf = parts[-1]
    flat: list[str] = []
    for p in parts[:-1]:
        if p.startswith("_") and flat:     # conv1._2 -> conv1_2
            flat[-1] += p
        else:
            flat.append(p)
    if "bn" in flat:
        name = _BN_NAMES.get(leaf)
        if name is None:
            return None
        return "/".join(flat[:flat.index("bn")] + ["bn", name])
    if leaf in _LEAVES:
        return "/".join(flat + [leaf])
    return None


def tf_variables(state_dict: Mapping[str, torch.Tensor]
                 ) -> dict[str, np.ndarray]:
    """The reverse map: a port ``state_dict`` -> {TF1 name: f32 array},
    as a bundle of the reference's names holds them (``write_bundle``
    writes it)."""
    out = {}
    for key, value in state_dict.items():
        name = tf_name(key)
        if name is not None:
            out[name] = value.detach().float().cpu().numpy()
    return out


def convert_tf_variables(
    state_dict: Mapping[str, torch.Tensor], tf_vars: Mapping[str, np.ndarray]
) -> dict[str, torch.Tensor]:
    """Fill a copy of ``state_dict`` (the port model's own) from a
    {tf_name: array} mapping, each value in its key's dtype; a key with no
    TF counterpart keeps its value.

    Raises KeyError naming every TF variable the checkpoint lacks and
    ValueError on a shape mismatch.
    """
    out: dict[str, torch.Tensor] = {}
    missing: list[str] = []
    for key, target in state_dict.items():
        name = tf_name(key)
        if name is None:
            out[key] = target.detach().clone()
            continue
        if name not in tf_vars:
            missing.append(name)
            continue
        value = np.asarray(tf_vars[name])
        if value.shape != tuple(target.shape):
            raise ValueError(
                f"shape mismatch for {name}: checkpoint {value.shape} vs "
                f"model {tuple(target.shape)} ({key})")
        out[key] = torch.from_numpy(np.array(value)).to(target.dtype)
    if missing:
        raise KeyError(
            "checkpoint is missing variables: " + ", ".join(sorted(missing)))
    return out


def load_tf_checkpoint(prefix: str) -> dict[str, np.ndarray]:
    """Every variable of a TF1 checkpoint bundle, {name: array}, without
    the optimizer's slots (Adam and Momentum accumulators, the beta powers,
    the global step). numpy only (``utils.tf1_bundle``)."""
    from sph3d_gcn_torch.utils.tf1_bundle import read_bundle

    return {name: value for name, value in read_bundle(prefix).items()
            if not any(s in name for s in _SLOTS)}


def convert_checkpoint(model: torch.nn.Module, prefix: str
                       ) -> dict[str, torch.Tensor]:
    """One call: a TF1 checkpoint (``model.ckpt-N``, the prefix TF1's
    ``Saver.restore`` takes) -> a ``state_dict`` for ``model``, to load
    with ``model.load_state_dict``."""
    return convert_tf_variables(model.state_dict(), load_tf_checkpoint(prefix))
