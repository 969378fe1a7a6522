"""Flax variables <-> PyTorch ``state_dict`` (the JAX package's checkpoints
into the port, and the port's parameters, gradients or statistics back
into a Flax-shaped tree).

The port names its modules, parameters and buffers after the Flax scopes,
so the map is structural: a Flax path ``conv1/_2/bn/BatchNorm_0/scale``
becomes ``conv1._2.bn.scale`` (the ``BatchNorm_0`` level is dropped) and
the ``batch_stats`` leaves ``mean``/``var`` become the BN buffers of the
same names. Shapes carry over unchanged: pointwise and FC kernels are
(in, out), depthwise filters (bin_size, in, multiplier).
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()
            ) -> Iterator[tuple[tuple[str, ...], object]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), value


def torch_state_dict_from_flax(
    variables: Mapping, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a Flax ``{"params", "batch_stats"}`` tree of arrays onto the
    keys of ``state_dict`` (the port model's own).

    Returns a new state dict with every key of ``state_dict`` filled, in
    that key's dtype. Raises ValueError on an unknown collection, a leaf
    that matches no key, a key left unfilled, or a shape mismatch.
    """
    out: dict[str, torch.Tensor] = {}
    unused = []
    for coll, tree in variables.items():
        if coll not in _COLLECTIONS:
            raise ValueError(f"unexpected variable collection {coll!r}")
        for path, leaf in _leaves(tree):
            key = ".".join(p for p in path if p != "BatchNorm_0")
            if key not in state_dict:
                unused.append(f"{coll}/{'/'.join(path)}")
                continue
            if key in out:
                raise ValueError(f"two Flax leaves map onto {key!r}")
            arr = np.asarray(leaf, dtype=np.float32)
            target = state_dict[key]
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(
                    f"{key}: Flax shape {arr.shape} != port shape "
                    f"{tuple(target.shape)}"
                )
            out[key] = torch.from_numpy(arr.copy()).to(target.dtype)
    missing = sorted(set(state_dict) - set(out))
    if unused or missing:
        raise ValueError(
            f"Flax leaves with no port key: {unused}; port keys with no "
            f"Flax leaf: {missing}"
        )
    return out


_BN_STATS = ("mean", "var")


def flax_tree_from_torch(
    tensors: Mapping[str, torch.Tensor]
) -> dict[str, dict]:
    """The reverse map: port names (``named_parameters``, a state dict, or
    per-parameter gradients under the same names) -> a Flax-shaped
    ``{"params": ..., "batch_stats": ...}`` tree of f32 numpy arrays.

    ``conv1._2.bn.scale`` becomes ``params/conv1/_2/bn/BatchNorm_0/scale``
    and the BN buffers ``mean``/``var`` go to ``batch_stats``; a
    collection with no leaf is left out.
    """
    out: dict[str, dict] = {}
    for key, value in tensors.items():
        parts = key.split(".")
        path: list[str] = []
        for p in parts[:-1]:
            path.append(p)
            if p == "bn":
                path.append("BatchNorm_0")
        leaf = parts[-1]
        in_bn = "bn" in parts[:-1]
        coll = "batch_stats" if in_bn and leaf in _BN_STATS else "params"
        node = out.setdefault(coll, {})
        for p in path:
            node = node.setdefault(p, {})
        if leaf in node:
            raise ValueError(f"two port keys map onto {coll}/{path}/{leaf}")
        node[leaf] = value.detach().float().cpu().numpy()
    return out
