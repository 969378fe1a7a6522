"""Logit parity of the port's models against an independent forward
(counterpart of the JAX package's ``scripts/parity_check.py``).

Two modes:

1. ``--oracle`` (``--model modelnet|s3dis``): seeds the model, sets its
   batch-norm statistics from a calibration batch (below), runs it in
   eval mode on the JAX script's synthetic batch (``surface_clouds`` or
   ``scene_blocks`` of ``default_rng(0)`` at ``--batch_size`` and
   ``--num_input``), and runs the same weights through the NumPy oracle
   forward on the host (``utils.numpy_reference``, built from the
   reference's CUDA semantics alone);
2. checkpoint mode (``--ckpt PREFIX --batch NPZ``, any of the five
   families): loads a TF1 checkpoint bundle into the model
   (``utils.checkpoint_convert.convert_checkpoint``) and compares its
   logits with the npz's ``logits`` on its ``points`` (and
   ``cls_label`` for ``shapenet_onehot``), captured from the reference.

Each prints the max abs diff, the max rel diff (over ``max(|ref|,
1e-6)``) and the argmax agreement, then ``PARITY[...]: PASS`` or
``FAIL``, and exits 1 unless ``allclose(logits, ref, rtol, atol)``.
The models run on the card unless ``--device cpu``::

    python -m sph3d_gcn_torch.cli.parity_check --model modelnet --oracle
    python -m sph3d_gcn_torch.cli.parity_check --model s3dis --oracle \\
        --num_input 1024 --batch_size 1 --device cpu
    python -m sph3d_gcn_torch.cli.parity_check --model modelnet \\
        --ckpt model.ckpt-198 --batch batch.npz

The calibration: a seeded model's initial statistics (mean 0, variance
1) shrink the activations layer after layer, to logits of about 1e-3,
which ``atol`` = 1e-4 would pass whatever they were. So the oracle mode
first runs one train-mode forward on eight more clouds of the same
generator with every batch norm's momentum at 0: each takes the
statistics of its input there (the per-cloud layers' over eight rows),
and the eval forward's activations and logits are of order 1. The
oracle reads the same statistics.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

CALIBRATION_CLOUDS = 8


def synthetic_points(model: str, rng: np.random.Generator, batch: int,
                     num_input: int) -> np.ndarray:
    """The JAX script's synthetic batch: ModelNet-like ellipsoid surfaces,
    or 1.5 m scene blocks with their nine columns."""
    from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds

    if model == "modelnet":
        return surface_clouds(rng, batch, num_input)
    return scene_blocks(rng, batch, num_input)


def seeded_model(cfg, seed: int = 0) -> torch.nn.Module:
    """The model of ``cfg``'s family (ModelNet when it has global layers,
    else the scene model), its weights from ``seed``."""
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg

    gen = torch.Generator().manual_seed(seed)
    if cfg.global_channels is not None:
        return SPH3DModelNet(cfg, generator=gen)
    return SPH3DSceneSeg(cfg, generator=gen)


def calibrate_batch_norm(model: torch.nn.Module, points: torch.Tensor,
                         seed: int = 0) -> None:
    """Set every batch norm's running statistics to those of its input in
    one train-mode forward of ``model`` on ``points`` (momentum 0 for
    that forward; dropout masks from ``seed``). Leaves the model in eval
    mode."""
    from sph3d_gcn_torch.nn.layers import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    kept = [bn.momentum for bn in norms]
    gen = torch.Generator(device=points.device).manual_seed(seed)
    try:
        for bn in norms:
            bn.momentum = 0.0
        with torch.no_grad():
            model.train()(points, generator=gen)
    finally:
        for bn, m in zip(norms, kept):
            bn.momentum = m
        model.eval()


def oracle_forward(cfg, variables: dict, points: np.ndarray) -> np.ndarray:
    """The NumPy oracle's logits of ``cfg``'s family on ``points`` with
    the Flax-shaped ``variables`` (``utils.convert.flax_tree_from_torch``);
    a ``spatial_sort`` config wants points already sorted."""
    from sph3d_gcn_torch.utils import numpy_reference as npref

    forward = (npref.forward_modelnet if cfg.global_channels is not None
               else npref.forward_scene_seg)
    return forward(variables, cfg, points)


def compare_logits(logits: np.ndarray, ref: np.ndarray, rtol: float,
                   atol: float, tag: str) -> dict:
    """Print the diffs, the argmax agreement and the ``PARITY[tag]`` line;
    return them with ``ok``, ``allclose(logits, ref, rtol, atol)``."""
    diff = np.abs(logits - ref)
    rel = diff / np.maximum(np.abs(ref), 1e-6)
    agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
    ok = bool(np.allclose(logits, ref, rtol=rtol, atol=atol))
    print(f"max abs diff:  {diff.max():.3e} (|ref| <= "
          f"{np.abs(ref).max():.3g})")
    print(f"max rel diff:  {rel.max():.3e}")
    print(f"argmax agreement: {agree:.4f}")
    print(f"PARITY[{tag}]:", "PASS" if ok else "FAIL", flush=True)
    return {"max_abs": float(diff.max()), "max_rel": float(rel.max()),
            "agree": agree, "ok": ok}


def oracle_parity(cfg, points: np.ndarray, calibration: np.ndarray,
                  device: torch.device | str = "cuda", rtol: float = 1e-4,
                  atol: float = 1e-4, seed: int = 0, tag: str = "") -> dict:
    """The oracle comparison for a config: the seeded model, calibrated on
    ``calibration`` (:func:`calibrate_batch_norm`), runs ``points`` in
    eval mode on ``device``; the oracle runs the same weights on the
    host. A ``spatial_sort`` config wants clouds already sorted (the
    model's sort is then the identity; the oracle skips it). Returns
    :func:`compare_logits`' numbers with ``dense_ok``, the model's
    certificate (True on the per-edge engine)."""
    from sph3d_gcn_torch.utils.convert import flax_tree_from_torch

    if cfg.compute_dtype != "float32":
        raise ValueError("the oracle computes in float32: pass a config "
                         f"with compute_dtype='float32', not "
                         f"{cfg.compute_dtype!r}")
    model = seeded_model(cfg, seed).to(device)
    calibrate_batch_norm(model, torch.from_numpy(calibration).to(device),
                         seed)
    with torch.no_grad():
        logits = model(torch.from_numpy(points).to(device))
    dense_ok = bool(model.dense_ok)
    variables = flax_tree_from_torch(model.state_dict())
    ref = oracle_forward(cfg, variables, points)
    out = compare_logits(logits.float().cpu().numpy(), ref, rtol, atol, tag)
    return dict(out, dense_ok=dense_ok)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", required=True,
                        choices=["modelnet", "s3dis", "scannet",
                                 "ruemonge2014", "shapenet_onehot"])
    parser.add_argument("--ckpt", default=None,
                        help="TF1 checkpoint prefix (model.ckpt-N)")
    parser.add_argument("--batch", default=None,
                        help="npz with 'points', 'logits' (+'cls_label')")
    parser.add_argument("--oracle", action="store_true",
                        help="compare with the NumPy oracle forward "
                             "instead of a TF checkpoint's logits")
    parser.add_argument("--num_input", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--num_cls", type=int, default=None,
                        help="classes of the logits (default: the "
                             "config's; 50 parts for shapenet_onehot)")
    parser.add_argument("--rtol", type=float, default=1e-4)
    parser.add_argument("--atol", type=float, default=1e-4)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    return parser.parse_args(argv)


def oracle_mode(args, device: torch.device) -> bool:
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config

    if args.model not in ("modelnet", "s3dis"):
        raise SystemExit(f"--oracle supports modelnet/s3dis, not "
                         f"{args.model}")
    n = args.num_input or (10000 if args.model == "modelnet" else 8192)
    cfg = (modelnet_config if args.model == "modelnet" else s3dis_config)(
        num_input=n)
    if args.num_cls is not None:
        cfg = dataclasses.replace(cfg, num_cls=args.num_cls)
    rng = np.random.default_rng(0)
    points = synthetic_points(args.model, rng, args.batch_size, n)
    calibration = synthetic_points(args.model, rng, CALIBRATION_CLOUDS, n)
    print(f"[{args.model}] B={args.batch_size} N={n} on {device}, "
          f"oracle on the host", flush=True)
    out = oracle_parity(cfg, points, calibration, device, args.rtol,
                        args.atol, tag=f"{args.model}, oracle, N={n}")
    return out["ok"]


def checkpoint_mode(args, device: torch.device) -> bool:
    from sph3d_gcn_torch import configs
    from sph3d_gcn_torch.models import (
        SPH3DModelNet,
        SPH3DRueMonge,
        SPH3DSceneSeg,
        SPH3DShapeNetOnehot,
    )
    from sph3d_gcn_torch.utils.checkpoint_convert import convert_checkpoint

    data = np.load(args.batch)
    points = data["points"].astype(np.float32)
    ref = data["logits"]
    n = points.shape[1]
    extra = ()
    if args.model == "shapenet_onehot":
        cfg = configs.shapenet_config(num_input=n)
        model = SPH3DShapeNetOnehot(cfg, num_cls=args.num_cls or 50)
        extra = (torch.from_numpy(data["cls_label"].astype(np.int64))
                 .to(device),)
    else:
        cfg = getattr(configs, f"{args.model}_config")(num_input=n)
        if args.num_cls is not None:
            cfg = dataclasses.replace(cfg, num_cls=args.num_cls)
        if args.model == "modelnet":
            model = SPH3DModelNet(cfg)
        elif args.model == "ruemonge2014":
            model = SPH3DRueMonge(cfg, in_columns=points.shape[2])
        else:
            model = SPH3DSceneSeg(cfg, in_columns=points.shape[2])
    model.load_state_dict(convert_checkpoint(model, args.ckpt))
    model = model.to(device).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(points).to(device), *extra)
    out = compare_logits(logits.float().cpu().numpy(), ref, args.rtol,
                         args.atol, f"{args.model}, checkpoint, N={n}")
    return out["ok"]


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.oracle and (not args.ckpt or not args.batch):
        raise SystemExit("--ckpt and --batch are required without --oracle")

    from sph3d_gcn_torch.cli import resolve_device

    device = resolve_device(args.device)
    ok = (oracle_mode if args.oracle else checkpoint_mode)(args, device)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
