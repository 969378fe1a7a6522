"""Calibrate the dense engine's windows for a dataset (counterpart of the
JAX package's ``scripts/measure_windows.py``).

Measures, on sample clouds (synthetic families or real clouds from an
npz), the per-level slab widths every graph of the model's pyramid needs
for the dense certificate to hold — encoder intra, pooling, decoder
intra, decoder inter with the +0.05 radius growth — and derives the
smallest ``SPH3DConfig.windows`` / ``dec_windows`` / ``dec_margin`` /
``growth_steps`` that cover them with a margin (``utils.windows``)::

    python -m sph3d_gcn_torch.cli.measure_windows --dataset modelnet
    python -m sph3d_gcn_torch.cli.measure_windows --dataset s3dis \\
        --data blocks.npz

ModelNet and ShapeNet are measured on surface families (bump-modulated
and smooth ellipsoids), S3DIS, ScanNet and RueMonge2014 on scene blocks
(plane-heavy and uniform). ShapeNet's clouds are unit-sphere normalized
first, as its data preparation normalizes them offline; its model then
builds its graphs on them as they are.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def bumpy_ellipsoids(rng, batch, n, amplitude=0.1):
    """Ellipsoid surfaces with sinusoidal bumps (CAD scans have surface
    detail that concentrates sorted-row slabs; plain ellipsoids
    under-estimate), normalized into the unit cube as the JAX package's
    family is."""
    v = rng.standard_normal((batch, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    freq = rng.uniform(2.0, 6.0, (batch, 1, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, (batch, 1, 3)).astype(np.float32)
    bump = 1.0 + amplitude * np.sin(freq * v + phase).sum(-1, keepdims=True)
    axes = rng.uniform(0.3, 1.0, (batch, 1, 3)).astype(np.float32)
    pts = v * bump * axes
    pts /= np.abs(pts).max(axis=(1, 2), keepdims=True)
    return pts


def scene_blocks_worst(rng, batch, n):
    """1.5 m blocks with a dominant floor or wall plane (half the cloud in
    one thin slab of two of the axes)."""
    pts = np.empty((batch, n, 3), np.float32)
    for b in range(batch):
        n_plane = int(n * rng.uniform(0.3, 0.6))
        plane = rng.uniform(0, 1.5, (n_plane, 3)).astype(np.float32)
        axis = rng.integers(0, 3)
        plane[:, axis] = rng.normal(0.02, 0.01, n_plane)
        rest = rng.uniform(0, 1.5, (n - n_plane, 3)).astype(np.float32)
        rest[:, 2] *= 2.0
        pts[b] = np.concatenate([plane, rest])
    return pts


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", required=True,
                        choices=["modelnet", "shapenet", "s3dis", "scannet",
                                 "ruemonge2014"])
    parser.add_argument("--samples", type=int, default=32,
                        help="number of synthetic clouds of each family")
    parser.add_argument("--num_input", type=int, default=None,
                        help="points a cloud (default: the config's)")
    parser.add_argument("--data", default=None,
                        help="npz with a (B, N, 3+) 'points' array of real "
                             "clouds (overrides the synthetic family)")
    parser.add_argument("--margin", type=float, default=0.10,
                        help="headroom multiplier on measured worst slabs")
    parser.add_argument("--family", default="union",
                        choices=["plain", "hard", "union"],
                        help="synthetic cloud family: 'plain' = the bench "
                             "generators, 'hard' = bump-modulated / "
                             "plane-heavy worst cases, 'union' = both")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (FPS on the card) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None) -> tuple:
    """Prints the measurements and the derived windows; returns
    (windows, dec_windows, dec_margin, growth_steps)."""
    args = parse_args(argv)

    from sph3d_gcn_torch import configs
    from sph3d_gcn_torch.cli import resolve_device
    from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
    from sph3d_gcn_torch.models.common import normalize_unit_sphere
    from sph3d_gcn_torch.utils.windows import (
        derive_config_windows,
        measure_requirements,
    )

    device = resolve_device(args.device)
    factory = getattr(configs, f"{args.dataset}_config")
    cfg = factory() if args.num_input is None else factory(
        num_input=args.num_input)
    rng = np.random.default_rng(args.seed)
    n = cfg.num_input
    if args.data:
        clouds = np.load(args.data)["points"][..., :3][:, :n]
    else:
        hard, plain = ((bumpy_ellipsoids, surface_clouds)
                       if args.dataset in ("modelnet", "shapenet") else
                       (scene_blocks_worst, scene_blocks))
        fams = []
        if args.family in ("hard", "union"):
            fams.append(hard(rng, args.samples, n)[..., :3])
        if args.family in ("plain", "union"):
            fams.append(plain(rng, args.samples, n)[..., :3])
        clouds = np.concatenate(fams)
    if args.dataset == "shapenet":
        # the offline normalization of ShapeNet's data preparation
        clouds = normalize_unit_sphere(torch.from_numpy(
            np.ascontiguousarray(clouds, np.float32))).numpy()
    # ModelNet's model sorts the raw cloud, then builds its graphs on the
    # unit-sphere-normalized one (models/modelnet.py); raw clouds would
    # overstate small shapes' slabs, and clouds normalized before the sort
    # may pick another sort axis than the model does
    reqs = measure_requirements(
        cfg, clouds, device=device,
        normalize=normalize_unit_sphere if args.dataset == "modelnet"
        else None)
    print(f"measured over {len(clouds)} clouds of {clouds.shape[1]} points:")
    for level, r in enumerate(reqs):
        print(
            f"  level {level}: enc {r.enc:5d}  pool {r.pool:5d}  "
            f"dec {r.dec:5d}  dec_inter {r.dec_inter:5d}  "
            f"growth {r.growth}"
        )
    derived = derive_config_windows(cfg, reqs, margin=args.margin)
    windows, dec_windows, dec_margin, growth = derived
    print(f"\nderived (margin {args.margin:.0%}):")
    print(f"  windows      = {windows}")
    print(f"  dec_windows  = {dec_windows}")
    print(f"  dec_margin   = {dec_margin}")
    print(f"  growth_steps = {growth}")
    probe = dataclasses.replace(
        cfg, windows=windows, dec_windows=dec_windows, spatial_sort=True
    )
    print("  derived graph windows per level:")
    for level in range(len(windows)):
        print(
            f"    level {level}: enc {probe.enc_window(level):5d}  "
            f"pool {probe.pool_window(level):5d}  "
            f"dec {probe.dec_window(level):5d}  "
            f"dec_inter {probe.dec_window(level) + dec_margin:5d}"
        )
    return derived


if __name__ == "__main__":
    main()
