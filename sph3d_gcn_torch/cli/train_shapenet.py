"""ShapeNet part-segmentation training (counterpart of the JAX package's
``scripts/train_shapenet.py``, ref shapenet_seg/train_shapenet.py and
train_shapenet_onehot.py)::

    python -m sph3d_gcn_torch.cli.train_shapenet --data_dir DIR \\
        --category chair --mode dense
    python -m sph3d_gcn_torch.cli.train_shapenet --data_dir DIR --onehot

``--category`` trains a per-category net on that category's shapes
(``<category>_train_files.txt``) with the reference's class rebalancing:
the shape list repeated ``640 / class_size + 1`` times and the decay step
``class_size * 36`` times that factor (ref train_shapenet.py:33-35,83-90).
``--onehot`` trains the 16-category, 50-part net on ``train_files.txt``
with the category one-hot input (the batches' ``cls_label``) and the
fixed decay step 320000 (ref train_shapenet_onehot.py). No eval pass
runs during training (``cli.evaluate_shapenet`` serves the model).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

SHAPENET_CATEGORIES = [
    "airplane", "bag", "cap", "car", "chair", "earphone", "guitar", "knife",
    "lamp", "laptop", "motorbike", "mug", "pistol", "rocket", "skateboard",
    "table",
]
# per-category part counts (50 global parts over 16 categories)
NUM_PARTS = [4, 2, 2, 4, 4, 3, 3, 2, 4, 2, 6, 2, 3, 3, 3, 3]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--category", default=None,
                        choices=SHAPENET_CATEGORIES,
                        help="per-category net (omit with --onehot)")
    parser.add_argument("--onehot", action="store_true")
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--max_epoch", type=int, default=201)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--optimizer", default="adam",
                        choices=["adam", "momentum"])
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--decay_rate", type=float, default=0.7)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mode", default="parity",
                        choices=["parity", "fast", "dense"],
                        help="engine: 'parity' = f32 reference-parity, "
                             "'fast' = bf16 + locality-windowed edges, "
                             "'dense' = bf16 + dense windowed engine "
                             "(fastest; exactness certified per step)")
    parser.add_argument("--bn_prime_steps", type=int, default=0,
                        help="average BN stats over this many fresh train "
                             "batches before each eval pass (cures the "
                             "momentum-0.99 eval lag on short runs)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    from sph3d_gcn_torch.cli import add_parallel_args

    add_parallel_args(parser)
    args = parser.parse_args(argv)
    if not args.onehot and args.category is None:
        parser.error("--category is required unless --onehot")
    return args


def main(argv=None) -> torch.nn.Module:
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import read_list, setup_mesh, shard_config
    from sph3d_gcn_torch.configs import shapenet_config
    from sph3d_gcn_torch.data.datasets import resample_indices
    from sph3d_gcn_torch.data.prep.shapenet import load_shapenet_records
    from sph3d_gcn_torch.models import SPH3DShapeNet, SPH3DShapeNetOnehot
    from sph3d_gcn_torch.train.augment_policies import shapenet_train_augment
    from sph3d_gcn_torch.train.checkpoint import snapshot_config
    from sph3d_gcn_torch.train.loop import fit
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    device, group, points = setup_mesh(args)
    arch = shapenet_config(fast=args.mode in ("fast", "dense"),
                           dense=args.mode == "dense")
    cfg = shard_config(arch, group, points)
    gen = torch.Generator().manual_seed(args.seed)
    if args.onehot:
        model = SPH3DShapeNetOnehot(cfg, num_cls=50, generator=gen)
        train_list = "train_files.txt"
        decay_step = 320000
        label_key = "seg_label"
        log_dir = args.log_dir or "log_shapenet_onehot"
    else:
        cat_id = SHAPENET_CATEGORIES.index(args.category)
        model = SPH3DShapeNet(cfg, num_cls=NUM_PARTS[cat_id], generator=gen)
        train_list = f"{args.category}_train_files.txt"
        label_key = "part_label"
        log_dir = args.log_dir or f"log_shapenet_{args.category}"
    model = model.to(device)

    records = load_shapenet_records(
        read_list(os.path.join(args.data_dir, train_list)))
    if not args.onehot:
        records = [r for r in records if r["cls_label"] == cat_id]
        # class rebalancing (ref train_shapenet.py:33-35,83-90)
        factor = int(np.int32(640 / max(1, len(records)))) + 1
        decay_step = factor * len(records) * 36
        records = records * factor
    print(f"{len(records)} training shapes, decay_step={decay_step}")
    # the snapshot holds the architecture, not the run's sharding (JAX's)
    snapshot_config(log_dir, arch, group)

    schedule = exponential_decay_lr(
        args.learning_rate, args.batch_size, decay_step, args.decay_rate)
    factory = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), args.optimizer, schedule,
                               momentum=args.momentum),
        weight_decay=cfg.weight_decay,
        model_kwargs_keys=("cls_label",) if args.onehot else (),
        group=group, points=points,
    )

    def train_batches(epoch):
        rng = np.random.default_rng((args.seed, epoch))
        order = rng.permutation(len(records))
        for start in range(0, len(order), args.batch_size):
            sel = order[start: start + args.batch_size]
            pts = np.zeros((len(sel), cfg.num_input, 3), np.float32)
            lbl = np.zeros((len(sel), cfg.num_input), np.int32)
            cls = np.zeros((len(sel),), np.int32)
            for j, i in enumerate(sel):
                rec = records[i]
                ridx = resample_indices(len(rec[label_key]), cfg.num_input,
                                        rng)
                pts[j] = rec["xyz"][ridx]
                lbl[j] = rec[label_key][ridx]  # stored 0-based
                cls[j] = rec["cls_label"]
            # the categories follow their shapes through the shuffle
            pts, lbl, cls = shapenet_train_augment(pts, lbl, rng, cls)
            batch = {"points": pts, "label": lbl}
            if args.onehot:
                batch["cls_label"] = cls
            yield batch

    return fit(
        factory,
        train_batches,
        None,
        batch_size=args.batch_size,
        num_epochs=args.max_epoch,
        log_dir=log_dir,
        seed=args.seed,
        bn_prime_steps=args.bn_prime_steps,
    )


if __name__ == "__main__":
    main()
