"""ModelNet40 classification training (counterpart of the JAX package's
``scripts/train_modelnet.py``, ref modelnet40_cls/train_modelnet.py).

Reads the reference-format tfrecords ({xyz_raw, label}) listed in
``<data_dir>/train_files.txt`` / ``test_files.txt``, trains the SPH3D
classifier with the reference schedule on the card, checkpoints each
epoch and resumes from the latest checkpoint in ``--log_dir``::

    python -m sph3d_gcn_torch.cli.train_modelnet --data_dir DIR \\
        --log_dir log_modelnet --mode dense

Under ``torchrun --nproc_per_node N`` it trains data-parallel (``cli``):
rank i reads every N-th record file at ``batch_size / N`` a step.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--log_dir", default="log_modelnet")
    parser.add_argument("--max_epoch", type=int, default=251)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--optimizer", default="adam",
                        choices=["adam", "momentum"])
    parser.add_argument("--decay_step", type=int, default=250000)
    parser.add_argument("--decay_rate", type=float, default=0.7)
    parser.add_argument("--num_input", type=int, default=10000)
    parser.add_argument("--mode", default="parity",
                        choices=["parity", "fast", "dense"],
                        help="engine: 'parity' = f32 reference-parity, "
                             "'fast' = bf16 + locality-windowed edges, "
                             "'dense' = bf16 + dense windowed engine "
                             "(fastest; exactness certified per step)")
    parser.add_argument("--family", default="plain",
                        choices=["plain", "hard"],
                        help="the fast modes' window calibration: 'plain' "
                             "(smooth ellipsoids) or 'hard' (bump-modulated "
                             "ones, which also cover the augmentation's "
                             "rotated clouds)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bn_prime_steps", type=int, default=0,
                        help="average BN stats over this many fresh train "
                             "batches before each eval pass (cures the "
                             "momentum-0.99 eval lag on short runs)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    from sph3d_gcn_torch.cli import add_parallel_args

    add_parallel_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> torch.nn.Module:
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import read_list, setup_mesh, shard_config
    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.data.datasets import (
        load_modelnet_records,
        modelnet_batches,
    )
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.train.augment_policies import modelnet_train_augment
    from sph3d_gcn_torch.train.checkpoint import snapshot_config
    from sph3d_gcn_torch.train.loop import fit
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import classification_step_factory

    device, group, points = setup_mesh(args)
    cfg = modelnet_config(num_input=args.num_input,
                          fast=args.mode in ("fast", "dense"),
                          dense=args.mode == "dense", family=args.family)
    # the snapshot holds the architecture, not the run's sharding (JAX's)
    snapshot_config(args.log_dir, cfg, group)
    cfg = shard_config(cfg, group, points)
    model = SPH3DModelNet(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(device)
    schedule = exponential_decay_lr(
        args.learning_rate, args.batch_size, args.decay_step, args.decay_rate
    )
    factory = classification_step_factory(
        model, *make_optimizer(model.parameters(), args.optimizer, schedule,
                               momentum=args.momentum),
        weight_decay=cfg.weight_decay, group=group, points=points,
    )

    train_records = load_modelnet_records(
        read_list(os.path.join(args.data_dir, "train_files.txt")))
    test_records = load_modelnet_records(
        read_list(os.path.join(args.data_dir, "test_files.txt")))
    print(f"train: {len(train_records)} shapes, test: {len(test_records)}")

    def train_batches(epoch):
        rng = np.random.default_rng((args.seed, epoch))
        for batch in modelnet_batches(
            train_records, args.batch_size, rng=rng, shuffle=True
        ):
            pts, label = modelnet_train_augment(
                batch["points"], batch["label"], rng
            )
            yield {"points": pts, "label": label}

    def eval_batches():
        return modelnet_batches(test_records, args.batch_size, shuffle=False)

    return fit(
        factory,
        train_batches,
        eval_batches,
        batch_size=args.batch_size,
        num_epochs=args.max_epoch,
        log_dir=args.log_dir,
        seed=args.seed,
        bn_prime_steps=args.bn_prime_steps,
    )


if __name__ == "__main__":
    main()
