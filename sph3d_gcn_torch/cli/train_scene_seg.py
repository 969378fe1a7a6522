"""Scene segmentation training: S3DIS / ScanNet / RueMonge2014
(counterpart of the JAX package's ``scripts/train_scene_seg.py``, ref
s3dis_seg/train_s3dis.py, scannet_seg/train_scannet.py,
ruemonge2014_seg/train_ruemonge2014.py)::

    python -m sph3d_gcn_torch.cli.train_scene_seg --dataset s3dis \\
        --data_dir DIR --mode dense

``--dataset`` selects the config, the model and the augmentation policy.
S3DIS uses 6-fold splits via ``--test_area`` (ref train_s3dis.py:22,60-61).
RueMonge2014 trains ``SPH3DRueMonge`` on xyz, normals and rgb with the
plain mean loss (no inner mask) and its few facade blocks repeated 100
times an epoch (ref train_ruemonge2014.py:63).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", required=True,
                        choices=["s3dis", "scannet", "ruemonge2014"])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--test_area", type=int, default=5,
                        help="s3dis fold (1-6)")
    parser.add_argument("--max_epoch", type=int, default=51)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--optimizer", default="adam",
                        choices=["adam", "momentum"])
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--decay_step", type=int, default=500000)
    parser.add_argument("--decay_rate", type=float, default=0.7)
    parser.add_argument("--adam_eps", type=float, default=1e-4,
                        help="ref train_s3dis.py:226 uses 1e-4")
    parser.add_argument("--num_input", type=int, default=8192)
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
    return parser.parse_args(argv)


def main(argv=None) -> torch.nn.Module:
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import read_list, setup_mesh, shard_config
    from sph3d_gcn_torch.configs import (
        ruemonge2014_config,
        s3dis_config,
        scannet_config,
    )
    from sph3d_gcn_torch.data.datasets import load_scene_blocks, scene_batches
    from sph3d_gcn_torch.models import SPH3DRueMonge, SPH3DSceneSeg
    from sph3d_gcn_torch.train.augment_policies import (
        s3dis_train_augment,
        scannet_train_augment,
    )
    from sph3d_gcn_torch.train.checkpoint import snapshot_config
    from sph3d_gcn_torch.train.loop import fit
    from sph3d_gcn_torch.train.schedule import (
        exponential_decay_lr,
        make_optimizer,
    )
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    device, group, points = setup_mesh(args)
    mode_kw = {"fast": args.mode in ("fast", "dense"),
               "dense": args.mode == "dense"}
    train_list = os.path.join(args.data_dir, "train_files.txt")
    test_list = os.path.join(args.data_dir, "test_files.txt")
    model_class, inner_masked, repeats = SPH3DSceneSeg, True, 1
    if args.dataset == "s3dis":
        cfg = s3dis_config(num_input=args.num_input, **mode_kw)
        augment = s3dis_train_augment
        train_list = os.path.join(
            args.data_dir, f"train_files_fold{args.test_area}.txt")
        test_list = os.path.join(
            args.data_dir, f"test_files_fold{args.test_area}.txt")
    elif args.dataset == "scannet":
        cfg = scannet_config(num_input=args.num_input, **mode_kw)
        augment = scannet_train_augment
    else:
        cfg = ruemonge2014_config(num_input=args.num_input, **mode_kw)
        augment = s3dis_train_augment
        model_class, inner_masked, repeats = SPH3DRueMonge, False, 100

    log_dir = args.log_dir or f"log_{args.dataset}"
    # the snapshot holds the architecture, not the run's sharding (JAX's)
    snapshot_config(log_dir, cfg, group)
    cfg = shard_config(cfg, group, points)
    # the train list repeated ``repeats`` times (RueMonge's 100), as its
    # blocks read once and repeated in the list's order
    train_blocks = load_scene_blocks(read_list(train_list)) * repeats
    test_blocks = load_scene_blocks(read_list(test_list))
    print(f"train blocks: {len(train_blocks)}, test blocks: "
          f"{len(test_blocks)}")

    model = model_class(
        cfg, generator=torch.Generator().manual_seed(args.seed),
        in_columns=train_blocks[0].points.shape[1]).to(device)
    schedule = exponential_decay_lr(
        args.learning_rate, args.batch_size, args.decay_step, args.decay_rate
    )
    factory = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), args.optimizer, schedule,
                               momentum=args.momentum,
                               adam_epsilon=args.adam_eps),
        weight_decay=cfg.weight_decay, inner_masked=inner_masked,
        group=group, points=points,
    )

    def train_batches(epoch):
        rng = np.random.default_rng((args.seed, epoch))
        for batch in scene_batches(
            train_blocks, args.batch_size, cfg.num_input, rng, shuffle=True
        ):
            pts, lbl, inner = augment(
                batch["points"], batch["label"], batch["inner_label"], rng
            )
            out = {"points": pts, "label": lbl}
            if inner_masked:
                out["inner_label"] = inner
            yield out

    def eval_batches():
        rng = np.random.default_rng(12345)
        for batch in scene_batches(test_blocks, args.batch_size,
                                   cfg.num_input, rng, shuffle=False):
            if not inner_masked:
                del batch["inner_label"]
            yield batch

    return fit(
        factory,
        train_batches,
        eval_batches,
        batch_size=args.batch_size,
        num_epochs=args.max_epoch,
        log_dir=log_dir,
        seed=args.seed,
        bn_prime_steps=args.bn_prime_steps,
    )


if __name__ == "__main__":
    main()
