"""ShapeNet part-segmentation evaluation (counterpart of the JAX package's
``scripts/evaluate_shapenet.py``, ref shapenet_seg/evaluate_shapenet.py,
evaluate_shapenet_onehot.py and post-merging/shapenet_mIoU.m)::

    python -m sph3d_gcn_torch.cli.evaluate_shapenet --data_dir DIR \\
        --category chair --log_dir log_shapenet_chair
    python -m sph3d_gcn_torch.cli.evaluate_shapenet --data_dir DIR \\
        --onehot --log_dir log_shapenet_onehot

Each shape is coverage-voted: resampled to the model's size until each of
its points was sampled 11 times (more than 10), each resample with a
second, augmented pass, logits summed; resamples of different shapes
share a batch (ref evaluate_shapenet.py:228-247). Then each shape's IoU
over its category's parts (the one-hot net: the parts its labels hold),
a part in neither prediction nor label counting 1; the instance mIoU
(over shapes) and the class mIoU (over categories) are printed, and
each shape's predicted and true labels written to
``<log_dir>/pred/shape_<i>.txt``. A batch whose dense certificate fails
is re-run on the per-edge engine (``train.eval.checked_eval_step``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# samples each point needs (ref evaluate_shapenet.py:239: more than 10)
MIN_COUNT = 11


def parse_args(argv=None) -> argparse.Namespace:
    from sph3d_gcn_torch.cli.train_shapenet import SHAPENET_CATEGORIES

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--category", default=None,
                        choices=SHAPENET_CATEGORIES)
    parser.add_argument("--onehot", action="store_true")
    parser.add_argument("--log_dir", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    from sph3d_gcn_torch.cli import add_parallel_args

    add_parallel_args(parser)
    args = parser.parse_args(argv)
    if not args.onehot and args.category is None:
        parser.error("--category is required unless --onehot")
    return args


def main(argv=None) -> dict:
    """Returns the instance and class mIoU, each shape's IoU and summed
    logits, and how many forwards ran and re-ran on the per-edge
    engine."""
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import (
        rank_print,
        read_list,
        setup_mesh,
        shard_config,
    )
    from sph3d_gcn_torch.cli.train_shapenet import (
        NUM_PARTS,
        SHAPENET_CATEGORIES,
    )
    from sph3d_gcn_torch.data.prep.shapenet import load_shapenet_records
    from sph3d_gcn_torch.models import SPH3DShapeNet, SPH3DShapeNetOnehot
    from sph3d_gcn_torch.parallel import is_primary, shard_batch
    from sph3d_gcn_torch.train.checkpoint import (
        Checkpointer,
        load_config_snapshot,
    )
    from sph3d_gcn_torch.train.eval import (
        checked_eval_step,
        coverage_eval_blocks,
        shapenet_eval_augment,
    )
    from sph3d_gcn_torch.train.loop import to_device
    from sph3d_gcn_torch.train.metrics import shape_iou
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    device, group, points = setup_mesh(args)
    say = rank_print(group)
    primary = is_primary(group)
    cfg = shard_config(load_config_snapshot(args.log_dir), group, points)
    if args.onehot:
        model = SPH3DShapeNetOnehot(cfg, num_cls=50)
        test_list = "test_files.txt"
        label_key = "seg_label"
        kwargs_keys = ("cls_label",)
    else:
        cat_id = SHAPENET_CATEGORIES.index(args.category)
        model = SPH3DShapeNet(cfg, num_cls=NUM_PARTS[cat_id])
        test_list = f"{args.category}_test_files.txt"
        label_key = "part_label"
        kwargs_keys = ()
    model = model.to(device)
    epoch = Checkpointer(args.log_dir).restore_variables(model, args.epoch)
    say(f"restored epoch {epoch} from {args.log_dir}")

    records = load_shapenet_records(
        read_list(os.path.join(args.data_dir, test_list)))
    if not args.onehot:
        records = [r for r in records if r["cls_label"] == cat_id]
    say(f"evaluating {len(records)} shapes")

    factory = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", 1e-3),
        model_kwargs_keys=kwargs_keys, group=group, points=points,
    )
    eval_step = checked_eval_step(factory)
    forwards = reruns = 0

    def forward(points, ids):
        nonlocal forwards, reruns
        batch = {"points": points.astype(np.float32),
                 "label": np.zeros(points.shape[:2], np.int32),
                 "cls_label": np.array([records[i]["cls_label"] for i in ids],
                                       np.int32)}
        logits = eval_step(to_device(shard_batch(batch, group),
                                     device))["logits"]
        forwards += 1
        reruns += not bool(model.dense_ok)   # the dense forward's certificate
        return logits.float().cpu().numpy()

    # more than 10 samples a point, raw and augmented passes, batched
    # across shapes (ref evaluate_shapenet.py:228-247)
    all_logits = coverage_eval_blocks(
        forward,
        [(rec["xyz"], np.ones(len(rec[label_key]), np.int32))
         for rec in records],
        cfg.num_input, args.batch_size, np.random.default_rng(0),
        min_count=MIN_COUNT, augment_fn=shapenet_eval_augment)
    out_dir = os.path.join(args.log_dir, "pred")
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    instance_ious = []
    per_class: dict[int, list[float]] = {}
    for i, (rec, logits) in enumerate(zip(records, all_logits)):
        cls = rec["cls_label"]
        label = rec[label_key]
        pred = logits.argmax(-1)
        part_ids = (np.unique(rec["seg_label"]) if args.onehot
                    else np.arange(NUM_PARTS[cls]))
        iou = shape_iou(pred, label, part_ids)
        instance_ious.append(iou)
        per_class.setdefault(cls, []).append(iou)
        if primary:
            np.savetxt(os.path.join(out_dir, f"shape_{i}.txt"),
                       np.stack([pred, label], axis=1), fmt="%d")

    instance = float(np.mean(instance_ious))
    class_miou = float(np.mean([np.mean(v) for v in per_class.values()]))
    say(f"instance mIoU: {instance:.4f}")
    say(f"class mIoU: {class_miou:.4f}")
    say(f"forwards re-run on the per-edge engine: {reruns} of {forwards}")
    return {"instance_miou": instance, "class_miou": class_miou,
            "shape_ious": instance_ious, "logits": all_logits,
            "forwards": forwards, "reruns": reruns}


if __name__ == "__main__":
    main()
