"""Scene segmentation evaluation with the block-to-scene re-merge
(counterpart of the JAX package's ``scripts/evaluate_scene_seg.py``,
which folds the reference's coverage-voting eval
``evaluate_s3dis_with_overlap.py``, its block->scene index export and
the MATLAB merge ``post-merging/s3dis_merge.m`` into one run)::

    python -m sph3d_gcn_torch.cli.evaluate_scene_seg --dataset s3dis \\
        --data_dir DIR --log_dir log_s3dis --test_area 5 \\
        --scene_dir SCENES

Each test block (records with ``index_label``, the block->scene map) is
coverage-voted: resampled to the model's size until every inner point
was sampled, resamples of different blocks sharing a batch, logits
summed per block point; the block-level OA and mIoU are printed. With
``--scene_dir`` (one ``<scene>.npz`` a scene: the voxelized ``xyz`` and
``label``, optionally ``full_xyz`` / ``full_label`` at full resolution)
the blocks' inner logits are merged onto each scene, projected to the
full cloud by nearest neighbour where it is given, and the merged OA,
mAcc, mIoU and per-class IoU are printed; the raw counts go to
``<log_dir>/Area_<test_area>_metric.npz`` for ``cli.aggregate_folds``.
``--save_blocks`` writes each block's points, logits, index, inner mask
and labels to ``<log_dir>/block_results/<scene>_<i>.npz``;
``--submission_dir`` (ScanNet) writes each scene's NYU-40 labels as
text. A batch whose dense certificate fails is re-run on the per-edge
engine (``train.eval.checked_eval_step``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", required=True,
                        choices=["s3dis", "scannet", "ruemonge2014"])
    parser.add_argument("--data_dir", required=True,
                        help="block record directory")
    parser.add_argument("--scene_dir", default=None,
                        help="per-scene npz ground-truth directory")
    parser.add_argument("--log_dir", required=True)
    parser.add_argument("--test_area", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--save_blocks", action="store_true",
                        help="write each block's logits as npz, like the "
                             "reference's .mat files")
    parser.add_argument("--submission_dir", default=None,
                        help="ScanNet only: write per-scene NYU-40 label txt "
                             "files for benchmark submission "
                             "(ref post-merging/scannet_merge.m:53-66)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    from sph3d_gcn_torch.cli import add_parallel_args

    add_parallel_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the block-level and merged accumulators
    (``data.merge.SceneAccumulator``; the merged one None without
    ``--scene_dir``), each block's summed logits, each scene's merged
    voxel labels, and how many forwards ran and re-ran on the per-edge
    engine."""
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import (
        rank_print,
        read_list,
        setup_mesh,
        shard_config,
    )
    from sph3d_gcn_torch.data.datasets import load_scene_blocks
    from sph3d_gcn_torch.data.merge import (
        SceneAccumulator,
        merge_scene_predictions,
        project_labels_to_full_cloud,
    )
    from sph3d_gcn_torch.data.prep.scannet import benchmark21_to_nyu40
    from sph3d_gcn_torch.models import SPH3DRueMonge, SPH3DSceneSeg
    from sph3d_gcn_torch.parallel import is_primary, shard_batch
    from sph3d_gcn_torch.train.checkpoint import (
        Checkpointer,
        load_config_snapshot,
    )
    from sph3d_gcn_torch.train.eval import (
        checked_eval_step,
        coverage_eval_blocks,
    )
    from sph3d_gcn_torch.train.loop import to_device
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import segmentation_step_factory

    device, group, points = setup_mesh(args)
    say = rank_print(group)
    primary = is_primary(group)
    ruemonge = args.dataset == "ruemonge2014"
    test_list = os.path.join(
        args.data_dir, f"test_files_fold{args.test_area}.txt"
        if args.dataset == "s3dis" else "test_files.txt")
    test_files = read_list(test_list)
    blocks = load_scene_blocks(test_files, with_index=True)
    say(f"evaluating {len(blocks)} blocks from {len(test_files)} scenes")

    cfg = shard_config(load_config_snapshot(args.log_dir), group, points)
    model_class = SPH3DRueMonge if ruemonge else SPH3DSceneSeg
    model = model_class(cfg, in_columns=blocks[0].points.shape[1]).to(device)
    epoch = Checkpointer(args.log_dir).restore_variables(model, args.epoch)
    say(f"restored epoch {epoch} from {args.log_dir}")
    factory = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", 1e-3),
        inner_masked=not ruemonge, group=group, points=points,
    )
    eval_step = checked_eval_step(factory)

    forwards = reruns = 0

    def forward(points, _ids):
        nonlocal forwards, reruns
        batch = {"points": points.astype(np.float32),
                 "label": np.zeros(points.shape[:2], np.int32),
                 "inner_label": np.ones(points.shape[:2], np.int32)}
        logits = eval_step(to_device(shard_batch(batch, group),
                                     device))["logits"]
        forwards += 1
        reruns += not bool(model.dense_ok)   # the dense forward's certificate
        return logits.float().cpu().numpy()

    # coverage voting, batched across blocks
    # (ref evaluate_s3dis_with_overlap.py:270-302)
    rng = np.random.default_rng(0)
    all_logits = coverage_eval_blocks(
        forward, [(blk.points, blk.inner) for blk in blocks], cfg.num_input,
        args.batch_size, rng)
    per_scene: dict[str, list] = {}
    block_acc = SceneAccumulator(num_cls=cfg.num_cls)
    out_dir = os.path.join(args.log_dir, "block_results")
    save_blocks = args.save_blocks and primary
    if save_blocks:
        os.makedirs(out_dir, exist_ok=True)
    for i, (blk, logits) in enumerate(zip(blocks, all_logits)):
        inner = blk.inner == 1
        block_acc.add_scene(logits.argmax(-1)[inner], blk.label[inner])
        per_scene.setdefault(blk.scene, []).append(
            (blk.index, blk.inner, logits))
        if save_blocks:
            np.savez(os.path.join(out_dir, f"{blk.scene}_{i}.npz"),
                     data=blk.points, logits=logits, index=blk.index,
                     inner=blk.inner, label=blk.label)
    say(f"block-level OA: {block_acc.overall_accuracy:.4f} "
          f"mIoU: {block_acc.mean_iou:.4f}")
    say(f"forwards re-run on the per-edge engine: {reruns} of {forwards}")

    # scene re-merge (ref post-merging/s3dis_merge.m)
    acc = None
    merged: dict[str, np.ndarray] = {}
    if args.scene_dir:
        acc = SceneAccumulator(num_cls=cfg.num_cls)
        for scene, blks in sorted(per_scene.items()):
            path = os.path.join(args.scene_dir, scene + ".npz")
            if not os.path.exists(path):
                say(f"missing scene ground truth: {path}")
                continue
            gt = np.load(path)
            labels = merge_scene_predictions(len(gt["label"]), blks,
                                             cfg.num_cls)
            merged[scene] = labels
            full = "full_xyz" in gt
            if (args.submission_dir and args.dataset == "scannet"
                    and primary):
                os.makedirs(args.submission_dir, exist_ok=True)
                out_labels = benchmark21_to_nyu40(labels)
                if full:
                    out_labels = project_labels_to_full_cloud(
                        gt["xyz"], out_labels, gt["full_xyz"])
                np.savetxt(os.path.join(args.submission_dir, scene + ".txt"),
                           out_labels, fmt="%d")
            if full:
                acc.add_scene(project_labels_to_full_cloud(
                    gt["xyz"], labels, gt["full_xyz"]), gt["full_label"])
            else:
                acc.add_scene(labels, gt["label"])
            say(f"{scene}: running OA {acc.overall_accuracy:.4f}")
        say("================== merged scene metrics ==================")
        say(f"OA:   {acc.overall_accuracy:.4f}")
        say(f"mAcc: {acc.mean_acc:.4f}")
        say(f"mIoU: {acc.mean_iou:.4f}")
        for c, iou in enumerate(acc.class_iou):
            say(f"class {c:02d} IoU: {iou:.4f}")
        # raw counts for the cross-fold aggregate (cli.aggregate_folds;
        # ref post-merging/s3dis_merge.m:96-99, s3dis_merge_6Areas.m)
        metric_path = os.path.join(args.log_dir,
                                   f"Area_{args.test_area}_metric.npz")
        if primary:
            acc.save(metric_path)
            say(f"saved fold counts to {metric_path}")
    return {"block_accumulator": block_acc, "accumulator": acc,
            "logits": all_logits, "merged": merged, "forwards": forwards,
            "reruns": reruns}


if __name__ == "__main__":
    main()
