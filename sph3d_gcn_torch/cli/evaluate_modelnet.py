"""ModelNet40 multi-vote evaluation (counterpart of the JAX package's
``scripts/evaluate_modelnet.py``, ref modelnet40_cls/evaluate_modelnet.py):
vote 0 on the raw cloud plus augmented votes, summed logits, overall,
mean-class and per-class accuracy, and the votes written to
``<log_dir>/pred_votes.npz``::

    python -m sph3d_gcn_torch.cli.evaluate_modelnet --data_dir DIR \\
        --log_dir log_modelnet --num_votes 12

The model is rebuilt from the log dir's ``config.json`` (either
package's) and its variables are restored from the checkpoint. A batch
whose dense certificate fails is re-run on the per-edge engine
(``train.eval.checked_eval_step``). Under ``torchrun`` (``cli``) every
rank reads every record and serves its rows of each batch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--log_dir", default="log_modelnet")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--num_votes", type=int, default=12)
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card's kernels) or 'cpu' (the "
                             "plain versions)")
    from sph3d_gcn_torch.cli import add_parallel_args

    add_parallel_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the accuracies, the votes and how many forwards re-ran on
    the per-edge engine."""
    args = parse_args(argv)

    from sph3d_gcn_torch.cli import (
        rank_print,
        read_list,
        setup_mesh,
        shard_config,
    )
    from sph3d_gcn_torch.data.datasets import (
        load_modelnet_records,
        modelnet_batches,
        pad_batch,
    )
    from sph3d_gcn_torch.models import SPH3DModelNet
    from sph3d_gcn_torch.parallel import is_primary, shard_batch
    from sph3d_gcn_torch.train.checkpoint import (
        Checkpointer,
        load_config_snapshot,
    )
    from sph3d_gcn_torch.train.eval import checked_eval_step, vote_classify
    from sph3d_gcn_torch.train.loop import to_device
    from sph3d_gcn_torch.train.metrics import (
        confusion_matrix,
        mean_class_accuracy,
        overall_accuracy,
        per_class_accuracy,
    )
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import classification_step_factory

    device, group, points = setup_mesh(args)
    say = rank_print(group)
    # the trained architecture from the log dir's snapshot (the reference
    # re-imports the copied model/config .py, ref evaluate_modelnet.py:35-46)
    cfg = shard_config(load_config_snapshot(args.log_dir), group, points)
    model = SPH3DModelNet(cfg).to(device)
    epoch = Checkpointer(args.log_dir).restore_variables(model, args.epoch)
    say(f"restored epoch {epoch} from {args.log_dir}")
    factory = classification_step_factory(
        model, *make_optimizer(model.parameters(), "adam", 1e-3),
        weight_decay=cfg.weight_decay, group=group, points=points,
    )
    eval_step = checked_eval_step(factory)
    records = load_modelnet_records(
        read_list(os.path.join(args.data_dir, "test_files.txt")))

    forwards = reruns = 0

    def forward(points):
        nonlocal forwards, reruns
        batch = {"points": points.astype(np.float32),
                 "label": np.zeros(len(points), np.int32)}
        batch, bsize = pad_batch(batch, args.batch_size)
        logits = eval_step(to_device(shard_batch(batch, group),
                                     device))["logits"]
        forwards += 1
        reruns += not bool(model.dense_ok)   # the dense forward's certificate
        return logits[:bsize].float().cpu().numpy()

    rng = np.random.default_rng(0)
    all_pred, all_label, all_votes = [], [], []
    for batch in modelnet_batches(records, args.batch_size, shuffle=False):
        votes = vote_classify(forward, batch["points"], args.num_votes, rng)
        all_votes.append(votes)
        all_pred.append(votes.argmax(-1))
        all_label.append(batch["label"])
    pred = np.concatenate(all_pred)
    label = np.concatenate(all_label)

    cm = confusion_matrix(pred, label, cfg.num_cls)
    say(f"eval accuracy: {overall_accuracy(cm):f}")
    say(f"eval avg class acc: {mean_class_accuracy(cm):f}")
    for i, acc in enumerate(per_class_accuracy(cm)):
        say(f"class {i:02d}: {acc:.3f}")
    say(f"forwards re-run on the per-edge engine: {reruns} of {forwards}")
    votes = np.concatenate(all_votes)
    if is_primary(group):
        np.savez(os.path.join(args.log_dir, "pred_votes.npz"), votes=votes,
                 label=label)
    return {"accuracy": overall_accuracy(cm),
            "mean_class_accuracy": mean_class_accuracy(cm),
            "votes": votes, "label": label, "forwards": forwards,
            "reruns": reruns}


if __name__ == "__main__":
    main()
