"""Deep-ensemble workflow CLI — the reference's ``test_ensemble`` driver path.

One command reproduces the reference surface (``fusion_train.py:392-502``):
train the five ``Multi_DE{1..5}_ResNet`` members (same late-fusion
architecture, per-member learning rates from the registry), checkpoint each,
then evaluate the logit-averaged ensemble with the 10-metric uncertainty
suite and write ``Metric.txt``.

    python -m edrl.cli.ensemble --dataset synthetic --batch_size 8 \
        --end_epochs 2 --synthetic_samples 32

``--members`` restricts to a subset (e.g. smoke tests); ``--skip_train``
evaluates existing member checkpoints only.
"""

from __future__ import annotations

import dataclasses
import os

from edrl.cli.train import (
    build_parser,
    config_from_args,
    make_loaders,
)


def member_checkpoint_dir(cfg, member: str) -> str:
    return os.path.join(
        cfg.train.checkpoint_dir,
        f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}_{member}",
    )


def run_ensemble(cfg, members, skip_train: bool = False, metric_path: str = "Metric.txt"):
    """Train (optionally) every member, then ensemble-evaluate. Returns the
    metric suite dict."""
    from edrl.train.checkpoint import CheckpointManager
    from edrl.train.ensemble import evaluate_ensemble
    from edrl.train.trainer import fit

    train_loader, val_loader = make_loaders(cfg)
    dirs = []
    for member in members:
        mcfg = cfg.replace(model=dataclasses.replace(cfg.model, model_name=member))
        ckpt_dir = member_checkpoint_dir(mcfg, member)
        dirs.append(ckpt_dir)
        if skip_train:
            continue
        mgr = CheckpointManager(ckpt_dir)
        state, result = fit(
            mcfg, train_loader, val_loader, checkpoint_manager=mgr, verbose=True
        )
        # Always leave a restorable checkpoint, even if no epoch improved on
        # accuracy 0.0 (best-only saving would leave the dir empty).
        mgr.save(state, name="latest")
        mgr.wait()  # commit the async write before this manager goes away
        print(
            f"[{member}] best val acc {result.best_acc:.4f} "
            f"at epoch {result.best_epoch}"
        )

    # Members share one architecture; any member config restores all of them.
    ecfg = cfg.replace(
        model=dataclasses.replace(cfg.model, model_name=members[0])
    )
    suite = evaluate_ensemble(ecfg, dirs, val_loader, output_path=metric_path)
    print(f"Ensemble ({len(members)} members) -> {metric_path}")
    for k, v in suite.items():
        print(f"  {k}: {v:.6f}")
    return suite


def main(argv=None):
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    parser = build_parser()
    parser.add_argument(
        "--members",
        type=int,
        default=5,
        help="number of Multi_DE members to train/evaluate (1-5)",
    )
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--metric_path", default="Metric.txt")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    from edrl.baselines.registry import ENSEMBLE_LRS

    members = list(ENSEMBLE_LRS)[: max(1, min(args.members, len(ENSEMBLE_LRS)))]
    run_ensemble(cfg, members, skip_train=args.skip_train, metric_path=args.metric_path)


if __name__ == "__main__":
    main()
