"""Evaluation CLI — the reference's ``fusion_test.py`` equivalent.

Identical flag surface to ``edrl.cli.train`` plus ``--checkpoint``
(``fusion_test.py:514``); runs eval only (no ``pdb.set_trace()`` — defect
ledger #11).

    python -m edrl.cli.test --dataset synthetic --checkpoint ckpt_dir/best
"""

from __future__ import annotations


from edrl.cli.train import (
    build_parser,
    config_from_args,
    make_loaders,
    report_eval,
    setup_cli_logging,
)


def resolve_sweep_levels(
    sweep, kind, sweep_levels, sp_sweep_levels, default_sigmas, default_sp
):
    """Per-kind corruption grid for ``--sweep``.

    ``--sweep_levels`` overrides the gaussian grid; with ``--sweep all`` it
    must NOT leak into the salt-pepper kind (sigma 0.25-0.5 read as a
    corrupted-pixel fraction is an order of magnitude past the protocol's
    0.001-0.05 grid — degenerate cells that silently poison the table).
    ``--sp_sweep_levels`` overrides salt-pepper explicitly; a bare
    ``--sweep salt_pepper --sweep_levels ...`` still honors ``sweep_levels``
    (single-kind invocations are unambiguous).
    """
    if kind == "gaussian":
        return tuple(sweep_levels or default_sigmas)
    explicit = (
        sp_sweep_levels if sweep == "all" else (sp_sweep_levels or sweep_levels)
    )
    return tuple(explicit or default_sp)


def main(argv=None):
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    parser = build_parser()
    parser.add_argument("--checkpoint", default="")
    parser.add_argument(
        "--sweep",
        choices=["gaussian", "salt_pepper", "all"],
        default="",
        help="run the noise x modality robustness grid after eval "
        "(the reference's Condition_G/SP_Variance axes, fusion_train.py:548)",
    )
    parser.add_argument(
        "--sweep_levels",
        type=float,
        nargs="+",
        default=None,
        help="corruption levels for --sweep (default: per-kind grid). "
        "With --sweep all this overrides the gaussian grid only — sigma "
        "and corrupted-pixel-fraction scales differ by ~10x, so a shared "
        "list would be nonsense for one of them; use --sp_sweep_levels "
        "for the salt-pepper grid",
    )
    parser.add_argument(
        "--sp_sweep_levels",
        type=float,
        nargs="+",
        default=None,
        help="salt-pepper corrupted-pixel fractions for --sweep "
        "salt_pepper/all (default: DEFAULT_SP_LEVELS)",
    )
    parser.add_argument(
        "--mc_samples",
        type=int,
        default=0,
        help="N>0: MC-dropout — average N stochastic forwards and report the "
        "predictive std (for Multi_dropout_ResNet and the Medical_*dropout* "
        "baselines, reference baseline_models.py:1069-1113)",
    )
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    emit = setup_cli_logging(cfg, args, "test")

    _, val_loader = make_loaders(cfg)

    from edrl.train.checkpoint import CheckpointManager
    from edrl.train.metrics import compute_uncertainty_metrics
    from edrl.train.trainer import init_state, make_eval_step, make_model

    _, state = init_state(cfg, cfg.train.seed)
    if args.checkpoint:
        import os

        directory, name = os.path.split(args.checkpoint.rstrip("/"))
        mgr = CheckpointManager(directory or ".")
        state = mgr.restore(state, name)

    if args.mc_samples > 0:
        from edrl.train.mc_dropout import mc_dropout_predict
        from edrl.train.metrics import compute_epoch_metrics

        pred = mc_dropout_predict(
            cfg, state, val_loader, num_samples=args.mc_samples, seed=cfg.train.seed
        )
        em = compute_epoch_metrics(pred["targets"], pred["probs"], 0.0)
        print(
            f"MC-dropout (K={args.mc_samples}): Acc {em.accuracy:.4f} "
            f"AUC {em.auc:.4f} F1 {em.f1:.4f} "
            f"mean predictive std {pred['predictive_std'].mean():.4f}"
        )
        mc_suite = compute_uncertainty_metrics(pred["targets"], pred["probs"])
        print("MC-dropout suite:", {k: round(v, 4) for k, v in mc_suite.items()})

    eval_step = make_eval_step(make_model(cfg), cfg)
    report_eval(emit, cfg, state, eval_step, val_loader)

    if args.sweep:
        from edrl.train.robustness import (
            DEFAULT_SIGMAS,
            DEFAULT_SP_LEVELS,
            format_sweep,
            noise_sweep,
        )

        kinds = (
            ("gaussian", "salt_pepper") if args.sweep == "all"
            else (args.sweep,)
        )
        for kind in kinds:
            levels = resolve_sweep_levels(
                args.sweep, kind, args.sweep_levels, args.sp_sweep_levels,
                DEFAULT_SIGMAS, DEFAULT_SP_LEVELS,
            )
            res = noise_sweep(cfg, state, sigmas=levels, kind=kind)
            emit(f"Robustness sweep [{kind}]:")
            emit(format_sweep(res))


if __name__ == "__main__":
    main()
