"""Training CLI — mirrors the reference's ``fusion_train.py`` flag surface.

Every reference flag (``fusion_train.py:510-542``) has an equivalent here,
plus the knobs the reference hard-coded or broke (noise lows/highs, fold
selection, device mesh shape).  Examples:

    # reference Run_fusion.sh equivalent (synthetic data):
    python -m edrl.cli.train --model_name MedFusion --dataset synthetic \
        --lr 1e-5 --batch_size 32 --end_epochs 200 --Condition_G_Variance 0.5

    # real GAMMA-layout data:
    python -m edrl.cli.train --dataset dr2 --data_path /data/MGamma \
        --label_file /data/train_839.xlsx --folder folder0
"""

from __future__ import annotations

import argparse

import numpy as np

from edrl.config import DataConfig, EDRLConfig, ModelConfig, NoiseConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # Reference flags (``fusion_train.py:510-542``).
    p.add_argument("--modal_number", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--end_epochs", type=int, default=200)
    # Default 0 = disabled: the reference's default (198, fusion_train.py:517)
    # would silently divert the test phase to epoch_198 whenever --save_every
    # happened to keep that checkpoint; only an explicit flag should.
    p.add_argument("--test_epoch", type=int, default=0)
    p.add_argument("--lambda_epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument(
        "--warmup_steps", type=int, default=100,
        help="linear LR warmup over N optimizer steps (default 100 — "
        "rescues seed-dependent init plateaus, ABLATION_FUSION_WARMUP.md; "
        "0 = strict reference constant-lr parity)",
    )
    p.add_argument(
        "--grad_clip_norm", type=float, default=0.0,
        help="global-norm gradient clipping (0 = off, reference behavior)",
    )
    p.add_argument("--model_name", default="MedFusion")
    p.add_argument("--dataset", default="synthetic", help="synthetic/dr2/glu2")
    p.add_argument("--folder", default="folder0")
    p.add_argument("--mode", default="train&test", help="train/test/train&test")
    p.add_argument("--model_base", default="transformer")
    p.add_argument("--condition", default="noise", help="noise/normal")
    p.add_argument("--condition_name", default="Gaussian")
    p.add_argument("--Condition_SP_Variance", type=float, default=0.005)
    p.add_argument("--Condition_G_Variance", type=float, default=0.5)
    p.add_argument("--name", default="checkpoint_0.3")
    # Fixed/new knobs.
    p.add_argument("--Condition_G_Variance_low", type=float, default=0.0)
    p.add_argument("--Condition_SP_Variance_low", type=float, default=0.0)
    p.add_argument("--data_path", default="")
    p.add_argument("--label_file", default="")
    p.add_argument("--checkpoint_dir", default="checkpoint")
    p.add_argument("--log_dir", default="log")
    # End-of-run loss/acc curves, written like the reference's
    # (``fusion_train.py:771-772``) when set; needs matplotlib (the `plots`
    # extra), which the training path otherwise does not.
    p.add_argument("--plot_dir", default="")
    p.add_argument(
        "--student_t_every",
        type=int,
        default=0,
        help="dump EPRL proxy Student-t PDF grids to --plot_dir every N "
        "epochs (reference fusion_net.py:852-868 intent; 0 = off)",
    )
    p.add_argument(
        "--save_every",
        type=int,
        default=0,
        help="keep an epoch_{N} checkpoint every N epochs so --test_epoch "
        "can evaluate that epoch (0 = best-only)",
    )
    p.add_argument(
        "--save_latest_every",
        type=int,
        default=0,
        help="rolling 'latest' checkpoint every N epochs for preemption "
        "resume (async write, overlaps training; 0 = off)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="restore the 'latest' checkpoint (if present) and continue "
        "from the epoch derived from its step counter",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_model_shards", type=int, default=1)
    p.add_argument(
        "--zero1",
        action="store_true",
        help="shard Adam moment buffers over the data mesh axis (ZeRO-1); "
        "needs a multi-device mesh",
    )
    # Steps per jitted call (lax.scan); amortizes per-step dispatch
    # latency.  0 = per-batch dispatch.
    p.add_argument("--scan_batches", type=int, default=0)
    p.add_argument("--no_bfloat16", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument(
        "--host_noise",
        action="store_true",
        help="build noise views on the host (reference parity) instead of on-device",
    )
    p.add_argument("--synthetic_samples", type=int, default=128)
    p.add_argument(
        "--num_classes",
        type=int,
        default=2,
        help="grading classes; the label schema carries 4 one-hot columns "
        "(train_true.xlsx) though the shipped reference only ran binary",
    )
    return p


def config_from_args(args) -> EDRLConfig:
    noise = NoiseConfig(
        condition=args.condition,
        condition_name=args.condition_name,
        gaussian_low=args.Condition_G_Variance_low,
        gaussian_high=args.Condition_G_Variance,
        salt_pepper_low=args.Condition_SP_Variance_low,
        salt_pepper_high=args.Condition_SP_Variance,
    )
    data = DataConfig(
        dataset=args.dataset,
        data_path=args.data_path,
        label_file=args.label_file,
        batch_size=args.batch_size,
        fold=int(args.folder[-1]) if args.folder[-1].isdigit() else 0,
        noise=noise,
        num_classes=args.num_classes,
        num_synthetic_samples=args.synthetic_samples,
        device_noise=not args.host_noise,
    )
    model = ModelConfig(
        model_name=args.model_name,
        num_classes=args.num_classes,
        use_bfloat16=not args.no_bfloat16,
        remat=args.remat,
    )
    train = TrainConfig(
        mode=args.mode,
        lr=args.lr,
        warmup_steps=getattr(args, "warmup_steps", 100),
        grad_clip_norm=getattr(args, "grad_clip_norm", 0.0),
        start_epoch=args.start_epoch,
        end_epochs=args.end_epochs,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir,
        plot_dir=getattr(args, "plot_dir", ""),
        student_t_every=getattr(args, "student_t_every", 0),
        save_every=getattr(args, "save_every", 0),
        save_latest_every=getattr(args, "save_latest_every", 0),
        resume=getattr(args, "resume", False),
        name=args.name,
        num_model_shards=args.num_model_shards,
        zero1=getattr(args, "zero1", False),
        scan_batches=args.scan_batches,
    )
    return EDRLConfig(data=data, model=model, train=train)


def make_loaders(cfg: EDRLConfig):
    from edrl.data import (
        SYNTHETIC_DATASETS,
        BatchLoader,
        GammaDataset,
        kfold_split,
    )

    if cfg.data.dataset in SYNTHETIC_DATASETS:
        ds_cls = SYNTHETIC_DATASETS[cfg.data.dataset]
        train_ds = ds_cls(cfg.data, mode="train")
        val_ds = ds_cls(cfg.data, mode="val")
    elif cfg.data.dataset == "glu2":
        # glu2 branch: sequential 80/20 split of the label-file id order
        # (``fusion_train.py:619-631``), not k-fold.
        if cfg.data.label_file.endswith(".csv"):
            import pandas as pd

            raw_ids = pd.read_csv(cfg.data.label_file)["data"].astype(str).values
        else:
            from edrl.data.xlsx import read_xlsx_dict

            raw_ids = [str(x) for x in read_xlsx_dict(cfg.data.label_file)["data"]]
        ids = [str(x).split(".")[0].zfill(5) for x in raw_ids]
        n_train = int(len(ids) * 0.8)
        train_ds = GammaDataset(cfg.data, mode="train", filelists=ids[:n_train])
        val_ds = GammaDataset(cfg.data, mode="val", filelists=ids[n_train:])
    else:
        # dr2 and other GAMMA-layout datasets: shuffled 5-fold
        # (``fusion_train.py:564``).
        import os

        filelists = sorted(os.listdir(cfg.data.data_path))
        folds = kfold_split(filelists, cfg.data.folds, cfg.data.split_seed)
        train_files, val_files = folds[cfg.data.fold]
        train_ds = GammaDataset(cfg.data, mode="train", filelists=list(train_files))
        val_ds = GammaDataset(cfg.data, mode="val", filelists=list(val_files))
    u8 = cfg.data.device_noise and cfg.data.uint8_transport
    train_loader = BatchLoader(
        train_ds,
        cfg.data.batch_size,
        shuffle=True,
        drop_last=True,
        seed=cfg.train.seed,
        uint8_transport=u8,
    )
    # Eval keeps the remainder batch (the reference's drop_last val loader
    # silently evaluated on nothing when the fold was smaller than the
    # eval batch; here every sample is scored).
    val_loader = BatchLoader(
        val_ds,
        min(cfg.data.eval_batch_size, max(len(val_ds), 1)),
        shuffle=False,
        drop_last=False,
        uint8_transport=u8,
    )
    return train_loader, val_loader


def setup_cli_logging(cfg, args, phase: str):
    """File+console logging of the run configuration — the reference defined
    ``log_args`` (``fusion_train.py:44-63``) but never wired it; here every
    CLI run leaves a .log next to its CSVs.  Returns the ``emit`` callable
    (``logger.info`` when ``--log_dir`` is set, else ``print``)."""
    if not cfg.train.log_dir:
        return print
    import os

    from edrl.train.logging import setup_logging

    logger = setup_logging(
        os.path.join(
            cfg.train.log_dir,
            f"{cfg.data.dataset}_{cfg.train.name}_{phase}.log",
        )
    )
    logger.info("args: %s", vars(args))
    return logger.info


def report_eval(emit, cfg, state, eval_step, val_loader, mesh=None):
    """The shared test-phase report: overall metrics + 10-metric uncertainty
    suite + missing-modality sweep.  Used by both
    the train&test loop and the standalone test CLI."""
    from edrl.train.metrics import compute_uncertainty_metrics
    from edrl.train.trainer import run_eval

    m, targets, probs = run_eval(state, eval_step, val_loader, mesh=mesh)
    emit(
        f"Test: Acc {m.accuracy:.4f} AUC {m.auc:.4f} F1 {m.f1:.4f} "
        f"Precision {m.precision:.4f} Recall {m.recall:.4f} "
        f"Specificity {m.specificity:.4f}"
    )
    suite = compute_uncertainty_metrics(targets, probs)
    emit(f"Uncertainty suite: {({k: round(v, 4) for k, v in suite.items()})}")
    for mask, label in (
        (np.array([True, False]), "fundus-only"),
        (np.array([False, True]), "oct-only"),
    ):
        mm, _, _ = run_eval(
            state, eval_step, val_loader, modality_mask=mask, mesh=mesh
        )
        emit(f"Missing-modality [{label}]: Acc {mm.accuracy:.4f} AUC {mm.auc:.4f}")


def main(argv=None):
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    emit = setup_cli_logging(cfg, args, "train")

    train_loader, val_loader = make_loaders(cfg)

    from edrl.train.checkpoint import CheckpointManager
    from edrl.train.trainer import fit, init_state, make_eval_step, make_model

    import os

    ckpt_dir = os.path.join(
        cfg.train.checkpoint_dir,
        f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}",
    )
    mgr = CheckpointManager(ckpt_dir)

    mesh = None
    import jax

    if len(jax.devices()) > 1:
        from edrl.parallel import make_mesh

        mesh = make_mesh(num_model=cfg.train.num_model_shards)

    if cfg.train.mode in ("train", "train&test"):
        state, initial_best, initial_best_epoch = None, 0.0, -1
        if cfg.train.resume:
            from edrl.train.trainer import resume_from_latest

            resumed = resume_from_latest(cfg, mgr, train_loader)
            if resumed is not None:
                state, cfg, initial_best, done = resumed
                binfo = mgr.best_info()
                if binfo is not None:
                    initial_best_epoch = int(binfo["epoch"])
                emit(
                    f"Resuming from latest (completed epoch {done}, "
                    f"best {initial_best:.4f})"
                )
        state, result = fit(
            cfg,
            train_loader,
            val_loader,
            state=state,
            mesh=mesh,
            checkpoint_manager=mgr,
            initial_best=initial_best,
            initial_best_epoch=initial_best_epoch,
        )
        emit(f"Best val accuracy {result.best_acc:.4f} at epoch {result.best_epoch}")
    if cfg.train.mode in ("test", "train&test"):
        _, state = init_state(cfg, cfg.train.seed)
        # ``--test_epoch`` parity (``fusion_train.py:517``): evaluate that
        # epoch's checkpoint when one was kept (--save_every), else best,
        # else the rolling latest (a preempted run may never have saved a
        # best) — and say so loudly if nothing restorable exists, instead
        # of silently reporting chance-level metrics from random init.
        epoch_name = f"epoch_{args.test_epoch}"
        if args.test_epoch and os.path.isdir(os.path.join(ckpt_dir, epoch_name)):
            state = mgr.restore(state, epoch_name)
            emit(f"Evaluating checkpoint {epoch_name}")
        elif mgr.best_info() is not None:
            if args.test_epoch:
                emit(
                    f"--test_epoch {args.test_epoch}: no {epoch_name} "
                    "checkpoint kept (see --save_every); evaluating best"
                )
            state = mgr.restore(state, "best")
        elif mgr.latest_info() is not None:
            emit("No 'best' checkpoint; evaluating the rolling 'latest'")
            state = mgr.restore(state, "latest")
        else:
            emit(
                f"WARNING: no checkpoint found under {ckpt_dir}; evaluating "
                "RANDOMLY INITIALIZED weights — metrics below are not a "
                "trained model's"
            )
        if mesh is not None and mesh.devices.size > 1:
            # Mesh placement: the restored state lives on device 0 while
            # run_eval shards batches over the mesh; mixing the two inside
            # one jitted call raises 'Received incompatible devices'.
            from edrl.parallel.mesh import train_state_shardings

            state = jax.device_put(state, train_state_shardings(state, mesh))
        # mesh= so the trace runs under the mesh context (batch_constraint
        # anchors only engage inside jax.set_mesh).
        eval_step = make_eval_step(make_model(cfg), cfg, mesh=mesh)
        report_eval(emit, cfg, state, eval_step, val_loader, mesh=mesh)


if __name__ == "__main__":
    main()
