"""Hard-synthetic ablation study: what does each EDRL mechanism buy?

Trains on the HARD synthetic protocol (weak, modality-split, noise-buried
class signal — ``edrl/data/synthetic.py::HardSyntheticGammaDataset``)
where clean linear separation fails, then evaluates every model on the
sigma x modality robustness grid:

- MedFusion (full EDRL)
- MedFusion without MK-MMD self-distillation (``mmd_weight=0``)
- MedFusion without EPRL proxy losses (``proxy_weight_*=0``)
- MedFusion without DILR loss (``dilr_weight=0``)
- Multi_ResNet (plain late fusion, the reference's strongest simple baseline)

Writes a markdown results table to ABLATION.md and prints it.  This is the
evidence for the paper's robustness claim (reference README.md:2; noise grid
``fusion_train.py:548``) that the easy synthetic task cannot provide.

Run on the GPU (full-size backbones):

    python scripts/ablation_study.py --epochs 30 --train_samples 256
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax


from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
from edrl.data import SYNTHETIC_DATASETS, BatchLoader
from edrl.train.robustness import noise_sweep
from edrl.train.trainer import fit

# --protocol hard: weak modality-split noise-buried signal — evidence for
#   the ROBUSTNESS axes (clean accuracy rewards memorization there).
# --protocol fusion: complementary evidence (label = sign(u+v), u in the
#   fundus, v in the OCT) — the multimodal advantage is expressible in
#   CLEAN ACCURACY (unimodal Bayes ceiling ~0.75, fused ~1.0).
PROTOCOL_DATASETS = {"hard": "synthetic_hard", "fusion": "synthetic_fusion"}


def base_config(args) -> EDRLConfig:
    return EDRLConfig(
        data=DataConfig(
            dataset=PROTOCOL_DATASETS[args.protocol],
            batch_size=args.batch_size,
            eval_batch_size=args.batch_size,
            num_synthetic_samples=args.train_samples,
            device_noise=True,
            fundus_size=args.fundus_size,
            oct_size=(args.oct_size,) * 3,
        ),
        model=ModelConfig(use_bfloat16=True),
        train=TrainConfig(
            lr=args.lr,
            warmup_steps=args.warmup_steps,
            end_epochs=args.epochs,
            log_dir="",
            checkpoint_dir="",
            # One jitted lax.scan per 16-batch chunk (one dispatch per
            # chunk instead of per step).
            scan_batches=args.scan_batches,
        ),
    )


def variant(cfg: EDRLConfig, name: str) -> EDRLConfig:
    m, t = cfg.model, cfg.train
    if name == "MedFusion (full EDRL)":
        return cfg
    if name == "MedFusion -MMD":
        return cfg.replace(train=dataclasses.replace(t, mmd_weight=0.0))
    if name == "MedFusion -EPRL":
        return cfg.replace(
            model=dataclasses.replace(
                m, proxy_weight_train=0.0, proxy_weight_eval=0.0
            )
        )
    if name == "MedFusion -DILR":
        return cfg.replace(model=dataclasses.replace(m, dilr_weight=0.0))
    if name == "Multi_ResNet (late fusion)":
        return cfg.replace(model=dataclasses.replace(m, model_name="Multi_ResNet"))
    raise ValueError(name)


VARIANTS = (
    "MedFusion (full EDRL)",
    "MedFusion -MMD",
    "MedFusion -EPRL",
    "MedFusion -DILR",
    "Multi_ResNet (late fusion)",
)


def protocol_of(args) -> dict:
    """The sweep/training grid a cached row must match to be reusable.

    Resuming with a different grid previously replayed stale rows (KeyError
    in to_markdown or silently mixed grids); rows now carry their protocol
    and mismatches are invalidated on load.
    """
    out = {
        "protocol": args.protocol,
        # Round-3 fix: synthetic val splits are now held-out draws (they
        # used to replay train indices); rows measured on seen data must
        # not mix with held-out rows.
        "heldout_val": True,
        "sigmas": list(args.sigmas),
        "epochs": args.epochs,
        "train_samples": args.train_samples,
        "val_samples": args.val_samples,
        "batch_size": args.batch_size,
        "lr": args.lr,
        "fundus_size": args.fundus_size,
        "oct_size": args.oct_size,
    }
    # Optimizer-shape knobs enter the key only when active: protocol tags
    # are compared by dict EQUALITY, so an unconditional new key would
    # invalidate every pre-existing cached row of the default studies.
    if args.warmup_steps:
        out["warmup_steps"] = args.warmup_steps
    return out


def run_variant(name: str, seed: int, cfg: EDRLConfig, args):
    vcfg = variant(cfg, name)
    # Seed threads through everything stochastic in TRAINING: init/noise/
    # dropout PRNG (train.seed), per-sample host-noise keys (data.seed) and
    # the shuffle order.  The synthetic dataset itself is deterministic per
    # index (fixed protocol instantiation), so every variant and seed trains
    # on identical data — the spread measures run-to-run training variance.
    # All seeds are runtime inputs, so they reuse the compiled programs.
    vcfg = vcfg.replace(
        data=dataclasses.replace(vcfg.data, seed=11 + 101 * seed),
        train=dataclasses.replace(vcfg.train, seed=seed),
    )
    val_cfg = dataclasses.replace(
        vcfg.data, num_synthetic_samples=args.val_samples
    )
    ds_cls = SYNTHETIC_DATASETS[vcfg.data.dataset]
    train_ds = ds_cls(vcfg.data, mode="train")
    val_ds = ds_cls(val_cfg, mode="val")
    train_loader = BatchLoader(
        train_ds, vcfg.data.batch_size, shuffle=True, drop_last=True,
        seed=seed, uint8_transport=True,
    )
    val_loader = BatchLoader(
        val_ds, vcfg.data.eval_batch_size, shuffle=False, drop_last=False,
        uint8_transport=True,
    )
    t0 = time.time()
    state, result = fit(vcfg, train_loader, val_loader, verbose=args.verbose)
    train_time = time.time() - t0
    if args.state_dir:
        # Persist the swept state: sweeps can then be re-run post-hoc
        # (different sigmas, fixed bugs) without retraining the variant.
        from edrl.train.checkpoint import CheckpointManager

        slug = name.replace(" ", "_").replace("(", "").replace(")", "")
        mgr = CheckpointManager(os.path.join(args.state_dir, f"{slug}_s{seed}"))
        mgr.save(state, name="final")
        mgr.wait()  # commit before the manager goes out of scope
    sweep_cfg = vcfg.replace(data=val_cfg)
    sweep = noise_sweep(sweep_cfg, state, sigmas=args.sigmas)
    return {
        "name": name,
        "seed": seed,
        "protocol": protocol_of(args),
        "best_val_acc": result.best_acc,
        "final_train_loss": result.train_history[-1].loss,
        "train_time_s": round(train_time, 1),
        "sweep": sweep,
    }


def _agg(values):
    """mean±std string over seeds (std omitted for a single seed)."""
    import numpy as np

    v = np.asarray(values, dtype=float)
    if v.size <= 1:
        return f"{v.mean():.2f}"
    return f"{v.mean():.2f}±{v.std(ddof=1):.2f}"


PROTOCOL_BLURB = {
    "hard": (
        "Protocol: `HardSyntheticGammaDataset` (weak modality-split signal, "
        "signal-dropout 0.3, distractors; dual-view training with "
        "gaussian_high=0.5)."
    ),
    "fusion": (
        "Protocol: `ComplementarySyntheticGammaDataset` — label = "
        "sign(u+v) with u rendered only in the fundus and v only in the "
        "OCT, so a unimodal Bayes-optimal classifier caps at ~0.75 "
        "accuracy while fusing both modalities decodes u+v exactly "
        "(ceiling ~1.0).  The multimodal advantage is therefore "
        "expressible in CLEAN accuracy: advantage = both(σ=0) − "
        "max(unimodal σ=0)."
    ),
}


def to_markdown(rows, sigmas, variants=VARIANTS, protocol="hard",
                analysis_path=None, extra_md=None) -> str:
    import numpy as np

    by_name = {}
    for r in rows:
        by_name.setdefault(r["name"], []).append(r)
    # Render every variant present in the rows (canonical order first), not
    # just the ones selected for *running* this invocation: the per-process
    # driver passes a single --variants value, and rendering only that one
    # used to clobber ABLATION.md down to a one-row table.
    order = [n for n in VARIANTS if n in by_name]
    order += [n for n in variants if n in by_name and n not in order]
    order += [n for n in by_name if n not in order]
    variants = tuple(order)
    seeds_seen = sorted({r.get("seed", 0) for r in rows})
    title = {
        "hard": "# Hard-synthetic ablation study",
        "fusion": "# Complementary-evidence (fusion) ablation study",
    }[protocol]
    lines = [
        title,
        "",
        PROTOCOL_BLURB[protocol] + "  Cells are `accuracy/AUC` of the "
        "final-epoch state on the sigma-corrupted low view of a HELD-OUT "
        "val split (disjoint per-index draws from the same protocol), "
        f"mean±std over seeds {seeds_seen}.  Seeds vary the init PRNG, "
        "shuffle order and the device noise/augmentation draws; the "
        "dataset itself is a fixed instantiation of the protocol "
        "(deterministic per-index draw), so every variant and seed sees "
        "identical data."
        + (
            "  AUC is the headline: the hard protocol drives some "
            "variants to a degenerate argmax while their ranking stays "
            "informative."
            if protocol == "hard"
            else ""
        ),
        "",
    ]
    for metric in ("accuracy", "auc"):
        lines += [f"## {metric.upper()} per cell", ""]
        header = "| model | val acc |"
        sep = "|---|---|"
        for m in ("both", "fundus-only", "oct-only"):
            for s in sigmas:
                header += f" {m} σ={s} |"
                sep += "---|"
        lines += [header, sep]
        for name in variants:
            group = by_name.get(name)
            if not group:
                continue
            row = f"| {name} | {_agg([g['best_val_acc'] for g in group])} |"
            for m in ("both", "fundus-only", "oct-only"):
                for s in sigmas:
                    row += (
                        f" {_agg([g['sweep'][m][s][metric] for g in group])} |"
                    )
            lines.append(row)
        lines.append("")
    # Per-seed appendix: run-to-run training variance is large at this
    # step budget (~400 Adam steps/run), so the per-seed numbers matter as
    # much as the aggregate — scripts/ablation_claims.py computes paired
    # per-seed directions from the same records.
    lines += ["## Per-seed best val accuracy", ""]
    header = "| model |" + "".join(f" s{s} |" for s in seeds_seen)
    lines += [header, "|---|" + "---|" * len(seeds_seen)]
    for name in variants:
        group = by_name.get(name)
        if not group:
            continue
        acc_by_seed = {g.get("seed", 0): g["best_val_acc"] for g in group}
        row = f"| {name} |"
        for s in seeds_seen:
            row += (
                f" {acc_by_seed[s]:.3f} |" if s in acc_by_seed else " — |"
            )
        lines.append(row)
    lines.append("")
    if protocol == "fusion":
        # The headline table for this protocol: per-variant fusion
        # advantage = both(σ=0) − max(fundus-only, oct-only)(σ=0) clean
        # accuracy, computed per seed then aggregated (paired).
        s0 = min(sigmas)
        lines += [
            "## Fusion advantage (clean accuracy, σ=0 cells)",
            "",
            "| model | both | fundus-only | oct-only | advantage |",
            "|---|---|---|---|---|",
        ]
        for name in variants:
            group = by_name.get(name)
            if not group:
                continue
            both = [g["sweep"]["both"][s0]["accuracy"] for g in group]
            fo = [g["sweep"]["fundus-only"][s0]["accuracy"] for g in group]
            oo = [g["sweep"]["oct-only"][s0]["accuracy"] for g in group]
            adv = [b - max(f, o) for b, f, o in zip(both, fo, oo)]
            lines.append(
                f"| {name} | {_agg(both)} | {_agg(fo)} | {_agg(oo)} | "
                f"{_agg(adv)} |"
            )
        lines.append("")
    per_run = ", ".join(
        f"{r['name']}[s{r.get('seed', 0)}]={r['train_time_s']}" for r in rows
    )
    lines += [
        f"Generated by scripts/ablation_study.py; train_time_s: {per_run}",
        "",
    ]
    if protocol != "hard":
        # Hand-written commentary survives re-renders the same way the hard
        # protocol's analysis does: appended from a sibling file, with
        # {{placeholder}} aggregates rendered from the rows when available.
        # Analysis commentary is keyed to the OUTPUT file, not just the
        # protocol: a non-default output (e.g. the long-budget study,
        # ABLATION_FUSION_LONG.md) gets its own <stem>_ANALYSIS.md so its
        # table is not narrated by the default study's caveats.
        fusion_analysis = analysis_path or os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "..", "ABLATION_FUSION_ANALYSIS.md",
        )
        if protocol == "fusion" and os.path.exists(fusion_analysis):
            try:
                import re

                sys.path.insert(
                    0, os.path.dirname(os.path.abspath(__file__))
                )
                import ablation_claims

                tmp = "/tmp/_ablation_fusion_rows.jsonl"
                with open(tmp, "w") as f:
                    for r in rows:
                        f.write(json.dumps(r, default=float) + "\n")
                by = ablation_claims.load(tmp)
                vals = ablation_claims.compute_aggregates(by)
                with open(fusion_analysis) as f:
                    text = f.read()
                text = re.sub(
                    r"\{\{(\w+)\}\}",
                    # Aggregates missing from a partial study (variant not
                    # yet run) render as a visible pending marker, not a raw
                    # template token — mid-study snapshots stay presentable.
                    lambda m: str(
                        vals.get(m.group(1), f"*(pending: {m.group(1)})*")
                    ),
                    text,
                )
                lines += ["", text]
            except Exception as e:  # pragma: no cover - advisory only
                lines += [f"(fusion analysis unavailable: {e})", ""]
        if extra_md:
            lines += ["", extra_md, ""]
        return "\n".join(lines)
    # Live claim check: recompute the analysis claims from these rows so
    # the committed table always carries the paired-seed evidence in sync
    # with the data (scripts/ablation_claims.py).
    try:
        import contextlib
        import io

        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import ablation_claims

        buf = io.StringIO()
        tmp = "/tmp/_ablation_rows.jsonl"
        with open(tmp, "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=float) + "\n")
        with contextlib.redirect_stdout(buf):
            ablation_claims.main(["--jsonl", tmp])
        lines += ["## Claim check (auto-generated)", "", "```",
                  buf.getvalue().rstrip(), "```", ""]
    except Exception as e:  # pragma: no cover - advisory section only
        lines += [f"(claim check unavailable: {e})", ""]
    # Seen-val vs held-out comparison (the memorization tell): rendered only
    # when the archived pre-fix table is present to pair against.
    seen_jsonl = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "..", "ABLATION_r3_seenval.jsonl")
    if os.path.exists(seen_jsonl):
        try:
            import contextlib
            import io

            import ablation_generalization_gap as gap

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                gap.main(["--seen", seen_jsonl, "--heldout", tmp])
            lines += [buf.getvalue().rstrip(), ""]
        except Exception as e:  # pragma: no cover - advisory section only
            lines += [f"(generalization-gap section unavailable: {e})", ""]
    analysis = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "ABLATION_ANALYSIS.md")
    if os.path.exists(analysis):
        with open(analysis) as f:
            text = f.read()
        # The narrative quotes aggregate numbers via {{name}} placeholders,
        # rendered from the same aggregation as the claim checker so the
        # prose can never drift from the data as seeds accumulate.
        try:
            import re

            by = ablation_claims.load(tmp)
            vals = ablation_claims.compute_aggregates(by)
            text = re.sub(
                r"\{\{(\w+)\}\}",
                # Missing aggregates (variant not yet run in a partial
                # study) render as a visible pending marker.
                lambda m: str(
                    vals.get(m.group(1), f"*(pending: {m.group(1)})*")
                ),
                text,
            )
        except Exception:  # pragma: no cover - template stays literal
            pass
        lines += ["", text]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--train_samples", type=int, default=256)
    p.add_argument("--val_samples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument(
        "--warmup_steps", type=int, default=0,
        help="linear LR warmup steps (0 = constant lr; nonzero enters the "
        "protocol key, so warmup rows never mix with the default tables — "
        "point --output at a separate file)",
    )
    p.add_argument("--fundus_size", type=int, default=384)
    p.add_argument("--oct_size", type=int, default=96)
    p.add_argument("--sigmas", type=float, nargs="+", default=[0.0, 0.25, 0.5])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--scan_batches", type=int, default=16)
    p.add_argument("--state_dir", default="/tmp/ablation_states")
    p.add_argument("--variants", nargs="+", default=None)
    p.add_argument(
        "--protocol", choices=sorted(PROTOCOL_DATASETS), default="hard"
    )
    p.add_argument("--output", default=None)
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if args.output is None:
        args.output = (
            "ABLATION.md" if args.protocol == "hard" else "ABLATION_FUSION.md"
        )
    args.sigmas = tuple(args.sigmas)
    # Commentary appendix lives next to the output (ABLATION_FUSION.md ->
    # ABLATION_FUSION_ANALYSIS.md, ABLATION_FUSION_LONG.md -> ..._LONG_
    # ANALYSIS.md).  to_markdown skips the appendix if the file is absent —
    # a custom output never inherits the default study's narrative.
    analysis = os.path.splitext(args.output)[0] + "_ANALYSIS.md"

    def budget_section():
        """25-vs-75-epoch paired comparison, appended to the LONG table's
        render once both studies have rows (scripts/ablation_budget_gap.py).
        Recomputed at every re-render so the section tracks the jsonl."""
        if not os.path.splitext(args.output)[0].endswith("_LONG"):
            return None
        short_jsonl = args.output.replace("_LONG", "") + ".jsonl"
        if not (os.path.exists(short_jsonl)
                and os.path.exists(args.output + ".jsonl")):
            return None
        try:
            import contextlib
            import io

            sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
            import ablation_budget_gap

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ablation_budget_gap.main(
                    ["--short", short_jsonl, "--long", args.output + ".jsonl"]
                )
            return buf.getvalue().rstrip()
        except Exception as e:  # pragma: no cover - advisory section only
            return f"(budget comparison unavailable: {e})"

    proto = protocol_of(args)

    cfg = base_config(args)
    # Incremental persistence: each (variant, seed) full record (sweep
    # included) lands in a .jsonl next to the output as soon as it finishes,
    # and already-recorded runs are skipped on re-run — a multi-hour study
    # survives timeouts/restarts without retraining finished runs.  Rows
    # whose recorded protocol (sigma grid / sample counts / lr) mismatches
    # the current invocation are invalidated, not silently mixed in.
    jsonl = args.output + ".jsonl"
    rows = []
    done = set()
    stale_lines = []
    if os.path.exists(jsonl):
        keep_lines = []
        with open(jsonl) as f:
            for line in f:
                r = json.loads(line)
                if r.get("protocol") != proto:
                    print(
                        f"(stale row archived: {r['name']} seed="
                        f"{r.get('seed')} — protocol mismatch)", flush=True,
                    )
                    stale_lines.append(line)
                    continue
                keep_lines.append(line)
                # JSON stringifies the float sigma keys; restore them.
                r["sweep"] = {
                    m: {float(s): v for s, v in cells.items()}
                    for m, cells in r["sweep"].items()
                }
                rows.append(r)
                done.add((r["name"], r["seed"]))
        if stale_lines:
            # Compact the live file so the standalone tools (ablation_claims
            # / ablation_generalization_gap) never see mixed grids; the
            # stale rows are preserved in a sidecar, not destroyed.
            with open(jsonl + ".stale", "a") as f:
                f.writelines(stale_lines)
            with open(jsonl, "w") as f:
                f.writelines(keep_lines)
    variants = tuple(args.variants or VARIANTS)
    # Seed-major order: the first pass yields a complete single-seed table
    # for every variant (and pays all the compiles); later passes add spread.
    for seed in args.seeds:
        for name in variants:
            if (name, seed) in done:
                print(f"=== {name} s{seed} === (cached)", flush=True)
                continue
            print(f"=== {name} s{seed} ===", flush=True)
            r = run_variant(name, seed, cfg, args)
            # Host RSS grows ~30 GB per full-size run (retained traced/
            # compiled artifacts); a 5-variant x 3-seed
            # study OOM-killed a 128 GB host mid-study.  Drop every cache
            # between runs — and prefer one (variant, seed) per process via
            # --variants/--seeds when driving long studies (the .jsonl resume
            # makes per-run subprocesses free).
            jax.clear_caches()
            import gc

            gc.collect()
            rows.append(r)
            with open(jsonl, "a") as f:
                f.write(json.dumps(r, default=float) + "\n")
            print(
                json.dumps(
                    {k: v for k, v in r.items()
                     if k not in ("sweep", "protocol")},
                    default=float,
                ),
                flush=True,
            )
            # Re-render after every run so a killed study still leaves the
            # freshest table on disk.
            with open(args.output, "w") as f:
                f.write(to_markdown(rows, args.sigmas, variants,
                                    args.protocol, analysis,
                                    budget_section()))

    md = to_markdown(rows, args.sigmas, variants, args.protocol, analysis,
                     budget_section())
    with open(args.output, "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
