"""Recompute the ABLATION_ANALYSIS.md headline claims from the raw records.

Each claim in the analysis write-up is a statement about specific cells of
the sigma x modality grid; this tool aggregates ABLATION.md.jsonl over all
recorded seeds (mean±std) and prints every claim with its supporting
numbers, flagging any claim the aggregate no longer supports.  Run it after
each seed pass so the prose in ABLATION_ANALYSIS.md never drifts from the
data (VERDICT r2 item 1: headline claims must survive an adversarial read).

    python scripts/ablation_claims.py [--jsonl ABLATION.md.jsonl]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np

FULL = "MedFusion (full EDRL)"
NOMMD = "MedFusion -MMD"
NOEPRL = "MedFusion -EPRL"
NODILR = "MedFusion -DILR"
LATE = "Multi_ResNet (late fusion)"


def load(path):
    """Current-protocol rows grouped by variant name, sweep keys as floats
    (shared filtering/seed-normalization: ``edrl.train.study_io``)."""
    from edrl.train.study_io import load_protocol_rows

    by = {}
    for r in load_protocol_rows(path, warn=True):
        r["sweep"] = {
            m: {float(s): v for s, v in cells.items()}
            for m, cells in r["sweep"].items()
        }
        by.setdefault(r["name"], []).append(r)
    return by


def agg(by, name, field):
    """field: callable(record) -> float; returns (mean, std, n)."""
    vals = np.asarray([field(r) for r in by[name]], dtype=float)
    return vals.mean(), (vals.std(ddof=1) if vals.size > 1 else 0.0), vals.size


def paired(by, name_a, name_b, field_a, field_b=None):
    """Per-seed paired comparison: how many seeds have a > b?

    Variants at the same seed share the shuffle/init/noise PRNG streams, so
    the per-seed sign is a matched comparison — much tighter than comparing
    means when run-to-run training variance is large.  Returns
    (wins, total, per_seed_deltas_str).
    """
    field_b = field_b or field_a
    if name_a not in by or name_b not in by:
        return 0, 0, "variant absent"  # partial/legacy jsonl
    a_by_seed = {r["seed"]: field_a(r) for r in by[name_a]}
    b_by_seed = {r["seed"]: field_b(r) for r in by[name_b]}
    seeds = sorted(set(a_by_seed) & set(b_by_seed))
    deltas = [(s, a_by_seed[s] - b_by_seed[s]) for s in seeds]
    wins = sum(1 for _, d in deltas if d > 0)
    detail = " ".join(f"s{s}:{d:+.3f}" for s, d in deltas)
    return wins, len(seeds), detail


def cell(m, s, metric):
    return lambda r: r["sweep"][m][s][metric]


def fmt(t):
    mean, std, n = t
    return f"{mean:.3f}±{std:.3f}(n={n})" if n > 1 else f"{mean:.3f}(n=1)"


def compute_claims(by) -> list:
    """The headline claims, each recomputed from the aggregate.

    Returns ``[(key, label, ok, detail), ...]``; claims whose variants are
    missing from ``by`` are skipped.  Shared by the printed claim-check block
    and the ``ok_<key>`` template placeholders so the analysis prose can
    never assert a direction the data no longer supports.
    """
    checks = []

    def claim(key, label, ok, detail):
        checks.append((key, label, ok, detail))

    # 1. MK-MMD = noise robustness: full EDRL both-modality accuracy holds
    #    sigma 0 -> 0.5 while -MMD collapses.
    if FULL in by and NOMMD in by:
        f0 = agg(by, FULL, cell("both", 0.0, "accuracy"))
        f5 = agg(by, FULL, cell("both", 0.5, "accuracy"))
        m0 = agg(by, NOMMD, cell("both", 0.0, "accuracy"))
        m5 = agg(by, NOMMD, cell("both", 0.5, "accuracy"))
        claim(
            "mmd_robustness",
            "MMD robustness: full acc holds under sigma, -MMD drops",
            (f5[0] >= f0[0] - 0.05) and (m5[0] < m0[0] - 0.10),
            f"full {fmt(f0)}->{fmt(f5)}  -MMD {fmt(m0)}->{fmt(m5)}",
        )

    # 2. EPRL = per-modality discriminability (single-modality AUC).
    #    Pairwise claims require the aggregate direction AND a paired-seed
    #    majority — a higher mean with split per-seed signs (the oct-only
    #    cell's history) is "within noise", not a supported claim.
    if FULL in by and NOEPRL in by:
        for mod, key in (("fundus-only", "eprl_fundus"), ("oct-only", "eprl_oct")):
            fa = agg(by, FULL, cell(mod, 0.0, "auc"))
            ea = agg(by, NOEPRL, cell(mod, 0.0, "auc"))
            wins, n, _ = paired(by, FULL, NOEPRL, cell(mod, 0.0, "auc"))
            claim(
                key,
                f"EPRL keeps {mod} AUC above -EPRL",
                fa[0] > ea[0] and wins * 2 > n,
                f"full {fmt(fa)} vs -EPRL {fmt(ea)}, {wins}/{n} paired wins",
            )

    # 3. DILR = the fundus pathway (fundus-only AUC drops without it).
    if FULL in by and NODILR in by:
        fa = agg(by, FULL, cell("fundus-only", 0.0, "auc"))
        da = agg(by, NODILR, cell("fundus-only", 0.0, "auc"))
        wins, n, _ = paired(by, FULL, NODILR, cell("fundus-only", 0.0, "auc"))
        claim(
            "dilr_fundus",
            "DILR keeps fundus-only AUC above -DILR",
            fa[0] > da[0] and wins * 2 > n,
            f"full {fmt(fa)} vs -DILR {fmt(da)}, {wins}/{n} paired wins",
        )

    # 4. Late fusion: fundus pathway at/below chance; both == oct-only.
    if LATE in by:
        lf = agg(by, LATE, cell("fundus-only", 0.0, "auc"))
        lb = agg(by, LATE, cell("both", 0.0, "auc"))
        lo = agg(by, LATE, cell("oct-only", 0.0, "auc"))
        claim(
            "late_fundus_chance",
            "late fusion fundus-only AUC ~ chance",
            lf[0] < 0.60,
            f"Multi_ResNet fundus-only {fmt(lf)}",
        )
        claim(
            "late_both_eq_oct",
            "late fusion both ~ oct-only (single-modality model in disguise)",
            abs(lb[0] - lo[0]) < 0.05,
            f"both {fmt(lb)} vs oct-only {fmt(lo)}",
        )

    # 5. Memorization: late fusion final train loss << full EDRL's.
    if LATE in by and FULL in by:
        lt = agg(by, LATE, lambda r: r["final_train_loss"])
        ft = agg(by, FULL, lambda r: r["final_train_loss"])
        claim(
            "late_memorizes",
            "late fusion memorizes (train loss << full EDRL)",
            lt[0] < ft[0] / 3,
            f"Multi_ResNet {fmt(lt)} vs full {fmt(ft)}",
        )
    return checks


def compute_aggregates(by) -> dict:
    """Named aggregate values for the ABLATION_ANALYSIS.md template.

    The narrative quotes specific cells; rendering them from the same
    aggregation as the claim checker keeps the prose from drifting as seeds
    accumulate (each value is a ``mean±std(n=..)`` string; ``wins_*`` are
    ``k/n`` paired per-seed direction counts)."""
    vals = {}
    seeds = sorted({r["seed"] for rs in by.values() for r in rs})
    vals["n_seeds"] = str(min(len(rs) for rs in by.values()))
    vals["seed_list"] = ", ".join(str(s) for s in seeds)
    short = {
        FULL: "full", NOMMD: "nommd", NOEPRL: "noeprl",
        NODILR: "nodilr", LATE: "late",
    }
    for name, key in short.items():
        if name not in by:
            continue
        vals[f"val_acc_{key}"] = fmt(agg(by, name, lambda r: r["best_val_acc"]))
        for mod, mkey in (
            ("both", "both"), ("fundus-only", "fundus"), ("oct-only", "oct")
        ):
            for sig, skey in ((0.0, "s0"), (0.5, "s5")):
                vals[f"{key}_{mkey}_acc_{skey}"] = fmt(
                    agg(by, name, cell(mod, sig, "accuracy"))
                )
                vals[f"{key}_{mkey}_auc_{skey}"] = fmt(
                    agg(by, name, cell(mod, sig, "auc"))
                )
        vals[f"{key}_train_loss"] = fmt(
            agg(by, name, lambda r: r["final_train_loss"])
        )
        # Signed mean per-seed sigma delta for the both-modality accuracy
        # sweep: lets the prose report the DIRECTION as data ("Δ +0.023")
        # instead of asserting "holds"/"drops" in static text that a new
        # seed could contradict.
        if all(
            0.5 in r["sweep"]["both"] and 0.0 in r["sweep"]["both"]
            for r in by[name]
        ):
            deltas = [
                r["sweep"]["both"][0.5]["accuracy"]
                - r["sweep"]["both"][0.0]["accuracy"]
                for r in by[name]
            ]
            vals[f"{key}_both_acc_dsig"] = f"{np.mean(deltas):+.3f}"
    # Fusion-protocol aggregates: per-seed clean-accuracy advantage
    # both(σ=0) − max(fundus-only, oct-only)(σ=0), and the best unimodal
    # cell itself (the honest reference for what "unimodal" achieves).
    for name, key in short.items():
        if name not in by:
            continue
        adv, uni = [], []
        for r in by[name]:
            b = r["sweep"]["both"][0.0]["accuracy"]
            u = max(
                r["sweep"]["fundus-only"][0.0]["accuracy"],
                r["sweep"]["oct-only"][0.0]["accuracy"],
            )
            adv.append(b - u)
            uni.append(u)
        vals[f"adv_{key}"] = fmt((np.mean(adv),
                                  np.std(adv, ddof=1) if len(adv) > 1 else 0.0,
                                  len(adv)))
        vals[f"uni_{key}"] = fmt((np.mean(uni),
                                  np.std(uni, ddof=1) if len(uni) > 1 else 0.0,
                                  len(uni)))
    paired_specs = {
        "wins_mmd_acc": (FULL, NOMMD, cell("both", 0.5, "accuracy")),
        "wins_eprl_fundus": (FULL, NOEPRL, cell("fundus-only", 0.0, "auc")),
        "wins_eprl_oct": (FULL, NOEPRL, cell("oct-only", 0.0, "auc")),
        "wins_dilr_fundus": (FULL, NODILR, cell("fundus-only", 0.0, "auc")),
        "wins_mmd_retention": (
            FULL, NOMMD,
            lambda r: r["sweep"]["both"][0.5]["auc"]
            - r["sweep"]["both"][0.0]["auc"],
        ),
    }
    for key, (a, b, f) in paired_specs.items():
        if a in by and b in by:
            wins, n, detail = paired(by, a, b, f)
            vals[key] = f"{wins}/{n}"
            vals[key + "_detail"] = detail
    # Live claim verdicts: the analysis prose embeds these instead of
    # asserting a direction statically (a new seed can flip a claim; the
    # prose must flip with it).
    for key, _label, ok, _detail in compute_claims(by):
        vals[f"ok_{key}"] = "holds" if ok else "NOT supported at current n"
    # The round-2 oct-only EPRL claim: provisionally withdrawn at n=2, so
    # the whole verdict sentence is recomputed from the live aggregate.
    if FULL in by and NOEPRL in by:
        wins, n, detail = paired(by, FULL, NOEPRL, cell("oct-only", 0.0, "auc"))
        fa = agg(by, FULL, cell("oct-only", 0.0, "auc"))
        ea = agg(by, NOEPRL, cell("oct-only", 0.0, "auc"))
        supported = fa[0] > ea[0] and wins * 2 > n
        if supported:
            vals["eprl_oct_verdict"] = (
                "**The oct-only EPRL effect currently holds** (full "
                f"{fmt(fa)} vs `-EPRL` {fmt(ea)}, {wins}/{n} paired wins; "
                f"per-seed deltas [{detail}]). It was provisionally "
                "withdrawn when an earlier seed pass put it within noise; "
                "this verdict sentence is recomputed from the live "
                "aggregate, so it reflects the current seed count."
            )
        else:
            vals["eprl_oct_verdict"] = (
                "**One round-2 claim did not survive seeds and is "
                "withdrawn.** The oct-only EPRL effect is within noise "
                f"(full {fmt(fa)} vs `-EPRL` {fmt(ea)}, {wins}/{n} paired "
                f"wins; per-seed deltas [{detail}]). The seed-0 table had "
                "shown a clean win; more seeds show it was luck. (This "
                "verdict sentence is recomputed from the live aggregate.)"
            )
    return vals


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--jsonl", default="ABLATION.md.jsonl")
    args = p.parse_args(argv)
    by = load(args.jsonl)
    print("records:", {k: len(v) for k, v in by.items()})
    checks = compute_claims(by)

    # The unfavorable cells, restated from the aggregate (no pass/fail —
    #    these exist so the write-up quotes them, not hides them).
    for name in (FULL, NOMMD, NOEPRL, NODILR, LATE):
        if name in by:
            va = agg(by, name, lambda r: r["best_val_acc"])
            print(f"val_acc {name:<28} {fmt(va)}")

    # Paired per-seed directions (matched PRNG streams per seed).
    print("\nPaired per-seed directions (wins/seeds, per-seed deltas):")
    pairs = [
        ("full sigma-0.5 both acc > -MMD", FULL, NOMMD,
         cell("both", 0.5, "accuracy")),
        ("full fundus-only AUC > -EPRL", FULL, NOEPRL,
         cell("fundus-only", 0.0, "auc")),
        ("full oct-only AUC > -EPRL", FULL, NOEPRL,
         cell("oct-only", 0.0, "auc")),
        ("full fundus-only AUC > -DILR", FULL, NODILR,
         cell("fundus-only", 0.0, "auc")),
        ("full both-AUC retention sigma 0->0.5 > -MMD", FULL, NOMMD,
         lambda r: r["sweep"]["both"][0.5]["auc"]
         - r["sweep"]["both"][0.0]["auc"]),
    ]
    for label, a, b, f in pairs:
        wins, n, detail = paired(by, a, b, f)
        print(f"  {wins}/{n}  {label}   [{detail}]")

    print()
    bad = 0
    for _key, label, ok, detail in checks:
        print(f"[{'OK ' if ok else 'FAIL'}] {label}\n       {detail}")
        bad += 0 if ok else 1
    print(f"\n{len(checks) - bad}/{len(checks)} claims supported by the aggregate")
    return 1 if bad else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
