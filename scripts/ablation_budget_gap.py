"""Training-budget effect: 25-epoch vs 75-epoch fusion-protocol runs, paired.

The 25-epoch fusion table (``ABLATION_FUSION.md.jsonl``) left every EDRL
variant with final train loss 1.4-2.0 — not converged — while the
late-fusion control sat at 0.074, so its accuracy columns measure a
fixed-budget snapshot, not architectural ceilings.  The long-budget study
(``ABLATION_FUSION_LONG.md.jsonl``) re-runs the same protocol instantiation,
lr, batch size, and seeds at 75 epochs; everything else is identical, so
per-(variant, seed) deltas are paired and the delta IS the budget effect.

Prints a markdown table: val accuracy, final train loss, clean both-modality
accuracy, and the clean-accuracy fusion advantage (both(σ=0) −
max(unimodal σ=0)) at each budget, with paired deltas.  Usage:

    python scripts/ablation_budget_gap.py \
        [--short ABLATION_FUSION.md.jsonl] [--long ABLATION_FUSION_LONG.md.jsonl]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np


def load(path):
    """Current-protocol rows keyed by (name, seed) — shared implementation
    in ``edrl.train.study_io``."""
    from edrl.train.study_io import load_by_name_seed

    return load_by_name_seed(path)


def _agg(vals, signed=True):
    v = np.asarray(vals, dtype=float)
    if v.size == 0:
        return "—"
    sign = "+" if signed else ""
    if v.size == 1:
        return f"{v[0]:{sign}.3f}"
    return f"{v.mean():{sign}.3f}±{v.std(ddof=1):.3f}"


def _advantage(r):
    s = r["sweep"]
    return s["both"]["0.0"]["accuracy"] - max(
        s["fundus-only"]["0.0"]["accuracy"], s["oct-only"]["0.0"]["accuracy"]
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    p.add_argument(
        "--short", default=os.path.join(root, "ABLATION_FUSION.md.jsonl")
    )
    p.add_argument(
        "--long", default=os.path.join(root, "ABLATION_FUSION_LONG.md.jsonl")
    )
    args = p.parse_args(argv)
    short, long_ = load(args.short), load(args.long)

    # The two studies must differ ONLY in epochs — otherwise the paired
    # delta confounds budget with whatever else changed.
    def proto(by):
        r = next(iter(by.values()), None)
        return dict(r["protocol"], epochs=None) if r else None

    ps, pl = proto(short), proto(long_)
    if ps is not None and pl is not None and ps != pl:
        diff = {k for k in ps if ps.get(k) != pl.get(k)}
        print(
            f"(budget comparison skipped: studies differ beyond epochs: "
            f"{sorted(diff)})"
        )
        return

    names = []
    for name, _ in long_:
        if name not in names:
            names.append(name)
    ep_s = next(iter(short.values()))["protocol"]["epochs"] if short else "?"
    ep_l = next(iter(long_.values()))["protocol"]["epochs"] if long_ else "?"

    lines = [
        f"## Budget effect: {ep_s} vs {ep_l} epochs "
        "(same protocol/lr/seeds, paired)",
        "",
        f"| model | val acc {ep_s}ep | val acc {ep_l}ep | Δ "
        f"| train loss {ep_s}ep | train loss {ep_l}ep "
        f"| both σ=0 acc {ep_s}ep | both σ=0 acc {ep_l}ep "
        f"| advantage {ep_s}ep | advantage {ep_l}ep |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name in names:
        seeds = sorted(
            s for (n, s) in long_ if n == name and (name, s) in short
        )
        if not seeds:
            continue
        sv = [short[(name, s)]["best_val_acc"] for s in seeds]
        lv = [long_[(name, s)]["best_val_acc"] for s in seeds]
        st = [short[(name, s)]["final_train_loss"] for s in seeds]
        lt = [long_[(name, s)]["final_train_loss"] for s in seeds]
        sb = [
            short[(name, s)]["sweep"]["both"]["0.0"]["accuracy"]
            for s in seeds
        ]
        lb = [
            long_[(name, s)]["sweep"]["both"]["0.0"]["accuracy"]
            for s in seeds
        ]
        sa = [_advantage(short[(name, s)]) for s in seeds]
        la = [_advantage(long_[(name, s)]) for s in seeds]
        lines.append(
            f"| {name} | {_agg(sv, signed=False)} | {_agg(lv, signed=False)} "
            f"| {_agg([b - a for a, b in zip(sv, lv)])} "
            f"| {_agg(st, signed=False)} | {_agg(lt, signed=False)} "
            f"| {_agg(sb, signed=False)} | {_agg(lb, signed=False)} "
            f"| {_agg(sa)} | {_agg(la)} |"
        )
    lines += [
        "",
        "A val-acc Δ that erases the late-fusion gap means the short-budget "
        "EDRL rows were under-trained artifacts; a flat Δ with train loss "
        "still high says 3× budget is not enough; a flat Δ with train loss "
        "converged says the gap is architectural. Advantage = both(σ=0) − "
        "max(unimodal σ=0) clean accuracy, per seed, paired.",
    ]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
