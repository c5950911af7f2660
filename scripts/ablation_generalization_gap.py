"""Seen-val vs held-out-val comparison: the memorization tell, quantified.

Round 3 found that every synthetic val split replayed the train per-index
entropy (``edrl/data/synthetic.py::_index_entropy``), so the archived
ablation table (``ABLATION_r3_seenval.jsonl``) was measured on SEEN data.
After the fix, the re-run (``ABLATION.md.jsonl``) evaluates on genuinely
held-out draws.  The per-variant drop between the two runs is itself
evidence: a model that memorized its 256 training samples loses far more
accuracy when the val set stops being a subset of train than one that
learned the protocol's class structure.

Matched comparison: both studies use the same training data, epochs, lr,
and seeds — only the val/sweep sampling changed — so per-(variant, seed)
deltas are paired.

Prints a markdown table (mean±std over the seeds both runs share) and one
summary line per variant.  Usage:

    python scripts/ablation_generalization_gap.py \
        [--seen ABLATION_r3_seenval.jsonl] [--heldout ABLATION.md.jsonl]
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


def _agg(vals):
    v = np.asarray(vals, dtype=float)
    if v.size == 0:
        return "—"
    if v.size == 1:
        return f"{v[0]:+.3f}"
    return f"{v.mean():+.3f}±{v.std(ddof=1):.3f}"


def _abs_agg(vals):
    v = np.asarray(vals, dtype=float)
    if v.size == 0:
        return "—"
    if v.size == 1:
        return f"{v[0]:.3f}"
    return f"{v.mean():.3f}±{v.std(ddof=1):.3f}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    p.add_argument("--seen", default=os.path.join(root, "ABLATION_r3_seenval.jsonl"))
    p.add_argument("--heldout", default=os.path.join(root, "ABLATION.md.jsonl"))
    args = p.parse_args(argv)
    seen, held = load(args.seen), load(args.heldout)
    names = []
    for name, _ in held:
        if name not in names:
            names.append(name)

    lines = [
        "## Generalization gap: seen-val vs held-out val "
        "(same training runs' protocol, paired seeds)",
        "",
        "| model | seen val acc | held-out val acc | drop "
        "| seen both-AUC σ=0 | held-out both-AUC σ=0 | drop |",
        "|---|---|---|---|---|---|---|",
    ]
    for name in names:
        seeds = sorted(
            s for (n, s) in held if n == name and (name, s) in seen
        )
        if not seeds:
            continue
        sv = [seen[(name, s)]["best_val_acc"] for s in seeds]
        hv = [held[(name, s)]["best_val_acc"] for s in seeds]
        sa = [seen[(name, s)]["sweep"]["both"]["0.0"]["auc"] for s in seeds]
        ha = [held[(name, s)]["sweep"]["both"]["0.0"]["auc"] for s in seeds]
        lines.append(
            f"| {name} | {_abs_agg(sv)} | {_abs_agg(hv)} | "
            f"{_agg([h - s for h, s in zip(hv, sv)])} | "
            f"{_abs_agg(sa)} | {_abs_agg(ha)} | "
            f"{_agg([h - s for h, s in zip(ha, sa)])} |"
        )
    lines.append("")
    lines.append(
        "Negative drops = the metric was inflated by evaluating on seen "
        "data; the size of the drop is the memorization tell (paired over "
        f"seeds shared by both runs)."
    )
    print("\n".join(lines))


if __name__ == "__main__":
    main()
