"""Preflight a real GAMMA / Harvard-style dataset tree.

Answers "will ``--dataset dr2`` (or glu2) work on this disk?" in seconds —
BEFORE paying the full-model compile — by validating the
label join, fundus path pattern, NIfTI headers (dims, datatype, scaling,
truncation), and OCT slice ordering, with actionable per-sample errors.

    python scripts/verify_dataset.py --dataset dr2 \
        --data_path /data/gamma --label_file /data/train_true.xlsx

    # decode every sample through the real loader too (slower):
    python scripts/verify_dataset.py ... --deep

Exit code 0 = READY, 1 = errors found.  Logic: ``edrl/data/verify.py``
(tested against deliberately-corrupted fixtures in
``tests/test_verify_dataset.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["dr2", "gamma", "glu2", "sub1"],
                   default="dr2")
    p.add_argument("--data_path", required=True)
    p.add_argument("--label_file", required=True)
    p.add_argument("--fundus_size", type=int, default=384)
    p.add_argument("--oct_size", type=int, default=96)
    p.add_argument(
        "--max_samples", type=int, default=None,
        help="check only the first N joined samples (default: all)",
    )
    p.add_argument(
        "--deep", action="store_true",
        help="additionally decode every checked sample through the real "
        "dataset class and validate tensor shapes/finiteness",
    )
    args = p.parse_args(argv)

    from edrl.config import DataConfig
    from edrl.data.verify import verify_tree

    cfg = DataConfig(
        dataset=args.dataset,
        data_path=args.data_path,
        label_file=args.label_file,
        fundus_size=args.fundus_size,
        oct_size=(args.oct_size,) * 3,
    )
    report = verify_tree(cfg, max_samples=args.max_samples, deep=args.deep)
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
