"""Bench any registry model's dual-view train step (pairs/sec/card).

Baseline-vs-EDRL perf comparisons are only meaningful when the baselines run
the same backbone layout as the flagship; the registry threads the flagship
layout into the transformer baselines, and this probe measures any of them
under the flagship's bench harness:

    python scripts/bench_model.py Trans_cross
    python scripts/bench_model.py Multi_ResNet --batch_size 32
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench import bench_infer_step, bench_train_step  # noqa: E402  (sets compile-cache dirs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument(
        "--infer", action="store_true",
        help="also bench the low-view eval forward (pairs/sec/chip)",
    )
    args = p.parse_args(argv)
    t0 = time.time()
    pairs = bench_train_step(
        batch_size=args.batch_size, steps=args.steps, model_name=args.model_name
    )
    result = {
        "model_name": args.model_name,
        "batch_size": args.batch_size,
        "train_pairs_per_sec": round(pairs, 2),
    }
    if args.infer:
        result["infer_pairs_per_sec"] = round(
            bench_infer_step(
                batch_size=args.batch_size, steps=args.steps,
                model_name=args.model_name,
            ),
            2,
        )
    result["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    main()
