"""Serving latency bench: per-request p50/p95 through ``serve.Predictor``.

Throughput (pairs/s, ``bench.py``) answers "how fast can we drain a queue";
this answers the production question the reference instruments but never
reports (per-sample wall time prints, ``fusion_train.py:469-470``): what a
single online request costs end-to-end — host->device transfer, forward,
device->host probs — at small request sizes.

Each timed request is a full ``predict_probs`` call (host sync included),
so the number includes the host<->device transfers an online deployment
pays.

Prints one JSON line:
    {"batch_sizes": [...], "p50_ms": {...}, "p95_ms": {...},
     "pairs_per_sec_at_b": {...}, "requests": N}

Usage:  python scripts/bench_latency.py [--batches 1 4 16] [--requests 30]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument(
        "--static", action="store_true",
        help="with --int8: static activation scales (calibrated on a "
        "held-out random batch) instead of dynamic per-row quantize",
    )
    ap.add_argument(
        "--uint8", action="store_true",
        help="ship uint8 inputs (Predictor dequantizes on device) — 4x "
        "less host->device transport",
    )
    ap.add_argument("--tiny", action="store_true", help="tiny model (smoke)")
    args = ap.parse_args()

    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.serve.predictor import Predictor
    from edrl.train.trainer import init_state

    rng = np.random.default_rng(0)
    p50, p95, throughput = {}, {}, {}
    for b in args.batches:
        if args.tiny:
            from edrl.config import tiny_test_config

            cfg = tiny_test_config(batch_size=b)
        else:
            cfg = EDRLConfig(
                data=DataConfig(batch_size=b, eval_batch_size=b),
                model=ModelConfig(use_bfloat16=True),
                train=TrainConfig(),
            )
        _, state = init_state(cfg, 0)
        d = cfg.data
        kwargs = {}
        if args.int8 and args.static:
            crng = np.random.default_rng(1)  # held-out calibration draw
            kwargs["int8_calibration"] = (
                crng.uniform(size=(b, d.fundus_size, d.fundus_size, 3)).astype(
                    np.float32
                ),
                crng.uniform(size=(b, *d.oct_size, 1)).astype(np.float32),
            )
        # transport is explicit so the f32 rows keep measuring f32 transport
        # now that the Predictor DEFAULTS to uint8; --uint8 rows exercise the
        # shipped default.
        pred = Predictor(
            cfg, state, quantize_int8=args.int8,
            transport="uint8" if args.uint8 else "f32", **kwargs
        )
        fundus = rng.uniform(size=(b, d.fundus_size, d.fundus_size, 3)).astype(
            np.float32
        )
        oct_vol = rng.uniform(size=(b, *d.oct_size, 1)).astype(np.float32)
        if args.uint8:
            fundus = (fundus * 255).astype(np.uint8)
            oct_vol = (oct_vol * 255).astype(np.uint8)
        pred.predict_probs(fundus, oct_vol)  # compile + warm
        times = []
        for _ in range(args.requests):
            t0 = time.perf_counter()
            pred.predict_probs(fundus, oct_vol)
            times.append((time.perf_counter() - t0) * 1e3)
        times = np.asarray(times)
        key = str(b)
        p50[key] = round(float(np.percentile(times, 50)), 1)
        p95[key] = round(float(np.percentile(times, 95)), 1)
        throughput[key] = round(b / (np.percentile(times, 50) / 1e3), 1)

    print(
        json.dumps(
            {
                "batch_sizes": args.batches,
                "p50_ms": p50,
                "p95_ms": p95,
                "pairs_per_sec_at_p50": throughput,
                "requests": args.requests,
                "int8": bool(args.int8),
                "static": bool(args.int8 and args.static),
                "uint8_transport": bool(args.uint8),
            }
        )
    )


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    main()
