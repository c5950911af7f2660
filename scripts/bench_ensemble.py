"""Measure one-program ensemble inference vs the per-member-sync loop.

The old ``ensemble_predict`` did K blocking ``np.asarray`` round-trips per
batch (one per member), serializing uploads behind compute; the current one
stacks member params and runs ONE vmapped jitted forward per
batch with every host sync deferred to after the loop (reference loop shape:
``fusion_train.py:441-445``).

Both paths are compiled/warmed before timing, so the delta is dispatch +
sync behavior, not compile time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def naive_predict(cfg, states, loader, model):
    """Round-2 behavior: per-member apply + blocking host sync per batch."""
    from edrl.train.trainer import _normalize_output

    probs, targets = [], []
    for batch in loader.epoch(0):
        logits = np.mean(
            [
                np.asarray(  # <- blocking round-trip per member per batch
                    _normalize_output(
                        model.apply(
                            {"params": s.params, "batch_stats": s.batch_stats},
                            batch["fundus_low"], batch["oct_low"],
                            batch["label"], train=False,
                        )
                    )[0]
                )
                for s in states
            ],
            axis=0,
        )
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs.append(e / e.sum(axis=1, keepdims=True))
        targets.append(np.asarray(batch["label"]))
    return np.concatenate(probs), np.concatenate(targets)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--members", type=int, default=5)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--model_name", default="Multi_DE1_ResNet")
    p.add_argument("--fundus_size", type=int, default=384)
    p.add_argument("--oct_size", type=int, default=96)
    args = p.parse_args(argv)

    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.data import BatchLoader, SyntheticGammaDataset
    from edrl.train.ensemble import ensemble_predict
    from edrl.train.trainer import init_state, make_model

    cfg = EDRLConfig(
        data=DataConfig(
            batch_size=args.batch_size,
            eval_batch_size=args.batch_size,
            num_synthetic_samples=args.samples,
            fundus_size=args.fundus_size,
            oct_size=(args.oct_size,) * 3,
        ),
        model=ModelConfig(use_bfloat16=True, model_name=args.model_name),
        train=TrainConfig(),
    )
    states = [init_state(cfg, seed)[1] for seed in range(args.members)]
    model = make_model(cfg)
    loader = BatchLoader(
        SyntheticGammaDataset(cfg.data, mode="val"), args.batch_size,
        shuffle=False, drop_last=False,
    )

    # Warm both paths (compile + transport).
    pred = ensemble_predict(cfg, states, loader, model=model)
    naive_predict(cfg, states, loader, model)

    t0 = time.perf_counter()
    pred = ensemble_predict(cfg, states, loader, model=model)
    one_program_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    naive_probs, _ = naive_predict(cfg, states, loader, model)
    naive_s = time.perf_counter() - t0

    np.testing.assert_allclose(pred["probs"], naive_probs, atol=2e-2)
    n = len(pred["targets"])
    print(
        json.dumps(
            {
                "metric": "deep-ensemble eval (K members, per-batch dispatch)",
                "members": args.members,
                "samples": n,
                "one_program_s": round(one_program_s, 3),
                "per_member_sync_s": round(naive_s, 3),
                "one_program_pairs_per_s": round(n / one_program_s, 2),
                "per_member_sync_pairs_per_s": round(n / naive_s, 2),
                "speedup": round(naive_s / one_program_s, 2),
            }
        )
    )


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    main()
