"""Accuracy delta of W8A8 int8 serving vs the bf16 eval path.

Loads a checkpoint, runs the val split through ``serve.Predictor`` twice
(bf16 and int8), and prints both metric rows plus probability deltas — the
honest-measurement companion to ``scripts/bench_int8.py`` (which measures
throughput on random weights).

    python scripts/int8_accuracy.py --checkpoint /tmp/ckpt/synthetic_0.5_x/best \
        --dataset synthetic --synthetic_samples 64 --batch_size 8
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np



def main(argv=None):
    from edrl.cli.train import build_parser, config_from_args, make_loaders

    parser = build_parser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--min_dim", type=int, default=128)
    parser.add_argument(
        "--static_calibrate", type=int, default=0,
        help="also evaluate static-activation-scale int8 calibrated on the "
        "first N val pairs (0 = dynamic-only)",
    )
    parser.add_argument(
        "--calib_percentile", type=float, default=100.0,
        help="static calibrator percentile (100 = abs-max)",
    )
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    import os

    from edrl.serve import Predictor
    from edrl.train.metrics import compute_epoch_metrics
    from edrl.train.trainer import _dequantize

    directory, name = os.path.split(args.checkpoint.rstrip("/"))
    _, val_loader = make_loaders(cfg)

    # Collect the val set once (low-noise view, same as make_eval_step).
    import jax.numpy as jnp

    from edrl.data.device_noise import make_low_view_device

    @jax.jit
    def low_view(f, o):
        return make_low_view_device(
            _dequantize(f), _dequantize(o), cfg.data.noise, jax.random.key(123)
        )

    fundus_list, oct_list, labels = [], [], []
    for batch in val_loader.epoch(0):
        if "fundus" in batch:
            f, o = low_view(jnp.asarray(batch["fundus"]), jnp.asarray(batch["oct"]))
        else:
            f, o = batch["fundus_low"], batch["oct_low"]
        fundus_list.append(np.asarray(f))
        oct_list.append(np.asarray(o))
        labels.append(np.asarray(batch["label"]))
    fundus = np.concatenate(fundus_list)
    oct_vol = np.concatenate(oct_list)
    targets = np.concatenate(labels)

    modes = [
        ("bf16", {}),
        ("int8", {"quantize_int8": True, "min_dim": args.min_dim}),
    ]
    if args.static_calibrate > 0:
        n = min(args.static_calibrate, len(fundus))
        modes.append(
            (
                "int8_static",
                {
                    "quantize_int8": True,
                    "min_dim": args.min_dim,
                    "int8_calibration": (fundus[:n], oct_vol[:n]),
                    "int8_calib_percentile": args.calib_percentile,
                },
            )
        )

    rows = {}
    probs = {}
    for tag, kwargs in modes:
        p = Predictor.from_checkpoint(cfg, directory or ".", name=name or None, **kwargs)
        probs[tag] = p.predict_probs(fundus, oct_vol)
        m = compute_epoch_metrics(targets, probs[tag], 0.0)
        rows[tag] = {
            "acc": round(m.accuracy, 4),
            "auc": round(m.auc, 4),
            "f1": round(m.f1, 4),
        }
        if tag != "bf16":
            rows[tag]["dense_quantized"] = p.quant_report["dense_modules_quantized"]

    out = {"n": int(len(targets))}
    out.update(rows)
    for tag in rows:
        if tag == "bf16":
            continue
        delta = np.abs(probs["bf16"] - probs[tag])
        out[f"{tag}_top1_agreement"] = float(
            (probs["bf16"].argmax(-1) == probs[tag].argmax(-1)).mean()
        )
        out[f"{tag}_mean_abs_prob_delta"] = round(float(delta.mean()), 5)
        out[f"{tag}_max_abs_prob_delta"] = round(float(delta.max()), 5)
    print(json.dumps(out))


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    main()
