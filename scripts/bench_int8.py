"""Measure W8A8 int8 serving throughput vs the bf16 eval path.

Same scanned-on-device methodology as ``bench.py``'s ``bench_infer_step``
(one jitted ``lax.scan``, carry fed back into the input so XLA cannot hoist
the loop-invariant forward, ``float()`` sync for device-true timing).

Prints one JSON line:
    {"bf16_pairs_per_sec": ..., "int8_pairs_per_sec": ..., "speedup": ...,
     "max_abs_prob_delta": ..., "dense_modules_quantized": N}

Usage:  python scripts/bench_int8.py [--batch 16] [--steps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--min_dim", type=int, default=128)
    ap.add_argument(
        "--static", action="store_true",
        help="also measure static-activation-scale int8 (calibrated on a "
        "held-out batch) — removes the dynamic per-row abs-max reduce",
    )
    ap.add_argument(
        "--calib_percentile", type=float, default=100.0,
        help="activation-scale calibrator percentile (100 = abs-max; e.g. "
        "99.9 clips outliers, values beyond saturate)",
    )
    args = ap.parse_args()

    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.ops.quantization import int8_dense, quantize_for_serving
    from edrl.train.trainer import _normalize_output, init_state

    cfg = EDRLConfig(
        data=DataConfig(batch_size=args.batch, eval_batch_size=args.batch),
        model=ModelConfig(use_bfloat16=True),
        train=TrainConfig(),
    )
    model, state = init_state(cfg, 0)
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    d = cfg.data
    rng = np.random.default_rng(0)
    fundus = jnp.asarray(
        rng.uniform(size=(args.batch, d.fundus_size, d.fundus_size, 3)).astype(
            np.float32
        )
    )
    oct_vol = jnp.asarray(
        rng.uniform(size=(args.batch, *d.oct_size, 1)).astype(np.float32)
    )
    y = jnp.zeros((args.batch,), jnp.int32)

    example = (
        jnp.zeros((2, d.fundus_size, d.fundus_size, 3), jnp.float32),
        jnp.zeros((2, *d.oct_size, 1), jnp.float32),
        jnp.zeros((2,), jnp.int32),
    )
    qvariables, scales, report = quantize_for_serving(
        model, variables, *example, train=False, min_dim=args.min_dim
    )

    def probs_fn(v, s, f):
        def apply():
            out = model.apply(v, f, oct_vol, y, train=False)
            return _normalize_output(out)[0]

        if s:
            with int8_dense(s):
                logits = apply()
        else:
            logits = apply()
        return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

    def make_runner(v, s):
        @jax.jit
        def run(v, s, fundus):
            def body(acc, _):
                f = fundus + acc * jnp.float32(1e-24)
                p = probs_fn(v, s, f)
                return p.mean().astype(jnp.float32), None

            acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=args.steps)
            return acc

        return lambda: float(run(v, s, fundus))

    run_bf16 = make_runner(variables, {})
    run_int8 = make_runner(qvariables, scales)

    modes = [("bf16", variables, {}), ("int8", qvariables, scales)]
    if args.static:
        from edrl.ops.quantization import calibrate_activation_scales

        # Calibrate on a DIFFERENT rng draw than the eval batch so the
        # reported static numerics are out-of-sample (saturation on values
        # outside the calibrated range is actually exercised).
        crng = np.random.default_rng(1)
        calib_fundus = jnp.asarray(
            crng.uniform(size=fundus.shape).astype(np.float32)
        )
        calib_oct = jnp.asarray(crng.uniform(size=oct_vol.shape).astype(np.float32))
        static_scales = calibrate_activation_scales(
            model, variables, scales, calib_fundus, calib_oct, y,
            percentile=args.calib_percentile, train=False,
        )
        modes.append(("int8_static", qvariables, static_scales))

    # Numerics: one forward each, compare probabilities against bf16.
    p_by_mode = {
        name: np.asarray(
            jax.jit(lambda v, s, f: probs_fn(v, s, f))(v, s, fundus)
        )
        for name, v, s in modes
    }
    p_ref = p_by_mode["bf16"]

    results = {}
    for name, v, s in modes:
        runner = make_runner(v, s) if name == "int8_static" else (
            run_bf16 if name == "bf16" else run_int8
        )
        runner()  # warmup/compile
        t0 = time.perf_counter()
        runner()
        dt = time.perf_counter() - t0
        results[name] = args.batch * args.steps / dt

    out = {
        "bf16_pairs_per_sec": round(results["bf16"], 1),
        "int8_pairs_per_sec": round(results["int8"], 1),
        "speedup": round(results["int8"] / results["bf16"], 3),
        "max_abs_prob_delta": round(
            float(np.max(np.abs(p_ref - p_by_mode["int8"]))), 5
        ),
        "top1_agreement": float(
            (p_ref.argmax(-1) == p_by_mode["int8"].argmax(-1)).mean()
        ),
        "dense_modules_quantized": report["dense_modules_quantized"],
        "batch": args.batch,
    }
    if args.static:
        out.update(
            int8_static_pairs_per_sec=round(results["int8_static"], 1),
            static_speedup=round(results["int8_static"] / results["bf16"], 3),
            static_max_abs_prob_delta=round(
                float(np.max(np.abs(p_ref - p_by_mode["int8_static"]))), 5
            ),
            static_top1_agreement=float(
                (p_ref.argmax(-1) == p_by_mode["int8_static"].argmax(-1)).mean()
            ),
        )
    print(json.dumps(out))


if __name__ == "__main__":
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    main()
