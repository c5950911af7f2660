"""Serving CLI: batched prediction from a checkpoint.

The production-shaped counterpart of ``edrl.cli.test`` (which mirrors
the reference's ``fusion_test.py`` eval loop): no labels or metrics, just
probabilities for a stack of fundus+OCT pairs, with the serving disciplines
from ``edrl.serve.Predictor`` — fixed-shape jitted forward, optional
chunked dispatch, one host sync per request, and optional W8A8 int8 Dense
quantization.

    # npz with arrays 'fundus' [N,H,W,3] and 'oct' [N,D,H,W,1] (f32 or uint8)
    python -m edrl.cli.predict --checkpoint ckpt/synthetic_.../best \
        --input pairs.npz --output probs.csv --int8 --chunk_batches 4

    # no --input: N synthetic pairs (shape/throughput smoke run)
    python -m edrl.cli.predict --checkpoint ckpt/.../best --num 32
"""

from __future__ import annotations

import time

import numpy as np

from edrl.cli.train import build_parser, config_from_args


def main(argv=None):
    from edrl.device import enable_compile_cache

    enable_compile_cache()
    parser = build_parser()
    parser.add_argument("--checkpoint", default="", help="checkpoint dir/name")
    parser.add_argument("--input", default="", help=".npz with fundus/oct arrays")
    parser.add_argument("--output", default="", help="write probs as CSV here")
    parser.add_argument("--num", type=int, default=16, help="synthetic pairs if no --input")
    parser.add_argument("--int8", action="store_true", help="W8A8 int8 Dense matmuls")
    parser.add_argument(
        "--int8_calibrate", type=int, default=0,
        help="with --int8: calibrate static per-tensor activation scales on "
        "the first N input pairs (0 = dynamic per-row scales)",
    )
    parser.add_argument("--chunk_batches", type=int, default=1)
    parser.add_argument(
        "--transport", choices=("uint8", "f32"), default="uint8",
        help="host->device request encoding; uint8 (default) ships 4x fewer "
        "bytes and dequantizes on device; f32 for sub-8-bit sources",
    )
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    d = cfg.data
    if args.input:
        data = np.load(args.input)
        fundus, oct_vol = data["fundus"], data["oct"]
    else:
        rng = np.random.default_rng(cfg.train.seed)
        fundus = (rng.uniform(size=(args.num, d.fundus_size, d.fundus_size, 3)) * 255).astype(np.uint8)
        oct_vol = (rng.uniform(size=(args.num, *d.oct_size, 1)) * 255).astype(np.uint8)

    if args.int8_calibrate > 0 and not args.int8:
        # Mirror the programmatic API: Predictor raises ValueError for this
        # combination; silently ignoring it here hid a likely user mistake.
        parser.error("--int8_calibrate requires --int8")
    calibration = None
    if args.int8 and args.int8_calibrate > 0:
        n = min(args.int8_calibrate, len(fundus))
        calibration = (fundus[:n], oct_vol[:n])

    from edrl.serve import Predictor

    if args.checkpoint:
        import os

        directory, name = os.path.split(args.checkpoint.rstrip("/"))
        predictor = Predictor.from_checkpoint(
            cfg,
            directory or ".",
            name=name or None,
            quantize_int8=args.int8,
            int8_calibration=calibration,
            chunk_batches=args.chunk_batches,
            transport=args.transport,
        )
    else:
        from edrl.train.trainer import init_state

        print("no --checkpoint: serving randomly initialized weights (smoke run)")
        _, state = init_state(cfg, cfg.train.seed)
        predictor = Predictor(
            cfg,
            state,
            quantize_int8=args.int8,
            int8_calibration=calibration,
            chunk_batches=args.chunk_batches,
            transport=args.transport,
        )
    if args.int8:
        r = predictor.quant_report
        print(
            f"int8: {r['dense_modules_quantized']}/{r['dense_modules_seen']} Dense "
            f"modules quantized, param bytes {r['param_bytes_before']:,} -> "
            f"{r['param_bytes_after']:,}"
            + (
                f"; {r['static_activation_scales']} static activation scales"
                if calibration is not None
                else ""
            )
        )

    t0 = time.perf_counter()
    probs = predictor.predict_probs(fundus, oct_vol)
    dt = time.perf_counter() - t0
    print(
        f"{len(probs)} pairs in {dt:.2f}s ({len(probs) / dt:.1f} pairs/s incl. "
        f"compile on first call); mean max-prob {probs.max(-1).mean():.4f}"
    )
    if args.output:
        np.savetxt(args.output, probs, delimiter=",", fmt="%.6f")
        print(f"wrote {args.output}")
    else:
        for i, p in enumerate(probs[:8]):
            print(f"pair {i}: {np.array2string(p, precision=4)}")


if __name__ == "__main__":
    main()
