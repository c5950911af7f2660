"""Prebuild the uint8 decode+resize cache for a GAMMA/Harvard tree.

Host-only (no device, no JAX): walks every labeled sample through
``GammaDataset._load_raw`` once so the per-sample ``_edrl_cache8_*.npz``
files exist before training starts — the first training epoch then reads
~1 ms uint8 caches instead of paying PNG+NIfTI decode + resize per sample
(data/gamma.py:123-170).  Safe to re-run: cached samples are skipped by
construction.  Part of the day-one runbook (``scripts/run_harvard.sh``).

    python scripts/build_cache.py --data_path /data/gamma \
        --label_file /data/train_true.xlsx
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Worker-process state for --workers > 1: multiprocessing cannot pickle a
# closure over the dataset, so each worker re-opens it once via an
# initializer and _build_one is a plain module-level function.
_WORKER_DS = None


def _worker_init(cfg):
    global _WORKER_DS
    from edrl.data.gamma import GammaDataset

    _WORKER_DS = GammaDataset(cfg, mode="train")


def _build_one(i):
    sid, _ = _WORKER_DS.samples[i]
    _WORKER_DS._load_raw(sid)
    return sid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_path", required=True)
    p.add_argument("--label_file", required=True)
    p.add_argument("--fundus_size", type=int, default=384,
                   help="must match the training config (cache is shape-keyed)")
    p.add_argument("--oct_size", type=int, default=96)
    p.add_argument("--workers", type=int, default=0,
                   help="decode processes (0 = in-process; the bench host "
                   "has one core, real hosts want #cores)")
    args = p.parse_args(argv)

    from edrl.config import DataConfig
    from edrl.data.gamma import GammaDataset

    cfg = DataConfig(
        dataset="dr2",
        data_path=args.data_path,
        label_file=args.label_file,
        fundus_size=args.fundus_size,
        oct_size=(args.oct_size,) * 3,
        device_noise=True,
        uint8_transport=True,
    )
    ds = GammaDataset(cfg, mode="train")
    n = len(ds)
    if n == 0:
        print("no labeled samples found — run scripts/verify_dataset.py first")
        return 1
    t0 = time.time()

    if args.workers > 1:
        from multiprocessing import Pool

        with Pool(args.workers, initializer=_worker_init, initargs=(cfg,)) as pool:
            for k, sid in enumerate(
                pool.imap_unordered(_build_one, range(n)), 1
            ):
                if k % 50 == 0 or k == n:
                    print(f"[{k}/{n}] cached (last: {sid})", flush=True)
    else:
        _worker_init(cfg)
        for i in range(n):
            sid = _build_one(i)
            if (i + 1) % 50 == 0 or i + 1 == n:
                print(f"[{i + 1}/{n}] cached (last: {sid})", flush=True)
    dt = time.time() - t0
    print(
        f"cache build complete: {n} samples in {dt:.1f}s "
        f"({n / max(dt, 1e-9):.1f} samples/s), "
        f"fundus {args.fundus_size}^2 / oct {args.oct_size}^3 uint8"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
