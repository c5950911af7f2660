"""Benchmark: EDRL training throughput (fundus+OCT pairs/sec/card).

Runs the flagship MedFusion self-distillation train step (dual full-size
forward: Swin-B @ 384^2 + 3-D ViT @ 96^3, MK-MMD, backward, Adam) on the
GPU and prints ONE JSON line naming the device it ran on:

    {"metric": "...", "value": N, "unit": "pairs/sec/card", ...,
     "device": {"platform": "gpu", "kind": "...", "count": 1,
                "nvidia_smi_name_power_limit": "..."}}

A run that finds no GPU fails.  ``mfu_pct`` divides the model FLOPs (XLA
cost analysis of the step without remat) by the card's published bf16 peak
from ``PEAK_BF16_FLOPS``.
"""

from __future__ import annotations

import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from edrl.device import card_info, enable_compile_cache, require_gpu

# Dense bf16 tensor-core peak by ``device_kind``.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part, without sparsity (at the 700 W
# power limit; a card set lower cannot hold it).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_bf16_flops(device_kind: str) -> float:
    """The published bf16 peak of ``device_kind``; unknown kinds raise."""
    try:
        return PEAK_BF16_FLOPS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device kind {device_kind!r}; add it to "
            "PEAK_BF16_FLOPS with its source"
        ) from None


def count_train_step_flops(batch_size: int) -> float:
    """Model FLOPs for ONE optimizer step, via XLA cost analysis.

    Counted on the step without attention remat (recomputed operations do
    not count).  Everything is abstract: the state comes from
    ``jax.eval_shape`` over ``init_state`` and the step is only lowered —
    no device compute, no compile.
    """
    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.train.trainer import (
        init_state,
        make_model,
        make_optimizer,
        make_train_step,
    )

    cfg = EDRLConfig(
        data=DataConfig(batch_size=batch_size),
        model=ModelConfig(use_bfloat16=True, remat=False, remat_attention=False),
        train=TrainConfig(),
    )
    state = jax.eval_shape(lambda: init_state(cfg, 0)[1])
    train_step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg, jit=False)
    d = cfg.data
    fundus = jax.ShapeDtypeStruct((batch_size, d.fundus_size, d.fundus_size, 3), jnp.float32)
    oct_vol = jax.ShapeDtypeStruct((batch_size, *d.oct_size, 1), jnp.float32)
    batch = {
        "fundus_low": fundus,
        "fundus_high": fundus,
        "oct_low": oct_vol,
        "oct_high": oct_vol,
        "label": jax.ShapeDtypeStruct((batch_size,), jnp.int32),
    }

    def one_step(state, batch, key):
        new_state, out = train_step(state, batch, key)
        return new_state, out["loss"]

    cost = jax.jit(one_step).lower(state, batch, jax.random.key(0)).cost_analysis()
    if isinstance(cost, (list, tuple)):  # older jax returns [dict]
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    if flops <= 0.0:
        raise RuntimeError(f"XLA cost analysis gave no FLOP count: {cost}")
    return flops


def make_batch(batch_size: int, data_cfg, rng):
    return {
        "fundus_low": jnp.asarray(
            rng.uniform(size=(batch_size, data_cfg.fundus_size, data_cfg.fundus_size, 3)).astype(np.float32)
        ),
        "fundus_high": jnp.asarray(
            rng.uniform(size=(batch_size, data_cfg.fundus_size, data_cfg.fundus_size, 3)).astype(np.float32)
        ),
        "oct_low": jnp.asarray(
            rng.uniform(size=(batch_size, *data_cfg.oct_size, 1)).astype(np.float32)
        ),
        "oct_high": jnp.asarray(
            rng.uniform(size=(batch_size, *data_cfg.oct_size, 1)).astype(np.float32)
        ),
        "label": jnp.asarray(rng.integers(0, 2, size=batch_size).astype(np.int32)),
    }


def bench_train_step(
    batch_size: int = 16, steps: int = 20, remat: bool = False, **model_kwargs
):
    """Device throughput of the dual-view train step.

    The ``steps`` optimizer steps run inside ONE jitted ``lax.scan`` program —
    exactly how a production loop with an on-device data queue behaves — so
    the number reflects device time, not host dispatch overhead.
    ``float()`` on the result waits for the device.
    """
    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.train.trainer import (
        init_state,
        make_model,
        make_optimizer,
        make_train_step,
    )

    cfg = EDRLConfig(
        data=DataConfig(batch_size=batch_size),
        model=ModelConfig(use_bfloat16=True, remat=remat, **model_kwargs),
        train=TrainConfig(),
    )
    _, state = init_state(cfg, 0)
    train_step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg, jit=False)
    batch = make_batch(batch_size, cfg.data, np.random.default_rng(0))
    key = jax.random.key(0)

    # Donating the state matches production (trainer donates too) and frees
    # the param+optimizer aliases.
    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_steps(state, batch, key):
        def body(carry, _):
            new_state, out = train_step(carry, batch, key)
            return new_state, out["loss"]

        state, losses = jax.lax.scan(body, state, None, length=steps)
        return state, losses

    # Warmup / compile (one scan program).  The input state is donated, so
    # keep rebinding the returned one.
    state, losses = run_steps(state, batch, key)
    float(losses[-1])
    t0 = time.perf_counter()
    state, losses = run_steps(state, batch, key)
    float(losses[-1])
    dt = time.perf_counter() - t0
    return batch_size * steps / dt


def bench_infer_step(batch_size: int = 16, steps: int = 20, **model_kwargs):
    """Inference throughput: low-view forward only (the ``val()``/``test()``
    path, parity ``fusion_train.py:277,469-470``), scanned on-device like
    the train bench so the number is device time."""
    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.train.trainer import init_state, make_eval_step, make_model

    cfg = EDRLConfig(
        data=DataConfig(batch_size=batch_size),
        model=ModelConfig(use_bfloat16=True, **model_kwargs),
        train=TrainConfig(),
    )
    model, state = init_state(cfg, 0)
    eval_step = make_eval_step(model, cfg)
    rng = np.random.default_rng(0)
    d = cfg.data
    batch = {
        "fundus_low": jnp.asarray(
            rng.uniform(size=(batch_size, d.fundus_size, d.fundus_size, 3)).astype(
                np.float32
            )
        ),
        "oct_low": jnp.asarray(
            rng.uniform(size=(batch_size, *d.oct_size, 1)).astype(np.float32)
        ),
        "label": jnp.asarray(rng.integers(0, 2, size=batch_size).astype(np.int32)),
    }

    @jax.jit
    def run_steps(state, batch):
        def body(acc, _):
            # Feed the carry back into the input (negligible numerically) so
            # iterations are data-dependent — otherwise XLA hoists the whole
            # loop-invariant forward out of the scan and the timing is fake.
            fundus = batch["fundus_low"] + acc * jnp.float32(1e-24)
            out = eval_step(state, {**batch, "fundus_low": fundus})
            return out["probs"].mean().astype(jnp.float32), None

        acc, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=steps)
        return acc

    float(run_steps(state, batch))  # warmup / compile
    t0 = time.perf_counter()
    float(run_steps(state, batch))
    dt = time.perf_counter() - t0
    return batch_size * steps / dt


def main():
    # Flagship only; to bench any registry model (apples-to-apples baseline
    # comparisons, same methodology) use scripts/bench_model.py.
    devices = require_gpu()
    enable_compile_cache()
    kind = devices[0].device_kind
    peak = peak_bf16_flops(kind)
    batch_size, steps = 16, 20
    pairs_per_sec = bench_train_step(batch_size=batch_size, steps=steps)
    infer_pairs_per_sec = bench_infer_step(batch_size=batch_size, steps=steps)
    flops_per_step = count_train_step_flops(batch_size)
    mfu = (pairs_per_sec / batch_size) * flops_per_step / peak
    record = {
        "metric": "EDRL fundus+OCT train pairs/sec/card (dual-view step, 384^2+96^3, bf16)",
        "value": round(pairs_per_sec, 3),
        "unit": "pairs/sec/card",
        "infer_pairs_per_sec_card": round(infer_pairs_per_sec, 3),
        "model_tflops_per_step": round(flops_per_step / 1e12, 3),
        "mfu_pct": round(100.0 * mfu, 2),
        "device": {
            "platform": devices[0].platform,
            "kind": kind,
            "count": len(devices),
            "nvidia_smi_name_power_limit": card_info(),
        },
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
