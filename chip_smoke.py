"""Smoke run of EDRL on an NVIDIA GPU: the main path once, at full width.

    python chip_smoke.py              # one card: parity, training, serving
    python chip_smoke.py --chips 4    # four cards: data-parallel fit() vs one card

One-card phases:

1. device   — JAX must see a GPU; prints its kind and count, and the card's
              name and power limit from ``nvidia-smi``.
2. parity   — Swin window attention (every stage's shape, with and without
              the shift mask) and ViT-3D attention at real widths in bf16
              against a float32 reference at "highest" matmul precision:
              output, dq/dk/dv and dbias.  Then the full-size model's bf16
              probabilities against its float32 ones, and the tiny model in
              float32 on the GPU against the CPU.
3. training — ``fit()`` trains the full-size flagship on synthetic data at
              batch 16, then 32: finite losses, compiled memory, peak
              memory, compile time, best-checkpoint save and restore.
4. serving  — ``Predictor`` built from the restored state answers requests
              with uint8 and f32 transport; its probabilities must match
              ``make_eval_step`` on the same inputs.

Any failure exits non-zero.  The last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, "results", "chip_smoke")

# Real widths: Swin-2D stages at 384^2 (windows per image, heads), window 12
# (N = 144), head_dim 128; ViT-3D at 96^3 (N = 216, 6 heads of 128).
SWIN_STAGES = ((64, 1), (16, 2), (4, 4), (1, 8))
VIT_SHAPE = (216, 6)
# bf16 keeps an 8-bit mantissa (relative rounding 2^-9 per operand) and the
# softmax / PV sums run over 144-216 terms, so outputs of O(1) carry ~1e-2
# absolute error; gradients accumulate a few such terms per element.
OUT_MAX_ABS = 2e-2
GRAD_REL_FRO = 3e-2
PROBS_MAX_ABS = 5e-2  # full model, bf16 vs float32 probabilities
CPU_GPU_LOSS = 1e-4  # tiny model, float32 at "highest", GPU vs CPU
SERVE_MAX_ABS = 2e-3  # Predictor vs make_eval_step, same program on the card
# Full widths, depth cut to one shifted pair per Swin stage and two ViT
# blocks: a cold compile of the full-depth train step takes ~6 minutes on
# the card, and the run has to fit its time limit from a cold cache.
SMOKE_DEPTH = dict(swin_depths=(2, 2, 2, 2), vit3d_depth=2)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_fro(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _softmax_attention(q, k, v, scale, bias=None):
    s = jnp.einsum("...qhd,...khd->...hqk", q, k) * scale
    if bias is not None:
        s = s + bias
    return jnp.einsum("...hqk,...khd->...qhd", jax.nn.softmax(s, axis=-1), v)


def _reference_window(qkv, bias, mask, heads, scale):
    """float32 window attention, written independently of the model code."""
    b, nw, n, c3 = qkv.shape
    x = qkv.astype(F32).reshape(b, nw, n, 3, heads, c3 // (3 * heads))
    full = bias.astype(F32) if mask is None else bias.astype(F32) + mask[:, None]
    out = _softmax_attention(x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :], scale, full)
    return out.reshape(b, nw, n, c3 // 3)


def _reference_vit(q, k, v, heads, scale):
    b, n, c = q.shape
    split = lambda y: y.astype(F32).reshape(b, n, heads, c // heads)
    return _softmax_attention(split(q), split(k), split(v), scale).reshape(b, n, c)


def _check(name: str, value: float, limit: float) -> None:
    ok = np.isfinite(value) and value <= limit
    log(f"  {name} = {value:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value} exceeds {limit}")


def _value_and_grads(fn, args, cot):
    """``fn(*args)`` and the gradients of ``sum(fn(*args) * cot)``, in one
    jitted program (``cot`` is an argument, not a baked-in constant)."""

    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return (out, *vjp(cot.astype(out.dtype)))

    return jax.jit(run)(args, cot)


def attention_parity(batch=16, window=12, head_dim=128, stages=SWIN_STAGES,
                     vit=VIT_SHAPE, seed=0):
    """Each attention route in bf16 vs the float32 reference, value and
    gradient.  Raises on a tolerance breach."""
    from edrl.models import layers, swin2d

    rng = np.random.default_rng(seed)
    scale = head_dim**-0.5
    bf = lambda shape: jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    n = window * window
    for nw, heads in stages:
        grid = int(round(nw**0.5)) * window
        for shifted in (False, True) if nw > 1 else (False,):
            mask = swin2d._shift_attn_mask(grid, window, window // 2) if shifted else None
            qkv = bf((batch, nw, n, 3 * heads * head_dim))
            bias = bf((heads, n, n))
            cot = bf((batch, nw, n, heads * head_dim)).astype(F32)

            def model_fn(a, b):
                return swin2d.window_attention(a, b, mask, heads, scale)

            def ref_fn(a, b):
                return _reference_window(a, b, None if mask is None else jnp.asarray(mask), heads, scale)

            out, dqkv, dbias = _value_and_grads(model_fn, (qkv, bias), cot)
            with jax.default_matmul_precision("highest"):
                ref, rdqkv, rdbias = _value_and_grads(
                    ref_fn, (qkv.astype(F32), bias.astype(F32)), cot)
            log(f"swin attention nW={nw} heads={heads} shift={shifted}:")
            _check("out max-abs", float(jnp.max(jnp.abs(out.astype(F32) - ref))), OUT_MAX_ABS)
            d = heads * head_dim
            for part, sl in (("dq", slice(0, d)), ("dk", slice(d, 2 * d)), ("dv", slice(2 * d, 3 * d))):
                _check(f"{part} rel-fro", rel_fro(dqkv[..., sl], rdqkv[..., sl]), GRAD_REL_FRO)
            _check("dbias rel-fro", rel_fro(dbias, rdbias), GRAD_REL_FRO)
    n, heads = vit
    c = heads * head_dim
    q, k, v = (bf((batch, n, c)) for _ in range(3))
    cot = bf((batch, n, c)).astype(F32)
    model_fn = lambda a, b, cc: layers.multi_head_attention(a, b, cc, heads, scale)
    ref_fn = lambda a, b, cc: _reference_vit(a, b, cc, heads, scale)
    out, *grads = _value_and_grads(model_fn, (q, k, v), cot)
    with jax.default_matmul_precision("highest"):
        ref, *rgrads = _value_and_grads(ref_fn, tuple(x.astype(F32) for x in (q, k, v)), cot)
    log(f"vit attention N={n} heads={heads}:")
    _check("out max-abs", float(jnp.max(jnp.abs(out.astype(F32) - ref))), OUT_MAX_ABS)
    for part, g, rg in zip(("dq", "dk", "dv"), grads, rgrads):
        _check(f"{part} rel-fro", rel_fro(g, rg), GRAD_REL_FRO)


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    return (
        jnp.asarray(rng.uniform(size=(batch, d.fundus_size, d.fundus_size, 3)), F32),
        jnp.asarray(rng.uniform(size=(batch, *d.oct_size, 1)), F32),
        jnp.asarray(rng.integers(0, cfg.model.num_classes, size=batch), jnp.int32),
    )


def model_parity(cfg, batch=4, seed=0):
    """bf16 probabilities vs float32 ones ("highest"), same params/inputs."""
    from edrl.train.trainer import init_state, make_model

    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model, use_bfloat16=False))
    _, state = init_state(cfg32, seed)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    fundus, oct_vol, y = _inputs(cfg, batch, seed)

    def probs(c):
        model = make_model(c)
        fn = jax.jit(lambda v, f, o: jax.nn.softmax(
            model.apply(v, f, o, None, train=False)[0].astype(F32), axis=-1))
        return fn(variables, fundus, oct_vol)

    p16 = probs(cfg.replace(model=dataclasses.replace(cfg.model, use_bfloat16=True)))
    with jax.default_matmul_precision("highest"):
        p32 = probs(cfg32)
    log(f"full model bf16 vs float32 probabilities (batch {batch}):")
    _check("probs max-abs", float(jnp.max(jnp.abs(p16 - p32))), PROBS_MAX_ABS)


def cpu_gpu_parity(cfg, seed=0):
    """Tiny model in float32 at "highest": loss on the default device vs the
    in-process CPU device."""
    from edrl.train.trainer import init_state

    model, state = init_state(cfg, seed)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    fundus, oct_vol, y = _inputs(cfg, cfg.data.batch_size, seed)
    fn = jax.jit(lambda v, f, o, yy: model.apply(v, f, o, yy, train=False)[1])
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        on_default = float(fn(variables, fundus, oct_vol, y))
        on_cpu = float(fn(*jax.device_put((variables, fundus, oct_vol, y), cpu)))
    log(f"tiny model float32 loss on {jax.devices()[0].platform} vs cpu: "
        f"{on_default:.6f} vs {on_cpu:.6f}")
    _check("loss abs diff", abs(on_default - on_cpu), CPU_GPU_LOSS)


def _memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    gib = 2**30
    return (f"args={ma.argument_size_in_bytes / gib:.3f}GiB "
            f"out={ma.output_size_in_bytes / gib:.3f}GiB "
            f"alias={ma.alias_size_in_bytes / gib:.3f}GiB "
            f"temp={ma.temp_size_in_bytes / gib:.3f}GiB")


def train_phase(cfg, workdir, mesh=None, seed=0, checkpoint=True):
    """``fit()`` through the CLI's loaders, with a checkpoint manager unless
    ``checkpoint`` is False; returns (final state, restored best state or
    None, result)."""
    from edrl.cli.train import make_loaders
    from edrl.train.checkpoint import CheckpointManager
    from edrl.train.trainer import (
        fit, init_state, make_model, make_optimizer, make_train_step,
    )

    train_loader, val_loader = make_loaders(cfg)
    bs = cfg.data.batch_size
    if mesh is None:
        # Compile the step fit() will run (fit reuses it through the
        # persistent compile cache) to report memory and compile time.
        model, state = init_state(cfg, cfg.train.seed)
        step = make_train_step(model, make_optimizer(cfg), cfg)
        batch = jax.tree_util.tree_map(jnp.asarray, next(iter(train_loader.epoch(1))))
        t0 = time.perf_counter()
        compiled = step.lower(state, batch, jax.random.key(0)).compile()
        log(f"train step batch {bs}: compile {time.perf_counter() - t0:.1f}s (set-up); "
            f"memory_analysis {_memory_line(compiled)}")
        del state, compiled
    mgr = CheckpointManager(os.path.join(workdir, f"ckpt_b{bs}")) if checkpoint else None
    t0 = time.perf_counter()
    # initial_best=-1: the first epoch always saves a best checkpoint.
    state, result = fit(cfg, train_loader, val_loader, mesh=mesh,
                        checkpoint_manager=mgr, verbose=False, initial_best=-1.0)
    losses = [m.loss for m in result.train_history]
    log(f"fit batch {bs}: {len(losses)} epochs x {len(train_loader)} steps in "
        f"{time.perf_counter() - t0:.1f}s, train loss per epoch {losses}, "
        f"val acc {[round(m.accuracy, 4) for m in result.val_history]}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    for dev in jax.local_devices():
        stats = dev.memory_stats() or {}
        log(f"  {dev}: peak_bytes_in_use={stats.get('peak_bytes_in_use', 0) / 2**30:.3f}GiB")
    if mgr is None:
        return state, None, result
    mgr.save(state, "final")
    _, template = init_state(cfg, seed)
    restored = mgr.restore(template, "final")
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    best = mgr.restore(template, "best")
    log(f"checkpoint: saved and restored 'final' bit-exact; restored 'best' "
        f"(epoch {mgr.best_info()['epoch']})")
    return state, best, result


def serve_phase(cfg, state, sizes=(1, 5), seed=0):
    """Predictor (uint8 and f32 transport) vs make_eval_step on the same
    8-bit inputs, shipped as the loaders ship them (uint8, clean view)."""
    from edrl.serve import Predictor
    from edrl.train.trainer import make_eval_step, make_model

    rng = np.random.default_rng(seed)
    d = cfg.data
    eval_step = make_eval_step(make_model(cfg), cfg)
    pad = lambda x: np.concatenate([x, np.repeat(x[-1:], d.eval_batch_size - len(x), 0)])
    for transport in ("uint8", "f32"):
        pred = Predictor(cfg, state, transport=transport)
        for n in sizes:
            fundus = rng.integers(0, 256, size=(n, d.fundus_size, d.fundus_size, 3), dtype=np.uint8)
            oct_vol = rng.integers(0, 256, size=(n, *d.oct_size, 1), dtype=np.uint8)
            if transport == "uint8":
                probs = pred.predict_probs(fundus, oct_vol)
            else:
                probs = pred.predict_probs(fundus / np.float32(255), oct_vol / np.float32(255))
            batch = {"fundus": jnp.asarray(pad(fundus)), "oct": jnp.asarray(pad(oct_vol)),
                     "label": jnp.zeros((d.eval_batch_size,), jnp.int32)}
            want = np.asarray(eval_step(state, batch)["probs"])[:n]
            if probs.shape != want.shape or not np.all(np.isfinite(probs)):
                raise AssertionError(f"bad Predictor output {probs.shape}")
            log(f"serve transport={transport} request of {n}:")
            _check("probs max-abs vs eval step", float(np.max(np.abs(probs - want))), SERVE_MAX_ABS)


def flagship_cfg(batch_size, samples, epochs, **model_overrides):
    """The CLI's configuration for ``--dataset synthetic`` at this batch."""
    from edrl.cli.train import build_parser, config_from_args

    args = build_parser().parse_args([
        "--dataset", "synthetic", "--batch_size", str(batch_size),
        "--synthetic_samples", str(samples), "--end_epochs", str(epochs),
        "--checkpoint_dir", "", "--log_dir", "",
    ])
    cfg = config_from_args(args)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_overrides),
        data=dataclasses.replace(cfg.data, eval_batch_size=16),
    )


def one_card():
    from edrl.config import tiny_test_config

    log("== parity")
    attention_parity()
    model_parity(flagship_cfg(16, 16, 1, **SMOKE_DEPTH))
    cpu_gpu_parity(tiny_test_config(batch_size=4))
    log("== training")
    state = None
    for bs, epochs in ((16, 2), (32, 1)):
        cfg = flagship_cfg(bs, 2 * bs, epochs, **SMOKE_DEPTH)
        _, state, _ = train_phase(cfg, WORKDIR)
    log("== serving")
    serve_phase(cfg, state)


def four_cards(n=4, batch=64, cfg=None, workdir=WORKDIR):
    """One fit() step at global batch ``batch`` over a data mesh vs the same
    step on one card.

    The one-card step is fit()'s first step (its initial state, first batch
    and key) as one program on the default device.  It is traced here and
    compiled on a worker thread while the mesh run compiles and runs:
    compiling is host work, and the two programs share nothing."""
    from concurrent.futures import ThreadPoolExecutor

    from edrl.cli.train import make_loaders
    from edrl.parallel import make_mesh
    from edrl.parallel.mesh import shard_batch
    from edrl.train.trainer import init_state, make_optimizer, make_train_step

    if jax.device_count() < n:
        raise RuntimeError(f"--chips {n} needs {n} devices, JAX found {jax.device_count()}")
    if cfg is None:
        # Full widths at one block per Swin stage and one ViT block: the
        # phase checks sharding, not depth.
        cfg = flagship_cfg(batch, batch, 1, swin_depths=(1, 1, 1, 1), vit3d_depth=1)
    model, single = init_state(cfg, cfg.train.seed)
    train_loader, _ = make_loaders(cfg)
    first = jax.tree_util.tree_map(
        jnp.asarray, next(iter(train_loader.epoch(cfg.train.start_epoch))))
    key = jax.random.key(cfg.train.seed + 1000)  # fit()'s base key
    lowered = make_train_step(model, make_optimizer(cfg), cfg).lower(single, first, key)
    log(f"== {n} cards, data mesh, global batch {batch}; one-card step compiling alongside")
    mesh = make_mesh(num_data=n, num_model=1, devices=jax.devices()[:n])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(lambda: (lowered.compile(), time.perf_counter() - t0))
        sharded, _, r_mesh = train_phase(cfg, workdir, mesh=mesh, checkpoint=False)
        compiled, secs = compiling.result()
    log(f"== one card, same step (compiled in {secs:.1f}s, set-up)")
    single, out = compiled(single, first, key)
    loss_m, loss_1 = r_mesh.train_history[0].loss, float(out["loss"])
    log(f"loss {n} cards {loss_m:.6f} vs one card {loss_1:.6f}")
    _check("loss rel diff", abs(loss_m - loss_1) / max(abs(loss_1), 1e-30), 1e-3)
    p_m = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree_util.tree_leaves(sharded.params)])
    p_1 = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree_util.tree_leaves(single.params)])
    _check("updated params rel-fro", rel_fro(p_m, p_1), 1e-3)
    leaf = jax.tree_util.tree_leaves(sharded.params)[0]
    devices = {s.device for s in leaf.addressable_shards}
    d = cfg.data
    x = shard_batch({"x": np.zeros((batch, d.fundus_size, 8), np.float32)}, mesh)["x"]
    shard_devices = {s.device for s in x.addressable_shards}
    shard_rows = {s.data.shape[0] for s in x.addressable_shards}
    stats = [dev.memory_stats() for dev in mesh.devices.flat]
    used = [s.get("bytes_in_use", 0) for s in stats if s is not None]
    log(f"param shards on {len(devices)} devices; batch shards on "
        f"{len(shard_devices)} devices with {shard_rows} rows; bytes_in_use per card "
        f"{used if len(used) == n else 'not reported on this platform'}")
    if len(devices) != n or len(shard_devices) != n or shard_rows != {batch // n}:
        raise AssertionError("the mesh did not place one shard on each card")
    if len(used) == n and min(used) <= 0:
        raise AssertionError(f"a card holds no memory: {used}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)

    # No GEMM autotuning: a cold compile of the train step autotunes for
    # minutes on the card (PERF.md), and this run must fit its time limit
    # from a cold cache.  Only the choice of GEMM configs changes.  Set
    # before the first device query, which creates the backend.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_autotune_level=0"
    ).strip()
    from edrl.device import card_info, enable_compile_cache, require_gpu

    try:
        device = require_gpu()[0]
    except RuntimeError as err:
        log(f"chip_smoke {err}")
        return 1
    enable_compile_cache()
    log(f"== device: {device.device_kind} x {jax.device_count()} ({device.platform})")
    log(f"nvidia-smi name, power.limit: {card_info()}")
    try:
        if args.chips == 4:
            four_cards()
        else:
            one_card()
    finally:
        shutil.rmtree(WORKDIR, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
