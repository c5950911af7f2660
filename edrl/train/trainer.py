"""Training / evaluation loops (rebuild of ``fusion_train.py`` L4).

The hot path — two full dual-backbone forwards (low + high noise view) plus
MK-MMD between the fused features plus backward (``fusion_train.py:176-225``)
— is ONE jitted XLA program per step.  Both forwards live in the same
program, so XLA schedules them back-to-back without host round-trips; under
a multi-device Mesh the same program is SPMD-partitioned with the batch on
the ``data`` axis and the global-batch loss semantics preserved
automatically.

Reference defects fixed here (SURVEY.md section 2.9):
- #9: the CSV "Loss" column now logs the epoch-average total loss, not the
  last batch's MMD value.
- #10: the optional plateau LR schedule is actually stepped when enabled.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from edrl.config import EDRLConfig
from edrl.models.medfusion import MedFusion
from edrl.ops.mmd import mk_mmd
from edrl.train import metrics as metrics_lib
from edrl.train.logging import AverageMeter, CsvMetricWriter


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)


def make_model(cfg: EDRLConfig):
    """Build the configured model via the registry (``--model_name`` parity,
    ``fusion_train.py:657-739``).  Every registry model shares the signature
    ``(fundus, oct_vol, y, train=...)`` and returns either the MedFusion
    4-tuple or the baseline 3-tuple; ``_normalize_output`` unifies them."""
    from edrl.baselines.registry import build_baseline

    model, _ = build_baseline(cfg.model.model_name, cfg)
    return model


def _normalize_output(out):
    """(logits, loss, features[, aux]) -> (logits, loss, features, aux)."""
    if len(out) == 3:
        return out[0], out[1], out[2], {}
    return out


def _dequantize(x: jax.Array) -> jax.Array:
    """uint8-transported batches -> float32 in [0, 1] (no-op for floats)."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) / 255.0
    return x


def make_optimizer(cfg: EDRLConfig) -> optax.GradientTransformation:
    """Adam(lr, weight_decay) parity with ``fusion_train.py:747`` (torch Adam
    folds decay into the gradient before the moments — ``add_decayed_weights``
    upstream of adam reproduces that).  Deep-ensemble member names carry the
    reference's per-member lr overrides (``fusion_train.py:694-716``).  When
    the plateau schedule is enabled it is actually stepped via
    ``optax.contrib.reduce_on_plateau`` (reference defect ledger #10: the
    scheduler existed but was never stepped)."""
    from edrl.baselines.registry import ENSEMBLE_LRS

    lr = ENSEMBLE_LRS.get(cfg.model.model_name, cfg.train.lr)
    parts = []
    if cfg.train.grad_clip_norm > 0:
        # Clip the raw gradients BEFORE the decayed weights are folded in,
        # matching the torch idiom (clip_grad_norm_ runs on .grad before
        # optimizer.step applies weight decay).
        parts.append(optax.clip_by_global_norm(cfg.train.grad_clip_norm))
    parts += [
        optax.add_decayed_weights(cfg.train.weight_decay),
        optax.inject_hyperparams(optax.adam)(learning_rate=lr),
    ]
    if cfg.train.warmup_steps > 0:
        # Multiplicative linear warmup APPENDED to the chain: the effective
        # lr is injected_lr * min((step+1)/warmup_steps, 1), so the plateau
        # schedule's set_learning_rate mutation (which edits the injected
        # base lr at opt_state index 1) composes unchanged, as do
        # get_learning_rate and checkpoint restore of pre-warmup states.
        w = cfg.train.warmup_steps

        def _warmup_factor(step):
            return jnp.minimum((step + 1.0) / w, 1.0)

        parts.append(optax.scale_by_schedule(_warmup_factor))
    return optax.chain(*parts)


def _injected_lr_index(opt_state) -> int:
    """Position of the inject_hyperparams(adam) element in the optax chain.

    Found by structure, not by a hardcoded index: optional chain elements
    (grad clipping upstream, warmup downstream) move it."""
    for i, el in enumerate(opt_state):
        if "learning_rate" in getattr(el, "hyperparams", {}):
            return i
    raise ValueError("no injected learning_rate in opt_state")


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Mutate the injected lr hyperparam (used by the plateau schedule)."""
    opt_state = list(state.opt_state)
    i = _injected_lr_index(opt_state)
    inner = opt_state[i]
    hyperparams = dict(inner.hyperparams)
    hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    opt_state[i] = inner._replace(hyperparams=hyperparams)
    return state.replace(opt_state=tuple(opt_state))


def get_learning_rate(state: TrainState) -> float:
    """The live injected lr (inverse of ``set_learning_rate``)."""
    i = _injected_lr_index(state.opt_state)
    return float(state.opt_state[i].hyperparams["learning_rate"])


class PlateauTracker:
    """ReduceLROnPlateau(mode=min, factor, patience) host-side logic —
    the reference constructed this but never stepped it (ledger #10); here it
    runs when ``use_plateau_schedule`` is on."""

    def __init__(self, lr: float, factor: float, patience: int):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, val_loss: float) -> Optional[float]:
        if val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad_epochs = 0
            return None
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.lr *= self.factor
            self.bad_epochs = 0
            return self.lr
        return None


def init_state(cfg: EDRLConfig, rng_seed: int = 0) -> Tuple[MedFusion, TrainState]:
    model = make_model(cfg)
    d = cfg.data
    fundus = jnp.zeros((2, d.fundus_size, d.fundus_size, 3), jnp.float32)
    oct_vol = jnp.zeros((2, *d.oct_size, 1), jnp.float32)
    y = jnp.zeros((2,), jnp.int32)
    rngs = {
        "params": jax.random.key(rng_seed),
        "sample": jax.random.key(rng_seed + 1),
        "dropout": jax.random.key(rng_seed + 2),
    }
    # jit the init: eager init dispatches thousands of tiny ops one by one.
    init_fn = jax.jit(functools.partial(model.init, train=True))
    variables = init_fn(rngs, fundus, oct_vol, y)
    tx = make_optimizer(cfg)
    params = variables["params"]
    return model, TrainState(
        step=jnp.asarray(0, jnp.int32),
        params=params,
        # Plain {} (not FrozenDict()): a mutable apply returns batch_stats as
        # a plain dict, and lax.scan requires the carry pytree TYPES to match
        # — FrozenDict() in / {} out broke every scanned path (epoch runner,
        # bench) for models without batch stats (caught benching Trans_cross).
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(params),
    )


def make_train_step(
    model,
    tx: optax.GradientTransformation,
    cfg: EDRLConfig,
    jit: bool = True,
    state_shardings=None,
):
    """One jitted step: dual forward + MK-MMD + backward + Adam update.

    ``jit=False`` returns the raw step function for embedding inside a larger
    jitted program (e.g. a multi-step ``lax.scan`` in ``bench.py``).

    ``state_shardings``: optional TrainState-shaped sharding tree (see
    ``parallel.mesh.train_state_shardings``); the updated state is
    sharding-constrained to it so output shardings always match input
    shardings (ZeRO-1 moment shards survive the step, and re-feeding the
    state never recompiles)."""

    kernel_mul = cfg.train.mmd_kernel_mul
    kernel_num = cfg.train.mmd_kernel_num

    def mmd_fn(a, b):
        return mk_mmd(a, b, kernel_mul=kernel_mul, kernel_num=kernel_num)

    noise_cfg = cfg.data.noise
    data_cfg = cfg.data

    def step_fn(state: TrainState, batch: Dict[str, jax.Array], base_key: jax.Array):
        key = jax.random.fold_in(base_key, state.step)
        k_s1, k_d1, k_s2, k_d2, k_noise = jax.random.split(key, 5)
        y = batch["label"]
        if "fundus" in batch:
            # Device-side augmentation + dual-view construction from the
            # clean batch (uint8 transport dequantized; dtype trace-static).
            from edrl.data.device_augment import (
                augment_fundus_batch,
                augment_oct_batch,
            )
            from edrl.data.device_noise import make_views_device

            k_aug_f, k_aug_o, k_noise = jax.random.split(k_noise, 3)
            fundus = augment_fundus_batch(
                _dequantize(batch["fundus"]),
                k_aug_f,
                jitter_prob=data_cfg.color_jitter_prob,
                jitter_strength=data_cfg.color_jitter_strength,
                grayscale_prob=data_cfg.grayscale_prob,
                hflip_prob=data_cfg.hflip_prob,
            )
            oct_vol = augment_oct_batch(
                _dequantize(batch["oct"]), k_aug_o, data_cfg.hflip_prob
            )
            views = make_views_device(fundus, oct_vol, noise_cfg, k_noise)
            batch = {**views, "label": y}

        def loss_fn(params):
            out1, upd1 = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch["fundus_low"],
                batch["oct_low"],
                y,
                train=True,
                rngs={"sample": k_s1, "dropout": k_d1},
                mutable=["batch_stats"],
            )
            logits, loss1, feat1, aux = _normalize_output(out1)
            if (
                cfg.train.mmd_weight == 0.0
                and cfg.train.js_distillation_weight == 0.0
            ):
                # Ablation: the high-noise forward only feeds the dual-view
                # terms (MK-MMD, JS distillation) — skip it entirely (half
                # the FLOPs) only when BOTH are off; '-MMD +JSD' still needs
                # the second forward's logits.
                return loss1, (upd1["batch_stats"], logits, aux, jnp.asarray(0.0))
            # Second full forward on the high-noise view; its own loss is
            # discarded, only features feed MK-MMD (``fusion_train.py:194``).
            out2, upd2 = model.apply(
                {"params": params, "batch_stats": upd1["batch_stats"]},
                batch["fundus_high"],
                batch["oct_high"],
                y,
                train=True,
                rngs={"sample": k_s2, "dropout": k_d2},
                mutable=["batch_stats"],
            )
            norm2 = _normalize_output(out2)
            feat2 = norm2[2]
            mmd = cfg.train.mmd_weight * mmd_fn(feat1, feat2)
            loss = loss1 + mmd
            if cfg.train.js_distillation_weight > 0.0:
                from edrl.ops.distributions import js_divergence

                js = js_divergence(
                    jax.nn.softmax(logits, axis=-1),
                    jax.nn.softmax(norm2[0], axis=-1),
                )
                loss = loss + cfg.train.js_distillation_weight * js
            return loss, (upd2["batch_stats"], logits, aux, mmd)

        (loss, (batch_stats, logits, aux, mmd)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = state.replace(
            step=state.step + 1,
            params=params,
            batch_stats=batch_stats,
            opt_state=opt_state,
        )
        probs = jax.nn.softmax(logits, axis=-1)
        out = {"loss": loss, "mmd": mmd, "probs": probs}
        out.update({k: v for k, v in aux.items()})
        if state_shardings is not None:
            new_state = jax.lax.with_sharding_constraint(
                new_state, state_shardings
            )
        return new_state, out

    if not jit:
        return step_fn
    jitted = jax.jit(step_fn, donate_argnums=(0,))
    if state_shardings is None:
        return jitted
    return _with_mesh_context(jitted, state_shardings)


def _with_mesh(jitted_fn, mesh):
    """Call ``jitted_fn`` under ``jax.set_mesh`` so model-internal
    ``parallel.mesh.batch_constraint`` calls (bare-PartitionSpec sharding
    constraints) resolve against the step's mesh at trace time.  The context only matters for the first
    (tracing) call; it is a few-ns no-op on cached dispatches."""
    if mesh is None:
        return jitted_fn

    @functools.wraps(jitted_fn)
    def call(*args, **kwargs):
        with jax.set_mesh(mesh):
            return jitted_fn(*args, **kwargs)

    return call


def _with_mesh_context(jitted_fn, state_shardings):
    mesh = jax.tree_util.tree_leaves(state_shardings)[0].mesh
    return _with_mesh(jitted_fn, mesh)


def eval_low_view(batch, noise_cfg):
    """The deterministic LOW-noise eval view (parity ``fusion_train.py:277``).

    uint8-transport loaders ship clean ``{fundus, oct}``: dequantize and
    build the low view on device with the FIXED key 123 (eval noise is
    deterministic across runs — the reference replayed a frozen host seed,
    ledger #11 analog); host-noise loaders already carry
    ``{fundus_low, oct_low}``.  ONE implementation shared by
    ``make_eval_step``, ``ensemble.ensemble_predict`` and
    ``mc_dropout.mc_dropout_predict`` so every eval surface sees the same
    view protocol.
    """
    if "fundus_low" in batch:
        return batch["fundus_low"], batch["oct_low"]
    from edrl.data.device_noise import make_low_view_device

    return make_low_view_device(
        _dequantize(batch["fundus"]),
        _dequantize(batch["oct"]),
        noise_cfg,
        jax.random.key(123),
    )


def make_eval_step(model, cfg: EDRLConfig, mesh=None):
    """Eval on the LOW-noise view only (parity ``fusion_train.py:277``).

    Missing-modality masking: MedFusion takes the mask natively (PoE expert
    exclusion); baselines get the absent modality's input zeroed.

    ``mesh``: pass the training mesh so the trace runs under its context
    (the model's ``batch_constraint`` anchors resolve against it).
    """
    native_mask = isinstance(model, MedFusion)
    noise_cfg = cfg.data.noise

    def step_fn(state: TrainState, batch, modality_mask=None):
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        fundus, oct_vol = eval_low_view(batch, noise_cfg)
        kwargs = {}
        if modality_mask is not None:
            if native_mask:
                kwargs["modality_mask"] = modality_mask
            else:
                fundus = fundus * modality_mask[0].astype(fundus.dtype)
                oct_vol = oct_vol * modality_mask[1].astype(oct_vol.dtype)
        out = model.apply(
            variables, fundus, oct_vol, batch["label"], train=False, **kwargs
        )
        logits, loss, _, _ = _normalize_output(out)
        return {"loss": loss, "probs": jax.nn.softmax(logits, axis=-1)}

    return _with_mesh(
        jax.jit(step_fn),
        mesh if mesh is not None and mesh.devices.size > 1 else None,
    )


def make_epoch_runner(
    model,
    tx: optax.GradientTransformation,
    cfg: EDRLConfig,
    state_shardings=None,
):
    """``scan_batches`` train steps inside ONE jitted ``lax.scan`` program.

    Per-batch dispatch pays one host->device round-trip of latency per step.
    The runner takes batches stacked on a leading axis ``[N, B, ...]``, so an
    N-batch chunk costs one dispatch + one transfer.
    The per-step PRNG stream is identical to per-batch dispatch: the step
    function folds ``base_key`` with ``state.step``, which increments inside
    the scan exactly as it does outside.
    """
    raw_step = make_train_step(
        model, tx, cfg, jit=False, state_shardings=state_shardings
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_chunk(state: TrainState, stacked, base_key):
        def body(st, batch):
            st, out = raw_step(st, batch, base_key)
            return st, (out["loss"], out["probs"])

        state, (losses, probs) = jax.lax.scan(body, state, stacked)
        return state, losses, probs

    if state_shardings is not None:
        return _with_mesh_context(run_chunk, state_shardings)
    return run_chunk


def _stack_batches(batches):
    """[{k: [B, ...]}] -> {k: [N, B, ...]} (host-side byte stack)."""
    return {
        k: np.stack([np.asarray(b[k]) for b in batches])
        for k in batches[0]
    }


@dataclasses.dataclass
class FitResult:
    train_history: list
    val_history: list
    best_acc: float
    best_epoch: int


def run_eval(
    state: TrainState,
    eval_step,
    loader,
    epoch: int = 0,
    modality_mask: Optional[np.ndarray] = None,
    mesh=None,
) -> Tuple[metrics_lib.EpochMetrics, np.ndarray, np.ndarray]:
    targets, dev_probs, dev_losses, real_sizes = [], [], [], []
    loss_meter = AverageMeter()
    mask = None if modality_mask is None else jnp.asarray(modality_mask)
    data_axis = int(mesh.shape.get("data", 1)) if mesh is not None else 1
    for batch in loader.epoch(epoch):
        n = int(batch["label"].shape[0])
        pad = (-n) % data_axis
        if pad:
            # Val loaders keep the remainder batch (drop_last=False); a
            # partial batch is not shardable over the data axis, so pad by
            # repeating the last sample and slice the probs back after the
            # loop.  The batch's mean loss still averages over the padded
            # rows (the composite loss has batch-level terms, so an exact
            # per-sample re-slice is not well-defined) — but the epoch mean
            # below weights every batch by its REAL sample count, so padding
            # does not inflate the remainder batch's influence.
            batch = {
                k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                for k, v in batch.items()
            }
        arrays = _to_device(batch, mesh)
        out = eval_step(state, arrays) if mask is None else eval_step(
            state, arrays, mask
        )
        targets.append(np.asarray(batch["label"][:n]))
        real_sizes.append(n)
        # Keep device futures; a per-batch float()/asarray() sync serializes
        # the next batch's upload behind this batch's compute.
        dev_probs.append(out["probs"])
        dev_losses.append(out["loss"])
    probs = [np.asarray(p)[:n] for p, n in zip(dev_probs, real_sizes)]
    for loss, n in zip(dev_losses, real_sizes):
        # Sample-weighted epoch mean: remainder batches (and their padded
        # duplicates) count only their real rows.
        loss_meter.update(float(loss), n=n)
    if not targets:
        # Empty loader (e.g. fold smaller than the batch with drop_last):
        # surface NaN metrics instead of crashing.
        nan = float("nan")
        empty = metrics_lib.EpochMetrics(nan, nan, nan, nan, nan, nan, nan)
        return empty, np.zeros((0,), np.int64), np.zeros((0, 2))
    targets = np.concatenate(targets)
    probs = np.concatenate(probs)
    return (
        metrics_lib.compute_epoch_metrics(targets, probs, loss_meter.avg),
        targets,
        probs,
    )


def _to_device(batch, mesh):
    if mesh is not None:
        from edrl.parallel.mesh import shard_batch

        return shard_batch(batch, mesh)
    return jax.tree_util.tree_map(jnp.asarray, batch)


def resume_from_latest(cfg: EDRLConfig, checkpoint_manager, train_loader):
    """Preemption resume: restore the rolling ``latest`` checkpoint and
    compute where to continue.

    Returns ``(state, cfg, initial_best, completed_epochs)`` with
    ``cfg.train.start_epoch`` advanced past the completed epochs, or ``None``
    when there is nothing to resume.  The completed-epoch count is derived
    from the checkpointed step counter (one optimizer step per batch,
    ``len(train_loader)`` per epoch) — exact even if a crash interrupted an
    async ``latest`` write, because the rename-into-place write means ``latest``
    is always a complete (possibly one-epoch-older) state.  The resumed run
    is step-identical to an uninterrupted one: the loader shuffles are
    epoch-indexed and the train PRNG folds the checkpointed step
    (``tests/test_train.py::TestResume``); the plateau tracker's lr is
    re-seeded from the restored state's injected hyperparam (so a pre-crash
    reduction is never undone) but its best/bad-epoch counters restart.
    No reference analog — its ``--start_epoch`` reloads
    nothing (SURVEY.md section 5.4)."""
    if checkpoint_manager.latest_info() is None:
        return None
    _, template = init_state(cfg, cfg.train.seed)
    state = checkpoint_manager.restore(template, "latest")
    steps_per_epoch = max(1, len(train_loader))
    done = int(state.step) // steps_per_epoch
    best = checkpoint_manager.best_info()
    initial_best = float(best["accuracy"]) if best else 0.0
    # Offset by the configured start epoch: a run launched with
    # --start_epoch 3 that completed one epoch (epoch 3) must resume at
    # epoch 4, not epoch 2 — the epoch-indexed loader shuffles and the
    # step-folded PRNG both key on the absolute epoch number.
    cfg = cfg.replace(
        train=dataclasses.replace(
            cfg.train, start_epoch=cfg.train.start_epoch + done
        )
    )
    return state, cfg, initial_best, done


def fit(
    cfg: EDRLConfig,
    train_loader,
    val_loader,
    state: Optional[TrainState] = None,
    mesh=None,
    checkpoint_manager=None,
    verbose: bool = True,
    initial_best: float = 0.0,
    initial_best_epoch: int = -1,
) -> Tuple[TrainState, FitResult]:
    """The train&test loop (``fusion_train.py:754-772``): per-epoch train,
    val on the low-noise view, best-accuracy checkpointing, CSV logging.

    ``initial_best``/``initial_best_epoch``: the best-val-accuracy watermark
    (and its epoch) to start from — set on resume so a restored run does not
    overwrite a better pre-crash ``best``, and so FitResult reports the
    pre-crash best epoch instead of -1 when no post-resume epoch beats it.
    """
    model = make_model(cfg)
    tx = make_optimizer(cfg)
    if state is None:
        _, state = init_state(cfg, cfg.train.seed)
    state_shardings = None
    if mesh is not None and mesh.devices.size > 1:
        # Explicit state placement: TP rules on params, ZeRO-1 moment shards
        # when enabled; the same tree constrains the step's output state so
        # shardings are stable across steps (no recompiles).
        from edrl.parallel.mesh import train_state_shardings

        state_shardings = train_state_shardings(
            state, mesh, zero1=cfg.train.zero1
        )
        state = jax.device_put(state, state_shardings)
    eval_step = make_eval_step(model, cfg, mesh=mesh)
    # Dispatch-latency amortization: scan_batches > 0 runs that many steps
    # per jitted call.  Composes with the mesh: the stacked chunk is sharded
    # P(None, 'data') so every scanned step sees the same per-chip slices as
    # per-batch dispatch would (regression test in tests/test_parallel.py).
    scan_n = cfg.train.scan_batches
    epoch_runner = (
        make_epoch_runner(model, tx, cfg, state_shardings=state_shardings)
        if scan_n and scan_n > 1
        else None
    )
    # Under scan mode the per-batch step only runs for remainder chunks —
    # build it lazily so an evenly-divisible epoch never pays its (full
    # train-step) compile.
    _step_cache = [] if epoch_runner is not None else [
        make_train_step(model, tx, cfg, state_shardings=state_shardings)
    ]

    def train_step(*a, **kw):
        if not _step_cache:
            _step_cache.append(
                make_train_step(model, tx, cfg, state_shardings=state_shardings)
            )
        return _step_cache[0](*a, **kw)
    base_key = jax.random.key(cfg.train.seed + 1000)

    writer = None
    if cfg.train.log_dir:
        os.makedirs(cfg.train.log_dir, exist_ok=True)
        writer = CsvMetricWriter(
            os.path.join(
                cfg.train.log_dir,
                f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}.csv",
            )
        )
        if cfg.train.resume and cfg.train.start_epoch > 1:
            # Epochs re-run after the restored `latest` checkpoint re-write
            # their rows; drop the pre-crash duplicates first.
            writer.drop_rows_from(cfg.train.start_epoch)

    plateau = None
    if cfg.train.use_plateau_schedule:
        # Seed from the state's LIVE lr, not the configured lr0: a resumed
        # checkpoint carries any pre-crash plateau reductions in its injected
        # hyperparam, and restarting the tracker at lr0 would RAISE the lr on
        # the first post-resume plateau event (lr0*factor > reduced lr).
        # Only the best/bad_epochs counters restart (documented caveat).
        plateau = PlateauTracker(
            get_learning_rate(state),
            cfg.train.plateau_factor,
            cfg.train.plateau_patience,
        )

    best_acc, best_epoch = initial_best, initial_best_epoch
    train_hist, val_hist = [], []
    for epoch in range(cfg.train.start_epoch, cfg.train.end_epochs + 1):
        loss_meter = AverageMeter()
        # Device arrays are collected as async futures and materialized ONCE
        # after the loop: a float()/np.asarray() per step forces a full
        # host<->device sync, which serializes the next batch's upload behind
        # the current step.
        targets, dev_losses, dev_probs = [], [], []
        t0 = time.time()
        pending = []

        def flush_chunk():
            nonlocal state
            uniform = (
                len({np.asarray(b["label"]).shape[0] for b in pending}) == 1
            )
            if epoch_runner is not None and len(pending) == scan_n and uniform:
                # Uniform-shape chunk (train loaders drop the remainder, so
                # every batch matches): one dispatch for scan_n steps.
                stacked = _stack_batches(pending)
                if mesh is not None:
                    from edrl.parallel.mesh import shard_stacked_batch

                    stacked = shard_stacked_batch(stacked, mesh)
                else:
                    stacked = jax.tree_util.tree_map(jnp.asarray, stacked)
                state, losses, chunk_probs = epoch_runner(
                    state, stacked, base_key
                )
                dev_losses.append(losses)  # [scan_n]
                dev_probs.append(
                    chunk_probs.reshape(-1, chunk_probs.shape[-1])
                )
            else:
                for b in pending:
                    arrays = _to_device(b, mesh)
                    state, out = train_step(state, arrays, base_key)
                    dev_losses.append(out["loss"].reshape(1))
                    dev_probs.append(out["probs"])
            targets.extend(np.asarray(b["label"]) for b in pending)
            pending.clear()

        for batch in train_loader.epoch(epoch):
            pending.append(batch)
            if epoch_runner is None or len(pending) == scan_n:
                flush_chunk()
        if pending:
            flush_chunk()
        probs = [np.asarray(p) for p in dev_probs]
        for larr in np.concatenate([np.asarray(l) for l in dev_losses]):
            loss_meter.update(float(larr))
        epoch_time = time.time() - t0
        em = metrics_lib.compute_epoch_metrics(
            np.concatenate(targets), np.concatenate(probs), loss_meter.avg
        )
        train_hist.append(em)
        if writer:
            writer.write(epoch, em)
        if verbose:
            pairs = len(np.concatenate(targets))
            print(
                f"Train Epoch: {epoch} \tLoss: {em.loss:.6f} \t"
                f"Accuracy: {em.accuracy:.4f} \tAUC: {em.auc:.4f} \t"
                f"({pairs / max(epoch_time, 1e-9):.2f} pairs/s)"
            )

        vm, _, _ = run_eval(state, eval_step, val_loader, epoch, mesh=mesh)
        val_hist.append(vm)
        if verbose:
            print(
                f"Val   Epoch: {epoch} \tLoss: {vm.loss:.6f} \t"
                f"Accuracy: {vm.accuracy:.4f} \tAUC: {vm.auc:.4f}"
            )
        if vm.accuracy > best_acc:
            best_acc, best_epoch = vm.accuracy, epoch
            if checkpoint_manager is not None:
                checkpoint_manager.save_best(state, epoch, best_acc)
        if (
            checkpoint_manager is not None
            and cfg.train.save_every > 0
            and epoch % cfg.train.save_every == 0
        ):
            checkpoint_manager.save(state, name=f"epoch_{epoch}")
        if (
            checkpoint_manager is not None
            and cfg.train.save_latest_every > 0
            and epoch % cfg.train.save_latest_every == 0
            and hasattr(checkpoint_manager, "save_latest")
        ):
            checkpoint_manager.save_latest(state, epoch)
        if plateau is not None:
            # "accuracy" negates so the min-mode tracker maximizes it (see
            # plateau_metric in config.py: the eval loss is dominated by the
            # 0.8-weighted proxy term, not CE).
            signal = (
                -vm.accuracy
                if cfg.train.plateau_metric == "accuracy"
                else vm.loss
            )
            new_lr = plateau.step(signal)
            if new_lr is not None:
                state = set_learning_rate(state, new_lr)
                if verbose:
                    print(f"Plateau: reducing lr to {new_lr:g}")
        if (
            cfg.train.plot_dir
            and cfg.train.student_t_every > 0
            and epoch % cfg.train.student_t_every == 0
        ):
            from edrl.train.visualize import dump_proxy_distributions

            try:
                dump_proxy_distributions(
                    state.params, cfg.model, epoch, cfg.train.plot_dir
                )
            except KeyError:
                # Unexpected params tree (e.g. a custom model whose eprl_*
                # module lacks "proxies"); proxy-less baselines return None
                # inside dump_proxy_distributions without raising.
                pass

    if cfg.train.plot_dir and train_hist:
        # End-of-run curve jpgs (reference ``fusion_train.py:771-772``;
        # the acc curve plots per-epoch val accuracy rather than the
        # reference's running-best, which flatlines).
        from edrl.train.visualize import loss_plot, metrics_plot

        stem = (
            f"{cfg.model.model_name}_{cfg.data.batch_size}_"
            f"{cfg.data.dataset}_{cfg.train.end_epochs}"
        )
        loss_plot(
            [m.loss for m in train_hist],
            os.path.join(cfg.train.plot_dir, f"{stem}_loss.jpg"),
        )
        metrics_plot(
            {"acc": [m.accuracy for m in val_hist]},
            os.path.join(cfg.train.plot_dir, f"{stem}_acc.jpg"),
        )

    if checkpoint_manager is not None and hasattr(checkpoint_manager, "wait"):
        # Async checkpoint writes overlap training epochs; drain the last
        # in-flight write so callers (test phase, ensemble stacking) never
        # race a half-committed "best".
        checkpoint_manager.wait()
    return state, FitResult(train_hist, val_hist, best_acc, best_epoch)
