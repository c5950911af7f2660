"""MC-dropout uncertainty sampling.

The reference's ``Multi_dropout_ResNet`` keeps dropout active at inference
(``mc=True``, ``baseline_models.py:1069-1113``) but ships no loop that
actually samples it.  This module supplies the missing piece: K stochastic
forwards per batch, averaged into a predictive distribution with a
per-sample epistemic-uncertainty estimate.

Design: the K passes run inside ONE jitted ``lax.scan`` over dropout
keys — a single XLA program per batch regardless of K, so sampling cost is
K device passes with zero host round-trips in between.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from edrl.config import EDRLConfig
from edrl.train.trainer import TrainState, _normalize_output


def model_supports_mc(model) -> bool:
    """True if the model's ``__call__`` takes the ``mc`` keyword (dropout
    stays active at inference for uncertainty sampling)."""
    try:
        return "mc" in inspect.signature(type(model).__call__).parameters
    except (TypeError, ValueError):
        return False


def make_mc_predict(model, num_samples: int):
    """Returns a jitted ``(state, fundus, oct_vol, y, key) -> (mean, std)``
    running ``num_samples`` stochastic forwards in one ``lax.scan`` program.

    ``mean``/``std`` are the per-sample mean and standard deviation of the
    softmax probabilities over the K dropout masks ``[B, C]``.
    """
    use_mc = model_supports_mc(model)

    @jax.jit
    def predict(state: TrainState, fundus, oct_vol, y, key):
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        kwargs = {"mc": True} if use_mc else {}

        def one_pass(_, k):
            out = model.apply(
                variables,
                fundus,
                oct_vol,
                y,
                train=False,
                rngs={"dropout": k, "sample": jax.random.fold_in(k, 1)},
                **kwargs,
            )
            logits = _normalize_output(out)[0]
            return None, jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

        keys = jax.random.split(key, num_samples)
        _, probs = jax.lax.scan(one_pass, None, keys)  # [K, B, C]
        return probs.mean(axis=0), probs.std(axis=0)

    return predict


def mc_dropout_predict(
    cfg: EDRLConfig,
    state: TrainState,
    loader,
    num_samples: int = 10,
    seed: int = 0,
    model=None,
) -> Dict[str, np.ndarray]:
    """Run MC-dropout over an eval loader (low-noise view).

    Returns targets, the K-averaged probabilities, and the mean predictive
    std (epistemic uncertainty) per sample.
    """
    from edrl.train.trainer import make_model

    model = model or make_model(cfg)
    predict = make_mc_predict(model, num_samples)
    base = jax.random.key(seed)

    targets: List[np.ndarray] = []
    dev_probs: List[jax.Array] = []
    dev_stds: List[jax.Array] = []
    for i, batch in enumerate(loader.epoch(0)):
        arrays = jax.tree_util.tree_map(jnp.asarray, batch)
        # The shared deterministic low-noise eval view (trainer.eval_low_view).
        from edrl.train.trainer import eval_low_view

        fundus, oct_vol = eval_low_view(arrays, cfg.data.noise)
        mean, std = predict(
            state, fundus, oct_vol, arrays["label"], jax.random.fold_in(base, i)
        )
        targets.append(np.asarray(batch["label"]))
        # Device futures only; a per-batch np.asarray() sync serializes the
        # next batch's upload behind the K-sample scan (same fix as
        # ensemble_predict's one-deferred-sync loop).
        dev_probs.append(mean)
        dev_stds.append(std)
    return {
        "targets": np.concatenate(targets),
        "probs": np.concatenate([np.asarray(p) for p in dev_probs]),
        "predictive_std": np.concatenate([np.asarray(s) for s in dev_stds]),
    }
