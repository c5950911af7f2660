"""Deep-ensemble evaluation (``test_ensemble``, ``fusion_train.py:392-502``).

Loads the ``Multi_DE{1..5}_ResNet`` member checkpoints (same late-fusion
architecture, trained at different learning rates), averages their logits per
sample, computes the 10-metric uncertainty suite (Acc/AUC/AURC/EAURC/NLL/
Brier/F1/Recall/Kappa/ECE), and writes ``Metric.txt`` — the reference's
evaluation surface, minus its dependency on the missing ``metrics``/
``metrics2`` modules (rebuilt in ``edrl.train.metrics``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import jax
import numpy as np

from edrl.config import EDRLConfig
from edrl.train import metrics as metrics_lib
from edrl.train.checkpoint import CheckpointManager
from edrl.train.trainer import TrainState, _normalize_output, init_state


def stack_pytrees(trees):
    """Leaf-wise stack of congruent pytrees onto a leading [K] axis."""
    import jax.numpy as jnp

    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def stack_member_states(states: Sequence[TrainState]):
    """Leaf-wise stack of member params/batch_stats onto a leading [K] axis.

    Members share an architecture by construction (``Multi_DE{1..5}`` differ
    only by training lr, ``fusion_train.py:694-716``), so their pytrees are
    congruent and the K forwards can run as ONE vmapped program.
    """
    params = stack_pytrees([s.params for s in states])
    stats = stack_pytrees([s.batch_stats for s in states])
    return params, stats


def restore_members(cfg: EDRLConfig, checkpoint_dirs: Sequence[str]) -> List:
    """Restore one state per member checkpoint dir (``best`` else ``latest``).

    One init template serves every member: ``init_state(cfg, 0)`` is
    deterministic and a jitted full-model init is a full compile — don't
    pay it K times.  Shared by ``evaluate_ensemble`` and
    ``serve.Predictor.from_checkpoints``.
    """
    _, template = init_state(cfg, 0)
    states = []
    for directory in checkpoint_dirs:
        mgr = CheckpointManager(directory)
        name = "best" if mgr.best_info() is not None else "latest"
        states.append(mgr.restore(template, name))
    return states


def ensemble_predict(
    cfg: EDRLConfig,
    states: Sequence[TrainState],
    loader,
    model=None,
) -> Dict[str, np.ndarray]:
    """Average member logits over the eval set (low-noise view).

    One jitted program per batch: the K member forwards run as a vmap over
    stacked params (no per-member dispatch), and all host syncs are
    deferred to after the loop — the reference did K sequential forwards
    per batch (``fusion_train.py:441-445``) and round 2's port additionally
    blocked on a host sync per member per batch, which serializes uploads
    behind compute.

    Returns targets, mean probabilities, and per-sample latency
    (the reference instrumented per-sample inference time,
    ``fusion_train.py:469-470``; measured here over the whole deferred
    pipeline, not per blocking call).
    """
    import jax.numpy as jnp

    from edrl.train.trainer import _dequantize, make_model

    model = model or make_model(cfg)
    stacked_params, stacked_stats = stack_member_states(states)
    noise_cfg = cfg.data.noise

    @jax.jit
    def make_view(fundus_raw, oct_raw):
        # The shared deterministic low-noise eval view (one protocol across
        # every eval surface — ``trainer.eval_low_view``).
        from edrl.train.trainer import eval_low_view

        return eval_low_view(
            {"fundus": fundus_raw, "oct": oct_raw}, noise_cfg
        )

    @jax.jit
    def forward(params_k, stats_k, fundus, oct_vol, y):
        def one_member(p, bs):
            out = model.apply(
                {"params": p, "batch_stats": bs}, fundus, oct_vol, y,
                train=False,
            )
            return _normalize_output(out)[0]

        logits_k = jax.vmap(one_member)(params_k, stats_k)  # [K, B, C]
        return jax.nn.softmax(jnp.mean(logits_k, axis=0), axis=-1)

    targets: List[np.ndarray] = []
    dev_probs: List[jax.Array] = []
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        y = batch["label"]
        if "fundus" in batch:
            fundus, oct_vol = make_view(
                jnp.asarray(batch["fundus"]), jnp.asarray(batch["oct"])
            )
        else:
            fundus, oct_vol = batch["fundus_low"], batch["oct_low"]
        dev_probs.append(
            forward(stacked_params, stacked_stats, fundus, oct_vol, y)
        )
        targets.append(np.asarray(y))
    probs = [np.asarray(p) for p in dev_probs]  # single deferred sync point
    total = time.perf_counter() - t0
    n = int(sum(len(t) for t in targets))
    return {
        "targets": np.concatenate(targets),
        "probs": np.concatenate(probs),
        "latency_per_sample": total / max(n, 1),
    }


def evaluate_ensemble(
    cfg: EDRLConfig,
    checkpoint_dirs: Sequence[str],
    loader,
    output_path: str = "Metric.txt",
) -> Dict[str, float]:
    """Load member checkpoints, run the suite, write ``Metric.txt``."""
    pred = ensemble_predict(cfg, restore_members(cfg, checkpoint_dirs), loader)
    suite = metrics_lib.compute_uncertainty_metrics(pred["targets"], pred["probs"])
    suite["latency_per_sample_s"] = pred["latency_per_sample"]
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        for k, v in suite.items():
            f.write(f"{k}: {v:.6f}\n")
    return suite
