"""CLUB mutual-information upper-bound estimator (functional core).

Rebuilds the math of ``CLUBMean`` (``fusion_net.py:501-542``): a variational
MI upper bound with unit-variance q(y|x).  The MLP that predicts mu is a model
concern (``edrl.models``); these functions take the predicted ``mu``
directly so they stay pure and testable.

Note: in the reference the estimator is constructed but its ``learning_loss``
call on the active path is commented out (``fusion_net.py:832,922`` — defect
ledger #3); it is provided here for completeness and for ablation configs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def club_mean_mi(mu: jax.Array, y_samples: jax.Array) -> jax.Array:
    """CLUB MI upper bound given q(y|x) mean predictions.

    positive = -(mu - y)^2 / 2 per pair (i, i);
    negative = mean_j -(mu_i - y_j)^2 / 2;
    bound = mean_i sum_d (positive - negative).
    Parity: ``CLUBMean.forward`` (``fusion_net.py:520-533``).
    """
    mu = mu.astype(jnp.float32)
    y = y_samples.astype(jnp.float32)
    positive = -jnp.square(mu - y) / 2.0  # [n, d]
    diffs = mu[:, None, :] - y[None, :, :]  # [n, n, d]
    negative = -jnp.mean(jnp.square(diffs), axis=1) / 2.0  # [n, d]
    return jnp.mean(jnp.sum(positive, axis=-1) - jnp.sum(negative, axis=-1))


def club_learning_loss(mu: jax.Array, y_samples: jax.Array) -> jax.Array:
    """Negative unnormalized log-likelihood of q(y|x) — the estimator's own loss.

    Parity: ``CLUBMean.loglikeli``/``learning_loss`` (``fusion_net.py:535-542``).
    """
    mu = mu.astype(jnp.float32)
    y = y_samples.astype(jnp.float32)
    loglik = jnp.mean(jnp.sum(-jnp.square(mu - y), axis=1))
    return -loglik
