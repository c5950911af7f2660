"""Barlow-Twins-style cross-correlation losses (DILR disentanglement).

Rebuilds ``off_diagonal`` (``fusion_net.py:544-548``) and
``DILR.bt_loss_cross`` (``fusion_net.py:656-677``): the empirical
cross-correlation between batch-standardized common/unique feature blocks,
pushed toward identity on the common block and toward zero on the unique
block.

The correlation is a ``[d, d]`` contraction over the batch — one matmul;
accumulate in float32.  Under data parallelism the batch mean /
variance and the ``z1.T @ z2`` contraction are *global-batch* statistics; jit
over a Mesh with batch sharded on the data axis makes XLA insert the needed
psum/all-gather (SURVEY.md section 2.7).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def batch_standardize(x: jax.Array, eps: float = 1e-5) -> jax.Array:
    """Zero-mean unit-variance standardization over the batch axis.

    Equivalent to the reference's affine-free ``nn.BatchNorm1d(2048,
    affine=False)`` in training mode (``fusion_net.py:653-654``).  Computed in
    float32 regardless of input dtype.
    """
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=0, keepdims=True)
    var = jnp.var(x, axis=0, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps)


def cross_correlation(z1: jax.Array, z2: jax.Array, divisor: float) -> jax.Array:
    """c = z1.T @ z2 / divisor  (``fusion_net.py:658-661``).

    The reference divides by ``batch_size * 4`` — a 4-GPU Barlow-Twins
    leftover preserved as-executed via the explicit ``divisor`` argument.
    """
    z1 = z1.astype(jnp.float32)
    z2 = z2.astype(jnp.float32)
    return (z1.T @ z2) / divisor


def off_diagonal_sum_sq(c: jax.Array) -> jax.Array:
    """Sum of squares of off-diagonal entries of a square matrix."""
    n = c.shape[0]
    mask = 1.0 - jnp.eye(n, dtype=c.dtype)
    return jnp.sum(jnp.square(c) * mask)


def barlow_block_loss(
    z1: jax.Array,
    z2: jax.Array,
    common_dim: int,
    batch_divisor: float,
    off_diag_weight: float = 0.0051,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """DILR cross-correlation loss over (common, unique) blocks.

    Parity: ``DILR.bt_loss_cross`` (``fusion_net.py:656-677``).
    ``z1``/``z2`` are already batch-standardized ``[B, d]`` features whose
    first ``common_dim`` channels are the common block.  Returns
    ``(loss, loss_common, loss_unique)`` where
    ``loss = (loss_common + loss_unique) / 2`` as composed at
    ``fusion_net.py:754``.
    """
    c = cross_correlation(z1, z2, batch_divisor)
    c_c = c[:common_dim, :common_dim]
    c_u = c[common_dim:, common_dim:]

    on_diag_c = jnp.sum(jnp.square(jnp.diagonal(c_c) - 1.0))
    off_diag_c = off_diagonal_sum_sq(c_c)
    on_diag_u = jnp.sum(jnp.square(jnp.diagonal(c_u)))
    off_diag_u = off_diagonal_sum_sq(c_u)

    loss_c = on_diag_c + off_diag_weight * off_diag_c
    loss_u = on_diag_u + off_diag_weight * off_diag_u
    return 0.5 * (loss_c + loss_u), loss_c, loss_u
