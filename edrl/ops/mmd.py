"""Multi-kernel Maximum Mean Discrepancy (MK-MMD).

Rebuild of the reference self-distillation loss
(``code/MMD.py:3-74``): a multi-scale RBF kernel over the concatenation of the
low-noise and high-noise fused feature batches, with the bandwidth set from
the mean pairwise distance.

Design notes:
- The kernel matrix is ``[n, n]`` with ``n = n_s + n_t`` (64 rows at the
  reference batch size), tiny relative to the backbones; the win here is
  keeping everything in one fused XLA computation (one matmul for the Gram
  matrix, fused elementwise exp-sum) and accumulating in float32 even when
  features arrive in bfloat16.
- Under data parallelism the loss must keep *global-batch* semantics
  (SURVEY.md section 2.7): run this inside ``jit`` over a Mesh with the batch
  sharded on the data axis and XLA inserts the all-gather for the ``x @ x.T``
  contraction automatically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pairwise_sq_dists(total: jax.Array) -> jax.Array:
    """Squared euclidean distance matrix via the (x-y)^2 = x^2+y^2-2xy identity.

    The diagonal is forced to exactly zero: the identity suffers float32
    cancellation on self-distances, which would otherwise bleed into the
    bandwidth estimate and the kernel diagonal.
    """
    sq = jnp.sum(total * total, axis=1, keepdims=True)
    d2 = sq + sq.T - 2.0 * (total @ total.T)
    d2 = d2 * (1.0 - jnp.eye(total.shape[0], dtype=d2.dtype))
    return jnp.maximum(d2, 0.0)


def gaussian_kernel(
    source: jax.Array,
    target: jax.Array,
    kernel_mul: float = 2.0,
    kernel_num: int = 5,
) -> jax.Array:
    """Summed multi-scale RBF kernel matrix over concat(source, target).

    Parity: ``code/MMD.py:3-44``.  Bandwidth = mean off-diagonal pairwise
    squared distance, divided by ``kernel_mul**(kernel_num//2)``, then scaled
    geometrically by ``kernel_mul**i`` for each of the ``kernel_num`` kernels.
    """
    total = jnp.concatenate([source, target], axis=0).astype(jnp.float32)
    n = total.shape[0]
    d2 = _pairwise_sq_dists(total)
    length_scale = jnp.sum(d2) / float(n * n - n)
    length_scale = length_scale / (kernel_mul ** (kernel_num // 2))
    # Sum_i exp(-d2 / (ls * mul^i)); keep the loop static and let XLA fuse.
    acc = jnp.zeros_like(d2)
    for i in range(kernel_num):
        acc = acc + jnp.exp(-d2 / (length_scale * (kernel_mul**i) + 1e-12))
    return acc


def mk_mmd(
    source: jax.Array,
    target: jax.Array,
    kernel_mul: float = 2.0,
    kernel_num: int = 5,
) -> jax.Array:
    """MK-MMD loss |mean K_XX + mean K_YY - mean K_XY - mean K_YX|.

    Parity: ``code/MMD.py:46-74``.  This is the noise-robust self-distillation
    loss between the low-noise and high-noise fused feature batches
    (``fusion_train.py:198,212``).
    """
    n_s = source.shape[0]
    n_t = target.shape[0]
    k = gaussian_kernel(source, target, kernel_mul=kernel_mul, kernel_num=kernel_num)
    xx = jnp.sum(k[:n_s, :n_s]) / float(n_s * n_s)
    yy = jnp.sum(k[n_s:, n_s:]) / float(n_t * n_t)
    xy = jnp.sum(k[:n_s, n_s:]) / float(n_s * n_t)
    yx = jnp.sum(k[n_s:, :n_s]) / float(n_s * n_t)
    return jnp.abs(xx + yy - xy - yx)
