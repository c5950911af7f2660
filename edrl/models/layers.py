"""Shared building blocks.

Conventions used across all models in this package:

- computation dtype is configurable (bfloat16 by default) while parameters
  and softmax/reduction accumulations stay float32;
- every matmul that feeds a reduction specifies its accumulation dtype;
- shapes are static everywhere — no data-dependent Python control flow.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from edrl.models import nn

Dtype = Any


class Mlp(nn.Module):
    """Transformer MLP block: Linear -> act -> drop -> Linear -> drop."""

    hidden_dim: int
    out_dim: int
    dropout: float = 0.0
    act: Callable = nn.gelu
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        x = nn.Dense(self.hidden_dim, dtype=self.dtype)(x)
        x = self.act(x)
        x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        x = nn.Dense(self.out_dim, dtype=self.dtype)(x)
        x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        return x


def dot_product_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    scale: float,
    bias: Optional[jax.Array] = None,
) -> jax.Array:
    """``softmax(q k^T * scale + bias) v`` with a float32 softmax.

    q, k, v: ``[..., tokens, heads, head_dim]``; bias broadcasts against the
    scores ``[..., heads, q_tokens, k_tokens]``.  Plain XLA: on the H100 it
    beat cuDNN's fused attention and a Pallas-Triton kernel on the train
    step's attention (forward plus backward) at every Swin stage and the
    ViT (PERF.md).
    """
    s = jnp.einsum("...qhd,...khd->...hqk", q, k, preferred_element_type=jnp.float32)
    s = s * scale
    if bias is not None:
        s = s + bias
    p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
    return jnp.einsum(
        "...hqk,...khd->...qhd", p, v, preferred_element_type=jnp.float32
    ).astype(q.dtype)


def multi_head_attention(q, k, v, num_heads: int, scale: float) -> jax.Array:
    """Attention over ``[B, N, C]`` projections with heads packed in the
    columns; returns ``[B, Nq, C]``."""
    b, n, c = q.shape
    split = lambda y: y.reshape(b, y.shape[1], num_heads, c // num_heads)
    return dot_product_attention(split(q), split(k), split(v), scale).reshape(b, n, c)


class MultiHeadAttention(nn.Module):
    """Q/KV multi-head attention with separate query and key/value inputs.

    Generalizes the reference's ``MIAttention`` (``fusion_net.py:258-285``,
    self-attention when ``q is kv``) and the ``nn.MultiheadAttention`` inside
    ``AttentionModel`` (``fusion_net.py:550-578``).
    """

    dim: int
    num_heads: int
    qkv_bias: bool = True
    dropout: float = 0.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, q_in, k_in, v_in, *, deterministic: bool = True):
        scale = (self.dim // self.num_heads) ** -0.5

        def proj(name, x):
            from edrl.parallel.mesh import batch_constraint

            # Anchor the projection (and its cotangent) to batch-over-'data'
            # sharding: under TP the q/k/v Dense kernels are column-sharded,
            # so their outputs arrive channel-sharded, and the head-split
            # reshape below would otherwise hit the partitioner's
            # "Involuntary full rematerialization" last resort.  No-op
            # without a mesh context.
            return batch_constraint(
                nn.Dense(
                    self.dim, use_bias=self.qkv_bias, dtype=self.dtype,
                    name=name,
                )(x)
            )

        q = proj("q", q_in)  # [B, Nq, C], heads packed in columns
        k = proj("k", k_in)
        v = proj("v", v_in)
        out = multi_head_attention(q, k, v, self.num_heads, scale)
        out = nn.Dense(self.dim, dtype=self.dtype, name="proj")(out)
        out = nn.Dropout(self.dropout)(out, deterministic=deterministic)
        return out


class SelfAttentionBlock(nn.Module):
    """Pre-LN transformer encoder block (attention + MLP with residuals)."""

    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True):
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = MultiHeadAttention(
            self.dim, self.num_heads, dropout=self.dropout, dtype=self.dtype
        )(h, h, h, deterministic=deterministic)
        x = x + h
        h = nn.LayerNorm(dtype=self.dtype)(x)
        h = Mlp(
            int(self.dim * self.mlp_ratio),
            self.dim,
            dropout=self.dropout,
            dtype=self.dtype,
        )(h, deterministic=deterministic)
        return x + h
