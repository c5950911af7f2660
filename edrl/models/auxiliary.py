"""Auxiliary reference modules: complete the component inventory.

The reference constructs several modules that are off the active MedFusion
path (SURVEY.md section 2.1, defect ledger #12) but are part of its public
surface; they are rebuilt here so the framework covers the full inventory and
they remain usable for ablations:

- ``MIAttentionFusion`` — tri-input attention (``fusion_net.py:288-343``):
  separate qkv for fundus / OCT / global streams, the global query attends
  over the concatenated keys/values, LayerNorm output.
- ``PID`` — per-modality self-attention + average-pool to per-modality
  vectors (``fusion_net.py:405-439``).
- ``MIEstimator`` — CLUB-based MI upper bound across (fundus, oct, global)
  (``fusion_net.py:482-498``), on top of the functional CLUB math in
  ``edrl.ops.club``.
- ``estimate_v`` — Student-t dof estimate from sample variance
  (``fusion_net.py:121-125``).
"""

from __future__ import annotations

from typing import Any, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.models.layers import MultiHeadAttention
from edrl.ops.club import club_learning_loss, club_mean_mi

Dtype = Any


def estimate_v(z_proxy: jax.Array, epsilon: float = 1e-8) -> jax.Array:
    """Student-t degrees-of-freedom estimate, clamped at 2
    (``fusion_net.py:121-125``)."""
    var = jnp.var(z_proxy, axis=1)
    v = 2.0 * var / (var - 1.0 + epsilon)
    return jnp.maximum(v, 2.0)


class MIAttentionFusion(nn.Module):
    """Tri-input attention: global queries attend over concatenated
    keys/values (``fusion_net.py:309-343``).

    Reference quirk preserved as-executed: the key concat order is
    (general, **3d**, **2d**) while the value order is (general, **2d**,
    **3d**) (``fusion_net.py:334,338``) — each cross-modal key is paired
    with the OTHER modality's value.  Token counts differ (144 vs 216), so
    positions don't even correspond 1:1; this looks like a reference bug,
    but the module is constructed-and-never-called there (ledger #12), so
    there is no executed behavior to diverge from and we keep the literal
    ordering."""

    dim_2d: int
    dim_3d: int
    dim_general: int
    num_heads: int = 8
    out_dim: int = 128
    dropout: float = 0.1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x_2d, x_3d, x_global, *, deterministic: bool = True):
        d = self.out_dim

        def qkv(x, name):
            h = nn.Dense(3 * d, dtype=self.dtype, name=name)(x)
            return jnp.split(h, 3, axis=-1)

        q2, k2, v2 = qkv(x_2d, "qkv_fundus")
        q3, k3, v3 = qkv(x_3d, "qkv_oct")
        qg, kg, vg = qkv(x_global, "qkv_general")

        keys = jnp.concatenate([kg, k3, k2], axis=1)
        vals = jnp.concatenate([vg, v2, v3], axis=1)
        out = MultiHeadAttention(
            d, self.num_heads, dropout=self.dropout, dtype=self.dtype, name="attn"
        )(qg, keys, vals, deterministic=deterministic)
        out = nn.Dropout(self.dropout)(out, deterministic=deterministic)
        return nn.LayerNorm(dtype=self.dtype)(out)


class PID(nn.Module):
    """Per-modality self-attention + avg-pool (``fusion_net.py:405-439``).

    Returns ``(x_2d_vec [B, embed_dim], x_3d_vec [B, embed_dim])`` — the
    reference pools over tokens after lifting the 3-D stream 768 -> 1024.
    """

    embed_dim: int = 1024
    embed_dim_3d: int = 768
    num_heads: int = 8
    dropout: float = 0.1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x_2d, x_3d, *, deterministic: bool = True) -> Tuple[jax.Array, jax.Array]:
        a2 = MultiHeadAttention(
            self.embed_dim, self.num_heads, dtype=self.dtype, name="self_attn_2d"
        )(x_2d, x_2d, x_2d, deterministic=deterministic)
        a3 = MultiHeadAttention(
            self.embed_dim_3d, self.num_heads, dtype=self.dtype, name="self_attn_3d"
        )(x_3d, x_3d, x_3d, deterministic=deterministic)
        a3 = nn.relu(nn.Dense(self.embed_dim, dtype=self.dtype, name="lift")(a3))
        return jnp.mean(a2, axis=1), jnp.mean(a3, axis=1)


class CLUBMean(nn.Module):
    """CLUB estimator head: MLP q(y|x) mean + the functional MI bound
    (``fusion_net.py:501-542``)."""

    y_dim: int
    hidden: int = 512
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x_samples, y_samples, *, mode: str = "mi"):
        mu = nn.Dense(self.hidden, dtype=self.dtype, name="p_mu1")(x_samples)
        mu = nn.relu(mu)
        mu = nn.Dense(self.y_dim, dtype=self.dtype, name="p_mu2")(mu)
        if mode == "mi":
            return club_mean_mi(mu, y_samples)
        return club_learning_loss(mu, y_samples)


class MIEstimator(nn.Module):
    """MI bound across (fundus, oct) and their concat vs the global embed
    (``fusion_net.py:482-498``)."""

    dim: int = 128

    @nn.compact
    def __call__(self, histology, pathways, global_embed, *, mode: str = "mi"):
        mi = CLUBMean(y_dim=self.dim, name="mimin")(histology, pathways, mode=mode)
        mi = mi + CLUBMean(y_dim=self.dim, name="mimin_glob")(
            jnp.concatenate([histology, pathways], axis=1), global_embed, mode=mode
        )
        return mi
