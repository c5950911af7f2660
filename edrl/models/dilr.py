"""DILR — Disentangled representation Learning fusion head.

Rebuild of ``DILR`` + ``AttentionModel`` (``fusion_net.py:550-768``), the
active fusion head of EDRL:

- fundus tokens ``[B, N1, 1024]`` and OCT tokens ``[B, N2, 768]`` are
  projected to 2048 and split in half into (unique, common) blocks
  (``common_ratio=0.5``, ``fusion_net.py:721-728``);
- the unique halves are attended with EPRL-guided queries, the common halves
  cross-attended with the PoE shared features (``:730-743``);
- a Barlow-Twins-style cross-correlation loss pushes the common block toward
  identity correlation and the unique block toward zero (``:656-677``);
- output is ``concat(unique1, common1 + common2, unique2) -> [B, 3072]``
  (``:762-766``).

Defect-ledger decisions:
- #13 (new): the reference's guided-feature projectors are
  ``Linear(1024, 1024)`` but receive ``[B, num_classes, 256]`` EPRL proxies —
  a shape mismatch that crashes as published.  Intent (a guided query for the
  unique-block attention) is preserved by flattening the proxies to
  ``[B, num_classes * z]`` and projecting to one 1024-d query token.
- The ``batch_size * 4`` correlation divisor (a 4-GPU leftover, ``:661``) is
  preserved as-executed.
- ``bt_loss_single`` (broken/dead, ``:680-691``) is not ported.

Distributed note: the batch-standardization and cross-correlation are
*global-batch* statistics; under jit-over-Mesh data parallelism XLA inserts
the collectives automatically (SURVEY.md section 2.7).
"""

from __future__ import annotations

from typing import Any, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.models.layers import MultiHeadAttention
from edrl.ops.correlation import barlow_block_loss

Dtype = Any


class AttentionModel(nn.Module):
    """MultiheadAttention + residual + LayerNorm + FFN(3x) + ReLU.

    Parity: ``fusion_net.py:550-578`` (q, k, v passed separately; residual is
    added to the *query* stream).
    """

    embed_dim: int
    num_heads: int
    dropout: float = 0.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, q, k, v, *, deterministic: bool = True):
        attn_out = MultiHeadAttention(
            self.embed_dim, self.num_heads, dropout=self.dropout, dtype=self.dtype
        )(q, k, v, deterministic=deterministic)
        x = nn.LayerNorm(dtype=self.dtype)(q + attn_out)
        ffn = nn.Dense(self.embed_dim * 3, dtype=self.dtype)(x)
        ffn = nn.relu(ffn)
        ffn = nn.Dense(self.embed_dim, dtype=self.dtype)(ffn)
        return nn.relu(x + ffn)


class DILR(nn.Module):
    fundus_dim: int = 1024
    oct_dim: int = 768
    feature_dim: int = 2048
    guided_in_dim: int = 512  # num_classes * z_dim from EPRL
    common_ratio: float = 0.5
    num_heads: int = 8
    off_diag_weight: float = 0.0051
    # The reference divides by the CONSTANT ``args.batch_size * 4``
    # (``fusion_net.py:661``, a 4-GPU Barlow-Twins leftover).  We keep the
    # x4 but use the RUNTIME batch: identical on the reference's own train
    # path (drop_last=True makes every batch full), and statistically
    # correct when the eval batch size differs — a constant divisor would
    # scale the correlation (hence the squared loss ~quadratically) by
    # (train_b / eval_b) at eval.  Deliberate fix, ledger-style.
    batch_divisor_mult: float = 4.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        fundus_tokens: jax.Array,  # [B, N1, fundus_dim]
        oct_tokens: jax.Array,  # [B, N2, oct_dim]
        shared_features: jax.Array,  # [B, half]
        fundus_guided: jax.Array,  # [B, guided_in_dim]
        oct_guided: jax.Array,  # [B, guided_in_dim]
        *,
        train: bool = True,
    ) -> Tuple[jax.Array, jax.Array]:
        half = self.feature_dim // 2  # common/unique split point (ratio 0.5)
        b = fundus_tokens.shape[0]
        det = not train

        y1 = nn.Dense(self.feature_dim, dtype=self.dtype, name="projector1")(
            fundus_tokens.astype(self.dtype)
        )
        y2 = nn.Dense(self.feature_dim, dtype=self.dtype, name="projector2")(
            oct_tokens.astype(self.dtype)
        )
        # Split: first half "unique", second half "common" (``:725-728``).
        y1_unique, y1_common = y1[..., :half], y1[..., half:]
        y2_unique, y2_common = y2[..., :half], y2[..., half:]

        # Guided queries (defect fix #13: flatten proxies -> one query token).
        fq = nn.Dense(half, dtype=self.dtype, name="guided_projector1")(
            fundus_guided.astype(self.dtype)
        )[:, None, :]
        oq = nn.Dense(half, dtype=self.dtype, name="guided_projector2")(
            oct_guided.astype(self.dtype)
        )[:, None, :]

        y1_uni = AttentionModel(half, self.num_heads, dtype=self.dtype, name="self_attn1")(
            fq, y1_unique, y1_unique, deterministic=det
        )
        y2_uni = AttentionModel(half, self.num_heads, dtype=self.dtype, name="self_attn2")(
            oq, y2_unique, y2_unique, deterministic=det
        )
        y1_uni = jnp.mean(y1_uni, axis=1)  # [B, half]
        y2_uni = jnp.mean(y2_uni, axis=1)

        shared = nn.Dense(half, dtype=self.dtype, name="shared_projector")(
            shared_features.astype(self.dtype)
        )[:, None, :]
        y1_com = AttentionModel(half, self.num_heads, dtype=self.dtype, name="cross_attn1")(
            shared, y1_common, y1_common, deterministic=det
        )[:, 0]
        y2_com = AttentionModel(half, self.num_heads, dtype=self.dtype, name="cross_attn2")(
            shared, y2_common, y2_common, deterministic=det
        )[:, 0]

        # Reassemble [common | unique] (``:746-747``).
        y1_full = jnp.concatenate([y1_com, y1_uni], axis=1)  # [B, 2048]
        y2_full = jnp.concatenate([y2_com, y2_uni], axis=1)

        # Affine-free batch norm (``:653-654,757-758``); momentum 0.9 ==
        # torch BatchNorm1d's default 0.1 (the module layer's default 0.99 would track
        # the running stats that standardize the eval-path features 10x
        # slower than the reference).
        z1 = nn.BatchNorm(
            use_running_average=det, use_bias=False, use_scale=False, name="bn1",
            momentum=0.9, dtype=jnp.float32,
        )(y1_full.astype(jnp.float32))
        z2 = nn.BatchNorm(
            use_running_average=det, use_bias=False, use_scale=False, name="bn2",
            momentum=0.9, dtype=jnp.float32,
        )(y2_full.astype(jnp.float32))

        loss, _, _ = barlow_block_loss(
            z1,
            z2,
            common_dim=int(self.common_ratio * self.feature_dim),
            batch_divisor=float(b) * self.batch_divisor_mult,
            off_diag_weight=self.off_diag_weight,
        )

        # combined = [bn'd unique1 | raw common1+common2 | bn'd unique2]
        # (``fusion_net.py:762-766``) -> [B, 3072].
        combined = jnp.concatenate(
            [z1[:, half:], (y1_com + y2_com).astype(jnp.float32), z2[:, half:]], axis=1
        )
        return combined, loss
