"""3-D Vision Transformer OCT backbone (UNETR-style encoder).

Reconstructs the missing ``Models.unetr.UNETR_base_3DNet`` (SURVEY.md
section 2.8 item 2) from its dimensional contract: over a 96^3 OCT volume it
must produce tokens ``[B, 216, 768]`` (6^3 patch grid at patch size 16 —
pinned by ``EPRL(x_dim=768)`` at ``fusion_net.py:784,820`` and
``mlp_3d: Linear(216, C)`` at ``fusion_net.py:96``) plus a pooled vector.

The encoder is a standard ViT trunk (the part of UNETR the reference actually
consumes — it never uses the decoder): 3-D patchify, learned positional
embedding, 12 pre-LN encoder blocks, final LayerNorm.

Patchify is reshape + one dense matmul; 216-token attention is small, so the
whole trunk is one chain of large batched matmuls; bf16 compute / f32
accumulation.
"""

from __future__ import annotations

from typing import Any, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.models.layers import SelfAttentionBlock

Dtype = Any


class ViT3D(nn.Module):
    """Returns ``(tokens [B, N, dim], pooled [B, dim])`` for [B, D, H, W, C] input."""

    volume_size: int = 96
    patch_size: int = 16
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    in_channels: int = 1
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True) -> Tuple[jax.Array, jax.Array]:
        b, d, h, w, c = x.shape
        p = self.patch_size
        x = x.astype(self.dtype)
        # 3-D patchify via reshape + dense.  The channel dim is folded into
        # the innermost patch axis (``p * c``) so no intermediate has a
        # size-``c`` (=1) minor dimension.
        x = x.reshape(b, d // p, p, h // p, p, w // p, p * c)
        x = x.transpose(0, 1, 3, 5, 2, 4, 6)
        x = x.reshape(b, (d // p) * (h // p) * (w // p), p * p * p * c)
        x = nn.Dense(self.dim, dtype=self.dtype, name="patch_embed")(x)

        n = x.shape[1]
        pos = self.param(
            "pos_embed", nn.initializers.truncated_normal(0.02), (1, n, self.dim)
        )
        x = x + pos.astype(self.dtype)

        block_cls = SelfAttentionBlock
        if self.remat:
            block_cls = nn.remat(SelfAttentionBlock)
        for _ in range(self.depth):
            x = block_cls(
                dim=self.dim,
                num_heads=self.num_heads,
                mlp_ratio=self.mlp_ratio,
                dropout=self.dropout,
                dtype=self.dtype,
            )(x, deterministic=deterministic)

        x = nn.LayerNorm(dtype=self.dtype, name="final_norm")(x)
        pooled = jnp.mean(x, axis=1)
        return x, pooled
