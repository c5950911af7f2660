"""Swin-Transformer 2-D fundus backbone.

Reconstructs the missing ``Models.fundus_swin_network.build_model`` backbone
(SURVEY.md section 2.8 item 1) from its dimensional contract: over a 384^2
fundus photograph it must produce final-stage tokens ``[B, 144, 1024]``
(12x12 grid, dim 1024 — pinned by ``EPRL(x_dim=1024)`` at
``fusion_net.py:783,817`` and ``mlp_2d: Linear(144, C)`` at
``fusion_net.py:95``) plus a pooled vector.  The default configuration is a
Swin-B: patch 4, embed 128, depths (2,2,6,2), heads (4,8,16,32), window 12.

Design:
- window partition/merge are pure reshape/transposes with static shapes;
- the shifted-window attention mask is precomputed at trace time with numpy;
- attention runs batched over ``B * num_windows``, one large batched matmul
  per block;
- bf16 compute / f32 softmax & accumulation via ``layers.dot_product_attention``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp
import numpy as np

from edrl.models.layers import Mlp, dot_product_attention

Dtype = Any


def _relative_position_index(window: int) -> np.ndarray:
    """Static [w*w, w*w] index into the (2w-1)^2 relative-bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    )  # [2, w, w]
    coords = coords.reshape(2, -1)  # [2, w*w]
    rel = coords[:, :, None] - coords[:, None, :]  # [2, w*w, w*w]
    rel = rel.transpose(1, 2, 0)  # [w*w, w*w, 2]
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # [w*w, w*w]


def _rel_bias_from_table(table, window: int, num_heads: int, dtype) -> jax.Array:
    """[ (2w-1)^2, heads ] learned table -> [heads, n, n] additive bias (f32).

    Bias lookup as a static one-hot matmul rather than a gather: the
    gather's backward is a scatter-add with massively repeated indices
    (n^2=20736 rows -> 529 table slots); the matmul's transpose is a
    dense matmul, and the one-hot literal is shared across blocks by XLA
    constant CSE.
    One-hot/table operands follow the module dtype (not hard-coded bf16): in
    f32 mode the learned table and its gradient stay exact, matching
    the old gather path; the one-hot is exact in either dtype.
    """
    n = window * window
    idx = _relative_position_index(window)
    onehot = np.zeros((n * n, table.shape[0]), np.float32)
    onehot[np.arange(n * n), idx.reshape(-1)] = 1.0
    bias = jax.lax.dot_general(
        jnp.asarray(onehot, dtype),
        table.astype(dtype),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(n, n, num_heads)
    return bias.transpose(2, 0, 1)  # [heads, n, n]


def _shift_attn_mask(grid: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask [num_windows, w*w, w*w] for shifted windows."""
    img = np.zeros((grid, grid), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nw = grid // window
    img = img.reshape(nw, window, nw, window).transpose(0, 2, 1, 3)
    img = img.reshape(-1, window * window)  # [num_windows, w*w]
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def window_partition(x: jax.Array, window: int) -> jax.Array:
    """[B, H, W, C] -> [B, nW, window*window, C].

    Persistent windowed layout: tokens stay in this layout across a whole
    stage (LayerNorm/MLP/residuals are per-token, so only shifted blocks ever
    leave it).
    """
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // window) * (w // window), window * window, c)


def window_merge(x: jax.Array, window: int, h: int, w: int) -> jax.Array:
    """[B, nW, window*window, C] -> [B, H, W, C]."""
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _shift_windows(xw: jax.Array, window: int, grid: int, shift: int) -> jax.Array:
    """Re-window [B, nW, N, C] after rolling the implied feature map by
    ``shift`` (negative = the Swin forward shift).  merge -> roll ->
    partition is a single token permutation; XLA fuses the chain into one
    copy, vs. the two separate partition/merge transposes of the per-block
    layout."""
    x = window_merge(xw, window, grid, grid)
    x = jnp.roll(x, shift=(shift, shift), axis=(1, 2))
    return window_partition(x, window)


def window_attention(
    qkv: jax.Array,
    bias: jax.Array,
    mask: Optional[np.ndarray],
    num_heads: int,
    scale: float,
) -> jax.Array:
    """Attention inside each window from the packed qkv projection.

    qkv: ``[B, nW, N, 3C]`` (columns: q heads | k heads | v heads); bias:
    ``[heads, N, N]`` relative-position bias; mask: ``[nW, N, N]`` additive
    shift mask or None.  Returns ``[B, nW, N, C]``.
    """
    b, nw, n, c3 = qkv.shape
    head_dim = c3 // (3 * num_heads)
    # [B, nW, N, 3, H, D] views of the packed columns: no transposes.
    qkv = qkv.reshape(b, nw, n, 3, num_heads, head_dim)
    if mask is not None:
        bias = bias + jnp.asarray(mask)[:, None]  # [nW, H, N, N]
    return dot_product_attention(
        qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :], scale, bias=bias
    ).reshape(b, nw, n, c3 // 3)


class WindowAttention(nn.Module):
    dim: int
    window: int
    num_heads: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask: Optional[np.ndarray] = None):
        """x: [B, nW, w*w, C]; mask: [nW, w*w, w*w] additive or None."""
        scale = (self.dim // self.num_heads) ** -0.5
        qkv = nn.Dense(self.dim * 3, dtype=self.dtype, name="qkv")(x)

        table = self.param(
            "rel_bias_table",
            nn.initializers.truncated_normal(0.02),
            ((2 * self.window - 1) ** 2, self.num_heads),
        )
        bias = _rel_bias_from_table(
            table, self.window, self.num_heads, self.dtype
        )  # [heads, n, n]
        out = window_attention(qkv, bias, mask, self.num_heads, scale)
        return nn.Dense(self.dim, dtype=self.dtype, name="proj")(out)


class SwinBlock(nn.Module):
    dim: int
    grid: int
    num_heads: int
    window: int
    shift: int
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    dtype: Dtype = jnp.float32
    remat_attention: bool = True

    @nn.compact
    def __call__(self, xw, *, deterministic: bool = True):
        """xw: [B, nW, N, C] in the persistent windowed layout.

        Non-shifted blocks run with zero layout copies (LN, qkv Dense,
        attention, proj, MLP are all windowed-layout-native); shifted blocks
        pay one merge->roll->partition permutation on each side of the
        attention.
        """
        window = min(self.window, self.grid)
        shift = self.shift if window < self.grid else 0

        shortcut = xw
        h = nn.LayerNorm(dtype=self.dtype)(xw)
        if shift > 0:
            h = _shift_windows(h, window, self.grid, -shift)
            mask = _shift_attn_mask(self.grid, window, shift)
        else:
            mask = None
        attn = WindowAttention(self.dim, window, self.num_heads, dtype=self.dtype)

        def attend(mdl, xin):
            return mdl(xin, mask=mask)

        if self.remat_attention:
            # Rematerialize only the attention: its [G, N, N] f32 score
            # tensors dominate activation memory (the MLP activations are
            # cheap to keep), so this buys most of full-remat's memory saving
            # at a fraction of the recompute.
            attend = nn.remat(attend)
        h = attend(attn, h)
        if shift > 0:
            h = _shift_windows(h, window, self.grid, shift)
        xw = shortcut + h
        h2 = nn.LayerNorm(dtype=self.dtype)(xw)
        h2 = Mlp(
            int(self.dim * self.mlp_ratio),
            self.dim,
            self.dropout,
            dtype=self.dtype,
        )(h2, deterministic=deterministic)
        return xw + h2


class PatchMerging(nn.Module):
    dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        # Strided slices + channel concat instead of a 6-D reshape/transpose.
        # The flattened feature order (sh, sw, c) matches the reshape path.
        x = jnp.concatenate(
            [x[:, i::2, j::2, :] for i in (0, 1) for j in (0, 1)], axis=-1
        )
        x = nn.LayerNorm(dtype=self.dtype)(x)
        return nn.Dense(2 * self.dim, use_bias=False, dtype=self.dtype)(x)


class SwinTransformer2D(nn.Module):
    """Returns ``(tokens [B, N, C_final], pooled [B, C_final])``.

    With the default (image 384, patch 4, embed 128, 4 stages) this lands on
    exactly ``[B, 144, 1024]`` — the contract of the missing reference
    backbone (``fusion_net.py:796,884``).
    """

    img_size: int = 384
    patch_size: int = 4
    embed_dim: int = 128
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (4, 8, 16, 32)
    window: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    dtype: Dtype = jnp.float32
    remat: bool = False
    remat_attention: bool = True

    @nn.compact
    def __call__(self, x, *, deterministic: bool = True) -> Tuple[jax.Array, jax.Array]:
        """x: [B, H, W, 3] (NHWC, values in [0, 1])."""
        b, h, w, _ = x.shape
        p = self.patch_size
        x = x.astype(self.dtype)
        # Patchify as reshape + one dense matmul; the channel dim folds into
        # the innermost patch axis so no intermediate carries a size-3 minor
        # dimension.
        x = x.reshape(b, h // p, p, w // p, p * x.shape[-1])
        x = x.transpose(0, 1, 3, 2, 4).reshape(b, h // p, w // p, p * p * 3)
        x = nn.Dense(self.embed_dim, dtype=self.dtype, name="patch_embed")(x)
        x = nn.LayerNorm(dtype=self.dtype)(x)

        grid = h // p
        dim = self.embed_dim
        block_cls = SwinBlock
        if self.remat:
            block_cls = nn.remat(SwinBlock)
        for stage, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            # Partition once per stage: blocks run in the windowed layout.
            window = min(self.window, grid)
            xw = window_partition(x, window)
            for i in range(depth):
                xw = block_cls(
                    dim=dim,
                    grid=grid,
                    num_heads=heads,
                    window=self.window,
                    shift=0 if i % 2 == 0 else self.window // 2,
                    mlp_ratio=self.mlp_ratio,
                    dropout=self.dropout,
                    dtype=self.dtype,
                    remat_attention=self.remat_attention and not self.remat,
                )(xw, deterministic=deterministic)
            x = window_merge(xw, window, grid, grid)
            if stage != len(self.depths) - 1:
                x = PatchMerging(dim=dim, dtype=self.dtype)(x)
                dim *= 2
                grid //= 2

        x = nn.LayerNorm(dtype=self.dtype, name="final_norm")(x)
        tokens = x.reshape(b, grid * grid, dim)
        pooled = jnp.mean(tokens, axis=1)
        return tokens, pooled
