"""The plain XLA paths the models run, against float64 numpy references.

Swin window attention (relative bias, with and without the shift mask, at
each stage's window/head shape), ViT attention, LayerNorm, the MLP block and
MK-MMD, value and (for attention) gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.models import layers, nn, swin2d
from edrl.ops import mk_mmd


def _np_attention(q, k, v, scale, bias, do):
    """float64 forward and backward of softmax(q k^T * scale + bias) v.

    q, k, v, do: [G, N, D]; bias: [G, N, N].  Returns o, dq, dk, dv, dbias."""
    s = np.einsum("gqd,gkd->gqk", q, k) * scale + bias
    s -= s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("gqk,gkd->gqd", p, v)
    dv = np.einsum("gqk,gqd->gkd", p, do)
    dp = np.einsum("gqd,gkd->gqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = np.einsum("gqk,gkd->gqd", ds, k) * scale
    dk = np.einsum("gqk,gqd->gkd", ds, q) * scale
    return o, dq, dk, dv, ds


# (windows per image, heads) of the four Swin stages at 384^2, window 12.
@pytest.mark.parametrize(
    "nw, heads, shifted",
    [(64, 1, False), (64, 1, True), (16, 2, False), (16, 2, True),
     (4, 4, False), (4, 4, True), (1, 8, False)],
)
def test_window_attention_matches_float64(nw, heads, shifted, rng):
    b, window, d = 1, 12, 16
    n = window * window
    scale = d**-0.5
    qkv = rng.normal(size=(b, nw, n, 3 * heads * d)).astype(np.float32)
    bias = rng.normal(size=(heads, n, n)).astype(np.float32)
    do = rng.normal(size=(b, nw, n, heads * d)).astype(np.float32)
    grid = int(round(nw**0.5)) * window
    mask = swin2d._shift_attn_mask(grid, window, window // 2) if shifted else None

    def f(qkv, bias):
        return swin2d.window_attention(qkv, bias, mask, heads, scale)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(do))

    # [B, nW, N, 3, H, D] -> [B*nW*H, N, D]
    x = qkv.astype(np.float64).reshape(b, nw, n, 3, heads, d)
    g = lambda y: y.transpose(0, 1, 3, 2, 4).reshape(-1, n, d)
    full = np.broadcast_to(bias[None, None], (b, nw, heads, n, n)).astype(np.float64)
    if mask is not None:
        full = full + mask[None, :, None]
    do64 = do.astype(np.float64).reshape(b, nw, n, heads, d)
    o, dq, dk, dv, ds = _np_attention(
        g(x[..., 0, :, :]), g(x[..., 1, :, :]), g(x[..., 2, :, :]), scale,
        full.reshape(-1, n, n), g(do64),
    )
    ungroup = lambda y: y.reshape(b, nw, heads, n, d).transpose(0, 1, 3, 2, 4).reshape(b, nw, n, heads * d)
    np.testing.assert_allclose(np.asarray(out), ungroup(o), atol=2e-5)
    want = np.concatenate([ungroup(dq), ungroup(dk), ungroup(dv)], axis=-1)
    np.testing.assert_allclose(np.asarray(dqkv), want, atol=5e-5)
    want_dbias = ds.reshape(b, nw, heads, n, n).sum(axis=(0, 1))
    np.testing.assert_allclose(np.asarray(dbias), want_dbias, atol=5e-4)


@pytest.mark.parametrize("heads, d", [(6, 16), (12, 8), (1, 32)])
def test_vit_attention_matches_float64(heads, d, rng):
    b, n = 2, 216
    scale = d**-0.5
    q, k, v, do = (rng.normal(size=(b, n, heads * d)).astype(np.float32) for _ in range(4))

    def f(q, k, v):
        return layers.multi_head_attention(q, k, v, heads, scale)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    g = lambda y: y.astype(np.float64).reshape(b, n, heads, d).transpose(0, 2, 1, 3).reshape(-1, n, d)
    ref = _np_attention(g(q), g(k), g(v), scale, 0.0, g(do))
    ungroup = lambda y: y.reshape(b, heads, n, d).transpose(0, 2, 1, 3).reshape(b, n, heads * d)
    np.testing.assert_allclose(np.asarray(out), ungroup(ref[0]), atol=2e-5)
    for got, want in zip(grads, ref[1:4]):
        np.testing.assert_allclose(np.asarray(got), ungroup(want), atol=5e-5)


@pytest.mark.parametrize("width", [128, 256, 512, 768, 1024])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm_matches_numpy(width, dtype, rng):
    x = (rng.normal(size=(3, 7, width)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(width,)).astype(np.float32)
    bias = rng.normal(size=(width,)).astype(np.float32)
    ln = nn.LayerNorm(dtype=dtype)
    out = ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, dtype))
    assert out.dtype == dtype
    xd = np.asarray(jnp.asarray(x, dtype), np.float64)
    mu = xd.mean(-1, keepdims=True)
    var = xd.var(-1, keepdims=True)
    want = (xd - mu) / np.sqrt(var + 1e-6) * scale + bias
    tol = 1e-4 if dtype == jnp.float32 else 6e-2
    np.testing.assert_allclose(np.asarray(out, np.float64), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("width, ratio", [(128, 4), (768, 4), (1024, 3)])
def test_mlp_matches_numpy(width, ratio, rng):
    x = rng.normal(size=(2, 5, width)).astype(np.float32)
    mlp = layers.Mlp(width * ratio, width)
    variables = mlp.init(jax.random.key(0), jnp.asarray(x))
    p = variables["params"]
    assert set(p) == {"Dense_0", "Dense_1"}
    out = mlp.apply(variables, jnp.asarray(x))
    w1, b1 = (np.asarray(p["Dense_0"][k], np.float64) for k in ("kernel", "bias"))
    w2, b2 = (np.asarray(p["Dense_1"][k], np.float64) for k in ("kernel", "bias"))
    h = x.astype(np.float64) @ w1 + b1
    # tanh-approximated GELU (jax.nn.gelu's default).
    h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h**3)))
    np.testing.assert_allclose(np.asarray(out), h @ w2 + b2, atol=1e-4, rtol=1e-4)


def _np_mk_mmd(src, tgt, kernel_mul=2.0, kernel_num=5):
    total = np.concatenate([src, tgt]).astype(np.float64)
    n = total.shape[0]
    d2 = ((total[:, None, :] - total[None, :, :]) ** 2).sum(-1)
    ls = d2.sum() / (n * n - n) / kernel_mul ** (kernel_num // 2)
    k = sum(np.exp(-d2 / (ls * kernel_mul**i)) for i in range(kernel_num))
    ns = src.shape[0]
    xx, yy = k[:ns, :ns].mean(), k[ns:, ns:].mean()
    xy, yx = k[:ns, ns:].mean(), k[ns:, :ns].mean()
    return abs(xx + yy - xy - yx)


@pytest.mark.parametrize("batch, width", [(4, 64), (8, 256), (16, 1024), (32, 3072)])
def test_mk_mmd_matches_numpy(batch, width, rng):
    src = rng.normal(size=(batch, width)).astype(np.float32)
    tgt = (rng.normal(size=(batch, width)) + 0.3).astype(np.float32)
    got = float(mk_mmd(jnp.asarray(src), jnp.asarray(tgt)))
    assert got == pytest.approx(_np_mk_mmd(src, tgt), rel=1e-3, abs=1e-5)


@pytest.mark.parametrize("window", [4, 7, 12])
def test_relative_bias_onehot_matmul_equals_table_gather(window, rng):
    heads = 3
    table = rng.normal(size=((2 * window - 1) ** 2, heads)).astype(np.float32)
    got = swin2d._rel_bias_from_table(jnp.asarray(table), window, heads, jnp.float32)
    idx = swin2d._relative_position_index(window)
    want = table[idx.reshape(-1)].reshape(window**2, window**2, heads).transpose(2, 0, 1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


@pytest.mark.parametrize("grid, window", [(8, 4), (24, 12), (96, 12)])
def test_shift_mask_blocks_exactly_the_cross_region_pairs(grid, window):
    shift = window // 2
    mask = swin2d._shift_attn_mask(grid, window, shift)
    # Brute force: label each pixel of the rolled map by its region, then
    # two tokens of a window may attend iff their labels match.
    def region(i):
        return 0 if i < grid - window else (1 if i < grid - shift else 2)

    labels = np.array([[3 * region(r) + region(c) for c in range(grid)] for r in range(grid)])
    nw = grid // window
    lab = labels.reshape(nw, window, nw, window).transpose(0, 2, 1, 3).reshape(nw * nw, -1)
    want = np.where(lab[:, :, None] == lab[:, None, :], 0.0, -1e9)
    np.testing.assert_array_equal(mask, want)


@pytest.mark.parametrize("differentiable", [True, False])
@pytest.mark.parametrize("width, k", [(800, 100), (1600, 100), (7, 7)])
def test_eprl_top_k_values_match_numpy(differentiable, width, k, rng):
    """Both top-k routes give numpy's k largest values, -inf masking included."""
    from edrl.models.eprl import _top_k_values

    x = rng.normal(size=(3, width)).astype(np.float32)
    x[:, ::3] = -np.inf
    got = np.asarray(_top_k_values(jnp.asarray(x), k, differentiable))
    np.testing.assert_array_equal(got, -np.sort(-x, axis=-1)[:, :k])
