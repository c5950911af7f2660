"""EPRL — Essence-Point Representation Learning.

Rebuild of ``fusion_net.py:63-255``: an MLP token encoder, learnable
per-class Gaussian *proxies*, sampled proxy points, token<->proxy cosine
attention, and a proxy contrast loss over top-k attention scores.  Train mode
indexes proxies with ground-truth labels (``:220-243``); eval mode derives
confidence-blended pseudo-labels (``:152-218``) and adds an entropy
regularizer.

jit-safe rewrites of the reference's data-dependent constructs
(SURVEY.md "Hard parts"):

- The eval path's ``masked_select`` + boolean-mask reshapes become fixed-shape
  one-hot selects and an ``-inf``-masked top-k.
- The reference thresholds pseudo-label confidence and *filters samples*, but
  then scatters with full-batch indices — which only runs when every sample
  passes (else it crashes, defect ledger; as-executed pseudo-label ==
  argmax of the blended distribution).  We use the argmax pseudo-label for
  every sample, which reproduces the only behavior the reference can execute.
- Train-mode shapes were coupled to a fixed ``batch_size`` (``:221``,
  forcing ``drop_last`` loaders); this module is batch-shape polymorphic
  (ledger #8).
- Eval-time noise came from ``torch.manual_seed`` replay (``:109-110``,
  ledger #11); here eval uses a fixed ``jax.random.key`` and train uses the
  ``'sample'`` RNG stream.

Normalization note: the reference calls ``F.normalize`` with default/explicit
``dim=1`` on ``[B, N, z]`` / ``[C, S, z]`` tensors, normalizing over tokens /
samples rather than features.  The evident intent is cosine similarity in
feature space ("cosine attention"); we normalize over the feature axis.
"""

from __future__ import annotations

from typing import Any, Optional

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.ops.distributions import entropy_regularization

Dtype = Any


def _l2_normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    norm = jnp.sqrt(jnp.sum(jnp.square(x), axis=axis, keepdims=True))
    return x / jnp.maximum(norm, eps)


def _top_k_values(x: jax.Array, k: int, differentiable: bool) -> jax.Array:
    """The ``k`` largest values along the last axis, largest first.

    ``lax.top_k`` where a gradient flows: its backward scatters into ``k``
    entries.  Otherwise a descending sort, which gives the same values: the
    GPU compiler rejects a TopK whose indices are unused once the program is
    partitioned over a device mesh (hlo verifier, after topk-decomposer).
    """
    if differentiable:
        return jax.lax.top_k(x, k)[0]
    return -jnp.sort(-x, axis=-1)[..., :k]


class EPRL(nn.Module):
    """Returns ``(mu [B, C, z], sigma [B, C, z], proxy_loss, z, entropy_loss)``."""

    x_dim: int
    num_tokens: int
    z_dim: int = 256
    num_classes: int = 2
    sample_num: int = 800  # proxy samples S (``fusion_net.py:790``)
    topk: int = 100  # ``self_topk`` (``fusion_net.py:199,236``)
    threshold: float = 0.5  # pseudo-label confidence gate (``fusion_net.py:153``)
    dropout: float = 0.2
    eval_seed: int = 1  # reference ``seed=1`` (``fusion_net.py:792``)
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        y: Optional[jax.Array] = None,
        *,
        train: bool = True,
        eps: Optional[jax.Array] = None,  # [C, S, z] override (tests/ablations)
    ):
        b, n, _ = x.shape
        c, s, z_dim = self.num_classes, self.sample_num, self.z_dim
        det = not train
        # x_dim/num_tokens pin the backbone contract ([B,144,1024] fundus /
        # [B,216,768] OCT, ``fusion_net.py:95-96,783-784``).  The Dense
        # layers infer their in-dims from the runtime input, so enforce the
        # declared shapes here — a silent mismatch would otherwise train a
        # differently-shaped model than configured.
        if x.shape[-1] != self.x_dim or n != self.num_tokens:
            raise ValueError(
                f"EPRL configured for [B, {self.num_tokens}, {self.x_dim}] "
                f"tokens, got {x.shape}"
            )

        # --- encoder MLP (x_dim -> 2z -> 2z -> z), ``fusion_net.py:82-90`` ---
        h = nn.Dense(2 * z_dim, dtype=self.dtype, name="enc1")(x.astype(self.dtype))
        h = nn.relu(h)
        h = nn.Dropout(self.dropout)(h, deterministic=det)
        h = nn.Dense(2 * z_dim, dtype=self.dtype, name="enc2")(h)
        h = nn.relu(h)
        h = nn.Dropout(self.dropout)(h, deterministic=det)
        z = nn.Dense(z_dim, dtype=self.dtype, name="enc3")(h)  # [B, N, z]

        # --- class proxies -> (mu, softplus sigma), ``fusion_net.py:99-119`` ---
        proxies = self.param(
            "proxies", nn.initializers.xavier_uniform(), (c, 2 * z_dim)
        )
        mu_proxy = proxies[:, :z_dim]
        sigma_proxy = nn.softplus(proxies[:, z_dim:])

        # --- sample proxy points, ``fusion_net.py:140-146`` ---
        if eps is None:
            if train:
                eps_key = self.make_rng("sample")
            else:
                eps_key = jax.random.key(self.eval_seed)
            eps = jax.random.normal(eps_key, (c, s, z_dim), dtype=jnp.float32)
        z_proxy = mu_proxy[:, None, :] + sigma_proxy[:, None, :] * eps  # [C, S, z]

        # --- cosine attention, token-mean: att[b,c,s] ---
        z_norm = _l2_normalize(z.astype(jnp.float32), axis=-1)
        p_norm = _l2_normalize(z_proxy, axis=-1)
        att = jnp.einsum(
            "bnd,csd->bcs", z_norm, p_norm, preferred_element_type=jnp.float32
        ) / float(n)

        # --- pseudo-label path, ``fusion_net.py:152-182`` ---
        # Constructed unconditionally so train-initialized params include it
        # (its outputs are dead code in train mode and DCE'd by XLA).
        att_mean = jnp.mean(att, axis=2)  # [B, C]
        # mean of normalized tokens over the feature axis -> [B, N]
        z_mean = jnp.mean(z_norm, axis=2)
        feat = jax.nn.softmax(z_mean, axis=1)
        # mlp over the token distribution: ReLU-Linear(N->C)-Dropout-ReLU
        feat = nn.relu(feat)
        feat = nn.Dense(c, dtype=jnp.float32, name="token_mlp")(feat)
        feat = nn.Dropout(self.dropout)(feat, deterministic=det)
        feat = nn.relu(feat)
        alpha = self.param("alpha", nn.initializers.constant(0.5), ())
        combined = alpha * jax.nn.softmax(att_mean, axis=1) + (1.0 - alpha) * feat

        entropy_loss = jnp.asarray(0.0, jnp.float32)
        if train:
            if y is None:
                raise ValueError("EPRL train mode requires labels y")
            labels = y
        else:
            labels = jnp.argmax(combined, axis=1)
            entropy_loss = entropy_regularization(combined)

        # --- proxy contrast loss over top-k attention, ``fusion_net.py:227-243`` ---
        one_hot = jax.nn.one_hot(labels, c, dtype=jnp.bool_)  # [B, C]
        pos = jnp.einsum("bcs,bc->bs", att, one_hot.astype(att.dtype))  # [B, S]
        neg_mask = jnp.repeat(~one_hot, s, axis=1)  # [B, C*S]
        neg = jnp.where(neg_mask, att.reshape(b, c * s), -jnp.inf)
        k_pos = min(self.topk, s)
        k_neg = min(self.topk, (c - 1) * s)
        pos_topk = _top_k_values(pos, k_pos, differentiable=train)
        neg_topk = _top_k_values(neg, k_neg, differentiable=train)
        proxy_loss = jnp.mean(
            jnp.exp(-jnp.mean(pos_topk, axis=1) + jnp.mean(neg_topk, axis=1))
        )

        # --- broadcast proxies per sample, ``fusion_net.py:210-213,246-250`` ---
        mu_rep = jnp.broadcast_to(mu_proxy[None], (b, c, z_dim))
        sigma_rep = jnp.broadcast_to(sigma_proxy[None], (b, c, z_dim))
        return mu_rep, sigma_rep, proxy_loss, z, entropy_loss
