"""Device-side dual-view noise construction (jittable).

The reference builds the low/high corruption views on the host
(``code/data_harvard.py:701-814``), which (a) doubles host->device transfer
and (b) serializes noise generation on CPU workers.  When
``DataConfig.device_noise`` is on, the loader ships ONE clean batch and the
jitted train/eval step materializes both views on the device with the step's
PRNG key — same distributions (additive Gaussian clipped to [0,1],
salt-and-pepper by pixel), half the transfer, zero host noise cost.

Semantics note: with device noise the two views share one augmentation draw
and differ only by corruption; the reference drew augmentations per view.
The self-distillation target (pull noise views together, ``fusion_train.py:
198``) is unchanged — if per-view augmentation is wanted, set
``device_noise=False`` for the host path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from edrl.config import NoiseConfig


def _gaussian(x: jax.Array, sigma: float, key: jax.Array) -> jax.Array:
    if sigma <= 0.0:
        return x
    noisy = x + sigma * jax.random.normal(key, x.shape, dtype=x.dtype)
    return jnp.clip(noisy, 0.0, 1.0)


def _salt_pepper(x: jax.Array, amount: float, key: jax.Array) -> jax.Array:
    if amount <= 0.0:
        return x
    # Corrupt whole pixels: share the mask across the trailing channel dim.
    u = jax.random.uniform(key, x.shape[:-1] + (1,))
    x = jnp.where(u < amount, jnp.ones_like(x), x)
    x = jnp.where(u > 1.0 - amount, jnp.zeros_like(x), x)
    return x


def _corrupt(fundus, oct_vol, cfg: NoiseConfig, g_sigma, sp_amount, key):
    kf, ko, kf2, ko2 = jax.random.split(key, 4)
    if cfg.condition != "noise":
        return fundus, oct_vol
    if cfg.condition_name == "Gaussian":
        return _gaussian(fundus, g_sigma, kf), _gaussian(oct_vol, g_sigma, ko)
    if cfg.condition_name == "SaltPepper":
        return _salt_pepper(fundus, sp_amount, kf), _salt_pepper(oct_vol, sp_amount, ko)
    f = _salt_pepper(_gaussian(fundus, g_sigma, kf), sp_amount, kf2)
    o = _salt_pepper(_gaussian(oct_vol, g_sigma, ko), sp_amount, ko2)
    return f, o


def make_views_device(
    fundus: jax.Array,
    oct_vol: jax.Array,
    cfg: NoiseConfig,
    key: jax.Array,
) -> Dict[str, jax.Array]:
    """Clean [B,H,W,3] / [B,D,H,W,1] -> the four view arrays, on device."""
    k_low, k_high = jax.random.split(key)
    f_low, o_low = _corrupt(
        fundus, oct_vol, cfg, cfg.gaussian_low, cfg.salt_pepper_low, k_low
    )
    f_high, o_high = _corrupt(
        fundus, oct_vol, cfg, cfg.gaussian_high, cfg.salt_pepper_high, k_high
    )
    return {
        "fundus_low": f_low,
        "oct_low": o_low,
        "fundus_high": f_high,
        "oct_high": o_high,
    }


def make_low_view_device(
    fundus: jax.Array, oct_vol: jax.Array, cfg: NoiseConfig, key: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Eval-path low view only (``fusion_train.py:277`` parity)."""
    return _corrupt(fundus, oct_vol, cfg, cfg.gaussian_low, cfg.salt_pepper_low, key)
