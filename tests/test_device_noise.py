"""Device-side noise view construction: distribution + pipeline integration."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.config import NoiseConfig, tiny_test_config
from edrl.data import BatchLoader, SyntheticGammaDataset
from edrl.data.device_noise import make_low_view_device, make_views_device


@pytest.fixture
def clean(rng):
    fundus = jnp.asarray(rng.uniform(size=(4, 16, 16, 3)).astype(np.float32))
    oct_vol = jnp.asarray(rng.uniform(size=(4, 8, 8, 8, 1)).astype(np.float32))
    return fundus, oct_vol


class TestMakeViews:
    def test_default_low_clean_high_noisy(self, clean):
        fundus, oct_vol = clean
        views = make_views_device(fundus, oct_vol, NoiseConfig(), jax.random.key(0))
        np.testing.assert_array_equal(np.asarray(views["fundus_low"]), np.asarray(fundus))
        assert not np.array_equal(np.asarray(views["fundus_high"]), np.asarray(fundus))
        assert views["oct_high"].min() >= 0.0 and views["oct_high"].max() <= 1.0

    def test_gaussian_sigma_honored(self, clean):
        fundus, oct_vol = clean
        cfg = NoiseConfig(gaussian_low=0.1, gaussian_high=0.5)
        views = make_views_device(fundus, oct_vol, cfg, jax.random.key(0))
        d_low = np.std(np.asarray(views["fundus_low"]) - np.asarray(fundus))
        d_high = np.std(np.asarray(views["fundus_high"]) - np.asarray(fundus))
        assert 0.0 < d_low < d_high  # clipping shrinks both below sigma

    def test_salt_pepper_pixelwise(self, clean):
        fundus, oct_vol = clean
        cfg = NoiseConfig(condition_name="SaltPepper", salt_pepper_high=0.2)
        views = make_views_device(fundus, oct_vol, cfg, jax.random.key(0))
        f = np.asarray(views["fundus_high"])
        salted = np.all(f == 1.0, axis=-1)  # whole-pixel corruption
        assert salted.mean() == pytest.approx(0.2, abs=0.05)

    def test_normal_condition_passthrough(self, clean):
        fundus, oct_vol = clean
        cfg = NoiseConfig(condition="normal")
        views = make_views_device(fundus, oct_vol, cfg, jax.random.key(0))
        np.testing.assert_array_equal(np.asarray(views["fundus_high"]), np.asarray(fundus))

    def test_jittable_and_keyed(self, clean):
        fundus, oct_vol = clean
        f = jax.jit(lambda k: make_views_device(fundus, oct_vol, NoiseConfig(), k))
        v1 = f(jax.random.key(0))
        v2 = f(jax.random.key(1))
        v1b = f(jax.random.key(0))
        assert not np.array_equal(np.asarray(v1["fundus_high"]), np.asarray(v2["fundus_high"]))
        np.testing.assert_array_equal(
            np.asarray(v1["fundus_high"]), np.asarray(v1b["fundus_high"])
        )

    def test_low_view_eval_helper(self, clean):
        fundus, oct_vol = clean
        cfg = NoiseConfig(gaussian_low=0.3)
        f1, o1 = make_low_view_device(fundus, oct_vol, cfg, jax.random.key(5))
        f2, o2 = make_low_view_device(fundus, oct_vol, cfg, jax.random.key(5))
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))


class TestPipelineIntegration:
    def test_dataset_emits_clean_single_view(self):
        cfg = tiny_test_config(batch_size=4)
        data_cfg = dataclasses.replace(cfg.data, device_noise=True)
        ds = SyntheticGammaDataset(data_cfg, mode="train")
        s = ds.get(0, 0)
        assert set(s) == {"fundus", "oct", "label"}

    def test_loader_adds_oct_channel(self):
        cfg = tiny_test_config(batch_size=4)
        data_cfg = dataclasses.replace(cfg.data, device_noise=True)
        ds = SyntheticGammaDataset(data_cfg, mode="val")
        loader = BatchLoader(ds, 4, shuffle=False, num_workers=2)
        b = next(iter(loader.epoch(0)))
        assert b["oct"].ndim == 5 and b["oct"].shape[-1] == 1

    @pytest.mark.slow
    def test_fit_runs_with_device_noise(self):
        from edrl.train.trainer import fit

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, device_noise=True),
            train=dataclasses.replace(cfg.train, end_epochs=1, log_dir=""),
        )
        train_loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="train"), 4, num_workers=2
        )
        val_loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="val"), 4, shuffle=False, num_workers=2
        )
        state, result = fit(cfg, train_loader, val_loader, verbose=False)
        assert np.isfinite(result.train_history[0].loss)
        assert np.isfinite(result.val_history[0].loss)


class TestUint8Transport:
    def test_loader_emits_uint8(self):
        cfg = tiny_test_config(batch_size=4)
        data_cfg = dataclasses.replace(cfg.data, device_noise=True)
        ds = SyntheticGammaDataset(data_cfg, mode="val")
        loader = BatchLoader(ds, 4, shuffle=False, num_workers=2, uint8_transport=True)
        b = next(iter(loader.epoch(0)))
        assert b["fundus"].dtype == np.uint8
        assert b["oct"].dtype == np.uint8

    def test_dequantize_roundtrip(self):
        from edrl.train.trainer import _dequantize

        x = np.arange(256, dtype=np.uint8).reshape(16, 16)
        out = np.asarray(_dequantize(jnp.asarray(x)))
        np.testing.assert_allclose(out, x.astype(np.float32) / 255.0, rtol=1e-6)
        f = jnp.asarray(np.array([0.5], np.float32))
        np.testing.assert_array_equal(np.asarray(_dequantize(f)), np.asarray(f))

    @pytest.mark.slow
    def test_train_step_accepts_uint8_batch(self):
        import jax as _jax

        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        cfg = tiny_test_config(batch_size=4)
        _, state = init_state(cfg, 0)
        step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg)
        data_cfg = dataclasses.replace(cfg.data, device_noise=True)
        ds = SyntheticGammaDataset(data_cfg, mode="train")
        loader = BatchLoader(ds, 4, shuffle=False, num_workers=2, uint8_transport=True)
        batch = jax.tree_util.tree_map(jnp.asarray, next(iter(loader.epoch(0))))
        _, out = step(state, batch, _jax.random.key(0))
        assert np.isfinite(float(out["loss"]))


class TestDeviceAugment:
    def test_fundus_augment_shapes_and_range(self, rng):
        from edrl.data.device_augment import augment_fundus_batch

        x = jnp.asarray(rng.uniform(size=(4, 16, 16, 3)).astype(np.float32))
        out = augment_fundus_batch(x, jax.random.key(0))
        assert out.shape == x.shape
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0

    def test_no_jitter_prob_zero_identity_up_to_flip(self, rng):
        from edrl.data.device_augment import augment_fundus_batch

        x = jnp.asarray(rng.uniform(size=(4, 8, 8, 3)).astype(np.float32))
        out = augment_fundus_batch(
            x, jax.random.key(0), jitter_prob=0.0, grayscale_prob=0.0, hflip_prob=0.0
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(x), atol=1e-5)

    def test_hue_round_trip_preserves_value_channel(self, rng):
        """Hue rotation must not change per-pixel max (HSV value)."""
        from edrl.data.device_augment import augment_fundus_batch

        x = jnp.asarray(rng.uniform(size=(2, 8, 8, 3)).astype(np.float32))
        out = augment_fundus_batch(
            x, jax.random.key(1),
            jitter_prob=1.0, jitter_strength=(0.0, 0.0, 0.0, 0.1),
            grayscale_prob=0.0, hflip_prob=0.0,
        )
        np.testing.assert_allclose(
            np.asarray(out).max(-1), np.asarray(x).max(-1), atol=1e-4
        )

    def test_per_sample_randomness(self, rng):
        from edrl.data.device_augment import augment_fundus_batch

        x = jnp.asarray(np.tile(rng.uniform(size=(1, 8, 8, 3)), (8, 1, 1, 1)).astype(np.float32))
        out = np.asarray(augment_fundus_batch(x, jax.random.key(2), jitter_prob=1.0))
        # identical inputs must receive different augmentations across batch
        diffs = [np.abs(out[i] - out[0]).max() for i in range(1, 8)]
        assert max(diffs) > 1e-3

    def test_oct_flip(self, rng):
        from edrl.data.device_augment import augment_oct_batch

        x = jnp.asarray(rng.uniform(size=(8, 4, 4, 4, 1)).astype(np.float32))
        out = np.asarray(augment_oct_batch(x, jax.random.key(0), hflip_prob=1.0))
        np.testing.assert_allclose(out, np.asarray(x)[:, :, :, ::-1, :], atol=1e-6)
