"""MC-dropout N-pass sampling (reference ``baseline_models.py:1069-1113``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.baselines import models as B
from edrl.train.mc_dropout import (
    make_mc_predict,
    mc_dropout_predict,
    model_supports_mc,
)
from edrl.train.trainer import TrainState


@pytest.fixture(scope="module")
def dropout_model_state():
    model = B.MultiDropoutResNet(classes=2, dropout=0.3)
    rng = np.random.default_rng(0)
    fundus = jnp.asarray(rng.uniform(size=(4, 32, 32, 3)).astype(np.float32))
    oct_vol = jnp.asarray(rng.uniform(size=(4, 16, 16, 16, 1)).astype(np.float32))
    y = jnp.asarray(np.array([0, 1, 0, 1]))
    variables = jax.jit(
        lambda: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            fundus,
            oct_vol,
            y,
            train=True,
        )
    )()
    state = TrainState(
        step=jnp.asarray(0),
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=(),
    )
    return model, state, fundus, oct_vol, y


class TestSupportsMc:
    def test_dropout_baselines_support_mc(self):
        assert model_supports_mc(B.MultiDropoutResNet(classes=2))
        assert model_supports_mc(B.FeatureExtractor2D(classes=2, dropout=0.3))

    def test_medfusion_does_not(self):
        from edrl.config import tiny_test_config
        from edrl.models import MedFusion

        cfg = tiny_test_config()
        assert not model_supports_mc(MedFusion(cfg=cfg.model))


class TestMcPredict:
    @pytest.mark.slow
    def test_scan_equals_manual_passes(self, dropout_model_state):
        """The K-pass scan must equal K individual stochastic forwards
        averaged by hand (same dropout keys)."""
        model, state, fundus, oct_vol, y = dropout_model_state
        K = 4
        predict = make_mc_predict(model, K)
        key = jax.random.key(42)
        mean, std = predict(state, fundus, oct_vol, y, key)

        keys = jax.random.split(key, K)
        probs = []
        for k in keys:
            out = model.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                fundus,
                oct_vol,
                y,
                train=False,
                mc=True,
                rngs={"dropout": k, "sample": jax.random.fold_in(k, 1)},
            )
            probs.append(np.asarray(jax.nn.softmax(out[0].astype(jnp.float32), -1)))
        probs = np.stack(probs)
        np.testing.assert_allclose(np.asarray(mean), probs.mean(0), atol=1e-6)
        np.testing.assert_allclose(np.asarray(std), probs.std(0), atol=1e-6)

    def test_stochastic_across_keys(self, dropout_model_state):
        """Different base keys draw different dropout masks (std > 0)."""
        model, state, fundus, oct_vol, y = dropout_model_state
        predict = make_mc_predict(model, 8)
        _, std = predict(state, fundus, oct_vol, y, jax.random.key(0))
        assert float(np.asarray(std).max()) > 0.0

    @pytest.mark.slow
    def test_estimator_variance_shrinks_with_k(self, dropout_model_state):
        """The MC estimate of the predictive mean concentrates as K grows:
        dispersion across independent K=64 estimates << across K=1 passes."""
        model, state, fundus, oct_vol, y = dropout_model_state

        def estimates(K, n_seeds=5):
            predict = make_mc_predict(model, K)
            return np.stack(
                [
                    np.asarray(
                        predict(state, fundus, oct_vol, y, jax.random.key(100 + s))[0]
                    )
                    for s in range(n_seeds)
                ]
            )  # [n_seeds, B, C]

        disp_small = estimates(1).std(axis=0).mean()
        disp_large = estimates(64).std(axis=0).mean()
        assert disp_large < disp_small


class TestMcOverLoader:
    @pytest.mark.slow
    def test_shapes_and_normalization(self):
        from edrl.config import tiny_test_config
        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.trainer import init_state

        import dataclasses

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, model_name="Multi_dropout_ResNet")
        )
        _, state = init_state(cfg, 0)
        ds = SyntheticGammaDataset(cfg.data, mode="val")
        loader = BatchLoader(ds, 4, shuffle=False, drop_last=False)
        pred = mc_dropout_predict(cfg, state, loader, num_samples=3, seed=0)
        n = len(ds)
        assert pred["targets"].shape == (n,)
        assert pred["probs"].shape == (n, 2)
        assert pred["predictive_std"].shape == (n, 2)
        np.testing.assert_allclose(pred["probs"].sum(axis=1), 1.0, atol=1e-5)
