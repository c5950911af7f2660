"""Auxiliary module tests: MIAttentionFusion, PID, MIEstimator, viz, ensemble."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.models.auxiliary import (
    CLUBMean,
    MIAttentionFusion,
    MIEstimator,
    PID,
    estimate_v,
)


class TestEstimateV:
    def test_clamped_at_two(self, rng):
        z = jnp.asarray(rng.normal(size=(4, 8, 16)).astype(np.float32)) * 0.1
        v = estimate_v(z)
        assert np.all(np.asarray(v) >= 2.0)


class TestMIAttentionFusion:
    def test_shapes(self, rng):
        m = MIAttentionFusion(dim_2d=32, dim_3d=24, dim_general=16, num_heads=4, out_dim=32)
        x2 = jnp.asarray(rng.normal(size=(2, 6, 32)).astype(np.float32))
        x3 = jnp.asarray(rng.normal(size=(2, 5, 24)).astype(np.float32))
        xg = jnp.asarray(rng.normal(size=(2, 1, 16)).astype(np.float32))
        v = m.init(jax.random.key(0), x2, x3, xg)
        out = m.apply(v, x2, x3, xg)
        assert out.shape == (2, 1, 32)
        assert np.all(np.isfinite(np.asarray(out)))


class TestPID:
    def test_pooled_outputs(self, rng):
        m = PID(embed_dim=32, embed_dim_3d=24, num_heads=4)
        x2 = jnp.asarray(rng.normal(size=(2, 6, 32)).astype(np.float32))
        x3 = jnp.asarray(rng.normal(size=(2, 5, 24)).astype(np.float32))
        v = m.init(jax.random.key(0), x2, x3)
        o2, o3 = m.apply(v, x2, x3)
        assert o2.shape == (2, 32)
        assert o3.shape == (2, 32)


class TestMIEstimator:
    def test_mi_and_learning_modes(self, rng):
        m = MIEstimator(dim=8)
        h = jnp.asarray(rng.normal(size=(6, 8)).astype(np.float32))
        p = jnp.asarray(rng.normal(size=(6, 8)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(6, 8)).astype(np.float32))
        v = m.init(jax.random.key(0), h, p, g)
        mi = m.apply(v, h, p, g, mode="mi")
        ll = m.apply(v, h, p, g, mode="learning")
        assert np.isfinite(float(mi))
        assert float(ll) > 0  # -loglikelihood of imperfect predictions


class TestVisualize:
    def test_loss_and_metrics_plots(self, tmp_path):
        from edrl.train.visualize import loss_plot, metrics_plot

        p1 = loss_plot([3.0, 2.0, 1.5], str(tmp_path / "plot" / "loss.jpg"))
        p2 = metrics_plot({"acc": [0.5, 0.6]}, str(tmp_path / "plot" / "acc.jpg"))
        assert os.path.exists(p1) and os.path.exists(p2)

    def test_proxy_dump_skips_models_without_eprl(self, tmp_path):
        """A proxy-less baseline (e.g. Multi_ResNet) with --student_t_every
        set must return None, not crash mid-training on plt.subplots(0, 4)."""
        from edrl.config import tiny_test_config
        from edrl.train.visualize import dump_proxy_distributions

        cfg = tiny_test_config()
        out = dump_proxy_distributions(
            {"dense": {"kernel": np.zeros((2, 2))}}, cfg.model, 5, str(tmp_path)
        )
        assert out is None
        assert not list(tmp_path.iterdir())

    def test_student_t_pdf(self, tmp_path):
        pytest.importorskip("scipy")
        from edrl.train.visualize import visualize_student_t_distributions

        n = 3
        path = visualize_student_t_distributions(
            [0.0] * n, [0.01] * n, [3.0] * n,
            [0.01] * n, [0.02] * n, [4.0] * n,
            "test", str(tmp_path / "dist.pdf"),
        )
        assert os.path.exists(path)


class TestEnsembleRunner:
    @pytest.mark.slow
    def test_metric_txt_written(self, tmp_path):
        from edrl.config import tiny_test_config
        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.checkpoint import CheckpointManager
        from edrl.train.ensemble import evaluate_ensemble
        from edrl.train.trainer import init_state

        cfg = tiny_test_config(batch_size=4)
        dirs = []
        for i in range(2):
            _, state = init_state(cfg, i)
            d = str(tmp_path / f"member{i}")
            CheckpointManager(d).save(state)
            dirs.append(d)
        loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="val"),
            cfg.data.batch_size,
            shuffle=False,
            num_workers=2,
        )
        out = str(tmp_path / "Metric.txt")
        suite = evaluate_ensemble(cfg, dirs, loader, out)
        assert os.path.exists(out)
        text = open(out).read()
        for key in ("accuracy", "auc", "nll", "brier", "ece", "kappa"):
            assert key in text
        assert "latency_per_sample_s" in suite
