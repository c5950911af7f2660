"""Baseline zoo tests: every registry model builds, runs forward, returns the
uniform (logits, loss, features) contract on tiny shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.baselines import MODEL_REGISTRY, build_baseline
from edrl.baselines.models import (
    CBAM2D,
    CBAM3D,
    MultiDropoutResNet,
    MultiResNet,
)
from edrl.baselines.registry import ENSEMBLE_LRS
from edrl.config import tiny_test_config

TINY_SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=4)
TINY_VIT = dict(volume_size=16, patch_size=8, dim=32, depth=1, num_heads=2)


@pytest.fixture(scope="module")
def tiny_batch():
    rng = np.random.default_rng(0)
    return (
        jnp.asarray(rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)),
        jnp.asarray(np.array([0, 1])),
    )


def _tiny_cfg():
    cfg = tiny_test_config(batch_size=2)
    return cfg.replace(data=cfg.data.__class__(fundus_size=32, oct_size=(16, 16, 16)))


# Transformer registry entries now inherit the tiny ModelConfig geometry via
# _swin_kwargs/_vit_kwargs (the flagship layout threading), so
# they build CPU-fast straight from the registry.  MedFusion/IMDR stay out:
# their EPRL token contract is pinned by ModelConfig, which _tiny_cfg's
# resized data deliberately breaks.
_SKIP_FULL_SIZE = {"MedFusion", "IMDR"}


class TestRegistry:
    def test_unknown_name_raises(self):
        with pytest.raises(NameError):
            build_baseline("NoSuchModel", _tiny_cfg())

    def test_ensemble_lr_overrides(self):
        cfg = _tiny_cfg()
        for name, lr in ENSEMBLE_LRS.items():
            model, override = build_baseline(name, cfg)
            assert override == lr

    @pytest.mark.parametrize(
        "name",
        [n for n in MODEL_REGISTRY if n not in _SKIP_FULL_SIZE],
    )
    @pytest.mark.slow
    def test_cnn_baselines_forward(self, name, tiny_batch):
        cfg = _tiny_cfg()
        model, _ = build_baseline(name, cfg)
        fundus, oct_vol, y = tiny_batch
        rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
        variables = model.init(rngs, fundus, oct_vol, y, train=True)
        (logits, loss, feat), _ = model.apply(
            variables,
            fundus,
            oct_vol,
            y,
            train=True,
            rngs={"dropout": jax.random.key(1)},
            mutable=["batch_stats"],
        )
        assert logits.shape == (2, 2)
        assert np.isfinite(float(loss))
        assert feat.ndim == 2
        assert np.all(np.isfinite(np.asarray(logits)))


class TestStructuralVariants:
    def test_multi_ensemble_resnet_structurally_distinct(self, tiny_batch):
        """``Multi_ensemble_ResNet`` is its own architecture (14w8s 2-D
        stream + ResNet-10 3-D + single-Linear head,
        ``baseline_models.py:1007-1038``), not an alias of Multi_ResNet."""
        cfg = _tiny_cfg()
        fundus, oct_vol, y = tiny_batch
        rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
        shapes = {}
        for name in ("Multi_ResNet", "Multi_ensemble_ResNet"):
            model, _ = build_baseline(name, cfg)
            variables = model.init(rngs, fundus, oct_vol, y, train=False)
            shapes[name] = jax.tree_util.tree_map(
                lambda x: x.shape, variables["params"]
            )
        assert shapes["Multi_ResNet"] != shapes["Multi_ensemble_ResNet"]

    def test_transformer_baselines_inherit_model_config(self):
        """Registry transformer baselines carry the flagship's layout
        (heads / attention remat from ModelConfig) so baseline-vs-EDRL
        benches share the backbone."""
        import dataclasses

        cfg = _tiny_cfg()
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, remat_attention=True)
        )
        m2d, _ = build_baseline("2D_transformer", cfg)
        assert m2d.swin_kwargs["num_heads"] == cfg.model.swin_heads
        assert m2d.swin_kwargs["remat_attention"] is True
        m3d, _ = build_baseline("3D_transformer", cfg)
        assert m3d.vit_kwargs["num_heads"] == cfg.model.vit3d_heads
        assert m3d.vit_kwargs["volume_size"] == cfg.data.oct_size[0]
        mx, _ = build_baseline("Trans_cross", cfg)
        assert mx.swin_kwargs == m2d.swin_kwargs
        assert mx.vit_kwargs == m3d.vit_kwargs


class TestTransformerBaselines:
    def test_two_d_transformer_tiny(self, tiny_batch):
        from edrl.baselines.models import TwoDTransformer

        fundus, oct_vol, y = tiny_batch
        m = TwoDTransformer(classes=2, img_size=32, swin_kwargs=TINY_SWIN)
        v = m.init({"params": jax.random.key(0)}, fundus, None, y, train=False)
        logits, loss, feat = m.apply(v, fundus, None, y, train=False)
        assert logits.shape == (2, 2)
        assert np.isfinite(float(loss))

    def test_three_d_transformer_tiny(self, tiny_batch):
        from edrl.baselines.models import ThreeDTransformer

        fundus, oct_vol, y = tiny_batch
        m = ThreeDTransformer(classes=2, vit_kwargs=TINY_VIT)
        v = m.init({"params": jax.random.key(0)}, None, oct_vol, y, train=False)
        logits, loss, feat = m.apply(v, None, oct_vol, y, train=False)
        assert logits.shape == (2, 2)

    def test_trans_cross_tiny(self, tiny_batch):
        from edrl.baselines.models import TransCross

        fundus, oct_vol, y = tiny_batch
        m = TransCross(classes=2, img_size=32, swin_kwargs=TINY_SWIN, vit_kwargs=TINY_VIT)
        v = m.init({"params": jax.random.key(0)}, fundus, oct_vol, y, train=False)
        logits, loss, feat = m.apply(v, fundus, oct_vol, y, train=False)
        assert logits.shape == (2, 2)

    def test_mlc_trans_tiny(self, tiny_batch):
        from edrl.baselines.models import MLCTrans

        fundus, oct_vol, y = tiny_batch
        m = MLCTrans(classes=2, img_size=32, swin_kwargs=TINY_SWIN, vit_kwargs=TINY_VIT)
        v = m.init({"params": jax.random.key(0)}, fundus, oct_vol, y, train=False)
        logits, loss, feat = m.apply(v, fundus, oct_vol, y, train=False)
        assert logits.shape == (2, 2)
        assert float(loss) > 0  # sum of three CE terms


class TestCBAM:
    def test_cbam2d_preserves_shape(self, rng):
        x = jnp.asarray(rng.normal(size=(2, 8, 8, 16)).astype(np.float32))
        m = CBAM2D()
        v = m.init(jax.random.key(0), x)
        out = m.apply(v, x)
        assert out.shape == x.shape

    def test_cbam3d_preserves_shape(self, rng):
        x = jnp.asarray(rng.normal(size=(2, 4, 4, 4, 16)).astype(np.float32))
        m = CBAM3D()
        v = m.init(jax.random.key(0), x)
        out = m.apply(v, x)
        assert out.shape == x.shape

    def test_cbam_attenuates(self, rng):
        """Sigmoid gates keep outputs bounded by inputs in magnitude."""
        x = jnp.asarray(np.abs(rng.normal(size=(1, 8, 8, 8))).astype(np.float32))
        m = CBAM2D()
        v = m.init(jax.random.key(0), x)
        out = np.asarray(m.apply(v, x))
        assert np.all(np.abs(out) <= np.abs(np.asarray(x)) + 1e-6)


class TestMCDropout:
    def test_mc_sampling_varies(self, tiny_batch):
        fundus, oct_vol, y = tiny_batch
        m = MultiDropoutResNet(classes=2)
        rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
        v = m.init(rngs, fundus, oct_vol, y, train=True)
        out1, _ = m.apply(
            v, fundus, oct_vol, y, train=False, mc=True,
            rngs={"dropout": jax.random.key(2)}, mutable=["batch_stats"],
        )
        out2, _ = m.apply(
            v, fundus, oct_vol, y, train=False, mc=True,
            rngs={"dropout": jax.random.key(3)}, mutable=["batch_stats"],
        )
        assert not np.allclose(np.asarray(out1[0]), np.asarray(out2[0]))


class TestDeepEnsemble:
    def test_ensemble_average_logits(self, tiny_batch):
        """test_ensemble parity (``fusion_train.py:441-445``): member logits
        are averaged, then the uncertainty suite is computed."""
        from edrl.train.metrics import compute_uncertainty_metrics

        fundus, oct_vol, y = tiny_batch
        cfg = _tiny_cfg()
        all_probs = []
        for seed, name in enumerate(["Multi_DE1_ResNet", "Multi_DE2_ResNet"]):
            model, lr = build_baseline(name, cfg)
            v = model.init(
                {"params": jax.random.key(seed)}, fundus, oct_vol, y, train=False
            )
            logits, _, _ = model.apply(v, fundus, oct_vol, y, train=False)
            all_probs.append(jax.nn.softmax(logits, axis=-1))
        mean_probs = np.mean([np.asarray(p) for p in all_probs], axis=0)
        suite = compute_uncertainty_metrics(np.asarray(y), mean_probs)
        assert np.isfinite(suite["nll"])
