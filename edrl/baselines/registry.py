"""Model registry: reference ``--model_name`` strings -> constructors.

Replaces the string-branching factory at ``fusion_train.py:657-739``.  The
``Multi_DE{i}_ResNet`` entries are ensemble members — the same late-fusion
architecture trained at different learning rates (``fusion_train.py:694-716``);
the registry returns ``(model, lr_override)`` so the trainer can reproduce
that.  The reference's ``Run_*.sh`` pass ``IMDR``, which matched no branch
(defect ledger #11); it is aliased to ``MedFusion`` here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from edrl.models import nn

from edrl.baselines import models as B
from edrl.config import EDRLConfig
from edrl.models.medfusion import MedFusion

# Deep-ensemble member learning rates (``fusion_train.py:694-716``).
ENSEMBLE_LRS = {
    "Multi_DE1_ResNet": 1e-4,
    "Multi_DE2_ResNet": 3e-4,
    "Multi_DE3_ResNet": 1e-3,
    "Multi_DE4_ResNet": 2e-4,
    "Multi_DE5_ResNet": 1e-5,
}


def _medfusion(cfg: EDRLConfig) -> nn.Module:
    return MedFusion(
        cfg=cfg.model, fundus_size=cfg.data.fundus_size, oct_size=cfg.data.oct_size
    )


def _dtype(cfg: EDRLConfig):
    import jax.numpy as jnp

    return jnp.bfloat16 if cfg.model.use_bfloat16 else jnp.float32


def _swin_kwargs(cfg: EDRLConfig) -> dict:
    """Thread the flagship's Swin layout into transformer baselines so
    baseline-vs-EDRL comparisons share the same backbone.  dtype is set on
    the baseline module itself, not here."""
    m = cfg.model
    return dict(
        embed_dim=m.swin_embed_dim,
        depths=m.swin_depths,
        num_heads=m.swin_heads,
        window=m.swin_window,
        remat=m.remat,
        remat_attention=m.remat_attention,
    )


def _vit_kwargs(cfg: EDRLConfig) -> dict:
    m = cfg.model
    return dict(
        volume_size=cfg.data.oct_size[0],
        patch_size=m.vit3d_patch,
        dim=m.oct_embed_dim,
        depth=m.vit3d_depth,
        num_heads=m.vit3d_heads,
        remat=m.remat,
    )


MODEL_REGISTRY: Dict[str, Callable[[EDRLConfig], nn.Module]] = {
    "MedFusion": _medfusion,
    "IMDR": _medfusion,  # Run_fusion.sh alias (ledger #11)
    "Res2Net2D": lambda cfg: B.FundusOnly2D(classes=cfg.model.num_classes),
    "ResNet3D": lambda cfg: B.OctOnly3D(classes=cfg.model.num_classes),
    "Multi_ResNet": lambda cfg: B.MultiResNet(classes=cfg.model.num_classes),
    "Multi_ResNet_cross": lambda cfg: B.MultiResNetCross(classes=cfg.model.num_classes),
    "Multi_EF_ResNet": lambda cfg: B.MultiEFResNet(classes=cfg.model.num_classes),
    "Multi_CBAM_ResNet": lambda cfg: B.MultiCBAMResNet(classes=cfg.model.num_classes),
    "Multi_dropout_ResNet": lambda cfg: B.MultiDropoutResNet(
        classes=cfg.model.num_classes
    ),
    "Base_transformer": lambda cfg: B.TwoDTransformer(
        classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
        swin_kwargs=_swin_kwargs(cfg), dtype=_dtype(cfg),
    ),
    "2D_transformer": lambda cfg: B.TwoDTransformer(
        classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
        swin_kwargs=_swin_kwargs(cfg), dtype=_dtype(cfg),
    ),
    "3D_transformer": lambda cfg: B.ThreeDTransformer(
        classes=cfg.model.num_classes,
        vit_kwargs=_vit_kwargs(cfg), dtype=_dtype(cfg),
    ),
    "Trans_cross": lambda cfg: B.TransCross(
        classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
        swin_kwargs=_swin_kwargs(cfg), vit_kwargs=_vit_kwargs(cfg),
        dtype=_dtype(cfg),
    ),
    "MLC": lambda cfg: B.MLC(classes=cfg.model.num_classes),
    "MLC_trans": lambda cfg: B.MLCTrans(
        classes=cfg.model.num_classes, img_size=cfg.data.fundus_size,
        swin_kwargs=_swin_kwargs(cfg), vit_kwargs=_vit_kwargs(cfg),
        dtype=_dtype(cfg),
    ),
    "Medical_2DNet": lambda cfg: B.FeatureExtractor2D(
        classes=cfg.model.num_classes, output="logits"
    ),
    "Medical_base_dropout_2DNet": lambda cfg: B.FeatureExtractor2D(
        classes=cfg.model.num_classes, output="logits", dropout=0.3
    ),
    "Medical_3DNet": lambda cfg: B.FeatureExtractor3D(
        classes=cfg.model.num_classes, output="logits"
    ),
    "Medical_base_dropout_3DNet": lambda cfg: B.FeatureExtractor3D(
        classes=cfg.model.num_classes, output="logits", dropout=0.3
    ),
    "Multi_ensemble_ResNet": lambda cfg: B.MultiEnsembleResNet(
        classes=cfg.model.num_classes
    ),
    "Multi_ensemble_3D_ResNet": lambda cfg: B.MultiEnsemble3DResNet(
        classes=cfg.model.num_classes
    ),
}
for name in ENSEMBLE_LRS:
    MODEL_REGISTRY[name] = lambda cfg: B.MultiResNet(classes=cfg.model.num_classes)


def build_baseline(
    name: str, cfg: EDRLConfig
) -> Tuple[nn.Module, Optional[float]]:
    """Returns ``(model, lr_override)``; unknown names raise (parity with the
    reference's ``raise NameError`` at ``fusion_train.py:739``)."""
    if name not in MODEL_REGISTRY:
        raise NameError(f"There is no model named {name!r}")
    return MODEL_REGISTRY[name](cfg), ENSEMBLE_LRS.get(name)
