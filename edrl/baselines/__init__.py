"""Baseline model zoo (reference ``baseline_models.py``, SURVEY.md section 2.4)."""

from edrl.baselines.models import (
    CBAM2D,
    CBAM3D,
    FundusOnly2D,
    OctOnly3D,
    MultiCBAMResNet,
    MultiDropoutResNet,
    MultiEFResNet,
    MultiResNet,
    MultiResNetCross,
    TransCross,
    TwoDTransformer,
    ThreeDTransformer,
    MLC,
    MLCTrans,
)
from edrl.baselines.registry import MODEL_REGISTRY, build_baseline

__all__ = [
    "CBAM2D",
    "CBAM3D",
    "FundusOnly2D",
    "OctOnly3D",
    "MultiCBAMResNet",
    "MultiDropoutResNet",
    "MultiEFResNet",
    "MultiResNet",
    "MultiResNetCross",
    "TransCross",
    "TwoDTransformer",
    "ThreeDTransformer",
    "MLC",
    "MLCTrans",
    "MODEL_REGISTRY",
    "build_baseline",
]
