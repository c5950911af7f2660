"""Model layer (reference L0 backbones + L3 EDRL modules) on ``models.nn``."""

from edrl.models.swin2d import SwinTransformer2D
from edrl.models.vit3d import ViT3D
from edrl.models.eprl import EPRL
from edrl.models.poe import PoE
from edrl.models.dilr import DILR, AttentionModel
from edrl.models.medfusion import MedFusion

__all__ = [
    "SwinTransformer2D",
    "ViT3D",
    "EPRL",
    "PoE",
    "DILR",
    "AttentionModel",
    "MedFusion",
]
