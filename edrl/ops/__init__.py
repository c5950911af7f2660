"""Jittable math primitives (reference L2: ``code/MMD.py``, parts of ``fusion_net.py``)."""

from edrl.ops.mmd import gaussian_kernel, mk_mmd
from edrl.ops.distributions import (
    kl_between_normals,
    kl_to_standard_normal,
    entropy_regularization,
    js_divergence,
)
from edrl.ops.correlation import (
    off_diagonal_sum_sq,
    cross_correlation,
    barlow_block_loss,
    batch_standardize,
)
from edrl.ops.losses import label_smoothing_cross_entropy
from edrl.ops.club import club_mean_mi, club_learning_loss
from edrl.ops.quantization import (
    quantize_for_serving,
    quantized_apply,
    int8_dense,
)

__all__ = [
    "gaussian_kernel",
    "mk_mmd",
    "kl_between_normals",
    "kl_to_standard_normal",
    "entropy_regularization",
    "js_divergence",
    "off_diagonal_sum_sq",
    "cross_correlation",
    "barlow_block_loss",
    "batch_standardize",
    "label_smoothing_cross_entropy",
    "club_mean_mi",
    "club_learning_loss",
    "quantize_for_serving",
    "quantized_apply",
    "int8_dense",
]
