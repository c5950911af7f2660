"""EDRL: robust multimodal learning for ophthalmic disease grading.

A from-scratch JAX rebuild of the capabilities of the reference EDRL
codebase (fundus + OCT fusion with disentangled representation learning,
essence-point proxies, Product-of-Experts fusion, and noise-robust MK-MMD
self-distillation):

- all compute paths are jittable with static shapes,
- batch-global losses (MK-MMD, Barlow cross-correlation) keep global-batch
  semantics under data parallelism via jit-over-Mesh SPMD,
- checkpoints are numpy archives, the metrics suite is plain numpy.

Reference layer map and parity contract: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

from edrl.config import EDRLConfig, DataConfig, TrainConfig, NoiseConfig

__all__ = [
    "EDRLConfig",
    "DataConfig",
    "TrainConfig",
    "NoiseConfig",
    "__version__",
]
