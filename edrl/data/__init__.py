"""Data layer (reference L1: ``code/data_harvard.py``), host-side numpy pipeline.

The pipeline decodes/resizes/normalizes on the host into fixed-shape batches
(static shapes for XLA), builds the dual low/high-noise views with
*per-sample keyed PRNG* (fixing reference ledger #7, where
``np.random.seed(seed_idx)`` inside ``__getitem__`` froze the noise), and
prefetches batches on a background thread so the device never waits on IO.
"""

from edrl.data.noise import add_gaussian, add_salt_pepper, make_noise_views
from edrl.data.synthetic import (
    SYNTHETIC_DATASETS,
    ComplementarySyntheticGammaDataset,
    HardSyntheticGammaDataset,
    SyntheticGammaDataset,
)
from edrl.data.loader import BatchLoader, kfold_split
from edrl.data.gamma import GammaDataset, GammaSub1Dataset

__all__ = [
    "add_gaussian",
    "add_salt_pepper",
    "make_noise_views",
    "SyntheticGammaDataset",
    "HardSyntheticGammaDataset",
    "ComplementarySyntheticGammaDataset",
    "SYNTHETIC_DATASETS",
    "GammaDataset",
    "GammaSub1Dataset",
    "BatchLoader",
    "kfold_split",
]
