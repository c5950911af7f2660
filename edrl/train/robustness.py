"""Robustness evaluation: noise sweeps and missing-modality grids.

The reference's robustness axis is input corruption
(``Condition_G_Variance = [0.1, 0.2, 0.3, 0.4, 0.5]``,
``fusion_train.py:548``) evaluated by rebuilding the dataset at each noise
level; the eval loop consumes the LOW-noise view (``fusion_train.py:277``),
so the sweep sets ``gaussian_low`` to the probe sigma.  Combined with the
modality-dropout grid this covers the missing-modality configurations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from edrl.config import EDRLConfig
from edrl.data import BatchLoader
from edrl.train.trainer import TrainState, make_eval_step, make_model, run_eval

DEFAULT_SIGMAS = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
# SP fraction grid bracketing the reference default (0.005,
# ``fusion_train.py:535``).
DEFAULT_SP_LEVELS = (0.0, 0.001, 0.005, 0.01, 0.05)

MODALITY_GRID = {
    "both": None,
    "fundus-only": np.array([True, False]),
    "oct-only": np.array([False, True]),
}


def _cfg_for(cfg: EDRLConfig, level: float, kind: str = "gaussian") -> EDRLConfig:
    """Probe config for one corruption level.

    ``kind`` selects the probe axis — "gaussian" (``--Condition_G_Variance``)
    or "salt_pepper" (``--Condition_SP_Variance``, ``fusion_train.py:535``);
    the probe sets ``condition_name`` explicitly so the sweep corrupts with
    exactly one mechanism even if the model was trained under "All".
    """
    if kind == "gaussian":
        noise = dataclasses.replace(
            cfg.data.noise, condition="noise", condition_name="Gaussian",
            gaussian_low=level,
        )
    elif kind == "salt_pepper":
        noise = dataclasses.replace(
            cfg.data.noise, condition="noise", condition_name="SaltPepper",
            salt_pepper_low=level,
        )
    else:
        raise ValueError(f"unknown probe kind: {kind!r}")
    return cfg.replace(data=dataclasses.replace(cfg.data, noise=noise))


def _dataset_for(cfg: EDRLConfig, sigma: float, kind: str = "gaussian"):
    data_cfg = _cfg_for(cfg, sigma, kind).data
    from edrl.data import SYNTHETIC_DATASETS

    if cfg.data.dataset in SYNTHETIC_DATASETS:
        return SYNTHETIC_DATASETS[cfg.data.dataset](data_cfg, mode="val")
    from edrl.data import GammaDataset

    return GammaDataset(data_cfg, mode="val")


def noise_sweep(
    cfg: EDRLConfig,
    state: TrainState,
    sigmas: Sequence[float] = DEFAULT_SIGMAS,
    modalities: Optional[Sequence[str]] = None,
    mesh=None,
    kind: str = "gaussian",
) -> Dict[str, Dict[float, dict]]:
    """Returns {modality: {level: EpochMetrics-as-dict}}.

    ``kind``: "gaussian" sweeps sigma; "salt_pepper" sweeps the corrupted-
    pixel fraction (reference SP levels are ~0.001-0.05)."""
    model = make_model(cfg)
    modalities = list(modalities or MODALITY_GRID)
    results: Dict[str, Dict[float, dict]] = {m: {} for m in modalities}
    for sigma in sigmas:
        # The eval step must be rebuilt PER SIGMA: on the device_noise path
        # the low view is constructed inside the jitted step from the noise
        # config captured at step-creation time — a sigma that only reaches
        # the dataset config is silently ignored there (caught 2026-08-17:
        # every sigma cell of a device_noise sweep came back identical).
        # mesh= so a sharded sweep traces under the mesh context (same
        # contract as fit()'s eval).
        eval_step = make_eval_step(model, _cfg_for(cfg, sigma, kind), mesh=mesh)
        # Keep the remainder batch: dropping it loses up to eval_batch_size-1
        # samples per grid cell on small folds (same class of bug as the
        # reference's drop_last val loaders, fixed for the main eval path in
        # cli/train.py — the sweep must evaluate every sample too).
        loader = BatchLoader(
            _dataset_for(cfg, sigma, kind),
            cfg.data.eval_batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=4,
        )
        for modality in modalities:
            mask = MODALITY_GRID[modality]
            m, targets, _ = run_eval(
                state, eval_step, loader, modality_mask=mask, mesh=mesh
            )
            cell = m.as_dict()
            cell["num_samples"] = int(targets.shape[0])
            results[modality][sigma] = cell
    return results


def format_sweep(results: Dict[str, Dict[float, dict]]) -> str:
    lines = ["modality\tsigma\taccuracy\tauc\tf1"]
    for modality, by_sigma in results.items():
        for sigma, m in sorted(by_sigma.items()):
            # %g, not %.2f: the salt-pepper grid (0.001, 0.005, ...) would
            # render as three identical "0.00" rows under fixed precision.
            lines.append(
                f"{modality}\t{sigma:g}\t{m['accuracy']:.4f}\t{m['auc']:.4f}\t{m['f1']:.4f}"
            )
    return "\n".join(lines)
