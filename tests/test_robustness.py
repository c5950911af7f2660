"""Noise-sweep robustness eval tests."""

import numpy as np
import pytest

from edrl.config import tiny_test_config
from edrl.train.robustness import format_sweep, noise_sweep
from edrl.train.trainer import init_state


@pytest.mark.slow
def test_noise_sweep_grid_runs():
    cfg = tiny_test_config(batch_size=4)
    _, state = init_state(cfg, 0)
    results = noise_sweep(cfg, state, sigmas=(0.0, 0.5), modalities=["both", "oct-only"])
    assert set(results) == {"both", "oct-only"}
    for modality in results:
        assert set(results[modality]) == {0.0, 0.5}
        for sigma, m in results[modality].items():
            assert 0.0 <= m["accuracy"] <= 1.0
            assert np.isfinite(m["loss"])
    table = format_sweep(results)
    assert "modality" in table and "oct-only" in table


def test_format_sweep_distinguishes_small_sp_levels():
    """%g rendering: the salt-pepper grid's 0.001/0.005 rows must not both
    print as '0.00' (fixed-two-decimal formatting made them ambiguous)."""
    cell = {"accuracy": 0.5, "auc": 0.5, "f1": 0.5}
    table = format_sweep({"both": {0.001: dict(cell), 0.005: dict(cell)}})
    assert "0.001" in table and "0.005" in table


def test_noise_sweep_evaluates_every_sample():
    """Regression: the sweep loaders must keep the remainder batch — with
    drop_last it silently lost up to eval_batch_size-1 samples per grid
    cell on small folds (VERDICT round 1, weak #4)."""
    import dataclasses

    cfg = tiny_test_config(batch_size=4)
    # Dataset length NOT a multiple of the eval batch size.
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_synthetic_samples=11,
                                      eval_batch_size=4)
    )
    from edrl.data import SyntheticGammaDataset

    n_val = len(SyntheticGammaDataset(cfg.data, mode="val"))
    assert n_val % cfg.data.eval_batch_size != 0, "fixture must have remainder"
    _, state = init_state(cfg, 0)
    results = noise_sweep(cfg, state, sigmas=(0.0,), modalities=["both"])
    assert results["both"][0.0]["num_samples"] == n_val


@pytest.mark.slow
def test_device_noise_sweep_sigma_reaches_the_step():
    """Regression: with device_noise=True the low view is built inside the
    jitted eval step from the noise config captured at step creation; a
    sigma that only reached the dataset config was silently ignored and
    every sigma cell came back identical (caught 2026-08-17 in the
    hard-synthetic ablation).  The sweep must rebuild the step per sigma."""
    import dataclasses

    cfg = tiny_test_config(batch_size=4)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, device_noise=True)
    )
    _, state = init_state(cfg, 0)
    results = noise_sweep(cfg, state, sigmas=(0.0, 2.0), modalities=["both"])
    clean = results["both"][0.0]
    noisy = results["both"][2.0]
    assert clean["loss"] != noisy["loss"], (
        "sigma=2.0 cell identical to sigma=0.0 — the probe sigma never "
        "reached the device-side view construction"
    )


@pytest.mark.slow
def test_salt_pepper_sweep_axis():
    """The SP probe axis (``--Condition_SP_Variance``,
    ``fusion_train.py:535``): levels must reach the view construction on
    both the host and device_noise paths, and probe with SP only."""
    import dataclasses

    for device_noise in (False, True):
        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, device_noise=device_noise)
        )
        _, state = init_state(cfg, 0)
        results = noise_sweep(
            cfg, state, sigmas=(0.0, 0.4), modalities=["both"],
            kind="salt_pepper",
        )
        clean = results["both"][0.0]
        corrupted = results["both"][0.4]
        assert clean["loss"] != corrupted["loss"], (
            f"SP level 0.4 cell identical to clean (device_noise="
            f"{device_noise}) — the probe level never reached the view"
        )


def test_unknown_probe_kind_raises():
    import pytest

    cfg = tiny_test_config(batch_size=4)
    _, state = init_state(cfg, 0)
    with pytest.raises(ValueError, match="probe kind"):
        noise_sweep(cfg, state, sigmas=(0.0,), kind="speckle")


def test_cli_sweep_flags_parse():
    """cli.test --sweep plumbing: flags parse and kind resolution matches
    the library's probe kinds."""
    from edrl.cli.train import build_parser

    parser = build_parser()
    parser.add_argument("--checkpoint", default="")
    parser.add_argument(
        "--sweep", choices=["gaussian", "salt_pepper", "all"], default=""
    )
    parser.add_argument("--sweep_levels", type=float, nargs="+", default=None)
    args = parser.parse_args(
        ["--sweep", "all", "--sweep_levels", "0", "0.25"]
    )
    assert args.sweep == "all" and args.sweep_levels == [0.0, 0.25]


def test_sweep_all_does_not_reuse_gaussian_levels_for_salt_pepper():
    """--sweep all + --sweep_levels must override gaussian ONLY: sigma
    0.25-0.5 read as a corrupted-pixel fraction is 10x past the SP grid."""
    from edrl.cli.test import resolve_sweep_levels

    sigmas, sp = (0.0, 0.25, 0.5), (0.0, 0.01, 0.05)
    # all + --sweep_levels: gaussian overridden, SP keeps its default grid
    assert resolve_sweep_levels("all", "gaussian", [0.1], None, sigmas, sp) == (0.1,)
    assert resolve_sweep_levels("all", "salt_pepper", [0.1], None, sigmas, sp) == sp
    # all + --sp_sweep_levels: SP overridden explicitly
    assert resolve_sweep_levels(
        "all", "salt_pepper", [0.1], [0.02], sigmas, sp
    ) == (0.02,)
    # single-kind invocations stay backward compatible with --sweep_levels
    assert resolve_sweep_levels(
        "salt_pepper", "salt_pepper", [0.02], None, sigmas, sp
    ) == (0.02,)
    # no overrides: per-kind defaults
    assert resolve_sweep_levels("all", "gaussian", None, None, sigmas, sp) == sigmas
    assert resolve_sweep_levels("all", "salt_pepper", None, None, sigmas, sp) == sp
