"""Day-one real-data runbook dress rehearsal (VERDICT r4 next-#5).

Generates a healthy GAMMA-layout fixture tree, then drives the actual
runbook surfaces against it: ``scripts/run_harvard.sh`` (preflight + uint8
cache build via SKIP_TRAIN=1) and an end-to-end tiny-model training fit on
the cached on-disk tree through the same ``GammaDataset``/k-fold path
``cli.train --dataset dr2`` uses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from edrl.config import DataConfig, tiny_test_config
from edrl.data.nifti import write_nifti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_png(path, rng, size=(40, 40)):
    img = (rng.uniform(size=(*size, 3)) * 255).astype(np.uint8)
    try:
        import cv2

        cv2.imwrite(str(path), img)
    except ImportError:  # pragma: no cover
        from PIL import Image

        Image.fromarray(img).save(path)


@pytest.fixture
def tree(tmp_path, rng):
    """Healthy 6-sample dr2 layout (6 >= the 5 CV folds) + csv labels."""
    import pandas as pd

    root = tmp_path / "data"
    rows = []
    for i in range(1, 7):
        sid = str(i)
        d = root / sid
        d.mkdir(parents=True)
        _write_png(d / f"data_{sid}_fundus.png", rng)
        vol = (rng.uniform(size=(32, 32, 20)) * 255).astype(np.float32)
        write_nifti(str(d / f"data_{sid}.nii"), vol)
        rows.append(
            {"data": sid.zfill(5), "class_0": 1 - (i % 2), "class_1": i % 2}
        )
    label_file = tmp_path / "labels.csv"
    pd.DataFrame(rows).to_csv(label_file, index=False)
    return root, label_file


def test_runbook_preflight_and_cache_build(tree):
    """SKIP_TRAIN=1 run of the real script: preflight passes, uint8 caches
    appear in every sample dir, and a second run is idempotent."""
    root, labels = tree
    env = dict(os.environ, DATA=str(root), LABELS=str(labels), SKIP_TRAIN="1")
    for _ in range(2):  # idempotent
        proc = subprocess.run(
            ["bash", os.path.join(REPO, "scripts", "run_harvard.sh")],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "preflight" in proc.stdout
        assert "cache build complete: 6 samples" in proc.stdout
    for i in range(1, 7):
        cache = root / str(i) / "_edrl_cache8_384_96x96x96.npz"
        assert cache.exists(), f"missing cache for sample {i}"
        z = np.load(cache)
        assert z["fundus"].shape == (384, 384, 3)
        assert z["fundus"].dtype == np.uint8
        assert z["oct"].shape == (96, 96, 96)


def test_runbook_preflight_failure_aborts(tree):
    root, labels = tree
    os.unlink(root / "2" / "data_2_fundus.png")
    env = dict(os.environ, DATA=str(root), LABELS=str(labels), SKIP_TRAIN="1")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "run_harvard.sh")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 1
    assert "preflight FAILED" in proc.stdout


@pytest.mark.slow
def test_ondisk_tree_trains_end_to_end(tree):
    """The cli.train dr2 path (k-fold split over the on-disk tree ->
    GammaDataset -> fit) on the fixture tree with the tiny model: one real
    epoch to finite loss + an eval over the val fold."""
    import dataclasses

    from edrl.cli.train import make_loaders
    from edrl.train.trainer import fit

    root, labels = tree
    cfg = tiny_test_config(batch_size=2)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data,
            dataset="dr2",
            data_path=str(root),
            label_file=str(labels),
            batch_size=2,
            eval_batch_size=2,
            device_noise=True,
        ),
        train=dataclasses.replace(cfg.train, end_epochs=1, log_dir=""),
    )
    train_loader, val_loader = make_loaders(cfg)
    assert len(train_loader.dataset.samples) >= 4
    _, result = fit(cfg, train_loader, val_loader, verbose=False)
    assert np.isfinite(result.train_history[-1].loss)
    assert 0.0 <= result.best_acc <= 1.0
