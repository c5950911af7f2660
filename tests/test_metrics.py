"""Metric suite tests, cross-checked against sklearn where available."""

import numpy as np
import pytest

from edrl.train import metrics as M

sklearn = pytest.importorskip("sklearn")
from sklearn.metrics import (  # noqa: E402
    cohen_kappa_score,
    f1_score,
    precision_score,
    recall_score,
    roc_auc_score,
)


@pytest.fixture
def binary_case(rng):
    n = 200
    targets = rng.integers(0, 2, size=n)
    logits = rng.normal(size=(n, 2)) + np.eye(2)[targets] * 1.5
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return targets, probs


def test_accuracy():
    t = np.array([0, 1, 1, 0])
    p = np.array([0, 1, 0, 0])
    assert M.accuracy(t, p) == 0.75


def test_weighted_prf_vs_sklearn(binary_case):
    targets, probs = binary_case
    preds = probs.argmax(1)
    prec, rec, f1 = M.precision_recall_f1_weighted(targets, preds)
    assert prec == pytest.approx(
        precision_score(targets, preds, average="weighted"), abs=1e-9
    )
    assert rec == pytest.approx(
        recall_score(targets, preds, average="weighted"), abs=1e-9
    )
    assert f1 == pytest.approx(f1_score(targets, preds, average="weighted"), abs=1e-9)


def test_binary_auc_vs_sklearn(binary_case):
    targets, probs = binary_case
    assert M.binary_auc(targets, probs[:, 1]) == pytest.approx(
        roc_auc_score(targets, probs[:, 1]), abs=1e-9
    )


def test_auc_with_ties():
    targets = np.array([0, 0, 1, 1])
    scores = np.array([0.5, 0.5, 0.5, 0.9])
    assert M.binary_auc(targets, scores) == pytest.approx(
        roc_auc_score(targets, scores), abs=1e-9
    )


def test_ovr_auc_vs_sklearn(rng):
    n = 300
    targets = rng.integers(0, 3, size=n)
    logits = rng.normal(size=(n, 3)) + np.eye(3)[targets]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = roc_auc_score(targets, probs, multi_class="ovr", average="macro")
    assert M.auc_ovr(targets, probs) == pytest.approx(want, abs=1e-6)


def test_kappa_vs_sklearn(binary_case):
    targets, probs = binary_case
    preds = probs.argmax(1)
    assert M.cohen_kappa(targets, preds) == pytest.approx(
        cohen_kappa_score(targets, preds), abs=1e-9
    )


def test_specificity():
    targets = np.array([0, 0, 0, 1, 1])
    preds = np.array([0, 1, 0, 1, 1])
    # TN=2, FP=1
    assert M.specificity(targets, preds) == pytest.approx(2 / 3)


def test_ece_perfect_calibration_zero():
    # Prob exactly matches empirical accuracy in one bin.
    targets = np.array([1, 0] * 50)
    probs = np.tile(np.array([[0.5, 0.5]]), (100, 1))
    # argmax ties -> class 0 predicted, accuracy 0.5, confidence 0.5 -> ECE 0
    assert M.expected_calibration_error(targets, probs) == pytest.approx(0.0, abs=1e-9)


def test_ece_overconfident():
    targets = np.zeros(100, dtype=int)
    targets[:50] = 1  # accuracy of predicting class 0 = 0.5
    probs = np.tile(np.array([[0.99, 0.01]]), (100, 1))
    assert M.expected_calibration_error(targets, probs) == pytest.approx(0.49, abs=1e-6)


def test_nll_brier():
    targets = np.array([0, 1])
    probs = np.array([[0.8, 0.2], [0.4, 0.6]])
    nll, brier = M.nll_brier(targets, probs)
    assert nll == pytest.approx(-(np.log(0.8) + np.log(0.6)) / 2, abs=1e-9)
    want_brier = ((0.2**2 + 0.2**2) + (0.4**2 + 0.4**2)) / 2
    assert brier == pytest.approx(want_brier, abs=1e-9)


def test_aurc_perfect_ordering_zero_eaurc():
    # Confidence perfectly separates correct from incorrect -> EAURC == 0.
    targets = np.array([0] * 8)
    probs = np.zeros((8, 2))
    probs[:6, 0] = np.linspace(0.9, 0.99, 6)  # correct, high conf
    probs[:6, 1] = 1 - probs[:6, 0]
    probs[6:, 1] = 0.6  # wrong, low conf
    probs[6:, 0] = 0.4
    aurc, eaurc = M.aurc_eaurc(targets, probs)
    assert eaurc == pytest.approx(0.0, abs=1e-9)
    assert aurc > 0


def test_compute_epoch_metrics_shape(binary_case):
    targets, probs = binary_case
    em = M.compute_epoch_metrics(targets, probs, loss=1.23)
    d = em.as_dict()
    assert set(d) == {
        "loss",
        "accuracy",
        "precision",
        "recall",
        "f1",
        "auc",
        "specificity",
    }
    assert 0 <= d["accuracy"] <= 1


def test_uncertainty_suite_keys(binary_case):
    targets, probs = binary_case
    d = M.compute_uncertainty_metrics(targets, probs)
    assert set(d) == {
        "accuracy",
        "auc",
        "aurc",
        "eaurc",
        "nll",
        "brier",
        "f1",
        "recall",
        "kappa",
        "ece",
    }
    assert all(np.isfinite(v) for v in d.values())
