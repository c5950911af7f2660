"""Complementary-evidence ("fusion") synthetic protocol + held-out splits.

Covers the round-3 additions to ``edrl/data/synthetic.py``:

- every synthetic protocol's non-train splits are **held-out** draws
  (until round 3, a standalone val dataset replayed the train entropy and
  was byte-identical to the first ``len(val)`` train samples — all "val"
  metrics were measured on seen data);
- ``ComplementarySyntheticGammaDataset``: label = sign(u+v) with u only in
  the fundus and v only in the OCT — the construction that makes the
  multimodal advantage expressible in clean accuracy (unimodal Bayes
  ceiling ~0.75, fusion ~1.0).  No reference analog (its data paths are
  placeholders, ``fusion_train.py:559-560``).
"""

import dataclasses

import numpy as np
import pytest

from edrl.config import tiny_test_config
from edrl.data import (
    SYNTHETIC_DATASETS,
    ComplementarySyntheticGammaDataset,
)


@pytest.fixture
def data_cfg():
    return tiny_test_config(batch_size=4).data


class TestHeldOutSplits:
    @pytest.mark.parametrize("dataset", sorted(SYNTHETIC_DATASETS))
    def test_val_disjoint_from_train(self, data_cfg, dataset):
        cls = SYNTHETIC_DATASETS[dataset]
        train = cls(data_cfg, mode="train")
        val = cls(data_cfg, mode="val")
        for i in range(3):
            f_tr, o_tr, _ = train._base_sample(i)
            f_va, o_va, _ = val._base_sample(i)
            assert not np.array_equal(f_tr, f_va), (dataset, i)
            assert not np.array_equal(o_tr, o_va), (dataset, i)

    @pytest.mark.parametrize("dataset", sorted(SYNTHETIC_DATASETS))
    def test_splits_deterministic(self, data_cfg, dataset):
        cls = SYNTHETIC_DATASETS[dataset]
        for mode in ("train", "val"):
            a = cls(data_cfg, mode=mode)._base_sample(1)
            b = cls(data_cfg, mode=mode)._base_sample(1)
            assert np.array_equal(a[0], b[0]) and a[2] == b[2]

    def test_test_split_differs_from_val(self, data_cfg):
        cls = SYNTHETIC_DATASETS["synthetic_hard"]
        f_va, _, _ = cls(data_cfg, mode="val")._base_sample(0)
        f_te, _, _ = cls(data_cfg, mode="test")._base_sample(0)
        assert not np.array_equal(f_va, f_te)


class TestComplementaryProtocol:
    def test_label_matches_latents(self, data_cfg):
        ds = ComplementarySyntheticGammaDataset(data_cfg, mode="train")
        for i in range(20):
            u, v = ds.latent_evidence(i)
            _, _, label = ds._base_sample(i)
            assert label == int(u + v > 0)

    def test_four_class_uses_both_bits(self, data_cfg):
        cfg = dataclasses.replace(data_cfg, num_classes=4)
        ds = ComplementarySyntheticGammaDataset(cfg, mode="train")
        labels = set()
        for i in range(40):
            u, v = ds.latent_evidence(i)
            _, _, label = ds._base_sample(i)
            assert label == int(u > 0) + 2 * int(v > 0)
            labels.add(label)
        assert labels == {0, 1, 2, 3}

    def test_unsupported_num_classes_raises(self, data_cfg):
        """num_classes=3 must raise, not silently emit binary labels into a
        3-class head (class 2 would have zero support and the protocol's
        unimodal/fusion ceilings would no longer hold)."""
        cfg = dataclasses.replace(data_cfg, num_classes=3)
        ds = ComplementarySyntheticGammaDataset(cfg, mode="train")
        with pytest.raises(ValueError, match="num_classes=3"):
            ds._base_sample(0)

    def test_labels_roughly_balanced(self, data_cfg):
        ds = ComplementarySyntheticGammaDataset(data_cfg, mode="train")
        frac = np.mean([ds._label_of(*ds.latent_evidence(i)) for i in range(400)])
        assert 0.4 < frac < 0.6

    def test_unimodal_bayes_gap(self, data_cfg):
        """sign(u) alone ~0.75 accuracy; sign(u+v) decodes exactly.

        This is the protocol's core property — the multimodal advantage
        is ~25 accuracy points at the Bayes level.
        """
        ds = ComplementarySyntheticGammaDataset(data_cfg, mode="train")
        lat = np.array([ds.latent_evidence(i) for i in range(800)])
        y = (lat.sum(axis=1) > 0).astype(int)
        uni = max(
            np.mean((lat[:, 0] > 0) == y), np.mean((lat[:, 1] > 0) == y)
        )
        assert 0.68 < uni < 0.82, uni
        assert np.mean(((lat.sum(axis=1)) > 0).astype(int) == y) == 1.0

    def test_fundus_encodes_u_not_v(self, data_cfg):
        """u must be linearly decodable from the fundus; v must not be.

        Estimate the template by regressing pixels on u over half the
        samples, then check the matched-filter response on the other half
        correlates with u (>0.8) and not with v (<0.3).  This pins the
        modality split the whole protocol rests on.
        """
        ds = ComplementarySyntheticGammaDataset(data_cfg, mode="train")
        n = 96
        f = np.stack([ds._base_sample(i)[0].mean(-1).ravel() for i in range(n)])
        lat = np.array([ds.latent_evidence(i) for i in range(n)])
        u, v = lat[:, 0], lat[:, 1]
        half = n // 2
        fc = f - f[:half].mean(0)
        t_hat = (u[:half, None] * fc[:half]).sum(0) / (u[:half] ** 2).sum()
        resp = fc[half:] @ t_hat
        corr_u = np.corrcoef(resp, u[half:])[0, 1]
        corr_v = np.corrcoef(resp, v[half:])[0, 1]
        assert corr_u > 0.8, corr_u
        assert abs(corr_v) < 0.3, corr_v

    def test_oct_encodes_v_not_u(self, data_cfg):
        ds = ComplementarySyntheticGammaDataset(data_cfg, mode="train")
        n = 96
        o = np.stack([ds._base_sample(i)[1].mean(axis=(1, 2)) for i in range(n)])
        lat = np.array([ds.latent_evidence(i) for i in range(n)])
        u, v = lat[:, 0], lat[:, 1]
        half = n // 2
        oc = o - o[:half].mean(0)
        t_hat = (v[:half, None] * oc[:half]).sum(0) / (v[:half] ** 2).sum()
        resp = oc[half:] @ t_hat
        assert np.corrcoef(resp, v[half:])[0, 1] > 0.8
        assert abs(np.corrcoef(resp, u[half:])[0, 1]) < 0.3

    def test_loader_integration(self, data_cfg):
        from edrl.data import BatchLoader

        cfg = dataclasses.replace(data_cfg, device_noise=True)
        ds = ComplementarySyntheticGammaDataset(cfg, mode="val")
        loader = BatchLoader(ds, 4, shuffle=False, drop_last=False)
        batch = next(iter(loader.epoch(0)))
        assert batch["fundus"].shape[0] == 4
        assert set(batch) >= {"fundus", "oct", "label"}
