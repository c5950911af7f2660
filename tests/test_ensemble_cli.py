"""Ensemble workflow e2e + multi-class (4-label) training.

The reference's ``test_ensemble`` driver path (``fusion_train.py:392-502``)
trains the ``Multi_DE{1..5}`` members and writes ``Metric.txt``;
``run_ensemble`` must reproduce that surface in one call.  The 4-class case
exercises the label schema's full 4 one-hot columns (``train_true.xlsx``,
SURVEY ledger #5 — the reference only ever ran binary).
"""

import dataclasses
import os

import numpy as np
import pytest

from edrl.config import tiny_test_config


class TestEnsembleWorkflow:
    @pytest.mark.slow
    def test_run_ensemble_end_to_end(self, tmp_path):
        from edrl.cli.ensemble import run_ensemble

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                end_epochs=1,
                lr=3e-4,
                checkpoint_dir=str(tmp_path / "ckpt"),
                log_dir="",
            )
        )
        metric_path = str(tmp_path / "Metric.txt")
        members = ["Multi_DE1_ResNet", "Multi_DE2_ResNet"]
        suite = run_ensemble(cfg, members, metric_path=metric_path)

        assert os.path.exists(metric_path)
        lines = open(metric_path).read().strip().splitlines()
        keys = {l.split(":")[0] for l in lines}
        for want in (
            "accuracy", "auc", "aurc", "eaurc", "nll", "brier",
            "f1", "recall", "kappa", "ece", "latency_per_sample_s",
        ):
            assert want in keys, f"Metric.txt missing {want}"
        assert 0.0 <= suite["accuracy"] <= 1.0
        assert np.isfinite(suite["nll"])
        # Each member left a restorable checkpoint directory.
        ckpt_root = cfg.train.checkpoint_dir
        assert len(os.listdir(ckpt_root)) == len(members)


class TestOneProgramEnsemble:
    """ensemble_predict runs the K member forwards as ONE vmapped program
    with deferred host syncs (VERDICT r2 weak #5) — results must match the
    naive per-member loop exactly."""

    def _members(self, cfg, k=2):
        from edrl.train.trainer import init_state

        return [init_state(cfg, seed)[1] for seed in range(k)]

    @pytest.mark.slow
    def test_vmapped_matches_per_member_loop(self):
        import jax
        import numpy as np

        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.ensemble import ensemble_predict
        from edrl.train.trainer import _normalize_output, make_model

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, model_name="Multi_DE1_ResNet")
        )
        states = self._members(cfg)
        loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="val"), 4, shuffle=False,
            drop_last=False,
        )
        pred = ensemble_predict(cfg, states, loader)

        model = make_model(cfg)
        naive_probs, naive_targets = [], []
        for batch in loader.epoch(0):
            logits = np.mean(
                [
                    np.asarray(
                        _normalize_output(
                            model.apply(
                                {"params": s.params, "batch_stats": s.batch_stats},
                                batch["fundus_low"], batch["oct_low"],
                                batch["label"], train=False,
                            )
                        )[0]
                    )
                    for s in states
                ],
                axis=0,
            )
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            naive_probs.append(e / e.sum(axis=1, keepdims=True))
            naive_targets.append(np.asarray(batch["label"]))
        np.testing.assert_allclose(
            pred["probs"], np.concatenate(naive_probs), atol=1e-5
        )
        np.testing.assert_array_equal(
            pred["targets"], np.concatenate(naive_targets)
        )

    def test_handles_uint8_transport_batches(self):
        import numpy as np

        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.ensemble import ensemble_predict

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, device_noise=True),
            model=dataclasses.replace(cfg.model, model_name="Multi_DE1_ResNet"),
        )
        states = self._members(cfg)
        loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="val"), 4, shuffle=False,
            drop_last=False, uint8_transport=True,
        )
        pred = ensemble_predict(cfg, states, loader)
        assert np.all(np.isfinite(pred["probs"]))
        np.testing.assert_allclose(pred["probs"].sum(axis=1), 1.0, atol=1e-4)


class TestFourClassTraining:
    @pytest.mark.slow
    def test_medfusion_trains_4_classes(self):
        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.metrics import auc_ovr
        from edrl.train.trainer import fit, make_eval_step, make_model, run_eval
        from edrl.train.trainer import init_state

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            data=dataclasses.replace(
                cfg.data, num_classes=4, num_synthetic_samples=16
            ),
            model=dataclasses.replace(cfg.model, num_classes=4),
            train=dataclasses.replace(cfg.train, end_epochs=1, log_dir=""),
        )
        train_ds = SyntheticGammaDataset(cfg.data, mode="train")
        val_ds = SyntheticGammaDataset(cfg.data, mode="val")
        labels = {int(train_ds.get(i)["label"]) for i in range(len(train_ds))}
        assert labels == {0, 1, 2, 3}, "synthetic dataset must emit 4 classes"

        train_loader = BatchLoader(train_ds, 4, seed=0)
        val_loader = BatchLoader(val_ds, 4, shuffle=False, drop_last=False)
        state, result = fit(cfg, train_loader, val_loader, verbose=False)
        assert np.isfinite(result.train_history[-1].loss)

        eval_step = make_eval_step(make_model(cfg), cfg)
        m, targets, probs = run_eval(state, eval_step, val_loader)
        assert probs.shape[1] == 4
        # OvR AUC is exercised (finite; untrained-tiny so no quality bar).
        assert np.isfinite(auc_ovr(targets, probs)) or len(np.unique(targets)) < 2
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)

    def test_cli_parser_carries_num_classes(self):
        from edrl.cli.train import build_parser, config_from_args

        args = build_parser().parse_args(
            ["--num_classes", "4", "--dataset", "synthetic"]
        )
        cfg = config_from_args(args)
        assert cfg.data.num_classes == 4
        assert cfg.model.num_classes == 4
