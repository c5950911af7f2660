"""End-to-end trainer tests: smoke train on synthetic data, checkpoint
round-trip, missing-modality eval, CSV logging."""

import os

import jax
import numpy as np
import pytest

from edrl.config import tiny_test_config
from edrl.data import BatchLoader, SyntheticGammaDataset
from edrl.train import metrics as metrics_lib
from edrl.train.checkpoint import CheckpointManager
from edrl.train.trainer import (
    fit,
    init_state,
    make_eval_step,
    make_model,
    make_optimizer,
    make_train_step,
    run_eval,
)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    c = tiny_test_config(batch_size=4)
    return c.replace(
        train=c.train.__class__(
            lr=3e-4, end_epochs=2, log_dir=str(tmp_path_factory.mktemp("log"))
        )
    )


@pytest.fixture(scope="module")
def loaders(cfg):
    train_ds = SyntheticGammaDataset(cfg.data, mode="train")
    val_ds = SyntheticGammaDataset(cfg.data, mode="val")
    return (
        BatchLoader(train_ds, cfg.data.batch_size, num_workers=2, seed=0),
        BatchLoader(val_ds, cfg.data.batch_size, shuffle=False, num_workers=2),
    )


@pytest.fixture(scope="module")
def fitted(cfg, loaders):
    train_loader, val_loader = loaders
    state, result = fit(cfg, train_loader, val_loader, verbose=False)
    return state, result


class TestSmokeTrain:
    @pytest.mark.slow
    def test_losses_finite_and_decreasing_trend(self, fitted):
        state, result = fitted
        losses = [m.loss for m in result.train_history]
        assert all(np.isfinite(l) for l in losses)
        assert len(losses) == 2

    def test_val_metrics_computed(self, fitted):
        _, result = fitted
        vm = result.val_history[-1]
        assert 0.0 <= vm.accuracy <= 1.0
        assert np.isfinite(vm.loss)

    def test_csv_log_written(self, fitted, cfg):
        files = os.listdir(cfg.train.log_dir)
        assert any(f.endswith(".csv") for f in files)
        path = os.path.join(cfg.train.log_dir, [f for f in files if f.endswith(".csv")][0])
        lines = open(path).read().strip().splitlines()
        assert lines[0].startswith("Epoch,Loss,Accuracy")
        assert len(lines) >= 3  # header + 2 epochs

    def test_csv_resume_drops_replayed_epoch_rows(self, tmp_path):
        """Preemption resume re-runs epochs after the restored `latest`; the
        writer must drop the pre-crash rows for those epochs or the CSV
        double-counts them."""
        from edrl.train.logging import CsvMetricWriter
        from edrl.train.metrics import EpochMetrics

        path = str(tmp_path / "m.csv")
        w = CsvMetricWriter(path)
        m = EpochMetrics(1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5)
        for e in (1, 2, 3, 4):
            w.write(e, m)
        assert w.drop_rows_from(3) == 2  # epochs 3 and 4 replayed
        rows = open(path).read().strip().splitlines()
        assert [r.split(",")[0] for r in rows] == ["Epoch", "1", "2"]
        assert w.drop_rows_from(3) == 0  # idempotent


class TestLongerTrainingLearns:
    @pytest.mark.slow
    def test_loss_decreases_over_epochs(self, cfg, loaders):
        """8 epochs on the synthetic class signal must reduce train loss."""
        train_loader, val_loader = loaders
        c = cfg.replace(train=cfg.train.__class__(lr=3e-4, end_epochs=8, log_dir=""))
        state, result = fit(c, train_loader, val_loader, verbose=False)
        losses = [m.loss for m in result.train_history]
        assert losses[-1] < losses[0], losses


class TestCheckpoint:
    def test_roundtrip(self, cfg, fitted, tmp_path):
        state, _ = fitted
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save_best(state, epoch=2, accuracy=0.75)
        assert mgr.best_info()["accuracy"] == 0.75
        _, template = init_state(cfg, 0)
        restored = mgr.restore(template, "best")
        leaf_a = jax.tree_util.tree_leaves(state.params)[0]
        leaf_b = jax.tree_util.tree_leaves(restored.params)[0]
        np.testing.assert_array_equal(np.asarray(leaf_a), np.asarray(leaf_b))
        assert int(restored.step) == int(state.step)

    @pytest.mark.slow
    def test_async_save_overlaps_and_survives_donation(self, cfg, tmp_path):
        """The async save must snapshot before returning: donating the live
        state's buffers right after save() (exactly what the next train step
        does) must not corrupt the checkpoint; sync mode behaves the same."""
        for sub, async_save in (("a", True), ("s", False)):
            _, state = init_state(cfg, 7)
            expected = np.asarray(jax.tree_util.tree_leaves(state.params)[0])
            mgr = CheckpointManager(
                str(tmp_path / f"ckpt_{sub}"), async_save=async_save
            )
            mgr.save(state, name="latest")
            # Donate the state's buffers for real while the disk write may
            # still be in flight — XLA reuses donated memory, so the save
            # must have snapshotted to host before returning.
            donate = jax.jit(
                lambda p: jax.tree_util.tree_map(lambda x: x * 0.0, p),
                donate_argnums=0,
            )
            jax.block_until_ready(donate(state.params))
            mgr.wait()
            _, template = init_state(cfg, 0)
            restored = mgr.restore(template, "latest")
            leaf_b = jax.tree_util.tree_leaves(restored.params)[0]
            np.testing.assert_array_equal(expected, np.asarray(leaf_b))

    def test_best_watermark_published_after_commit(
        self, cfg, tmp_path, monkeypatch
    ):
        """save_best must drain the async write BEFORE writing best.json:
        resume trusts the watermark as initial_best, so it must never be
        ahead of the committed ``best`` directory (a phantom watermark would
        block better-than-actual epochs from ever being saved)."""
        _, state = init_state(cfg, 3)
        mgr = CheckpointManager(str(tmp_path / "bw"))

        class FakeAsyncCkptr:
            """Models the async contract: save() leaves a write in flight;
            only wait_until_finished() commits it."""

            pending = False
            committed = False

            def save(self, path, item, force=False):
                self.pending = True

            def wait_until_finished(self):
                if self.pending:
                    self.committed = True
                    self.pending = False

        fake = FakeAsyncCkptr()
        monkeypatch.setattr(mgr, "_ckptr", fake)
        mgr.save_best(state, epoch=1, accuracy=0.5)
        # Regression: previously save_best returned (best.json written) with
        # the async write still in flight.
        assert fake.committed and not fake.pending
        assert mgr.best_info() == {"epoch": 1, "accuracy": 0.5}

    @pytest.mark.slow
    def test_restored_state_evaluates_identically(self, cfg, fitted, loaders, tmp_path):
        state, _ = fitted
        _, val_loader = loaders
        mgr = CheckpointManager(str(tmp_path / "ckpt2"))
        mgr.save(state)
        _, template = init_state(cfg, 0)
        restored = mgr.restore(template)
        eval_step = make_eval_step(make_model(cfg), cfg)
        m1, t1, p1 = run_eval(state, eval_step, val_loader)
        m2, t2, p2 = run_eval(restored, eval_step, val_loader)
        np.testing.assert_allclose(p1, p2, rtol=1e-6)


class TestResume:
    @pytest.mark.slow
    def test_resume_is_step_identical_to_uninterrupted(self, cfg, loaders, tmp_path):
        """Crash after epoch 2 of 4, resume_from_latest, finish — the final
        params must equal the uninterrupted 4-epoch run's (epoch-indexed
        loader shuffles + step-folded PRNG make resume exact)."""
        import dataclasses

        from edrl.train.trainer import resume_from_latest

        train_loader, val_loader = loaders
        base = cfg.replace(
            train=dataclasses.replace(
                cfg.train, end_epochs=4, save_latest_every=1, log_dir=""
            )
        )
        state_a, _ = fit(base, train_loader, val_loader, verbose=False)

        mgr = CheckpointManager(str(tmp_path / "resume_ckpt"))
        half = base.replace(train=dataclasses.replace(base.train, end_epochs=2))
        fit(half, train_loader, val_loader, checkpoint_manager=mgr, verbose=False)

        # "Fresh process": resume from the rolling latest.
        resumed = resume_from_latest(base, mgr, train_loader)
        assert resumed is not None
        state_r, rcfg, _, done = resumed
        assert done == 2 and rcfg.train.start_epoch == 3
        state_b, _ = fit(
            rcfg, train_loader, val_loader, state=state_r,
            checkpoint_manager=mgr, verbose=False,
        )
        assert int(state_b.step) == int(state_a.step)
        for la, lb in zip(
            jax.tree_util.tree_leaves(state_a.params),
            jax.tree_util.tree_leaves(state_b.params),
        ):
            np.testing.assert_allclose(
                np.asarray(la, np.float32), np.asarray(lb, np.float32),
                atol=1e-6, rtol=1e-6,
            )

    @pytest.mark.slow
    def test_resume_respects_nondefault_start_epoch(self, cfg, loaders, tmp_path):
        """A run launched with --start_epoch 3 that completed epochs 3-4 must
        resume at epoch 5, not epoch 3 (the step counter counts steps since
        the configured start, so the offset must be added back)."""
        import dataclasses

        from edrl.train.trainer import resume_from_latest

        train_loader, val_loader = loaders
        base = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                start_epoch=3,
                end_epochs=4,
                save_latest_every=1,
                log_dir="",
            )
        )
        mgr = CheckpointManager(str(tmp_path / "offset_ckpt"))
        fit(base, train_loader, val_loader, checkpoint_manager=mgr, verbose=False)

        resumed = resume_from_latest(base, mgr, train_loader)
        assert resumed is not None
        _, rcfg, _, done = resumed
        assert done == 2  # epochs 3 and 4 ran
        assert rcfg.train.start_epoch == 5

    def test_resume_without_latest_returns_none(self, cfg, loaders, tmp_path):
        from edrl.train.trainer import resume_from_latest

        train_loader, _ = loaders
        mgr = CheckpointManager(str(tmp_path / "empty_ckpt"))
        assert resume_from_latest(cfg, mgr, train_loader) is None


class TestMissingModality:
    def test_all_three_configurations(self, cfg, fitted, loaders):
        """fundus-only / OCT-only / both must all run."""
        state, _ = fitted
        _, val_loader = loaders
        eval_step = make_eval_step(make_model(cfg), cfg)
        for mask in ([True, True], [True, False], [False, True]):
            m, _, probs = run_eval(
                state, eval_step, val_loader, modality_mask=np.array(mask)
            )
            assert np.all(np.isfinite(probs)), mask
            assert 0.0 <= m.accuracy <= 1.0


class TestUncertaintySuiteOnEval:
    def test_uncertainty_metrics_from_eval(self, fitted, loaders):
        state, _ = fitted
        _, val_loader = loaders
        cfg_model = fitted  # placeholder to keep signature simple
        from edrl.config import tiny_test_config

        c = tiny_test_config(batch_size=4)
        eval_step = make_eval_step(make_model(c), c)
        _, targets, probs = run_eval(state, eval_step, val_loader)
        suite = metrics_lib.compute_uncertainty_metrics(targets, probs)
        assert set(suite) >= {"accuracy", "auc", "ece", "nll", "brier", "kappa"}


class TestJSDistillation:
    @pytest.mark.slow
    def test_js_weight_changes_loss(self):
        """js_distillation_weight > 0 must alter the training loss (the
        reference's commented-out logit distillation, made configurable)."""
        import dataclasses
        import jax

        from edrl.config import tiny_test_config
        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        cfg0 = tiny_test_config(batch_size=4)
        cfg1 = cfg0.replace(
            train=dataclasses.replace(cfg0.train, js_distillation_weight=10.0)
        )
        _, state0 = init_state(cfg0, 0)
        _, state1 = init_state(cfg1, 0)
        loader = BatchLoader(
            SyntheticGammaDataset(cfg0.data, mode="train"), 4, shuffle=False,
            num_workers=2,
        )
        batch = jax.tree_util.tree_map(
            jax.numpy.asarray, next(iter(loader.epoch(0)))
        )
        key = jax.numpy.asarray(jax.random.key(5))
        s0 = make_train_step(make_model(cfg0), make_optimizer(cfg0), cfg0)
        s1 = make_train_step(make_model(cfg1), make_optimizer(cfg1), cfg1)
        _, out0 = s0(state0, batch, key)
        _, out1 = s1(state1, batch, key)
        assert float(out1["loss"]) != pytest.approx(float(out0["loss"]), rel=1e-9)


class TestPlateauSchedule:
    def test_tracker_reduces_after_patience(self):
        from edrl.train.trainer import PlateauTracker

        t = PlateauTracker(lr=1e-3, factor=0.1, patience=2)
        assert t.step(1.0) is None  # first value = improvement
        assert t.step(1.0) is None  # bad 1
        assert t.step(1.0) is None  # bad 2 (== patience)
        assert t.step(1.0) == pytest.approx(1e-4)  # bad 3 -> reduce
        assert t.step(0.5) is None  # improvement resets

    def test_set_learning_rate_mutates_opt_state(self, cfg):
        from edrl.train.trainer import (
            get_learning_rate,
            init_state,
            set_learning_rate,
        )

        _, state = init_state(cfg, 0)
        state = set_learning_rate(state, 5e-5)
        assert float(state.opt_state[1].hyperparams["learning_rate"]) == (
            pytest.approx(5e-5)
        )
        assert get_learning_rate(state) == pytest.approx(5e-5)

    @pytest.mark.slow
    def test_plateau_resumes_from_live_lr_not_lr0(self, cfg, loaders):
        """A resumed state carrying a pre-crash plateau reduction must seed
        the tracker with the REDUCED lr: restarting at lr0 would let the
        first post-resume plateau event raise the lr (lr0*factor > live)."""
        import dataclasses

        from edrl.train.trainer import (
            fit,
            get_learning_rate,
            init_state,
            set_learning_rate,
        )

        c = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                end_epochs=2,
                log_dir="",
                use_plateau_schedule=True,
                plateau_factor=0.1,
                plateau_patience=0,
            )
        )
        _, state = init_state(c, 0)
        reduced = c.train.lr * 0.01  # as if two pre-crash reductions happened
        state = set_learning_rate(state, reduced)
        train_loader, val_loader = loaders
        state, _ = fit(c, train_loader, val_loader, state=state, verbose=False)
        # Any post-resume reduction must start from `reduced`, never from
        # lr0: the final live lr can only be reduced * factor^k, k >= 0.
        final = get_learning_rate(state)
        assert final <= reduced * (1 + 1e-6), (final, reduced)


class TestWarmup:
    """warmup_steps: multiplicative linear LR warmup downstream of the
    injected base lr (framework extension; the reference is constant-lr)."""

    def test_default_warmup_flagship_on_tiny_off(self):
        """The flagship default is 100 warmup steps (PARITY.md deviation:
        constant lr leaves full EDRL on its init plateau on some seeds,
        ABLATION_FUSION_WARMUP.md); the tiny test config opts out because
        its runs are shorter than the ramp."""
        from edrl.config import EDRLConfig, tiny_test_config

        assert EDRLConfig().train.warmup_steps == 100
        assert tiny_test_config().train.warmup_steps == 0

    def test_warmup_scales_adam_updates_exactly(self):
        """scale_by_schedule sits AFTER adam in the chain, so with identical
        grads the warmed update equals the unwarmed one times
        min((step+1)/w, 1) — exactly, at every step."""
        import dataclasses

        import jax
        import jax.numpy as jnp
        import optax

        from edrl.config import tiny_test_config
        from edrl.train.trainer import make_optimizer

        c0 = tiny_test_config(batch_size=4)
        w = 4
        c1 = c0.replace(train=dataclasses.replace(c0.train, warmup_steps=w))
        params = {"k": jnp.ones((3, 2)), "b": jnp.arange(2.0)}
        grads = {"k": jnp.full((3, 2), 0.3), "b": jnp.array([0.1, -0.2])}
        tx0, tx1 = make_optimizer(c0), make_optimizer(c1)
        s0, s1 = tx0.init(params), tx1.init(params)
        for step in range(w + 2):
            u0, s0 = tx0.update(grads, s0, params)
            u1, s1 = tx1.update(grads, s1, params)
            factor = min((step + 1) / w, 1.0)
            jax.tree.map(
                lambda a, b: np.testing.assert_allclose(
                    np.asarray(b), np.asarray(a) * factor, rtol=1e-6
                ),
                u0,
                u1,
            )

    def test_lr_injection_composes_with_warmup(self, cfg):
        """set/get_learning_rate address opt_state index 1 (the injected
        adam); appending the warmup element must not move that index."""
        import dataclasses

        from edrl.train.trainer import (
            get_learning_rate,
            init_state,
            set_learning_rate,
        )

        c = cfg.replace(train=dataclasses.replace(cfg.train, warmup_steps=8))
        _, state = init_state(c, 0)
        state = set_learning_rate(state, 5e-5)
        assert get_learning_rate(state) == pytest.approx(5e-5)

    def test_grad_clip_identity_below_threshold_active_above(self):
        """clip_by_global_norm upstream of adam: a threshold above every
        step's gradient norm leaves the chain's updates bit-identical to the
        unclipped optimizer, while a threshold that clips step 1 changes
        step 2 (adam's single-step update is scale-invariant — m/sqrt(v)
        cancels a uniform rescale — so the effect is only visible through
        the moment history across steps with different gradient scales)."""
        import dataclasses

        import jax.numpy as jnp

        from edrl.config import tiny_test_config
        from edrl.train.trainer import make_optimizer

        c0 = tiny_test_config(batch_size=4)
        params = {"k": jnp.ones((3, 2))}
        g_big = {"k": jnp.full((3, 2), 4.0)}  # global norm ~9.8
        g_small = {"k": jnp.full((3, 2), 0.1)}  # global norm ~0.24

        def two_step_update(cfg):
            opt = make_optimizer(cfg)
            st = opt.init(params)
            _, st = opt.update(g_big, st, params)
            u2, _ = opt.update(g_small, st, params)
            return np.asarray(u2["k"])

        above = c0.replace(
            train=dataclasses.replace(c0.train, grad_clip_norm=100.0)
        )
        clipping = c0.replace(
            train=dataclasses.replace(c0.train, grad_clip_norm=1.0)
        )
        u_plain = two_step_update(c0)
        u_above = two_step_update(above)
        u_clipping = two_step_update(clipping)
        np.testing.assert_array_equal(u_plain, u_above)
        assert not np.allclose(u_plain, u_clipping)

    def test_lr_injection_found_by_structure(self, cfg):
        """Optional chain elements (clip upstream, warmup downstream) move
        the injected-adam element; set/get_learning_rate must find it by
        structure in every combination."""
        import dataclasses

        from edrl.train.trainer import (
            get_learning_rate,
            init_state,
            set_learning_rate,
        )

        for knobs in (
            {"grad_clip_norm": 1.0},
            {"grad_clip_norm": 1.0, "warmup_steps": 4},
        ):
            c = cfg.replace(train=dataclasses.replace(cfg.train, **knobs))
            _, state = init_state(c, 0)
            state = set_learning_rate(state, 7e-5)
            assert get_learning_rate(state) == pytest.approx(7e-5), knobs

    @pytest.mark.slow
    def test_warmup_train_step_runs(self, cfg, loaders):
        """One fit() epoch with warmup on: runs, loss finite."""
        import dataclasses

        from edrl.train.trainer import fit, init_state

        c = cfg.replace(
            train=dataclasses.replace(
                cfg.train, warmup_steps=3, end_epochs=1, log_dir=""
            )
        )
        _, state = init_state(c, 0)
        train_loader, val_loader = loaders
        state, result = fit(c, train_loader, val_loader, state=state,
                             verbose=False)
        assert np.isfinite(result.train_history[-1].loss)


class TestObservabilityWiring:
    """fit() actually emits the reference's observability artifacts
    (VERDICT r2 missing #1): end-of-run loss/acc curve jpgs
    (``fusion_train.py:771-772``), periodic Student-t proxy PDFs
    (``fusion_net.py:852-868`` — dead in the reference, wired here), and
    per-epoch ``epoch_{N}`` checkpoints for ``--test_epoch``."""

    @pytest.mark.slow
    def test_fit_emits_plots_pdfs_and_epoch_checkpoints(self, cfg, loaders, tmp_path):
        import dataclasses

        plot_dir = str(tmp_path / "plot")
        ckpt_dir = str(tmp_path / "ckpt")
        c = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                end_epochs=1,
                log_dir="",
                plot_dir=plot_dir,
                student_t_every=1,
                save_every=1,
            )
        )
        train_loader, val_loader = loaders
        mgr = CheckpointManager(ckpt_dir)
        fit(c, train_loader, val_loader, checkpoint_manager=mgr, verbose=False)
        names = os.listdir(plot_dir)
        stem = f"{c.model.model_name}_{c.data.batch_size}_{c.data.dataset}_1"
        assert f"{stem}_loss.jpg" in names, names
        assert f"{stem}_acc.jpg" in names, names
        assert "students_t_distributions_epoch_1.pdf" in names, names
        assert os.path.isdir(os.path.join(ckpt_dir, "epoch_1"))

    def test_setup_logging_idempotent(self, tmp_path):
        from edrl.train.logging import setup_logging

        log_file = str(tmp_path / "x.log")
        logger = setup_logging(log_file)
        logger = setup_logging(log_file)
        assert len(logger.handlers) == 2  # file + console, not stacked
        logger.info("hello")
        assert "hello" in open(log_file).read()


class TestScanBatches:
    """scan_batches must be bit-compatible with per-batch dispatch: the step
    fn folds the PRNG with state.step, which advances identically inside the
    scan, so the two paths run the same numerical program."""

    def _fit(self, cfg, scan_batches):
        import dataclasses

        c = cfg.replace(
            train=dataclasses.replace(
                cfg.train, scan_batches=scan_batches, log_dir=""
            )
        )
        train_ds = SyntheticGammaDataset(c.data, mode="train")
        val_ds = SyntheticGammaDataset(c.data, mode="val")
        train_loader = BatchLoader(
            train_ds, c.data.batch_size, num_workers=1, seed=0
        )
        val_loader = BatchLoader(
            val_ds, c.data.batch_size, shuffle=False, num_workers=1
        )
        return fit(c, train_loader, val_loader, verbose=False)

    @pytest.mark.slow
    def test_scanned_matches_per_batch(self, cfg):
        state_a, result_a = self._fit(cfg, scan_batches=0)
        state_b, result_b = self._fit(cfg, scan_batches=2)
        la = [m.loss for m in result_a.train_history]
        lb = [m.loss for m in result_b.train_history]
        np.testing.assert_allclose(la, lb, rtol=2e-4)
        pa = jax.tree_util.tree_leaves(state_a.params)
        pb = jax.tree_util.tree_leaves(state_b.params)
        for a, b in zip(pa, pb):
            np.testing.assert_allclose(
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                atol=2e-4, rtol=2e-3,
            )

    @pytest.mark.slow
    def test_remainder_batches_dispatch_singly(self, cfg):
        # scan_batches larger than the epoch: everything goes through the
        # remainder path; results must still match.
        _, result_a = self._fit(cfg, scan_batches=0)
        _, result_b = self._fit(cfg, scan_batches=64)
        la = [m.loss for m in result_a.train_history]
        lb = [m.loss for m in result_b.train_history]
        np.testing.assert_allclose(la, lb, rtol=2e-4)


class TestScanCarryCongruence:
    """The train-step output must be pytree-congruent with its input state:
    ``lax.scan`` (epoch runner, bench) requires identical carry TYPES.  For
    models without batch stats, init_state used to hold an empty FrozenDict
    while the mutable apply returned a plain {} — fine under per-step jit,
    a TypeError inside every scanned path (caught benching Trans_cross)."""

    @pytest.mark.slow
    def test_stateless_model_step_is_scan_congruent(self):
        import dataclasses

        import jax
        import numpy as np

        from edrl.config import tiny_test_config
        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        cfg = tiny_test_config(batch_size=4)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, model_name="Trans_cross")
        )
        model, state = init_state(cfg, 0)
        assert not jax.tree_util.tree_leaves(state.batch_stats)
        step = make_train_step(model, make_optimizer(cfg), cfg, jit=False)
        rng = np.random.default_rng(0)
        batch = {
            "fundus_low": rng.uniform(size=(4, 64, 64, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(4, 64, 64, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(4, 32, 32, 32, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(4, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=4).astype(np.int32),
        }
        batch = jax.tree_util.tree_map(jax.numpy.asarray, batch)

        def body(carry, _):
            new_state, out = step(carry, batch, jax.random.key(0))
            return new_state, out["loss"]

        # Two scanned steps: fails loudly on any carry-structure mismatch.
        final, losses = jax.lax.scan(body, state, None, length=2)
        assert np.isfinite(np.asarray(losses)).all()
        assert (
            jax.tree_util.tree_structure(final)
            == jax.tree_util.tree_structure(state)
        )


class TestEvalRemainderWeighting:
    """run_eval's epoch-mean loss weights each batch by its REAL sample
    count, so a small remainder batch (or its mesh-padding duplicates) no
    longer carries a full batch's weight (VERDICT r4 weak #4)."""

    class _Loader:
        def __init__(self, batches):
            self._batches = batches

        def epoch(self, _):
            return iter(self._batches)

    @staticmethod
    def _stub_eval_step(state, batch, modality_mask=None):
        import jax.numpy as jnp

        y = batch["label"]
        b = y.shape[0]
        # Per-batch "loss" = mean label value (content-dependent, so the
        # weighting is observable); uniform probs.
        return {
            "loss": jnp.mean(y.astype(jnp.float32)),
            "probs": jnp.full((b, 2), 0.5, jnp.float32),
        }

    def test_sample_weighted_mean(self):
        from edrl.train.trainer import run_eval

        # 8 zeros then 2 ones: sample-weighted mean = 0.2; the old
        # equal-batch-weight mean was 0.5.
        batches = [
            {"label": np.zeros(8, np.int32)},
            {"label": np.ones(2, np.int32)},
        ]
        m, targets, probs = run_eval(None, self._stub_eval_step, self._Loader(batches))
        assert m.loss == pytest.approx(0.2)
        assert targets.shape[0] == 10 and probs.shape[0] == 10

    def test_mesh_padding_does_not_inflate_remainder(self):
        from edrl.parallel import make_mesh
        from edrl.train.trainer import run_eval

        mesh = make_mesh(num_data=8, num_model=1)
        batches = [
            {"label": np.zeros(8, np.int32)},
            {"label": np.ones(2, np.int32)},  # padded to 8 under the mesh
        ]
        m, targets, probs = run_eval(
            None, self._stub_eval_step, self._Loader(batches), mesh=mesh
        )
        # Padded duplicate rows keep the batch mean at 1.0 here, and the
        # batch still weighs only its 2 real rows.
        assert m.loss == pytest.approx(0.2)
        assert targets.shape[0] == 10 and probs.shape[0] == 10
