"""Hard synthetic protocol + ablation knobs.

The hard generator must (a) carry a per-class signal, (b) drop it per
modality with the configured probability (never both), (c) not be solvable
by the trivial intensity shortcut of the easy generator; the ``mmd_weight=0``
ablation must skip the second forward and still train.
"""

import dataclasses

import numpy as np
import pytest

from edrl.config import tiny_test_config
from edrl.data import BatchLoader, HardSyntheticGammaDataset


@pytest.fixture(scope="module")
def cfg():
    c = tiny_test_config(batch_size=4)
    return c.replace(
        data=dataclasses.replace(
            c.data, dataset="synthetic_hard", num_synthetic_samples=64,
            device_noise=True, uint8_transport=False,
        )
    )


class TestHardDataset:
    def test_schema_and_determinism(self, cfg):
        ds = HardSyntheticGammaDataset(cfg.data, mode="train")
        s1 = ds._base_sample(3)
        s2 = ds._base_sample(3)
        np.testing.assert_array_equal(s1[0], s2[0])
        assert s1[0].shape == (cfg.data.fundus_size, cfg.data.fundus_size, 3)
        assert s1[1].shape == cfg.data.oct_size
        assert s1[2] in (0, 1)

    def test_signal_dropout_never_both(self, cfg):
        """Reconstruct the has-signal draws: each modality ~70%, never 0/0."""
        ds = HardSyntheticGammaDataset(cfg.data, mode="train")
        both_missing = 0
        f_has = o_has = 0
        n = 200
        for i in range(n):
            rng = np.random.default_rng(np.random.SeedSequence([99177, i]))
            u = rng.uniform()
            fh = u >= ds.signal_dropout
            oh = not (ds.signal_dropout <= u < 2 * ds.signal_dropout)
            f_has += fh
            o_has += oh
            both_missing += (not fh) and (not oh)
        assert both_missing == 0
        assert 0.55 < f_has / n < 0.85
        assert 0.55 < o_has / n < 0.85

    def test_no_intensity_shortcut(self, cfg):
        """Unlike the easy generator, per-class mean intensity overlaps:
        a threshold on the image mean must not separate the classes."""
        ds = HardSyntheticGammaDataset(cfg.data, mode="train")
        means = {0: [], 1: []}
        for i in range(40):
            f, o, y = ds._base_sample(i)
            means[y].append(float(f.mean()))
        gap = abs(np.mean(means[0]) - np.mean(means[1]))
        spread = (np.std(means[0]) + np.std(means[1])) / 2
        assert gap < 2 * spread, "class means must overlap (no trivial shortcut)"

    def test_loader_integration(self, cfg):
        ds = HardSyntheticGammaDataset(cfg.data, mode="val")
        loader = BatchLoader(ds, 4, shuffle=False, drop_last=False)
        batch = next(iter(loader.epoch(0)))
        assert "fundus" in batch and "oct" in batch and "label" in batch


class TestMmdWeightAblation:
    @pytest.mark.slow
    def test_zero_weight_trains_and_reports_zero_mmd(self, cfg):
        import jax

        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        c = cfg.replace(train=dataclasses.replace(cfg.train, mmd_weight=0.0))
        _, state = init_state(c, 0)
        step = make_train_step(make_model(c), make_optimizer(c), c)
        d = c.data
        rng = np.random.default_rng(0)
        batch = {
            "fundus_low": rng.uniform(size=(4, d.fundus_size, d.fundus_size, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(4, d.fundus_size, d.fundus_size, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(4, *d.oct_size, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(4, *d.oct_size, 1)).astype(np.float32),
            "label": np.array([0, 1, 0, 1], np.int32),
        }
        # snapshot before the step: the jitted step donates the state buffers
        p0 = np.asarray(jax.tree_util.tree_leaves(state.params)[0])
        new_state, out = step(state, batch, jax.random.key(0))
        assert np.isfinite(float(out["loss"]))
        assert float(out["mmd"]) == 0.0
        # params actually updated
        p1 = np.asarray(jax.tree_util.tree_leaves(new_state.params)[0])
        assert not np.allclose(p0, p1)

    @pytest.mark.slow
    def test_js_distillation_survives_zero_mmd_weight(self, cfg):
        """-MMD +JSD must still run the second forward: the skip-the-
        high-view optimization is only valid when BOTH dual-view terms are
        off (previously mmd_weight==0 alone dropped the JS term silently,
        making a '+JSD' ablation identical to plain '-MMD')."""
        import jax

        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        d = cfg.data
        rng = np.random.default_rng(0)
        batch = {
            "fundus_low": rng.uniform(size=(4, d.fundus_size, d.fundus_size, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(4, d.fundus_size, d.fundus_size, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(4, *d.oct_size, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(4, *d.oct_size, 1)).astype(np.float32),
            "label": np.array([0, 1, 0, 1], np.int32),
        }
        losses = {}
        for js in (0.0, 10.0):
            c = cfg.replace(
                train=dataclasses.replace(
                    cfg.train, mmd_weight=0.0, js_distillation_weight=js
                )
            )
            _, state = init_state(c, 0)
            step = make_train_step(make_model(c), make_optimizer(c), c)
            _, out = step(state, dict(batch), jax.random.key(0))
            losses[js] = float(out["loss"])
        assert np.isfinite(losses[10.0])
        assert losses[10.0] != losses[0.0], losses

    def test_variant_configs(self):
        import importlib.util
        import os

        spec = importlib.util.spec_from_file_location(
            "ablation_study",
            os.path.join(
                os.path.dirname(__file__), "..", "scripts", "ablation_study.py"
            ),
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        VARIANTS, base_config, variant = mod.VARIANTS, mod.base_config, mod.variant

        class A:  # minimal args shim (mirror every field base_config reads)
            batch_size = 4
            train_samples = 16
            epochs = 1
            lr = 1e-4
            warmup_steps = 0
            fundus_size = 64
            oct_size = 32
            scan_batches = 0
            protocol = "hard"

        cfg = base_config(A)
        v = {name: variant(cfg, name) for name in VARIANTS}
        assert v["MedFusion -MMD"].train.mmd_weight == 0.0
        assert v["MedFusion -EPRL"].model.proxy_weight_train == 0.0
        assert v["MedFusion -DILR"].model.dilr_weight == 0.0
        assert v["Multi_ResNet (late fusion)"].model.model_name == "Multi_ResNet"

    def test_fusion_protocol_markdown(self):
        """to_markdown(protocol='fusion') renders the advantage table from
        fabricated rows — catches schema drift before a multi-hour study."""
        import importlib.util
        import os

        spec = importlib.util.spec_from_file_location(
            "ablation_study",
            os.path.join(
                os.path.dirname(__file__), "..", "scripts", "ablation_study.py"
            ),
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        sigmas = (0.0, 0.5)
        def row(name, seed, both, fo, oo):
            return {
                "name": name,
                "seed": seed,
                "best_val_acc": both,
                "final_train_loss": 1.0,
                "train_time_s": 10.0,
                "sweep": {
                    m: {s: {"accuracy": a, "auc": a} for s in sigmas}
                    for m, a in (
                        ("both", both), ("fundus-only", fo), ("oct-only", oo)
                    )
                },
            }

        rows = [
            row("MedFusion (full EDRL)", s, 0.95, 0.74, 0.76) for s in (0, 1)
        ] + [
            row("Multi_ResNet (late fusion)", s, 0.78, 0.5, 0.77)
            for s in (0, 1)
        ]
        md = mod.to_markdown(
            rows,
            sigmas,
            variants=("MedFusion (full EDRL)", "Multi_ResNet (late fusion)"),
            protocol="fusion",
        )
        assert "Fusion advantage" in md
        # full EDRL: 0.95 - max(0.74, 0.76) = 0.19
        assert "0.19±0.00" in md
        # late fusion: 0.78 - 0.77 = 0.01
        assert "0.01±0.00" in md
        # the hard-protocol claim check must NOT be appended for fusion
        assert "claim check" not in md.lower()

        # With every variant present, the appended ABLATION_FUSION_ANALYSIS
        # commentary must have all {{placeholder}} aggregates resolved.
        all_rows = [
            row(name, s, 0.9, 0.7, 0.72)
            for name in mod.VARIANTS
            for s in (0, 1)
        ]
        md = mod.to_markdown(all_rows, sigmas, protocol="fusion")
        assert "Reading the fusion-protocol table" in md
        assert "{{" not in md, md[md.find("{{") - 80 : md.find("{{") + 120]

    def test_output_keyed_analysis_appendix(self, tmp_path):
        """A non-default --output gets its own <stem>_ANALYSIS.md appendix
        (or none at all if absent) — never the default study's narrative.
        Also renders the committed LONG analysis, asserting every
        {{placeholder}} it quotes resolves once all five study variants
        have rows (the mechanism-attribution sections quote the ablated
        variants too, so full+late alone is no longer sufficient)."""
        import importlib.util
        import os

        repo = os.path.join(os.path.dirname(__file__), "..")
        spec = importlib.util.spec_from_file_location(
            "ablation_study", os.path.join(repo, "scripts", "ablation_study.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        sigmas = (0.0, 0.5)
        def row(name, seed):
            return {
                "name": name, "seed": seed, "best_val_acc": 0.9,
                "final_train_loss": 0.5, "train_time_s": 10.0,
                "sweep": {
                    m: {s: {"accuracy": 0.8, "auc": 0.8} for s in sigmas}
                    for m in ("both", "fundus-only", "oct-only")
                },
            }

        rows = [
            row(n, s)
            for n in (
                "MedFusion (full EDRL)",
                "Multi_ResNet (late fusion)",
                "MedFusion -MMD",
                "MedFusion -EPRL",
                "MedFusion -DILR",
            )
            for s in (0, 1)
        ]
        # explicit path -> that appendix, not the default one
        custom = tmp_path / "CUSTOM_ANALYSIS.md"
        custom.write_text("CUSTOM APPENDIX {{val_acc_full}}")
        md = mod.to_markdown(rows, sigmas, protocol="fusion",
                             analysis_path=str(custom))
        assert "CUSTOM APPENDIX 0.900" in md
        assert "Reading the fusion-protocol table" not in md
        # nonexistent path -> no appendix at all (not the default fallback)
        md = mod.to_markdown(rows, sigmas, protocol="fusion",
                             analysis_path=str(tmp_path / "MISSING.md"))
        assert "Reading the fusion-protocol table" not in md
        # the committed long-budget analysis resolves with full+late only
        long_analysis = os.path.join(repo, "ABLATION_FUSION_LONG_ANALYSIS.md")
        md = mod.to_markdown(rows, sigmas, protocol="fusion",
                             analysis_path=long_analysis)
        assert "training-budget hypothesis" in md
        assert "{{" not in md, md[md.find("{{") - 80 : md.find("{{") + 120]
        assert "*(pending:" not in md, md[
            md.find("*(pending:") - 80 : md.find("*(pending:") + 120
        ]
        # extra_md (the budget-gap section hook) lands after the appendix
        md = mod.to_markdown(rows, sigmas, protocol="fusion",
                             analysis_path=str(tmp_path / "MISSING.md"),
                             extra_md="## Budget effect: TEST SENTINEL")
        assert "## Budget effect: TEST SENTINEL" in md

    def test_study_io_protocol_filter_and_seed_default(self, tmp_path):
        """The shared jsonl loader keeps only the newest row's protocol and
        backfills seed=0 on legacy (round-2 archive) rows."""
        import json

        from edrl.train.study_io import load_by_name_seed, load_protocol_rows

        p = tmp_path / "x.jsonl"
        rows = [
            {"name": "a", "protocol": {"epochs": 5}, "seed": 1},
            {"name": "a", "protocol": {"epochs": 9}},  # legacy: no seed
        ]
        p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
        kept = load_protocol_rows(str(p))
        assert len(kept) == 1 and kept[0]["seed"] == 0
        assert set(load_by_name_seed(str(p))) == {("a", 0)}

    def test_warmup_enters_protocol_key_only_when_active(self):
        """warmup_steps=0 must leave the protocol dict byte-identical to
        the pre-warmup format (protocol tags compare by equality, so an
        unconditional key would invalidate every cached study row);
        nonzero warmup must enter the key so its rows never mix in."""
        import importlib.util
        import os

        repo = os.path.join(os.path.dirname(__file__), "..")
        spec = importlib.util.spec_from_file_location(
            "ablation_study", os.path.join(repo, "scripts", "ablation_study.py")
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        args = mod.main.__globals__["argparse"].Namespace(
            protocol="fusion", sigmas=[0.0], epochs=5, train_samples=8,
            val_samples=8, batch_size=4, lr=1e-4, fundus_size=32,
            oct_size=16, warmup_steps=0,
        )
        assert "warmup_steps" not in mod.protocol_of(args)
        args.warmup_steps = 50
        assert mod.protocol_of(args)["warmup_steps"] == 50

    def test_budget_gap_tool(self, tmp_path):
        """ablation_budget_gap pairs (variant, seed) rows across the
        25-epoch and 75-epoch studies, and refuses to compare studies that
        differ in anything besides epochs."""
        import contextlib
        import importlib.util
        import io
        import json
        import os

        repo = os.path.join(os.path.dirname(__file__), "..")
        spec = importlib.util.spec_from_file_location(
            "ablation_budget_gap",
            os.path.join(repo, "scripts", "ablation_budget_gap.py"),
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        def row(name, seed, epochs, val, loss, both, uni, lr=3e-5):
            return {
                "name": name, "seed": seed, "best_val_acc": val,
                "final_train_loss": loss,
                "protocol": {"protocol": "fusion", "epochs": epochs,
                             "lr": lr},
                "sweep": {
                    "both": {"0.0": {"accuracy": both, "auc": both}},
                    "fundus-only": {"0.0": {"accuracy": uni, "auc": uni}},
                    "oct-only": {"0.0": {"accuracy": uni, "auc": uni}},
                },
            }

        short = tmp_path / "S.jsonl"
        long_ = tmp_path / "L.jsonl"
        with open(short, "w") as f:
            for s in (0, 1):
                f.write(json.dumps(
                    row("MedFusion (full EDRL)", s, 25, 0.55, 2.0, 0.54,
                        0.52)) + "\n")
        with open(long_, "w") as f:
            for s in (0, 1):
                f.write(json.dumps(
                    row("MedFusion (full EDRL)", s, 75, 0.75, 0.3, 0.80,
                        0.60)) + "\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--short", str(short), "--long", str(long_)])
        out = buf.getvalue()
        assert "Budget effect: 25 vs 75 epochs" in out
        assert "+0.200±0.000" in out  # paired val-acc delta
        assert "+0.200" in out  # advantage long: 0.80 - 0.60
        # guard: lr differs -> refuse
        with open(long_, "w") as f:
            f.write(json.dumps(
                row("MedFusion (full EDRL)", 0, 75, 0.75, 0.3, 0.80, 0.60,
                    lr=1e-4)) + "\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--short", str(short), "--long", str(long_)])
        assert "skipped: studies differ beyond epochs" in buf.getvalue()
