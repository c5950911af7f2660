"""Where the program runs: the GPU guard, the peaks table, the compile cache,
the checkpoint format, and ``chip_smoke.py``'s phases at the tiny config."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from edrl import device
from edrl.config import tiny_test_config
from edrl.train.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        device.require_gpu()


def test_chip_smoke_exits_nonzero_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stdout
    assert '"ok"' not in proc.stdout


def test_peaks_table_knows_the_h100():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA L4", "NVIDIA A100-SXM4-80GB"])
def test_peaks_table_raises_on_unknown_kind(kind):
    with pytest.raises(KeyError, match="no published peak"):
        bench.peak_bf16_flops(kind)


@pytest.mark.parametrize("env_dir", [None, "elsewhere/cache"])
def test_compile_cache_dir(env_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert device.enable_compile_cache() == device.CACHE_DIR
        assert calls == [("jax_compilation_cache_dir", device.CACHE_DIR)]
        # Inside the checkout, and ignored by git.
        assert os.path.dirname(device.CACHE_DIR) == REPO
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert device.enable_compile_cache() == env_dir
        assert calls == []  # JAX reads the variable itself


def _state():
    return {
        "w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "h": jnp.asarray([1.5, -2.0], jnp.bfloat16),
        "step": jnp.asarray(7, jnp.int32),
        "nested": ({"a": jnp.ones((4,), jnp.float32)},),
    }


def test_checkpoint_roundtrip_keeps_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(_state(), "x")
    template = jax.tree_util.tree_map(jnp.zeros_like, _state())
    got = mgr.restore(template, "x")
    for a, b in zip(jax.tree_util.tree_leaves(_state()), jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(os.listdir(tmp_path / "x")) == ["arrays.npz", "index.json"]


def test_checkpoint_restore_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(), "x")
    template = dict(_state(), w=jnp.zeros((3, 2), jnp.float32))
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(template, "x")


def test_checkpoint_restore_rejects_missing_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(), "x")
    template = dict(_state(), extra=jnp.zeros((1,)))
    with pytest.raises(KeyError, match="extra"):
        mgr.restore(template, "x")


def test_smoke_attention_parity_phase():
    chip_smoke.attention_parity(
        batch=1, window=4, head_dim=16, stages=((4, 1), (1, 2)), vit=(8, 2)
    )


def test_smoke_attention_parity_detects_a_wrong_route(monkeypatch):
    from edrl.models import swin2d

    real = swin2d.window_attention
    monkeypatch.setattr(
        swin2d, "window_attention", lambda *a: real(*a) * 1.1
    )
    with pytest.raises(AssertionError, match="exceeds"):
        chip_smoke.attention_parity(
            batch=1, window=4, head_dim=16, stages=((1, 1),), vit=(8, 2)
        )


def test_smoke_model_and_cpu_parity_phases():
    cfg = tiny_test_config(batch_size=2)
    chip_smoke.model_parity(cfg, batch=2)
    chip_smoke.cpu_gpu_parity(cfg)


def test_smoke_train_and_serve_phases(tmp_path):
    cfg = tiny_test_config(batch_size=4)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, device_noise=True, num_synthetic_samples=8),
        train=dataclasses.replace(cfg.train, end_epochs=2, checkpoint_dir="", log_dir=""),
    )
    state, best, result = chip_smoke.train_phase(cfg, str(tmp_path))
    assert len(result.train_history) == 2
    assert int(state.step) == 4
    chip_smoke.serve_phase(cfg, best, sizes=(1, 3))


def test_smoke_four_card_phase_on_virtual_devices(tmp_path):
    """The --chips 4 phase on 4 of the 8 virtual CPU devices, tiny config."""
    cfg = tiny_test_config(batch_size=16)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, device_noise=True, num_synthetic_samples=16, eval_batch_size=16
        ),
        train=dataclasses.replace(cfg.train, end_epochs=1, checkpoint_dir="", log_dir=""),
    )
    chip_smoke.four_cards(n=4, batch=16, cfg=cfg, workdir=str(tmp_path))


@pytest.mark.gpu
def test_attention_parity_at_real_widths_on_the_card(gpu_device):
    chip_smoke.attention_parity()


@pytest.mark.gpu
def test_the_card_is_in_the_peaks_table(gpu_device):
    assert bench.peak_bf16_flops(gpu_device.device_kind) > 0
    assert device.require_gpu()[0] == gpu_device
