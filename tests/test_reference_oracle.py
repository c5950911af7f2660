"""Live-oracle parity: EDRL math vs the ACTUAL reference torch code.

``tests/test_golden_parity.py`` checks our modules against independent numpy
re-derivations.  This module goes one tier stronger: it loads the reference's
own PyTorch source from ``/root/reference`` at test time (with its missing
third-party imports stubbed — ``Models`` backbones, ``ot``), copies weights
torch -> JAX, and asserts numerical agreement on identical inputs.  That
turns "we believe our derivation matches" into measured agreement with the
shipped implementation for every component where we claim exact parity:

- ``MK_MMD`` / ``gaussian_kernel`` / ``compute_js_divergence``
  (``code/MMD.py``) — values AND input gradients (the self-distillation
  loss's gradient is what actually trains the model).
- ``KL_between_normals`` (``fusion_net.py:390-402``).
- ``PoE`` (``fusion_net.py:16-60``) — deterministic mu+var output.
- ``CLUBMean`` (``fusion_net.py:501-542``) — forward MI bound and
  learning loss, with copied MLP weights.
- ``MIAttention`` (``fusion_net.py:258-285``) via our
  ``MultiHeadAttention``.
- ``AttentionModel`` (``fusion_net.py:550-578``) — torch
  ``nn.MultiheadAttention`` + residual/LN/FFN, with packed-qkv weight
  mapping.
- ``DILR.forward`` + ``bt_loss_cross`` (``fusion_net.py:635-768``) — the
  full fusion head end-to-end: projections, common/unique split, guided and
  shared attention, affine-free BN, Barlow cross-correlation loss, and the
  3072-d combined features.

Components with DOCUMENTED deviations are not asserted here: EPRL normalizes
over the feature axis where the reference's ``F.normalize(dim=1)`` hits the
token axis (see ``edrl/models/eprl.py`` docstring), and the reference
DILR's guided projectors crash as published (ledger #13) — the oracle feeds
the post-fix query shape ``[B, 1, 1024]`` both sides, which exercises every
weight the reference can actually run.

Everything here is skipped when ``/root/reference`` is absent, so the suite
stays hermetic off this machine.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF_DIR = "/root/reference/code"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_DIR), reason="reference checkout not available"
)


def _load_ref_module(filename, name, stub_models=False):
    """Load a reference source file, stubbing its unavailable imports."""
    if stub_models:
        ot_stub = types.ModuleType("ot")
        sys.modules.setdefault("ot", ot_stub)
        models_pkg = types.ModuleType("Models")
        models_pkg.__path__ = []  # mark as package
        fsn = types.ModuleType("Models.fundus_swin_network")
        fsn.build_model = lambda *a, **k: None
        unetr = types.ModuleType("Models.unetr")
        unetr.UNETR_base_3DNet = object
        sys.modules.setdefault("Models", models_pkg)
        sys.modules.setdefault("Models.fundus_swin_network", fsn)
        sys.modules.setdefault("Models.unetr", unetr)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REF_DIR, filename)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_mmd():
    return _load_ref_module("MMD.py", "ref_mmd_oracle")


@pytest.fixture(scope="module")
def ref_net():
    """fusion_net.py with ``.cuda()`` neutralized for the CPU-only torch."""
    orig_cuda = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        yield _load_ref_module("fusion_net.py", "ref_fusion_net", stub_models=True)
    finally:
        torch.Tensor.cuda = orig_cuda


@pytest.fixture()
def nprng():
    return np.random.default_rng(20260819)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _dense(linear):
    """torch nn.Linear -> Dense params."""
    p = {"kernel": jnp.asarray(linear.weight.detach().numpy().T)}
    if linear.bias is not None:
        p["bias"] = jnp.asarray(linear.bias.detach().numpy())
    return p


def _mha(mha):
    """torch nn.MultiheadAttention (packed qkv) -> our MultiHeadAttention."""
    e = mha.embed_dim
    w = mha.in_proj_weight.detach().numpy()
    b = mha.in_proj_bias.detach().numpy()
    return {
        "q": {"kernel": jnp.asarray(w[:e].T), "bias": jnp.asarray(b[:e])},
        "k": {"kernel": jnp.asarray(w[e : 2 * e].T), "bias": jnp.asarray(b[e : 2 * e])},
        "v": {"kernel": jnp.asarray(w[2 * e :].T), "bias": jnp.asarray(b[2 * e :])},
        "proj": _dense(mha.out_proj),
    }


def _attention_model(t):
    """reference AttentionModel -> our AttentionModel param tree."""
    return {
        "MultiHeadAttention_0": _mha(t.attn),
        "LayerNorm_0": {
            "scale": jnp.asarray(t.layer_norm.weight.detach().numpy()),
            "bias": jnp.asarray(t.layer_norm.bias.detach().numpy()),
        },
        "Dense_0": _dense(t.ffn[0]),
        "Dense_1": _dense(t.ffn[2]),
    }


class TestMMDOracle:
    def test_gaussian_kernel_matches(self, ref_mmd, nprng):
        from edrl.ops.mmd import gaussian_kernel

        s = nprng.normal(size=(10, 32)).astype(np.float32)
        t = nprng.normal(size=(14, 32)).astype(np.float32)
        with torch.no_grad():
            k_ref = ref_mmd.gaussian_kernel(_t(s), _t(t)).numpy()
        k_ours = np.asarray(gaussian_kernel(jnp.asarray(s), jnp.asarray(t)))
        np.testing.assert_allclose(k_ours, k_ref, rtol=1e-4, atol=1e-4)

    def test_mk_mmd_value_matches(self, ref_mmd, nprng):
        from edrl.ops.mmd import mk_mmd

        # Shifted target so the MMD is well away from zero.
        s = nprng.normal(size=(12, 48)).astype(np.float32)
        t = (nprng.normal(size=(12, 48)) + 0.5).astype(np.float32)
        with torch.no_grad():
            ref_val = float(ref_mmd.MK_MMD(_t(s), _t(t)))
        ours = float(mk_mmd(jnp.asarray(s), jnp.asarray(t)))
        assert ours == pytest.approx(ref_val, rel=1e-4)

    def test_mk_mmd_gradient_matches(self, ref_mmd, nprng):
        """The distillation loss's input gradient is what trains the model —
        check it against torch autograd, not just the forward value."""
        from edrl.ops.mmd import mk_mmd

        s = nprng.normal(size=(8, 24)).astype(np.float32)
        t = (nprng.normal(size=(8, 24)) + 0.3).astype(np.float32)
        ts = _t(s).requires_grad_(True)
        tt = _t(t).requires_grad_(True)
        ref_mmd.MK_MMD(ts, tt).backward()
        g_ours = jax.grad(
            lambda a, b: mk_mmd(a, b), argnums=(0, 1)
        )(jnp.asarray(s), jnp.asarray(t))
        np.testing.assert_allclose(
            np.asarray(g_ours[0]), ts.grad.numpy(), rtol=2e-3, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(g_ours[1]), tt.grad.numpy(), rtol=2e-3, atol=1e-5
        )

    def test_js_divergence_matches(self, ref_mmd, nprng):
        from edrl.ops.distributions import js_divergence

        p = torch.softmax(_t(nprng.normal(size=(16, 4))), dim=1)
        q = torch.softmax(_t(nprng.normal(size=(16, 4))), dim=1)
        with torch.no_grad():
            ref_val = float(ref_mmd.compute_js_divergence(p, q))
        ours = float(js_divergence(jnp.asarray(p.numpy()), jnp.asarray(q.numpy())))
        assert ours == pytest.approx(ref_val, rel=1e-5, abs=1e-7)


class TestFusionNetOracles:
    def test_kl_between_normals_matches(self, ref_net, nprng):
        from edrl.ops.distributions import kl_between_normals

        mu_q = nprng.normal(size=(6, 5)).astype(np.float32)
        mu_p = nprng.normal(size=(6, 5)).astype(np.float32)
        sig_q = nprng.uniform(0.1, 2.0, size=(6, 5)).astype(np.float32)
        sig_p = nprng.uniform(0.1, 2.0, size=(6, 5)).astype(np.float32)
        with torch.no_grad():
            ref_val = ref_net.KL_between_normals(
                (_t(mu_q), _t(sig_q)), (_t(mu_p), _t(sig_p))
            ).numpy()
        ours = np.asarray(
            kl_between_normals(
                jnp.asarray(mu_q), jnp.asarray(sig_q), jnp.asarray(mu_p), jnp.asarray(sig_p)
            )
        )
        np.testing.assert_allclose(ours, ref_val, rtol=1e-5, atol=1e-6)

    def test_poe_matches(self, ref_net, nprng):
        from edrl.models.poe import PoE

        b, c, z = 4, 2, 16
        mu = [nprng.normal(size=(b, c, z)).astype(np.float32) for _ in range(2)]
        var = [
            nprng.uniform(0.2, 1.5, size=(b, c, z)).astype(np.float32)
            for _ in range(2)
        ]
        phi = nprng.normal(size=(2,)).astype(np.float32)

        tpoe = ref_net.PoE(modality_num=2)
        tpoe.train()
        with torch.no_grad():
            tpoe.phi.copy_(_t(phi))
            # [B, 1, C, z]: the reference unsqueezes dim 1 (its sampled noise
            # is discarded, fusion_net.py:44-50).
            ref_out = tpoe([_t(m) for m in mu], [_t(v) for v in var]).numpy()

        ours = PoE(modality_num=2).apply(
            {"params": {"phi": jnp.asarray(phi)}},
            [jnp.asarray(m) for m in mu],
            [jnp.asarray(v) for v in var],
        )
        np.testing.assert_allclose(
            np.asarray(ours), ref_out[:, 0], rtol=1e-5, atol=1e-6
        )

    def test_club_mean_matches(self, ref_net, nprng):
        from edrl.models.auxiliary import CLUBMean

        x_dim, y_dim, hidden, n = 12, 6, 32, 9
        x = nprng.normal(size=(n, x_dim)).astype(np.float32)
        y = nprng.normal(size=(n, y_dim)).astype(np.float32)
        tclub = ref_net.CLUBMean(x_dim, y_dim, hidden_size=hidden)
        tclub.eval()
        with torch.no_grad():
            ref_mi = float(tclub(_t(x), _t(y)))
            ref_ll = float(tclub.learning_loss(_t(x), _t(y)))

        params = {
            "p_mu1": _dense(tclub.p_mu[0]),
            "p_mu2": _dense(tclub.p_mu[2]),
        }
        m = CLUBMean(y_dim=y_dim, hidden=hidden)
        ours_mi = float(
            m.apply({"params": params}, jnp.asarray(x), jnp.asarray(y), mode="mi")
        )
        ours_ll = float(
            m.apply({"params": params}, jnp.asarray(x), jnp.asarray(y), mode="loss")
        )
        assert ours_mi == pytest.approx(ref_mi, rel=1e-4, abs=1e-5)
        assert ours_ll == pytest.approx(ref_ll, rel=1e-4, abs=1e-5)

    def test_mi_attention_matches(self, ref_net, nprng):
        from edrl.models.layers import MultiHeadAttention

        dim, heads, b, n = 32, 4, 3, 7
        x = nprng.normal(size=(b, n, dim)).astype(np.float32)
        tatt = ref_net.MIAttention(dim, num_heads=heads)
        tatt.eval()
        with torch.no_grad():
            ref_out = tatt(_t(x)).numpy()

        w = tatt.qkv.weight.detach().numpy()  # [3C, C], qkv-packed rows
        params = {
            "q": {"kernel": jnp.asarray(w[:dim].T)},
            "k": {"kernel": jnp.asarray(w[dim : 2 * dim].T)},
            "v": {"kernel": jnp.asarray(w[2 * dim :].T)},
            "proj": _dense(tatt.proj),
        }
        ours = MultiHeadAttention(dim, heads, qkv_bias=False).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x)
        )
        np.testing.assert_allclose(np.asarray(ours), ref_out, rtol=1e-4, atol=1e-5)

    def test_attention_model_matches(self, ref_net, nprng):
        from edrl.models.dilr import AttentionModel

        dim, heads = 64, 4
        q = nprng.normal(size=(2, 3, dim)).astype(np.float32)
        kv = nprng.normal(size=(2, 5, dim)).astype(np.float32)
        tmod = ref_net.AttentionModel(dim, heads, 1)
        tmod.eval()
        with torch.no_grad():
            ref_out = tmod(_t(q), _t(kv), _t(kv)).numpy()

        ours = AttentionModel(dim, heads).apply(
            {"params": _attention_model(tmod)},
            jnp.asarray(q),
            jnp.asarray(kv),
            jnp.asarray(kv),
        )
        np.testing.assert_allclose(np.asarray(ours), ref_out, rtol=2e-4, atol=2e-5)


class TestDILROracle:
    """End-to-end fusion-head parity: combined features AND Barlow loss.

    The reference DILR hard-codes its dims (1024/768 -> 2048,
    ``fusion_net.py:635-645``), so this runs the full-size head on a small
    batch.  Guided inputs are fed at the post-fix shape (one 1024-d query,
    ledger #13) — the only shape the reference's own projectors accept.
    """

    def test_dilr_forward_matches(self, ref_net, nprng):
        from edrl.models.dilr import DILR

        b, n1, n2 = 8, 6, 10
        fundus = nprng.normal(size=(b, n1, 1024)).astype(np.float32)
        oct_t = nprng.normal(size=(b, n2, 768)).astype(np.float32)
        shared = nprng.normal(size=(b, 1024)).astype(np.float32)
        gf = nprng.normal(size=(b, 1024)).astype(np.float32)
        go = nprng.normal(size=(b, 1024)).astype(np.float32)

        args = types.SimpleNamespace(batch_size=b)
        tdilr = ref_net.DILR(args, common_ratio=0.5)
        tdilr.train()  # BatchNorm must use batch statistics, as in training
        with torch.no_grad():
            ref_comb, ref_loss = tdilr(
                _t(fundus), _t(oct_t), _t(shared), _t(gf)[:, None, :], _t(go)[:, None, :]
            )
        ref_comb = ref_comb.numpy()
        ref_loss = float(ref_loss)

        params = {
            "projector1": _dense(tdilr.projector1),
            "projector2": _dense(tdilr.projector2),
            "guided_projector1": _dense(tdilr.guided_features_projector1),
            "guided_projector2": _dense(tdilr.guided_features_projector2),
            "shared_projector": _dense(tdilr.shared_features_projector),
            "self_attn1": _attention_model(tdilr.self_attn1),
            "self_attn2": _attention_model(tdilr.self_attn2),
            "cross_attn1": _attention_model(tdilr.cross_attn1),
            "cross_attn2": _attention_model(tdilr.cross_attn2),
        }
        m = DILR(
            fundus_dim=1024,
            oct_dim=768,
            feature_dim=2048,
            guided_in_dim=1024,
            common_ratio=0.5,
            num_heads=8,
        )
        # In train mode BatchNorm reads nothing from batch_stats (it only
        # writes the running estimates), so a fresh template suffices.
        batch_stats = {
            name: {"mean": jnp.zeros((2048,)), "var": jnp.ones((2048,))}
            for name in ("bn1", "bn2")
        }
        (ours_comb, ours_loss), _ = m.apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(fundus),
            jnp.asarray(oct_t),
            jnp.asarray(shared),
            jnp.asarray(gf),
            jnp.asarray(go),
            train=True,
            mutable=["batch_stats"],
        )
        assert ours_comb.shape == (b, 3072) == ref_comb.shape
        np.testing.assert_allclose(
            np.asarray(ours_comb), ref_comb, rtol=2e-3, atol=2e-3
        )
        assert float(ours_loss) == pytest.approx(ref_loss, rel=2e-3)
