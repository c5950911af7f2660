"""Unit tests for core math primitives against closed-form / torch-free oracles.

Golden values are computed with independent numpy reimplementations of the
reference formulas (``code/MMD.py``, ``fusion_net.py:390-402,501-548,656-677``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edrl.ops import (
    barlow_block_loss,
    batch_standardize,
    club_learning_loss,
    club_mean_mi,
    entropy_regularization,
    gaussian_kernel,
    js_divergence,
    kl_between_normals,
    kl_to_standard_normal,
    label_smoothing_cross_entropy,
    mk_mmd,
    off_diagonal_sum_sq,
)


def _np_mk_mmd(source, target, kernel_mul=2.0, kernel_num=5):
    total = np.concatenate([source, target], axis=0).astype(np.float64)
    n = total.shape[0]
    sq = np.sum(total**2, axis=1, keepdims=True)
    d2 = np.maximum(sq + sq.T - 2 * total @ total.T, 0.0)
    ls = d2.sum() / (n * n - n)
    ls /= kernel_mul ** (kernel_num // 2)
    k = sum(np.exp(-d2 / (ls * kernel_mul**i)) for i in range(kernel_num))
    ns, nt = source.shape[0], target.shape[0]
    xx = k[:ns, :ns].sum() / ns**2
    yy = k[ns:, ns:].sum() / nt**2
    xy = k[:ns, ns:].sum() / (ns * nt)
    yx = k[ns:, :ns].sum() / (ns * nt)
    return abs(xx + yy - xy - yx)


class TestMMD:
    def test_matches_numpy_oracle(self, rng):
        s = rng.normal(size=(8, 16)).astype(np.float32)
        t = rng.normal(size=(8, 16)).astype(np.float32) + 0.5
        got = float(jax.jit(mk_mmd)(jnp.asarray(s), jnp.asarray(t)))
        want = _np_mk_mmd(s, t)
        # float32 Gram-matrix path vs float64 oracle: allow small drift.
        assert got == pytest.approx(want, rel=5e-3)

    def test_identical_batches_give_zero(self, rng):
        s = rng.normal(size=(6, 8)).astype(np.float32)
        got = float(mk_mmd(jnp.asarray(s), jnp.asarray(s)))
        assert got == pytest.approx(0.0, abs=1e-5)

    def test_separated_clusters_large(self, rng):
        s = rng.normal(size=(8, 4)).astype(np.float32)
        t = s + 100.0
        near = float(mk_mmd(jnp.asarray(s), jnp.asarray(s + 0.01)))
        far = float(mk_mmd(jnp.asarray(s), jnp.asarray(t)))
        assert far > near

    def test_kernel_matrix_shape_and_symmetry(self, rng):
        s = rng.normal(size=(5, 3)).astype(np.float32)
        t = rng.normal(size=(7, 3)).astype(np.float32)
        k = np.asarray(gaussian_kernel(jnp.asarray(s), jnp.asarray(t)))
        assert k.shape == (12, 12)
        np.testing.assert_allclose(k, k.T, rtol=1e-5)
        # Diagonal = kernel_num (exp(0) per kernel).
        np.testing.assert_allclose(np.diag(k), 5.0, rtol=1e-5)

    def test_gradients_flow(self, rng):
        s = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
        t = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
        g = jax.grad(lambda a: mk_mmd(a, t))(s)
        assert np.all(np.isfinite(np.asarray(g)))
        assert float(jnp.abs(g).sum()) > 0


class TestKL:
    def test_kl_same_distribution_zero(self, rng):
        mu = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
        sig = jnp.asarray(rng.uniform(0.5, 2.0, size=(4, 8)).astype(np.float32))
        kl = kl_between_normals(mu, sig, mu, sig)
        np.testing.assert_allclose(np.asarray(kl), 0.0, atol=1e-5)

    def test_kl_closed_form_1d(self):
        # KL(N(m,s^2)||N(0,1)) = 0.5 (s^2 + m^2 - 1 - ln s^2), per-dim.
        mu = jnp.array([[1.0]])
        sig = jnp.array([[2.0]])
        got = float(
            kl_between_normals(mu, sig, jnp.zeros((1, 1)), jnp.ones((1, 1)))[0]
        )
        want = 0.5 * (4.0 + 1.0 - 1.0 - np.log(4.0))
        assert got == pytest.approx(want, rel=1e-5)

    def test_kl_to_standard_normal_nonneg(self, rng):
        mu = jnp.asarray(rng.normal(size=(4, 2, 8)).astype(np.float32))
        sig = jnp.asarray(rng.uniform(0.5, 2.0, size=(4, 2, 8)).astype(np.float32))
        val = float(kl_to_standard_normal(mu, sig, axis=1))
        assert val >= 0.0


class TestEntropyAndJS:
    def test_uniform_logits_max_entropy(self):
        logits = jnp.zeros((3, 4))
        assert float(entropy_regularization(logits)) == pytest.approx(
            np.log(4.0), rel=1e-5
        )

    def test_peaked_logits_low_entropy(self):
        logits = jnp.array([[100.0, 0.0, 0.0]])
        assert float(entropy_regularization(logits)) == pytest.approx(0.0, abs=1e-3)

    def test_js_symmetric_and_zero_on_equal(self, rng):
        p = jax.nn.softmax(jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)))
        q = jax.nn.softmax(jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)))
        assert float(js_divergence(p, p)) == pytest.approx(0.0, abs=1e-6)
        assert float(js_divergence(p, q)) == pytest.approx(
            float(js_divergence(q, p)), rel=1e-5
        )


class TestBarlow:
    def test_off_diagonal_sum_sq(self):
        c = jnp.arange(9.0).reshape(3, 3)
        # off-diagonal entries: 1,2,3,5,6,7
        want = 1 + 4 + 9 + 25 + 36 + 49
        assert float(off_diagonal_sum_sq(c)) == pytest.approx(want)

    def test_batch_standardize(self, rng):
        x = jnp.asarray(rng.normal(2.0, 3.0, size=(64, 8)).astype(np.float32))
        z = np.asarray(batch_standardize(x))
        np.testing.assert_allclose(z.mean(axis=0), 0.0, atol=1e-4)
        np.testing.assert_allclose(z.std(axis=0), 1.0, atol=1e-2)

    def test_perfectly_correlated_common_block_zero_common_loss(self, rng):
        b, d = 256, 8
        x = rng.normal(size=(b, d)).astype(np.float32)
        z = np.asarray(batch_standardize(jnp.asarray(x)))
        # With divisor exactly b the correlation diag of identical features -> 1.
        loss, loss_c, loss_u = barlow_block_loss(
            jnp.asarray(z), jnp.asarray(z), common_dim=d, batch_divisor=float(b)
        )
        # common block is the whole matrix: on-diag ~1 -> loss_c ~ only off-diag
        assert float(loss_c) < 0.1 * d
        assert float(loss_u) == pytest.approx(0.0)  # empty unique block

    def test_block_split_geometry(self, rng):
        b, d = 32, 6
        z1 = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
        z2 = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
        loss, loss_c, loss_u = barlow_block_loss(
            z1, z2, common_dim=3, batch_divisor=float(b * 4)
        )
        assert float(loss) == pytest.approx(
            0.5 * (float(loss_c) + float(loss_u)), rel=1e-6
        )


class TestClassificationLoss:
    def test_label_smoothing_matches_manual(self, rng):
        logits = rng.normal(size=(4, 3)).astype(np.float32)
        labels = np.array([0, 2, 1, 1])
        got = float(
            label_smoothing_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 0.1)
        )
        # manual
        log_p = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        true = np.full_like(logits, 0.1 / 2)
        true[np.arange(4), labels] = 0.9
        want = (-true * log_p).sum(-1).mean()
        assert got == pytest.approx(want, rel=1e-5)

    def test_zero_smoothing_is_plain_ce(self, rng):
        logits = jnp.asarray(rng.normal(size=(8, 2)).astype(np.float32))
        labels = jnp.asarray(np.array([0, 1] * 4))
        got = float(label_smoothing_cross_entropy(logits, labels, 0.0))
        want = float(
            -jnp.mean(
                jnp.take_along_axis(
                    jax.nn.log_softmax(logits), labels[:, None], axis=1
                )
            )
        )
        assert got == pytest.approx(want, rel=1e-5)


class TestClub:
    def test_mi_zero_for_identical_rows(self):
        # If all mu and y rows are identical, positive == negative -> MI == 0.
        mu = jnp.ones((4, 3))
        y = jnp.ones((4, 3))
        assert float(club_mean_mi(mu, y)) == pytest.approx(0.0, abs=1e-6)

    def test_learning_loss_zero_at_perfect_prediction(self, rng):
        y = jnp.asarray(rng.normal(size=(5, 4)).astype(np.float32))
        assert float(club_learning_loss(y, y)) == pytest.approx(0.0, abs=1e-6)

    def test_mi_positive_for_matched_pairs(self, rng):
        y = rng.normal(size=(16, 4)).astype(np.float32)
        mu = y + 0.01 * rng.normal(size=(16, 4)).astype(np.float32)
        assert float(club_mean_mi(jnp.asarray(mu), jnp.asarray(y))) > 0
