"""The in-repo module layer (``edrl.models.nn``): naming, variables, rngs,
remat, interception and the layers against plain lax/numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from edrl.models import nn


class _Net(nn.Module):
    width: int = 8

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = nn.Dense(self.width)(x)
        x = nn.LayerNorm()(x)
        x = nn.Dense(self.width, name="head")(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.Dropout(0.5)(x, deterministic=not train)
        return nn.Dense(2)(x)


def test_auto_and_explicit_names_give_linen_layout():
    v = _Net().init(jax.random.key(0), jnp.zeros((2, 4)))
    assert set(v) == {"params", "batch_stats"}
    assert set(v["params"]) == {"Dense_0", "LayerNorm_0", "head", "BatchNorm_0", "Dense_1"}
    assert set(v["params"]["Dense_0"]) == {"kernel", "bias"}
    assert v["params"]["Dense_0"]["kernel"].shape == (4, 8)
    assert set(v["batch_stats"]["BatchNorm_0"]) == {"mean", "var"}


def test_duplicate_explicit_name_raises():
    class Dup(nn.Module):
        @nn.compact
        def __call__(self, x):
            nn.Dense(2, name="a")(x)
            return nn.Dense(2, name="a")(x)

    with pytest.raises(ValueError, match="used twice"):
        Dup().init(jax.random.key(0), jnp.zeros((1, 3)))


def test_shared_submodule_reuses_params():
    class Shared(nn.Module):
        @nn.compact
        def __call__(self, x):
            fc = nn.Dense(3)
            return fc(x) + fc(x)

    v = Shared().init(jax.random.key(0), jnp.ones((1, 3)))
    assert list(v["params"]) == ["Dense_0"]
    k = v["params"]["Dense_0"]
    out = Shared().apply(v, jnp.ones((1, 3)))
    np.testing.assert_allclose(out, 2 * (jnp.ones((1, 3)) @ k["kernel"] + k["bias"]), rtol=1e-6)


def test_batchnorm_updates_only_when_mutable(rng):
    x = jnp.asarray(rng.normal(size=(16, 4)) * 2 + 3, jnp.float32)
    v = _Net().init(jax.random.key(0), x)
    rngs = {"dropout": jax.random.key(1)}
    _, upd = _Net().apply(v, x, train=True, rngs=rngs, mutable=["batch_stats"])
    assert not np.allclose(upd["batch_stats"]["BatchNorm_0"]["mean"], 0.0)
    assert np.allclose(v["batch_stats"]["BatchNorm_0"]["mean"], 0.0)  # input untouched
    with pytest.raises(ValueError, match="immutable"):
        _Net().apply(v, x, train=True, rngs=rngs)


def test_dropout_needs_rng_and_is_deterministic_per_key(rng):
    x = jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)
    v = _Net().init(jax.random.key(0), x)
    with pytest.raises(ValueError, match="'dropout' rng"):
        _Net().apply(v, x, train=True, mutable=["batch_stats"])
    run = lambda k: _Net().apply(
        v, x, train=True, rngs={"dropout": jax.random.key(k)},
        mutable=["batch_stats"],
    )[0]
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


def test_missing_param_in_apply_raises():
    with pytest.raises(KeyError, match="params/Dense_0/kernel"):
        _Net().apply({"params": {}}, jnp.ones((1, 4)))


@pytest.mark.parametrize("as_class", [True, False])
def test_remat_matches_plain_value_and_grad(as_class, rng):
    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            return jnp.tanh(nn.Dense(8)(x)) * x

    class Net(nn.Module):
        remat: bool = False

        @nn.compact
        def __call__(self, x):
            if as_class:
                cls = nn.remat(Block) if self.remat else Block
                return cls()(x).sum()
            blk = Block()
            call = (lambda m, y: m(y))
            return (nn.remat(call) if self.remat else call)(blk, x).sum()

    x = jnp.asarray(rng.normal(size=(2, 8)), jnp.float32)
    v = Net().init(jax.random.key(0), x)
    v2 = Net(remat=True).init(jax.random.key(0), x)
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(v2)
    f = lambda remat: jax.value_and_grad(lambda p: Net(remat=remat).apply({"params": p}, x))
    (a, ga), (b, gb) = f(False)(v["params"]), f(True)(v["params"])
    np.testing.assert_allclose(a, b, rtol=1e-6)
    for la, lb in zip(jax.tree_util.tree_leaves(ga), jax.tree_util.tree_leaves(gb)):
        np.testing.assert_allclose(la, lb, rtol=1e-6)


def test_intercept_methods_sees_module_path_and_can_replace_output():
    seen = []

    def icpt(next_fun, args, kwargs, ctx):
        if isinstance(ctx.module, nn.Dense) and ctx.method_name == "__call__":
            seen.append(ctx.module.path)
            if ctx.module.path == ("head",):
                return jnp.zeros_like(next_fun(*args, **kwargs))
        return next_fun(*args, **kwargs)

    v = _Net().init(jax.random.key(0), jnp.ones((2, 4)))
    with nn.intercept_methods(icpt):
        out = _Net().apply(v, jnp.ones((2, 4)))
    assert seen == [("Dense_0",), ("head",), ("Dense_1",)]
    # head zeroed -> BatchNorm (running stats 0/1) keeps zeros -> Dense_1
    # adds its zero-initialised bias.
    np.testing.assert_allclose(out, np.zeros((2, 2)), atol=1e-6)


@pytest.mark.parametrize(
    "shape, kernel, strides",
    [((2, 9, 9, 3), (3, 3), (2, 2)), ((1, 6, 6, 6, 2), (3, 3, 3), (1, 2, 1))],
)
def test_conv_matches_lax(shape, kernel, strides, rng):
    x = jnp.asarray(rng.normal(size=shape), jnp.float32)
    conv = nn.Conv(5, kernel, strides=strides)
    v = conv.init(jax.random.key(0), x)
    w = v["params"]["kernel"]
    assert w.shape == kernel + (shape[-1], 5)
    spatial = "DHW"[-len(kernel):]
    want = lax.conv_general_dilated(
        x, w, strides, "SAME",
        dimension_numbers=("N" + spatial + "C", spatial + "IO", "N" + spatial + "C"),
    ) + v["params"]["bias"]
    np.testing.assert_allclose(conv.apply(v, x), want, rtol=1e-5, atol=1e-5)


def test_pools_match_numpy(rng):
    x = rng.normal(size=(1, 4, 4, 2)).astype(np.float32)
    mx = nn.max_pool(jnp.asarray(x), (2, 2), strides=(2, 2))
    av = nn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2))
    blocks = x.reshape(1, 2, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4, 5)
    np.testing.assert_allclose(mx, blocks.max(axis=(3, 4)), rtol=1e-6)
    np.testing.assert_allclose(av, blocks.mean(axis=(3, 4)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_dense_matches_numpy(dtype, rng):
    x = rng.normal(size=(3, 5)).astype(np.float32)
    d = nn.Dense(7, dtype=dtype)
    v = d.init(jax.random.key(0), jnp.asarray(x))
    out = d.apply(v, jnp.asarray(x))
    assert out.dtype == (dtype or jnp.float32)
    want = x @ np.asarray(v["params"]["kernel"]) + np.asarray(v["params"]["bias"])
    tol = 1e-5 if dtype is None else 5e-2
    np.testing.assert_allclose(np.asarray(out, np.float32), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(6, 3), (2, 5, 5, 3), (2, 3, 4, 4, 3)])
def test_batchnorm_eval_uses_running_stats(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    mean = rng.normal(size=(3,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(3,)).astype(np.float32)
    scale = rng.normal(size=(3,)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=True)
    out = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x),
    )
    want = (x - mean) / np.sqrt(var + 1e-5) * scale + bias
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate, deterministic", [(0.0, False), (0.5, True)])
def test_dropout_identity_cases_need_no_rng(rate, deterministic, rng):
    x = jnp.asarray(rng.normal(size=(3, 4)), jnp.float32)
    out = nn.Dropout(rate).apply({}, x, deterministic=deterministic)
    np.testing.assert_array_equal(out, x)


def test_make_rng_differs_per_path_and_per_call():
    class Draw(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("sample"), self.make_rng("sample")

    class Two(nn.Module):
        @nn.compact
        def __call__(self):
            return Draw()(), Draw()()

    (a1, a2), (b1, _) = Two().apply({}, rngs={"sample": jax.random.key(0)})
    data = [jax.random.key_data(k) for k in (a1, a2, b1)]
    assert not np.array_equal(data[0], data[1])
    assert not np.array_equal(data[0], data[2])
    (c1, _), _ = Two().apply({}, rngs={"sample": jax.random.key(0)})
    np.testing.assert_array_equal(jax.random.key_data(c1), data[0])


def test_calling_a_module_twice_reuses_its_children(rng):
    class Twice(nn.Module):
        @nn.compact
        def __call__(self, x):
            inner = _Inner()
            return inner(x) + inner(x)

    x = jnp.asarray(rng.normal(size=(2, 3)), jnp.float32)
    v = Twice().init(jax.random.key(0), x)
    assert list(v["params"]) == ["_Inner_0"]
    assert list(v["params"]["_Inner_0"]) == ["Dense_0"]
    single = _Inner().apply({"params": v["params"]["_Inner_0"]}, x)
    np.testing.assert_allclose(Twice().apply(v, x), 2 * single, rtol=1e-6)


class _Inner(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(4)(x)


def test_init_returns_plain_nested_dicts_and_apply_copies_them(rng):
    x = jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)
    v = _Net().init(jax.random.key(0), x)
    assert type(v) is dict and type(v["params"]["Dense_0"]) is dict
    before = jax.tree_util.tree_map(lambda a: a, v)
    _Net().apply(v, x, train=True, rngs={"dropout": jax.random.key(0)},
                 mutable=["batch_stats"])
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(before)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(before)):
        assert a is b
