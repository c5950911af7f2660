"""A small module layer: the subset of ``flax.linen`` this package uses.

Modules are dataclasses whose ``@compact`` method creates submodules inline.
Variables live in nested dicts, one per collection (``params``,
``batch_stats``), keyed by module path.  A submodule is named
``<Class>_<n>`` unless it is given ``name=``, so parameter trees have
linen's layout (``Dense_0/kernel``, ``LayerNorm_1/scale``).

    variables = model.init(rngs, *args, **kwargs)
    out = model.apply(variables, *args, rngs=..., **kwargs)
    out, updates = model.apply(variables, *args, mutable=["batch_stats"])

Also here: ``Dense``, ``Conv``, ``LayerNorm``, ``BatchNorm``, ``Dropout``,
``remat``, the pools, the activations, ``initializers`` and
``intercept_methods`` (method interception, used by int8 serving).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
gelu = jax.nn.gelu
sigmoid = jax.nn.sigmoid
softplus = jax.nn.softplus

Dtype = Any

# Per-thread: the modules whose compact method is running (innermost last)
# and the active method interceptors (outermost first).
_local = threading.local()


def _module_stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _interceptors() -> list:
    if not hasattr(_local, "interceptors"):
        _local.interceptors = []
    return _local.interceptors


class _Frame:
    """State shared by every module bound in one ``init`` or ``apply``."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counts = {}
        self.remat_depth = 0

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


def _copy_dicts(tree):
    """Copy the nested dict structure; leaves are shared."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _node(tree, path, create: bool = False):
    for name in path:
        if name not in tree:
            if not create:
                return None
            tree[name] = {}
        tree = tree[name]
    return tree


class InterceptorContext(NamedTuple):
    module: "Module"
    method_name: str


@contextlib.contextmanager
def intercept_methods(interceptor):
    """Within the context, every compact method call of a bound module goes
    through ``interceptor(next_fun, args, kwargs, context)``."""
    stack = _interceptors()
    stack.append(interceptor)
    try:
        yield
    finally:
        stack.pop()


def compact(fn):
    """Mark the method that creates submodules inline (``__call__``)."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._frame is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply or from a parent module's compact method"
            )

        def run(*a, **k):
            # Each call names its children afresh, so a second call reuses
            # the first call's variables.
            self._cursor, self._names = {}, set()
            stack = _module_stack()
            stack.append(self)
            try:
                return fn(self, *a, **k)
            finally:
                stack.pop()

        ctx = InterceptorContext(self, fn.__name__)
        call = run
        for interceptor in _interceptors():
            call = functools.partial(
                lambda icpt, inner, *a, **k: icpt(inner, a, k, ctx),
                interceptor,
                call,
            )
        return call(*args, **kwargs)

    return wrapped


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class; subclasses are dataclasses of their attributes."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False, repr=False)(cls)

    def __post_init__(self):
        self._frame = None
        self._path: Tuple[str, ...] = ()
        self._cursor, self._names = {}, set()
        stack = _module_stack()
        if stack:
            stack[-1]._adopt(self)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"

    def _adopt(self, child: "Module") -> None:
        if child.name is None:
            prefix = type(child).__name__
            i = self._cursor.get(prefix, 0)
            self._cursor[prefix] = i + 1
            child.name = f"{prefix}_{i}"
        if child.name in self._names:
            raise ValueError(
                f"submodule name {child.name!r} used twice in "
                f"{'/'.join(self._path) or type(self).__name__}"
            )
        self._names.add(child.name)
        child._frame = self._frame
        child._path = self._path + (child.name,)

    def _bind(self, frame: _Frame) -> "Module":
        root = copy.copy(self)
        root._frame, root._path = frame, ()
        root._cursor, root._names = {}, set()
        return root

    # -- entry points --------------------------------------------------------

    def init(self, rngs, *args, **kwargs):
        """Run ``__call__`` once, creating every variable; returns them."""
        frame = _Frame({}, _as_rngs(rngs), True, initializing=True)
        self._bind(frame)(*args, **kwargs)
        return frame.variables

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        """Run ``__call__`` with ``variables``.  With ``mutable`` (a list of
        collection names, or True) returns ``(out, updated collections)``."""
        frame = _Frame(
            _copy_dicts(dict(variables)),
            _as_rngs(rngs) if rngs is not None else {},
            True if mutable is True else frozenset(mutable or ()),
            initializing=False,
        )
        out = self._bind(frame)(*args, **kwargs)
        if mutable is False:
            return out
        return out, {
            c: v for c, v in frame.variables.items() if frame.is_mutable(c)
        }

    # -- inside a compact method ---------------------------------------------

    @property
    def path(self) -> Tuple[str, ...]:
        return self._path

    @property
    def variables(self):
        out = {}
        for col, tree in self._frame.variables.items():
            node = _node(tree, self._path)
            if node is not None:
                out[col] = node
        return out

    def is_initializing(self) -> bool:
        return self._frame.initializing

    def make_rng(self, name: str = "params") -> jax.Array:
        """A fresh key from the ``name`` stream, distinct per module path and
        per call."""
        frame = self._frame
        if name not in frame.rngs:
            raise ValueError(
                f"{'/'.join(self._path) or type(self).__name__} needs a "
                f"'{name}' rng: pass rngs={{'{name}': key}}"
            )
        count = frame.rng_counts.get((name, self._path), 0)
        frame.rng_counts[(name, self._path)] = count + 1
        key = jax.random.fold_in(
            frame.rngs[name], zlib.crc32("/".join(self._path).encode())
        )
        return jax.random.fold_in(key, count)

    def get_variable(self, col: str, name: str, init_fn: Callable[[], Any]):
        """Read ``col/<path>/name``, creating it with ``init_fn()`` during
        init."""
        node = _node(self._frame.variables.get(col, {}), self._path)
        if node is not None and name in node:
            return node[name]
        if not self._frame.initializing:
            raise KeyError(
                f"variable {col}/{'/'.join(self._path + (name,))} not found"
            )
        value = init_fn()
        self.put_variable(col, name, value)
        return value

    def put_variable(self, col: str, name: str, value) -> None:
        frame = self._frame
        if not frame.is_mutable(col):
            raise ValueError(
                f"collection '{col}' is immutable here: pass mutable=['{col}']"
            )
        if frame.remat_depth:
            raise ValueError(f"cannot update '{col}' inside remat")
        tree = frame.variables.setdefault(col, {})
        _node(tree, self._path, create=True)[name] = value

    def param(self, name: str, init_fn: Callable, *init_args):
        return self.get_variable(
            "params", name, lambda: init_fn(self.make_rng("params"), *init_args)
        )


def _as_rngs(rngs):
    if isinstance(rngs, dict):
        return dict(rngs)
    return {"params": rngs}


def remat(target):
    """Recompute ``target``'s activations in the backward pass.

    ``target`` is a Module class (its ``__call__`` is checkpointed) or a
    function whose first argument is a bound module.  Positional arguments
    after the module are traced; keyword arguments are static."""

    def checkpointed(module, f, args):
        frame = module._frame
        if frame.initializing:
            return f(*args)
        frame.remat_depth += 1
        try:
            return jax.checkpoint(f)(*args)
        finally:
            frame.remat_depth -= 1

    if isinstance(target, type) and issubclass(target, Module):
        call = target.__call__

        def __call__(self, *args, **kwargs):
            return checkpointed(
                self, lambda *a: call(self, *a, **kwargs), args
            )

        return type(target.__name__, (target,), {"__call__": __call__})

    @functools.wraps(target)
    def wrapped(module, *args, **kwargs):
        return checkpointed(
            module, lambda *a: target(module, *a, **kwargs), args
        )

    return wrapped


_KERNEL_INIT = initializers.lecun_normal()


def _promote(*args, dtype=None):
    dtype = dtype or jnp.result_type(*(a for a in args if a is not None))
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis; float32 parameters
    (LeCun-normal kernel, zero bias), computed in ``dtype``."""

    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, inputs):
        kernel = self.param(
            "kernel", _KERNEL_INIT, (jnp.shape(inputs)[-1], self.features)
        )
        bias = (
            self.param("bias", initializers.zeros, (self.features,))
            if self.use_bias
            else None
        )
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(
            inputs, kernel, (((inputs.ndim - 1,), (0,)), ((), ()))
        )
        if bias is not None:
            y = y + bias
        return y


class Conv(Module):
    """N-d "SAME" convolution over channels-last inputs ``[B, *spatial, C]``;
    parameters as in ``Dense``."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, inputs):
        ks = tuple(self.kernel_size)
        nd = len(ks)
        strides = (
            (self.strides,) * nd
            if isinstance(self.strides, int)
            else tuple(self.strides)
        )
        kernel = self.param("kernel", _KERNEL_INIT, ks + (inputs.shape[-1], self.features))
        bias = (
            self.param("bias", initializers.zeros, (self.features,))
            if self.use_bias
            else None
        )
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        spatial = tuple(range(1, nd + 1))
        dn = lax.ConvDimensionNumbers(
            lhs_spec=(0, nd + 1) + spatial,
            rhs_spec=(nd + 1, nd) + tuple(range(nd)),
            out_spec=(0, nd + 1) + spatial,
        )
        y = lax.conv_general_dilated(
            inputs, kernel, strides, "SAME", dimension_numbers=dn
        )
        if bias is not None:
            y = y + bias
        return y


def _stats(x, axes):
    """Mean and variance over ``axes`` in at least float32."""
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x, axes)
    mean2 = jnp.mean(x * x, axes)
    return mean, jnp.maximum(0.0, mean2 - mean * mean)


def _normalize(mdl, x, mean, var, axes, dtype, epsilon, use_bias, use_scale):
    features = (x.shape[-1],)
    mean = jnp.expand_dims(mean, axes)
    var = jnp.expand_dims(var, axes)
    y = x - mean
    mul = lax.rsqrt(var + epsilon)
    args = [x]
    if use_scale:
        scale = mdl.param("scale", initializers.ones, features, jnp.float32)
        mul = mul * scale
        args.append(scale)
    y = y * mul
    if use_bias:
        bias = mdl.param("bias", initializers.zeros, features, jnp.float32)
        y = y + bias
        args.append(bias)
    return jnp.asarray(y, dtype or jnp.result_type(*args))


class LayerNorm(Module):
    """Normalize over the last axis (epsilon 1e-6), with a learned
    ``scale`` and ``bias``; statistics in float32."""

    dtype: Optional[Dtype] = None

    @compact
    def __call__(self, x):
        axes = (x.ndim - 1,)
        mean, var = _stats(x, axes)
        return _normalize(self, x, mean, var, axes, self.dtype, 1e-6, True, True)


class BatchNorm(Module):
    """Normalize over every axis but the last (epsilon 1e-5).  Training
    updates the ``batch_stats`` running averages (pass
    ``mutable=['batch_stats']``)."""

    use_running_average: bool
    momentum: float = 0.99
    dtype: Optional[Dtype] = None
    use_bias: bool = True
    use_scale: bool = True

    @compact
    def __call__(self, x):
        axes = tuple(range(x.ndim - 1))
        features = (x.shape[-1],)
        ra_mean = self.get_variable(
            "batch_stats", "mean", lambda: jnp.zeros(features, jnp.float32)
        )
        ra_var = self.get_variable(
            "batch_stats", "var", lambda: jnp.ones(features, jnp.float32)
        )
        if self.use_running_average:
            mean, var = ra_mean, ra_var
        else:
            mean, var = _stats(x, axes)
            if not self.is_initializing():
                m = self.momentum
                self.put_variable("batch_stats", "mean", m * ra_mean + (1 - m) * mean)
                self.put_variable("batch_stats", "var", m * ra_var + (1 - m) * var)
        return _normalize(
            self, x, mean, var, axes, self.dtype, 1e-5,
            self.use_bias, self.use_scale,
        )


class Dropout(Module):
    """Zero a ``rate`` share of the inputs and rescale the rest (needs a
    ``dropout`` rng unless deterministic)."""

    rate: float

    @compact
    def __call__(self, inputs, *, deterministic: bool):
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), keep, inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


def _pool(inputs, init, reduce_fn, window_shape, strides, padding):
    strides = strides or (1,) * len(window_shape)
    if not isinstance(padding, str):
        padding = ((0, 0),) + tuple(map(tuple, padding)) + ((0, 0),)
    return lax.reduce_window(
        inputs,
        init,
        reduce_fn,
        (1,) + tuple(window_shape) + (1,),
        (1,) + tuple(strides) + (1,),
        padding,
    )


def max_pool(inputs, window_shape, strides=None, padding="VALID"):
    return _pool(inputs, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(inputs, window_shape, strides=None, padding="VALID"):
    """Window mean; padded positions count toward the divisor."""
    y = _pool(inputs, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)
