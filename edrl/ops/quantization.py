"""Post-training W8A8 int8 quantization of Dense layers for serving.

Rationale: int8 x int8 -> int32 matmuls run at twice the bf16 tensor-core
rate on the H100, and the eval/serving forward is dominated by Dense
matmuls.  This module quantizes every large ``nn.Dense`` kernel to int8 with
static per-output-channel weight scales and *dynamic* per-row activation
scales — no calibration data or retraining needed — and swaps the matmul for
an ``int8 x int8 -> int32`` ``lax.dot_general`` at apply time via method
interception (``models.nn.intercept_methods``).  Everything around the
matmuls (LayerNorm, attention softmax, losses) stays bf16/f32.  Whether
this wins on the card is not measured yet.

Optionally, ``calibrate_activation_scales`` records *static* per-tensor
activation scales from a calibration batch (classic static-PTQ): the
interceptor then skips the dynamic per-row abs-max reduce — one extra full
read of every quantized Dense's input tensor.

This is a serving-path extension beyond the reference (which serves f32
torch, ``fusion_test.py:336-386``); accuracy impact is measured, not
assumed — see ``tests/test_quantization.py``.

Design notes
------------
- Only 2-D ``kernel`` parameters that belong to an ``nn.Dense`` module are
  touched, and only when ``min(in, out) >= min_dim`` (small projections are
  perf-irrelevant and accuracy-risky).  Dense ownership is established by a
  *discovery trace* (``discover_dense_paths``), not by guessing from tree
  shape, so custom 2-D params (EPRL proxies, fused-kernel weights) are never
  corrupted.
- Quantized params are an ordinary pytree (int8 kernels in place, f32
  everything else) plus a ``scales`` dict keyed by the module path joined
  with ``/`` — itself a valid pytree with string keys, so both pass through
  ``jax.jit`` arguments AND through ``jax.export`` serialization
  (``serve/export.py``).
- Applying quantized params WITHOUT the interceptor is an error by
  construction (nn.Dense would promote the int8 kernel); always go through
  ``quantized_apply`` or ``serve.Predictor``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from edrl.models import nn

Path = Tuple[str, ...]

# Reserved key suffix: a static activation scale for the Dense at path key
# ``k`` lives at ``k + ACT_SUFFIX`` in the same scales dict, so calibrated
# scales ride through jit arguments, ensemble stacking, and jax.export
# exactly like the weight scales do.  Module paths are "/"-joined module
# names, which never contain "@".
ACT_SUFFIX = "@act"


def _path_key(path: Path) -> str:
    return "/".join(path)


def discover_dense_paths(model: nn.Module, variables, *args, **kwargs):
    """Trace one apply and record the module paths of every ``nn.Dense`` hit.

    Runs under ``jax.eval_shape`` so no real compute happens — interceptors
    fire during tracing.  Returns paths in first-call order.
    """
    seen: Dict[Path, None] = {}

    def recorder(next_fun, f_args, f_kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dense) and context.method_name == "__call__":
            seen.setdefault(tuple(mod.path), None)
        return next_fun(*f_args, **f_kwargs)

    def run(v):
        with nn.intercept_methods(recorder):
            return model.apply(v, *args, **kwargs)

    jax.eval_shape(run, variables)
    return tuple(seen.keys())


def quantize_dense_params(
    params,
    dense_paths: Sequence[Path],
    min_dim: int = 128,
):
    """Symmetric per-output-channel int8 quantization of Dense kernels.

    Returns ``(new_params, scales)`` where ``new_params`` has int8 kernels in
    place of the selected f32 ones and ``scales["a/b/c"]`` is the f32
    ``[out_features]`` dequantization scale for the Dense module at path
    ``(a, b, c)``.
    Kernels below ``min_dim`` on either axis are left untouched (and will run
    the normal f32/bf16 path).
    """
    flat = _flatten(params)
    scales: Dict[str, jax.Array] = {}
    for path in dense_paths:
        key = path + ("kernel",)
        w = flat.get(key)
        if w is None or w.ndim != 2 or min(w.shape) < min_dim:
            continue
        w32 = jnp.asarray(w, jnp.float32)
        s = jnp.maximum(jnp.max(jnp.abs(w32), axis=0), 1e-12) / 127.0
        flat[key] = jnp.clip(jnp.round(w32 / s), -127, 127).astype(jnp.int8)
        scales[_path_key(path)] = s
    return _unflatten(flat), scales


def _flatten(tree, prefix: Path = ()) -> Dict[Path, Any]:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Path, Any]):
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _dynamic_quantize_rows(x: jax.Array):
    """Per-row (last-axis) symmetric int8 quantization of activations."""
    x32 = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    s = jnp.maximum(amax, 1e-12) / 127.0
    q = jnp.clip(jnp.round(x32 / s), -127, 127).astype(jnp.int8)
    return q, s


def calibrate_activation_scales(
    model: nn.Module,
    variables,
    scales,
    *calib_args,
    percentile: float = 100.0,
    **calib_kwargs,
) -> Dict[str, jax.Array]:
    """Static per-tensor activation scales from a calibration batch.

    Runs ONE jitted forward of the *unquantized* ``variables`` (classic PTQ
    calibration measures the fp activation distribution) and records, for
    every Dense path already present in ``scales``, the abs-max of that
    module's input.  Returns a new scales dict with scalar f32
    ``"<path>@act"`` entries (abs-max / 127) added; ``make_int8_interceptor``
    then quantizes activations with these instead of the dynamic per-row
    abs-max reduce, removing one full read of every quantized Dense's input
    tensor at serve time.

    Per-tensor static scales are coarser than per-row dynamic ones and
    serving values outside the calibrated range saturate — calibrate on a
    batch that covers the serving distribution and measure the accuracy
    delta (``tests/test_quantization.py`` does, and ``scripts/bench_int8.py
    --static`` measures both axes on the flagship).

    ``percentile < 100`` clips the calibrator to that percentile of |x|
    instead of the raw abs-max (e.g. 99.9): a single activation outlier —
    common in transformer LN/GELU tails — otherwise inflates the scale and
    crushes int8 resolution for the rest of the tensor.  Values beyond the
    percentile saturate at ±127 (standard static-PTQ clipping).  When a
    Dense path is applied more than once in the forward (shared modules),
    per-call percentiles are combined with max — a slight overestimate of
    the joint percentile, never an underestimate of coverage.
    """
    target = {k for k in scales if not k.endswith(ACT_SUFFIX)}

    def run(v, *args):
        amax: Dict[str, jax.Array] = {}

        def recorder(next_fun, f_args, f_kwargs, context):
            mod = context.module
            if isinstance(mod, nn.Dense) and context.method_name == "__call__":
                key = _path_key(tuple(mod.path))
                if key in target:
                    absx = jnp.abs(f_args[0].astype(jnp.float32))
                    if percentile >= 100.0:
                        a = jnp.max(absx)
                    else:
                        a = jnp.percentile(absx.reshape(-1), percentile)
                    prev = amax.get(key, jnp.zeros((), jnp.float32))
                    amax[key] = jnp.maximum(prev, a)
            return next_fun(*f_args, **f_kwargs)

        with nn.intercept_methods(recorder):
            model.apply(v, *args, **calib_kwargs)
        return amax

    amax = jax.jit(run)(variables, *calib_args)
    out = dict(scales)
    for key, a in amax.items():
        out[key + ACT_SUFFIX] = jnp.maximum(a, 1e-12) / 127.0
    return out


def make_int8_interceptor(scales: Dict[str, jax.Array]):
    """Method interceptor replacing quantized Dense matmuls with
    ``int8 x int8 -> int32`` dots + f32 rescale (+ bias).

    Activation scales are dynamic per-row by default; if the scales dict
    carries a calibrated ``"<path>@act"`` entry (``calibrate_activation_
    scales``), that static per-tensor scale is used instead — no abs-max
    reduce over the activations at serve time."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, nn.Dense) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        key = _path_key(tuple(mod.path))
        w_scale = scales.get(key)
        if w_scale is None:
            return next_fun(*args, **kwargs)
        (x,) = args
        params = mod.variables["params"]
        w_q = params["kernel"]  # int8 [in, out]
        act_scale = scales.get(key + ACT_SUFFIX)
        if act_scale is None:
            x_q, x_scale = _dynamic_quantize_rows(x)
        else:
            # Static path: out-of-calibration-range values saturate at +-127
            # (standard static-PTQ semantics).
            x_scale = act_scale
            x_q = jnp.clip(
                jnp.round(x.astype(jnp.float32) / x_scale), -127, 127
            ).astype(jnp.int8)
        acc = jax.lax.dot_general(
            x_q,
            w_q,
            (((x_q.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        y = acc.astype(jnp.float32) * x_scale * w_scale
        if mod.use_bias:
            y = y + params["bias"].astype(jnp.float32)
        return y.astype(mod.dtype or x.dtype)

    return interceptor


@contextlib.contextmanager
def int8_dense(scales: Dict[str, jax.Array]):
    """Context manager: inside it, ``model.apply`` uses the int8 Dense path
    for every module in ``scales``.  Must be active during jit *tracing*."""
    with nn.intercept_methods(make_int8_interceptor(scales)):
        yield


def quantized_apply(model: nn.Module, variables, scales, *args, **kwargs):
    """``model.apply`` with int8 Dense interception active."""
    with int8_dense(scales):
        return model.apply(variables, *args, **kwargs)


def quantize_for_serving(
    model: nn.Module,
    variables,
    *example_args,
    min_dim: int = 128,
    **example_kwargs,
) -> Tuple[Any, Dict[str, jax.Array], Dict[str, Any]]:
    """One-call PTQ: discover Dense modules, quantize their kernels.

    Returns ``(quantized_variables, scales, report)``.  ``report`` lists the
    quantized paths and the parameter-byte reduction.
    """
    dense_paths = discover_dense_paths(
        model, variables, *example_args, **example_kwargs
    )
    params = variables["params"] if "params" in variables else variables
    qparams, scales = quantize_dense_params(params, dense_paths, min_dim=min_dim)
    if "params" in variables:
        qvariables = dict(variables)
        qvariables["params"] = qparams
    else:
        qvariables = qparams

    def tree_bytes(t):
        return sum(
            x.size * x.dtype.itemsize
            for x in jax.tree_util.tree_leaves(t)
            if hasattr(x, "dtype")
        )

    report = {
        "dense_modules_seen": len(dense_paths),
        "dense_modules_quantized": len(scales),
        "param_bytes_before": tree_bytes(params),
        "param_bytes_after": tree_bytes(qparams)
        + sum(s.size * s.dtype.itemsize for s in scales.values()),
        "quantized_paths": sorted(scales),
    }
    return qvariables, scales, report
