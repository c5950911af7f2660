"""AOT export of the serving forward as a versioned StableHLO artifact.

Production serving wants the *program* pinned independently of the
Python model code: ``jax.export`` serializes the lowered StableHLO of the
Predictor's fixed-shape forward (including the int8 Dense path when the
predictor is quantized), so a serving binary can ``deserialize`` and
``call`` it without importing ``edrl.models`` at all — no tracing, no
Python-side model drift, stable across framework refactors.

Weights stay in the checkpoint (they are *arguments* of the exported
program, not baked-in constants), so one artifact serves every checkpoint
of the same architecture.

This has no reference counterpart (the reference redefines the torch model
and ``load_state_dict``s at serve time, ``fusion_test.py:336-386``); it is
part of the serving story alongside ``serve.Predictor``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import export as jax_export


def _abstract_like(tree):
    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree
    )


def export_forward(predictor, path: str | None = None) -> bytes:
    """Serialize the predictor's single-batch forward program.

    The exported callable has signature ``(variables, scales, fundus,
    oct_vol) -> probs`` with the predictor's serving batch size and input
    dtypes (f32 in [0,1]).  Returns the serialized bytes; also writes them
    to ``path`` when given.
    """
    d = predictor.cfg.data
    b = predictor.batch_size
    args = (
        _abstract_like(predictor.variables),
        _abstract_like(predictor.scales),
        jax.ShapeDtypeStruct((b, d.fundus_size, d.fundus_size, 3), jnp.float32),
        jax.ShapeDtypeStruct((b, *d.oct_size, 1), jnp.float32),
    )
    exported = jax_export.export(predictor._forward)(*args)
    blob = exported.serialize()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


class ExportedForward:
    """A deserialized serving program: ``call(variables, scales, fundus,
    oct_vol) -> probs``.  Needs no model code, only the checkpointed
    variables (and scales, ``{}`` for unquantized exports)."""

    def __init__(self, blob: bytes):
        self._exported = jax_export.deserialize(blob)

    @classmethod
    def load(cls, path: str) -> "ExportedForward":
        with open(path, "rb") as f:
            return cls(f.read())

    def __call__(self, variables, scales, fundus, oct_vol):
        return self._exported.call(variables, scales, fundus, oct_vol)


def roundtrip_check(predictor, fundus, oct_vol) -> Tuple[bool, float]:
    """Export -> deserialize -> compare against the live forward on one
    batch.  Returns (exact_dtype_shape_match, max_abs_delta)."""
    import numpy as np

    blob = export_forward(predictor)
    loaded = ExportedForward(blob)
    live = predictor._forward(
        predictor.variables, predictor.scales, fundus, oct_vol
    )
    replay = loaded(predictor.variables, predictor.scales, fundus, oct_vol)
    same = live.shape == replay.shape and live.dtype == replay.dtype
    return same, float(np.max(np.abs(np.asarray(live) - np.asarray(replay))))
