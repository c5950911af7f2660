"""Batched serving front-end for any registry model.

The reference's serving story is ``fusion_test.py``'s eval loop (checkpoint
load + per-batch ``model(data)`` + sklearn metrics, ``fusion_test.py:336-386``).
This module is the production-shaped equivalent:

- ONE fixed-shape jitted forward (tail batches are padded, never recompiled);
- optional ``chunk_batches > 1``: stack N batches and run them as one
  ``lax.scan`` program per dispatch;
- all host syncs deferred to the end of ``predict_probs`` (one transfer);
- optional W8A8 int8 quantization of the Dense matmuls
  (``edrl.ops.quantization``);
- accepts uint8 inputs and normalizes on device (4x less host->device
  traffic, same trick as the trainer's ``uint8_transport``);
- deep-ensemble serving: pass a list of member states and the K forwards run
  as ONE vmapped program with logits averaged on device (the reference's
  ``test_ensemble`` semantics, ``fusion_train.py:441-445``) — composes with
  int8 (each member quantized independently, scales vmapped alongside);
- multi-chip serving: pass a ``jax.sharding.Mesh`` and the batch is sharded
  over the ``data`` axis while params follow the tensor-parallel rules from
  ``parallel.mesh`` (replicated when ``model=1``); XLA inserts the
  collectives.  Ensemble members' stacked 3-D kernels replicate (TP rules
  are 2-D-kernel scoped).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from edrl.config import EDRLConfig


def _to_uint8_transport(x: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 for transport (uint8 passes through)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x
    return np.clip(np.round(x * 255.0), 0.0, 255.0).astype(np.uint8)


class Predictor:
    """Serve class probabilities for fundus+OCT pairs.

    Parameters
    ----------
    cfg: full config (model architecture + eval batch size).
    state: a ``TrainState`` (e.g. from ``CheckpointManager.restore``).
    quantize_int8: post-training-quantize Dense kernels >= ``min_dim`` to
        int8 (W8A8 dynamic).  Accuracy delta is small but nonzero — measure
        on your eval set (tests assert top-1 agreement on synthetic data).
    int8_calibration: optional ``(fundus, oct_vol)`` calibration batch
        (f32 in [0,1] or uint8, any N).  With ``quantize_int8``, records
        static per-tensor activation scales from one fp forward per member
        (``ops.quantization.calibrate_activation_scales``), replacing the
        dynamic per-row abs-max reduce at serve time.  Coarser quantization
        — measure the accuracy delta on your eval set.  The batch is tiled/
        truncated to ``eval_batch_size`` so calibration reuses one compiled
        shape regardless of how many samples are passed.
    int8_calib_percentile: calibrator percentile over |activations|
        (100 = abs-max; e.g. 99.9 clips outliers, values beyond saturate).
    chunk_batches: batches per dispatch (1 = plain per-batch jit).
    transport: host->device input encoding.  ``"uint8"`` (default) ships
        requests as uint8 and dequantizes on device — 4x fewer bytes to
        copy; exact for 8-bit image sources (uint8 inputs pass through,
        floats in [0,1] are round-tripped through 1/255 steps).  ``"f32"``
        ships floats unmodified — use it for data with genuine sub-8-bit
        precision.
    """

    def __init__(
        self,
        cfg: EDRLConfig,
        state,
        *,
        quantize_int8: bool = False,
        int8_calibration=None,
        int8_calib_percentile: float = 100.0,
        min_dim: int = 128,
        chunk_batches: int = 1,
        mesh=None,
        transport: str = "uint8",
    ):
        from edrl.train.trainer import make_model

        self.cfg = cfg
        self.model = make_model(cfg)
        self.batch_size = cfg.data.eval_batch_size
        self.chunk_batches = max(1, int(chunk_batches))
        self.mesh = mesh
        if transport not in ("uint8", "f32"):
            raise ValueError(f"transport must be 'uint8' or 'f32', got {transport!r}")
        self.transport = transport
        if mesh is not None and self.batch_size % mesh.shape["data"] != 0:
            raise ValueError(
                f"eval_batch_size {self.batch_size} not divisible by the "
                f"mesh data axis ({mesh.shape['data']})"
            )
        self.quantized = bool(quantize_int8)
        if int8_calibration is not None and not quantize_int8:
            raise ValueError("int8_calibration requires quantize_int8=True")
        states = state if isinstance(state, (list, tuple)) else [state]
        self.num_members = len(states)
        member_vars = [
            {"params": s.params, "batch_stats": s.batch_stats} for s in states
        ]

        d = cfg.data
        if quantize_int8:
            from edrl.ops.quantization import quantize_for_serving

            example = (
                jnp.zeros((2, d.fundus_size, d.fundus_size, 3), jnp.float32),
                jnp.zeros((2, *d.oct_size, 1), jnp.float32),
                jnp.zeros((2,), jnp.int32),
            )
            quantized = [
                quantize_for_serving(
                    self.model, v, *example, train=False, min_dim=min_dim
                )
                for v in member_vars
            ]
            member_scales = [q[1] for q in quantized]
            self.quant_report = quantized[0][2]
            if int8_calibration is not None:
                # Static activation scales, calibrated on the fp (pre-
                # quantization) member variables — one jitted forward per
                # member; XLA dead-code-eliminates everything downstream of
                # the recorded Dense inputs.
                from edrl.ops.quantization import (
                    calibrate_activation_scales,
                )
                from edrl.train.trainer import _dequantize

                # Pin every calibration FORWARD to eval_batch_size (one
                # compiled shape — a distinct sample count would pay a fresh
                # full-model compile), but cover
                # the WHOLE calibration set by chunking it into
                # eval_batch_size-sized batches and max-combining the
                # per-chunk scales (ADVICE r4 #1: the old single-batch
                # truncation silently dropped samples beyond
                # eval_batch_size).  The last chunk wraps around; repeats
                # cannot widen a recorded range.  With percentile clipping
                # the combine is max-of-per-chunk-percentiles — slightly
                # conservative vs a global percentile, never narrower.
                n = d.eval_batch_size
                cal_f = np.asarray(int8_calibration[0])
                cal_o = np.asarray(int8_calibration[1])
                if len(cal_f) == 0 or len(cal_o) == 0:
                    raise ValueError("int8_calibration batch is empty")
                num_chunks = max(1, -(-len(cal_f) // n))
                cy = jnp.zeros((n,), jnp.int32)
                # Build (and upload) each chunk ONCE, outside the member
                # loop: K ensemble members reuse the same device-resident
                # chunk tensors instead of paying K x num_chunks transfers.
                chunks = []
                for c in range(num_chunks):
                    ids = np.arange(c * n, (c + 1) * n) % len(cal_f)
                    chunks.append(
                        (
                            _dequantize(jnp.asarray(cal_f[ids])),
                            _dequantize(jnp.asarray(cal_o[ids])),
                        )
                    )
                combined_scales = []
                for v, s in zip(member_vars, member_scales):
                    combined = None
                    for cf, co in chunks:
                        sc = calibrate_activation_scales(
                            self.model, v, s, cf, co, cy,
                            percentile=int8_calib_percentile, train=False,
                        )
                        combined = (
                            sc
                            if combined is None
                            else jax.tree_util.tree_map(jnp.maximum, combined, sc)
                        )
                    combined_scales.append(combined)
                member_scales = combined_scales
                self.quant_report = dict(
                    self.quant_report,
                    static_activation_scales=len(member_scales[0])
                    - len(quantized[0][1]),
                )
            member_vars = [q[0] for q in quantized]
        else:
            member_scales = [{} for _ in member_vars]
            self.quant_report = {}

        if self.num_members == 1:
            self.variables, self.scales = member_vars[0], member_scales[0]
        else:
            # Members share an architecture by construction so the pytrees
            # are congruent and the K forwards can run as ONE vmapped program.
            from edrl.train.ensemble import stack_pytrees

            self.variables = stack_pytrees(member_vars)
            self.scales = stack_pytrees(member_scales) if quantize_int8 else {}

        if mesh is not None:
            from edrl.parallel.mesh import infer_param_shardings, replicated

            rep = replicated(mesh)

            def shard_tree(tree, shardings):
                return jax.tree_util.tree_map(jax.device_put, tree, shardings)

            param_sh = infer_param_shardings(self.variables["params"], mesh)
            self.variables = {
                "params": shard_tree(self.variables["params"], param_sh),
                "batch_stats": jax.tree_util.tree_map(
                    lambda x: jax.device_put(x, rep),
                    self.variables["batch_stats"],
                ),
            }
            self.scales = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, rep), self.scales
            )

        model = self.model
        num_members = self.num_members

        def member_logits(variables, scales, fundus, oct_vol, y):
            from edrl.ops.quantization import int8_dense
            from edrl.train.trainer import _normalize_output

            def apply():
                return model.apply(variables, fundus, oct_vol, y, train=False)

            if scales:
                with int8_dense(scales):
                    out = apply()
            else:
                out = apply()
            return _normalize_output(out)[0]

        def forward(variables, scales, fundus, oct_vol):
            from edrl.train.trainer import _dequantize

            fundus = _dequantize(fundus)
            oct_vol = _dequantize(oct_vol)
            y = jnp.zeros((fundus.shape[0],), jnp.int32)  # logits ignore labels
            if num_members == 1:
                logits = member_logits(variables, scales, fundus, oct_vol, y)
            else:
                logits_k = jax.vmap(
                    lambda v, s: member_logits(v, s, fundus, oct_vol, y),
                    in_axes=(0, 0 if scales else None),
                )(variables, scales if scales else None)
                logits = jnp.mean(logits_k, axis=0)
            return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)

        # Mesh serving traces under the mesh context so batch_constraint
        # resolves — same contract as the sharded train/eval steps.
        from edrl.train.trainer import _with_mesh

        ctx_mesh = mesh if mesh is not None and mesh.devices.size > 1 else None
        self._forward = _with_mesh(jax.jit(forward), ctx_mesh)

        def forward_chunk(variables, scales, fundus_c, oct_c):
            def body(_, xs):
                f, o = xs
                return (), forward(variables, scales, f, o)

            _, probs = jax.lax.scan(body, (), (fundus_c, oct_c))
            return probs  # [C, B, classes]

        self._forward_chunk = _with_mesh(jax.jit(forward_chunk), ctx_mesh)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: EDRLConfig,
        checkpoint_dir: str,
        name: Optional[str] = None,
        **kwargs,
    ) -> "Predictor":
        from edrl.train.ensemble import restore_members

        if name is None:  # best-else-latest, shared with the ensemble path
            return cls(cfg, restore_members(cfg, [checkpoint_dir])[0], **kwargs)

        from edrl.train.checkpoint import CheckpointManager
        from edrl.train.trainer import init_state

        _, template = init_state(cfg, 0)
        mgr = CheckpointManager(checkpoint_dir)
        return cls(cfg, mgr.restore(template, name), **kwargs)

    @classmethod
    def from_checkpoints(
        cls, cfg: EDRLConfig, checkpoint_dirs, **kwargs
    ) -> "Predictor":
        """Deep-ensemble predictor from K member checkpoint dirs
        (the serving counterpart of ``train.ensemble.evaluate_ensemble``)."""
        from edrl.train.ensemble import restore_members

        return cls(cfg, restore_members(cfg, checkpoint_dirs), **kwargs)

    def predict_probs(self, fundus: np.ndarray, oct_vol: np.ndarray) -> np.ndarray:
        """Probabilities ``[N, num_classes]`` for N pairs.

        ``fundus``: ``[N, H, W, 3]`` float in [0,1] or uint8;
        ``oct_vol``: ``[N, D, H, W, 1]`` likewise.  Any N: inputs are padded
        to the serving batch size on the host and results sliced back.
        """
        n = fundus.shape[0]
        if oct_vol.shape[0] != n:
            raise ValueError("fundus/oct batch mismatch")
        if n == 0:
            return np.zeros((0, self.cfg.model.num_classes), np.float32)
        if self.transport == "uint8":
            # Default request path: ship uint8, dequantize on device.
            # uint8 inputs pass through untouched; [0,1] floats round-trip
            # through 1/255 steps (exact for 8-bit sources).
            fundus = _to_uint8_transport(fundus)
            oct_vol = _to_uint8_transport(oct_vol)
        b, c = self.batch_size, self.chunk_batches
        pad = (-n) % b
        if pad:
            fundus = np.concatenate([fundus, np.repeat(fundus[-1:], pad, 0)])
            oct_vol = np.concatenate([oct_vol, np.repeat(oct_vol[-1:], pad, 0)])
        num_batches = fundus.shape[0] // b

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            batch_sh = NamedSharding(self.mesh, P("data"))
            chunk_sh = NamedSharding(self.mesh, P(None, "data"))

            def put(x, sh):
                # device_put straight from the numpy array (same as
                # parallel.mesh.shard_batch): jnp.asarray first would stage
                # the WHOLE batch on the default device, then reshard.
                return jax.device_put(x, sh)
        else:
            batch_sh = chunk_sh = None

            def put(x, sh):
                return jnp.asarray(x)

        device_probs = []
        i = 0
        while i < num_batches:
            if c > 1 and num_batches - i >= c:
                f = put(
                    fundus[i * b : (i + c) * b].reshape(c, b, *fundus.shape[1:]),
                    chunk_sh,
                )
                o = put(
                    oct_vol[i * b : (i + c) * b].reshape(c, b, *oct_vol.shape[1:]),
                    chunk_sh,
                )
                p = self._forward_chunk(self.variables, self.scales, f, o)
                device_probs.append(p.reshape(c * b, -1))
                i += c
            else:
                f = put(fundus[i * b : (i + 1) * b], batch_sh)
                o = put(oct_vol[i * b : (i + 1) * b], batch_sh)
                device_probs.append(self._forward(self.variables, self.scales, f, o))
                i += 1
        # ONE host sync for the whole request.
        probs = np.concatenate([np.asarray(p) for p in device_probs])
        return probs[:n]

    def predict_labels(self, fundus: np.ndarray, oct_vol: np.ndarray) -> np.ndarray:
        return self.predict_probs(fundus, oct_vol).argmax(axis=-1)
