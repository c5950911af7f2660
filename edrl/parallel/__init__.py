"""Parallelism layer: device mesh, shardings, TP rules (new vs reference).

The reference is single-GPU (SURVEY.md section 2.7); this package adds the
scale-out path: a (data, model) ``jax.sharding.Mesh``, batch
sharded over the data axis, optional tensor-parallel sharding of the large
MLP kernels over the model axis, with XLA SPMD inserting all collectives
(psum for gradients, all-gather for the global-batch MK-MMD / Barlow
statistics).
"""

from edrl.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated,
    infer_param_shardings,
    shard_batch,
    shard_stacked_batch,
    sharded_byte_fraction,
    train_state_shardings,
    zero1_opt_shardings,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "infer_param_shardings",
    "shard_batch",
    "shard_stacked_batch",
    "sharded_byte_fraction",
    "train_state_shardings",
    "zero1_opt_shardings",
]
