"""Data parallelism (counterpart of pidnet_tpu/parallel/): the mesh, its
collectives and the batch placement. The JAX package's `batch_sharding`
and `replicated_sharding` are NamedShardings of one XLA program and have
no counterpart: each rank holds its own tensors."""

from pidnet_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    make_mesh,
    shard_batch,
    shard_microbatches,
)
