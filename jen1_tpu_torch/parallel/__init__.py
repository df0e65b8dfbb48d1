"""Device-mesh parallelism on torch.distributed (port of jen1_tpu/parallel)."""

from jen1_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    init_distributed,
    make_mesh,
    param_shardings,
    replicated,
    seq_sharding,
    shard_batch,
    shard_params,
)
