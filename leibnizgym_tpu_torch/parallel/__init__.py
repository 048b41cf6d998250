"""Env-axis data parallelism over torch.distributed (counterpart of
``leibnizgym_tpu/parallel``)."""

from leibnizgym_tpu_torch.parallel.mesh import (
    DataShard,
    data_shard,
    initialize_distributed,
    shard_batch,
)

__all__ = ["DataShard", "data_shard", "initialize_distributed", "shard_batch"]
