"""Data parallelism over ``torch.distributed`` (counterpart of
``marconet_tpu/parallel``).

One rank drives one device, ``cuda:LOCAL_RANK``, so the JAX package's
``mesh.py`` (a device mesh inside one process) has no counterpart here,
nor have ``local_rows`` and ``make_global_batch``: each rank already
holds only its own rows of the global batch.
"""

from marconet_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    all_reduce_metrics,
    broadcast_module_state,
    local_batch_slice,
    local_rank,
    maybe_initialize,
    rank,
    world_size,
)

__all__ = ["maybe_initialize", "rank", "world_size", "local_rank",
           "local_batch_slice", "broadcast_module_state",
           "all_reduce_grads", "all_reduce_metrics"]
