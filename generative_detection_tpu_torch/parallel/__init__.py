"""Data parallelism over ``torch.distributed`` (``parallel/`` of the JAX
package): ``mesh`` holds the world as the port sees it and the collectives the
step uses, ``multihost`` joins or launches the process group, and ``fsdp``
shards parameters over it (FSDP, ZeRO-3) and holds the flat slice ZeRO-1
shares."""

from .fsdp import FlatShard, is_sharded, shard_module
from .mesh import (
    World,
    all_gather_cat,
    all_reduce_mean,
    all_reduce_sum,
    average_gradients,
    draw,
    local_batch_size,
    reduce_scatter,
    shard_batch,
    world,
)
from .multihost import (
    global_batch_from_local,
    initialize,
    is_main_process,
    maybe_initialize,
    should_initialize,
)

__all__ = [
    "FlatShard",
    "World",
    "all_gather_cat",
    "all_reduce_mean",
    "all_reduce_sum",
    "average_gradients",
    "draw",
    "global_batch_from_local",
    "initialize",
    "is_main_process",
    "is_sharded",
    "local_batch_size",
    "maybe_initialize",
    "reduce_scatter",
    "shard_batch",
    "shard_module",
    "should_initialize",
    "world",
]
