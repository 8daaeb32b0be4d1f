"""Data parallelism over ``torch.distributed`` (``parallel/`` of the JAX
package): ``mesh`` holds the world as the port sees it and the collectives the
step uses, ``multihost`` joins or launches the process group."""

from .mesh import (
    World,
    all_reduce_mean,
    all_reduce_sum,
    average_gradients,
    draw,
    local_batch_size,
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
    "World",
    "all_reduce_mean",
    "all_reduce_sum",
    "average_gradients",
    "draw",
    "global_batch_from_local",
    "initialize",
    "is_main_process",
    "local_batch_size",
    "maybe_initialize",
    "shard_batch",
    "should_initialize",
    "world",
]
