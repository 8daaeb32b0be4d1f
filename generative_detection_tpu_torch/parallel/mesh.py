"""The process group as the port sees it (``parallel/mesh.py`` of the JAX
package).

The JAX package trains data-parallel over a ``Mesh`` with the batch sharded
over its ``data`` axis: under ``jit`` a sharded batch's sums and means are
global, and XLA inserts the gradient psum. The port runs one process a card
over ``torch.distributed`` (NCCL on the card, gloo on the CPU; see
``multihost.py``), so it makes those sums global itself, where the step forms
them:

- ``all_reduce_sum`` / ``all_reduce_mean``: a tensor, or a dict of scalars in
  one collective (the logged metrics);
- ``average_gradients``: parameter gradients averaged over the ranks in flat
  buckets, XLA's gradient psum;
- ``all_gather_cat`` / ``reduce_scatter``: the ZeRO-1 and FSDP shards'
  gathers and FSDP's gradient reduction (``fsdp.py``);
- ``differentiable_all_reduce_sum``: a sum whose backward all-reduces the
  incoming gradients too (the discriminator's batch statistics);
- ``draw``: a rank's slice of the random tensor one process would draw for
  the global batch, so W ranks take the draws of one process.

``world()`` reads the default process group. Outside one every helper is the
identity of a single process. Inside a group of one rank the collectives run
and leave every value bit for bit as it was (a sum of one, a mean over one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

# elements a flat gradient bucket holds: 128 MiB of float32
BUCKET_ELEMENTS = 32 * 1024 * 1024


@dataclass(frozen=True)
class World:
    """This process's place in the default process group: ``rank`` of
    ``size``; ``active`` when a group is initialized (of one rank or more)."""

    rank: int = 0
    size: int = 1
    active: bool = False


def world() -> World:
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size(), True)
    return World()


def local_batch_size(global_batch_size: int, world_size: int) -> int:
    """The per-rank batch of ``global_batch_size`` over ``world_size``
    ranks; a remainder raises."""
    if global_batch_size % world_size != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by the world size {world_size}"
        )
    return global_batch_size // world_size


def shard_batch(batch: Mapping[str, Any], rank: int = None, size: int = None) -> Dict[str, Any]:
    """The rank's slice (along the leading dimension) of every array of a
    global host batch: rank r of W takes rows [r * B / W, (r + 1) * B / W),
    the order in which the ranks' batches concatenate into the global one.
    ``rank`` and ``size`` default to ``world()``'s."""
    w = world()
    rank = w.rank if rank is None else rank
    size = w.size if size is None else size
    out = {}
    for k, v in batch.items():
        n = local_batch_size(len(v), size)
        out[k] = v[rank * n : (rank + 1) * n]
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (in place), or ``x`` outside a group."""
    if world().active:
        dist.all_reduce(x)
    return x


def all_reduce_mean(
    x: Union[torch.Tensor, Mapping[str, Any]],
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean over the ranks of a tensor, or of every scalar of a dict (as
    float32, in one collective on the first tensor's device). Outside a
    group: ``x`` as it is."""
    w = world()
    if not w.active:
        return x if isinstance(x, torch.Tensor) else dict(x)
    if isinstance(x, torch.Tensor):
        out = x.clone(memory_format=torch.contiguous_format)  # collectives take dense tensors
        dist.all_reduce(out)
        return out.div_(w.size)
    keys = list(x)
    device = next((v.device for v in x.values() if isinstance(v, torch.Tensor)), None)
    flat = torch.stack([torch.as_tensor(x[k], dtype=torch.float32, device=device).reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    flat.div_(w.size)
    return dict(zip(keys, flat.unbind()))


def any_rank(flag: bool) -> bool:
    """True when ``flag`` is true on any rank (a collective on the CPU)."""
    if not world().active:
        return flag
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _buckets(tensors: Sequence[torch.Tensor], limit: int) -> List[List[int]]:
    """Consecutive runs of tensors of one dtype and device, each run at most
    ``limit`` elements (a larger tensor alone)."""
    out: List[List[int]] = []
    size, key = 0, None
    for i, t in enumerate(tensors):
        k = (t.dtype, t.device)
        if not out or k != key or size + t.numel() > limit:
            out.append([])
            size, key = 0, k
        out[-1].append(i)
        size += t.numel()
    return out


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (of one size on every rank) concatenated along the
    leading dimension in rank order. Gloo gathers host tensors only, so a
    card's tensor in a gloo group goes through the host."""
    w = world()
    if not w.active:
        return x
    staged = x.is_cuda and "nccl" not in str(dist.get_backend())
    src = x.cpu() if staged else x
    parts = [torch.empty_like(src) for _ in range(w.size)]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``x`` summed over the ranks: ``x`` (of W k
    elements on every rank, W the world) in W parts of k, rank r keeping the
    sum of every rank's part r. NCCL reduce-scatters a card's tensor; else
    (gloo, which not every PyTorch release gives a reduce-scatter, or a host
    tensor in a group of both backends) the ranks all-reduce on the host (a
    card's tensor staged as ``all_gather_cat`` stages it) and each keeps its
    part. Outside a group ``x`` itself."""
    w = world()
    if not w.active:
        return x
    k = x.numel() // w.size
    if x.is_cuda and "nccl" in str(dist.get_backend()):
        out = x.new_empty(k)
        dist.reduce_scatter_tensor(out, x.contiguous())
        return out
    summed = x.cpu().contiguous() if x.is_cuda else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(summed)
    return summed[w.rank * k: (w.rank + 1) * k].to(x.device, copy=True)


def average_gradients(tensors: Sequence[torch.Tensor], limit: int = BUCKET_ELEMENTS) -> None:
    """Replace each tensor by its mean over the ranks, in place: flat
    buckets of at most ``limit`` elements, one all-reduce each. Outside a
    group nothing changes."""
    w = world()
    if not w.active or not tensors:
        return
    for idx in _buckets(tensors, limit):
        group = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(w.size)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view(t.shape))


def differentiable_all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks; its gradient is the incoming gradients
    summed over the ranks (every rank's loss depends on every rank's ``x``).
    Every rank must run the backward through it, in the same order."""
    if not world().active:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def draw(fn: Callable[..., torch.Tensor], shape: Sequence[int], generator=None, device=None,
         dtype=None) -> torch.Tensor:
    """``fn(shape, generator=..., device=..., dtype=...)`` (``torch.randn``,
    ``torch.rand``) for this rank's slice of the batch: rank r of W draws
    the global tensor (W x the leading dimension) and takes rows [r B, (r +
    1) B). Every rank's generator advances as one process's would, so W
    ranks take exactly what one process draws for the global batch."""
    kw = {"generator": generator, "device": device}
    if dtype is not None:
        kw["dtype"] = dtype
    w = world()
    if w.size == 1:
        return fn(tuple(shape), **kw)
    b = shape[0]
    full = fn((w.size * b,) + tuple(shape[1:]), **kw)
    return full[w.rank * b : (w.rank + 1) * b]


def broadcast_object(obj: Any) -> Any:
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` outside a group."""
    if not world().active:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
