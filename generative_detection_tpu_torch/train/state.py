"""Train state and optimizers (``train/state.py`` of the JAX package).

Two Adam(b1=0.5, b2=0.9, eps=1e-8) optimizers, as the reference's
``configure_optimizers`` builds them: one over every parameter of the
network, one over the discriminator only. LPIPS is frozen and the loss's
``logvar`` is in neither optimizer, so both stay at their init. Each
optimizer clips its gradients to ``grad_clip`` in global norm first.

Numerics follow optax: ``clip_by_global_norm`` scales by max / ||g|| only
when ||g|| >= max (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the
norm), and ``torch.optim.Adam`` computes optax's ``adam`` update
(mu_hat / (sqrt(nu_hat) + eps)); its ``exp_avg``/``exp_avg_sq`` are optax's
mu and nu. A parameter without a gradient gets a zero one, so every
parameter's Adam step count advances each step, as optax's shared count does.

Accumulation (``optax.MultiSteps`` semantics): with ``accumulate`` k > 1 the
backward passes of a window of k micro-batches sum into the gradients, and
the clip and the Adam step run once, at the window's end, on their mean.
Parameters and moments do not change inside the window.

Parameters stay float32 (flax keeps fp32 params and casts at use), so Adam's
state and updates are fp32 whatever the compute dtype.

Data parallelism: in a process group the gradients are averaged over the
ranks at the window's end, before the clip (``parallel.mesh.
average_gradients``: flat buckets, one all-reduce each, XLA's psum of the JAX
package). The all-reduce is explicit rather than DDP's hooks: the step takes
its reconstruction gradients with ``torch.autograd.grad`` on a detached leaf
and has two optimizers over overlapping modules, and a window accumulates
locally, so one collective an optimizer step, where the optimizer steps, is
what XLA's psum is. With ``zero1`` (ZeRO-1, the JAX package's
``zero1_leaf_spec`` sharding) each rank keeps the Adam moments of one shard
only: a 1/W slice of all the parameters' elements, flattened in order (a
slice, not whole tensors, so a large tensor splits too): every rank averages
the full gradient and clips by its global norm, each updates its shard, and
the parameters are then all-gathered. Adam is elementwise, so the update
equals the unsharded one. ``state_dict`` consolidates the moments into the
unsharded optimizer's state dict and ``load_state_dict`` takes the rank's
shard of one, so a checkpoint moves between world sizes and between ZeRO-1
and not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch
from torch import nn

from ..models.blocks import flax_like_init_
from ..parallel.mesh import all_gather_cat, average_gradients, world


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2, eps))``
    over a fixed list of parameters; in a process group over the ranks'
    averaged gradients, with ``zero1`` over this rank's shard of the
    moments."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 grad_clip: Optional[float] = 1.0, b1: float = 0.5, b2: float = 0.9,
                 eps: float = 1e-8, accumulate: int = 1, zero1: bool = False):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.accumulate = max(int(accumulate), 1)
        self.mini_step = 0  # micro-batches summed into the open window
        self.adam_steps = 0
        w = world()
        self.zero1 = bool(zero1) and w.size > 1
        n = sum(p.numel() for p in self.params)
        # ZeRO-1: this rank's shard [lo, hi) of the parameters' elements, in
        # their order, each flattened in its logical (NCHW) order
        self.per_rank = -(-n // w.size) if self.zero1 else n
        lo = w.rank * self.per_rank if self.zero1 else 0
        self.shard_range = (min(lo, n), min(lo + self.per_rank, n))
        if self.zero1:
            ref = self.params[0]
            self.shard = nn.Parameter(torch.zeros(self.shard_range[1] - self.shard_range[0],
                                                  dtype=ref.dtype, device=ref.device))
            local = [self.shard]
        else:
            local = self.params
        fused = all(p.is_cuda for p in local)
        self.adam = torch.optim.Adam(local, lr=lr, betas=(b1, b2), eps=eps,
                                     foreach=not fused, fused=fused or None)

    def zero_grad(self) -> None:
        """Clear the gradients at a window's start (inside a window the
        backward passes sum into them)."""
        if self.mini_step == 0:
            for p in self.params:
                p.grad = None

    def step(self) -> bool:
        """Count a micro-batch; at the window's end average the summed
        gradients (over the window and the ranks), clip them by the global
        norm and take the Adam step (with ZeRO-1 on this rank's shard, then
        gather the parameters). True when it stepped."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.mini_step += 1
        if self.mini_step < self.accumulate:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params]
        average_gradients(grads)
        if self.accumulate > 1:
            torch._foreach_mul_(grads, 1.0 / self.accumulate)
        if self.grad_clip is not None and self.grad_clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        if self.zero1:
            with torch.no_grad():
                self.shard.copy_(self._flat_slice([p.detach() for p in self.params]))
            self.shard.grad = self._flat_slice(grads)
            self.adam.step()
            self.shard.grad = None
            with torch.no_grad():
                self._write_flat(self.params, self._gather(self.shard.detach()))
        else:
            self.adam.step()
        self.adam_steps += 1
        return True

    # -- ZeRO-1's flat shard -----------------------------------------------------

    def _flat_slice(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """This rank's shard of ``tensors`` (shaped as the parameters),
        flattened in their logical order."""
        lo, hi = self.shard_range
        parts, start = [], 0
        for t in tensors:
            end = start + t.numel()
            if end > lo and start < hi:
                parts.append(t.reshape(-1)[max(lo - start, 0): min(hi, end) - start])
            start = end
        return torch.cat(parts) if parts else tensors[0].new_zeros(0)

    def _gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's shard, in rank order: the flat tensor of all the
        parameters' elements (padded at the end)."""
        buf = shard.new_zeros(self.per_rank)
        buf[: shard.numel()] = shard
        return all_gather_cat(buf)

    def _write_flat(self, tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
        start = 0
        for t in tensors:
            t.copy_(flat[start: start + t.numel()].view(t.shape))
            start += t.numel()

    def _full_adam_state(self) -> dict:
        """The unsharded optimizer's ``state_dict``: the moments gathered
        from every rank's shard, each in its parameter's shape and memory
        format (a collective)."""
        group = dict(self.adam.state_dict()["param_groups"][0],
                     params=list(range(len(self.params))))
        if not self.adam_steps:
            return {"state": {}, "param_groups": [group]}
        st = self.adam.state[self.shard]
        flats = [self._gather(st[k]) for k in ("exp_avg", "exp_avg_sq")]
        state = {i: {"step": torch.tensor(float(self.adam_steps))} for i in range(len(self.params))}
        for key, flat in zip(("exp_avg", "exp_avg_sq"), flats):
            moments = [torch.empty_like(p) for p in self.params]
            self._write_flat(moments, flat)
            for i, m in enumerate(moments):
                state[i][key] = m
        return {"state": state, "param_groups": [group]}

    def _shard_adam_state(self, adam: dict) -> dict:
        """This rank's shard of an unsharded optimizer's ``state_dict``."""
        group = dict(adam["param_groups"][0], params=[0])
        saved = adam["state"]
        if not saved:
            return {"state": {}, "param_groups": [group]}
        st = {"step": saved[0]["step"]}
        for key in ("exp_avg", "exp_avg_sq"):
            st[key] = self._flat_slice([saved[i][key] for i in range(len(self.params))])
        return {"state": {0: st}, "param_groups": [group]}

    # -- checkpoints -------------------------------------------------------------

    def state_dict(self) -> dict:
        """Adam's state (with ZeRO-1 consolidated: what an unsharded run
        holds), the open window's count and, inside a window, the summed
        gradients (on the CPU; in a process group their mean over the
        ranks, which the window's end would take anyway). In a process
        group every rank must call it."""
        grads = [None] * len(self.params)
        if self.mini_step:
            grads = [p.grad.detach().clone() for p in self.params]
            average_gradients(grads)
            grads = [g.cpu() for g in grads]
        return {
            "adam": self._full_adam_state() if self.zero1 else self.adam.state_dict(),
            "mini_step": self.mini_step,
            "grads": grads,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Load an optimizer's ``state_dict`` (from any world size, with
        ZeRO-1 or without): with ZeRO-1 this rank's shard of it."""
        adam = sd["adam"]
        self.adam.load_state_dict(self._shard_adam_state(adam) if self.zero1 else adam)
        steps = [float(st["step"]) for st in adam["state"].values()]
        self.adam_steps = int(steps[0]) if steps else 0
        self.mini_step = int(sd["mini_step"])
        for p, g in zip(self.params, sd["grads"]):
            p.grad = None if g is None else g.to(p.device)

    def moments(self, p: nn.Parameter):
        """Adam's (mu, nu) of ``p``, zeros before its first step; not with
        ZeRO-1 (``held_moments`` has the shard, ``state_dict`` all)."""
        if self.zero1:
            raise ValueError("with ZeRO-1 a rank holds a shard of the moments: see held_moments")
        st = self.adam.state.get(p)
        if not st:
            return torch.zeros_like(p), torch.zeros_like(p)
        return st["exp_avg"], st["exp_avg_sq"]

    def held_moments(self):
        """(mu, nu) this rank holds over ``shard_range`` of the parameters'
        flat elements (all of them without ZeRO-1), zeros before the first
        step."""
        if self.zero1:
            st = self.adam.state.get(self.shard)
            if not st:
                return torch.zeros_like(self.shard), torch.zeros_like(self.shard)
            return st["exp_avg"], st["exp_avg_sq"]
        pairs = [self.moments(p) for p in self.params]
        return tuple(torch.cat([m[i].reshape(-1) for m in pairs]) for i in (0, 1))


@dataclass
class TrainState:
    step: int  # batch counter
    net: nn.Module
    # PoseLoss or LPIPSWithDiscriminator: perceptual (frozen), discriminator
    # (trained), logvar (frozen)
    loss: nn.Module
    opt_ae: ClippedAdam
    opt_disc: ClippedAdam
    generator: Optional[torch.Generator] = None  # the forward's random draws


def make_optimizers(
    net: nn.Module,
    loss: nn.Module,
    learning_rate: float,
    grad_clip: Optional[float] = 1.0,
    accumulate_grad_batches: int = 1,
    b1: float = 0.5,
    b2: float = 0.9,
    eps: float = 1e-8,
    zero1: bool = False,
):
    """(opt_ae over every net parameter, opt_disc over ``loss.discriminator``),
    each accumulating over ``accumulate_grad_batches`` micro-batches, with
    ``zero1`` each sharding its moments over the process group. Either
    family's net and loss (``PoseLoss`` or ``LPIPSWithDiscriminator``)."""
    kw = dict(lr=learning_rate, grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
              accumulate=accumulate_grad_batches, zero1=zero1)
    return (ClippedAdam(net.parameters(), **kw),
            ClippedAdam(loss.discriminator.parameters(), **kw))


def create_train_state(model, learning_rate: float, grad_clip: Optional[float] = 1.0,
                       seed: int = 0, device="cuda",
                       accumulate_grad_batches: int = 1, zero1: bool = False) -> TrainState:
    """A fresh state for a ``PoseAutoencoder`` or a plain ``Autoencoder``:
    seeded float32 net and loss on ``device`` and both optimizers. The
    weights are drawn on the CPU from ``seed``, then ``model.ckpt_path``'s reference checkpoint loads over them
    when it is set (the Adam moments start fresh); the forward's draws come
    from a generator on ``device`` seeded with ``seed + 1``. In a process
    group every rank makes the same state from the same seed; ``zero1``
    shards the optimizers' moments over it."""
    g = torch.Generator().manual_seed(seed)
    net = flax_like_net(model, g, device)
    loss = model.init_loss(g, device=device)
    model.maybe_init_from_ckpt(net, loss)
    opt_ae, opt_disc = make_optimizers(
        net, loss, learning_rate, grad_clip, accumulate_grad_batches, zero1=zero1
    )
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(0, net, loss, opt_ae, opt_disc, gen)


def flax_like_net(model, generator: torch.Generator, device) -> nn.Module:
    """``model``'s network, flax-like initialised, kept in float32 (the
    master weights) on ``device``."""
    net = flax_like_init_(model.build_net(), generator)
    return net.to(device=device, memory_format=torch.channels_last)
