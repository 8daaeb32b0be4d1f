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

FSDP (ZeRO-3, the JAX package's ``create_train_state(fsdp=True)``):
``shard_for_fsdp`` shards the parameters of the net, LPIPS and the
discriminator themselves into units (``parallel/fsdp.py``), each rank keeping
a 1/W flat shard of each unit; the optimizers then step on those shards. The
backward has reduce-scattered each unit's gradient into its shard's (the mean
over the ranks), so at a window's end the global norm is the square root of
the ranks' squared shard norms summed, optax's rule clips by it, and Adam
updates the shard; the parameters stay sharded (a unit's forward gathers
them). ``state_dict`` and ``load_state_dict`` move between FSDP, ZeRO-1 and
the unsharded optimizer through the unsharded layout. In a world of one
nothing is sharded, as the JAX package's mesh of one is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from ..models.blocks import AttnBlock, Downsample, ResnetBlock, Upsample, flax_like_init_
from ..models.discriminator import NLayerDiscriminator
from ..models.lpips import VGG16Slices
from ..models.pose_modules import PoseDecoderSpatialVAE, PoseEncoderSpatialVAE
from ..parallel import fsdp
from ..parallel.fsdp import FlatShard
from ..parallel.mesh import all_reduce_sum, average_gradients, world


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2, eps))``
    over a fixed list of parameters; in a process group over the ranks'
    averaged gradients, with ``zero1`` over this rank's shard of the
    moments, and over a sharded module's flat shards when ``layout`` (its
    ``parallel.fsdp.layout``) is given."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 grad_clip: Optional[float] = 1.0, b1: float = 0.5, b2: float = 0.9,
                 eps: float = 1e-8, accumulate: int = 1, zero1: bool = False,
                 layout: Optional[List[Tuple[fsdp.Unit, int]]] = None):
        self.grad_clip = grad_clip
        self.accumulate = max(int(accumulate), 1)
        self.mini_step = 0  # micro-batches summed into the open window
        self.adam_steps = 0
        # the global norm of the last step's averaged gradient, before clipping
        self.grad_norm: Optional[torch.Tensor] = None
        w = world()
        # FSDP: the parameters are the units' flat shards, each rank's 1/W
        self.layout = layout
        self.fsdp = layout is not None
        if self.fsdp:
            self.units = list(dict.fromkeys(u for u, _ in layout))
            self.params = [u.flat for u in self.units]
        else:
            self.params = list(params)
        self.zero1 = bool(zero1) and w.size > 1 and not self.fsdp
        # ZeRO-1: this rank's shard [lo, hi) of the parameters' elements, in
        # their order, each flattened in its logical (NCHW) order
        self.flat = FlatShard([p.numel() for p in self.params],
                              w.rank if self.zero1 else 0, w.size if self.zero1 else 1)
        self.shard_range = None if self.fsdp else self.flat.shard_range
        if self.zero1:
            ref = self.params[0]
            lo, hi = self.shard_range
            self.shard = nn.Parameter(torch.zeros(hi - lo, dtype=ref.dtype, device=ref.device))
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
        gather the parameters; with FSDP on the shards, whose gradients the
        backward reduce-scattered, and the parameters stay sharded). True
        when it stepped."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.mini_step += 1
        if self.mini_step < self.accumulate:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params]
        if not self.fsdp:
            average_gradients(grads)
        if self.accumulate > 1:
            torch._foreach_mul_(grads, 1.0 / self.accumulate)
        if self.grad_clip is not None and self.grad_clip > 0:
            norms = torch.stack(torch._foreach_norm(grads))
            if self.fsdp:  # the global norm: the ranks' squared norms summed
                norm = all_reduce_sum(norms.square().sum()).sqrt()
            else:
                norm = torch.linalg.vector_norm(norms)
            self.grad_norm = norm
            torch._foreach_mul_(grads, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        if self.zero1:
            with torch.no_grad():
                self.shard.copy_(self.flat.slice([p.detach() for p in self.params]))
            self.shard.grad = self.flat.slice(grads)
            self.adam.step()
            self.shard.grad = None
            with torch.no_grad():
                self.flat.write(self.params, self.flat.gather(self.shard.detach()))
        else:
            self.adam.step()
        self.adam_steps += 1
        return True

    # -- FSDP's shards as the unsharded parameters ---------------------------------

    def _unsharded(self, flats: List[torch.Tensor]) -> List[torch.Tensor]:
        """One tensor a parameter of the unsharded module, in its order,
        shape and strides, from a flat shard a unit (a collective)."""
        parts = {u: u.split(u.flat_shard.gather(f)) for u, f in zip(self.units, flats)}
        return [parts[u][i] for u, i in self.layout]

    def _sharded(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's flat shard a unit of one tensor a parameter of the
        unsharded module."""
        by_unit = {u: [None] * len(u.slots) for u in self.units}
        for (u, i), t in zip(self.layout, tensors):
            by_unit[u][i] = t
        return [u.flat_shard.padded(by_unit[u]) for u in self.units]

    def _full_adam_state(self) -> dict:
        """The unsharded optimizer's ``state_dict``: the moments gathered
        from every rank's shard, each in its parameter's shape and memory
        format (a collective)."""
        n = len(self.layout) if self.fsdp else len(self.params)
        group = dict(self.adam.state_dict()["param_groups"][0], params=list(range(n)))
        if not self.adam_steps:
            return {"state": {}, "param_groups": [group]}
        state = {i: {"step": torch.tensor(float(self.adam_steps))} for i in range(n)}
        for key in ("exp_avg", "exp_avg_sq"):
            if self.fsdp:
                moments = self._unsharded([self.adam.state[p][key] for p in self.params])
            else:
                moments = [torch.empty_like(p) for p in self.params]
                self.flat.write(moments, self.flat.gather(self.adam.state[self.shard][key]))
            for i, m in enumerate(moments):
                state[i][key] = m
        return {"state": state, "param_groups": [group]}

    def _shard_adam_state(self, adam: dict) -> dict:
        """This rank's shard of an unsharded optimizer's ``state_dict``."""
        local = range(len(self.params)) if self.fsdp else [0]
        group = dict(adam["param_groups"][0], params=list(local))
        saved = adam["state"]
        if not saved:
            return {"state": {}, "param_groups": [group]}
        sts = [{"step": saved[0]["step"].clone()} for _ in local]
        for key in ("exp_avg", "exp_avg_sq"):
            moments = [saved[i][key] for i in range(len(saved))]
            shards = self._sharded(moments) if self.fsdp else [self.flat.slice(moments)]
            for st, m in zip(sts, shards):
                st[key] = m
        return {"state": dict(zip(local, sts)), "param_groups": [group]}

    # -- checkpoints -------------------------------------------------------------

    def state_dict(self) -> dict:
        """Adam's state (with ZeRO-1 or FSDP consolidated: what an unsharded
        run holds), the open window's count and, inside a window, the summed
        gradients (on the CPU; in a process group their mean over the
        ranks, which the window's end would take anyway). In a process
        group every rank must call it."""
        grads = [None] * (len(self.layout) if self.fsdp else len(self.params))
        if self.mini_step:
            if self.fsdp:
                grads = self._unsharded([p.grad.detach() for p in self.params])
            else:
                grads = [p.grad.detach().clone() for p in self.params]
                average_gradients(grads)
            grads = [g.cpu() for g in grads]
        sharded = self.zero1 or self.fsdp
        return {
            "adam": self._full_adam_state() if sharded else self.adam.state_dict(),
            "mini_step": self.mini_step,
            "grads": grads,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Load an optimizer's ``state_dict`` (from any world size, with
        ZeRO-1, FSDP or neither): with ZeRO-1 or FSDP this rank's shard of
        it."""
        adam = sd["adam"]
        sharded = self.zero1 or self.fsdp
        self.adam.load_state_dict(self._shard_adam_state(adam) if sharded else adam)
        steps = [float(st["step"]) for st in adam["state"].values()]
        self.adam_steps = int(steps[0]) if steps else 0
        self.mini_step = int(sd["mini_step"])
        grads = sd["grads"]
        if self.fsdp:
            grads = ([None] * len(self.params) if grads[0] is None else self._sharded(grads))
        for p, g in zip(self.params, grads):
            p.grad = None if g is None else g.to(p.device)

    def moments(self, p: nn.Parameter):
        """Adam's (mu, nu) of ``p``, zeros before its first step; not with
        ZeRO-1 or FSDP (``held_moments`` has the shard, ``state_dict``
        all)."""
        if self.zero1 or self.fsdp:
            raise ValueError("a rank holds a shard of the moments: see held_moments")
        st = self.adam.state.get(p)
        if not st:
            return torch.zeros_like(p), torch.zeros_like(p)
        return st["exp_avg"], st["exp_avg_sq"]

    def held_moments(self):
        """(mu, nu) this rank holds over ``shard_range`` of the parameters'
        flat elements (all of them without ZeRO-1; with FSDP its units'
        padded shards end to end), zeros before the first step."""
        if self.zero1 or self.fsdp:
            local = [self.shard] if self.zero1 else self.params
            pairs = []
            for p in local:
                st = self.adam.state.get(p)
                pairs.append((st["exp_avg"], st["exp_avg_sq"]) if st
                             else (torch.zeros_like(p), torch.zeros_like(p)))
            return tuple(torch.cat([m[i] for m in pairs]) for i in (0, 1))
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


# the modules that are FSDP units, each gathered by its own forward; under an
# LPIPS, each slice of its VGG
FSDP_UNIT_TYPES = (ResnetBlock, AttnBlock, Downsample, Upsample, PoseDecoderSpatialVAE,
                   PoseEncoderSpatialVAE, NLayerDiscriminator)


def fsdp_units(root: nn.Module) -> List[nn.Module]:
    """The FSDP units of ``root`` (``parallel.fsdp.shard_module``): every
    outermost module of ``FSDP_UNIT_TYPES`` and every slice of a VGG, or
    ``root`` itself when it is of those types. The rest of ``root``'s
    parameters (the nets' stems, heads and quant convs, LPIPS's heads) form
    ``root``'s unit."""
    if isinstance(root, FSDP_UNIT_TYPES):
        return [root]
    out = []

    def walk(m):
        for child in m.children():
            if isinstance(child, FSDP_UNIT_TYPES) or isinstance(m, VGG16Slices):
                out.append(child)
            else:
                walk(child)

    walk(root)
    return out


def shard_for_fsdp(net: nn.Module, loss: nn.Module) -> None:
    """FSDP over the process group: the net, LPIPS and the discriminator
    each sharded into their ``fsdp_units``; the loss's ``logvar`` (a
    scalar) stays whole. A world of one shards nothing."""
    if world().size == 1:
        return
    for m in (net, loss.perceptual_loss, loss.discriminator):
        fsdp.shard_module(m, fsdp_units(m))


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
    family's net and loss (``PoseLoss`` or ``LPIPSWithDiscriminator``).
    Modules that ``shard_for_fsdp`` sharded take their flat shards (FSDP,
    which shards the moments with them; ``zero1`` is then moot)."""
    kw = dict(lr=learning_rate, grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
              accumulate=accumulate_grad_batches, zero1=zero1)
    return tuple(ClippedAdam(m.parameters(), layout=fsdp.layout(m), **kw)
                 for m in (net, loss.discriminator))


def create_train_state(model, learning_rate: float, grad_clip: Optional[float] = 1.0,
                       seed: int = 0, device="cuda",
                       accumulate_grad_batches: int = 1, zero1: bool = False,
                       fsdp: bool = False) -> TrainState:
    """A fresh state for a ``PoseAutoencoder`` or a plain ``Autoencoder``:
    seeded float32 net and loss on ``device`` and both optimizers. The
    weights are drawn on the CPU from ``seed``, then ``model.ckpt_path``'s reference checkpoint loads over them
    when it is set (the Adam moments start fresh); the forward's draws come
    from a generator on ``device`` seeded with ``seed + 1``. In a process
    group every rank makes the same state from the same seed; ``zero1``
    shards the optimizers' moments over it, ``fsdp`` the parameters of the
    net, LPIPS and the discriminator with their gradients and moments
    (``shard_for_fsdp``; ``ckpt_path``'s weights then load into the shards).
    A world of one keeps the unsharded state either way."""
    g = torch.Generator().manual_seed(seed)
    net = flax_like_net(model, g, device)
    loss = model.init_loss(g, device=device)
    if fsdp:
        shard_for_fsdp(net, loss)
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
