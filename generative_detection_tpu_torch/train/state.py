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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn

from ..models.blocks import flax_like_init_


class ClippedAdam:
    """optax ``chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2, eps))``
    over a fixed list of parameters."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 grad_clip: Optional[float] = 1.0, b1: float = 0.5, b2: float = 0.9,
                 eps: float = 1e-8, accumulate: int = 1):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.accumulate = max(int(accumulate), 1)
        self.mini_step = 0  # micro-batches summed into the open window
        fused = all(p.is_cuda for p in self.params)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(b1, b2), eps=eps,
                                     foreach=not fused, fused=fused or None)

    def zero_grad(self) -> None:
        """Clear the gradients at a window's start (inside a window the
        backward passes sum into them)."""
        if self.mini_step == 0:
            for p in self.params:
                p.grad = None

    def step(self) -> bool:
        """Count a micro-batch; at the window's end average the summed
        gradients, clip them by the global norm and take the Adam step.
        True when it stepped."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.mini_step += 1
        if self.mini_step < self.accumulate:
            return False
        self.mini_step = 0
        grads = [p.grad for p in self.params]
        if self.accumulate > 1:
            torch._foreach_mul_(grads, 1.0 / self.accumulate)
        if self.grad_clip is not None and self.grad_clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        self.adam.step()
        return True

    def state_dict(self) -> dict:
        """Adam's state, the open window's count and, inside a window, the
        summed gradients (on the CPU)."""
        return {
            "adam": self.adam.state_dict(),
            "mini_step": self.mini_step,
            "grads": [p.grad.detach().cpu() if self.mini_step and p.grad is not None else None
                      for p in self.params],
        }

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.mini_step = int(sd["mini_step"])
        for p, g in zip(self.params, sd["grads"]):
            p.grad = None if g is None else g.to(p.device)

    def moments(self, p: nn.Parameter):
        """Adam's (mu, nu) of ``p``, zeros before its first step."""
        st = self.adam.state.get(p)
        if not st:
            return torch.zeros_like(p), torch.zeros_like(p)
        return st["exp_avg"], st["exp_avg_sq"]


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
):
    """(opt_ae over every net parameter, opt_disc over ``loss.discriminator``),
    each accumulating over ``accumulate_grad_batches`` micro-batches. Either
    family's net and loss (``PoseLoss`` or ``LPIPSWithDiscriminator``)."""
    kw = dict(lr=learning_rate, grad_clip=grad_clip, b1=b1, b2=b2, eps=eps,
              accumulate=accumulate_grad_batches)
    return (ClippedAdam(net.parameters(), **kw),
            ClippedAdam(loss.discriminator.parameters(), **kw))


def create_train_state(model, learning_rate: float, grad_clip: Optional[float] = 1.0,
                       seed: int = 0, device="cuda",
                       accumulate_grad_batches: int = 1) -> TrainState:
    """A fresh state for a ``PoseAutoencoder`` or a plain ``Autoencoder``:
    seeded float32 net and loss on ``device`` and both optimizers. The
    weights are drawn on the CPU from ``seed``, then ``model.ckpt_path``'s reference checkpoint loads over them
    when it is set (the Adam moments start fresh); the forward's draws come
    from a generator on ``device`` seeded with ``seed + 1``."""
    g = torch.Generator().manual_seed(seed)
    net = flax_like_net(model, g, device)
    loss = model.init_loss(g, device=device)
    model.maybe_init_from_ckpt(net, loss)
    opt_ae, opt_disc = make_optimizers(
        net, loss, learning_rate, grad_clip, accumulate_grad_batches
    )
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(0, net, loss, opt_ae, opt_disc, gen)


def flax_like_net(model, generator: torch.Generator, device) -> nn.Module:
    """``model``'s network, flax-like initialised, kept in float32 (the
    master weights) on ``device``."""
    net = flax_like_init_(model.build_net(), generator)
    return net.to(device=device, memory_format=torch.channels_last)
