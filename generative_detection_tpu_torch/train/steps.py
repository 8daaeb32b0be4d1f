"""The fused two-optimizer train step and the eval step (``train/steps.py`` of
the JAX package).

One call of ``train_step(state, batch)``:

1. generator pass: forward, the adaptive discriminator weight, the composite
   loss, gradients over the net's parameters, clipped Adam update;
2. discriminator pass: hinge loss on the detached reconstruction, gradients
   over the discriminator only, clipped Adam update.

Adaptive d_weight (ldm ``calculate_adaptive_weight``): ||d nll / dW|| /
(||d g_loss / dW|| + 1e-4), clipped to [0, 1e4], times ``disc_weight``,
detached, with W the decoder's ``conv_out.weight``; it is live once
``global_step > encoder_pretrain_steps`` and ``disc_factor > 0``. The
gradients of nll and g_loss with respect to the reconstruction y come from
two ``torch.autograd.grad`` calls on a detached leaf copy of y (one LPIPS
backward, one discriminator backward). Both W-gradients are formed from them
in fp32 against ``pre_out``, and the same two y-gradients carry the
reconstruction terms into the one backward of the total:
``backward([total, y], [1, gy_nll + d_weight * disc_factor * gy_g])``, so
LPIPS and the discriminator are differentiated once each (the JAX package
gets the same with a surrogate term).

Data parallelism: in a process group of W ranks, each holding B / W of the
global batch B, a step computes the step of one process at batch B, as the
JAX package's ``jit`` over a sharded batch does. The loss is formed so that
the ranks' mean of it is the global loss (``losses/contperceptual.py``); the
draws are the rank's slice of the global batch's (``parallel.mesh.draw``);
the two ``conv_out`` weight gradients of d_weight are averaged over the
ranks before their norms; the optimizers average the gradients before the
clip (``train/state.py``); the metrics are the ranks' means. Under FSDP
(``parallel/fsdp.py``) the same step runs on sharded modules: each unit's
forward gathers its weights, the backward gathers them again and
reduce-scatters their gradients, and outside a forward a weight attribute is
a meta tensor of the weight's shape, which is all d_weight takes of
``conv_out.weight``.

Mixed precision: the parameters stay float32 (the master weights, and Adam's
state). With ``compute_dtype`` bfloat16 the step runs the net, LPIPS and the
discriminator under ``torch.autocast``, which casts each convolution's and
dense layer's input and weight to bf16 at use and returns bf16: flax's
``dtype`` semantics (params fp32, compute in ``dtype``). GroupNorm takes the
bf16 activations with its fp32 affine, as flax's does. The d_weight
gradients run with autocast off, in fp32. With ``compute_dtype`` float32 the
whole step (forward and backward) runs under ``ops.precision.ieee_fp32()``:
IEEE fp32 convolutions and matmuls, no TF32.

The plain family (``make_plain_train_step``, ldm's ``AutoencoderKL`` with
``LPIPSWithDiscriminator``) takes the same two passes: NLL + LPIPS, KL and
the GAN term over ``{'image'}`` batches, its d_weight with no step gate.

Step counting: ``step_counting='optimizer'`` (PyTorch Lightning 1.9's, which
the reference pins) lets the curriculum see 2 * batch (generator) and
2 * batch + 1 (discriminator); ``'batch'`` sees the batch index. With
``accumulate_grad_batches`` k the batch index is the optimizer step,
``state.step // k``: the curriculum clock advances once a window, as
Lightning's ``global_step`` does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..losses.contperceptual import adopt_weight
from ..ops.precision import compute_precision
from ..parallel.mesh import all_reduce_mean, average_gradients, world
from .state import TrainState


def _global_steps(step: int, step_counting: str) -> Tuple[int, int]:
    if step_counting == "optimizer":
        return 2 * step, 2 * step + 1
    return step, step


def _conv_out_weight_grads(shape: torch.Size, pre_out: torch.Tensor, cotangents):
    """Pull reconstruction cotangents (NHWC) back through the decoder's final
    3x3 conv to its weight (of ``shape``) only, in fp32."""
    a = pre_out.float().permute(0, 3, 1, 2)
    with torch.autocast(a.device.type, enabled=False):
        return [
            torch.nn.grad.conv2d_weight(a, shape, c.float().permute(0, 3, 1, 2), padding=1)
            for c in cotangents
        ]


def _adaptive_d_weight(g_nll_w, g_g_w, disc_weight: float) -> torch.Tensor:
    """In a process group both weight gradients are first averaged over the
    ranks, which makes them the global batch's: every rank then takes the
    same d_weight."""
    if world().active:
        # each keeps its memory format, so its norm sums in one process's order
        g_nll_w, g_g_w = g_nll_w.clone(), g_g_w.clone()
        average_gradients([g_nll_w, g_g_w])
    num = torch.linalg.vector_norm(g_nll_w)
    den = torch.linalg.vector_norm(g_g_w) + 1e-4
    return torch.clamp(num / den, 0.0, 1e4) * disc_weight


def _global_means(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics' means over the ranks of a process group (float32, one
    collective), the logged values of the global batch; as they are outside
    one."""
    return all_reduce_mean(metrics) if world().active else metrics


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def make_train_step(
    model,
    phase: str = "auto",
    disc_forward: str = "shared",
    step_counting: str = "optimizer",
    lean_pretrain: bool = True,
    accumulate_grad_batches: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for a ``PoseAutoencoder``:
    ``train_step(state, batch, draws=None) -> (state, metrics)``, which
    updates ``state`` in place and advances ``state.step``.

    disc_forward: 'shared' reuses the generator pass's reconstruction for the
    discriminator update; 'separate' re-runs the forward with the updated
    net and fresh draws, as Lightning's sequential optimizer loop does.
    lean_pretrain: in phase 'pretrain', skip LPIPS and the discriminator (the
    total excludes every reconstruction and GAN term there and the
    discriminator's gradients are zero), so only log-only values differ.
    draws: optional tensors for the forward's random draws (see
    ``PoseAutoencoderNet.forward``); the separate discriminator forward takes
    ``draws['disc']`` when given.
    accumulate_grad_batches: the window of the state's optimizers; the
    curriculum sees the optimizer step ``state.step // k``.
    compute_dtype: defaults to the model's ``compute_dtype``."""
    accum = max(int(accumulate_grad_batches), 1)
    if disc_forward not in ("shared", "separate"):
        raise ValueError(f"disc_forward must be 'shared' or 'separate', got {disc_forward!r}")
    dtype = compute_dtype or model.compute_dtype
    pretrain = model.encoder_pretrain_steps

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   draws: Optional[Mapping] = None):
        with compute_precision(dtype):
            return _train_step(state, batch, draws)

    def _train_step(state, batch, draws):
        net, loss = state.net, state.loss
        lean = lean_pretrain and phase == "pretrain" and loss.disc_start >= pretrain
        step_g, step_d = _global_steps(state.step // accum, step_counting)
        rgb, class_gt, mask = batch["rgb_gt"], batch["class_gt"], batch["mask_2d_bbox"]
        autocast = _autocast(rgb.device, dtype)
        draws = dict(draws or {})

        # ---- generator (optimizer 0) ----------------------------------------
        state.opt_ae.zero_grad()
        with autocast:
            outs = net(rgb, step_g, phase=phase, generator=state.generator, draws=draws)
        y = outs["dec_obj"]
        gy = None
        if lean:
            zero = torch.zeros((), device=rgb.device)
            terms, d_weight = (zero, zero, zero, zero), zero
        else:
            y_leaf = y.detach().requires_grad_(True)
            with autocast:
                nll, w_nll, rec_mean = loss.nll_terms(rgb, y_leaf, class_gt, mask, step_g)
            (gy_nll,) = torch.autograd.grad(nll, y_leaf)
            with autocast:
                g_loss = loss.g_term(y_leaf, class_gt, mask)
            (gy_g,) = torch.autograd.grad(g_loss, y_leaf)
            if loss.disc_factor > 0.0 and step_g > pretrain:
                g_nll_w, g_g_w = _conv_out_weight_grads(
                    net.decoder.conv_out.weight.shape, outs["pre_out"], (gy_nll, gy_g)
                )
                d_weight = _adaptive_d_weight(g_nll_w, g_g_w, loss.disc_weight).detach()
            else:
                d_weight = torch.zeros((), device=rgb.device)
            terms = (nll.detach(), w_nll.detach(), g_loss.detach(), rec_mean.detach())
            # d total / dy, where generator_loss takes its 'full' branch
            if y.requires_grad and not (pretrain == -1 or step_g <= pretrain):
                disc_factor = loss.disc_factor if step_g >= loss.disc_start else 0.0
                gy = gy_nll + (d_weight * disc_factor) * gy_g
        total, log_ae = loss.generator_loss(
            rgb, None, batch["pose_gt"], y.detach(), outs["dec_pose"], class_gt,
            batch["class_orig_id"], batch["bbox_gt"], batch["fill_factor_gt"],
            outs["posterior_obj"], outs["bbox_posterior"], step_g, mask,
            d_weight=d_weight, split="train", rec_terms=terms,
        )
        if gy is None:
            total.backward()
        else:
            torch.autograd.backward([total, y], [torch.ones_like(total), gy])
        state.opt_ae.step()

        # ---- discriminator (optimizer 1) -------------------------------------
        if lean:
            zero = torch.zeros((), device=rgb.device)
            log_disc = {"train/disc_loss": zero, "train/logits_real": zero,
                        "train/logits_fake": zero}
            discloss = zero
        else:
            if disc_forward == "separate":
                with torch.no_grad(), autocast:
                    y_d = net(rgb, step_d, phase=phase, generator=state.generator,
                              draws=draws.get("disc"))["dec_obj"]
            else:
                y_d = y.detach()
            state.opt_disc.zero_grad()
            with autocast:
                discloss, log_disc = loss.discriminator_loss(
                    rgb, y_d, class_gt, step_d, mask, split="train"
                )
            discloss.backward()
            state.opt_disc.step()

        metrics = dict(log_ae)
        metrics.update(log_disc)
        metrics["aeloss"] = total.detach()
        metrics["discloss"] = discloss.detach()
        metrics["dropout_prob"] = torch.tensor(outs["dropout_prob"])
        state.step += 1
        return state, _global_means({k: torch.as_tensor(v).detach() for k, v in metrics.items()})

    return train_step


def make_eval_step(
    model,
    phase: str = "auto",
    step_counting: str = "optimizer",
    split: str = "val",
    accumulate_grad_batches: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Validation: ``eval_step(state, batch, generator=None, draws=None) ->
    metrics``, the forward and both losses for logging only, with d_weight 0
    (the reference's eval-mode fallback). The curriculum sees
    ``state.step // accumulate_grad_batches``."""
    accum = max(int(accumulate_grad_batches), 1)
    dtype = compute_dtype or model.compute_dtype

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Mapping] = None):
        net, loss = state.net, state.loss
        step_g, step_d = _global_steps(state.step // accum, step_counting)
        rgb = batch["rgb_gt"]
        with compute_precision(dtype), _autocast(rgb.device, dtype):
            outs = net(rgb, step_g, phase=phase, generator=generator, draws=draws)
            _, log_ae = loss.generator_loss(
                rgb, None, batch["pose_gt"], outs["dec_obj"], outs["dec_pose"],
                batch["class_gt"], batch["class_orig_id"], batch["bbox_gt"],
                batch["fill_factor_gt"], outs["posterior_obj"], outs["bbox_posterior"],
                step_g, batch["mask_2d_bbox"], d_weight=0.0, split=split,
            )
            _, log_disc = loss.discriminator_loss(
                rgb, outs["dec_obj"], batch["class_gt"], step_d, batch["mask_2d_bbox"],
                split=split,
            )
        metrics = dict(log_ae)
        metrics.update(log_disc)
        return _global_means(metrics)

    return eval_step



def make_plain_train_step(
    model,
    step_counting: str = "optimizer",
    accumulate_grad_batches: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step for the plain ``Autoencoder`` (``make_plain_train_step``
    of the JAX package): ``train_step(state, batch, draws=None) -> (state,
    metrics)`` on ``{'image': (B, H, W, C)}`` batches, updating ``state`` in
    place. As the pose step: the y-gradients of nll (pixel + LPIPS) and of
    the GAN scalar on a detached leaf, the adaptive d_weight from them, one
    backward of the total, then the discriminator on the detached
    reconstruction. ldm's d_weight has no step gate, only ``disc_factor >
    0``: it is live (and logged) from step 0, while ``adopt_weight`` keeps the
    GAN term out of the total until ``disc_start``. ``draws``: the
    posterior's normal draw as ``{'posterior': tensor}``."""
    accum = max(int(accumulate_grad_batches), 1)
    dtype = compute_dtype or model.compute_dtype

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   draws: Optional[Mapping] = None):
        with compute_precision(dtype):
            return _train_step(state, batch, draws)

    def _train_step(state, batch, draws):
        net, loss = state.net, state.loss
        step_g, step_d = _global_steps(state.step // accum, step_counting)
        x = batch["image"]
        autocast = _autocast(x.device, dtype)

        # ---- generator (optimizer 0) ----------------------------------------
        state.opt_ae.zero_grad()
        with autocast:
            outs = net(x, generator=state.generator, draws=draws)
        y = outs["dec_obj"]
        y_leaf = y.detach().requires_grad_(True)
        with autocast:
            nll, rec_mean = loss.nll_terms(x, y_leaf)
        (gy_nll,) = torch.autograd.grad(nll, y_leaf)
        with autocast:
            g_loss = loss.g_term(y_leaf)
        (gy_g,) = torch.autograd.grad(g_loss, y_leaf)
        if loss.disc_factor > 0.0:
            g_nll_w, g_g_w = _conv_out_weight_grads(
                net.decoder.conv_out.weight.shape, outs["pre_out"], (gy_nll, gy_g)
            )
            d_weight = _adaptive_d_weight(g_nll_w, g_g_w, loss.disc_weight).detach()
        else:
            d_weight = torch.zeros((), device=x.device)
        total, log_ae = loss(
            x, y.detach(), outs["posterior_obj"], 0, step_g, d_weight=d_weight,
            rec_terms=(nll.detach(), g_loss.detach(), rec_mean.detach()),
        )
        disc_factor = adopt_weight(loss.disc_factor, step_g, loss.disc_start)
        gy = gy_nll + (d_weight * disc_factor) * gy_g
        torch.autograd.backward([total, y], [torch.ones_like(total), gy])
        state.opt_ae.step()

        # ---- discriminator (optimizer 1) -------------------------------------
        state.opt_disc.zero_grad()
        with autocast:
            discloss, log_disc = loss(x, y.detach(), outs["posterior_obj"], 1, step_d)
        discloss.backward()
        state.opt_disc.step()

        metrics = dict(log_ae)
        metrics.update(log_disc)
        metrics["aeloss"] = total.detach()
        metrics["discloss"] = discloss.detach()
        state.step += 1
        return state, _global_means({k: torch.as_tensor(v).detach() for k, v in metrics.items()})

    return train_step


def make_plain_eval_step(
    model,
    step_counting: str = "optimizer",
    split: str = "val",
    accumulate_grad_batches: int = 1,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Validation for the plain ``Autoencoder``: ``eval_step(state, batch,
    generator=None, draws=None) -> metrics``, the forward (a posterior
    sample) and both loss passes for logging only, d_weight 0, the split's
    keys."""
    accum = max(int(accumulate_grad_batches), 1)
    dtype = compute_dtype or model.compute_dtype

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Mapping] = None):
        net, loss = state.net, state.loss
        step_g, step_d = _global_steps(state.step // accum, step_counting)
        x = batch["image"]
        with compute_precision(dtype), _autocast(x.device, dtype):
            outs = net(x, generator=generator, draws=draws)
            post = outs["posterior_obj"]
            _, log_ae = loss(x, outs["dec_obj"], post, 0, step_g, d_weight=0.0, split=split)
            _, log_disc = loss(x, outs["dec_obj"], post, 1, step_d, split=split)
        metrics = dict(log_ae)
        metrics.update(log_disc)
        return _global_means(metrics)

    return eval_step
