"""OD-VAE composite loss (``losses/contperceptual.py`` of the JAX package;
the reference's ``PoseLoss`` over ldm's ``LPIPSWithDiscriminator``):

- L1 pixel + LPIPS reconstruction, NLL with a learned scalar ``logvar``;
- object-latent KL and per-class bbox-posterior KL against dataset priors,
  vectorised as one gathered table lookup;
- pose L1 + SmoothL1(sin yaw), focal class loss, MSE box size and fill
  factor, all with foreground masking;
- PatchGAN hinge (or vanilla) adversarial loss with ``adopt_weight`` gating.
  The adaptive generator weight needs parameter gradients, so the train step
  computes it and passes it in.

``global_step`` is a Python int here: PyTorch runs eagerly, so the phase
gates are plain conditions rather than the JAX package's traced ``where``.

``LPIPSWithDiscriminator`` is the plain autoencoder's loss (ldm's): L1 +
LPIPS NLL, the posterior's KL and the same PatchGAN term, unmasked.

Data parallelism (``parallel/``): each rank's loss is formed so that the
ranks' mean of it, and of its gradients, is the global batch's. The masked
means divide by the global foreground count (``_masked_mean``); every other
term is a plain mean or a sum over the batch divided by its size, equal over
equal per-rank batches; the discriminator's batch statistics are global.

Kept from the JAX package, on purpose: the foreground mask uses
``background_class_idx = 1`` (the reference's ``BACKGROUND_CLASS_IDX``) while
the prior-KL background skip uses the class *name*'s id (10), and the prior
KL divides by the foreground count of the other mask.
"""

from __future__ import annotations

import logging
import math
import pickle
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.discriminator import NLayerDiscriminator
from ..models.lpips import LPIPS
from ..ops.focal import sigmoid_focal_loss
from ..parallel.mesh import all_reduce_sum, world
from ..utils.distributions import kl_vs_prior_table

POSE_6D_DIM = 4
LHW_DIM = 3
FILL_FACTOR_DIM = 1
BBOX_DIM = POSE_6D_DIM + LHW_DIM + FILL_FACTOR_DIM  # 8

# Canonical nuScenes label order.
LABEL_NAMES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier", "background",
)
BACKGROUND_LABEL_ID = 10


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0):
    """``weight`` once ``global_step >= threshold``, else ``value``."""
    return value if global_step < threshold else weight


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def _smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _masked_mean(x_sum: torch.Tensor, mask_sum: torch.Tensor) -> torch.Tensor:
    """sum(x) / sum(mask), or 0 when the mask is empty, over the global
    batch. In a process group of W ranks the count is all-reduced (no
    gradient flows through it) and the local sum scaled by W: the ranks'
    mean of the result is the global ratio, and so is the mean of its
    gradients, which the optimizers average. A rank whose patches are all
    background still divides by the global count."""
    w = world()
    if w.active:
        mask_sum = all_reduce_sum(mask_sum.detach().clone())
        x_sum = x_sum * w.size
    return torch.where(mask_sum > 0, x_sum / torch.clamp(mask_sum, min=1e-12), 0.0)


def build_prior_tables(
    dataset_stats_path: Optional[str],
    train_on_yaw: bool = True,
    label_names: Tuple[str, ...] = LABEL_NAMES,
) -> Tuple[tuple, tuple]:
    """Per-class bbox prior moments (mean, logvar), each (num_labels, 8):
    keys [t1, t2, t3, yaw|v3, l, h, w, fill_factor]; t1/t2 ~ N(0, 1), yaw ~
    N(0, pi^2), fill ~ N(0.5, 2); t3/l/h/w from the dataset stats pickle."""
    stats = {}
    if dataset_stats_path:
        try:
            with open(dataset_stats_path, "rb") as f:
                stats = pickle.load(f)
        except (FileNotFoundError, OSError):
            logging.warning(
                "dataset stats %s not found; using unit-Gaussian bbox priors", dataset_stats_path
            )
    rot_key = "yaw" if train_on_yaw else "v3"
    keys = ["t1", "t2", "t3", rot_key, "l", "h", "w", "fill_factor"]
    means, logvars = [], []
    for label in label_names:
        label_stats = stats.get(label, {})
        m_row, lv_row = [], []
        for key in keys:
            if key == "yaw":
                m, lv = 0.0, 2.0 * math.log(math.pi)
            elif key in ("t1", "t2"):
                m, lv = 0.0, 0.0
            elif key == "fill_factor":
                m, lv = 0.5, 2.0 * math.log(math.sqrt(2.0))
            elif key in label_stats:
                m, lv = float(label_stats[key][0]), float(label_stats[key][1])
            else:
                m, lv = 0.0, 0.0
            m_row.append(m)
            lv_row.append(lv)
        means.append(tuple(m_row))
        logvars.append(tuple(lv_row))
    return tuple(means), tuple(logvars)


class PoseLoss(nn.Module):
    """Generator and discriminator losses of the pose autoencoder. The
    keyword surface is the reference YAML's ``lossconfig.params``.

    Submodules: ``perceptual_loss`` (LPIPS, frozen), ``discriminator``
    (trained by its own optimizer) and the scalar ``logvar`` parameter,
    which no optimizer updates."""

    def __init__(
        self,
        train_on_yaw: bool = True,
        kl_weight_obj: float = 1.0,
        kl_weight_bbox: float = 1e-6,
        pose_weight: float = 1.0,
        mask_weight: float = 0.0,
        class_weight: float = 1.0,
        bbox_weight: float = 1.0,
        fill_factor_weight: float = 1.0,
        pose_loss_fn: str = "l1",
        mask_loss_fn: str = "l2",
        encoder_pretrain_steps: int = 0,
        pose_conditioned_generation_steps: int = 7000,
        use_mask_loss: bool = False,
        num_classes: int = 1,
        dataset_stats_path: Optional[str] = None,
        background_class_idx: int = 1,
        background_label_id: int = BACKGROUND_LABEL_ID,
        disc_start: int = 0,
        logvar_init: float = 0.0,
        pixelloss_weight: float = 1.0,
        disc_num_layers: int = 3,
        disc_in_channels: int = 3,
        disc_factor: float = 1.0,
        disc_weight: float = 1.0,
        perceptual_weight: float = 1.0,
        disc_ndf: int = 64,
        disc_conditional: bool = False,
        disc_loss: str = "hinge",
        prior_means: Optional[tuple] = None,
        prior_logvars: Optional[tuple] = None,
    ):
        super().__init__()
        if pose_loss_fn not in ("l1", "l2", "mse") or mask_loss_fn not in ("l1", "l2", "mse"):
            raise ValueError(f"loss fns must be l1/l2/mse, got {pose_loss_fn}, {mask_loss_fn}")
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss must be hinge or vanilla, got {disc_loss}")
        self.train_on_yaw = train_on_yaw
        self.kl_weight_obj, self.kl_weight_bbox = kl_weight_obj, kl_weight_bbox
        self.pose_weight, self.mask_weight = pose_weight, mask_weight
        self.class_weight, self.bbox_weight = class_weight, bbox_weight
        self.fill_factor_weight = fill_factor_weight
        self.pose_loss_fn, self.mask_loss_fn = pose_loss_fn, mask_loss_fn
        self.encoder_pretrain_steps = encoder_pretrain_steps
        self.pose_conditioned_generation_steps = pose_conditioned_generation_steps
        self.use_mask_loss = use_mask_loss
        self.num_classes = num_classes
        self.background_class_idx = background_class_idx
        self.background_label_id = background_label_id
        self.disc_start, self.disc_factor, self.disc_weight = disc_start, disc_factor, disc_weight
        self.perceptual_weight = perceptual_weight
        self.disc_loss = disc_loss
        if prior_means is None:
            prior_means, prior_logvars = build_prior_tables(dataset_stats_path, train_on_yaw)
        self.register_buffer("prior_mean", torch.tensor(prior_means, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("prior_logvar", torch.tensor(prior_logvars, dtype=torch.float32),
                             persistent=False)
        self.perceptual_loss = LPIPS()
        self.discriminator = NLayerDiscriminator(disc_in_channels, disc_ndf, disc_num_layers)
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)), requires_grad=False)

    # -- pieces ---------------------------------------------------------------

    @staticmethod
    def _elemwise(kind: str, a, b):
        return (a - b).abs() if kind == "l1" else (a - b).square()

    def _mask_bg(self, class_gt: torch.Tensor) -> torch.Tensor:
        """Foreground mask: 1 where class != background_class_idx."""
        return (class_gt != self.background_class_idx).float()

    def _use_pixel(self, global_step: int) -> bool:
        return global_step >= self.encoder_pretrain_steps + self.pose_conditioned_generation_steps

    def compute_pose_loss(self, pred, gt, mask_bg):
        """(pose_loss, weighted, t1, t2, t3, v3 per sample)."""
        t1 = self._elemwise(self.pose_loss_fn, pred[:, 0], gt[:, 0])
        t2 = self._elemwise(self.pose_loss_fn, pred[:, 1], gt[:, 1])
        t3 = self._elemwise(self.pose_loss_fn, pred[:, 2], gt[:, 2])
        if self.train_on_yaw:
            v3 = _smooth_l1(torch.sin(pred[:, 3]) - torch.sin(gt[:, 3]))
        else:
            v3 = self._elemwise(self.pose_loss_fn, pred[:, 3], gt[:, 3])
        pose_loss = _masked_mean(((t1 + t2 + t3 + v3) * mask_bg).sum(), mask_bg.sum())
        return pose_loss, self.pose_weight * pose_loss, t1, t2, t3, v3

    def _get_rec_loss(self, inputs, recons, use_pixel: bool):
        """|x - x_hat| (phase-gated) + the perceptual map, NHWC."""
        rec = (inputs - recons).abs() if use_pixel else torch.zeros_like(inputs)
        if self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * self.perceptual_loss(inputs, recons)
        return rec

    def _get_nll_loss(self, rec_loss, mask_bg, weights=None):
        """nll = rec / exp(logvar) + logvar; masked sum over pixels divided
        by the count of foreground samples."""
        nll = rec_loss / (torch.exp(self.logvar) + 1e-8) + self.logvar
        weighted = nll if weights is None else weights * nll
        m = mask_bg.reshape(-1, 1, 1, 1)
        n = mask_bg.sum()
        return _masked_mean((nll * m).sum(), n), _masked_mean((weighted * m).sum(), n)

    def _get_kl_loss(self, posterior, mask_bg):
        return _masked_mean((posterior.kl() * mask_bg).sum(), mask_bg.sum())

    def compute_class_loss(self, class_gt, class_logits):
        loss = sigmoid_focal_loss(class_logits, class_gt)
        return loss, self.class_weight * loss

    def compute_bbox_loss(self, bbox_gt, bbox_pred, mask_bg):
        loss = _masked_mean(((bbox_gt - bbox_pred).square() * mask_bg[:, None]).sum(), mask_bg.sum())
        return loss, self.bbox_weight * loss

    def compute_fill_factor_loss(self, fill_gt, fill_pred, mask_bg):
        loss = _masked_mean(((fill_gt - fill_pred).square() * mask_bg).sum(), mask_bg.sum())
        return loss, self.fill_factor_weight * loss

    def get_mask_loss(self, mask_gt, dec_obj, mask_2d_bbox):
        """The alpha-mask term; off in every shipped config. When on it needs
        a mask ground truth and a 4-channel reconstruction, or it raises."""
        if not self.use_mask_loss:
            z = torch.zeros((), device=dec_obj.device)
            return z, z
        if mask_gt is None or dec_obj.shape[-1] != 4:
            raise ValueError(
                "use_mask_loss=True requires a mask ground truth in the batch and a "
                "4-channel (RGBA) reconstruction (ddconfig out_ch: 4)"
            )
        loss = self._elemwise(
            self.mask_loss_fn, mask_gt * mask_2d_bbox, dec_obj[..., 3:] * mask_2d_bbox
        ).mean()
        return loss, self.mask_weight * loss

    def compute_pose_kl_loss(self, bbox_posterior, mask_bg, class_orig_id):
        """Per-class prior KL: gather the priors by canonical class id, skip
        'background' rows by name id, divide by sum(mask_bg)."""
        idx = class_orig_id.long()
        kl = kl_vs_prior_table(
            bbox_posterior.mean, bbox_posterior.logvar, self.prior_mean[idx], self.prior_logvar[idx]
        )
        not_bg = (class_orig_id != self.background_label_id).to(kl.dtype)
        return _masked_mean((kl * not_bg).sum(), mask_bg.sum())

    # -- the reconstruction-dependent scalars -------------------------------------

    def rec_gan_terms(self, rgb_gt, dec_obj, class_gt, mask_2d_bbox, global_step, weights=None):
        """``(nll, weighted_nll, g_loss, rec_mean)`` as functions of ``dec_obj``."""
        nll, w_nll, rec_mean = self.nll_terms(
            rgb_gt, dec_obj, class_gt, mask_2d_bbox, global_step, weights
        )
        return nll, w_nll, self.g_term(dec_obj, class_gt, mask_2d_bbox), rec_mean

    def nll_terms(self, rgb_gt, dec_obj, class_gt, mask_2d_bbox, global_step, weights=None):
        """``(nll, weighted_nll, rec_mean)``: pixel + LPIPS only, no
        discriminator (weighted_nll == nll without per-sample ``weights``)."""
        mask_bg = self._mask_bg(class_gt)
        rec = self._get_rec_loss(
            rgb_gt * mask_2d_bbox, dec_obj * mask_2d_bbox, self._use_pixel(global_step)
        )
        nll, w_nll = self._get_nll_loss(rec, mask_bg, weights)
        return nll, w_nll, rec.mean()

    def g_term(self, dec_obj, class_gt, mask_2d_bbox):
        """The generator's GAN scalar (one discriminator forward)."""
        mask_bg = self._mask_bg(class_gt)
        return -(self.discriminator(dec_obj * mask_2d_bbox) * mask_bg.reshape(-1, 1, 1, 1)).mean()

    # -- entry points -------------------------------------------------------------

    def generator_loss(
        self, rgb_gt, mask_gt, pose_gt, dec_obj, dec_pose, class_gt, class_orig_id, bbox_gt,
        fill_factor_gt, posterior_obj, bbox_posterior, global_step, mask_2d_bbox,
        d_weight=0.0, split="train", weights=None, rec_terms=None,
    ):
        """The optimizer-0 loss and its log. ``rec_terms``: precomputed
        ``(nll, weighted_nll, g_loss, rec_mean)`` (the train step passes them
        detached, having taken their gradients itself)."""
        mask_bg = self._mask_bg(class_gt)
        d = POSE_6D_DIM
        pose_rec = dec_pose[:, :d]
        lhw_rec = dec_pose[:, d : d + LHW_DIM]
        fill_rec = dec_pose[:, d + LHW_DIM : BBOX_DIM]
        class_logits = dec_pose[:, BBOX_DIM:]

        class_loss, w_class = self.compute_class_loss(class_gt, class_logits)
        bbox_loss, w_bbox = self.compute_bbox_loss(bbox_gt, lhw_rec, mask_bg)
        pose_loss, w_pose, t1, t2, t3, v3 = self.compute_pose_loss(pose_gt, pose_rec, mask_bg)
        fill_loss, w_fill = self.compute_fill_factor_loss(fill_factor_gt, fill_rec[:, 0], mask_bg)
        mask_loss, w_mask = self.get_mask_loss(mask_gt, dec_obj, mask_2d_bbox)
        if rec_terms is None:
            rec_terms = self.rec_gan_terms(
                rgb_gt, dec_obj, class_gt, mask_2d_bbox, global_step, weights
            )
        nll_loss, w_nll, g_loss, rec_mean = rec_terms
        kl_obj = self._get_kl_loss(posterior_obj, mask_bg)
        kl_bbox = self.compute_pose_kl_loss(bbox_posterior, mask_bg, class_orig_id)
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        d_weight = torch.as_tensor(d_weight, dtype=torch.float32, device=dec_pose.device)

        if self.encoder_pretrain_steps == -1 or global_step <= self.encoder_pretrain_steps:
            loss = w_pose + w_class + w_bbox + w_fill + self.kl_weight_bbox * kl_bbox
        else:
            loss = (
                w_pose + w_mask + w_nll + w_class + w_bbox + w_fill
                + self.kl_weight_obj * kl_obj + self.kl_weight_bbox * kl_bbox
                + d_weight * disc_factor * g_loss
            )
        log = {
            f"{split}/total_loss": loss,
            f"{split}/logvar": self.logvar,
            f"{split}/kl_loss_obj": kl_obj,
            f"{split}/nll_loss": nll_loss,
            f"{split}/weighted_nll_loss": w_nll,
            f"{split}/rec_loss": rec_mean,
            f"{split}/d_weight": d_weight,
            f"{split}/disc_factor": torch.tensor(float(disc_factor), device=dec_pose.device),
            f"{split}/g_loss": g_loss,
            f"{split}/pose_loss": pose_loss,
            f"{split}/weighted_pose_loss": w_pose,
            f"{split}/mask_loss": mask_loss,
            f"{split}/weighted_mask_loss": w_mask,
            f"{split}/class_loss": class_loss,
            f"{split}/weighted_class_loss": w_class,
            f"{split}/bbox_loss": bbox_loss,
            f"{split}/weighted_bbox_loss": w_bbox,
            f"{split}/t1_loss": t1.mean(),
            f"{split}/t2_loss": t2.mean(),
            f"{split}/t3_loss": t3.mean(),
            f"{split}/v3_loss": v3.mean(),
            f"{split}/kl_loss_bbox": kl_bbox,
            f"{split}/weighted_kl_loss_bbox": self.kl_weight_bbox * kl_bbox,
            f"{split}/weighted_kl_loss_obj": self.kl_weight_obj * kl_obj,
            f"{split}/fill_factor_loss": fill_loss,
            f"{split}/weighted_fill_factor_loss": w_fill,
        }
        return loss, log

    def discriminator_loss(self, rgb_gt, dec_obj, class_gt, global_step, mask_2d_bbox,
                           split="train"):
        """The optimizer-1 loss on a reconstruction the caller detached."""
        mask_bg = self._mask_bg(class_gt).reshape(-1, 1, 1, 1)
        logits_real = self.discriminator(rgb_gt * mask_2d_bbox) * mask_bg
        logits_fake = self.discriminator(dec_obj * mask_2d_bbox) * mask_bg
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        d_loss = disc_factor * loss_fn(logits_real, logits_fake)
        log = {
            f"{split}/disc_loss": d_loss,
            f"{split}/logits_real": logits_real.mean(),
            f"{split}/logits_fake": logits_fake.mean(),
        }
        return d_loss, log


class LPIPSWithDiscriminator(nn.Module):
    """The plain autoencoder's loss (``LPIPSWithDiscriminator`` of the JAX
    package; ldm's, which the reference subclasses unchanged): L1 + LPIPS
    NLL with the scalar ``logvar``, the posterior's KL against N(0, I) and
    the PatchGAN term. Submodules as ``PoseLoss``'s: ``perceptual_loss``
    (frozen), ``discriminator`` (trained by its own optimizer) and
    ``logvar``, which no optimizer updates. ``pixelloss_weight`` and
    ``disc_conditional`` are accepted and unused, as in ldm."""

    def __init__(
        self,
        disc_start: int = 0,
        logvar_init: float = 0.0,
        kl_weight: float = 1.0,
        pixelloss_weight: float = 1.0,
        disc_num_layers: int = 3,
        disc_in_channels: int = 3,
        disc_factor: float = 1.0,
        disc_weight: float = 1.0,
        perceptual_weight: float = 1.0,
        disc_conditional: bool = False,
        disc_loss: str = "hinge",
    ):
        super().__init__()
        if disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss must be hinge or vanilla, got {disc_loss}")
        self.disc_start, self.disc_factor, self.disc_weight = disc_start, disc_factor, disc_weight
        self.kl_weight = kl_weight
        self.perceptual_weight = perceptual_weight
        self.disc_loss = disc_loss
        self.perceptual_loss = LPIPS()
        self.discriminator = NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers)
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)), requires_grad=False)

    def nll_terms(self, inputs: torch.Tensor, recons: torch.Tensor):
        """``(nll, rec_mean)``: pixel + LPIPS only, no discriminator."""
        rec = (inputs - recons).abs()
        if self.perceptual_weight > 0:
            rec = rec + self.perceptual_weight * self.perceptual_loss(inputs, recons)
        nll = (rec / torch.exp(self.logvar) + self.logvar).sum() / inputs.shape[0]
        return nll, rec.mean()

    def g_term(self, recons: torch.Tensor) -> torch.Tensor:
        """The generator's GAN scalar (one discriminator forward)."""
        return -self.discriminator(recons).mean()

    def forward(self, inputs, recons, posterior, optimizer_idx: int, global_step: int,
                d_weight=0.0, split: str = "train", rec_terms=None):
        """Optimizer 0: the generator loss and its log; ``rec_terms``, when
        given, are the precomputed ``(nll, g_loss, rec_mean)`` (the train
        step passes them detached, having taken their gradients itself).
        Optimizer 1: the discriminator loss on inputs and reconstructions
        it detaches."""
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        if optimizer_idx == 0:
            if rec_terms is None:
                nll, rec_mean = self.nll_terms(inputs, recons)
                g = self.g_term(recons)
            else:
                nll, g, rec_mean = rec_terms
            kl = posterior.kl().sum() / inputs.shape[0]
            d_weight = torch.as_tensor(d_weight, dtype=torch.float32, device=inputs.device)
            loss = nll + self.kl_weight * kl + d_weight * disc_factor * g
            log = {
                f"{split}/total_loss": loss,
                f"{split}/nll_loss": nll,
                f"{split}/rec_loss": rec_mean,
                f"{split}/kl_loss": kl,
                f"{split}/g_loss": g,
                f"{split}/logvar": self.logvar,
                f"{split}/d_weight": d_weight,
                f"{split}/disc_factor": torch.tensor(float(disc_factor), device=inputs.device),
            }
            return loss, log
        logits_real = self.discriminator(inputs.detach())
        logits_fake = self.discriminator(recons.detach())
        loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        d_loss = disc_factor * loss_fn(logits_real, logits_fake)
        log = {
            f"{split}/disc_loss": d_loss,
            f"{split}/logits_real": logits_real.mean(),
            f"{split}/logits_fake": logits_fake.mean(),
        }
        return d_loss, log
