"""Pose-aware KL autoencoder (``models/autoencoder.py`` of the JAX package).

- ``PoseAutoencoderNet``: the network. Its public methods keep the JAX
  layout (NHWC tensors in and out); inside, the conv stack runs in
  ``torch.channels_last``. Flatten/reshape between the pose MLPs and the
  feature maps goes through NCHW order (torch ``.view``), as in the JAX
  package, so checkpoints carry over unchanged. ``forward`` is the training
  pass: posterior sample, the staged z-dropout schedule, z-noise, pose
  decode, and the phase-gated reconstruction. Its four random draws come
  from a ``torch.Generator`` or are handed in as tensors.
  ``perturbed_pose_forward`` decodes with a given pose (the image logger's
  pose-controllability probe).
- ``PoseAutoencoder``: the config-facing wrapper with the keyword surface of
  the reference YAML ``model.params``. It holds the configuration, builds
  nets and the ``PoseLoss``, and prepares batches.
- ``AutoencoderKLNet`` and ``Autoencoder``: the plain KL autoencoder (ldm's
  ``AutoencoderKL``, the reference's ``Autoencoder``) and its wrapper, with
  ``LPIPSWithDiscriminator`` as its loss. ``step_family`` tells the Trainer
  which train step to build: "pose" or "plain".
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import instantiate_from_config
from ..ops.resize import batched_crop_resize, bbox_mask
from ..utils.distributions import DiagonalGaussianDistribution
from .blocks import Decoder, Encoder, _nchw, _nhwc, flax_like_init_
from .discriminator import init_discriminator_
from .lpips import load_lpips_weights
from .pose_modules import PoseDecoderSpatialVAE, PoseEncoderSpatialVAE

POSE_6D_DIM = 4
FILL_FACTOR_DIM = 1
LHW_DIM = 3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def cast_compute_dtype(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast conv and dense parameters to ``dtype`` in place; GroupNorm
    affine parameters stay float32."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return net


class AutoencoderKLNet(nn.Module):
    """The plain KL autoencoder (ldm ``AutoencoderKL``): encoder, ``quant_conv``
    (1x1 -> 2 * embed_dim), a diagonal Gaussian posterior, ``post_quant_conv``
    and decoder, with ldm's parameter names. NHWC in and out, as
    ``PoseAutoencoderNet``; ``fuse`` as its."""

    def __init__(self, ddconfig: Dict[str, Any], embed_dim: int = 16, fuse: bool = False):
        super().__init__()
        self.encoder = Encoder(ddconfig, fuse)
        self.decoder = Decoder(ddconfig, fuse)
        zc = ddconfig["z_channels"]
        enc_out = 2 * zc if ddconfig.get("double_z", True) else zc
        self.quant_conv = nn.Conv2d(enc_out, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, zc, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """(B, H, W, C) images -> the posterior over (B, h, w, embed_dim)."""
        h = self.encoder(_nchw(x).contiguous(memory_format=torch.channels_last))
        return DiagonalGaussianDistribution.from_parameters(_nhwc(self.quant_conv(h)), dim=-1)

    def decode(self, z: torch.Tensor, return_pre_out: bool = False):
        """(B, h, w, embed_dim) latents -> (B, H, W, out_ch) float32 images
        (and the pre-``conv_out`` activations, NHWC)."""
        z = self.post_quant_conv(_nchw(z).to(self.post_quant_conv.weight.dtype))
        out, pre_out = self.decoder(z, return_pre_out=True)
        return (_nhwc(out), _nhwc(pre_out)) if return_pre_out else _nhwc(out)

    def forward(
        self,
        x: torch.Tensor,
        sample_posterior: bool = True,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Dict[str, Any]:
        """Encode, take a posterior sample (its normal draw ``draws['posterior']``
        when given, else from ``generator``) or the mode, decode. Returns
        dec_obj (B, H, W, out_ch) float32, posterior_obj and pre_out (NHWC,
        the input of the decoder's ``conv_out``)."""
        posterior = self.encode(x)
        if sample_posterior:
            noise = (draws or {}).get("posterior")
            if noise is not None:
                noise = noise.to(posterior.mean.device)
            z = posterior.sample(generator, noise)
        else:
            z = posterior.mode()
        dec, pre_out = self.decode(z, return_pre_out=True)
        return {"dec_obj": dec, "posterior_obj": posterior, "pre_out": pre_out}


class PoseAutoencoderNet(nn.Module):
    """The OD-VAE network: dual-latent encode, pose decode, pose re-encode
    and decode. ``fuse=True`` routes the backbone's ResnetBlock norm+conv
    pairs through the fused GroupNorm+SiLU+conv kernel (same parameters)."""

    def __init__(
        self,
        ddconfig: Dict[str, Any],
        embed_dim: int = 16,
        feat_dims: Sequence[int] = (16, 16, 16),
        pose_decoder_config: Optional[Dict[str, Any]] = None,
        pose_encoder_config: Optional[Dict[str, Any]] = None,
        num_classes: int = 11,
        dropout_prob_init: float = 1.0,
        dropout_prob_final: float = 0.7,
        dropout_warmup_steps: int = 5000,
        pose_conditioned_generation_steps: int = 10000,
        encoder_pretrain_steps: int = 0,
        add_noise_to_z_obj: bool = True,
        fuse: bool = False,
    ):
        super().__init__()
        self.feat_dims = tuple(feat_dims)
        self.num_classes = num_classes
        self.ch = ddconfig["ch"]
        self.dropout_prob_init = dropout_prob_init
        self.dropout_prob_final = dropout_prob_final
        self.dropout_warmup_steps = dropout_warmup_steps
        self.pose_conditioned_generation_steps = pose_conditioned_generation_steps
        self.encoder_pretrain_steps = encoder_pretrain_steps
        self.add_noise_to_z_obj = add_noise_to_z_obj
        self.encoder = Encoder(ddconfig, fuse)
        self.decoder = Decoder(ddconfig, fuse)
        zc = ddconfig["z_channels"]
        enc_out = 2 * zc if ddconfig.get("double_z", True) else zc
        self.quant_conv_obj = nn.Conv2d(enc_out, 2 * embed_dim, 1)
        self.quant_conv_pose = nn.Conv2d(enc_out, embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, zc, 1)
        self.pose_decoder = (
            instantiate_from_config(pose_decoder_config)
            if pose_decoder_config is not None
            else PoseDecoderSpatialVAE(num_classes=num_classes)
        )
        self.pose_encoder = (
            instantiate_from_config(pose_encoder_config)
            if pose_encoder_config is not None
            else PoseEncoderSpatialVAE(num_classes=num_classes)
        )

    def encode(self, x: torch.Tensor):
        """(B, H, W, 3) patches -> (posterior_obj, pose_feat), both NHWC."""
        h = self.encoder(_nchw(x).contiguous(memory_format=torch.channels_last))
        posterior_obj = DiagonalGaussianDistribution.from_parameters(
            _nhwc(self.quant_conv_obj(h)), dim=-1
        )
        return posterior_obj, _nhwc(self.quant_conv_pose(h))

    def decode(self, z: torch.Tensor, return_pre_out: bool = False):
        """(B, h, w, embed_dim) latents -> (B, H, W, out_ch) float32 images
        (and the pre-``conv_out`` activations, NHWC)."""
        z = self.post_quant_conv(_nchw(z).to(self.post_quant_conv.weight.dtype))
        out, pre_out = self.decoder(z, return_pre_out=True)
        return (_nhwc(out), _nhwc(pre_out)) if return_pre_out else _nhwc(out)

    def _decode_pose_to_distribution(self, z: torch.Tensor):
        d = POSE_6D_DIM + LHW_DIM + FILL_FACTOR_DIM
        bbox_logvar = torch.clamp(z[..., d : 2 * d], -30.0, 20.0)
        return DiagonalGaussianDistribution(z[..., :d], bbox_logvar), z[..., -self.num_classes :]

    def _decode_pose(
        self,
        pose_feat: torch.Tensor,
        sample_posterior: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """NHWC pose feature -> (dec_pose (B, 8 + num_classes), bbox posterior).
        The flatten order is NCHW, as torch's ``.view(B, -1)``."""
        flat = _nchw(pose_feat).reshape(pose_feat.shape[0], -1)
        bbox_posterior, c_pred = self._decode_pose_to_distribution(self.pose_decoder(flat))
        if sample_posterior:
            bbox_pred = bbox_posterior.sample(generator, noise)
        else:
            bbox_pred = bbox_posterior.mode()
        return torch.cat([bbox_pred, c_pred], dim=-1), bbox_posterior

    def _encode_pose(self, dec_pose: torch.Tensor) -> torch.Tensor:
        """(B, 8 + num_classes) pose -> (B, H, W, C) NHWC pose feature map."""
        c, h, w = self.feat_dims
        return _nhwc(self.pose_encoder(dec_pose).reshape(-1, c, h, w))

    def dropout_prob(self, global_step: int) -> float:
        """The staged z-dropout probability (``autoencoder.py:171-184`` of the
        JAX package): ``dropout_prob_init`` through pretraining and the
        pose-conditioned phase, then a linear ramp to ``dropout_prob_final``
        over ``dropout_warmup_steps``."""
        p_init, p_final = self.dropout_prob_init, self.dropout_prob_final
        start = self.encoder_pretrain_steps + self.pose_conditioned_generation_steps
        warmup = max(self.dropout_warmup_steps, 1)
        if global_step < start:
            p = p_init
        elif global_step < start + warmup:
            p = p_init - (p_init - p_final) * (global_step - self.encoder_pretrain_steps) / warmup
        else:
            p = p_final
        return min(max(p, 0.0), 1.0)

    def forward(
        self,
        x: torch.Tensor,
        global_step: int,
        sample_posterior: bool = True,
        phase: str = "auto",
        generator: Optional[torch.Generator] = None,
        draws: Optional[Mapping[str, torch.Tensor]] = None,
        override_pose: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """The training pass (``autoencoder.py:186-244`` of the JAX package)
        on NHWC patches ``x``.

        phase: 'auto' decodes and zeroes the reconstruction while
        ``global_step < encoder_pretrain_steps``; 'pretrain' skips the decoder;
        'full' always decodes. The four random draws, in the JAX package's
        order, are 'posterior' (normal, like the object posterior), 'dropout'
        (uniform), 'noise' (normal) and 'bbox' (normal, (B, 8)): each is taken
        from ``draws`` when given there, else drawn from ``generator``.
        ``override_pose`` replaces ``dec_pose`` before the pose is re-encoded
        for the decoder. Returns dec_obj (B, H, W, 3) float32, dec_pose,
        posterior_obj, bbox_posterior, pre_out (NHWC, the input of the
        decoder's ``conv_out``) and dropout_prob."""
        draws = dict(draws or {})

        def draw(name, shape, like, uniform=False):
            t = draws.get(name)
            if t is None:
                fn = torch.rand if uniform else torch.randn
                t = fn(shape, generator=generator, device=like.device)
            return t.to(device=like.device, dtype=like.dtype)

        posterior_obj, pose_feat = self.encode(x)
        z_obj = posterior_obj.mean
        if sample_posterior:
            z_obj = posterior_obj.sample(noise=draw("posterior", z_obj.shape, z_obj))
        p = self.dropout_prob(global_step)
        # nn.Dropout with the scheduled p: zero w.p. p, kept values scaled by
        # 1/(1-p); all zero at p = 1 without inf * 0
        keep = (draw("dropout", z_obj.shape, z_obj, uniform=True) >= p).to(z_obj.dtype)
        z_obj = z_obj * keep / max(1.0 - p, 1e-6)
        if self.add_noise_to_z_obj:
            z_obj = z_obj + draw("noise", z_obj.shape, z_obj)
        bbox_noise = None
        if sample_posterior:
            bbox_noise = draw("bbox", (x.shape[0], POSE_6D_DIM + LHW_DIM + FILL_FACTOR_DIM),
                              torch.empty((), dtype=torch.float32, device=x.device))
        dec_pose, bbox_posterior = self._decode_pose(pose_feat, sample_posterior, noise=bbox_noise)
        pose_for_decode = dec_pose if override_pose is None else override_pose

        if phase == "pretrain":
            dec_obj = torch.zeros_like(x)
            pre_out = torch.zeros(x.shape[:3] + (self.ch,), dtype=x.dtype, device=x.device)
        else:
            dec_obj, pre_out = self.decode(z_obj + self._encode_pose(pose_for_decode),
                                           return_pre_out=True)
            if phase == "auto" and global_step < self.encoder_pretrain_steps:
                dec_obj = torch.zeros_like(dec_obj)
        return {
            "dec_obj": dec_obj,
            "dec_pose": dec_pose,
            "posterior_obj": posterior_obj,
            "bbox_posterior": bbox_posterior,
            "pre_out": pre_out,
            "dropout_prob": p,
        }

    def perturbed_pose_forward(
        self,
        x: torch.Tensor,
        pose: torch.Tensor,
        sample_posterior: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Decode ``x`` with a given pose (``autoencoder.py:246-257`` of the
        JAX package): a fresh posterior sample (its normal draw from
        ``noise`` or ``generator``), no z-dropout or z-noise, the pose
        re-encoded, then the decoder."""
        posterior_obj, _ = self.encode(x)
        z_obj = posterior_obj.sample(generator, noise) if sample_posterior else posterior_obj.mean
        return self.decode(z_obj + self._encode_pose(pose))


class _WrapperBase:
    """What both config-facing wrappers share: reference checkpoints
    (``ckpt_path``), the forward-only network, the seeded loss and network,
    and ``prepare_batch`` from its host and device halves (``_WrapperBase``
    of the JAX package). A wrapper defines ``build_net``, ``build_loss`` and
    the two halves of ``prepare_batch``."""

    learning_rate: float = 4.5e-6
    # the train and eval steps the Trainer builds: "pose" or "plain"
    step_family: str = "pose"
    ckpt_path: Optional[str] = None
    ignore_keys: Sequence[str] = ()
    lpips_weights_path: Optional[str] = None

    def init_from_ckpt(self, net: nn.Module, loss: Optional[nn.Module], path: str,
                       ignore_keys: Sequence[str] = ()):
        """Overlay the reference checkpoint at ``path`` onto ``net`` (and
        ``loss``) in place, ldm's ``init_from_ckpt``: keys under
        ``ignore_keys`` (else the wrapper's) dropped, the rest loaded with
        strict=False into each module's dtype and device (a shape that
        differs raises; missing and unexpected keys are logged). Returns
        (net, loss)."""
        from ..utils.torch_compat import (
            filter_ignore_keys, load_overlay, load_torch_state_dict, split_loss,
        )

        sd = filter_ignore_keys(load_torch_state_dict(path), ignore_keys or self.ignore_keys)
        net_sd, loss_sd = split_loss(sd)
        load_overlay(net, net_sd, "the network")
        if loss is not None and loss_sd:
            load_overlay(loss, loss_sd, "the loss")
        return net, loss

    def maybe_init_from_ckpt(self, net: nn.Module, loss: Optional[nn.Module] = None):
        """``init_from_ckpt`` from ``ckpt_path`` when it is set, else nothing.
        Called by every entry point that builds a state from a seed (the
        train state, the Trainer's fit and forward-only loops, the eval CLI
        without ``-r``); the detector and its export serve the weights they
        are given, so a caller applies it before them. Returns (net, loss)."""
        if not self.ckpt_path:
            return net, loss
        logging.info("Initializing from torch checkpoint %s (ignore_keys=%s)",
                     self.ckpt_path, list(self.ignore_keys))
        return self.init_from_ckpt(net, loss, self.ckpt_path, self.ignore_keys)

    def inference_net(self, net: Optional[nn.Module] = None) -> nn.Module:
        """The network of the forward-only paths (the detector, the image
        logger, ``predict``), as ``build_net``: ``GDT_FUSE_INFERENCE=1``
        builds it with the fused GroupNorm+SiLU+conv kernels
        (``inference_net()`` of the JAX package, which clones its net with
        ``fuse=True``). Same parameter names. Given a live ``net``: ``net``
        itself when the switch is off, else a fused network holding ``net``'s
        weights on its device."""
        fuse = os.environ.get("GDT_FUSE_INFERENCE", "0") == "1"
        if net is not None and not fuse:
            return net
        inet = self.build_net(fuse=fuse)
        if net is not None:
            inet.load_state_dict(net.state_dict())
            inet = inet.to(next(net.parameters()).device, memory_format=torch.channels_last)
        return inet

    def init_loss(self, generator: Optional[torch.Generator] = None, device="cuda"):
        """A seeded loss in float32 on ``device``: LPIPS flax-like (the JAX
        package's seeded random default) or from ``lpips_weights_path``, the
        discriminator with taming's init."""
        loss = self.build_loss()
        flax_like_init_(loss.perceptual_loss, generator)
        init_discriminator_(loss.discriminator, generator)
        if self.lpips_weights_path:
            load_lpips_weights(loss.perceptual_loss, self.lpips_weights_path)
        return loss.to(device=device, memory_format=torch.channels_last)

    def prepare_batch(
        self, batch: Mapping[str, Any], num_shards: int = 1, device="cuda"
    ) -> Dict[str, torch.Tensor]:
        """A host batch -> the loss-ready tensors on ``device``: the numpy
        half (``prepare_batch_host``), then the device half."""
        return self.prepare_batch_device(self.prepare_batch_host(batch), num_shards, device)

    def init_net(self, generator: Optional[torch.Generator] = None, device="cuda") -> nn.Module:
        """A flax-like initialised network (weights drawn on the CPU from
        ``generator``) in the configured compute dtype, on ``device``."""
        net = flax_like_init_(self.build_net(), generator)
        cast_compute_dtype(net, self.compute_dtype)
        return net.to(device=device, memory_format=torch.channels_last)


class PoseAutoencoder(_WrapperBase):
    """Config-facing wrapper with the reference constructor surface. It
    keeps the configuration; ``build_net``/``init_net`` make networks.
    ``learning_rate`` is the base rate until the training entry point scales
    it. ``ckpt_path`` names a reference checkpoint (``ignore_keys`` the key
    prefixes to skip) that every entry point building a state loads over its
    initial weights (``maybe_init_from_ckpt``), as the reference loads it at
    construction."""

    def __init__(
        self,
        ddconfig,
        lossconfig,
        embed_dim,
        euler_convention="XYZ",
        ckpt_path=None,
        ignore_keys=(),
        image_mask_key=None,
        image_rgb_key="patch",
        pose_key="pose_6d",
        fill_factor_key="fill_factor",
        pose_perturbed_key="pose_6d_perturbed",
        class_key="class_id",
        bbox_key="bbox_sizes",
        colorize_nlabels=None,
        monitor=None,
        activation="relu",
        feat_dims=(16, 16, 16),
        pose_decoder_config=None,
        pose_encoder_config=None,
        dropout_prob_init=1.0,
        dropout_prob_final=0.7,
        dropout_warmup_steps=5000,
        pose_conditioned_generation_steps=10000,
        add_noise_to_z_obj=True,
        train_on_yaw=True,
        dtype="float32",
        lpips_weights_path=None,
        input_size=256,
    ):
        self.ckpt_path = ckpt_path
        self.ignore_keys = tuple(ignore_keys or ())
        self.input_size = input_size
        self.image_rgb_key = image_rgb_key
        self.image_mask_key = image_mask_key
        self.pose_key = pose_key
        self.pose_perturbed_key = pose_perturbed_key
        self.class_key = class_key
        self.bbox_key = bbox_key
        self.fill_factor_key = fill_factor_key
        self.train_on_yaw = train_on_yaw
        self.euler_convention = euler_convention
        self.monitor = monitor
        self.embed_dim = embed_dim
        self.feat_dims = tuple(feat_dims)
        self.ddconfig = dict(ddconfig)
        self.pose_decoder_config = pose_decoder_config
        self.pose_encoder_config = pose_encoder_config
        self.dropout_prob_init = dropout_prob_init
        self.dropout_prob_final = dropout_prob_final
        self.dropout_warmup_steps = dropout_warmup_steps
        self.pose_conditioned_generation_steps = pose_conditioned_generation_steps
        self.add_noise_to_z_obj = add_noise_to_z_obj
        self.compute_dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.lpips_weights_path = lpips_weights_path
        loss_params = dict(lossconfig.get("params") or {})
        self.encoder_pretrain_steps = loss_params.get("encoder_pretrain_steps", 0)
        self.num_classes = loss_params.get("num_classes", 11)
        # the PoseLoss keywords, as ``autoencoder.py:419-434`` of the JAX
        # package builds them (train_on_yaw injected, priors read once here);
        # imported here because the losses package imports this one
        from ..losses.contperceptual import build_prior_tables

        prior_means, prior_logvars = build_prior_tables(
            loss_params.pop("dataset_stats_path", None), train_on_yaw
        )
        self.loss_kwargs = dict(
            loss_params, train_on_yaw=train_on_yaw, prior_means=prior_means,
            prior_logvars=prior_logvars,
        )

    def build_net(self, fuse: bool = False) -> PoseAutoencoderNet:
        """A float32 network on the CPU with PyTorch's default init (for
        loading a state_dict into); ``fuse`` as ``PoseAutoencoderNet``'s."""
        return PoseAutoencoderNet(
            ddconfig=self.ddconfig,
            embed_dim=self.embed_dim,
            feat_dims=self.feat_dims,
            pose_decoder_config=self.pose_decoder_config,
            pose_encoder_config=self.pose_encoder_config,
            num_classes=self.num_classes,
            dropout_prob_init=self.dropout_prob_init,
            dropout_prob_final=self.dropout_prob_final,
            dropout_warmup_steps=self.dropout_warmup_steps,
            pose_conditioned_generation_steps=self.pose_conditioned_generation_steps,
            encoder_pretrain_steps=self.encoder_pretrain_steps,
            add_noise_to_z_obj=self.add_noise_to_z_obj,
            fuse=fuse,
        )

    def build_loss(self):
        """A float32 ``PoseLoss`` on the CPU with PyTorch's default init (for
        loading a state_dict into)."""
        from ..losses.contperceptual import PoseLoss

        return PoseLoss(**self.loss_kwargs)

    def example_batch(self, batch_size: int = 1) -> Dict[str, np.ndarray]:
        """A host batch of zeros with every key ``prepare_batch`` reads."""
        h = w = self.input_size
        return {
            self.image_rgb_key: np.zeros((batch_size, h, w, 3), np.float32),
            self.pose_key: np.zeros((batch_size, POSE_6D_DIM), np.float32),
            "yaw": np.zeros((batch_size,), np.float32),
            self.class_key: np.zeros((batch_size,), np.int32),
            "original_class_id": np.zeros((batch_size,), np.int32),
            self.bbox_key: np.zeros((batch_size, LHW_DIM), np.float32),
            self.fill_factor_key: np.zeros((batch_size,), np.float32),
            "mask_2d_bbox": np.ones((batch_size, h, w, 1), np.float32),
            self.pose_perturbed_key: np.zeros((batch_size, POSE_6D_DIM), np.float32),
            "yaw_perturbed": np.zeros((batch_size,), np.float32),
        }

    def prepare_batch_host(self, batch: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """The numpy half of ``prepare_batch`` (``prepare_batch_host`` of the
        JAX package): the yaw column injected into the pose, every field in
        its dtype. A float batch gives ``rgb_gt`` (not yet rescaled) and
        ``mask_2d_bbox``, NCHW turned NHWC. A raw-crop batch (the datasets'
        ``device_preprocess: true`` contract) passes ``patch_raw`` (uint8
        crops padded into one buffer size), ``patch_src_size``,
        ``bbox_in_crop`` and ``patch_out_size`` through for the device half."""
        b = np.asarray(batch[self.class_key]).shape[0]
        pose = np.array(batch[self.pose_key], np.float32, copy=True)
        if self.train_on_yaw:
            pose[:, 3] = np.asarray(batch["yaw"], np.float32)
        host = {
            "pose_gt": pose,
            "class_gt": np.asarray(batch[self.class_key], np.int64),
            "class_orig_id": np.asarray(batch.get("original_class_id", batch[self.class_key]),
                                        np.int64),
            "bbox_gt": np.asarray(batch[self.bbox_key], np.float32),
            "fill_factor_gt": np.asarray(batch[self.fill_factor_key], np.float32),
            "yaw_perturbed": np.asarray(batch.get("yaw_perturbed", np.zeros(b)), np.float32),
        }
        if "patch_raw" in batch:
            host["patch_raw"] = np.asarray(batch["patch_raw"], np.uint8)  # (B, S, S, 3)
            host["patch_src_size"] = np.asarray(batch["patch_src_size"], np.float32)
            host["bbox_in_crop"] = np.asarray(batch["bbox_in_crop"], np.float32)
            host["patch_out_size"] = np.asarray(batch["patch_out_size"], np.int32).reshape(-1)[:1]
        else:
            rgb = np.asarray(batch[self.image_rgb_key], np.float32)
            if rgb.ndim == 4 and rgb.shape[1] == 3 and rgb.shape[-1] != 3:
                rgb = np.transpose(rgb, (0, 2, 3, 1))
            mask = np.asarray(batch["mask_2d_bbox"], np.float32)
            if mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[-1] != 1:
                mask = np.transpose(mask, (0, 2, 3, 1))
            host["rgb_gt"] = rgb
            host["mask_2d_bbox"] = mask
        return {k: np.ascontiguousarray(v) for k, v in host.items()}

    @staticmethod
    def prepare_batch_device(
        host: Mapping[str, Any], num_shards: int = 1, device="cuda", non_blocking: bool = False
    ) -> Dict[str, torch.Tensor]:
        """The device half: every field onto ``device``; a raw-crop batch is
        cropped, resized and its box mask drawn there (``ops/resize.py``);
        then ``rgb_gt`` is rescaled to [-1, 1] per shard. ``host`` holds
        numpy arrays or (pinned) CPU tensors. ``batch_contracts`` counts the
        batches of each contract."""
        host = dict(host)
        raw = "patch_raw" in host
        out_size = int(np.asarray(host.pop("patch_out_size")).reshape(-1)[0]) if raw else 0
        out = {k: torch.as_tensor(v).to(device, non_blocking=non_blocking)
               for k, v in host.items()}
        if raw:
            src = out.pop("patch_src_size")
            centers = torch.stack([src / 2.0, src / 2.0], dim=-1)
            out["rgb_gt"] = batched_crop_resize(out.pop("patch_raw"), centers, src, out_size)
            out["mask_2d_bbox"] = bbox_mask(out.pop("bbox_in_crop"), src, out_size)
        batch_contracts["raw" if raw else "float"] += 1
        out["rgb_gt"] = rescale_minmax(out["rgb_gt"], num_shards)
        return out

class Autoencoder(_WrapperBase):
    """The plain KL autoencoder's wrapper (the reference's ``Autoencoder``,
    ldm's ``AutoencoderKL``), with the keyword surface of the JAX package's.
    The Trainer builds the plain train and eval steps for it
    (``step_family``); its batches are ``{'image': (B, H, W, C)}`` in [-1, 1],
    taken as the dataset gives them. ``ckpt_path`` names an ldm
    ``AutoencoderKL`` checkpoint, loaded as ``PoseAutoencoder``'s."""

    step_family = "plain"
    encoder_pretrain_steps = 0  # no curriculum: always the 'full' phase

    def __init__(
        self,
        ddconfig,
        lossconfig,
        embed_dim,
        ckpt_path=None,
        ignore_keys=(),
        image_key="image",
        colorize_nlabels=None,
        monitor=None,
        dtype="float32",
        **_,
    ):
        self.ddconfig = dict(ddconfig)
        self.embed_dim = embed_dim
        self.ckpt_path = ckpt_path
        self.ignore_keys = tuple(ignore_keys or ())
        self.image_key = image_key
        self.monitor = monitor
        self.compute_dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.lossconfig = lossconfig

    def build_net(self, fuse: bool = False) -> AutoencoderKLNet:
        """A float32 network on the CPU with PyTorch's default init (for
        loading a state_dict into); ``fuse`` as ``AutoencoderKLNet``'s."""
        return AutoencoderKLNet(self.ddconfig, self.embed_dim, fuse=fuse)

    def build_loss(self):
        """A float32 loss (``lossconfig``'s target, ``LPIPSWithDiscriminator``
        in the shipped configs) on the CPU with PyTorch's default init."""
        return instantiate_from_config(self.lossconfig)

    def example_batch(self, batch_size: int = 1) -> Dict[str, np.ndarray]:
        """A host batch of zeros at the configured resolution."""
        res = self.ddconfig.get("resolution", 256)
        return {self.image_key: np.zeros((batch_size, res, res, self.ddconfig["in_channels"]),
                                         np.float32)}

    def prepare_batch_host(self, batch: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """ldm's ``get_input``: the images float32, NCHW turned NHWC."""
        img = np.asarray(batch[self.image_key], np.float32)
        if img.ndim == 4 and img.shape[1] in (1, 3) and img.shape[-1] not in (1, 3):
            img = np.transpose(img, (0, 2, 3, 1))
        return {"image": np.ascontiguousarray(img)}

    @staticmethod
    def prepare_batch_device(
        host: Mapping[str, Any], num_shards: int = 1, device="cuda", non_blocking: bool = False
    ) -> Dict[str, torch.Tensor]:
        """The images onto ``device`` (numpy or (pinned) CPU tensors)."""
        return {"image": torch.as_tensor(host["image"]).to(device, non_blocking=non_blocking)}


# batches that ``prepare_batch_device`` prepared, by image contract ("raw", "float")
batch_contracts: collections.Counter = collections.Counter()


def rescale_minmax(x: torch.Tensor, num_shards: int = 1) -> torch.Tensor:
    """2*(x - min)/(max - min) - 1; with ``num_shards`` > 1 each of that many
    contiguous batch groups is normalised on its own (the reference's
    per-rank normalisation)."""
    b = x.shape[0]
    if num_shards > 1 and b % num_shards == 0:
        g = x.reshape(num_shards, b // num_shards, -1)
        lo = g.amin(dim=(1, 2), keepdim=True)
        hi = g.amax(dim=(1, 2), keepdim=True)
        return (2.0 * (g - lo) / torch.clamp(hi - lo, min=1e-12) - 1.0).reshape(x.shape)
    lo, hi = x.min(), x.max()
    return 2.0 * (x - lo) / torch.clamp(hi - lo, min=1e-12) - 1.0
