"""Pose-aware KL autoencoder (``models/autoencoder.py`` of the JAX package).

- ``PoseAutoencoderNet``: the network. Its public methods keep the JAX
  layout (NHWC tensors in and out); inside, the conv stack runs in
  ``torch.channels_last``. Flatten/reshape between the pose MLPs and the
  feature maps goes through NCHW order (torch ``.view``), as in the JAX
  package, so checkpoints carry over unchanged. The training ``forward``
  (dropout schedule, z-noise, phase gate) comes with the training slice.
- ``PoseAutoencoder``: the config-facing wrapper with the keyword surface of
  the reference YAML ``model.params``. It holds the configuration and builds
  nets; it does not build the loss yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ..config import instantiate_from_config
from ..utils.distributions import DiagonalGaussianDistribution
from .blocks import Decoder, Encoder, _nchw, _nhwc, flax_like_init_
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


class PoseAutoencoderNet(nn.Module):
    """The OD-VAE network: dual-latent encode, pose decode, pose re-encode
    and decode."""

    def __init__(
        self,
        ddconfig: Dict[str, Any],
        embed_dim: int = 16,
        feat_dims: Sequence[int] = (16, 16, 16),
        pose_decoder_config: Optional[Dict[str, Any]] = None,
        pose_encoder_config: Optional[Dict[str, Any]] = None,
        num_classes: int = 11,
    ):
        super().__init__()
        self.feat_dims = tuple(feat_dims)
        self.num_classes = num_classes
        self.encoder = Encoder(ddconfig)
        self.decoder = Decoder(ddconfig)
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
    ):
        """NHWC pose feature -> (dec_pose (B, 8 + num_classes), bbox posterior).
        The flatten order is NCHW, as torch's ``.view(B, -1)``."""
        flat = _nchw(pose_feat).reshape(pose_feat.shape[0], -1)
        bbox_posterior, c_pred = self._decode_pose_to_distribution(self.pose_decoder(flat))
        if sample_posterior:
            bbox_pred = bbox_posterior.sample(generator)
        else:
            bbox_pred = bbox_posterior.mode()
        return torch.cat([bbox_pred, c_pred], dim=-1), bbox_posterior

    def _encode_pose(self, dec_pose: torch.Tensor) -> torch.Tensor:
        """(B, 8 + num_classes) pose -> (B, H, W, C) NHWC pose feature map."""
        c, h, w = self.feat_dims
        return _nhwc(self.pose_encoder(dec_pose).reshape(-1, c, h, w))


class PoseAutoencoder:
    """Config-facing wrapper with the reference constructor surface. It
    keeps the configuration; ``build_net``/``init_net`` make networks."""

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
        if ckpt_path:
            raise NotImplementedError(
                "ckpt_path: loading reference checkpoints comes with the interop "
                "slice; load a state_dict into init_net()'s network instead"
            )
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
        loss_params = dict(lossconfig.get("params") or {})
        self.encoder_pretrain_steps = loss_params.get("encoder_pretrain_steps", 0)
        self.num_classes = loss_params.get("num_classes", 11)

    def build_net(self) -> PoseAutoencoderNet:
        """A float32 network on the CPU with PyTorch's default init (for
        loading a state_dict into)."""
        return PoseAutoencoderNet(
            ddconfig=self.ddconfig,
            embed_dim=self.embed_dim,
            feat_dims=self.feat_dims,
            pose_decoder_config=self.pose_decoder_config,
            pose_encoder_config=self.pose_encoder_config,
            num_classes=self.num_classes,
        )

    def init_net(
        self, generator: Optional[torch.Generator] = None, device="cuda"
    ) -> PoseAutoencoderNet:
        """A flax-like initialised network (weights drawn on the CPU from
        ``generator``) in the configured compute dtype, on ``device``."""
        net = flax_like_init_(self.build_net(), generator)
        cast_compute_dtype(net, self.compute_dtype)
        return net.to(device=device, memory_format=torch.channels_last)


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
