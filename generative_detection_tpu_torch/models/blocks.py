"""Conv VAE backbone blocks configured by ``ddconfig`` (``models/blocks.py`` of
the JAX package; ldm ``Encoder``/``Decoder`` semantics and parameter names).

Layout: modules take and return NCHW tensors in ``torch.channels_last``
memory, so every GroupNorm reads contiguous NHWC rows and every AttnBlock
gets (B, L, C) tokens without a transpose. Convolutions and dense products
stay cuDNN/cuBLAS; GroupNorm and attention go through ``ops``.

Compute dtype: a module computes in the dtype of its conv weights (bf16 for
serving), while GroupNorm affine parameters stay float32 — flax keeps params
in fp32 and casts them where they are used.

Attention placement tracks ``curr_res`` from the *configured* ``resolution``
(64 in the flagship config), so attention lands at level 2 (64x64 for 256x256
inputs) plus the mid block.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import group_norm, single_head_attention


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels_last -> NHWC (a view; contiguous when x is channels_last)."""
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class GroupNormSiLU(nn.Module):
    """GroupNorm(32, eps 1e-6) with optional fused SiLU; fp32 affine."""

    def __init__(self, channels: int, act: Optional[str] = "silu", num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.act, self.num_groups, self.eps = act, num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = group_norm(
            _nhwc(x).contiguous(), self.weight, self.bias, self.num_groups, self.eps, self.act
        )
        return _nchw(y)


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv, the direct formulation (``blocks.py:123-130``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels)
        self.conv1 = Conv3x3(in_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels)
        self.conv2 = Conv3x3(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """GroupNorm -> one fused (C, 3C) q/k/v product -> single-head attention
    -> 1x1 proj_out, residual. q/k/v keep their own parameters."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNormSiLU(channels, act=None)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = _nhwc(self.norm(x)).reshape(1, b * h * w, c)
        w3 = torch.cat([self.q.weight, self.k.weight, self.v.weight]).reshape(3, c, c)
        b3 = torch.cat([self.q.bias, self.k.bias, self.v.bias]).reshape(3, 1, c)
        # (3, B*L, C): q, k and v each come out contiguous
        qkv = torch.baddbmm(b3, y.expand(3, -1, -1), w3.transpose(1, 2))
        q, k, v = (t.reshape(b, h * w, c) for t in qkv.unbind(0))
        o = single_head_attention(q, k, v)
        o = F.linear(o, self.proj_out.weight.reshape(c, c), self.proj_out.bias)
        return x + _nchw(o.reshape(b, h, w, c))


class Downsample(nn.Module):
    """Asymmetric (0,1)x(0,1) pad, then a stride-2 VALID 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 SAME conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _parse_ddconfig(ddconfig: Dict[str, Any]) -> Dict[str, Any]:
    return dict(
        ch=ddconfig["ch"],
        out_ch=ddconfig["out_ch"],
        ch_mult=tuple(ddconfig["ch_mult"]),
        num_res_blocks=ddconfig["num_res_blocks"],
        attn_resolutions=tuple(ddconfig["attn_resolutions"]),
        in_channels=ddconfig["in_channels"],
        resolution=ddconfig["resolution"],
        z_channels=ddconfig["z_channels"],
        double_z=ddconfig.get("double_z", True),
    )


class Encoder(nn.Module):
    """256x256x3 -> 16x16x(2*z_channels) in the flagship configuration."""

    def __init__(self, ddconfig: Dict[str, Any]):
        super().__init__()
        cfg = _parse_ddconfig(ddconfig)
        ch, ch_mult = cfg["ch"], cfg["ch_mult"]
        in_ch_mult = (1,) + ch_mult
        curr_res = cfg["resolution"]
        self.conv_in = Conv3x3(cfg["in_channels"], ch)
        self.down = nn.ModuleList()
        for i_level in range(len(ch_mult)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(cfg["num_res_blocks"]):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg["attn_resolutions"]:
                    level.attn.append(AttnBlock(block_in))
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = GroupNormSiLU(block_in)
        out_c = 2 * cfg["z_channels"] if cfg["double_z"] else cfg["z_channels"]
        self.conv_out = Conv3x3(block_in, out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    """16x16xz_channels -> 256x256xout_ch. The detector does not run it; it is
    here so that a full checkpoint loads with ``strict=True``."""

    def __init__(self, ddconfig: Dict[str, Any]):
        super().__init__()
        cfg = _parse_ddconfig(ddconfig)
        ch, ch_mult = cfg["ch"], cfg["ch_mult"]
        curr_res = cfg["resolution"] // 2 ** (len(ch_mult) - 1)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv3x3(cfg["z_channels"], block_in)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.up = nn.ModuleList()
        for i_level in reversed(range(len(ch_mult))):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(cfg["num_res_blocks"] + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg["attn_resolutions"]:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            self.up.insert(0, level)
        self.norm_out = GroupNormSiLU(block_in)
        self.conv_out = Conv3x3(block_in, cfg["out_ch"])

    def forward(self, z: torch.Tensor, return_pre_out: bool = False):
        h = self.conv_in(z.to(self.conv_in.weight.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        a = self.norm_out(h)
        out = self.conv_out(a).float()
        return (out, a) if return_pre_out else out


def flax_like_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise like flax: lecun-normal (truncated at 2 std) conv and dense
    kernels, zero biases, GroupNorm weight 1 and bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNormSiLU):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module
