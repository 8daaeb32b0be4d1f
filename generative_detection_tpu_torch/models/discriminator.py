"""PatchGAN discriminator (``models/discriminator.py`` of the JAX package;
taming-transformers' ``NLayerDiscriminator``): n_layers=3, ndf=64,
LeakyReLU(0.2); 256x256x3 -> 30x30x1 logits.

Layout: one ``main`` ``nn.Sequential`` with taming's indices (convs at 0, 2,
5, 8, 11 and norms at 3, 6, 9 for n_layers=3), so reference checkpoints load
by name. It takes and returns NHWC tensors, as the JAX module does.

``BatchStatsNorm`` always normalises by the current batch's statistics
(biased variance) and tracks no running statistics: torch BatchNorm in train
mode, which is what the reference discriminator sees while it trains. In a
process group of more than one rank the statistics are the global batch's,
as under the JAX package's ``jit`` over a sharded batch (``SyncBatchNorm``'s
semantics): the mean, then the mean square deviation from it, each a sum
all-reduced with its gradient.

``LeakyReLU`` takes flax's gradient at 0 (1, where torch's takes the slope).
It matters: the first conv's bias starts at zero, so wherever the masked
input is all zero its outputs sit exactly on the kink.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import differentiable_all_reduce_sum, world


class BatchStatsNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if world().size == 1:
            return F.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        return self._global_batch_norm(x)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Batch statistics over every rank's batch, in float32 at least: the global
        mean (the sums and the count all-reduced), then the global mean of
        the squared deviation from it (the biased variance, two-pass as
        ``jnp.var``)."""
        dims = (0, 2, 3)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        stats = differentiable_all_reduce_sum(torch.cat([xf.sum(dims), count]))
        n = stats[-1]
        mean = stats[:-1] / n
        d = xf - mean.view(1, -1, 1, 1)
        var = differentiable_all_reduce_sum(d.square().sum(dims)) / n
        y = d * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        return (y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)).to(x.dtype)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.negative_slope)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1), LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers + 1):
            prev, nf_mult = nf_mult, min(2**n, 8)
            stride = 2 if n < n_layers else 1
            layers += [
                nn.Conv2d(ndf * prev, ndf * nf_mult, 4, stride=stride, padding=1, bias=False),
                BatchStatsNorm(ndf * nf_mult),
                LeakyReLU(0.2),
            ]
        layers.append(nn.Conv2d(ndf * nf_mult, 1, 4, stride=1, padding=1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, h, w, 1) float32 logits; the input is taken in
        the weights' dtype, as the JAX module casts it to its own."""
        x = x.to(self.main[0].weight.dtype)
        h = self.main(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
        return h.permute(0, 2, 3, 1).float()


def init_discriminator_(module: NLayerDiscriminator,
                        generator: Optional[torch.Generator] = None) -> NLayerDiscriminator:
    """taming's ``weights_init`` as the JAX package draws it: conv weights
    N(0, 0.02), conv biases 0, norm weights N(1, 0.02), norm biases 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchStatsNorm):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()
    return module
