"""Diagonal Gaussian posterior (``utils/distributions.py`` of the JAX package;
ldm ``DiagonalGaussianDistribution`` semantics), with ``kl`` against N(0, I)
or another distribution (``src/util/distributions.py`` semantics: the prior
is squeezed and broadcast over the batch, its variance gets a 1e-5 epsilon),
``nll``, and the per-sample prior-table KL."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..parallel.mesh import draw

LOGVAR_MIN = -30.0
LOGVAR_MAX = 20.0


@dataclass(frozen=True)
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor
    deterministic: bool = False

    @classmethod
    def from_parameters(
        cls, parameters: torch.Tensor, dim: int = 1, deterministic: bool = False
    ) -> "DiagonalGaussianDistribution":
        """Split ``parameters`` into (mean, logvar) halves along ``dim``;
        logvar is clamped to [-30, 20]."""
        mean, logvar = torch.chunk(parameters, 2, dim=dim)
        return cls(mean, torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX), deterministic)

    @property
    def std(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(self.logvar)

    def sample(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """mean + std * noise, with ``noise`` given or drawn from ``generator``
        (in a process group: this rank's slice of the global batch's draw,
        ``parallel.mesh.draw``)."""
        if noise is None:
            noise = draw(torch.randn, self.mean.shape, generator, self.mean.device,
                         torch.float32)
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def _reduce_dims(self) -> tuple:
        return tuple(range(1, self.mean.dim()))

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        """KL(self || N(0, I)) or KL(self || other), one value per batch element."""
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype, device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(
                self.mean.square() + self.var - 1.0 - self.logvar, dim=self._reduce_dims()
            )
        other_mean = other.mean.squeeze().reshape(1, -1)
        other_var = other.var.squeeze().reshape(1, -1)
        other_logvar = other.logvar.squeeze().reshape(1, -1)
        return 0.5 * torch.sum(
            (self.mean - other_mean).square() / (other_var + 1e-5)
            + self.var / (other_var + 1e-5)
            - 1.0
            - self.logvar
            + other_logvar,
            dim=tuple(range(1, max(self.mean.dim(), 2))),
        )

    def nll(self, sample: torch.Tensor, dims: Optional[tuple] = None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype, device=self.mean.device)
        if dims is None:
            dims = self._reduce_dims()
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean).square() / self.var,
            dim=dims,
        )


def kl_vs_prior_table(
    mean: torch.Tensor,
    logvar: torch.Tensor,
    prior_mean: torch.Tensor,
    prior_logvar: torch.Tensor,
) -> torch.Tensor:
    """Per-sample KL of (B, D) posterior moments against (B, D) priors already
    gathered per sample; the numerics of ``kl(other)`` with its 1e-5 epsilon."""
    prior_var = torch.exp(prior_logvar)
    return 0.5 * torch.sum(
        (mean - prior_mean).square() / (prior_var + 1e-5)
        + torch.exp(logvar) / (prior_var + 1e-5)
        - 1.0
        - logvar
        + prior_logvar,
        dim=-1,
    )
