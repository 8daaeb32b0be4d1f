"""Diagonal Gaussian posterior (``utils/distributions.py:33-73`` of the JAX
package; ldm ``DiagonalGaussianDistribution`` semantics). ``kl`` and ``nll``
come with the loss slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

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

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(
            self.mean.shape, generator=generator, dtype=self.mean.dtype,
            device=self.mean.device,
        )
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean
