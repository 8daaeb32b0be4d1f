"""SE(3) exp/log maps in PyTorch (``geometry/se3.py`` of the JAX package;
pytorch3d row-vector convention): transforms are 4x4 ``[[R, 0], [T, 1]]``
and the log is ``(u, omega)`` with ``omega = so3_log(R)``, ``u = V(omega)^-1 T``.
"""

from __future__ import annotations

import torch

from .so3 import _eye_like, hat, so3_exp_map, so3_log_map

_EPS = 1e-8


def _se3_V(log_rot: torch.Tensor) -> torch.Tensor:
    """The SE(3) left Jacobian V(omega), (..., 3, 3)."""
    theta2 = torch.sum(log_rot.square(), dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    safe = theta2 > _EPS
    fac1 = torch.where(
        safe, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS), 0.5 - theta2 / 24.0
    )
    fac2 = torch.where(
        safe,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    k = hat(log_rot)
    return _eye_like(k) + fac1[..., None, None] * k + fac2[..., None, None] * (k @ k)


def se3_exp_map(log_transform: torch.Tensor) -> torch.Tensor:
    """(..., 6) [u, omega] -> (..., 4, 4) row-vector transforms."""
    u, omega = log_transform[..., :3], log_transform[..., 3:]
    t = torch.einsum("...ij,...j->...i", _se3_V(omega), u)
    m = log_transform.new_zeros(log_transform.shape[:-1] + (4, 4))
    m[..., :3, :3] = so3_exp_map(omega)
    m[..., 3, :3] = t
    m[..., 3, 3] = 1.0
    return m


def se3_log_map(transform: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) row-vector transforms -> (..., 6) [u, omega]."""
    omega = so3_log_map(transform[..., :3, :3])
    u = torch.linalg.solve(_se3_V(omega), transform[..., 3, :3].unsqueeze(-1))[..., 0]
    return torch.cat([u, omega], dim=-1)
