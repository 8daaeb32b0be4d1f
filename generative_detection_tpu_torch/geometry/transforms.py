"""Row-vector 4x4 transforms (pytorch3d ``Transform3d`` semantics) on torch
tensors (``geometry/transforms.py`` of the JAX package).

Points transform as ``p' = [p, 1] @ M`` followed by division by the resulting
homogeneous coordinate (with an epsilon guard when asked). Composition is
left to right: ``a.compose(b)`` applies ``a`` first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Transform:
    matrix: torch.Tensor  # (..., 4, 4), row-vector convention

    def compose(self, *others: "Transform") -> "Transform":
        m = self.matrix
        for o in others:
            m = m @ o.matrix
        return Transform(matrix=m)

    def inverse(self) -> "Transform":
        return Transform(matrix=torch.linalg.inv(self.matrix))

    def get_matrix(self) -> torch.Tensor:
        return self.matrix

    def transform_points(self, points, eps: Optional[float] = None) -> torch.Tensor:
        """Apply to points (..., P, 3) or (P, 3); w-divide like pytorch3d."""
        pts = torch.as_tensor(points, dtype=self.matrix.dtype, device=self.matrix.device)
        homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        out = homo @ self.matrix
        w = out[..., 3:4]
        if eps is not None:
            sign = torch.where(w >= 0.0, 1.0, -1.0)
            w = sign * torch.clamp(w.abs(), min=eps)
        return out[..., :3] / w


def robust_inverse(transform: Transform, eps: float = 1e-6) -> Transform:
    """Inverse that retries with ``eps`` on the diagonal where the plain
    inverse is not finite (a singular matrix)."""
    m = transform.matrix
    plain, info = torch.linalg.inv_ex(m)
    bumped = torch.linalg.inv(m + torch.eye(m.shape[-1], dtype=m.dtype, device=m.device) * eps)
    ok = torch.isfinite(plain).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    ok = ok & (info == 0)[..., None, None]
    return Transform(matrix=torch.where(ok, plain, bumped))
