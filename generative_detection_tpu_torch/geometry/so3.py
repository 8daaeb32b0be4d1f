"""SO(3) maps in PyTorch, closed form, any number of leading dims
(``geometry/so3.py`` of the JAX package; pytorch3d conventions).

- ``euler_angles_to_matrix(angles, "XYZ")`` = R_X(a0) @ R_Y(a1) @ R_Z(a2).
- ``so3_exp_map``/``so3_log_map``: Rodrigues with the standard ``hat``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"Invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(a not in "XYZ" for a in convention):
        raise ValueError(f"Invalid convention {convention!r}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3)."""
    if euler_angles.shape[-1] != 3:
        raise ValueError("euler_angles must have last dim 3")
    _check_convention(convention)
    mats = [_axis_rotation(axis, euler_angles[..., i]) for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis, other_axis, data, horizontal, tait_bryan):
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in ["XY", "YZ", "ZX"]
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3)."""
    _check_convention(convention)
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        sign = -1.0 if i0 - i2 in [-1, 2] else 1.0
        central_angle = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0, 1.0))
    else:
        central_angle = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0, 1.0))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central_angle,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Vectors (..., 3) -> skew matrices (..., 3, 3): hat(v) @ u == v x u."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp_map(log_rot: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) via Rodrigues."""
    theta2 = torch.sum(log_rot.square(), dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    safe = theta2 > _EPS
    fac1 = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    fac2 = torch.where(
        safe, (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS), 0.5 - theta2 / 24.0
    )
    k = hat(log_rot)
    return _eye_like(k) + fac1[..., None, None] * k + fac2[..., None, None] * (k @ k)


def so3_log_map(rot: torch.Tensor, cos_bound: float = 1e-4) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + cos_bound, 1.0 - cos_bound)
    theta = torch.acos(cos_theta)
    vx = rot[..., 2, 1] - rot[..., 1, 2]
    vy = rot[..., 0, 2] - rot[..., 2, 0]
    vz = rot[..., 1, 0] - rot[..., 0, 1]
    v = 0.5 * torch.stack([vx, vy, vz], dim=-1)
    sin_theta = torch.sin(theta)
    scale = torch.where(
        sin_theta.abs() > 1e-6,
        theta / torch.clamp(sin_theta.abs(), min=1e-12),
        1.0 + theta * theta / 6.0,
    )
    return v * scale[..., None]
