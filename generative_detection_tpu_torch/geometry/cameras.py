"""Patch-perspective camera math on torch tensors (``geometry/cameras.py`` of
the JAX package): a screen-space pinhole camera, the affine NDC -> patch-NDC
transform that expresses object centroids in patch-local coordinates, and
the z remappings between world, patch and learned depth.

Conventions (pytorch3d's):
- row-vector transforms: ``p' = [p, 1] @ M`` (``transforms.Transform``);
- projection (screen units): ``x' = fx*x/z + px``, ``y' = fy*y/z + py``,
  ``z' = 1/z``;
- screen -> NDC (no xyflip): ``x_ndc = (x_screen - W/2) / s``,
  ``y_ndc = (y_screen - H/2) / s`` with ``s = min(H, W)/2``; z unchanged;
- NDC -> screen with xyflip applies the flip before the affine:
  ``x_screen = W/2 - s * x_ndc``;
- NDC -> patch NDC: ``x_patch = (min(patch)/min(image)) * (x_ndc - cx_ndc)``
  where ``cx_ndc`` is the patch center pushed through screen -> NDC; z
  unchanged.

Everything is float32 and batched over a leading camera dimension N.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from .transforms import Transform, robust_inverse

ArrayLike = Union[torch.Tensor, Sequence, float]


def _as_batched(x: ArrayLike, last_dim: Optional[int]) -> torch.Tensor:
    a = torch.as_tensor(x, dtype=torch.float32)
    if last_dim is None:
        return a[None] if a.ndim == 0 else a
    return a.reshape(-1, last_dim)


def _flip(n: int, device) -> torch.Tensor:
    return torch.diag(torch.tensor([-1.0, -1.0, 1.0, 1.0], device=device)).expand(n, 4, 4)


@dataclass(frozen=True)
class PatchPerspectiveCameras:
    """Screen-space perspective camera (R and T optional; identity by
    default). The datasets build it with a negated focal length."""

    focal_length: torch.Tensor  # (N,) or (N, 2)
    principal_point: torch.Tensor  # (N, 2)
    image_size: torch.Tensor  # (N, 2) as (H, W)
    R: torch.Tensor  # (N, 3, 3)
    T: torch.Tensor  # (N, 3)
    znear: float = 0.0
    zfar: float = 80.0

    @classmethod
    def create(
        cls,
        focal_length: ArrayLike,
        principal_point: ArrayLike,
        image_size: ArrayLike,
        R: Optional[ArrayLike] = None,
        T: Optional[ArrayLike] = None,
        znear: float = 0.0,
        zfar: float = 80.0,
    ) -> "PatchPerspectiveCameras":
        f = _as_batched(focal_length, None)
        pp = _as_batched(principal_point, 2)
        im = _as_batched(image_size, 2)
        n = max(f.shape[0], pp.shape[0], im.shape[0])
        R_ = (torch.eye(3).expand(n, 3, 3) if R is None
              else torch.as_tensor(R, dtype=torch.float32).reshape(-1, 3, 3))
        T_ = torch.zeros(n, 3) if T is None else torch.as_tensor(T, dtype=torch.float32).reshape(-1, 3)
        return cls(f, pp, im, R_, T_, znear, zfar)

    @property
    def batch(self) -> int:
        return self.principal_point.shape[0]

    def _fx_fy(self):
        f = self.focal_length
        if f.ndim == 1:
            return f, f
        return f[..., 0], f[..., 1]

    def get_principal_point(self) -> torch.Tensor:
        return self.principal_point

    def get_image_size(self) -> torch.Tensor:
        return self.image_size

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.batch, 4, 4, device=self.principal_point.device)

    def get_world_to_view_transform(self) -> Transform:
        M = self._zeros()
        M[:, :3, :3] = self.R
        M[:, 3, :3] = self.T
        M[:, 3, 3] = 1.0
        return Transform(M)

    def get_projection_transform(self) -> Transform:
        """Perspective projection in screen units: row-vector K with
        ``[x,y,z,1] @ K -> (fx x + px z, fy y + py z, 1, z)``, then the
        w-divide."""
        fx, fy = self._fx_fy()
        M = self._zeros()
        M[:, 0, 0] = fx
        M[:, 1, 1] = fy
        M[:, 2, 0] = self.principal_point[..., 0]
        M[:, 2, 1] = self.principal_point[..., 1]
        M[:, 3, 2] = 1.0
        M[:, 2, 3] = 1.0
        return Transform(M)

    def get_full_projection_transform(self) -> Transform:
        return self.get_world_to_view_transform().compose(self.get_projection_transform())

    def _ndc_to_screen_matrix(self, with_xyflip: bool) -> torch.Tensor:
        h, w = self.image_size[..., 0], self.image_size[..., 1]
        s = torch.minimum(h, w) / 2.0
        M = self._zeros()
        M[:, 0, 0] = s
        M[:, 1, 1] = s
        M[:, 3, 0] = w / 2.0
        M[:, 3, 1] = h / 2.0
        M[:, 2, 2] = 1.0
        M[:, 3, 3] = 1.0
        if with_xyflip:
            M = _flip(self.batch, M.device) @ M  # the flip applied first
        return M

    def get_ndc_camera_transform(self) -> Transform:
        """screen -> NDC, no xyflip (pytorch3d ``get_ndc_camera_transform``
        of a screen-space camera)."""
        return Transform(torch.linalg.inv(self._ndc_to_screen_matrix(False)))

    def transform_points_ndc(self, points: ArrayLike, eps: Optional[float] = None) -> torch.Tensor:
        world_to_ndc = self.get_full_projection_transform().compose(self.get_ndc_camera_transform())
        return world_to_ndc.transform_points(points, eps=eps)

    def transform_points_screen(self, points: ArrayLike, eps: Optional[float] = None,
                                with_xyflip: bool = True) -> torch.Tensor:
        pts_ndc = self.transform_points_ndc(points, eps=eps)
        return Transform(self._ndc_to_screen_matrix(with_xyflip)).transform_points(pts_ndc, eps=eps)

    # -- patch NDC -------------------------------------------------------------
    def get_patch_ndc_camera_transform(self, patch_size: ArrayLike,
                                       patch_center: ArrayLike) -> Transform:
        return get_ndc_to_patch_ndc_transform(
            self, with_xyflip=False, image_size=self.image_size, patch_size=patch_size,
            patch_center=patch_center,
        )

    def get_patch_projection_transform(self, patch_size: ArrayLike,
                                       patch_center: ArrayLike) -> Transform:
        world_to_ndc = self.get_full_projection_transform().compose(self.get_ndc_camera_transform())
        return world_to_ndc.compose(self.get_patch_ndc_camera_transform(patch_size, patch_center))

    def transform_points_patch_ndc(self, points: ArrayLike, patch_size: ArrayLike,
                                   patch_center: ArrayLike,
                                   eps: Optional[float] = None) -> torch.Tensor:
        """Camera or world points -> patch NDC: project to screen (with
        xyflip), screen -> NDC, then NDC -> patch NDC."""
        points_screen = self.transform_points_screen(points, eps=eps)
        points_ndc = self.get_ndc_camera_transform().transform_points(points_screen)
        ndc_to_patch = self.get_patch_ndc_camera_transform(patch_size, patch_center)
        return ndc_to_patch.transform_points(points_ndc, eps=1e-7)

    def transform_points_world_from_patch_ndc(self, points: ArrayLike, patch_size: ArrayLike,
                                              patch_center: ArrayLike,
                                              eps: Optional[float] = None) -> torch.Tensor:
        """Patch-NDC points -> world. Inverts the composed world -> patch-NDC
        matrix as a plain matrix, through the projective w-divide, as the
        JAX package and the reference do."""
        world_to_patch = self.get_patch_projection_transform(patch_size, patch_center)
        return robust_inverse(world_to_patch).transform_points(points, eps=eps)


def get_ndc_to_patch_ndc_transform(
    cameras: PatchPerspectiveCameras,
    with_xyflip: bool = False,
    image_size: Optional[ArrayLike] = None,
    patch_size: Optional[ArrayLike] = None,
    patch_center: Optional[ArrayLike] = None,
) -> Transform:
    """NDC -> patch NDC: ``x_patch = (min(patch)/min(image)) * (x_ndc -
    cx_ndc)`` with (cx_ndc, cy_ndc) the patch center mapped screen -> NDC.
    The ratio divides by the full min image size (not the half size of
    screen -> NDC), as the reference does."""
    if image_size is None or patch_size is None or patch_center is None:
        raise ValueError("image_size, patch_size and patch_center are required")
    image_size = _as_batched(image_size, 2)
    patch_size = _as_batched(patch_size, 2)
    patch_center = _as_batched(patch_center, 2)
    n = cameras.batch
    cx, cy = patch_center[..., 0], patch_center[..., 1]
    point_screen = torch.stack([cx, cy, torch.ones_like(cx)], dim=-1)[:, None, :]
    point_ndc = cameras.get_ndc_camera_transform().transform_points(point_screen)[:, 0, :]
    ratio = patch_size.amin(dim=-1) / image_size.amin(dim=1)
    K = torch.zeros(n, 4, 4)
    K[:, 0, 0] = ratio
    K[:, 1, 1] = ratio
    K[:, 3, 0] = -ratio * point_ndc[..., 0]
    K[:, 3, 1] = -ratio * point_ndc[..., 1]
    K[:, 2, 2] = 1.0
    K[:, 3, 3] = 1.0
    transform = Transform(K)
    if with_xyflip:
        transform = transform.compose(Transform(_flip(n, K.device)))
    return transform


def get_patch_ndc_to_ndc_transform(
    cameras: PatchPerspectiveCameras,
    with_xyflip: bool = False,
    image_size: Optional[ArrayLike] = None,
    patch_size: Optional[ArrayLike] = None,
    patch_center: Optional[ArrayLike] = None,
) -> Transform:
    """patch NDC -> NDC, the robust inverse of the above."""
    return robust_inverse(get_ndc_to_patch_ndc_transform(
        cameras, with_xyflip=with_xyflip, image_size=image_size, patch_size=patch_size,
        patch_center=patch_center,
    ))


# -- z remappings between world, patch and learned depth ----------------------

def z_patch_to_world(z_patch, patch_resampling_factor):
    return z_patch * patch_resampling_factor


def z_world_to_patch(z_world, patch_resampling_factor):
    return z_world / patch_resampling_factor


def z_patch_to_learned(z_patch, zmin, zmax):
    return 2.0 * ((z_patch - zmin) / (zmax - zmin)) - 1.0


def z_learned_to_patch(z_learned, zmin, zmax):
    return 0.5 * (z_learned + 1.0) * (zmax - zmin) + zmin


def z_world_to_learned(z_world, zmin, zmax, patch_resampling_factor):
    return z_patch_to_learned(z_world_to_patch(z_world, patch_resampling_factor), zmin, zmax)


def z_learned_to_world(z_learned, zmin, zmax, patch_resampling_factor):
    return z_patch_to_world(z_learned_to_patch(z_learned, zmin, zmax), patch_resampling_factor)
