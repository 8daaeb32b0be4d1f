"""Image resize on the device: the preprocessing stage of raw-crop batches
(``ops/resize.py`` of the JAX package, which runs it as plain XLA ops inside
the step's jit; no Pallas kernel there, so plain tensor ops here, on whatever
device the input lies).

The coordinate arithmetic is the JAX package's, in float32: output pixel i
samples the source at (i + 0.5) * scale - 0.5 (align_corners=False), the four
neighbours are gathered by explicit index arithmetic with out-of-frame pixels
read as 0, and the mask samples floor((i + 0.5) * size / out) with the box
truncated to int. ``F.grid_sample`` is not used: it normalises coordinates to
[-1, 1] and back, which moves the rounding.
"""

from __future__ import annotations

import torch


def _axis(in_size: int, out_size: int, device) -> tuple:
    scale = torch.tensor(in_size / out_size, dtype=torch.float32, device=device)
    coords = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, in_size - 1.0)
    lo = torch.floor(coords).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    return lo, hi, coords - lo.to(torch.float32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) images (edge pixels clamped), in the
    input's dtype."""
    h, w = img.shape[-3], img.shape[-2]
    x = img.to(torch.float32)
    ylo, yhi, yf = _axis(h, out_h, img.device)
    xlo, xhi, xf = _axis(w, out_w, img.device)
    top = x[..., ylo, :, :]
    bot = x[..., yhi, :, :]
    rows = top + (bot - top) * yf[:, None, None]
    left = rows[..., :, xlo, :]
    right = rows[..., :, xhi, :]
    out = left + (right - left) * xf[None, :, None]
    return out.to(img.dtype)


def batched_crop_resize(
    frames: torch.Tensor,  # (B, H, W, C) uint8 or float
    centers: torch.Tensor,  # (B, 2) crop centres (x, y) in pixels
    sizes: torch.Tensor,  # (B,) square crop sizes in pixels, one a sample
    out_size: int = 256,
) -> torch.Tensor:
    """Square crops of per-sample size around ``centers``, each resized to
    ``out_size`` by point-sampled bilinear interpolation; out-of-frame source
    pixels read as 0. (B, out_size, out_size, C) float32, in [0, 1] for uint8
    frames."""
    b, h, w, _ = frames.shape
    dev = frames.device
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    centers = centers.to(torch.float32)
    sizes = sizes.to(torch.float32)
    x0 = centers[:, 0] - sizes / 2.0
    y0 = centers[:, 1] - sizes / 2.0
    idx = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)[None, :] \
        * (sizes / out_size)[:, None] - 0.5  # (B, out)
    sx = x0[:, None] + idx
    sy = y0[:, None] + idx
    x_lo = torch.floor(sx).to(torch.int64)
    y_lo = torch.floor(sy).to(torch.int64)
    fx = (sx - x_lo.to(torch.float32))[:, None, :, None]
    fy = (sy - y_lo.to(torch.float32))[:, :, None, None]
    bi = torch.arange(b, device=dev)[:, None, None]

    def gather(yi, xi):
        valid = (((yi >= 0) & (yi < h))[:, :, None] & ((xi >= 0) & (xi < w))[:, None, :])
        vals = frames[bi, yi.clamp(0, h - 1)[:, :, None], xi.clamp(0, w - 1)[:, None, :]]
        vals = vals.to(torch.float32) * scale
        return vals * valid.to(torch.float32)[..., None]

    tl = gather(y_lo, x_lo)
    tr = gather(y_lo, x_lo + 1)
    bl = gather(y_lo + 1, x_lo)
    br = gather(y_lo + 1, x_lo + 1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    return top + (bot - top) * fy


def bbox_mask(
    bbox_in_crop: torch.Tensor,  # (B, 4) x1, y1, x2, y2 in source-crop pixels
    sizes: torch.Tensor,  # (B,) square source-crop sizes in pixels
    out_size: int = 256,
) -> torch.Tensor:
    """The box of each crop drawn at the output size, nearest-neighbour (the
    twin of ``native/patchops.cpp`` ``bbox_mask_resize``; negative corners
    clamp to 0). (B, out_size, out_size, 1) float32 in {0, 1}."""
    dev = bbox_in_crop.device
    scale = sizes.to(torch.float32) / out_size
    coords = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    s = torch.floor(coords[None, :] * scale[:, None]).to(torch.int32)  # (B, out)
    box = bbox_in_crop.to(torch.float32).clamp(min=0.0).to(torch.int32)  # truncates, as C++
    in_x = (s >= box[:, 0:1]) & (s < box[:, 2:3])
    in_y = (s >= box[:, 1:2]) & (s < box[:, 3:4])
    return (in_y[:, :, None] & in_x[:, None, :]).to(torch.float32)[..., None]


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W, C) images (PIL NEAREST)."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device

    def pick(in_size, out_size):
        scale = torch.tensor(in_size / out_size, dtype=torch.float32, device=dev)
        i = torch.floor((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * scale)
        return i.to(torch.int64).clamp(0, in_size - 1)

    return img[..., pick(h, out_h), :, :][..., :, pick(w, out_w), :]
