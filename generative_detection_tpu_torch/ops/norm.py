"""GroupNorm(+SiLU) over NHWC feature maps, forward and backward.

``group_norm`` takes a CPU tensor through the plain PyTorch versions
(``_gn_reference``, ``_gn_backward_reference``) and a CUDA tensor through the
hand-written kernels in ``csrc/group_norm.cu`` (forward) and
``csrc/group_norm_bwd.cu`` (backward), or raises. There is no other path.
When autograd needs the result, the call goes through ``_GroupNormFn``; its
forward keeps the per-(image, group) statistics (the kernel's stats partials
on the card, mean and rstd on the CPU) so the backward never recomputes
them. Under ``torch.no_grad`` and ``inference_mode`` nothing is saved.

Kernel notes:

- forward: replaces ``generative_detection_tpu/ops/norm.py`` ``_gn_pallas``
  (kernel ``_gn_kernel``), which runs only on rows of <= 512K elements
  because the whole row must sit in TPU VMEM, and the chunked stats and
  apply kernels ``_gn_chunked_stats``/``_gn_chunked_apply`` that take larger
  rows. On the H100 it is memory-bound: read x once, write y once (0.080 ms
  at 8x256x256x128 bf16). One cooperative launch of
  ``gn_fwd_resident_kernel`` holds every row of the model in the shared
  memory of the card's blocks: a unit (an image's rows over a slice of whole
  groups, 128 bytes a row) is cut into row tiles dealt to one persistent
  block per SM; each block keeps a ring of three tiles, tags each tile's
  group sums with the launch's epoch in 64-bit words, and a round later
  folds its unit's tagged sums (every block in the same order) and
  normalizes the tile from shared memory, so x crosses HBM once.
  ``forward_route`` (a pure function of the shape) picks the slice, the
  tiles and the grid; rows too long for the card (a unit of more than one
  tile per block) and C / G not a power of two take the two-pass kernels,
  stats then apply, which read x twice.
- affine: ``group_norm_affine`` is the stats pass alone (it reads x once,
  four rows of 16-byte loads a thread in flight where a thread walks at
  least 12 rows) and a small fold into the
  per-(image, channel) affine (a, b) with silu(x a + b) = GroupNorm+SiLU: the
  prologue of the fused convolutions (``_gn_affine`` of the JAX package's
  ``ops/fused_conv.py``, XLA there). It keeps the stats for
  ``group_norm_backward``, as the forward does.
- the stats both keep are the backward kernels' (B, tiles, 2, G) layout of
  per-tile (sum, sumsq) partials (``_tiling``); the resident kernel writes an
  image's folded sums into tile 0 and zeros into the others
  (``_gn_partial_reference`` is its plain version), so the backward's fold
  gives the forward's own mean and rstd.
- backward: replaces the chunked custom VJP's reduce and dx kernels
  (``_gn_bwd_reduce_chunk_kernel``, ``_gn_bwd_dx_chunk_kernel``). Also
  memory-bound (read x and dy, write dx); two launches, a reduce pass with
  per-tile partials and a dx pass that folds them in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
# stats blocks to aim for: a few per SM of the H100's 132
_TARGET_BLOCKS = 528
# The resident kernel (csrc/group_norm.cu): threads a block, tiles a block
# holds (three fill an SM's shared memory: ~75 KB each), rounds reduced ahead
# of the one that waits, its shared-memory limit
_RES_THREADS = 512
_RING = 3
_LAG = 1
_SMEM_MAX = 232448
_TILE_MIN = 16 * 1024  # smaller tiles cost more in waits than they spread the load
_ROW_BYTES = 128  # a slice's share of a row: one L2 line
_H100_SMS = 132


def _gn_forward_reference(x, gamma, beta, num_groups, eps, act):
    """Plain forward that also returns the per-(image, group) ``mean`` and
    ``rstd``, each (B, G) float32."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    meansq = xg.square().mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(meansq - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xg - mean) * rstd).reshape(b, h, w, c)
    y = y * gamma.float() + beta.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), mean.reshape(b, num_groups), rstd.reshape(b, num_groups)


def _gn_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    act: Optional[str],
) -> torch.Tensor:
    """Plain version: fp32 one-pass E[x^2] - E[x]^2 stats, variance clamped
    at >= 0, output in ``x.dtype`` (``norm.py:38-60`` of the JAX package)."""
    return _gn_forward_reference(x, gamma, beta, num_groups, eps, act)[0]


def _gn_backward_reference(x, dy, mean, rstd, gamma, beta, act):
    """Plain backward, the closed form of ``norm.py:511-537`` of the JAX
    package from the forward's ``mean`` and ``rstd`` (B, G): returns
    (dx in ``x.dtype``, dgamma, dbeta float32 (C,))."""
    b, h, w, c = x.shape
    g = mean.shape[-1]
    shape = (b, h * w, g, c // g)
    xhat = (x.float().reshape(shape) - mean.reshape(b, 1, g, 1)) * rstd.reshape(b, 1, g, 1)
    g32 = gamma.float().reshape(1, 1, g, c // g)
    dy32 = dy.float().reshape(shape)
    if act == "silu":
        z = xhat * g32 + beta.float().reshape(1, 1, g, c // g)
        sig = torch.sigmoid(z)
        dz = dy32 * sig * (1.0 + z * (1.0 - sig))
    else:
        dz = dy32
    dgamma = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbeta = dz.sum(dim=(0, 1)).reshape(c)
    dxhat = dz * g32
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 3), keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd.reshape(b, 1, g, 1)
    return dx.reshape(b, h, w, c).to(x.dtype), dgamma, dbeta


def _gn_affine_reference(x, gamma, beta, num_groups, eps):
    """Plain affine (``fused_conv.py:52-69`` of the JAX package): returns
    (a, b, mean, rstd), a and b (B, C) float32, mean and rstd (B, G)."""
    bsz, h, w, c = x.shape
    cg = c // num_groups
    xg = x.reshape(bsz, h * w, num_groups, cg).float()
    mean = xg.mean(dim=(1, 3))
    meansq = xg.square().mean(dim=(1, 3))
    var = torch.clamp(meansq - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(cg, dim=-1) * gamma.float()[None, :]
    b = beta.float()[None, :] - mean.repeat_interleave(cg, dim=-1) * a
    return a, b, mean, rstd


def _tiling(b: int, l: int) -> tuple[int, int]:
    """Rows per tile and tiles per image: enough blocks to fill the card.
    The backward kernels' tiling, and the forward's stats layout."""
    tiles = max(1, min(math.ceil(_TARGET_BLOCKS / b), math.ceil(l / 16)))
    rows = math.ceil(l / tiles)
    return rows, math.ceil(l / rows)


def _partial_shape(b: int, l: int, g: int) -> tuple[int, int, int, int]:
    """The (B, tiles, 2, G) float32 stats the forward keeps for the backward."""
    return (b, _tiling(b, l)[1], 2, g)


def _gn_partial_reference(x, num_groups):
    """Plain version of the stats layout the resident kernel writes: per
    (image, group) float32 (sum, sumsq) of x in tile 0, zeros in the other
    tiles of ``_partial_shape``."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, num_groups, c // num_groups).float()
    partial = torch.zeros(_partial_shape(b, h * w, num_groups), dtype=torch.float32,
                          device=x.device)
    partial[:, 0, 0] = xg.sum(dim=(1, 3))
    partial[:, 0, 1] = xg.square().sum(dim=(1, 3))
    return partial


def _slice_channels(c: int, g: int, elem: int) -> int:
    """Channels of a unit's slice: whole groups, a multiple of 16 bytes, the
    fewest groups that fill ``_ROW_BYTES`` of a row (all of C if none do)."""
    cg = c // g
    fits = [m for m in range(1, g + 1) if g % m == 0 and cg * m * elem % 16 == 0]
    return cg * next((m for m in fits if cg * m * elem >= _ROW_BYTES), fits[-1])


def _resident_smem(cs: int, tile_rows: int, m: int, elem: int) -> int:
    """Shared memory of one resident block (``resident_smem`` in the source):
    the ring of tiles, each warp's group sums, each ring slot's statistics
    and the fold buffer."""
    return (_RING * tile_rows * cs * elem + (_RES_THREADS // 32) * 2 * m * 4
            + _RING * 2 * m * 4 + max(2 * m, _RES_THREADS) * 4)


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


@dataclass(frozen=True)
class Route:
    """How one forward call runs. ``kind`` "resident": units of ``cs``
    channels, each cut into ``tiles`` tiles of ``tile_rows`` rows, on
    ``grid`` persistent blocks; "two_pass": the stats and apply kernels (the
    other fields unused)."""

    kind: str
    cs: int = 0
    tiles: int = 0
    tile_rows: int = 0
    grid: int = 0


@functools.lru_cache(maxsize=None)
def forward_route(b: int, l: int, c: int, g: int, elem: int, sms: int = _H100_SMS) -> Route:
    """The route of a GroupNorm forward of ``b`` images of ``l`` rows, ``c``
    channels in ``g`` groups, ``elem`` bytes a value, on ``sms`` SMs. A pure
    function of the shape.

    The resident kernel reduces a tile with warp shuffles, so a slice's row
    must be a power of two of 16-byte vectors, at most a warp's, and a group
    must cover whole vectors or a vector whole groups (every C / G a power of
    two, as in every config of the repo); other shapes take the two-pass
    kernels. Tiles per unit: at least what a ~75 KB tile needs, at most
    one per 16 KB; among those, the least a block walks (rounds x (tile rows
    + 64, a round's own cost), + 192 rows for gathering a unit's tiles when
    there is more than one), then the fewest tiles. A block waits on a unit
    one round after its first tiles arrived, so a unit may span at most two
    rounds: at most ``grid`` tiles; a longer one takes the two-pass
    kernels."""
    cs = _slice_channels(c, g, elem)
    cg, vec = c // g, 16 // elem
    vr = cs * elem // 16
    if not (_pow2(vr) and vr <= 32 and _pow2(cg) and (cg % vec == 0 or vec % cg == 0)):
        return Route("two_pass")
    m = cs // cg
    if 2 * m > _RES_THREADS:
        return Route("two_pass")
    units, row_bytes = b * (c // cs), cs * elem
    budget = (_SMEM_MAX - _resident_smem(cs, 0, m, elem)) // _RING
    tile_rows = budget // row_bytes
    t_min = math.ceil(l / tile_rows)
    if t_min > _LAG * sms:
        return Route("two_pass")
    t_max = max(t_min, min(l, l * row_bytes // _TILE_MIN))

    def grid(t):
        return min(units * t, sms)

    def cost(t):  # a round costs about as much as 64 more rows, a unit's gather 192
        return math.ceil(units * t / grid(t)) * (math.ceil(l / t) + 64) + 192 * (t > 1), t

    fits = [t for t in range(t_min, t_max + 1) if t <= _LAG * grid(t)]
    tiles = min(fits, key=cost)
    tile_rows = math.ceil(l / tiles)
    tiles = math.ceil(l / tile_rows)
    return Route("resident", cs, tiles, tile_rows, grid(tiles))


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    if lib.gdt_group_norm_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_group_norm_fwd.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.gdt_group_norm_fwd.restype = i
        lib.gdt_group_norm_affine.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.gdt_group_norm_affine.restype = i
        lib.gdt_group_norm_resident.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.gdt_group_norm_resident.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The resident kernel's persistent state, by (device, stream): its epoch
# and exit count (int32 [2]) and the tagged per-tile sums (uint64, grown when
# a call needs more). Zero when made; each launch with more than one tile a
# unit tags its sums with the next epoch and leaves the exit count at zero.
_STATE: dict = {}


def _resident_state(device: torch.device, stream: int, words: int):
    key = (device.index, stream)
    state, tags = _STATE.get(key, (None, None))
    if state is None:
        state = torch.zeros(2, dtype=torch.int32, device=device)
    if tags is None or tags.numel() < words:
        tags = torch.zeros(max(words, 2 * (0 if tags is None else tags.numel())),
                           dtype=torch.int64, device=device)
    _STATE[key] = (state, tags)
    return state, tags


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("group_norm_bwd")
    if lib.gdt_group_norm_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gdt_group_norm_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.gdt_group_norm_bwd.restype = i
    return lib


def _check_kernel_args(x, gamma, beta, act):
    c = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel takes a contiguous NHWC tensor")
    vec = 16 // x.element_size()
    if c % 32 or c // vec > _THREADS:
        raise ValueError(
            f"group_norm kernel takes C % 32 == 0 and C <= {_THREADS * vec} "
            f"for {x.dtype}, got C={c}"
        )
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device:
            raise ValueError(f"group_norm {name} must be float32 ({c},) on {x.device}")
    if act not in (None, "silu"):
        raise ValueError(f"group_norm act must be None or 'silu', got {act!r}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernel needs a 16-byte aligned tensor")


def _gn_resident(x, gamma, beta, num_groups, eps, act, route):
    """One launch of the resident kernel on ``route``: returns (y, partial)."""
    b, h, w, c = x.shape
    l, dev = h * w, x.device
    m = route.cs // (c // num_groups)
    partial = torch.empty(_partial_shape(b, l, num_groups), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    state, tags = _resident_state(dev, stream, b * (c // route.cs) * route.tiles * 2 * m)
    lib = _lib()
    rc = lib.gdt_group_norm_resident(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), partial.data_ptr(),
        tags.data_ptr(), state.data_ptr(), b, l, c, num_groups, route.cs, route.tiles,
        route.tile_rows, partial.shape[1], route.grid, eps, int(act == "silu"),
        _DTYPES[x.dtype], stream,
    )
    _build.check(lib, rc, "group_norm resident kernel launch")
    return y, partial


def _route_of(x, num_groups):
    b, h, w, c = x.shape
    return forward_route(b, h * w, c, num_groups, x.element_size(), _sm_count(x.device.index))


def _gn_cuda(x, gamma, beta, num_groups, eps, act):
    """Forward kernel: returns (y, partial), ``partial`` the (B, tiles, 2, G)
    float32 stats that the backward kernels fold again."""
    _check_kernel_args(x, gamma, beta, act)
    gamma, beta = gamma.contiguous(), beta.contiguous()
    route = _route_of(x, num_groups)
    if route.kind == "resident":
        y, partial = _gn_resident(x, gamma, beta, num_groups, eps, act, route)
        group_norm.launches += 1
        return y, partial
    b, h, w, c = x.shape
    l = h * w
    rows, tiles = _tiling(b, l)
    y = torch.empty_like(x)
    partial = torch.empty((b, tiles, 2, num_groups), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.gdt_group_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        partial.data_ptr(), b, l, c, num_groups, rows, tiles, eps,
        int(act == "silu"), _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "group_norm kernel launch")
    group_norm.launches += 1
    group_norm.two_pass += 1
    return y, partial


def _gn_affine_cuda(x, gamma, beta, num_groups, eps):
    """The stats pass and the affine fold: returns (a, b, partial)."""
    _check_kernel_args(x, gamma, beta, None)
    b, h, w, c = x.shape
    gamma, beta = gamma.contiguous(), beta.contiguous()
    l = h * w
    rows, tiles = _tiling(b, l)
    partial = torch.empty((b, tiles, 2, num_groups), dtype=torch.float32, device=x.device)
    a = torch.empty((b, c), dtype=torch.float32, device=x.device)
    shift = torch.empty_like(a)
    lib = _lib()
    rc = lib.gdt_group_norm_affine(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(), a.data_ptr(),
        shift.data_ptr(), b, l, c, num_groups, rows, tiles, eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "group_norm affine kernel launch")
    group_norm_affine.launches += 1
    return a, shift, partial


def group_norm_affine(x, gamma, beta, num_groups=32, eps=1e-6):
    """The per-(image, channel) float32 affine (a, b) of GroupNorm over NHWC
    ``x``, each (B, C), and the ``stats`` that ``group_norm_backward`` takes:
    (mean, rstd) for a CPU tensor, the kernel's (partial,) for a CUDA one.
    Not differentiable itself: the fused convolutions' backward uses
    ``group_norm_backward``."""
    if x.device.type == "cpu":
        a, b, mean, rstd = _gn_affine_reference(x, gamma, beta, num_groups, eps)
        return a, b, (mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_affine runs on cpu or cuda, got {x.device}")
    a, b, partial = _gn_affine_cuda(x, gamma, beta, num_groups, eps)
    return a, b, (partial,)


group_norm_affine.launches = 0  # calls that launched the stats + affine kernels


def _gn_backward_cuda(x, dy, partial, gamma, beta, num_groups, eps, act):
    """Backward kernels: returns (dx, dgamma, dbeta) from the forward's
    stats ``partial``."""
    _check_kernel_args(x, gamma, beta, act)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("group_norm backward: dy must match x in shape, dtype and device")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        group_norm_backward.grad_copies += 1
    if dy.data_ptr() % 16:
        raise ValueError("group_norm backward kernel needs a 16-byte aligned dy")
    b, h, w, c = x.shape
    l = h * w
    rows, tiles = _tiling(b, l)
    if partial.shape != _partial_shape(b, l, num_groups) or partial.dtype != torch.float32:
        raise ValueError("group_norm backward: partial does not come from this forward")
    gamma, beta = gamma.contiguous(), beta.contiguous()
    dx = torch.empty_like(x)
    chan = torch.empty((b, tiles, 2, c), dtype=torch.float32, device=x.device)
    grp = torch.empty((b, tiles, 2, num_groups), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _bwd_lib()
    rc = lib.gdt_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        chan.data_ptr(), grp.data_ptr(), dx.data_ptr(), dgb.data_ptr(), b, l, c,
        num_groups, rows, tiles, eps, int(act == "silu"), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "group_norm backward kernel launch")
    group_norm_backward.launches += 1
    return dx, dgb[0], dgb[1]


def _gn_forward(x, gamma, beta, num_groups, eps, act):
    """(y, stats) by device: stats are (mean, rstd) on the CPU and the
    kernel's (partial,) on the card."""
    if x.device.type == "cpu":
        y, mean, rstd = _gn_forward_reference(x, gamma, beta, num_groups, eps, act)
        return y, (mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cpu or cuda, got {x.device}")
    y, partial = _gn_cuda(x, gamma, beta, num_groups, eps, act)
    return y, (partial,)


def group_norm_backward(x, dy, stats, gamma, beta, num_groups=32, eps=1e-6, act=None):
    """(dx, dgamma, dbeta) of ``group_norm`` from the ``stats`` its forward
    kept: (mean, rstd) for a CPU tensor, (partial,) for a CUDA tensor."""
    if x.device.type == "cpu":
        return _gn_backward_reference(x, dy, *stats, gamma, beta, act)
    return _gn_backward_cuda(x, dy, *stats, gamma, beta, num_groups, eps, act)


group_norm_backward.launches = 0  # calls that launched the kernels (reduce + dx)
group_norm_backward.grad_copies = 0  # gradients that arrived non-contiguous


class _GroupNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        y, stats = _gn_forward(x, gamma, beta, num_groups, eps, act)
        ctx.save_for_backward(x, gamma, beta, *stats)
        ctx.cfg = (num_groups, eps, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, *stats = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_backward(x, dy, stats, gamma, beta, *ctx.cfg)
        return dx, dgamma, dbeta, None, None, None


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over NHWC ``x`` with optional fused SiLU (``act='silu'``).

    ``gamma``/``beta`` stay float32 whatever the activation dtype."""
    if x.dim() != 4:
        raise ValueError(f"group_norm takes (B, H, W, C), got {tuple(x.shape)}")
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by groups {num_groups}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return _GroupNormFn.apply(x, gamma, beta, num_groups, eps, act)
    return _gn_forward(x, gamma, beta, num_groups, eps, act)[0]


group_norm.launches = 0  # calls that launched the kernels: one resident launch, or two
group_norm.two_pass = 0  # of those, calls too long for the card: stats + apply launches
