"""The GroupNorm forward's route rule (``ops/norm.py`` ``forward_route``), a
pure function of the shape, and the statistics layout the resident kernel
keeps for the backward. CPU only: the kernels themselves are checked on the
card (``tests/test_torch_port_gpu.py``, ``chip_smoke.py``)."""

import math

import numpy as np
import pytest
import torch

from generative_detection_tpu_torch.ops import norm
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

# (h=w, C): every GroupNorm row of the flagship detector and train step, and
# the tiny configs' C = 32 and 64
MODEL_ROWS = [(256, 128), (128, 128), (128, 256), (64, 128), (64, 256), (32, 256), (32, 512),
              (16, 256), (16, 512), (16, 32), (32, 32), (16, 64)]
SMS = 132


def _check_resident(r, b, l, c, g, elem):
    cg = c // g
    assert r.kind == "resident"
    assert c % r.cs == 0 and r.cs % cg == 0  # a slice holds whole groups
    assert r.cs * elem % 16 == 0
    vr = r.cs * elem // 16
    assert vr <= 32 and vr & (vr - 1) == 0  # a row of the slice is a power of two of vectors
    assert 1 <= r.tiles <= l and (r.tiles - 1) * r.tile_rows < l <= r.tiles * r.tile_rows
    units = b * (c // r.cs)
    assert r.grid == min(units * r.tiles, SMS)  # one block per SM, each with a slot
    assert units * r.tiles < 2 ** 31
    assert norm._resident_smem(r.cs, r.tile_rows, r.cs // cg, elem) <= norm._SMEM_MAX
    assert r.tiles <= norm._LAG * r.grid  # a unit spans at most lag + 1 rounds


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("b", [1, 8, 16, 32])
@pytest.mark.parametrize("hw, c", MODEL_ROWS)
def test_every_model_row_takes_the_resident_kernel(hw, c, b, elem):
    r = norm.forward_route(b, hw * hw, c, 32, elem, SMS)
    _check_resident(r, b, hw * hw, c, 32, elem)


@pytest.mark.parametrize("b, h, w, c, elem, kind", [
    (2, 24, 24, 128, 2, "resident"),  # ragged: L not a multiple of any tile
    (3, 40, 40, 256, 4, "resident"),
    (2, 8, 8, 2048, 2, "resident"),  # the widest bf16 row
    (2, 8, 8, 1024, 4, "resident"),  # the widest fp32 row
    (1, 1, 1, 64, 4, "resident"),  # one row
    (2, 7, 5, 96, 2, "two_pass"),  # C / G = 3: a group splits a 16-byte vector
    (1, 250, 250, 64, 2, "resident"),  # a unit of nearly grid tiles
    (1, 300, 300, 64, 2, "two_pass"),  # too long for the card
    (1, 512, 512, 128, 2, "two_pass"),  # too long for the card
    (4, 512, 512, 64, 4, "two_pass"),
])
def test_edge_rows(b, h, w, c, elem, kind):
    r = norm.forward_route(b, h * w, c, 32, elem, SMS)
    assert r.kind == kind
    if kind == "resident":
        _check_resident(r, b, h * w, c, 32, elem)


def test_route_is_a_pure_function_of_the_shape():
    a = norm.forward_route(8, 65536, 128, 32, 2, SMS)
    norm.forward_route.cache_clear()
    assert norm.forward_route(8, 65536, 128, 32, 2, SMS) == a
    # the flagship's largest site: ~75 KB tiles, one round of the card and part of a second
    assert a.cs == 64 and a.grid == SMS and a.tiles <= a.grid < 16 * a.tiles
    assert norm._RING * a.tile_rows * a.cs * 2 <= norm._SMEM_MAX


def _schedule_deadlocks(r, units):
    """Play the resident kernel's loop on route ``r``: block k takes slots k,
    k + grid, ...; it tags its first ``_LAG`` rounds, then each iteration r
    tags round r + lag and waits until every tile of round r's unit is
    tagged. True if some block waits forever."""
    slots = units * r.tiles
    tagged = np.zeros(slots, dtype=bool)
    rounds = [list(range(k, slots, r.grid)) for k in range(r.grid)]
    step = [0] * r.grid  # iterations done
    lag = norm._LAG
    for own in rounds:
        tagged[own[:lag]] = True
    while any(s < len(own) for s, own in zip(step, rounds)):
        moved = False
        for k, own in enumerate(rounds):
            while step[k] < len(own):
                it = step[k]
                if it + lag < len(own):
                    tagged[own[it + lag]] = True
                u = own[it] // r.tiles
                if not tagged[u * r.tiles:(u + 1) * r.tiles].all():
                    break
                step[k] += 1
                moved = True
        if not moved:
            return True
    return False


@pytest.mark.parametrize("b, hw, c, elem", [(8, 256, 128, 2), (1, 256, 128, 4),
                                            (16, 128, 256, 2), (3, 40, 256, 4),
                                            (1, 250, 64, 2), (8, 16, 512, 2)])
def test_resident_schedule_cannot_deadlock(b, hw, c, elem):
    r = norm.forward_route(b, hw * hw, c, 32, elem, SMS)
    assert not _schedule_deadlocks(r, b * (c // r.cs))
    # the same play finds the wait a unit longer than the grid can hold
    assert _schedule_deadlocks(norm.Route("resident", r.cs, norm._LAG + 2, 1, 1), 1)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 5, 7, 128), (1, 32, 32, 256)])
def test_stats_layout_is_what_the_backward_folds(shape):
    """The resident kernel's stats: per (image, group) sums in tile 0, zeros
    in the others, in the backward's (B, tiles, 2, G) shape. Folding it as
    the backward kernel does (sum over tiles, E[x^2] - E[x]^2) gives the
    forward's mean and rstd, so the plain backward from either agrees."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 2 + 0.5)
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(shape[-1]).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    b, h, w, c = shape
    partial = norm._gn_partial_reference(x, 32)
    assert partial.shape == norm._partial_shape(b, h * w, 32)
    assert partial.shape[1] == norm._tiling(b, h * w)[1]
    assert not partial[:, 1:].any()
    sums = partial.sum(dim=1)  # the backward's fold over tiles
    denom = h * w * (c // 32)
    mean = sums[:, 0] / denom
    rstd = torch.rsqrt(torch.clamp(sums[:, 1] / denom - mean.square(), min=0.0) + 1e-6)
    _, want_mean, want_rstd = norm._gn_forward_reference(x, gamma, beta, 32, 1e-6, "silu")
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, want_rstd, rtol=1e-4, atol=0)
    got = norm._gn_backward_reference(x, dy, mean, rstd, gamma, beta, "silu")
    want = norm._gn_backward_reference(x, dy, want_mean, want_rstd, gamma, beta, "silu")
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=1e-4, atol=1e-4 * float(wv.abs().max()))
    assert math.prod(partial.shape) == b * partial.shape[1] * 2 * 32
