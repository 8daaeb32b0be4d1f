"""The bf16 row-Winograd kernel's shape rule admits every site the flagship
train step routes to it with GDT_WINOGRAD=fused, forward and dgrad. The
rule is checked here on the CPU because the card is the only place the
kernel runs: a site it refused would raise there while every CPU test
stays green. Pure shape arithmetic, no JAX, no kernel."""

from collections import Counter
from pathlib import Path

import pytest
import torch

from generative_detection_tpu_torch.config import merge_configs
from generative_detection_tpu_torch.models.blocks import _wino_band
from generative_detection_tpu_torch.ops import conv3x3
from generative_detection_tpu_torch.ops import winograd_rows as wr
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"
BATCH, M = 16, 4
INPUT = 256  # the flagship's patch size
# (h = w, C, CO) -> fused sites per step of the flagship train step
FUSED_SITES = {(128, 256, 128): 1, (128, 128, 128): 9, (64, 256, 256): 9, (64, 128, 256): 1,
               (32, 256, 256): 9, (32, 512, 256): 1}


def _resnet_convs():
    """(h, C, CO) of every GroupNorm+SiLU -> 3x3 conv pair of the flagship's
    ResnetBlocks (two per block), encoder, mid blocks and decoder, with
    repeats."""
    cfg = merge_configs([str(FLAGSHIP)])["model"]["params"]["ddconfig"]
    ch, mult, nrb = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    convs, h, c = [], INPUT, ch
    for lvl, m in enumerate(mult):  # encoder
        for _ in range(nrb):
            convs += [(h, c, ch * m), (h, ch * m, ch * m)]
            c = ch * m
        if lvl != len(mult) - 1:
            h //= 2
    convs += [(h, c, c)] * 4  # two mid blocks
    for lvl in reversed(range(len(mult))):  # decoder
        for _ in range(nrb + 1):
            convs += [(h, c, ch * mult[lvl]), (h, ch * mult[lvl], ch * mult[lvl])]
            c = ch * mult[lvl]
        if lvl:
            h *= 2
    return convs


def _fused(h, c, co):
    """Whether GDT_WINOGRAD=fused sends this pair to the row-Winograd kernel
    (models/blocks.py ``_fused_wino_ok``)."""
    shape = (BATCH, h, h, c)
    return _wino_band(shape) and wr.gn_silu_wino_eligible(shape, co, torch.bfloat16, M)


def test_flagship_fused_sites_are_the_table():
    sites = Counter(s for s in _resnet_convs() if _fused(*s))
    assert dict(sites) == FUSED_SITES
    assert sum(sites.values()) == 30


@pytest.mark.parametrize("which", ["forward", "dgrad"])
@pytest.mark.parametrize("h, c, co", sorted(FUSED_SITES))
def test_bf16_kernel_admits_every_fused_site(h, c, co, which):
    if which == "forward":  # the GroupNorm prologue on x, C -> CO
        assert conv3x3.forward_shape_error((BATCH, h, h, c), co, torch.bfloat16, M,
                                           gn=True) is None
    else:  # the same kernel on dy with the rotated, io-swapped kernel, CO -> C
        assert wr._pick_tile(h, h, co, c, 2, M) is not None  # routed to the kernel
        assert conv3x3.forward_shape_error((BATCH, h, h, co), c, torch.bfloat16, M) is None


@pytest.mark.parametrize("m", [2, 4])
def test_bf16_kernel_admits_every_eligible_flagship_conv(m):
    """GDT_WINOGRAD=pallas / pallas4 / auto send any eligible conv of the
    flagship, at any level, to the same kernel."""
    for h, c, co in set(_resnet_convs()):
        shape = (BATCH, h, h, c)
        if wr.wino_rows_eligible(shape, co, torch.bfloat16, m):
            assert conv3x3.forward_shape_error(shape, co, torch.bfloat16, m) is None
        if wr._pick_tile(h, h, co, c, 2, m) is not None and c % 128 == 0 and co % 128 == 0:
            assert conv3x3.forward_shape_error((BATCH, h, h, co), c, torch.bfloat16, m) is None


def test_bf16_kernel_rule_refuses_what_it_cannot_tile():
    bf16 = torch.bfloat16
    assert "CO % 128 == 0" in conv3x3.forward_shape_error((2, 32, 32, 128), 64, bf16, 4)
    assert "H % mode == 0" in conv3x3.forward_shape_error((2, 30, 32, 128), 128, bf16, 4)
    assert conv3x3.forward_shape_error((2, 32, 48, 128), 128, bf16, 4) is None  # any W
    # the direct mode (B6) and fp32 take any W too: their last 64-column tile
    # may run past the image
    assert conv3x3.forward_shape_error((2, 32, 96, 128), 128, bf16, 1, gn=True) is None
    assert conv3x3.forward_shape_error((2, 32, 96, 128), 128, torch.float32, 4) is None
