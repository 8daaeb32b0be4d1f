"""The 3x3 conv kernels' shape rule (``ops/conv3x3.py`` ``forward_shape_error``)
admits every shape the port's routing sends to them: the fused detector's
sites (B6, ``GDT_FUSE_INFERENCE=1``), and every shape ``fused_eligible`` or
``wino_rows_eligible`` admit at any width, in bf16 and fp32. The rule is
checked here on the CPU because the card is the only place the kernels run:
a shape the rule refused would raise there while the CPU takes the plain
version. Then the fused GroupNorm+SiLU+conv at such a width against the JAX
package's Pallas kernel in interpret mode.
"""

from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_detection_tpu.ops import fused_conv as jax_fused
from generative_detection_tpu_torch.config import merge_configs
from generative_detection_tpu_torch.models.blocks import Encoder
from generative_detection_tpu_torch.ops import conv3x3, fused_conv
from generative_detection_tpu_torch.ops import winograd_rows as wr
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "configs/autoencoder/pose/autoencoder_kl_16x16x16.yaml"
BATCH, INPUT = 8, 256  # the flagship's patch size
# (h = w, C, CO) -> B6 sites per request of the flagship fused detector
DETECTOR_SITES = {(256, 128, 128): 4, (128, 128, 128): 4, (64, 128, 256): 1,
                  (64, 256, 256): 3, (32, 256, 256): 4, (16, 256, 512): 1,
                  (16, 512, 512): 7}
DTYPES = (torch.bfloat16, torch.float32)


def _encoder_pairs():
    """(h, C, CO, fuse) of every GroupNorm+SiLU -> 3x3 conv pair of the
    flagship encoder with fuse=True (levels and mid blocks), built on the
    meta device from the config."""
    ddconfig = merge_configs([str(FLAGSHIP)])["model"]["params"]["ddconfig"]
    with torch.device("meta"):
        enc = Encoder(ddconfig, fuse=True)
    blocks, h = [], INPUT
    for level in enc.down:
        blocks += [(h, b) for b in level.block]
        if hasattr(level, "downsample"):
            h //= 2
    blocks += [(h, enc.mid.block_1), (h, enc.mid.block_2)]
    return [(h, conv.in_channels, conv.out_channels, b.fuse)
            for h, b in blocks for conv in (b.conv1, b.conv2)]


def test_flagship_fused_detector_sites_are_the_table():
    sites = Counter((h, c, co) for h, c, co, fuse in _encoder_pairs()
                    if fuse and fused_conv.fused_eligible((BATCH, h, h, c), co, torch.bfloat16))
    assert dict(sites) == DETECTOR_SITES
    assert sum(sites.values()) == 24


@pytest.mark.parametrize("emit_z", [False, True])
@pytest.mark.parametrize("h, c, co", sorted(DETECTOR_SITES))
def test_b6_rule_admits_every_detector_site(h, c, co, emit_z):
    assert conv3x3.forward_shape_error((BATCH, h, h, c), co, torch.bfloat16, 1, gn=True,
                                       emit_z=emit_z) is None


def _admitted(h, c, co):
    """(W, dtype, mode, shape, CO) of every launch the port's gates send to
    conv3x3_forward at W = 8 .. 256: the fused conv (mode 1), the
    row-Winograd forward (mode 2, 4) and its dgrad (the channels swapped)."""
    out = []
    for w in range(8, 257, 8):
        for dtype in DTYPES:
            shape = (2, h, w, c)
            if fused_conv.fused_eligible(shape, co, dtype):
                out.append((w, dtype, 1, shape, co))
            for m in (2, 4):
                if wr.wino_rows_eligible(shape, co, dtype, m):
                    out.append((w, dtype, m, shape, co))
                    if wr._pick_tile(h, w, co, c, dtype.itemsize, m) is not None:
                        out.append((w, dtype, m, (2, h, w, co), c))
    return out


@pytest.mark.parametrize("h, c, co", [(8, 128, 128), (16, 128, 256), (32, 256, 256),
                                      (12, 512, 512), (64, 256, 128)])
def test_rule_admits_every_width_the_gates_admit(h, c, co):
    """C2: the JAX package's gates put W % 8 (fused) or nothing (row-Winograd)
    on W, so the port's kernels must take every such W, 64-column tiles that
    run past the image included."""
    admitted = _admitted(h, c, co)
    assert {w for w, *_ in admitted if w > 64 and w % 64}  # widths past a 64-column tile
    for w, dtype, mode, shape, cout in admitted:
        gns = (True,) if mode == 1 else (False, True)
        for gn in gns:
            for emit_z in ((False, True) if mode == 1 else (False,)):
                err = conv3x3.forward_shape_error(shape, cout, dtype, mode, gn=gn, emit_z=emit_z)
                assert err is None, (shape, cout, dtype, mode, gn, emit_z, err)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("GDT_PALLAS_INTERPRET", "1")
    return monkeypatch


def test_gn_silu_conv_at_a_c2_width_matches_jax(interpret):
    """The fused conv at W = 72 (past a 64-column tile) against the JAX
    package's Pallas kernel in interpret mode; fp32 on both sides, max |port
    - JAX| <= 1e-4 * max |JAX| (the same fp32 arithmetic in another order)."""
    shape, co = (1, 8, 72, 128), 128
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], co)) / np.sqrt(9 * shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=co)).astype(np.float32)
    assert jax_fused.fused_eligible(shape, co, jnp.float32)
    assert fused_conv.fused_eligible(shape, co, torch.float32)
    want = np.asarray(jax_fused.gn_silu_conv(*(jnp.asarray(a) for a in (x, gamma, beta, k, bias))))
    got = fused_conv.gn_silu_conv(*(torch.from_numpy(a) for a in (x, gamma, beta, k, bias)))
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
