"""fp32 means IEEE fp32 in the port: ``ops.precision.ieee_fp32()`` turns TF32
off for cuDNN and cuBLAS and restores the caller's flags, and the float32
detector runs its network under it while the bfloat16 one leaves the flags
alone. (The flags are process-wide settings, read here on the CPU; the card
test that they change the result is in tests/test_torch_port_gpu.py.)"""

from pathlib import Path

import numpy as np
import pytest
import torch

from generative_detection_tpu_torch.config import instantiate_from_config, merge_configs
from generative_detection_tpu_torch.ops.precision import compute_precision, ieee_fp32
from generative_detection_tpu_torch.serving import make_detector_fn
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture
def caller_flags():
    """TF32 on for both, as a caller might set it; restored after the test."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield (True, "high")
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


def test_ieee_fp32_turns_tf32_off_and_restores(caller_flags):
    with ieee_fp32():
        assert _flags() == (False, "highest")
        assert not torch.backends.cuda.matmul.allow_tf32
    assert _flags() == caller_flags
    with pytest.raises(RuntimeError), ieee_fp32():
        raise RuntimeError("restored on the way out too")
    assert _flags() == caller_flags
    with compute_precision(torch.bfloat16):
        assert _flags() == caller_flags
    with compute_precision(torch.float32):
        assert _flags() == (False, "highest")


@pytest.mark.parametrize("dtype, inside", [("float32", (False, "highest")), ("bfloat16", None)])
def test_detector_runs_its_net_under_the_setting(caller_flags, dtype, inside, monkeypatch):
    monkeypatch.delenv("GDT_SERVE_DTYPE", raising=False)
    cfg = merge_configs([str(REPO / "configs/autoencoder/pose/tiny_cpu.yaml")])
    model = instantiate_from_config(cfg["model"])
    net = model.init_net(torch.Generator().manual_seed(0), device="cpu")
    hmin, hmax = np.full(11, 0.5, np.float32), np.full(11, 4.0, np.float32)
    detect = make_detector_fn(model, net, hmin, hmax, 32, dtype=dtype, device="cpu")
    seen = set()
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda *_: seen.add(_flags()))
    try:
        rng = np.random.default_rng(1)
        detect(rng.normal(size=(1, 32, 32, 3)).astype(np.float32),
               np.full((1,), 1266.0, np.float32), np.float32([[800.0, 450.0]]),
               np.full((1,), 100.0, np.float32), np.float32([[820.0, 460.0]]),
               np.full((1,), 2.56, np.float32))
    finally:
        hook.remove()
    assert seen == {inside or caller_flags}
    assert _flags() == caller_flags
