"""What float32 means in the port: IEEE fp32, decided in one place.

PyTorch runs a float32 convolution through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), a 10-bit mantissa. The JAX
package's float32 on the CPU, the port's reference, has none. So the port's
entry points that compute in float32 (``serving.make_detector_fn``'s
detector, ``train.make_train_step``'s and ``make_eval_step``'s steps) run
their bodies under ``ieee_fp32()``; bfloat16 compute leaves the flags as
the caller set them.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block;
    the caller's settings restored on exit. The flags are process-wide, so
    the autograd engine's backward threads see them too."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn


def compute_precision(dtype: torch.dtype):
    """``ieee_fp32()`` when ``dtype`` is float32, else a context that leaves
    the flags alone."""
    return ieee_fp32() if dtype == torch.float32 else contextlib.nullcontext()
