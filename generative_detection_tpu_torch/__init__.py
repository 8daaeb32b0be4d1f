"""OD-VAE in PyTorch for NVIDIA Hopper (H100).

The port of ``generative_detection_tpu`` (JAX on a TPU). Module names follow
the JAX package so each piece has an obvious counterpart; the JAX package
stays the reference the port is tested against. This package imports
``torch``, numpy and yaml only — never ``jax``, ``flax`` or the JAX package.

Kernels: every Pallas kernel on a ported path becomes a hand-written CUDA
kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``ops/_build.py``), and runs as a ``torch.library`` operator of the ``gdt``
namespace (``ops/library.py``): its plain PyTorch version for a CPU tensor,
the kernel for a CUDA tensor, or it raises.
"""
