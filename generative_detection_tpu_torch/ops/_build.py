"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library lands in ``build/kernels/`` at the repository root,
named by a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused. The compiler writes to a temporary file that is
renamed into place, so processes that build at the same time do not race.

There is no fallback: if ``nvcc`` is missing or the build fails, this raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("group_norm", "group_norm_bwd", "attention", "attention_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels of generative_detection_tpu_torch cannot be built"
        )
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, nvcc: str):
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every named source that has no up-to-date library, all ``nvcc``
    processes started together. Returns the seconds each build took (0.0 for
    a library that was already built)."""
    pending, times, t0 = [], {}, time.perf_counter()
    nvcc = None
    for name in names:
        if _target(name).exists():
            times[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        pending.append((name, *_start(name, nvcc)))
    for name, proc, tmp, out in pending:
        _finish(name, proc, tmp, out)
        times[name] = time.perf_counter() - t0
    return times


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said for the built library (registers, spills)."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.gdt_error_string.argtypes = [ctypes.c_int]
        lib.gdt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.gdt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
