"""ctypes bindings of the native host-side loader ops (``data/native.py`` of
the JAX package).

Two libraries are built from the repository's C++ sources at first use:

- ``native/patchops.cpp``: ``crop_resize_bilinear_u8`` (a square crop with
  out-of-frame pixels read as 0, resized with Pillow's BILINEAR triangle
  filter), ``bbox_mask_resize``, ``resize_bilinear_u8`` and ``max_iou``;
- ``native/jpegdec.cpp``: ``gdt_jpeg_dims`` and ``gdt_jpeg_region``, the
  libjpeg region-of-interest decoder (bit-identical to a full decode and a
  crop).

``g++`` builds each into ``build/native/lib<name>-<hash>.so`` at the
repository root (the hash covers the source, the flags and the compiler's
``-march=native`` target), writing to a temporary file that is renamed into
place; ``native/`` itself is never written. The flags are those of
``native/Makefile``, so the port's ops compute what the JAX package's do, bit
for bit.

``libpatchops`` has no fallback: if it does not build or load, this raises.
``libjpegdec`` needs libjpeg's header; where it cannot build,
``load_jpeg_lib`` returns None and the nuScenes reader decodes whole frames
with PIL (the same pixels, slower).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = REPO / "native"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_LIBS: dict = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader ops cannot be built")
    return cxx


def _openmp(cxx: str) -> tuple:
    probe = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                           input="int main(){return 0;}", capture_output=True, text=True)
    return ("-fopenmp",) if probe.returncode == 0 else ()


def _target_id(cxx: str) -> bytes:
    """What ``-march=native`` means on this host: a build made for another
    CPU gets another name."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    return (out.stdout + cxx).encode()


def _build(name: str, extra: tuple, libs: tuple) -> Path:
    """``native/<name>.cpp`` -> ``build/native/lib<name>-<hash>.so``."""
    cxx = _cxx()
    src = NATIVE_SRC / f"{name}.cpp"
    flags = CXX_FLAGS + extra
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags + libs).encode()
                          + _target_id(cxx)).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    proc = subprocess.run([cxx, *flags, "-o", tmp, str(src), *libs],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build native/{name}.cpp:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_lib() -> ctypes.CDLL:
    """The loaded ``libpatchops``, built first if needed; raises if it
    cannot be built or loaded."""
    lib = _LIBS.get("patchops")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(_build("patchops", _openmp(_cxx()), ())))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i, f = ctypes.c_int, ctypes.c_float
    lib.crop_resize_bilinear_u8.argtypes = [u8p, i, i, i, i, i, i, i, f32p, i, i]
    lib.crop_resize_bilinear_u8.restype = None
    lib.bbox_mask_resize.argtypes = [i, f, f, f, f, f32p, i, i]
    lib.bbox_mask_resize.restype = None
    lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, f32p, i, i]
    lib.resize_bilinear_u8.restype = None
    lib.max_iou.argtypes = [f32p, f32p, i]
    lib.max_iou.restype = f
    _LIBS["patchops"] = lib
    return lib


def crop_resize_bilinear(img_u8: np.ndarray, x1: int, y1: int, size: int, out_h: int,
                         out_w: int) -> np.ndarray:
    """The square crop [x1, x1 + size) x [y1, y1 + size) (out-of-frame pixels
    0), resized: (out_h, out_w, C) float32 in [0, 1]."""
    lib = load_lib()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.crop_resize_bilinear_u8(img_u8, h, w, c, x1, y1, size, size, out, out_h, out_w)
    return out


def bbox_mask(crop_size: int, bbox_in_crop, out_h: int, out_w: int) -> np.ndarray:
    """The box [x1, y1, x2, y2) of a ``crop_size`` crop drawn at the output
    size, nearest-neighbour: (out_h, out_w) float32 in {0, 1}."""
    lib = load_lib()
    out = np.empty((out_h, out_w), np.float32)
    bx1, by1, bx2, by2 = (float(v) for v in bbox_in_crop)
    lib.bbox_mask_resize(crop_size, bx1, by1, bx2, by2, out, out_h, out_w)
    return out


def resize_bilinear(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = load_lib()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.resize_bilinear_u8(img_u8, h, w, c, out, out_h, out_w)
    return out


def max_iou(box: np.ndarray, boxes: np.ndarray) -> Optional[float]:
    """The largest IoU of one xyxy box against (N, 4) boxes; None for N = 0."""
    if boxes.size == 0:
        return None
    lib = load_lib()
    box = np.ascontiguousarray(box, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    return float(lib.max_iou(box, boxes, boxes.shape[0]))


# -- region-of-interest JPEG decode (native/jpegdec.cpp) -------------------------


def load_jpeg_lib() -> Optional[ctypes.CDLL]:
    """The loaded ``libjpegdec``, or None where it cannot be built (no
    libjpeg header or library on this host)."""
    if "jpegdec" in _LIBS:
        return _LIBS["jpegdec"]
    try:
        lib = ctypes.CDLL(str(_build("jpegdec", (), ("-ljpeg",))))
    except (RuntimeError, OSError) as e:
        logging.info("native jpegdec not built (%s)", str(e).splitlines()[0])
        lib = None
    if lib is not None:
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i, ip = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.gdt_jpeg_dims.argtypes = [u8p, ctypes.c_long, ip, ip]
        lib.gdt_jpeg_dims.restype = i
        lib.gdt_jpeg_region.argtypes = [u8p, ctypes.c_long, i, i, i, i, u8p]
        lib.gdt_jpeg_region.restype = i
    _LIBS["jpegdec"] = lib
    return lib


def jpeg_dims(data: np.ndarray) -> Optional[tuple]:
    """(width, height) from an in-memory JPEG's header, or None."""
    lib = load_jpeg_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.gdt_jpeg_dims(data, data.size, ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def jpeg_region(data: np.ndarray, x1: int, y1: int, w: int, h: int) -> Optional[np.ndarray]:
    """The [x1, x1 + w) x [y1, y1 + h) window of an in-memory JPEG, (h, w, 3)
    uint8 with out-of-frame pixels 0; None if the library is absent or the
    stream does not decode here."""
    lib = load_jpeg_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.gdt_jpeg_region(data, data.size, x1, y1, w, h, out)
    return out if rc == 0 else None


def jpeg_region_file(path: str, x1: int, y1: int, w: int, h: int) -> Optional[np.ndarray]:
    if load_jpeg_lib() is None:
        return None
    try:
        data = np.fromfile(path, np.uint8)
    except OSError:
        return None
    return jpeg_region(data, x1, y1, w, h)
