"""``ctypes`` binding of the native C++ image loader ``native/loader.cc``
(counterpart of ``tpu_unet/data/native.py``): multithreaded JPEG/PNG decode
and PIL-compatible bicubic letterbox straight into the batch buffer.

The library is built from the source at first use, never at import: ``g++``
with the flags and link libraries of ``native/Makefile`` into
``build/libtpuunet_loader_<hash>.so``, keyed by a hash of the source, the
flags and the host CPU's ``-march=native`` target, so a library built on
another machine is never loaded.  The prebuilt ``native/*.so`` is not used
and nothing is written into ``native/``.  Where the library cannot be
built (no ``g++``, no libjpeg or libpng headers), every entry point takes
the PIL path, with identical bytes, as the JAX package does
(``native.py:77-87``); :func:`route` says which path runs and why.  This is
host decoding: no kernel and no device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "loader.cc"
BUILD = ROOT / "build"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
LDLIBS = ["-ljpeg", "-lpng", "-lpthread"]

_lock = threading.Lock()
_lib = None
_why_not = None  # why the library is unavailable, once a build failed


def _cxx():
    return shutil.which("g++")


def _target(cxx: str) -> bytes:
    """What ``-march=native`` means on this host, as the compiler expands it."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, timeout=60)
    return out.stdout


def _build() -> Path:
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(_target(cxx))
    out = BUILD / f"libtpuunet_loader_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        tmp_so = Path(tmp) / out.name
        res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp_so),
                              str(SOURCE), *LDLIBS], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"g++ failed: {res.stderr.strip()[-400:]}")
        os.replace(tmp_so, out)
    return out


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.dl_load_letterbox_batch.restype = ctypes.c_int
    lib.dl_load_letterbox_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.dl_resize_bicubic.restype = None
    lib.dl_resize_bicubic.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    return lib


def get_lib():
    """The loaded library (built on first call), or None where it cannot
    be built; :func:`route` then says why."""
    global _lib, _why_not
    with _lock:
        if _lib is None and _why_not is None:
            try:
                _lib = _bind(_build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _why_not = str(e)
    return _lib


def available() -> bool:
    return get_lib() is not None


def route() -> str:
    """``"native"``, or ``"PIL (<why the library is unavailable>)"``."""
    return "native" if available() else f"PIL ({_why_not})"


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_letterbox_batch(paths: Sequence[str], out_h: int, out_w: int,
                         n_threads: int = 8):
    """Decode and letterbox a batch: (uint8 (N, H, W, 3), nws, nhs), the
    content sizes for cropping the gray bars.  Raises ``RuntimeError`` when
    an image fails to decode; takes the PIL path when the library is
    unavailable."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    nws = np.empty(n, np.int32)
    nhs = np.empty(n, np.int32)
    if lib is None:
        from PIL import Image

        from tpu_unet_torch.data.transforms import cvt_rgb, letterbox_image

        for i, p in enumerate(paths):
            boxed, nw, nh = letterbox_image(cvt_rgb(Image.open(p)), (out_h, out_w))
            out[i] = np.asarray(boxed, np.uint8)
            nws[i], nhs[i] = nw, nh
        return out, nws, nhs
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.dl_load_letterbox_batch(
        arr, n, out_h, out_w, _ptr(out, ctypes.c_uint8), _ptr(nws, ctypes.c_int),
        _ptr(nhs, ctypes.c_int), n_threads)
    if failures:
        raise RuntimeError(f"{failures}/{n} images failed to decode")
    return out, nws, nhs


def resize_bicubic(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """PIL-compatible bicubic resize of an (H, W, 3) uint8 array."""
    lib = get_lib()
    if lib is None:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BICUBIC))
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or min(nh, nw) < 1:
        raise ValueError(f"resize_bicubic: (H, W, 3) uint8 to a positive size, got "
                         f"{img.shape} to {(nh, nw)}")
    out = np.empty((nh, nw, 3), np.uint8)
    lib.dl_resize_bicubic(_ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
                          _ptr(out, ctypes.c_uint8), nh, nw)
    return out
