"""ctypes bindings for the native IO hot paths (native/meteor_io.cc).

Auto-builds libmeteor_io.so with the system compiler on first use, and
rebuilds it when native/meteor_io.cc is newer than the library (the
reference's analogous code paths are C: wavfile.c:50-80, main.c:305-316);
every function has a numpy fallback so the framework works without a
toolchain. `available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmeteor_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _stale() -> bool:
    """True when the library is missing or older than its source, so what
    is loaded is always built from the committed native/meteor_io.cc."""
    src = os.path.join(_NATIVE_DIR, "meteor_io.cc")
    if not os.path.exists(_SO_PATH):
        return True
    return (os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_SO_PATH))


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if _stale() and os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR],
                               capture_output=True, timeout=60, check=True)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i8 = ctypes.POINTER(ctypes.c_int8)
        for name in ("meteor_decode_iq8", "meteor_decode_iq16",
                     "meteor_decode_iq32"):
            fn = getattr(lib, name)
            fn.argtypes = [p_u8, ctypes.c_size_t, p_f32]
            fn.restype = ctypes.c_size_t
        lib.meteor_quantize_soft.argtypes = [p_f32, p_f32, ctypes.c_size_t,
                                             p_i8]
        lib.meteor_quantize_soft.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_iq_f32(raw: bytes, bps: int) -> np.ndarray | None:
    """Interleaved I/Q bytes -> (n, 2) float32; None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    fn = {8: lib.meteor_decode_iq8, 16: lib.meteor_decode_iq16,
          32: lib.meteor_decode_iq32}.get(bps)
    if fn is None:
        return None
    nmax = len(raw) // (2 * bps // 8)
    out = np.empty((nmax, 2), dtype=np.float32)
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = fn(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:n]


def quantize_soft(re: np.ndarray, im: np.ndarray) -> np.ndarray | None:
    """Soft f32 components -> interleaved int8; None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    out = np.empty(2 * len(re), dtype=np.int8)
    lib.meteor_quantize_soft(
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(re), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out
