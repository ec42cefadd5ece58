"""ctypes loader for the native C++ runtime library (``gvr_native.cpp``).

The reference is a pure native program; here the *compute* path is JAX/XLA,
while host-side runtime work — PPM codec, GIF encoding, scene parsing — has
a C++ implementation for speed, with pure Python fallbacks so nothing
hard-depends on the toolchain.

``lib()`` builds the shared object at first use (``native/build.py``, into
the gitignored ``build/native/``) and caches a handle; it returns None when
no C++ toolchain is available or the library fails to load.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from gvr.native.build import SO_PATH as _SO_PATH, build as _build

_cached = None
_failed = False


class NativeLib:
    def __init__(self, cdll):
        self._lib = cdll
        self._lib.gvr_read_ppm.restype = ctypes.c_int
        self._lib.gvr_read_ppm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        self._lib.gvr_read_ppm_data.restype = ctypes.c_int
        self._lib.gvr_read_ppm_data.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        self._lib.gvr_write_ppm.restype = ctypes.c_int
        self._lib.gvr_write_ppm.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int]
        self._lib.gvr_gif_begin.restype = ctypes.c_void_p
        self._lib.gvr_gif_begin.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        self._lib.gvr_gif_frame.restype = ctypes.c_int
        self._lib.gvr_gif_frame.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
        if hasattr(self._lib, "gvr_gif_frame_indexed"):
            self._lib.gvr_gif_frame_indexed.restype = ctypes.c_int
            self._lib.gvr_gif_frame_indexed.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_ubyte)]
        self._lib.gvr_gif_end.restype = ctypes.c_int
        self._lib.gvr_gif_end.argtypes = [ctypes.c_void_p]
        self._lib.gvr_parse_scene.restype = ctypes.c_int
        self._lib.gvr_parse_scene.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # gaussians out
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # spheres out
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # lights out
            ctypes.POINTER(ctypes.c_int)]                   # counts [3]

    # ---- PPM ----------------------------------------------------------------
    def read_ppm(self, path: str) -> Optional[np.ndarray]:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if self._lib.gvr_read_ppm(path.encode(), ctypes.byref(w),
                                  ctypes.byref(h)) != 0:
            return None
        out = np.empty((h.value, w.value, 3), np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.gvr_read_ppm_data(path.encode(), ptr, out.size) != 0:
            return None
        return out

    def write_ppm(self, path: str, rgb_u8: np.ndarray) -> bool:
        h, w = rgb_u8.shape[:2]
        buf = np.ascontiguousarray(rgb_u8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        return self._lib.gvr_write_ppm(path.encode(), ptr, w, h) == 0

    # ---- GIF ----------------------------------------------------------------
    def gif_begin(self, path: str, width: int, height: int, delay_cs: int):
        return self._lib.gvr_gif_begin(path.encode(), width, height, delay_cs)

    def gif_frame(self, handle, rgba_u8: np.ndarray) -> bool:
        buf = np.ascontiguousarray(rgba_u8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        return self._lib.gvr_gif_frame(handle, ptr) == 0

    @property
    def has_indexed_gif(self) -> bool:
        return hasattr(self._lib, "gvr_gif_frame_indexed")

    def gif_frame_indexed(self, handle, idx_u8: np.ndarray,
                          pal_u8: np.ndarray) -> bool:
        """Adaptive-palette frame: 8-bit palette indices + a [256,3] local
        color table (see io/gif.adaptive_palette)."""
        if not hasattr(self._lib, "gvr_gif_frame_indexed"):
            raise AttributeError("native lib predates gif_frame_indexed; "
                                 "rebuild with python -m gvr.native.build")
        idx = np.ascontiguousarray(idx_u8, np.uint8)
        pal = np.ascontiguousarray(pal_u8, np.uint8)
        return self._lib.gvr_gif_frame_indexed(
            handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            pal.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))) == 0

    def gif_end(self, handle) -> bool:
        return self._lib.gvr_gif_end(handle) == 0

    # ---- scene parsing -------------------------------------------------------
    def parse_scene(self, path: str, max_prims: int = 1 << 21,
                    max_lights: int = 4096):
        """Returns (gauss [Ng,14], spheres [Ns,6], lights [Nl,6]) float32."""
        g = np.empty((max_prims, 14), np.float32)
        s = np.empty((max_lights, 6), np.float32)
        l = np.empty((max_lights, 6), np.float32)
        counts = (ctypes.c_int * 3)()
        rc = self._lib.gvr_parse_scene(
            path.encode(),
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_prims,
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_lights,
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_lights,
            counts)
        if rc != 0:
            return None
        ng, ns, nl = counts[0], counts[1], counts[2]
        return g[:ng].copy(), s[:ns].copy(), l[:nl].copy()


def lib() -> Optional[NativeLib]:
    global _cached, _failed
    if _cached is not None:
        return _cached
    if _failed:
        return None
    try:
        if not os.path.exists(_SO_PATH):
            _build(verbose=False)
        _cached = NativeLib(ctypes.CDLL(_SO_PATH))
    except (OSError, subprocess.SubprocessError):
        _failed = True
        return None
    return _cached
