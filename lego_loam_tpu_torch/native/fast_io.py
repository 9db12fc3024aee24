"""ctypes bindings for the native host-IO library (``native/fast_io.cpp``):
a jax-free counterpart of ``lego_loam_tpu.native.fast_io``.

The library is built from the checkout's source with g++ at first use,
with native/Makefile's flags, into ``<repo>/build/native/`` (gitignored)
under a hash of the source and flags, as kernels/build.py builds the CUDA
kernels; the committed native/libfast_io.so, built elsewhere, is not
loaded.  Without a compiler, or if the build fails, :func:`available` is
False and the callers keep their NumPy paths (pad_scan_native falls back
itself; Prefetcher raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "fast_io.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_LIB = None
_TRIED = False
build_info: dict = {}


def build() -> Path:
    """Compile native/fast_io.cpp unless an identical build exists; returns
    the library's path.  Raises RuntimeError without g++ or on a failed
    build."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for native/fast_io.cpp")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libfast_io_{h.hexdigest()[:16]}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
        tmp.replace(out)
    build_info["path"] = str(out)
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        build_info["error"] = str(e)
        return None
    lib.kitti_read_bin.restype = ctypes.c_longlong
    lib.kitti_read_bin.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    lib.pad_scan.restype = ctypes.c_longlong
    lib.pad_scan.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong]
    lib.prefetcher_create.restype = ctypes.c_void_p
    lib.prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong, ctypes.c_longlong]
    lib.prefetcher_next.restype = ctypes.c_longlong
    lib.prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.prefetcher_destroy.restype = None
    lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library is built and loaded (builds it at first call)."""
    return _load() is not None


_MAX_PTS = 1 << 18  # 262144 points: far above any HDL-64E scan


def read_kitti_bin(path: str) -> np.ndarray:
    """(N, 4) float32 records of a KITTI .bin (a partial last record is
    dropped)."""
    lib = _load()
    if lib is None:
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    buf = np.empty((_MAX_PTS, 4), np.float32)
    n = lib.kitti_read_bin(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _MAX_PTS)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return buf[:n].copy()


def pad_scan_native(pts: np.ndarray, cap: int):
    """(N, 4|3) -> (cap, 3) xyz + (cap,) bool valid, non-finite points
    zeroed and marked invalid."""
    lib = _load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        xyz = np.zeros((cap, 3), np.float32)
        valid = np.zeros((cap,), bool)
        n = min(pts.shape[0], cap)
        ok = np.isfinite(pts[:n, :3]).all(axis=1)
        xyz[:n] = np.where(ok[:, None], pts[:n, :3], 0.0)
        valid[:n] = ok
        return xyz, valid
    xyz = np.empty((cap, 3), np.float32)
    valid_u8 = np.empty((cap,), np.uint8)
    lib.pad_scan(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        pts.shape[1], xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), cap)
    return xyz, valid_u8.astype(bool)


class Prefetcher:
    """Background-threaded KITTI sequence loader (native): yields each
    file's (N, 4) float32 records in order."""

    def __init__(self, paths: list[str], cap: int = _MAX_PTS):
        self._h = None
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library not built: {build_info.get('error')}")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.prefetcher_create(arr, len(paths), cap)
        self._buf = np.empty((cap, 4), np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        n = self._lib.prefetcher_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError("prefetcher read error")
        return self._buf[:n].copy()

    def close(self):
        if self._h:
            self._lib.prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
