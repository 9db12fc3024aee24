"""Build and bind the hand-written CUDA kernels (``lego_loam_tpu_torch/csrc``).

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, at first use, into
``<repo>/build/kernels/`` (gitignored).  The file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing library.  The library is loaded with ctypes; every pointer and
the CUDA stream cross as ``c_void_p`` (a bare Python int would be cut to 32
bits).  Each C entry returns ``cudaGetLastError()`` and :func:`check`
raises if it is not 0.

Nothing here touches CUDA at import time: the CPU tests import every
module, and only a call that launches a kernel builds or loads anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # labels0, conn_left, conn_right, conn_up, conn_down, out, R, H, stream
    "lego_label_prop": [_P] * 6 + [_I] * 2 + [_P],
    "lego_label_prop_grid": [_I, _I],       # R, H -> blocks of one launch
    "lego_label_prop_max_blocks": [],       # -> blocks the device holds at once
    # curv, corner_base, surf_base, picked0, reach_l, reach_r, sp, ep, ok,
    # labels, picked, R, W, S, n_corner, n_sharp, n_surf, stream
    "lego_pick_features": [_P] * 11 + [_I] * 6 + [_P],
    # query, ref, ref_valid, Q, N, k, S, scratch, idx, d2, stream
    "lego_knn": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless an identical build
    exists; returns its path.  Fills ``build_info`` (seconds, log)."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"liblego_kernels_{h.hexdigest()[:16]}.so"
    if out.is_file():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    tmp.replace(out)
    build_info.update(path=str(out), seconds=seconds,
                      log=proc.stdout + proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype/shape on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
