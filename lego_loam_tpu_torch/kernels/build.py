"""Build and bind the hand-written CUDA kernels (``lego_loam_tpu_torch/csrc``).

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (one
process a source, in parallel) and linked into ONE shared library with a
plain C interface, at first use, into ``<repo>/build/kernels/``
(gitignored).  The file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing library.  The library is loaded with ctypes; every pointer and
the CUDA stream cross as ``c_void_p`` (a bare Python int would be cut to 32
bits).  Each C entry returns ``cudaGetLastError()`` and :func:`check`
raises if it is not 0.

Nothing here touches CUDA at import time: the CPU tests import every
module, and only a call that launches a kernel builds or loads anything.

Each kernel is also a ``torch.library.custom_op`` (namespace ``lego``,
defined beside its wrapper in the ops modules), so that
``torch.func.vmap`` sees it: the vmapped batch of a sequence fleet
(models/batch.py) reaches the op's vmap rule, which moves the batch to the
front with :func:`batch_front` and calls the op once on the whole batch --
on the card one launch for all B, on the CPU the plain version once per
batch element (:func:`per_element`).
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
    # labels0, conn_left, conn_right, conn_up, conn_down, out, R, H, B, stream
    "lego_label_prop": [_P] * 6 + [_I] * 3 + [_P],
    "lego_label_prop_grid": [_I, _I],       # R, H -> blocks of one launch
    "lego_label_prop_max_blocks": [],       # -> blocks the device holds at once
    # rng, valid, col, ground, count, labels, picked, R, W, &params, stream
    "lego_label_features": [_P] * 7 + [_I] * 2 + [_P] * 2,
    # query, ref, ref_valid, B, Q, N, k, S, scratch, idx, d2, stream
    "lego_knn": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # H, thresh, P, lam, sweeps, B, n, stream
    "lego_eig6": [_P, ctypes.c_float, _P, _P, _P, _I, _I, _P],
    # query, ref, ref_valid, ref_ring, query_ground, ref_ground, B, Q, N,
    # n_same, n_adj, split, idx, d2, stream
    "lego_odom_assoc": [_P] * 6 + [_I] * 6 + [_P] * 3,
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
    exists; returns its path.  One nvcc process a source, all started
    together, then one link.  Fills ``build_info`` (seconds, log)."""
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
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} ({p.returncode}):\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        tmp.replace(out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="".join(logs) + link.stdout + link.stderr)
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


def batch_front(info, in_dims, *args):
    """The arguments of a custom op's vmap rule with the vmapped dimension
    in front: a batched tensor moved there, an unbatched one expanded (a
    view), anything else as it is."""
    out = []
    for a, d in zip(args, in_dims):
        if not isinstance(a, torch.Tensor):
            out.append(a)
        elif d is None:
            out.append(a.expand(info.batch_size, *a.shape))
        else:
            out.append(a.movedim(d, 0))
    return out


def per_element(fn, n_lead: int, *args):
    """fn over the leading batch dimensions of its tensor arguments, one
    element at a time, outputs stacked: the plain version of a custom op
    on a batch.  `n_lead` is the number of leading batch dimensions; a
    call without any is fn itself."""
    if n_lead == 0:
        return fn(*args)
    lead = next(a for a in args if isinstance(a, torch.Tensor)).shape[:n_lead]
    flat = [a.reshape((-1,) + a.shape[n_lead:]) if isinstance(a, torch.Tensor)
            else a for a in args]
    outs = [fn(*(a[i] if isinstance(a, torch.Tensor) else a for a in flat))
            for i in range(lead.numel())]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o).reshape(lead + o[0].shape)
                     for o in zip(*outs))
    return torch.stack(outs).reshape(lead + outs[0].shape)
