"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Route: every source is compiled by ``nvcc`` for ``sm_90a`` into an object
file, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface that :mod:`ctypes` loads. No
PyTorch headers are included, so a build takes seconds, not minutes.

The library lands in ``build/kernels/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one is loaded as it is. :func:`ensure_built` builds at first
use, once per process, under a lock; it is never called at import time (the
CPU tests import every module and have no ``nvcc``). It also runs the
sources' init entry points once on each device a wrapper launches on: they
opt kernels in to more than 48 KB of dynamic shared memory and record K4's
persistent grid, work that must not happen inside a launch a CUDA graph
may be capturing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["ensure_built", "build_info", "current_stream", "FLOAT32",
           "BFLOAT16"]

#: dtype codes shared with csrc/common.cuh
FLOAT32 = 0
BFLOAT16 = 1

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_attention.cu", "flash_attention.cu", "lsdnn_layer.cu",
           "mamba_scan.cu")
HEADERS = ("common.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: device indices whose init entry points have run
_inited: set = set()
#: {"path", "seconds", "built", "ptxas"} of the library this process loaded
_info: dict = {}

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # dtype, q, pool, tables, lengths, out, B, H, KV, N, bs, hd, mb,
    # scale, stream
    "repro_paged_attention": (_i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                              _i, _i, _i, _f, _vp),
    # dtype, q, k, v, o, B, S, T, H, KV, hd, causal, scale, stream
    "repro_flash_attention": (_i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                              _i, _i, _f, _vp),
    # dtype, y, w, b, out, T, F, G, cap, stream
    "repro_lsdnn_layer": (_i, _vp, _vp, _vp, _vp, _i, _i, _i, _f, _vp),
    # dtype, dt, x, Bc, Cc, A, h0, y, hT, B, S, dI, N, stream
    "repro_mamba_scan": (_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                         _i, _i, _vp),
    # run on the current device, once per device, before any launch
    "repro_paged_attention_init": (),
    "repro_flash_attention_init": (),
    "repro_lsdnn_layer_init": (),
}
_INITS = ("repro_paged_attention_init", "repro_flash_attention_init",
          "repro_lsdnn_layer_init")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, link one library, move it into
    place atomically (a concurrent process may be building the same hash).
    Returns the compilers' diagnostics (ptxas register/smem report)."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, p in procs:
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{text}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib = tmp / LIB_NAME
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
           *[str(o) for _, o, _ in procs]]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                           f"{p.stdout}")
    log = "\n".join(logs)
    (tmp / "build.log").write_text(log)
    os.replace(tmp / "build.log", out.parent / "build.log")
    os.replace(lib, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return log


def ensure_built(device: Optional[int] = None) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, and run its init
    entry points on CUDA device ``device`` (default: the current one) if
    they have not run there; idempotent and thread-safe. Raises if ``nvcc``
    is missing, a source does not compile or an init fails: there is no
    fallback to the plain versions."""
    global _lib
    lib = _lib
    if lib is not None and device is not None and device in _inited:
        return lib
    with _lock:
        if _lib is None:
            _lib = _load()
        idx = torch.cuda.current_device() if device is None else device
        if idx not in _inited:
            with torch.cuda.device(idx):
                for name in _INITS:
                    check(getattr(_lib, name)(), name)
            _inited.add(idx)
        return _lib


def _load() -> ctypes.CDLL:
    t0 = time.perf_counter()
    out = BUILD_ROOT / _digest() / LIB_NAME
    built = False
    log = ""
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        log = _compile(out)
        built = True
    elif (out.parent / "build.log").exists():
        log = (out.parent / "build.log").read_text()
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _info.update(path=str(out), seconds=time.perf_counter() - t0,
                 built=built, ptxas=log)
    return lib


def current_stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device`` as the raw
    ``cudaStream_t`` the C entry points take (without building a Stream
    object: the wrappers call this on every launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device)
    return torch.cuda.current_stream(device).cuda_stream


def build_info() -> dict:
    """Where the loaded library lives, how long :func:`ensure_built` took
    and whether it compiled (empty before the first build)."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
