"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``build/kernels/`` beside the package (listed in ``.gitignore``).  The file
name carries a digest of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library.  Nothing here runs at import: the CPU
tests import every module, and only a CUDA tensor reaches ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "myriad_int8_matmul_splits": ([_I], _I),
    "myriad_int8_matmul": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "myriad_decode_attention": (
        [_P] * 7 + [_I] * 4 + [_L] * 6 + [_I, _F, _P], _I),
    "myriad_prefill_attention": (
        [_P] * 7 + [_I] * 5 + [_L] * 6 + [_I, _F, _P], _I),
    "myriad_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class LaunchCounter:
    """How many times a kernel wrapper launched its kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} with nvcc (set CUDA_HOME)")


def build() -> Path:
    """Compile csrc/*.cu into one library (once per source digest).  nvcc's
    output, with ptxas's register and shared-memory report, is kept beside
    it with the suffix ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libmyriad_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().myriad_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Wrapper input checks: raise on anything the kernel does not take."""
    if not cond:
        raise ValueError(what)
