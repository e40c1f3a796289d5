"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library with a
plain C interface, at first use, into ``build/kernels/`` beside the package
(listed in ``.gitignore``).  The file
name carries a digest of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library.  Nothing here runs at import: the CPU
tests import every module, and only a CUDA tensor reaches ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
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
# no -use_fast_math: kernel B4's quantization is bit-exact with the plain
# version only with IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "myriad_int8_matmul": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "myriad_int8_matmul_f32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "myriad_int8_matmul_launch_info": ([_I] * 3 + [_P], _I),
    "myriad_int4_matmul": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "myriad_int4_matmul_f32": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "myriad_int4_matmul_launch_info": ([_I] * 5 + [_P], _I),
    "myriad_decode_attention": (
        [_P] * 7 + [_I] * 4 + [_L] * 6 + [_I, _F, _P], _I),
    "myriad_decode_attention_launch_info": ([_I] * 4 + [_P], _I),
    "myriad_decode_attention_rows_scratch": ([_I] * 4, _L),
    "myriad_decode_attention_rows": (
        [_P] * 7 + [_I] * 4 + [_L] * 6 + [_I, _F, _P, _P], _I),
    "myriad_prefill_attention_scratch": ([_I] * 5, _L),
    "myriad_prefill_attention": (
        [_P] * 7 + [_I] * 5 + [_L] * 6 + [_I, _F, _P, _P], _I),
    "myriad_kv_write": ([_P] * 3 + [_I] * 7 + [_L] * 5 + [_P], _I),
    "myriad_kv_quantize_write": ([_P] * 7 + [_I] * 6 + [_L] * 5 + [_P], _I),
    "myriad_u8_normalize": ([_P, _P, _L, _F, _F, _F, _F, _F, _F, _I, _P], _I),
    "myriad_stream_sum": ([_P, _P, _P, _P, _L, _L, _F, _I, _P], _I),
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
    """Compile csrc/*.cu into one library (once per source digest): one
    ``nvcc -c`` per source, started together, then one link.  nvcc's output,
    with ptxas's register and shared-memory report, is kept beside the
    library with the suffix ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libmyriad_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    try:
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            logs.append(f"== {src.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    finally:
        for proc in procs:
            proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=256)
def scratch_floats(entry: str, *widths: int) -> int:
    """Floats of scratch a kernel's C entry point asks for at these widths
    (cached: a decode loop asks for the same widths every step)."""
    return getattr(library(), entry)(*widths)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().myriad_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """The handle of PyTorch's current stream on ``device`` (a tensor's
    device, which carries its index), read without building a
    ``torch.cuda.Stream``: a decode step asks for it at every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def require(cond: bool, what: str) -> None:
    """Wrapper input checks: raise on anything the kernel does not take."""
    if not cond:
        raise ValueError(what)
