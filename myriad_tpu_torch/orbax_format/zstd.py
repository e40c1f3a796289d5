"""Zstandard decoding for Orbax checkpoints, through the port's own decoder.

``csrc/zstd_decode.cpp`` (RFC 8878, written for this package) is compiled at
first use with the host C++ compiler (``$CXX``, else ``c++``) into
``build/host/`` beside the package, under a name that carries a digest of the
source and flags, and loaded with ``ctypes``.  Builds from several processes
take one file lock, so concurrent first uses compile once.  Without a
compiler ``library()`` raises and names it: nothing decodes zstd another way.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "zstd_decode.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P = ctypes.c_void_p
_S = ctypes.c_size_t
_SIGNATURES = {
    "myriad_zstd_decompress": ([_P, _S, _P, _S], ctypes.c_longlong),
    "myriad_zstd_bound": ([_P, _S], ctypes.c_longlong),
    "myriad_zstd_error": ([], ctypes.c_char_p),
    "myriad_xxh64": ([_P, _S, ctypes.c_ulonglong], ctypes.c_ulonglong),
    "myriad_crc32c": ([_P, _S], ctypes.c_uint),
}
# the decoder's error codes (csrc/zstd_decode.cpp)
_DICTIONARY = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """A frame that is truncated, corrupt or fails its checksum."""


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` on the PATH."""
    name = os.environ.get("CXX") or "c++"
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"the zstd decoder is built from {SOURCE} with a host C++ compiler, "
                           f"and {name!r} was not found (set CXX)")
    return path


def build() -> Path:
    """Compile the decoder once per source digest; returns the library."""
    cxx = compiler()
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libmyriad_zstd-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "zstd.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # another process may have built it meanwhile
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{cxx} failed on {SOURCE.name} ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
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


def _raise(code: int) -> None:
    msg = library().myriad_zstd_error().decode()
    if code == _DICTIONARY:
        raise NotImplementedError(f"zstd: {msg}; dictionaries are not supported")
    raise ZstdError(f"zstd: {msg}")


def _as_u8(data) -> np.ndarray:
    a = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if a.dtype != np.uint8 or a.ndim != 1 or not a.flags.c_contiguous:
        raise TypeError("zstd input: a contiguous 1-D uint8 buffer")
    return a


def decompress(data, size: Optional[int] = None, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode every frame of ``data`` (bytes-like or a uint8 array) into a
    uint8 array.  ``size``, when given, is the exact decoded size (a zarr
    chunk's bytes) and anything else raises; ``out`` is a caller's buffer of
    at least that size, written in place (the returned array is a view of
    it).  Without ``size`` the frames' headers bound the buffer."""
    src = _as_u8(data)
    lib = library()
    if size is None:
        size = lib.myriad_zstd_bound(src.ctypes.data, src.size)
        if size < 0:
            _raise(-size)
        exact = False
    else:
        exact = True
    if out is None:
        out = np.empty(size, dtype=np.uint8)
    elif out.dtype != np.uint8 or not out.flags.c_contiguous or out.size < size:
        raise ValueError(f"zstd output buffer: {size} contiguous uint8 bytes needed")
    n = lib.myriad_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, size)
    if n < 0:
        _raise(-n)
    if exact and n != size:
        raise ZstdError(f"zstd: decoded {n} bytes where {size} were expected")
    return out[:n]


def xxh64(data, seed: int = 0) -> int:
    src = _as_u8(data)
    return int(library().myriad_xxh64(src.ctypes.data, src.size, seed))


def crc32c(data) -> int:
    src = _as_u8(data)
    return int(library().myriad_crc32c(src.ctypes.data, src.size))
