"""Zstandard decoding for Orbax checkpoints, through the port's own decoder.

``csrc/zstd_decode.cpp`` (RFC 8878, written for this package) is compiled at
first use with the host C++ compiler into ``build/host/`` and loaded with
``ctypes`` (``common/host_build.py``).  Without a compiler ``library()``
raises and names it: nothing decodes zstd another way.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from myriad_tpu_torch.common import host_build
from myriad_tpu_torch.common.host_build import compiler  # noqa: F401  (chip_smoke prints it)

SOURCE = host_build.PKG / "csrc" / "zstd_decode.cpp"

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

_HOST = host_build.HostLibrary(SOURCE, "libmyriad_zstd", _SIGNATURES)
build = _HOST.build  # compile once per source digest; returns the library's path
library = _HOST.library


class ZstdError(ValueError):
    """A frame that is truncated, corrupt or fails its checksum."""


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
