"""JPEG decoding through the port's own decoder, equal to
``PIL.Image.open(f).convert("RGB")`` byte for byte, and ``read_image``.

The card has no PIL.  ``csrc/jpeg_decode.cpp`` (baseline sequential Huffman,
8-bit, one or three components, sampling factors 1 or 2, restart intervals;
libjpeg-turbo's integer IDCT, fancy upsampling and colour conversion) is
compiled at first use with the host C++ compiler into ``build/host/`` and
loaded with ``ctypes`` (``common/host_build.py``).  A progressive,
arithmetic-coded, 12-bit, CMYK or YCCK file raises ``NotImplementedError``
naming the mode; a truncated or corrupt one raises ``ValueError``.  Nothing
decodes a JPEG another way: without a compiler ``decode_jpeg`` raises.

``read_image`` reads a PNG (``datasets/png.py``) or a JPEG by its magic bytes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from myriad_tpu_torch.common import host_build
from myriad_tpu_torch.datasets.png import SIGNATURE as PNG_SIGNATURE
from myriad_tpu_torch.datasets.png import decode_png

SOURCE = host_build.PKG / "csrc" / "jpeg_decode.cpp"
JPEG_SOI = b"\xff\xd8"

_P = ctypes.c_void_p
_S = ctypes.c_size_t
_HOST = host_build.HostLibrary(SOURCE, "libmyriad_jpeg", {
    "myriad_jpeg_info": ([_P, _S, _P], ctypes.c_int),
    "myriad_jpeg_decode": ([_P, _S, _P, _S], ctypes.c_int),
    "myriad_jpeg_error": ([], ctypes.c_char_p),
})
build = _HOST.build  # compile once per source digest; returns the library's path
library = _HOST.library

# the decoder's error codes (csrc/jpeg_decode.cpp)
_UNSUPPORTED = 3


def _raise(code: int) -> None:
    msg = library().myriad_jpeg_error().decode()
    if code == _UNSUPPORTED:
        raise NotImplementedError(f"JPEG: {msg}")
    raise ValueError(f"JPEG: {msg}")


def decode_jpeg(data) -> np.ndarray:
    """A JPEG's bytes -> (H, W, 3) uint8 RGB, as ``Image.open(...).convert("RGB")``."""
    src = np.frombuffer(data, dtype=np.uint8)
    lib = library()
    info = np.zeros(3, np.int32)
    code = lib.myriad_jpeg_info(src.ctypes.data, src.size, info.ctypes.data)
    if code:
        _raise(code)
    width, height = int(info[0]), int(info[1])
    out = np.empty((height, width, 3), np.uint8)
    code = lib.myriad_jpeg_decode(src.ctypes.data, src.size, out.ctypes.data, out.nbytes)
    if code:
        _raise(code)
    return out


def decode_image(data: bytes) -> np.ndarray:
    """A PNG's or a JPEG's bytes -> (H, W, 3) uint8 RGB, by the magic bytes."""
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data)
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    raise NotImplementedError(f"only PNG and JPEG files are read; this one starts with "
                              f"{bytes(data[:8])!r}")


def read_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())
