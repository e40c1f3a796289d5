"""PNG reading on ``zlib`` and numpy, equal to ``PIL.Image.open(p).convert("RGB")``
byte for byte, and a PNG writer for synthetic data.

The card has no PIL.  ``decode_png`` takes 8-bit, non-interlaced PNGs of
colour type 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA)
with any mix of the five row filters, and returns HWC uint8 RGB: gray is
replicated and alpha dropped, as ``convert("RGB")`` does.  Interlaced
(Adam7) input, other bit depths and non-PNG input (a JPEG, say) raise
``NotImplementedError``.

Average and Paeth rows depend on the pixel to their left, so a row cannot be
reconstructed in one vectorised step.  The decoder reconstructs every row at
once along anti-diagonals instead: pixel x of row y is done at step x + y,
when its left, upper and upper-left neighbours are done, each row with its
own filter's predictor.  That is W + H - 1 numpy steps an image, over a
skewed copy in which each diagonal is a contiguous slice.

``decode_png_gray`` gives the one-channel image that
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives (precomputed anomaly masks).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> bytes a pixel at 8 bits


def _not_png(data: bytes) -> NotImplementedError:
    kind = "a JPEG" if data.startswith(b"\xff\xd8\xff") else "not a PNG"
    return NotImplementedError(f"only PNG files are read; this one starts with "
                               f"{data[:8]!r} ({kind})")


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _paeth(a, b, c):
    """PNG's Paeth predictor: of a, b and c the nearest to a + b - c."""
    d_b, d_a = b - c, a - c
    pa, pb, pc = np.abs(d_b), np.abs(d_a), np.abs(d_a + d_b)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """(H, 1 + W * bpp) filtered scanlines -> (H, W, bpp) uint8 pixels."""
    height = rows.shape[0]
    kinds = rows[:, 0]
    if kinds.size and int(kinds.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    filt = rows[:, 1:].reshape(height, width, bpp)
    if not np.isin(kinds, (3, 4)).any():
        # None, Sub and Up rows vectorise over the row
        out = np.empty_like(filt)
        prev = np.zeros((width, bpp), np.uint8)
        for y in range(height):
            kind = kinds[y]
            if kind == 0:
                prev = filt[y]
            elif kind == 1:
                prev = np.cumsum(filt[y], axis=0, dtype=np.uint8)
            else:
                prev = filt[y] + prev
            out[y] = prev
        return out
    # anti-diagonals: recon[y, x] lives at skew[x + y + 2, y + 1]; the first
    # two diagonals and row 0 stay zero (PNG's neighbours outside the image)
    steps = width + height - 1
    ys = np.arange(height)[:, None]
    xs = np.arange(width)[None, :]
    fskew = np.zeros((steps, height, bpp), np.int16)
    fskew[xs + ys, ys] = filt
    skew = np.zeros((steps + 2, height + 1, bpp), np.int16)
    # each row's predictor as 0/1 weights of left, up, average and Paeth
    # (masks are cheaper than np.choose per step)
    m_a, m_b, m_avg, m_paeth = ((kinds == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4))
    n_avg = np.concatenate([[0], np.cumsum(m_avg)])
    n_paeth = np.concatenate([[0], np.cumsum(m_paeth)])
    for s in range(steps):
        lo, hi = max(0, s - width + 1), min(height, s + 1)
        a = skew[s + 1, lo + 1:hi + 1]  # left: recon[y, x - 1]
        b = skew[s + 1, lo:hi]  # up: recon[y - 1, x]
        pred = a * m_a[lo:hi] + b * m_b[lo:hi]
        if n_avg[hi] > n_avg[lo]:
            pred += ((a + b) >> 1) * m_avg[lo:hi]
        if n_paeth[hi] > n_paeth[lo]:
            c = skew[s, lo:hi]  # up-left: recon[y - 1, x - 1]
            pred += _paeth(a, b, c) * m_paeth[lo:hi]
        pred += fskew[s, lo:hi]
        np.bitwise_and(pred, 0xFF, out=skew[s + 2, lo + 1:hi + 1])
    return skew[xs + ys + 2, ys + 1].astype(np.uint8)


def _decode(data: bytes):
    """PNG bytes -> (pixels (H, W, channels) uint8, colour type, palette)."""
    if not data.startswith(SIGNATURE):
        raise _not_png(data)
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
            width, height, depth, color, _, _, interlace = header
            if depth != 8:
                raise NotImplementedError(f"PNG bit depth {depth}: only 8-bit PNGs are read")
            if interlace:
                raise NotImplementedError("interlaced (Adam7) PNG: only non-interlaced PNGs "
                                          "are read")
            if color not in CHANNELS:
                raise ValueError(f"unknown PNG colour type {color}")
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind[0:1].isupper() and kind != b"IEND":
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    bpp = CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (1 + width * bpp):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=height * (1 + width * bpp))
    return _unfilter(rows.reshape(height, 1 + width * bpp), width, bpp), color, palette


def _rgb(pix: np.ndarray, color: int, palette) -> np.ndarray:
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        return table[pix[..., 0]]
    return np.ascontiguousarray(pix[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as ``Image.open(...).convert("RGB")``."""
    return _rgb(*_decode(data))


def decode_png_gray(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8, as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
    reads a file: gray as stored (alpha dropped); colour (RGB, RGBA, a
    palette's colours) by libpng's ``png_set_rgb_to_gray`` with OpenCV's
    weights, 0.299 and 0.587 in 15-bit fixed point (9797, 19234, and 3737 for
    blue), the sum truncated, and a pixel whose three channels are equal kept
    as it is."""
    pix, color, palette = _decode(data)
    if color in (0, 4):
        return np.ascontiguousarray(pix[..., 0])
    rgb = _rgb(pix, color, palette).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    gray = (r * 9797 + g * 19234 + b * 3737) >> 15
    return np.where((r == g) & (g == b), r, gray).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_png_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_gray(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(pixels: np.ndarray, color_type: Optional[int] = None,
               filters: Union[int, Sequence[int]] = 4, palette: Optional[np.ndarray] = None,
               idat_chunks: int = 1, level: int = 6) -> bytes:
    """uint8 (H, W) or (H, W, C) -> 8-bit PNG bytes, row y filtered with
    ``filters[y]`` (or one filter type for every row), the compressed stream
    split over ``idat_chunks`` IDAT chunks.  ``color_type`` defaults to gray,
    gray + alpha, RGB or RGBA by the channel count; type 3 takes (H, W)
    indices into ``palette`` ((N, 3) uint8)."""
    pix = np.asarray(pixels, np.uint8)
    if pix.ndim == 2:
        pix = pix[..., None]
    height, width, channels = pix.shape
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    if CHANNELS[color_type] != channels:
        raise ValueError(f"colour type {color_type} takes {CHANNELS[color_type]} channels, "
                         f"got {channels}")
    kinds = np.broadcast_to(np.asarray(filters, np.uint8), (height,))
    x = pix.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    filt = ((x - preds[kinds, np.arange(height)]) & 0xFF).astype(np.uint8)
    rows = np.concatenate([kinds[:, None], filt.reshape(height, -1)], axis=1)
    stream = zlib.compress(rows.tobytes(), level)
    step = -(-len(stream) // max(1, idat_chunks))
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color_type,
                                                  0, 0, 0))]
    if color_type == 3:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [_chunk(b"IDAT", stream[i:i + step]) for i in range(0, len(stream), step)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)
