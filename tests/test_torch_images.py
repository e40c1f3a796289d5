"""The port's image path against PIL, on the CPU: the PNG decoder
(myriad_tpu_torch/datasets/png.py) against ``Image.open(p).convert("RGB")``,
and ``resize_bicubic`` + ``center_crop``
(myriad_tpu_torch/processors/functional.py) against the JAX package's PIL
helpers (myriad_tpu/processors/functional.py).  Tolerance 0: the bytes must
be PIL's.  The PNGs are written by the port's ``encode_png`` (zlib, every
filter type forced on every row, or a per-row mix) and by PIL itself.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from myriad_tpu.processors import functional as JF
from myriad_tpu_torch.datasets.png import decode_png, encode_png, read_png
from myriad_tpu_torch.processors import functional as F
import torch_threads  # noqa: F401  (one torch thread a test process)

COLOR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> channels


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _png(rng, height, width, color_type, filters, idat_chunks=1):
    pix = rng.integers(0, 256, (height, width, COLOR_TYPES[color_type]), dtype=np.uint8)
    palette = None
    if color_type == 3:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    if filters == "mix":
        filters = rng.integers(0, 5, height)
    return encode_png(pix, color_type, filters, palette=palette, idat_chunks=idat_chunks)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mix"])
@pytest.mark.parametrize("color_type", sorted(COLOR_TYPES))
@pytest.mark.parametrize("width", [1, 3, 224])
def test_png_decode_equals_pil(width, color_type, filters):
    rng = np.random.default_rng([width, color_type, 9 if filters == "mix" else filters])
    data = _png(rng, 6 if width < 224 else 37, width, color_type, filters, idat_chunks=3)
    got, ref = decode_png(data), _pil(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("color_type", [0, 2])
def test_png_decode_1024_equals_pil(color_type, tmp_path):
    """An MVTec-sized image, every row with its own filter, read from a file."""
    rng = np.random.default_rng(color_type)
    path = tmp_path / "big.png"
    path.write_bytes(_png(rng, 1024, 1024, color_type, "mix", idat_chunks=4))
    np.testing.assert_array_equal(read_png(str(path)), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P"])
def test_png_written_by_pil_equals_pil(mode):
    """PIL's own encoder (adaptive filters) on a smooth image plus noise."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:120, 0:161]
    rgba = np.stack([(xx * 3) % 256, (yy * 2) % 256, (xx + yy) % 256, (xx * yy) % 256], -1)
    rgba = (rgba + rng.integers(0, 8, rgba.shape)).astype(np.uint8)
    img = Image.fromarray(rgba, "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), _pil(buf.getvalue()))


def _with_header(data: bytes, depth: int, interlace: int) -> bytes:
    """``data`` with its IHDR's bit depth and interlace method replaced."""
    start = 8 + 8  # signature, then IHDR's length and type
    width, height, _, color, comp, filt, _ = struct.unpack(">IIBBBBB", data[start:start + 13])
    body = struct.pack(">IIBBBBB", width, height, depth, color, comp, filt, interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:start] + body + crc + data[start + 17:]


@pytest.mark.parametrize("case,match", [
    ("interlaced", "interlaced"),
    ("16-bit", "bit depth 16"),
    ("jpeg", "JPEG"),
])
def test_png_decode_refuses(case, match):
    rng = np.random.default_rng(0)
    data = _png(rng, 4, 4, 2, 0)
    if case == "interlaced":
        data = _with_header(data, 8, 1)
    elif case == "16-bit":
        data = _with_header(data, 16, 0)
    else:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(buf, "JPEG")
        data = buf.getvalue()
    with pytest.raises(NotImplementedError, match=match):
        decode_png(data)


def _jax_resize_crop(arr: np.ndarray, size: int) -> np.ndarray:
    return np.asarray(JF.center_crop(JF.resize_bicubic(Image.fromarray(arr), size), size))


@pytest.mark.parametrize("h,w,size", [
    (900, 900, 224), (1024, 1024, 224), (700, 1000, 224), (1000, 700, 224),
    (17, 17, 64), (17, 17, 224), (28, 28, 64), (28, 28, 224),
    (224, 224, 224), (28, 28, 28), (224, 300, 224),
    (5, 300, 7), (300, 5, 7), (1, 1, 3), (333, 334, 100),
])
def test_resize_and_crop_equal_pil(h, w, size):
    rng = np.random.default_rng(h * 7 + w)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = F.center_crop(F.resize_bicubic(arr, size), size)
    np.testing.assert_array_equal(got, _jax_resize_crop(arr, size))


def test_resize_and_crop_equal_pil_on_gray():
    """L-derived RGB, as MVTec's gray classes are read."""
    rng = np.random.default_rng(3)
    arr = np.asarray(Image.fromarray(rng.integers(0, 256, (1024, 1024), dtype=np.uint8),
                                     "L").convert("RGB"))
    np.testing.assert_array_equal(F.center_crop(F.resize_bicubic(arr, 224), 224),
                                  _jax_resize_crop(arr, 224))


@pytest.mark.parametrize("h,w,oh,ow", [(50, 60, 13, 97), (97, 13, 50, 60), (10, 10, 10, 3)])
def test_resize_to_a_shape_equals_pil(h, w, oh, ow):
    rng = np.random.default_rng(h + w)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        F.resize_bicubic(arr, (oh, ow)),
        np.asarray(JF.resize_bicubic(Image.fromarray(arr), (oh, ow))))


def test_center_crop_pads_with_black_as_pil():
    rng = np.random.default_rng(4)
    for h, w, size in ((5, 9, 8), (9, 5, 8), (3, 3, (7, 4)), (6, 6, 6)):
        arr = rng.integers(1, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(F.center_crop(arr, size),
                                      np.asarray(JF.center_crop(Image.fromarray(arr), size)))


@settings(max_examples=25, deadline=None, database=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), size=st.integers(1, 40),
       seed=st.integers(0, 2 ** 16))
def test_resize_and_crop_equal_pil_sampled(h, w, size, seed):
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got = F.center_crop(F.resize_bicubic(arr, size), size)
    np.testing.assert_array_equal(got, _jax_resize_crop(arr, size))


def test_normalisation_equals_the_jax_processor():
    from myriad_tpu.processors.blip_processors import LocImageTrainProcessor
    from myriad_tpu.processors.functional import CLIP_MEAN, CLIP_STD

    np.testing.assert_array_equal(F.CLIP_MEAN, CLIP_MEAN)
    np.testing.assert_array_equal(F.CLIP_STD, CLIP_STD)
    arr = np.random.default_rng(6).integers(0, 256, (28, 28, 3), dtype=np.uint8)
    ref = LocImageTrainProcessor(identity=True)({"img": arr})["img"]
    got = F.normalize(F.to_float_hwc(arr))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
