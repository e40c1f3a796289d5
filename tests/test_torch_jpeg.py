"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through
``myriad_tpu_torch.datasets.jpeg``) against Pillow over libjpeg-turbo, at
tolerance 0: every decoded byte equal to ``Image.open(f).convert("RGB")``.

Cases: qualities 50/75/95/100 at 4:4:4, 4:2:2 and 4:2:0, grayscale,
``optimize=True`` tables, restart markers, sizes 1x1, 17x9, 9x17 and
333x251, noise and smooth content; the committed fixture against its
``expected.json`` (and regenerated from its seed); progressive,
arithmetic-coded, 12-bit and CMYK files raise ``NotImplementedError``;
truncated streams, structural corruption and the Huffman tables libjpeg
rejects (over-subscribed lengths, an all-ones code) raise ``ValueError``,
and a bit flip in the scan or in any header segment either raises or is a
valid stream decoded as Pillow decodes it (JPEG carries no checksum: a flip
inside a coefficient's magnitude bits is another valid image).  ``read_image`` reads PNG and JPEG.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageFile

from myriad_tpu_torch.datasets import jpeg
from myriad_tpu_torch.datasets.png import encode_png
import torch_threads  # noqa: F401  (one torch thread a test process)

ImageFile.MAXBLOCK = 1 << 24  # optimize=True writes the whole scan in one buffer
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_fixture")


def _pixels(w, h, seed, smooth=True):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, ((xx + yy) * 2) % 256], -1)
    return np.clip(a + rng.normal(0, 30, a.shape), 0, 255).astype(np.uint8)


def _jpeg(arr, gray=False, **kw):
    im = Image.fromarray(arr)
    if gray:
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _same(data):
    got, ref = jpeg.decode_jpeg(data), _pil(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (9, 17), (333, 251)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_equals_pil(quality, subsampling, size):
    for smooth in (True, False):
        arr = _pixels(*size, seed=quality + subsampling, smooth=smooth)
        _same(_jpeg(arr, quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (17, 9), (333, 251), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grayscale_optimize_and_restarts_equal_pil(size):
    arr = _pixels(*size, seed=7)
    _same(_jpeg(arr, gray=True, quality=90))
    _same(_jpeg(arr, gray=True, quality=60, optimize=True))
    for subsampling in (0, 1, 2):
        _same(_jpeg(arr, quality=85, subsampling=subsampling, optimize=True))
        _same(_jpeg(arr, quality=80, subsampling=subsampling, restart_marker_blocks=1))
        _same(_jpeg(arr, quality=70, subsampling=subsampling, restart_marker_blocks=5,
                    optimize=True))
    _same(_jpeg(arr, gray=True, quality=75, restart_marker_blocks=2))


def _expected():
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        return json.load(f)


def test_committed_fixture_matches_expected():
    expected = _expected()
    assert len(expected["images"]) >= 12
    for name, rec in expected["images"].items():
        got = jpeg.read_image(os.path.join(FIXTURE, name))
        assert list(got.shape) == rec["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name


def test_committed_fixture_regenerates_from_its_seed():
    import make_jpeg_fixture as mk

    out = mk.build(_expected()["seed"])
    assert out["expected"]["images"] == _expected()["images"]
    for name, data in out["files"].items():
        with open(os.path.join(FIXTURE, name), "rb") as f:
            assert f.read() == data, name


def _sof_patched(data, marker=None, precision=None):
    b = bytearray(data)
    at = data.index(b"\xff\xc0")
    if marker is not None:
        b[at + 1] = marker
    if precision is not None:
        b[at + 4] = precision
    return bytes(b)


@pytest.mark.parametrize("case,match", [
    ("progressive", "progressive"),
    ("arithmetic", "arithmetic"),
    ("12-bit", "12-bit"),
    ("cmyk", "CMYK"),
    ("lossless", "lossless"),
])
def test_unsupported_modes_raise_naming_the_mode(case, match):
    arr = _pixels(37, 45, seed=1)
    base = _jpeg(arr, quality=90)
    if case == "progressive":
        data = _jpeg(arr, quality=90, progressive=True)
    elif case == "arithmetic":
        data = _sof_patched(base, marker=0xC9)
    elif case == "12-bit":
        data = _sof_patched(base, precision=12)
    elif case == "lossless":
        data = _sof_patched(base, marker=0xC3)
    else:
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    with pytest.raises(NotImplementedError, match=match):
        jpeg.decode_jpeg(data)


def test_truncated_streams_raise():
    data = _jpeg(_pixels(45, 37, seed=2), quality=90, restart_marker_blocks=2)
    cuts = list(range(0, len(data) - 1, 5)) + [len(data) - 2, len(data) - 1]
    for cut in cuts:
        with pytest.raises(ValueError):
            jpeg.decode_jpeg(data[:cut])


@pytest.mark.parametrize("case", ["misnumbered RST", "byte inserted in the scan",
                                  "byte dropped from the scan", "no SOI",
                                  "scan names a missing component",
                                  "frame larger than the file can hold"])
def test_structural_corruption_raises(case):
    data = _jpeg(_pixels(45, 37, seed=3), quality=90, restart_marker_blocks=2)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    rst = data.index(b"\xff\xd0", start)
    sof = data.index(b"\xff\xc0")
    bad = {
        "misnumbered RST": lambda: data[:rst + 1] + b"\xd3" + data[rst + 2:],
        "byte inserted in the scan": lambda: data[:start + 40] + b"\x5a" + data[start + 40:],
        "byte dropped from the scan": lambda: data[:start + 40] + data[start + 41:],
        "no SOI": lambda: data[2:],
        "scan names a missing component": lambda: data[:sos + 5] + b"\x09" + data[sos + 6:],
        "frame larger than the file can hold": lambda: (
            data[:sof + 5] + (60000).to_bytes(2, "big") + (2900).to_bytes(2, "big")
            + data[sof + 9:]),
    }[case]()
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(bad)


def _segments(data, marker):
    """Offsets of the 0xFF of each ``marker`` segment before the first scan's data."""
    out, at = [], 2
    while at < len(data):
        m = data[at + 1]
        if m == marker:
            out.append(at)
        if m == 0xDA:
            return out
        at += 2 + int.from_bytes(data[at + 2:at + 4], "big")
    return out


def _with_first_table(data, counts, vals):
    """``data`` with the first Huffman table of its first DHT replaced."""
    at = _segments(data, 0xC4)[0]
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    seg = data[at + 4:end]
    rest = seg[17 + sum(seg[1:17]):]
    body = seg[:1] + bytes(counts) + bytes(vals) + rest
    return data[:at + 2] + (len(body) + 2).to_bytes(2, "big") + body + data[end:]


@pytest.mark.parametrize("counts,vals", [
    ([3] + [0] * 15, [0, 1, 2]),
    ([255] + [0] * 15, range(255)),
    ([2] + [0] * 15, [0, 1]),
    ([0, 0, 0, 16] + [0] * 12, range(16)),
    ([0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7, [*range(11), 16]),
], ids=["three 1-bit codes", "255 1-bit codes", "all-ones 1-bit code",
        "all-ones 4-bit code", "DC symbol above 15"])
def test_bad_huffman_tables_raise_as_pil_does(counts, vals):
    """Over-subscribed lengths, an all-ones code and a DC magnitude above 15:
    libjpeg's table checks, made before the table is built."""
    data = _jpeg(_pixels(45, 37, seed=4), quality=90)
    bad = _with_first_table(data, counts, vals)
    with pytest.raises(ValueError, match="Huffman table"):
        jpeg.decode_jpeg(bad)
    with pytest.raises(OSError):
        _pil(bad)


@pytest.mark.parametrize("marker", [0xC4, 0xC0, 0xDB, 0xDA, 0xDD],
                         ids=["DHT", "SOF", "DQT", "SOS", "DRI"])
def test_header_bit_flips_raise_or_decode_as_pil(marker):
    """Every bit of every such segment (its marker byte and length too)
    flipped in turn: the decoder raises, or decodes as Pillow decodes; where
    Pillow raises, it raises.  Flipped quantization tables give samples far
    outside the range-limit table, where Pillow's C and SIMD IDCTs part: the
    decoder raises there."""
    data = _jpeg(_pixels(45, 37, seed=4, smooth=False), quality=90, restart_marker_blocks=2)
    raised = flips = 0
    for at in _segments(data, marker):
        end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
        for pos in range(at + 1, end):
            for bit in range(8):
                bad = bytearray(data)
                bad[pos] ^= 1 << bit
                bad = bytes(bad)
                flips += 1
                try:
                    got = jpeg.decode_jpeg(bad)
                except (ValueError, NotImplementedError):
                    raised += 1
                    continue
                np.testing.assert_array_equal(got, _pil(bad), err_msg=f"byte {pos - at} bit {bit}")
    assert flips >= 40 and raised > 0, (raised, flips)


def test_bit_flips_raise_or_decode_as_pil():
    data = _jpeg(_pixels(45, 37, seed=4, smooth=False), quality=90, restart_marker_blocks=2)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    rng = np.random.default_rng(5)
    raised = 0
    for _ in range(200):
        pos, bit = int(rng.integers(start, len(data) - 2)), int(rng.integers(8))
        bad = bytearray(data)
        bad[pos] ^= 1 << bit
        bad = bytes(bad)
        try:
            got = jpeg.decode_jpeg(bad)
        except ValueError:
            raised += 1
            continue
        np.testing.assert_array_equal(got, _pil(bad))
    assert raised >= 50, raised


def test_read_image_reads_png_and_jpeg(tmp_path):
    arr = _pixels(23, 19, seed=6)
    (tmp_path / "a.png").write_bytes(encode_png(arr))
    data = _jpeg(arr, quality=88)
    (tmp_path / "a.jpg").write_bytes(data)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.png")), arr)
    np.testing.assert_array_equal(jpeg.read_image(str(tmp_path / "a.jpg")), _pil(data))
    (tmp_path / "a.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(NotImplementedError, match="PNG and JPEG"):
        jpeg.read_image(str(tmp_path / "a.gif"))
