"""Write ``tests/jpeg_fixture/``: baseline JPEGs that Pillow (over
libjpeg-turbo) wrote, and ``expected.json`` with each image's shape and the
sha256 of Pillow's RGB decode, for the port's JPEG decoder to be held to
where Pillow is not installed (the card).

The images are synthetic (smooth colour fields, edges and mild noise drawn
from ``SEED``), at MiniGPT-4-like sizes and at odd and tiny ones, across
the modes the decoder takes: qualities 50-100, 4:4:4, 4:2:2 and 4:2:0
subsampling, grayscale, ``optimize=True`` Huffman tables and restart
markers.  Run from the repository root: ``python tests/make_jpeg_fixture.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, ImageFile, features

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "jpeg_fixture")
SEED = 18
# name: (width, height, gray, quality, subsampling, optimize, restart_marker_blocks)
IMAGES = {
    "q75_420_256x256": (256, 256, False, 75, 2, False, 0),
    "q95_444_333x500": (333, 500, False, 95, 0, False, 0),
    "q50_422_500x375": (500, 375, False, 50, 1, False, 0),
    "q90_420_opt_640x480": (640, 480, False, 90, 2, True, 0),
    "q85_420_1024x768": (1024, 768, False, 85, 2, False, 0),
    "q100_444_333x251": (333, 251, False, 100, 0, False, 0),
    "gray_q90_500x333": (500, 333, True, 90, 0, False, 0),
    "q80_420_rst_640x427": (640, 427, False, 80, 2, False, 7),
    "q75_422_17x9": (17, 9, False, 75, 1, False, 0),
    "q90_420_1x1": (1, 1, False, 90, 2, False, 0),
    "q60_420_opt_rst_375x500": (375, 500, False, 60, 2, True, 3),
    "gray_q70_251x187": (251, 187, True, 70, 0, False, 0),
}


def pixels(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    """A smooth colour field with a few hard-edged discs and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.005, 0.03, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([127 + 100 * np.sin(f[c] * (xx + 0.7 * yy) + ph[c]) for c in range(3)], -1)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.05, 0.3) * max(w, h)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(name: str, rng: np.random.Generator) -> bytes:
    w, h, gray, quality, subsampling, optimize, rst = IMAGES[name]
    im = Image.fromarray(pixels(w, h, rng))
    if gray:
        im = im.convert("L")
    kw = dict(quality=quality, optimize=optimize)
    if not gray:
        kw["subsampling"] = subsampling
    if rst:
        kw["restart_marker_blocks"] = rst
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def build(seed: int = SEED) -> dict:
    """{name: JPEG bytes} and the expected.json record, made from ``seed``."""
    ImageFile.MAXBLOCK = 1 << 24  # optimize=True needs the whole scan in one buffer
    rng = np.random.default_rng(seed)
    files, record = {}, {"seed": seed, "pillow_libjpeg_turbo": features.version("libjpeg_turbo"),
                         "images": {}}
    for name in IMAGES:
        data = encode(name, rng)
        rgb = pil_rgb(data)
        files[f"{name}.jpg"] = data
        record["images"][f"{name}.jpg"] = {
            "shape": list(rgb.shape), "bytes": len(data),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    return {"files": files, "expected": record}


def main() -> None:
    out = build()
    os.makedirs(OUT, exist_ok=True)
    for name, data in out["files"].items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(out["expected"], f, indent=1)
        f.write("\n")
    total = sum(len(d) for d in out["files"].values())
    print(f"wrote {len(out['files'])} JPEGs ({total} bytes) and expected.json under {OUT}")


if __name__ == "__main__":
    main()
