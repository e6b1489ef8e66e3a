#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's tests and ``chip_smoke.py`` under
``tests/data/jpeg/``, with OpenCV (the card's machine has none):

    python tools/make_jpeg_fixtures.py [--out tests/data/jpeg]

* small frames that ``cv2.imencode`` writes (seeded gradients with noise):
  each sampling factor (4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4) at odd sizes,
  grey, a restart interval that ends mid MCU row, EXIF orientations 6 (big
  endian) and 8 (little endian) in a spliced APP1 segment, and a scan cut in
  half; beside each ``<name>.png``, ``cv2.imread``'s pixels (RGB, through the
  port's ``utils/png.encode_png``);
* two full-width strips at quality 90 with a restart interval of one MCU row,
  from which ``chip_smoke.py`` stacks ETH-XGaze's 6000 x 4000 frames: 6000 x
  16 at 4:2:0 and 6000 x 8 at 4:2:2; ``strips.json`` holds the SHA-256 of
  ``cv2.imread``'s BGR pixels of each strip and of each 6000 x 4000 frame
  stacked from it (``kernels/checks.stack_jpeg_strip``; their PNGs would be
  too large to commit).

Run it again only to change the fixtures: the CPU tests hold every file to
``cv2.imread`` of its JPEG.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

STRIPS = {"strip420_6000x16": (16, "420"), "strip422_6000x8": (8, "422")}
STRIP_WIDTH, STRIP_QUALITY = 6000, 90


def frame(rng, h, w):
    """A seeded frame: smooth bands, edges and noise in each channel."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([128 + 60 * np.sin(xx / 9.7 + yy / 5.3), 100 + 3 * yy,
                     128 + 50 * np.cos(xx / 6.1 - yy / 3.7)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def strip(rng, h):
    """A full-width strip: slow waves and photo-like noise (the strips come
    to ~45 and ~29 KB at quality 90)."""
    yy, xx = np.mgrid[:h, :STRIP_WIDTH].astype(np.float64)
    base = np.stack([128 + 60 * np.sin(xx / 97.0 + yy / 13.0), 128 + 50 * np.cos(xx / 61.0),
                     128 + 40 * np.sin(xx / 37.0 - yy / 7.0)], -1)
    return np.clip(base + rng.normal(0, 16, base.shape), 0, 255).astype(np.uint8)


def exif_app1(orientation: int, little: bool) -> bytes:
    """An APP1 segment: ``Exif\\0\\0``, a TIFF header and IFD0 with the
    orientation (SHORT) after a Make entry."""
    e = "<" if little else ">"
    tiff = (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
    tiff += struct.pack(e + "HHI", 0x010F, 2, 4) + b"Cam\0"
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def after_app0(jpg: bytes, segment: bytes) -> bytes:
    """``segment`` spliced in after the JFIF APP0 segment."""
    end = 4 + struct.unpack(">H", jpg[4:6])[0]
    return jpg[:end] + segment + jpg[end:]


def main() -> int:
    import cv2

    from gazenerf_tpu_torch.kernels.checks import JPEG_STRIP_REPEATS, stack_jpeg_strip
    from gazenerf_tpu_torch.utils.png import encode_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)

    def encode(img, quality, sampling="420", restart=0):
        flags = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                 getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling),
                 cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        ok, buf = cv2.imencode(".jpg", img, flags)
        assert ok
        return buf.tobytes()

    small = {}
    for sampling, (h, w), quality in (("411", (53, 37), 50), ("420", (30, 61), 95),
                                      ("422", (53, 37), 90), ("440", (30, 61), 50),
                                      ("444", (53, 37), 95)):
        small[f"s{sampling}_q{quality}_{w}x{h}"] = encode(frame(rng, h, w), quality, sampling)
    small["grey_q75_37x53"] = encode(frame(rng, 53, 37)[..., 0], 75)
    small["rst3_s420_61x30"] = encode(frame(rng, 30, 61), 85, "420", restart=3)
    small["exif6_mm_s420_37x53"] = after_app0(encode(frame(rng, 53, 37), 80), exif_app1(6, False))
    small["exif8_ii_s444_37x53"] = after_app0(encode(frame(rng, 53, 37), 80, "444"),
                                              exif_app1(8, True))
    whole = encode(frame(rng, 53, 37), 90)
    scan = whole.index(b"\xff\xda")
    small["cut_s420_37x53"] = whole[:scan + (len(whole) - scan) // 2]

    for name, data in small.items():
        path = os.path.join(args.out, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        pixels = cv2.imread(path)
        with open(os.path.join(args.out, name + ".png"), "wb") as f:
            f.write(encode_png(np.ascontiguousarray(pixels[..., ::-1])))

    digests = {}
    for name, (h, sampling) in STRIPS.items():
        path = os.path.join(args.out, name + ".jpg")
        with open(path, "wb") as f:
            f.write(encode(strip(rng, h), STRIP_QUALITY, sampling, restart=STRIP_WIDTH // 16))
        pixels = cv2.imread(path)
        digests[name] = {"shape": list(pixels.shape),
                         "sha256_bgr": hashlib.sha256(pixels.tobytes()).hexdigest()}
        with open(path, "rb") as f:
            stacked = stack_jpeg_strip(f.read(), JPEG_STRIP_REPEATS[name])
        with tempfile.TemporaryDirectory() as tmp:
            big = os.path.join(tmp, "stacked.jpg")
            with open(big, "wb") as f:
                f.write(stacked)
            pixels = cv2.imread(big)
        digests[name]["stacked"] = {"shape": list(pixels.shape),
                                    "sha256_bgr": hashlib.sha256(pixels.tobytes()).hexdigest()}
    with open(os.path.join(args.out, "strips.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"{len(small)} frames and {len(STRIPS)} strips in {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
