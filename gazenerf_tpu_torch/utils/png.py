"""Minimal PNG codec (stdlib ``zlib`` + ``struct``).

The viewer serves PNGs and the preprocessing reads PNG frames; the JAX
package encodes and reads them with OpenCV, which the port does not depend
on.  :func:`encode_png` writes 8-bit RGB with filter 0; :func:`decode_png`
reads 8-bit grey, RGB and RGBA without interlace, with any of the five
scanline filters (OpenCV's writer picks them adaptively per row).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# zlib's best-speed level, also OpenCV's default for PNG (the JAX viewer's
# encoder)
_ZLIB_LEVEL = 1


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """``uint8 [H, W, 3]`` RGB -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, 3 * w)],
        axis=1,
    )  # filter byte 0 (None) in front of every scanline
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL))
        + _chunk(b"IEND", b"")
    )


_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels (grey, RGB, RGBA)


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters of ``raw`` (``h`` rows of a filter byte and
    ``w * bpp`` bytes) -> ``uint8 [h, w, bpp]``.  Without Average or Paeth,
    row by row; with them (they read the reconstructed pixel to the left and
    the row above), in anti-diagonals (row + column constant), each one
    vectorized."""
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    if ftype.max() <= 2:  # None, Sub, Up: row by row (Sub is a running sum)
        out = np.zeros((h, w, bpp), np.int32)
        prev = np.zeros((w, bpp), np.int32)
        for r in range(h):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = prev = row & 255
        return out.astype(np.uint8)
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - r
        a, b, c = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        t = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit grey, RGB or RGBA, not interlaced) -> ``uint8 [H,
    W]`` for grey, else ``[H, W, 3]`` RGB or ``[H, W, 4]`` RGBA.  Corrupt or
    truncated data raises ``ValueError``; a valid PNG of another bit depth,
    colour type or interlace raises ``NotImplementedError``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG")
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        if pos + 12 + n > len(data):
            raise ValueError("truncated PNG")
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r} chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    if hdr[2] != 8 or hdr[3] not in _CHANNELS or hdr[4:] != (0, 0, 0):
        # a valid PNG this decoder does not read (16-bit, palette, interlaced)
        raise NotImplementedError(
            f"unsupported PNG header {hdr}: only 8-bit grey, RGB or RGBA, not interlaced")
    w, h, bpp = hdr[0], hdr[1], _CHANNELS[hdr[3]]
    img = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), h, w, bpp)
    return img[..., 0] if bpp == 1 else img
