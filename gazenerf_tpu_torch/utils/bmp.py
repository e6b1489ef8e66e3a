"""BMP frames as ``cv2.imread`` reads them (OpenCV's ``grfmt_bmp.cpp``), for
the data factory's ``read_frame``: uncompressed 24- and 32-bit BMPs (rows
bottom-up, or top-down where the height is negative; 32-bit drops its
fourth byte, or takes the bytes its bit fields name where each of the red,
green and blue masks is one whole byte, as ``cv2.imwrite`` writes 32-bit
BMPs) and 8-bit palette BMPs (each index through the palette, whose missing
entries are black).  RLE, other bit fields and other depths raise
``NotImplementedError``; a file cut short or not a BMP gives None, as cv2
gives.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3


def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    """BMP bytes -> BGR ``uint8 [H, W, 3]``, or None."""
    if len(data) < 54 or data[:2] != b"BM":
        return None
    offset, size = struct.unpack_from("<II", data, 10)
    if 14 + size > len(data):
        return None
    if size < 40:
        raise NotImplementedError(f"BMP header of {size} bytes (OS/2) is not read yet")
    width, height, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
    if compression in (_BI_RLE8, _BI_RLE4):
        raise NotImplementedError(f"RLE-compressed BMP ({bpp}-bit) is not read yet")
    # the bytes of a 32-bit pixel that hold blue, green and red
    channels = [0, 1, 2]
    if compression == _BI_BITFIELDS and bpp == 32 and len(data) >= 66:
        masks = struct.unpack_from("<III", data, 54)  # red, green, blue
        whole = [0xFF << 8 * k for k in range(4)]
        if all(m in whole for m in masks):
            channels = [whole.index(m) for m in masks[::-1]]
            compression = _BI_RGB
    if compression == _BI_BITFIELDS:
        raise NotImplementedError(f"bit-field BMP ({bpp}-bit) is not read yet")
    if compression != _BI_RGB or bpp not in (8, 24, 32):
        raise NotImplementedError(f"{bpp}-bit BMP (compression {compression}) is not read yet")
    if width <= 0 or height == 0:
        return None
    rows = abs(height)
    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * rows > len(data):
        return None
    pixels = np.frombuffer(data, np.uint8, stride * rows, offset).reshape(rows, stride)
    if height > 0:
        pixels = pixels[::-1]
    if bpp == 8:
        used = struct.unpack_from("<I", data, 46)[0] or 256
        used = min(used, 256, (len(data) - 14 - size) // 4)
        palette = np.zeros((256, 3), np.uint8)
        palette[:used] = np.frombuffer(data, np.uint8, 4 * used, 14 + size).reshape(used, 4)[:, :3]
        return palette[pixels[:, :width]]
    step = bpp // 8
    return np.ascontiguousarray(pixels[:, :width * step].reshape(rows, width, step)[..., channels])
