"""A GIF89a writer in the standard library and numpy.

Each frame gets its own colour table of at most 256 colours (the frame's
own colours where it has that few, else a median cut of them weighted by
their pixel counts, each pixel taking its box's mean), LZW-compressed
pixel indices, and a graphic control extension with the frame delay; a
NETSCAPE2.0 extension makes the animation loop.  Host code only.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

_MAX_CODES = 4096


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Split the unique ``colors`` ``[U, 3]`` into at most ``n`` boxes:
    repeatedly halve the box with the most pixels (of those with more than
    one colour) at the weighted median of its widest channel.  Returns each
    colour's box index ``[U]``."""
    boxes = [np.arange(len(colors))]
    weight = [float(counts.sum()) if len(colors) > 1 else -1.0]  # -1: a single colour
    while len(boxes) < n:
        i = int(np.argmax(weight))
        if weight[i] < 0:
            break
        b = boxes.pop(i)
        weight.pop(i)
        c = colors[b]
        ch = int(np.argmax(c.max(0) - c.min(0)))
        order = b[np.argsort(c[:, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)) + 1, 1), len(order) - 1)
        for part, w in ((order[:cut], cum[cut - 1]), (order[cut:], cum[-1] - cum[cut - 1])):
            boxes.append(part)
            weight.append(float(w) if len(part) > 1 else -1.0)
    label = np.empty(len(colors), np.int64)
    for k, b in enumerate(boxes):
        label[b] = k
    return label


def quantize(frame: np.ndarray, max_colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """``[H, W, 3]`` uint8 -> ``(palette [P, 3] uint8, indices [H, W])``,
    ``P <= max_colors``."""
    flat = frame.reshape(-1, 3).astype(np.uint32)
    packed = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    colors = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], 1).astype(np.float64)
    if len(uniq) <= max_colors:
        return colors.astype(np.uint8), inverse.reshape(frame.shape[:2])
    label = _median_cut(colors, counts, max_colors)
    n = int(label.max()) + 1
    w = np.bincount(label, counts, n)
    palette = np.stack([np.bincount(label, colors[:, c] * counts, n) / w for c in range(3)], 1)
    return np.rint(palette).astype(np.uint8), label[inverse].reshape(frame.shape[:2])


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's variable-width LZW of a flat index array: codes from
    ``min_code_size + 1`` bits up to 12, LSB first, a clear code first and
    whenever the table fills, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    codes: List[Tuple[int, int]] = [(clear, min_code_size + 1)]
    table = {}
    nxt, size = end + 1, min_code_size + 1
    it = iter(indices.tolist())
    prefix = next(it, None)
    if prefix is not None:
        for c in it:
            key = (prefix << 8) | c
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            codes.append((prefix, size))
            if nxt == _MAX_CODES:
                codes.append((clear, size))
                table.clear()
                nxt, size = end + 1, min_code_size + 1
            else:
                table[key] = nxt
                if nxt == 1 << size:
                    size += 1
                nxt += 1
            prefix = c
        codes.append((prefix, size))
    codes.append((end, size))
    # pack LSB first
    out, acc, bits = bytearray(), 0, 0
    for code, width in codes:
        acc |= code << bits
        bits += width
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], delay_cs: int = 0, loop: int = 0) -> bytes:
    """The GIF89a bytes of ``frames`` (``[H, W, 3]`` uint8, one size), each
    shown for ``delay_cs`` hundredths of a second; ``loop`` repeats (0:
    forever)."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    H, W = frames[0].shape[:2]
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", W, H, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        if f.shape != (H, W, 3) or f.dtype != np.uint8:
            raise ValueError(f"frame {f.shape} {f.dtype}: every frame is uint8 [{H}, {W}, 3]")
        palette, idx = quantize(f)
        bits = max(1, int(np.ceil(np.log2(len(palette)))))  # table of 2^bits entries
        table = np.zeros((1 << bits, 3), np.uint8)
        table[: len(palette)] = palette
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0x80 | (bits - 1))
        out += table.tobytes()
        mcs = max(2, bits)
        out += bytes([mcs]) + _sub_blocks(lzw_encode(idx.reshape(-1), mcs))
    out += b"\x3b"
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], delay_cs: int = 0, loop: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, delay_cs, loop))
