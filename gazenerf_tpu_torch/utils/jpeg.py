"""Baseline JPEG decoding with ``cv2.imread``'s pixels: the parser and the
plain versions of the two stages.

The JAX package reads raw frames with ``cv2.imread``; OpenCV decodes JPEG
with libjpeg-turbo at its defaults (the integer IDCT ``JDCT_ISLOW``, fancy
upsampling, its table YCbCr -> BGR conversion) and applies the EXIF
orientation afterwards.  This module follows libjpeg-turbo's C so that a
reader can check each function against it:

* :func:`parse_header`: ``jdmarker.c``'s ``read_markers`` up to the first
  SOS, over the stream the stdio source gives (the file, then an endless
  fake EOI, ``FF D9``, as ``jdatasrc.c`` inserts at the end of a file), and
  ``jdinput.c``'s geometry; the first APP1's EXIF orientation as OpenCV's
  ``ExifReader`` reads it;
* :func:`entropy_decode_reference`: ``jdhuff.c``'s sequential Huffman
  decoder with ``jdmarker.c``'s restart handling, in Python: the quantized
  coefficients, ``int16 [n_blocks, 64]`` in natural order, all components'
  block planes one after the other.  A scan cut short decodes as libjpeg
  decodes it: zero bits past the data, then the rest of the segment's MCUs
  left zero (grey 128);
* :func:`pixels_reference`: the pixel stage in PyTorch integer ops on any
  device: dequantization and ``jidctint.c``'s ``jpeg_idct_islow``,
  ``jdsample.c``'s upsampling, ``jdcolor.c``'s conversion to BGR and the
  crop; :func:`orient` applies the EXIF orientation as OpenCV does.

These are the CPU path and the card's yardstick, not fast code: the card
runs the entropy decoder in host C++ and the pixel stage as a CUDA kernel
(``csrc/jpeg_decode.cu``, ``kernels/jpeg.py``).  Progressive, lossless,
arithmetic-coded, 12-bit, CMYK/YCCK and multi-scan sequential files raise
``NotImplementedError`` naming the feature and its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MULTI_SCAN_ITEM = "ROADMAP Queue 1 item 9"  # progressive and multi-scan files
ARITHMETIC_ITEM = "ROADMAP Queue 1 item 10"
PRECISION_ITEM = "ROADMAP Queue 1 item 11"
CMYK_ITEM = "ROADMAP Queue 1 item 12"
LOSSLESS_ITEM = "ROADMAP Queue 1 item 13"

SOI, EOI, SOS, DQT, DHT, DRI, DAC, DNL, COM, TEM = (
    0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xCC, 0xDC, 0xFE, 0x01)
SOF0, SOF1, SOF2, SOF3 = 0xC0, 0xC1, 0xC2, 0xC3
RST0 = 0xD0
APP0, APP1, APP14 = 0xE0, 0xE1, 0xEE
_ARITHMETIC_SOF = {0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
                   0xCB: "arithmetic-coded lossless"}
# SOF5-7, JPG, SOF13-15: libjpeg-turbo refuses them (JERR_SOF_UNSUPPORTED)
_UNSUPPORTED_SOF = (0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF)

# jutils.c jpeg_natural_order: zigzag index -> natural index, with 16 extra
# entries of 63 that catch a run past the end of a corrupt block
NATURAL_ORDER = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16

# jstdhuff.c: the tables libjpeg-turbo puts in slots 0 and 1 where a file
# defines none (Motion-JPEG frames omit them): (bits[1..16], values)
_STD_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_STD_DC_VALS = tuple(range(12))
_STD_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
                (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_STD_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "0001020311040521310612415107617113223281081442919fa1b1c109233352"
    "f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a8283848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
    "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7"
    "f8f9fa"))

# upsampling methods of a component (jdsample.c jinit_upsampler)
FULLSIZE, H2V1_FANCY, H1V2_FANCY, H2V2_FANCY, BOX = range(5)
# the entropy decoder's warnings, libjpeg's JWRN_HIT_MARKER (a segment's
# data ran out), JWRN_JPEG_EOF (the file ended) and JWRN_MUST_RESYNC
WARN_HIT_MARKER, WARN_EOF, WARN_RESYNC = 1, 2, 4
WARNINGS = {WARN_HIT_MARKER: "Corrupt JPEG data: premature end of data segment",
            WARN_EOF: "Premature end of JPEG file",
            WARN_RESYNC: "Corrupt JPEG data: found a marker other than the expected restart"}


class _Broken(Exception):
    """libjpeg's error exit: ``cv2.imread`` gives None."""


class _Stream:
    """The bytes libjpeg's stdio source hands out: the file, then ``FF D9``
    over and over (``fill_input_buffer`` at end of file inserts a fake EOI
    each time it is called)."""

    def __init__(self, data: bytes):
        self.data, self.n, self.pos = data, len(data), 0

    def byte(self) -> int:
        p = self.pos
        self.pos = p + 1
        if p < self.n:
            return self.data[p]
        return 0xFF if (p - self.n) % 2 == 0 else 0xD9

    def u16(self) -> int:
        return (self.byte() << 8) | self.byte()

    def read(self, count: int) -> bytes:
        return bytes(self.byte() for _ in range(count))

    def next_marker(self) -> int:
        """``jdmarker.c`` ``next_marker``: skip to an FF, swallow fill FFs, and
        step over stuffed ``FF 00`` pairs."""
        while True:
            c = self.byte()
            while c != 0xFF:
                c = self.byte()
            c = self.byte()
            while c == 0xFF:
                c = self.byte()
            if c != 0:
                return c


@dataclasses.dataclass
class Component:
    """One colour component as ``jdinput.c`` lays it out.  ``blocks_w`` x
    ``blocks_h``: its block plane, the MCU grid's dummy blocks included;
    ``offset``: its first block in the coefficient buffer; ``dw`` x ``dh``:
    its downsampled size; ``method``/``hexp``/``vexp``: its upsampling."""

    ident: int
    h: int
    v: int
    tq: int
    blocks_w: int = 0
    blocks_h: int = 0
    offset: int = 0
    dw: int = 0
    dh: int = 0
    method: int = FULLSIZE
    hexp: int = 1
    vexp: int = 1


@dataclasses.dataclass
class Header:
    """What decoding needs from the markers before the scan."""

    width: int
    height: int
    components: List[Component]  # SOF order
    color: str  # "ycc", "rgb" or "grey"
    qtables: np.ndarray  # int32 [n_components, 64], natural order
    scan: List[int]  # the scan's components, as indices into ``components``
    tables: List[Tuple[bytes, bytes]]  # per scan component: DC, AC as bits[16] + values
    restart_interval: int
    mcus_x: int
    mcus_y: int
    scan_start: int  # the scan's first byte in the file
    n_blocks: int
    orientation: int = 1


def _refuse(feature: str, item: str):
    raise NotImplementedError(f"{feature} JPEG files are not read yet ({item})")


# the IFD0 tags OpenCV's ExifReader reads beyond their entry: its string
# tags (the value at offset 8 of the TIFF data when 4 bytes or fewer, else
# at the entry's offset) and its rational tags (so many rationals at the
# entry's offset); a read past the end stops the parse
_EXIF_STRINGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}


def _ifd0_orientation(d: bytes) -> Optional[int]:
    """The orientation in one EXIF block (the TIFF data after ``Exif\0\0``)
    as OpenCV reads it: ``II`` or ``MM``, the mark 42, IFD0's offset; IFD0's
    entries in order, the first of tag 0x0112 giving the 16-bit value at its
    offset + 8.  None where the block holds none or its parse stops first."""
    if len(d) < 2 or d[0] != d[1] or d[0] not in b"IM":
        return None
    order = "little" if d[0] == ord("I") else "big"

    def u(o, n):
        if o + n - 1 >= len(d):
            raise IndexError
        return int.from_bytes(d[o:o + n], order)

    try:
        if u(2, 2) != 42:
            return None
        offset = u(4, 4)
        for k in range(u(offset, 2)):
            entry = offset + 2 + 12 * k
            tag = u(entry, 2)
            if tag == 0x0112:
                return u(entry + 8, 2)
            if tag in _EXIF_STRINGS:
                size = u(entry + 4, 4)
                start = u(entry + 8, 4) if size > 4 else 8
                if start + size > len(d):
                    raise IndexError
            elif tag in _EXIF_RATIONALS:
                at = u(entry + 8, 4)
                for r in range(2 * _EXIF_RATIONALS[tag]):
                    u(at + 4 * r, 4)
    except IndexError:
        pass
    return None


def _exif_orientation(app1: List[bytes]) -> int:
    """The EXIF orientation ``cv2.imread`` applies: the first found in the
    APP1 segments that begin ``Exif\0\0``, taken in order; 1 where none."""
    for body in app1:
        if body[:6] == b"Exif\0\0":
            found = _ifd0_orientation(body[6:])
            if found is not None:
                return found
    return 1


def _sos_geometry(hdr: Header) -> None:
    """``jdinput.c`` ``initial_setup`` and ``per_scan_setup``: component
    sizes, block planes, the MCU grid; and ``jdsample.c``'s choice of
    upsampling per component."""
    comps, W, H = hdr.components, hdr.width, hdr.height
    max_h = max(c.h for c in comps)
    max_v = max(c.v for c in comps)
    for c in comps:
        c.dw = -(-W * c.h // max_h)
        c.dh = -(-H * c.v // max_v)
    if len(hdr.scan) == 1:
        c = comps[hdr.scan[0]]
        c.blocks_w, c.blocks_h = -(-c.dw // 8), -(-c.dh // 8)
        hdr.mcus_x, hdr.mcus_y = c.blocks_w, c.blocks_h
    else:
        hdr.mcus_x, hdr.mcus_y = -(-W // (8 * max_h)), -(-H // (8 * max_v))
        if sum(comps[i].h * comps[i].v for i in hdr.scan) > 10:
            raise _Broken("too many blocks in an MCU")  # JERR_BAD_MCU_SIZE
        for c in comps:
            c.blocks_w, c.blocks_h = hdr.mcus_x * c.h, hdr.mcus_y * c.v
    offset = 0
    for c in comps:
        c.offset = offset
        offset += c.blocks_w * c.blocks_h
        if (c.h, c.v) == (max_h, max_v):
            c.method = FULLSIZE
        elif 2 * c.h == max_h and c.v == max_v:
            c.method, c.hexp = (H2V1_FANCY, 2) if c.dw > 2 else (BOX, 2)
        elif c.h == max_h and 2 * c.v == max_v:
            c.method, c.vexp = H1V2_FANCY, 2
        elif 2 * c.h == max_h and 2 * c.v == max_v:
            c.method, c.hexp, c.vexp = (H2V2_FANCY, 2, 2) if c.dw > 2 else (BOX, 2, 2)
        elif max_h % c.h == 0 and max_v % c.v == 0:
            c.method, c.hexp, c.vexp = BOX, max_h // c.h, max_v // c.v
        else:
            raise _Broken("fractional sampling")  # JERR_FRACT_SAMPLE_NOTIMPL
    hdr.n_blocks = offset


def parse_header(data: bytes) -> Optional[Header]:
    """``jpeg_read_header`` as ``cv2.imread`` drives it: the markers up to
    the first SOS -> :class:`Header`, or None where libjpeg stops with an
    error (no SOI, a file cut inside its headers, a malformed segment).
    Raises ``NotImplementedError`` for the files this decoder does not read
    (progressive, lossless, arithmetic, 12-bit, CMYK/YCCK, multi-scan)."""
    try:
        return _parse(data)
    except _Broken:
        return None


def _parse(data: bytes) -> Header:
    if not data:
        raise _Broken("empty file")
    s = _Stream(data)
    if s.byte() != 0xFF or s.byte() != SOI:
        raise _Broken("not a JPEG file")
    dc: Dict[int, Tuple[bytes, bytes]] = {}
    ac: Dict[int, Tuple[bytes, bytes]] = {}
    qt: Dict[int, np.ndarray] = {}
    frame = None
    restart, jfif, adobe, app1 = 0, False, None, []
    while True:
        m = s.next_marker()
        if m in (SOF0, SOF1):
            if frame is not None:
                raise _Broken("two SOF markers")
            length, precision = s.u16(), s.byte()
            height, width, nc = s.u16(), s.u16(), s.byte()
            if height == 0 or width == 0 or nc == 0 or length != 8 + 3 * nc:
                raise _Broken("bad SOF")
            comps = []
            for _ in range(nc):
                ident, hv, tq = s.byte(), s.byte(), s.byte()
                comps.append(Component(ident, hv >> 4, hv & 15, tq))
            if precision == 12:
                _refuse("12-bit", PRECISION_ITEM)
            if precision != 8 or nc > 10 or width > 65500 or height > 65500:
                raise _Broken("bad precision or size")
            if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
                raise _Broken("bad sampling factors")
            frame = (width, height, comps)
        elif m == SOF2:
            _refuse("progressive (SOF2)", MULTI_SCAN_ITEM)
        elif m == SOF3:
            _refuse("lossless (SOF3)", LOSSLESS_ITEM)
        elif m in _ARITHMETIC_SOF or m == DAC:
            _refuse(_ARITHMETIC_SOF.get(m, "arithmetic-coded"), ARITHMETIC_ITEM)
        elif m in _UNSUPPORTED_SOF:
            raise _Broken("unsupported SOF")
        elif m == DHT:
            length = s.u16() - 2
            while length > 16:
                index = s.byte()
                bits = s.read(16)
                count = sum(bits)
                length -= 17
                if count > 256 or count > length:
                    raise _Broken("bad DHT")
                vals = s.read(count)
                length -= count
                table = ac if index & 0x10 else dc
                index &= ~0x10
                if index >= 4:
                    raise _Broken("bad DHT index")
                table[index] = (bits, vals)
            if length != 0:
                raise _Broken("bad DHT length")
        elif m == DQT:
            length = s.u16() - 2
            while length > 0:
                n = s.byte()
                length -= 1
                prec, n = n >> 4, n & 15
                if n >= 4 or length < 64 * (2 if prec else 1):
                    raise _Broken("bad DQT")
                vals = [s.u16() if prec else s.byte() for _ in range(64)]
                table = np.zeros(64, np.int32)
                table[list(NATURAL_ORDER[:64])] = vals
                qt[n] = table
                length -= 64 * (2 if prec else 1)
            if length != 0:
                raise _Broken("bad DQT length")
        elif m == DRI:
            if s.u16() != 4:
                raise _Broken("bad DRI")
            restart = s.u16()
        elif APP0 <= m <= 0xEF or m in (COM, DNL):
            length = s.u16() - 2
            if length < 0:
                raise _Broken("bad segment length")
            body = s.read(length)
            if m == APP0 and length >= 14 and body[:5] == b"JFIF\0":
                jfif = True
            elif m == APP14 and length >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
            elif m == APP1:
                app1.append(body)
        elif RST0 <= m <= RST0 + 7 or m == TEM:
            continue  # parameterless
        elif m == SOS:
            if frame is None:
                raise _Broken("SOS before SOF")
            length, ns = s.u16(), s.byte()
            if length != 6 + 2 * ns or not 1 <= ns <= 4:
                raise _Broken("bad SOS")
            width, height, comps = frame
            scan, sel = [], []
            for _ in range(ns):
                cc, tdta = s.byte(), s.byte()
                idx = [i for i, c in enumerate(comps) if c.ident == cc and i not in scan]
                if not idx:
                    raise _Broken("bad component id in SOS")
                scan.append(idx[0])
                sel.append((tdta >> 4, tdta & 15))
            s.read(3)  # Ss, Se, Ah/Al: a baseline scan's, whatever they say
            break
        elif m == EOI:
            raise _Broken("no image")
        elif m == SOI:
            raise _Broken("two SOI markers")
        else:
            raise _Broken(f"unknown marker {m:#x}")

    nc = len(comps)
    if nc == 4:
        _refuse("CMYK/YCCK (4-component)", CMYK_ITEM)
    if nc == 1:
        color = "grey"
    elif nc == 3:
        ids = tuple(c.ident for c in comps)
        if jfif:
            color = "ycc"
        elif adobe is not None:
            color = "rgb" if adobe == 0 else "ycc"
        else:
            color = "rgb" if ids == (82, 71, 66) else "ycc"
    else:
        raise _Broken(f"{nc} components")  # no conversion to BGR
    if len(scan) < nc:
        _refuse("multi-scan sequential", MULTI_SCAN_ITEM)
    for i in (0, 1):  # jdhuff.c std_huff_tables
        dc.setdefault(i, (bytes(_STD_DC_BITS[i]), bytes(_STD_DC_VALS)))
        ac.setdefault(i, (bytes(_STD_AC_BITS[i]), _STD_AC_VALS[i]))
    tables = []
    for td, ta in sel:
        if td not in dc or ta not in ac:
            raise _Broken("no Huffman table")
        if any(v > 15 for v in dc[td][1]):
            raise _Broken("bad DC table")
        if not (_prefix_code(dc[td][0]) and _prefix_code(ac[ta][0])):
            raise _Broken("bad Huffman table")  # JERR_BAD_HUFF_TABLE
        tables.append((dc[td], ac[ta]))
    for c in comps:
        if c.tq not in qt:
            raise _Broken("no quantization table")
    hdr = Header(width, height, comps, color, np.stack([qt[c.tq] for c in comps]), scan,
                 tables, restart, 0, 0, s.pos, 0, _exif_orientation(app1))
    _sos_geometry(hdr)
    return hdr


# ---------------- entropy decoding (jdhuff.c) --------------------------------


def _prefix_code(bits: bytes) -> bool:
    """``jpeg_make_d_derived_tbl``'s check: the canonical codes of these
    lengths fit (no code of ``length`` bits reaches ``2 ** length``)."""
    code = 0
    for length in range(1, 17):
        code += bits[length - 1]
        if code > 1 << length:
            return False
        code <<= 1
    return True


def huffman_lookup(bits: bytes, vals: bytes) -> List[int]:
    """``jpeg_make_d_derived_tbl`` as a table over every 16-bit window: entry
    ``length << 8 | symbol``; a window no code starts gives length 17 and
    symbol 0, what ``jpeg_huff_decode`` returns for a bad code after reading
    17 bits.  Raises :class:`_Broken` for an over-full table."""
    table = [(17 << 8)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if code >= 1 << length:
                raise _Broken("bad Huffman table")
            span = 1 << (16 - length)
            table[code * span:(code + 1) * span] = [(length << 8) | vals[k]] * span
            code += 1
            k += 1
        code <<= 1
    return table


def _segment(data: bytes, pos: int) -> Tuple[bytes, int, int]:
    """The entropy-coded bytes from ``pos`` to the next marker, unstuffed
    (``FF 00`` and ``FF FF .. 00`` are one ``FF``), as ``jpeg_fill_bit_buffer``
    reads them -> (bytes, the marker, the position after it); past the end
    of the file the fake EOI."""
    out = bytearray()
    n = len(data)
    while True:
        q = data.find(b"\xff", pos)
        if q < 0:
            out += data[pos:]
            return bytes(out), EOI, n + 2
        out += data[pos:q]
        r = q + 1
        while r < n and data[r] == 0xFF:
            r += 1
        if r >= n:  # FF at the very end: the fake EOI's FF D9 follows
            return bytes(out), EOI, n + 2
        if data[r] == 0:
            out.append(0xFF)
            pos = r + 1
        else:
            return bytes(out), data[r], r + 1


def entropy_decode_reference(data: bytes, hdr: Header) -> Tuple[np.ndarray, int]:
    """``jdhuff.c``'s ``decode_mcu`` over the scan, in Python -> (``int16
    [n_blocks, 64]`` coefficients in natural order, warnings as ``WARN_*``
    bits).  Component by component, each its block plane row by row; the
    MCUs in the scan's order, a component's ``v`` x ``h`` blocks an MCU.
    Beyond a segment's data the decoder reads zero bits and then leaves
    the segment's remaining MCUs zero; a restart resets the DC predictions
    and, found where expected, the out-of-data state (``process_restart``,
    ``read_restart_marker``, ``jpeg_resync_to_restart``)."""
    comps = [hdr.components[i] for i in hdr.scan]
    luts = [(huffman_lookup(*dct), huffman_lookup(*act)) for dct, act in hdr.tables]
    coef = np.zeros((hdr.n_blocks, 64), np.int16)
    # the blocks of one MCU: (scan component, block row, block column)
    single = len(comps) == 1
    mcu = [(k, by, bx) for k, c in enumerate(comps)
           for by in range(1 if single else c.v) for bx in range(1 if single else c.h)]
    natural = NATURAL_ORDER
    n_mcus = hdr.mcus_x * hdr.mcus_y
    interval = hdr.restart_interval or n_mcus
    warn, pos, next_rst, insufficient = 0, hdr.scan_start, 0, False
    marker = after = None  # the marker that ends the last segment, and past it
    for first in range(0, n_mcus, interval):
        if first:  # process_restart -> read_restart_marker
            if marker == RST0 + next_rst:
                marker, pos = None, after
            else:
                warn |= WARN_RESYNC
                marker, after = _resync(data, marker, after, next_rst)
                pos = after
            next_rst = (next_rst + 1) % 8
            if marker is None:
                insufficient = False
        if marker is None:
            seg, seg_marker, seg_after = _segment(data, pos)
        else:  # left at a marker: the segment is empty
            seg, seg_marker, seg_after = b"", marker, after
        marker, after = seg_marker, seg_after
        if seg_after > len(data):
            warn |= WARN_EOF
        nbits = 8 * len(seg)
        padded = np.frombuffer(seg + bytes(4096), np.uint8).astype(np.int64)
        w = ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()
        bit = 0
        last_dc = [0] * len(comps)
        for m in range(first, min(first + interval, n_mcus)):
            if insufficient:
                continue
            my, mx = divmod(m, hdr.mcus_x)
            for k, by, bx in mcu:
                c = comps[k]
                dcl, acl = luts[k]
                if single:
                    blk = c.offset + m
                else:
                    blk = c.offset + (my * c.v + by) * c.blocks_w + mx * c.h + bx
                block = [0] * 64
                e = dcl[(w[bit >> 3] >> (8 - (bit & 7))) & 0xFFFF]
                bit += e >> 8
                s = e & 0xFF
                if s:
                    r = ((w[bit >> 3] >> (8 - (bit & 7))) & 0xFFFF) >> (16 - s)
                    bit += s
                    s = r if r >= 1 << (s - 1) else r - (1 << s) + 1
                d = (last_dc[k] + s + 0x80000000) % 0x100000000 - 0x80000000
                last_dc[k] = d
                block[0] = d
                kk = 1
                while kk < 64:
                    e = acl[(w[bit >> 3] >> (8 - (bit & 7))) & 0xFFFF]
                    bit += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        kk += r
                        v = ((w[bit >> 3] >> (8 - (bit & 7))) & 0xFFFF) >> (16 - s)
                        bit += s
                        block[natural[kk]] = v if v >= 1 << (s - 1) else v - (1 << s) + 1
                    elif r != 15:
                        break
                    else:
                        kk += 15
                    kk += 1
                coef[blk] = np.array(block, np.int64).astype(np.int16)
            if bit > nbits:
                insufficient = True
                warn |= WARN_HIT_MARKER
    return coef, warn


def _resync(data: bytes, marker: int, after: int, next_rst: int) -> Tuple[Optional[int], int]:
    """``jpeg_resync_to_restart`` for ``marker`` where RST``next_rst`` was
    due -> (None, the position after the marker it discards), or (the marker
    it stops at, the position after it): the segment then is empty."""
    while True:
        if marker < SOF0:
            action = 2  # not a marker a file holds: scan on
        elif not RST0 <= marker <= RST0 + 7:
            action = 3  # a marker that ends the scan
        elif marker in (RST0 + (next_rst + 1) % 8, RST0 + (next_rst + 2) % 8):
            action = 3  # one of the next two restarts: stop before it
        elif marker in (RST0 + (next_rst - 1) % 8, RST0 + (next_rst - 2) % 8):
            action = 2  # an earlier restart: scan on
        else:
            action = 1  # the desired one or far off: take it
        if action == 1:
            return None, after
        if action == 3:
            return marker, after
        _, marker, after = _segment(data, after)  # next_marker


# ---------------- the pixel stage --------------------------------------------

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """An int16 lane's wrap-around (``paddw``, ``pmullw``)."""
    return ((x + 32768) & 0xFFFF) - 32768


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int32 lane's wrap-around (``paddd``, ``pmaddwd``)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_1d(x, shift):
    """One pass of ``jpeg_idct_islow`` on the int16 inputs ``x[0..7]`` (int64
    tensors of any shape) -> its 8 outputs ``DESCALE``d by ``shift`` bits and
    saturated to int16.  The formula of ``jidctint.c`` as libjpeg-turbo's x86
    SIMD runs it (``jidctint-avx2.asm``, ``-sse2.asm``), which is what
    ``cv2.imread`` computes: ``x[0] +/- x[4]``, ``z3 = x[7] + x[3]`` and ``z4 =
    x[5] + x[1]`` are 16-bit sums, the products and the rest 32-bit, exact.
    Where no 16-bit sum wraps and no output saturates, as for the
    coefficients of any real image, this is the C."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = wrap16(x[0] + x[4]) << CONST_BITS
    tmp1 = wrap16(x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = wrap16(tmp0 + tmp2), wrap16(tmp1 + tmp3)
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    half = 1 << (shift - 1)
    return [(wrap32(v + half) >> shift).clamp(-32768, 32767) for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def idct_islow_reference(coef: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """``jpeg_idct_islow`` for ``int16 [n, 64]`` coefficients (natural order)
    and a quantization table ``[64]`` -> ``uint8 [n, 8, 8]``, as the SIMD
    form runs it: the products with the table 16-bit (``pmullw``); pass 1
    down the columns into an int16 workspace (``PASS1_BITS`` up), where a
    block whose rows 1-7 are all zero takes its DC terms shifted in 16 bits;
    pass 2 along the rows (``CONST_BITS + PASS1_BITS + 3`` down); the output
    ``x + 128`` clamped to [0, 255] (the C's range-limit table, which wraps
    beyond [-512, 511] where the SIMD saturates)."""
    c = coef.to(torch.int64).view(-1, 8, 8)
    deq = wrap16(c * qtable.to(torch.int64).view(8, 8))
    ws = torch.stack(_idct_1d([deq[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS), 1)
    dc_only = ~c[:, 1:, :].flatten(1).any(1)
    ws = torch.where(dc_only[:, None, None], wrap16(deq[:, :1, :] << PASS1_BITS), ws)
    out = torch.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                               CONST_BITS + PASS1_BITS + 3), 2)
    return (out + 128).clamp(0, 255).to(torch.uint8)


def component_plane(pixels: torch.Tensor, comp: Component) -> torch.Tensor:
    """The IDCT's blocks ``[blocks_h * blocks_w, 8, 8]`` of a component ->
    its sample plane ``[8 blocks_h, 8 blocks_w]``."""
    bh, bw = comp.blocks_h, comp.blocks_w
    return pixels.view(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(8 * bh, 8 * bw)


def upsample_reference(plane: torch.Tensor, comp: Component, width: int,
                       height: int) -> torch.Tensor:
    """``jdsample.c`` for one component's plane -> int64 ``[height, width]``.
    Samples beyond the component's downsampled size ``dw`` x ``dh`` are never
    read: libjpeg's edges repeat the last real column (the fancy methods'
    first and last columns) and row (``jdmainct.c``'s context rows).  Fancy
    h2v1: ``(3 s[j] + s[j -/+ 1] + 1 or 2) >> 2`` for even/odd output
    columns; h1v2 the same down the rows; h2v2: column sums ``3 s[i] +
    s[i -/+ 1]``, then ``(3 c[j] + c[j -/+ 1] + 8 or 7) >> 4``; box: each
    sample ``hexp`` x ``vexp`` times."""
    s = plane.to(torch.int64)
    dev = s.device
    y = torch.arange(height, device=dev)
    x = torch.arange(width, device=dev)
    if comp.method == FULLSIZE:
        return s[:height, :width]
    if comp.method == BOX:
        return s[y // comp.vexp][:, x // comp.hexp]

    def near_far(t, n):  # the nearer sample, the further one (clamped), the bias's parity
        i = t >> 1
        odd = t & 1
        return i, (i - 1 + 2 * odd).clamp(0, n - 1), odd

    if comp.method == H2V1_FANCY:
        j, jn, odd = near_far(x, comp.dw)
        rows = s[:height]
        return (3 * rows[:, j] + rows[:, jn] + 1 + odd) >> 2
    if comp.method == H1V2_FANCY:
        i, i_n, odd = near_far(y, comp.dh)
        cols = s[:, :width]
        return (3 * cols[i] + cols[i_n] + 1 + odd[:, None]) >> 2
    i, i_n, _ = near_far(y, comp.dh)
    colsum = 3 * s[i] + s[i_n]
    j, jn, odd = near_far(x, comp.dw)
    return (3 * colsum[:, j] + colsum[:, jn] + 8 - odd) >> 4


def _fix16(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


def ycc_tables(device=None) -> torch.Tensor:
    """``jdcolor.c`` ``build_ycc_rgb_table`` (``SCALEBITS`` 16) -> int64 ``[4,
    256]``: Cr->R, Cb->B (rounded), Cr->G, Cb->G (scaled, ONE_HALF in Cb's)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    tabs = np.stack([(_fix16(1.40200) * x + half) >> 16, (_fix16(1.77200) * x + half) >> 16,
                     -_fix16(0.71414) * x, -_fix16(0.34414) * x + half])
    return torch.from_numpy(tabs).to(device)


def color_reference(planes: List[torch.Tensor], color: str) -> torch.Tensor:
    """Full-size int64 component planes -> BGR ``uint8 [H, W, 3]``:
    ``ycc_rgb_convert`` (each sum range-limited to [0, 255]), a copy for an
    RGB-coded file, grey replicated (``gray_rgb_convert``)."""
    if color == "grey":
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, 3)
    if color == "rgb":
        return torch.stack(planes[::-1], -1).to(torch.uint8)
    y, cb, cr = planes
    t = ycc_tables(y.device)
    r = y + t[0][cr]
    g = y + ((t[3][cb] + t[2][cr]) >> 16)
    b = y + t[1][cb]
    return torch.stack([b, g, r], -1).clamp(0, 255).to(torch.uint8)


def pixels_reference(coef: torch.Tensor, hdr: Header) -> torch.Tensor:
    """The plain pixel stage on ``coef``'s device: ``int16 [n_blocks, 64]``
    -> BGR ``uint8 [height, width, 3]`` before the EXIF orientation."""
    qt = torch.from_numpy(hdr.qtables).to(coef.device)
    planes = []
    for ci, comp in enumerate(hdr.components):
        blocks = coef[comp.offset:comp.offset + comp.blocks_w * comp.blocks_h]
        plane = component_plane(idct_islow_reference(blocks, qt[ci]), comp)
        planes.append(upsample_reference(plane, comp, hdr.width, hdr.height))
    return color_reference(planes, hdr.color).contiguous()


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """OpenCV's ``ExifTransform``: 2 flips left-right, 3 turns half round, 4
    flips upside down, 5 transposes, 6 transposes and flips left-right, 7
    transposes and turns half round, 8 transposes and flips upside down;
    any other value leaves the image."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation)
    if flips:
        img = img.flip(flips)
    return img.contiguous()
