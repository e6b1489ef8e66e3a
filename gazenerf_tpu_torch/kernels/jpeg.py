"""JPEG frames on the card: :func:`decode_jpeg`, the port's ``cv2.imread``
for baseline JPEG.

No TPU kernel is replaced: the JAX package reads raw frames with
``cv2.imread`` (``gazenerf_tpu/preprocess/driver.py:238``), whose
libjpeg-turbo work this is.  ``csrc/jpeg_decode.cu`` holds both native
parts: ``jpeg_entropy_decode``, the Huffman decoder in host C++ (sequential
by nature; it fills a pinned ``int16`` coefficient buffer), and
``jpeg_pixels``, the pixel stage as two CUDA launches (dequantization and
the integer IDCT per 8 x 8 block into component planes; upsampling, YCbCr ->
BGR and the crop per output pixel).  Their plain versions are
``utils/jpeg.py``'s :func:`~gazenerf_tpu_torch.utils.jpeg.entropy_decode_reference`
and :func:`~gazenerf_tpu_torch.utils.jpeg.pixels_reference`, to the bit.

* :func:`decode_jpeg`: bytes -> BGR ``uint8 [H, W, 3]`` on the device (the
  card unless the caller asks for the CPU), EXIF orientation applied; None
  where ``cv2.imread`` gives None;
* :func:`entropy_decode`, :func:`jpeg_pixels`: the two stages' wrappers
  (``jpeg_pixels`` runs the plain version for a CPU tensor, the kernel for a
  CUDA tensor).
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from gazenerf_tpu_torch.kernels import build
from gazenerf_tpu_torch.models.gaze_nerf import resolve_device
from gazenerf_tpu_torch.utils import jpeg as J

KERNEL = "jpeg_decode"
DEFINES: dict = {}

# pixel-stage launches since import (or since a caller reset it): one per
# decoded frame (its IDCT and its colour kernel)
launch_count = 0

logger = logging.getLogger(__name__)
_COLORS = {"grey": 0, "ycc": 1, "rgb": 2}
_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL, DEFINES)
    lib.jpeg_entropy_decode.argtypes = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                        _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]
    lib.jpeg_entropy_decode.restype = ctypes.c_int
    lib.jpeg_pixels.argtypes = [_P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_longlong, _P]
    lib.jpeg_pixels.restype = ctypes.c_int
    return lib


def scan_arguments(hdr: J.Header) -> Tuple[np.ndarray, np.ndarray]:
    """The entropy decoder's description of the scan: per scan component
    ``h, v, blocks_w, first block`` (int32) and its DC and AC tables, each
    16 counts and 256 values (uint8)."""
    comp = np.array([[c.h, c.v, c.blocks_w, c.offset]
                     for c in (hdr.components[i] for i in hdr.scan)], np.int32)
    tables = np.zeros((len(hdr.scan), 2, 272), np.uint8)
    for k, pair in enumerate(hdr.tables):
        for j, (bits, vals) in enumerate(pair):
            tables[k, j, :16] = np.frombuffer(bits, np.uint8)
            tables[k, j, 16:16 + len(vals)] = np.frombuffer(vals, np.uint8)
    return comp, tables


def entropy_decode(data: bytes, hdr: J.Header, out: torch.Tensor) -> int:
    """The native entropy decoder: fills ``out`` (``int16 [n_blocks, 64]``,
    contiguous, on the host; pinned for the copy to the card) -> the
    ``WARN_*`` bits of ``utils/jpeg.py``."""
    if out.dtype != torch.int16 or out.device.type != "cpu" or not out.is_contiguous():
        raise ValueError("out: int16, contiguous, on the host")
    if tuple(out.shape) != (hdr.n_blocks, 64):
        raise ValueError(f"out: shape {tuple(out.shape)}, expected ({hdr.n_blocks}, 64)")
    comp, tables = scan_arguments(hdr)
    buf = np.frombuffer(data, np.uint8)
    warn = ctypes.c_int(0)
    err = _library().jpeg_entropy_decode(
        buf.ctypes.data, len(data), hdr.scan_start, len(hdr.scan), comp.ctypes.data,
        tables.ctypes.data, hdr.mcus_x, hdr.mcus_y, hdr.restart_interval, out.data_ptr(),
        ctypes.byref(warn))
    if err:
        raise RuntimeError(
            f"jpeg_entropy_decode failed ({err}): a Huffman table is not a prefix code")
    return warn.value


def pixel_arguments(hdr: J.Header) -> Tuple[np.ndarray, np.ndarray, int]:
    """The pixel stage's layout: per component ``block0, plane0, blocks_w,
    blocks_h, dw, dh, method, hexp, vexp`` (int32), the quantization tables
    (int32, natural order) and the planes' bytes."""
    rows, plane0 = [], 0
    for c in hdr.components:
        rows.append([c.offset, plane0, c.blocks_w, c.blocks_h, c.dw, c.dh, c.method, c.hexp,
                     c.vexp])
        plane0 += 64 * c.blocks_w * c.blocks_h
    return (np.array(rows, np.int32), np.ascontiguousarray(hdr.qtables, np.int32), plane0)


def jpeg_pixels(coef: torch.Tensor, hdr: J.Header) -> torch.Tensor:
    """The pixel stage's wrapper: ``int16 [n_blocks, 64]`` -> BGR ``uint8
    [height, width, 3]`` before the EXIF orientation.  CUDA tensors launch
    the kernel (on the current stream, no synchronisation); CPU tensors take
    :func:`~gazenerf_tpu_torch.utils.jpeg.pixels_reference`."""
    global launch_count
    if coef.device.type == "cpu":
        return J.pixels_reference(coef, hdr)
    if coef.device.type != "cuda":
        raise ValueError(f"no JPEG kernel for device {coef.device}")
    if coef.dtype != torch.int16 or not coef.is_contiguous():
        raise ValueError("coef: int16, contiguous")
    if tuple(coef.shape) != (hdr.n_blocks, 64):
        raise ValueError(f"coef: shape {tuple(coef.shape)}, expected ({hdr.n_blocks}, 64)")
    comp, qt, plane_bytes = pixel_arguments(hdr)
    planes = torch.empty(plane_bytes, dtype=torch.uint8, device=coef.device)
    bgr = torch.empty((hdr.height, hdr.width, 3), dtype=torch.uint8, device=coef.device)
    err = _library().jpeg_pixels(
        coef.data_ptr(), planes.data_ptr(), bgr.data_ptr(), len(hdr.components),
        comp.ctypes.data, qt.ctypes.data, hdr.width, hdr.height, _COLORS[hdr.color],
        hdr.n_blocks, torch.cuda.current_stream(coef.device).cuda_stream)
    if err:
        raise RuntimeError(f"jpeg_pixels launch failed with CUDA error {err}")
    launch_count += 1
    return bgr


def decode_jpeg(data: bytes, device=None) -> Optional[torch.Tensor]:
    """``cv2.imread`` of a baseline JPEG file's bytes -> BGR ``uint8 [H, W,
    3]`` on ``device`` (the card unless told otherwise), grey replicated, the
    EXIF orientation applied; None where cv2 gives None (no JPEG, headers
    cut or malformed).  On the card the native entropy decoder and the
    kernel, on the CPU the plain versions; a failed build or launch raises.
    Files this decoder does not read raise ``NotImplementedError``."""
    dev = resolve_device(device)
    hdr = J.parse_header(data)
    if hdr is None:
        return None
    if dev.type == "cpu":
        coef, warn = J.entropy_decode_reference(data, hdr)
        coef = torch.from_numpy(coef)
    elif dev.type == "cuda":
        host = torch.empty((hdr.n_blocks, 64), dtype=torch.int16, pin_memory=True)
        warn = entropy_decode(data, hdr, host)
        coef = host.to(dev, non_blocking=True)
    else:
        raise ValueError(f"no JPEG decoder for device {dev}")
    for bit, text in J.WARNINGS.items():
        if warn & bit:
            logger.warning("%s", text)
    return J.orient(jpeg_pixels(coef, hdr), hdr.orientation)
