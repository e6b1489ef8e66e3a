"""The port's frame reading against ``cv2.imread`` (OpenCV 5.0.0 with
libjpeg-turbo 3.1.2 where these tests ran), exactly equal: baseline JPEG
(``utils/jpeg.py`` through ``kernels/jpeg.decode_jpeg`` on the CPU, the
plain versions of the card's entropy decoder and pixel kernel) and BMP
(``utils/bmp.py``), through ``preprocess/driver.read_frame``.  The JPEGs
are written by ``cv2.imencode`` in the tests: every sampling factor at odd
sizes, grey, restart intervals, the eight EXIF orientations in both byte
orders, cut scans and cut headers.  The committed fixtures
(``tests/data/jpeg``, ``tools/make_jpeg_fixtures.py``) are held to
``cv2.imread`` of their JPEGs, so that the card's checks cannot drift from
their yardstick."""

import hashlib
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")  # the yardstick

from gazenerf_tpu_torch.kernels import checks  # noqa: E402
from gazenerf_tpu_torch.kernels import jpeg as KJ  # noqa: E402
from gazenerf_tpu_torch.preprocess.driver import read_frame  # noqa: E402
from gazenerf_tpu_torch.utils import jpeg as J  # noqa: E402
from gazenerf_tpu_torch.utils.png import decode_png  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

SAMPLINGS = ("411", "420", "422", "440", "444")
SIZES = ((53, 37), (30, 61))  # (height, width)


def _frame(rng, h, w):
    """Smooth bands, edges and noise in each channel."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([128 + 60 * np.sin(xx / 9.7 + yy / 5.3), 100 + 3 * yy,
                     128 + 50 * np.cos(xx / 6.1 - yy / 3.7)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _encode(img, quality=90, sampling="420", restart=0, progressive=False):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def _same_as_cv2(tmp_path, data, name="frame.jpg"):
    """Write ``data``, read it with both; the port's pixels (or None)."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    got, want = read_frame(p, device="cpu"), cv2.imread(p)
    if want is None:
        assert got is None
    else:
        assert got is not None and got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), int((got != want).sum())
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", (50, 95))
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_sampling_factors_match_cv2(tmp_path, sampling, quality, size):
    rng = np.random.default_rng([int(sampling), quality, *size])
    _same_as_cv2(tmp_path, _encode(_frame(rng, *size), quality, sampling))


@pytest.mark.parametrize("quality", (50, 95))
def test_grey_matches_cv2(tmp_path, quality):
    """One component, replicated to three channels as ``IMREAD_COLOR``
    does."""
    got = _same_as_cv2(tmp_path, _encode(_frame(np.random.default_rng(quality), 53, 37)[..., 1],
                                         quality))
    assert np.array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("restart", (1, 3, 5))
@pytest.mark.parametrize("sampling", ("420", "422", "444"))
def test_restart_intervals_match_cv2(tmp_path, sampling, restart):
    """Restart markers every 1, 3 or 5 MCUs: most fall in the middle of an
    MCU row."""
    data = _encode(_frame(np.random.default_rng(restart), 45, 67), 85, sampling, restart)
    assert J.parse_header(data).restart_interval == restart
    _same_as_cv2(tmp_path, data)


def _exif_app1(orientation: int, little: bool) -> bytes:
    """An APP1 segment: ``Exif\\0\\0``, a TIFF header and IFD0 with a Make
    entry and then the orientation (SHORT)."""
    e = "<" if little else ">"
    tiff = (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
    tiff += struct.pack(e + "HHI", 0x010F, 2, 4) + b"Cam\0"
    tiff += struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    return _app1(b"Exif\0\0" + tiff)


def _app1(body: bytes) -> bytes:
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _after_app0(jpg: bytes, segment: bytes) -> bytes:
    end = 4 + struct.unpack(">H", jpg[4:6])[0]
    return jpg[:end] + segment + jpg[end:]


@pytest.mark.parametrize("little", (True, False), ids=("II", "MM"))
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations_match_cv2(tmp_path, orientation, little):
    """cv2 applies the orientation after decoding: 5-8 turn a 37 x 53 frame
    into 53 x 37."""
    data = _encode(_frame(np.random.default_rng(orientation), 53, 37), 80)
    got = _same_as_cv2(tmp_path, _after_app0(data, _exif_app1(orientation, little)))
    assert got.shape[:2] == ((37, 53) if orientation >= 5 else (53, 37))


def test_damaged_exif_is_ignored_as_cv2_ignores_it(tmp_path):
    """EXIF blocks cv2 cannot parse leave the frame as it is: IFD0 past the
    block, the block cut inside the orientation's entry, a bad TIFF mark,
    no TIFF header at all; a second, sound block after a damaged one is
    read."""
    data = _encode(_frame(np.random.default_rng(7), 53, 37), 80)
    sound = _exif_app1(6, True)[4:]  # Exif\0\0 + TIFF
    damaged = [b"Exif\0\0II" + struct.pack("<HI", 42, 4000) + bytes(8),
               sound[:6 + 8 + 2 + 12 + 6], b"Exif\0\0II" + struct.pack("<HI", 43, 8) + bytes(16),
               b"Exif\0\0", b"Exif\0\0MMxx"]
    for k, body in enumerate(damaged):
        got = _same_as_cv2(tmp_path, _after_app0(data, _app1(body)), f"damaged{k}.jpg")
        assert got.shape[:2] == (53, 37), k
    got = _same_as_cv2(tmp_path, _after_app0(data, _app1(damaged[0]) + _app1(sound)))
    assert got.shape[:2] == (37, 53)


def test_cut_files_read_as_cv2_reads_them(tmp_path, caplog):
    """A scan cut short is an image, the blocks never reached grey, with
    libjpeg's warning; a file cut inside its headers is None; a file that
    ends without EOI reads whole."""
    data = _encode(_frame(np.random.default_rng(3), 53, 37), 90)
    scan = data.index(b"\xff\xda")
    got = _same_as_cv2(tmp_path, data[:scan + (len(data) - scan) // 2], "half.jpg")
    assert (got[-8:] == 128).all()  # the last block row never reached
    assert "Premature end of JPEG file" in caplog.text
    rst = _encode(_frame(np.random.default_rng(4), 45, 67), 85, "422", 2)
    _same_as_cv2(tmp_path, rst[:len(rst) * 2 // 3], "rst_cut.jpg")
    for cut in (1, 40, scan, scan + 6):
        assert _same_as_cv2(tmp_path, data[:cut], f"head{cut}.jpg") is None
    assert _same_as_cv2(tmp_path, data[:-2], "no_eoi.jpg") is not None


def test_over_full_huffman_table_reads_as_none(tmp_path):
    """A Huffman table whose code lengths overflow (three 1-bit codes, five
    2-bit codes) is libjpeg's error: cv2 gives None, and so does the port."""
    data = _encode(_frame(np.random.default_rng(10), 20, 20), 90)
    bits = data.index(b"\xff\xc4") + 5  # the first table's 16 counts
    for k, count in ((0, 3), (1, 5)):
        bad = data[:bits + k] + bytes([count]) + data[bits + k + 1:]
        assert _same_as_cv2(tmp_path, bad, f"table{k}.jpg") is None


def _patch_sof(data: bytes, marker: int = 0xC0, precision: int = 8) -> bytes:
    at = data.index(b"\xff\xc0")
    return (data[:at + 1] + bytes([marker]) + data[at + 2:at + 4] + bytes([precision])
            + data[at + 5:])


def test_files_it_does_not_read_raise_naming_file_and_item(tmp_path):
    """Progressive, 12-bit, arithmetic-coded, lossless and CMYK files raise
    ``NotImplementedError`` naming the file and their ROADMAP item (cv2
    reads progressive and CMYK files)."""
    from PIL import Image

    data = _encode(_frame(np.random.default_rng(5), 24, 40), 90)
    cmyk = io.BytesIO()
    Image.fromarray(_frame(np.random.default_rng(6), 24, 40)).convert("CMYK").save(cmyk, "JPEG")
    cases = {
        "progressive": (_encode(_frame(np.random.default_rng(5), 24, 40), 90, progressive=True),
                        "progressive", 9),
        "twelve_bit": (_patch_sof(data, 0xC1, 12), "12-bit", 11),
        "arithmetic": (_patch_sof(data, 0xC9), "arithmetic", 10),
        "lossless": (_patch_sof(data, 0xC3), "lossless", 13),
        "cmyk": (cmyk.getvalue(), "CMYK", 12),
    }
    for name, (blob, feature, item) in cases.items():
        p = tmp_path / f"{name}_frame.jpg"
        p.write_bytes(blob)
        match = f"{name}_frame.jpg: {feature}.*ROADMAP Queue 1 item {item}"
        with pytest.raises(NotImplementedError, match=match):
            read_frame(str(p), device="cpu")
    assert cv2.imread(str(tmp_path / "progressive_frame.jpg")) is not None
    assert cv2.imread(str(tmp_path / "cmyk_frame.jpg")) is not None


FIXTURES = checks.jpeg_fixture_names()


def test_fixtures_are_listed():
    assert len(FIXTURES) == 10 and {"cut_s420_37x53", "grey_q75_37x53"} <= set(FIXTURES)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_cv2_imread_of_its_jpeg(name):
    """The committed PNG is ``cv2.imread`` of the committed JPEG, and the
    port (CPU) reads the JPEG to it."""
    path = str(checks.JPEG_FIXTURES / f"{name}.jpg")
    want = cv2.imread(path)
    with open(checks.JPEG_FIXTURES / f"{name}.png", "rb") as f:
        committed = decode_png(f.read())[..., ::-1]
    assert np.array_equal(committed, want)
    assert np.array_equal(read_frame(path, device="cpu"), want)


@pytest.mark.parametrize("name", sorted(checks.JPEG_STRIP_REPEATS))
def test_strip_digests_are_cv2_imread(name):
    """The full-width strips: ``strips.json`` holds the digests of
    ``cv2.imread``'s pixels of each strip and of the 6000 x 4000 frame
    stacked from it; the port (CPU) reads the strip to its digest."""
    with open(checks.JPEG_FIXTURES / "strips.json") as f:
        digests = json.load(f)[name]
    path = str(checks.JPEG_FIXTURES / f"{name}.jpg")
    with open(path, "rb") as f:
        data = f.read()
    for pixels, want in ((cv2.imread(path), digests),
                         (cv2.imdecode(np.frombuffer(checks.stack_jpeg_strip(
                             data, checks.JPEG_STRIP_REPEATS[name]), np.uint8),
                             cv2.IMREAD_COLOR), digests["stacked"])):
        assert list(pixels.shape) == want["shape"]
        assert hashlib.sha256(pixels.tobytes()).hexdigest() == want["sha256_bgr"]
    got = read_frame(path, device="cpu")
    assert hashlib.sha256(got.tobytes()).hexdigest() == digests["sha256_bgr"]


def test_stacked_strip_decodes_as_cv2_and_repeats_its_coefficients(tmp_path):
    """``checks.stack_jpeg_strip`` in small: a one-MCU-row strip stacked
    three times is a frame cv2 reads, the port reads it to cv2's pixels, and
    each restart segment's coefficients are the strip's alone."""
    strip = _encode(_frame(np.random.default_rng(8), 16, 61), 90, "420", restart=4)
    stacked = checks.stack_jpeg_strip(strip, 3)
    assert _same_as_cv2(tmp_path, stacked).shape == (48, 61, 3)
    one, big = J.parse_header(strip), J.parse_header(stacked)
    coef_one, warn_one = J.entropy_decode_reference(strip, one)
    coef_big, warn_big = J.entropy_decode_reference(stacked, big)
    assert warn_one == warn_big == 0
    for c1, cb in zip(one.components, big.components):
        plane = coef_one[c1.offset:c1.offset + c1.blocks_w * c1.blocks_h]
        tall = coef_big[cb.offset:cb.offset + cb.blocks_w * cb.blocks_h]
        assert np.array_equal(tall.reshape(3, *plane.shape),
                              np.broadcast_to(plane, (3, *plane.shape)))
    with pytest.raises(ValueError, match="one-MCU-row strip"):
        checks.stack_jpeg_strip(_encode(_frame(np.random.default_rng(8), 16, 61), 90, "420"), 3)


def test_pixel_wrapper_takes_the_plain_version_on_the_cpu():
    """``jpeg_pixels`` on a CPU tensor is the plain pixel stage and counts
    no launch; a device it has no kernel for raises."""
    data = _encode(_frame(np.random.default_rng(9), 30, 61), 75, "422")
    hdr = J.parse_header(data)
    coef, _ = J.entropy_decode_reference(data, hdr)
    before = KJ.launch_count
    got = KJ.jpeg_pixels(torch.from_numpy(coef), hdr)
    assert KJ.launch_count == before
    assert torch.equal(got, J.pixels_reference(torch.from_numpy(coef), hdr))
    with pytest.raises(ValueError, match="no JPEG kernel"):
        KJ.jpeg_pixels(torch.from_numpy(coef).to("meta"), hdr)
    with pytest.raises(ValueError, match="int16, contiguous, on the host"):
        KJ.entropy_decode(data, hdr, torch.empty((hdr.n_blocks, 64), dtype=torch.int32))


_BLOCKED = """
import sys
for blocked in ("jax", "jaxlib", "flax", "gazenerf_tpu", "cv2", "imageio", "PIL"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
import numpy as np
from gazenerf_tpu_torch.kernels import checks
from gazenerf_tpu_torch.preprocess.driver import read_frame
from gazenerf_tpu_torch.utils.png import decode_png
name = "exif6_mm_s420_37x53"
got = read_frame(str(checks.JPEG_FIXTURES / (name + ".jpg")), device="cpu")
want = decode_png((checks.JPEG_FIXTURES / (name + ".png")).read_bytes())[..., ::-1]
print(got.shape, bool(np.array_equal(got, want)))
"""


def test_jpeg_reads_without_cv2_or_pil():
    """The readers run where JAX, the JAX package, OpenCV, imageio and PIL
    cannot be imported at all, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.strip() == "(37, 53, 3) True"


def test_decode_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """``decode_jpeg`` and ``read_frame`` default to the card and raise
    without one; they never fall back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(checks.JPEG_FIXTURES / "s444_q95_37x53.jpg")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        read_frame(path)
    with open(path, "rb") as f:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KJ.decode_jpeg(f.read())


# ---------------- BMP ---------------------------------------------------------


def _bmp(img) -> bytes:
    ok, buf = cv2.imencode(".bmp", img)
    assert ok
    return buf.tobytes()


def _top_down(data: bytes) -> bytes:
    """The same BMP stored top-down (a negative height, rows reversed)."""
    offset = struct.unpack_from("<I", data, 10)[0]
    width, height, _, bpp = struct.unpack_from("<iiHH", data, 18)
    stride = (width * bpp + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    out = bytearray(data)
    struct.pack_into("<i", out, 22, -height)
    out[offset:offset + stride * height] = rows[::-1].tobytes()
    return bytes(out)


@pytest.mark.parametrize("channels", (3, 1, 4), ids=("24bit", "8bit_palette", "32bit"))
def test_bmp_matches_cv2(tmp_path, channels):
    """What ``cv2.imwrite`` writes (24-bit; 8-bit with a grey palette;
    32-bit with its bit fields), bottom-up and top-down, at an odd width
    (padded rows); a file cut short is None, as cv2 gives."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (7, 13, channels), dtype=np.uint8)
    data = _bmp(img if channels > 1 else img[..., 0])
    assert _same_as_cv2(tmp_path, data, "frame.bmp").shape == (7, 13, 3)
    _same_as_cv2(tmp_path, _top_down(data), "top_down.bmp")
    assert _same_as_cv2(tmp_path, data[:-5], "cut.bmp") is None


def test_bmp_it_does_not_read_raises_naming_file(tmp_path):
    """RLE and bit fields other than whole bytes raise."""
    data = _bmp(np.random.default_rng(0).integers(0, 256, (7, 13, 4), dtype=np.uint8))
    rle = bytearray(_bmp(np.zeros((4, 4), np.uint8)))
    struct.pack_into("<I", rle, 30, 1)
    odd = data[:54] + struct.pack("<I", 0x00FFF000) + data[58:]
    for name, blob, match in (("rle8.bmp", bytes(rle), "RLE"), ("fields.bmp", odd, "bit-field")):
        p = tmp_path / name
        p.write_bytes(blob)
        with pytest.raises(NotImplementedError, match=f"{name}.*{match}"):
            read_frame(str(p))
