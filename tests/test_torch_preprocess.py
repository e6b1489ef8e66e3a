"""The port's offline data factory without the nets and the fit: its
OpenCV replacements against OpenCV (5.0.0 where these tests ran), to the pixel
(``preprocess/normalize.py``: ``undistort``, ``Undistorter``,
``warp_affine`` with ``rotation_matrix_2d``, ``resize_area_u8``;
``preprocess/masks.py``; ``preprocess/landmarks.py``'s grey and equalized
images; ``utils/png.decode_png`` and ``preprocess/driver.read_frame``),
and its functions against the JAX package's (the gaze conversions, the
resizes BiSeNet uses, ``side_by_side``, the landmark fallbacks, the masks,
the five raw layouts' enumeration and ``process_frame``)."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")  # the JAX side and the references call OpenCV

import jax.numpy as jnp  # noqa: E402

from gazenerf_tpu.ops import image as JI  # noqa: E402
from gazenerf_tpu.preprocess import driver as JD  # noqa: E402
from gazenerf_tpu.preprocess import enumerate as JE  # noqa: E402
from gazenerf_tpu.preprocess import landmarks as JL  # noqa: E402
from gazenerf_tpu.preprocess import masks as JM  # noqa: E402
from gazenerf_tpu.preprocess import normalize as JN  # noqa: E402
from gazenerf_tpu.utils.logging import side_by_side as jax_side_by_side  # noqa: E402
from gazenerf_tpu_torch.ops import image as I  # noqa: E402
from gazenerf_tpu_torch.preprocess import driver as D  # noqa: E402
from gazenerf_tpu_torch.preprocess import enumerate as E  # noqa: E402
from gazenerf_tpu_torch.preprocess import landmarks as L  # noqa: E402
from gazenerf_tpu_torch.preprocess import masks as M  # noqa: E402
from gazenerf_tpu_torch.preprocess import normalize as N  # noqa: E402
from gazenerf_tpu_torch.utils.logging import side_by_side  # noqa: E402
from gazenerf_tpu_torch.utils.png import decode_png  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

FACE_MODEL_6 = np.array([[-45.0, -30.0, 30.0], [-15.0, -30.0, 35.0], [15.0, -30.0, 35.0],
                         [45.0, -30.0, 30.0], [-25.0, 30.0, 30.0], [25.0, 30.0, 30.0]])
K = np.array([[610.0, 0, 121.3], [0, 600.0, 119.7], [0, 0, 1.0]])
DIST = np.array([[-0.12], [0.05], [0.001], [-0.002], [0.01]])
# the warp to the virtual camera (``normalize.warp_perspective``): 1 level on at
# most this share of the pixels (tests/test_torch_normalize.py)
WARP_MAX_LEVELS, WARP_MAX_SHARE = 1, 1e-3


def _image(rng, h, w, c=3):
    """Smooth ramps plus noise: edges and flat areas both."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 2) % 256, ((xx - yy) * 5) % 256], -1)[..., :c]
    return (base * 0.7 + rng.random((h, w, c)) * 76).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------- PNG reading -------------------------------------------


@pytest.mark.parametrize("filt", ["NONE", "SUB", "UP", "AVG", "PAETH", "ALL"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_reads_what_cv2_writes(tmp_path, filt, channels):
    """``decode_png`` against ``cv2.imread(IMREAD_UNCHANGED)`` to the byte on
    PNGs ``cv2.imwrite`` writes with each scanline filter (and all of them,
    chosen per row), grey, RGB and RGBA."""
    img = _image(np.random.default_rng(channels), 37, 53, 3)
    if channels == 1:
        img = img[..., 0]
    elif channels == 4:
        img = np.concatenate([img, img[..., :1] ^ 0x5A], -1)
    flag = (cv2.IMWRITE_PNG_ALL_FILTERS if filt == "ALL"
            else getattr(cv2, "IMWRITE_PNG_FILTER_" + filt))
    p = str(tmp_path / "f.png")
    cv2.imwrite(p, img, [cv2.IMWRITE_PNG_FILTER, flag])
    got = decode_png(open(p, "rb").read())
    want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if channels > 1:
        got = got[..., [2, 1, 0, 3][:channels]]  # RGB(A) -> cv2's BGR(A)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_read_frame_is_cv2_imread_and_refuses_jpeg(tmp_path):
    """``read_frame`` is ``cv2.imread`` (BGR, grey replicated, alpha
    dropped) on PNGs, and on JPEGs on the CPU (``kernels/jpeg.decode_jpeg``'s
    plain path; every sampling factor, EXIF and damage in
    ``tests/test_torch_jpeg.py``); a JPEG it does not read yet
    (progressive) raises naming the file and the ROADMAP item; an
    unreadable file reads as None, as cv2 gives."""
    rng = np.random.default_rng(0)
    for name, img in (("rgb.png", _image(rng, 20, 30)), ("grey.png", _image(rng, 20, 30)[..., 0]),
                      ("rgba.png", _image(rng, 20, 30, 3).repeat(2, -1)[..., :4])):
        p = str(tmp_path / name)
        cv2.imwrite(p, img)
        assert np.array_equal(D.read_frame(p), cv2.imread(p)), name
    for name, img in (("frame0000_cam00.jpg", _image(rng, 21, 30)),
                      ("grey.jpeg", _image(rng, 21, 30)[..., 0])):
        p = str(tmp_path / name)
        cv2.imwrite(p, img)
        assert np.array_equal(D.read_frame(p, device="cpu"), cv2.imread(p)), name
    jpg = str(tmp_path / "frame0001_cam00.jpg")
    cv2.imwrite(jpg, _image(rng, 20, 30), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError,
                       match="frame0001_cam00.jpg: progressive.*ROADMAP Queue 1 item 9"):
        D.read_frame(jpg, device="cpu")
    bad = str(tmp_path / "broken.png")
    open(bad, "wb").write(b"\x89PNG\r\n\x1a\nnot a png")
    assert D.read_frame(bad) is None and cv2.imread(bad) is None


def _palette_png(idx: np.ndarray, palette: np.ndarray) -> bytes:
    """An 8-bit palette PNG (colour type 3, filter 0) of ``idx`` [H, W]."""
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    h, w = idx.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), idx.astype(np.uint8)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", palette.astype(np.uint8).tobytes())
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def test_read_frame_refuses_png_it_cannot_decode(tmp_path):
    """A valid PNG that ``decode_png`` does not read (16-bit from
    ``cv2.imwrite``, palette) raises ``NotImplementedError`` naming the file,
    where ``cv2.imread`` reads it: the frame is never dropped as unreadable."""
    rng = np.random.default_rng(1)
    deep = str(tmp_path / "deep16.png")
    cv2.imwrite(deep, rng.integers(0, 65536, (12, 9, 3), dtype=np.uint16))
    pal = str(tmp_path / "palette.png")
    open(pal, "wb").write(_palette_png(rng.integers(0, 4, (12, 9)),
                                       rng.integers(0, 256, (4, 3))))
    for p in (deep, pal):
        assert cv2.imread(p) is not None and cv2.imread(p).shape == (12, 9, 3)
        with pytest.raises(NotImplementedError, match=os.path.basename(p)):
            D.read_frame(p)


# ---------------- OpenCV's image functions --------------------------------


@pytest.mark.parametrize("shape", [(240, 240), (97, 131), (480, 640)])
def test_undistort_and_undistorter_match_cv2(shape):
    """``undistort`` is ``cv2.undistort`` (fixed-point maps, 1/32 pixel,
    15-bit weights) and ``Undistorter`` is ``initUndistortRectifyMap(...,
    CV_32FC1)`` + ``remap`` (f32 lerps): equal to the pixel."""
    img = _image(np.random.default_rng(shape[0]), *shape)
    Kc = K.copy()
    Kc[0, 2], Kc[1, 2] = shape[1] / 2 + 1.3, shape[0] / 2 - 0.3
    for dist in (DIST, np.array([0.3, -0.2, 0.01, 0.0, 0.05])):
        np.testing.assert_array_equal(N.undistort(_t(img), Kc, dist).numpy(),
                                      cv2.undistort(img, Kc, dist))
        maps = cv2.initUndistortRectifyMap(Kc, dist, None, Kc, shape[::-1], cv2.CV_32FC1)
        und = N.Undistorter()
        for _ in range(2):  # the second call reads the cached maps
            np.testing.assert_array_equal(und(_t(img), Kc, dist).numpy(),
                                          cv2.remap(img, maps[0], maps[1], cv2.INTER_LINEAR))


@pytest.mark.parametrize("shape", [(240, 240), (97, 131)])
def test_rotate180_matches_cv2(shape):
    """The upside-down cameras' turn: ``getRotationMatrix2D((w/2, h/2), 180,
    1)`` and ``warpAffine``, equal to cv2's matrix and pixels (one pixel
    off a flip, with a black first row and column)."""
    img = _image(np.random.default_rng(1), *shape)
    h, w = shape
    M_ = N.rotation_matrix_2d((w / 2, h / 2), 180, 1.0)
    ref_M = cv2.getRotationMatrix2D((w / 2, h / 2), 180, 1.0)
    np.testing.assert_array_equal(M_, ref_M)
    got = N.warp_affine(_t(img), M_, (w, h)).numpy()
    np.testing.assert_array_equal(got, cv2.warpAffine(img, ref_M, (w, h)))
    assert not got[0].any() and not got[:, 0].any()


@pytest.mark.parametrize("shape", [(120, 160), (700, 690), (1024, 1024), (1536, 1536),
                                   (300, 700), (512, 512)])
def test_area_resize_matches_cv2(shape):
    """``resize_area_u8`` against ``cv2.resize(INTER_AREA)`` to 512^2 (the
    Columbia crop's resize): enlarging, shrinking by a fraction, by 2 and 3,
    mixed and the identity, equal to the pixel."""
    img = _image(np.random.default_rng(shape[1]), *shape)
    np.testing.assert_array_equal(N.resize_area_u8(_t(img), (512, 512)).numpy(),
                                  cv2.resize(img, (512, 512), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("shape,size", [((512, 512), 128), ((512, 512), 64), ((300, 280), 128)])
def test_fit_resize_matches_cv2(shape, size):
    """The fit's input resize (``cv2.resize``, INTER_LINEAR) to the pixel."""
    img = _image(np.random.default_rng(size), *shape)
    np.testing.assert_array_equal(N.resize_linear_u8(_t(img), (size, size)).numpy(),
                                  cv2.resize(img, (size, size)))


def test_grey_and_equalized_images_match_cv2():
    """The landmark retry's ``cvtColor(RGB2GRAY)`` over every one of the
    2^24 colours, and ``equalizeHist`` on varied histograms, to the level."""
    v = np.arange(256, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(L.rgb_to_gray(cube), cv2.cvtColor(cube, cv2.COLOR_RGB2GRAY))
    rng = np.random.default_rng(0)
    for g in (cv2.cvtColor(_image(rng, 64, 80), cv2.COLOR_RGB2GRAY),
              np.full((10, 10), 7, np.uint8), (rng.random((64, 64)) * 40 + 100).astype(np.uint8),
              np.where(rng.random((30, 30)) > 0.5, 3, 250).astype(np.uint8)):
        np.testing.assert_array_equal(L.equalize_hist(g), cv2.equalizeHist(g))


# ---------------- masks ---------------------------------------------------


def test_convex_polygon_fill_matches_cv2():
    """``convex_hull`` + ``fill_convex_poly`` against ``convexHull`` +
    ``fillConvexPoly`` on 200 random point sets, many reaching past the
    image's edges (the outline is clipped as ``cv2.line`` clips it)."""
    rng = np.random.default_rng(0)
    for t in range(200):
        size = int(rng.integers(16, 160))
        n = int(rng.integers(3, 40))
        pts = (rng.uniform(-20, size + 20, (n, 2)) if t % 3
               else rng.normal(size / 2, size / 5, (n, 2))).astype(np.int32)
        want = np.zeros((size, size), np.uint8)
        cv2.fillConvexPoly(want, cv2.convexHull(pts), 255)
        got = np.zeros((size, size), np.uint8)
        M.fill_convex_poly(got, M.convex_hull(pts), 255)
        np.testing.assert_array_equal(got, want, err_msg=f"case {t}")


def test_landmark_masks_match_jax():
    """The no-weights masks against JAX's (cv2's hull and fill), for jittered
    landmark layouts (the forehead often above the image) and the
    half-profile cameras."""
    rng = np.random.default_rng(1)
    for t in range(60):
        box = rng.uniform(0, 60, 2).tolist() + rng.uniform(80, 128, 2).tolist()
        lm = L.synthetic_landmarks(box, jitter=2.0, seed=t)
        cam = (0, 11, 14)[t % 3]
        for got, want in zip(M.landmark_masks(lm, 128, cam), JM.landmark_masks(lm, 128, cam)):
            np.testing.assert_array_equal(got, want, err_msg=f"case {t}")


def test_head_mask_cleanup_matches_jax():
    """``correct_head_mask`` (largest component, hole fill from the corner,
    erosion) against JAX's cv2 calls on random blobs, on two components of
    equal area (the tie goes to the one cv2 labels first, by 2 x 2 blocks),
    on a foreground corner pixel (the fill makes everything foreground) and
    on background cut off from the corner (filled: it is not a hole fill)."""
    rng = np.random.default_rng(2)
    cases = []
    for t in range(120):
        size = int(rng.integers(8, 64))
        m = (rng.random((size, size)) > rng.uniform(0.3, 0.8)).astype(np.uint8) * 255
        cases.append(m)
    for t in range(40):  # rectangles, ties among them
        m = np.zeros((24, 24), np.uint8)
        for _ in range(int(rng.integers(2, 4))):
            y, x = rng.integers(0, 22, 2)
            m[y:y + 3, x:x + 3] = 255
        cases.append(m)
    tie = np.zeros((12, 12), np.uint8)
    tie[1:3, 6:8] = 255  # first in raster order of pixels, second by cv2's blocks
    tie[2:4, 0:2] = 255
    corner = np.zeros((10, 10), np.uint8)
    corner[0:4, 0:4] = 255
    cut = np.full((10, 10), 255, np.uint8)
    cut[6:, 6:] = 0
    cut[0:3, 0:3] = 0
    cut[5, :] = 255
    for i, m in enumerate(cases + [tie, corner, cut]):
        np.testing.assert_array_equal(M.correct_head_mask(m), JM.correct_head_mask(m),
                                      err_msg=f"case {i}")
    assert M.correct_head_mask(corner).min() == 255


# ---------------- small functions against JAX -----------------------------


def test_gaze_conversions_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        v = rng.normal(0, 1, 3)
        R = N.rodrigues(rng.normal(0, 0.4, 3))
        hR = N.rodrigues(rng.normal(0, 0.4, 3))
        np.testing.assert_array_equal(N.vector_to_pitchyaw(v), JN.vector_to_pitchyaw(v))
        np.testing.assert_allclose(N.normalize_gaze_vector(v, R), JN.normalize_gaze_vector(v, R),
                                   rtol=0, atol=1e-15)
        py = N.vector_to_pitchyaw(v)
        # JAX's pitch-yaw vector is XLA's f32 sin/cos (PyTorch's and XLA's
        # round one f32 step apart now and then, ROADMAP 3.5)
        np.testing.assert_allclose(N.gaze_to_head_coordinates(py, hR),
                                   JN.gaze_to_head_coordinates(py, hR), rtol=0, atol=5e-7)
        np.testing.assert_array_equal(N.normalized_head_pose(R, hR), JN.normalized_head_pose(R, hR))


@pytest.mark.parametrize("out_hw", [(64, 64), (37, 53), (7, 5), (1, 3)])
def test_bisenet_resizes_match_jax(out_hw):
    """``resize_nearest`` and ``resize_bilinear_align_corners`` on NCHW, as
    BiSeNet calls them, against JAX's on the same NHWC data: the same taps,
    f32."""
    x = np.random.default_rng(4).standard_normal((2, 16, 23, 5)).astype(np.float32)
    want_n = np.asarray(JI.resize_nearest(jnp.asarray(x), out_hw))
    want_b = np.asarray(JI.resize_bilinear_align_corners(jnp.asarray(x), out_hw))
    cf = _t(x.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(I.resize_nearest(cf, out_hw).permute(0, 2, 3, 1).numpy(), want_n)
    got_b = I.resize_bilinear_align_corners(cf, out_hw)
    np.testing.assert_allclose(got_b.permute(0, 2, 3, 1).numpy(), want_b, rtol=0, atol=1e-6)


def test_side_by_side_and_landmark_fallbacks_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.random((20, 30, 3)).astype(np.float32), _image(rng, 14, 10)
    np.testing.assert_array_equal(side_by_side(a, b, _t(a)), jax_side_by_side(a, b, a))
    for box in ((32, 24, 96, 120), (0.5, 3.25, 50, 70)):
        np.testing.assert_array_equal(L.synthetic_landmarks(box, jitter=1.5, seed=3),
                                      JL.synthetic_landmarks(box, jitter=1.5, seed=3))
    det, jdet = L.LandmarkDetector(), JL.LandmarkDetector()
    assert not det.available and not jdet.available  # face-alignment is not installed
    for img in (np.zeros((64, 48, 3), np.uint8), np.zeros((32, 32, 3), np.uint8)):
        np.testing.assert_array_equal(det(img), jdet(img))  # the second reuses the first


# ---------------- the raw layouts ------------------------------------------


def _write_xml(path, Kc, dist):
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("Camera_Matrix", Kc)
    fs.write("Distortion_Coefficients", np.asarray(dist, np.float64).reshape(-1, 1))
    fs.release()


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in w.__dataclass_fields__:
            a, b = getattr(g, field), getattr(w, field)
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=field)
            else:
                assert a == b, field


def test_five_layouts_enumerate_as_jax(tmp_path):
    """ETH-XGaze (frame folders, per-camera XML, CSV), MPIIFaceGaze (day
    folders, pNN.txt, Camera.mat), Columbia (labels in file names),
    GazeCapture (per-frame arrays; the Rodrigues rotation is the port's)
    and the flat layout give JAX's records, field by field."""
    import scipy.io

    from gazenerf_tpu.data.cameras import load_camera_calibrations as jax_calibrations
    from gazenerf_tpu_torch.data.cameras import load_camera_calibrations

    rng = np.random.default_rng(6)
    # ETH-XGaze
    subj, calib = tmp_path / "xgaze" / "subject0000", tmp_path / "xgaze" / "calib"
    calib.mkdir(parents=True)
    for c in range(18):
        _write_xml(str(calib / f"cam{c:02d}.xml"), K, np.zeros(4) + 0.001 * c)
    rows = []
    for f in range(2):
        (subj / f"frame{f:04d}").mkdir(parents=True)
        for c in (2, 3, 7, 13):
            name = f"frame{f:04d}_cam{c:02d}.JPG"
            (subj / f"frame{f:04d}" / name).write_bytes(b"")
            if (f, c) != (1, 7):  # one frame without an annotation row
                rows.append([f"frame{f:04d}", name, "0.1", "-0.2", "0.05", "-0.02", "-0.99",
                             str(0.01 * c), "-0.02", "0.03", "5.0", "-3.0", "580.0"])
        (subj / f"frame{f:04d}" / "frame_cam00_resized.JPG").write_bytes(b"")
    csv_path = tmp_path / "xgaze" / "subject0000.csv"
    csv_path.write_text("\n".join(",".join(r) for r in rows))
    got = E.iter_xgaze_subject(str(subj), str(csv_path), load_camera_calibrations("eth_xgaze",
                                                                                  str(calib)))
    _same_records(got, JE.iter_xgaze_subject(str(subj), str(csv_path),
                                             jax_calibrations("eth_xgaze", str(calib))))
    assert [r.rotate180 for r in got[:4]] == [False, True, False, True]
    # MPIIFaceGaze
    mp = tmp_path / "p03"
    (mp / "Calibration").mkdir(parents=True)
    scipy.io.savemat(str(mp / "Calibration" / "Camera.mat"),
                     {"cameraMatrix": K, "distCoeffs": DIST.T})
    lines = []
    for day in ("day01", "day02"):
        (mp / day).mkdir()
        for name in ("0001.jpg", "0002.png"):
            (mp / day / name).write_bytes(b"")
            lines.append(" ".join([f"{day}/{name}"] + ["0"] * 14 + ["0.01", "-0.02", "0.03",
                         "1.0", "2.0", "580.0", "0.5", "1.0", "575.0", "0.05", "-0.02", "-0.99"]))
    (mp / "p03.txt").write_text("\n".join(lines[:-1]))
    _same_records(E.iter_mpii_subject(str(mp)), JE.iter_mpii_subject(str(mp)))
    # Columbia and the flat layout
    col = tmp_path / "0001"
    col.mkdir()
    for name in ("0001_2m_0P_-10V_5H.jpg", "0001_2m_15P_10V_-5H.png", "bad_name.png",
                 "0001_2m_0P_0V_0H_resized.jpg", "notes.txt"):
        (col / name).write_bytes(b"")
    _same_records(E.iter_columbia_subject(str(col), K, DIST),
                  JE.iter_columbia_subject(str(col), K, DIST))
    _same_records(E.iter_flat_subject(str(col), K, cam_index=4),
                  JE.iter_flat_subject(str(col), K, cam_index=4))
    # GazeCapture
    gc = tmp_path / "gc"
    gc.mkdir()
    for i in range(3):
        (gc / f"{i:05d}.jpg").write_bytes(b"")
    anno = {"camera_parameters": rng.uniform(500, 700, (3, 4)),
            "distortion_parameters": rng.normal(0, 0.01, (3, 5)),
            "head_pose": np.concatenate([rng.normal(0, 0.3, (3, 3)), rng.normal(0, 20, (3, 3))
                                         + [0, 0, 500]], 1),
            "3d_gaze_target": rng.normal(0, 50, (3, 3))}
    fm3d = rng.normal(0, 30, (14, 3))
    _same_records(E.iter_gazecapture_subject(str(gc), anno, fm3d),
                  JE.iter_gazecapture_subject(str(gc), anno, fm3d))


# ---------------- one frame through the pipeline ----------------------------


class _PosedLandmarks:
    """A landmark source without a detector (``available`` False) whose six
    face-model rows are the model's projection at a head pose (so the pose
    from them has one minimum) and the rest the synthetic layout."""

    available = False

    def __init__(self, rvec, tvec):
        self.rvec, self.tvec = rvec, tvec

    def __call__(self, img):
        h, w = img.shape[:2]
        lm = L.synthetic_landmarks((w * 0.25, h * 0.2, w * 0.75, h * 0.85))
        lm[D.FACE_MODEL_LM68] = N.project_points(FACE_MODEL_6, self.rvec, self.tvec, K) + 0.3
        return lm


@pytest.mark.parametrize("case", ["xgaze_rotated", "flat_pnp", "columbia", "mpii"])
def test_process_frame_matches_jax(case):
    """``process_frame`` on a synthetic frame against JAX's, each h5 field:
    the undistortion, the 180-degree turn, Columbia's crop and resize, the
    face centre, the head pose from the landmarks, the landmark fallback and
    its masks, the gaze in head coordinates.  The warp to the virtual camera
    is ``warp_perspective``'s (1 level on at most WARP_MAX_SHARE of the pixels); every
    other field is equal, the angles to 1e-6 (f32 sin and cos) and the
    landmarks through the warp's homography to 1e-4 px."""
    rng = np.random.default_rng(7)
    img = _image(rng, 240, 320)
    kw = dict(cam_index=3, img_size=64, gaze_vector=np.array([0.05, -0.02, -0.99]))
    det, jdet = L.LandmarkDetector(), JL.LandmarkDetector()
    if case == "flat_pnp":  # the head pose from the landmarks (solvePnP in JAX)
        det = jdet = _PosedLandmarks(np.array([0.1, -0.2, 0.05]), np.array([10.0, -5.0, 600.0]))
    if case == "xgaze_rotated":
        kw.update(dist_coeffs=DIST, undistort=True, rotate180=True,
                  head_pose=(np.array([0.03, -0.02, 0.03]), np.array([5.0, -3.0, 580.0])))
    elif case == "flat_pnp":  # the head pose from the landmarks
        kw.update(dataset="mpii_face_gaze")
    elif case == "columbia":
        kw.update(dataset="columbia", columbia_crop=True,
                  pitchyaw_head_direct=np.array([0.1, -0.05], np.float32),
                  head_pose=(np.array([0.0, 0.1, 0.0]), np.array([0.0, 0.0, 700.0])))
    else:
        kw.update(dataset="mpii_face_gaze", face_center=np.array([0.5, 1.0, 575.0]),
                  head_pose=(np.array([0.01, -0.02, 0.03]), np.array([1.0, 2.0, 580.0])))
    got = D.process_frame(img, K, FACE_MODEL_6, det, device="cpu", **kw)
    want = JD.process_frame(img, K, FACE_MODEL_6, jdet, **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "face_patch":
            d = np.abs(g.astype(int) - w.astype(int))
            assert d.max() <= WARP_MAX_LEVELS and (d > 0).mean() <= WARP_MAX_SHARE, (
                d.max(), (d > 0).mean())
        elif key in ("pitchyaw_head", "face_head_pose"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        elif key == "facial_landmarks":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_flat_layout_pose_is_the_better_minimum():
    """Without a landmark detector the synthetic layout does not fit the
    6-point face model, and the reprojection error has two mirror minima
    of nearly equal cost (yaw about +-1.3 rad): ``cv2.solvePnP`` (JAX)
    settles in one, the port's Levenberg-Marquardt in the lower one, so
    such frames' warps differ from JAX's (a standing fact in ROADMAP).  The
    port's cost is never above cv2's."""
    h, w = 240, 320
    lm = L.synthetic_landmarks((w * 0.25, h * 0.2, w * 0.75, h * 0.85))[D.FACE_MODEL_LM68]
    Kc = np.array([[1200.0, 0, w / 2], [0, 1200.0, h / 2], [0, 0, 1]])
    r, t = N.estimate_head_pose(lm, FACE_MODEL_6, Kc)
    rj, tj = JN.estimate_head_pose(lm, FACE_MODEL_6, Kc)

    def cost(r_, t_):
        return float(((N.project_points(FACE_MODEL_6, r_, t_, Kc) - lm) ** 2).sum())

    print(f"port: yaw {float(r[1, 0]):.4f}, cost {cost(r, t):.1f} px^2; cv2: yaw "
          f"{float(rj[1, 0]):.4f}, cost {cost(rj, tj):.1f} px^2")
    assert cost(r, t) <= cost(rj, tj)
    assert abs(abs(float(r[1, 0])) - abs(float(rj[1, 0]))) < 0.05  # mirror yaws


def test_subject_writer_needs_h5py(monkeypatch, tmp_path):
    monkeypatch.setattr(D, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        D.SubjectWriter(str(tmp_path / "s.h5"))
    assert os.listdir(tmp_path) == []
