"""``python -m gazenerf_tpu_torch.cli.preprocess`` end to end against the JAX
package's CLI: an ETH-XGaze layout of PNG frames (distorted cameras, an
upside-down one, the CSV head poses) through both, with the same NL-3DMM
basis and decoder checkpoint, and the two h5 files compared field by
field; the QA panels re-rendered from the h5; the same on JPEG frames
(``.JPG``, as ETH-XGaze ships them) without the fit, and a progressive JPEG
frame refused.

The frame fields are equal (the warp to the virtual camera within its
bound, 1 level on 1e-3 of the pixels, ``tests/test_torch_normalize.py``).  The fit's fields are compared loosely: 50
+ 200 Adam steps at lr 1e-2 amplify f32 rounding, so one f32 step on the
landmarks moves the port's own codes by 2.3e-2 relative L2, its rotations
by 3.8e-3 and ``c2w_Tvec`` by 1.2e-3 (ROADMAP, standing facts).  Port
against JAX read 2.8e-2, 6.8e-3, 2.3e-4 (``w2c_Tvec``) and 8.2e-3
(``c2w_Tvec``, the rotation's difference times the 12-unit distance), as
the test prints them (``-s``); the bounds are ~3.5x the largest of each
kind.  ``tests/test_torch_nl3dmm.py``
holds the fit tightly over few steps."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")  # the JAX CLI reads and writes with OpenCV
h5py = pytest.importorskip("h5py")

from gazenerf_tpu.cli.preprocess import main as jax_main  # noqa: E402
from gazenerf_tpu.nl3dmm.face_model import GeometryDecoder, random_basis  # noqa: E402
from gazenerf_tpu_torch.cli.preprocess import main  # noqa: E402
from gazenerf_tpu_torch.utils.png import decode_png  # noqa: E402
from torch_threads import one_thread  # noqa: F401,E402

CODE_REL_L2, ROT_REL_L2, TVEC_REL_L2 = 0.1, 0.025, 0.03  # the 250-step fit
WARP_MAX_LEVELS, WARP_MAX_SHARE = 1, 1e-3


def _layout(root, ext=".png"):
    """One frame from cameras 3 (upside down) and 7 at 240 x 240 (written by
    ``cv2.imwrite`` as ``ext``), distorted calibrations for all 18 cameras, a
    CSV row per image; and the decoder checkpoint (JAX's seeded draw in
    upstream's names)."""
    rng = np.random.default_rng(0)
    subj, calib = os.path.join(root, "subject0000"), os.path.join(root, "calib")
    os.makedirs(os.path.join(subj, "frame0000"))
    os.makedirs(calib)
    for c in range(18):
        fs = cv2.FileStorage(os.path.join(calib, f"cam{c:02d}.xml"), cv2.FILE_STORAGE_WRITE)
        fs.write("Camera_Matrix", np.array([[600.0, 0, 120.0], [0, 600.0, 120.0], [0, 0, 1.0]]))
        fs.write("Distortion_Coefficients", np.array([[-0.05], [0.02], [0.001], [-0.001]]))
        fs.release()
    yy, xx = np.mgrid[:240, :240]
    rows = []
    for c in (3, 7):
        img = np.stack([(xx * 3 + yy + 40 * c) % 256, (yy * 2) % 256, ((xx - yy) * 5) % 256], -1)
        img = (img * 0.7 + rng.random(img.shape) * 76).astype(np.uint8)
        name = f"frame0000_cam{c:02d}{ext}"
        cv2.imwrite(os.path.join(subj, "frame0000", name), img)
        rows.append(["frame0000", name, "0.1", "-0.2", "0.05", "-0.02", "-0.99", str(0.01 * c),
                     "-0.02", "0.03", "5.0", "-3.0", "580.0"])
    csv = os.path.join(root, "subject0000.csv")
    with open(csv, "w") as f:
        f.write("\n".join(",".join(r) for r in rows))
    p = GeometryDecoder(random_basis()).init_params
    sd = {"nl3dmm.geo_fc2.weight": np.asarray(p["w1"]).T, "nl3dmm.geo_fc2.bias": p["b1"],
          "nl3dmm.geo_fc3.weight": np.asarray(p["w2"]).T, "nl3dmm.geo_fc3.bias": p["b2"]}
    ckpt = os.path.join(root, "nl3dmm_net_dict.pth")
    torch.save({"net": {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}}, ckpt)
    return ["--layout", "xgaze", "--frames_dir", subj, "--cam_calib_dir", calib,
            "--annotation_csv", csv, "--img_size", "64", "--fit_image_size", "16",
            "--decoder_ckpt", ckpt]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_cli_h5_matches_jax_field_by_field(tmp_path):
    args = _layout(str(tmp_path))
    port, jax_h5 = str(tmp_path / "port" / "xgaze_subject0000.h5"), str(tmp_path / "jax.h5")
    qa = str(tmp_path / "qa")
    assert main(args + ["--out", port, "--device", "cpu", "--qa_render_dir", qa]) == 0
    assert jax_main(args + ["--out", jax_h5]) == 0
    with h5py.File(port) as g, h5py.File(jax_h5) as w:
        assert set(g) == set(w)
        for key in w:
            a, b = g[key][:], w[key][:]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if key == "face_patch":
                d = np.abs(a.astype(int) - b.astype(int))
                assert d.max() <= WARP_MAX_LEVELS and (d > 0).mean() <= WARP_MAX_SHARE
            elif key == "latent_codes":
                assert _rel(a, b) <= CODE_REL_L2, _rel(a, b)
                # the identity, expression and texture codes: the first
                # frames' mean on every row
                np.testing.assert_array_equal(a[:, :279], np.broadcast_to(a[:1, :279], (2, 279)))
            elif key in ("w2c_Rmat", "c2w_Rmat"):
                assert _rel(a, b) <= ROT_REL_L2, (key, _rel(a, b))
            elif key in ("w2c_Tvec", "c2w_Tvec"):
                assert _rel(a, b) <= TVEC_REL_L2, (key, _rel(a, b))
            elif key in ("pitchyaw_head", "face_head_pose", "facial_landmarks"):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=key)
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)
        np.testing.assert_array_equal(g["cam_index"][:, 0], [3, 7])
    # the fit's own sensitivity: the same fit with the landmarks one f32
    # step up (printed beside the port's distance from JAX)
    import argparse

    from gazenerf_tpu_torch.cli.preprocess import _build_fitter
    from gazenerf_tpu_torch.preprocess.driver import _fit_images

    fitter = _build_fitter(argparse.Namespace(
        basis_pkl="", basis_npz="", decoder_ckpt=args[args.index("--decoder_ckpt") + 1],
        fit_image_size=16), "cpu")
    with h5py.File(port) as g, h5py.File(jax_h5) as w:
        imgs = _fit_images([g["face_patch"][i] for i in range(2)], 16)
        lms = g["facial_landmarks"][:].astype(np.float32) * (16 / 64)
        inmat = g["inmat"][:] * (16 / 64)
        inmat[:, 2, 2] = 1.0
        cams = (np.tile(np.diag([1.0, -1.0, -1.0]).astype(np.float32), (2, 1, 1)),
                np.tile(np.array([0, 0, 12.0], np.float32), (2, 1)))
        r0 = fitter.fit(imgs, lms, *cams, inmat)
        r1 = fitter.fit(imgs, np.nextafter(lms, np.float32(np.inf)), *cams, inmat)
        for key, ref in (("code", "latent_codes"), ("w2c_Rmat", "w2c_Rmat"),
                         ("w2c_Tvec", "w2c_Tvec"), ("c2w_Tvec", "c2w_Tvec")):
            print(f"{key}: one f32 step {_rel(r1[key], r0[key]):.2e}, port against JAX "
                  f"{_rel(g[ref][:], w[ref][:]):.2e}")
        np.testing.assert_allclose(r0["code"][:, 279:], g["latent_codes"][:, 279:], rtol=0,
                                   atol=0)  # the CLI's fit, run again
    panels = sorted(os.listdir(qa))
    assert panels == ["fit_qa_0000.png", "fit_qa_0001.png"]
    assert decode_png(open(os.path.join(qa, panels[0]), "rb").read()).shape == (16, 48, 3)

    # the QA panels of the saved fits: both CLIs re-render the port's h5
    qa_port, qa_jax = str(tmp_path / "qa_port"), str(tmp_path / "qa_jax")
    assert main(args + ["--qa_from_h5", port, "--qa_render_dir", qa_port, "--qa_limit", "1",
                        "--device", "cpu"]) == 0
    assert jax_main(args + ["--qa_from_h5", port, "--qa_render_dir", qa_jax,
                            "--qa_limit", "1"]) == 0
    assert os.listdir(qa_port) == os.listdir(qa_jax) == ["fit_qa_0000.png"]
    got = decode_png(open(os.path.join(qa_port, "fit_qa_0000.png"), "rb").read())
    want = cv2.imread(os.path.join(qa_jax, "fit_qa_0000.png"))[..., ::-1]
    d = np.abs(got.astype(int) - want.astype(int))  # a render in f32, truncated to uint8
    assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())


def test_cli_refuses_jpeg_frames(tmp_path):
    """ETH-XGaze's layout with JPEG frames (``cv2.imwrite``'s 4:2:0 at
    quality 95, named ``.JPG``): both CLIs without the fit write the same h5
    field by field (the port reads the frames on the CPU to ``cv2.imread``'s
    pixels); a progressive frame, which the port does not read yet, raises
    naming the file and its ROADMAP item."""
    args = _layout(str(tmp_path), ".JPG") + ["--fit", "false"]
    port, jax_h5 = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    assert main(args + ["--out", port, "--device", "cpu"]) == 0
    assert jax_main(args + ["--out", jax_h5]) == 0
    with h5py.File(port) as g, h5py.File(jax_h5) as w:
        assert set(g) == set(w) and len(w["face_patch"]) == 2
        for key in w:
            a, b = g[key][:], w[key][:]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if key == "face_patch":
                d = np.abs(a.astype(int) - b.astype(int))
                assert d.max() <= WARP_MAX_LEVELS and (d > 0).mean() <= WARP_MAX_SHARE
            elif key in ("pitchyaw_head", "face_head_pose", "facial_landmarks"):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=key)
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)
    frame = tmp_path / "subject0000" / "frame0000" / "frame0000_cam03.JPG"
    img = cv2.imread(str(frame))
    cv2.imwrite(str(frame), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError,
                       match="frame0000_cam03.JPG: progressive.*ROADMAP Queue 1 item 9"):
        main(args + ["--out", str(tmp_path / "s.h5"), "--device", "cpu"])
