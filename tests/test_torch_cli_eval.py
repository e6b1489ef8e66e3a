"""The port's evaluation entry points on the CPU from synthetic h5
subjects: ``python -m gazenerf_tpu_torch.cli.evaluate`` and ``cli.visualize``
(the JAX package's GIF names per subject key), ``cli.evaluate_metrics``
(the JAX CLI's JSON keys; personal calibration's h5 files; exact FID and
the identity pipeline from seeded checkpoints), the precision switch, and
no fall-back to the CPU.

The JAX CLI cannot load an embedder checkpoint (it imports
``mobilefacenet_from_torch`` from ``gazenerf_tpu.utils.transplant``, which
lacks it), so the port's FID is held against the JAX package's ``fid``
through its own InceptionV3 on the images the port's protocol scored."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gazenerf_tpu.eval import metrics as JM
from gazenerf_tpu.models.inception import inception_from_torch
from gazenerf_tpu.models.inception import make_fid_features_fn as jax_make_fid_features_fn
from gazenerf_tpu_torch.cli import evaluate_metrics
from gazenerf_tpu_torch.eval import metrics as M
from gazenerf_tpu_torch.models.inception import InceptionV3FID
from gazenerf_tpu_torch.models.seeding import seed_frozen_net_, seeded_identity_state_dicts
from gazenerf_tpu_torch.cli.evaluate import main as evaluate_main
from gazenerf_tpu_torch.cli.visualize import main as visualize_main
from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject
from torch_threads import one_thread  # noqa: F401

TINY = ["--featmap_size", "16", "--pred_img_size", "64", "--num_sample_coarse", "8",
        "--mlp_hidden", "32", "--use_vgg_loss", "false"]
PORT = TINY + ["--device", "cpu"]
# the JAX CLI's input-target JSON at these flags (``gazenerf_tpu/cli/
# evaluate_metrics.py`` over ``eval/protocols.evaluate_input_target_sweep``:
# no estimator, no VGG, so no angular, LPIPS or FID keys), values dropped
_IT_METRICS = {"ssim": "number", "psnr": "number", "l1": "number", "num_pairs": "number"}
JAX_INPUT_TARGET_KEYS = {"per_subject": {"subject0001.h5": _IT_METRICS},
                         "overall": {**_IT_METRICS, "num_subjects": "number"}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two subjects of four 64x64 frames, subject0000 in the train split and
    subject0001 in val."""
    d = tmp_path_factory.mktemp("cli_eval")
    write_synthetic_subject(str(d), num_frames=4, img_size=64)
    write_synthetic_subject(str(d), num_frames=4, img_size=64, subject="subject0001.h5", seed=1)
    with open(d / "train_test_split.json", "w") as f:
        json.dump({"train": ["subject0000.h5"], "val": ["subject0001.h5"]}, f)
    return d


def test_evaluate_and_visualize_write_jaxs_gif_names(data, tmp_path):
    """``evaluate`` renders the val keys, ``visualize`` the train keys, each
    fitting the chosen frame; ``--fit false`` is the not_fitted flow.  Each
    GIF holds the orbit's views or the 44-frame sweep."""
    from PIL import Image

    base = ["--img_dir", str(data), "--fit_steps", "2", "--view_num", "3"] + PORT
    out = str(tmp_path / "val")
    assert evaluate_main(base + ["--fixed_index", "2", "--out_dir", out]) == 0
    assert sorted(os.listdir(out)) == [f"subject0001_fitted_{k}.gif" for k in ("both", "gaze", "head")]
    frames = {k: Image.open(os.path.join(out, f"subject0001_fitted_{k}.gif")).n_frames
              for k in ("both", "gaze", "head")}
    assert frames == {"both": 3, "gaze": 44, "head": 3}
    out = str(tmp_path / "train")
    assert visualize_main(base + ["--fixed_index", "1", "--out_dir", out]) == 0
    assert sorted(os.listdir(out)) == [f"subject0000_fitted_{k}.gif" for k in ("both", "gaze", "head")]
    out = str(tmp_path / "nofit")
    assert evaluate_main(base + ["--subject", "subject0000.h5", "--fit", "false",
                                 "--out_dir", out]) == 0
    assert "subject0000_not_fitted_both.gif" in os.listdir(out)


def _keys(tree):
    """The nested key structure of a JSON result (values dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if isinstance(tree, (list, str)) else "number"


def test_evaluate_metrics_input_target_has_jaxs_keys(data, capsys):
    """The input-target sweep over the val split prints the JAX CLI's JSON
    structure, with finite metrics over its two pairs."""
    argv = ["--img_dir", str(data), "--evaluation_type", "input_target_images",
            "--fit_steps", "2", "--max_pairs", "2"]
    assert evaluate_metrics.main(argv + PORT) == 0
    got = json.loads(capsys.readouterr().out)
    assert _keys(got) == JAX_INPUT_TARGET_KEYS
    assert got["overall"]["num_pairs"] == 2
    assert all(np.isfinite(v) for v in got["overall"].values())


def test_evaluate_metrics_personal_calibration(data, tmp_path, capsys):
    """Two calibration rounds on the val subject: per round the frames swept,
    the fitted indices and an h5 file of normalized BGR frames."""
    h5py = pytest.importorskip("h5py")
    calib = str(tmp_path / "calib")
    assert evaluate_metrics.main(
        ["--img_dir", str(data), "--evaluation_type", "personal_calibration", "--fit_steps", "1",
         "--num_fit_images", "2", "--num_iterations", "2", "--num_eval_images", "3",
         "--calib_out_dir", calib] + PORT) == 0
    out = json.loads(capsys.readouterr().out)
    (res,) = out["per_subject"].values()
    assert set(res) == {"iter_0", "iter_1"}
    for it, r in res.items():
        assert r["num_frames"] == 3 and len(r["fit_indices"]) == 2
        assert r["h5_path"] == os.path.join(calib, f"subject0001_nsample_2_{it}.h5")
        with h5py.File(r["h5_path"]) as f:
            assert f["face_patch"].shape == (3, 224, 224, 3) and f["face_patch"].dtype == np.uint8


# InceptionV3's bound in the JAX package's tests (tests/test_metrics_backends.py)
FID_RTOL = 1e-3


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded checkpoints in the upstream layouts: pytorch-fid's InceptionV3
    (with its ``fc`` head), FaceX-Zoo's MobileFaceNet (``state_dict`` of a
    ``DataParallel``, ``module.`` keys), RetinaFace and PFLD."""
    d = tmp_path_factory.mktemp("ckpts")
    inc = seed_frozen_net_(InceptionV3FID(), torch.Generator().manual_seed(1)).state_dict()
    torch.save(dict(inc, **{"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)}),
               d / "inception.pth")
    ids = seeded_identity_state_dicts(torch.Generator().manual_seed(5))
    torch.save({"state_dict": {f"module.{k}": v for k, v in ids["embed"].items()}}, d / "embed.pth")
    torch.save(ids["detector"], d / "detector.pth")
    torch.save(ids["aligner"], d / "aligner.pth")
    flags = {"inception": ["--inception_ckpt", str(d / "inception.pth")],
             "identity": ["--identity_embed_ckpt", str(d / "embed.pth"),
                          "--identity_detector_ckpt", str(d / "detector.pth"),
                          "--identity_aligner_ckpt", str(d / "aligner.pth")]}
    return flags, inc


def test_exact_fid_and_identity_pipeline(data, ckpts, capsys, monkeypatch):
    """``--inception_ckpt`` and the three identity flags: FID from the
    exact backend, equal to the JAX package's ``fid`` through its
    InceptionV3 on the same images; the identity score, valid."""
    flags, inc = ckpts
    seen = []
    fid = M.fid
    monkeypatch.setattr(M, "fid", lambda fn, a, b: seen.append((a, b)) or fid(fn, a, b))
    argv = ["--img_dir", str(data), "--fit_steps", "2", "--max_pairs", "2"]
    assert evaluate_metrics.main(argv + flags["inception"] + flags["identity"] + PORT) == 0
    got = json.loads(capsys.readouterr().out)
    overall = got["overall"]
    assert overall["fid_backend"] == got["per_subject"]["subject0001.h5"]["fid_backend"] == "exact"
    assert got["identity_similarity_valid"] is True
    assert overall["num_pairs"] == 2 and -1.0 <= overall["identity_similarity"] <= 1.0
    assert all(np.isfinite(v) for v in overall.values() if not isinstance(v, str))
    (gt, pred), = seen  # one subject: the overall FID is the subject's
    jax_feats = jax_make_fid_features_fn(inception_from_torch({k: v.numpy() for k, v in inc.items()}))
    want = JM.fid(lambda x: jax_feats(jnp.asarray(x)), [np.asarray(i) for i in gt],
                  [np.asarray(i) for i in pred])
    assert overall["fid"] == pytest.approx(want, rel=FID_RTOL)


def test_identity_without_the_embedder_is_not_valid(data, ckpts, capsys):
    """The detector's flag alone: the pipeline runs on a seeded embedder,
    the score is left out and the result says so."""
    flags, _ = ckpts
    argv = ["--img_dir", str(data), "--fit_steps", "1", "--max_pairs", "1"]
    assert evaluate_metrics.main(argv + flags["identity"][2:4] + PORT) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["identity_similarity_valid"] is False
    assert "identity_similarity" not in got["overall"]


@pytest.mark.parametrize("precision, tf32", [("highest", False), ("high", True), ("default", None)])
def test_eval_precision_sets_tf32(precision, tf32):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    saved_mm = torch.get_float32_matmul_precision()
    try:
        for start in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = start
            evaluate_metrics.set_eval_precision(precision)
            want = start if tf32 is None else tf32  # default: PyTorch's settings, untouched
            assert torch.backends.cuda.matmul.allow_tf32 is want
            assert torch.backends.cudnn.allow_tf32 is want
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        torch.set_float32_matmul_precision(saved_mm)


@pytest.mark.parametrize("build", ["fid_features", "identity_pipeline"])
def test_metric_nets_default_to_the_card(ckpts, monkeypatch, build):
    """``--device`` defaults to ``cuda``, and the metric nets' loaders given
    no device look for the card: without one they raise."""
    flags, _ = ckpts
    assert evaluate_metrics._parser().parse_args(["--img_dir", "unused"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if build == "fid_features":
            evaluate_metrics.build_fid_features(flags["inception"][1])
        else:
            evaluate_metrics.build_identity_pipeline(*flags["identity"][1::2])


@pytest.mark.parametrize("entry", ["evaluate", "evaluate_metrics"])
def test_entry_points_default_to_the_card(data, tmp_path, monkeypatch, entry):
    """Without ``--device`` the CLIs run on the CUDA card: where there is none
    they fail and write nothing, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--img_dir", str(data), "--fit_steps", "1"] + TINY
    main = evaluate_main if entry == "evaluate" else evaluate_metrics.main
    out = str(tmp_path / "gifs")
    with pytest.raises((RuntimeError, AssertionError)):
        main(argv + (["--out_dir", out] if entry == "evaluate" else []))
    assert not os.path.exists(out) or not os.listdir(out)
