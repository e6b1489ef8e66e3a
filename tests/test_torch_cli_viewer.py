"""``python -m gazenerf_tpu_torch.cli.viewer`` on the CPU: it starts, serves
a render over HTTP on a free port and stops; ``--resume`` serves the
checkpoint's weights, and ``--img_dir --subject`` the weights and codes
fitted to the subject's first frame (the JAX CLI's flow)."""

import argparse
import json
import urllib.request

import numpy as np
import pytest
import torch

from gazenerf_tpu_torch import Trainer
from gazenerf_tpu_torch.cli import common
from gazenerf_tpu_torch.cli.viewer import main
from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject
from gazenerf_tpu_torch.train.checkpoint import save_checkpoint
from gazenerf_tpu_torch.utils.png import decode_png
from gazenerf_tpu_torch.viewer import server as viewer_server
from torch_threads import one_thread  # noqa: F401

TINY = ["--featmap_size", "16", "--pred_img_size", "64", "--num_sample_coarse", "8",
        "--mlp_hidden", "32", "--use_vgg_loss", "false", "--device", "cpu", "--port", "0"]
QUERY = "/render?pitch=0.1&yaw=-0.2&az=10&el=0&dist=12&t=1"


def _serve_once(monkeypatch, argv):
    """Run the CLI with ``serve`` in its non-blocking form; fetch one
    render and the health check, then stop the server.  Returns the app,
    the served image and the health reply."""
    started = {}
    serve = viewer_server.serve

    def non_blocking(app, host, port):
        started["app"] = app
        started["server"] = serve(app, host=host, port=port, block=False)

    monkeypatch.setattr(viewer_server, "serve", non_blocking)
    assert main(argv) == 0
    server = started["server"]
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + QUERY, timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
            img = decode_png(r.read())
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    return started["app"], img, health


def test_viewer_cli_serves_a_render(monkeypatch):
    """The seeded random model with zero codes on the CPU: a 64x64 PNG
    equal to the app's own render."""
    app, img, health = _serve_once(monkeypatch, TINY)
    assert health == {"ok": True}
    assert img.shape == (64, 64, 3)
    assert app.device == torch.device("cpu")
    np.testing.assert_array_equal(img, app.render(0.1, -0.2, 10.0, 0.0, 12.0))


def _trainer():
    """The trainer the CLI builds at ``TINY``'s flags (its seeded weights)."""
    p = argparse.ArgumentParser()
    common.add_common_args(p)
    cfg = common.config_from_args(p.parse_args(TINY[:-4]))
    return cfg, Trainer(cfg, train_len=1, steps_per_epoch=1, device="cpu")


def test_viewer_cli_resumes_a_checkpoint(monkeypatch, tmp_path):
    """``--resume`` serves the checkpoint's weights, not the seeded ones."""
    cfg, trainer = _trainer()
    with torch.no_grad():
        for t in trainer.model.parameters():
            t.add_(0.01)
    path = save_checkpoint(str(tmp_path), trainer, cfg, 0)
    app, img, _ = _serve_once(monkeypatch, TINY + ["--resume", path])
    want = trainer.model.state_dict()
    for k, v in app.model.state_dict().items():
        torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)
    np.testing.assert_array_equal(img, app.render(0.1, -0.2, 10.0, 0.0, 12.0))


def test_viewer_cli_fits_a_subject(monkeypatch, tmp_path):
    """``--img_dir --subject``: two fit steps on the subject's first frame;
    the served codes are the fitted ones (not zero) and the weights the
    fitted copy's (not the trainer's)."""
    pytest.importorskip("h5py")
    write_synthetic_subject(str(tmp_path), num_frames=2, img_size=64)
    app, img, _ = _serve_once(monkeypatch, TINY + ["--img_dir", str(tmp_path), "--subject",
                                                   "subject0000.h5", "--fit_steps", "2"])
    assert float(app.shape_code.abs().sum()) > 0 and float(app.appea_code.abs().sum()) > 0
    seeded = _trainer()[1].model.state_dict()
    assert any(not torch.equal(v, seeded[k]) for k, v in app.model.state_dict().items())
    assert img.shape == (64, 64, 3)
