"""The port's training CLI: the JAX CLI's flags and config, and
``python -m gazenerf_tpu_torch.cli.train`` end to end on the CPU (a tiny
model from synthetic files): checkpoints, ``summary.csv``, a resume and the
validation epoch, as ``tests/test_cli_train.py`` runs the JAX CLI."""

import argparse
import csv
import dataclasses
import os

import numpy as np
import pytest

from gazenerf_tpu.cli import common as jax_common
from gazenerf_tpu_torch.cli import common
from gazenerf_tpu_torch.cli.train import main
from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject
from torch_threads import one_thread  # noqa: F401

ARGV = [
    ["--img_dir", "d", "--batch_size", "4", "--lr", "3e-4", "--featmap_size", "32",
     "--num_sample_coarse", "48", "--use_vgg_loss", "false", "--compute_dtype", "float32"],
    ["--dataset", "columbia", "--pallas_tuning", "off", "--is_gradual_loss", "true",
     "--num_workers", "1", "--prefetch", "3", "--seed", "7", "--vgg_ckpt", "v.pth"],
    ["--num_sample_coarse", "128", "--mlp_hidden", "128", "--steps_per_dispatch", "1"],
]


def _config(add_args, config_from_args, argv):
    p = argparse.ArgumentParser()
    add_args(p)
    return config_from_args(p.parse_args(argv))


@pytest.mark.parametrize("argv", ARGV, ids=["scale", "data", "deep"])
def test_config_from_args_matches_jax(argv, tmp_path, monkeypatch):
    """The same argv gives the same model, loss, train and data sections,
    ``ray_chunk`` of the deep march included."""
    monkeypatch.setenv("GAZENERF_COMPILATION_CACHE", str(tmp_path))  # the JAX CLI's cache
    want = _config(jax_common.add_common_args, jax_common.config_from_args, argv)
    got = _config(common.add_common_args, common.config_from_args, argv)
    for section in ("loss", "train", "data"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section)), section
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)


@pytest.mark.parametrize("shape", [(64, 64), (16, 8), (32, 32), (64, 128)])
def test_tuned_overrides_have_jaxs_keys(shape):
    """The JAX package's overrides, keys and values, at and beyond S = 64:
    its stash choice, and its 512-ray chunks of a deep march where the rays
    split into them."""
    want = jax_common.tuned_kernel_overrides(*shape)
    got = common.tuned_kernel_overrides(*shape)
    assert got == want
    assert got["pallas_stash_acts"] == want["pallas_stash_acts"] == (shape[1] <= 64)


def _run(img_dir, ckpt_dir, extra):
    argv = [
        "--img_dir", img_dir, "--checkpoint_dir", ckpt_dir, "--batch_size", "2",
        "--lr", "1e-3", "--featmap_size", "16", "--pred_img_size", "64",
        "--num_sample_coarse", "8", "--mlp_hidden", "64", "--use_vgg_loss", "false",
        "--num_workers", "2", "--device", "cpu",
    ] + list(extra)
    assert main(argv) == 0
    with open(os.path.join(ckpt_dir, "summary.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_synthetic_subject(str(d / "train"), num_frames=4, img_size=64)
    write_synthetic_subject(str(d / "val"), num_frames=2, img_size=64, seed=3)
    return d


def test_cli_trains_checkpoints_and_resumes(data, capsys):
    """Two epochs of the bf16 fused path with the auto-tuned stash and
    ``dens_vpu`` (the plain K1 and K2 on the CPU), a checkpoint per epoch
    and ``summary.csv``; resumed from the last checkpoint for a third epoch,
    the summary lists all three; a validation epoch after each."""
    ck = str(data / "ck")
    rows = _run(str(data / "train"), ck, ["--num_epochs", "2", "--val_dir", str(data / "val"),
                                          "--num_val_images", "2"])
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(int(r["batches"]) == 2 and np.isfinite(float(r["loss"])) for r in rows)
    assert sorted(p for p in os.listdir(ck) if p.startswith("epoch_")) == ["epoch_1", "epoch_2"]
    rows = _run(str(data / "train"), ck, ["--num_epochs", "3", "--resume",
                                          os.path.join(ck, "epoch_2")])
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert os.path.isdir(os.path.join(ck, "epoch_3"))
    out = capsys.readouterr().out  # configure_logging routes through stdout
    val = [ln for ln in out.splitlines() if " val: " in ln]
    assert len(val) == 2, out[-2000:]
    for key in ("mse=", "psnr=", "head_mse=", "eyes_mse=", "nonhead_mse="):
        assert key in val[-1], val[-1]


_TWO = ["--num_processes", "2", "--process_id", "0", "--coordinator", "localhost:1"]


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2"], r"\(--dp\) 2 x ray_parallel \(--rp\) 1 = 2 processes, but --num_processes "
                    "runs 1"),
    (["--rp", "3"] + _TWO, r"\(--rp\) 3 does not divide the 2 processes"),
    (["--batch_size", "3", "--dp", "2"] + _TWO, "--batch_size 3 is not divisible by --dp 2"),
], ids=["flags0", "flags1", "flags2"])
def test_cli_runs_on_one_device(data, flags, match):
    """One process runs one device, and multi-process flags that do not fit
    together raise ``ValueError`` naming them, before any process connects
    (the coordinator's address is never dialled): ``--dp 2`` in one
    process, ``--rp 3`` against two processes, ``--batch_size 3 --dp 2``."""
    with pytest.raises(ValueError, match=match):
        _run(str(data / "train"), str(data / "ck1"), flags)
