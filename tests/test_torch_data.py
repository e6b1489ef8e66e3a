"""The port's HDF5 input pipeline against the JAX package's.

One subject file written by JAX's ``write_synthetic_subject`` is read by
both loaders: the same index and order per seed, the same samples and
batches to the bit (the eroded head mask, the frame-0 code freeze, the
uint8 wire format), the same rows per process shard and the same
validation split.  The port's writer writes the same datasets as JAX's, and
its numpy erosion equals ``cv2``'s.  ``device_prefetch`` hands the batches
on as tensors on the device asked for.
"""

import h5py
import numpy as np
import pytest
import torch

from gazenerf_tpu.data import h5_dataset as jax_h5
from gazenerf_tpu.data.synthetic import write_synthetic_subject as jax_write
from gazenerf_tpu_torch.data import h5_dataset as port_h5
from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject
from torch_threads import one_thread  # noqa: F401

FRAMES, SIZE = 12, 64


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    jax_write(str(d), num_frames=FRAMES, img_size=SIZE, seed=2)
    jax_write(str(d), num_frames=6, img_size=SIZE, seed=5, subject="subject0001.h5")
    return str(d)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_writer_matches_jax(tmp_path):
    """Every dataset of a subject file: the same shapes, dtypes and values."""
    want = jax_write(str(tmp_path / "jax"), num_frames=3, img_size=32, seed=4)
    got = write_synthetic_subject(str(tmp_path / "port"), num_frames=3, img_size=32, seed=4)
    with h5py.File(want, "r") as fw, h5py.File(got, "r") as fg:
        assert sorted(fw) == sorted(fg)
        for k in fw:
            assert fw[k].dtype == fg[k].dtype, k
            np.testing.assert_array_equal(fw[k][()], fg[k][()], err_msg=k)


@pytest.mark.parametrize("decode", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_matches_jax(data_dir, seed, decode):
    """The same index, shuffled the same way per seed, and the same
    samples: image (BGR to RGB), eroded head mask, eye masks, the code
    frozen to frame 0 but for its illumination, cameras, sample ids."""
    kw = dict(seed=seed, device_decode=decode)
    want, got = jax_h5.GazeH5Dataset(data_dir, **kw), port_h5.GazeH5Dataset(data_dir, **kw)
    assert got.index == want.index and got.subjects == want.subjects
    for i in range(len(want)):
        _equal(got[i], want[i])


def test_target_evaluation_pairs_match_jax(data_dir):
    kw = dict(evaluate="target", shuffle=False)
    want, got = jax_h5.GazeH5Dataset(data_dir, **kw), port_h5.GazeH5Dataset(data_dir, **kw)
    for i in (0, 5):
        _equal(got[i], want[i])


def test_validation_split_matches_jax(data_dir):
    kw = dict(split="val", num_val_images=4, shuffle=False)
    want, got = jax_h5.GazeH5Dataset(data_dir, **kw), port_h5.GazeH5Dataset(data_dir, **kw)
    assert got.index == want.index and len(got) == 8


def test_numpy_erosion_equals_cv2():
    rng = np.random.default_rng(0)
    mask = (rng.random((40, 48)) > 0.3).astype(np.uint8) * 255
    mask[:, :3] = 255  # a filled edge: the border must not erode it
    np.testing.assert_array_equal(port_h5._erode2(mask, use_cv2=False), port_h5._erode2(mask))


@pytest.mark.parametrize("shard, drop_last", [(None, True), (None, False), ((0, 2), True),
                                               ((1, 2), True)],
                         ids=["whole", "ragged", "shard0", "shard1"])
def test_batches_match_jax(data_dir, shard, drop_last):
    """The batches in order, each to the bit, per process shard (a shard
    takes its contiguous half of every batch; shards take whole batches
    only) and with or without the ragged last batch."""
    ds = dict(seed=1, device_decode=True)
    kw = dict(batch_size=4, num_workers=2, prefetch=2, drop_last=drop_last, process_shard=shard)
    want = list(jax_h5.BatchLoader(jax_h5.GazeH5Dataset(data_dir, **ds), **kw))
    got = list(port_h5.BatchLoader(port_h5.GazeH5Dataset(data_dir, **ds), **kw))
    assert len(got) == len(want) == (4 if drop_last else 5)
    for a, b in zip(got, want):
        _equal(a, b)


def test_device_prefetch_gives_tensors_in_order(data_dir):
    loader = port_h5.BatchLoader(port_h5.GazeH5Dataset(data_dir, seed=1, device_decode=True),
                                 batch_size=4, num_workers=2)
    want = list(loader)
    got = list(port_h5.device_prefetch(loader, "cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in a.values())
        _equal({k: v.numpy() for k, v in a.items()}, b)
