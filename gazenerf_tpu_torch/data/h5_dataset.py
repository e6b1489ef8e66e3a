"""HDF5 input pipeline: per-subject files -> numpy or pinned batches.

The port's own copy of the JAX package's ``data/h5_dataset.py`` (the
upstream ``GazeDataset`` and ``DataLoader``): the same index, order, frames
and batches for the same arguments.

* :class:`GazeH5Dataset` indexes (subject, frame) pairs over the
  per-subject files; the four datasets (ETH-XGaze, MPIIFaceGaze, Columbia,
  GazeCapture) differ in file prefix and index policy.  Each sample carries
  its global index, by which the trainer gathers the per-sample offsets.
  The head mask is eroded twice by a 3x3 kernel (upstream
  ``datasets/eth_xgaze.py``); identity, expression and texture codes are
  frozen to the subject's frame 0.  With ``device_decode`` the image and the
  masks stay uint8 (the trainer divides by 255 on the card).
* :class:`BatchLoader` decodes samples on a thread pool, collates batches
  in order and keeps ``prefetch`` of them ready; with ``pin_memory`` the
  pool's collator also turns each batch into pinned tensors.
* :func:`device_prefetch` copies batches to the card one ahead of the
  consumer, with non-blocking copies from the pinned batches.

``h5py`` (and ``cv2``, whose erosion a numpy min-filter replaces) are
imported when the module is, where installed: a dataset needs ``h5py``.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import h5py
except ImportError:  # the module imports without it; a dataset raises
    h5py = None

try:
    import cv2
except ImportError:
    cv2 = None

DATASET_PREFIXES = {
    "eth_xgaze": "xgaze_",
    "mpii_face_gaze": "mpii_",
    "columbia": "columbia_",
    "gaze_capture": "gaze_capture_",
}


def _erode2(mask: np.ndarray, use_cv2: bool = True) -> np.ndarray:
    """3x3 erosion, two iterations: ``cv2.erode`` where installed, else a
    numpy min-filter over edge-padded windows (the same values: erosion
    ignores the border either way)."""
    if use_cv2 and cv2 is not None:
        return cv2.erode(mask, np.ones((3, 3), np.uint8), iterations=2)
    m = mask.copy()
    for _ in range(2):
        p = np.pad(m, 1, mode="edge")
        m = np.minimum.reduce(
            [p[i : i + m.shape[0], j : j + m.shape[1]] for i in range(3) for j in range(3)]
        )
    return m


class GazeH5Dataset:
    """Index over (subject, frame) pairs across per-subject h5 files.

    Index policies: ETH-XGaze training takes its 43 x 18 frontal frames and
    the last 7 x 18 in reverse order when a subject has more than
    ``frames_per_subject`` (900) frames; the other datasets take every
    frame; ``split="val"`` takes the first ``num_val_images`` frames.  The
    subjects are the ``split`` list of ``train_test_split.json`` in
    ``data_dir`` or else every file with the dataset's prefix, sorted; the
    index is shuffled by ``seed``.  ``evaluate="target"`` adds the target
    frame of each sample's evaluation pair (``data/target_indices.py``).
    """

    def __init__(
        self,
        data_dir: str,
        subjects: Optional[Sequence[str]] = None,
        dataset: str = "eth_xgaze",
        split: str = "train",
        num_val_images: int = 50,
        frames_per_subject: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        fixed_index: Optional[int] = None,
        evaluate: Optional[str] = None,
        target_index: Optional[Sequence[int]] = None,
        device_decode: bool = False,
    ):
        if h5py is None:
            raise ImportError("the HDF5 pipeline needs h5py, which is not installed")
        self.data_dir = data_dir
        self.dataset = dataset
        self.prefix = DATASET_PREFIXES.get(dataset, "")
        if subjects is None:
            split_file = os.path.join(data_dir, "train_test_split.json")
            if os.path.exists(split_file):
                with open(split_file) as f:
                    subjects = json.load(f)[split]
            else:
                subjects = sorted(
                    f[len(self.prefix):] for f in os.listdir(data_dir) if f.startswith(self.prefix)
                )
        self.subjects = list(subjects)
        self._local = threading.local()
        self.fixed_index = fixed_index
        self.evaluate = evaluate
        self.device_decode = device_decode

        self.index: List[Tuple[int, int]] = []
        for si in range(len(self.subjects)):
            with h5py.File(self._path(si), "r") as f:
                n = f["face_patch"].shape[0]
            if split == "val":
                take = list(range(min(num_val_images, n)))
            elif dataset == "eth_xgaze":
                fps = 900 if frames_per_subject is None else frames_per_subject
                if n > fps:
                    front = min(43 * 18, n)
                    back = min(7 * 18, n - front)
                    take = list(range(front)) + list(range(n - 1, n - 1 - back, -1))
                else:
                    take = list(range(n))
            else:
                take = list(range(n))
            self.index += [(si, i) for i in take]
        if shuffle:
            np.random.default_rng(seed).shuffle(self.index)

        self.target_index = None
        if evaluate == "target":
            if target_index is None:
                from gazenerf_tpu_torch.data.target_indices import TARGET_INDICES

                target_index = TARGET_INDICES[dataset]
            self.target_index = np.asarray(target_index, np.int64)

    def _path(self, subject_idx: int) -> str:
        return os.path.join(self.data_dir, self.prefix + self.subjects[subject_idx])

    def _file(self, subject_idx: int):
        # one handle per (thread, subject): h5py handles are not shared
        # across the loader's threads
        files = getattr(self._local, "files", None)
        if files is None:
            files = self._local.files = {}
        f = files.get(subject_idx)
        if f is None:
            f = files[subject_idx] = h5py.File(self._path(subject_idx), "r", swmr=True)
        return f

    def __len__(self) -> int:
        return len(self.index)

    def close(self):
        files = getattr(self._local, "files", None)
        if files:
            for f in files.values():
                f.close()
            files.clear()

    def _read_frame(self, h, fi: int) -> Dict[str, np.ndarray]:
        img = h["face_patch"][fi][:, :, ::-1]  # BGR -> RGB
        head_mask = _erode2(h["head_mask"][fi])
        if self.device_decode:  # uint8 on the wire
            img = np.ascontiguousarray(img)
            lm = np.asarray(h["left_eye_mask"][fi], np.uint8)
            rm = np.asarray(h["right_eye_mask"][fi], np.uint8)
            hm = head_mask.astype(np.uint8)
        else:
            img = img.astype(np.float32) / 255.0
            lm = h["left_eye_mask"][fi].astype(np.float32) / 255.0
            rm = h["right_eye_mask"][fi].astype(np.float32) / 255.0
            hm = head_mask.astype(np.float32) / 255.0
        sample = {
            "image": img,
            "head_mask": hm,
            "left_eye_mask": lm,
            "right_eye_mask": rm,
            "landmarks": h["facial_landmarks"][fi].astype(np.float32),
            "cam_index": np.asarray(h["cam_index"][fi]).reshape(-1)[:1],
            "pitchyaw": h["pitchyaw_head"][fi].astype(np.float32),
            "head_pose": h["face_head_pose"][fi].astype(np.float32),
            "c2w_Rmat": h["c2w_Rmat"][fi].astype(np.float32),
            "c2w_Tvec": h["c2w_Tvec"][fi].astype(np.float32),
            "w2c_Rmat": h["w2c_Rmat"][fi].astype(np.float32),
            "w2c_Tvec": h["w2c_Tvec"][fi].astype(np.float32),
            "inmat": h["inmat"][fi].astype(np.float32),
        }
        # identity, expression and texture frozen to frame 0; the frame's
        # own illumination
        code = np.array(h["latent_codes"][0], np.float32)
        code[279:] = h["latent_codes"][fi][279:]
        sample["code"] = code
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.fixed_index is not None:
            idx = self.fixed_index
        si, fi = self.index[idx]
        h = self._file(si)
        sample = self._read_frame(h, fi)
        sample["sample_idx"] = np.asarray(idx, np.int64)
        if self.evaluate == "target":  # the target frame in the same subject
            ti = int(self.target_index[idx % len(self.target_index)])
            ti = min(ti, h["face_patch"].shape[0] - 1)
            for k, v in self._read_frame(h, ti).items():
                sample["target_" + k] = v
            sample["target_sample_idx"] = np.asarray(ti, np.int64)
        return sample

    @staticmethod
    def _valid(hm, lm, rm) -> bool:
        return (hm.max() != hm.min()) and not (lm.max() == lm.min() and rm.max() == rm.min())

    def valid_mask_sample(self, sample: Dict[str, np.ndarray]) -> bool:
        """The degenerate-mask guard (upstream trainer): a constant head
        mask, or both eye masks constant, make a sample invalid."""
        return self._valid(sample["head_mask"], sample["left_eye_mask"], sample["right_eye_mask"])

    def valid_mask_index(self, idx: int) -> bool:
        """The same guard for dataset index ``idx`` from its three masks
        alone (the eroded head mask, as the sample carries it), so that the
        loaders of several processes reach the same verdict on rows that
        they do not decode."""
        if self.fixed_index is not None:
            idx = self.fixed_index
        si, fi = self.index[idx]
        h = self._file(si)
        return self._valid(_erode2(np.asarray(h["head_mask"][fi])), h["left_eye_mask"][fi],
                           h["right_eye_mask"][fi])


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def pin_batch(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A numpy batch as pinned host tensors, ready for a non-blocking copy
    to the card."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}


class BatchLoader:
    """Multi-threaded prefetching batch iterator over a :class:`GazeH5Dataset`.

    ``num_workers`` threads decode samples (h5py reads, the BGR flip and the
    erosion release the GIL); a collator thread stacks them into batches in
    order, with ``pin_memory`` as pinned tensors (:func:`pin_batch`), and
    keeps up to ``prefetch`` batches ready.  Batches with a degenerate mask
    are skipped when ``skip_invalid``.  ``process_shard = (pid, n)``: every
    process walks the same batches and decodes its contiguous ``1/n`` of
    each, deciding the skip from the whole batch."""

    def __init__(
        self,
        dataset: GazeH5Dataset,
        batch_size: int,
        num_workers: int = 2,
        prefetch: int = 2,
        drop_last: bool = True,
        skip_invalid: bool = True,
        process_shard: Optional[Tuple[int, int]] = None,
        pin_memory: bool = False,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.skip_invalid = skip_invalid
        self.pin_memory = pin_memory
        self.process_shard = process_shard
        if process_shard is not None:
            pid, nproc = process_shard
            if not 0 <= pid < nproc or batch_size % nproc or not drop_last:
                raise ValueError(f"process_shard {process_shard} needs 0 <= pid < n, batch_size "
                                 f"{batch_size} a multiple of n, and drop_last")

    def __len__(self) -> int:
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    def _local_rows(self, batch_indices: List[int]) -> List[int]:
        """This process's contiguous slice of a batch's dataset rows."""
        if self.process_shard is None:
            return batch_indices
        pid, nproc = self.process_shard
        per = self.batch_size // nproc
        return batch_indices[pid * per : (pid + 1) * per]

    def _batch_valid(self, global_indices, samples) -> bool:
        if self.process_shard is None:
            return all(self.ds.valid_mask_sample(s) for s in samples)
        by_row = dict(zip(self._local_rows(global_indices), samples))
        return all(self.ds.valid_mask_sample(by_row[i]) if i in by_row
                   else self.ds.valid_mask_index(i) for i in global_indices)

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.ds)
        batches = [list(range(i, min(i + self.batch_size, n)))
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def collator(pool):
            # decodes fan out over the pool; batches complete in order, and at
            # most prefetch + 2 are in flight
            try:
                inflight: collections.deque = collections.deque()
                bi = 0
                while bi < len(batches) or inflight:
                    while bi < len(batches) and len(inflight) < self.prefetch + 2:
                        try:
                            futs = [pool.submit(self.ds.__getitem__, i)
                                    for i in self._local_rows(batches[bi])]
                        except RuntimeError:  # the consumer left: the pool is shut down
                            return
                        inflight.append((batches[bi], futs))
                        bi += 1
                    rows, futs = inflight.popleft()
                    if stop.is_set():
                        return
                    try:
                        samples = [f.result() for f in futs]
                    except CancelledError:  # the consumer left mid-flight
                        return
                    if self.skip_invalid and not self._batch_valid(rows, samples):
                        continue
                    batch = _collate(samples)
                    if not put(pin_batch(batch) if self.pin_memory else batch):
                        return
            finally:
                put(None)

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        threading.Thread(target=collator, args=(pool,), daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def stack_batches(loader, k: int):
    """Group ``k`` consecutive batches into one stacked dict (a new leading
    axis ``k``) for one copy to the card and ``k`` steps from it; the
    trailing ``len % k`` batches come unstacked, so no sample is dropped.
    Yields ``(batch, n)``: ``n == k`` for a stacked dict, ``n == 1`` for a
    plain one.  Tensor leaves stack into tensors, pinned where the
    loader's were."""

    def stack(vs):
        if isinstance(vs[0], torch.Tensor):
            t = torch.stack(vs)
            return t.pin_memory() if vs[0].is_pinned() else t
        return np.stack([np.asarray(v) for v in vs])

    buf: List[Dict] = []
    for b in loader:
        buf.append(b)
        if len(buf) == k:
            yield {key: stack([bb[key] for bb in buf]) for key in buf[0]}, k
            buf = []
    for b in buf:
        yield b, 1


def device_prefetch(loader, device) -> Iterator:
    """The loader's batches as tensors on ``device``: each batch's copy is
    issued one batch before the consumer takes it, non-blocking from pinned
    batches, so that it runs on the card's copy engine behind the work
    already queued.  Items may also be ``(batch, n)`` pairs, as
    :func:`stack_batches` yields them: the batch is copied and ``n`` passed
    along."""
    device = torch.device(device)

    def to_device(b):
        return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in b.items()}

    ahead = None
    for item in loader:
        item = (to_device(item[0]), item[1]) if isinstance(item, tuple) else to_device(item)
        if ahead is not None:
            yield ahead
        ahead = item
    if ahead is not None:
        yield ahead
