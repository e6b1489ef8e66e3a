"""The process mesh of a multi-process training run.

The port's counterpart of the JAX package's ``parallel/mesh.py``: a
``("data", "ray")`` layout of ``data_parallel x ray_parallel`` processes,
one device each.

* ``data``: the batch rows.  A process takes its data index's contiguous
  ``B / data_parallel`` rows; the processes of one data index (its *ray
  group*) hold the same rows.
* ``ray``: the rays of each image.  A process marches its ray index's
  contiguous ``R / ray_parallel`` rays (whole featmap rows), and its ray
  group gathers the fields' features before the featmaps merge.

Ranks are laid out row-major, ``rank = data_index * ray_parallel +
ray_index``, as ``np.asarray(devices).reshape(dp, rp)`` lays out JAX's
mesh.  The processes of one ray index form a *data group*: the batch
statistics that the step takes over the whole batch (the masked means'
denominators, the discriminator's BatchNorm) are reduced over it.

Start the processes' group with :func:`init_distributed` (a no-op for one
process), then build the mesh with :func:`make_mesh`.  Without a process
group the mesh is one process (``1 x 1``) and its collectives do nothing.
"""

from __future__ import annotations

import datetime
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises in every backend
DEFAULT_TIMEOUT_S = 300.0


def init_distributed(coordinator: Optional[str], num_processes: Optional[int],
                     process_id: Optional[int], backend: Optional[str] = None,
                     device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the training processes' group over ``tcp://<coordinator>``
    (``host:port``; process 0 listens there).  The backend is NCCL for
    CUDA devices and gloo for the CPU unless ``backend`` names one.  A
    no-op for one process without an explicit ``backend`` (with one, a
    one-process group whose collectives run through that backend), and
    when the group exists already, so that a resumed run can enter the
    launch path again in the same process."""
    n = num_processes or 1
    if (n <= 1 and backend is None) or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=n,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of process ``rank``: ``cuda:<rank % device_count>``, or
    the CPU where ``device`` asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """A process's place in the ``(data, ray)`` layout, its two process
    groups and its device.  ``traffic`` counts each kind of collective the
    step runs (``gather``, ``reduce``, ``stats``): calls, bytes and, while
    ``timed`` is set, seconds (the device synchronised around each call)."""

    def __init__(self, data_parallel: int, ray_parallel: int, rank: int, device: torch.device,
                 data_group=None, ray_group=None):
        self.data_parallel = data_parallel
        self.ray_parallel = ray_parallel
        self.rank = rank
        self.device = device
        self.data_group = data_group
        self.ray_group = ray_group
        self.distributed = dist.is_initialized()
        self.timed = False
        self.traffic: Dict[str, Dict[str, float]] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_parallel, "ray": self.ray_parallel}

    @property
    def size(self) -> int:
        return self.data_parallel * self.ray_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.ray_parallel

    @property
    def ray_index(self) -> int:
        return self.rank % self.ray_parallel

    def reset_traffic(self) -> None:
        self.traffic = {}

    @contextmanager
    def _counted(self, kind: str, tensor: torch.Tensor):
        t = self.traffic.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        t["calls"] += 1
        t["bytes"] += tensor.numel() * tensor.element_size()
        sync = self.timed and tensor.is_cuda
        if sync:
            torch.cuda.synchronize(tensor.device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(tensor.device)
        if self.timed:
            t["seconds"] += time.perf_counter() - t0

    def all_reduce(self, tensor: torch.Tensor, group="world", kind: str = "reduce"
                   ) -> torch.Tensor:
        """Sum ``tensor`` in place over ``group`` (``"world"``, ``"data"``
        or ``"ray"``); without a process group it stays as it is."""
        if self.distributed:
            with self._counted(kind, tensor):
                dist.all_reduce(tensor, group=self._group(group))
        return tensor

    def all_reduce_with_grad(self, tensor: torch.Tensor, group: str, kind: str = "stats"
                             ) -> torch.Tensor:
        """The sum of ``tensor`` over ``group`` as a new tensor whose
        backward sums the cotangents over the group (the gradient of the
        sum over every process's loss)."""
        if not self.distributed:
            return tensor
        from torch.distributed.nn.functional import all_reduce

        with self._counted(kind, tensor):
            return all_reduce(tensor, group=self._group(group))

    def barrier(self) -> None:
        """Wait for every process (an all-reduce of one element, which every
        backend runs on every device)."""
        if self.distributed:
            dist.all_reduce(torch.zeros(1, device=self.device))

    def _group(self, name: str):
        return {"world": None, "data": self.data_group, "ray": self.ray_group}[name]


def mesh_shape(world: int, data_parallel: int = 0, ray_parallel: int = 1) -> Tuple[int, int]:
    """``(data_parallel, ray_parallel)`` of ``world`` processes:
    ``data_parallel=0`` means all remaining, ``world // ray_parallel``.
    Raises ``ValueError``, naming the training CLI's flags too, where the
    layout is not the world."""
    if ray_parallel < 1 or world % ray_parallel:
        raise ValueError(f"ray_parallel (--rp) {ray_parallel} does not divide the {world} "
                         f"processes (--num_processes)")
    if data_parallel <= 0:
        data_parallel = world // ray_parallel
    if data_parallel * ray_parallel != world:
        raise ValueError(f"data_parallel (--dp) {data_parallel} x ray_parallel (--rp) "
                         f"{ray_parallel} = {data_parallel * ray_parallel} processes, but "
                         f"--num_processes runs {world}")
    return data_parallel, ray_parallel


def make_mesh(data_parallel: int = 0, ray_parallel: int = 1, device="cuda") -> Mesh:
    """This process's :class:`Mesh` over the process group (one process
    without one).  ``data_parallel=0`` means all remaining processes,
    ``world_size // ray_parallel``; ``data_parallel x ray_parallel`` must be
    the world size (:func:`mesh_shape`).  Every process must call it, in the
    same order as its other collectives: it creates the ray and data groups
    of every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data_parallel, ray_parallel = mesh_shape(world, data_parallel, ray_parallel)
    data_group = ray_group = None
    if dist.is_initialized():
        layout = np.arange(world).reshape(data_parallel, ray_parallel)
        for row in layout:  # same data index: the ray groups
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                ray_group = g
        for col in layout.T:  # same ray index: the data groups
            g = dist.new_group([int(r) for r in col])
            if rank in col:
                data_group = g
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(data_parallel, ray_parallel, rank, dev, data_group, ray_group)
