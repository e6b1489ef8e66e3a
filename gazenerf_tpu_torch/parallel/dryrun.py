"""``python -m gazenerf_tpu_torch.parallel.dryrun N [--rp RP] [--device cpu|cuda]``
— the multi-process launch path end to end, on tiny shapes.

The port's counterpart of the JAX package's multi-chip dry run: writes one
synthetic subject and starts ``N`` processes, each of which runs the
training CLI (``cli/train.main``) with ``--dp N/rp --rp rp`` (``rp`` 2
where ``N`` is even and above 2, else 1, unless ``--rp`` gives it; two
batches of ``2 dp`` rows, two steps per dispatch) for one epoch, then runs
it again, resumed from that epoch's checkpoint, for a second: the launch
path entered twice in one process, as a resumed run does.  Checks that
every process exits 0, that ``summary.csv`` lists both epochs with finite
losses and that the resumed run wrote its checkpoint.  Each process has
``--timeout`` seconds; a process that overstays is killed with the others
and the run fails.  It needs h5py (the loader's files).  It runs over NCCL
on the cards (the default), one process per card, so ``N`` cards;
``--device cpu`` runs over gloo on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import socket
import subprocess
import sys
import tempfile
from typing import List

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(argv: List[str]) -> None:
    """One process: the CLI for one epoch, then resumed for a second."""
    from gazenerf_tpu_torch.cli.train import main

    ckpt = os.path.join(argv[argv.index("--checkpoint_dir") + 1], "epoch_1")
    if main(argv + ["--num_epochs", "1"]) or main(argv + ["--num_epochs", "2", "--resume", ckpt]):
        raise SystemExit(1)


def launch(n: int, argv: List[str], timeout: float) -> None:
    """Run ``n`` processes of :func:`_worker` with the CLI's ``argv`` and
    their ranks, joined over a free localhost port.  Raises, with its
    output, if one fails, or if one overstays ``timeout`` seconds (all are
    killed then)."""
    coord = f"localhost:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    code = ("import sys; from gazenerf_tpu_torch.parallel.dryrun import _worker; "
            "_worker(sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv, "--coordinator", coord,
         "--num_processes", str(n), "--process_id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {i} of {n} exited {p.returncode}:\n{out[-3000:]}")


def dryrun(n: int, rp: int = 0, device=None, timeout: float = 300.0) -> dict:
    """Train one epoch on ``n`` processes, resume for a second; returns the
    two epochs' losses and the layout.  On the cards unless ``device`` asks
    for the CPU: without a card, or with fewer cards than processes, it
    raises before any process starts."""
    import torch

    from gazenerf_tpu_torch.models.gaze_nerf import resolve_device

    device = resolve_device(device).type
    if device == "cuda" and torch.cuda.device_count() < n:
        raise ValueError(f"{n} processes over NCCL need {n} cards, but there are "
                         f"{torch.cuda.device_count()}; pass device='cpu' to run on the CPU")
    rp = rp or (2 if n % 2 == 0 and n > 2 else 1)
    dp = n // rp
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        return _run(n, dp, rp, device, timeout, work)


def _run(n, dp, rp, device, timeout, work) -> dict:
    from gazenerf_tpu_torch.data.synthetic import write_synthetic_subject

    B = 2 * dp
    data_dir, ckpt_dir = os.path.join(work, "data"), os.path.join(work, "ckpt")
    write_synthetic_subject(data_dir, num_frames=2 * B, img_size=64)
    argv = [
        "--img_dir", data_dir, "--checkpoint_dir", ckpt_dir, "--device", device,
        "--dp", str(dp), "--rp", str(rp), "--batch_size", str(B), "--lr", "1e-3",
        "--steps_per_dispatch", "2", "--featmap_size", "16", "--pred_img_size", "64",
        "--num_sample_coarse", "8", "--mlp_hidden", "32", "--use_pallas", "false",
        "--use_vgg_loss", "false", "--compute_dtype", "float32", "--renderer_dtype", "float32",
        "--num_workers", "1",
    ]
    launch(n, argv, timeout)
    with open(os.path.join(ckpt_dir, "summary.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    if [int(r["epoch"]) for r in rows] != [0, 1] or not all(map(math.isfinite, losses)):
        raise RuntimeError(f"summary.csv after the resumed run: {rows}")
    if sorted(os.listdir(ckpt_dir)) != ["epoch_1", "epoch_2", "summary.csv", "train.log"]:
        raise RuntimeError(f"the runs wrote {sorted(os.listdir(ckpt_dir))}")
    return {"dp": dp, "rp": rp, "processes": n, "losses": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process training dry run on tiny shapes")
    ap.add_argument("n", type=int, nargs="?", default=2, help="processes")
    ap.add_argument("--rp", type=int, default=0, help="ray-parallel axis (0: 2 if n is even "
                                                      "and above 2, else 1)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per process")
    args = ap.parse_args(argv)
    out = dryrun(args.n, args.rp, args.device, args.timeout)
    print(f"dryrun ok: mesh=({out['dp']}x{out['rp']}) processes={out['processes']} "
          f"loss={out['losses'][0]:.4f} -> resumed loss={out['losses'][1]:.4f} "
          f"(via cli.train --dp {out['dp']} --rp {out['rp']} [+ --resume])")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
