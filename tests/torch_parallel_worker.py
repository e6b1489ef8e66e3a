"""One process of the port's multi-process CPU tests
(``tests/test_torch_parallel.py``): ``python tests/torch_parallel_worker.py
CASE.json RANK``.  Imports the port and nothing of JAX.

The case file names the mode, the layout, the port's config sections and
the input and output files:

* ``step``: ``steps`` training steps of a ``Trainer`` on the mesh from
  the state and global batch in ``inputs`` (a ``torch.save`` file:
  ``model``, ``offsets``, optionally ``disc``, ``batch``, ``t_rand``), the
  first at step count 0, in float64 with ``float64``; each process writes
  its losses and state after each step and the mesh's traffic of the first
  to ``out/rank<r>.pt``.  With ``world`` 0 it is the one-process step (no
  mesh, no process group) on the global batch.
* ``forward``: the model's jittered forward on the mesh, the fine pass
  included (``hier_sampling``), from the jitter generator seeded with
  ``inputs["seed"]``; writes the outputs.
* ``ckpt``: two epochs of two steps, a checkpoint after the first; then a
  fresh trainer restores it and takes the second epoch again.  Each process
  writes both final states.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gazenerf_tpu_torch import Config, LossConfig, ModelConfig, TrainConfig, Trainer  # noqa: E402
from gazenerf_tpu_torch.parallel import sharding  # noqa: E402
from gazenerf_tpu_torch.parallel.mesh import init_distributed, make_mesh  # noqa: E402
from gazenerf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402


def state_of(tr):
    """Every tensor of a trainer's state, on the CPU, by name."""
    out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
    out.update({f"offsets.{k}": v.detach() for k, v in tr.offsets.items()})
    if tr.disc is not None:
        out.update({f"disc.{k}": v for k, v in tr.disc.state_dict().items()})
    names = {id(p): f"model.{k}" for k, p in tr.model.named_parameters()}
    names.update({id(p): f"offsets.{k}" for k, p in tr.offsets.items()})
    for p, st in tr.optimizer.state.items():
        out.update({f"adam.{names[id(p)]}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    out["generator"] = tr.generator.get_state()
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def trainer(case, mesh):
    cfg = Config(model=ModelConfig(**case["model"]), loss=LossConfig(**case["loss"]),
                 train=TrainConfig(**case["train"]))
    tr = Trainer(cfg, train_len=case["train_len"], steps_per_epoch=case["steps_per_epoch"],
                 device="cpu", mesh=mesh)
    if case.get("float64"):
        for m in (tr.model, tr.disc):
            if m is not None:
                m.double()
        for table in tr.offsets.values():
            table.data = table.data.double()
    return tr


def local_rows(mesh, batch):
    if mesh is None:
        return batch
    return {k: v[sharding.row_slice(mesh, v.shape[0])] for k, v in batch.items()}


def run_step(case, mesh, rank):
    inputs = torch.load(case["inputs"], weights_only=False)
    tr = trainer(case, mesh)
    dt = torch.float64 if case.get("float64") else torch.float32
    tr.model.load_state_dict({k: v.to(dt) for k, v in inputs["model"].items()})
    with torch.no_grad():
        for k, v in inputs["offsets"].items():
            tr.offsets[k].copy_(v)
    if "disc" in inputs:
        tr.disc.load_state_dict({k: v.to(dt) for k, v in inputs["disc"].items()})
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    if case.get("float64"):
        batch = {k: v.double() if v.dtype == torch.float32 else v for k, v in batch.items()}
    out = {"losses": [], "state": []}
    for i in range(case["steps"]):
        losses = tr.train_step(local_rows(mesh, batch), t_rand=inputs["t_rand"])
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["state"].append(state_of(tr))
        if i == 0:
            out["traffic"] = {} if mesh is None else {k: dict(v) for k, v in mesh.traffic.items()}
    return out


def run_forward(case, mesh, rank):
    from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF
    from gazenerf_tpu_torch.ops.rays import pixel_grid

    inputs = torch.load(case["inputs"], weights_only=False)
    model = GazeNeRF(ModelConfig(**case["model"]), device="cpu", mesh=mesh)
    model.to(inputs["args"][0].dtype).load_state_dict(inputs["model"])
    args = [local_rows(mesh, {"a": a})["a"] for a in inputs["args"]]
    R = model.cfg.num_rays
    xy = pixel_grid(model.cfg.featmap_size)[sharding.ray_slice(mesh, R)]
    gen = torch.Generator().manual_seed(inputs["seed"])
    with torch.no_grad():
        out = model(xy[None].expand(args[0].shape[0], -1, -1), *args, train=True,
                    generator=gen)
    return {"coarse": out["coarse_dict"]["merge_img"], "fine": out["fine_dict"]["merge_img"],
            "weights": out["weights"], "depth": out["depth"], "featmaps": out["featmaps"],
            "generator": gen.get_state()}


def run_ckpt(case, mesh, rank):
    inputs = torch.load(case["inputs"], weights_only=False)
    batches = [local_rows(mesh, {k: torch.from_numpy(v) for k, v in b.items()})
               for b in inputs["batches"]]
    a = trainer(case, mesh)
    a.train_epoch(batches[:2], 0)
    path = save_checkpoint(case["ckpt_dir"], a, a.cfg, 0)
    a.train_epoch(batches[2:], 1)
    b = trainer(case, mesh)
    load_checkpoint(path, b)
    b.train_epoch(batches[2:], 1)
    return {"uninterrupted": state_of(a), "resumed": state_of(b),
            "history": [a.history, b.history]}


def main():
    case = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    mesh = None
    if case["world"]:
        init_distributed(case["coordinator"], case["world"], rank, backend="gloo", device="cpu",
                         timeout_s=case.get("timeout_s", 120))
        mesh = make_mesh(case["dp"], case["rp"], device="cpu")
    out = {"step": run_step, "forward": run_forward, "ckpt": run_ckpt}[case["mode"]](
        case, mesh, rank)
    torch.save(out, os.path.join(case["out"], f"rank{rank}.pt"))
    print("worker ok", rank)


if __name__ == "__main__":
    main()
