"""Count the collectives of one sharded train step on the CPU.

    PYTHONPATH=src python scripts/sharded_comm_bytes.py [--arch gemma-2b]
        [--mesh 4x1] [--batch 4] [--seq 16] [--microbatches 1]

Spawns as many gloo ranks as the ("data", "model") mesh has, trains the
arch's smoke config one step through ``train.step.make_train_step`` with
the state placed by ``state_shardings`` and the batch by
``batch_shardings``, and counts, on rank 0, every collective that the
step issues (the functional collectives DTensor's redistributions run):
for each kind, its calls, the bytes of the full tensors it produces (an
all-gather's output, a reduce-scatter's input, an all-reduce's tensor)
and the bytes this rank receives (``(n - 1) / n`` of a gather's output,
of a reduce-scatter's input and, ring-wise, of an all-reduce's tensor
twice), the all-gathers also by the logical axes of the parameter whose
shard they gather where their size matches one.  Prints one JSON line.
The counts are properties of the program and the mesh, not of a device:
a card runs the same collectives.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

_FUNCOL = {"all_gather_into_tensor": "all_gather",
           "reduce_scatter_tensor": "reduce_scatter",
           "all_reduce": "all_reduce", "all_to_all_single": "all_to_all"}


class CommBytes(TorchDispatchMode):
    """Tallies the functional collectives dispatched under it.  An op on
    DTensors is handed back to DTensor (``NotImplemented``), so that the
    mode sees the collectives its redistributions run on local tensors."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name in _FUNCOL:
            x = args[0]
            n = 1
            if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
                n = int(args[1] if name == "all_gather_into_tensor"
                        else args[2])
            nbytes = x.numel() * x.element_size()
            self.calls.append((_FUNCOL[name], tuple(x.shape), nbytes, n))
        return func(*args, **kwargs)


def _summary(calls, n_world, shard_axes):
    out = {}
    for kind, shape, nbytes, n in calls:
        full = nbytes * n if kind == "all_gather" else nbytes
        if kind == "all_reduce":
            recv = 2 * full * (n_world - 1) // n_world
        else:
            recv = full * (n - 1) // max(n, 1) if n > 1 else 0
        row = out.setdefault(kind, {"calls": 0, "full_bytes": 0,
                                    "received_bytes": 0})
        row["calls"] += 1
        row["full_bytes"] += full
        row["received_bytes"] += recv
        if kind == "all_gather":
            axes = shard_axes.get(shape, "activation")
            by = row.setdefault("by_axes", {})
            by[axes] = by.get(axes, 0) + full
    return out


def _worker(rank, args, path):
    torch.set_num_threads(1)
    store = dist.FileStore(path, args.ranks)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=args.ranks)
    try:
        from repro_torch.configs import get_smoke_config
        from repro_torch.data.pipeline import SyntheticLM, make_batch
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import RuntimeFlags, build_model
        from repro_torch.models.params import spec_leaves
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.shard import make_rules, sharding_for
        from repro_torch.train import step as st

        mesh = make_mesh(args.shape, ("data", "model"), device="cpu")
        rules = make_rules()
        model = build_model(get_smoke_config(args.arch))
        flags = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                             compute_dtype="float32",
                             microbatches=args.microbatches)
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        sh = st.state_shardings(model, flags, mesh, rules)
        state = st.distribute(st.make_train_state(
            model, torch.Generator().manual_seed(0), opt, flags,
            device="cpu"), sh)
        host = make_batch(model.cfg, "train", args.batch, args.seq, seed=0,
                          step=0)
        data = SyntheticLM(model.cfg, batch=args.batch, seq=args.seq,
                           seed=0, device="cpu",
                           shardings=st.batch_shardings(host, mesh, rules))
        step = st.make_train_step(model, flags, opt, mesh, rules)
        # A parameter's local shard shape names its gathers: the stacked
        # leaf's, a layer's (the model unstacks the layers) and, for a
        # matrix, its transpose's (the tied unembedding).
        shard_axes = {}
        for _, s in spec_leaves(model.specs()):
            spec = sharding_for(s.shape, s.axes, rules, mesh)
            local = tuple(sl.stop - sl.start
                          for sl in spec.local_slices(s.shape))
            if local == tuple(s.shape):
                continue
            name = "param " + ",".join(str(a) for a in s.axes)
            shapes = [local]
            if s.axes[0] == "layers":
                shapes.append(local[1:])
            if len(local) == 2:
                shapes.append(local[::-1])
            for shape in shapes:
                shard_axes.setdefault(shape, name)
        batch = data(0)
        mode = CommBytes()
        with mode:
            state, metrics = step(state, batch)
        if rank == 0:
            print(json.dumps({
                "arch": model.cfg.name, "mesh": list(args.shape),
                "batch": args.batch, "seq": args.seq,
                "microbatches": args.microbatches,
                "param_bytes": 4 * model.n_params(),
                "loss": float(metrics["loss"]),
                "collectives": _summary(mode.calls, args.ranks,
                                        shard_axes)}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--mesh", default="4x1")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)
    args.shape = tuple(int(x) for x in args.mesh.split("x"))
    args.ranks = args.shape[0] * args.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(args, str(pathlib.Path(tmp) / "store")),
                 nprocs=args.ranks)


if __name__ == "__main__":
    main()
