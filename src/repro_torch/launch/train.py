"""Training launcher — ``repro.launch.train``: config -> mesh -> train
state -> ``run_training`` with the fault-tolerance kit.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --batch 2 --seq 2048 --microbatches 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --layers 27 --batch 2 --seq 2048 --microbatches 2 --steps 3 --ckpt none
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --batch 2 --seq 2048 --microbatches 2 --steps 4 --mesh 1x1
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch gemma-2b --smoke --steps 6 --mesh 2x2 --device cpu

The reference's flags plus ``--device`` (the card unless asked) and
``--layers N``, which cuts the config's depth to N blocks (zamba2-7b's
81 at float32 with AdamW's moments do not fit one card); the run prints
the cut under ``reduced``.  The state is drawn on the device from a
seeded generator and the step donates it (updates in place, the
reference's ``donate_argnums``).  ``--mesh DxM`` trains on a
("data", "model") mesh (``launch.mesh``): under ``torchrun`` on its ranks,
else as a world of one (NCCL on the card, gloo with ``--device cpu``);
the state is drawn whole on every rank and distributed by
``state_shardings``, each batch placed by ``batch_shardings``, and rank 0
prints the summary.  ``--remat none|dots|full`` checkpoints each layer of
the step (``models.remat``; the gradients are those of ``none``, bit for
bit, at a lower peak).  ``--ckpt none`` runs
without checkpoints.  Prints the reference's JSON keys (``final_step``,
``preempted``, ``stragglers``, ``final_loss``) and ``step_s`` (the
median step after the first, which builds the kernels),
``tokens_per_s``, ``peak_gb`` (peak allocated device memory),
``device``, ``layers``, ``reduced`` (the depth cut as ``{"n_layers":
[published, run]}``, or null) and ``mesh`` (``--mesh``, or null).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ensure_world, make_mesh
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import RunConfig, run_training
from repro_torch.shard.api import make_rules
from repro_torch.train.step import (batch_shardings, distribute,
                                    make_train_state, make_train_step,
                                    state_shardings)

__all__ = ["main", "run"]


class _NoCheckpoint:
    """``--ckpt none``: nothing to restore, nothing written."""

    def restore_latest(self, like, shardings=None, *, device=None):
        return None, None

    def save(self, step, state):
        pass

    def wait(self):
        pass


def run(args) -> dict:
    """Train as the parsed ``args`` say; returns the printed summary."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    reduced = None
    if args.layers is not None and args.layers != cfg.n_layers:
        if not 0 < args.layers < cfg.n_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers}; a cut keeps 1 to "
                             f"{cfg.n_layers - 1}")
        reduced = {"n_layers": [cfg.n_layers, args.layers]}
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive" if args.seq <= 512 else "chunked",
                         loss_chunks=4, compute_dtype="float32",
                         microbatches=args.microbatches, remat=args.remat,
                         grad_compress=args.grad_compress)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    mesh = rules = st_sh = b_sh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        ensure_world(device)
        mesh = make_mesh(shape, ("data", "model"), device)
        rules = make_rules()
        st_sh = state_shardings(model, flags, mesh, rules)
        b_sh = batch_shardings(make_batch(cfg, "train", args.batch, args.seq,
                                          seed=0, step=0), mesh, rules)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=device).manual_seed(0)
    state = make_train_state(model, gen, opt, flags, device=device)
    if st_sh is not None:
        state = distribute(state, st_sh)
    step = make_train_step(model, flags, opt, mesh, rules, donate=True)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=0,
                       device=device, shardings=b_sh)
    ckpt = (_NoCheckpoint() if args.ckpt == "none"
            else CheckpointManager(args.ckpt, keep=3))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    out = run_training(step, state, data, ckpt,
                       RunConfig(total_steps=args.steps,
                                 checkpoint_every=args.ckpt_every,
                                 log_every=max(args.steps // 20, 1)),
                       state_shardings=st_sh,
                       log=lambda *a: lead and print(*a, flush=True))
    times = out["step_times"]
    step_s = statistics.median(times[1:] or times) if times else None
    return {"final_step": out["step"], "preempted": out["preempted"],
            "stragglers": len(out["stragglers"]),
            "final_loss": out["history"][-1][1] if out["history"] else None,
            "step_s": step_s,
            "tokens_per_s": (args.batch * args.seq / step_s
                             if step_s else None),
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "layers": cfg.n_layers, "reduced": reduced,
            "mesh": args.mesh}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many blocks (printed as "
                         "'reduced')")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    help="none | dots | full (models.remat)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"),
                    help="checkpoint directory, or 'none'")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '1x1' data x model (default: no mesh); "
                         "under torchrun its ranks, else a world of one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    out = run(ap.parse_args(argv))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
