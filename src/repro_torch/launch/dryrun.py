"""Multi-pod dry run: execute every (arch x shape x mesh) cell's step on
meta tensors, as DTensors on a fake world of the mesh's size, and count
its work — ``repro.launch.dryrun`` without a compiler.

The reference lowers and compiles each cell on 256 or 512 forced host
devices and reads XLA's ``cost_analysis``.  Here the step itself runs:
the full config at its published width and depth, its parameters,
optimizer state and inputs on the ``meta`` device (shapes only: nothing
is allocated or launched), placed on the production mesh by
``state_shardings``, ``batch_shardings`` and ``sharding_for``, in a
process group of the ``fake`` backend (``torch.testing``'s ``FakeStore``:
collectives return at once, this process is rank 0 of 256 or 512).  The
model kernels take their meta branch (``kernels.dispatch``), which checks
the inputs as the kernel does and reports the kernel's own work
(``kernels/<op>/kernel.py``'s ``cost``).  Three counts, all per device:

* flops: ``torch.utils.flop_counter``'s formulas over the aten ops at the
  local shards' shapes (a counting mode below DTensor: a mode above it
  sees the global op, 256 times a device's work on a (16, 16) mesh),
  plus the kernels' reported operations;
* bytes: each aten op's input and output bytes at local shapes (views,
  allocations and collectives move none here), plus the kernels'
  reported bytes;
* wire bytes: ``roofline.record_collectives`` over the collectives the
  step issues (DTensor's redistributions included).

A meta run executes every layer, so the reference's reduced-clone
extrapolation (``_pattern``, ``reduced_clone``, ``extrapolated_costs``)
has nothing to do and is not ported, nor is its ``--exact-costs`` flag,
which chooses between the two.  The module starts the fake world
itself when no process group is up, and refuses a real one: run it as a
command, never import it into a process with a real group:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh single --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --mesh both

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``.  The keys are the
reference's, with ``flops_per_device``, ``bytes_per_device`` and
``wire_bytes_per_device`` where it says ``hlo_``; ``roofline`` is
against the H100's published peaks (``roofline.HW``).  Train cells run
float32 (``compute_dtype`` and ``param_dtype``): the port's backward
kernels are float32 only.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import mesh_devices, production_shape
from repro_torch.launch.specs import (SHAPES, batch_struct, decode_struct,
                                      prefill_struct, skip_reason)
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.shard.api import make_rules, sharding_for
from repro_torch.train.step import (abstract_state, batch_shardings,
                                    distribute, make_serve_step,
                                    make_train_step, state_shardings)

__all__ = ["default_flags", "fake_world", "production_mesh", "placed_step",
           "count", "lower_cell", "analyze", "run_cell", "main", "Counted"]

_aten = torch.ops.aten
# Ops that move no bytes here: allocations and views that are not marked
# as such.
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten._unsafe_view.default,
             _aten.lift_fresh.default, _aten.detach.default}
# The namespaces of the collectives: their bytes are wire bytes.
_COLLECTIVES = ("_c10d_functional", "_dtensor")


def default_flags(kind: str, overrides: dict) -> RuntimeFlags:
    """The reference's flags, but train cells run float32 (the port's
    backward kernels are float32 only).  ``scan_layers`` and
    ``analysis_unroll`` keep the reference's values and are not read."""
    base = dict(attn_impl="chunked", attn_chunk=1024, loss_chunks=16,
                scan_layers=True, param_dtype="bfloat16",
                compute_dtype="bfloat16", moe_impl="gather",
                analysis_unroll=False)
    if kind == "train":
        base.update(remat="full", microbatches=1, compute_dtype="float32",
                    param_dtype="float32")
    else:
        base.update(remat="none", microbatches=1)
    base.update(overrides)
    return RuntimeFlags(**base)


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks, this process rank 0;
    restarted at another size if one is up.  Raises if a real group is."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a fake process group; a "
                               f"{dist.get_backend()!r} group is up")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(multi_pod: bool):
    """The production mesh (``launch.mesh.production_shape``) over the
    fake world, typed as the card fleet's ("cuda": DTensor issues the
    collectives it would issue there, an all-to-all where a CPU mesh
    gathers); its shards stay on the meta device.  No card is asked."""
    shape, axes = production_shape(multi_pod)
    fake_world(math.prod(shape))
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def _has_fake(args) -> bool:
    return any(isinstance(a, FakeTensor) for a in tree_flatten(args)[0])


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class Counted(TorchDispatchMode):
    """Per-device flops and bytes of the aten ops run under it, at the
    local shards' shapes (a DTensor op is left to DTensor, whose local ops
    come back here; its sharding propagation, on fake tensors, is not
    counted), plus the kernels' reported work (``kernel_cost``, by op
    in ``kernels``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels = {}

    def kernel_cost(self, op, ops, nbytes):
        k = self.kernels.setdefault(op, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += ops
        k["bytes"] += nbytes
        self.flops += ops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func.namespace in _COLLECTIVES or _has_fake(args)
                or func.is_view or func in _NO_BYTES):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += _bytes((args, kwargs)) + _bytes(out)
        return out


def _cache_shardings(model, caches, mesh, rules):
    axes = model.cache_axes()

    def zip_tree(c, a):
        if isinstance(c, torch.Tensor):
            return sharding_for(c.shape, a, rules, mesh)
        if isinstance(c, dict):
            return {k: zip_tree(c[k], a[k]) for k in c}
        return type(c)(zip_tree(x, y) for x, y in zip(c, a))
    return zip_tree(caches, axes)


def placed_step(model, kind: str, batch: int, seq: int, flags, mesh,
                rules):
    """(step, args): the ``kind`` step ("train", "prefill" or "decode") of
    ``model`` and its arguments as meta tensors of a ``batch`` x ``seq``
    cell, placed on ``mesh`` (``state_shardings``, ``batch_shardings``,
    ``sharding_for``)."""
    cfg = model.cfg
    p_dt = getattr(torch, flags.param_dtype)
    c_dt = getattr(torch, flags.compute_dtype)
    st_sh = state_shardings(model, flags, mesh, rules)
    if kind == "train":
        b = batch_struct(cfg, batch, seq, c_dt)
        args = (distribute(abstract_state(model, flags, p_dt), st_sh),
                distribute(b, batch_shardings(b, mesh, rules)))
        return make_train_step(model, flags, AdamWConfig(), mesh, rules,
                               donate=True), args
    params = distribute(model.abstract(p_dt), st_sh.params)
    prefill, decode = make_serve_step(model, flags, mesh, rules)
    if kind == "prefill":
        b = prefill_struct(cfg, batch, seq, c_dt)
        return prefill, (params, distribute(
            b, batch_shardings(b, mesh, rules)), seq)
    caches, tokens, pos = decode_struct(model, batch, seq, c_dt)
    tok_sh = sharding_for(tokens.shape, ("batch", None), rules, mesh)
    return decode, (params, distribute(caches, _cache_shardings(
        model, caches, mesh, rules)), tok_sh.distribute(tokens), pos)


def count(step, args) -> dict:
    """Run ``step(*args)`` under the counters: ``flops``, ``bytes``,
    ``collectives`` (``CollectiveStats``), ``kernels``, ``run_s`` and
    ``argument_size_in_bytes`` (the arguments' local shards)."""
    arg_bytes = sum(t.to_local().numel() * t.element_size()
                    for a in args if not isinstance(a, int)
                    for t in tree_leaves(a))
    t0 = time.time()
    with rl.record_collectives() as rec, Counted() as cnt:
        step(*args)
    return {"flops": cnt.flops, "bytes": cnt.bytes,
            "collectives": rec.stats(), "kernels": cnt.kernels,
            "run_s": time.time() - t0, "argument_size_in_bytes": arg_bytes}


def lower_cell(arch: str, shape: str, multi_pod: bool, flags_over: dict,
               rules_over: dict, cfg=None):
    """Place and run one cell's step on meta tensors under the counters
    (:func:`count`).  Returns (counts, cfg, meta)."""
    if cfg is None:
        cfg = get_config(arch)
    model = build_model(cfg)
    mesh = production_mesh(multi_pod)
    rules = make_rules(**rules_over)
    kind = SHAPES[shape]["kind"]
    seq, gb = SHAPES[shape]["seq"], SHAPES[shape]["batch"]
    flags = default_flags(kind, flags_over)
    t0 = time.time()
    step, args = placed_step(model, kind, gb, seq, flags, mesh, rules)
    t_place = time.time() - t0
    counts = count(step, args)
    meta = dict(arch=arch, shape=shape, kind=kind, seq=seq, global_batch=gb,
                mesh="multi" if multi_pod else "single",
                chips=mesh_devices(mesh), place_s=t_place,
                run_s=counts["run_s"], flags=flags_over,
                flags_run={k: getattr(flags, k) for k in (
                    "compute_dtype", "param_dtype", "remat", "microbatches",
                    "attn_chunk", "loss_chunks", "moe_impl")},
                flags_unread=["scan_layers", "analysis_unroll"],
                rules={k: str(v) for k, v in rules_over.items()},
                n_params=model.n_params(),
                n_params_active=cfg.active_param_count(),
                argument_size_in_bytes=counts["argument_size_in_bytes"])
    return counts, cfg, meta


def analyze(counts, cfg, meta) -> dict:
    """Collective stats and roofline terms of a counted cell."""
    out = dict(meta)
    flops, nbytes = float(counts["flops"]), float(counts["bytes"])
    stats = counts["collectives"]
    wire = stats.wire_bytes_per_device
    out["flops_per_device"] = flops
    out["bytes_per_device"] = nbytes
    out["wire_bytes_per_device"] = wire
    out["collectives"] = stats.to_json()
    out["kernels"] = counts["kernels"]
    dtype = meta["flags_run"]["compute_dtype"]
    terms = rl.roofline_terms(flops, nbytes, wire, dtype)
    out["roofline"] = dict(terms, peak=rl.HW["name"], dtype=dtype)
    n_tokens = meta["global_batch"] * (meta["seq"] if meta["kind"] != "decode"
                                       else 1)
    mf = rl.model_flops(cfg, n_tokens, meta["kind"])
    out["model_flops_global"] = mf
    denom = flops * meta["chips"]
    out["model_flops_ratio"] = (mf / denom) if denom else 0.0
    out["mfu_upper_bound"] = (mf / meta["chips"] / rl.HW["peak_flops"][dtype]
                              / terms["step_s"]) if terms["step_s"] else 0.0
    return out


def run_cell(arch, shape, mesh_kind, flags_over, rules_over, out_dir):
    """One cell to ``<out_dir>/<arch>__<shape>__<mesh_kind>.json``; a skip
    or an error is written there too.  Returns whether it ran."""
    reason = skip_reason(arch, shape)
    tag = f"{arch}__{shape}__{mesh_kind}"
    out_path = pathlib.Path(out_dir) / f"{tag}.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if reason:
        out_path.write_text(json.dumps(
            {"arch": arch, "shape": shape, "mesh": mesh_kind,
             "skipped": reason}, indent=1))
        print(f"[skip] {tag}: {reason}")
        return True
    try:
        counts, cfg, meta = lower_cell(arch, shape, mesh_kind == "multi",
                                       flags_over, rules_over)
        result = analyze(counts, cfg, meta)
        print(f"[ok] {tag}: run {meta['run_s']:.1f}s "
              f"flops/dev {result['flops_per_device']:.3e} "
              f"bound={result['roofline']['bound']} "
              f"mfu_ub={result['mfu_upper_bound']:.3f}")
        out_path.write_text(json.dumps(result, indent=1, default=str))
        return True
    except Exception:
        err = traceback.format_exc()
        out_path.write_text(json.dumps(
            {"arch": arch, "shape": shape, "mesh": mesh_kind,
             "error": err[-4000:]}, indent=1))
        print(f"[FAIL] {tag}\n{err}", file=sys.stderr)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--flags", default="{}", help="RuntimeFlags overrides JSON")
    ap.add_argument("--rules", default="{}", help="shard-rule overrides JSON")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--sweep", action="store_true",
                    help="run every cell, one subprocess a cell")
    args = ap.parse_args(argv)
    flags_over = json.loads(args.flags)
    rules_over = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in json.loads(args.rules).items()}
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    ok = True
    if args.sweep:
        # one subprocess per cell: a pathological cell fails alone
        for arch, shape in [(a, s) for a in ARCHS for s in SHAPES]:
            for m in meshes:
                tag = f"{arch}__{shape}__{m}"
                done = pathlib.Path(args.out) / f"{tag}.json"
                if done.exists() and "error" not in done.read_text()[:200]:
                    print(f"[cached] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", m,
                       "--flags", args.flags, "--rules", args.rules,
                       "--out", args.out]
                r = subprocess.run(cmd, timeout=3600)
                ok &= (r.returncode == 0)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --sweep")
        try:
            for m in meshes:
                ok &= run_cell(args.arch, args.shape, m, flags_over,
                               rules_over, args.out)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
