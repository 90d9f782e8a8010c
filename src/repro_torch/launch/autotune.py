"""Lynceus as a first-class framework feature: tune the LAUNCH CONFIG.

The port of ``repro.launch.autotune``.  The paper tunes <cluster,
hyper-params> for cloud jobs under a profiling budget; the framework's
analogous decision is the launch configuration of a training/serving job
on an accelerator fleet:

  microbatches x remat policy x attention chunk x MoE dispatch x
  KV-cache/sequence sharding rules

Lynceus' budget-aware lookahead spends a *dollar* budget — each probe is
charged as if the candidate ran ``profile_steps`` real steps on the
cluster — and returns the cheapest config meeting a step-time SLO.  The
selections run on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.autotune --arch mixtral-8x22b \\
      --shape train_4k --mesh single --budget 1000 --slo 1.5 --mock

``--mock`` uses an analytic cost model instead of real profiling.
Without it each candidate is profiled by the dry run (``launch/dryrun.py``:
the step executed on meta tensors over a fake world of the mesh's size,
its work counted) and priced by its roofline step time against the H100's
published peaks (``launch/roofline.py``); the dry runs need no card, the
selections run where ``--device`` says:

  PYTHONPATH=src python -m repro_torch.launch.autotune --arch gemma-2b \
      --device cpu --out /tmp/at
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core import Settings
from repro_torch.core.optimizer import optimize_live
from repro_torch.core.space import DiscreteSpace

__all__ = ["build_space", "decode_point", "dry_run", "real_evaluator",
           "mock_evaluator", "tune", "main"]

PRICE_PER_CHIP_HOUR = 1.2          # $/chip-hour (the reference's ballpark)

# launch-config dimensions (ordinal-encoded for the tree surrogate)
MICROBATCHES = [1, 2, 4, 8, 16]
REMAT = ["none", "dots", "full"]
ATTN_CHUNK = [512, 1024, 2048]
MOE_IMPL = ["gather", "einsum"]
SEQ_RULE = ["none", "data"]        # act_seq sharding override


def build_space(is_moe: bool) -> DiscreteSpace:
    dims = {
        "microbatches": list(range(len(MICROBATCHES))),
        "remat": list(range(len(REMAT))),
        "attn_chunk": list(range(len(ATTN_CHUNK))),
        "seq_rule": list(range(len(SEQ_RULE))),
    }
    if is_moe:
        dims["moe_impl"] = list(range(len(MOE_IMPL)))
    return DiscreteSpace.from_grid(dims)


def decode_point(space, i, is_moe: bool):
    raw = space.points_raw[i].astype(int)
    names = list(space.names)
    d = dict(zip(names, raw))
    flags = {"microbatches": MICROBATCHES[d["microbatches"]],
             "remat": REMAT[d["remat"]],
             "attn_chunk": ATTN_CHUNK[d["attn_chunk"]]}
    if is_moe:
        flags["moe_impl"] = MOE_IMPL[d["moe_impl"]]
    rules = {}
    if SEQ_RULE[d["seq_rule"]] == "data":
        rules["act_seq"] = "data"
    return flags, rules


def dry_run(arch, shape, mesh_kind, flags: dict, rules: dict) -> dict:
    """The dry run's JSON of one candidate (``launch.dryrun``): in this
    process when the fake world is up, else in a subprocess of its own
    (``python -m repro_torch.launch.dryrun``), whose file it reads.
    Raises with the dry run's last error line if the cell failed."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        from repro_torch.launch import dryrun
        counts, cfg, meta = dryrun.lower_cell(
            arch, shape, mesh_kind == "multi", flags, rules)
        return dryrun.analyze(counts, cfg, meta)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as out:
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--mesh",
                        mesh_kind, "--flags", json.dumps(flags), "--rules",
                        json.dumps(rules), "--out", out], env=env,
                       capture_output=True, text=True, timeout=3600)
        res = json.loads((pathlib.Path(out) /
                          f"{arch}__{shape}__{mesh_kind}.json").read_text())
    if "error" in res:
        raise RuntimeError(res["error"].strip().splitlines()[-1])
    return res


def real_evaluator(arch, shape, mesh_kind, space, is_moe, profile_steps,
                   log=print):
    """Dry run + roofline step time -> (runtime, full-run cost $).

    Returns the *uncapped* cost of profiling the candidate; probe aborts
    are the optimizer's job (``Settings.timeout`` in ``optimize_live``
    bills aborted probes pro rata and learns from the censored bound).  A
    candidate whose dry run raises costs 3600 s a step on 256 chips, as
    in the reference."""

    def evaluate(i):
        flags, rules = decode_point(space, i, is_moe)
        t0 = time.time()
        try:
            res = dry_run(arch, shape, mesh_kind, flags, rules)
            step_s, chips = res["roofline"]["step_s"], res["chips"]
        except Exception as e:                   # invalid config: huge cost
            log(f"[tune] cfg {i} failed: {type(e).__name__}: {e}")
            step_s, chips = 3600.0, 256
        cost = step_s * profile_steps * chips * PRICE_PER_CHIP_HOUR / 3600.0
        log(f"[tune] cfg {i} {flags} {rules}: step {step_s:.3f}s "
            f"probe ${cost:.2f} (dry run {time.time() - t0:.0f}s)")
        return step_s, cost

    return evaluate


def mock_evaluator(space, is_moe, profile_steps, chips=256, seed=0):
    """Analytic launch-cost model (for tests/examples; no compiles).

    Shape mirrors reality: remat trades memory for +30% recompute flops;
    microbatching cuts activation traffic but adds fixed per-step overhead;
    OOM (no remat, mb too small) -> infeasible (huge step time).  Each call
    draws one normal from the evaluator's own generator, so the calls'
    order fixes their noise.
    """
    rng = np.random.default_rng(seed)

    def evaluate(i):
        flags, rules = decode_point(space, i, is_moe)
        mb = flags["microbatches"]
        base = 1.0
        compute = base * {"none": 1.0, "dots": 1.12, "full": 1.3}[flags["remat"]]
        mem_pressure = 8.0 / mb * {"none": 2.0, "dots": 1.2,
                                   "full": 0.6}[flags["remat"]]
        oom = mem_pressure > 4.0
        overhead = 0.015 * mb
        comm = 0.25 if rules.get("act_seq") else 0.35
        if is_moe:
            comm += 0.1 if flags.get("moe_impl") == "gather" else 0.35
        step = (max(compute, comm) + overhead) * (50.0 if oom else 1.0)
        step *= float(np.exp(rng.normal(0, 0.02)))
        cost = step * profile_steps * chips * PRICE_PER_CHIP_HOUR / 3600.0
        return step, cost

    return evaluate


def tune_settings(la: int = 2) -> Settings:
    """The tuner's selector: Lynceus at lookahead ``la`` with censored
    exploration (paper §3): probes abort at the predictive cap once an
    SLO-meeting incumbent exists, and never run past 10x the SLO."""
    return Settings(policy="lynceus", la=la, k_gh=3, refit="frozen",
                    timeout=True, timeout_tmax_mult=10.0)


def tune(arch, shape, mesh_kind, *, budget, slo, profile_steps=100,
         mock=False, seed=0, la=2, out_dir="results/autotune", log=print,
         device="cuda"):
    """Tune ``arch``'s launch config under a dollar ``budget`` and a
    step-time ``slo``; selections run on ``device`` (``"cuda"`` by default;
    raises without a card).  Writes ``<out_dir>/<arch>__<shape>__<mesh>.json``
    unless ``out_dir`` is None."""
    is_moe = arch in ("deepseek-v3-671b", "mixtral-8x22b") if arch else False
    space = build_space(is_moe)
    chips = 512 if mesh_kind == "multi" else 256
    unit_price = np.full(space.n_points,
                         chips * PRICE_PER_CHIP_HOUR * profile_steps / 3600.0)
    if mock:
        ev = mock_evaluator(space, is_moe, profile_steps, chips, seed)
    else:
        ev = real_evaluator(arch, shape, mesh_kind, space, is_moe,
                            profile_steps, log)
    out = optimize_live(ev, space, unit_price, slo, tune_settings(la),
                        budget=budget, seed=seed, log=log, device=device)
    out["flags"], out["rules"] = decode_point(space, out["recommended"],
                                              is_moe)
    out.update(arch=arch, shape=shape, mesh=mesh_kind, slo=slo, mock=mock)
    if out_dir:
        p = pathlib.Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        (p / f"{arch}__{shape}__{mesh_kind}.json").write_text(
            json.dumps(out, indent=1, default=str))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--budget", type=float, default=25.0, help="$ budget")
    ap.add_argument("--slo", type=float, default=60.0,
                    help="step-time SLO (s)")
    ap.add_argument("--profile-steps", type=int, default=100)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--la", type=int, default=2)
    ap.add_argument("--out", default="results/autotune")
    ap.add_argument("--device", default="cuda",
                    help="where the selections run: cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = tune(args.arch, args.shape, args.mesh, budget=args.budget,
               slo=args.slo, profile_steps=args.profile_steps,
               mock=args.mock, la=args.la, out_dir=args.out,
               device=args.device)
    print(json.dumps({k: out[k] for k in
                      ("recommended", "flags", "rules", "best_runtime",
                       "best_cost", "spent", "budget")}, indent=1))


if __name__ == "__main__":
    main()
