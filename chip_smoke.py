#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, one line each with its times, then two JSON lines:

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: compiles every CUDA kernel of the main path (one ``nvcc`` per
   source, all started together);
3. kernel: each kernel against its plain PyTorch version on the card,
   bitwise, at the shapes the main path gives it (tf-cnn, M = 384), with
   its time, its plain version's time and its bound;
4. main path: ``run_many`` on tf-cnn at the paper's defaults, timeout off
   and on, through the kernel (launch counts read around the run), then
   the same runs through the plain path (``fused_selector="ref"``) — the
   pinned Outcome fields must be byte-identical;
5. golden: ``run_many`` on ``synthetic_job(0)`` through the kernel must
   reproduce ``src/repro_torch/testdata/golden_outcomes.json``, written by
   the JAX package on the CPU;

then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Any failed phase raises, so the script exits non-zero and prints no result
line.  Without a CUDA device it exits non-zero at once.  It imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import os

# cuBLAS reads this when its handle is created; deterministic algorithms
# need it set before the first CUDA product.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "src" / "repro_torch" / "testdata" / "golden_outcomes.json"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor fp32 op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _launch_ms(launch, n: int = 50, warmup: int = 3) -> float:
    """Device time of one kernel launch: ``n`` launches back to back
    between two CUDA events, so the card never waits on the host."""
    import torch
    for _ in range(warmup):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _median_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each bracketed by
    CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------- #
# Phase 3: the kernel against its plain version
# --------------------------------------------------------------------------- #
def capture_select_step_calls(job, settings, device):
    """Drive one real selection step and keep the arguments of every
    ``select_step`` kernel launch (root S = 1, depth 1, depth 2)."""
    import numpy as np
    from repro_torch.core import lookahead, prng
    from repro_torch.core.space import latin_hypercube_indices
    from repro_torch.kernels.select_step import kernel, ops

    calls = []

    def record(*args, **kw):
        calls.append((args, dict(kw)))
        return kernel.select_step_cuda(*args, **kw)

    rng = np.random.default_rng(5)
    boot = latin_hypercube_indices(job.space, job.bootstrap_size(), rng)
    host = job.host_view()
    y = np.zeros(job.space.n_points, np.float32)
    mask = np.zeros(job.space.n_points, bool)
    cens = np.zeros(job.space.n_points, bool)
    y[boot] = host.cost[boot]
    mask[boot] = True
    cens[boot[:2]] = True
    y[boot[:2]] *= np.float32(0.5)
    sel = lookahead.make_selector(job.space, job.unit_price, job.t_max,
                                  settings, device=device)
    ops._kernel = types.SimpleNamespace(select_step_cuda=record)
    try:
        t0 = time.perf_counter()
        sel(prng.PRNGKey(11), y, mask, np.float32(job.budget(3.0) * 0.8),
            cens if settings.timeout else None)
        import torch
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        ops._kernel = kernel
    return calls, step_s


def _pad_call(args, kw, m_pad, device):
    """The same call on the space padded to ``m_pad`` points (valid mask)."""
    import torch
    feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor, xi = args
    cens = kw.pop("cens", None)
    kw.pop("valid", None)
    m = y.shape[1]
    ext = m_pad - m
    padm = lambda a, v: torch.cat(
        [a, torch.full((a.shape[0], ext), v, dtype=a.dtype, device=device)],
        dim=1)
    pts = torch.cat([points, torch.full((ext, points.shape[1]), 0.5,
                                        device=device)])
    u2 = torch.cat([u, torch.ones(ext, device=device)])
    valid = torch.arange(m_pad, device=device) < m
    cens2 = None if cens is None else padm(cens, False)
    return ((feat, thr, leaf, padm(y, 0.0), padm(obs, False), beta, bf, pts,
             u2, t_max, floor, xi), dict(kw, cens=cens2, valid=valid))


def _random_forest_call(args, kw, seed, device):
    """The call with random forests: random features, thresholds with a
    share of +inf (degenerate splits), random leaves."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    feat, thr, leaf = args[:3]
    n_feat = args[7].shape[1]
    feat2 = torch.randint(0, n_feat, feat.shape, generator=g,
                          dtype=torch.int32)
    thr2 = torch.rand(thr.shape, generator=g)
    thr2[torch.rand(thr.shape, generator=g) < 0.2] = float("inf")
    leaf2 = torch.rand(leaf.shape, generator=g) * 3.0 + 0.05
    return ((feat2.to(device), thr2.to(device), leaf2.to(device))
            + tuple(args[3:])), dict(kw)


def _slice_states(args, kw, n):
    import torch
    s_dim = args[3].shape[0]
    cut = lambda a: (a[:n].contiguous() if isinstance(a, torch.Tensor)
                     and a.dim() >= 1 and a.shape[0] == s_dim else a)
    return tuple(cut(a) for a in args), {k: cut(v) for k, v in kw.items()}


def _bytes_and_ops(args, kw, outs):
    """Bytes the call must move (inputs once, outputs once) and its fp32
    operation count, from this call's shapes."""
    import torch
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    tensors += [v for v in kw.values() if isinstance(v, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += sum(t.numel() * t.element_size() for t in outs)
    s_dim, n_trees, depth = args[0].shape[:3]
    m_dim = args[3].shape[1]
    # Per (state, point): 2·B·D node compares (two descents), 4B + 4 for
    # the mean/spread chains, ~98 for EI_c (two Phi, two phi, exp_det),
    # the budget test and the score.
    ops = s_dim * m_dim * (2 * n_trees * depth + 4 * n_trees + 102)
    return nbytes, ops


def phase_kernel(device, tf_job):
    import torch
    from repro_torch.core import GeometryBucket, Settings
    from repro_torch.kernels.select_step import kernel
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.kernels.select_step.ref import select_step_ref

    t0 = time.perf_counter()
    s = Settings(timeout=True)
    capture_select_step_calls(tf_job, s, device)      # warm-up step
    calls, step_s = capture_select_step_calls(tf_job, s, device)
    _line("kernel", one_selection_step_s=f"{step_s:.4f}",
          launch_shapes=[tuple(c[0][3].shape) for c in calls])
    m = tf_job.space.n_points
    s_dims = [c[0][3].shape[0] for c in calls]
    if s_dims != [1, m * s.k_gh, m * s.k_gh ** 2]:
        raise AssertionError(f"expected launches at S = 1, M·K, M·K²; "
                             f"got {s_dims}")
    root, d1, d2 = calls
    ragged = min(1000, m * s.k_gh - 7)
    m_pad = GeometryBucket.for_spaces([tf_job.space]).m
    cases = [("root_S1_full_nodes", *root), (f"d1_S{m * s.k_gh}_nodes", *d1),
             (f"d2_S{m * s.k_gh ** 2}", *d2),
             (f"ragged_S{ragged}", *_slice_states(*d1, ragged))]
    variants = []
    for name, args, kw in cases:
        variants.append((name + "_cens", args, dict(kw)))
        variants.append((name + "_nocens", args, dict(kw, cens=None)))
        pa, pk = _pad_call(args, dict(kw), m_pad, device)
        variants.append((name + f"_valid{m_pad}", pa, pk))
    ra, rk = _random_forest_call(*d2, seed=3, device=device)
    variants.append((f"d2_S{m * s.k_gh ** 2}_random_forest", ra, rk))
    ra, rk = _random_forest_call(*root, seed=4, device=device)
    variants.append(("root_S1_random_forest", ra, rk))

    rows = []
    max_err = 0.0
    failures = []
    for name, args, kw in variants:
        out_k = select_step_cuda(*args, **kw)
        out_r = select_step_ref(*args, **kw)
        torch.cuda.synchronize()
        bad = []
        for i, (a, b) in enumerate(zip(out_k, out_r)):
            a, b = a.cpu(), b.cpu()
            if a.numpy().tobytes() != b.numpy().tobytes():
                neq = a != b
                diff = (a.double() - b.double()).abs().nan_to_num(
                    nan=float("inf")).max().item()
                max_err = max(max_err, diff)
                first = tuple(int(j) for j in neq.nonzero()[0]) if (
                    neq.any()) else ()
                bad.append(f"out{i}: {int(neq.sum())} of {a.numel()} differ, "
                           f"max abs {diff}, first at {first}: kernel "
                           f"{a[first].item() if first else '?'} plain "
                           f"{b[first].item() if first else '?'}")
        cargs, _, keep = kernel.prepare(*args, **kw)
        ms = _launch_ms(lambda: kernel.launch(cargs))
        call_ms = _median_ms(lambda: select_step_cuda(*args, **kw))
        plain_ms = _median_ms(lambda: select_step_ref(*args, **kw), reps=20)
        del keep
        nbytes, ops = _bytes_and_ops(args, kw, out_k)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / FP32_OPS_PER_S else "operations")
        rows.append(dict(case=name, S=int(args[3].shape[0]),
                         M=int(args[3].shape[1]), ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, ops=ops))
        _line("kernel", case=name, S=args[3].shape[0], M=args[3].shape[1],
              bitwise="differs" if bad else "equal", ms=f"{ms:.5f}",
              call_ms=f"{call_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
              bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, bytes=nbytes,
              ops=ops)
        for b in bad:
            print(f"[kernel]   {name} {b}", flush=True)
            failures.append(f"{name} {b}")
    _line("kernel", phase_s=f"{time.perf_counter() - t0:.1f}",
          variants=len(variants), max_abs_err=max_err)
    if failures:
        raise AssertionError(f"select_step differs from its plain version "
                             f"in {len(failures)} outputs: {failures[:3]}")
    return rows, max_err


# --------------------------------------------------------------------------- #
# Phase 4: the main path at full size
# --------------------------------------------------------------------------- #
def _pinned_json(outcomes):
    from repro_torch.obs.forensics import outcome_to_dict
    return json.dumps([outcome_to_dict(o) for o in outcomes], sort_keys=True)


def _counting_selector_runs(job, settings, n_runs, budget_b, device):
    """``run_many`` with its selector wrapped to count selection steps."""
    from repro_torch.core import lookahead, run_many
    steps = 0
    real = lookahead.make_selector

    def make_counting(*a, **k):
        sel = real(*a, **k)

        def run(*x, **y):
            nonlocal steps
            steps += 1
            return sel(*x, **y)
        return run

    lookahead.make_selector = make_counting
    try:
        t0 = time.perf_counter()
        outs = run_many(job, settings, n_runs=n_runs, budget_b=budget_b,
                        device=device)
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lookahead.make_selector = real
    return outs, steps, wall


def phase_main(device, tf_job, n_runs=1, budget_b=3.0):
    """tf-cnn at the paper's defaults, timeout off and on, through the
    kernel and then through the plain path.  One run per setting: a run
    with the timeout on takes some 190 selection steps of ~0.8 s each on
    an H100, and the script must stay well inside its time limit."""
    import dataclasses

    from repro_torch.core import Settings
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs.forensics import diff_outcomes

    launches = 0
    for timeout in (False, True):
        s = Settings(timeout=timeout)
        select_step_cuda.launches = 0
        outs, steps, wall = _counting_selector_runs(tf_job, s, n_runs,
                                                    budget_b, device)
        n = select_step_cuda.launches
        if n != 3 * steps or steps == 0:
            raise AssertionError(f"timeout={timeout}: {n} kernel launches "
                                 f"for {steps} selection steps (want 3 each)")
        launches += n
        sel_s = [o.select_seconds for o in outs]
        ref_outs, ref_steps, ref_wall = _counting_selector_runs(
            tf_job, dataclasses.replace(s, fused_selector="ref"), n_runs,
            budget_b, device)
        if _pinned_json(outs) != _pinned_json(ref_outs):
            raise AssertionError(
                "kernel path and plain path disagree: "
                + "; ".join(diff_outcomes(ref_outs, outs)[:5]))
        _line("main", job=tf_job.name, timeout=timeout, runs=n_runs,
              budget_b=budget_b, steps=steps, launches=n,
              steps_per_s=f"{steps / wall:.3f}",
              mean_select_s=f"{statistics.mean(sel_s):.4f}",
              wall_s=f"{wall:.1f}", ref_steps_per_s=f"{ref_steps / ref_wall:.3f}",
              ref_mean_select_s=f"{statistics.mean(o.select_seconds for o in ref_outs):.4f}",
              nex=[o.nex for o in outs], cno=[round(o.cno, 4) for o in outs],
              pinned_equal_ref=True)
    return launches


# --------------------------------------------------------------------------- #
# Phase 5: the JAX package's golden outcomes
# --------------------------------------------------------------------------- #
def phase_golden(device):
    from repro_torch.core import Settings, run_many
    from repro_torch.jobs.synthetic import synthetic_job
    from repro_torch.obs.forensics import outcome_to_dict

    golden = json.loads(GOLDEN.read_text())
    job = synthetic_job(golden["job_seed"])
    t0 = time.perf_counter()
    for case in golden["cases"]:
        s = Settings(**case["settings"])
        outs = run_many(job, s, n_runs=golden["n_runs"],
                        budget_b=golden["budget_b"], device=device)
        got = [outcome_to_dict(o) for o in outs]
        want = case["outcomes"]
        if json.dumps(got, sort_keys=True) != json.dumps(want,
                                                         sort_keys=True):
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"golden {case['settings']}: runs {bad} "
                                 "differ from the JAX package's outcomes")
        _line("golden", settings=json.dumps(case["settings"],
                                            separators=(",", ":")),
              runs=len(outs), equal=True)
    _line("golden", phase_s=f"{time.perf_counter() - t0:.1f}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import set_cuda_determinism
    from repro_torch.jobs.synthetic import tensorflow_jobs
    from repro_torch.kernels import build

    set_cuda_determinism()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _line("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    _line("build", sources=",".join(logs), seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}", flush=True)

    tf_job = tensorflow_jobs(0)[0]
    rows, max_err = phase_kernel(device, tf_job)
    launches = phase_main(device, tf_job)
    phase_golden(device)

    # The depth-2 launch, the one that moves the most bytes, stands for the
    # kernel in the summary line.
    row = next(r for r in rows if r["case"].startswith("d2_")
               and r["case"].endswith("_cens"))
    kernels = [{
        "name": "select_step", "route": "cuda",
        "source": "src/repro_torch/csrc/select_step.cu",
        "replaces": "src/repro/kernels/select_step/kernel.py:255",
        "launches": launches, "max_abs_err": max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": {"S": row["S"], "M": row["M"]},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
