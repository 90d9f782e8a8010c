#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only tree_predict,gh_ei,masked_argmax
    python3 chip_smoke.py --only batched

With ``--only`` it builds, runs the named kernels' checks and times of
phases ops and analysis (or, for ``batched``, the batched step's launches
of phase kernel and phase batched), and prints no result line (a
measurement run).
Without it, phases one line each with its times, then two JSON lines:

1. device: the card's name and ``nvidia-smi`` name/power limit;
2. build: compiles every CUDA kernel (one ``nvcc`` per source, all
   started together) and fails if ``-Xptxas -v`` shows a spill in the
   kernels whose register budget is their design (``NO_SPILL``);
3. kernel: the select_step kernel against its plain PyTorch version on
   the card, bitwise, at the shapes the main path gives it (tf-cnn, M =
   384: root S = 1, depth 1 S = 1152, depth 2 S = 3456, with and without
   censoring, padded to the bucket, a ragged S, random forests) and
   beyond them (16 trees of depth 6, M = 377, y* over signed zeros and
   ties), and at one batched selection step of 2 tf-cnn runs (S = 2,
   2304, 6912, each state with its run's sigma floor), each with its
   launch plan (grid, lanes per state, states a
   block, shared bytes, registers), its device time (``ms``: launches
   replayed from a CUDA graph; ``launch_ms``: launched back to back from
   the host), the main path's launches also at other lanes per state, its
   plain version's time and its bound;
4. ops: the kernel entry point ``repro_torch.kernels`` — tree_predict and
   gh_ei on the forests and root posterior of a real tf-cnn selection
   step, flash_attention on a gemma2-9b prefill (S = T = 8192, local,
   global, causal and non-causal, bf16 and f32) and bf16 edge cases of
   the tensor-core kernel (S and T off the tiles, D 112 and 100, MQA),
   decode_attention on gemma2-9b caches at B = 8 (global T = 8192 and
   local ring T = 4096, each full and filling; splits whose slots are all
   dead, every slot dead, a ragged last tile) and at zamba2-7b's shape,
   and ssm_scan at xlstm-125m's mLSTM widths (N = 192, P = 193, float32,
   held against the plain version in float64 as in phase model); scale
   cases, not path shapes, of tree_predict and gh_ei at M = 1 << 20
   (tf-cnn's F = 5, B = 10, D = 4; K = 3), timed over copies of their
   inputs that move three times the L2 cache.  Each case is driven
   through the op once with the launch counts at 0, then held against
   the plain version within its tolerance and timed (from a CUDA graph,
   ``ms``, with the host-launched ``launch_ms`` beside it; tree_predict
   with its launch plan: grid, threads, tile, shared bytes, registers)
   beside its plain version, its bound and, where one PyTorch call
   computes the same function, that call (``library_ms``: SDPA, or a
   compiled ``flex_attention`` for the softcapped and windowed prefills,
   with its max abs error against the plain version, and ``vs_library``,
   the kernel's time over the library call's);
5. main path: ``run_many`` on tf-cnn at the paper's defaults, timeout off
   and on, through the kernel (launch counts read around the run), then
   the same runs through the plain path (``fused_selector="ref"``) — the
   pinned Outcome fields must be byte-identical;
6. golden: ``run_many`` on ``synthetic_job(0)`` through the kernel must
   reproduce ``src/repro_torch/testdata/golden_outcomes.json``, written by
   the JAX package on the CPU;
7. batched: the batched harness (``run_many_batched``,
   ``run_queue_batched``) through the kernel: (a) the golden runs of
   phase 6, compact on 2 slots and lockstep on 3; (b) the three-job and
   the three-geometry queues of ``tests/test_batched_harness.py`` against
   ``run_queue``, each bucketed drain adding one program geometry; (c)
   tf-cnn's bootstrap states at the deployment's slot count
   (``_auto_lane_chunk``: 11 seats) in one batched step, 3 launches (S =
   11, 12,672, 38,016), each seat bitwise equal to the sequential
   selector, with its seconds and peak memory; (d) tf-cnn, 3 runs on 2
   slots (a refill), against ``run_many``, with 3 launches a step and the
   host syncs inside the step bodies counted; steps/s and mean
   ``select_seconds`` of both;
8. analysis: the determinism gate's kernel, masked_argmax, against its
   plain version (both variants; random scores, near-ties, exact ties,
   NaN, -0.0/+0.0, infinities and all-invalid rows at M = 16, 384, 4096
   and 1 << 20: the index exactly) with its launch plan (grid, threads,
   scratch, registers), its time from a CUDA graph (at 1 << 20 over
   copies of the row) and launched from the host, the plain version's
   and the bound; then the gate, ``repro_torch.analysis``'s entry point with
   ``--all --device cuda``, with the kernel's launch count at 0 before and
   read after; its findings (fixtures and registered programs) held equal
   to the CPU's; and ``python -m repro_torch.analysis --all --device cuda``
   as a command;
9. model: zamba2-7b served at full width and depth (81 layers, d_model
   3584, 6.75 B float32 parameters drawn on the card from a seeded
   generator) through ``repro_torch.launch.serve.generate``: B = 4 prompts
   of 1000 tokens from ``make_batch(seed=0)``, 32 tokens each, with the
   launch counts at 0 before and read after (ssm_scan 81, flash_attention
   13, decode_attention 13 x 31), with prefill seconds and decode
   tokens/s.  Then layer 0's and layer 80's ssm_scan (float32, and k/q/v
   cast to bf16), site 0's flash_attention and the last decode_attention
   call, each held against its plain version on the arguments captured
   from that run and timed beside it, its bound and (attention) SDPA;
   ssm_scan also with each of its three kernels' device times
   (``kernel_ms``: each launched alone between CUDA events).
   Last, zamba2-smoke through the kernels, teacher-forced, against the
   JAX package's logits (``golden_zamba.json``, atol 2e-4);

then the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.
Any failed phase raises, so the script exits non-zero and prints no result
line.
Without a CUDA device it exits non-zero at once.  It imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import os

# cuBLAS reads this when its handle is created; deterministic algorithms
# need it set before the first CUDA product.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# The compiled flex_attention yardstick keeps its caches in the checkout.
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      os.path.join(_BUILD, "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_BUILD, "triton"))

import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "src" / "repro_torch" / "testdata" / "golden_outcomes.json"
GOLDEN_ZAMBA = ROOT / "src" / "repro_torch" / "testdata" / "golden_zamba.json"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 op/s
# and dense bf16 tensor-core op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12        # dense, tensor cores
TF32_OPS_PER_S = 495e12        # dense, tensor cores


def _fmt(key, v):
    if isinstance(v, float) and key.endswith("ms"):
        return f"{v:.5f}"
    if isinstance(v, dict):
        return json.dumps(v, separators=(",", ":"))
    return json.dumps(v) if isinstance(v, str) else v


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


def _graph_ms(launch, n: int = 20, reps: int = 10) -> float:
    """Device time of one kernel launch without the host's: ``n`` launches
    captured in a CUDA graph, replayed ``reps`` times between two CUDA
    events.  ``launch`` must launch on the current stream when called (the
    capture stream inside the capture)."""
    import torch
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


L2_BYTES = 50 * 2 ** 20


def _cold_copies(nbytes: int) -> int:
    """Copies of a scale case's inputs (and outputs) whose rotation moves
    three times the card's L2 cache, so that no launch finds its inputs
    there."""
    return max(2, -(-3 * L2_BYTES // nbytes))


def _in_turn(launch, preps, device=None):
    """A launch of ``launch`` on each prepared argument tuple of ``preps``
    in turn.  With ``device`` the stream (each C entry's last argument) is
    the current one at each launch, so that a CUDA graph captures it."""
    import itertools
    from repro_torch.kernels import capi
    turn = itertools.cycle(preps)
    if device is None:
        return lambda: launch(next(turn))
    return lambda: launch(next(turn)[:-1] + (capi.stream(device),))


def _timed(launch, preps, device, n):
    """(graph ms, host-launched ms) of ``launch`` over ``preps`` in turn,
    ``n`` launches each way (at least one of each of ``preps``)."""
    n = max(n, len(preps))
    ms = _graph_ms(_in_turn(launch, preps, device), n=n)
    launch_ms = _launch_ms(_in_turn(launch, preps), n=n, warmup=min(3, n))
    return ms, launch_ms


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


def _seat_states(job, settings, seats, device):
    """The bootstrap states of ``seats`` runs (seeds 0, 1, ... of
    ``run_many``) on the card, and each run's first selection key."""
    import torch
    from repro_torch.core import RunRequest, optimizer, prng
    reqs = [RunRequest(job, sd)
            for sd in optimizer._per_run_seeds(0, seats)]
    st = optimizer._init_run_states(reqs, settings)
    st.pop("budgets")
    st = {k: torch.as_tensor(v, device=device) for k, v in st.items()}
    st["sub"] = prng.split(st["keys"]).unbind(-2)[1]
    st["beta"] = torch.clamp_min(st["beta"], 0.0)
    return st


def _batched_select(job, settings, st, device):
    """One batched selection step of the seats in ``st`` (one job: one
    group), timed to its end."""
    import numpy as np
    import torch
    from repro_torch.core import lookahead
    pts, left, thr, u = lookahead.space_arrays(job.space, job.unit_price,
                                               device)
    t_max = torch.tensor(float(np.float32(job.t_max)), device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lookahead.select_next_batched(
        st["sub"], st["y"], st["mask"], st["beta"], pts, left, thr, u, t_max,
        settings, st["cens"] if settings.timeout else None, None)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def capture_batched_calls(job, settings, seats, device):
    """The arguments of every ``select_step`` launch of one batched
    selection step at ``seats`` runs (S = R, R·M·K, R·M·K²)."""
    from repro_torch.kernels.select_step import kernel, ops
    calls = []

    def record(*args, **kw):
        calls.append((args, dict(kw)))
        return kernel.select_step_cuda(*args, **kw)

    st = _seat_states(job, settings, seats, device)
    ops._kernel = types.SimpleNamespace(select_step_cuda=record)
    try:
        _, step_s = _batched_select(job, settings, st, device)
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


def _random_forest_call(args, kw, seed, device, n_trees=None, depth=None):
    """The call with random forests: random features, thresholds with a
    share of +inf (degenerate splits), random leaves; ``n_trees`` and
    ``depth`` (default: the call's) set another geometry."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    feat, thr, leaf = args[:3]
    s_dim = feat.shape[0]
    n_trees = n_trees or feat.shape[1]
    depth = depth or feat.shape[2]
    shape = (s_dim, n_trees, depth, 2 ** (depth - 1))
    n_feat = args[7].shape[1]
    feat2 = torch.randint(0, n_feat, shape, generator=g, dtype=torch.int32)
    thr2 = torch.rand(shape, generator=g)
    thr2[torch.rand(shape, generator=g) < 0.2] = float("inf")
    leaf2 = torch.rand((s_dim, n_trees, 2 ** depth), generator=g) * 3.0 + 0.05
    return ((feat2.to(device), thr2.to(device), leaf2.to(device))
            + tuple(args[3:])), dict(kw)


def _cut_points(args, kw, m):
    """The call on the first ``m`` points of the space."""
    feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor, xi = args
    cut = lambda a: None if a is None else a[..., :m].contiguous()
    return ((feat, thr, leaf, cut(y), cut(obs), beta, bf,
             points[:m].contiguous(), cut(u), t_max, floor, xi),
            dict(kw, cens=cut(kw.get("cens")), valid=cut(kw.get("valid"))))


def _signed_zero_call(args, kw):
    """The call with y* on its fallback (no best feasible): in even states
    every observed y is a zero, -0.0 and +0.0 in turn, so y*'s maximum over
    them is a zero of either sign; in odd states every observed y is 1.25,
    a tie at the maximum.  Every third state has no budget left, so no
    candidate: its pick is the lowest index."""
    import torch
    feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor, xi = args
    s_dim, m_dim = y.shape
    zeros = torch.tensor([-0.0, 0.0], device=y.device)[
        torch.arange(m_dim, device=y.device) % 2].expand(s_dim, m_dim)
    even = (torch.arange(s_dim, device=y.device) % 2 == 0)[:, None]
    y2 = torch.where(obs, torch.where(even, zeros, 1.25), y).contiguous()
    broke = torch.arange(s_dim, device=y.device) % 3 == 0
    beta2 = torch.where(broke, 0.0, beta).contiguous()
    return ((feat, thr, leaf, y2, obs, beta2, torch.full_like(bf, math.inf),
             points, u, t_max, floor, xi), dict(kw))


def _slice_states(args, kw, n):
    import torch
    s_dim = args[3].shape[0]
    cut = lambda a: (a[:n].contiguous() if isinstance(a, torch.Tensor)
                     and a.dim() >= 1 and a.shape[0] == s_dim else a)
    return tuple(cut(a) for a in args), {k: cut(v) for k, v in kw.items()}


def _select_step_plan(args, kw):
    """The launch geometry the wrapper plans for this call."""
    from repro_torch.kernels.select_step import kernel
    s_dim, n_trees, depth = args[0].shape[:3]
    m_dim, n_feat = args[7].shape
    return kernel.plan(s_dim, n_trees, depth, m_dim, n_feat,
                       cens=kw.get("cens") is not None,
                       sm_count=kernel._sm_count(args[3].device.index))


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
    # Per (state, point): B·D node compares (the function descends each
    # tree once, whatever implements it), 4B + 4 for the mean/spread
    # chains, ~98 for EI_c (two Phi, two phi, exp_det), the budget test and
    # the score.
    ops = s_dim * m_dim * (n_trees * depth + 4 * n_trees + 102)
    return nbytes, ops


BATCHED_KERNEL_SEATS = 2


def _batched_variants(tf_job, s, device):
    """Phase kernel's cases from one batched tf-cnn selection step at
    ``BATCHED_KERNEL_SEATS`` runs: one launch a level for both runs, each
    state with its own run's sigma floor."""
    capture_batched_calls(tf_job, s, BATCHED_KERNEL_SEATS, device)  # warm-up
    calls, step_s = capture_batched_calls(tf_job, s, BATCHED_KERNEL_SEATS,
                                          device)
    r, m, k = BATCHED_KERNEL_SEATS, tf_job.space.n_points, s.k_gh
    s_dims = [c[0][3].shape[0] for c in calls]
    if s_dims != [r, r * m * k, r * m * k * k]:
        raise AssertionError(f"batched step at {r} runs: expected launches "
                             f"at S = R, R·M·K, R·M·K²; got {s_dims}")
    _line("kernel", batched_runs=r, batched_selection_step_s=f"{step_s:.4f}",
          launch_shapes=[tuple(c[0][3].shape) for c in calls])
    return [(f"batched{r}_{tag}_S{n}", *c)
            for tag, n, c in zip(("root", "d1", "d2"), s_dims, calls)]


def phase_kernel(device, tf_job, only_batched=False):
    """The select_step kernel against its plain version at the main
    path's shapes and beyond them, then at a batched step's (phase
    batched's launches); ``only_batched``: the batched step's alone."""
    from repro_torch.core import GeometryBucket, Settings

    t0 = time.perf_counter()
    s = Settings(timeout=True)
    if only_batched:
        variants = _batched_variants(tf_job, s, device)
        return _kernel_checks(variants, device, t0)
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
    # Beyond the main path's shapes: another geometry that Settings allows,
    # M off the warp width, and y*'s maxima over signed zeros and ties.
    ra, rk = _random_forest_call(*d1, seed=5, device=device, n_trees=16,
                                 depth=6)
    variants.append((f"d1_S{m * s.k_gh}_random_forest_B16_D6", ra, rk))
    for name, (args, kw) in (("root_S1", root), (f"d1_S{m * s.k_gh}", d1)):
        variants.append((f"{name}_M{m - 7}", *_cut_points(args, kw, m - 7)))
        variants.append((f"{name}_signed_zero_ties",
                         *_signed_zero_call(args, kw)))
    variants += _batched_variants(tf_job, s, device)
    return _kernel_checks(variants, device, t0)


def _kernel_checks(variants, device, t0):
    """Each variant's kernel output against its plain version, bitwise,
    with its plan and times; raises on any difference."""
    import torch
    from repro_torch.kernels.select_step import kernel
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.kernels.select_step.ref import select_step_ref

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
        geo = _select_step_plan(args, kw)
        regs, local = kernel.attributes(int(args[0].shape[1]))
        cargs, _, keep = kernel.prepare(*args, **kw)
        on_stream = lambda a: _in_turn(kernel.launch, [a], device)
        ms = _graph_ms(on_stream(cargs))
        launch_ms = _launch_ms(lambda: kernel.launch(cargs))
        # The main path's three launches also at other lanes per state.
        ms_wps = {}
        if not name.endswith(("_nocens", "forest", "ties")) and (
                "_valid" not in name and "_M" not in name):
            for wps in (1, 2, 4, 8):
                if (wps != geo.warps_per_state
                        and wps <= -(-args[3].shape[1] // 32)):
                    wargs, _, wkeep = kernel.prepare(*args, **kw,
                                                     warps_per_state=wps)
                    ms_wps[wps] = round(_graph_ms(on_stream(wargs)), 5)
                    del wkeep
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
              B=args[0].shape[1], D=args[0].shape[2],
              bitwise="differs" if bad else "equal", ms=f"{ms:.5f}",
              launch_ms=f"{launch_ms:.5f}", call_ms=f"{call_ms:.5f}",
              plain_ms=f"{plain_ms:.5f}",
              bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, bytes=nbytes,
              ops=ops, grid=geo.grid, lanes_per_state=32 * geo.warps_per_state,
              states_a_block=geo.groups, threads=geo.threads,
              smem_bytes=geo.smem, registers=regs, local_bytes=local,
              ms_by_warps_per_state=_fmt("", ms_wps))
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
# Phase 4: the kernel entry point (repro_torch.kernels) at full width
# --------------------------------------------------------------------------- #
# gemma2-9b's attention widths (src/repro/configs/gemma2_9b.py).
GEMMA2 = dict(n_heads=16, n_kv_heads=8, head_dim=256, window=4096,
              softcap=50.0, scale=256 ** -0.5)
PREFILL_S = 8192          # twice the window: the local layers' window binds
# bf16 (atol, rtol): both sides take q·k in float32 (a bf16 product is
# exact there) and round the output to bf16, so they may land one bf16 ulp
# apart (at most 2^-7·|want|).  The flash kernel also rounds p to bf16
# before P·V on the tensor cores: about 2^-9·|p∘v| more per output, ~2e-5
# at these statistics; the atol covers that and outputs near 0.
BF16_TOL = (1e-3, 1e-2)
DECODE_B = 8
# (label, T, window, pos): the global layers' cache and the local layers'
# ring, full (the ring has rolled over at pos 8191) and filling (the slots
# past pos are empty: pos - slot < 0, where floor modulo matters).
DECODE_CACHES = (("global cache T 8192, pos 8191", 8192, None, 8191),
                 ("local ring T 4096, window 4096, pos 8191 (rollover)",
                  4096, 4096, 8191),
                 ("global cache T 8192, pos 5000 (filling)", 8192, None,
                  5000),
                 ("local ring T 4096, window 4096, pos 3000 (filling)",
                  4096, 4096, 3000),
                 # Edge cases of the split over T: splits whose slots are
                 # all dead, and a ragged last tile.
                 ("global cache T 8192, pos 10 (all-dead splits)", 8192,
                  None, 10),
                 ("cache T 1000 (ragged last tile), pos 1500 (rollover)",
                  1000, None, 1500),
                 ("global cache T 8192, pos -1 (every slot dead)", 8192,
                  None, -1))
# flash_attention edge cases of the tensor-core kernel, bf16: (label, H,
# KH, S, T, D, causal, window, softcap).  S and T off the 64-row tiles,
# head dims zero-padded in shared memory (112: zamba2-7b's; 100: not a
# multiple of 8, so 8-byte copies), and MQA.
FLASH_EDGES = (
    ("ragged S = T = 1000, causal, window 300, softcap 50", 16, 8, 1000,
     1000, 256, True, 300, 50.0),
    ("cross S 200, T 1000, non-causal", 16, 8, 200, 1000, 256, False, None,
     None),
    ("D 112 (zamba2-7b heads), S = T = 1000, causal", 32, 32, 1000, 1000,
     112, True, None, None),
    ("D 100, S = T = 500, causal, softcap 30", 4, 2, 500, 500, 100, True,
     None, 30.0),
    ("MQA KH 1, D 128, S = T = 777, causal, window 200", 8, 1, 777, 777, 128,
     True, 200, None))
# zamba2-7b's decode shape (B 4, KH 32, G 1, D 112, f32) through the
# [B, T, KH, D] ring cache's transposed view, as the model calls it.
ZAMBA_DECODE = dict(b=4, kh=32, t=1032, d=112, pos=1031)


class OpCase:
    """One call of a ``repro_torch.kernels`` op: ``run`` goes through the
    public op (the kernel, counted), ``plain`` through ``force="ref"``,
    ``prep``/``launch`` give uncounted launches for timing, ``library`` is
    one PyTorch call of the same function (or None).

    The kernel's ``ms`` is replayed from a CUDA graph (its host-launched
    time beside it as ``launch_ms``).  ``copies`` > 1 makes
    ``prep(i)`` prepare the i-th copy of the inputs: the timed launches
    take the copies in turn, so that a scale case reads its inputs from
    device memory and not from the L2 cache.  ``plan`` gives the launch
    plan printed beside the times (grid, threads, shared bytes,
    registers)."""

    def __init__(self, kernel, name, run, plain, prep, launch, compare,
                 nbytes, ops, peak, library=None, reps=50, plain_reps=20,
                 extra=None, copies=1, plan=None):
        self.kernel, self.name = kernel, name
        self.run, self.plain, self.prep, self.launch = run, plain, prep, launch
        self.compare, self.library = compare, library
        self.nbytes, self.ops, self.peak = nbytes, ops, peak
        self.reps, self.plain_reps = reps, plain_reps
        self.extra = extra or {}
        self.copies, self.plan = copies, plan


def _close(atol, rtol=0.0, exact=()):
    """Compare outputs: ``|got - want| <= atol + rtol·|want|`` elementwise
    (in float64), and bitwise for the output indices in ``exact``.
    Returns (max abs error, list of failures)."""
    def compare(got, want):
        import torch
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        err, bad = 0.0, []
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape or a.dtype != b.dtype:
                bad.append(f"out{i}: {a.dtype}{tuple(a.shape)} vs "
                           f"{b.dtype}{tuple(b.shape)}")
                continue
            if i in exact:
                n = int((a != b).sum())
                if n:
                    bad.append(f"out{i}: {n} of {a.numel()} differ")
                continue
            a64, b64 = a.double(), b.double()
            diff = (a64 - b64).abs()
            e = diff.nan_to_num(nan=float("inf")).max().item() if (
                diff.numel()) else 0.0
            err = max(err, e)
            n = int((~(diff <= atol + rtol * b64.abs())).sum())
            if n:
                bad.append(f"out{i}: {n} of {a.numel()} outside atol {atol} "
                           f"rtol {rtol}, max abs {e}")
        return err, bad
    return compare


def _tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _per_forest(compare):
    """A compare over lists of output tuples, one per forest."""
    def run(got, want):
        err, bad = 0.0, []
        for i, (g, w) in enumerate(zip(got, want)):
            e, b = compare(g, w)
            err = max(err, e)
            bad += [f"forest {i} {x}" for x in b]
        return err, bad
    return run


def _tree_plan(points, forest):
    """The launch plan of tree_predict over ``points`` and its registers."""
    from repro_torch.kernels.tree_predict import kernel as tp
    geo = tp.plan(points.shape[0], points.shape[1], *forest[0].shape[:2],
                  sm_count=tp._sm_count(points.device.index))
    regs, local = tp.attributes(forest[0].shape[1])
    return dict(grid=geo.grid, threads=geo.threads, tile=geo.tile,
                smem_bytes=geo.smem, registers=regs, local_bytes=local)


def _tree_cases(points, forests, floor, label, scale=False):
    """tree_predict over ``points`` for each (feat, thr, leaf) forest; a
    ``scale`` case times its launches over copies of the points."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.tree_predict import kernel as tp
    n_trees, depth, _ = forests[0][0].shape
    m_dim = points.shape[0]
    # Inputs once and mu, sigma [M] f32, per forest.
    nbytes = len(forests) * (_tensor_bytes(points, *forests[0]) + 8 * m_dim)
    copies = _cold_copies(nbytes) if scale else 1
    xs = [points] + [points.clone() for _ in range(copies - 1)]
    # One descent per tree (a compare and an index step a level), then the
    # mean and the two-pass spread over the trees.
    ops = len(forests) * m_dim * (n_trees * (2 * depth + 4) + 3)
    inf_share = sum(float(torch.isinf(f[1]).float().mean()) for f in forests
                    ) / len(forests)
    # The JAX test's 1e-5 at tf-cnn's scale too: its leaves are costs
    # under 1, and the kernel takes the two-pass spread as the plain
    # version does.
    return OpCase(
        "tree_predict", label,
        run=lambda: [kernels.tree_predict(points, *f, sigma_floor=floor)
                     for f in forests],
        plain=lambda: [kernels.tree_predict(points, *f, sigma_floor=floor,
                                            force="ref") for f in forests],
        prep=lambda i=0: tp.prepare(xs[i], *forests[0], sigma_floor=floor),
        launch=tp.launch, compare=_per_forest(_close(1e-5)), nbytes=nbytes,
        ops=ops, peak=FP32_OPS_PER_S, copies=copies,
        plan=lambda: _tree_plan(points, forests[0]),
        extra=dict(forests=len(forests), M=m_dim, B=n_trees, D=depth,
                   inf_thr_share=round(inf_share, 4)))


def _gh_ei_case(label, args, kw, scale=False):
    """gh_ei on ``args``; ``kw`` may carry the censoring pre-pass.  A
    ``scale`` case times its launches over copies of the posterior."""
    from repro_torch import kernels
    from repro_torch.core import acquisition as acq
    from repro_torch.kernels.gh_ei import kernel as ge
    mu, sigma, u, ystar, t_max, beta, xi = args
    cens = kw.get("cens")
    # The kernel alone, for timing: on the pre-pass's output.
    adj = ((mu, sigma) if cens is None else acq.censored_adjust(
        mu, sigma, kw["y_cens"], cens, kw["cens_sigma_rel"]))
    m_dim, k_gh = mu.shape[0], xi.shape[0]
    nbytes = 4 * m_dim * (3 + 1 + k_gh) + m_dim + 4 * (k_gh + 3)
    copies = _cold_copies(nbytes) if scale else 1
    posts = [(*adj, args[2])] + [tuple(t.clone() for t in (*adj, args[2]))
                                 for _ in range(copies - 1)]
    return OpCase(
        "gh_ei", label,
        run=lambda: kernels.gh_ei(*args, **kw),
        plain=lambda: kernels.gh_ei(*args, **kw, force="ref"),
        prep=lambda i=0: ge.prepare(*posts[i], *args[3:], conf=kw["conf"]),
        launch=ge.launch, compare=_close(1e-5, exact=(1,)),
        nbytes=nbytes,
        # ~40 per point for EI_c (two erf, an exp, three divisions), one
        # compare, two per node.
        ops=m_dim * (42 + 2 * k_gh), peak=FP32_OPS_PER_S, copies=copies,
        extra=dict(M=m_dim, K=k_gh, censored=0 if cens is None
                   else int(cens.sum())))


# The scale cases of the small kernels: 2^20 points (tf-cnn has 384).
SCALE_M = 1 << 20


def ops_cases(device, tf_job, only=None):
    """Every kernel of ``repro_torch.kernels`` but select_step at the
    shapes of this slice: tf-cnn's forests and root posterior (and their
    scale cases), gemma2-9b's attention, xlstm-125m's scan.  ``only``
    names the kernels whose cases are made (all by default)."""
    want = lambda *names: only is None or any(n in only for n in names)
    cases = []
    if want("tree_predict", "gh_ei"):
        cases += _forest_cases(device, tf_job)
    if want("flash_attention", "decode_attention"):
        cases += _attention_cases(device)
    if want("ssm_scan"):
        cases.append(_xlstm_scan_case(device))
    return [c for c in cases if want(c.kernel)]


def _forest_cases(device, tf_job):
    """tree_predict and gh_ei on a real tf-cnn selection step's forests and
    root posterior, and their scale cases."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import Settings
    from repro_torch.core import acquisition as acq
    from repro_torch.kernels.select_step.ref import select_step_ref

    cases = []
    calls, _ = capture_select_step_calls(tf_job, Settings(timeout=True),
                                         device)
    (root_args, root_kw), (d1_args, _d1_kw) = calls[0], calls[1]
    points = root_args[7]
    floor = float(root_args[10])
    forest = lambda args, i: tuple(a[i] for a in args[:3])
    cases.append(_tree_cases(points, [forest(root_args, 0)], floor,
                             "tf-cnn root forest"))
    cases.append(_tree_cases(points, [forest(d1_args, i) for i in range(64)],
                             floor, "tf-cnn depth-1 forests 0..63"))
    g = torch.Generator(device=device).manual_seed(7)
    n_trees, depth, width = root_args[0].shape[1:]
    rand = (torch.randint(0, points.shape[1], (n_trees, depth, width),
                          generator=g, device=device, dtype=torch.int32),
            torch.rand((n_trees, depth, width), generator=g, device=device),
            torch.randn((n_trees, 2 ** depth), generator=g, device=device))
    rand[1][torch.rand(rand[1].shape, generator=g, device=device) < 0.2] = (
        float("inf"))
    cases.append(_tree_cases(points, [rand], 1e-6,
                             "N(0,1)-leaf random forest"))

    # gh_ei on the root posterior of the captured step: with the step's
    # beta and censoring, and uncensored with beta at the median of
    # mu + q·sigma, so that the budget flag splits the points.
    y, beta, u, t_max = root_args[3], root_args[5], root_args[8], root_args[9]
    xi = root_args[11]
    cens = root_kw.get("cens")
    mu, sigma = kernels.tree_predict(points, *forest(root_args, 0),
                                     sigma_floor=floor)
    # The step's y*: the root launch emits full rows, y* fourth.
    ystar = select_step_ref(*root_args, **root_kw)[3][0]
    conf = root_kw.get("conf", 0.99)
    q = acq.normal_quantile(conf)
    cases.append(_gh_ei_case("tf-cnn root posterior, step's beta, censored",
                             (mu, sigma, u, ystar, t_max, beta[0], xi),
                             dict(cens=cens[0], y_cens=y[0], conf=conf,
                                  cens_sigma_rel=root_kw["cens_rel"])))
    cases.append(_gh_ei_case("tf-cnn root posterior, median beta",
                             (mu, sigma, u, ystar, t_max,
                              (mu + q * sigma).median(), xi),
                             dict(conf=conf)))

    # Scale cases, not path shapes: M = SCALE_M points, where bytes and
    # not a launch's latency set the bound.  tree_predict on uniform points
    # of tf-cnn's F = 5 with a random forest of its B = 10 trees of depth 4
    # (20% +inf thresholds); gh_ei on the root posterior drawn SCALE_M
    # times (point, posterior and price together), K = 3, median beta.
    big = torch.rand((SCALE_M, points.shape[1]), generator=g, device=device)
    rand_big = (torch.randint(0, points.shape[1], (n_trees, depth, width),
                              generator=g, device=device, dtype=torch.int32),
                torch.rand((n_trees, depth, width), generator=g,
                           device=device),
                torch.randn((n_trees, 2 ** depth), generator=g,
                            device=device))
    rand_big[1][torch.rand(rand_big[1].shape, generator=g, device=device)
                < 0.2] = float("inf")
    cases.append(_tree_cases(big, [rand_big], 1e-6,
                             f"scale case M={SCALE_M}: N(0,1)-leaf random "
                             f"forest", scale=True))
    pick = torch.randint(0, mu.shape[0], (SCALE_M,), generator=g,
                         device=device)
    mu_b, sigma_b, u_b = mu[pick], sigma[pick], u[pick]
    cases.append(_gh_ei_case(f"scale case M={SCALE_M}: root posterior "
                             f"drawn, median beta",
                             (mu_b, sigma_b, u_b, ystar, t_max,
                              (mu_b + q * sigma_b).median(), xi),
                             dict(conf=conf), scale=True))

    return cases


def _attention_cases(device):
    """flash_attention on a gemma2-9b prefill and edge cases of the
    tensor-core kernel; decode_attention on gemma2-9b caches and at
    zamba2-7b's decode shape."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa

    cases = []
    # flash_attention: a gemma2-9b prefill, four variants, two dtypes.
    h, kh, d = GEMMA2["n_heads"], GEMMA2["n_kv_heads"], GEMMA2["head_dim"]
    s = PREFILL_S
    cap, win = GEMMA2["softcap"], GEMMA2["window"]
    variants = [(f"local: causal, window {win}, softcap {cap:g}",
                 dict(causal=True, window=win, softcap=cap)),
                (f"global: causal, softcap {cap:g}",
                 dict(causal=True, window=None, softcap=cap)),
                ("causal", dict(causal=True, window=None, softcap=None)),
                ("non-causal", dict(causal=False, window=None,
                                    softcap=None))]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, tol, peak in ((torch.bfloat16, BF16_TOL, BF16_OPS_PER_S),
                             (torch.float32, (2e-5, 2e-5), FP32_OPS_PER_S)):
        gq = torch.Generator(device=device).manual_seed(11)
        q = torch.randn((1, h, s, d), generator=gq, device=device
                        ).to(dtype)
        k = torch.randn((1, kh, s, d), generator=gq, device=device
                        ).to(dtype)
        v = torch.randn((1, kh, s, d), generator=gq, device=device
                        ).to(dtype)
        for label, kw in variants:
            kw = dict(kw, scale=GEMMA2["scale"])
            pairs = _live_pairs(s, s, kw["causal"], kw["window"])
            if kw["softcap"] is None and kw["window"] is None:
                lib = (lambda q=q, k=k, v=v, kw=kw: sdpa(
                    q, k, v, is_causal=kw["causal"], scale=kw["scale"],
                    enable_gqa=True))
            else:
                lib = _flex_attention(q, k, v, **kw)
            cases.append(OpCase(
                "flash_attention", f"{label}, {str(dtype)[6:]}",
                run=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                    q, k, v, **kw),
                plain=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                    q, k, v, **kw, force="ref"),
                prep=lambda q=q, k=k, v=v, kw=kw: fa.prepare(q, k, v, **kw),
                launch=fa.launch, compare=_close(*tol),
                nbytes=2 * _tensor_bytes(q) + _tensor_bytes(k, v),
                ops=4 * d * h * pairs, peak=peak, library=lib, reps=5,
                plain_reps=3, extra=dict(B=1, H=h, KH=kh, S=s, T=s, D=d,
                                         live_pairs_per_head=pairs)))

    for label, h_, kh_, s_, t_, d_, causal, window, softcap in FLASH_EDGES:
        gq = torch.Generator(device=device).manual_seed(s_ + t_ + d_)
        q = torch.randn((1, h_, s_, d_), generator=gq, device=device
                        ).to(torch.bfloat16)
        k = torch.randn((1, kh_, t_, d_), generator=gq, device=device
                        ).to(torch.bfloat16)
        v = torch.randn((1, kh_, t_, d_), generator=gq, device=device
                        ).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=d_ ** -0.5)
        pairs = _live_pairs(s_, t_, causal, window)
        lib = None
        if softcap is None and window is None and (s_ == t_ or not causal):
            lib = (lambda q=q, k=k, v=v, kw=kw: sdpa(
                q, k, v, is_causal=kw["causal"], scale=kw["scale"],
                enable_gqa=True))
        cases.append(OpCase(
            "flash_attention", f"{label}, bfloat16",
            run=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                q, k, v, **kw),
            plain=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                q, k, v, **kw, force="ref"),
            prep=lambda q=q, k=k, v=v, kw=kw: fa.prepare(q, k, v, **kw),
            launch=fa.launch, compare=_close(*BF16_TOL),
            nbytes=2 * _tensor_bytes(q) + _tensor_bytes(k, v),
            ops=4 * d_ * h_ * pairs, peak=BF16_OPS_PER_S, library=lib,
            reps=20, plain_reps=3, extra=dict(B=1, H=h_, KH=kh_, S=s_, T=t_,
                                              D=d_,
                                              live_pairs_per_head=pairs)))

    # decode_attention: gemma2-9b at B = 8, global cache and local ring.
    b = DECODE_B
    n_sm = da._sm_count(device.index or 0)
    for dtype, tol, peak in ((torch.bfloat16, BF16_TOL, BF16_OPS_PER_S),
                             (torch.float32, (2e-5, 2e-5), FP32_OPS_PER_S)):
        for label, t, window, pos in DECODE_CACHES:
            gk = torch.Generator(device=device).manual_seed(t)
            q = torch.randn((b, h, d), generator=gk, device=device).to(dtype)
            k = torch.randn((b, kh, t, d), generator=gk, device=device
                            ).to(dtype)
            v = torch.randn((b, kh, t, d), generator=gk, device=device
                            ).to(dtype)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
            live_mask = _live_mask(t, pos, window)
            live = int(live_mask.sum())
            kw = dict(scale=GEMMA2["scale"], window=window)
            # SDPA over the live slots (a masked slot gets weight 0, as the
            # kernel's -0.7·f32max does); no mask when every slot is live.
            mask = (None if live == t else
                    torch.from_numpy(live_mask).to(device)[None, None, None])
            lib = (lambda q=q, k=k, v=v, m=mask: sdpa(
                q[:, :, None], k, v, attn_mask=m, scale=GEMMA2["scale"],
                enable_gqa=True)[:, :, 0])
            # q and o, and the K/V rows of the live slots only; with no
            # live slot the answer is the mean of V, which SDPA does not
            # compute.
            nbytes = 2 * _tensor_bytes(q) + _tensor_bytes(k, v) * live // t
            ops = 4 * d * h * b * live
            if live == 0:
                lib, nbytes = None, 2 * _tensor_bytes(q) + _tensor_bytes(v)
                ops = 2 * d * h * b * t
            cases.append(OpCase(
                "decode_attention", f"{label}, {str(dtype)[6:]}",
                run=lambda q=q, k=k, v=v, p=pos_t, kw=kw:
                    kernels.decode_attention(q, k, v, p, **kw),
                plain=lambda q=q, k=k, v=v, p=pos_t, kw=kw:
                    kernels.decode_attention(q, k, v, p, **kw, force="ref"),
                prep=lambda q=q, k=k, v=v, p=pos_t, kw=kw: da.prepare(
                    q, k, v, p, **kw),
                launch=da.launch, compare=_close(*tol),
                nbytes=nbytes, ops=ops, peak=peak, library=lib, reps=20,
                plain_reps=5, extra=dict(B=b, H=h, KH=kh, T=t, D=d,
                                         live_slots=live,
                                         splits=da.split_plan(
                                             b, kh, t, n_sm)[0])))
    z = ZAMBA_DECODE
    gk = torch.Generator(device=device).manual_seed(z["t"])
    q = torch.randn((z["b"], z["kh"], z["d"]), generator=gk, device=device)
    k = torch.randn((z["b"], z["t"], z["kh"], z["d"]), generator=gk,
                    device=device).transpose(1, 2)
    v = torch.randn((z["b"], z["t"], z["kh"], z["d"]), generator=gk,
                    device=device).transpose(1, 2)
    pos_t = torch.tensor(z["pos"], dtype=torch.int32, device=device)
    kw = dict(scale=z["d"] ** -0.5, window=None)
    cases.append(OpCase(
        "decode_attention",
        f"B {z['b']}, KH {z['kh']}, G 1, D {z['d']}, T {z['t']} "
        f"(zamba2-7b's decode shape), strided cache, float32",
        run=lambda: kernels.decode_attention(q, k, v, pos_t, **kw),
        plain=lambda: kernels.decode_attention(q, k, v, pos_t, **kw,
                                               force="ref"),
        prep=lambda: da.prepare(q, k, v, pos_t, **kw),
        launch=da.launch, compare=_close(2e-5, 2e-5),
        nbytes=2 * _tensor_bytes(q) + _tensor_bytes(k, v),
        ops=4 * z["d"] * z["kh"] * z["b"] * z["t"], peak=FP32_OPS_PER_S,
        library=lambda: sdpa(q[:, :, None], k, v,
                             scale=kw["scale"])[:, :, 0],
        reps=20, plain_reps=5,
        extra=dict(B=z["b"], H=z["kh"], KH=z["kh"], T=z["t"], D=z["d"],
                   live_slots=z["t"], k_strides=list(k.stride()),
                   splits=da.split_plan(z["b"], z["kh"], z["t"], n_sm)[0])))
    return cases


# xlstm-125m's mLSTM calls the scan with N = head_dim = 192 and P = 193 (v
# and the normalizer): src/repro/models/xlstm.py:94, configs/xlstm_125m.py.
XLSTM_SCAN = dict(b=4, l=1000, h=4, n=192, p=193, chunk=256)


def _xlstm_scan_case(device):
    """ssm_scan at xlstm-125m's mLSTM widths, float32, held against the
    plain version evaluated in float64 at the model path's gate."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ops import linear_scan

    x = XLSTM_SCAN
    b, l, h, n, p, chunk = (x[k] for k in ("b", "l", "h", "n", "p",
                                           "chunk"))
    g = torch.Generator(device=device).manual_seed(192)
    k = torch.randn((b, l, h, n), generator=g, device=device) * n ** -0.5
    q = torch.randn((b, l, h, n), generator=g, device=device) * n ** -0.5
    v = torch.randn((b, l, h, p), generator=g, device=device)
    ld = -torch.rand((b, l, h), generator=g, device=device) * 0.5 - 0.01
    gate = torch.rand((b, l, h), generator=g, device=device)
    args = (k, v, q, ld, gate)
    kw = dict(chunk=chunk)
    exact = linear_scan(*(t.double() for t in args), **kw, force="ref")
    nbytes, ops, peak, work = _ssm_bound(args, kw, chunk, "float32")
    return OpCase(
        "ssm_scan", f"xlstm-125m mLSTM widths: B {b}, L {l}, H {h}, N {n}, "
        f"P {p}, chunk {chunk}, float32",
        run=lambda: linear_scan(*args, **kw),
        plain=lambda: linear_scan(*args, **kw, force="ref"),
        prep=lambda: sk.prepare(*args, **kw), launch=sk.launch,
        compare=lambda got, want: _scan_check(
            got, want, exact, SSM_PLAIN_TOL["float32"])[:2],
        nbytes=nbytes, ops=ops, peak=peak, reps=20, plain_reps=5,
        extra=dict(B=b, L=l, H=h, N=n, P=p, chunk=chunk, **work))


def _live_pairs(s, t, causal, window):
    """(query, key) pairs that the mask keeps, per head."""
    import numpy as np
    qp = np.arange(s)[:, None]
    kp = np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return int(ok.sum())


def _live_mask(t, pos, window):
    """The ring slots that hold a live key at ``pos`` (floor modulo)."""
    import numpy as np
    kpos = pos - np.mod(pos - np.arange(t), t)
    ok = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        ok &= kpos > pos - window
    return ok


def _flex_attention(q, k, v, *, causal, window, softcap, scale):
    """One compiled ``flex_attention`` call of the same function: the
    softcap as its score_mod (after the scale, before the mask), the causal
    and window mask as its block mask.  The library yardstick only."""
    import torch
    from torch.nn.attention import flex_attention as fx

    def mask_mod(b, h, qi, ki):
        ok = ki >= 0
        if causal:
            ok = ok & (ki <= qi)
        if window is not None:
            ok = ok & (ki > qi - window)
        return ok

    def score_mod(sc, b, h, qi, ki):
        return softcap * torch.tanh(sc / softcap)

    block = fx.create_block_mask(mask_mod, None, None, q.shape[2],
                                 k.shape[2], device=q.device)
    flex = torch.compile(fx.flex_attention)
    return lambda: flex(q, k, v, score_mod=None if softcap is None
                        else score_mod, block_mask=block, scale=scale,
                        enable_gqa=True)


def _op_counters():
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.gh_ei.kernel import gh_ei_cuda
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_cuda
    from repro_torch.kernels.tree_predict.kernel import tree_predict_cuda
    return dict(tree_predict=tree_predict_cuda, gh_ei=gh_ei_cuda,
                flash_attention=flash_attention_cuda,
                decode_attention=decode_attention_cuda,
                ssm_scan=ssm_scan_cuda)


def phase_ops(device, tf_job, only=None):
    """Drive every case through ``repro_torch.kernels`` once with the launch
    counts at 0 (the path), then hold each output against the plain
    version and time the kernel, the plain version and the library call.
    ``only`` names the kernels whose cases run (all by default)."""
    import torch

    t0 = time.perf_counter()
    cases = ops_cases(device, tf_job, only)
    torch.cuda.synchronize()
    counters = {k: fn for k, fn in _op_counters().items()
                if only is None or k in only}
    for fn in counters.values():
        fn.launches = 0
    outs = [case.run() for case in cases]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _line("ops", drive="repro_torch.kernels", cases=len(cases),
          launches=json.dumps(launches, separators=(",", ":")))
    missing = [n for n, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the ops path: "
                             f"{missing}")

    rows, failures = [], []
    for i, case in enumerate(cases):
        got, outs[i] = outs[i], None
        want = case.plain()
        torch.cuda.synchronize()
        err, bad = case.compare(got, want)
        if case.kernel == "gh_ei":
            case.extra["ok"] = int(got[1].sum())
        del got, want
        preps = [case.prep()] + [case.prep(i)
                                 for i in range(1, case.copies)]
        args = preps[0][0]
        if case.plan is not None:
            case.extra.update(case.plan())
        ms, case.extra["launch_ms"] = _timed(
            case.launch, [p[0] for p in preps], device, case.reps)
        case.extra["copies"] = case.copies
        if case.kernel == "ssm_scan":
            case.extra["kernel_ms"] = _ssm_kernel_ms(args)
        del preps, args
        plain_ms = _median_ms(case.plain, reps=case.plain_reps,
                              warmup=1)
        lib_ms = lib_err = None
        if case.library is not None:
            # Its max abs error against the plain version, reported only:
            # SDPA and flex_attention round their bf16 probabilities.
            lib_err = case.compare(case.library(), case.plain())[0]
            lib_ms = _launch_ms(case.library, n=case.reps,
                                warmup=min(3, case.reps))
        torch.cuda.synchronize()
        byte_ms = case.nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = case.ops / case.peak * 1e3
        row = dict(kernel=case.kernel, case=case.name, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   library_err=lib_err,
                   bound_ms=max(byte_ms, op_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   bytes=case.nbytes, ops=case.ops,
                   launches=launches[case.kernel], **case.extra)
        rows.append(row)
        row_line = dict(row, vs_library=None if lib_ms is None
                        else round(ms / lib_ms, 4))
        _line("ops", **{k: _fmt(k, v) for k, v in row_line.items()},
              within_tol=not bad)
        for b_ in bad:
            print(f"[ops]   {case.kernel} {case.name}: {b_}", flush=True)
            failures.append(f"{case.kernel} {case.name}: {b_}")
        torch.cuda.empty_cache()
    _line("ops", phase_s=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError(f"{len(failures)} op outputs differ from the "
                             f"plain version: {failures[:3]}")
    return rows, launches


# --------------------------------------------------------------------------- #
# Phase 5: the main path at full size
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
# Phase 6: the JAX package's golden outcomes
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


# --------------------------------------------------------------------------- #
# Phase 7: the batched harness (run_many_batched, run_queue_batched)
# --------------------------------------------------------------------------- #
# (d)'s tf-cnn runs: timeout off (~30 steps a run), 3 runs on 2 slots, so
# that a slot refills.
BATCHED_TF_RUNS, BATCHED_TF_SLOTS = 3, 2


def _mixed_queues():
    """The three-job and the three-geometry queues of
    ``tests/test_batched_harness.py``."""
    from repro_torch.core import RunRequest
    from repro_torch.jobs.synthetic import synthetic_job
    jobs = [synthetic_job(i, name=f"syn{i}") for i in range(3)]
    geo = [synthetic_job(0, n_a=6, n_b=4, name="g24"),
           synthetic_job(1, n_a=5, n_b=3, name="g15"),
           synthetic_job(2, n_a=4, n_b=8, name="g32")]
    return {
        "three_jobs": [RunRequest(jobs[r % 3], seed=100 + r,
                                  budget_b=5.0 if r % 3 == 0 else 1.5)
                       for r in range(8)],
        "three_geometries": [RunRequest(geo[r % 3], seed=700 + r,
                                        budget_b=4.0 if r % 3 == 0 else 1.5)
                             for r in range(7)]}


class _StepCounter:
    """Counts the harness's steps (``optimizer._segment_body`` calls) and
    the host syncs inside them (``torch.cuda.set_sync_debug_mode``
    warnings): each step's one intended host read, its loop condition,
    lies outside the body."""

    def __init__(self):
        from repro_torch.core import optimizer
        self.optimizer, self.real = optimizer, optimizer._segment_body
        self.steps = self.syncs = 0

    def __enter__(self):
        import torch
        import warnings

        def body(*a, **k):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = self.real(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            self.steps += 1
            self.syncs += sum("synchroniz" in str(w.message) for w in caught)
            return out
        self.optimizer._segment_body = body
        return self

    def __exit__(self, *exc):
        self.optimizer._segment_body = self.real


def _batched_golden(device):
    """(a) The golden synthetic runs through both schedulers."""
    from repro_torch.core import Settings, run_many_batched
    from repro_torch.jobs.synthetic import synthetic_job
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs.forensics import outcome_to_dict

    golden = json.loads(GOLDEN.read_text())
    job = synthetic_job(golden["job_seed"])
    for case in golden["cases"]:
        want = json.dumps(case["outcomes"], sort_keys=True)
        for scheduler, slots in (("compact", 2), ("lockstep", 3)):
            select_step_cuda.launches = 0
            outs = run_many_batched(
                job, Settings(**case["settings"]), n_runs=golden["n_runs"],
                budget_b=golden["budget_b"], lane_chunk=slots,
                scheduler=scheduler, device=device)
            got = json.dumps([outcome_to_dict(o) for o in outs],
                             sort_keys=True)
            if got != want or select_step_cuda.launches == 0:
                raise AssertionError(
                    f"batched golden {case['settings']} {scheduler}: "
                    f"{select_step_cuda.launches} launches, outcomes "
                    f"{'equal' if got == want else 'differ'}")
            _line("batched", part="golden", scheduler=scheduler, slots=slots,
                  settings=json.dumps(case["settings"],
                                      separators=(",", ":")),
                  runs=len(outs), launches=select_step_cuda.launches,
                  equal=True)


def _batched_queues(device):
    """(b) The mixed queues against ``run_queue``, on 2 slots: the
    reference's frozen-refit queues (plain path) with the timeout off and
    on, and the same queues with the exact refit (the kernel, one group a
    job)."""
    from repro_torch.core import (Settings, episode_cache_size, run_queue,
                                  run_queue_batched)
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs.forensics import diff_outcomes

    for name, reqs in _mixed_queues().items():
        for refit, timeout in (("frozen", False), ("frozen", True),
                               ("exact", False)):
            s = Settings(policy="lynceus", la=1, k_gh=2, refit=refit,
                         timeout=timeout)
            seq = run_queue(reqs, s, device=device)
            before = episode_cache_size()
            select_step_cuda.launches = 0
            with _StepCounter() as count:
                t0 = time.perf_counter()
                bat = run_queue_batched(reqs, s, lane_slots=2, device=device)
                wall = time.perf_counter() - t0
            added = episode_cache_size() - before
            if _pinned_json(bat) != _pinned_json(seq):
                raise AssertionError(f"batched queue {name} {refit} "
                                     f"timeout={timeout}: "
                                     + "; ".join(diff_outcomes(seq,
                                                               bat)[:3]))
            if added != 1 or (refit == "exact"
                              and select_step_cuda.launches == 0):
                raise AssertionError(
                    f"batched queue {name}: {added} programs added, "
                    f"{select_step_cuda.launches} launches")
            _line("batched", part="queue", queue=name, refit=refit,
                  timeout=timeout, requests=len(reqs), slots=2,
                  steps=count.steps, launches=select_step_cuda.launches,
                  syncs_in_step_bodies=count.syncs, programs_added=added,
                  wall_s=f"{wall:.2f}", pinned_equal_run_queue=True)


def _batched_tf_step(device, tf_job):
    """(c) One batched selection step at the deployment's slot count
    against the sequential selector on each seat's state."""
    import numpy as np
    import torch
    from repro_torch.core import Settings, lookahead, optimizer
    from repro_torch.kernels.select_step.kernel import select_step_cuda

    s = Settings(timeout=True)
    seats = optimizer._auto_lane_chunk(tf_job, s, 100)
    st = _seat_states(tf_job, s, seats, device)
    calls, _ = capture_batched_calls(tf_job, s, seats, device)
    m, k = tf_job.space.n_points, s.k_gh
    s_dims = [c[0][3].shape[0] for c in calls]
    del calls
    if s_dims != [seats, seats * m * k, seats * m * k * k]:
        raise AssertionError(f"tf-cnn at {seats} seats: launches at S = "
                             f"{s_dims}")
    torch.cuda.reset_peak_memory_stats()
    select_step_cuda.launches = 0
    (idx, valid, diag), step_s = _batched_select(tf_job, s, st, device)
    launches = select_step_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 3:
        raise AssertionError(f"{seats} seats: {launches} select_step "
                             "launches in one step (want 3)")
    sel = lookahead.make_selector(tf_job.space, tf_job.unit_price,
                                  tf_job.t_max, s, device=device)
    host = lambda a: a.cpu().numpy()
    bad = []
    t0 = time.perf_counter()
    for r in range(seats):
        i, v, d = sel(st["sub"][r], host(st["y"][r]), host(st["mask"][r]),
                      np.float32(st["beta"][r].item()), host(st["cens"][r]))
        if int(i) != int(idx[r]) or bool(v) != bool(valid[r]):
            bad.append(f"seat {r}: index/valid {int(i)}/{bool(v)} alone, "
                       f"{int(idx[r])}/{bool(valid[r])} batched")
        bad += [f"seat {r}: diagnostic {key} differs" for key in d
                if host(d[key]).tobytes() != host(diag[key][r]).tobytes()]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"tf-cnn batched step: {bad[:3]}")
    _line("batched", part="tf_step", job=tf_job.name, seats=seats,
          launches=launches, launch_S=s_dims, step_s=f"{step_s:.4f}",
          sequential_s=f"{seq_s:.4f}",
          peak_memory_gib=f"{peak / 2 ** 30:.2f}", equal_alone=True)
    return dict(seats=seats, step_s=step_s, sequential_s=seq_s, peak=peak)


def _batched_tf_runs(device, tf_job, n_runs=BATCHED_TF_RUNS,
                     slots=BATCHED_TF_SLOTS):
    """(d) tf-cnn runs, timeout off, through the compacting scheduler
    against ``run_many`` on the same seeds, through the kernel."""
    import statistics as st_

    import torch
    from repro_torch.core import Settings, run_many_batched
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs.forensics import diff_outcomes

    s = Settings()
    select_step_cuda.launches = 0
    with _StepCounter() as count:
        t0 = time.perf_counter()
        bat = run_many_batched(tf_job, s, n_runs=n_runs, lane_chunk=slots,
                               device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = select_step_cuda.launches
    if launches != 3 * count.steps or count.steps == 0:
        raise AssertionError(f"batched tf-cnn: {launches} launches for "
                             f"{count.steps} steps of {slots} slots (want "
                             "3 a step: one a level for every slot)")
    seq, seq_steps, seq_wall = _counting_selector_runs(tf_job, s, n_runs,
                                                       3.0, device)
    if _pinned_json(bat) != _pinned_json(seq):
        raise AssertionError("batched tf-cnn runs differ from run_many: "
                             + "; ".join(diff_outcomes(seq, bat)[:3]))
    _line("batched", part="tf_runs", job=tf_job.name, runs=n_runs,
          slots=slots, steps=count.steps, launches=launches,
          syncs_in_step_bodies=count.syncs, wall_s=f"{wall:.1f}",
          steps_per_s=f"{count.steps / wall:.3f}",
          selections_per_s=f"{count.steps * slots / wall:.3f}",
          mean_select_s=f"{st_.mean(o.select_seconds for o in bat):.4f}",
          seq_steps=seq_steps, seq_wall_s=f"{seq_wall:.1f}",
          seq_steps_per_s=f"{seq_steps / seq_wall:.3f}",
          seq_mean_select_s=f"{st_.mean(o.select_seconds for o in seq):.4f}",
          nex=[o.nex for o in bat], pinned_equal_run_many=True)
    return launches


def phase_batched(device, tf_job):
    """The batched harness on the card: (a) the golden runs through both
    schedulers, (b) the mixed queues against ``run_queue``, (c) a tf-cnn
    step at the deployment's seat count against the sequential selector,
    (d) tf-cnn runs against ``run_many``.  Phase kernel holds the batched
    step's launches against their plain version (e)."""
    t0 = time.perf_counter()
    _batched_golden(device)
    _batched_queues(device)
    step = _batched_tf_step(device, tf_job)
    launches = _batched_tf_runs(device, tf_job)
    _line("batched", phase_s=f"{time.perf_counter() - t0:.1f}")
    return step, launches


# --------------------------------------------------------------------------- #
# Phase 9: the Zamba2 serving path (ssm_scan, flash and decode attention)
# --------------------------------------------------------------------------- #
ZAMBA = dict(arch="zamba2-7b", batch=4, prompt=1000, gen=32)
# Serving runs in phase model: the first with the launch counts, then
# repeats for the spread of the rates.
SERVE_RUNS = 3
# ssm_scan against the plain version evaluated in float64 on the same
# inputs: |kernel - exact| <= SSM_RTOL·|exact| + SSM_ATOL·max|exact|, per
# output, in both input types (the kernel takes bf16 inputs exactly and
# computes in float32).  The kernel's measured error is 1.4e-7 to 1.8e-7 of
# max|exact| at layers 0 and 80 of zamba2-7b (PERF.md §6), so this
# leaves a margin of about 5 and fails a decay or gate off by a part in
# 1e5.  Against the plain float32 version, which loses digits of cum_i -
# cum_j deep in the model, tests/test_kernels.py:173's atol 1e-4 / rtol
# 5e-2 (bf16 5e-2) is reported, not held.
SSM_RTOL, SSM_ATOL = 1e-5, 1e-6
SSM_PLAIN_TOL = {"float32": (1e-4, 5e-2), "bfloat16": (5e-2, 5e-2)}


def _scan_check(got, plain, exact, plain_tol):
    """The kernel's (y, state) against ``exact``, the plain version in
    float64.  Returns (max |kernel - exact|, failures, extra fields: the
    error against the float32 plain version, the elements outside
    ``plain_tol`` of it, and each output's error and largest
    magnitude)."""
    atol, rtol = plain_tol
    err, bad = 0.0, []
    extra = dict(err_vs_plain=0.0, outside_plain_tol=0)
    for name, k_, p_, x_ in zip(("y", "state"), got, plain, exact):
        k64, p64 = k_.double(), p_.double()
        d = (k64 - x_).abs()
        e = d.nan_to_num(nan=float("inf")).max().item()
        top = x_.abs().max().item()
        err = max(err, e)
        extra[f"{name}_err"], extra[f"{name}_absmax"] = e, top
        out = ~(d <= SSM_RTOL * x_.abs() + SSM_ATOL * top)
        if out.any():
            bad.append(f"{name}: {int(out.sum())} of {d.numel()} outside "
                       f"rtol {SSM_RTOL} + atol {SSM_ATOL}·max of the plain "
                       f"version in float64 (max err {e:.3g}, max {top:.3g})")
        dp = (k64 - p64).abs()
        extra["err_vs_plain"] = max(extra["err_vs_plain"], dp.max().item())
        extra["outside_plain_tol"] += int((~(dp <= atol + rtol
                                             * p64.abs())).sum())
    return err, bad, extra


def _profile(label, fn, wall_s):
    """One call of ``fn`` under ``torch.profiler``, recording the card's
    activity only: device busy seconds (the kernels' summed time), the
    idle share against ``wall_s``, the median wall time of the same work
    unprofiled, and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    self_us = lambda e: (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0) or 0)
    # Kernels only: "Command Buffer Full" marks the host waiting on a full
    # queue.
    rows = sorted(((e.key, self_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and self_us(e) > 0
                   and e.key != "Command Buffer Full"), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    _line("model", profile=label, wall_s=f"{wall_s:.4f}",
          profiled_wall_s=f"{profiled_s:.4f}", device_busy_s=f"{busy:.4f}",
          idle_share=f"{1 - busy / wall_s:.3f}" if busy else "not measured")
    for name, us, calls in rows[:10]:
        _line("model", profile=label, kernel=json.dumps(name[:70]),
              device_ms=f"{us / 1e3:.3f}", calls=calls,
              share=f"{us / 1e6 / busy:.3f}")


def _unique_bytes(t):
    """Bytes a tensor holds once, however its strides repeat them (a head
    stride of 0 reads one row for every head)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _ssm_work(args, kw, chunk):
    """Bytes (inputs once, y and the state once) and float32 operations of
    one scan from its shapes, by two algorithms.  The recurrence, step by
    step: per row the decay, the outer product and the add over N·P, the
    gated key and q·S (5·N·P + N), the first row of each (batch, head)
    without the decay against a zero state.  The chunked form the kernel
    runs: per causal pair of a chunk the q·k dot, the weight and its share
    of the value product; per row the update, and the carry after the
    first chunk or from a given initial state."""
    k, v = args[0], args[1]
    b, l, h, n = k.shape
    p = v.shape[-1]
    nbytes = sum(_unique_bytes(t) for t in args) + 4 * b * h * p * (l + n)
    if kw.get("initial_state") is not None:
        nbytes += 4 * b * h * n * p
    zero = kw.get("initial_state") is None
    recurrence = b * h * (l * (5 * n * p + n) - zero * 2 * n * p)
    sizes = [min(chunk, l - c0) for c0 in range(0, l, chunk)]
    pairs = sum(c * (c + 1) // 2 for c in sizes)
    chunked = b * h * (pairs * (2 * n + 2 * p + 3) + l * (2 * n * p + 2 * p)
                       + (l - zero * sizes[0]) * (2 * n * p + p))
    return nbytes, recurrence, chunked


def _ssm_bound(args, kw, chunk, dtype):
    """Bytes, operations and peak of the least time over the algorithms:
    the recurrence on the CUDA cores whatever the input type; the chunked
    form on the CUDA cores, on the tensor cores at the inputs' type (bf16),
    and in split TF32 (three products for each, the float32 form the
    kernel runs).  Returns (bytes, ops, peak, fields naming them)."""
    nbytes, recurrence, chunked = _ssm_work(args, kw, chunk)
    forms = [(recurrence, FP32_OPS_PER_S, "recurrence"),
             (chunked, FP32_OPS_PER_S, "chunked"),
             (3 * chunked, TF32_OPS_PER_S, "chunked, split TF32")]
    if dtype == "bfloat16":
        forms.append((chunked, BF16_OPS_PER_S, "chunked, bf16"))
    ops, peak, algorithm = min(forms, key=lambda w: w[0] / w[1])
    return nbytes, ops, peak, dict(ops_algorithm=algorithm,
                                   ops_recurrence=recurrence,
                                   ops_chunked=chunked)


def _ssm_kernel_ms(prep, n=20):
    """Device ms of each of ssm_scan's three kernels, each launched alone
    ``n`` times on the prepared arguments between CUDA events (the state
    passing rewrites the scratch in place: these launches are for timing
    only, after the call's outputs were checked)."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    return {name: round(_launch_ms(lambda: sk.launch(prep, 1 << i), n=n), 5)
            for i, name in enumerate(sk.PHASES)}


class _HostClock:
    """Where a serving run's host time goes: the process's CPU seconds
    (all its threads) and the wall seconds of the block, the cyclic
    garbage collector's collections and their seconds, the objects it
    tracks at the start, and the machine's 1-minute load average."""

    def __enter__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        self.objects = len(gc.get_objects())
        self.load = os.getloadavg()[0]
        gc.callbacks.append(self._tick)
        self.cpu0, self.wall0 = time.process_time(), time.perf_counter()
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def __exit__(self, *exc):
        self.cpu_s = time.process_time() - self.cpu0
        self.wall_s = time.perf_counter() - self.wall0
        gc.callbacks.remove(self._tick)

    def fields(self):
        return dict(host_cpu_s=f"{self.cpu_s:.3f}",
                    host_wall_s=f"{self.wall_s:.3f}", loadavg=self.load,
                    gc_tracked_objects=self.objects, gc_collections=self.gc_n,
                    gc_s=f"{self.gc_s:.4f}")


class _Capture:
    """Stand-in for an op module's ``_kernel``: counts through the real
    wrapper and keeps the arguments of the calls ``keep`` selects."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls, self.n = {}, 0

    def __getattr__(self, attr):
        real = getattr(self.module, attr)
        if attr != self.name:
            return real

        def run(*args, **kw):
            if self.keep(self.n):
                self.calls[self.n] = (args, kw)
            self.n += 1
            return real(*args, **kw)
        return run


def _zamba_golden(device):
    """zamba2-smoke through the kernels, teacher-forced, against the JAX
    package's logits (``golden_zamba.json``)."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import RuntimeFlags, build_model

    golden = json.loads(GOLDEN_ZAMBA.read_text())
    cfg = get_smoke_config(golden["arch"])
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    params = convert.tree_from_numpy(
        convert.numpy_params(model.specs(), golden["param_seed"]), device)
    toks = torch.as_tensor(np.asarray(golden["tokens"]), device=device)
    prompt, steps = golden["prompt_len"], golden["steps"]
    logits, caches = model.prefill(params, {"tokens": toks[:, :prompt]},
                                   flags, prompt + steps)
    out = [logits[:, 0]]
    for i in range(steps):
        pos = prompt + i
        logits, caches = model.decode(params, caches, toks[:, pos:pos + 1],
                                      pos, flags)
        out.append(logits[:, 0])
    got = torch.stack(out).cpu().double()
    want = torch.tensor(golden["logits"], dtype=torch.float64)
    err = (got - want).abs().max().item()
    _line("model", golden=GOLDEN_ZAMBA.name, config=cfg.name,
          steps=steps + 1, max_abs_err=err, atol=2e-4)
    if not err <= 2e-4:
        raise AssertionError(f"zamba2-smoke on the card differs from the JAX "
                             f"package's logits by {err} (atol 2e-4)")


def phase_model(device, cfg=None, batch=ZAMBA["batch"],
                prompt=ZAMBA["prompt"], gen=ZAMBA["gen"]):
    """Serve zamba2-7b at full width and depth through
    ``repro_torch.launch.serve.generate`` with the launch counts at 0, then
    hold each kernel against its plain version on the arguments captured
    from that run, time it, and check the smoke model's golden logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sk_ops
    from repro_torch.kernels.ssm_scan.ref import linear_scan_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import RuntimeFlags, build_model

    t0 = time.perf_counter()
    cfg = cfg or get_config(ZAMBA["arch"])
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats(device)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        torch.float32, device)
    n_params = model.n_params()
    toks = make_batch(cfg, "serve", batch, prompt, seed=0, step=0)["tokens"]
    tokens = torch.as_tensor(toks, device=device)
    torch.cuda.synchronize(device)
    _line("model", arch=cfg.name, params=n_params, layers=cfg.n_layers,
          d_model=cfg.d_model, batch=batch, prompt=prompt, gen=gen,
          init_s=f"{time.perf_counter() - t0:.1f}")

    n_scan = cfg.n_layers
    n_sites = cfg.n_layers // cfg.attn_every
    caps = {"ssm_scan": _Capture(sk, "ssm_scan_cuda",
                                 lambda i: i in (0, n_scan - 1)),
            "flash_attention": _Capture(fa, "flash_attention_cuda",
                                        lambda i: i == 0),
            # The last decode call stands for decode.
            "decode_attention": _Capture(
                da, "decode_attention_cuda",
                lambda i: i == n_sites * (gen - 1) - 1)}
    mods = {"ssm_scan": sk_ops, "flash_attention": fa_ops,
            "decode_attention": da_ops}
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    for name, mod in mods.items():
        mod._kernel = caps[name]
    try:
        with _HostClock() as clock:
            out, tps, prefill_s = generate(model, params, flags,
                                           {"tokens": tokens}, prompt, gen,
                                           prompt + gen)
        torch.cuda.synchronize(device)
    finally:
        for name, mod in mods.items():
            mod._kernel = caps[name].module
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    want = {"ssm_scan": cfg.n_layers, "flash_attention": n_sites,
            "decode_attention": n_sites * (gen - 1), "select_step": 0,
            "tree_predict": 0, "gh_ei": 0}
    host = out.cpu()
    _line("model", drive="repro_torch.launch.serve.generate",
          prefill_s=f"{prefill_s:.4f}", decode_tokens_per_s=f"{tps:.1f}",
          peak_gb=f"{peak_gb:.2f}", **clock.fields(),
          launches=json.dumps(launches, separators=(",", ":")),
          sample=host[0, :10].tolist())
    if launches != want:
        raise AssertionError(f"launches on the serving path {launches}, "
                             f"expected {want}")
    if tuple(host.shape) != (batch, gen) or not (
            (host >= 0) & (host < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {tuple(host.shape)} out of "
                             f"range")
    # The same requests again, for the spread of the two rates.
    prefill_runs, tps_runs = [prefill_s], [tps]
    for run in range(1, SERVE_RUNS):
        with _HostClock() as clock:
            _, tps_r, prefill_r = generate(model, params, flags,
                                           {"tokens": tokens}, prompt, gen,
                                           prompt + gen)
        prefill_runs.append(prefill_r)
        tps_runs.append(tps_r)
        _line("model", drive="repro_torch.launch.serve.generate", run=run,
              prefill_s=f"{prefill_r:.4f}",
              decode_tokens_per_s=f"{tps_r:.1f}", **clock.fields())
    prefill_med = float(np.median(prefill_runs))
    tps_med = float(np.median(tps_runs))
    _line("model", runs=SERVE_RUNS, prefill_s_median=f"{prefill_med:.4f}",
          decode_tokens_per_s_median=f"{tps_med:.1f}",
          decode_step_s_median=f"{batch / tps_med:.4f}")

    rows, failures = [], []

    def report(name, case, err, bad, ms, plain_ms, lib_ms, nbytes, ops,
               peak=FP32_OPS_PER_S, **extra):
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / peak * 1e3
        row = dict(kernel=name, case=case, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(byte_ms, op_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   bytes=nbytes, ops=ops, launches=launches[name], **extra)
        rows.append(row)
        _line("model", **{k: _fmt(k, v) for k, v in row.items()},
              within_tol=not bad)
        failures.extend(f"{name} {case}: {b}" for b in bad)

    # ssm_scan: layer 0 and the last layer, float32, then k/q/v in bf16.
    chunk = min(cfg.ssm_chunk, prompt)
    # bf16 keeps B and C broadcast over the heads (stride 0).
    bf16 = lambda t: (t[:, :, :1].to(torch.bfloat16).expand(t.shape)
                      if t.stride(2) == 0 else t.to(torch.bfloat16))
    for i, (args, kw) in sorted(caps["ssm_scan"].calls.items()):
        for dtype in ("float32", "bfloat16"):
            a = list(args)
            if dtype == "bfloat16":
                a[:3] = [bf16(t) for t in a[:3]]
            prep, outs, keep = sk.prepare(*a, **kw)
            sk.launch(prep)
            want_out = linear_scan_ref(*a, **kw)
            exact = linear_scan_ref(*(t.double() for t in a), **kw)
            torch.cuda.synchronize(device)
            err, bad, extra = _scan_check(outs, want_out, exact,
                                          SSM_PLAIN_TOL[dtype])
            del exact
            ms = _launch_ms(lambda: sk.launch(prep), n=20)
            kernel_ms = _ssm_kernel_ms(prep)
            plain_ms = _median_ms(lambda: linear_scan_ref(*a, **kw), reps=5,
                                  warmup=1)
            nbytes, ops, peak, work = _ssm_bound(a, kw, chunk, dtype)
            b_, l_, h_, n_ = a[0].shape
            report("ssm_scan", f"layer {i}, {dtype}", err, bad, ms, plain_ms,
                   None, nbytes, ops, peak=peak, kernel_ms=kernel_ms, **work,
                   B=b_, L=l_, H=h_, N=n_, P=a[1].shape[-1], chunk=chunk,
                   k_head_stride=a[0].stride(2), **extra)
            del prep, outs, keep, want_out
    # flash_attention at site 0 of the prefill.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (args, kw) in caps["flash_attention"].calls.values():
        q, k, v = args
        prep, o, keep = fa.prepare(q, k, v, **kw)
        fa.launch(prep)
        want_o = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize(device)
        err, bad = _close(2e-5, 2e-5)(o, want_o)
        ms = _launch_ms(lambda: fa.launch(prep), n=10)
        plain_ms = _median_ms(lambda: attention_ref(q, k, v, **kw), reps=3,
                              warmup=1)
        lib_ms = _launch_ms(lambda: sdpa(q, k, v, is_causal=True,
                                         scale=kw.get("scale")), n=10)
        b_, h_, s_, d_ = q.shape
        pairs = _live_pairs(s_, k.shape[2], kw["causal"], kw["window"])
        report("flash_attention", f"{cfg.name} site 0 prefill, f32", err,
               bad, ms, plain_ms, lib_ms,
               2 * _tensor_bytes(q) + _tensor_bytes(k, v),
               4 * d_ * h_ * b_ * pairs, B=b_, H=h_, KH=k.shape[1], S=s_,
               T=k.shape[2], D=d_)
        del prep, o, keep, want_o
    # decode_attention: the last step's last site, over the ring cache
    # views the model hands it (strided [B, KH, T, D]).
    for (args, kw) in caps["decode_attention"].calls.values():
        q, k, v, pos = args
        prep, o, keep = da.prepare(q, k, v, pos, **kw)
        da.launch(prep)
        want_o = decode_attention_ref(q, k, v, pos, **kw)
        torch.cuda.synchronize(device)
        err, bad = _close(2e-5, 2e-5)(o, want_o)
        ms = _launch_ms(lambda: da.launch(prep), n=20)
        plain_ms = _median_ms(
            lambda: decode_attention_ref(q, k, v, pos, **kw), reps=5,
            warmup=1)
        t_ = k.shape[2]
        live_mask = _live_mask(t_, int(pos), kw.get("window"))
        live = int(live_mask.sum())
        mask = torch.from_numpy(live_mask).to(device)[None, None, None]
        lib_ms = _launch_ms(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask,
                                         scale=kw.get("scale"))[:, :, 0],
                            n=20)
        b_, h_, d_ = q.shape
        report("decode_attention",
               f"{cfg.name} last step, site {n_sites - 1}, pos {int(pos)}, "
               f"f32", err, bad, ms, plain_ms, lib_ms,
               2 * _tensor_bytes(q) + _tensor_bytes(k, v) * live // t_,
               4 * d_ * h_ * b_ * live, B=b_, H=h_, KH=k.shape[1], T=t_,
               D=d_, live_slots=live, k_strides=list(k.stride()))
        del prep, o, keep, want_o
    caps.clear()
    # Where the time goes: one prefill and one decode step, profiled.
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(
            params, {"tokens": tokens}, flags, prompt + gen)

    _profile("prefill", prefill, prefill_med)
    nxt = torch.argmax(state.pop("logits"), dim=-1)
    _profile("decode step", lambda: model.decode(params, state["caches"],
                                                 nxt, prompt, flags),
             batch / tps_med)
    state.clear()
    del params, out, tokens
    torch.cuda.empty_cache()
    _zamba_golden(device)
    _line("model", phase_s=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError(f"{len(failures)} kernel outputs on the "
                             f"serving path differ from the plain version: "
                             f"{failures[:3]}")
    return rows, launches, dict(prefill_s=prefill_runs,
                                decode_tokens_per_s=tps_runs,
                                peak_gb=peak_gb)


# --------------------------------------------------------------------------- #
# Phase 8: the determinism gate and its kernel, masked_argmax
# --------------------------------------------------------------------------- #
ARGMAX_WIDTHS = (16, 384, 4096, 1 << 20)
ARGMAX_KINDS = ("random", "near_tie", "exact_tie", "nan", "signed_zero",
                "inf", "all_invalid", "all_neg_inf")


def _argmax_case(kind, m, seed):
    """(score f32 [m], valid bool [m]) as numpy, made from ``seed``: the
    edge cases of ``tests/test_torch_masked_argmax.py``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    score = rng.normal(size=m).astype(np.float32)
    valid = rng.random(m) < 0.7
    i, j = sorted(int(v) for v in rng.choice(m, 2, replace=False))
    valid[[i, j]] = True
    top = np.float32(np.abs(score).max() + 1)
    if kind == "near_tie":        # one ulp apart: quantizing makes a tie
        score[i], score[j] = top, np.nextafter(top, np.float32(np.inf))
    elif kind == "exact_tie":
        score[i] = score[j] = top
    elif kind == "nan":
        score[[0, i, j]] = np.nan
        valid[0] = False
    elif kind == "signed_zero":
        score = -np.abs(score) - 1
        score[i], score[j] = np.float32(-0.0), np.float32(0.0)
    elif kind == "inf":
        score[[i, j]] = np.inf
        score[(j + 1) % m] = -np.inf
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "all_neg_inf":
        score[:] = -np.inf
    return score, valid


def _finding_keys(findings_by_name):
    return {name: sorted(f.key() for f in found)
            for name, found in findings_by_name.items()}


def argmax_checks(device):
    """masked_argmax against its plain version (both variants, every edge
    case, at every width of ``ARGMAX_WIDTHS``: the index exactly) and its
    times: from a CUDA graph (``ms``; at 1 << 20 over copies of the row
    that together move three times the L2 cache) and launched from the
    host (``launch_ms``).  Returns (rows, failures)."""
    import torch
    from repro_torch.kernels.masked_argmax import kernel
    from repro_torch.kernels.masked_argmax.kernel import masked_argmax_cuda
    from repro_torch.kernels.masked_argmax.ref import masked_argmax_ref

    rows, failures = [], []
    for m in ARGMAX_WIDTHS:
        err = 0
        for n, kind in enumerate(ARGMAX_KINDS):
            score, valid = _argmax_case(kind, m, seed=m + n)
            st = torch.as_tensor(score, device=device)
            vt = torch.as_tensor(valid, device=device)
            for quantize in (True, False):
                got = int(masked_argmax_cuda(st, vt, quantize=quantize)[0])
                want = int(masked_argmax_ref(st, vt, quantize=quantize)[0])
                cpu = int(masked_argmax_ref(torch.as_tensor(score),
                                            torch.as_tensor(valid),
                                            quantize=quantize)[0])
                err = max(err, abs(got - want))
                if not got == want == cpu:
                    failures.append(f"M={m} {kind} quantize={quantize}: "
                                    f"kernel {got}, plain {want}, plain on "
                                    f"the CPU {cpu}")
        score, valid = _argmax_case("random", m, seed=m)
        st = torch.as_tensor(score, device=device)
        vt = torch.as_tensor(valid, device=device)
        nbytes = 5 * m + 4
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        copies = _cold_copies(nbytes) if m >= SCALE_M else 1
        rows_in = [(st, vt)] + [(st.clone(), vt.clone())
                                for _ in range(copies - 1)]
        geo = kernel.plan(m, kernel._sm_count(device.index or 0))
        regs, local = kernel.attributes()
        for quantize in (True, False):
            preps = [kernel.prepare(a, b, quantize=quantize)
                     for a, b in rows_in]
            ms, launch_ms = _timed(kernel.launch, [p[0] for p in preps],
                                   device, 200)
            plain_ms = _median_ms(lambda: masked_argmax_ref(
                st, vt, quantize=quantize))
            del preps
            rows.append(dict(kernel="masked_argmax", M=m, quantize=quantize,
                             case=f"M={m} quantize={quantize}", ms=ms,
                             launch_ms=launch_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by="bytes",
                             library_ms=None, max_abs_err=float(err)))
            _line("analysis", kernel="masked_argmax", M=m,
                  quantize=quantize, ms=f"{ms:.5f}",
                  launch_ms=f"{launch_ms:.5f}",
                  plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.3e}",
                  bound_by="bytes", bytes=nbytes, copies=copies,
                  grid=geo.grid, threads=geo.threads,
                  scratch=geo.grid > 1, registers=regs, local_bytes=local)
        del rows_in
    _line("analysis", cases=len(ARGMAX_WIDTHS) * len(ARGMAX_KINDS) * 2,
          index_equal=not failures)
    for f in failures:
        print(f"[analysis]   {f}", flush=True)
    return rows, failures


def phase_analysis(device):
    """masked_argmax against its plain version and its times
    (:func:`argmax_checks`), then the gate: ``repro_torch.analysis``'s
    entry point with ``--all --device cuda`` (its launch count read around
    it), its findings held equal to the CPU's, and the command line
    itself."""
    import torch
    from repro_torch.analysis import __main__ as gate
    from repro_torch.analysis import fixtures, registry
    from repro_torch.kernels.masked_argmax.kernel import masked_argmax_cuda

    t0 = time.perf_counter()
    rows, failures = argmax_checks(device)

    # The gate, through its entry point, with the kernel's count around it.
    masked_argmax_cuda.launches = 0
    g0 = time.perf_counter()
    rc = gate.main(["--all", "--device", "cuda"])
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - g0
    launches = masked_argmax_cuda.launches
    _line("analysis", gate_rc=rc, gate_s=f"{gate_s:.1f}",
          masked_argmax_launches=launches)
    if rc != 0:
        failures.append(f"the gate failed on the card (exit {rc})")
    if launches == 0:
        failures.append("the gate launched no masked_argmax kernel")

    # The same findings on both devices, fixture by fixture and program by
    # program (the paths differ by the kernel replays, ``kernel:<op>``).
    same = {}
    specs = registry.registered_programs()
    for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
        found = fixtures.run_fixtures(dev)
        n_fixtures = len(found)
        found.update({spec.name: registry.audit_program(spec, dev)
                      for spec in specs})
        same[tag] = _finding_keys(found)
    differ = sorted(k for k in same["cpu"]
                    if same["cpu"][k] != same["card"].get(k))
    _line("analysis", programs=len(specs), fixtures=n_fixtures,
          same_findings=not differ,
          findings_on_card=sum(len(v) for v in same["card"].values()))
    if differ:
        failures.append(f"card and CPU findings differ in {differ}")

    # The command line, as a user runs it.
    c0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--device",
         "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    tail = cli.stdout.strip().splitlines()[-3:]
    _line("analysis", cli_rc=cli.returncode,
          cli_s=f"{time.perf_counter() - c0:.1f}", cli_tail=json.dumps(tail))
    if cli.returncode != 0 or "determinism gate: OK" not in cli.stdout:
        failures.append(f"python -m repro_torch.analysis --all --device cuda"
                        f" exited {cli.returncode}: {cli.stdout[-1500:]} "
                        f"{cli.stderr[-1500:]}")
    _line("analysis", phase_s=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError(f"phase analysis: {failures[:3]}")
    return rows, launches


def _all_counters():
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    return dict(_op_counters(), select_step=select_step_cuda)


# Of each op's cases, the one that stands for it in the summary line (its
# label's start and end), and the TPU kernel it replaces.
OP_SUMMARY = {
    "tree_predict": ("tf-cnn root forest", "",
                     "src/repro/kernels/tree_predict/kernel.py:88"),
    "gh_ei": ("tf-cnn root posterior, step's beta", "",
              "src/repro/kernels/gh_ei/kernel.py:70"),
    "flash_attention": ("zamba2", "",
                        "src/repro/kernels/flash_attention/kernel.py:111"),
    "decode_attention": ("zamba2", "",
                         "src/repro/kernels/decode_attention/kernel.py:88"),
    "ssm_scan": ("layer 0, float32", "",
                 "src/repro/kernels/ssm_scan/kernel.py:83"),
    # The fixture's width, quantized: the launch the gate makes.
    "masked_argmax": ("M=16 quantize=True", "",
                      "src/repro/analysis/fixtures.py:101"),
}


def _op_summary(rows, launches):
    out = []
    for name, (start, end, replaces) in OP_SUMMARY.items():
        mine = [r for r in rows if r["kernel"] == name]
        row = next(r for r in mine if r["case"].startswith(start)
                   and r["case"].endswith(end))
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "case": row["case"],
            "cases": [{k: r[k] for k in ("case", "max_abs_err", "ms",
                                         "launch_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "kernel_ms")
                       if k in r} for r in mine]})
    return out


# Kernels whose register budget is part of their design: -Xptxas -v must
# show no spill for any of their instantiations.
NO_SPILL = ("select_step_kernel", "flash_bf16_kernel",
            "decode_split_kernel", "decode_combine_kernel",
            "ssm_chunk_state_kernel", "ssm_state_pass_kernel",
            "ssm_chunk_scan_kernel", "masked_argmax_kernel",
            "tree_predict_kernel")


def _spills(logs):
    """Spilled bytes (stores plus loads) of every function in the
    ``-Xptxas -v`` output of ``logs``, by mangled name."""
    out, fn = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
                continue
            m = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and fn is not None:
                out[fn] = int(m.group(1)) + int(m.group(2))
                fn = None
    return out


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", default=None,
        help="comma-separated kernels of phase ops (tree_predict, gh_ei, "
             "flash_attention, decode_attention, ssm_scan), masked_argmax "
             "and the phase batched: build, run only their checks and "
             "times, and print no result line (a measurement run, not the "
             "smoke)")
    args = parser.parse_args(argv)
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
    _line("build", sources=",".join(logs),
          seconds=f"{time.perf_counter() - t0:.1f}")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}", flush=True)
    spilled = [f"{fn}: {n} bytes" for fn, n in _spills(logs).items()
               if n and any(k in fn for k in NO_SPILL)]
    _line("build", no_spill_kernels=",".join(NO_SPILL),
          spilled=json.dumps(spilled))
    if spilled:
        raise AssertionError(f"kernels that must not spill do: {spilled}")

    tf_job = tensorflow_jobs(0)[0]
    if args.only is not None:
        only = tuple(args.only.split(","))
        ops_only = tuple(k for k in only
                         if k not in ("masked_argmax", "batched"))
        if "batched" in only:
            phase_kernel(device, tf_job, only_batched=True)
            phase_batched(device, tf_job)
        if ops_only:
            phase_ops(device, tf_job, only=ops_only)
        if "masked_argmax" in only:
            _, failures = argmax_checks(device)
            if failures:
                raise AssertionError(f"masked_argmax: {failures[:3]}")
        return 0
    rows, max_err = phase_kernel(device, tf_job)
    op_rows, op_launches = phase_ops(device, tf_job)
    launches = phase_main(device, tf_job)
    phase_golden(device)
    phase_batched(device, tf_job)
    analysis_rows, argmax_launches = phase_analysis(device)
    model_rows, model_launches, _serving = phase_model(device)
    # Each kernel's launches come from the path that runs it: tree_predict
    # and gh_ei from the ops drive, the model kernels from the serving run.
    op_launches.update({k: model_launches[k] for k in
                        ("flash_attention", "decode_attention", "ssm_scan")})
    op_launches["masked_argmax"] = argmax_launches
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
    }] + _op_summary(op_rows + model_rows + analysis_rows, op_launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
