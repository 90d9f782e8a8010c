#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only tree_predict,gh_ei,masked_argmax
    python3 chip_smoke.py --only batched
    python3 chip_smoke.py --only service
    python3 chip_smoke.py --only extensions
    python3 chip_smoke.py --only zoo
    python3 chip_smoke.py --only train
    python3 chip_smoke.py --only flash_bwd
    python3 chip_smoke.py --only remat

With ``--only`` it builds, runs the named kernels' checks and times of
phases ops and analysis (or, for ``batched``, the batched step's launches
of phase kernel and phase batched; for ``service``, phase batched's
tf-cnn runs (d) and then phase service; for ``extensions``, phase
extensions; for ``zoo``, the zoo's serving runs and golden logits of
phase model; for ``train``, phase train; for ``flash_bwd``, phase
train's (a) alone; for ``remat``, phase train's (b) with (k), then the
dry run's cells), and prints no result line (a measurement run).
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
   the tensor-core kernel (S and T off the tiles, D 112 and 100, MQA) and
   float32 ones at the rest of the zoo's widths (D 192 with 128 heads,
   DeepSeek-V3's MLA; D 80 non-causal, HuBERT's; D 192 windowed) and at
   gemma-2b's training shape (MQA, D 256), each float32 case with the
   split-TF32 kernel's plan (``kernel.fwd_plan``) and its split-TF32
   bound beside the float32 one,
   decode_attention on gemma2-9b caches at B = 8 (global T = 8192 and
   local ring T = 4096, each full and filling, and the global one full
   with Gemma2's softcap; splits whose slots are all dead, every slot dead, a
   ragged last tile) and at zamba2-7b's shape, and ssm_scan at
   xlstm-125m's mLSTM widths (N = 384, P = 385) and at N = 192, P = 193
   (float32, held against the plain version in float64 as in phase
   model); scale
   cases, not path shapes, of tree_predict and gh_ei at M = 1 << 20
   (tf-cnn's F = 5, B = 10, D = 4; K = 3), timed over copies of their
   inputs that move three times the L2 cache.  Each case is driven
   through the op once with the launch counts at 0, then held against
   the plain version within its tolerance and timed (from a CUDA graph,
   ``ms``, with the host-launched ``launch_ms`` beside it; tree_predict
   with its launch plan: grid, threads, tile, shared bytes, registers)
   beside its plain version, its bound and, where one PyTorch call
   computes the same function, that call (``library_ms``: SDPA; for the
   softcapped and windowed prefills and the softcapped decodes a
   compiled ``flex_attention`` with static shapes, with its max abs
   error against the plain version, only under ``--only flex``, here and
   in the zoo and phase train; and ``vs_library``,
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
   slots (a refill) at budget b = 1.25, against ``run_many``, with 3
   launches a step and the host syncs inside the step bodies counted;
   steps/s and mean ``select_seconds`` of both;
8. service: the streaming service (``repro_torch.service.StreamingTuner``
   on the card): (a) the golden runs of phase 6 streamed in three bursts
   with a pump between them (2 seats, a queue of 2, 4 steps a segment,
   traced), on 1 shard, on 2 shards (both on the one card) and with one
   run preempted and resumed (``high_water=0``), each against the golden
   outcomes with its trace validated (``validate_trace``,
   ``validate_lifecycle``) and select_step launched; (b) the tf-cnn runs
   of phase 7 (d) streamed on 2 seats, 8 steps a segment, traced (runs 0
   and 1, a pump, then run 2, then a drain), byte-equal to phase 7's
   ``run_many`` outcomes with 3 launches a step, with segments, steps/s,
   selections/s, each span's summed seconds, host reads per segment,
   syncs inside the step bodies, lane occupancy, latency p50/p99 and peak
   memory.  Every ticket must resolve with an Outcome;
9. analysis: the determinism gate's kernel, masked_argmax, against its
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
10. model: zamba2-7b served at full width and depth (81 layers, d_model
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
   Then zamba2-smoke through the kernels, teacher-forced, against the
   JAX package's logits (``golden_zamba.json``, atol 2e-4).  Then the
   zoo, each arch served the same way with its weights drawn on the card:
   xlstm-125m (B = 4, prompt 1000, gen 32; ssm_scan 10 a prefill and none
   a decode step; mLSTM block 0's scan held in float32 and bf16; the two
   sLSTM blocks' share of a prefill) and gemma2-9b (B = 2, prompt 4608,
   past its 4096 window, gen 32; flash_attention 42 a prefill,
   decode_attention 42 x 31; layers 0 (local) and 1 (global) held in the
   prefill and in the last decode step, softcapped), then the rest of the
   zoo at full width: mixtral-8x22b at 4 of its 56 layers (B = 2, prompt
   4608 past its 4096 window on every layer, so the 4096-slot ring
   wraps, gen 32; flash_attention 4 a prefill, decode_attention 4 x 31),
   deepseek-v3-671b at its 3 dense layers and 1 MoE layer (B = 2, prompt
   2048, gen 32; MLA: flash_attention 4 at D 192 a prefill, latent
   einsums in decode), qwen2-vl-2b (B = 4, prompt 1280 with 256 vision
   tokens, gen 32; M-RoPE; flash_attention 28, decode_attention 28 x 31)
   and hubert-xlarge's encoder prefill (B = 4 x 1000 frames, D 80,
   non-causal; flash_attention 48), each arch's first layer held in the
   prefill and in the last decode step after its weights are freed, each
   profiled; last, the nine smoke configs of ``golden_zoo.json`` against
   the JAX package's logits (atol 2e-4);
11. extensions (run after phase 6): (a) every case of
   ``golden_extensions.json`` on the card,
   equal to the JAX package's outputs on the CPU: ``cartesian_gh``,
   ``default_setup_cost``, ``optimize_multi_constraint`` and
   ``optimize_with_setup_costs`` on the inputs of
   ``tests/test_core_extensions.py`` and at tf-cnn size, ``optimize_live``
   on those of ``tests/test_autotune_and_launch.py``, and the mock
   launch-config tuner (``launch.autotune.tune``, mixtral-8x22b, budget
   1000, la 2), each with its probes, wall seconds and selections; (b)
   that tuner call with the exact refit, which selects through
   ``select_step`` (the tuner's frozen refit has no fused kernel, in the
   reference or the port), 3 launches a selection counted around it,
   against the same call through the plain path (``fused_selector="ref"``),
   with steps, steps/s and mean seconds a selection of both;

12. train (last): (a) the flash-attention backward kernel
   (``csrc/flash_attention_bwd.cu``) at gemma-2b's training shape (B 1,
   H 8, KH 1, S 2048, D 256, causal), gemma2-9b's (window 4096, softcap
   50, S 4608), HuBERT's D 80 non-causal, the MLA's D 192 with H 128, a
   GQA group of 6 and an edge case off the tiles with rows no key
   reaches, each driven once through the op (one forward and one backward
   launch), held against the plain backward evaluated in float64 on the
   same inputs (``BWD_TOL``) and against itself (two runs bitwise equal),
   with its plan (``kernel.bwd_plan``: the query group's split and the
   workspace bytes), timed from a CUDA graph with each of its kernels'
   times (Δ, dK/dV, the split's sum, dQ), beside the float32 plain
   backward, the library's backward (SDPA's, or with ``--only flex`` a
   compiled ``flex_attention``'s for the window and softcap) and the
   bound (five products in float32 on the CUDA cores; beside it, split
   TF32, three products each, on the tensor cores); (b)
   gemma-2b at full width and depth (18 layers, 2.51 B float32
   parameters drawn on the card) trained through
   ``train.step.make_train_step`` (B 2, S 2048, 2 microbatches, AdamW,
   the step donated): step 0's loss and gradient norm against the same
   step with the plain attention (``force="ref"``), then 4 steps with
   finite losses and 36 forward and 36 backward flash launches a step,
   step seconds, tokens/s, peak memory, and a fifth step profiled (idle
   share); (c) a kill-and-restart cycle through
   ``runtime.fault_tolerance.run_training`` on gemma-2b-smoke whose final
   state equals an unbroken run's bitwise; (d) gemma-2b-smoke's 3 steps
   against the JAX package's trajectory (``golden_train.json``); (e)
   ``ssm_scan`` and ``decode_attention`` refusing CUDA tensors that
   require grad; (f)-(i) the hybrid and ssm families
   (:func:`phase_train_ssm`); (j) gemma-2b's steps through the sharded
   step on a (1, 1) mesh of an NCCL world of one, bitwise (b)'s, and
   ``compressed_psum`` over NCCL (:func:`_train_mesh`); (k) within (b),
   before its steps, step 0's ``loss_and_grads`` from the same state and
   batch under ``remat`` none, full and dots: the loss and every gradient
   bitwise equal, the flash launches (36 + 36; 72 + 36 under full and
   dots), each call's peak memory (lower under full) and seconds, and
   the memory a forward of microbatch 0 holds for its backward (less
   under dots than none, and less under full than dots)
   (:func:`_train_remat`); after the phase's timed parts, in two
   processes at once, ``python -m repro_torch.launch.dryrun`` on two
   cells (gemma-2b
   train_4k and decode_32k on the (16, 16) mesh of a fake world, meta
   tensors, no card), their counts and roofline or their error on
   ``[dryrun]`` lines that the smoke does not depend on (the fake process
   group is a private module of torch, and DTensor's strategies differ
   between its versions);

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
GOLDEN_ZOO = ROOT / "src" / "repro_torch" / "testdata" / "golden_zoo.json"
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
# (label, T, window, pos, softcap): the global layers' cache and the local
# layers' ring, full (the ring has rolled over at pos 8191) and filling (the
# slots past pos are empty: pos - slot < 0, where floor modulo matters).
DECODE_CACHES = (
    ("global cache T 8192, pos 8191", 8192, None, 8191, None),
    ("local ring T 4096, window 4096, pos 8191 (rollover)", 4096, 4096, 8191,
     None),
    ("global cache T 8192, pos 5000 (filling)", 8192, None, 5000, None),
    ("local ring T 4096, window 4096, pos 3000 (filling)", 4096, 4096, 3000,
     None),
    # Edge cases of the split over T: splits whose slots are all dead, and
    # a ragged last tile.
    ("global cache T 8192, pos 10 (all-dead splits)", 8192, None, 10, None),
    ("cache T 1000 (ragged last tile), pos 1500 (rollover)", 1000, None,
     1500, None),
    ("global cache T 8192, pos -1 (every slot dead)", 8192, None, -1, None),
    # gemma2-9b decodes with its attention softcap (50): the global cache,
    # full (phase model holds the local ring, softcapped, at gemma2-9b's
    # serving shape).
    ("global cache T 8192, pos 8191, softcap 50", 8192, None, 8191, 50.0))
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
# flash_attention in float32 at the widths the rest of the zoo gives the
# split-TF32 kernel: DeepSeek-V3's MLA prefill (q/k 128 + 64 = 192 wide, v
# zero-padded from 128 to 192, 128 heads; src/repro/models/mla.py:70-73),
# the DP = 192 instantiation, and HuBERT's (D 80, non-causal), which runs
# DP = 128 with the 8-column blocks past D skipped; a ragged, windowed D
# 192 case; gemma-2b's training shape (the forward of each of its 18
# layers, twice a step in 2 microbatches).
FLASH_F32_EDGES = (
    ("deepseek-v3 MLA: D 192 (v zero-padded from 128), H = KH = 128, "
     "S = T = 2048, causal", 128, 128, 2048, 2048, 192, True, None, None),
    ("hubert-xlarge: D 80, H = KH = 16, S = T = 1000, non-causal", 16, 16,
     1000, 1000, 80, False, None, None),
    ("D 192, GQA 4, S = T = 777, causal, window 300", 8, 2, 777, 777, 192,
     True, 300, None),
    ("gemma-2b training: H 8, KH 1 (MQA), S = T = 2048, D 256, causal", 8,
     1, 2048, 2048, 256, True, None, None))
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
        cases += [_xlstm_scan_case(device),
                  _xlstm_scan_case(device, SCAN_N192)]
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
    """flash_attention on a gemma2-9b prefill, edge cases of the
    tensor-core kernel and the float32 kernel at the MLA's and HuBERT's
    head dims; decode_attention on gemma2-9b caches and at zamba2-7b's
    decode shape."""
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
            ops, nbytes = fa.cost(q, k, v, causal=kw["causal"],
                                  window=kw["window"])
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
                nbytes=nbytes, ops=ops, peak=peak, library=lib, reps=5,
                plain_reps=3, extra=dict(
                    B=1, H=h, KH=kh, S=s, T=s, D=d,
                    live_pairs_per_head=fa.live_pairs(s, s, kw["causal"],
                                                      kw["window"]),
                    **_f32_flash_extra(dtype, 1, h, kh, s, s, d, kw,
                                       ops, nbytes))))

    edges = [(e, torch.bfloat16, BF16_TOL, BF16_OPS_PER_S)
             for e in FLASH_EDGES]
    edges += [(e, torch.float32, (2e-5, 2e-5), FP32_OPS_PER_S)
              for e in FLASH_F32_EDGES]
    for edge, dtype, tol, peak in edges:
        label, h_, kh_, s_, t_, d_, causal, window, softcap = edge
        gq = torch.Generator(device=device).manual_seed(s_ + t_ + d_)
        q = torch.randn((1, h_, s_, d_), generator=gq, device=device
                        ).to(dtype)
        k = torch.randn((1, kh_, t_, d_), generator=gq, device=device
                        ).to(dtype)
        v = torch.randn((1, kh_, t_, d_), generator=gq, device=device
                        ).to(dtype)
        if "zero-padded" in label:
            v[..., 128:] = 0
        kw = dict(causal=causal, window=window, softcap=softcap,
                  scale=d_ ** -0.5)
        ops, nbytes = fa.cost(q, k, v, causal=causal, window=window)
        lib = None
        if softcap is None and window is None and (s_ == t_ or not causal):
            lib = (lambda q=q, k=k, v=v, kw=kw: sdpa(
                q, k, v, is_causal=kw["causal"], scale=kw["scale"],
                enable_gqa=True))
        cases.append(OpCase(
            "flash_attention", f"{label}, {str(dtype)[6:]}",
            run=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                q, k, v, **kw),
            plain=lambda q=q, k=k, v=v, kw=kw: kernels.flash_attention(
                q, k, v, **kw, force="ref"),
            prep=lambda q=q, k=k, v=v, kw=kw: fa.prepare(q, k, v, **kw),
            launch=fa.launch, compare=_close(*tol),
            nbytes=nbytes, ops=ops, peak=peak, library=lib,
            reps=20, plain_reps=3, extra=dict(
                B=1, H=h_, KH=kh_, S=s_, T=t_, D=d_,
                live_pairs_per_head=fa.live_pairs(s_, t_, causal, window),
                **_f32_flash_extra(dtype, 1, h_, kh_, s_, t_, d_, kw,
                                   ops, nbytes))))

    # decode_attention: gemma2-9b at B = 8, global cache and local ring.
    b = DECODE_B
    n_sm = da._sm_count(device.index or 0)
    for dtype, tol, peak in ((torch.bfloat16, BF16_TOL, BF16_OPS_PER_S),
                             (torch.float32, (2e-5, 2e-5), FP32_OPS_PER_S)):
        for label, t, window, pos, softcap in DECODE_CACHES:
            gk = torch.Generator(device=device).manual_seed(t)
            q = torch.randn((b, h, d), generator=gk, device=device).to(dtype)
            k = torch.randn((b, kh, t, d), generator=gk, device=device
                            ).to(dtype)
            v = torch.randn((b, kh, t, d), generator=gk, device=device
                            ).to(dtype)
            pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
            live_mask = _live_mask(t, pos, window)
            live = int(live_mask.sum())
            kw = dict(scale=GEMMA2["scale"], window=window, softcap=softcap)
            # SDPA over the live slots (a masked slot gets weight 0, as the
            # kernel's -0.7·f32max does; no mask when every slot is live),
            # or flex_attention where there is a softcap.
            mask = (None if live == t else
                    torch.from_numpy(live_mask).to(device)[None, None, None])
            lib = (_flex_decode(q, k, v, pos, **kw) if softcap is not None
                   else (lambda q=q, k=k, v=v, m=mask: sdpa(
                       q[:, :, None], k, v, attn_mask=m,
                       scale=GEMMA2["scale"], enable_gqa=True)[:, :, 0]))
            # q and o, and the K/V rows of the live slots only; with no
            # live slot the answer is the mean of V, which SDPA does not
            # compute.
            ops, nbytes = da.cost(q, k, v, pos, window=window)
            if live == 0:
                lib = None
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
    z_ops, z_bytes = da.cost(q, k, v, z["pos"])
    cases.append(OpCase(
        "decode_attention",
        f"B {z['b']}, KH {z['kh']}, G 1, D {z['d']}, T {z['t']} "
        f"(zamba2-7b's decode shape), strided cache, float32",
        run=lambda: kernels.decode_attention(q, k, v, pos_t, **kw),
        plain=lambda: kernels.decode_attention(q, k, v, pos_t, **kw,
                                               force="ref"),
        prep=lambda: da.prepare(q, k, v, pos_t, **kw),
        launch=da.launch, compare=_close(2e-5, 2e-5),
        nbytes=z_bytes, ops=z_ops, peak=FP32_OPS_PER_S,
        library=lambda: sdpa(q[:, :, None], k, v,
                             scale=kw["scale"])[:, :, 0],
        reps=20, plain_reps=5,
        extra=dict(B=z["b"], H=z["kh"], KH=z["kh"], T=z["t"], D=z["d"],
                   live_slots=z["t"], k_strides=list(k.stride()),
                   splits=da.split_plan(z["b"], z["kh"], z["t"], n_sm)[0])))
    return cases


# xlstm-125m's mLSTM calls the scan with N = hd = 2·d_model / n_heads =
# 384 and P = hd + 1 = 385 (v and the normalizer):
# src/repro/models/xlstm.py:34-37 and :94, configs/xlstm_125m.py.  N = 192,
# P = 193, timed in earlier runs, stays beside it so that its time stays
# comparable.
XLSTM_SCAN = dict(b=4, l=1000, h=4, n=384, p=385, chunk=256)
SCAN_N192 = dict(XLSTM_SCAN, n=192, p=193)


def _xlstm_scan_case(device, x=XLSTM_SCAN):
    """ssm_scan at xlstm-125m's mLSTM widths (or ``x``'s), float32, held
    against the plain version evaluated in float64 at the model path's
    gate."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ops import linear_scan

    b, l, h, n, p, chunk = (x[k] for k in ("b", "l", "h", "n", "p",
                                           "chunk"))
    g = torch.Generator(device=device).manual_seed(n)
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
        "ssm_scan", (f"xlstm-125m mLSTM widths: " if x is XLSTM_SCAN
                     else "") + f"B {b}, L {l}, H {h}, N {n}, P {p}, "
        f"chunk {chunk}, float32",
        run=lambda: linear_scan(*args, **kw),
        plain=lambda: linear_scan(*args, **kw, force="ref"),
        prep=lambda: sk.prepare(*args, **kw), launch=sk.launch,
        compare=lambda got, want: _scan_check(
            got, want, exact, SSM_PLAIN_TOL["float32"])[:2],
        nbytes=nbytes, ops=ops, peak=peak, reps=20, plain_reps=5,
        extra=dict(B=b, L=l, H=h, N=n, P=p, chunk=chunk, **work))


def _f32_flash_extra(dtype, b, h, kh, s, t, d, kw, ops, nbytes):
    """A float32 flash case's split-TF32 plan (``kernel.fwd_plan``) and its
    bound in split TF32 (three TF32 products for each float32 one, at
    495 TFLOP/s, or the bytes; ``ops`` and ``nbytes`` from
    ``kernel.cost``); nothing for bf16."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    if dtype != torch.float32:
        return {}
    plan = fa.fwd_plan(b, h, kh, s, t, d, kw["causal"], kw["window"])
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_split_tf32_ms=max(3 * ops / TF32_OPS_PER_S * 1e3,
                                        byte_ms),
                plan=plan._asdict())


def _live_mask(t, pos, window):
    """The ring slots that hold a live key at ``pos`` (floor modulo)."""
    import numpy as np
    kpos = pos - np.mod(pos - np.arange(t), t)
    ok = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        ok &= kpos > pos - window
    return ok


# The library yardstick's flex_attention, compiled once with static shapes,
# only in a run that asks for it (``--only flex``, with the phases it
# names): its compiles took ~10-16 s each, in phase ops (four), the zoo
# (gemma2-9b's and mixtral-8x22b's windows and softcaps) and phase train's
# backward cases, and its times are recorded (PERF.md, rows 4 and B9).
# Elsewhere a softcapped or windowed case has no library time; SDPA's
# stay.
# With dynamo's default automatic dynamic shapes, a call at a new size
# (gemma2-9b serving's B 2, S 4608 after phase ops' B 1, S 8192) compiled a
# graph over symbolic sizes that ran 5x slower on an H100 (466.9 against
# 94.9 ms at gemma2-9b's f32 prefill).  Each (shape, dtype, softcap) is a
# graph of its own, six in a whole run; past dynamo's recompile limit (8)
# the call would run eagerly, materialising every score, so a hit raises
# instead.
_FLEX = {}


def _flex_call(q, k, v, softcap, mask_mod, scale):
    """A call of the compiled flex_attention: the softcap as its score_mod
    (after the scale, before the mask), ``mask_mod`` as its block mask;
    None when the run does not ask for the flex yardstick."""
    import torch
    from torch.nn.attention import flex_attention as fx

    if not _FLEX.get("on"):
        return None
    if "call" not in _FLEX:
        torch._dynamo.config.fail_on_recompile_limit_hit = True
        _FLEX["call"] = torch.compile(fx.flex_attention, dynamic=False)
    flex = _FLEX["call"]

    def score_mod(sc, b, h, qi, ki):
        return softcap * torch.tanh(sc / softcap)

    block = fx.create_block_mask(mask_mod, None, None, q.shape[2],
                                 k.shape[2], device=q.device)
    return lambda: flex(q, k, v, score_mod=None if softcap is None
                        else score_mod, block_mask=block, scale=scale,
                        enable_gqa=True)


def _flex_attention(q, k, v, *, causal, window, softcap, scale):
    """One compiled ``flex_attention`` call of the same function as the
    prefill, the causal and window mask as its block mask (the window a
    tensor the mask reads, so that a local and a global layer of one shape
    share a graph).  The library yardstick only."""
    import torch

    win = torch.tensor(q.shape[2] + k.shape[2] if window is None else window,
                       device=q.device)

    def mask_mod(b, h, qi, ki):
        ok = ki > qi - win
        if causal:
            ok = ok & (ki <= qi)
        return ok

    return _flex_call(q, k, v, softcap, mask_mod, scale)


def _flex_decode(q, k, v, pos, *, window, softcap, scale):
    """One compiled ``flex_attention`` call of the same function as the
    decode: q [B, H, D] as one query row against the ring cache [B, KH, T,
    D], ``_live_mask``'s slots as its block mask (a tensor the mask reads,
    so that two masks of one shape share a graph).  Returns [B, H, D].  The
    library yardstick only."""
    import torch

    live = torch.from_numpy(_live_mask(k.shape[2], pos, window)).to(q.device)

    def mask_mod(b, h, qi, ki):
        return live[ki]

    call = _flex_call(q[:, :, None], k, v, softcap, mask_mod, scale)
    return None if call is None else (lambda: call()[:, :, 0])


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
    import torch
    from repro_torch.core import run_many
    with _SelectionTimer() as timer:
        t0 = time.perf_counter()
        outs = run_many(job, settings, n_runs=n_runs, budget_b=budget_b,
                        device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return outs, len(timer.seconds), wall


class _SelectionTimer:
    """Wraps ``lookahead.make_selector`` so that every selector built inside
    the block counts and times its selections (a synchronise after each)."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        import torch
        from repro_torch.core import lookahead
        self._real = real = lookahead.make_selector

        def make_timed(*a, **k):
            sel = real(*a, **k)

            def run(*x, **y):
                t0 = time.perf_counter()
                out = sel(*x, **y)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                return out
            return run

        lookahead.make_selector = make_timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import lookahead
        lookahead.make_selector = self._real


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
# (d)'s tf-cnn runs: timeout off, 3 runs on 2 slots, so that a slot
# refills; at budget b = 1.25 (B = N·m̃·b: a quarter of the paper's
# exploration budget of b = 3 past the bootstrap), cut to keep the script
# within its time limit (b = 2 until phase train came, 1.5 until the
# script passed 1100 s).  Printed as `reduced` on (d)'s and phase
# service (b)'s lines.
BATCHED_TF_RUNS, BATCHED_TF_SLOTS, BATCHED_TF_BUDGET = 3, 2, 1.25
BATCHED_TF_REDUCED = json.dumps({"budget_b": [3.0, BATCHED_TF_BUDGET]})


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
                               budget_b=BATCHED_TF_BUDGET, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = select_step_cuda.launches
    if launches != 3 * count.steps or count.steps == 0:
        raise AssertionError(f"batched tf-cnn: {launches} launches for "
                             f"{count.steps} steps of {slots} slots (want "
                             "3 a step: one a level for every slot)")
    seq, seq_steps, seq_wall = _counting_selector_runs(
        tf_job, s, n_runs, BATCHED_TF_BUDGET, device)
    if _pinned_json(bat) != _pinned_json(seq):
        raise AssertionError("batched tf-cnn runs differ from run_many: "
                             + "; ".join(diff_outcomes(seq, bat)[:3]))
    _line("batched", part="tf_runs", job=tf_job.name, runs=n_runs,
          slots=slots, budget_b=BATCHED_TF_BUDGET,
          reduced=BATCHED_TF_REDUCED, steps=count.steps, launches=launches,
          syncs_in_step_bodies=count.syncs, wall_s=f"{wall:.1f}",
          steps_per_s=f"{count.steps / wall:.3f}",
          selections_per_s=f"{count.steps * slots / wall:.3f}",
          mean_select_s=f"{st_.mean(o.select_seconds for o in bat):.4f}",
          seq_steps=seq_steps, seq_wall_s=f"{seq_wall:.1f}",
          seq_steps_per_s=f"{seq_steps / seq_wall:.3f}",
          seq_mean_select_s=f"{st_.mean(o.select_seconds for o in seq):.4f}",
          nex=[o.nex for o in bat], pinned_equal_run_many=True)
    return launches, seq


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
    launches, tf_outs = _batched_tf_runs(device, tf_job)
    _line("batched", phase_s=f"{time.perf_counter() - t0:.1f}")
    return step, launches, tf_outs


# --------------------------------------------------------------------------- #
# Phase 8: the streaming service (StreamingTuner over the segment engines)
# --------------------------------------------------------------------------- #
# (b)'s pacing: 2 seats, 8 steps a segment (16 until (d)'s budget fell to
# b = 1.25: at half the steps, 8 keeps the streams crossing segments).
SERVICE_TF_SLOTS, SERVICE_TF_QUOTA = 2, 8


def _service_tickets_done(tickets, what):
    """Every ticket resolved with an Outcome: one that resolved with an
    exception, or was cancelled, fails the phase."""
    bad = [f"ticket {t.id}: {t.state}" for t in tickets
           if t.state != "done"]
    if bad:
        raise AssertionError(f"{what}: {bad}")
    return [t.result() for t in tickets]


def _service_trace_ok(svc, what):
    from repro_torch.obs import validate_lifecycle, validate_trace
    events = svc.flight_record()
    issues = (validate_trace(events)
              + validate_lifecycle(events, require_terminal=True))
    if issues:
        raise AssertionError(f"{what}: trace issues {issues[:3]}")
    return events


def _service_golden(device):
    """(a) The golden synthetic runs streamed in three bursts, on 1 shard,
    on 2 shards (both on the one card) and with a run preempted and
    resumed (high_water=0, the first burst at a low priority)."""
    from repro_torch.core import RunRequest, Settings
    from repro_torch.core.optimizer import _per_run_seeds
    from repro_torch.jobs.synthetic import synthetic_job
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs.forensics import outcome_to_dict
    from repro_torch.service import ServiceConfig, StreamingTuner

    golden = json.loads(GOLDEN.read_text())
    job = synthetic_job(golden["job_seed"])
    reqs = [RunRequest(job, seed=sd, budget_b=golden["budget_b"])
            for sd in _per_run_seeds(0, golden["n_runs"])]
    bursts = [[0, 1], [2], [3]]
    variants = (("1 shard", dict(num_shards=1), 0),
                ("2 shards", dict(num_shards=2), 0),
                ("preempt", dict(num_shards=1, high_water=0), 5))
    for case in golden["cases"]:
        want = json.dumps(case["outcomes"], sort_keys=True)
        for name, kw, first_priority in variants:
            cfg = ServiceConfig(lane_slots=2, queue_capacity=2, step_quota=4,
                                trace=True, **kw)
            svc = StreamingTuner(job, Settings(**case["settings"]), cfg,
                                 device=device)
            select_step_cuda.launches = 0
            tickets = {}
            for k, burst in enumerate(bursts):
                for r in burst:
                    tickets[r] = svc.submit(
                        reqs[r], priority=first_priority if k == 0 else 0)
                if k < len(bursts) - 1:
                    svc.pump()
            svc.drain()
            launches = select_step_cuda.launches
            outs = _service_tickets_done(
                [tickets[r] for r in range(len(reqs))],
                f"service golden {name}")
            got = json.dumps([outcome_to_dict(o) for o in outs],
                             sort_keys=True)
            m = svc.metrics()
            _service_trace_ok(svc, f"service golden {name}")
            devices = sorted({str(e.device) for e in svc._engines.shards})
            if got != want or launches == 0 or (
                    first_priority and (m.preempted < 1 or m.resumed < 1)):
                raise AssertionError(
                    f"service golden {case['settings']} {name}: "
                    f"{launches} launches, {m.preempted} preempted, "
                    f"{m.resumed} resumed, outcomes "
                    f"{'equal' if got == want else 'differ'}")
            _line("service", part="golden", variant=name,
                  settings=json.dumps(case["settings"],
                                      separators=(",", ":")),
                  runs=len(outs), shards=cfg.num_shards,
                  devices=",".join(devices), segments=m.segments,
                  steps=m.steps, preempted=m.preempted, resumed=m.resumed,
                  launches=launches, trace_valid=True, equal=True)


def _service_tf_runs(device, tf_job, seq_outs):
    """(b) tf-cnn at the paper's defaults: the runs of phase batched (d)
    streamed on 2 seats, 8 steps a segment, traced; the pinned fields
    byte-equal to ``run_many``'s, 3 launches a step."""
    import torch
    from repro_torch.core import RunRequest, Settings
    from repro_torch.core.optimizer import _per_run_seeds
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.obs import PHASES
    from repro_torch.obs.forensics import diff_outcomes
    from repro_torch.service import ServiceConfig, StreamingTuner

    n_runs = len(seq_outs)
    reqs = [RunRequest(tf_job, seed=sd, budget_b=BATCHED_TF_BUDGET)
            for sd in _per_run_seeds(0, n_runs)]
    cfg = ServiceConfig(lane_slots=SERVICE_TF_SLOTS,
                        queue_capacity=SERVICE_TF_SLOTS,
                        step_quota=SERVICE_TF_QUOTA, trace=True)
    svc = StreamingTuner(tf_job, Settings(), cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    select_step_cuda.launches = 0
    with _StepCounter() as count:
        t0 = time.perf_counter()
        tickets = [svc.submit(q) for q in reqs[:2]]
        svc.pump()
        tickets.append(svc.submit(reqs[2]))
        svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = select_step_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    outs = _service_tickets_done(tickets, "service tf-cnn")
    if _pinned_json(outs) != _pinned_json(seq_outs):
        raise AssertionError("streamed tf-cnn runs differ from run_many: "
                             + "; ".join(diff_outcomes(seq_outs, outs)[:3]))
    if launches != 3 * count.steps or count.steps == 0:
        raise AssertionError(f"service tf-cnn: {launches} launches for "
                             f"{count.steps} steps (want 3 a step)")
    events = _service_trace_ok(svc, "service tf-cnn")
    m = svc.metrics()
    spans = {p: sum(e.data["dur_s"] for e in events
                    if e.kind == "span" and e.data["phase"] == p)
             for p in PHASES}
    reads = sum(e.host_reads for e in svc._engines.shards)
    _line("service", part="tf_runs", job=tf_job.name, runs=n_runs,
          reduced=BATCHED_TF_REDUCED, slots=cfg.lane_slots,
          step_quota=cfg.step_quota,
          segments=m.segments, steps=count.steps, launches=launches,
          wall_s=f"{wall:.1f}", steps_per_s=f"{count.steps / wall:.3f}",
          selections_per_s=f"{count.steps * cfg.lane_slots / wall:.3f}",
          span_s=json.dumps({p: round(v, 4) for p, v in spans.items()},
                            separators=(",", ":")),
          host_reads=reads,
          host_reads_per_segment=f"{reads / max(m.segments, 1):.1f}",
          syncs_in_step_bodies=count.syncs,
          lane_occupancy=f"{m.lane_occupancy:.4f}",
          latency_p50_s=f"{m.latency_p50_s:.2f}",
          latency_p99_s=f"{m.latency_p99_s:.2f}",
          peak_memory_gib=f"{peak / 2 ** 30:.2f}",
          nex=[o.nex for o in outs], trace_valid=True,
          pinned_equal_run_many=True)
    return launches


def phase_service(device, tf_job, tf_outs):
    """The streaming service on the card: (a) the golden runs streamed in
    bursts through 1 shard, 2 shards and a preemption; (b) the tf-cnn
    runs of phase batched (d) streamed against their ``run_many``
    outcomes.  Returns (b)'s select_step launches."""
    t0 = time.perf_counter()
    _service_golden(device)
    launches = _service_tf_runs(device, tf_job, tf_outs)
    _line("service", phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


# --------------------------------------------------------------------------- #
# Phase 10: the Zamba2 serving path (ssm_scan, flash and decode attention)
# --------------------------------------------------------------------------- #
ZAMBA = dict(arch="zamba2-7b", batch=4, prompt=1000, gen=32)
# Serving runs in phase model and the zoo: the first with the launch
# counts, then repeats for the spread of the rates (3 runs until the
# script passed 1100 s, 2 until remat's part (k) and the dry run came;
# printed as `reduced` on the medians' lines).
SERVE_RUNS = 1
SERVE_REDUCED = json.dumps({"serve_runs": [3, SERVE_RUNS]})
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
    unprofiled, and the kernels that take the most device time.  Returns
    the busy seconds."""
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
    return busy


def _ssm_bound(args, kw, chunk, dtype):
    """Bytes, operations and peak of the least time over the algorithms:
    the recurrence on the CUDA cores whatever the input type; the chunked
    form on the CUDA cores, on the tensor cores at the inputs' type (bf16),
    and in split TF32 (three products for each, the float32 form the
    kernel runs), from ``kernel.work``.  Returns (bytes, ops, peak, fields
    naming them)."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    nbytes, recurrence, chunked = sk.work(
        *args, chunk=chunk, initial_state=kw.get("initial_state"))
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


def prompt_batch(batch, prompt):
    """The prefill's inputs from a family's batch of ``prompt`` + steps
    positions: the first ``prompt`` tokens, frames, mask entries and
    M-RoPE ids, the vision prefix whole, no targets."""
    out = {}
    for k, v in batch.items():
        if k == "targets":
            continue
        out[k] = (v if k == "vision_embeds" else
                  v[:, :, :prompt] if k == "positions" else v[:, :prompt])
    return out


def golden_logits(cfg, weights, batch, prompt, steps, device):
    """A smoke model's prefill logits and ``steps`` teacher-forced decode
    logits [steps + 1, B, V] (float64, on the host), computed on
    ``device`` from numpy weights and a family's numpy ``batch`` (tokens;
    a VLM's vision prefix and M-RoPE ids; an encoder's frames and mask):
    what the golden files hold, and what the tests check on the CPU.  An
    encoder has no decode step: its prefill's logits of every frame [1, B,
    prompt, V]."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import RuntimeFlags, build_model

    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    params = convert.tree_from_numpy(weights, device)
    pre = convert.tree_from_numpy(
        {k: np.asarray(v) for k, v in prompt_batch(batch, prompt).items()},
        device)
    logits, caches = model.prefill(params, pre, flags, prompt + steps)
    if cfg.is_encoder:
        return logits[None].cpu().double()
    toks = torch.as_tensor(np.asarray(batch["tokens"]), device=device)
    out = [logits[:, 0]]
    for i in range(steps):
        pos = prompt + i
        logits, caches = model.decode(params, caches, toks[:, pos:pos + 1],
                                      pos, flags)
        out.append(logits[:, 0])
    return torch.stack(out).cpu().double()


def golden_batch(cfg, entry, meta):
    """The inputs of a golden entry: its tokens, or for the audio and VLM
    families ``make_batch``'s arrays at the file's seed (the entry keeps
    their tokens or mask, which must match)."""
    import numpy as np
    from repro_torch.data.pipeline import make_batch

    if cfg.family not in ("audio", "vlm"):
        return {"tokens": np.asarray(entry["tokens"])}
    batch = make_batch(cfg, "serve", meta["batch"],
                       meta["prompt_len"] + meta["steps"],
                       seed=meta["data_seed"], step=0)
    key = "mask" if cfg.family == "audio" else "tokens"
    if not np.array_equal(batch[key], np.asarray(entry[key])):
        raise AssertionError(f"{cfg.name}: make_batch's {key} differ from "
                             f"the golden file's")
    return batch


def _golden_check(golden_file, arch, entry, meta, device):
    """One arch's smoke config through the kernels, teacher-forced,
    against the JAX package's inputs and logits in ``entry``, at atol 2e-4
    (``meta``: the file's seeds, batch, prompt length and steps)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    weights = convert.numpy_params(build_model(cfg).specs(),
                                   meta["param_seed"])
    got = golden_logits(cfg, weights, golden_batch(cfg, entry, meta),
                        meta["prompt_len"], meta["steps"], device)
    want = torch.tensor(entry["logits"], dtype=torch.float64)
    err = (got - want).abs().max().item()
    _line("model", golden=golden_file.name, config=cfg.name,
          steps=1 if cfg.is_encoder else meta["steps"] + 1,
          max_abs_err=err, atol=2e-4)
    if got.shape != want.shape or not err <= 2e-4:
        raise AssertionError(f"{cfg.name} on the card differs from the JAX "
                             f"package's logits by {err} (atol 2e-4; shapes "
                             f"{tuple(got.shape)}, {tuple(want.shape)})")


def _zamba_golden(device):
    """zamba2-smoke through the kernels, teacher-forced, against the JAX
    package's logits (``golden_zamba.json``)."""
    golden = json.loads(GOLDEN_ZAMBA.read_text())
    entry = {k: golden[k] for k in ("tokens", "logits")}
    _golden_check(GOLDEN_ZAMBA, golden["arch"], entry, golden, device)


def _zoo_golden(device):
    """Each smoke config of ``golden_zoo.json`` (every arch but zamba2-7b)
    through the kernels, teacher-forced (an encoder's prefill alone),
    against the JAX package's logits."""
    golden = json.loads(GOLDEN_ZOO.read_text())
    for arch, entry in golden["archs"].items():
        _golden_check(GOLDEN_ZOO, arch, entry, golden, device)


def _model_ops():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as sk_ops
    return {"ssm_scan": sk_ops, "flash_attention": fa_ops,
            "decode_attention": da_ops}


def _serve(device, model, params, flags, batch, prompt, gen, caps, want):
    """Serve ``batch`` (the family's inputs on the card) through
    ``repro_torch.launch.serve.generate``:
    once with every launch count at 0 and the model ops' kernels behind
    ``caps`` (read after), then ``SERVE_RUNS - 1`` more times for the
    spread of the two rates.  Fails unless the launches equal ``want``
    and the tokens are in range.  Returns (launches, prefill seconds of
    each run, decode tokens/s of each run, peak GB, medians of both)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate

    cfg = model.cfg
    n_seq = batch["tokens"].shape[0]
    mods = _model_ops()
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    for name, cap in caps.items():
        mods[name]._kernel = cap
    try:
        with _HostClock() as clock:
            out, tps, prefill_s = generate(model, params, flags, batch,
                                           prompt, gen, prompt + gen)
        torch.cuda.synchronize(device)
    finally:
        for name, cap in caps.items():
            mods[name]._kernel = cap.module
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    host = out.cpu()
    _line("model", arch=cfg.name, drive="repro_torch.launch.serve.generate",
          prefill_s=f"{prefill_s:.4f}", decode_tokens_per_s=f"{tps:.1f}",
          peak_gb=f"{peak_gb:.2f}", **clock.fields(),
          launches=json.dumps(launches, separators=(",", ":")),
          sample=host[0, :10].tolist())
    if launches != want:
        raise AssertionError(f"launches on the {cfg.name} serving path "
                             f"{launches}, expected {want}")
    if tuple(host.shape) != (n_seq, gen) or not (
            (host >= 0) & (host < cfg.vocab)).all():
        raise AssertionError(f"generated tokens {tuple(host.shape)} out of "
                             f"range")
    del out, host
    prefill_runs, tps_runs = [prefill_s], [tps]
    for run in range(1, SERVE_RUNS):
        with _HostClock() as clock:
            _, tps_r, prefill_r = generate(model, params, flags, batch,
                                           prompt, gen, prompt + gen)
        prefill_runs.append(prefill_r)
        tps_runs.append(tps_r)
        _line("model", arch=cfg.name,
              drive="repro_torch.launch.serve.generate", run=run,
              prefill_s=f"{prefill_r:.4f}",
              decode_tokens_per_s=f"{tps_r:.1f}", **clock.fields())
    prefill_med = float(np.median(prefill_runs))
    tps_med = float(np.median(tps_runs))
    _line("model", arch=cfg.name, runs=SERVE_RUNS, reduced=SERVE_REDUCED,
          prefill_s_median=f"{prefill_med:.4f}",
          decode_tokens_per_s_median=f"{tps_med:.1f}",
          decode_step_s_median=f"{n_seq / tps_med:.4f}")
    return launches, prefill_runs, tps_runs, peak_gb, prefill_med, tps_med


def _reporter(rows, failures, launches):
    """``report(name, case, err, bad, ms, plain_ms, lib_ms, nbytes, ops,
    peak, **extra)``: one row of a model kernel against its plain version,
    with its bound, into ``rows`` (and its failures into ``failures``)."""
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
    return report


def _check_scan(calls, report, chunk, label, device):
    """ssm_scan on each captured call, float32 and with k/q/v cast to
    bf16, against the plain version evaluated in float64, timed."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import linear_scan_ref

    # bf16 keeps B and C broadcast over the heads (stride 0).
    bf16 = lambda t: (t[:, :, :1].to(torch.bfloat16).expand(t.shape)
                      if t.stride(2) == 0 else t.to(torch.bfloat16))
    for i, (args, kw) in sorted(calls.items()):
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
            report("ssm_scan", f"{label(i)}, {dtype}", err, bad, ms,
                   plain_ms, None, nbytes, ops, peak=peak,
                   kernel_ms=kernel_ms, **work, B=b_, L=l_, H=h_, N=n_,
                   P=a[1].shape[-1], chunk=chunk,
                   k_head_stride=a[0].stride(2), **extra)
            del prep, outs, keep, want_out


def _check_flash(calls, report, label, device):
    """flash_attention on each captured prefill call against its plain
    version, timed beside the library call: SDPA, or a compiled
    ``flex_attention`` where there is a softcap or a window."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (args, kw) in sorted(calls.items()):
        q, k, v = args
        prep, o, keep = fa.prepare(q, k, v, **kw)
        fa.launch(prep)
        want_o = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize(device)
        err, bad = _close(2e-5, 2e-5)(o, want_o)
        del want_o
        ms = _launch_ms(lambda: fa.launch(prep), n=10)
        plain_ms = _median_ms(lambda: attention_ref(q, k, v, **kw), reps=3,
                              warmup=1)
        if kw.get("softcap") is None and kw.get("window") is None:
            lib = lambda: sdpa(q, k, v, is_causal=kw["causal"],
                               scale=kw.get("scale"),
                               enable_gqa=k.shape[1] != q.shape[1])
        else:
            lib = _flex_attention(q, k, v, causal=kw["causal"],
                                  window=kw.get("window"),
                                  softcap=kw.get("softcap"),
                                  scale=kw.get("scale"))
        lib_ms = None if lib is None else _launch_ms(lib, n=10)
        b_, h_, s_, d_ = q.shape
        ops, nbytes = fa.cost(q, k, v, causal=kw["causal"],
                              window=kw["window"])
        report("flash_attention", f"{label(i)}, f32", err, bad, ms,
               plain_ms, lib_ms, nbytes, ops, B=b_, H=h_, KH=k.shape[1], S=s_,
               T=k.shape[2], D=d_, window=kw.get("window"),
               softcap=kw.get("softcap"),
               **_f32_flash_extra(q.dtype, b_, h_, k.shape[1], s_,
                                  k.shape[2], d_, kw, ops, nbytes))
        del prep, o, keep


def _check_decode(calls, report, label, device):
    """decode_attention on each captured call, over the ring cache views
    the model hands it (strided [B, KH, T, D]), against its plain version,
    timed beside SDPA over the live slots, or a compiled
    ``flex_attention`` over them where there is a softcap."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (args, kw) in sorted(calls.items()):
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
        if kw.get("softcap") is None:
            lib = lambda: sdpa(
                q[:, :, None], k, v, attn_mask=mask, scale=kw.get("scale"),
                enable_gqa=k.shape[1] != q.shape[1])[:, :, 0]
        else:
            lib = _flex_decode(q, k, v, int(pos), window=kw.get("window"),
                               softcap=kw["softcap"], scale=kw.get("scale"))
        lib_err = None if lib is None else _close(2e-5, 2e-5)(lib(),
                                                             want_o)[0]
        lib_ms = None if lib is None else _launch_ms(lib, n=20)
        b_, h_, d_ = q.shape
        ops, nbytes = da.cost(q, k, v, int(pos), window=kw.get("window"))
        report("decode_attention", f"{label(i)}, pos {int(pos)}, f32", err,
               bad, ms, plain_ms, lib_ms, nbytes, ops, B=b_, H=h_,
               KH=k.shape[1], T=t_,
               D=d_, live_slots=live, window=kw.get("window"),
               softcap=kw.get("softcap"), k_strides=list(k.stride()),
               library_err=lib_err)
        del prep, o, keep, want_o


def _profile_serving(model, params, flags, batch, prompt, gen, prefill_med,
                     tps_med):
    """Where the time goes: one prefill and one decode step (an encoder:
    the prefill alone), profiled."""
    import torch
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(
            params, batch, flags, prompt + gen)

    _profile(f"{model.cfg.name} prefill", prefill, prefill_med)
    if model.cfg.is_encoder:
        state.clear()
        return
    nxt = torch.argmax(state.pop("logits"), dim=-1)
    _profile(f"{model.cfg.name} decode step",
             lambda: model.decode(params, state["caches"], nxt, prompt,
                                  flags), nxt.shape[0] / tps_med)
    state.clear()


def _init_model(device, cfg, batch, prompt, gen, reduced=None):
    """The model, its float32 weights drawn on the card from a seeded
    generator, and ``make_batch``'s inputs of the family on the card (no
    targets); the peak memory counted from before the draw.  ``reduced``
    names the config's cuts for the model line."""
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(device)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        torch.float32, device)
    host = make_batch(cfg, "serve", batch, prompt, seed=0, step=0)
    inputs = {k: torch.as_tensor(v, device=device) for k, v in host.items()
              if k != "targets"}
    torch.cuda.synchronize(device)
    extra = {} if reduced is None else dict(reduced=json.dumps(reduced))
    _line("model", arch=cfg.name, params=model.n_params(),
          layers=cfg.n_layers, d_model=cfg.d_model, batch=batch,
          prompt=prompt, gen=gen, inputs=",".join(inputs), **extra,
          init_s=f"{time.perf_counter() - t0:.1f}")
    return model, params, inputs


def phase_model(device, cfg=None, batch=ZAMBA["batch"],
                prompt=ZAMBA["prompt"], gen=ZAMBA["gen"]):
    """Serve zamba2-7b at full width and depth through
    ``repro_torch.launch.serve.generate`` with the launch counts at 0, then
    hold each kernel against its plain version on the arguments captured
    from that run, time it, and check the smoke model's golden logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.models import RuntimeFlags

    t0 = time.perf_counter()
    cfg = cfg or get_config(ZAMBA["arch"])
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    model, params, inputs = _init_model(device, cfg, batch, prompt, gen)
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
    want = {"ssm_scan": cfg.n_layers, "flash_attention": n_sites,
            "decode_attention": n_sites * (gen - 1), "select_step": 0,
            "tree_predict": 0, "gh_ei": 0}
    launches, prefill_runs, tps_runs, peak_gb, prefill_med, tps_med = \
        _serve(device, model, params, flags, inputs, prompt, gen, caps, want)

    rows, failures = [], []
    report = _reporter(rows, failures, launches)
    # ssm_scan: layer 0 and the last layer, float32, then k/q/v in bf16.
    _check_scan(caps["ssm_scan"].calls, report, min(cfg.ssm_chunk, prompt),
                lambda i: f"layer {i}", device)
    # flash_attention at site 0 of the prefill.
    _check_flash(caps["flash_attention"].calls, report,
                 lambda i: f"{cfg.name} site 0 prefill", device)
    # decode_attention: the last step's last site.
    _check_decode(caps["decode_attention"].calls, report,
                  lambda i: f"{cfg.name} last step, site {n_sites - 1}",
                  device)
    caps.clear()
    _profile_serving(model, params, flags, inputs, prompt, gen, prefill_med,
                     tps_med)
    del params, inputs
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
# Phase 10 (zoo): the rest of the model zoo served at full width
# --------------------------------------------------------------------------- #
# ``layers`` cuts the depth (listed as ``reduced`` in the model line): the
# two MoE archs do not fit one card at full depth.
ZOO = (dict(arch="xlstm-125m", batch=4, prompt=1000, gen=32),
       # Past the 4096 window: the local layers' window masks in the
       # prefill and in decode.
       dict(arch="gemma2-9b", batch=2, prompt=4608, gen=32),
       # The window on every layer caps the ring at 4096 slots: past it,
       # the ring wraps in the prefill's ring_place and in decode.
       dict(arch="mixtral-8x22b", batch=2, prompt=4608, gen=32, layers=4),
       # The 3 dense layers and 1 of the 58 MoE layers; two MoE groups of
       # 2048 tokens.  MLA decodes in latent einsums (no kernel).
       dict(arch="deepseek-v3-671b", batch=2, prompt=2048, gen=32,
            layers=4),
       # 256 vision tokens and 1024 text, M-RoPE ids.
       dict(arch="qwen2-vl-2b", batch=4, prompt=1280, gen=32),
       # 20 s of audio at the 20 ms frame rate; an encoder: prefill only.
       dict(arch="hubert-xlarge", batch=4, prompt=1000, gen=0))


def _zoo_config(spec):
    """The arch's full config, its depth cut to ``spec["layers"]`` where
    the spec says; returns (config, the cut or None)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(spec["arch"])
    if "layers" not in spec:
        return cfg, None
    gb = build_model(cfg).n_params() * 4 / 1e9
    reduced = {"n_layers": [cfg.n_layers, spec["layers"]],
               "why": f"{gb:.1f} GB of float32 weights at full depth"}
    return dataclasses.replace(cfg, n_layers=spec["layers"]), reduced


def _slstm_share(device, model, params, flags, inputs):
    """One xLSTM prefill with its sLSTM blocks timed (host clock around
    each, synchronized): their seconds and share of the prefill's."""
    import torch
    from repro_torch.models import xlstm_model as xm

    real, spent = xm.slstm_block, []

    def timed(*args, **kw):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize(device)
        spent.append(time.perf_counter() - t)
        return out

    xm.slstm_block = timed
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        model.prefill(params, inputs, flags, 0)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        xm.slstm_block = real
    _line("model", arch=model.cfg.name, slstm_blocks=len(spent),
          slstm_s=f"{sum(spent):.4f}", prefill_s=f"{wall:.4f}",
          slstm_share=f"{sum(spent) / wall:.3f}")


def _serve_encoder(device, model, params, flags, inputs, caps, want):
    """An encoder served through ``train.step.make_serve_step``'s prefill
    (a unit for every frame, no cache): once with every launch count at 0
    and the model ops' kernels behind ``caps``, then ``SERVE_RUNS - 1``
    more times.  Fails unless the launches equal ``want`` and the units are
    in range.  Returns (launches, peak GB, the median prefill seconds)."""
    import numpy as np
    import torch
    from repro_torch.train.step import make_serve_step

    cfg = model.cfg
    prefill, _ = make_serve_step(model, flags)
    mods = _model_ops()
    counters = _all_counters()
    runs = []
    for run in range(SERVE_RUNS):
        if run == 0:
            for fn in counters.values():
                fn.launches = 0
            for name, cap in caps.items():
                mods[name]._kernel = cap
        try:
            with _HostClock() as clock:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                out, caches = prefill(params, inputs, 0)
                torch.cuda.synchronize(device)
                runs.append(time.perf_counter() - t0)
        finally:
            for name, cap in caps.items():
                mods[name]._kernel = cap.module
        if run == 0:
            launches = {name: fn.launches for name, fn in counters.items()}
            host = out.cpu()
            _line("model", arch=cfg.name,
                  drive="repro_torch.train.step.make_serve_step prefill",
                  prefill_s=f"{runs[-1]:.4f}",
                  peak_gb=f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f}",
                  **clock.fields(),
                  launches=json.dumps(launches, separators=(",", ":")),
                  sample=host[0, :10].tolist())
            if launches != want:
                raise AssertionError(f"launches on the {cfg.name} serving "
                                     f"path {launches}, expected {want}")
            if caches != {} or tuple(host.shape) != tuple(
                    inputs["features"].shape[:2]) or not (
                    (host >= 0) & (host < cfg.vocab)).all():
                raise AssertionError(f"{cfg.name}: the encoder's units "
                                     f"{tuple(host.shape)} out of range")
        else:
            _line("model", arch=cfg.name,
                  drive="repro_torch.train.step.make_serve_step prefill",
                  run=run, prefill_s=f"{runs[-1]:.4f}", **clock.fields())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    med = float(np.median(runs))
    _line("model", arch=cfg.name, runs=SERVE_RUNS, reduced=SERVE_REDUCED,
          prefill_s_median=f"{med:.4f}")
    return launches, peak_gb, med


def _serve_zoo(device, spec, rows, failures, by_path):
    """One arch of ``ZOO``: served with the launch counts at 0, profiled,
    its weights freed, then its kernels held against their plain versions
    on the captured calls (one mLSTM block; the first layer's prefill and
    the last decode step's first layer, and for Gemma2 the second, global,
    layer too)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.models import RuntimeFlags
    from repro_torch.models.xlstm_model import block_kinds

    cfg, reduced = _zoo_config(spec)
    batch, prompt, gen = spec["batch"], spec["prompt"], spec["gen"]
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                         compute_dtype="float32")
    model, params, inputs = _init_model(device, cfg, batch, prompt, gen,
                                        reduced)
    want = dict.fromkeys(_all_counters(), 0)
    # Layers whose calls are held: Gemma2's first pair (local, global).
    held = 2 if cfg.alt_window is not None else 1
    decodes = cfg.family != "ssm" and not cfg.mla and not cfg.is_encoder
    if cfg.family == "ssm":
        n_scan = block_kinds(cfg).count("mlstm")   # a prefill; 0 a decode
        want["ssm_scan"] = n_scan
        caps = {"ssm_scan": _Capture(sk, "ssm_scan_cuda", lambda i: i == 0)}
    else:
        n = cfg.n_layers
        want["flash_attention"] = n
        caps = {"flash_attention": _Capture(fa, "flash_attention_cuda",
                                            lambda i: i < held)}
        if decodes:
            want["decode_attention"] = n * (gen - 1)
            last = n * (gen - 2)
            caps["decode_attention"] = _Capture(
                da, "decode_attention_cuda",
                lambda i: last <= i < last + held)
    tps_med = None
    if cfg.is_encoder:
        launches, _, prefill_med = _serve_encoder(
            device, model, params, flags, inputs, caps, want)
    else:
        launches, _, _, _, prefill_med, tps_med = _serve(
            device, model, params, flags, inputs, prompt, gen, caps, want)
    by_path[cfg.name] = launches
    if cfg.family == "ssm":
        _slstm_share(device, model, params, flags, inputs)
    _profile_serving(model, params, flags, inputs, prompt, gen, prefill_med,
                     tps_med)
    # The plain versions below materialise every score (8 GB at
    # mixtral-8x22b's prefill): the weights go first.
    del model, params, inputs
    torch.cuda.empty_cache()
    report = _reporter(rows, failures, launches)

    def kind(i):
        win = cfg.layer_window(i % cfg.n_layers)
        if cfg.alt_window is not None:
            return " (local)" if win else " (global)"
        return f" (window {win})" if win else ""

    if cfg.family == "ssm":
        _check_scan(caps["ssm_scan"].calls, report,
                    min(cfg.ssm_chunk, prompt),
                    lambda i: f"{cfg.name} mLSTM block {i}", device)
    else:
        _check_flash(caps["flash_attention"].calls, report,
                     lambda i: f"{cfg.name} layer {i}{kind(i)} prefill",
                     device)
        if decodes:
            _check_decode(caps["decode_attention"].calls, report,
                          lambda i: f"{cfg.name} last step, layer "
                                    f"{i - last}{kind(i)}", device)
    caps.clear()
    torch.cuda.empty_cache()


def phase_zoo(device):
    """Serve the archs of ``ZOO`` at full width (the MoE archs at cut
    depth), each with its kernels held against their plain versions, then
    the smoke configs of ``golden_zoo.json`` against the JAX package's
    logits.  Returns (rows, launches by arch)."""
    t0 = time.perf_counter()
    rows, failures, by_path = [], [], {}
    for spec in ZOO:
        t1 = time.perf_counter()
        _serve_zoo(device, spec, rows, failures, by_path)
        _line("model", arch=spec["arch"],
              arch_s=f"{time.perf_counter() - t1:.1f}")
    _zoo_golden(device)
    _line("model", zoo_s=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError(f"{len(failures)} kernel outputs on the zoo's "
                             f"serving paths differ from the plain version: "
                             f"{failures[:3]}")
    return rows, by_path


# --------------------------------------------------------------------------- #
# Phase 9: the determinism gate and its kernel, masked_argmax
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


# --------------------------------------------------------------------------- #
# Phase 11: the §4.4 extensions, optimize_live and the launch-config tuner
# --------------------------------------------------------------------------- #
GOLDEN_EXT = (ROOT / "src" / "repro_torch" / "testdata"
              / "golden_extensions.json")
# (b)'s selections: the tuner's golden call (mixtral-8x22b's 180-point launch
# space, budget 1000, SLO 1.5, la 2) with the exact refit.  The tuner's own
# selector refits frozen, which has no fused kernel in the reference or the
# port (``lookahead._fused_mode``): it selects through the plain program.
LIVE_TUNE = dict(arch="mixtral-8x22b", shape="train_4k", mesh_kind="single",
                 budget=1000.0, slo=1.5, mock=True, la=2)


def extension_api(device):
    """The port's names that :func:`run_extension_case` calls, with the
    device its entry points run on.  (The tests build the JAX package's
    twin of this namespace.)"""
    from repro_torch.core import Settings, extensions
    from repro_torch.core.optimizer import optimize_live
    from repro_torch.core.space import DiscreteSpace
    from repro_torch.jobs.synthetic import tensorflow_jobs
    from repro_torch.jobs.tables import JobTable
    from repro_torch.launch import autotune
    return types.SimpleNamespace(
        Settings=Settings, ext=extensions, optimize_live=optimize_live,
        DiscreteSpace=DiscreteSpace, JobTable=JobTable,
        tensorflow_jobs=tensorflow_jobs, autotune=autotune,
        kw={"device": device})


def extension_job(spec, api):
    import numpy as np
    if "tensorflow_jobs" in spec:
        return api.tensorflow_jobs(spec["tensorflow_jobs"])[spec["index"]]
    space = api.DiscreteSpace.from_grid(spec["grid"])
    return api.JobTable(spec["name"], space, np.asarray(spec["runtime"]),
                        np.asarray(spec["unit_price"]), spec["t_max"])


def run_extension_case(case, api):
    """One case of ``golden_extensions.json`` through ``api``'s names;
    returns its output as JSON values (floats exact, so ``==`` is bitwise).

    ``case["call"]`` names the function; the case holds its inputs: a job
    (its grid and table columns, or a ``tensorflow_jobs`` index), metric
    arrays, ``Settings`` fields and keywords.  ``optimize_live`` runs
    against the evaluator of ``tests/test_autotune_and_launch.py``: a
    probe's runtime from the case's table, its cost runtime times
    ``price``."""
    import numpy as np
    call, kw = case["call"], dict(case.get("kwargs", {}))
    settings = (None if case.get("settings") is None
                else api.Settings(**case["settings"]))
    if call == "cartesian_gh":
        vals, wts = api.ext.cartesian_gh(**kw)
        out = {"vals": vals.tolist(), "wts": wts.tolist()}
    elif call == "default_setup_cost":
        space = extension_job(case["job"], api).space
        setup = api.ext.default_setup_cost(space, **kw)
        m = space.n_points
        out = {"first": [setup(None, j) for j in range(m)],
               "pairs": [[setup(i, j) for j in range(m)] for i in range(m)]}
    elif call == "optimize_multi_constraint":
        cjob = api.ext.ConstrainedJob(
            extension_job(case["job"], api),
            {k: np.asarray(v) for k, v in case["metrics"].items()},
            dict(case["thresholds"]))
        out = api.ext.optimize_multi_constraint(cjob, settings=settings,
                                                **kw, **api.kw)
    elif call == "optimize_with_setup_costs":
        job = extension_job(case["job"], api)
        setup = api.ext.default_setup_cost(job.space, **case["setup"])
        out = api.ext.optimize_with_setup_costs(job, settings,
                                                setup_cost=setup, **kw,
                                                **api.kw)
    elif call == "optimize_live":
        space = api.DiscreteSpace.from_grid(case["grid"])
        runtimes, price = np.asarray(case["runtimes"]), case["price"]

        def evaluate(i):
            t = float(runtimes[i])
            return t, t * price

        out = api.optimize_live(evaluate, space,
                                np.full(space.n_points, price),
                                case["t_max"], settings, **kw, **api.kw)
    elif call == "tune":
        out = api.autotune.tune(*case["args"], out_dir=None,
                                log=lambda *a: None, **kw, **api.kw)
    else:
        raise ValueError(f"unknown extension call {call!r}")
    return json.loads(json.dumps(out, default=str))


def _tune_with(device, **change):
    """``autotune.tune`` on :data:`LIVE_TUNE` with its selector's Settings
    changed by ``change``; returns (output, selection seconds, wall s)."""
    import dataclasses

    import torch
    from repro_torch.launch import autotune

    real = autotune.tune_settings
    autotune.tune_settings = lambda la: dataclasses.replace(real(la),
                                                            **change)
    try:
        args = dict(LIVE_TUNE)
        with _SelectionTimer() as timer:
            t0 = time.perf_counter()
            out = autotune.tune(args.pop("arch"), args.pop("shape"),
                                args.pop("mesh_kind"), out_dir=None,
                                log=None, device=device, **args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        autotune.tune_settings = real
    return out, timer.seconds, wall


def phase_extensions(device):
    """(a) Every case of ``golden_extensions.json`` on the card, equal to
    the JAX package's outputs; (b) the tuner's golden call with the exact
    refit through ``select_step`` (3 launches a selection), against the
    plain path.  Returns (b)'s launches."""
    import statistics as st_

    import torch
    from repro_torch.kernels.select_step.kernel import select_step_cuda
    from repro_torch.launch import autotune

    t0 = time.perf_counter()
    golden = json.loads(GOLDEN_EXT.read_text())
    api = extension_api(device)
    bad = []
    for case in golden["cases"]:
        c0 = time.perf_counter()
        with _SelectionTimer() as timer:
            got = run_extension_case(case, api)
            torch.cuda.synchronize()
        wall = time.perf_counter() - c0
        equal = got == case["out"]
        if not equal:
            bad.append(case["name"])
        probes = got.get("explored") if isinstance(got, dict) else None
        sel = timer.seconds
        _line("extensions", case=case["name"], call=case["call"],
              equal_golden=equal, wall_s=f"{wall:.3f}",
              probes=None if probes is None else len(probes),
              censored=len(got.get("censored", ())),
              steps=len(sel), steps_per_s=(f"{len(sel) / wall:.3f}"
                                           if sel else None),
              mean_select_s=f"{st_.mean(sel):.4f}" if sel else None)
    if bad:
        raise AssertionError(f"extension cases differ from the JAX "
                             f"package's golden outputs: {bad}")

    # (b) The kernel against its plain version through optimize_live.
    select_step_cuda.launches = 0
    kern, k_sel, k_wall = _tune_with(device, refit="exact")
    launches = select_step_cuda.launches
    if launches != 3 * len(k_sel) or not k_sel:
        raise AssertionError(f"optimize_live: {launches} select_step "
                             f"launches for {len(k_sel)} selections (want "
                             "3 each)")
    plain, p_sel, p_wall = _tune_with(device, refit="exact",
                                      fused_selector="ref")
    if json.dumps(kern, sort_keys=True, default=str) != json.dumps(
            plain, sort_keys=True, default=str):
        raise AssertionError("optimize_live: the kernel path and the plain "
                             "path disagree")
    _line("extensions", part="live_kernel", refit="exact", la=2,
          points=autotune.build_space(True).n_points,
          probes=len(kern["explored"]),
          censored=len(kern["censored"]), steps=len(k_sel),
          launches=launches, wall_s=f"{k_wall:.3f}",
          steps_per_s=f"{len(k_sel) / k_wall:.3f}",
          mean_select_s=f"{st_.mean(k_sel):.4f}",
          plain_steps=len(p_sel), plain_wall_s=f"{p_wall:.3f}",
          plain_mean_select_s=f"{st_.mean(p_sel):.4f}",
          recommended=kern["recommended"], equal_plain=True)
    _line("extensions", phase_s=f"{time.perf_counter() - t0:.1f}")
    return launches


# --------------------------------------------------------------------------- #
# Phase 12: training, and the flash-attention backward kernel
# --------------------------------------------------------------------------- #
GOLDEN_TRAIN = ROOT / "src" / "repro_torch" / "testdata" / "golden_train.json"
GOLDEN_TRAIN_SSM = (ROOT / "src" / "repro_torch" / "testdata"
                    / "golden_train_ssm.json")
# The backward kernel's shapes: (label, B, H, KH, S, T, D, causal, window,
# softcap, scale; None: D^-0.5).
BWD_CASES = (
    ("gemma-2b train: MQA, causal", 1, 8, 1, 2048, 2048, 256, True, None,
     None, None),
    ("gemma2-9b: causal, window 4096, softcap 50", 1, 16, 8, 4608, 4608,
     256, True, 4096, 50.0, 256 ** -0.5),
    ("hubert-xlarge: D 80, non-causal", 1, 16, 16, 1000, 1000, 80, False,
     None, None, None),
    ("deepseek-v3 MLA: D 192, H 128", 1, 128, 128, 2048, 2048, 192, True,
     None, None, None),
    ("GQA group 6: H 48, KH 8, D 128", 1, 48, 8, 2048, 2048, 128, True,
     None, None, None),
    ("zamba2-7b train: the shared attention, D 112", 1, 32, 32, 2048, 2048,
     112, True, None, None, None),
    ("edge: S 1100, T 700 off the tiles, D 100, window 300, dead rows", 1,
     4, 2, 1100, 700, 100, True, 300, None, None),
)
# Each gradient of the kernel within BWD_TOL x its largest magnitude of the
# plain backward evaluated in float64 on the same inputs (the forward's o
# and lse included): float32 sums over up to S x group terms a gradient.
BWD_TOL = 1e-4
TRAIN = dict(arch="gemma-2b", batch=2, seq=2048, microbatches=2, steps=4)
# Step 0 through the kernels against the same step with force="ref" (the
# plain attention, and for xlstm-125m the plain scan) on the card:
# relative gaps of the loss and of the gradient norm, and the largest gap
# of an attention projection's gradient entry over the largest entry of
# that gradient (gemma-2b).  xlstm-125m's mLSTM projections and gates
# (wq, wk, wv, wi, wf) are held by XLSTM_STEP0_F64_TOL instead.
TRAIN_REF_RTOL = {"loss": 1e-5, "grad_norm": 1e-4, "attn_grads": 1e-4}
# xlstm-125m's step 0 against a float64 witness on the card: the same step
# with the parameters in float64, compute_dtype float64 and the plain scan
# under autograd (each cast on the path keeps float64: ``layers.wide``).
# For each mLSTM projection's and gate's gradient (wq, wk, wv, wi, wf), the
# largest gap over the witness's largest entry: the kernel path's, the
# force="ref" path's (the plain float32 scan takes cum_i - cum_j in float32
# and loses digits over a chunk, as its forward does: SSM_PLAIN_TOL), and
# the two float32 paths' gap to each other.
# Set from the first run's readings (NVIDIA H100 80GB HBM3): the kernel
# path 1.1e-4 at most (block 0's wf; 1e-5 to 2e-5 on wq, wk, wv, wi), the
# plain path 9.4e-3 (block 8, under the sLSTM block 7; 1.2e-4 at most above
# it, where the forget gates' gradients sit near float32's noise), their
# gap 9.4e-3.  About twice to three times each.
XLSTM_STEP0_F64_TOL = {"kernel": 3e-4, "plain": 2e-2, "gap": 2e-2}
# golden_train.json: the port on the card against the JAX package's
# trajectory on the CPU (losses, gradient norms and learning rates
# relative; each leaf's sampled entries absolute, about a tenth of the
# learning rate: a gradient entry near zero whose sign differs moves its
# weight by 2 lr in Adam's first step; each leaf's sum within 1e-5 of its
# sum of magnitudes).
GOLDEN_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "lr": 1e-6,
                    "sample": 1e-4, "sum": 1e-5}
# golden_train_ssm.json (zamba2-smoke, xlstm-125m-smoke): the same, but
# the gradient norm and the leaves' sums looser.  Two correct float32
# evaluations of these losses lie up to 1.9e-5 of a leaf's largest
# gradient apart (tests/test_torch_train_ssm.py), and Adam divides each
# update by its gradient's size: the port on the CPU, whose arithmetic is
# the plain version's, lies 1.2e-5 from JAX's third gradient norm
# (zamba2-smoke) and 7.2e-5 of a leaf's sum of magnitudes from its sum
# (the sLSTM bias of xlstm-125m-smoke, whose entries' gradients are near
# float32's noise, through plain autograd).  Four times those gaps.
GOLDEN_TRAIN_SSM_TOL = dict(GOLDEN_TRAIN_TOL, grad_norm=5e-5, sum=3e-4)


def _bwd_plain64(q, k, v, o, lse, do, kw):
    """The plain backward evaluated in float64, one KV head's query group
    at a time (the group's [S, T] float64 scores, not the whole call's)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    g = q.shape[1] // k.shape[1]
    out = [torch.empty(x.shape, dtype=torch.float64, device=x.device)
           for x in (q, k, v)]
    for j in range(k.shape[1]):
        qs, ks = slice(j * g, (j + 1) * g), slice(j, j + 1)
        parts = attention_bwd_ref(*(x.double() for x in (
            q[:, qs], k[:, ks], v[:, ks], o[:, qs], lse[:, qs], do[:, qs])),
            **kw)
        out[0][:, qs], out[1][:, ks], out[2][:, ks] = parts
    return out


def _library_backward(q, k, v, do, kw):
    """The library's backward of the same attention, on a graph built
    once: SDPA's, or a compiled ``flex_attention``'s where there is a
    window or a softcap.  Returns (label, a call of the backward; None
    where the run does not ask for the flex yardstick)."""
    import torch
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    if kw["window"] is None and kw["softcap"] is None:
        label = "SDPA backward"
        o = torch.nn.functional.scaled_dot_product_attention(
            *xs, is_causal=kw["causal"], scale=kw["scale"],
            enable_gqa=k.shape[1] != q.shape[1])
    else:
        label = "compiled flex_attention backward"
        fwd = _flex_attention(*xs, causal=kw["causal"], window=kw["window"],
                              softcap=kw["softcap"], scale=kw["scale"])
        if fwd is None:
            return "none: the flex yardstick runs with --only flex", None
        o = fwd()
    return label, lambda: torch.autograd.grad(o, xs, do, retain_graph=True)


def _bwd_case(device, i, case):
    """One backward shape: driven through the op (forward and backward
    launches counted), the kernel against the float64 plain backward and
    itself (bitwise), with its plan, timed from a CUDA graph beside each
    of its kernels, the float32 plain backward, the library's backward
    and the bound (float32, and split TF32 beside it)."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    label, b, h, kh, s, t, d, causal, window, softcap, scale = case
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    gen = torch.Generator(device=device).manual_seed(31 + i)
    q = torch.randn((b, h, s, d), generator=gen, device=device)
    k = torch.randn((b, kh, t, d), generator=gen, device=device)
    v = torch.randn((b, kh, t, d), generator=gen, device=device)
    do = torch.randn((b, h, s, d), generator=gen, device=device)
    fa.flash_attention_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    via_op = torch.autograd.grad(flash_attention(*xs, **kw), xs, do)
    launches = {"forward": fa.flash_attention_cuda.launches,
                "backward": fa.flash_attention_bwd_cuda.launches}
    prep, (o, lse), keep = fa.prepare(q, k, v, want_lse=True, **kw)
    fa.launch(prep)
    bprep, got, bkeep = fa.prepare_bwd(q, k, v, o, lse, do, **kw)
    fa.launch_bwd(bprep)
    _, again, keep2 = fa.prepare_bwd(q, k, v, o, lse, do, **kw)
    fa.launch_bwd(_)
    plan = fa.bwd_plan(b, h, kh, s, t, d, causal, window)
    torch.cuda.synchronize(device)
    bitwise = (all(torch.equal(a, c) for a, c in zip(got, again))
               and all(torch.equal(a, c) for a, c in zip(got, via_op)))
    del again, keep2, via_op, xs
    want = _bwd_plain64(q, k, v, o, lse, do, kw)
    errs = [(a.double() - w).abs().max().item() for a, w in zip(got, want)]
    tols = [BWD_TOL * w.abs().max().item() for w in want]
    plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    plain_errs = [(a.double() - w).abs().max().item()
                  for a, w in zip(plain, want)]
    del want, plain
    ms = _graph_ms(_in_turn(fa.launch_bwd, [bprep], device), n=5, reps=4)
    launch_ms = _launch_ms(lambda: fa.launch_bwd(bprep), n=5, warmup=1)
    kernel_ms = {name: _launch_ms(lambda bit=bit: fa.launch_bwd(bprep, bit),
                                  n=5, warmup=1)
                 for name, bit in fa.BWD_PHASES.items()
                 if name != "reduce" or plan.n_split > 1}
    plain_ms = _median_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                    **kw), reps=3, warmup=1)
    lib, lib_ms = None, None
    if not label.startswith("edge"):
        try:
            lib, call = _library_backward(q, k, v, do, kw)
            lib_ms = None if call is None else _median_ms(call, reps=5,
                                                          warmup=2)
            del call
        except Exception as exc:   # a yardstick only: say why, go on
            lib = f"failed: {type(exc).__name__}: {str(exc)[:120]}"
    # Five products of 2.D a live pair (kernel.cost_bwd).
    ops, nbytes = fa.cost_bwd(q, k, v, causal=causal, window=window)
    # The yardstick: the products in float32 at the CUDA cores' rate.
    # Beside it, the kernel's own form: split TF32 on the tensor cores,
    # three products for each, as _ssm_bound counts ssm_scan's.
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / \
        HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    row = dict(kernel="flash_attention_bwd", case=label,
               max_abs_err=max(errs), errs_dq_dk_dv=errs,
               tols=tols, plain_f32_errs=plain_errs, ms=ms,
               launch_ms=launch_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library=lib,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bound_split_tf32_ms=max(tf32_ms, bytes_ms),
               launches=launches, bitwise_repeat=bitwise,
               n_split=plan.n_split, workspace_bytes=plan.workspace_bytes,
               B=b, H=h, KH=kh, S=s, T=t, D=d)
    _line("train", **{k_: (_fmt(k_, v_) if not isinstance(v_, list)
                           else json.dumps(v_)) for k_, v_ in row.items()})
    failures = []
    if not all(e <= tol for e, tol in zip(errs, tols)):
        failures.append(f"{label}: errors {errs} over {tols}")
    if not bitwise:
        failures.append(f"{label}: two runs differ")
    if launches != {"forward": 1, "backward": 1}:
        failures.append(f"{label}: launches {launches}")
    del prep, keep, bprep, bkeep, got, o, lse
    torch.cuda.empty_cache()
    return row, failures


def _train_flags(meta):
    from repro_torch.models import RuntimeFlags
    return RuntimeFlags(attn_impl=meta["attn_impl"],
                        loss_chunks=meta["loss_chunks"],
                        compute_dtype="float32",
                        microbatches=meta["microbatches"],
                        grad_compress=meta["grad_compress"])


def param_summary(params, n_samples: int = 16) -> dict:
    """Each leaf's float64 sum, sum of magnitudes and ``n_samples``
    entries evenly spaced over its flat index (by the leaf's path,
    "a/b/c"): what ``golden_train.json`` holds of the final parameters."""
    import numpy as np
    from repro_torch.models.params import tree_leaves
    out = {}
    for path, leaf in zip(_leaf_paths(params), tree_leaves(params)):
        a = np.asarray(leaf.detach().cpu().double().numpy()
                       if hasattr(leaf, "detach") else leaf,
                       np.float64).ravel()
        idx = np.linspace(0, a.size - 1, min(a.size, n_samples)).astype(int)
        out[path] = {"sum": float(a.sum()), "abs_sum": float(np.abs(a).sum()),
                     "sample": [float(x) for x in a[idx]]}
    return out


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in sorted(tree.items())
                for p in _leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def train_golden_run(meta, device):
    """The golden trajectory's steps through the port on ``device``: the
    smoke config's numpy weights (``convert.numpy_params``), zero moments,
    ``SyntheticLM``'s batches and ``make_train_step``.  Returns the
    per-step loss, grad_norm and lr and the final parameters' summary
    (:func:`param_summary`)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    cfg = get_smoke_config(meta["arch"])
    model = build_model(cfg)
    flags = _train_flags(meta)
    opt = AdamWConfig(**meta["opt"])
    weights = convert.numpy_params(model.specs(), meta["param_seed"])
    state = convert.train_state_from_numpy(
        weights, *_zero_moments(weights), 0, device=device)
    step = make_train_step(model, flags, opt)
    data = SyntheticLM(cfg, batch=meta["batch"], seq=meta["seq"],
                       seed=meta["data_seed"], device=device)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(meta["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    out["params"] = param_summary(state.params)
    return out


def _zero_moments(weights):
    """Zero first and second moments of a tree of numpy weights."""
    import numpy as np
    from repro_torch.models.params import tree_map
    zero = lambda a: np.zeros(np.shape(a), np.float32)
    return tree_map(zero, weights), tree_map(zero, weights)


def compare_golden_train(got, want, tol=GOLDEN_TRAIN_TOL):
    """The largest gaps of ``got`` (from :func:`train_golden_run`) against
    the golden file's ``want``, each over its tolerance in ``tol``:
    {name: (gap, limit)}; a failed comparison has a gap above its
    limit."""
    out = {}
    for key in ("loss", "grad_norm", "lr"):
        gaps = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(got[key], want[key])]
        out[key] = (max(gaps), tol[key])
        if len(got[key]) != len(want[key]):
            out[key] = (float("inf"), tol[key])
    if set(got["params"]) != set(want["params"]):
        out["leaves"] = (float("inf"), 0.0)
        return out
    sample, total = 0.0, 0.0
    for name, w in want["params"].items():
        g = got["params"][name]
        sample = max([sample] + [abs(a - b) for a, b in
                                 zip(g["sample"], w["sample"])])
        total = max(total, abs(g["sum"] - w["sum"]) / max(w["abs_sum"],
                                                          1e-30))
    out["sample"] = (sample, tol["sample"])
    out["sum"] = (total, tol["sum"])
    return out


def _train_gemma(device):
    """gemma-2b at full width and depth: step 0's loss and gradient norm
    through the kernels and with the plain attention (``force="ref"``),
    then ``TRAIN["steps"]`` donated steps with the flash launches counted
    (18 layers x 2 microbatches = 36 forward and 36 backward a step), the
    step seconds, tokens/s, peak memory and, over one more step under the
    profiler, the idle share."""
    import functools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models import attention as attn_mod
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.train.step import (loss_and_grads, make_train_state,
                                        make_train_step)

    spec = TRAIN
    cfg = get_config(spec["arch"])
    model = build_model(cfg)
    # The launcher's flags and optimizer (repro_torch.launch.train).
    flags = RuntimeFlags(attn_impl="chunked", loss_chunks=4,
                         compute_dtype="float32",
                         microbatches=spec["microbatches"])
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(spec["steps"] // 20, 5),
                      total_steps=spec["steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=device
                                                    ).manual_seed(0),
                             opt, flags, device=device)
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"], seed=0,
                       device=device)
    torch.cuda.synchronize(device)
    _line("train", arch=cfg.name, params=model.n_params(),
          layers=cfg.n_layers, d_model=cfg.d_model, batch=spec["batch"],
          seq=spec["seq"], microbatches=spec["microbatches"],
          init_s=f"{time.perf_counter() - t0:.1f}")

    batch0 = data(0)

    def step0():
        """Step 0's loss, gradient norm and the attention projections'
        gradients (the leaves the attention backward feeds first), and the
        flash launches it made."""
        fa.flash_attention_cuda.launches = 0
        fa.flash_attention_bwd_cuda.launches = 0
        loss, _, grads = loss_and_grads(model, flags, state.params, batch0)
        attn = {k: g.clone() for k, g in grads["layers"]["attn"].items()}
        out = (loss.item(), global_norm(grads).item())
        del grads
        return out, attn, (fa.flash_attention_cuda.launches,
                           fa.flash_attention_bwd_cuda.launches)

    kern, kern_attn, kern_launches = step0()
    plain_attention = attn_mod.flash_attention
    attn_mod.flash_attention = functools.partial(plain_attention,
                                                 force="ref")
    try:
        ref, ref_attn, ref_launches = step0()
    finally:
        attn_mod.flash_attention = plain_attention
    names = ("loss", "grad_norm")
    gaps = {key: abs(a - b) / abs(b) for key, a, b in zip(names, kern, ref)}
    # Each attention projection's gradient, entry by entry, against its
    # largest magnitude.
    gaps["attn_grads"] = max(
        ((kern_attn[k] - g).abs().max() / g.abs().max()).item()
        for k, g in ref_attn.items())
    del kern_attn, ref_attn
    _line("train", **{f"step0_{k}": v for k, v in zip(names, kern)},
          **{f"step0_{k}_ref": v for k, v in zip(names, ref)},
          launches=json.dumps(kern_launches),
          launches_ref=json.dumps(ref_launches),
          rel_gap=json.dumps(gaps), rtol=json.dumps(TRAIN_REF_RTOL))
    remat, remat_failures = _train_remat(device, model, flags, state.params,
                                         batch0)

    step = make_train_step(model, flags, opt, donate=True)
    # (b)'s peak is that of the donated steps ((k) reset the counter).
    torch.cuda.reset_peak_memory_stats(device)
    fa.flash_attention_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    losses, norms, times = [], [], []
    for i in range(spec["steps"]):
        t1 = time.perf_counter()
        state, metrics = step(state, data(i))
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t1)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = {"forward": fa.flash_attention_cuda.launches,
                "backward": fa.flash_attention_bwd_cuda.launches}
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    step_s = statistics.median(times[1:])
    _line("train", part="(k) remat", arch=cfg.name, card=json.dumps(_smi()),
          whole_step_peak_gb=f"{peak:.2f}",
          **{f"{m}_{k}": (json.dumps(v) if isinstance(v, list) else
                          f"{v:.4f}" if isinstance(v, float) else v)
             for m, run in remat.items() for k, v in run.items()})
    busy = _profile(f"{cfg.name} train step",
                    lambda: step(state, data(spec["steps"])), step_s)
    _line("train", losses=json.dumps(losses), grad_norms=json.dumps(norms),
          step_times=json.dumps([round(x, 4) for x in times]),
          step_s=f"{step_s:.4f}",
          tokens_per_s=f"{spec['batch'] * spec['seq'] / step_s:.1f}",
          peak_gb=f"{peak:.2f}", launches=json.dumps(launches),
          idle_share=f"{1 - busy / step_s:.3f}" if busy else "not measured")
    per_step = cfg.n_layers * spec["microbatches"]
    failures = []
    if not all(math.isfinite(x) for x in losses + norms):
        failures.append(f"non-finite loss or norm: {losses}, {norms}")
    if launches != {"forward": per_step * spec["steps"],
                    "backward": per_step * spec["steps"]}:
        failures.append(f"flash launches {launches}, expected {per_step} "
                        f"of each a step")
    if any(gaps[k] > TRAIN_REF_RTOL[k] for k in gaps):
        failures.append(f"step 0 against force='ref': {gaps}")
    if kern_launches != (per_step, per_step) or ref_launches != (0, 0):
        failures.append(f"step 0's flash launches: {kern_launches} through "
                        f"the kernels, {ref_launches} with force='ref'")
    if losses[0] != kern[0]:
        failures.append(f"step 0's loss {losses[0]} differs from its "
                        f"earlier run {kern[0]}: not deterministic")
    failures += remat_failures
    del state, metrics, batch0
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(step_s=step_s, tokens_per_s=spec["batch"] * spec["seq"]
                   / step_s, peak_gb=peak, launches=launches,
                   idle_share=1 - busy / step_s if busy else None,
                   losses=losses, grad_norms=norms, step_times=times,
                   remat=remat)
    return summary, failures


# Part (k): step 0 of gemma-2b's training under each remat policy.
REMAT_POLICIES = ("none", "full", "dots")


def _train_remat(device, model, flags, params, batch):
    """(k) gemma-2b's step 0 (``loss_and_grads`` at TRAIN's shapes, its 2
    microbatches) from one state and batch under ``remat`` none, full and
    dots: the loss and every gradient leaf bitwise equal across the three
    (none's gradients held on the host while the others run), the flash
    launches read around each call (36 forward and 36 backward without
    remat; under full and dots the backward runs each layer's forward
    again: 72 and 36), the peak device memory from a reset before the
    call to the gradients, before AdamW (lower under full than none),
    each call's seconds, and then the memory that a forward of microbatch
    0 holds for its backward (:func:`_held_gb`; what a policy keeps: full
    keeps each layer's input, dots those and the outputs of the products
    without batch dimensions, none everything, so none > dots > full).
    Returns ({policy: run}, failures)."""
    import dataclasses
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.step import loss_and_grads

    runs, failures, want = {}, [], None
    per_step = model.cfg.n_layers * flags.microbatches
    for remat in REMAT_POLICIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        fa.flash_attention_cuda.launches = 0
        fa.flash_attention_bwd_cuda.launches = 0
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(
            model, dataclasses.replace(flags, remat=remat), params, batch)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        launches = [fa.flash_attention_cuda.launches,
                    fa.flash_attention_bwd_cuda.launches]
        leaves = tree_leaves(grads)
        if want is None:
            want = (loss.item(), [g.to("cpu") for g in leaves])
            equal = True
        else:
            equal = loss.item() == want[0] and len(leaves) == len(want[1]) \
                and all(torch.equal(g, h.to(device))
                        for g, h in zip(leaves, want[1]))
        del grads, leaves
        held = _held_gb(device, model, dataclasses.replace(flags, remat=remat),
                        params, batch)
        runs[remat] = dict(seconds=seconds, peak_gb=peak, held_gb=held,
                           launches=launches, loss=loss.item(),
                           bitwise_equal=equal)
        del loss
        expect = [per_step if remat == "none" else 2 * per_step, per_step]
        if launches != expect:
            failures.append(f"(k) remat={remat}: flash launches {launches}, "
                            f"expected {expect}")
        if not equal:
            failures.append(f"(k) remat={remat}: the loss or a gradient "
                            "differs from remat='none'")
    del want
    gc.collect()
    if not runs["full"]["peak_gb"] < runs["none"]["peak_gb"]:
        failures.append(f"(k) peak under full {runs['full']['peak_gb']:.2f} "
                        f"GB not below none's {runs['none']['peak_gb']:.2f}")
    held = [runs[m]["held_gb"] for m in ("none", "dots", "full")]
    if not held[0] > held[1] > held[2]:
        failures.append(f"(k) memory held for the backward (none, dots, "
                        f"full) {held} GB is not decreasing")
    return runs, failures


def _held_gb(device, model, flags, params, batch):
    """GB of device memory that the forward of ``batch``'s microbatch 0
    under ``flags`` leaves allocated for its backward (the loss's graph),
    read before the graph is dropped."""
    import torch
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.train.step import _microbatch

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    mb = _microbatch(batch, flags.microbatches, 0)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    with torch.enable_grad():
        loss, _ = model.loss(tree_unflatten(params, leaves), mb, flags)
    torch.cuda.synchronize(device)
    held = (torch.cuda.memory_allocated(device) - before) / 1e9
    del loss
    return held


# The dry run on the card's machine: cells through the command, its fake
# process group (a private testing module of torch) and meta tensors
# asking no card.  Their lines report them; the smoke does not depend on
# them (DTensor's strategies differ between torch versions: the first
# cell is the one asked for, the second a serving cell).
DRYRUN_CELLS = (("gemma-2b", "train_4k", "single"),
                ("gemma-2b", "decode_32k", "single"))


def _dryrun_json(cell):
    return ROOT / "build" / "dryrun" / f"{'__'.join(cell)}.json"


def _start_dryrun():
    """Start ``python -m repro_torch.launch.dryrun`` on each of
    DRYRUN_CELLS, all at once (the card hidden from them), each
    cell's JSON of an earlier run deleted first; returns [(cell, process,
    start time)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    for cell in DRYRUN_CELLS:
        _dryrun_json(cell).unlink(missing_ok=True)
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out",
         str(ROOT / "build" / "dryrun")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter())
        for cell in DRYRUN_CELLS]


def _finish_dryrun(started):
    """Wait for the dry runs and print a line each: its exit code and
    seconds, then the JSON's counts and roofline, or its error's last
    line and the port's frames above it."""
    for cell, proc, t0 in started:
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        path = _dryrun_json(cell)
        fields = dict(cell="__".join(cell), rc=proc.returncode,
                      seconds=f"{time.perf_counter() - t0:.1f}")
        res = json.loads(path.read_text()) if path.exists() else {}
        if "roofline" in res:
            fields.update({k: res[k] for k in (
                "chips", "flops_per_device", "bytes_per_device",
                "wire_bytes_per_device", "argument_size_in_bytes",
                "model_flops_ratio", "mfu_upper_bound", "run_s")})
            fields["roofline"] = json.dumps(res["roofline"])
            fields["kernels"] = json.dumps(res["kernels"])
        else:
            lines = (res.get("error") or err).strip().splitlines()
            fields["error"] = json.dumps(lines[-1:])
            fields["frames"] = json.dumps(
                [ln.strip() for ln in lines if "repro_torch" in ln][-6:])
        _line("dryrun", **fields)


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


# Part (j): gemma-2b's train step at TRAIN's shapes on a (1, 1) mesh of
# an NCCL world of one, its first TRAIN_MESH_STEPS steps held bitwise
# against part (b)'s unsharded steps.
TRAIN_MESH_STEPS = 2


def _gemma_train_setup(device):
    """gemma-2b's model, the launcher's flags and optimizer at TRAIN."""
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.optim.adamw import AdamWConfig
    del device
    model = build_model(get_config(TRAIN["arch"]))
    flags = RuntimeFlags(attn_impl="chunked", loss_chunks=4,
                         compute_dtype="float32",
                         microbatches=TRAIN["microbatches"])
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(TRAIN["steps"] // 20, 5),
                      total_steps=TRAIN["steps"])
    return model, flags, opt


def _unsharded_steps(device, n):
    """``n`` donated unsharded steps of gemma-2b from the seeded state: the
    losses, gradient norms and step seconds (part (b)'s, when part (j)
    runs alone)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.step import make_train_state, make_train_step
    model, flags, opt = _gemma_train_setup(device)
    state = make_train_state(model, torch.Generator(device=device
                                                    ).manual_seed(0),
                             opt, flags, device=device)
    data = SyntheticLM(model.cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                       seed=0, device=device)
    step = make_train_step(model, flags, opt, donate=True)
    losses, norms, times = [], [], []
    for i in range(n):
        t1 = time.perf_counter()
        state, metrics = step(state, data(i))
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t1)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, step_times=times)


def _train_mesh(device, ref=None):
    """(j) gemma-2b at full width and depth through the sharded step on a
    (1, 1) ("data", "model") mesh of an NCCL world of one: the state drawn
    whole from the seeded generator and placed by ``state_shardings``,
    each batch by ``batch_shardings``, TRAIN_MESH_STEPS donated steps with
    the flash launches counted (36 forward and 36 backward a step).  Their
    losses and gradient norms must equal ``ref``'s (part (b)'s unsharded
    steps; without it, as with ``--only train_mesh``, the unsharded steps
    run here first, one state at a time) bit for bit.  Then
    ``compressed_psum`` over NCCL on the embedding's leaf (the largest
    gradient), against ``dequantize(quantize(x))`` bitwise.  Returns
    (summary, failures)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import SyntheticLM, make_batch
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize, quantize)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.launch.mesh import ensure_world, make_mesh
    from repro_torch.shard.api import make_rules
    from repro_torch.train.step import (batch_shardings, distribute,
                                        make_train_state, make_train_step,
                                        state_shardings)

    n = TRAIN_MESH_STEPS
    if ref is None:
        ref = _unsharded_steps(device, n)
    started = not dist.is_initialized()
    ensure_world(device)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device)
        rules = make_rules()
        model, flags, opt = _gemma_train_setup(device)
        torch.cuda.reset_peak_memory_stats(device)
        state = make_train_state(model, torch.Generator(device=device
                                                        ).manual_seed(0),
                                 opt, flags, device=device)
        state = distribute(state, state_shardings(model, flags, mesh,
                                                  rules))
        host0 = make_batch(model.cfg, "train", TRAIN["batch"], TRAIN["seq"],
                           seed=0, step=0)
        data = SyntheticLM(model.cfg, batch=TRAIN["batch"], seq=TRAIN["seq"],
                           seed=0, device=device,
                           shardings=batch_shardings(host0, mesh, rules))
        step = make_train_step(model, flags, opt, mesh, rules, donate=True)
        fa.flash_attention_cuda.launches = 0
        fa.flash_attention_bwd_cuda.launches = 0
        losses, norms, times = [], [], []
        for i in range(n):
            t1 = time.perf_counter()
            state, metrics = step(state, data(i))
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t1)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        launches = {"forward": fa.flash_attention_cuda.launches,
                    "backward": fa.flash_attention_bwd_cuda.launches}
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        x = state.params["embed"]["tokens"].to_local()
        t1 = time.perf_counter()
        got = compressed_psum(x, mesh, "data")
        torch.cuda.synchronize(device)
        psum_s = time.perf_counter() - t1
        want = dequantize(*quantize(x))
        psum_equal = bool(torch.equal(got, want))
        psum_shape = list(x.shape)
        del state, metrics, x, got, want
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if started:
            dist.destroy_process_group()
    ref_losses = ref["losses"][:n]
    ref_norms = ref["grad_norms"][:n]
    # The first step of each run builds nothing more (the kernels are
    # built), but its first-call costs differ: compare the later steps.
    step_s = times[-1]
    ref_s = statistics.median(ref["step_times"][1:n]
                              or ref["step_times"][:n])
    _line("train", part="(j) mesh 1x1", mesh=json.dumps([1, 1]),
          backend="nccl", losses=json.dumps(losses),
          grad_norms=json.dumps(norms), losses_unsharded=json.dumps(
              ref_losses), grad_norms_unsharded=json.dumps(ref_norms),
          bitwise_equal=losses == ref_losses and norms == ref_norms,
          step_times=json.dumps([round(t, 4) for t in times]),
          step_s=f"{step_s:.4f}", step_s_unsharded=f"{ref_s:.4f}",
          step_ratio=f"{step_s / ref_s:.4f}", peak_gb=f"{peak:.2f}",
          launches=json.dumps(launches), psum_shape=json.dumps(psum_shape),
          psum_s=f"{psum_s:.4f}", psum_bitwise_equal=psum_equal)
    per_step = model.cfg.n_layers * TRAIN["microbatches"]
    failures = []
    if losses != ref_losses or norms != ref_norms:
        failures.append(f"(j) the mesh-of-one steps' losses {losses} and "
                        f"norms {norms} differ from the unsharded "
                        f"{ref_losses}, {ref_norms}")
    if launches != {"forward": per_step * n, "backward": per_step * n}:
        failures.append(f"(j) flash launches {launches}, expected "
                        f"{per_step} of each a step")
    if not psum_equal:
        failures.append("(j) compressed_psum over NCCL differs from "
                        "dequantize(quantize(x))")
    summary = dict(step_s=step_s, step_s_unsharded=ref_s, peak_gb=peak,
                   launches=launches, psum_s=psum_s)
    return summary, failures


def _train_restart(device):
    """A kill-and-restart cycle through ``run_training`` on
    gemma-2b-smoke: a run that fails at step 9 and resumes from its step-5
    checkpoint ends with parameters and moments bitwise equal to an
    unbroken run's."""
    import shutil
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import RunConfig, run_training
    from repro_torch.train.step import make_train_state, make_train_step

    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                         compute_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    data = SyntheticLM(cfg, batch=4, seq=16, seed=0, device=device)
    fresh = lambda: make_train_state(
        model, torch.Generator(device=device).manual_seed(0), opt, flags,
        device=device)
    step = make_train_step(model, flags, opt)
    root = ROOT / "build" / "train_restart"
    shutil.rmtree(root, ignore_errors=True)
    quiet = lambda *a: None
    cfg_run = dict(total_steps=12, checkpoint_every=5, log_every=100)
    try:
        whole = run_training(step, fresh(), data,
                             CheckpointManager(root / "a", keep=3),
                             RunConfig(**cfg_run), log=quiet)
        ckpt = CheckpointManager(root / "b", keep=3)
        try:
            run_training(step, fresh(), data, ckpt,
                         RunConfig(**cfg_run, fail_at_step=9), log=quiet)
            raise AssertionError("the injected failure did not happen")
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
        ckpt.wait()
        resumed = run_training(step, fresh(), data, ckpt,
                               RunConfig(**cfg_run), log=quiet)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    pairs = list(zip(tree_leaves(whole["state"]),
                     tree_leaves(resumed["state"])))
    equal = all(torch.equal(a, b) for a, b in pairs)
    _line("train", restart="fail at 9, resume from 5", steps=12,
          leaves=len(pairs), bitwise_equal=equal)
    return [] if equal else ["the resumed run's state differs from the "
                             "unbroken run's"]


def _train_golden(device):
    """gemma-2b-smoke's steps against ``golden_train.json``."""
    golden = json.loads(GOLDEN_TRAIN.read_text())
    gaps = compare_golden_train(train_golden_run(golden["meta"], device),
                                golden)
    _line("train", golden=GOLDEN_TRAIN.name, config=golden["meta"]["arch"],
          steps=golden["meta"]["steps"], gaps=json.dumps(gaps))
    return [f"golden {k}: {g} over {lim}" for k, (g, lim) in gaps.items()
            if not g <= lim]


def _train_guard(device):
    """The model ops without a backward kernel (decode_attention: training
    has no decode) refuse CUDA tensors that require grad, before any
    launch.  ssm_scan has its backward kernel (part f)."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ops import decode_attention

    g = lambda *shape: torch.randn(shape, device=device, requires_grad=True)
    calls = {"decode_attention": (dk.decode_attention_cuda,
                                  lambda: decode_attention(
                                      g(1, 4, 16), g(1, 2, 64, 16),
                                      g(1, 2, 64, 16), 40))}
    failures = []
    for name, (counter, call) in calls.items():
        before = counter.launches
        try:
            call()
            failures.append(f"{name} accepted CUDA tensors that require "
                            f"grad")
        except NotImplementedError as exc:
            _line("train", guard=name, raised=json.dumps(str(exc)[:60]))
        if counter.launches != before:
            failures.append(f"{name} launched before refusing")
    return failures


# (f) The scan's backward kernel: (label, B, L, H, N, P, chunk, k/q
# broadcast over the heads, initial state, dS_final, zero gates).
SSM_BWD_CASES = (
    ("zamba2-7b layer 0: B 1, L 2048, H 112, N 64, P 64, k/q broadcast", 1,
     2048, 112, 64, 64, 256, True, False, False, False),
    ("xlstm-125m mLSTM: B 4, L 2048, H 4, N 384, P 385", 4, 2048, 4, 384,
     385, 256, False, False, False, False),
    ("edge: L 1100, initial state, dS_final, zero gates", 2, 1100, 3, 48,
     65, 256, False, True, True, True),
)
# (g), (h): full width; zamba2-7b's depth cut to the deepest 6 s + 3 whose
# float32 state (parameters, gradient sums, two moments), activations and
# AdamW's temporaries stay under 72 GB of the card's 80 (27 layers ran out
# of the card's memory in AdamW's update on the H100).
# xlstm-125m takes 2 steps (its step, ~11 s, is the sLSTM's host loop):
# step_s is the second's, after step 0's compile and warm-up.
TRAIN_SSM = (dict(arch="xlstm-125m", batch=4, seq=2048, microbatches=1,
                  steps=2, layers=None, cut_steps=3),
             dict(arch="zamba2-7b", batch=2, seq=2048, microbatches=2,
                  steps=3, layers=21))


def _ssm_bwd_inputs(device, i, case):
    """Seeded inputs of one backward case, as the models hand them over:
    Mamba2's log-decay dt·a (dt a softplus, a = -exp) and gate dt, k and q
    one row broadcast over the heads; the mLSTM's log-sigmoid forget gate,
    exponential input gate, k scaled by N^-1/2 and v's ones column."""
    import torch
    import torch.nn.functional as F
    _, b, l, h, n, p, chunk, bcast, s0, dfin, zeros = case
    gen = torch.Generator(device=device).manual_seed(71 + i)
    r = lambda *s: torch.randn(s, generator=gen, device=device)
    if bcast:
        k = r(b, l, 1, n).expand(b, l, h, n)
        q = r(b, l, 1, n).expand(b, l, h, n)
        dt = F.softplus(r(b, l, h) - 1.0)
        ld, g = dt * -torch.exp(0.5 * r(h)), dt
    else:
        k, q = r(b, l, h, n) * n ** -0.5, r(b, l, h, n)
        ld = F.logsigmoid(r(b, l, h) + 3.0)
        g = torch.exp(torch.clamp_max(r(b, l, h), 8.0))
    v = r(b, l, h, p)
    if not bcast:
        v[..., -1] = 1.0
    if zeros:
        g[:, ::7] = 0.0
        g[:, -1] = 0.0
    return (k, v, q, ld, g), dict(
        chunk=chunk, initial_state=r(b, h, n, p) if s0 else None), \
        r(b, l, h, p), r(b, h, n, p) if dfin else None


def _ssm_bwd_case(device, i, case):
    """One backward shape: driven through the op (forward and backward
    launches counted), the kernel against the plain backward evaluated in
    float64 (each gradient within BWD_TOL of its largest magnitude, the
    forward-class figure SSM_RTOL / SSM_ATOL reported beside it) and itself
    (bitwise), timed beside each of its kernels, the
    float32 and float64 plain backwards and the bound.  ``ms`` is host
    launched (five calls between CUDA events): a call takes milliseconds,
    its six launches microseconds."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.ssm_scan.ref import linear_scan_bwd_ref

    label = case[0]
    args, kw, dy, dfin = _ssm_bwd_inputs(device, i, case)
    names = ("dk", "dv", "dq", "d_log_decay", "d_gate", "d_initial_state")
    sk.ssm_scan_cuda.launches = 0
    sk.ssm_scan_bwd_cuda.launches = 0
    leaves = [a.clone().requires_grad_(True) for a in args]
    s0 = kw["initial_state"]
    s0l = None if s0 is None else s0.clone().requires_grad_(True)
    y, s = linear_scan(*leaves, chunk=kw["chunk"], initial_state=s0l)
    loss = (y * dy).sum() + (0 if dfin is None else (s * dfin).sum())
    via_op = torch.autograd.grad(loss, leaves + ([s0l] if s0l is not None
                                                 else []))
    launches = {"forward": sk.ssm_scan_cuda.launches,
                "backward": sk.ssm_scan_bwd_cuda.launches}
    del y, s, loss, leaves
    _, s_fin, states = sk.ssm_scan_cuda(*args, want_states=True, **kw)
    bkw = dict(kw, states=states, final_state=s_fin)
    prep, got, keep = sk.prepare_bwd(*args, dy, dfin, **bkw)
    sk.launch_bwd(prep)
    prep2, again, keep2 = sk.prepare_bwd(*args, dy, dfin, **bkw)
    sk.launch_bwd(prep2)
    torch.cuda.synchronize(device)
    bitwise = (all(torch.equal(a, c) for a, c in zip(got, again))
               and all(torch.equal(a, c) for a, c in zip(got, via_op)))
    del prep2, again, keep2, via_op
    f64 = lambda t: None if t is None else t.double()
    want = linear_scan_bwd_ref(*map(f64, args), f64(dy), f64(dfin),
                               chunk=kw["chunk"], initial_state=f64(s0))
    if s0 is None:
        got, want = got[:5], want[:5]
    errs, tols, fwd_class = {}, {}, {}
    for name, a, w in zip(names, got, want):
        d = (a.double() - w).abs()
        top = w.abs().max().item()
        errs[name] = d.nan_to_num(nan=float("inf")).max().item()
        tols[name] = BWD_TOL * top
        fwd_class[name] = int((~(d <= SSM_RTOL * w.abs()
                                 + SSM_ATOL * top)).sum())
    del want
    t64 = time.perf_counter()
    linear_scan_bwd_ref(*map(f64, args), f64(dy), f64(dfin),
                        chunk=kw["chunk"], initial_state=f64(s0))
    torch.cuda.synchronize(device)
    plain64_ms = (time.perf_counter() - t64) * 1e3
    plain = lambda: linear_scan_bwd_ref(*args, dy, dfin, **bkw)
    plain_ms = _median_ms(plain, reps=3, warmup=1)
    ms = _launch_ms(lambda: sk.launch_bwd(prep), n=5, warmup=1)
    kernel_ms = {name: round(_launch_ms(lambda bit=bit: sk.launch_bwd(
        prep, bit), n=5, warmup=1), 5)
        for name, bit in sk.BWD_PHASES.items()}
    nbytes, recurrence, chunked = sk.work_bwd(
        *args, dy, dfin, chunk=kw["chunk"],
        initial_state=kw.get("initial_state"), states=states)
    ops = min(recurrence, chunked)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b, l, h, n = args[0].shape
    row = dict(kernel="ssm_scan_bwd", case=label, max_abs_err=max(
        errs.values()), errs=errs, tols=tols,
        outside_forward_class=fwd_class, ms=ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, plain64_ms=plain64_ms,
        library_ms=None,
        library="none: no single PyTorch call computes it",
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        bound_split_tf32_ms=max(3 * chunked / TF32_OPS_PER_S * 1e3,
                                bytes_ms),
        useful_tflops=chunked / ms * 1e-9,
        plan=sk.plan_bwd(b, l, h, n, args[1].shape[-1], kw["chunk"]
                         )._asdict(),
        ops=ops, ops_algorithm="recurrence" if recurrence <= chunked
        else "chunked", ops_recurrence=recurrence, ops_chunked=chunked,
        bytes=nbytes, launches=launches, bitwise_repeat=bitwise,
        B=b, L=l, H=h, N=n, P=args[1].shape[-1], chunk=kw["chunk"])
    _line("train", **{k_: _fmt(k_, v_) for k_, v_ in row.items()})
    failures = []
    bad = {k_: e for k_, e in errs.items() if not e <= tols[k_]}
    if bad:
        failures.append(f"{label}: errors {bad} over {tols}")
    if not bitwise:
        failures.append(f"{label}: two runs differ")
    if launches != {"forward": 1, "backward": 1}:
        failures.append(f"{label}: launches {launches}")
    del prep, keep, got, states, s_fin
    torch.cuda.empty_cache()
    return row, failures


def _scan_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssm_scan import kernel as sk
    return {"ssm_scan": sk.ssm_scan_cuda.launches,
            "ssm_scan_bwd": sk.ssm_scan_bwd_cuda.launches,
            "flash_attention": fa.flash_attention_cuda.launches,
            "flash_attention_bwd": fa.flash_attention_bwd_cuda.launches}


def _zero_scan_counts():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssm_scan import kernel as sk
    for fn in (sk.ssm_scan_cuda, sk.ssm_scan_bwd_cuda,
               fa.flash_attention_cuda, fa.flash_attention_bwd_cuda):
        fn.launches = 0


def _slstm_timer(device, spent):
    """A wrapper of ``slstm_block`` that adds to ``spent`` each call's
    forward seconds and, through hooks on its output's and its input's
    gradients, its backward's (host clock, synchronized)."""
    import torch
    from repro_torch.models import xlstm_model as xm
    real = xm.slstm_block

    def mark(key):
        def hook(grad):
            torch.cuda.synchronize(device)
            now = time.perf_counter()
            if key == "out":
                spent["_t"] = now
            else:
                spent["backward"] += now - spent.pop("_t")
        return hook

    def timed(p, x, cfg, state=None):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out, st = real(p, x, cfg, state)
        torch.cuda.synchronize(device)
        spent["forward"] += time.perf_counter() - t
        if out.requires_grad and x.requires_grad:
            out.register_hook(mark("out"))
            x.register_hook(mark("in"))
        return out, st

    return real, timed


# The mLSTM projections and gates whose gradients step 0 holds.
SCAN_GRAD_KEYS = ("wq", "wk", "wv", "wi", "wf")


def _step0_f64(model, flags, params, batch, keys):
    """The float64 witness of xlstm-125m's step 0 on the card -> (loss,
    {"block/key": gradient}) of the mLSTM blocks' ``keys``: the
    parameters cast, compute_dtype float64 and the scan's plain version
    under autograd (``linear_scan_ref``: the op's differentiable path takes
    float32 only)."""
    import dataclasses
    import torch
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.ssm_scan.ref import linear_scan_ref
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xl_mod
    from repro_torch.models.params import tree_map
    p64 = tree_map(lambda t: t.detach().double().requires_grad_(True),
                   params)
    flags64 = dataclasses.replace(flags, compute_dtype="float64")
    want = [(f"{i}/{k}", blk[k]) for i, blk in enumerate(p64["blocks"])
            for k in keys if k in blk]
    ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
        linear_scan_ref
    try:
        with torch.enable_grad():
            loss, _ = model.loss(p64, batch, flags64)
            grads = torch.autograd.grad(loss, [t for _, t in want])
    finally:
        ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
            linear_scan
    out = {name: g for (name, _), g in zip(want, grads)}
    del p64, grads
    return loss.item(), out


def _train_ssm(device, spec):
    """One arch of the hybrid or ssm family trained at full width (depth
    cut where ``spec["layers"]`` says): seeded weights, AdamW and the
    launcher's flags; for xlstm-125m step 0 through the kernels against
    the same step with ``force="ref"`` (the plain scan and attention),
    both against the float64 witness (:func:`_step0_f64`), and the sLSTM
    blocks' share of step 0; then ``spec["steps"]`` donated steps
    with the launches counted, step seconds, tokens/s and peak memory."""
    import dataclasses
    import functools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xl_mod
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.models import xlstm_model as xm
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.train.step import (loss_and_grads, make_train_state,
                                        make_train_step)

    cfg = get_config(spec["arch"])
    reduced = None
    if spec["layers"] is not None:
        reduced = {"n_layers": [cfg.n_layers, spec["layers"]]}
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    if "cut_steps" in spec:
        reduced = dict(reduced or {},
                       steps=[spec["cut_steps"], spec["steps"]])
    model = build_model(cfg)
    flags = RuntimeFlags(attn_impl="chunked", loss_chunks=4,
                         compute_dtype="float32",
                         microbatches=spec["microbatches"])
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(spec["steps"] // 20, 5),
                      total_steps=spec["steps"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = make_train_state(model, torch.Generator(device=device
                                                    ).manual_seed(0),
                             opt, flags, device=device)
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"], seed=0,
                       device=device)
    torch.cuda.synchronize(device)
    _line("train", arch=cfg.name, params=model.n_params(),
          layers=cfg.n_layers, reduced=json.dumps(reduced),
          d_model=cfg.d_model, batch=spec["batch"], seq=spec["seq"],
          microbatches=spec["microbatches"],
          init_s=f"{time.perf_counter() - t0:.1f}")
    failures, extra = [], {}
    if cfg.family == "ssm":
        batch0 = data(0)
        spent = {"forward": 0.0, "backward": 0.0}
        real, timed = _slstm_timer(device, spent)

        def step0():
            _zero_scan_counts()
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            loss, _, grads = loss_and_grads(model, flags, state.params,
                                            batch0)
            out = (loss.item(), global_norm(grads).item())
            wall = time.perf_counter() - t1
            scan = {f"{i}/{k}": g.clone() for i, blk in
                    enumerate(grads["blocks"]) for k, g in blk.items()
                    if k in SCAN_GRAD_KEYS}
            del grads
            return out, scan, _scan_counts(), wall

        xm.slstm_block = timed
        try:
            kern, kern_scan, kern_launches, wall0 = step0()
        finally:
            xm.slstm_block = real
        plain_scan = functools.partial(linear_scan, force="ref")
        plain_attention = attn_mod.flash_attention
        ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = plain_scan
        attn_mod.flash_attention = functools.partial(plain_attention,
                                                     force="ref")
        try:
            ref, ref_scan, ref_launches, _ = step0()
        finally:
            ssm_mod.chunked_linear_scan = linear_scan
            xl_mod.chunked_linear_scan = linear_scan
            attn_mod.flash_attention = plain_attention
        names = ("loss", "grad_norm")
        gaps = {key: abs(a - b) / abs(b)
                for key, a, b in zip(names, kern, ref)}
        t1 = time.perf_counter()
        loss64, wit = _step0_f64(model, flags, state.params, batch0,
                                 SCAN_GRAD_KEYS)
        witness_s = time.perf_counter() - t1
        rel = lambda a, w: ((a.double() - w).abs().max()
                            / w.abs().max()).item()
        scan_gap = {
            "kernel": {k: rel(kern_scan[k], w) for k, w in wit.items()},
            "plain": {k: rel(ref_scan[k], w) for k, w in wit.items()},
            "gap": {k: rel(kern_scan[k], ref_scan[k].double())
                    for k in wit}}
        worst = {k: max(v.values()) for k, v in scan_gap.items()}
        del kern_scan, ref_scan, wit
        slstm_s = spent["forward"] + spent["backward"]
        extra = dict(slstm_forward_s=spent["forward"],
                     slstm_backward_s=spent["backward"],
                     step0_wall_s=wall0, slstm_share=slstm_s / wall0)
        _line("train", arch=cfg.name,
              **{f"step0_{k}": v for k, v in zip(names, kern)},
              **{f"step0_{k}_ref": v for k, v in zip(names, ref)},
              launches=json.dumps(kern_launches),
              launches_ref=json.dumps(ref_launches),
              rel_gap=json.dumps(gaps), rtol=json.dumps(TRAIN_REF_RTOL),
              step0_loss_f64=loss64, witness_s=f"{witness_s:.1f}",
              scan_grads_f64=json.dumps(scan_gap),
              scan_grads_worst=json.dumps(worst),
              scan_grads_tol=json.dumps(XLSTM_STEP0_F64_TOL),
              slstm_forward_s=f"{spent['forward']:.4f}",
              slstm_backward_s=f"{spent['backward']:.4f}",
              step0_wall_s=f"{wall0:.4f}",
              slstm_share=f"{slstm_s / wall0:.3f}")
        if any(gaps[k] > TRAIN_REF_RTOL[k] for k in gaps):
            failures.append(f"{cfg.name} step 0 against force='ref': {gaps}")
        if not all(worst[k] <= XLSTM_STEP0_F64_TOL[k] for k in worst):
            failures.append(f"{cfg.name} step 0's scan gradients against "
                            f"float64: {worst} over {XLSTM_STEP0_F64_TOL}")
        if ref_launches["ssm_scan"] or ref_launches["ssm_scan_bwd"]:
            failures.append(f"{cfg.name} force='ref' launched {ref_launches}")
        del batch0
        # The peak below is the training steps' (the witness's float64
        # step holds more than they do).
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(model, flags, opt, donate=True)
    _zero_scan_counts()
    losses, norms, times = [], [], []
    # The first step's last backward call is the first block's: kept.
    real_prepare, calls = sk.prepare_bwd, []

    def recording(*a, **kw):
        calls[:] = [(a, kw)]
        return real_prepare(*a, **kw)

    sk.prepare_bwd = recording
    for i in range(spec["steps"]):
        t1 = time.perf_counter()
        try:
            state, metrics = step(state, data(i))
        finally:
            sk.prepare_bwd = real_prepare
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t1)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = _scan_counts()
    failures += _check_captured_bwd(device, cfg.name, *calls[0])
    del calls
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    step_s = statistics.median(times[1:])
    tokens_s = spec["batch"] * spec["seq"] / step_s
    # The kernel split and idle share of one more step under the profiler
    # (zamba2-7b; xlstm-125m's step is the sLSTM loop's, timed above).
    busy = None
    if cfg.family == "hybrid":
        busy = _profile(f"{cfg.name} train step",
                        lambda: step(state, data(spec["steps"])), step_s)
        extra["idle_share"] = 1 - busy / step_s if busy else None
    _line("train", arch=cfg.name, losses=json.dumps(losses),
          grad_norms=json.dumps(norms),
          step_times=json.dumps([round(x, 4) for x in times]),
          step_s=f"{step_s:.4f}", tokens_per_s=f"{tokens_s:.1f}",
          peak_gb=f"{peak:.2f}", launches=json.dumps(launches),
          idle_share=f"{1 - busy / step_s:.3f}" if busy else
          "not measured")
    n_scan = sum(k == "mlstm" for k in xm.block_kinds(cfg)) \
        if cfg.family == "ssm" else cfg.n_layers
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers // cfg.attn_every
    per_step = spec["microbatches"] * spec["steps"]
    want = {"ssm_scan": n_scan * per_step, "ssm_scan_bwd": n_scan * per_step,
            "flash_attention": n_attn * per_step,
            "flash_attention_bwd": n_attn * per_step}
    if not all(math.isfinite(x) for x in losses + norms):
        failures.append(f"{cfg.name}: non-finite loss or norm: {losses}, "
                        f"{norms}")
    if launches != want:
        failures.append(f"{cfg.name}: launches {launches}, expected {want}")
    if peak > 72.0:
        failures.append(f"{cfg.name}: peak {peak:.2f} GB over 72 GB")
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(arch=cfg.name, step_s=step_s, tokens_per_s=tokens_s,
                   peak_gb=peak, launches=launches, reduced=reduced, **extra)
    return summary, failures


def _check_captured_bwd(device, arch, args, kw):
    """The backward kernel on a training step's own call (the first
    block's: its inputs, dy and the forward's states) against the plain
    backward evaluated in float64, each gradient within BWD_TOL of its
    largest magnitude; the float32 plain backward's error beside it."""
    import torch
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import linear_scan_bwd_ref
    names = ("dk", "dv", "dq", "d_log_decay", "d_gate")
    prep, got, keep = sk.prepare_bwd(*args, **kw)
    sk.launch_bwd(prep)
    f64 = lambda t: None if t is None else t.double()
    want = linear_scan_bwd_ref(*map(f64, args), chunk=kw["chunk"],
                               initial_state=f64(kw["initial_state"]))
    plain = linear_scan_bwd_ref(*args, **kw)
    errs, plain_errs, tols = {}, {}, {}
    for name, a, p, w in zip(names, got, plain, want):
        tols[name] = BWD_TOL * w.abs().max().item()
        errs[name] = (a.double() - w).abs().nan_to_num(
            nan=float("inf")).max().item()
        plain_errs[name] = (p.double() - w).abs().max().item()
    k, v = args[0], args[1]
    _line("train", arch=arch, captured="first block's backward call",
          shape=json.dumps([*k.shape, v.shape[-1]]),
          k_head_stride=k.stride(2), errs=json.dumps(errs),
          tols=json.dumps(tols), plain_f32_errs=json.dumps(plain_errs))
    del prep, got, keep, want, plain
    torch.cuda.empty_cache()
    bad = {n: e for n, e in errs.items() if not e <= tols[n]}
    return [f"{arch} first block's backward: {bad} over {tols}"] \
        if bad else []


def _train_golden_ssm(device):
    """zamba2-smoke's and xlstm-125m-smoke's steps against
    ``golden_train_ssm.json``."""
    golden = json.loads(GOLDEN_TRAIN_SSM.read_text())["runs"]
    failures = []
    for arch, want in golden.items():
        gaps = compare_golden_train(train_golden_run(want["meta"], device),
                                    want, GOLDEN_TRAIN_SSM_TOL)
        _line("train", golden=GOLDEN_TRAIN_SSM.name, config=arch,
              steps=want["meta"]["steps"], gaps=json.dumps(gaps))
        failures += [f"golden {arch} {k}: {g} over {lim}"
                     for k, (g, lim) in gaps.items() if not g <= lim]
    return failures


def phase_train_ssm(device):
    """(f) the scan's backward kernel at the training shapes, (g)
    xlstm-125m and (h) zamba2-7b (depth cut) trained, (i) the two smoke
    trajectories against ``golden_train_ssm.json``.  Returns (kernel rows,
    the training runs' summaries, failures)."""
    t0 = time.perf_counter()
    rows, failures = [], []
    for i, case in enumerate(SSM_BWD_CASES):
        row, bad = _ssm_bwd_case(device, i, case)
        rows.append(row)
        failures += bad
    _line("train", part="ssm_scan backward kernel",
          part_s=f"{time.perf_counter() - t0:.1f}")
    runs = {}
    for spec in TRAIN_SSM:
        t1 = time.perf_counter()
        summary, bad = _train_ssm(device, spec)
        runs[summary["arch"]] = summary
        failures += bad
        _line("train", part=summary["arch"],
              part_s=f"{time.perf_counter() - t1:.1f}")
    t1 = time.perf_counter()
    failures += _train_golden_ssm(device)
    _line("train", part="golden_train_ssm",
          part_s=f"{time.perf_counter() - t1:.1f}",
          parts_f_to_i_s=f"{time.perf_counter() - t0:.1f}")
    return rows, runs, failures


def phase_train(device):
    """(a) the backward kernel at the zoo's training shapes, (b) gemma-2b's
    train step at full width and depth, (c) a kill-and-restart cycle, (d)
    the golden trajectory, (e) the no-gradient guard, then (f)-(i) of
    :func:`phase_train_ssm` and (j) gemma-2b's sharded step on a mesh of
    one (:func:`_train_mesh`).  Returns (flash backward rows, gemma-2b's
    summary, ssm_scan backward rows, the hybrid and ssm runs' summaries)."""
    t0 = time.perf_counter()
    rows, failures = [], []
    for i, case in enumerate(BWD_CASES):
        row, bad = _bwd_case(device, i, case)
        rows.append(row)
        failures += bad
    _line("train", part="backward kernel",
          part_s=f"{time.perf_counter() - t0:.1f}")
    t1 = time.perf_counter()
    summary, bad = _train_gemma(device)
    failures += bad
    _line("train", part="gemma-2b", part_s=f"{time.perf_counter() - t1:.1f}")
    t1 = time.perf_counter()
    failures += _train_restart(device)
    failures += _train_golden(device)
    failures += _train_guard(device)
    _line("train", part="restart, golden, guard",
          part_s=f"{time.perf_counter() - t1:.1f}")
    ssm_rows, runs, bad = phase_train_ssm(device)
    failures += bad
    t1 = time.perf_counter()
    mesh_run, bad = _train_mesh(device, summary)
    failures += bad
    summary["mesh"] = mesh_run
    _line("train", part="(j) mesh 1x1",
          part_s=f"{time.perf_counter() - t1:.1f}")
    _finish_dryrun(_start_dryrun())
    _line("train", phase_s=f"{time.perf_counter() - t0:.1f}")
    if failures:
        raise AssertionError(f"phase train: {failures}")
    return rows, summary, ssm_rows, runs


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
NO_SPILL = ("select_step_kernel", "flash_bf16_kernel", "flash_tf32_kernel",
            "decode_split_kernel", "decode_combine_kernel",
            "ssm_chunk_state_kernel", "ssm_state_pass_kernel",
            "ssm_chunk_scan_kernel", "masked_argmax_kernel",
            "tree_predict_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel",
            "bwd_reduce_kernel", "ssm_bwd_dstate_kernel",
            "ssm_bwd_carry_kernel", "ssm_bwd_dkdv_kernel",
            "ssm_bwd_dq_sum_kernel")


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
             "flash_attention, decode_attention, ssm_scan), masked_argmax, "
             "the phase batched, service (phase batched's tf-cnn runs, "
             "then phase service), extensions, zoo (the archs of ZOO "
             "served, and the zoo's golden logits), train (the phase "
             "train), flash_bwd (phase train's flash backward kernel "
             "cases alone), train_ssm (phase train's parts f-i: the "
             "ssm_scan backward kernel, xlstm-125m and zamba2-7b trained, "
             "their smoke goldens), ssm_bwd (part f alone), train_mesh "
             "(part j: gemma-2b's sharded step on a mesh of one, after "
             "its unsharded steps), remat (part b, gemma-2b's steps, with "
             "part k: step 0 under remat none, full and dots; and the dry "
             "run's cell) and flex (phase ops' attention cases "
             "with the compiled flex_attention yardstick): build, run "
             "only their checks and times, and print no result line (a "
             "measurement run, not the smoke)")
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
    smi = _smi()
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
                         if k not in ("masked_argmax", "batched", "service",
                                      "extensions", "zoo", "train",
                                      "flash_bwd", "train_ssm", "ssm_bwd",
                                      "flex", "train_mesh", "remat"))
        if "batched" in only:
            phase_kernel(device, tf_job, only_batched=True)
            phase_batched(device, tf_job)
        if "service" in only:
            _, tf_outs = _batched_tf_runs(device, tf_job)
            phase_service(device, tf_job, tf_outs)
        _FLEX["on"] = "flex" in only
        if ops_only or "flex" in only:
            phase_ops(device, tf_job, only=ops_only or (
                "flash_attention", "decode_attention"))
        if "masked_argmax" in only:
            _, failures = argmax_checks(device)
            if failures:
                raise AssertionError(f"masked_argmax: {failures[:3]}")
        if "extensions" in only:
            phase_extensions(device)
        if "zoo" in only:
            phase_zoo(device)
        if "train" in only:
            phase_train(device)
        if "remat" in only:
            failures = _train_gemma(device)[1]
            _finish_dryrun(_start_dryrun())
            if failures:
                raise AssertionError(f"remat: {failures}")
        if "train_mesh" in only:
            t1 = time.perf_counter()
            failures = _train_mesh(device)[1]
            _line("train", part="(j) mesh 1x1 with its unsharded steps",
                  part_s=f"{time.perf_counter() - t1:.1f}")
            if failures:
                raise AssertionError(f"train_mesh: {failures}")
        if "train_ssm" in only:
            failures = phase_train_ssm(device)[2]
            if failures:
                raise AssertionError(f"train_ssm: {failures}")
        if "ssm_bwd" in only:
            failures = []
            for i, case in enumerate(SSM_BWD_CASES):
                failures += _ssm_bwd_case(device, i, case)[1]
            if failures:
                raise AssertionError(f"ssm_bwd: {failures}")
        if "flash_bwd" in only:
            failures = []
            for i, case in enumerate(BWD_CASES):
                failures += _bwd_case(device, i, case)[1]
            if failures:
                raise AssertionError(f"flash_bwd: {failures}")
        return 0
    rows, max_err = phase_kernel(device, tf_job)
    op_rows, op_launches = phase_ops(device, tf_job)
    launches = phase_main(device, tf_job)
    phase_golden(device)
    # The live path's host-bound loops run before the long phases: run
    # after phase model, they took up to 2.4x as long.
    live_launches = phase_extensions(device)
    _, _, tf_outs = phase_batched(device, tf_job)
    service_launches = phase_service(device, tf_job, tf_outs)
    analysis_rows, argmax_launches = phase_analysis(device)
    model_rows, model_launches, _serving = phase_model(device)
    zoo_rows, zoo_launches = phase_zoo(device)
    bwd_rows, train, ssm_bwd_rows, ssm_runs = phase_train(device)
    # Each kernel's launches come from the path that runs it: tree_predict
    # and gh_ei from the ops drive, the model kernels from the zamba2-7b
    # serving run (and each serving path's beside it).
    model_kernels = ("flash_attention", "decode_attention", "ssm_scan")
    op_launches.update({k: model_launches[k] for k in model_kernels})
    op_launches["masked_argmax"] = argmax_launches
    # The depth-2 launch, the one that moves the most bytes, stands for the
    # kernel in the summary line.
    row = next(r for r in rows if r["case"].startswith("d2_")
               and r["case"].endswith("_cens"))
    kernels = [{
        "name": "select_step", "route": "cuda",
        "source": "src/repro_torch/csrc/select_step.cu",
        "replaces": "src/repro/kernels/select_step/kernel.py:255",
        "launches": launches,
        "launches_by_path": {"main": launches, "service": service_launches,
                             "live": live_launches},
        "max_abs_err": max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": {"S": row["S"], "M": row["M"]},
    }] + _op_summary(op_rows + model_rows + zoo_rows + analysis_rows,
                     op_launches)
    paths = {"zamba2-7b": model_launches, **zoo_launches}
    for entry in kernels:
        if entry["name"] in model_kernels:
            entry["launches_by_path"] = {
                arch: n[entry["name"]] for arch, n in paths.items()}
        if entry["name"] == "flash_attention":
            entry["launches_by_path"]["gemma-2b train"] = \
                train["launches"]["forward"]
            entry["launches_by_path"]["gemma-2b train mesh 1x1"] = \
                train["mesh"]["launches"]["forward"]
            for m, run in train["remat"].items():
                entry["launches_by_path"][
                    f"gemma-2b step 0 remat {m}"] = run["launches"][0]
        if entry["name"] in ("ssm_scan", "flash_attention"):
            for arch, run in ssm_runs.items():
                entry["launches_by_path"][f"{arch} train"] = \
                    run["launches"][entry["name"]]
    # The backward kernel's line: gemma-2b's training shape, its launches
    # those of the training run.
    row = bwd_rows[0]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none: no TPU kernel computes it (the reference trains "
                    "through plain jnp attention, "
                    "src/repro/launch/train.py:49)",
        "launches": train["launches"]["backward"],
        "launches_by_path": {"gemma-2b train":
                             train["launches"]["backward"],
                             "gemma-2b train mesh 1x1":
                             train["mesh"]["launches"]["backward"],
                             **{f"gemma-2b step 0 remat {m}":
                                run["launches"][1]
                                for m, run in train["remat"].items()},
                             **{f"{arch} train":
                                run["launches"]["flash_attention_bwd"]
                                for arch, run in ssm_runs.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "case": row["case"],
        "cases": [{k: r[k] for k in ("case", "max_abs_err", "ms",
                                     "launch_ms", "kernel_ms", "plain_ms",
                                     "library_ms", "library", "bound_ms",
                                     "bound_by")} for r in bwd_rows]})
    # The scan's backward: zamba2-7b's layer shape, its launches those of
    # the two training runs (g) and (h).
    row = ssm_bwd_rows[0]
    by_path = {f"{arch} train": run["launches"]["ssm_scan_bwd"]
               for arch, run in ssm_runs.items()}
    kernels.append({
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
        "replaces": "none: no TPU kernel computes it (the Pallas ssm_scan "
                    "has no backward; the reference trains through the "
                    "plain chunked_linear_scan, src/repro/models/ssm.py:38)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in ssm_bwd_rows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "case": row["case"],
        "cases": [{k: r[k] for k in ("case", "max_abs_err", "ms",
                                     "kernel_ms", "plain_ms", "plain64_ms",
                                     "library_ms", "library", "bound_ms",
                                     "bound_by")} for r in ssm_bwd_rows]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
