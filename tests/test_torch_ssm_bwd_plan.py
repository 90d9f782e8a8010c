"""The scan backward kernel's plan and arithmetic, on the CPU.

``csrc/ssm_scan_bwd.cu`` takes the products of its chunk d-state, dq and
dk/dv phases on the tensor cores in split TF32: each float32 operand split
once, as it is staged, into hi (its TF32 rounding) and lo (the TF32
rounding of x - hi), three products lo·hi + hi·lo + hi·hi, a fragment
summing one staged tile (at most 64 of depth) before it is added into
float32 sums; each score tile of a (query tile, key tile) pair is formed
once and feeds both dq (through a workspace of partials, added in
ascending key tile, the diagonal pair's holding dq's carry) and dk̃.
The kernel runs only on the card (``chip_smoke.py`` part (f),
``scripts/ssm_bwd_series.py``).  Here:

(a) ``kernel.plan_bwd`` is a pure function of the shapes (it asks no
    device), its shared memory fits a block at every
    ``chip_smoke.SSM_BWD_CASES`` shape and at chunks 16-640, every case
    takes the one instantiation, and its workspace is what the kernel
    writes;
(b) a model of the kernel's backward in torch float32 (the plan's tiles,
    pairs and promotion points, each k-step of 8 summed exactly and
    rounded into a float32 fragment, the sums in the kernel's order, cum
    and phase 4 in float64) lies within ``chip_smoke.BWD_TOL`` of the
    float64 ``linear_scan_bwd_ref`` for every gradient, d_log_decay
    included, at reduced L for the three case families, while one-term
    TF32 misses that gate.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root: SSM_BWD_CASES, BWD_TOL)
from repro_torch.kernels.ssm_scan import kernel  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    linear_scan_bwd_ref, linear_scan_fwd_ref)
from test_torch_flash_bwd_plan import tf32  # noqa: E402

torch.set_num_threads(1)

SMEM_LIMIT = 227 * 1024          # bytes of shared memory a block may have
CASES = chip_smoke.SSM_BWD_CASES
CASE_IDS = [c[0].split(":")[0] for c in CASES]
T = kernel.BWD_TILE


def _shape(case):
    return case[1:7]                  # B, L, H, N, P, chunk


def test_bwd_plan_is_a_pure_function_of_the_shapes(monkeypatch):
    """The same shapes give the same plan, and computing it asks nothing
    of a device (every query of the card raises)."""
    def refuse(*args, **kwargs):
        raise AssertionError("plan_bwd asked the device")
    for name in ("device_count", "is_available", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for case in CASES:
        assert kernel.plan_bwd(*_shape(case)) == \
            kernel.plan_bwd(*_shape(case))
    zamba = kernel.plan_bwd(*_shape(CASES[0]))
    assert (zamba.q_tiles, zamba.pairs, zamba.n_tiles) == (4, 10, 1)
    assert zamba.grids == ((112, 8, 1), (112, 8, 3), (112, 8, 8),
                           (112, 8, 4))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bwd_plan_fits_and_takes_the_one_instantiation(case):
    b, l, h, n, p, chunk = _shape(case)
    plan = kernel.plan_bwd(b, l, h, n, p, chunk)
    # One kernel instantiation: the tiling is the same at every shape.
    assert (plan.tile, plan.threads, plan.stages) == (T, 256, (2, 1, 0))
    assert plan.q_tiles == -(-chunk // T)
    assert plan.pairs == plan.q_tiles * (plan.q_tiles + 1) // 2
    assert (plan.n_tiles, plan.p_tiles) == (-(-n // T), -(-p // T))
    # Two staged tiles, and two raw tiles (one staged tile's bytes) or, in
    # the dk/dv blocks, the score tile: two blocks an SM.  The dq sum stages
    # nothing.
    staged = T * (T + 4) * 8
    base = 12 * plan.q_tiles * T + 4 * T * 4 + 2 * staged
    assert plan.smem_dstate == base + staged
    assert plan.smem_dq_sum == 2 * T * 4
    assert plan.smem_dkdv == base + staged <= SMEM_LIMIT
    assert plan.blocks_per_sm == 2
    assert 2 * (plan.smem_dkdv + 1024) <= SMEM_LIMIT + 1024
    # The dq partials: one 64 x 64 float32 tile a (pair, N tile) of every
    # chunk and head.
    assert plan.workspace_bytes == \
        4 * b * h * plan.chunks * plan.pairs * plan.n_tiles * T * T
    assert len(plan.c_plan()) == 10
    assert plan.c_plan()[9] * 4 == plan.workspace_bytes


@pytest.mark.parametrize("chunk", [16, 40, 64, 100, 128, 200, 256, 384, 512,
                                   640])
def test_bwd_plan_fits_a_block_at_every_chunk(chunk):
    for n, p in ((64, 64), (384, 385), (48, 65)):
        plan = kernel.plan_bwd(1, 4096, 2, n, p, chunk)
        assert max(plan.smem_dstate, plan.smem_dkdv,
                   plan.smem_dq_sum) <= SMEM_LIMIT
        assert plan.q_tiles == -(-chunk // T)
        assert plan.grids[2][2] == 2 * plan.q_tiles


# --------------------------------------------------------------------------
# A model of the kernel's arithmetic
# --------------------------------------------------------------------------
def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _frag(a, b, terms, acc=None):
    """acc + a [..., M, K] @ b [..., K, N], K at most 64, as one staged
    tile's product: each k-step of 8 summed exactly and rounded into a
    float32 fragment, lo·hi, hi·lo, then hi·hi (``terms`` 3) or hi·hi
    alone (1); the fragment added to acc."""
    ah, al = _split(a)
    bh, bl = _split(b)
    parts = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    frag = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in parts:
            step = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            frag = frag + step.float()
    return frag if acc is None else acc + frag


def _mm(a, b, terms, acc=None):
    """acc + a @ b, the depth in staged tiles of 64, each tile's fragments
    added into the float32 sum in order."""
    for k0 in range(0, a.shape[-1], T):
        acc = _frag(a[..., k0:k0 + T], b[..., k0:k0 + T, :], terms, acc)
    return acc


def _model(k, v, q, ld, g, dy, d_final, s0, chunk, terms):
    """The kernel's backward on float32 inputs [B, L, H, *], chunk a
    multiple of 64: the rows padded to whole chunks with zero inputs, gate
    and log-decay (what the kernel's last chunk, ending at L, computes),
    then phases 0-4 over (batch x head) at once."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    states_f = linear_scan_fwd_ref(k, v, q, ld, g, chunk=chunk,
                                   initial_state=s0)
    s_fin, states = states_f[1], states_f[2]          # [B,H,C,N,P]
    pad = (-l) % chunk
    c_n = (l + pad) // chunk
    nq = chunk // T
    f = lambda x: torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 2) + (0, pad)).transpose(1, 2) \
        .reshape((b * h, c_n, chunk) + tuple(x.shape[3:]))
    kc, vc, qc, dyc = (f(x) for x in (k, v, q, dy))     # [BH,C,Q,*]
    ldc, gc = (f(x[..., None])[..., 0] for x in (ld, g))
    cum = torch.cumsum(ldc.double(), dim=2)             # 0. float64
    total = cum[:, :, -1]
    e = lambda x: torch.exp(x.float())
    # 1. ΔG_c = Σ_i (e^cum_i q_i) dy_iᵀ, the rows in 64-row tiles.
    qe = e(cum)[..., None] * qc
    d_state = _mm(qe.transpose(-1, -2), dyc, terms)     # [BH,C,N,P]
    # 2. the reverse pass in float32.
    gs = torch.empty_like(d_state)
    gcur = (torch.zeros((b * h, n, p)) if d_final is None
            else d_final.reshape(b * h, n, p).clone())
    for c in reversed(range(c_n)):
        gs[:, c] = gcur
        gcur = gcur * e(total[:, c])[:, None, None] + d_state[:, c]
    d_init = gcur
    sp = states.reshape(b * h, c_n, n, p)
    tiles = lambda x: x.reshape(x.shape[:2] + (nq, T) + x.shape[3:])
    kt_, vt, qt_, dyt = map(tiles, (kc, vc, qc, dyc))   # [BH,C,nq,64,*]
    cumt, gt = tiles(cum), tiles(gc)
    rows = torch.arange(T)
    dq_parts, dkt, dvt = {}, {}, {}
    q_carry = [_mm(dyt[:, :, i], sp.transpose(-1, -2), terms)   # 2b.
               * e(cumt[:, :, i])[..., None] for i in range(nq)]
    for j in range(nq):                                 # 3. per key tile
        e_in = e(total[:, :, None] - cumt[:, :, j])[..., None]
        gk = gt[:, :, j, :, None] * kt_[:, :, j]
        acc_k = _mm(vt[:, :, j], gs.transpose(-1, -2), terms) * e_in
        acc_v = _mm(kt_[:, :, j], gs, terms) * e_in
        for i in range(j, nq):
            w = torch.exp((cumt[:, :, i, :, None] - cumt[:, :, j, None, :])
                          .float())
            live = (i * T + rows[:, None]) >= (j * T + rows[None, :])
            s = _mm(dyt[:, :, i], vt[:, :, j].transpose(-1, -2), terms)
            wk = torch.where(live, s * w, 0.0)
            s = _mm(qt_[:, :, i], kt_[:, :, j].transpose(-1, -2), terms)
            wv = torch.where(live, s * w, 0.0)
            acc_k = _frag(wk.transpose(-1, -2), qt_[:, :, i], terms, acc_k)
            acc_v = _frag(wv.transpose(-1, -2), dyt[:, :, i], terms, acc_v)
            # The diagonal pair's partial starts from dq's carry.
            dq_parts[i, j] = _frag(wk, gk, terms,
                                   q_carry[i] if i == j else None)
        dkt[j], dvt[j] = acc_k, acc_v
    dq = []
    for i in range(nq):                                 # 3b. the dq sums
        acc = dq_parts[i, 0]
        for j in range(1, i + 1):
            acc = acc + dq_parts[i, j]
        dq.append(acc)
    dq = torch.stack(dq, 2).reshape(b * h, c_n, chunk, n)
    dkt = torch.stack([dkt[j] for j in range(nq)], 2).reshape(dq.shape)
    dvt = torch.stack([dvt[j] for j in range(nq)], 2) \
        .reshape(b * h, c_n, chunk, p)
    dk, dv = gc[..., None] * dkt, gc[..., None] * dvt
    # 4. each 64-column tile's dot products in float32, then float64.
    dot = lambda x, y: sum((x[..., c0:c0 + T] * y[..., c0:c0 + T]).sum(-1)
                           .double() for c0 in range(0, n, T))
    dgv = dot(kc, dkt)
    dcum = dot(qc, dq) - gc.double() * dgv
    dcum = dcum.reshape(b * h, -1)[:, :l]
    if d_final is not None:
        dcum[:, -1] += (s_fin.double() * d_final.double()).reshape(
            b * h, -1).sum(-1)
    dld = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
    out = lambda x: x.reshape(b, h, -1, *x.shape[3:])[:, :, :l] \
        .transpose(1, 2)
    return (out(dk), out(dv), out(dq), out(dld).float(), out(dgv).float(),
            d_init.reshape(b, h, n, p))


# (family, B, L, H, N, P): the SSM_BWD_CASES forms at L <= 512, heads cut.
REDUCED = [("zamba2", 1, 512, 2, 64, 64), ("mlstm", 1, 512, 1, 384, 385),
           ("edge", 2, 300, 3, 48, 65)]


def _inputs(family, b, l, h, n, p):
    """numpy-seeded inputs of chip_smoke._ssm_bwd_inputs's forms."""
    rng = np.random.default_rng(sum(map(ord, family)))
    r = lambda *s: torch.as_tensor(rng.standard_normal(s),
                                   dtype=torch.float32)
    softplus = torch.nn.functional.softplus
    s0 = dfin = None
    if family == "zamba2":
        k = r(b, l, 1, n).expand(b, l, h, n)
        q = r(b, l, 1, n).expand(b, l, h, n)
        dt = softplus(r(b, l, h) - 1.0)
        ld, g = dt * -torch.exp(0.5 * r(h)), dt
    else:
        k, q = r(b, l, h, n) * n ** -0.5, r(b, l, h, n)
        ld = torch.nn.functional.logsigmoid(r(b, l, h) + 3.0)
        g = torch.exp(torch.clamp_max(r(b, l, h), 8.0))
    v = r(b, l, h, p)
    if family != "zamba2":
        v[..., -1] = 1.0
    if family == "edge":
        g[:, ::7] = 0.0
        g[:, -1] = 0.0
        s0, dfin = r(b, h, n, p), r(b, h, n, p)
    return k, v, q, ld, g, r(b, l, h, p), dfin, s0


@pytest.mark.parametrize("form", REDUCED, ids=[f[0] for f in REDUCED])
def test_split_tf32_backward_meets_the_gate(form):
    """The model in split TF32 lies within BWD_TOL of the float64 plain
    backward for every gradient; one-term TF32 does not."""
    k, v, q, ld, g, dy, dfin, s0 = _inputs(*form)
    chunk = 256
    f64 = lambda t: None if t is None else t.double()
    want = linear_scan_bwd_ref(*map(f64, (k, v, q, ld, g, dy)), f64(dfin),
                               chunk=chunk, initial_state=f64(s0))
    names = ("dk", "dv", "dq", "d_log_decay", "d_gate", "d_initial_state")
    m = 6 if s0 is not None else 5
    worst = {}
    for terms in (3, 1):
        got = _model(k, v, q, ld, g, dy, dfin, s0, chunk, terms)
        worst[terms] = {
            name: (a.double() - w).abs().max().item()
            / (chip_smoke.BWD_TOL * w.abs().max().item())
            for name, a, w in zip(names[:m], got[:m], want[:m])}
    assert max(worst[3].values()) <= 1.0, worst[3]
    assert max(worst[1].values()) > 1.0, worst[1]
    assert max(worst[1].values()) >= 20 * max(worst[3].values()), worst
