"""The float32 flash-attention forward's plan and arithmetic, on the CPU.

``csrc/flash_attention.cu`` takes a float32 attention on the tensor cores
in split TF32: each operand split into hi (its TF32 rounding) and lo = x -
hi, three products hi·hi + hi·lo + lo·hi, a fragment summing one 64-column
slab of D for S = Q·Kᵀ and one key tile for P·V before it is added into
float32 sums, with the tiling of ``kernel.fwd_plan``.  The kernel runs
only on the card (``chip_smoke.py`` phase ops, ``scripts/
flash_fwd_series.py``).  Here:

(a) the plan is a pure function of the shapes (it asks no device), and
    its shared memory fits a block at every head dim of the zoo and of the
    edge cases (80, 100, 112, 128, 192, 256), one instantiation a DP;
(b) a model of the forward in split TF32 (the backward tests' ``tf32``,
    ``tf32_trunc`` and ``_mm_tf32`` for S and P·V, an online softmax over
    the plan's key tiles with the kernel's causal and window skips and
    its rescale acc = alpha·acc + part) is held against float64 within
    phase ops' 2e-5 + 2e-5·|want|, while one-term TF32 misses it;
(c) P stays in registers: the S accumulator fragment, read as P·V's A
    fragment through the permuted key order (slot t: key 2t, slot t + 4:
    key 2t + 1, in A and B alike), gives the product of the natural order.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref
from test_torch_flash_bwd_plan import _mm_tf32, tf32, tf32_trunc

torch.set_num_threads(1)

SMEM_LIMIT = 227 * 1024          # bytes of shared memory a block may have
ZOO_DIMS = (80, 100, 112, 128, 192, 256)


def test_fwd_plan_is_a_pure_function_of_the_shapes(monkeypatch):
    """The same shapes give the same plan, and computing it asks nothing
    of a device (every query of the card raises)."""
    def refuse(*args, **kwargs):
        raise AssertionError("fwd_plan asked the device")
    for name in ("device_count", "is_available", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for d in ZOO_DIMS:
        a = fa.fwd_plan(2, 16, 8, 4608, 4608, d, True, 4096)
        assert a == fa.fwd_plan(2, 16, 8, 4608, 4608, d, True, 4096)
        # The mask and the KV heads do not change the tiling.
        assert a == fa.fwd_plan(2, 16, 16, 4608, 1000, d, False, None)
    gemma = fa.fwd_plan(1, 8, 1, 2048, 2048, 256)
    assert (gemma.dp, gemma.rows, gemma.grid) == (256, 16 * gemma.warps,
                                                 (2048 // gemma.rows, 8))


@pytest.mark.parametrize("d", ZOO_DIMS)
def test_fwd_plan_fits_a_block(d):
    plan = fa.fwd_plan(4, 16, 16, 1000, 1000, d)
    assert plan.dp == -(-d // 64) * 64 and plan.dp - d < 64
    assert plan.rows == 16 * plan.warps and plan.stages >= 2
    assert plan.grid == (-(-1000 // plan.rows), 64)
    assert not plan.split_kv
    # Q (twice where split) and the ring's two stages, one K and one V
    # tile, rows of DP + 4 floats.
    want = 4 * (plan.dp + 4) * ((2 if plan.split_q else 1) * plan.rows
                                + plan.stages * plan.keys)
    assert plan.smem_bytes == want <= SMEM_LIMIT
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SMEM_LIMIT


@pytest.mark.parametrize("tiles", fa.FWD_TILES,
                         ids=lambda x: "dp%d-w%d-k%d-sq%d" % x)
def test_every_instantiation_fits_a_block(tiles):
    """Each DP's one instantiation is the plan of every D it pads, and it
    fits as many blocks an SM as its launch bounds ask."""
    dp = tiles[0]
    for d in range(dp - 60, dp + 1, 4):
        plan = fa.fwd_plan(1, 8, 8, 300, 300, d)
        assert (plan.dp, plan.warps, plan.keys, plan.split_q) == tiles
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SMEM_LIMIT
    assert plan.keys % 8 == 0 and plan.warps in (4, 8)
    # The P·V passes take 2, 4 or 8 column blocks of O at a time.
    assert (dp // 8) % (8 if dp < 192 else 4) == 0


def _exact(q, k, v, kw):
    """The attention in float64 from the same float32 inputs, [S, D]."""
    kr, vr, scale = ref._heads(q, k, v, kw["scale"])
    sc, _, _ = ref._scores(q, kr, scale=scale, causal=kw["causal"],
                           window=kw["window"], softcap=kw["softcap"],
                           dtype=torch.float64)
    return (torch.softmax(sc, dim=-1) @ vr.double())[0, 0]


def _model(q, k, v, kw, plan, terms):
    """The kernel's forward on one head in a model of its arithmetic: for
    each query tile of ``plan.rows`` rows, the key tiles it can see, S
    by ``_mm_tf32`` (a fragment a 64-column slab), the scale, softcap and
    mask in float32, the online softmax, and O = alpha·O + P·V (P·V by
    ``_mm_tf32``, one fragment a key tile; the rescale one fmaf)."""
    q, k, v = q[0, 0], k[0, 0], v[0, 0]
    s_len, t_len = q.shape[0], k.shape[0]
    scale, causal, window = kw["scale"], kw["causal"], kw["window"]
    softcap, keys = kw["softcap"], plan.keys
    neg = torch.tensor(ref.NEG, dtype=torch.float32)
    out = torch.empty_like(q)
    n_kv = -(-t_len // keys)
    for q0 in range(0, s_len, plan.rows):
        rows = torch.arange(q0, min(q0 + plan.rows, s_len))
        last = int(rows[-1])
        j_end = min(n_kv, last // keys + 1) if causal else n_kv
        j_begin = 0
        if window is not None and q0 - window - (keys - 1) >= 0:
            j_begin = (q0 - window - (keys - 1)) // keys + 1
        m = torch.full((len(rows),), ref.NEG, dtype=torch.float32)
        l_ = torch.zeros(len(rows), dtype=torch.float32)
        acc = torch.zeros((len(rows), q.shape[1]), dtype=torch.float32)
        for j in range(j_begin, j_end):
            kp = torch.arange(j * keys, min((j + 1) * keys, t_len))
            x = _mm_tf32(q[rows], k[kp].T.contiguous(), terms, 64) * \
                np.float32(scale)
            if softcap is not None:
                x = np.float32(softcap) * torch.tanh(x / np.float32(softcap))
            live = torch.ones_like(x, dtype=torch.bool)
            if causal:
                live &= kp[None, :] <= rows[:, None]
            if window is not None:
                live &= kp[None, :] > rows[:, None] - window
            x = torch.where(live, x, neg)
            m_new = torch.maximum(m, x.max(dim=1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[:, None])
            l_ = l_ * alpha + p.sum(dim=1)
            pv = _mm_tf32(p, v[kp], terms, keys)
            acc = (acc.double() * alpha.double()[:, None]
                   + pv.double()).float()
            m = m_new
        out[rows] = acc / torch.clamp(l_, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("d", [80, 192, 256])
@pytest.mark.parametrize("mask", ["causal, softcap 30", "causal, window 50"])
def test_split_tf32_forward_meets_the_float32_tolerance(d, mask):
    """Split TF32 lies within phase ops' 2e-5 + 2e-5·|want| of the float64
    attention; one-term TF32 does not."""
    s = t = 150                         # off the tiles: a ragged last tile
    rng = np.random.default_rng(d + len(mask))
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 1, n, d)),
                               dtype=torch.float32) for n in (s, t, t))
    kw = dict(scale=d ** -0.5, causal=True,
              window=50 if "window" in mask else None,
              softcap=30.0 if "softcap" in mask else None)
    plan = fa.fwd_plan(1, 1, 1, s, t, d, True, kw["window"])
    exact = _exact(q, k, v, kw)
    limit = 2e-5 + 2e-5 * exact.abs()
    err3 = (_model(q, k, v, kw, plan, 3).double() - exact).abs()
    err1 = (_model(q, k, v, kw, plan, 1).double() - exact).abs()
    assert bool((err3 <= limit).all()), err3.max().item()
    assert not bool((err1 <= limit).all()), err1.max().item()
    assert err1.max().item() >= 100 * err3.max().item()


def test_tf32_split_recovers_float32_operands():
    """hi + lo read truncated lies within 2^-21 of x: the split carries
    what one-term TF32 (2^-11) drops."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    hi = tf32(x)
    lo = tf32_trunc(x - hi)
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.abs()
    assert rel.max().item() <= 2.0 ** -21
    assert ((hi.double() - x.double()).abs() / x.abs()).max().item() \
        > 2.0 ** -13


def _pv_through_fragments(p, v):
    """One m16n8k8 product O = P·V of a 16 x 8 P block and an 8 x 8 V
    block as the kernel lays it out: lane (g, t) holds S's accumulator
    fragment (P[g, 2t], P[g, 2t+1], P[g+8, 2t], P[g+8, 2t+1]) and hands
    it to the mma as its A fragment a0..a3 = c0, c2, c1, c3, which the PTX
    layout reads as A[g, t], A[g+8, t], A[g, t+4], A[g+8, t+4]; its B
    fragment is b0 = V[2t, g], b1 = V[2t+1, g], read as B[t, g], B[t+4,
    g].  Returns A·B."""
    a = torch.full((16, 8), math.nan, dtype=p.dtype)
    b = torch.full((8, 8), math.nan, dtype=v.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        c = (p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1])
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = \
            c[0], c[2], c[1], c[3]
        b[t, g], b[t + 4, g] = v[2 * t, g], v[2 * t + 1, g]
    assert not torch.isnan(a).any() and not torch.isnan(b).any()
    return a @ b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permuted_key_order_gives_the_natural_product(seed):
    """Integer-valued blocks, so the float64 sums are exact: the permuted
    order's product equals P·V in the natural key order."""
    gen = torch.Generator().manual_seed(seed)
    p = torch.randint(-64, 64, (16, 8), generator=gen).double()
    v = torch.randint(-64, 64, (8, 8), generator=gen).double()
    assert torch.equal(_pv_through_fragments(p, v), p @ v)
    # A key order that is not the kernel's (slot t: key t) gives another
    # product: the permutation is what makes S's fragment P's.
    wrong = torch.full((16, 8), 0.0, dtype=torch.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        wrong[g, t], wrong[g + 8, t] = p[g, 2 * t], p[g + 8, 2 * t]
        wrong[g, t + 4], wrong[g + 8, t + 4] = p[g, 2 * t + 1], \
            p[g + 8, 2 * t + 1]
    assert not torch.equal(wrong @ v, p @ v)
