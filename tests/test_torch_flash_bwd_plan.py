"""The flash-attention backward kernel's plan and arithmetic, on the CPU.

``csrc/flash_attention_bwd.cu`` splits each KV head's query group over
blocks (``kernel.bwd_plan``), sums the blocks' partial dK and dV in
ascending split order in a kernel of its own, and takes its five
products on the tensor cores in split TF32 (hi·hi + hi·lo + lo·hi).  The
kernel runs only on the card (``chip_smoke.py`` phase train).  Here:

(a) the plan at phase train's shapes and at the backward tests' cases:
    one query head a block (the split is the group), the workspace is
    what the kernel writes, and the plan reads no device;
(b) the partition and the order of the partial sums: the plain backward
    on each split's heads, dK and dV added in ascending split order,
    against ``jax.vjp`` of the JAX package's ``attention_ref`` at the
    forward's 2e-5, for every split of the group;
(c) a model of split TF32's error, not a bit-exact copy of the card's
    sums: hi the TF32 rounding of x (``cvt.rna.tf32.f32``'s: to nearest,
    ties away from zero, a 10-bit mantissa, bit for bit), lo = x - hi,
    which the tensor cores read truncated to TF32; each k-step of 8 summed
    exactly and rounded once into a float32 fragment (the mma's own sums
    truncate), one fragment a 32-row (or 64-column) tile, added into
    float32 as the kernel promotes it: the backward's five products
    against float64 within ``chip_smoke.BWD_TOL``, while one-term TF32
    fails that limit and is at least 50 times further off, so the gate
    on the card tells a split kernel from an unsplit one.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for BWD_CASES, BWD_TOL)
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from test_torch_flash_backward import (CASES, IDS, _close,  # noqa: E402
                                       _inputs, _jax_vjp, _kw)

torch.set_num_threads(1)

# (B, H, KH, S, T, D, causal, window) of phase train's cases and of the
# backward tests' cases.
TRAIN_SHAPES = [c[1:9] for c in chip_smoke.BWD_CASES]
SHAPES = TRAIN_SHAPES + [c[:8] for c in CASES]
SHAPE_IDS = [c[0].split(":")[0] for c in chip_smoke.BWD_CASES] + IDS


def _divisors(n):
    return [i for i in range(1, n + 1) if n % i == 0]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bwd_plan(shape):
    b, h, kh, s, t, d, causal, window = shape
    plan = fa.bwd_plan(b, h, kh, s, t, d, causal, window)
    # One query head a block: MHA is not split.
    assert plan.n_split == h // kh
    # Partial dK and dV, float32 [2, n_split, B, KH, T, D]; none unsplit.
    want = 0 if plan.n_split == 1 else 2 * plan.n_split * b * kh * t * d * 4
    assert plan.workspace_bytes == want


def test_bwd_plan_is_a_pure_function_of_the_shapes(monkeypatch):
    """The same shapes give the same plan, and computing it asks nothing
    of a device (every query of the card raises)."""
    def refuse(*args, **kwargs):
        raise AssertionError("bwd_plan asked the device")
    for name in ("device_count", "is_available", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for shape in TRAIN_SHAPES:
        assert fa.bwd_plan(*shape) == fa.bwd_plan(*shape)
    gemma = fa.bwd_plan(*TRAIN_SHAPES[0])
    assert gemma.n_split == 8                 # one head a block: 512 blocks
    assert gemma.workspace_bytes == 8 * 2048 * 256 * 4 * 2


def _split_backward(q, k, v, o, lse, do, n_split, kw):
    """The plain backward on each split's query heads (split i takes heads
    i·per .. (i + 1)·per - 1 of every KV head's group), dK and dV added in
    ascending split order, one addition at a time."""
    h, kh = q.shape[1], k.shape[1]
    per = h // kh // n_split
    dq = torch.empty_like(q)
    dk = dv = None
    for i in range(n_split):
        heads = [j * (h // kh) + i * per + e for j in range(kh)
                 for e in range(per)]
        gq, gk, gv = ref.attention_bwd_ref(q[:, heads], k, v, o[:, heads],
                                           lse[:, heads], do[:, heads], **kw)
        dq[:, heads] = gq
        dk = gk if dk is None else dk + gk
        dv = gv if dv is None else dv + gv
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_partials_summed_in_order_match_jax_vjp(case):
    q, k, v, do = _inputs(case, 7)
    kw = _kw(case)
    _, want = _jax_vjp(kw)(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    to, lse = ref.attention_fwd_ref(tq, tk, tv, **kw)
    group = case[1] // case[2]
    for n_split in _divisors(group):
        got = _split_backward(tq, tk, tv, to, lse, tdo, n_split, kw)
        for g, w in zip(got, want):
            _close(g, w)


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to nearest, ties away from zero, to
    a 10-bit mantissa (the low 13 bits of the float32 cleared); adding
    half of the cleared range to the bit pattern rounds the magnitude,
    whatever the sign.  The kernel's ``to_tf32`` is this arithmetic."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """x as the tensor cores read a TF32 operand: its upper 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, terms, tile=32):
    """a [M, K] . b [K, N] in a model of the kernel's split TF32: hi =
    tf32(x), lo = x - hi read truncated; K in mma steps of 8, each step's
    products summed exactly (float64) and rounded once into a float32
    fragment, lo·hi, hi·lo, then hi·hi (split, ``terms=3``), or hi·hi
    alone (one-term TF32, ``terms=1``); the fragment added into a float32
    sum every ``tile`` of K.  The card's mma truncates its own sums and
    the kernel alternates fragments over a tile: the model bounds the
    error's size, not its bits."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    parts = [(ah, bh)] if terms == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for t0 in range(0, a.shape[1], tile):
        frag = torch.zeros_like(acc)
        for k0 in range(t0, min(t0 + tile, a.shape[1]), 8):
            for x, y in parts:
                step = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
                frag = frag + step.float()
        acc = acc + frag
    return acc


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                           # a TF32 value
    half = 2.0 ** -11                                # half its last place
    x = torch.tensor([one, one + half, -(one + half), 1.0 + half,
                      one + half * 0.5, 3.0e38], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * half, -(one + 2 * half),
                         1.0 + 2 * half, one, 3.0e38], dtype=torch.float64)
    got = tf32(x).double()
    assert torch.equal(got[:5], want[:5])
    assert abs(got[5] / want[5] - 1) < 2.0 ** -11
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((y - hi).abs() <= y.abs() * 2.0 ** -11)


@pytest.mark.parametrize("d", [16, 100, 256])
def test_split_tf32_products_meet_the_backward_tolerance(d):
    """The five products of the backward (S = Q·Kᵀ, dP = dO·Vᵀ, dV =
    Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K) on one head of a causal softcapped
    attention, P and dS from the float64 plain backward, each in split
    TF32 and in one-term TF32 against the float64 product of the same
    float32 operands: the split meets ``BWD_TOL``, one-term TF32 does
    not."""
    s = t = 96
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(1, 1, n, d)))
                   for n in (s, t, t, s))
    kw = dict(scale=d ** -0.5, causal=True, window=None, softcap=30.0)
    o, lse = ref.attention_fwd_ref(q, k, v, **kw)
    kr, vr, scale = ref._heads(q, k, v, kw["scale"])
    sc, raw, ok = ref._scores(q, kr, scale=scale, causal=True, window=None,
                              softcap=kw["softcap"], dtype=torch.float64)
    p = torch.exp(sc - lse[..., None])[0, 0]
    dp = (do @ vr.transpose(-1, -2))[0, 0]
    delta = (do * o).sum(-1)[0, 0, :, None]
    th = torch.tanh(raw / kw["softcap"])[0, 0]
    ds = torch.where(ok, p * (dp - delta), 0.0) * (1 - th * th)
    q2, k2, v2, do2 = (x[0, 0] for x in (q, k, v, do))
    # (A, B, the K the kernel sums in one fragment: 64 columns of D for
    # the recomputed scores, a 32-row or 32-key tile for the gradients)
    products = {"S": (q2, k2.T, 64), "dP": (do2, v2.T, 64),
                "dV": (p.T, do2, 32), "dK": (ds.T, q2, 32),
                "dQ": (ds, k2, 32)}
    for name, (a, b, tile) in products.items():
        a, b = a.float(), b.float()
        exact = a.double() @ b.double()
        limit = chip_smoke.BWD_TOL * exact.abs().max().item()
        err3 = (_mm_tf32(a, b, 3, tile).double() - exact).abs().max().item()
        err1 = (_mm_tf32(a, b, 1, tile).double() - exact).abs().max().item()
        assert err3 <= limit, (name, err3, limit)
        assert err1 > limit, (name, err1, limit)
        assert err1 >= 50 * err3, (name, err1, err3)
