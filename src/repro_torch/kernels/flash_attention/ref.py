"""Plain PyTorch version of flash attention — same contract as the CUDA
kernels in ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd.cu`` (backward).

The PyTorch form of ``repro.kernels.flash_attention.ref.attention_ref``:
the KV heads repeated to the query heads, float32 scores, the softcap,
the causal / window mask at -0.7·f32max, a softmax and the float32 value
product, rounded to q's dtype.  It serves the CPU path and the tests; on
the card it is the kernels' yardstick (``chip_smoke.py``).

:func:`attention_fwd_ref` also returns each row's log-sum-exp of the
masked scores, which is what the backward keeps of the softmax, and
:func:`attention_bwd_ref` is the backward written out as formulas: P
recomputed from the log-sum-exp, dP = dO·Vᵀ, Δ = rowsum(dO∘O), dS =
P∘(dP − Δ) through the mask and the softcap's 1 − tanh², dV = Pᵀ·dO,
dK = dSᵀ·Q·scale and dQ = dS·K·scale, dK and dV summed over each KV
head's group of query heads.  A row with no live key (a window that
ends before the first key) has the softmax of a constant row: P = 1/T on
every key, and no gradient reaches its scores.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["attention_ref", "attention_fwd_ref", "attention_bwd_ref", "NEG"]

NEG = -0.7 * float(np.finfo(np.float32).max)


def _live(s, t, causal, window, device):
    """The [S, T] mask of live (query, key) pairs."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def _scores(q, k, *, scale, causal, window, softcap, dtype=torch.float32):
    """(masked scores [B, H, S, T], raw scaled scores, live mask) in
    ``dtype``; k already repeated to the query heads."""
    sc = torch.einsum("bhsd,bhtd->bhst", q.to(dtype), k.to(dtype)) * scale
    raw = sc
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    ok = _live(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.where(ok, sc, NEG), raw, ok


def _heads(q, k, v, scale):
    d = q.shape[3]
    rep = q.shape[1] // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    return (torch.repeat_interleave(k, rep, dim=1),
            torch.repeat_interleave(v, rep, dim=1), scale)


def _attend(q, k, v, scale, causal, window, softcap):
    """(output in q's dtype, the masked float32 scores)."""
    k, v, scale = _heads(q, k, v, scale)
    sc, _, _ = _scores(q, k, scale=scale, causal=causal, window=window,
                       softcap=softcap)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        v.to(torch.float32)).to(q.dtype), sc


def attention_ref(q, k, v, *, scale=None, causal=True, window=None,
                  softcap=None):
    """q [B, H, S, D]; k, v [B, KH, T, D] -> [B, H, S, D] (f32 math)."""
    return _attend(q, k, v, scale, causal, window, softcap)[0]


def attention_fwd_ref(q, k, v, *, scale=None, causal=True, window=None,
                      softcap=None):
    """(o, lse): :func:`attention_ref`'s output and the log-sum-exp of each
    row's masked scores, lse [B, H, S] float32."""
    o, sc = _attend(q, k, v, scale, causal, window, softcap)
    return o, torch.logsumexp(sc, dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, *, scale=None, causal=True,
                      window=None, softcap=None):
    """(dq, dk, dv) of attention at q, k, v for the output gradient ``do``,
    from the forward's output ``o`` and ``lse``; the arithmetic in the
    inputs' dtype (float32 on the training path; the card's check runs it
    in float64)."""
    dt = q.dtype
    h, kh = q.shape[1], k.shape[1]
    kr, vr, scale = _heads(q, k, v, scale)
    sc, raw, ok = _scores(q, kr, scale=scale, causal=causal, window=window,
                          softcap=softcap, dtype=dt)
    t = k.shape[2]
    dead = ~ok.any(dim=-1)                                   # [S]
    p = torch.exp(sc - lse.to(dt)[..., None])
    p = torch.where(dead[:, None], torch.tensor(1.0 / t, dtype=dt,
                                                device=q.device), p)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do.to(dt))
    dp = torch.einsum("bhsd,bhtd->bhst", do.to(dt), vr.to(dt))
    delta = (do.to(dt) * o.to(dt)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    ds = torch.where(ok, ds, torch.zeros((), dtype=dt, device=q.device))
    if softcap is not None:
        th = torch.tanh(raw / softcap)
        ds = ds * (1 - th * th)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kr.to(dt)) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.to(dt)) * scale
    b = q.shape[0]
    fold = lambda x: x.reshape(b, kh, h // kh, *x.shape[2:]).sum(dim=2)
    return dq, fold(dk), fold(dv)
