"""Wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``).

:func:`prepare` checks the inputs and allocates the output, :func:`launch`
launches once on prepared arguments, and :func:`flash_attention_cuda` does
both and counts the launch in ``flash_attention_cuda.launches`` (and
nowhere else).  The C entry routes by dtype, both to tensor-core kernels
(``mma.sync`` with a ``cp.async`` K/V ring): bfloat16 to the bf16
kernel, float32 to the split-TF32 kernel (each operand split into a TF32
head and remainder, three products, which keeps the float32 contract)
with the tiling that :func:`fwd_plan` gives; the float32 kernel also
writes each row's log-sum-exp when asked (``want_lse``), which the
backward reads.  :func:`prepare_bwd`,
:func:`launch_bwd` and :func:`flash_attention_bwd_cuda` are the same for
the backward (float32 only), counted in
``flash_attention_bwd_cuda.launches``: one a call, whose kernels are the
Δ = rowsum(dO∘O) pre-pass, dK/dV, the fixed-order sum of dK/dV's partials
over the query group's split and dQ.  :func:`bwd_plan` fixes the split
from the shapes alone.  :func:`flash_attention_meta` and
:func:`flash_attention_bwd_meta` run the same checks on meta tensors and
return empty outputs (the dry run's branch, ``kernels.dispatch``);
:func:`cost` and :func:`cost_bwd` count a call's operations and bytes,
which both ``chip_smoke.py``'s bounds and the dry run read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import capi
from repro_torch.shard.local import reject

__all__ = ["flash_attention_bwd_cuda", "flash_attention_cuda", "launch",
           "launch_bwd", "prepare", "prepare_bwd", "BWD_PHASES", "BwdPlan",
           "bwd_plan", "FwdPlan", "FWD_TILES", "fwd_plan", "live_pairs",
           "cost", "cost_bwd", "flash_attention_meta",
           "flash_attention_bwd_meta"]

_OP = "flash_attention"
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


_BWD = "flash_attention_bwd"
# The backward's kernels, as bits of launch_bwd's ``phases``; "reduce"
# launches only where the plan splits the query group.
BWD_PHASES = {"delta": 1, "dkdv": 2, "dq": 4, "reduce": 8}
BWD_ALL = sum(BWD_PHASES.values())


def _fn():
    return capi.entry(_OP, "flash_attention_launch",
                      [capi.P] * 5 + [capi.I] * 7
                      + [capi.F, capi.I, capi.I, capi.I, capi.F]
                      + [capi.I] * 3 + [capi.P])


def _bwd_fn():
    return capi.entry(_BWD, "flash_attention_bwd_launch",
                      [capi.P] * 11 + [capi.I] * 7
                      + [capi.F, capi.I, capi.I, capi.I, capi.F, capi.I,
                         capi.P])


# The float32 forward's instantiations in csrc/flash_attention.cu, one a
# DP: (DP, warps, keys, split_q).
FWD_TILES = ((64, 8, 64, True), (128, 8, 64, True), (192, 4, 32, False),
             (256, 8, 32, False))
_FWD_STAGES = 2
_SMEM_LIMIT = 232448        # bytes of shared memory a block may have


class FwdPlan(NamedTuple):
    """The float32 forward's launch plan (:func:`fwd_plan`)."""
    dp: int                 # D padded to a multiple of 64 in shared memory
    warps: int              # 16 query rows each
    rows: int               # query rows of a block
    keys: int               # keys of a K/V tile
    stages: int             # the ring's stages: K_j, V_j, K_j+1, ... in turn
    split_q: bool           # Q split into hi and lo once, as it lands
    split_kv: bool          # K and V split as they land (never: see below)
    smem_bytes: int
    blocks_per_sm: int      # as the kernel's launch bounds ask
    grid: tuple             # (query tiles, B x H)


def fwd_plan(b, h, kh, s, t, d, causal=True, window=None) -> FwdPlan:
    """The float32 forward's plan, a pure function of the shapes: it reads
    no device, so a call's tiling, order of sums and bits are the same on
    every card.

    DP is D padded to a multiple of 64; each DP has one tiling
    (:data:`FWD_TILES`): Q [rows][DP + 4] float32 in shared memory and a
    two-stage ring that takes K_j, V_j, K_j+1, ... [keys][DP + 4] in turn
    (V_j lands during S of tile j, K_j+1 during P·V).  Q is split into hi
    and lo once where ``split_q`` (twice Q's bytes: at DP <= 128), else at
    each fragment load.  K and V are split at each fragment load: split as
    they land, their hi and lo would double the shared-memory reads of the
    B fragments, the largest stream, and need a third buffer.  8 warps a
    block, one block an SM, 128-row tiles; at DP 192, 4 warps and two
    blocks an SM (64-row tiles, twice the blocks: as fast at the MLA's
    shape, faster on small grids; 64-key tiles at 8 warps spill there).
    ``kh``, ``t``, ``causal`` and ``window`` do not change the plan."""
    dp = (d + 63) // 64 * 64
    mine = [x for x in FWD_TILES if x[0] == dp]
    if not mine:
        raise ValueError(f"{_OP}: head dim {d} must lie in (0, "
                         f"{MAX_HEAD_DIM}]")
    _, warps, keys, split_q = mine[0]
    rows = 16 * warps
    smem = 4 * (dp + 4) * ((2 if split_q else 1) * rows + 2 * keys)
    assert smem <= _SMEM_LIMIT, (dp, warps, keys, split_q, smem)
    blocks = 2 if warps <= 4 and smem <= _SMEM_LIMIT // 2 - 1024 else 1
    return FwdPlan(dp=dp, warps=warps, rows=rows, keys=keys,
                   stages=_FWD_STAGES, split_q=split_q, split_kv=False,
                   smem_bytes=smem, blocks_per_sm=blocks,
                   grid=((s + rows - 1) // rows, b * h))


class BwdPlan(NamedTuple):
    """The backward's launch plan (:func:`bwd_plan`)."""
    n_split: int            # blocks a (batch, KV head, key tile) splits into
    workspace_bytes: int    # the partial dK and dV, 0 where n_split == 1


def bwd_plan(b, h, kh, s, t, d, causal=True, window=None) -> BwdPlan:
    """The backward's plan, a pure function of the shapes: it reads no
    device, so a call's order of sums, and its bits, are the same on every
    card.

    The dK/dV kernel gives each block one (batch, KV head, 32-key tile)
    and one query head of the KV head's group: ``n_split`` = H/KH.
    gemma-2b's MQA (group 8, 64 key tiles) gets 512 blocks, where one
    block a key tile walking every head left the card half idle.  Each
    block writes its partial dK and dV (``workspace_bytes``: n_split x B x
    KH x T x D float32, for dK and for dV); MHA (n_split 1) writes dK and
    dV directly.  A coarser split, the smallest reaching 1024 blocks, was
    no faster on the card at a GQA group of 6 or Gemma2's group of 2.
    ``s``, ``causal`` and ``window`` do not change the plan."""
    n_split = h // kh
    return BwdPlan(n_split=n_split,
                   workspace_bytes=0 if n_split == 1
                   else 2 * 4 * n_split * b * kh * t * d)


def check_heads(op, q, k, v, n_heads, n_kv, head_dim):
    """The shape rules the attention kernels share."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{op}: q, k and v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if n_kv == 0 or n_heads % n_kv:
        raise ValueError(f"{op}: {n_heads} query heads do not group over "
                         f"{n_kv} KV heads")
    if head_dim % 4 or not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {head_dim} must be a multiple of "
                         f"4 in (0, {MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} is not 16-byte aligned")


def _check_mask(op, window):
    if window is not None and window <= 0:
        raise ValueError(f"{op}: window={window} must be positive")


def _check_fwd(q, k, v, window, want_lse, dev):
    """The forward's rules on its inputs (on ``dev``): shapes, dtypes,
    heads, the mask; the float32 tiling's head dims (:func:`fwd_plan`)."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    capi.check(_OP, "q", q, DTYPES, (b, h, s, d), dev)
    capi.check(_OP, "k", k, DTYPES, (b, kh, t, d), dev)
    capi.check(_OP, "v", v, DTYPES, (b, kh, t, d), dev)
    check_heads(_OP, q, k, v, h, kh, d)
    _check_mask(_OP, window)
    if want_lse and q.dtype != torch.float32:
        raise TypeError(f"{_OP}: the lse output is float32 only")
    return None if q.dtype == torch.bfloat16 else fwd_plan(b, h, kh, s, t, d)


def prepare(q, k, v, *, scale=None, causal=True, window=None,
            softcap=None, want_lse=False):
    """Returns ``(args, out, keep)``: the C entry's arguments, the output
    tensor (``(o, lse)`` with ``want_lse``: lse [B, H, S] float32, float32
    inputs only) and the inputs ``args`` points into.  A float32 call
    takes :func:`fwd_plan`'s tiling."""
    reject("flash_attention", q, k, v)
    dev = capi.require_cuda(_OP, q)
    plan = _check_fwd(q, k, v, window, want_lse, dev)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    bf16 = plan is None
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
           if want_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            capi.ptr(lse), int(bf16), b, h, kh, s, t, d,
            float(np.float32(scale)), int(bool(causal)),
            0 if window is None else int(window), int(softcap is not None),
            float(np.float32(0.0 if softcap is None else softcap)),
            *((0, 0, 0) if bf16 else
              (plan.warps, plan.keys, int(plan.split_q))),
            capi.stream(dev))
    return args, (o if lse is None else (o, lse)), (q, k, v)


def flash_attention_meta(q, k, v, *, scale=None, causal=True, window=None,
                         softcap=None, want_lse=False):
    """The forward's outputs on the meta device, after :func:`prepare`'s
    checks: the dry run's stand-in for a launch (nothing is computed or
    counted in ``launches``)."""
    reject("flash_attention", q, k, v)
    dev = capi.require_meta(_OP, q)
    _check_fwd(q, k, v, window, want_lse, dev)
    o = torch.empty_like(q)
    if not want_lse:
        return o
    return o, torch.empty(q.shape[:3], dtype=torch.float32, device=dev)


def live_pairs(s: int, t: int, causal=True, window=None) -> int:
    """(query, key) pairs that a head's mask keeps: query i sees key j
    where j <= i (causal) and j > i - window (a window).  The kernels skip
    the key tiles that hold none of them; the plain version computes all
    S x T."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = (np.maximum(i - window + 1, 0) if window is not None
          else np.zeros(s, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q, k, v, *, causal=True, window=None, want_lse=False):
    """(operations, bytes) of one forward call: two products of 2·D
    operations for each live pair (S = Q·Kᵀ and O += P·V; the softmax's
    few operations a pair not counted), each input read once and O (and
    the lse) written once."""
    b, h, s, d = q.shape
    ops = 4 * d * b * h * live_pairs(s, k.shape[2], causal, window)
    lse = 4 * b * h * s if want_lse else 0
    return ops, 2 * capi.nbytes(q) + capi.nbytes(k, v) + lse


def cost_bwd(q, k, v, *, causal=True, window=None):
    """(operations, bytes) of one backward call: five products of 2·D a
    live pair (S and P again, dV += Pᵀ·dO, dP = dO·Vᵀ, dQ and dK), q, k, v,
    o, do and the lse read once, dq, dk and dv written once."""
    b, h, s, d = q.shape
    ops = 10 * d * b * h * live_pairs(s, k.shape[2], causal, window)
    return ops, 4 * capi.nbytes(q) + 2 * capi.nbytes(k, v) + 4 * b * h * s


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def flash_attention_cuda(q, k, v, *, scale=None, causal=True, window=None,
                         softcap=None, want_lse=False):
    """Attention on the card; the contract of
    :func:`repro_torch.kernels.flash_attention.ref.attention_ref` (with
    ``want_lse``, ``(o, lse)``: that of ``ref.attention_fwd_ref``)."""
    args, out, _keep = prepare(q, k, v, scale=scale, causal=causal,
                               window=window, softcap=softcap,
                               want_lse=want_lse)
    launch(args)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _check_bwd(q, k, v, o, lse, do, window, dev):
    """The backward's rules on its inputs (on ``dev``): float32, shapes,
    heads, the mask."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    f32 = torch.float32
    for name, x, shape in (("q", q, (b, h, s, d)), ("k", k, (b, kh, t, d)),
                           ("v", v, (b, kh, t, d)), ("o", o, (b, h, s, d)),
                           ("lse", lse, (b, h, s)), ("do", do, (b, h, s, d))):
        capi.check(_BWD, name, x, f32, shape, dev)
    check_heads(_BWD, q, k, v, h, kh, d)
    for name, x in (("o", o), ("do", do)):
        if x.data_ptr() % 16:
            raise ValueError(f"{_BWD}: {name} is not 16-byte aligned")
    _check_mask(_BWD, window)


def prepare_bwd(q, k, v, o, lse, do, *, scale=None, causal=True,
                window=None, softcap=None):
    """The backward's ``(args, (dq, dk, dv), keep)``: the C entry's
    arguments, the gradients (float32, allocated here with the Δ scratch
    [B, H, S] and, where :func:`bwd_plan` splits the group, the workspace
    of partial dK and dV [2, n_split, B, KH, T, D]) and the tensors
    ``args`` points into."""
    reject("flash_attention_bwd", q, k, v, o, lse, do)
    dev = capi.require_cuda(_BWD, q)
    _check_bwd(q, k, v, o, lse, do, window, dev)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    f32 = torch.float32
    scale = d ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((b, h, s), dtype=f32, device=dev)
    n_split = bwd_plan(b, h, kh, s, t, d, bool(causal), window).n_split
    work = (torch.empty((2, n_split, b, kh, t, d), dtype=f32, device=dev)
            if n_split > 1 else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), capi.ptr(work), b, h, kh, s,
            t, d, n_split,
            float(np.float32(scale)), int(bool(causal)),
            0 if window is None else int(window), int(softcap is not None),
            float(np.float32(0.0 if softcap is None else softcap)),
            capi.stream(dev))
    return args, (dq, dk, dv), (q, k, v, o, lse, do, delta, work)


def flash_attention_bwd_meta(q, k, v, o, lse, do, *, scale=None,
                             causal=True, window=None, softcap=None):
    """(dq, dk, dv) on the meta device after :func:`prepare_bwd`'s checks:
    the dry run's stand-in for the backward's launch."""
    reject("flash_attention_bwd", q, k, v, o, lse, do)
    dev = capi.require_meta(_BWD, q)
    _check_bwd(q, k, v, o, lse, do, window, dev)
    return tuple(torch.empty_like(x) for x in (q, k, v))


def launch_bwd(args, phases: int = BWD_ALL) -> None:
    """One launch of the backward's kernels named by ``phases`` (bits of
    :data:`BWD_PHASES`; all of them by default) on prepared arguments;
    does not count."""
    capi.raise_on_error(_BWD, _bwd_fn()(*args[:-1], phases, args[-1]))


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, scale=None,
                             causal=True, window=None, softcap=None):
    """(dq, dk, dv) on the card; the contract of
    :func:`repro_torch.kernels.flash_attention.ref.attention_bwd_ref`."""
    args, grads, _keep = prepare_bwd(q, k, v, o, lse, do, scale=scale,
                                     causal=causal, window=window,
                                     softcap=softcap)
    launch_bwd(args)
    flash_attention_bwd_cuda.launches += 1
    return grads


flash_attention_bwd_cuda.launches = 0
