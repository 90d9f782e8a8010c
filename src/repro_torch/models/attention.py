"""Attention over the kernel ops, and the ring-buffer KV cache —
``repro.models.attention`` in PyTorch.

``attend`` keeps the reference's layouts (q [B, S, H, D], k and v
[B, T, KH, D]) and runs one of the two attention ops of
``repro_torch.kernels``: ``flash_attention`` for a prefill without a cache
and ``decode_attention`` for one query against a ring cache.  Each op
takes its CUDA kernel for CUDA tensors and its plain version for CPU
tensors, so one code path serves both devices.  The reference's choice
between a naive and a chunked jnp formulation (``RuntimeFlags.attn_impl``)
is an implementation choice of the reference: the port accepts the
arguments and does not branch on them.

Caches are ring buffers: slot = position mod cache_len, and absolute key
positions derive from the scalar write position.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG

__all__ = ["attend", "cache_slot_positions", "write_kv", "ring_place", "NEG"]


def attend(q, k, v, *, causal: bool = True, window: int | None = None,
           softcap: float | None = None, scale: float | None = None,
           pos=None, impl: str = "chunked", chunk: int = 1024,
           unroll: bool = False):
    """Grouped-query attention.

    q [B, S, H, D]; k, v [B, T, KH, D] (H % KH == 0).  Without ``pos`` the
    queries and keys both start at position 0 (a prefill) and the call
    goes to ``flash_attention``.  With ``pos`` (a Python int or an integer
    tensor) k and v are ring caches already holding the token at ``pos``,
    S must be 1, and the call goes to ``decode_attention`` over the live
    slots (positions ``pos - ((pos - slot) mod T)`` in [0, pos], inside
    the window).  ``impl``, ``chunk`` and ``unroll`` are the reference's
    and are ignored.  Returns [B, S, H, D].
    """
    del impl, chunk, unroll
    kw = dict(scale=scale, window=window)
    if pos is None:
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), causal=causal,
                            softcap=softcap, **kw)
        return o.transpose(1, 2)
    if q.shape[1] != 1:
        raise NotImplementedError(
            f"attend over a ring cache takes one query, got {q.shape[1]}; "
            "a prefill writes its cache with ring_place")
    if not causal:
        raise NotImplementedError("decode attention is causal")
    # The kernel reads the [B, T, KH, D] caches through their strides.
    o = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), pos,
                         softcap=softcap, **kw)
    return o[:, None]


def cache_slot_positions(pos, cache_len: int, device=None):
    """Absolute position held by each ring slot after writing ``pos``:
    slot i holds ``pos - ((pos - i) mod cache_len)`` (floor modulo); a
    negative position is a slot never written.  Returns (k_pos [T],
    k_valid [T]) on ``device``: the caller passes its cache's, so that a
    decode step on the card copies nothing from the host (default: a
    tensor ``pos``'s device, else the CPU)."""
    if device is None:
        device = pos.device if torch.is_tensor(pos) else "cpu"
    i = torch.arange(cache_len, device=device)
    p = pos - torch.remainder(pos - i, cache_len)
    return p, p >= 0


def write_kv(cache_k, cache_v, k_new, v_new, pos):
    """Write one token's K/V at ring slot ``pos mod cache_len``, in place.

    cache_k/v [B, T, KH, D]; k_new/v_new [B, 1, KH, D]; ``pos`` a Python
    int.  The reference returns updated copies; the port writes into the
    caches (at zamba2-7b's widths a copy would move 1.5 GB a token) and
    returns them.
    """
    slot = int(pos) % cache_k.shape[1]
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def ring_place(arr, s_len: int, cache_len: int):
    """Place the last ``cache_len`` of a [B, S, ...] sequence at ring slots
    ``p mod cache_len`` — the reference's ``transformer._ring_place``."""
    if s_len <= cache_len:
        pad = torch.zeros((arr.shape[0], cache_len - s_len)
                          + tuple(arr.shape[2:]), dtype=arr.dtype,
                          device=arr.device)
        return torch.cat([arr, pad], dim=1)
    last = arr[:, s_len - cache_len:]
    return torch.roll(last, s_len % cache_len, dims=1)
