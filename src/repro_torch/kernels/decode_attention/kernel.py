"""Wrapper of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

:func:`prepare` checks the inputs and allocates the output, :func:`launch`
launches once on prepared arguments, and :func:`decode_attention_cuda`
does both and counts the call in ``decode_attention_cuda.launches`` (and
nowhere else).  A call is two kernels: the split kernel writes each
split's softmax partials to a float32 scratch that :func:`prepare`
allocates, and the combine kernel folds them in fixed split order
(:func:`split_plan` chooses the splits).

K and V are read through their strides: each row of D values contiguous,
the batch, head and slot strides free (the same for K and V).  So a cache
kept as [B, T, KH, D], the reference's layout, goes in as its transposed
view without a copy.  :func:`decode_attention_meta` runs the same checks
on meta tensors and returns an empty output (the dry run's branch,
``kernels.dispatch``); :func:`cost` counts a call's operations and
bytes, which both ``chip_smoke.py``'s bounds and the dry run read.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import capi
from repro_torch.kernels.flash_attention.kernel import DTYPES, check_heads
from repro_torch.shard.local import reject

__all__ = ["decode_attention_cuda", "launch", "prepare", "split_plan",
           "decode_attention_meta", "live_slots", "cost"]

_OP = "decode_attention"
# Outputs a block holds: G·D query-head values of one KV head.
MAX_GROUP_WIDTH = 4096
# Slots of a split-plan tile: every split is a whole number of them.
TILE = 64


def _fn():
    return capi.entry(_OP, "decode_attention_launch",
                      [capi.P] * 5 + [capi.I] * 6
                      + [capi.F, capi.I, capi.I, capi.F, capi.P, capi.I]
                      + [ctypes.c_longlong] * 3 + [capi.I, capi.I, capi.P])


def split_plan(batch, n_kv, t, n_sm):
    """``(n_split, tiles_per_split)``: how a call cuts its T slots.

    One block per (batch, KV head, split); the splits aim at two waves of
    blocks on ``n_sm`` SMs, a whole number of 64-slot tiles each, none
    empty, and one split when ``batch·n_kv`` alone fills two waves.  It
    reads T, ``batch·n_kv`` and the card's SM count, never ``pos``, so a
    call never waits on the host.  The combine adds the splits in order, so
    a request's outputs may change in the last bits with the batch it
    rides in or with the card it runs on (ROADMAP C6); all stay within
    the kernel's tolerance.
    """
    n_tiles = -(-t // TILE)
    want = -(-2 * n_sm // max(batch * n_kv, 1))
    n_split = min(n_tiles, max(want, 1))
    per = -(-n_tiles // n_split)
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cache(name, t, dtype, shape, device):
    """``t`` as ``capi.check`` has it, but with rows of D contiguous and
    every other stride free, a multiple of 4 (vector loads)."""
    capi.check(_OP, name, t, dtype, shape, device, contiguous=False)
    if t.stride(3) != 1 or any(st % 4 for st in t.stride()[:3]):
        raise ValueError(f"{_OP}: {name} needs contiguous rows and strides "
                         f"that are multiples of 4, got {t.stride()}")


def _check(q, k, v, pos, window, softcap, dev):
    """The kernel's rules on its inputs (on ``dev``)."""
    b, h, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    capi.check(_OP, "q", q, DTYPES, (b, h, d), dev)
    _check_cache("k", k, q.dtype, (b, kh, t, d), dev)
    _check_cache("v", v, q.dtype, (b, kh, t, d), dev)
    if v.stride() != k.stride():
        raise ValueError(f"{_OP}: k and v have strides {k.stride()} and "
                         f"{v.stride()}; the kernel takes one set")
    check_heads(_OP, q, k, v, h, kh, d)
    if t < 1:
        raise ValueError(f"{_OP}: the cache holds no slot")
    if (h // kh) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"{_OP}: {h // kh} heads x {d} per KV head exceed "
                         f"{MAX_GROUP_WIDTH} values")
    if window is not None and window <= 0:
        raise ValueError(f"{_OP}: window={window} must be positive")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{_OP}: softcap={softcap} must be positive")
    if isinstance(pos, torch.Tensor) and pos.numel() != 1:
        raise ValueError(f"{_OP}: pos must be a scalar")


def prepare(q, k, v, pos, *, scale=None, window=None, softcap=None):
    """Returns ``(args, out, keep)``: the C entry's arguments, the output
    tensor and the tensors ``args`` points into.  ``pos`` is a Python int
    (passed by value) or an integer tensor on the card (read there)."""
    reject("decode_attention", q, k, v)
    dev = capi.require_cuda(_OP, q)
    _check(q, k, v, pos, window, softcap, dev)
    b, h, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    pos_t = None
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=dev, dtype=torch.int32).reshape(1)
        pos_val = 0
    else:
        pos_val = int(pos)
    scale = d ** -0.5 if scale is None else scale
    n_split, per = split_plan(b, kh, t, _sm_count(dev.index))
    o = torch.empty_like(q)
    # Each split's acc [G, D], then its (m, l) per head, in float32.
    part = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                       device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part.data_ptr(), int(q.dtype == torch.bfloat16), b, h, kh, t, d,
            float(np.float32(scale)), 0 if window is None else int(window),
            int(softcap is not None),
            float(np.float32(0.0 if softcap is None else softcap)),
            capi.ptr(pos_t), pos_val, *k.stride()[:3], n_split, per,
            capi.stream(dev))
    return args, o, (q, k, v, pos_t, part)


def decode_attention_meta(q, k, v, pos, *, scale=None, window=None,
                          softcap=None):
    """The output on the meta device after :func:`prepare`'s checks: the
    dry run's stand-in for a launch.  ``pos`` must be a Python int there:
    the live slots, and so the work, follow its value."""
    reject("decode_attention", q, k, v)
    dev = capi.require_meta(_OP, q)
    _check(q, k, v, pos, window, softcap, dev)
    if isinstance(pos, torch.Tensor):
        raise ValueError(f"{_OP}: on the meta device pos must be a Python "
                         "int (the live slots follow its value)")
    return torch.empty_like(q)


def live_slots(t: int, pos: int, window=None) -> int:
    """Ring slots that hold a live key at ``pos``: slot i holds position
    pos - ((pos - i) mod t), live when it is >= 0 and within the window."""
    if pos < 0:
        return 0
    return min(t, pos + 1, t if window is None else window)


def cost(q, k, v, pos: int, *, window=None):
    """(operations, bytes) of one call at write position ``pos``: two
    products of 2·D a live slot for each query head, q read and o written
    once, the K and V rows of the live slots read once.  With no live slot
    the answer is the mean of V (each row read, D adds a head)."""
    b, h, d = q.shape
    t = k.shape[2]
    live = live_slots(t, int(pos), window)
    if live == 0:
        return 2 * d * h * b * t, 2 * capi.nbytes(q) + capi.nbytes(v)
    return (4 * d * h * b * live,
            2 * capi.nbytes(q) + capi.nbytes(k, v) * live // t)


def launch(args) -> None:
    """One call (split and combine kernels) on prepared arguments; does not
    count."""
    capi.raise_on_error(_OP, _fn()(*args))


def decode_attention_cuda(q, k, v, pos, *, scale=None, window=None,
                          softcap=None):
    """Decode attention on the card; the contract of
    :func:`repro_torch.kernels.decode_attention.ref.decode_attention_ref`."""
    args, out, _keep = prepare(q, k, v, pos, scale=scale, window=window,
                               softcap=softcap)
    launch(args)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
