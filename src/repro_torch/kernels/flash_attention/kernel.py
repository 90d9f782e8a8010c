"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

:func:`prepare` checks the inputs and allocates the output, :func:`launch`
launches once on prepared arguments, and :func:`flash_attention_cuda` does
both and counts the launch in ``flash_attention_cuda.launches`` (and
nowhere else).  The C entry routes by dtype: bfloat16 to the tensor-core
kernel (``mma.sync`` with ``cp.async`` loads), float32 to the CUDA-core
kernel, which keeps the float32 contract that TF32 would break.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import capi

__all__ = ["flash_attention_cuda", "launch", "prepare"]

_OP = "flash_attention"
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _fn():
    return capi.entry(_OP, "flash_attention_launch",
                      [capi.P] * 4 + [capi.I] * 7
                      + [capi.F, capi.I, capi.I, capi.I, capi.F, capi.P])


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


def prepare(q, k, v, *, scale=None, causal=True, window=None,
            softcap=None):
    """Returns ``(args, out, keep)``: the C entry's arguments, the output
    tensor and the inputs ``args`` points into."""
    dev = capi.require_cuda(_OP, q)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    capi.check(_OP, "q", q, DTYPES, (b, h, s, d), dev)
    capi.check(_OP, "k", k, DTYPES, (b, kh, t, d), dev)
    capi.check(_OP, "v", v, DTYPES, (b, kh, t, d), dev)
    check_heads(_OP, q, k, v, h, kh, d)
    if window is not None and window <= 0:
        raise ValueError(f"{_OP}: window={window} must be positive")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, kh, s, t, d,
            float(np.float32(scale)), int(bool(causal)),
            0 if window is None else int(window), int(softcap is not None),
            float(np.float32(0.0 if softcap is None else softcap)),
            capi.stream(dev))
    return args, o, (q, k, v)


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def flash_attention_cuda(q, k, v, *, scale=None, causal=True, window=None,
                         softcap=None):
    """Attention on the card; the contract of
    :func:`repro_torch.kernels.flash_attention.ref.attention_ref`."""
    args, out, _keep = prepare(q, k, v, scale=scale, causal=causal,
                               window=window, softcap=softcap)
    launch(args)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
