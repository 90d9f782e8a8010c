"""Dispatching entry of train/prefill attention."""

from __future__ import annotations

from repro_torch.kernels.dispatch import declare_kernel, resolve_mode
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, scale=None, causal=True, window=None,
                    softcap=None, bq=128, bk=512, force: str = "auto"):
    """q [B, H, S, D]; k, v [B, KH, T, D] -> [B, H, S, D] in q's dtype.

    The kernel for CUDA tensors, the plain version for CPU tensors (see
    ``kernels.dispatch``).  ``bq``/``bk`` are the TPU kernel's tiles, kept
    for its signature; the CUDA kernel picks its own.
    """
    del bq, bk
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    plain = lambda: _ref.attention_ref(q, k, v, **kw)
    if resolve_mode(force, q.device, op="flash_attention") == "ref":
        return plain()
    out = _kernel.flash_attention_cuda(q, k, v, **kw)
    declare_kernel("flash_attention", out, plain)
    return out
