"""Dispatching entry of single-token attention over a ring KV cache."""

from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.kernels.dispatch import (declare_kernel, report_cost,
                                         require_no_grad, resolve_mode)
from repro_torch.shard.local import any_dtensor, reject, run_local

__all__ = ["decode_attention"]

# The operands' logical axes (q [B, H, D]; the caches, [B, KH, T, D] views
# of the [B, T, KH, D] ring buffers).
_Q_AXES = ("batch", "act_heads", None)
_KV_AXES = ("batch", "act_kv_heads", "cache_seq", None)


def decode_attention(q, k, v, pos, *, scale=None, window=None,
                     softcap=None, bk=1024, force: str = "auto"):
    """q [B, H, D]; k, v [B, KH, T, D] ring caches; ``pos`` the scalar write
    position (a Python int or an integer tensor) -> [B, H, D].

    The kernel for CUDA tensors, the plain version for CPU tensors, the
    meta branch for meta tensors (``pos`` a Python int there; see
    ``kernels.dispatch``); DTensor operands run it on each rank's shard of
    batch and heads (``shard.local``).  ``softcap`` caps the scores as the
    JAX model's ``attend`` does (the TPU kernel has none).  ``bk`` is the
    TPU kernel's key block, kept for its signature; the CUDA kernel picks
    its own.
    """
    del bk
    kw = dict(scale=scale, window=window, softcap=softcap)
    if any_dtensor(q, k, v):
        return run_local(
            "decode_attention",
            lambda q, k, v: decode_attention(q, k, v, pos, force=force,
                                             **kw),
            [(q, _Q_AXES), (k, _KV_AXES), (v, _KV_AXES)], heads=(1, 1, 1),
            groups=((0, 1), (0, 2)), outputs=((0, 1),))
    plain = lambda: _ref.decode_attention_ref(q, k, v, pos, **kw)
    mode = resolve_mode(force, q.device, op="decode_attention")
    if mode == "ref":
        return plain()
    require_no_grad("decode_attention", q, k, v)
    if mode == "meta":
        out = _kernel.decode_attention_meta(q, k, v, pos, **kw)
        report_cost("decode_attention", *_kernel.cost(
            q, k, v, pos, window=window))
        return out
    out = _kernel.decode_attention_cuda(q, k, v, pos, **kw)
    declare_kernel("decode_attention", out, plain)
    return out
