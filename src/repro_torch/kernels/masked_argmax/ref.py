"""Plain PyTorch version of the masked, quantized argmax — same contract
as the CUDA kernel in ``csrc/masked_argmax.cu``.

The PyTorch form of the kernel body of ``repro.analysis.fixtures.
_pallas_argmax``: ``argmax(quantize_scores(where(valid, score, -inf)))``,
or the argmax of the raw masked scores with ``quantize=False``.
``torch.argmax`` on the CPU takes ``jnp.argmax``'s semantics: a NaN is the
maximum (the first NaN wins), an exact tie goes to the lowest index, and
an all-invalid row gives 0.  It serves the CPU path, the tests and the
trace audit; on the card it is the kernel's yardstick (``chip_smoke.py``).

:func:`argmax_keys` is the plain form of the kernel's 64-bit lane keys,
whose maximum is that argmax in any order of reduction; the tests hold it
to the plain version, and nothing on the card's path calls it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.acquisition import quantize_scores

__all__ = ["argmax_keys", "key_index", "masked_argmax_ref"]


def masked_argmax_ref(score, valid, *, quantize: bool = True):
    """score f32 [M], valid bool [M] -> the selected index, int32 [1]."""
    masked = torch.where(valid, score, torch.full_like(score, -math.inf))
    if quantize:
        masked = quantize_scores(masked)
    return torch.argmax(masked).to(torch.int32).reshape(1)


def argmax_keys(score, valid, *, quantize: bool = True):
    """score f32 [M], valid bool [M] -> the kernel's lane keys, int64 [M].

    The kernel's key is the unsigned 64-bit ``hi << 32 | lo``: ``hi`` the
    masked (quantized) value's bits in a monotone unsigned order, NaN as
    0xFFFFFFFF above +inf and -0.0 on +0.0's word; ``lo`` 0xFFFFFFFF minus
    the index, so that a tie goes to the lower index.  Here it is offset
    by -2^63 into int64, which keeps its order."""
    masked = torch.where(valid, score, torch.full_like(score, -math.inf))
    if quantize:
        masked = quantize_scores(masked)
    bits = masked.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(masked == 0, torch.zeros_like(bits), bits)
    hi = torch.where(bits >= 2 ** 31, 0xFFFFFFFF - bits, bits + 2 ** 31)
    hi = torch.where(torch.isnan(masked), torch.full_like(hi, 0xFFFFFFFF),
                     hi)
    lo = 0xFFFFFFFF - torch.arange(score.shape[0], device=score.device)
    return (hi - 2 ** 31) * 2 ** 32 + lo


def key_index(key):
    """The lane index a key of :func:`argmax_keys` carries, int32 [1]."""
    return (0xFFFFFFFF - (key & 0xFFFFFFFF)).to(torch.int32).reshape(1)
