"""Plain PyTorch version of the masked, quantized argmax — same contract
as the CUDA kernel in ``csrc/masked_argmax.cu``.

The PyTorch form of the kernel body of ``repro.analysis.fixtures.
_pallas_argmax``: ``argmax(quantize_scores(where(valid, score, -inf)))``,
or the argmax of the raw masked scores with ``quantize=False``.
``torch.argmax`` on the CPU takes ``jnp.argmax``'s semantics: a NaN is the
maximum (the first NaN wins), an exact tie goes to the lowest index, and
an all-invalid row gives 0.  It serves the CPU path, the tests and the
trace audit; on the card it is the kernel's yardstick (``chip_smoke.py``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.acquisition import quantize_scores

__all__ = ["masked_argmax_ref"]


def masked_argmax_ref(score, valid, *, quantize: bool = True):
    """score f32 [M], valid bool [M] -> the selected index, int32 [1]."""
    masked = torch.where(valid, score, torch.full_like(score, -math.inf))
    if quantize:
        masked = quantize_scores(masked)
    return torch.argmax(masked).to(torch.int32).reshape(1)
