"""Losses — ``repro.models.losses`` in PyTorch: the token-mean
cross-entropy from the final hidden states, taken in sequence chunks, and
HuBERT's masked-unit form of it.

The [B, S, V] float32 logits are never held at once: each chunk's logits
(``_ce_chunk``) run under ``torch.utils.checkpoint``, which keeps only the
chunk's inputs and recomputes its logits in the backward, so the peak is
one chunk's [B, S / n_chunks, V] and its softmax.  The recomputation runs
the same operations on the same inputs, so the numbers are those of the
forward.  The logits product ``h @ tokens.T`` is a plain matrix product
(``layers.unembed``), as in the reference, where XLA computes it.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import unembed
from repro_torch.shard.api import constrain

__all__ = ["chunked_ce_from_hidden", "masked_unit_ce"]


def _ce_chunk(embed_params, h, targets, mask, softcap):
    """h [B, C, D] -> (sum of nll, count) over the valid positions."""
    logits = unembed(embed_params, h, softcap=softcap)       # f32 [B, C, V]
    # Under a mesh the vocab dim is gathered: the row's log-sum-exp and the
    # target's logit are taken whole, as on one device.
    logits = constrain(logits, ("batch", "act_seq", None))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, targets.to(torch.int64)[..., None],
                               dim=-1)[..., 0]
    nll = (lse - tgt) * mask
    return nll.sum(), mask.sum()


def chunked_ce_from_hidden(embed_params, hidden, targets, mask=None, *,
                           softcap=None, n_chunks: int = 8,
                           unroll: bool = False):
    """Token-mean cross-entropy over ``n_chunks`` sequence chunks (fewer
    if the length does not divide: the reference's rule), the chunks'
    sums added in order.  ``unroll`` is the reference's scan option and is
    ignored."""
    del unroll
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    mask = mask.to(torch.float32)
    while s % n_chunks:
        n_chunks -= 1
    c = s // n_chunks
    if n_chunks <= 1:
        tot, cnt = _ce_chunk(embed_params, hidden, targets, mask, softcap)
        return tot / torch.clamp(cnt, min=1.0)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        dt, dc = checkpoint(_ce_chunk, embed_params, hidden[:, sl],
                            targets[:, sl], mask[:, sl], softcap,
                            use_reentrant=False)
        tot, cnt = tot + dt, cnt + dc
    return tot / torch.clamp(cnt, min=1.0)


def masked_unit_ce(embed_params, hidden, targets, mask, *, n_chunks: int = 8,
                   unroll: bool = False):
    """HuBERT-style masked-unit prediction: CE only on masked frames."""
    return chunked_ce_from_hidden(embed_params, hidden, targets, mask,
                                  n_chunks=n_chunks, unroll=unroll)
