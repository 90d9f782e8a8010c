"""Threefry-2x32 counter-based PRNG, bit-compatible with ``jax.random``.

The reference draws every random bit of the decision path through
``jax.random`` (the per-run key in ``optimizer.optimize``, the per-state
``fold_in`` in ``lookahead._fit_batch_exact``, the per-point ``fold_in`` and
``uniform`` of ``trees.bootstrap_weights``).  Reproducing its decisions bit
for bit therefore needs the same generator: Threefry-2x32 (20 rounds) in
the ``jax_threefry_partitionable=True`` layout, where element ``i`` of a
draw hashes the counter pair ``(i >> 32, i & 0xffffffff)``.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  All word
arithmetic runs in int64 masked to 32 bits (torch has no full uint32
arithmetic); every function broadcasts over leading key dimensions, which
replaces the reference's ``vmap`` over keys.
"""

from __future__ import annotations

import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function on broadcastable uint32-in-int64
    tensors; returns the two output words.  The rounds update two fresh
    buffers in place (the bulk of a bootstrap draw's time is here)."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    x1, x2 = torch.broadcast_tensors(x1, x2)
    x1, x2 = x1.contiguous(), x2.contiguous()
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(_MASK)
            hi = x2 << r                            # rotate left by r ...
            x2.bitwise_right_shift_(32 - r).bitwise_or_(hi)
            x2.bitwise_and_(_MASK).bitwise_xor_(x1)  # ... then mix in x1
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is cut
    to its low 32 bits, and the high key word is 0.

    The key stays on the CPU by default, unlike the port's entry points:
    it is a two-word host value that runs no work, and the loops keep it
    and its splits on the host (``optimizer.optimize``); the selectors
    copy each step's key to their device."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key ``[..., 2]`` -> ``[..., num, 2]``."""
    k1, k2 = key[..., 0, None], key[..., 1, None]
    cnt = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key ``[..., 2]`` and integer ``data``
    (broadcast against the key's leading dims) -> ``[..., 2]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit words of ``jax.random.bits``: key ``[..., 2]`` ->
    ``[..., *shape]`` uint32 values in int64."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32: the top 23
    bits become the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
