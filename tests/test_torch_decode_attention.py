"""The port's decode attention op against ``repro.kernels.decode_attention``.

On CPU tensors ``repro_torch.kernels.decode_attention`` runs its plain
version.  It is held against the JAX package's ``decode_attention_ref`` and
its Pallas kernel in interpret mode, over the shapes and tolerances of
``tests/test_kernels.py`` (2e-5 in float32, 5e-2 in bfloat16): a cache
with empty slots past ``pos``, ring rollover (pos > T) and a sliding
window; and with ``pos`` given as an int32 tensor.  The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``; here its
wrapper's dispatch rules are checked, its split plan (``split_plan``) and,
written out in plain PyTorch, the arithmetic of its two kernels: softmax
partials per split of the cache, combined in split order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_call
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels import decode_attention
from repro_torch.kernels.decode_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ref import NEG

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _inputs(b, h, kh, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, d)).astype(np.float32),
            rng.normal(size=(b, kh, t, d)).astype(np.float32),
            rng.normal(size=(b, kh, t, d)).astype(np.float32))


def _f32(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("b,h,kh,t,d,pos,window", [
    (2, 4, 2, 256, 64, 100, None),
    (1, 8, 1, 512, 32, 900, None),    # ring rollover (pos > t)
    (2, 4, 4, 256, 64, 300, 64),      # sliding window
    (1, 16, 8, 128, 256, 300, 128),   # gemma2-9b heads, window = T
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos_as", ["int", "tensor"])
def test_matches_jax_ref_and_interpret(b, h, kh, t, d, pos, window, dtype,
                                       pos_as):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(b, h, kh, t, d, seed=t + d + pos)
    tpos = pos if pos_as == "int" else torch.tensor(pos, dtype=torch.int32)
    got = decode_attention(*(torch.as_tensor(a).to(tdt) for a in arrs),
                           tpos, window=window)
    assert got.dtype == tdt and got.shape == (b, h, d)
    j = tuple(jnp.asarray(a, jdt) for a in arrs)
    for want in (decode_attention_ref(*j, pos, window=window),
                 decode_attention_call(*j, pos, window=window, bk=128,
                                       interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_ring_positions_use_floor_modulo():
    """Slots past ``pos`` in a cache that has not rolled over are empty:
    the answer equals attention over slots 0..pos alone."""
    q, k, v = map(torch.as_tensor, _inputs(1, 2, 1, 64, 16, seed=3))
    got = decode_attention(q, k, v, 20)
    want = decode_attention(q, k[:, :, :21], v[:, :, :21], 20)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    q, k, v = map(torch.as_tensor, _inputs(1, 2, 1, 32, 16, seed=0))
    before = tkernel.decode_attention_cuda.launches
    out = decode_attention(q, k, v, 40, bk=8)
    assert out.shape == q.shape
    assert tkernel.decode_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, k, v, 40, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.decode_attention_cuda(q, k, v, 40)


H100_SMS = 132


@pytest.mark.parametrize("batch,n_kv,t", [
    (8, 8, 8192),      # gemma2-9b decode at B = 8: 5 splits
    (4, 32, 1032),     # zamba2-7b: 3 splits, a ragged last tile
    (1, 1, 64),        # one tile
    (1, 8, 100),       # fewer tiles than the card wants
    (2, 4, 4096),
    (33, 8, 8192),     # B·KH = 264 fills two waves alone
    (64, 8, 512),
])
def test_split_plan_covers_the_cache_in_whole_tiles(batch, n_kv, t):
    n_split, per = tkernel.split_plan(batch, n_kv, t, H100_SMS)
    n_tiles = -(-t // tkernel.TILE)
    bounds = [(i * per * tkernel.TILE, min(t, (i + 1) * per * tkernel.TILE))
              for i in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    assert all(lo < hi for lo, hi in bounds)                 # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % tkernel.TILE == 0 for lo, _ in bounds)   # whole tiles
    assert 1 <= n_split <= n_tiles
    if batch * n_kv >= 2 * H100_SMS:
        assert n_split == 1
    elif n_tiles >= -(-2 * H100_SMS // (batch * n_kv)):
        # Two waves of blocks unless T runs out of tiles first.
        assert batch * n_kv * n_split >= H100_SMS


def test_split_plan_depends_on_t_only():
    plans = {tkernel.split_plan(8, 8, 8192, H100_SMS) for _ in range(3)}
    assert plans == {(5, 26)}


def _split_combine(q, k, v, pos, n_split, window=None):
    """The two kernels' arithmetic in plain PyTorch: per split of whole
    64-slot tiles, the running max (from -0.7·f32max), the sum of p and
    p·V; then, in split order, o = Σ acc_i·e^(m_i - m) / Σ l_i·e^(m_i - m)."""
    h, d = q.shape[1:]
    kh, t = k.shape[1], k.shape[2]
    rep = h // kh
    kf = torch.repeat_interleave(k, rep, dim=1)
    vf = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhd,bhtd->bht", q, kf) * d ** -0.5
    slot = torch.arange(t)
    k_pos = pos - torch.remainder(pos - slot, t)
    ok = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        ok &= k_pos > pos - window
    s = torch.where(ok, s, NEG)
    n_tiles = -(-t // tkernel.TILE)
    per = -(-n_tiles // n_split)
    parts = []
    for lo in range(0, t, per * tkernel.TILE):
        hi = min(t, lo + per * tkernel.TILE)
        m = torch.clamp_min(s[..., lo:hi].amax(-1), NEG)
        p = torch.exp(s[..., lo:hi] - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bht,bhtd->bhd", p,
                                                 vf[:, :, lo:hi])))
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    num, den = 0.0, 0.0
    for mi, li, acc in parts:
        w = torch.exp(mi - m)
        num = num + acc * w[..., None]
        den = den + li * w
    return num / torch.clamp_min(den, 1e-30)[..., None]


@pytest.mark.parametrize("t,pos,window", [
    (256, 40, None),     # filling ring, pos < 64: splits 1.. all dead
    (256, -1, None),     # every slot dead: the mean of V
    (512, 900, None),    # rollover
    (512, 700, 200),     # rollover and a window
    (300, 250, None),    # a ragged last tile
])
@pytest.mark.parametrize("n_split", ["1", "2", "3", "T/64"])
def test_split_and_combine_matches_jax_ref(t, pos, window, n_split):
    n = -(-t // tkernel.TILE) if n_split == "T/64" else int(n_split)
    arrs = _inputs(2, 4, 2, t, 64, seed=t + abs(pos))
    got = _split_combine(*map(torch.as_tensor, arrs), pos, n, window)
    want = decode_attention_ref(*map(jnp.asarray, arrs), pos, window=window)
    np.testing.assert_allclose(got.numpy(), _f32(want), **_tol("float32"))
    if pos < 0:
        np.testing.assert_allclose(
            got.numpy(), np.broadcast_to(arrs[2].mean(axis=2).repeat(2, 1),
                                         got.shape), atol=2e-6, rtol=0)
