"""The port's masked, quantized argmax against the JAX package's kernel
fixture, ``repro.analysis.fixtures._pallas_argmax``.

On CPU tensors ``repro_torch.kernels.masked_argmax`` runs its plain
version.  Both variants — quantized, and the fixture's broken twin that
argmaxes the raw masked scores — are held against the fixture's Pallas
kernel in interpret mode, as the reference runs it, on inputs made with
numpy from a seed at M = 16 (the fixture's width) and M = 384 (the
selector's largest space): random scores, near-ties that quantizing makes
exact (where the two variants must differ), exact ties, NaN, -0.0 against
+0.0, infinities and an all-invalid row.  The index must be equal exactly.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` (phase ``analysis``); here its wrapper's dispatch rules
and launch plan are checked, and its arithmetic in plain PyTorch: the
index of the maximum 64-bit lane key equals the fixture's at M = 16, 384
and 4096, and so does the maximum of per-tile maxima for several tilings.
"""

import numpy as np
import pytest
import torch

from repro.analysis.fixtures import _pallas_argmax
from repro_torch.kernels import masked_argmax
from repro_torch.kernels.masked_argmax import kernel as tkernel
from repro_torch.kernels.masked_argmax.ref import (argmax_keys, key_index,
                                                   masked_argmax_ref)

torch.set_num_threads(1)


def _case(kind, m, seed):
    rng = np.random.default_rng(seed)
    score = rng.normal(size=m).astype(np.float32)
    valid = rng.random(m) < 0.7
    i, j = sorted(rng.choice(m, 2, replace=False))
    valid[[i, j]] = True
    top = np.float32(np.abs(score).max() + 1)
    if kind == "near_tie":
        # j > i is larger by one ulp: the raw argmax takes j, the quantized
        # one sees an exact tie and takes i.
        score[i] = top
        score[j] = np.nextafter(top, np.float32(np.inf))
    elif kind == "exact_tie":
        score[i] = score[j] = top
    elif kind == "nan":
        score[j] = np.nan
        score[i] = np.nan
        score[0] = np.nan
        valid[0] = False                       # a masked NaN is -inf
    elif kind == "signed_zero":
        score = -np.abs(score) - 1
        score[i] = np.float32(-0.0)
        score[j] = np.float32(0.0)
    elif kind == "inf":
        score[i] = np.inf
        score[j] = np.inf
        score[(j + 1) % m] = -np.inf
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "all_neg_inf":
        score[:] = -np.inf
    return score, valid


KINDS = ["random", "near_tie", "exact_tie", "nan", "signed_zero", "inf",
         "all_invalid", "all_neg_inf"]


@pytest.mark.parametrize("m", [16, 384])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_jax_fixture_kernel(kind, m):
    score, valid = _case(kind, m, seed=m + KINDS.index(kind))
    got = {}
    for quantize in (True, False):
        fn, _, _ = _pallas_argmax(not quantize)
        want = np.asarray(fn(score, valid))
        out = masked_argmax(torch.as_tensor(score), torch.as_tensor(valid),
                            quantize=quantize)
        assert out.dtype == torch.int32 and out.shape == (1,)
        assert want.dtype == np.int32 and want.shape == (1,)
        assert int(out[0]) == int(want[0]), (kind, m, quantize)
        got[quantize] = int(out[0])
    if kind == "near_tie":
        assert got[True] != got[False]
    if kind in ("all_invalid", "all_neg_inf"):
        assert got[True] == got[False] == 0


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    score, valid = map(torch.as_tensor, _case("random", 16, seed=1))
    before = tkernel.masked_argmax_cuda.launches
    out = masked_argmax(score, valid)
    assert out.shape == (1,) and bool(valid[out[0]])
    assert tkernel.masked_argmax_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        masked_argmax(score, valid, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.masked_argmax_cuda(score, valid)


# The redesigned kernel's arithmetic in plain PyTorch: every lane's 64-bit
# key (``ref.argmax_keys``), whose maximum is the argmax in any order.
KEY_WIDTHS = [16, 384, 4096]


@pytest.mark.parametrize("m", KEY_WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_max_key_is_the_argmax_of_the_jax_fixture(kind, m):
    score, valid = _case(kind, m, seed=m + KINDS.index(kind))
    st, vt = torch.as_tensor(score), torch.as_tensor(valid)
    for quantize in (True, False):
        keys = argmax_keys(st, vt, quantize=quantize)
        assert keys.dtype == torch.int64 and keys.shape == (m,)
        assert len(set(keys.tolist())) == m          # one key a lane
        got = int(key_index(keys.max())[0])
        want = int(masked_argmax_ref(st, vt, quantize=quantize)[0])
        fn, _, _ = _pallas_argmax(not quantize)
        assert got == want == int(np.asarray(fn(score, valid))[0]), (
            kind, m, quantize)


def _tilings(m):
    """Lane groups of several tilings of [0, m): contiguous tiles, the
    kernel's float4 quads dealt to threads by a grid stride, and a tail."""
    lanes = np.arange(m)
    yield "one lane a tile", [lanes[i:i + 1] for i in range(m)]
    for size in (3, 64, 1000):
        yield f"tiles of {size}", [lanes[i:i + size]
                                   for i in range(0, m, size)]
    for threads in (32, 96, 512 * 7):
        quads = m // 4
        groups = [np.concatenate([np.arange(4 * g, 4 * g + 4)
                                  for g in range(t, quads, threads)] or
                                 [np.zeros(0, np.int64)])
                  for t in range(threads)]
        yield f"quads over {threads} threads", groups + [lanes[4 * quads:]]


@pytest.mark.parametrize("kind", KINDS)
def test_max_of_tile_maxima_is_the_argmax(kind):
    m = 4099                      # a tail that is not a whole quad
    score, valid = _case(kind, m, seed=7 + KINDS.index(kind))
    st, vt = torch.as_tensor(score), torch.as_tensor(valid)
    for quantize in (True, False):
        keys = argmax_keys(st, vt, quantize=quantize)
        want = int(masked_argmax_ref(st, vt, quantize=quantize)[0])
        for name, groups in _tilings(m):
            assert sorted(np.concatenate(groups).tolist()) == list(range(m))
            maxima = [keys[torch.as_tensor(g)].max() for g in groups
                      if len(g)]
            got = int(key_index(torch.stack(maxima).max())[0])
            assert got == want, (kind, quantize, name)


@pytest.mark.parametrize("m,grid,threads", [(0, 1, 32), (16, 1, 32),
                                            (384, 1, 96), (4096, 1, 512),
                                            (16384, 1, 512),
                                            (16385, 5, 512),
                                            (1 << 20, 256, 512),
                                            (1 << 24, 264, 512)])
def test_plan(m, grid, threads):
    """One block, of as few warps as four lanes a thread need, up to
    16384 lanes (no scratch); then about two blocks an SM of 512 threads."""
    p = tkernel.plan(m, sm_count=132)
    assert (p.grid, p.threads) == (grid, threads)
    assert p.grid <= 2 * 132 and p.threads % 32 == 0
    # Every lane has a thread: the single block covers the row in quads,
    # a grid's threads stride over it.
    assert p.grid > 1 or m <= tkernel.SINGLE_MAX


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="M = -1"):
        tkernel.plan(-1, sm_count=132)
    with pytest.raises(ValueError, match="32-bit"):
        tkernel.plan(2 ** 30 + 1, sm_count=132)
