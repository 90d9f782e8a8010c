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
are checked.
"""

import numpy as np
import pytest
import torch

from repro.analysis.fixtures import _pallas_argmax
from repro_torch.kernels import masked_argmax
from repro_torch.kernels.masked_argmax import kernel as tkernel

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
