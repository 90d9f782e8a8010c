"""The split search's ``w·y`` product sums in XLA's CPU order.

``repro.core.trees`` leaves the left-branch sums of its split search to an
XLA matrix product, ``[rows, M] x [M, F·T]``.  Its summation order depends
on the shape, and the port's ``trees._xla_dot`` reproduces it.  A last-bit
difference there flips a split only where two candidates' gains straddle a
quantization step, so the fit tests see it in about one fit in a thousand:
this pins the order itself, bitwise, at the widths of the repo's spaces
(F·T = 10, 15, 27, 35) and at a band (20) whose order depends on M mod 4.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.trees import _xla_dot

ROWS = (1, 2, 50, 51, 160)
# M of synthetic_job, of odd and even sizes around it, of the 69-point
# scout/hibench spaces, of tf-cnn and of its 512-point bucket.
POINTS = (24, 25, 26, 27, 69, 384, 512)


@pytest.mark.parametrize("j", [10, 15, 20, 27, 35])
def test_xla_dot_matches_jax_matmul_bitwise(j):
    rng = np.random.default_rng(j)
    dot = jax.jit(lambda a, b: a @ b)
    for k in POINTS:
        b = (rng.random((k, j)) < 0.5).astype(np.float32)
        for rows in ROWS:
            a = rng.standard_normal((rows, k)).astype(np.float32)
            want = np.asarray(dot(a, b))
            got = _xla_dot(torch.from_numpy(a), torch.from_numpy(b),
                           rows).numpy()
            assert want.tobytes() == got.tobytes(), (rows, k, j)
