"""Wrapper of the CUDA chunked-SSD kernel (``csrc/ssm_scan.cu``).

:func:`prepare` checks the inputs and allocates the outputs, :func:`launch`
launches once on prepared arguments, and :func:`ssm_scan_cuda` does both
and counts the launch in ``ssm_scan_cuda.launches`` (and nowhere else).

k, q and v are read through their strides, so the views the Mamba2 block
hands over go in as they are: B and C broadcast over the heads (head
stride 0) and the head-split slice of the conv output.  Nothing is
copied but an ``initial_state`` that is not float32 and contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import capi

__all__ = ["ssm_scan_cuda", "launch", "prepare", "smem_bytes"]

_OP = "ssm_scan"
DTYPES = (torch.float32, torch.bfloat16)
MAX_N = 64               # state width N and value width P the kernel holds
MAX_P = 64
TILE = 64                # rows of a query or key tile
SMEM_LIMIT = 232448      # dynamic shared memory a block may opt in to
_STRIDES = ctypes.c_longlong * 18


def smem_bytes(chunk: int) -> int:
    """Q, K, V, score and state tiles (float32), then a chunk's cumsum
    (float64), gate, exp(cum) and state weights (float32)."""
    return 4 * (5 * TILE * (TILE + 4) + 5 * chunk)


def _fn():
    return capi.entry(_OP, "ssm_scan_launch",
                      [capi.P] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                      + [capi.I] * 7 + [capi.P])


def prepare(k, v, q, log_decay, gate, *, chunk: int, initial_state=None):
    """Returns ``(args, (y, state), keep)``: the C entry's arguments, the
    outputs and the tensors ``args`` points into."""
    dev = capi.require_cuda(_OP, k)
    _fn()                     # built (or its build error raised) first
    b, l, h, n = k.shape
    p = v.shape[-1]
    for name, t, dtype, shape in (
            ("k", k, DTYPES, (b, l, h, n)), ("q", q, k.dtype, (b, l, h, n)),
            ("v", v, k.dtype, (b, l, h, p)),
            ("log_decay", log_decay, torch.float32, (b, l, h)),
            ("gate", gate, torch.float32, (b, l, h))):
        capi.check(_OP, name, t, dtype, shape, dev, contiguous=False)
    if not (0 < n <= MAX_N and 0 < p <= MAX_P):
        raise ValueError(f"{_OP}: N = {n}, P = {p}; the kernel takes "
                         f"N <= {MAX_N} and P <= {MAX_P}")
    if l < 1 or b * h < 1:
        raise ValueError(f"{_OP}: empty input {tuple(k.shape)}")
    if chunk < 1:
        raise ValueError(f"{_OP}: chunk={chunk} must be positive")
    # A chunk longer than L is the padded single chunk: the same function.
    chunk = min(int(chunk), l)
    if smem_bytes(chunk) > SMEM_LIMIT:
        raise ValueError(f"{_OP}: chunk {chunk} needs {smem_bytes(chunk)} "
                         f"bytes of shared memory (limit {SMEM_LIMIT})")
    s0 = None
    if initial_state is not None:
        capi.check(_OP, "initial_state", initial_state, DTYPES,
                   (b, h, n, p), dev, contiguous=False)
        s0 = initial_state.to(torch.float32).contiguous()
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=dev)
    s = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    strides = _STRIDES(*k.stride(), *q.stride(), *v.stride(),
                       *log_decay.stride(), *gate.stride())
    args = (k.data_ptr(), q.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            gate.data_ptr(), capi.ptr(s0), y.data_ptr(), s.data_ptr(),
            strides, int(k.dtype == torch.bfloat16), b, l, h, n, p, chunk,
            capi.stream(dev))
    return args, (y, s), (k, v, q, log_decay, gate, s0)


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def ssm_scan_cuda(k, v, q, log_decay, gate, *, chunk: int,
                  initial_state=None):
    """The scan on the card -> (y, final_state); the contract of
    :func:`repro_torch.kernels.ssm_scan.ref.linear_scan_ref`."""
    args, out, _keep = prepare(k, v, q, log_decay, gate, chunk=chunk,
                               initial_state=initial_state)
    launch(args)
    ssm_scan_cuda.launches += 1
    return out


ssm_scan_cuda.launches = 0
