"""Wrapper of the CUDA masked-argmax kernel (``csrc/masked_argmax.cu``).

:func:`plan` picks the launch (one block for a small row, about two blocks
an SM for a large one), :func:`prepare` checks the inputs and allocates
the output, :func:`launch` launches once on prepared arguments, and
:func:`masked_argmax_cuda` does both and counts the launch in
``masked_argmax_cuda.launches`` (and nowhere else).

A launch of more than one block combines the blocks' keys in the same
launch, through a scratch of one 64-bit slot a block and a ticket that the
last block resets to 0.  The scratch is allocated once per (device,
stream) and kept: launches on one stream run in order, so they share it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import capi

__all__ = ["Plan", "attributes", "launch", "masked_argmax_cuda", "plan",
           "prepare"]

_OP = "masked_argmax"
MAX_THREADS = 512        # threads a block (the kernel's __launch_bounds__)
SINGLE_MAX = 16384       # lanes up to which one block takes the row
LANES_A_THREAD = 8       # two float4 loads of scores a trip
BLOCKS_PER_SM = 2
MAX_M = 2 ** 30          # lanes, so that no index + grid stride overflows


class Plan(NamedTuple):
    """Launch geometry: ``grid`` blocks of ``threads`` threads."""

    grid: int
    threads: int


def plan(m_dim: int, sm_count: int) -> Plan:
    """One block of as few warps as four lanes a thread need, up to
    ``SINGLE_MAX`` lanes (the gate's 16, the selector's 384: the launch
    stays at the latency floor and needs no scratch); beyond it
    ``MAX_THREADS`` threads a block and as many blocks as give each thread
    ``LANES_A_THREAD`` lanes, at most ``BLOCKS_PER_SM`` an SM."""
    if m_dim < 0 or sm_count < 1:
        raise ValueError(f"{_OP}: M = {m_dim}, {sm_count} SMs")
    if m_dim > MAX_M:
        raise ValueError(f"{_OP}: M = {m_dim}: the kernel indexes lanes "
                         f"with 32-bit ints (at most {MAX_M})")
    if m_dim <= SINGLE_MAX:
        quads = -(-m_dim // 4)
        return Plan(1, min(MAX_THREADS, max(32, -(-quads // 32) * 32)))
    grid = min(BLOCKS_PER_SM * sm_count,
               -(-m_dim // (LANES_A_THREAD * MAX_THREADS)))
    return Plan(max(1, grid), MAX_THREADS)


def _fn():
    return capi.entry(_OP, "masked_argmax_launch",
                      [capi.P, capi.P, capi.I, capi.I, capi.I, capi.I,
                       capi.P, capi.P, capi.P, capi.P])


def attributes() -> tuple[int, int]:
    """(registers a thread, local bytes) of the kernel, as the card's
    loaded module reports them."""
    fn = capi.entry(_OP, "masked_argmax_attributes", [capi.P, capi.P])
    regs, local = ctypes.c_int(), ctypes.c_int()
    capi.raise_on_error(_OP, fn(ctypes.addressof(regs),
                                ctypes.addressof(local)))
    return regs.value, local.value


def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_scratch: dict[tuple[int, int], torch.Tensor] = {}


def _scratch_for(dev, stream: int, slots: int) -> torch.Tensor:
    """int64 [slots + 1]: one slot a block, then the ticket (zeroed here,
    and reset to 0 by the last block of every launch)."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < slots + 1:
        buf = torch.zeros((slots + 1,), dtype=torch.int64, device=dev)
        _scratch[key] = buf
    return buf


def prepare(score, valid, *, quantize: bool = True):
    """Returns ``(args, out, keep)``: the C entry's arguments, the output
    index [1] and the tensors ``args`` points into."""
    dev = capi.require_cuda(_OP, score)
    m_dim = score.shape[0]
    capi.check(_OP, "score", score, torch.float32, (m_dim,), dev)
    capi.check(_OP, "valid", valid, torch.bool, (m_dim,), dev)
    sms = _sm_count(dev.index)
    geo = plan(m_dim, sms)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    stream = capi.stream(dev)
    slots = ticket = None
    keep = (score, valid)
    if geo.grid > 1:
        buf = _scratch_for(dev, stream, BLOCKS_PER_SM * sms)
        slots = buf.data_ptr()
        ticket = slots + 8 * (buf.numel() - 1)
        keep += (buf,)
    args = (score.data_ptr(), valid.data_ptr(), m_dim, int(bool(quantize)),
            geo.grid, geo.threads, slots, ticket, out.data_ptr(), stream)
    return args, out, keep


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def masked_argmax_cuda(score, valid, *, quantize: bool = True):
    """The selected index [1] int32 on the card; the contract of
    :func:`repro_torch.kernels.masked_argmax.ref.masked_argmax_ref`."""
    args, out, _keep = prepare(score, valid, quantize=quantize)
    launch(args)
    masked_argmax_cuda.launches += 1
    return out


masked_argmax_cuda.launches = 0
