"""Wrapper of the CUDA chunked-SSD kernels (``csrc/ssm_scan.cu``).

:func:`plan` checks the inputs and returns the launch geometry,
:func:`prepare` allocates the outputs and the chunk-state scratch,
:func:`launch` launches once on prepared arguments (three kernels on the
current stream: chunk state, state passing, chunk scan), and
:func:`ssm_scan_cuda` does all of it and counts the call in
``ssm_scan_cuda.launches`` (and nowhere else).

k, q and v are read through their strides, so the views the Mamba2 block
hands over go in as they are: B and C broadcast over the heads (head
stride 0) and the head-split slice of the conv output.  Nothing is
copied but an ``initial_state`` that is not float32 and contiguous.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import capi

__all__ = ["PHASES", "Plan", "launch", "plan", "prepare", "smem_bytes",
           "ssm_scan_cuda"]

_OP = "ssm_scan"
DTYPES = (torch.float32, torch.bfloat16)
ROWS = 64                # rows of a query, key or slab tile
P_TILE = 64              # columns of y and of the state a block computes
N_TILE = 64              # rows of the state a chunk-state block computes
N_SLAB = 64              # columns of N a chunk-scan stage holds
SMEM_LIMIT = 232448      # dynamic shared memory a block may opt in to
MAX_CHUNKS = 65535       # the chunk index is a grid dimension
_STRIDES = ctypes.c_longlong * 18
# The call's three kernels, in launch order; bit i of a launch's phase mask
# selects PHASES[i].
PHASES = ("ssm_chunk_state_kernel", "ssm_state_pass_kernel",
          "ssm_chunk_scan_kernel")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(n: int, chunk: int, bf16: bool) -> tuple[int, int]:
    """Shared bytes of the chunk-state and the chunk-scan kernels (the
    sizes ``csrc/ssm_scan.cu`` computes).  Both hold the chunk's cumsum
    (float64) and gate; the first a two-stage ring of 64-row k and v slabs
    of 64 columns, the second a two-stage ring whose stage holds a 64-row q
    slab of 64 columns of N, k's slab of the same shape or the previous
    state's [64, 64] slab, and a v tile.  N streams through both in 64-wide
    pieces, so ``n`` does not change the sizes: only the chunk does."""
    del n
    el = 2 if bf16 else 4
    q_pad, vs, ss = (8, 72, 68) if bf16 else (4, 68, 72)
    cum = 12 * _round_up(chunk, ROWS)
    state = cum + 2 * 2 * ROWS * 72 * el
    q_slab = ROWS * (N_SLAB + q_pad) * el
    stage = q_slab + max(q_slab, N_SLAB * ss * 4) + ROWS * vs * el
    return state, cum + 2 * stage


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's geometry: sizes, the three grids and shared bytes."""
    b: int
    l: int
    h: int
    n: int
    p: int
    chunk: int
    chunks: int
    bf16: bool
    vec: int                 # bits: k, q, v copied in 16-byte pieces
    grids: tuple             # chunk state, state passing, chunk scan
    smem: tuple              # shared bytes of the first and the third


def _vec16(t: torch.Tensor) -> bool:
    """Rows of ``t`` may go in 16-byte copies: the last stride 1, the other
    strides and the offset into its (aligned) storage 16-byte aligned."""
    e = 16 // t.element_size()
    return (t.stride(-1) == 1 and all(s % e == 0 for s in t.stride()[:-1])
            and t.storage_offset() % e == 0)


def plan(k, v, q, log_decay, gate, *, chunk: int,
         initial_state=None) -> Plan:
    """Check the inputs (device, dtypes, shapes) and the limits of the
    kernels, and return the launch geometry.  Raises ``ValueError`` for
    what the kernels cannot take: an empty input, chunk < 1, more than
    65535 chunks, or a chunk whose cumsum overflows a block's shared
    memory (any N fits: it streams through in slabs)."""
    dev = capi.require_cuda(_OP, k)
    b, l, h, n = k.shape
    p = v.shape[-1]
    for name, t, dtype, shape in (
            ("k", k, DTYPES, (b, l, h, n)), ("q", q, k.dtype, (b, l, h, n)),
            ("v", v, k.dtype, (b, l, h, p)),
            ("log_decay", log_decay, torch.float32, (b, l, h)),
            ("gate", gate, torch.float32, (b, l, h))):
        capi.check(_OP, name, t, dtype, shape, dev, contiguous=False)
    if initial_state is not None:
        capi.check(_OP, "initial_state", initial_state, DTYPES,
                   (b, h, n, p), dev, contiguous=False)
    if min(b, l, h, n, p) < 1:
        raise ValueError(f"{_OP}: empty input {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if chunk < 1:
        raise ValueError(f"{_OP}: chunk={chunk} must be positive")
    # A chunk longer than L is the padded single chunk: the same function.
    chunk = min(int(chunk), l)
    chunks = -(-l // chunk)
    if chunks > MAX_CHUNKS:
        raise ValueError(f"{_OP}: {chunks} chunks of {chunk} rows; the "
                         f"chunk index is a grid dimension (at most "
                         f"{MAX_CHUNKS})")
    bf16 = k.dtype == torch.bfloat16
    smem = smem_bytes(n, chunk, bf16)
    if max(smem) > SMEM_LIMIT:
        raise ValueError(
            f"{_OP}: chunk {chunk} needs {max(smem)} bytes of shared "
            f"memory a block (limit {SMEM_LIMIT}): the kernels keep the "
            f"chunk's cumsum and gate, 12 bytes a row, beside their rings")
    vec = sum(bit for bit, t in ((1, k), (2, q), (4, v)) if _vec16(t))
    n_p = -(-p // P_TILE)
    # The state-passing kernel takes 4 elements a thread (float4) where N·P
    # is a multiple of 4, else 1, 256 threads a block.
    per_block = 256 * (4 if n * p % 4 == 0 else 1)
    grids = ((b * h, chunks, -(-n // N_TILE) * n_p),
             (b * h, -(-(n * p) // per_block)),
             (b * h, chunks, -(-chunk // ROWS) * n_p))
    return Plan(b, l, h, n, p, chunk, chunks, bf16, vec, grids, smem)


def _fn():
    return capi.entry(_OP, "ssm_scan_launch",
                      [capi.P] * 12 + [ctypes.POINTER(ctypes.c_longlong)]
                      + [capi.I] * 9 + [capi.P])


def prepare(k, v, q, log_decay, gate, *, chunk: int, initial_state=None):
    """Returns ``(args, (y, state), keep)``: the C entry's arguments, the
    outputs and the tensors ``args`` points into (the scratch among
    them)."""
    pl = plan(k, v, q, log_decay, gate, chunk=chunk,
              initial_state=initial_state)
    _fn()                     # built (or its build error raised) first
    dev = k.device
    s0 = None
    if initial_state is not None:
        s0 = initial_state.to(torch.float32).contiguous()
    b, l, h, n, p = pl.b, pl.l, pl.h, pl.n, pl.p
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=dev)
    s = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    # dS_c of each chunk, then S_{c-1} in its place; exp(total_c).
    ds = torch.empty((b, h, pl.chunks, n, p), dtype=torch.float32,
                     device=dev)
    etot = torch.empty((b, h, pl.chunks), dtype=torch.float32, device=dev)
    # The chunks' cumsum of log_decay and gate, rows padded to 64.  The
    # kernel keeps the cumsum in float64; to the host it is opaque 8-byte
    # scratch (no float64 tensor: the determinism gate's rule R4).
    pad = _round_up(pl.chunk, ROWS)
    cum = torch.empty((b, h, pl.chunks, pad), dtype=torch.int64, device=dev)
    gts = torch.empty((b, h, pl.chunks, pad), dtype=torch.float32,
                      device=dev)
    strides = _STRIDES(*k.stride(), *q.stride(), *v.stride(),
                       *log_decay.stride(), *gate.stride())
    args = (k.data_ptr(), q.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            gate.data_ptr(), capi.ptr(s0), y.data_ptr(), s.data_ptr(),
            ds.data_ptr(), etot.data_ptr(), cum.data_ptr(), gts.data_ptr(),
            strides, int(pl.bf16),
            pl.vec if all(t.data_ptr() % 16 == 0 for t in (k, q, v)) else 0,
            b, l, h, n, p, pl.chunk, capi.stream(dev))
    return args, (y, s), (k, v, q, log_decay, gate, s0, ds, etot, cum, gts)


def launch(args, phases: int = 7) -> None:
    """One call on prepared arguments (the three kernels; ``phases``, a
    mask over :data:`PHASES`, launches some of them alone, for timing);
    does not count."""
    capi.raise_on_error(_OP, _fn()(*args[:-1], phases, args[-1]))


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
