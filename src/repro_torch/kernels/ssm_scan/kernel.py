"""Wrapper of the CUDA chunked-SSD kernels (``csrc/ssm_scan.cu``).

:func:`plan` checks the inputs and returns the launch geometry,
:func:`prepare` allocates the outputs and the chunk-state scratch,
:func:`launch` launches once on prepared arguments (three kernels on the
current stream: chunk state, state passing, chunk scan), and
:func:`ssm_scan_cuda` does all of it and counts the call in
``ssm_scan_cuda.launches`` (and nowhere else); with ``want_states`` it
also returns the states entering each chunk, which the backward reads.
:func:`plan_bwd`, :func:`prepare_bwd`, :func:`launch_bwd` and
:func:`ssm_scan_bwd_cuda` are the same for the backward
(``csrc/ssm_scan_bwd.cu``, float32 only), counted in
``ssm_scan_bwd_cuda.launches``.

k, q and v are read through their strides, so the views the Mamba2 block
hands over go in as they are: B and C broadcast over the heads (head
stride 0) and the head-split slice of the conv output.  Nothing is
copied but an ``initial_state`` that is not float32 and contiguous.

:func:`ssm_scan_meta` and :func:`ssm_scan_bwd_meta` run the same checks
on meta tensors and return empty outputs (the dry run's branch,
``kernels.dispatch``).  :func:`work` and :func:`work_bwd` count a call's
bytes and its operations by two algorithms, the recurrence and the
chunked form the kernels run; :func:`cost` and :func:`cost_bwd` give the
chunked form's.  ``chip_smoke.py``'s bounds and the dry run read them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import capi
from repro_torch.shard.local import reject

__all__ = ["BWD_PHASES", "BwdPlan", "PHASES", "Plan", "launch", "launch_bwd",
           "plan", "plan_bwd", "prepare", "prepare_bwd", "smem_bytes",
           "ssm_scan_bwd_cuda", "ssm_scan_cuda", "ssm_scan_meta",
           "ssm_scan_bwd_meta", "unique_bytes", "work", "work_bwd", "cost",
           "cost_bwd"]

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
    return _plan(k, v, q, log_decay, gate, chunk, initial_state,
                 capi.require_cuda(_OP, k))


def _plan(k, v, q, log_decay, gate, chunk, initial_state, dev) -> Plan:
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
    reject("ssm_scan", k, v, q, log_decay, gate, initial_state)
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
                  initial_state=None, want_states: bool = False):
    """The scan on the card -> (y, final_state); the contract of
    :func:`repro_torch.kernels.ssm_scan.ref.linear_scan_ref`.  With
    ``want_states``, (y, final_state, states [B, H, C, N, P]): the state
    entering each chunk, the scratch that the state-passing kernel leaves
    (``ref.linear_scan_fwd_ref``'s third output)."""
    args, out, keep = prepare(k, v, q, log_decay, gate, chunk=chunk,
                              initial_state=initial_state)
    launch(args)
    ssm_scan_cuda.launches += 1
    return (*out, keep[6]) if want_states else out


ssm_scan_cuda.launches = 0


def ssm_scan_meta(k, v, q, log_decay, gate, *, chunk: int,
                  initial_state=None, want_states: bool = False):
    """The outputs of :func:`ssm_scan_cuda` on the meta device after
    :func:`plan`'s checks: the dry run's stand-in for a launch."""
    reject("ssm_scan", k, v, q, log_decay, gate, initial_state)
    dev = capi.require_meta(_OP, k)
    pl = _plan(k, v, q, log_decay, gate, chunk, initial_state, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((pl.b, pl.l, pl.h, pl.p), **f32)
    s = torch.empty((pl.b, pl.h, pl.n, pl.p), **f32)
    if not want_states:
        return y, s
    return y, s, torch.empty((pl.b, pl.h, pl.chunks, pl.n, pl.p), **f32)


def unique_bytes(t) -> int:
    """Bytes a tensor holds once, however its strides repeat them (a head
    stride of 0 reads one row for every head); 0 for None."""
    if t is None:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _chunk_sizes(l: int, chunk: int) -> list:
    return [min(chunk, l - c0) for c0 in range(0, l, chunk)]


def work(k, v, q, log_decay, gate, *, chunk: int, initial_state=None):
    """(bytes, recurrence operations, chunked operations) of one forward
    call.  Bytes: the inputs once, y and the state once.  The recurrence,
    step by step: per row the decay, the outer product and the add over
    N·P, the gated key and q·S (5·N·P + N), the first row of each (batch,
    head) without the decay against a zero state.  The chunked form the
    kernel runs: per causal pair of a chunk the q·k dot, the weight and
    its share of the value product; per row the update, and the carry
    after the first chunk or from a given initial state."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    nbytes = (sum(unique_bytes(t) for t in (k, v, q, log_decay, gate))
              + 4 * b * h * p * (l + n))
    if initial_state is not None:
        nbytes += 4 * b * h * n * p
    zero = initial_state is None
    recurrence = b * h * (l * (5 * n * p + n) - zero * 2 * n * p)
    sizes = _chunk_sizes(l, chunk)
    pairs = sum(c * (c + 1) // 2 for c in sizes)
    chunked = b * h * (pairs * (2 * n + 2 * p + 3) + l * (2 * n * p + 2 * p)
                       + (l - zero * sizes[0]) * (2 * n * p + p))
    return nbytes, recurrence, chunked


def cost(k, v, q, log_decay, gate, *, chunk: int, initial_state=None):
    """(operations, bytes) of one forward call in the chunked form the
    kernels run (:func:`work`)."""
    nbytes, _, chunked = work(k, v, q, log_decay, gate, chunk=chunk,
                              initial_state=initial_state)
    return chunked, nbytes


_BWD = "ssm_scan_bwd"
# The backward's kernels, as bits of launch_bwd's ``phases``, in launch
# order: the carries start dk/dv's sums and the diagonal pairs' dq
# partials, which the dk/dv kernel writes and dq_sum adds.
BWD_PHASES = {"cum": 1, "dstate": 2, "state_pass": 4, "carry": 8,
              "dkdv": 16, "dq_sum": 32, "dlog": 64}
BWD_ALL = sum(BWD_PHASES.values())
BWD_TILE = 64            # rows and columns of a backward tile
BWD_THREADS = 256        # eight warps, a 32 x 16 eighth of a tile each
_BWD_STAGED = BWD_TILE * (BWD_TILE + 4) * 8   # a (hi, lo) float2 tile
_BWD_STRIDES = ctypes.c_longlong * 22
_BWD_PLAN = ctypes.c_longlong * 10


class BwdPlan(NamedTuple):
    """The backward's geometry, a pure function of the shapes: the tiles
    that split a sum over blocks, and so its order, are the same on every
    card.  The C entry (``csrc/ssm_scan_bwd.cu``) computes the same values
    from the shapes and refuses a launch whose plan differs.

    Every product of phases 1, 2b and 3 is a ``tile`` x ``tile`` output
    of a block of ``threads`` (eight warps), its operands split once as
    they are staged, hi and lo planes of ``tile + 4`` floats a row.  The
    d-state and carry blocks hold two staged tiles and two raw tiles, the
    next step's copies in flight while the step before computes
    (``stages`` 2); the dk/dv blocks two staged tiles and the score tile,
    their copies landing in place (``stages`` 1), two blocks an SM
    (``blocks_per_sm``); each beside the chunk's cumsum (float64) and
    gate and four warps' row sums.  The dq-sum blocks stage nothing
    (``stages`` 0): they add the partials and keep two warps' column
    sums.  Sums split over blocks, in a fixed order: dq_i's partial of
    each (query tile, key tile) pair, ``pairs`` a chunk, in the workspace
    (``workspace_bytes``), added in ascending key tile, the diagonal
    pair's last and holding dq's carry (phase 2b's); q·dq and k·dk̃ one
    slot a 64-column tile of N (``n_tiles``), added in tile order by
    phase 4."""
    chunk: int
    chunks: int
    n_tiles: int             # 64-column tiles of N: the partial dot products
    tile: int = BWD_TILE
    threads: int = BWD_THREADS
    stages: tuple = (2, 1, 0)  # d-state, dk/dv, dq sum
    q_tiles: int = 1         # 64-row query (and key) tiles a chunk
    p_tiles: int = 1         # 64-column tiles of P
    pairs: int = 1           # (query tile, key tile) pairs, j <= i
    smem_dstate: int = 0     # shared bytes of phase 1's (and 2b's) block
    smem_dkdv: int = 0       # of phase 3's (dk̃ and dq partials, or dṽ)
    smem_dq_sum: int = 0     # of phase 3b's
    workspace_bytes: int = 0  # the dq partials, float32
    blocks_per_sm: int = 2   # dk/dv blocks an SM holds at once
    grids: tuple = ()        # d-state, carry, dk/dv and dq-sum grids

    def c_plan(self):
        """The values the C entry checks, in its order."""
        return _BWD_PLAN(self.tile, self.threads, self.q_tiles,
                         self.n_tiles, self.p_tiles, self.pairs,
                         self.smem_dstate, self.smem_dkdv, self.smem_dq_sum,
                         self.workspace_bytes // 4)


def plan_bwd(b: int, l: int, h: int, n: int, p: int, chunk: int) -> BwdPlan:
    """The backward's plan for k [b, l, h, n], v [b, l, h, p]; raises
    ``ValueError`` for more than 65535 chunks or a chunk whose cumsum and
    gate, beside the staged tiles, overflow a block's shared memory.  It
    reads the shapes only, never the card."""
    chunk = min(int(chunk), l)
    chunks = -(-l // chunk)
    if chunks > MAX_CHUNKS:
        raise ValueError(f"{_BWD}: {chunks} chunks of {chunk} rows; the "
                         f"chunk index is a grid dimension (at most "
                         f"{MAX_CHUNKS})")
    t = BWD_TILE
    pad = _round_up(chunk, t)
    q_tiles = pad // t
    n_tiles, p_tiles = -(-n // t), -(-p // t)
    pairs = q_tiles * (q_tiles + 1) // 2
    # csrc/ssm_scan_bwd.cu's tile_smem: cum (float64) and gate, 12 bytes a
    # row; four warps' row sums; two staged tiles; two raw tiles in flight
    # (phases 1 and 3b) or the score tile (phase 3).
    base = 12 * pad + 4 * t * 4 + 2 * _BWD_STAGED
    smem2 = smem3 = base + _BWD_STAGED
    smem_sum = 2 * t * 4      # phase 3b: two warps' column sums
    if smem3 > SMEM_LIMIT:
        raise ValueError(f"{_BWD}: chunk {chunk} needs {smem3} bytes of "
                         f"shared memory a block (limit {SMEM_LIMIT})")
    ws = 4 * b * h * chunks * pairs * n_tiles * t * t
    # An SM's 228 KB, 1 KB of it reserved a block.
    per_sm = min(2, (SMEM_LIMIT + 1024) // (smem3 + 1024))
    grids = ((b * h, chunks, n_tiles * p_tiles),
             (b * h, chunks, 3 * max(n_tiles, p_tiles)),
             (b * h, chunks, 2 * q_tiles), (b * h, chunks, q_tiles * n_tiles))
    return BwdPlan(chunk, chunks, n_tiles, t, BWD_THREADS, (2, 1, 0), q_tiles,
                   p_tiles, pairs, smem2, smem3, smem_sum, ws, per_sm, grids)


def _bwd_fn():
    return capi.entry(_BWD, "ssm_scan_bwd_launch",
                      [capi.P] * 21 + [ctypes.POINTER(ctypes.c_longlong)] * 2
                      + [capi.I] * 8 + [capi.P])


def _check_bwd(k, v, q, log_decay, gate, dy, d_final, chunk, states,
               final_state, dev):
    """The backward's rules on its inputs (on ``dev``) -> (its plan,
    d_final as float32 contiguous or None)."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    f32 = torch.float32
    pl = plan_bwd(b, l, h, n, p, chunk)
    for name, t, shape in (
            ("k", k, (b, l, h, n)), ("q", q, (b, l, h, n)),
            ("v", v, (b, l, h, p)), ("dy", dy, (b, l, h, p)),
            ("log_decay", log_decay, (b, l, h)), ("gate", gate, (b, l, h))):
        capi.check(_BWD, name, t, f32, shape, dev, contiguous=False)
    for name, t, shape in (("states", states, (b, h, pl.chunks, n, p)),
                           ("final_state", final_state, (b, h, n, p))):
        capi.check(_BWD, name, t, f32, shape, dev)
    if d_final is not None:
        d_final = d_final.to(f32).contiguous()
        capi.check(_BWD, "d_final", d_final, f32, (b, h, n, p), dev)
    return pl, d_final


def prepare_bwd(k, v, q, log_decay, gate, dy, d_final=None, *, chunk: int,
                initial_state=None, states, final_state):
    """The backward's ``(args, (dk, dv, dq, d_log_decay, d_gate,
    d_initial_state), keep)``: the C entry's arguments, the gradients
    (float32, contiguous, allocated here with the scratch and the dq
    partials' workspace of :func:`plan_bwd`, whose values go to the C
    entry beside the shapes) and the tensors ``args`` points into.  ``states``
    and ``final_state`` are the forward's (:func:`ssm_scan_cuda` with
    ``want_states``); ``initial_state`` only says whether there was one."""
    reject("ssm_scan_bwd", k, v, q, log_decay, gate, dy, d_final)
    dev = capi.require_cuda(_BWD, k)
    b, l, h, n = k.shape
    p = v.shape[-1]
    f32 = torch.float32
    pl, d_final = _check_bwd(k, v, q, log_decay, gate, dy, d_final, chunk,
                             states, final_state, dev)
    _bwd_fn()                 # built (or its build error raised) first
    dk, dq = (torch.empty((b, l, h, n), dtype=f32, device=dev)
              for _ in range(2))
    dv = torch.empty((b, l, h, p), dtype=f32, device=dev)
    dld, dg = (torch.empty((b, l, h), dtype=f32, device=dev)
               for _ in range(2))
    d_init = torch.empty((b, h, n, p), dtype=f32, device=dev)
    gs = torch.empty((b, h, pl.chunks, n, p), dtype=f32, device=dev)
    # float64 cumsum as opaque 8-byte scratch, as the forward's.
    cum = torch.empty((b, h, pl.chunks, _round_up(pl.chunk, BWD_TILE)),
                      dtype=torch.int64, device=dev)
    etot = torch.empty((b, h, pl.chunks), dtype=f32, device=dev)
    parts = torch.empty((2, pl.n_tiles, b, h, l), dtype=f32, device=dev)
    dqp = torch.empty(pl.workspace_bytes // 4, dtype=f32, device=dev)
    strides = _BWD_STRIDES(*k.stride(), *q.stride(), *v.stride(),
                           *dy.stride(), *log_decay.stride(),
                           *gate.stride())
    args = (k.data_ptr(), q.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            gate.data_ptr(), dy.data_ptr(), capi.ptr(d_final),
            states.data_ptr(), final_state.data_ptr(), dk.data_ptr(),
            dq.data_ptr(), dv.data_ptr(), dld.data_ptr(), dg.data_ptr(),
            d_init.data_ptr(), gs.data_ptr(), cum.data_ptr(),
            etot.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
            dqp.data_ptr(), strides, pl.c_plan(),
            int(initial_state is not None), b, l, h, n, p, pl.chunk,
            capi.stream(dev))
    keep = (k, v, q, log_decay, gate, dy, d_final, states, final_state, gs,
            cum, etot, parts, dqp)
    return args, (dk, dv, dq, dld, dg, d_init), keep


def launch_bwd(args, phases: int = BWD_ALL) -> None:
    """One launch of the backward's kernels named by ``phases`` (bits of
    :data:`BWD_PHASES`; all of them by default) on prepared arguments;
    does not count."""
    capi.raise_on_error(_BWD, _bwd_fn()(*args[:-1], phases, args[-1]))


def ssm_scan_bwd_cuda(k, v, q, log_decay, gate, dy, d_final=None, *,
                      chunk: int, initial_state=None, states, final_state):
    """(dk, dv, dq, d_log_decay, d_gate, d_initial_state) on the card; the
    contract of :func:`repro_torch.kernels.ssm_scan.ref.linear_scan_bwd_ref`
    with the forward's states given."""
    args, grads, _keep = prepare_bwd(
        k, v, q, log_decay, gate, dy, d_final, chunk=chunk,
        initial_state=initial_state, states=states, final_state=final_state)
    launch_bwd(args)
    ssm_scan_bwd_cuda.launches += 1
    return grads


ssm_scan_bwd_cuda.launches = 0


def ssm_scan_bwd_meta(k, v, q, log_decay, gate, dy, d_final=None, *,
                      chunk: int, initial_state=None, states, final_state):
    """The gradients of :func:`ssm_scan_bwd_cuda` on the meta device after
    :func:`prepare_bwd`'s checks: the dry run's stand-in for a launch."""
    del initial_state
    reject("ssm_scan_bwd", k, v, q, log_decay, gate, dy, d_final)
    dev = capi.require_meta(_BWD, k)
    _check_bwd(k, v, q, log_decay, gate, dy, d_final, chunk, states,
               final_state, dev)
    b, l, h, n = k.shape
    p = v.shape[-1]
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((b, l, h, n), **f32), torch.empty((b, l, h, p), **f32),
            torch.empty((b, l, h, n), **f32), torch.empty((b, l, h), **f32),
            torch.empty((b, l, h), **f32), torch.empty((b, h, n, p), **f32))


def work_bwd(k, v, q, log_decay, gate, dy, d_final=None, *, chunk: int,
             initial_state=None, states):
    """(bytes, recurrence operations, chunked operations) of one backward
    call (each input once, each gradient written once), counted as
    :func:`work` counts the forward (a multiply-add two).  The recurrence,
    row by row from the last: S_t again from S_{t-1} (the decay, the gated
    outer product and the add, 3·N·P + N), its gradient G_t =
    a_{t+1}·G_{t+1} + q_t dy_tᵀ (3·N·P), dq = S_t dy_t, dk̃ = G_t v_t and
    dṽ = G_tᵀ k_t (2·N·P each), the gating, dg = k·dk̃ and d cum = q·dq -
    g·dg and its reverse sum (5·N + P + 3); the first row's S without its
    decay and add against a zero state, the last row's G without them when
    there is no dS_final and <S_final, dS_final> when there is.  The
    chunked form the kernel runs: per causal pair of a chunk the scores
    dy·v and q·k, the weight exp(cum_i - cum_j) and its products with the
    scores and the gate, and the three products dq, dk̃, dṽ (6·N + 4·P +
    5); per row the four state products (ΔG, the carry S_{c-1} dy, G v, Gᵀ
    k: 8·N·P) and their row scales, the gating, dg, d cum and its sum
    (8·N + 2·P + 5), the carry skipped in the first chunk against a zero
    state and G's products in the last without dS_final; per chunk the
    reverse pass (2·N·P)."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    zero = initial_state is None
    no_df = d_final is None
    np_ = n * p
    recurrence = b * h * (l * (12 * np_ + 5 * n + p + 3)
                          - zero * 2 * np_ + (1 - 2 * no_df) * 2 * np_)
    sizes = _chunk_sizes(l, chunk)
    pairs = sum(c * (c + 1) // 2 for c in sizes)
    chunked = b * h * (pairs * (6 * n + 4 * p + 5)
                       + l * (8 * np_ + 8 * n + 2 * p + 5)
                       - zero * sizes[0] * (2 * np_ + n)
                       - no_df * sizes[-1] * (4 * np_ + n + p)
                       + len(sizes) * 2 * np_ + (not no_df) * 2 * np_)
    ins = (sum(unique_bytes(t) for t in (k, v, q, log_decay, gate, dy,
                                         states))
           + 4 * b * h * n * p * (1 + (not no_df)))
    outs = 4 * b * l * h * (2 * n + p + 2) + 4 * b * h * n * p
    return ins + outs, recurrence, chunked


def cost_bwd(k, v, q, log_decay, gate, dy, d_final=None, *, chunk: int,
             initial_state=None, states):
    """(operations, bytes) of one backward call in the chunked form the
    kernels run (:func:`work_bwd`)."""
    nbytes, _, chunked = work_bwd(k, v, q, log_decay, gate, dy, d_final,
                                  chunk=chunk, initial_state=initial_state,
                                  states=states)
    return chunked, nbytes
