"""Device-side half of the streaming tuner: a resident segment engine.

One :class:`SegmentEngine` owns the persistent slot carry of a
lane-compacting episode (``_episode_segment`` in ``core/optimizer.py``) on
its device and, per pump, performs the host/device handshake around one
bounded segment:

1. **seat** — copy the head of the staged admission list straight into
   idle lane slots (indexed writes of the exact per-run initial states
   ``_init_run_states`` replays; no arithmetic, so no parity risk);
2. **inject** — materialize the remaining staged runs as the device-side
   pending queue (up to ``queue_capacity`` rows);
3. **dispatch** — run one segment (low-water + step-quota exits are plain
   scalars of its host loop);
4. **device_block** — wait for the device to finish what the segment
   enqueued;
5. **harvest** — read the ``out_*`` banking rows to the host, rebuild each
   finished run's :class:`~repro_torch.core.Outcome` via
   ``_reconstruct_outcome`` (the same post-hoc table math every other
   backend uses), and re-key in-flight runs to their slot index so the
   next segment's banking targets stay stable while queue rows are
   recycled.

The port of ``repro.service.engine``.  Where the reference's dispatch is
the asynchronous enqueue of a jitted program and ``device_block`` the
wait, the port's ``_episode_segment`` is a host loop that reads its loop
condition once a step, so nearly all of a segment's device time falls
inside ``dispatch``; ``device_block`` synchronizes the engine's device.
Every engine has a real device (the service's, or its shard's), and every
resident tensor lives there.  ``host_reads`` counts the device-to-host
reads the engine makes outside the segment's steps (the evict snapshot and
the harvest).

Everything here runs on the broker's pump thread (one thread per busy
shard); the engine itself is not thread-safe (see ``broker.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import lookahead
from repro_torch.core.optimizer import (_CARRY_TIMEOUT_KEYS, _episode_segment,
                                        _fresh_slot_carry, _init_run_states,
                                        _queue_spaces, _queue_tables,
                                        _reconstruct_outcome, _resolve_bucket)
from repro_torch.device import resolve_device
from repro_torch.obs import FlightRecorder, phase_span
from repro_torch.service import placement

if TYPE_CHECKING:
    from repro_torch.core.optimizer import Outcome
    from repro_torch.jobs.tables import JobTable
    from repro_torch.service.config import ServiceConfig

__all__ = ["SegmentEngine", "SegmentReport", "ShardedEngine"]

_STATE_FIELDS = ("keys", "y", "mask", "beta", "explored", "n_exp")
# queue-row field -> slot-carry field (only "keys" differs)
_CARRY_NAME = {"keys": "key"}


@dataclasses.dataclass(frozen=True)
class SegmentReport:
    """Host-visible facts about one executed segment."""

    steps: int              # host-loop iterations this segment
    busy_slot_steps: int    # sum over iterations of seated slots
    lane_slots: int
    wall_seconds: float
    seated: int             # staged runs copied into idle slots host-side
    injected: int           # staged runs materialized as device queue rows
    consumed: int           # device queue rows seated on device mid-segment
    completed: int          # runs banked + reconstructed this segment
    in_flight: int          # seats still holding a live run afterwards
    evicted: int = 0        # seats banked partial + freed at the boundary
    resumed: int = 0        # previously preempted runs re-seated on device
    dropped: int = 0        # cancel-requested staged runs filtered pre-seat

    @property
    def occupancy(self) -> float:
        """Seated-slot fraction of this segment's slot-steps."""
        return self.busy_slot_steps / max(self.steps * self.lane_slots, 1)


class SegmentEngine:
    """Resident episode state + the seat/inject/dispatch/harvest cycle.

    ``jobs`` fixes the table stack (and therefore the segment program's
    geometry) for the service's lifetime: every submitted request must
    reference one of these :class:`JobTable` objects.  Jobs sharing one
    space geometry run the native shared-tensor program; jobs of different
    geometries are right-padded into one geometry bucket (auto-sized, or
    forced via ``config.bucket``) so the service still runs exactly one
    segment program geometry — the contract of ``run_queue_batched``, held
    at registration instead of per call.  ``device`` is where every
    resident tensor lives (``"cuda"`` by default: raises without a card).
    """

    def __init__(self, jobs: list[JobTable], settings,
                 config: ServiceConfig, recorder: FlightRecorder | None = None,
                 *, shard_id: int = 0, device="cuda"):
        if not jobs:
            raise ValueError("register at least one JobTable")
        if settings.policy == "rnd":
            raise ValueError(
                "policy 'rnd' is host-driven (no model to keep device-"
                "resident); stream it through run_queue instead")
        self.jobs = list(jobs)
        self.settings = settings
        self.config = config
        self.shard_id = int(shard_id)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The card it lands on: ``cuda`` means the current one.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.bucket = _resolve_bucket(self.jobs, config.bucket)
        job0 = self.jobs[0]
        self.m_dim = (job0.space.n_points if self.bucket is None
                      else self.bucket.m)
        self.l_dim = config.lane_slots
        self.c_dim = config.queue_capacity

        dev = self.device
        if self.bucket is None:
            pts, left, thr, u0 = lookahead.space_arrays(
                job0.space, job0.unit_price, dev)
            self._valid = None
        else:
            pts, left, thr, self._valid = _queue_spaces(self.jobs,
                                                        self.bucket, dev)
            u0 = None
        self._space = (pts, left, thr)
        (self._cost, self._runtime, self._u, self._tmax,
         self._single) = _queue_tables(self.jobs, u0, self.bucket, dev)

        self._carry = _fresh_slot_carry(self.l_dim, self.m_dim, settings,
                                        device=dev)
        self._fields = _STATE_FIELDS + (_CARRY_TIMEOUT_KEYS
                                        if settings.timeout else ())
        # The queue's pad table takes every dtype and row shape from the
        # slot carry: a queue row is seated into a slot as it is.
        self._queue_pad = {
            f: (self._carry[_CARRY_NAME.get(f, f)].shape[1:],
                torch.empty((), dtype=self._carry[_CARRY_NAME.get(f, f)]
                            .dtype).numpy().dtype)
            for f in self._fields}
        self._slot_tickets: list = [None] * self.l_dim
        self._slot_jids = np.zeros(self.l_dim, np.int64)
        # Cumulative wall/steps for the Outcome.select_seconds amortization
        # (same estimator as run_queue_batched's, accrued across segments).
        self._wall = 0.0
        self._steps = 0
        self.host_reads = 0
        # Observability (zero-perturbation: the recorder watches the
        # handshake, it never feeds the selection).  A disabled recorder
        # makes every emit/span a no-op.
        self._recorder = (recorder if recorder is not None
                          else FlightRecorder(enabled=False))
        self._profiler = config.trace_profiler
        self._segment_seq = 0

    # ------------------------------------------------------------------ #
    def _host(self, t: torch.Tensor) -> np.ndarray:
        """One counted device-to-host read (a copy: it never aliases a
        resident tensor)."""
        self.host_reads += 1
        return t.cpu().numpy().copy()

    def job_index(self, job) -> int:
        for k, j in enumerate(self.jobs):
            if job is j:
                return k
        raise ValueError(
            f"job {job.name!r} is not registered with this service; pass "
            "every JobTable at construction (the segment program stacks "
            "their tables once)")

    def prepare(self, tickets) -> None:
        """Replay bootstraps for newly staged tickets (Alg. 1 lines 6-8 via
        ``_init_run_states``, batched) and pin their per-run rows host-side
        as numpy copies.  Idempotent per ticket — a ticket returned to the
        backlog keeps its rows."""
        fresh = [t for t in tickets if t.rows is None]
        if not fresh:
            return
        states = _init_run_states(
            [t.request for t in fresh], self.settings,
            None if self.bucket is None else self.bucket.m)
        budgets = states.pop("budgets")
        for r, t in enumerate(fresh):
            t.rows = {f: np.array(states[f][r:r + 1]) for f in self._fields}
            t.budget = float(budgets[r])
            t.jid = self.job_index(t.request.job)

    def in_flight(self) -> int:
        return sum(t is not None for t in self._slot_tickets)

    # ------------------------------------------------------------------ #
    def _rows(self, tickets: list, f: str) -> np.ndarray:
        """The tickets' rows of field ``f`` stacked, in the carry's dtype
        (a mismatch raises: a cast would change the run)."""
        rows = np.concatenate([t.rows[f] for t in tickets])
        want = self._queue_pad[f][1]
        if rows.dtype != want:
            raise TypeError(f"queue field {f!r}: rows are {rows.dtype}, the "
                            f"slot carry holds {want}")
        return rows

    def _seat(self, staged: list) -> tuple[list, int]:
        """Copy staged runs into idle slots host-side; returns the
        remainder (destined for the device queue) and the seat count."""
        idle = [i for i, t in enumerate(self._slot_tickets) if t is None]
        n = min(len(idle), len(staged))
        if n == 0:
            return staged, 0
        slots, seated = idle[:n], staged[:n]
        dev = self.device
        sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        carry = self._carry
        for f in self._fields:
            name = _CARRY_NAME.get(f, f)
            stack = torch.as_tensor(self._rows(seated, f), device=dev)
            carry[name] = carry[name].index_put((sl,), stack)
        # A host-seated run banks into its slot's own output row.
        carry["rid"] = carry["rid"].index_put((sl,), sl.to(torch.int32))
        carry["active"] = carry["active"].index_put(
            (sl,), torch.ones(n, dtype=torch.bool, device=dev))
        for i, t in zip(slots, seated):
            self._slot_tickets[i] = t
            self._slot_jids[i] = t.jid
            self._recorder.emit("seat", ticket=t.id, slot=int(i),
                                segment=self._segment_seq, via="host",
                                shard=self.shard_id)
            if t._pending_resume:
                self._recorder.emit("resume", ticket=t.id, slot=int(i),
                                    segment=self._segment_seq,
                                    shard=self.shard_id)
        return staged[n:], n

    def _queue_arrays(self, staged: list) -> dict:
        """Materialize staged runs as the fixed-shape [C, ...] device queue
        (zero-padded; padding rows sit beyond qtail and are never read)."""
        queue = {}
        for f in self._fields:
            shape, dtype = self._queue_pad[f]
            buf = np.zeros((self.c_dim,) + tuple(shape), dtype)
            if staged:
                buf[:len(staged)] = self._rows(staged, f)
            queue[f] = torch.as_tensor(buf, device=self.device)
        return queue

    def run_segment(self, staged: list, evict_tickets: list,
                    low_water: int, step_quota: int
                    ) -> tuple[list, list, list, list, SegmentReport]:
        """One seat/inject/dispatch/harvest cycle.

        ``staged`` must hold at most ``queue_capacity + idle slots``
        prepared tickets, in admission (priority) order; ``evict_tickets``
        names seated tickets whose slot must bank partial state and free at
        this boundary (cancellation or preemption, through the segment's
        evict flag).  Cancel-requested staged tickets are filtered out
        *here*, at seating time, which closes the cancel-between-stage-and-
        seat race: a tombstoned ticket can never reach a slot.  Returns
        ``(resolved, leftover, dropped, evicted, report)``: finished
        ``(ticket, Outcome)`` pairs, the staged tickets that neither seated
        nor started (back to the broker's backlog), the cancel-requested
        staged tickets that were dropped pre-seat, the ``(ticket, rows,
        partial_outcome)`` triples for evicted seats (``rows`` is the
        banked slot carry, numpy copies — reseating it resumes the run
        bit-identically), and the segment facts.
        """
        dropped = [t for t in staged if t._cancel_requested]
        staged = [t for t in staged if not t._cancel_requested]
        self.prepare(staged)
        rec, seg, prof = self._recorder, self._segment_seq, self._profiler
        shard, dev = self.shard_id, self.device
        t0 = time.perf_counter()
        with phase_span(rec, "seat", segment=seg, profiler=prof,
                        shard=shard):
            staged_q, seated = self._seat(staged)
        if len(staged_q) > self.c_dim:
            raise ValueError(f"staged {len(staged_q)} queue rows but device "
                             f"capacity is {self.c_dim}")
        if not staged_q and self.in_flight() == 0:
            return [], [], dropped, [], SegmentReport(
                0, 0, self.l_dim, 0.0, seated, 0, 0, 0, 0,
                dropped=len(dropped))

        # Evict mask + pre-segment carry snapshot (the banked state a
        # preempted run resumes from — identical to what the segment's
        # start banks into the out rows, read host-side for the resumable
        # request).
        ev = np.zeros(self.l_dim, bool)
        for t in evict_tickets:
            for i, held in enumerate(self._slot_tickets):
                if held is t:
                    ev[i] = True
        ev_slots = np.nonzero(ev)[0]
        ev_rows: dict[int, dict] = {}
        if len(ev_slots):
            host = {f: self._host(self._carry[_CARRY_NAME.get(f, f)])
                    for f in self._fields}
            for i in ev_slots:
                ev_rows[int(i)] = {f: host[f][i:i + 1].copy()
                                   for f in self._fields}

        with phase_span(rec, "inject", segment=seg, profiler=prof,
                        shard=shard):
            queue = self._queue_arrays(staged_q)
            for j, t in enumerate(staged_q):
                rec.emit("inject", ticket=t.id, segment=seg, row=j,
                         shard=shard)
        if self._single:
            job_ids = None
        else:
            job_ids = torch.as_tensor(np.concatenate(
                [self._slot_jids,
                 np.array([t.jid for t in staged_q], np.int64),
                 np.zeros(self.c_dim - len(staged_q), np.int64)]),
                device=dev)
        # dispatch = the segment's host loop of device steps; device_block
        # = the wait for the last step's work.
        with phase_span(rec, "dispatch", segment=seg, profiler=prof,
                        compiles=True, shard=shard):
            carry, report = _episode_segment(
                self._carry, queue, len(staged_q),
                torch.as_tensor(ev, device=dev), int(low_water),
                int(step_quota), job_ids, self._cost,
                self._runtime if self.settings.timeout else None,
                *self._space, self._valid, self._u, self._tmax,
                self.settings)
        with phase_span(rec, "device_block", segment=seg, profiler=prof,
                        shard=shard):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0

        steps = int(report["steps"])
        self._wall += wall
        self._steps += steps
        sel_s = self._wall / max(self._steps * self.l_dim, 1)

        # Harvest banked runs: out row i < L is the run seated in slot i at
        # segment start, row L + j the run injected as queue row j.
        with phase_span(rec, "harvest", segment=seg, profiler=prof,
                        shard=shard):
            out = {k: self._host(v) for k, v in report.items()
                   if k.startswith("out_")}
            busy = int(self._host(report["busy"]))
            rid = self._host(carry["rid"])
            active = self._host(carry["active"])
            consumed = int(self._host(carry["qhead"]))
            # Queue rows the device consumed became seats mid-segment; the
            # host only learns it here, so the seat (and any resume) event
            # lands at harvest time — still before the row's harvest event.
            for t in staged_q[:consumed]:
                rec.emit("seat", ticket=t.id, segment=seg, via="queue",
                         shard=shard)
                if t._pending_resume:
                    rec.emit("resume", ticket=t.id, segment=seg,
                             shard=shard)
            row_ticket = dict(enumerate(self._slot_tickets))
            for j, t in enumerate(staged_q):
                row_ticket[self.l_dim + j] = t
            resolved = []
            for r in np.nonzero(out["out_done"])[0]:
                t = row_ticket[int(r)]
                resolved.append((t, self._outcome_from_row(t, out, int(r),
                                                           sel_s)))
                rec.emit("harvest", ticket=t.id, segment=seg, row=int(r),
                         nex=int(out["out_nexp"][r]), shard=shard)

            # Evicted seats banked into their own out row (rid == slot at
            # segment start; out_done stays False there, so the loop above
            # never double-harvests them).
            evicted = []
            for i in ev_slots:
                t = row_ticket[int(i)]
                evicted.append((t, ev_rows[int(i)],
                                self._outcome_from_row(t, out, int(i),
                                                       sel_s)))
                rec.emit("evict", ticket=t.id, slot=int(i), segment=seg,
                         cancel=bool(t._cancel_requested), shard=shard)

            # Re-key in-flight runs to their seat and recycle queue rows.
            tickets = [row_ticket[int(rid[i])] if active[i] else None
                       for i in range(self.l_dim)]
            self._slot_tickets = tickets
            self._slot_jids = np.array([t.jid if t else 0 for t in tickets],
                                       np.int64)
            carry["rid"] = torch.as_tensor(
                np.where(active, np.arange(self.l_dim), -1).astype(np.int32),
                device=dev)
            carry["qhead"] = torch.zeros((), dtype=torch.int32, device=dev)
            self._carry = carry

        leftover = staged_q[consumed:]
        started = staged[:seated] + staged_q[:consumed]
        resumed = 0
        for t in started:
            if t._pending_resume:
                t._pending_resume = False
                resumed += 1
        rep = SegmentReport(
            steps=steps, busy_slot_steps=busy,
            lane_slots=self.l_dim, wall_seconds=wall, seated=seated,
            injected=len(staged_q), consumed=consumed,
            completed=len(resolved), in_flight=self.in_flight(),
            evicted=len(evicted), resumed=resumed, dropped=len(dropped))
        rec.emit("dispatch", segment=seg, steps=steps, busy=busy,
                 seated=seated, injected=len(staged_q), consumed=consumed,
                 completed=len(resolved), evicted=len(evicted),
                 in_flight=rep.in_flight, wall_s=wall, shard=shard)
        self._segment_seq += 1
        return resolved, leftover, dropped, evicted, rep

    def partial_outcome(self, t) -> Outcome | None:
        """Partial :class:`Outcome` from a ticket's banked carry rows —
        what a cancelled-while-pending ticket that previously ran (was
        preempted) has already paid for.  None when the ticket never held
        a seat (its rows are the untouched bootstrap replay)."""
        if t.rows is None or t.preemptions == 0:
            return None
        n = int(t.rows["n_exp"][0])
        explored = [int(i) for i in t.rows["explored"][0, :n]]
        if self.settings.timeout:
            cflags = [bool(f) for f in t.rows["cexpl"][0, :n]]
            billed = np.asarray(t.rows["bexpl"][0, :n])
        else:
            cflags = [False] * len(explored)
            billed = t.request.job.host_view().cost[explored]
        sel_s = self._wall / max(self._steps * self.l_dim, 1)
        return _reconstruct_outcome(t.request.job, self.settings, t.budget,
                                    explored, cflags, billed,
                                    np.float32(t.rows["beta"][0]), sel_s)

    def _outcome_from_row(self, t, out, r: int, sel_s: float) -> Outcome:
        n = int(out["out_nexp"][r])
        explored = [int(i) for i in out["out_expl"][r, :n]]
        if self.settings.timeout:
            cflags = [bool(f) for f in out["out_cexpl"][r, :n]]
            billed = out["out_bexpl"][r, :n]
        else:
            cflags = [False] * len(explored)
            billed = t.request.job.host_view().cost[explored]
        # beta stays an np.float32 scalar: _reconstruct_outcome's
        # ``budget - beta_final`` must run under the same float32 promotion
        # the sequential oracle's bookkeeping uses.
        return _reconstruct_outcome(t.request.job, self.settings, t.budget,
                                    explored, cflags, billed,
                                    out["out_beta"][r], sel_s)


class ShardedEngine:
    """Facade over one :class:`SegmentEngine` per shard (engine-per-device).

    ``config.num_shards`` engines share one job fleet, one ``settings``
    policy and one flight recorder; each owns its *own* resident slot
    carry, device queue and table copies on its device
    (``placement.shard_devices``).  ``num_shards=1`` is a single engine on
    the service's device.

    The broker routes every ticket to exactly one shard (sticky — see
    ``placement.choose_shard``) and pumps each engine separately; this
    facade only fans harvest-side queries in: aggregate ``in_flight`` and
    home-shard ``partial_outcome`` lookups.  Every per-shard event the
    engines emit carries its ``shard`` id, so one merged trace stays
    attributable (``repro_torch.obs.validate_lifecycle`` rejects
    cross-shard ticket streams).
    """

    def __init__(self, jobs, settings, config: ServiceConfig,
                 recorder: FlightRecorder | None = None, *, device="cuda"):
        n = config.num_shards
        devices = ([resolve_device(device)] if n == 1
                   else placement.shard_devices(n, device))
        self.shards = [SegmentEngine(jobs, settings, config,
                                     recorder=recorder, shard_id=d,
                                     device=devices[d])
                       for d in range(n)]

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def bucket(self):
        return self.shards[0].bucket

    def job_index(self, job) -> int:
        return self.shards[0].job_index(job)

    def in_flight(self) -> int:
        """Aggregate seated runs across every shard."""
        return sum(e.in_flight() for e in self.shards)

    def home(self, ticket) -> SegmentEngine:
        """The engine holding ``ticket``'s state (shard 0 before any
        placement — sticky affinity makes this stable for life)."""
        shard = getattr(ticket, "shard", None)
        return self.shards[0 if shard is None else shard]

    def partial_outcome(self, ticket):
        """Home-shard partial-Outcome lookup (harvest fan-in: the banked
        carry rows of a preempted run live only in its home engine)."""
        return self.home(ticket).partial_outcome(ticket)
