"""Host-side broker of the streaming tuner: admission, futures, pumping.

The port of ``repro.service.broker``, line for line but for the device.
:class:`StreamingTuner` is the service front door.  Callers ``submit()``
:class:`~repro_torch.core.RunRequest`\\ s (getting a :class:`TuningTicket`
future back) while a lane-compacting episode stays resident on the device
(``device="cuda"`` by default); between bounded segments the broker
refills the device queue from its
admission buffer, banks finished runs out of the segment's output buffers,
and resolves tickets.  With ``config.num_shards > 1`` the broker runs one
resident engine *per shard* — each with its own device, admission buffer
and metrics recorder — and routes every new ticket to a home shard at
admission (``service/placement.py``; sticky for the ticket's life, so
cancel/preempt/resume stay single-shard).  Determinism contract: an
outcome is a function of its request alone — bit-identical to the
sequential oracle no matter the arrival order, priorities, segment pacing,
shard count, or what else shared the lanes
(``tests/test_torch_service*.py`` hold it against the JAX package).

Two driving modes share all of that:

* **synchronous** — no thread: ``pump()`` runs one segment on the calling
  thread; ``ticket.result()`` and ``drain()`` pump inline until satisfied.
* **background** — ``start()`` (or entering the context manager) spawns a
  worker that pumps while work is outstanding; ``submit`` is then fully
  asynchronous and ``result()``/``drain()`` just wait.

All device work happens on whichever thread pumps (serialized by a pump
lock; several busy shards run on one host thread each, each inside its
engine's device scope); submission itself touches only numpy/heapq
state.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time

import torch

from repro_torch.core.optimizer import Outcome, RunRequest
from repro_torch.device import resolve_device
from repro_torch.jobs.tables import JobTable
from repro_torch.obs import FlightRecorder
from repro_torch.service import placement
from repro_torch.service.config import ServiceConfig
from repro_torch.service.engine import (SegmentEngine, SegmentReport,
                                        ShardedEngine)
from repro_torch.service.metrics import MetricsRecorder, ServiceMetrics

__all__ = ["DeadlineUnmeetable", "QueueFull", "StreamingTuner",
           "TicketCancelled", "TuningTicket"]


class QueueFull(RuntimeError):
    """Backpressure: ``max_pending`` outstanding requests already admitted."""


class TicketCancelled(RuntimeError):
    """Terminal state of a cancelled ticket — ``result()`` raises this.

    ``partial`` carries the partial :class:`~repro_torch.core.Outcome` banked
    before the cancel took effect (what the run already paid for — spend
    trajectory and censored observations included, paper §3 mechanism i),
    or None when the run never held a seat.
    """

    def __init__(self, message: str, partial: Outcome | None = None):
        super().__init__(message)
        self.partial = partial


class DeadlineUnmeetable(RuntimeError):
    """Deadline-aware admission rejected a submit: the requested deadline
    is below the fastest resolution this service has ever produced, so the
    SLO is provably unmeetable (``ServiceConfig.deadline_policy``)."""


class TuningTicket:
    """Future for one submitted tuning run.

    ``result()`` blocks until the run's :class:`~repro_torch.core.Outcome` is
    banked out of a segment (pumping inline when the service has no
    background worker).  Tickets compare by id, which is also the
    admission FIFO tie-break within a priority class.

    Four terminal states, each with its own ``result()`` behaviour:
    **done** returns the Outcome; **cancelled** raises
    :class:`TicketCancelled` (carrying the partial Outcome, if any);
    **failed** raises RuntimeError chained to the service failure;
    unresolved-within-``timeout`` raises TimeoutError.  ``state`` exposes
    which one holds without raising.
    """

    def __init__(self, tid: int, request: RunRequest, priority: int,
                 tuner: "StreamingTuner"):
        self.id = tid
        self.request = request
        self.priority = priority
        self.submitted_at = time.perf_counter()
        self.resolved_at: float | None = None
        self.deadline: float | None = None   # absolute perf_counter SLO
        self.preemptions = 0                 # boundary evictions survived
        self.shard: int | None = None        # home shard (sticky for life)
        # Engine-managed: replayed bootstrap rows, budget B, job index.
        self.rows = None
        self.budget: float | None = None
        self.jid = 0
        self._tuner = tuner
        self._event = threading.Event()
        self._outcome: Outcome | None = None
        self._error: BaseException | None = None
        self._partial: Outcome | None = None
        self._cancel_requested = False       # tombstone: drop at next seat
        self._cancelled = False              # terminal, pump thread only
        self._pending_resume = False         # preempted, awaiting reseat

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def state(self) -> str:
        """``"pending"`` / ``"done"`` / ``"cancelled"`` / ``"failed"``."""
        if not self._event.is_set():
            return "pending"
        if self._cancelled:
            return "cancelled"
        if self._outcome is not None:
            return "done"
        return "failed"

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Request cancellation; returns False when the ticket already
        resolved (an existing resolution always stands).

        Unseated: the ticket is tombstoned and purged from the admission
        heap / dropped at seating time — it never reaches a slot.  Seated:
        the slot banks its partial state at the next segment boundary and
        the ticket resolves with :class:`TicketCancelled` carrying the
        partial :class:`~repro_torch.core.Outcome`.  A run that completes in the
        same segment the cancel raced with resolves ``done`` — check
        ``state`` after the fact.  ``result()`` (or ``wait``) still
        unblocks promptly either way.
        """
        return self._tuner._cancel(self)

    def partial_outcome(self) -> Outcome | None:
        """The partial Outcome banked before cancellation, or None."""
        return self._partial

    def result(self, timeout: float | None = None) -> Outcome:
        if not self._event.is_set():
            self._tuner._wait_for(self, timeout)
        if self._cancelled:
            raise TicketCancelled(f"ticket {self.id} was cancelled",
                                  partial=self._partial)
        if self._error is not None:
            raise RuntimeError("tuning service failed while this ticket "
                               "was outstanding") from self._error
        if self._outcome is not None:
            return self._outcome
        if self._tuner._failure is not None:
            raise RuntimeError("tuning service failed while this "
                               "ticket was outstanding") \
                from self._tuner._failure
        raise TimeoutError(f"ticket {self.id} not resolved within "
                           f"{timeout}s")

    def __repr__(self):
        return (f"TuningTicket(id={self.id}, job={self.request.job.name!r}, "
                f"seed={self.request.seed}, {self.state})")


class _AdmissionBuffer:
    """Double-buffered priority queue of ``(priority, ticket_id, ticket)``.

    Producers push into the *front* heap under a short lock; the single
    pump thread swaps front into its privately owned *back* heap and pops
    from the merged backlog without holding the submit lock.  Lower
    ``priority`` values stage first; ticket id breaks ties FIFO.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._front: list = []   # producers, lock-guarded
        self._back: list = []    # pump thread only

    def push(self, ticket: TuningTicket) -> None:
        with self._lock:
            heapq.heappush(self._front, (ticket.priority, ticket.id, ticket))

    def stage(self, k: int, aging_rate: float = 0.0) -> list[TuningTicket]:
        """Move up to ``k`` highest-priority tickets to the caller.  Pump
        thread only.

        With ``aging_rate > 0`` the backlog is re-keyed by *effective*
        priority ``priority - aging_rate * wait_seconds`` before popping,
        so an old low-priority ticket eventually outranks fresh
        high-priority traffic and cannot starve.  Aging reorders seating
        only — it can never change an outcome (determinism contract).
        """
        with self._lock:
            front, self._front = self._front, []
        if front:
            self._back.extend(front)
            heapq.heapify(self._back)
        if aging_rate > 0.0 and self._back:
            now = time.perf_counter()
            self._back = [(t.priority - aging_rate * (now - t.submitted_at),
                           t.id, t) for _, _, t in self._back]
            heapq.heapify(self._back)
        out = [heapq.heappop(self._back)[2]
               for _ in range(min(k, len(self._back)))]
        return out

    def restage(self, tickets: list[TuningTicket]) -> None:
        """Return staged-but-unstarted tickets to the backlog.  Pump thread
        only."""
        for t in tickets:
            heapq.heappush(self._back, (t.priority, t.id, t))

    def purge_cancelled(self) -> list[TuningTicket]:
        """Drop tombstoned (cancel-requested) tickets from both heaps and
        return them.  Pump thread only — the caller resolves each as
        cancelled."""
        with self._lock:
            front, self._front = self._front, []
        self._back.extend(front)
        purged = [t for _, _, t in self._back if t._cancel_requested]
        if purged:
            self._back = [e for e in self._back
                          if not e[2]._cancel_requested]
        heapq.heapify(self._back)
        return purged

    def __len__(self) -> int:
        with self._lock:
            return len(self._front) + len(self._back)


def _device_scope(device):
    """The CUDA device scope of ``device`` (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _merge_reports(reps: list[SegmentReport],
                   lane_slots: int) -> SegmentReport:
    """Fan-in of per-shard segment reports into one service-level report.

    Exactly one report passes through unchanged, so the ``num_shards=1``
    service returns its single engine's report.
    Several merge by summing the work counters and taking the max wall
    clock (the segments ran concurrently — summed steps over max wall IS
    the fleet throughput); ``lane_slots`` becomes the fleet total.  A
    merged report's ``occupancy`` is a conservative lower bound (steps are
    summed across shards while each shard only held its own slots) — exact
    aggregate occupancy comes from ``MetricsRecorder.aggregate``, which
    keeps per-shard denominators.
    """
    if len(reps) == 1:
        return reps[0]
    if not reps:
        return SegmentReport(steps=0, busy_slot_steps=0,
                             lane_slots=lane_slots, wall_seconds=0.0,
                             seated=0, injected=0, consumed=0,
                             completed=0, in_flight=0)
    return SegmentReport(
        steps=sum(r.steps for r in reps),
        busy_slot_steps=sum(r.busy_slot_steps for r in reps),
        lane_slots=sum(r.lane_slots for r in reps),
        wall_seconds=max(r.wall_seconds for r in reps),
        seated=sum(r.seated for r in reps),
        injected=sum(r.injected for r in reps),
        consumed=sum(r.consumed for r in reps),
        completed=sum(r.completed for r in reps),
        in_flight=sum(r.in_flight for r in reps),
        evicted=sum(r.evicted for r in reps),
        resumed=sum(r.resumed for r in reps),
        dropped=sum(r.dropped for r in reps),
    )


class StreamingTuner:
    """A long-lived tuning endpoint over a device-resident episode.

    Args:
      jobs: one :class:`JobTable` or a sequence of them — the jobs this
        service can tune.  Registered once: their tables are stacked into
        the segment program; jobs whose spaces differ in geometry
        are padded into one geometry bucket (``config.bucket``, auto-sized
        by default — the ``run_queue_batched`` contract).
      settings: selector knobs (static — one service, one policy program).
      config: :class:`ServiceConfig` pacing/capacity knobs.
      device: where the engines' tensors live — ``"cuda"`` (default;
        raises without a card; shards on ``cuda:{d % device_count}``) or
        ``"cpu"``.
    """

    def __init__(self, jobs, settings, config: ServiceConfig | None = None,
                 *, device="cuda"):
        jobs = [jobs] if isinstance(jobs, JobTable) else list(jobs)
        self.config = config or ServiceConfig()
        self.settings = settings
        self.device = resolve_device(device)
        # Flight recorder (repro_torch.obs): every lifecycle transition +
        # segment dispatch when config.trace is on; a disabled recorder's
        # emit is a single attribute check (the zero-perturbation rule).
        self.recorder = FlightRecorder(capacity=self.config.trace_capacity,
                                       enabled=self.config.trace)
        # One resident engine, admission buffer and metrics recorder per
        # shard (engine-per-device; service/placement.py routes tickets).
        # num_shards=1 degenerates to the classic single-engine service.
        self._engines = ShardedEngine(jobs, settings, self.config,
                                      recorder=self.recorder,
                                      device=self.device)
        self._admissions = [_AdmissionBuffer()
                            for _ in range(self.num_shards)]
        self._shard_metrics = [MetricsRecorder(self.config.lane_slots)
                               for _ in range(self.num_shards)]
        self._rr = 0                         # round-robin placement cursor
        self._cond = threading.Condition()
        self._pump_lock = threading.RLock()
        self._outstanding = 0
        self._next_id = 0
        self._unharvested: list[TuningTicket] = []
        self._worker: threading.Thread | None = None
        self._stopping = False
        self._failure: BaseException | None = None

    # Shard-0 aliases: the single-shard internals tests poke at.  With
    # num_shards=1 these ARE the service's whole state.
    @property
    def num_shards(self) -> int:
        return self.config.num_shards

    @property
    def _engine(self) -> SegmentEngine:
        return self._engines.shards[0]

    @property
    def _admission(self) -> _AdmissionBuffer:
        return self._admissions[0]

    @property
    def _metrics(self) -> MetricsRecorder:
        return self._shard_metrics[0]

    # ------------------------------------------------------------------ #
    # Admission
    # ------------------------------------------------------------------ #
    def submit(self, request: RunRequest | None = None, *, job=None,
               seed: int | None = None, budget_b: float = 3.0,
               bootstrap=None, priority: int = 0, block: bool = True,
               timeout: float | None = None,
               deadline: float | None = None) -> TuningTicket:
        """Admit one tuning run; returns its :class:`TuningTicket` future.

        Pass a prebuilt :class:`RunRequest`, or its fields (``job``,
        ``seed``, ``budget_b``, ``bootstrap``).  Lower ``priority`` values
        are seated first; arrival order breaks ties.  When the
        ``max_pending`` backpressure cap is reached, ``submit`` blocks
        until space frees (pumping inline if no background worker runs) —
        or raises :class:`QueueFull` immediately with ``block=False``.
        Priorities and admission timing never change a run's outcome, only
        when it runs.

        ``deadline`` (seconds from now) attaches a per-ticket SLO: under
        ``deadline_policy="reject"`` a deadline below the fastest
        resolution the service has ever produced is rejected at admission
        with :class:`DeadlineUnmeetable` (the run provably cannot make
        it); under ``"admit"`` the ticket is admitted regardless and a
        late resolution is counted in ``ServiceMetrics.slo_missed``.
        Deadlines shape admission and accounting only — never an Outcome.
        """
        if self._failure is not None:
            raise RuntimeError("tuning service already failed") \
                from self._failure
        if request is None:
            if job is None or seed is None:
                raise ValueError("pass a RunRequest, or at least job= and "
                                 "seed=")
            request = RunRequest(job, seed, budget_b, bootstrap)
        self._engines.job_index(request.job)     # eager registration check
        if deadline is not None:
            if deadline <= 0:
                raise ValueError("deadline must be > 0 seconds from now")
            floor = self._latency_floor()
            if (self.config.deadline_policy == "reject"
                    and floor is not None and deadline < floor):
                with self._cond:                 # account on the would-be
                    d = self._place_shard()      # home shard
                self._shard_metrics[d].record_deadline_reject()
                self.recorder.emit("deadline_reject", job=request.job.name,
                                   seed=request.seed, deadline_s=deadline,
                                   floor_s=floor, shard=d)
                raise DeadlineUnmeetable(
                    f"deadline {deadline:.3g}s is below this service's "
                    f"observed resolution floor {floor:.3g}s")
        deadline_abs = deadline
        deadline = (time.perf_counter() + timeout) if timeout is not None \
            else None
        cap = self.config.max_pending
        while True:
            with self._cond:
                if self._failure is not None:
                    raise RuntimeError("tuning service failed") \
                        from self._failure
                if cap is None or self._outstanding < cap:
                    self._next_id += 1
                    ticket = TuningTicket(self._next_id, request, priority,
                                          self)
                    if deadline_abs is not None:
                        ticket.deadline = (ticket.submitted_at
                                           + deadline_abs)
                    # Placement happens exactly once, at admission, against
                    # the loads of that instant; the ticket then sticks to
                    # its home shard for life (cancel/preempt/resume are
                    # single-shard operations).
                    ticket.shard = self._place_shard()
                    self._outstanding += 1
                    break
                if not block:
                    raise QueueFull(f"{self._outstanding} outstanding >= "
                                    f"max_pending={cap}")
                if self._worker_alive():
                    self._cond.wait(timeout=0.05)
                    self._check_deadline(deadline, "submit")
                    continue
            # No worker: make room ourselves (outstanding >= 1, so a pump
            # always progresses toward resolution).
            self._check_deadline(deadline, "submit")
            self.pump()
        # Emit submit+admit *before* the push: once the ticket is in the
        # heap a racing pump may stage it, and its stage event must not
        # outrun the admit event in the record.
        self.recorder.emit("submit", ticket=ticket.id,
                           job=request.job.name, seed=request.seed,
                           priority=priority, shard=ticket.shard)
        self.recorder.emit("admit", ticket=ticket.id,
                           backlog=len(self._admissions[ticket.shard]),
                           shard=ticket.shard)
        self._admissions[ticket.shard].push(ticket)
        self._shard_metrics[ticket.shard].record_submit()
        with self._cond:
            if self._failure is not None:
                # The worker died between our admission-counter increment
                # and the push: its failure sweep could not see this
                # ticket, so fail it here.
                ticket._error = self._failure
                ticket._event.set()
                self.recorder.emit(
                    "fail", ticket=ticket.id,
                    error=type(self._failure).__name__)
            self._cond.notify_all()              # wake the worker
        return ticket

    @staticmethod
    def _check_deadline(deadline, what: str) -> None:
        if deadline is not None and time.perf_counter() > deadline:
            raise TimeoutError(f"{what} timed out")

    def _place_shard(self, home: int | None = None) -> int:
        """Choose a ticket's home shard (``config.placement_policy``) over
        the instantaneous loads ``backlog + seated`` of each shard.  Called
        under ``self._cond`` at admission; the choice is sticky for the
        ticket's life (resume re-queues to the home shard directly)."""
        n = self.num_shards
        if n == 1:
            return 0
        loads = [len(self._admissions[d])
                 + self._engines.shards[d].in_flight() for d in range(n)]
        d = placement.choose_shard(self.config.placement_policy, loads,
                                   home=home, rr=self._rr)
        self._rr += 1
        return d

    def _latency_floor(self) -> float | None:
        """Fastest resolution any shard has produced (deadline admission
        uses the service-wide floor: a reject must be provable no matter
        which shard would serve the ticket)."""
        floors = [m.latency_floor() for m in self._shard_metrics]
        floors = [f for f in floors if f is not None]
        return min(floors) if floors else None

    # ------------------------------------------------------------------ #
    # Cancellation
    # ------------------------------------------------------------------ #
    def _cancel(self, ticket: TuningTicket) -> bool:
        """Tombstone ``ticket`` (see :meth:`TuningTicket.cancel`).  The
        pump thread honors the tombstone at the next boundary: purged from
        the heap, dropped at seating time, or evicted from its seat."""
        with self._cond:
            if ticket._event.is_set():
                return False
            ticket._cancel_requested = True
            self.recorder.emit("cancel_request", ticket=ticket.id)
            self._cond.notify_all()          # wake the worker promptly
        return True

    def _finish_cancel(self, ticket: TuningTicket,
                       partial: Outcome | None = None) -> None:
        """Resolve ``ticket`` as cancelled (pump thread only).  A ticket
        that already resolved — its run completed in the segment the
        cancel raced with, or the service failed it — keeps that
        resolution: a set event is never overwritten, so a ticket can
        never resolve twice."""
        if ticket._event.is_set():
            return
        home = self._engines.home(ticket)
        if partial is None:
            partial = home.partial_outcome(ticket)
        ticket._partial = partial
        ticket._cancelled = True
        ticket.resolved_at = time.perf_counter()
        self._shard_metrics[home.shard_id].record_cancel()
        self.recorder.emit("cancel", ticket=ticket.id,
                           had_partial=partial is not None,
                           shard=home.shard_id)
        with self._cond:
            self._outstanding -= 1
            ticket._event.set()
            self._cond.notify_all()

    def _preemption_victim(self, engine: SegmentEngine, evicting: list,
                           staged: list, depth: int) -> TuningTicket | None:
        """The seated ticket to preempt on ``engine`` this segment, or
        None.  Per shard: pressure, seats and candidates are all the home
        shard's own — preemption never reaches across shards.

        Preemption fires only under real pressure: the shard's backlog
        depth at pump start exceeded ``high_water``, every seat is
        occupied, and the best pending priority is *strictly* better than
        the worst seated one (strict, so a re-queued victim can never
        evict itself — no thrash, no livelock).  The victim is the
        lowest-priority seated run, latest admission breaking ties.
        """
        hw = self.config.high_water
        if hw is None or depth <= hw or not staged:
            return None
        if engine.in_flight() < self.config.lane_slots:
            return None                       # an idle seat serves instead
        cands = [t for t in engine._slot_tickets
                 if t is not None and not t._cancel_requested
                 and not any(t is e for e in evicting)]
        if not cands:
            return None
        best = min(t.priority for t in staged)
        victim = max(cands, key=lambda t: (t.priority, t.id))
        return victim if victim.priority > best else None

    # ------------------------------------------------------------------ #
    # Pumping
    # ------------------------------------------------------------------ #
    def pump(self) -> SegmentReport:
        """Run one bounded segment on every busy shard: resolve tombstoned
        (cancelled) backlog, refill each shard's device queue from its
        admission buffer, evict cancel-requested or preempted seats at the
        boundary, advance up to ``step_quota`` steps, harvest and resolve
        finished runs.  Busy shards run their segments concurrently — one
        host thread per shard, each inside its engine's device scope.  Safe to call concurrently
        with submits; pump itself is serialized.  Returns the per-shard
        reports merged (``num_shards=1``: the single report, unchanged)."""
        with self._pump_lock:
            if self._failure is not None:
                # A failed service must not re-fill the device: the worker's
                # failure sweep may still be flagging tickets, and any it
                # has swept must stay failed.
                raise RuntimeError("tuning service already failed") \
                    from self._failure
            plans = []
            for d in range(self.num_shards):
                adm = self._admissions[d]
                eng = self._engines.shards[d]
                for t in adm.purge_cancelled():
                    self._finish_cancel(t)
                depth = len(adm)              # admitted, not yet staged
                staged = adm.stage(
                    eng.c_dim + self.config.lane_slots - eng.in_flight(),
                    aging_rate=self.config.aging_rate)
                for t in staged:
                    self.recorder.emit("stage", ticket=t.id,
                                       priority=t.priority, shard=d)
                # Boundary evictions: tombstoned seats always; plus at most
                # one preemption per shard when its own backlog is past the
                # high-water mark.
                evict = [t for t in eng._slot_tickets
                         if t is not None and t._cancel_requested]
                victim = self._preemption_victim(eng, evict, staged, depth)
                if victim is not None:
                    evict.append(victim)
                # Early-exit at the low-water mark only pays off if there
                # is backlog left to inject afterwards; otherwise run the
                # segment to its quota (or to drained).
                low = (self.config.resolved_low_water()
                       if len(adm) else 0)
                plans.append((d, eng, adm, staged, evict, low, depth))
            results = self._run_segments(plans)
            reps, resolved_tickets, failure = [], [], None
            for (d, eng, adm, staged, evict, low, depth), res in \
                    zip(plans, results):
                if isinstance(res, BaseException):
                    # Don't strand staged tickets: whatever was not seated
                    # goes back to that shard's backlog (seated ones live
                    # in the engine's slot bookkeeping, which the failure
                    # paths cover).  Other shards' results still resolve
                    # below; the first failure re-raises after that.
                    seated = eng._slot_tickets
                    adm.restage([t for t in staged
                                 if not any(t is s for s in seated)])
                    if failure is None:
                        failure = res
                    continue
                if res is None:               # idle shard: nothing ran
                    continue
                resolved, leftover, dropped, evicted, rep = res
                metrics = self._shard_metrics[d]
                adm.restage(leftover)
                for t in leftover:
                    self.recorder.emit("restage", ticket=t.id, shard=d)
                now = time.perf_counter()
                for ticket, outcome in resolved:
                    ticket._outcome = outcome
                    ticket.resolved_at = now
                    missed = (ticket.deadline is not None
                              and now > ticket.deadline)
                    if missed:
                        metrics.record_slo_miss()
                    metrics.record_resolve(now - ticket.submitted_at,
                                           outcome.nex)
                    self.recorder.emit("resolve", ticket=ticket.id,
                                       latency_s=now - ticket.submitted_at,
                                       nex=outcome.nex, slo_missed=missed,
                                       shard=d)
                    ticket._event.set()
                for t in dropped:             # tombstoned at seating time
                    self._finish_cancel(t)
                for t, rows, partial in evicted:
                    if t._cancel_requested:
                        self._finish_cancel(t, partial)
                    else:
                        # Preempted: the banked carry rows ARE the
                        # resumable request — reseating them replays the
                        # rest of the run bit-identically (prepare() is
                        # idempotent on rows).  Sticky affinity: straight
                        # back to the home shard's own backlog.
                        t.rows = rows
                        t.preemptions += 1
                        t._pending_resume = True
                        metrics.record_preempt()
                        self.recorder.emit("preempt", ticket=t.id,
                                           preemptions=t.preemptions,
                                           shard=d)
                        adm.push(t)
                if rep.resumed:
                    metrics.record_resume(rep.resumed)
                if rep.steps:
                    metrics.record_segment(rep.steps, rep.busy_slot_steps,
                                           rep.wall_seconds, depth)
                resolved_tickets.extend(t for t, _ in resolved)
                reps.append(rep)
            with self._cond:
                self._outstanding -= len(resolved_tickets)
                self._unharvested.extend(resolved_tickets)
                self._cond.notify_all()
            if failure is not None:
                raise failure
            return _merge_reports(reps, self.config.lane_slots)

    def _run_segments(self, plans) -> list:
        """Execute the busy shards' segments; returns one slot per plan —
        the ``run_segment`` 5-tuple, the exception it raised, or None for
        an idle shard that was skipped.  A single busy shard (always the
        case at ``num_shards=1``) runs inline on the calling thread;
        several busy shards run on one host thread each (a host read of a
        step's loop condition releases the GIL while a device computes).
        Each runs inside its engine's device scope, so the current CUDA
        device is the engine's on every thread.
        """
        busy = [i for i, (d, eng, adm, staged, evict, low, depth)
                in enumerate(plans)
                if staged or evict or eng.in_flight()]
        if not busy:
            busy = [0]            # keep "pump always runs a segment"
        results: list = [None] * len(plans)

        def run(i: int) -> None:
            d, eng, adm, staged, evict, low, depth = plans[i]
            try:
                with _device_scope(eng.device):
                    results[i] = eng.run_segment(staged, evict, low,
                                                 self.config.step_quota)
            except BaseException as e:        # surfaced by the caller
                results[i] = e

        if len(busy) == 1:
            run(busy[0])
        else:
            threads = [threading.Thread(target=run, args=(i,),
                                        name=f"shard-segment-{plans[i][0]}")
                       for i in busy]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        return results

    def drain(self, timeout: float | None = None) -> list[Outcome]:
        """Block until every outstanding request is resolved (pumping
        inline when no background worker runs); returns the outcomes
        resolved since the last drain, in submission (ticket-id) order."""
        deadline = (time.perf_counter() + timeout) if timeout is not None \
            else None
        while True:
            with self._cond:
                if self._failure is not None:
                    raise RuntimeError("tuning service failed") \
                        from self._failure
                if self._outstanding == 0:
                    done, self._unharvested = self._unharvested, []
                    return [t._outcome
                            for t in sorted(done, key=lambda t: t.id)]
                if self._worker_alive():
                    self._cond.wait(timeout=0.05)
                    self._check_deadline(deadline, "drain")
                    continue
            self._check_deadline(deadline, "drain")
            self.pump()

    def _wait_for(self, ticket: TuningTicket, timeout: float | None) -> None:
        """Progress until ``ticket`` resolves: wait on the worker while one
        runs, pump inline otherwise.  Re-checks worker liveness so a waiter
        is never stranded by a ``stop()`` (or worker death) that happens
        mid-wait — outstanding tickets stay drivable by inline pumps."""
        deadline = (time.perf_counter() + timeout) if timeout is not None \
            else None
        while not ticket.done() and self._failure is None:
            self._check_deadline(deadline, f"ticket {ticket.id}")
            if self._worker_alive():
                ticket._event.wait(0.05)
            else:
                self.pump()

    # ------------------------------------------------------------------ #
    # Background worker
    # ------------------------------------------------------------------ #
    def _worker_alive(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start(self) -> "StreamingTuner":
        """Spawn the background pump thread (idempotent)."""
        with self._cond:
            if self._worker_alive():
                return self
            self._stopping = False
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="streaming-tuner",
                                            daemon=True)
            self._worker.start()
        return self

    def stop(self) -> None:
        """Stop the background worker (outstanding tickets stay valid and
        can still be driven by inline pumps)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            worker = self._worker
        if worker is not None:
            worker.join()
        self._worker = None

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and self._outstanding == 0:
                    self._cond.wait()
                if self._stopping:
                    return
            try:
                rep = self.pump()
                if rep.steps == 0:
                    # Outstanding tickets exist but none were admitted yet
                    # (a submitter sits between its counter increment and
                    # its admission push) — yield instead of spinning.
                    with self._cond:
                        self._cond.wait(timeout=0.01)
            except BaseException as e:      # fail every waiter, loudly
                with self._cond:
                    self._failure = e
                    self._cond.notify_all()
                # The pump lock serializes this sweep against any inline
                # pump already mutating the back buffers; _failure being
                # set keeps later submits/pumps from re-filling them.
                # Every shard's backlog and seats get swept — a failure
                # anywhere fails the whole service.
                with self._pump_lock:
                    backlog: list = []
                    seated: list = []
                    for d in range(self.num_shards):
                        adm = self._admissions[d]
                        backlog.extend(adm.stage(
                            len(adm) + 2 * self.config.lane_slots))
                        seated.extend(self._engines.shards[d]._slot_tickets)
                for t in backlog + seated:
                    # Skip tickets an interleaved inline pump already
                    # resolved — their outcomes are valid.
                    if t is not None and not t._event.is_set():
                        t._error = e
                        t._event.set()
                        self.recorder.emit("fail", ticket=t.id,
                                           error=type(e).__name__)
                return

    def __enter__(self) -> "StreamingTuner":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    def flight_record(self):
        """Snapshot of the flight recorder's event ring, oldest first
        (empty unless ``config.trace`` is on).  ``repro_torch.obs`` has
        the validators; ``scripts/obs_report.py`` renders it."""
        return self.recorder.events()

    def dump_trace(self, path):
        """Freeze the flight record to a JSONL file; returns the path."""
        return self.recorder.dump_jsonl(path)

    def metrics(self) -> ServiceMetrics:
        """Service-wide metrics: the per-shard recorders aggregated
        (``num_shards=1`` is exactly the single recorder's snapshot)."""
        return MetricsRecorder.aggregate(self._shard_metrics)

    def shard_metrics(self) -> list[ServiceMetrics]:
        """One :class:`ServiceMetrics` snapshot per shard, by shard id."""
        return [m.snapshot() for m in self._shard_metrics]

    def reset_metrics(self) -> None:
        """Zero the counters (keeps the engines and their episode state) —
        call after a warmup pass so gates measure steady state."""
        for m in self._shard_metrics:
            m.reset()

    @property
    def outstanding(self) -> int:
        return self._outstanding
