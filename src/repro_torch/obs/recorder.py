"""Flight recorder: a bounded, thread-safe, structured lifecycle event log.

The port's copy of ``repro.obs.recorder`` (pure Python, so a copy rather
than an import: the port imports nothing of the JAX package).  The
streaming service emits one :class:`Event` per lifecycle transition
(submit/admit/stage/seat/.../resolve), per segment dispatch, and per timing
span.  Events land in a fixed-capacity ring buffer — a long-lived endpoint
never grows state per request — and can be frozen to JSONL for offline
triage; the schema is the JAX package's, so ``scripts/obs_report.py``
renders a port trace as it renders the reference's.

Zero-perturbation rule: the recorder *watches* the service, it never joins
the decision path.  Nothing here touches a tensor of the selection, a PRNG
key, or an Outcome; a disabled recorder's :meth:`FlightRecorder.emit` is a
single attribute check, so the trace-off service is bit-identical to a
never-instrumented one (``tests/test_torch_obs.py`` replays a trace-on
service against the trace-off one).

Alongside the bounded ring, per-kind *counts* accrue over the full history
(two ints per kind), so counter-balance checks against ``ServiceMetrics``
stay exact even after the ring wraps.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import threading
import time
from typing import Any

__all__ = ["EVENT_KINDS", "TERMINAL_KINDS", "Event", "FlightRecorder"]

# The lifecycle event vocabulary (the reference's docs/ARCHITECTURE.md
# documents each kind and the per-ticket state machine that
# ``repro_torch.obs.validate_lifecycle`` enforces).  ``emit`` rejects unknown kinds so a typo cannot silently
# produce an event no validator or report will ever look at.
EVENT_KINDS = frozenset({
    "submit",           # ticket created (past backpressure + deadline check)
    "admit",            # ticket entered the admission heap
    "deadline_reject",  # submit refused as provably unmeetable (no ticket)
    "stage",            # pump moved the ticket out of the admission heap
    "inject",           # materialized as a device pending-queue row
    "seat",             # holds a lane slot (host-seated, or via the queue)
    "restage",          # injected but not consumed; back to the backlog
    "evict",            # seat banked partial state + freed at the boundary
    "preempt",          # evicted under queue pressure, re-queued resumable
    "resume",           # previously preempted run re-seated on device
    "cancel_request",   # tombstoned (any thread); honored at next boundary
    "cancel",           # terminal: resolved as cancelled
    "harvest",          # banked out of a segment's output buffers
    "resolve",          # terminal: Outcome delivered to the ticket
    "fail",             # terminal: service failure propagated to the ticket
    "dispatch",         # one executed segment (engine-level, no ticket)
    "span",             # one timed phase (seat/inject/dispatch/... timing)
})

TERMINAL_KINDS = frozenset({"cancel", "resolve", "fail"})


@dataclasses.dataclass(frozen=True)
class Event:
    """One flight-recorder entry.

    ``seq`` is a dense per-recorder sequence number (assigned under the
    recorder lock, so it is also the global emission order); ``t`` is a
    monotonic ``time.perf_counter`` stamp taken under the same lock, hence
    nondecreasing in ``seq``.  ``ticket``/``slot``/``segment`` key the
    event to a request, a lane seat, and a segment dispatch; ``data``
    carries kind-specific fields (span phase + duration, dispatch step
    counts, resolve latency, ...).
    """

    seq: int
    t: float
    kind: str
    ticket: int | None = None
    slot: int | None = None
    segment: int | None = None
    data: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = {"seq": self.seq, "t": self.t, "kind": self.kind}
        if self.ticket is not None:
            d["ticket"] = self.ticket
        if self.slot is not None:
            d["slot"] = self.slot
        if self.segment is not None:
            d["segment"] = self.segment
        d.update(self.data)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Event":
        d = dict(d)
        return cls(seq=d.pop("seq"), t=d.pop("t"), kind=d.pop("kind"),
                   ticket=d.pop("ticket", None), slot=d.pop("slot", None),
                   segment=d.pop("segment", None), data=d)


class FlightRecorder:
    """Bounded thread-safe event log behind the streaming service.

    ``capacity`` bounds the ring (oldest events drop first; ``dropped``
    counts them); ``enabled=False`` turns :meth:`emit` into a no-op so an
    untraced service pays one attribute check per would-be event.  All
    methods are safe to call from any thread.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self._capacity = capacity
        self._lock = threading.Lock()
        self._ring: collections.deque[Event] = collections.deque(
            maxlen=capacity)
        self._counts: collections.Counter = collections.Counter()
        self._seq = 0
        self._dropped = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def dropped(self) -> int:
        """Events evicted from the ring (full-history counts still include
        them — see :meth:`counts`)."""
        with self._lock:
            return self._dropped

    def emit(self, kind: str, *, ticket: int | None = None,
             slot: int | None = None, segment: int | None = None,
             **data: Any) -> None:
        """Record one event (no-op when disabled).  ``kind`` must be in
        :data:`EVENT_KINDS`; extra keywords become the event's ``data``."""
        if not self.enabled:
            return
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r} (known: "
                             f"{sorted(EVENT_KINDS)})")
        with self._lock:
            self._seq += 1
            if len(self._ring) == self._capacity:
                self._dropped += 1
            self._ring.append(Event(seq=self._seq, t=time.perf_counter(),
                                    kind=kind, ticket=ticket, slot=slot,
                                    segment=segment, data=data))
            self._counts[kind] += 1

    def events(self) -> list[Event]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def counts(self) -> dict[str, int]:
        """Per-kind event totals over the FULL history (survive ring
        eviction) — the counter-balance side of the recorder, compared
        against ``ServiceMetrics`` by the lifecycle fuzz tests."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        """Drop buffered events and zero the counts (``seq`` keeps
        increasing, so post-clear events never reuse sequence numbers)."""
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._dropped = 0

    def dump_jsonl(self, path) -> pathlib.Path:
        """Write the buffered events as JSON Lines; returns the path."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            for e in self.events():
                f.write(json.dumps(e.to_json()) + "\n")
        return path

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
