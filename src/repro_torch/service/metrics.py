"""Service observability: throughput, lane occupancy, queue depth, latency.

The port's copy of ``repro.service.metrics`` (numpy and threading only).
A :class:`MetricsRecorder` accrues counters on the broker's threads (one
short lock per event); :meth:`MetricsRecorder.snapshot` freezes them into a
:class:`ServiceMetrics` value object.  Time denominators use *serve*
seconds — wall time spent inside segments — so a service idling between
bursts reports the throughput and occupancy of the work it actually did,
not of the silence in between.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

__all__ = ["MetricsRecorder", "ServiceMetrics"]

# Latency percentiles are computed over a sliding window of the most
# recent resolutions (the mean runs over the full history via running
# sums) — a long-lived endpoint must not grow state per request.
_LATENCY_WINDOW = 4096


@dataclasses.dataclass(frozen=True)
class ServiceMetrics:
    """Frozen snapshot of a streaming tuner's counters."""

    lane_slots: int
    segments: int            # segments dispatched
    steps: int               # exploration loop iterations across segments
    busy_slot_steps: int     # seated-slot iterations (occupancy numerator)
    lane_occupancy: float    # busy_slot_steps / (steps * lane_slots)
    submitted: int
    resolved: int
    cancelled: int           # tickets resolved as cancelled
    preempted: int           # seat evictions under queue pressure
    resumed: int             # preempted runs re-seated on device
    slo_missed: int          # resolved after their per-ticket deadline
    deadline_rejected: int   # submits refused as provably unmeetable
    outstanding: int         # submitted - resolved - cancelled
    explorations: int        # sum of resolved runs' NEX
    serve_seconds: float     # wall time inside segments (excludes idle)
    runs_per_second: float   # resolved / serve_seconds
    explorations_per_second: float
    queue_depth_max: int     # admitted-not-seated runs at segment dispatch
    queue_depth_mean: float
    latency_mean_s: float    # submit -> outcome resolution (full history)
    latency_p50_s: float     # percentiles over the recent window
    latency_p95_s: float
    latency_p99_s: float
    latency_floor_s: float   # fastest resolution EVER (survives reset();
                             # 0.0 before the first resolution) — the
                             # deadline-admission bound

    def to_dict(self) -> dict:
        """Field -> value mapping (JSON-safe) — what the Prometheus
        renderer (``repro_torch.obs.metrics_to_prometheus``) iterates."""
        return dataclasses.asdict(self)


class MetricsRecorder:
    """Thread-safe accumulator behind :class:`ServiceMetrics`.

    ``latency_window`` bounds the percentile sample (default
    ``_LATENCY_WINDOW``); the mean still runs over the full history via
    running sums, so a long-lived endpoint never grows state per request.
    """

    def __init__(self, lane_slots: int,
                 latency_window: int = _LATENCY_WINDOW):
        if latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        self._lane_slots = lane_slots
        self._latency_window = latency_window
        self._lock = threading.Lock()
        self._latency_min: float | None = None
        self.reset()

    def reset(self) -> None:
        """Zero the window counters (e.g. after a warmup pass, so benchmark
        gates measure steady state rather than compile time).

        The latency *floor* deliberately survives: it is the deadline-
        admission bound (:meth:`latency_floor`), a property of the service's
        lifetime, not of a metrics window.  Resetting it would make
        ``deadline_policy="reject"`` silently admit every unmeetable
        deadline until a post-reset resolution re-primed it
        (``tests/test_torch_service_metrics.py`` holds the port to the
        reference's snapshots)."""
        with self._lock:
            self._segments = 0
            self._steps = 0
            self._busy = 0
            self._submitted = 0
            self._resolved = 0
            self._cancelled = 0
            self._preempted = 0
            self._resumed = 0
            self._slo_missed = 0
            self._deadline_rejected = 0
            self._explorations = 0
            self._serve_seconds = 0.0
            self._depth_sum = 0
            self._depth_max = 0
            self._latency_sum = 0.0
            self._latencies: collections.deque[float] = collections.deque(
                maxlen=self._latency_window)

    def record_submit(self) -> None:
        with self._lock:
            self._submitted += 1

    def record_cancel(self) -> None:
        with self._lock:
            self._cancelled += 1

    def record_preempt(self) -> None:
        with self._lock:
            self._preempted += 1

    def record_resume(self, n: int = 1) -> None:
        with self._lock:
            self._resumed += n

    def record_slo_miss(self) -> None:
        with self._lock:
            self._slo_missed += 1

    def record_deadline_reject(self) -> None:
        with self._lock:
            self._deadline_rejected += 1

    def latency_floor(self) -> float | None:
        """Fastest submit->resolution latency ever observed (full history,
        survives the window) — the deadline-admission bound: a deadline
        below this floor is provably unmeetable.  None before the first
        resolution (an empty service admits any deadline)."""
        with self._lock:
            return self._latency_min

    def record_segment(self, steps: int, busy_slot_steps: int,
                       wall_seconds: float, queue_depth: int) -> None:
        with self._lock:
            self._segments += 1
            self._steps += steps
            self._busy += busy_slot_steps
            self._serve_seconds += wall_seconds
            self._depth_sum += queue_depth
            self._depth_max = max(self._depth_max, queue_depth)

    def record_resolve(self, latency_seconds: float, nex: int) -> None:
        with self._lock:
            self._resolved += 1
            self._explorations += nex
            self._latency_sum += latency_seconds
            if (self._latency_min is None
                    or latency_seconds < self._latency_min):
                self._latency_min = latency_seconds
            self._latencies.append(latency_seconds)

    @classmethod
    def aggregate(cls, recorders) -> ServiceMetrics:
        """Fold per-shard recorders into one service-wide snapshot.

        Counters are summed RAW and only then derived: ``outstanding`` is
        clamped *once* over the summed counters — summing the per-shard
        clamped values would double-count whenever any shard sits below
        its own clamp (a post-reset shard reads 0 outstanding even while
        another shard's resolves drive the true aggregate down).  The
        counter-balance invariant therefore holds service-wide:
        ``submitted == resolved + cancelled + outstanding`` (pre-reset).

        ``lane_occupancy`` keeps per-recorder denominators (each shard
        only ever held its own slots); ``serve_seconds`` sums to
        device-seconds of work (shards serve concurrently, so the rates
        here are per device-second — fleet wall-clock rates belong to the
        caller's own clock); percentiles pool the recent windows; the
        latency floor is the min across shards.  Aggregating a single
        recorder reproduces its :meth:`snapshot` exactly.
        """
        recorders = list(recorders)
        if not recorders:
            raise ValueError("aggregate needs at least one recorder")
        raw = []
        for r in recorders:
            with r._lock:
                raw.append({
                    "slots": r._lane_slots, "segments": r._segments,
                    "steps": r._steps, "busy": r._busy,
                    "submitted": r._submitted, "resolved": r._resolved,
                    "cancelled": r._cancelled, "preempted": r._preempted,
                    "resumed": r._resumed, "slo_missed": r._slo_missed,
                    "deadline_rejected": r._deadline_rejected,
                    "explorations": r._explorations,
                    "serve": r._serve_seconds, "depth_sum": r._depth_sum,
                    "depth_max": r._depth_max,
                    "latency_sum": r._latency_sum,
                    "latencies": list(r._latencies),
                    "floor": r._latency_min})

        def tot(key):
            return sum(row[key] for row in raw)

        slots, segments, steps, busy = (tot("slots"), tot("segments"),
                                        tot("steps"), tot("busy"))
        submitted, resolved, cancelled = (tot("submitted"), tot("resolved"),
                                          tot("cancelled"))
        explorations, serve = tot("explorations"), tot("serve")
        latency_sum, depth_sum = tot("latency_sum"), tot("depth_sum")
        depth_max = max(row["depth_max"] for row in raw)
        lat = np.asarray([x for row in raw for x in row["latencies"]],
                         np.float64)
        floors = [row["floor"] for row in raw if row["floor"] is not None]
        occ_denom = sum(row["steps"] * row["slots"] for row in raw)
        return ServiceMetrics(
            lane_slots=slots,
            segments=segments,
            steps=steps,
            busy_slot_steps=busy,
            lane_occupancy=busy / max(occ_denom, 1),
            submitted=submitted,
            resolved=resolved,
            cancelled=cancelled,
            preempted=tot("preempted"),
            resumed=tot("resumed"),
            slo_missed=tot("slo_missed"),
            deadline_rejected=tot("deadline_rejected"),
            outstanding=max(submitted - resolved - cancelled, 0),
            explorations=explorations,
            serve_seconds=serve,
            runs_per_second=resolved / serve if serve else 0.0,
            explorations_per_second=(explorations / serve
                                     if serve else 0.0),
            queue_depth_max=depth_max,
            queue_depth_mean=(depth_sum / segments if segments else 0.0),
            latency_mean_s=(latency_sum / resolved if resolved else 0.0),
            latency_p50_s=(float(np.percentile(lat, 50))
                           if lat.size else 0.0),
            latency_p95_s=(float(np.percentile(lat, 95))
                           if lat.size else 0.0),
            latency_p99_s=(float(np.percentile(lat, 99))
                           if lat.size else 0.0),
            latency_floor_s=min(floors) if floors else 0.0)

    def snapshot(self) -> ServiceMetrics:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            serve = self._serve_seconds
            return ServiceMetrics(
                lane_slots=self._lane_slots,
                segments=self._segments,
                steps=self._steps,
                busy_slot_steps=self._busy,
                lane_occupancy=self._busy / max(self._steps
                                                * self._lane_slots, 1),
                submitted=self._submitted,
                resolved=self._resolved,
                cancelled=self._cancelled,
                preempted=self._preempted,
                resumed=self._resumed,
                slo_missed=self._slo_missed,
                deadline_rejected=self._deadline_rejected,
                # Clamped: a reset() taken while runs were in flight zeroes
                # the submit counter before those runs resolve, and the gap
                # must read as "none outstanding since reset", not as a
                # negative count.  Counter balance invariant:
                # submitted == resolved + cancelled + outstanding.
                outstanding=max(self._submitted - self._resolved
                                - self._cancelled, 0),
                explorations=self._explorations,
                serve_seconds=serve,
                runs_per_second=self._resolved / serve if serve else 0.0,
                explorations_per_second=(self._explorations / serve
                                         if serve else 0.0),
                queue_depth_max=self._depth_max,
                queue_depth_mean=(self._depth_sum / self._segments
                                  if self._segments else 0.0),
                latency_mean_s=(self._latency_sum / self._resolved
                                if self._resolved else 0.0),
                latency_p50_s=(float(np.percentile(lat, 50))
                               if lat.size else 0.0),
                latency_p95_s=(float(np.percentile(lat, 95))
                               if lat.size else 0.0),
                latency_p99_s=(float(np.percentile(lat, 99))
                               if lat.size else 0.0),
                latency_floor_s=(self._latency_min
                                 if self._latency_min is not None else 0.0))
