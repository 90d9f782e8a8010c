"""Streaming-service knobs: segment pacing, device queue sizing, admission.

The port's copy of ``repro.service.config``: the same fields, defaults and
validation.  All knobs here are *host-side pacing, capacity and observability*
controls — none of them can change a run's Outcome (the determinism
contract: outcomes are bit-identical to the sequential oracle regardless
of arrival order, seating order, segment boundaries, or whether the flight
recorder is on).  They trade device utilization against admission latency
instead.  The reference's docs/KNOBS.md documents each field with tuning
guidance.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ServiceConfig"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of a :class:`~repro_torch.service.StreamingTuner`.

    ``lane_slots``, ``queue_capacity`` and ``bucket`` fix the tensor
    shapes: one episode-segment program geometry per (slots, capacity,
    space-or-bucket geometry, settings, device) combination, reused for the
    service's lifetime (``episode_cache_size`` counts them).  The pacing
    knobs (``low_water``, ``step_quota``) are plain scalars of the
    segment's host loop — tune them per segment freely.
    """

    lane_slots: int = 8
    """Device lane seats advancing concurrently (the compacting episode's
    slot count).  Size like ``lane_chunk``: each slot pays the speculative
    lookahead state tensor (``n_trees x M x M*k_gh^la``)."""

    queue_capacity: int = 32
    """Device-side pending rows refilled per segment.  Bounds how many
    admitted runs ride each segment beyond the seated ones; admitted
    requests beyond it simply wait in the host admission buffer."""

    low_water: int | None = None
    """Segment early-exit: yield to the host when fewer than this many
    pending rows remain on device AND the host still holds backlog to
    inject.  None defaults to ``lane_slots`` (refill before seats starve).
    0 disables the early exit."""

    step_quota: int = 64
    """Max exploration steps per segment — the responsiveness bound: the
    host harvests finished runs and admits new arrivals between segments,
    so a smaller quota means lower admission/result latency and more host
    round trips."""

    max_pending: int | None = None
    """Admission backpressure: cap on outstanding (submitted, unresolved)
    requests.  ``submit`` blocks — or raises with ``block=False`` — while
    the cap is reached.  None disables backpressure."""

    high_water: int | None = None
    """Preemption trigger: when the host backlog (admitted, not yet
    staged) exceeds this depth at pump start and every seat is occupied,
    the broker may preempt the lowest-priority seated run at the segment
    boundary — bank its partial carry, re-queue it as a resumable request
    — provided a pending ticket has *strictly* better priority (so a
    re-queued victim never evicts itself).  None disables preemption.
    Resume replays bit-identically, so this only re-orders work."""

    aging_rate: float = 0.0
    """Priority aging in priority-units per second of wait: a backlogged
    ticket's effective staging priority is
    ``priority - aging_rate * wait_seconds``, so old low-priority tickets
    eventually outrank fresh high-priority traffic and cannot starve
    under sustained pressure.  0 disables aging (strict priority)."""

    deadline_policy: str = "reject"
    """What ``submit(deadline=...)`` does with a provably unmeetable
    deadline (below the service's observed resolution-latency floor):
    ``"reject"`` raises ``DeadlineUnmeetable`` at admission; ``"admit"``
    admits anyway and counts late resolutions in
    ``ServiceMetrics.slo_missed``.  Tickets without a deadline are never
    affected."""

    trace: bool = False
    """Flight recorder on/off (``repro_torch.obs.FlightRecorder``): record
    every lifecycle transition and segment dispatch plus per-phase timing
    spans.  Observability only — it cannot change a run's Outcome (the
    zero-perturbation rule)."""

    trace_capacity: int = 4096
    """Flight-recorder ring size: the most recent events kept for
    ``StreamingTuner.flight_record()``/``dump_trace()``.  Per-kind counts
    accrue over the full history regardless, so counter-balance checks
    survive ring eviction."""

    trace_profiler: bool = False
    """Additionally wrap each segment phase (seat/inject/dispatch/
    device_block/harvest) in a torch profiler scope
    (``torch.profiler.record_function``), so captured profiler traces show
    the phases by name.  Requires ``trace=True``."""

    num_shards: int = 1
    """Resident engines the service runs, one per shard — each with its
    own slot carry, device queue and tables, on the device
    ``cuda:{shard % device_count}`` (every shard on ``cpu`` for a CPU
    service; ``service/placement.py``).  1 = the single-engine service, on
    the service's device.  Shard count is pure capacity: every run's
    Outcome is byte-identical to the sequential oracle regardless of
    ``num_shards`` or which shard served it
    (``tests/test_torch_service_sharded.py``)."""

    placement_policy: str = "least_backlog"
    """How the broker routes a *new* ticket to a shard:
    ``"least_backlog"`` picks the shard with the fewest unfinished tickets
    (lowest id breaking ties), ``"round_robin"`` rotates.  Tickets are
    sticky: once placed, cancel/preempt/resume all stay on the home shard.
    Placement reorders work across engines — it can never change an
    Outcome."""

    bucket: tuple[int, int, int] | None = None
    """Geometry bucket ``(m, f, t)`` the registered jobs' spaces are
    right-padded into (see ``repro_torch.core.space.GeometryBucket``).
    None = auto: jobs sharing one space geometry run the native program, jobs of
    *different* geometries are padded into ``GeometryBucket.for_spaces``'s
    canonical bucket.  An explicit bucket forces padding even for a single
    geometry — size it to the largest job the service should ever admit
    and the one segment program geometry covers future registrations of
    any smaller geometry.  Like every knob here it cannot change a run's
    Outcome, only which program geometry serves it."""

    def __post_init__(self):
        if self.lane_slots < 1:
            raise ValueError("lane_slots must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.step_quota < 1:
            raise ValueError("step_quota must be >= 1")
        if self.low_water is not None and self.low_water < 0:
            raise ValueError("low_water must be >= 0 (or None for auto)")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if self.high_water is not None and self.high_water < 0:
            raise ValueError("high_water must be >= 0 (or None to disable "
                             "preemption)")
        if self.aging_rate < 0:
            raise ValueError("aging_rate must be >= 0")
        if self.deadline_policy not in ("reject", "admit"):
            raise ValueError("deadline_policy must be 'reject' or 'admit'")
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1")
        if self.trace_profiler and not self.trace:
            raise ValueError("trace_profiler requires trace=True (profiler "
                             "scopes annotate the recorded spans)")
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        from repro_torch.service.placement import PLACEMENT_POLICIES
        if self.placement_policy not in PLACEMENT_POLICIES:
            raise ValueError(f"placement_policy must be one of "
                             f"{PLACEMENT_POLICIES}")
        if self.bucket is not None:
            if len(self.bucket) != 3 or any(int(w) < 1 for w in self.bucket):
                raise ValueError("bucket must be three positive widths "
                                 "(m, f, t), or None for auto")

    def resolved_low_water(self) -> int:
        """The effective low-water mark (auto = lane_slots, capped at the
        device queue capacity so the exit condition is satisfiable)."""
        low = self.lane_slots if self.low_water is None else self.low_water
        return min(low, self.queue_capacity)
