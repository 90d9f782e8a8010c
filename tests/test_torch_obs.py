"""The port's observability layer against the JAX package's
(``tests/test_obs.py``): recorder mechanics, spans, exporters, forensics —
and the zero-perturbation pin: a trace-on service replays the trace-off
service bit for bit.

The validators and the Prometheus renderer are held to the reference's
output on the same events and metrics; ``signature`` (the port's canonical
program text) must be stable when a program runs again and differ between
programs.
"""

import json
import threading

import pytest
import torch

import repro.obs as jobs_
from repro.service.metrics import MetricsRecorder as JMetricsRecorder
from repro_torch.analysis import registered_programs, signature
from repro_torch.core import Settings, run_queue
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import (COUNTER_FIELDS, EVENT_KINDS, PHASES,
                             PINNED_OUTCOME_FIELDS, TERMINAL_KINDS, Event,
                             FlightRecorder, diff_outcomes, dump_divergence,
                             metrics_to_prometheus, phase_span,
                             read_trace_jsonl, registry_signatures,
                             validate_lifecycle, validate_trace,
                             write_trace_jsonl)
from repro_torch.service import ServiceConfig, StreamingTuner
from repro_torch.service.metrics import MetricsRecorder
from tests.test_torch_service import CPU, LA1, pinned, requests, syn_jobs

torch.set_num_threads(1)


# --------------------------------------------------------------------------- #
# FlightRecorder mechanics
# --------------------------------------------------------------------------- #
def test_vocabularies_match_the_reference():
    assert EVENT_KINDS == jobs_.EVENT_KINDS
    assert TERMINAL_KINDS == jobs_.TERMINAL_KINDS <= EVENT_KINDS
    assert PHASES == jobs_.PHASES == ("seat", "inject", "dispatch",
                                      "device_block", "harvest")
    assert COUNTER_FIELDS == jobs_.COUNTER_FIELDS
    assert PINNED_OUTCOME_FIELDS == jobs_.PINNED_OUTCOME_FIELDS


def test_recorder_ring_bounds_and_full_history_counts():
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.emit("submit", ticket=i)
    assert len(rec) == 4
    assert rec.dropped == 6
    assert [e.ticket for e in rec.events()] == [6, 7, 8, 9]
    assert rec.counts() == {"submit": 10}
    rec.clear()
    assert len(rec) == 0 and rec.counts() == {} and rec.dropped == 0
    rec.emit("submit", ticket=99)
    assert rec.events()[0].seq == 11, "seq must never be reused after clear"


def test_recorder_rejects_unknown_kind_and_disabled_is_a_no_op():
    with pytest.raises(ValueError, match="unknown event kind"):
        FlightRecorder().emit("teleport", ticket=1)
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)
    rec = FlightRecorder(enabled=False)
    rec.emit("submit", ticket=1)
    rec.emit("nonsense-not-even-validated")
    assert len(rec) == 0 and rec.counts() == {}


def test_recorder_seq_and_time_monotone_under_threads():
    rec = FlightRecorder(capacity=10_000)

    def hammer(tid):
        for _ in range(200):
            rec.emit("stage", ticket=tid)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert validate_trace(rec.events()) == []
    assert rec.counts()["stage"] == 800


def test_event_jsonl_round_trip_and_reference_schema(tmp_path):
    rec = FlightRecorder()
    rec.emit("seat", ticket=3, slot=1, segment=2, via="host", shard=0)
    rec.emit("dispatch", segment=2, steps=5, busy=8)
    path = rec.dump_jsonl(tmp_path / "trace.jsonl")
    back = read_trace_jsonl(path)
    assert back == rec.events()
    assert back[0].data == {"via": "host", "shard": 0}
    p2 = write_trace_jsonl(rec.events(), tmp_path / "t2.jsonl")
    assert p2.read_text() == path.read_text()
    # the JAX package reads the port's trace as its own
    theirs = jobs_.read_trace_jsonl(path)
    assert [e.to_json() for e in theirs] == [e.to_json() for e in back]


# --------------------------------------------------------------------------- #
# phase_span
# --------------------------------------------------------------------------- #
def test_phase_span_times_and_attributes_compiles():
    rec = FlightRecorder()
    with phase_span(rec, "dispatch", segment=0, compiles=True, shard=1):
        pass
    (e,) = rec.events()
    assert e.kind == "span" and e.data["phase"] == "dispatch"
    assert e.data["dur_s"] >= 0.0 and e.data["shard"] == 1
    assert e.data["episode_compiles"] == 0
    assert e.data["selector_compiles"] == 0


def test_phase_span_emits_on_raise_and_checks_its_phase():
    rec = FlightRecorder()
    with pytest.raises(RuntimeError):
        with phase_span(rec, "device_block"):
            raise RuntimeError("crashed dispatch")
    (e,) = rec.events()
    assert e.data["phase"] == "device_block"
    with pytest.raises(ValueError, match="unknown phase"):
        with phase_span(FlightRecorder(), "warp"):
            pass
    off = FlightRecorder(enabled=False)
    with phase_span(off, "seat", profiler=True):
        pass
    with phase_span(None, "seat"):
        pass
    assert len(off) == 0


def test_phase_span_profiler_scope_names_the_phase():
    rec = FlightRecorder()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with phase_span(rec, "harvest", profiler=True):
            torch.ones(4).sum()
    assert "lynceus/harvest" in {e.key for e in prof.key_averages()}
    assert rec.events()[0].data["phase"] == "harvest"


# --------------------------------------------------------------------------- #
# Validators and Prometheus: the reference's output on the same input
# --------------------------------------------------------------------------- #
def _ev(seq, kind, ticket=None, **data):
    return Event(seq=seq, t=float(seq), kind=kind, ticket=ticket, data=data)


_TRACES = {
    "schema": [Event(seq=1, t=1.0, kind="nope"),
               Event(seq=1, t=0.5, kind="submit"),
               Event(seq=2, t=0.6, kind="span", data={"phase": "warp"}),
               Event(seq=3, t=0.7, kind="dispatch"),
               Event(seq=4, t=0.8, kind="seat"),
               Event(seq=5, t=0.9, kind="span",
                     data={"phase": "seat", "dur_s": -1.0}),
               Event(seq=6, t=1.0, kind="stage", ticket=2,
                     data={"shard": -1})],
    "seat_without_admit": [_ev(1, "seat", ticket=1)],
    "resolve_after_cancel": [
        _ev(1, "submit", ticket=1), _ev(2, "admit", ticket=1),
        _ev(3, "cancel_request", ticket=1), _ev(4, "cancel", ticket=1),
        _ev(5, "resolve", ticket=1)],
    "cancel_unrequested": [_ev(1, "submit", ticket=1),
                           _ev(2, "cancel", ticket=1)],
    "resume_unpreempted": [
        _ev(1, "submit", ticket=1), _ev(2, "admit", ticket=1),
        _ev(3, "stage", ticket=1), _ev(4, "seat", ticket=1),
        _ev(5, "resume", ticket=1)],
    "happy_path": [
        _ev(1, "submit", ticket=1), _ev(2, "admit", ticket=1),
        _ev(3, "stage", ticket=1), _ev(4, "inject", ticket=1),
        _ev(5, "seat", ticket=1), _ev(6, "evict", ticket=1),
        _ev(7, "preempt", ticket=1), _ev(8, "stage", ticket=1),
        _ev(9, "seat", ticket=1), _ev(10, "resume", ticket=1),
        _ev(11, "harvest", ticket=1), _ev(12, "resolve", ticket=1)],
    "undrained": [_ev(1, "submit", ticket=1), _ev(2, "admit", ticket=1)],
    "cross_shard": [_ev(1, "submit", ticket=1, shard=0),
                    _ev(2, "admit", ticket=1, shard=1)],
}


def _theirs(events):
    return [jobs_.Event.from_json(e.to_json()) for e in events]


@pytest.mark.parametrize("name", sorted(_TRACES))
def test_validators_give_the_references_output(name):
    events = _TRACES[name]
    assert validate_trace(events) == jobs_.validate_trace(_theirs(events))
    for term in (False, True):
        assert (validate_lifecycle(events, require_terminal=term)
                == jobs_.validate_lifecycle(_theirs(events),
                                            require_terminal=term))
    if name != "happy_path":
        assert (validate_trace(events)
                or validate_lifecycle(events, require_terminal=True))


def test_prometheus_text_equals_the_reference():
    ops = [("submit",), ("segment", 4, 6, 0.5, 2), ("resolve", 0.5, 4),
           ("submit",), ("cancel",), ("preempt",), ("resume", 1)]
    mine, ref = MetricsRecorder(2), JMetricsRecorder(2)
    for name, *args in ops:
        getattr(mine, f"record_{name}")(*args)
        getattr(ref, f"record_{name}")(*args)
    text = metrics_to_prometheus(mine.snapshot())
    assert text == jobs_.metrics_to_prometheus(ref.snapshot())
    assert text == metrics_to_prometheus(ref.snapshot(), "lynceus_service")
    assert "# TYPE lynceus_service_resolved counter" in text
    assert "# TYPE lynceus_service_lane_occupancy gauge" in text


# --------------------------------------------------------------------------- #
# Forensics and program signatures
# --------------------------------------------------------------------------- #
def test_diff_outcomes_and_divergence_artifact(tmp_path):
    class O:
        def __init__(self, nex, spent):
            self.explored, self.recommended, self.cno = (1, 2), 2, 0.5
            self.nex, self.spent, self.budget = nex, spent, 3.0
            self.found_optimum, self.censored = True, set()
            self.trajectory, self.spend_trajectory = (0.5,), (spent,)

    a, b = O(2, 1.0), O(3, 1.5)
    assert diff_outcomes([a], [a]) == []
    diffs = diff_outcomes([a], [b])
    assert any("nex differs" in d for d in diffs)
    assert any("spend_trajectory differs" in d for d in diffs)
    rec = FlightRecorder()
    rec.emit("submit", ticket=1)
    p0 = dump_divergence("unit", expected=[a], actual=[b], recorder=rec,
                         context={"suite": "test_torch_obs"},
                         signatures={"x": "in()"}, out_dir=tmp_path)
    p1 = dump_divergence("unit", expected=[a], actual=[b],
                         out_dir=tmp_path)
    assert p0 != p1, "repeated failures must not overwrite each other"
    art = json.loads(p0.read_text())
    assert art["diffs"] and art["context"] == {"suite": "test_torch_obs"}
    assert art["expected"][0]["nex"] == 2 and art["actual"][0]["nex"] == 3
    assert art["flight_record"][0]["kind"] == "submit"
    assert art["event_counts"] == {"submit": 1}
    assert art["program_signatures"] == {"x": "in()"}
    assert set(art["expected"][0]) == set(PINNED_OUTCOME_FIELDS)


def test_registry_signatures_over_the_ports_registry(tmp_path):
    sigs = registry_signatures(["episode/segment", "no/such/program"],
                               device="cpu")
    assert sorted(sigs) == ["episode/segment", "episode/segment/bucketed",
                            "episode/segment/sharded"]
    assert all(s.startswith("in(") and "<signature failed" not in s
               for s in sigs.values())
    # placement is not part of the program: a shard runs the bucketed
    # segment's operations (on the CPU every shard is ``cpu``)
    assert sigs["episode/segment/sharded"] == sigs["episode/segment/bucketed"]
    assert sigs["episode/segment"] != sigs["episode/segment/bucketed"]
    path = dump_divergence("sigs", signatures=["episode/segment/sharded"],
                           out_dir=tmp_path, device="cpu")
    art = json.loads(path.read_text())
    assert art["program_signatures"] == {
        "episode/segment/sharded": sigs["episode/segment/sharded"]}


def test_registry_signatures_default_to_the_card(tmp_path):
    """Without ``device=`` the signatures are taken on the card, where the
    ``kernel/*/auto`` programs run the kernels: here, with no card, both
    entry points raise instead of recording the CPU's plain programs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry_signatures(["episode/segment"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dump_divergence("sigs", signatures=["episode/segment"],
                        out_dir=tmp_path)


def test_signature_stable_under_rerun_and_distinct_for_distinct_programs():
    specs = {s.name: s for s in registered_programs()}
    sigs = {}
    for name in ("selector/lynceus/native", "selector/lynceus/native/fused",
                 "selector/la0/native", "kernel/gh_ei/ref"):
        fn, example, _ = specs[name].build(torch.device("cpu"))
        sigs[name] = signature(fn, *example)
        assert signature(fn, *example) == sigs[name], name
    assert len(set(sigs.values())) == len(sigs)
    # the same operations on another shape, or another operation, differ
    f = lambda x, y: (x * 2 + y).sum()
    a, b = torch.ones(3), torch.zeros(3)
    assert signature(f, a, b) == signature(f, torch.ones(3), b)
    assert signature(f, a, b) != signature(f, torch.ones(4), torch.ones(4))
    assert signature(f, a, b) != signature(lambda x, y: (x + y).sum(), a, b)


# --------------------------------------------------------------------------- #
# The zero-perturbation pin + an end-to-end traced service
# --------------------------------------------------------------------------- #
_PLANS = [(r % 2, 770 + r, 4.0 if r % 2 == 0 else 1.5) for r in range(6)]


def _drive(cfg: ServiceConfig):
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(**LA1), cfg, device=CPU)
    tickets = []
    for i, r in enumerate(requests(jobs, _PLANS)):
        tickets.append(svc.submit(r, priority=i % 2))
        if i % 2:
            svc.pump()
    svc.drain()
    return [t.result() for t in tickets], svc


def test_trace_on_replays_trace_off_bit_for_bit(tmp_path):
    """A traced service's outcomes equal the untraced one's and the port's
    sequential oracle's; its record passes both validators, covers every
    phase and lifecycle stage the drive exercised, and round-trips."""
    base = dict(lane_slots=2, queue_capacity=3, step_quota=6, high_water=0)
    off, svc_off = _drive(ServiceConfig(**base))
    on, svc = _drive(ServiceConfig(**base, trace=True, trace_capacity=8192))
    assert [pinned(o) for o in on] == [pinned(o) for o in off]
    jobs = syn_jobs(synthetic_job, 2)
    seq = run_queue(requests(jobs, _PLANS), Settings(**LA1), device=CPU)
    assert [pinned(o) for o in on] == [pinned(o) for o in seq]
    assert svc_off.flight_record() == [] and svc_off.recorder.counts() == {}
    events = svc.flight_record()
    assert validate_trace(events) == []
    assert validate_lifecycle(events, require_terminal=True) == []
    assert jobs_.validate_lifecycle(_theirs(events),
                                    require_terminal=True) == []
    counts = svc.recorder.counts()
    assert counts["submit"] == counts["admit"] == len(_PLANS)
    assert counts["resolve"] == counts["harvest"] == len(_PLANS)
    assert counts["dispatch"] >= 1
    assert {e.data["phase"] for e in events if e.kind == "span"} \
        == set(PHASES)
    disp = [e for e in events if e.kind == "span"
            and e.data["phase"] == "dispatch"]
    assert all(e.data["episode_compiles"] >= 0
               and e.data["selector_compiles"] >= 0 for e in disp)
    path = svc.dump_trace(tmp_path / "svc.jsonl")
    assert read_trace_jsonl(path) == events


def test_trace_profiler_and_obs_report(tmp_path, capsys):
    """Profiler scopes are naming only; ``scripts/obs_report.py`` renders
    the port's trace and its validator gate trips on a corrupted one."""
    import pathlib
    import sys
    cfg = ServiceConfig(lane_slots=2, queue_capacity=3, step_quota=6,
                        trace=True, trace_profiler=True)
    outs, svc = _drive(cfg)
    assert all(o.nex > 0 for o in outs)
    path = svc.dump_trace(tmp_path / "trace.jsonl")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "scripts"))
    import obs_report
    argv = sys.argv
    try:
        sys.argv = ["obs_report.py", str(path), "--require-terminal"]
        assert obs_report.main() == 0
        out = capsys.readouterr().out
        for frag in ("0 issue(s)", "per-ticket timeline",
                     "per-slot occupancy", "phase spans"):
            assert frag in out
        with path.open("a") as f:
            f.write(json.dumps({"seq": 10**6, "t": 10.0**6,
                                "kind": "resolve", "ticket": 424242}) + "\n")
        sys.argv = ["obs_report.py", str(path)]
        assert obs_report.main() == 1
    finally:
        sys.argv = argv
