"""The readers of the program's own plan spans and event-loop counters, on
hand-built runs: each gives its value where its spans or counters are
there, and None where they are not (as in a program without them)."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

from harness.cell import Run  # noqa: E402
from harness.spec import Spec  # noqa: E402
from harness.traffic import PlanRecord  # noqa: E402

SPEC = Spec.load(ROOT)
NEW = ("alg2_s.search", "rerank_s.search", "facade_des_s.search",
       "plan_self_s.search", "syncs_per_trip.search")


def _run(spans=(), counters=None, ok=2, failed=0) -> Run:
    records = [PlanRecord(i, i, float(i), 1.0, feasible=True)
               for i in range(ok)]
    records += [PlanRecord(ok + i, 0, 0.0, 1.0, error="boom")
                for i in range(failed)]
    return Run(workload={}, config={}, traffic={}, records=records,
               spans=list(spans), counters=dict(counters or {}))


def read(name: str, run: Run):
    return SPEC.reader(name).read(run)


def test_entries_read_in_the_search_cell():
    entries = {m["name"]: m for m in SPEC.raw["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["m462b.search"]
        assert m["moves"] == "search_gen_s"
    assert {entries[n]["source"] for n in NEW[:4]} == {"program_span"}
    assert entries["syncs_per_trip.search"]["source"] == "program_counter"


@pytest.mark.parametrize("name,span", [
    ("alg2_s.search", "xbound.upper_bound"),
    ("rerank_s.search", "ga.rerank")])
def test_stage_seconds_per_completed_plan(name, span):
    spans = [(span, 0.0, 1.5), (span, 10.0, 0.5), ("xbound", 0.0, 9.0),
             ("host_des", 0.0, 9.0), ("des.host", 0.2, 0.3)]
    assert read(name, _run(spans, failed=1)) == pytest.approx(1.0)
    assert read(name, _run(spans[2:])) is None      # no span of the program
    assert read(name, _run(spans, ok=0, failed=1)) is None


def test_facade_des_seconds_sum_ideal_and_certify():
    spans = [("api.ideal", 0.0, 0.1), ("api.certify", 5.0, 0.2),
             ("api.ideal", 6.0, 0.3), ("api.certify", 9.0, 0.4),
             ("des.host", 0.0, 0.1), ("host_des", 0.0, 0.1)]
    assert read("facade_des_s.search", _run(spans)) == pytest.approx(0.5)
    assert read("facade_des_s.search", _run(spans[4:])) is None
    assert read("facade_des_s.search", _run(spans, ok=0)) is None


def test_plan_self_seconds_leave_out_the_benchmark_spans():
    spans = [
        ("api.plan", 0.0, 10.0),
        ("des.problem", -1.0, 1.2),          # clipped to 0 .. 0.2
        ("xbound.upper_bound", 0.5, 1.0),    # 0.5 .. 1.5
        ("ga.evolve", 1.0, 5.0),             # 1 .. 6, overlaps the above
        ("ga.generation", 2.0, 1.0),         # inside ga.evolve
        ("des.host", 7.0, 1.0),              # 7 .. 8
        ("plan", 0.0, 10.0), ("xbound", 0.5, 1.0),
        ("host_des", 7.0, 2.0),              # would cover 8 .. 9 too
        ("api.ideal", 11.0, 1.0),            # after the plan
    ]
    # covered: 0 .. 0.2, 0.5 .. 6 and 7 .. 8, so 10 - 6.7 is the plan's own
    assert read("plan_self_s.search", _run(spans, ok=1)) == \
        pytest.approx(3.3)
    assert read("plan_self_s.search", _run(spans, ok=2)) == \
        pytest.approx(1.65)
    two = spans + [("api.plan", 20.0, 2.0), ("ga.rerank", 20.5, 1.0)]
    assert read("plan_self_s.search", _run(two, ok=2)) == \
        pytest.approx((3.3 + 1.0) / 2)
    assert read("plan_self_s.search", _run(spans[1:])) is None
    assert read("plan_self_s.search", _run(spans, ok=0)) is None


def test_syncs_per_trip_reads_the_two_counters():
    counters = {"des_host_syncs_total": 1010.0,
                "des_event_trips_total": 1000.0}
    assert read("syncs_per_trip.search", _run(counters=counters)) == \
        pytest.approx(1.01)
    # a program without the sync counter, or a window without a trip
    assert read("syncs_per_trip.search", _run(counters={
        "des_event_trips_total": 1000.0})) is None
    assert read("syncs_per_trip.search", _run(counters={
        "des_host_syncs_total": 3.0, "des_event_trips_total": 0.0})) is None

