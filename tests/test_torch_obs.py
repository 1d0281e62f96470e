"""The port's own spans and event-loop counters, on the CPU.

One traced delta-fast `plan` at a small job gives one span tree per plan:
every span's parent chain ends at the plan's `api.plan` span, the numpy
DES runs once per stage that runs (`des.host`), and every span lies on
`time.perf_counter`.  The torch DES counts its trips and host reads once
per simulation, and its filling rounds only while tracing is on, with no
rounds work in the trip when it is off.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.core.api import PlanRequest, plan
from repro_torch.core.des import DESProblem
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.ga import GAOptions
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.obs import REGISTRY
from repro_torch.obs.tracing import _NULL_SPAN, Tracer

CPU = DESOptions(device="cpu")
COUNTERS = ("des_event_trips_total", "des_host_syncs_total",
            "des_fill_rounds_total")


def small_dag(mb: int = 4):
    """gpt-7b's Fig.-1 profiling job (4 pods, 2 stages per pod)."""
    job = JobSpec(name="gpt7b", tp=2, pp=4, dp=2, num_microbatches=mb,
                  micro_tokens=4096, d_model=4096,
                  stage_params=(1.75e9,) * 4, gpus_per_pod_per_replica=4)
    return build_comm_dag(job, 400.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def traced_plan():
    """(records, result, perf_counter before, after) of one traced plan."""
    dag = small_dag()
    opts = GAOptions(seed=3, pop_size=8, max_generations=3, patience=100,
                     time_limit=1e9, des_options=CPU)
    obs.TRACER.clear()
    before = time.perf_counter()
    with obs.enabled():
        res = plan(PlanRequest(dag=dag, method="delta-fast",
                               ga_options=opts))
    after = time.perf_counter()
    records = obs.TRACER.records
    obs.TRACER.clear()
    return records, res, before, after


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def test_every_span_chains_to_its_plan(traced_plan):
    records, _, _, _ = traced_plan
    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)           # ids are unique
    roots = [r for r in records if r.parent_id is None]
    assert [r.name for r in roots] == ["api.plan"]
    root = roots[0]
    assert root.attrs["kind"] == "dag"
    assert root.attrs["method"] == "delta-fast"
    for r in records:
        hops, cur = 0, r
        while cur.parent_id is not None:
            parent = by_id[cur.parent_id]
            assert cur.parent == parent.name
            assert cur.depth == parent.depth + 1
            cur, hops = parent, hops + 1
        assert cur is root and hops == r.depth
    names = set(_by_name(records))
    assert {"api.plan", "api.ideal", "api.certify", "xbound.upper_bound",
            "ga.rerank", "des.problem", "des.build", "des.host",
            "ga.evolve", "ga.fitness_batch", "des.simulate"} <= names


def test_des_host_runs_once_per_stage(traced_plan):
    """The ideal run, each re-ranked genome, the winner again in
    delta_fast, the certification, and Alg. 2's t_up estimate."""
    records, res, _, _ = traced_plan
    by = _by_name(records)
    by_id = {r.id: r for r in records}
    (rerank,) = by["ga.rerank"]
    scored = rerank.attrs["scored"]
    assert 1 <= scored <= rerank.attrs["top"] == 8
    parents = collections.Counter(by_id[r.parent_id].name
                                  for r in by["des.host"])
    assert parents == {"api.ideal": 1, "ga.rerank": scored, "api.plan": 1,
                       "api.certify": 1, "xbound.upper_bound": 1}
    assert len(by["des.host"]) == 1 + scored + 1 + 1 + 1
    (ideal,) = [r for r in by["des.host"]
                if by_id[r.parent_id].name == "api.ideal"]
    assert ideal.attrs == {"ideal": True}
    (certify,) = by["api.certify"]
    assert certify.attrs["feasible"] is bool(res.feasible) is True
    (xb,) = by["xbound.upper_bound"]
    assert xb.attrs == {"tasks": small_dag().num_tasks, "closure": "auto"}
    # the engine the GA builds, and the DES problems of the plan
    (build,) = by["des.build"]
    assert build.attrs["members"] == 0 and isinstance(build.attrs["hit"],
                                                      bool)
    for r in by["des.problem"]:
        assert r.attrs["tasks"] == small_dag().num_tasks


def test_spans_are_on_perf_counter(traced_plan):
    records, _, before, after = traced_plan
    for r in records:
        assert before <= r.t0 <= r.t0 + r.dur <= after
    (root,) = [r for r in records if r.name == "api.plan"]
    for r in records:
        assert root.t0 <= r.t0 and r.t0 + r.dur <= root.t0 + root.dur


def test_plan_ids_are_one_sequence():
    dag = small_dag(2)
    opts = GAOptions(seed=0, pop_size=4, max_generations=1, time_limit=1e9,
                     des_options=CPU)
    obs.TRACER.clear()
    with obs.enabled():
        for method in ("prop-alloc", None):
            plan(PlanRequest(dag=dag, method=method, ga_options=opts))
    plans = [r for r in obs.TRACER.records if r.name == "api.plan"]
    obs.TRACER.clear()
    # a request naming no method records the default its kind runs
    assert [p.attrs["method"] for p in plans] == ["prop-alloc", "delta-fast"]
    # each plan is a root, and the span ids, one sequence per tracer, tell
    # the plans apart in the order they ran
    assert [p.parent_id for p in plans] == [None, None]
    assert plans[0].id < plans[1].id


def test_chrome_trace_exports_ids():
    tr = Tracer(enabled=True)
    with tr.span("outer"):
        with tr.span("inner", k=1):
            pass
    recs = {r.name: r for r in tr.records}
    assert recs["inner"].parent_id == recs["outer"].id
    assert recs["outer"].parent_id is None
    assert recs["inner"].as_dict()["parent_id"] == recs["outer"].id
    events = {e["name"]: e for e in tr.to_chrome_trace()["traceEvents"]
              if e["ph"] == "X"}
    assert events["inner"]["args"] == {"k": 1, "parent": "outer",
                                       "id": recs["inner"].id,
                                       "parent_id": recs["outer"].id}
    assert events["outer"]["args"]["parent_id"] is None


def test_disabled_span_is_null_and_cheap():
    """Under 2 us per disabled `span()` call: the plan's stages take
    milliseconds, so a few spans per plan cost nothing measurable."""
    with obs.enabled(False):
        assert obs.span("x", a=1) is _NULL_SPAN
        obs.TRACER.clear()
        n = 100_000
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("hot", i=0):
                pass
        per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"{per_call * 1e6:.2f} us per disabled span"
    assert obs.TRACER.records == []


# ------------------------------------------------------- event-loop counts
def _topology(dag, circuits: int = 2) -> np.ndarray:
    x = np.zeros((dag.cluster.num_pods,) * 2, dtype=np.int64)
    for i, j in dag.undirected_pairs():
        x[i, j] = x[j, i] = circuits
    return x


def _count(des: TorchDES, run, traced: bool):
    """(trips, syncs, rounds) the counters gained over `run()`, and the
    trips counted independently: one rate step per trip."""
    calls = [0]
    rates = des._rates

    def counted(*args):
        calls[0] += 1
        return rates(*args)
    des._rates = counted
    before = [REGISTRY.counter(c).value() for c in COUNTERS]
    try:
        with obs.enabled(traced):
            run()
    finally:
        des._rates = rates
        obs.TRACER.clear()
    after = [REGISTRY.counter(c).value() for c in COUNTERS]
    return tuple(a - b for a, b in zip(after, before)), calls[0]


@pytest.mark.parametrize("entry", ["simulate", "batch"])
def test_ref_and_segment_count_alike_and_rounds_only_traced(entry):
    dag = small_dag(3)
    prob = DESProblem(dag)
    x = _topology(dag)
    xs = np.stack([x, _topology(dag, 1), _topology(dag, 3)])
    got = {}
    for backend in ("ref", "segment"):
        des = TorchDES(prob, options=DESOptions(device="cpu",
                                                backend=backend))

        def run():
            if entry == "simulate":
                des.simulate(x)
            else:
                des.batch_makespan(xs)
        (trips, syncs, rounds), steps = _count(des, run, traced=True)
        (trips0, syncs0, rounds0), steps0 = _count(des, run, traced=False)
        # trips count exactly the rate steps, traced or not
        assert trips == steps == trips0 == steps0 > 0
        # rounds only while traced; the traced run reads them once more
        assert rounds > 0 and rounds0 == 0
        assert syncs == syncs0 + 1
        got[backend] = (trips, syncs, rounds)
    assert got["ref"] == got["segment"]
    trips, syncs, rounds = got["ref"]
    # the loop's exit tests (one per trip and the last), the rounds read,
    # and the result copies: 4 for one topology (makespan, feasibility,
    # start, finish), 2 for a batch
    copies = 4 if entry == "simulate" else 2
    assert syncs == trips + 1 + 1 + copies


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def test_untraced_trip_does_no_rounds_work():
    """Tracing off: each trip loses the rounds' max and add, and the
    simulation its rounds read; tracing on, they are back."""
    dag = small_dag(3)
    des = TorchDES(DESProblem(dag), options=CPU)
    x = _topology(dag)
    counts = {}
    for traced in (False, True):
        with obs.enabled(traced), _OpCount() as mode:
            before = REGISTRY.counter("des_event_trips_total").value()
            des.simulate(x)
            trips = REGISTRY.counter("des_event_trips_total").value() \
                - before
        obs.TRACER.clear()
        counts[traced] = (mode.ops, trips)
    (off, trips), (on, trips_on) = counts[False], counts[True]
    assert trips == trips_on > 0
    assert on["amax"] - off["amax"] == trips
    assert on["add_"] - off["add_"] == trips
