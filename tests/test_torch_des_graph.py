"""The torch DES's event trips as a CUDA graph (`des_torch._TripGraph`):
the factored trip body against the eager loop of `_LaneDES._simulate`.

On the CPU the body runs eagerly, GRAPH_TRIPS trips per exit read as
`_LaneDES._replay` replays it, on the plain filling ('ref'); on a CUDA
device (marker `cuda`, skipped without one) the replayed graph runs on the
fused kernel against the eager loop on its plain version, which gives the
kernel's bits.  Nothing differs between the two but when the host reads
the exit flag, so every comparison is exact: start, finish, makespan,
feasibility, the trips in which some lane ran and the filling rounds.
On the card the kernel's launches are counted in a device trace: the
graph's replays launch it where the host sees no launch.  The graphs kept
are bounded by GRAPHS_KEPT, least recently replayed dropped first, and go
with their bucket.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_des_graph.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro_torch import obs
from repro_torch.convert import topology_from_numpy
from repro_torch.core.des import DESProblem
from repro_torch.core import des_torch
from repro_torch.core.des_torch import (GRAPH_TRIPS, DESOptions,
                                        EnsembleTorchDES, TorchDES,
                                        _incidence_csr, _keep_graph,
                                        _outcome, _TripGraph, des_cache_clear)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.kernels import waterfill
from repro_torch.obs import REGISTRY

LANES = 48


def problem(mb: int, **kw) -> DESProblem:
    ref = gpt7b_job(mb, **kw)
    return DESProblem(build_comm_dag(JobSpec(**{
        f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
        if f.init})))


def topologies(prob: DESProblem, k: int, seed: int) -> np.ndarray:
    """k random topologies of 1-3 circuits per pod pair; the last one
    leaves a pair dark, so its lane stops infeasible at its first trip."""
    rng = np.random.default_rng(seed)
    pairs = prob.dag.undirected_pairs()
    P = prob.dag.cluster.num_pods
    xs = np.zeros((k, P, P), dtype=np.int64)
    for s in range(k):
        for i, j in pairs:
            xs[s, i, j] = xs[s, j, i] = rng.integers(1, 4)
    i, j = pairs[0]
    xs[-1, i, j] = xs[-1, j, i] = 0
    return xs


def counts() -> dict[str, float]:
    return {name: REGISTRY.counter(name).value() for name in (
        "des_event_trips_total", "des_fill_rounds_total",
        "des_graph_captures_total", "des_graph_replays_total",
        "des_graph_idle_trips_total")} | {
        "maxmin": waterfill.maxmin_launches}


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def eager(des, xs: torch.Tensor, traced: bool):
    """The eager loop's (makespan, feasible, start, finish), trips and
    rounds."""
    c0 = counts()
    with obs.enabled(traced):
        out = des._simulate(xs, des._masks(None))
    c = delta(c0, counts())
    obs.TRACER.clear()
    return out, c["des_event_trips_total"], c["des_fill_rounds_total"]


def trip_body(des, xs: torch.Tensor, traced: bool):
    """The factored body run eagerly as `_replay` replays the graph:
    GRAPH_TRIPS trips, then one read of the status, until no lane runs.
    Returns the outcome, the trips in which some lane ran, the rounds and
    the trips taken."""
    csr = _incidence_csr(des.arrays)
    lane_caps, state = des._initial(xs, des._masks(None), False)
    tg = _TripGraph(des.arrays, csr, xs.shape[0], des.max_events, traced)
    tg.load(des.arrays, csr, lane_caps, state)
    for _ in range(math.ceil(des.max_events / GRAPH_TRIPS)):
        tg.run_trips(GRAPH_TRIPS)
        running, trips, rounds, _ = tg.status.tolist()
        if not running:
            break
    assert not running
    return (_outcome(tg.feasible, tg.done, tg.start, tg.finish), trips,
            rounds, int(tg.step))


def assert_same(got, want) -> None:
    for name, g, w in zip(("makespan", "feasible", "start", "finish"), got,
                          want):
        assert g.shape == w.shape and torch.equal(g, w), name


@pytest.fixture(scope="module")
def prob12():
    return problem(12)


@pytest.mark.parametrize("traced", [False, True])
def test_trip_body_matches_eager_loop_at_48_lanes(prob12, traced):
    """48 lanes of one DAG, one of them infeasible from its first trip:
    the body bit for bit the eager loop, with its trips and rounds; every
    batch of GRAPH_TRIPS trips but the last ran some lane."""
    des = TorchDES(prob12, options=DESOptions(device="cpu"))
    xs = topology_from_numpy(topologies(prob12, LANES, 1), des.device)
    want, trips, rounds = eager(des, xs, traced)
    got, got_trips, got_rounds, step = trip_body(des, xs, traced)
    assert_same(got, want)
    assert got_trips == trips > GRAPH_TRIPS
    assert got_rounds == (rounds if traced else 0)
    assert step == GRAPH_TRIPS * math.ceil((trips + 1) / GRAPH_TRIPS)
    feasible = want[1]
    assert not feasible[-1].any() and feasible[:-1].all()


@pytest.mark.parametrize("traced", [False, True])
def test_trip_body_stops_lanes_at_max_events(prob12, traced):
    """`max_events` not a multiple of GRAPH_TRIPS and below the trips some
    lanes need: those lanes end infeasible where the eager loop stops
    them, and the body takes no trip past the cap's batch."""
    full = TorchDES(prob12, options=DESOptions(device="cpu"))
    xs = topology_from_numpy(topologies(prob12, LANES, 2), full.device)
    (_, feas_full, _, _), need, _ = eager(full, xs, False)
    cap = need - 3 if (need - 3) % GRAPH_TRIPS else need - 4
    des = TorchDES(prob12, max_events=cap, options=DESOptions(device="cpu"))
    want, trips, rounds = eager(des, xs, traced)
    got, got_trips, got_rounds, step = trip_body(des, xs, traced)
    assert_same(got, want)
    assert got_trips == trips == cap
    assert got_rounds == (rounds if traced else 0)
    assert step == GRAPH_TRIPS * math.ceil(cap / GRAPH_TRIPS) > cap
    cut = feas_full & ~want[1]
    assert cut.any() and (want[1] | cut | ~feas_full).all()


@pytest.mark.parametrize("traced", [False, True])
def test_trip_body_matches_eager_loop_on_an_ensemble(traced):
    """An ensemble of two members of different sizes (M = 2, 24 genomes,
    48 lanes): the members' lanes end on different trips, and the body
    matches the eager loop lane for lane."""
    probs = [problem(8), problem(12, micro_tokens=8192)]
    des = EnsembleTorchDES(probs, options=DESOptions(device="cpu"))
    assert des.M == 2
    xs = topology_from_numpy(topologies(probs[0], LANES // 2, 3),
                             des.device)
    want, trips, rounds = eager(des, xs, traced)
    got, got_trips, got_rounds, _ = trip_body(des, xs, traced)
    assert_same(got, want)
    assert want[0].shape == (LANES // 2, 2)
    assert got_trips == trips > GRAPH_TRIPS
    assert got_rounds == (rounds if traced else 0)


def test_engines_of_one_bucket_share_their_graph_entry(prob12):
    """The engine cache's entry of a bucket is the one dict of trip graphs
    every engine of the bucket holds; another bucket has its own, and a
    host-driven backend leaves its entry empty."""
    des_cache_clear()
    opts = DESOptions(device="cpu")
    a = TorchDES(prob12, options=opts)
    b = TorchDES(problem(12, d_model=2048), options=opts)
    c = TorchDES(problem(8), options=opts)
    assert a.pad == b.pad and a._graphs is b._graphs
    assert c._graphs is not a._graphs
    a.batch_makespan(topologies(prob12, 4, 4))
    assert a._graphs == {}
    des_cache_clear()


def test_graphs_kept_are_bounded_and_go_with_their_bucket(prob12,
                                                          monkeypatch):
    """At most GRAPHS_KEPT trip graphs stay in the entries, the least
    recently replayed dropped first, whichever bucket holds them; an
    evicted bucket's graphs go with it.  (The graphs here stand in for
    captured ones: what is kept does not depend on what a graph holds.)"""
    des_cache_clear()
    monkeypatch.setattr(des_torch, "GRAPHS_KEPT", 3)
    monkeypatch.setattr(des_torch, "CACHE_SIZE", 2)
    opts = DESOptions(device="cpu")
    a, b = TorchDES(prob12, options=opts), TorchDES(problem(8), options=opts)

    def replay(engine, key):
        engine._graphs.setdefault(key, object())
        _keep_graph(engine._graphs, key)
    for lanes in (1, 2, 3):
        replay(a, (lanes, False))
    replay(b, (1, True))
    assert set(a._graphs) == {(2, False), (3, False)}
    replay(a, (2, False))
    replay(b, (2, True))
    assert set(a._graphs) == {(2, False)}
    assert set(b._graphs) == {(1, True), (2, True)}
    assert len(des_torch._GRAPHS) == 3
    TorchDES(problem(16), options=opts)      # a's bucket is evicted
    assert a._graphs == {} and len(des_torch._GRAPHS) == 2
    des_cache_clear()
    assert b._graphs == {} and not des_torch._GRAPHS


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def traced_kernels(fn, name: str):
    """fn()'s result and the kernels whose name holds `name` in a device
    trace of the call (a replayed graph's kernels each appear).  Short
    spin kernels close the trace: a trace can lose the records of its
    last moments when the profiler stops, and they take that loss."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
        for _ in range(2000):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return out, sum(name in ev.name()
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cap", [None, "cut"])
def test_graph_matches_eager_loop_on_card(cuda, prob12, traced, cap):
    """The replayed graph ('cuda') against the eager loop on the kernel's
    plain version ('ref', the kernel's bits) on the card, bit for bit,
    with its trips and rounds; at the default cap and at one below the
    trips some lanes need.  fill_maxmin's kernels in a device trace of
    each run equal the trips plus the idle trips (both counted on the
    device), as do the host's launches and GRAPH_TRIPS per replay; one
    status read serves GRAPH_TRIPS trips."""
    des_cache_clear()
    xs_np = topologies(prob12, LANES, 5)
    if cap == "cut":
        full = TorchDES(prob12, options=DESOptions(backend="ref"))
        (_, _, _, _), need, _ = eager(
            full, topology_from_numpy(xs_np, cuda), False)
        cap = need - 3 if (need - 3) % GRAPH_TRIPS else need - 4
    graph = TorchDES(prob12, max_events=cap)
    plain = TorchDES(prob12, max_events=cap,
                     options=DESOptions(backend="ref"))
    assert graph.backend == "cuda" and plain.backend == "ref"
    xs = topology_from_numpy(xs_np, cuda)
    want, trips, rounds = eager(plain, xs, traced)
    for run in range(2):            # the capture, then a replay
        c0 = counts()
        with obs.enabled(traced):
            got, kernels = traced_kernels(
                lambda: graph._simulate(xs, graph._masks(None)),
                "fill_maxmin_kernel")
        c = delta(c0, counts())
        obs.TRACER.clear()
        assert_same(got, want)
        assert c["des_event_trips_total"] == trips
        assert c["des_fill_rounds_total"] == (rounds if traced else 0)
        assert c["des_graph_captures_total"] == (run == 0)
        ran = trips + c["des_graph_idle_trips_total"]
        assert kernels == ran
        assert c["maxmin"] == (GRAPH_TRIPS if run == 0 else 0)
        assert c["maxmin"] + GRAPH_TRIPS * c["des_graph_replays_total"] \
            == ran
        assert 0 <= c["des_graph_idle_trips_total"] < GRAPH_TRIPS
        assert c["des_graph_replays_total"] + (run == 0) == math.ceil(
            (trips + c["des_graph_idle_trips_total"]) / GRAPH_TRIPS)
    body, body_trips, body_rounds, _ = trip_body(graph, xs, traced)
    assert_same(body, want)
    assert (body_trips, body_rounds) == (trips, rounds if traced else 0)
    des_cache_clear()


@pytest.mark.cuda
def test_second_engine_of_a_bucket_replays_the_graph_on_its_arrays(
        cuda, prob12):
    """Another problem in the same bucket (other volumes, same padded
    shapes) reuses the first engine's graph without a capture, and gets
    its own results, not the first engine's."""
    des_cache_clear()
    other = problem(12, d_model=2048)
    first, second = TorchDES(prob12), TorchDES(other)
    assert first._graphs is second._graphs
    xs = topologies(prob12, LANES, 6)
    ms1, _ = first.batch_makespan(xs)
    c0 = counts()
    ms2, feas2 = second.batch_makespan(xs)
    torch.cuda.synchronize()
    c = delta(c0, counts())
    assert c["des_graph_captures_total"] == 0
    assert c["des_graph_replays_total"] > 0
    want, want_feas = TorchDES(other, options=DESOptions(
        backend="ref")).batch_makespan(xs)
    np.testing.assert_array_equal(ms2, want)
    np.testing.assert_array_equal(feas2, want_feas)
    assert not np.array_equal(ms1, ms2)
    des_cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda-round", "segment"])
def test_host_driven_backends_capture_nothing(cuda, prob12, backend):
    des_cache_clear()
    des = TorchDES(prob12, options=DESOptions(backend=backend))
    c0 = counts()
    des.batch_makespan(topologies(prob12, 4, 7))
    c = delta(c0, counts())
    assert c["des_graph_captures_total"] == c["des_graph_replays_total"] \
        == c["des_graph_idle_trips_total"] == 0
    assert c["des_event_trips_total"] > 0 and des._graphs == {}
    des_cache_clear()


@pytest.mark.cuda
def test_graphs_beyond_the_bound_are_captured_again(cuda, prob12,
                                                    monkeypatch):
    """With room for one graph, simulating at a second lane count drops
    the first lane count's graph, which the next simulation at that lane
    count captures again, with the same results."""
    des_cache_clear()
    monkeypatch.setattr(des_torch, "GRAPHS_KEPT", 1)
    des = TorchDES(prob12)
    xs = topologies(prob12, 8, 8)
    c0 = counts()
    first, _ = des.batch_makespan(xs)
    des.batch_makespan(xs[:4])
    assert set(des._graphs) == {(4, False)}
    again, _ = des.batch_makespan(xs)
    c = delta(c0, counts())
    assert c["des_graph_captures_total"] == 3
    assert set(des._graphs) == {(8, False)}
    np.testing.assert_array_equal(first, again)
    des_cache_clear()
