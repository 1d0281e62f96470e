"""The port's DELTA-Planes on the CPU against the JAX reference: k-plane
decomposition, the plane-state lanes of the ensemble engine, staggered
SLO-guarded rewires, plane-event serde, the fault injector, the fleet
loop's transition plumbing and bit-identical journal replay (every case
of tests/test_planes.py, each run in both packages).

Tolerances: budgets, splits, lane stacks, plane books, fault traces and
decision histories exact; `delta_planes` the reference's split from the
same seed, its exact makespans equal (the numpy DES on equal
topologies); the float32 plane-state lanes of `EnsembleTorchDES` within
rel 5e-5 of the numpy DES."""
from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import one_circuit_topology
from repro_torch.core.ga import PlanesFitness, TopologySpace
from test_torch_fleet import (CPU, GA_KW, PORT, REF, both, history_json,
                              make_planner, one_torch_thread)  # noqa: F401


def _dag(pkg, mb=2):
    return pkg.schedule.build_comm_dag(pkg.job(mb), 400.0)


def _job(pkg, name="j", mb=4, **kw):
    return pkg.job(mb, name=name, **kw)


# -------------------------------------------------------- budget splitting
def test_split_port_budgets_balanced_and_deterministic():
    def run(pkg):
        split = pkg.cluster.split_port_budgets
        budgets = split((10, 7, 4), 3)
        assert np.asarray(budgets).sum(axis=0).tolist() == [10, 7, 4]
        assert budgets == ((4, 3, 2), (3, 2, 1), (3, 2, 1))
        assert split((10, 7, 4), 3) == budgets
        cluster = pkg.cluster.ClusterSpec.uniform(
            num_pods=3, ports_per_pod=8, nic_bandwidth=50e9)
        limits = cluster.plane_port_limits(4)
        assert np.asarray(limits).sum(axis=0).tolist() == [8, 8, 8]
        return budgets, limits
    ref, port = both(run)
    assert port == ref


def test_split_across_planes_sums_budgets_and_balance():
    x = np.zeros((3, 3), dtype=np.int64)
    x[0, 1] = x[1, 0] = 7
    x[1, 2] = x[2, 1] = 3

    def run(pkg):
        budgets = np.asarray(pkg.cluster.split_port_budgets((16,) * 3, 4))
        planes = pkg.ga.split_across_planes(x, budgets)
        assert planes.shape == (4, 3, 3)
        assert np.array_equal(planes.sum(axis=0), x)
        for p in range(4):
            assert np.array_equal(planes[p], planes[p].T)
            usage = np.triu(planes[p], k=1).sum(axis=0) \
                + np.triu(planes[p], k=1).sum(axis=1)
            assert (usage <= budgets[p]).all()
            assert planes[p][0, 1] <= -(-7 // 4)
            assert planes[p][1, 2] <= -(-3 // 4)
        return planes
    ref, port = both(run)
    np.testing.assert_array_equal(port, ref)


def test_split_across_planes_integral_infeasibility():
    x = np.zeros((3, 3), dtype=np.int64)
    x[0, 1] = x[1, 0] = 9
    x[0, 2] = x[2, 0] = 5
    x[1, 2] = x[2, 1] = 2

    def run(pkg):
        budgets = np.asarray(pkg.cluster.split_port_budgets((16, 11, 7), 4))
        with pytest.raises(ValueError):
            pkg.ga.split_across_planes(x, budgets)
        assert pkg.fleet.split_plan(x, budgets) is None
        wide = np.asarray(pkg.cluster.split_port_budgets((64, 64, 64), 4))
        planes = pkg.fleet.split_plan(x, wide)
        assert planes is not None and np.array_equal(planes.sum(axis=0), x)
        return planes
    ref, port = both(run)
    np.testing.assert_array_equal(port, ref)


# ------------------------------------------------------- state conventions
def test_plane_state_genomes_trickle_and_blackout():
    lanes = np.array([[2.0, 0.0, 1.0],
                      [2.0, 0.0, 0.0],
                      [0.0, 0.0, 0.0]])

    def run(pkg):
        states = pkg.engine.plane_state_genomes(lanes)
        assert states.shape == (4, 3)
        total = states[0]
        assert total.tolist() == [4.0, 0.0, 1.0]
        assert np.array_equal(states[3], total)
        assert states[1].tolist() == [2.0, 0.0, 1.0 / 3.0]
        assert all(s[1] == 0.0 for s in states)
        with pytest.raises(ValueError):
            pkg.engine.plane_state_genomes(np.ones(3))
        return states
    ref, port = both(run)
    np.testing.assert_array_equal(port, ref)
    # batched leading axes expand the same way
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 4, size=(5, 3, 6)).astype(float)
    np.testing.assert_array_equal(PORT.engine.plane_state_genomes(batch),
                                  REF.engine.plane_state_genomes(batch))


def test_effective_topology_matches_state_conventions():
    planes = np.zeros((3, 2, 2), dtype=np.int64)
    planes[0, 0, 1] = planes[0, 1, 0] = 3
    planes[1, 0, 1] = planes[1, 1, 0] = 1
    x = planes.sum(axis=0)

    def run(pkg):
        eff = pkg.fleet.effective_topology
        assert np.array_equal(eff(planes, set()), x)
        assert eff(planes, {0})[0, 1] == 1.0
        assert eff(planes, {0, 1})[0, 1] == pytest.approx(4.0 / 3.0)
        assert (eff(planes, {0, 1, 2}) == 0).all()
        return [eff(planes, d) for d in (set(), {0}, {0, 1}, {0, 1, 2})]
    ref, port = both(run)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_plane_state_lanes_match_numpy_des():
    """The spare-plane fitness scores every genome on all k+1 fabric
    states in one call of `EnsembleTorchDES` (one lane per state x
    member); each lane is within rel 5e-5 of the numpy DES on the
    state's float topology."""
    dag = _dag(PORT)
    ens = PORT.dag.DagEnsemble.singleton(dag)
    space = TopologySpace.for_ensemble(ens, port_limits=np.full(4, 8),
                                       min_circuits=0)
    base = np.stack([space.genome_of(one_circuit_topology(dag))] * 3)
    fit = PlanesFitness(ens, base, space, PORT.ga.GAOptions(
        **GA_KW, des_options=CPU), np.ones(1))
    genomes = np.random.default_rng(1).integers(0, 3, size=(6, space.E))
    got = fit.state_makespans(genomes)
    assert got.shape == (6, 5, 1) and fit.batch_calls == 1
    for g, row in zip(genomes, got):
        np.testing.assert_allclose(row, fit.exact_state_makespans(g),
                                   rtol=5e-5)


# ------------------------------------------------------------ delta_planes
def test_delta_planes_decomposition_and_dark_certification():
    """The reference case, and the port's result is the reference's from
    the same seed: the same planes, lanes, budgets and exact makespans."""
    def run(pkg):
        dag = _dag(pkg)
        ens = pkg.dag.DagEnsemble.singleton(dag)
        kw = dict(pop_size=10, max_generations=8, patience=4,
                  time_limit=1e9, seed=0)
        opts = pkg.ga.GAOptions(**kw, des_options=CPU) if pkg is PORT \
            else pkg.ga.GAOptions(**kw)
        res = pkg.ga.delta_planes(ens, opts, num_planes=4)
        assert res.num_planes == 4
        assert np.array_equal(res.planes.sum(axis=0), res.x)
        budgets = np.asarray(res.plane_port_limits, dtype=np.int64)
        for p in range(4):
            usage = np.triu(res.planes[p], k=1).sum(axis=0) \
                + np.triu(res.planes[p], k=1).sum(axis=1)
            assert (usage <= budgets[p]).all()
        assert np.isfinite(res.dark_makespans).all()
        assert res.feasible and res.worst_dark_regret >= 1.0
        assert np.isfinite(res.objective_value)
        eu = np.asarray([e[0] for e in res.edges])
        ev = np.asarray([e[1] for e in res.edges])
        for p in range(4):
            assert np.array_equal(res.planes[p][eu, ev],
                                  res.lane_genomes[p])
        prob = pkg.des.DESProblem(dag)
        for p in range(4):
            eff = pkg.fleet.effective_topology(res.planes, {p})
            assert pkg.des.simulate(prob, eff).makespan \
                == res.dark_makespans[p, 0]
        return res
    ref, port = both(run)
    np.testing.assert_array_equal(port.planes, ref.planes)
    np.testing.assert_array_equal(port.lane_genomes, ref.lane_genomes)
    assert port.edges == ref.edges
    assert port.plane_port_limits == ref.plane_port_limits
    np.testing.assert_array_equal(port.makespans, ref.makespans)
    np.testing.assert_array_equal(port.dark_makespans, ref.dark_makespans)
    np.testing.assert_array_equal(port.refs, ref.refs)
    assert port.objective_value == ref.objective_value
    assert (port.generations, port.evaluations) \
        == (ref.generations, ref.evaluations)
    with pytest.raises(ValueError, match="num_planes"):
        PORT.ga.delta_planes(PORT.dag.DagEnsemble.singleton(_dag(PORT)),
                             num_planes=1)


# ----------------------------------------------------- staggered scheduler
def _lane_fixture(pkg, shrink_pairs=2):
    dag = _dag(pkg)
    P = dag.cluster.num_pods
    x_a = one_circuit_topology(dag) * 4
    x_b = x_a.copy()
    for i, j in dag.undirected_pairs()[:shrink_pairs]:
        x_b[i, j] = x_b[j, i] = x_a[i, j] - 2
    budgets = np.asarray(pkg.cluster.split_port_budgets((64,) * P, 4))
    lane = pkg.fleet.TenantLane(
        name="a", dag=dag, pods=tuple(range(P)),
        planes_a=pkg.fleet.split_plan(x_a, budgets),
        planes_b=pkg.fleet.split_plan(x_b, budgets))
    return dag, lane, x_a, x_b


def _steps(pkg, steps):
    return [pkg.events.serialize_event(s) for s in steps]


def test_transition_commits_and_certifies_each_step():
    def run(pkg):
        dag, lane, x_a, x_b = _lane_fixture(pkg)
        health = pkg.fleet.FabricHealth(dag.cluster.num_pods, 4)
        tr = pkg.fleet.StaggeredTransition([lane], health, slo=3.0,
                                           transition_id="tx")
        res = tr.run()
        assert res.committed and res.status == "committed"
        assert np.array_equal(tr.mixed_planes(lane), lane.planes_b)
        assert np.array_equal(tr.mixed_planes(lane).sum(axis=0), x_b)
        prob = pkg.des.DESProblem(dag)
        done: list[int] = []
        for s in res.steps:
            assert s.direction == "forward" and s.transition == "tx"
            mixed = lane.planes_a.copy()
            for p in done:
                mixed[p] = lane.planes_b[p]
            eff = pkg.fleet.effective_topology
            ref_ms = pkg.des.simulate(prob, eff(mixed, set())).makespan
            ms = pkg.des.simulate(prob, eff(mixed, {s.plane})).makespan
            assert s.peak_inflation == max(ms / ref_ms, 1.0)
            assert s.changed_circuits > 0 and s.delay_s > 0
            done.append(s.plane)
        assert res.summary.outcome == "committed"
        assert res.summary.peak_inflation == max(
            s.peak_inflation for s in res.steps)
        return _steps(pkg, res.steps), res.record()
    ref, port = both(run)
    assert port == ref


def test_transition_slo_breach_rolls_back_to_plan_a():
    def run(pkg):
        dag, lane, x_a, _ = _lane_fixture(pkg)
        health = pkg.fleet.FabricHealth(dag.cluster.num_pods, 4)
        tr = pkg.fleet.StaggeredTransition([lane], health, slo=0.5,
                                           transition_id="tr")
        res = tr.run()
        assert res.status == "rolled_back" and not res.committed
        assert np.array_equal(tr.mixed_planes(lane), lane.planes_a)
        assert np.array_equal(tr.mixed_planes(lane).sum(axis=0), x_a)
        assert all(s.direction == "rollback" for s in res.steps
                   if s.seq >= len(res.steps) - len(tr.done))
        return _steps(pkg, res.steps), res.record()
    ref, port = both(run)
    assert port == ref


def test_transition_reprices_against_midstream_plane_failure():
    def run(pkg):
        dag, lane, x_a, x_b = _lane_fixture(pkg)
        health = pkg.fleet.FabricHealth(dag.cluster.num_pods, 4)
        tr = pkg.fleet.StaggeredTransition([lane], health, slo=5.0)
        first = tr.step()
        assert first is not None
        health.fail_plane(tr.pending[0])
        status = "committed"
        while tr.pending:
            if tr.step() is None:
                tr.rollback()
                status = "rolled_back"
                break
        final = tr.mixed_planes(lane)
        target = lane.planes_b if status == "committed" else lane.planes_a
        assert np.array_equal(final, target)
        assert all(np.isfinite(s.peak_inflation) for s in tr.steps)
        return status, _steps(pkg, tr.steps)
    ref, port = both(run)
    assert port == ref


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_random_transitions_one_plane_dark_invariant(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        dag = _dag(pkg)
        P = dag.cluster.num_pods
        k = 3
        budgets = np.asarray(pkg.cluster.split_port_budgets((64,) * P, k))
        base = one_circuit_topology(dag)

        def rand_x():
            x = np.zeros_like(base)
            for i, j in dag.undirected_pairs():
                c = int(rng.integers(1, 5))
                x[i, j] = x[j, i] = c
            return x

        x_a, x_b = rand_x(), rand_x()
        lane = pkg.fleet.TenantLane(
            name="t", dag=dag, pods=tuple(range(P)),
            planes_a=pkg.fleet.split_plan(x_a, budgets),
            planes_b=pkg.fleet.split_plan(x_b, budgets))
        health = pkg.fleet.FabricHealth(P, k)
        tr = pkg.fleet.StaggeredTransition([lane], health,
                                           slo=float("inf"))
        res = tr.run()
        assert res.committed
        done: list[int] = []
        for s in res.steps:
            mixed = lane.planes_a.copy()
            for p in done:
                mixed[p] = lane.planes_b[p]
            eff = pkg.fleet.effective_topology(mixed, {s.plane})
            x_mid = mixed.sum(axis=0)
            carried = x_mid > 0
            assert (eff[carried] > 0).all()
            share = mixed[s.plane]
            assert (eff[carried] >= np.minimum(
                x_mid - share, x_mid / k)[carried] - 1e-12).all()
            done.append(s.plane)
        assert np.array_equal(tr.mixed_planes(lane), lane.planes_b)
        assert sorted(done) == sorted({s.plane for s in res.steps})
        return _steps(pkg, res.steps)
    ref, port = both(run)
    assert port == ref


# ------------------------------------------------- fault injector (S1)
def test_plane_failure_draws_are_collision_free():
    def run(pkg):
        inj = pkg.fleet.FaultInjector(num_pods=4, num_planes=2, seed=11,
                                      link_rate=0.05, port_rate=0.05,
                                      plane_rate=0.9, flap_rate=0.3)
        traces = []
        for _ in range(3):
            dark: set[int] = set()
            saw_fallback = False
            trace = inj.trace(40)
            for ev in trace:
                if ev["kind"] == "plane_failure":
                    assert ev["plane"] not in dark
                    dark.add(ev["plane"])
                elif ev["kind"] == "plane_recovery":
                    dark.discard(ev["plane"])
                elif len(dark) >= 2:
                    saw_fallback = True
            assert saw_fallback
            traces.append(trace)
        return traces
    ref, port = both(run)
    assert port == ref


# --------------------------------------------- health round-trip (S2)
@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_health_snapshot_roundtrip_under_plane_churn(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        h = pkg.fleet.FabricHealth(num_pods=5, num_planes=4)
        for _ in range(15):
            op = int(rng.integers(4))
            if op == 0:
                h.fail_plane(int(rng.integers(4)))
            elif op == 1:
                h.recover_plane(int(rng.integers(4)))
            else:
                i = int(rng.integers(5))
                j = (i + 1 + int(rng.integers(4))) % 5
                if op == 2:
                    h.fail_link((i, j), float(rng.uniform(0.1, 0.8)))
                else:
                    h.recover_link((i, j))
            snap = json.loads(json.dumps(h.snapshot()))
            h2 = pkg.fleet.FabricHealth.from_snapshot(snap)
            assert h2.availability() == h.availability()
            assert np.array_equal(h2.link_frac, h.link_frac)
            assert h2.dark_planes == h.dark_planes
            assert h2.plane_factor == h.plane_factor
        return h.snapshot(), h.mask().tolist()
    ref, port = both(run)
    assert port == ref


def test_plane_event_serde_roundtrip_and_backcompat():
    def run(pkg):
        step = pkg.fleet.PlaneRewireStep(
            transition="t3", plane=2, seq=5, direction="rollback",
            peak_inflation=1.25, delay_s=0.04, changed_circuits=4,
            tenants=("a", "b"))
        summ = pkg.fleet.PlaneTransitionSummary(
            transition="t3", outcome="rolled_back", steps=6,
            peak_inflation=1.25, total_delay_s=0.2, tenants=("a",),
            planes=(0, 1, 2))
        out = []
        for ev in (step, summ):
            data = json.loads(json.dumps(pkg.fleet.serialize_event(ev)))
            assert data["v"] == 3
            assert pkg.fleet.rebuild_event(data) == ev
            out.append(data)
        old = {"kind": "plane_rewire", "transition": "t0", "plane": 1,
               "seq": 0}
        back = pkg.fleet.rebuild_event(old)
        assert back.direction == "forward" and back.peak_inflation == 1.0
        assert pkg.fleet.rebuild_event(
            {"kind": "plane_transition", "transition": "t0",
             "outcome": "committed"}).planes == ()
        return out
    ref, port = both(run)
    assert port == ref


def test_plane_book_snapshot_roundtrip():
    def run(pkg):
        book = pkg.fleet.PlaneBook(3)
        planes = np.arange(12, dtype=np.int64).reshape(3, 2, 2)
        book.assign("a", planes)
        snap = json.loads(json.dumps(book.snapshot()))
        book2 = pkg.fleet.PlaneBook.from_snapshot(snap)
        assert book2.num_planes == 3
        assert np.array_equal(book2.get("a"), planes)
        assert np.array_equal(book2.total("a"), planes.sum(axis=0))
        with pytest.raises(ValueError):
            book.assign("bad", np.zeros((2, 2, 2)))
        return snap
    ref, port = both(run)
    assert port == ref


# -------------------------------------------------------------- timeline
def test_plane_rewire_timeline_is_valid_trace():
    def run(pkg):
        dag, lane, _, _ = _lane_fixture(pkg)
        health = pkg.fleet.FabricHealth(dag.cluster.num_pods, 4)
        res = pkg.fleet.StaggeredTransition([lane], health, slo=3.0).run()
        trace = pkg.obs.plane_rewire_timeline(res.steps, res.summary)
        assert pkg.obs.validate_trace(trace) == []
        assert trace["otherData"]["outcome"] == "committed"
        xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        assert len(xs) == len(res.steps)
        assert any(e["ph"] == "C" for e in trace["traceEvents"])
        with pytest.raises(ValueError):
            pkg.obs.plane_rewire_timeline([])
        return json.dumps(trace, sort_keys=True)
    ref, port = both(run)
    assert port == ref


# ------------------------------------------------------ fleet integration
def test_fleet_traffic_change_staggers_and_replays_bit_identical():
    def run(pkg):
        journal = pkg.obs.FleetJournal()
        pl = make_planner(pkg, journal=journal, cache=pkg.fleet.PlanCache())
        pl.handle(pkg.fleet.JobArrival(name="a", job=_job(pkg)))
        assert np.array_equal(pl.planes.total("a"), pl.tenants["a"].plan.x)
        rec = pl.handle(pkg.fleet.TrafficChange(
            name="a", job=_job(pkg, mb=8, micro_tokens=8192)))
        tr = rec.get("transition")
        assert tr is not None and tr["status"] == "committed"
        assert tr["reason"] == "traffic_change" and tr["steps"] > 0
        assert np.array_equal(pl.planes.total("a"), pl.tenants["a"].plan.x)
        plane_records = [e for e in journal.entries
                         if e.get("kind") == "plane_event"]
        assert plane_records
        assert {e["event"]["kind"] for e in plane_records} \
            == {"plane_rewire", "plane_transition"}
        assert all(e["event"]["v"] == 3 for e in plane_records)
        pl2 = pkg.fleet.FleetPlanner.recover(
            journal.entries, pl.fleet, ga_options=pkg.GA, seed=0,
            cache=pkg.fleet.PlanCache())
        dflt = pkg.journal._json_default
        assert pl2.planes.snapshot() == pl.planes.snapshot()
        assert json.dumps(pl2.transitions, default=dflt) \
            == json.dumps(pl.transitions, default=dflt)
        assert history_json(pkg, pl2) == history_json(pkg, pl)
        return pl, json.dumps(pl.transitions, default=dflt)
    (rp, rt), (pp, pt) = both(run)
    assert pp.planes.snapshot() == rp.planes.snapshot()
    assert pt == rt
    assert history_json(PORT, pp) == history_json(REF, rp)


def test_fleet_slo_breach_reverts_to_old_topology():
    def run(pkg):
        pl = make_planner(pkg, plane_slo=0.5, cache=pkg.fleet.PlanCache())
        pl.handle(pkg.fleet.JobArrival(name="a", job=_job(pkg)))
        x_before = pl.tenants["a"].plan.x.copy()
        rec = pl.handle(pkg.fleet.TrafficChange(
            name="a", job=_job(pkg, mb=8, micro_tokens=8192)))
        tr = rec.get("transition")
        assert tr is not None and tr["status"] == "rolled_back"
        assert np.array_equal(pl.tenants["a"].plan.x, x_before)
        prob = pkg.des.DESProblem(pl.tenants["a"].dag)
        assert pl.tenants["a"].plan.makespan \
            == pkg.des.simulate(prob, x_before).makespan
        pl.ledger.check()
        assert pl.report()["planes"]["rolled_back"] >= 1
        return pl
    ref, port = both(run)
    assert history_json(PORT, port) == history_json(REF, ref)
    assert port.report()["planes"] == ref.report()["planes"]


def test_fleet_snapshot_restore_carries_plane_book():
    def run(pkg):
        pl = make_planner(pkg, cache=pkg.fleet.PlanCache())
        pl.handle(pkg.fleet.JobArrival(name="a", job=_job(pkg)))
        snap = pl.snapshot()
        assert "planes" in snap \
            and snap["transition_seq"] == pl._transition_seq
        kw = dict(ga_options=pkg.GA, seed=0)
        pl2 = pkg.fleet.FleetPlanner.restore(snap, pl.fleet,
                                             cache=pkg.fleet.PlanCache(),
                                             **kw)
        assert pl2.planes.snapshot() == pl.planes.snapshot()
        assert pl2._transition_seq == pl._transition_seq
        legacy = {k: v for k, v in snap.items()
                  if k not in ("planes", "transition_seq", "transitions")}
        pl3 = pkg.fleet.FleetPlanner.restore(legacy, pl.fleet,
                                             cache=pkg.fleet.PlanCache(),
                                             **kw)
        assert pl3.planes.snapshot()["lanes"] == {}
        pl3.handle(pkg.fleet.PlaneFailure(plane=2))
        assert np.array_equal(pl3.planes.total("a"),
                              pl3.tenants["a"].plan.x)
        return json.dumps(snap, default=pkg.journal._json_default), pl3
    (rs, r3), (ps, p3) = both(run)
    assert ps == rs
    assert history_json(PORT, p3) == history_json(REF, r3)
    assert p3.planes.snapshot() == r3.planes.snapshot()
