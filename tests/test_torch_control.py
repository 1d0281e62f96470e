"""The port's control plane and `plan()` facade shims on the CPU against
the JAX reference: estimators, telemetry synthesis, break-even steering,
hysteresis, journal replay identity, the realloc break-even gate and the
deprecated facades bit-identical to `plan` (every case of
tests/test_control.py, each run in both packages).

Tolerances: decisions, topologies and replayed histories exact; the
priced costs and makespans from the exact numpy DES on equal topologies
exact; estimator outputs exact (the same float64 code)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from test_torch_fleet import (CPU, PORT, REF, both, history_json,
                              one_torch_thread)  # noqa: F401


def phase_job(pkg, mb: int, d_model: int, params: float):
    return pkg.traffic.JobSpec(
        name="t", tp=2, pp=4, dp=2, num_microbatches=mb, micro_tokens=4096,
        d_model=d_model, stage_params=(params,) * 4,
        gpus_per_pod_per_replica=4)


def job_a(pkg):
    return phase_job(pkg, 8, 4096, 0.2e9)     # PP-heavy phase


def job_b(pkg):
    return phase_job(pkg, 2, 1024, 3e9)       # DP-heavy phase


def make_planner(pkg, **kw):
    kw.setdefault("reconfig_s_per_circuit", 0.05)
    return pkg.fleet.FleetPlanner(
        pkg.fleet.FleetSpec(num_pods=4, ports_per_pod=8, nic_gbps=100.0),
        ga_options=pkg.GA, seed=0, **kw)


def drive(pkg, cp, dag, x, *, phase, t0, iterations, **kw):
    for ev in pkg.fleet.synthesize_telemetry(
            dag, x, tenant="t", phase=phase, t0=t0, iterations=iterations,
            **kw):
        cp.observe(ev)


def _tiny(pkg):
    return pkg.schedule.build_comm_dag(pkg.job(2), 400.0)


def _session(pkg, *, cfg, reconfig=None, phase_b_t0=300.0, **drive_kw):
    """Admit on phase A, drive phase-A then phase-B telemetry through a
    controller: (planner, controller, x0, base x)."""
    kw = {} if reconfig is None else {"reconfig_s_per_circuit": reconfig}
    planner = make_planner(pkg, journal=pkg.obs.FleetJournal(), **kw)
    planner.handle(pkg.fleet.JobArrival(name="t", job=job_a(pkg)))
    x0 = planner.tenants["t"].plan.x.copy()
    base_x = planner.tenants["t"].base_plan.x.copy()
    dag_a = pkg.schedule.build_comm_dag(job_a(pkg), 100.0)
    dag_b = pkg.schedule.build_comm_dag(job_b(pkg), 100.0)
    cp = pkg.fleet.ControlPlane(
        planner, cfg, phase_book={"t": {"A": job_a(pkg), "B": job_b(pkg)}})
    drive(pkg, cp, dag_a, x0, phase="A", t0=0.0, iterations=10)
    drive(pkg, cp, dag_b, x0, phase="B", t0=phase_b_t0, iterations=40,
          **drive_kw)
    return planner, cp, x0, base_x


def _decisions(cp) -> str:
    return json.dumps(cp.decisions, default=str, sort_keys=True)


# ------------------------------------------------------------- estimators
def test_dwell_estimator_convergence():
    def run(pkg):
        est = pkg.telemetry.DwellEstimator(prior_s=600.0, alpha=0.3)
        assert est.estimate() == 600.0
        t = 0.0
        for i in range(40):
            est.observe_transition(t, "A" if i % 2 == 0 else "B")
            t += 50.0
        assert est.estimate() == pytest.approx(50.0)
        assert est.count == 39
        last = t - 50.0
        assert est.expected_remaining(last + 500.0) == pytest.approx(500.0)
        assert est.expected_remaining(last + 1.0) == pytest.approx(50.0)
        return est.estimate(), est.expected_remaining(last + 7.0)
    ref, port = both(run)
    assert port == ref


def test_dwell_estimator_first_observation_replaces_prior():
    def run(pkg):
        est = pkg.telemetry.DwellEstimator(prior_s=600.0, alpha=0.3)
        est.observe_transition(0.0, "A")
        est.observe_transition(30.0, "B")
        assert est.estimate() == pytest.approx(30.0)
        assert est.observe_transition(40.0, "B") is None
        assert est.count == 1
        return est.estimate()
    ref, port = both(run)
    assert port == ref


def test_traffic_drift_bounds():
    a = np.array([[0.0, 2.0], [0.0, 0.0]])
    b = np.array([[0.0, 0.0], [3.0, 0.0]])

    def run(pkg):
        drift = pkg.fleet.traffic_drift
        assert drift(a, a) == 0.0
        assert drift(a, 10 * a) == 0.0
        assert drift(a, b) == pytest.approx(1.0)
        assert drift(np.zeros((2, 2)), a) == 0.0
        return drift(a, b), drift(a, a + b)
    ref, port = both(run)
    assert port == ref


def test_drift_estimator_integrates_windows():
    planned = np.array([[0.0, 1.0], [0.0, 0.0]])

    def run(pkg):
        est = pkg.telemetry.DriftEstimator(tau_s=10.0)
        assert est.drift(planned) == 0.0
        for _ in range(20):
            est.observe(planned, dt=1.0)
        assert est.drift(planned) == pytest.approx(0.0)
        est.observe(np.array([[0.0, 0.0], [1.0, 0.0]]), dt=0.1)
        assert est.drift(planned) < 0.05
        return est.drift(planned)
    ref, port = both(run)
    assert port == ref


def test_drift_estimator_shape_converges_to_volume():
    vol = np.array([[0.0, 3.0], [1.0, 0.0]])
    w1 = np.array([[0.0, 6.0], [0.0, 0.0]])
    w2 = np.array([[0.0, 0.0], [2.0, 0.0]])

    def run(pkg):
        est = pkg.telemetry.DriftEstimator(tau_s=50.0)
        for _ in range(40):
            est.observe(w1, dt=0.5)
            est.observe(w2, dt=0.5)
        assert est.drift(vol) < 0.02
        assert pkg.fleet.traffic_drift(w1, vol) == pytest.approx(0.25)
        return est.drift(vol)
    ref, port = both(run)
    assert port == ref


# ----------------------------------------------------- telemetry synthesis
def test_synthesized_telemetry_conserves_volume():
    def run(pkg):
        dag = _tiny(pkg)
        P = dag.cluster.num_pods
        x = np.full((P, P), 2)
        np.fill_diagonal(x, 0)
        events = pkg.fleet.synthesize_telemetry(dag, x, tenant="t",
                                                phase="A", iterations=2)
        assert isinstance(events[0], pkg.fleet.PhaseTransition)
        samples = [e for e in events
                   if isinstance(e, pkg.fleet.TelemetrySample)]
        n = len(samples) // 2
        moved = sum(np.asarray(s.rates) * s.dt for s in samples[:n])
        vol = dag.traffic_matrix()
        np.testing.assert_allclose(moved, vol, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(samples[0].queues), vol)
        totals = [float(np.asarray(s.queues).sum()) for s in samples[:n]]
        assert all(a >= b - 1e-9 for a, b in zip(totals, totals[1:]))
        np.testing.assert_allclose(np.asarray(samples[n].queues), vol)
        return [pkg.events.serialize_event(e) for e in events]
    ref, port = both(run)
    assert port == ref


def test_synthesized_telemetry_rejects_infeasible():
    for pkg in (REF, PORT):
        dag = _tiny(pkg)
        P = dag.cluster.num_pods
        with pytest.raises(ValueError):
            pkg.fleet.synthesize_telemetry(dag, np.zeros((P, P)),
                                           tenant="t")


def test_telemetry_events_round_trip_json():
    def run(pkg):
        s = pkg.fleet.TelemetrySample(
            t=1.5, tenant="t", dt=0.25, rates=((0.0, 2.5), (1.0, 0.0)),
            queues=((0.0, 9.0), (3.0, 0.0)), phase="A")
        p = pkg.fleet.PhaseTransition(t=2.0, tenant="t", phase="B")
        out = []
        for ev in (s, p):
            data = json.loads(json.dumps(pkg.events.serialize_event(ev)))
            assert data["v"] == 3
            assert pkg.events.rebuild_event(data) == ev
            assert pkg.events.rebuild_event({**data, "v": 2}) == ev
            out.append(data)
        return out
    ref, port = both(run)
    assert port == ref


# --------------------------------------------------------------- steering
CFG = dict(cadence_s=1.0, confirm_ticks=2, cooldown_s=0.0,
           drift_threshold=0.05)


@pytest.fixture(scope="module")
def steered_sessions():
    """The reference test's monitored session in both packages."""
    def run(pkg):
        cfg = pkg.fleet.ControllerConfig(**CFG)
        planner, cp, _, base_x = _session(pkg, cfg=cfg)
        return planner, cp, base_x, cfg
    return both(run)


def test_steered_change_clears_break_even(steered_sessions):
    for pkg, (planner, cp, base_x, _) in zip((REF, PORT), steered_sessions):
        applied = [d for d in cp.decisions if "decision" in d]
        assert applied, "controller never steered"
        decision = applied[0]["decision"]
        assert decision["option"] == "replan"
        assert decision["dwell_s"] == pytest.approx(300.0)
        assert decision["cost_replan_s"] < decision["cost_keep_s"]
        prob = pkg.des.DESProblem(planner.tenants["t"].dag)
        ms_keep = pkg.des.simulate(
            prob, np.asarray(base_x, dtype=np.float64)).makespan
        assert decision["ms_keep"] == pytest.approx(ms_keep)
        inflation = max(ms_keep / decision["ms_replan"] - 1.0, 0.0)
        assert decision["inflation"] == pytest.approx(inflation)
        assert decision["cost_keep_s"] == pytest.approx(
            decision["dwell_s"] * inflation)
        delay = decision["changed_circuits"] * planner.reconfig_s_per_circuit
        assert decision["delay_s"] == pytest.approx(delay)
        assert decision["dwell_s"] * inflation > delay
    (_, ref_cp, _, _), (_, port_cp, _, _) = steered_sessions
    assert _decisions(port_cp) == _decisions(ref_cp)


def test_steered_dwell_estimate_reaches_planner(steered_sessions):
    for pkg, (planner, cp, _, _) in zip((REF, PORT), steered_sessions):
        assert planner.dwell_for("t") == pytest.approx(300.0)
        assert planner.dwell_for("ghost") == pkg.telemetry.DEFAULT_DWELL_S
        rep = cp.report()
        assert rep["tenants"]["t"]["planned_phase"] == "B"
        assert rep["actions"].get("replan", 0) >= 1
    (ref_pl, ref_cp, _, _), (port_pl, port_cp, _, _) = steered_sessions
    assert json.dumps(port_cp.report(), sort_keys=True, default=str) \
        == json.dumps(ref_cp.report(), sort_keys=True, default=str)
    assert history_json(PORT, port_pl) == history_json(REF, ref_pl)


def test_keep_wins_when_dwell_cannot_amortize():
    def run(pkg):
        cfg = pkg.fleet.ControllerConfig(**CFG)
        planner, cp, _, base_x = _session(pkg, cfg=cfg, reconfig=1e4,
                                          phase_b_t0=60.0)
        applied = [d for d in cp.decisions if "decision" in d]
        assert applied and applied[0]["decision"]["option"] == "keep"
        assert np.array_equal(planner.tenants["t"].base_plan.x, base_x)
        assert applied[0]["decision"]["cost_keep_s"] <= \
            applied[0]["decision"]["cost_replan_s"]
        return _decisions(cp), planner
    (ref_d, ref_pl), (port_d, port_pl) = both(run)
    assert port_d == ref_d
    assert history_json(PORT, port_pl) == history_json(REF, ref_pl)


def test_hysteresis_short_flap_never_reaches_planner():
    def run(pkg):
        planner = make_planner(pkg)
        planner.handle(pkg.fleet.JobArrival(name="t", job=job_a(pkg)))
        x0 = planner.tenants["t"].plan.x.copy()
        dag_a = pkg.schedule.build_comm_dag(job_a(pkg), 100.0)
        dag_b = pkg.schedule.build_comm_dag(job_b(pkg), 100.0)
        cfg = pkg.fleet.ControllerConfig(cadence_s=5.0, confirm_ticks=3,
                                         cooldown_s=0.0,
                                         drift_threshold=0.05)
        cp = pkg.fleet.ControlPlane(
            planner, cfg,
            phase_book={"t": {"A": job_a(pkg), "B": job_b(pkg)}})
        history_before = len(planner.history)
        drive(pkg, cp, dag_a, x0, phase="A", t0=0.0, iterations=10)
        drive(pkg, cp, dag_b, x0, phase="B", t0=100.0, iterations=2)
        drive(pkg, cp, dag_a, x0, phase="A", t0=104.0, iterations=30)
        assert len(planner.history) == history_before
        assert all("decision" not in d for d in cp.decisions)
        assert cp.report()["tenants"]["t"]["planned_phase"] == "A"
        assert np.array_equal(planner.tenants["t"].plan.x, x0)
        return _decisions(cp), x0
    (ref_d, ref_x), (port_d, port_x) = both(run)
    assert port_d == ref_d
    np.testing.assert_array_equal(port_x, ref_x)


def test_hysteresis_noisy_rates_do_not_flap():
    def run(pkg):
        planner = make_planner(pkg)
        planner.handle(pkg.fleet.JobArrival(name="t", job=job_a(pkg)))
        x0 = planner.tenants["t"].plan.x.copy()
        dag_a = pkg.schedule.build_comm_dag(job_a(pkg), 100.0)
        cfg = pkg.fleet.ControllerConfig(**CFG)
        cp = pkg.fleet.ControlPlane(
            planner, cfg,
            phase_book={"t": {"A": job_a(pkg), "B": job_b(pkg)}})
        drive(pkg, cp, dag_a, x0, phase="A", t0=0.0, iterations=5)
        cp.observe(pkg.fleet.PhaseTransition(t=200.0, tenant="t",
                                             phase="B"))
        drive(pkg, cp, dag_a, x0, phase=None, t0=200.0, iterations=40,
              noise=0.3, rng=np.random.default_rng(7))
        evaluated = [d for d in cp.decisions if d["tenant"] == "t"]
        assert evaluated, "cadence never fired"
        assert all("decision" not in d for d in evaluated)
        assert np.array_equal(planner.tenants["t"].plan.x, x0)
        return _decisions(cp)
    ref, port = both(run)
    assert port == ref


def test_cooldown_limits_steer_rate():
    def run(pkg):
        planner = make_planner(pkg)
        planner.handle(pkg.fleet.JobArrival(name="t", job=job_a(pkg)))
        x0 = planner.tenants["t"].plan.x.copy()
        dag_b = pkg.schedule.build_comm_dag(job_b(pkg), 100.0)
        cfg = pkg.fleet.ControllerConfig(cadence_s=1.0, confirm_ticks=1,
                                         cooldown_s=1e9,
                                         drift_threshold=0.05)
        cp = pkg.fleet.ControlPlane(
            planner, cfg,
            phase_book={"t": {"A": job_a(pkg), "B": job_b(pkg)}})
        cp.observe(pkg.fleet.PhaseTransition(t=0.0, tenant="t", phase="A"))
        cp._last_change["t"] = 0.0
        drive(pkg, cp, dag_b, x0, phase="B", t0=10.0, iterations=40)
        assert {d["action"] for d in cp.decisions} == {"cooldown"}
        assert np.array_equal(planner.tenants["t"].plan.x, x0)
        return _decisions(cp)
    ref, port = both(run)
    assert port == ref


# ----------------------------------------------------------------- replay
def test_journal_replay_reproduces_decisions(steered_sessions, tmp_path):
    """Replaying each package's journal reproduces its decisions; the
    port's replay also reproduces the reference's."""
    replays = []
    for pkg, (planner, cp, _, cfg) in zip((REF, PORT), steered_sessions):
        path = tmp_path / f"{pkg.name}.jsonl"
        with open(path, "w") as f:
            for entry in planner.journal.entries:
                json.dump(entry, f, default=str)
                f.write("\n")
        fresh = make_planner(pkg, journal=pkg.obs.FleetJournal())
        cp2 = pkg.fleet.ControlPlane.replay(
            str(path), fresh, config=cfg,
            phase_book={"t": {"A": job_a(pkg), "B": job_b(pkg)}})

        def strip(decisions):
            return [{k: v for k, v in d.items() if k != "decision"}
                    for d in decisions]
        assert strip(cp2.decisions) == strip(cp.decisions)
        applied = [d["decision"] for d in cp.decisions if "decision" in d]
        replayed = [d["decision"] for d in cp2.decisions
                    if "decision" in d]
        assert [d["option"] for d in replayed] == \
            [d["option"] for d in applied]
        for a, b in zip(applied, replayed):
            assert a["cost_keep_s"] == pytest.approx(b["cost_keep_s"])
            assert a["cost_replan_s"] == pytest.approx(b["cost_replan_s"])
        np.testing.assert_array_equal(fresh.tenants["t"].plan.x,
                                      planner.tenants["t"].plan.x)
        assert fresh.dwell_for("t") == pytest.approx(planner.dwell_for("t"))
        replays.append((_decisions(cp2), fresh))
    (ref_d, ref_pl), (port_d, port_pl) = replays
    assert port_d == ref_d
    assert history_json(PORT, port_pl) == history_json(REF, ref_pl)


# --------------------------------------------------- realloc break-even
def test_realloc_break_even_gate():
    def run(pkg):
        dag = _tiny(pkg)
        P = dag.cluster.num_pods
        x0 = np.full((P, P), 1)
        np.fill_diagonal(x0, 0)
        prob = pkg.des.DESProblem(dag)
        ideal = pkg.des.simulate(prob, np.zeros((P, P)), ideal=True)
        boosted = np.full(P, 8)

        def realloc(**kw):
            if pkg is PORT:
                kw["des_options"] = CPU
            return pkg.fleet.reallocate(
                dag, x0, boosted, ideal_comm_time=ideal.comm_time,
                num_random=4, rng=np.random.default_rng(0), **kw)
        res_free = realloc()
        assert res_free.improved
        res_gated = realloc(dwell_s=1e-6, reconfig_s_per_circuit=1e3)
        assert not res_gated.improved
        assert res_gated.details.get("rejected") == "break_even"
        np.testing.assert_array_equal(res_gated.x, x0)
        res_long = realloc(dwell_s=1e12, reconfig_s_per_circuit=1e-9)
        assert res_long.improved
        np.testing.assert_array_equal(res_long.x, res_free.x)
        return res_free, res_gated
    (rf, rg), (pf, pg) = both(run)
    np.testing.assert_array_equal(pf.x, rf.x)
    assert pf.comm_time == rf.comm_time
    assert pg.details == rg.details


# ------------------------------------------------------- plan() facade
def test_plan_request_kind_validation():
    for pkg in (REF, PORT):
        dag = _tiny(pkg)
        req = pkg.api.PlanRequest
        with pytest.raises(ValueError):
            req().kind
        with pytest.raises(ValueError):
            req(dag=dag, fleet_requests=[("a", job_a(pkg))]).kind
        assert req(dag=dag).kind == "dag"
        assert req(dag=dag, failure=pkg.api.FailureModel()).kind \
            == "failsafe"
        assert req(dag=dag,
                   failure=pkg.api.FailureModel(resilient=True)).kind \
            == "resilient"
        assert req(fleet_requests=[("a", job_a(pkg))]).kind == "fleet"


def test_plan_matches_optimize_bit_identical():
    def run(pkg):
        dag = _tiny(pkg)
        legacy = pkg.api.optimize(dag, "delta-fast", ga_options=pkg.GA)
        unified = pkg.api.plan(pkg.api.PlanRequest(dag=dag,
                                                   ga_options=pkg.GA))
        np.testing.assert_array_equal(legacy.x, unified.x)
        assert legacy.makespan == unified.makespan
        assert legacy.nct == unified.nct
        assert legacy.total_ports == unified.total_ports
        return unified
    ref, port = both(run)
    np.testing.assert_array_equal(port.x, ref.x)
    assert port.makespan == ref.makespan and port.nct == ref.nct


def test_plan_matches_ensemble_and_failsafe_bit_identical():
    def run(pkg):
        dag = _tiny(pkg)
        ens = pkg.dag.DagEnsemble([dag, pkg.schedule.build_comm_dag(
            pkg.job(4), 400.0)])
        a = pkg.api.optimize_ensemble(ens, objective="max-regret",
                                      ga_options=pkg.GA)
        b = pkg.api.plan(pkg.api.PlanRequest(ensemble=ens,
                                             objective="max-regret",
                                             ga_options=pkg.GA))
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.makespans, b.makespans)
        assert a.worst_regret == b.worst_regret
        fa = pkg.api.optimize_failsafe(dag, num_planes=2, k=1,
                                       ga_options=pkg.GA)
        fb = pkg.api.plan(pkg.api.PlanRequest(
            dag=dag, ga_options=pkg.GA,
            failure=pkg.api.FailureModel(num_planes=2, k=1)))
        np.testing.assert_array_equal(fa.x, fb.x)
        assert fa.makespan == fb.makespan
        ra = pkg.api.optimize_resilient(dag, budget_s=0.0,
                                        ga_options=pkg.GA)
        rb = pkg.api.plan(pkg.api.PlanRequest(
            dag=dag, ga_options=pkg.GA,
            failure=pkg.api.FailureModel(resilient=True, budget_s=0.0)))
        np.testing.assert_array_equal(ra.x, rb.x)
        assert ra.makespan == rb.makespan
        assert ra.details["fallback_stage"] == rb.details["fallback_stage"]
        return b, fb, rb
    ref, port = both(run)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.x, r.x)
    np.testing.assert_array_equal(port[0].makespans, ref[0].makespans)
    assert port[1].makespan == ref[1].makespan


def test_plan_matches_fleet_bit_identical():
    def run(pkg):
        a_planner, a_report = pkg.api.fleet_optimize([("a", job_a(pkg))],
                                                     ga_options=pkg.GA)
        res = pkg.api.plan(pkg.api.PlanRequest(
            fleet_requests=[("a", job_a(pkg))], ga_options=pkg.GA,
            fleet=pkg.api.FleetOptions()))
        assert isinstance(res, pkg.api.FleetPlanResult)
        b_planner, b_report = res
        np.testing.assert_array_equal(a_planner.tenants["a"].plan.x,
                                      b_planner.tenants["a"].plan.x)
        assert a_report["tenants"].keys() == b_report["tenants"].keys()
        assert a_report["tenants"] == b_report["tenants"]
        return b_planner, b_report
    (rp, rr), (pp, pr) = both(run)
    np.testing.assert_array_equal(pp.tenants["a"].plan.x,
                                  rp.tenants["a"].plan.x)
    assert pr["tenants"] == rr["tenants"]
    assert pr["ledger"] == rr["ledger"]
