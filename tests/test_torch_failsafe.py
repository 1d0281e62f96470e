"""The port's failsafe and resilient planners on the CPU: the failure
scenarios and `delta_failsafe` against the JAX reference, the solver
fallback chain of `solve_resilient` (the reference's checks), and the
rule that no fallback hides the device: a GA that fails in the resilient
chain, or an ensemble engine that cannot be built, raises out of the
port instead of handing back a lesser plan.

The chain and `result_from_topology` are held against the reference's
on the same DAG and the same forced failures, and every schedule the
port hands back passes the reference's own `validate_solution`.

Tolerances: the same `x` as the reference's GA from the same seed, the
per-scenario makespans within rel 1e-12 (both from the exact numpy DES
on equal topologies) and the objective at rel 1e-5; rel 1e-9 for a
masked makespan against the numpy DES (the same float64 simulation);
rel 5e-5 for the float32 ensemble DES against it; none for
`result_from_topology` and the fallback chain against the reference's
(the same float64 numpy code on equal inputs)."""
import numpy as np
import pytest
import torch

from conftest import gpt7b_job, one_circuit_topology
from repro.core import des_jax
from repro.core import ga as jax_ga
from repro.core import milp as jax_milp
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core import ga as port_ga
from repro_torch.core.api import FailureModel, PlanRequest, plan
from repro_torch.core.dag import DagEnsemble
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import (FAILSAFE_OBJECTIVES, FailsafeFitness,
                                 GAOptions, GAResult, TopologySpace,
                                 delta_failsafe, delta_robust,
                                 failure_scenarios)
from repro_torch.core.milp import (MILPOptions, result_from_topology,
                                   solve_delta_milp, solve_resilient,
                                   validate_solution)
from repro_torch.core.schedule import build_comm_dag
from test_torch_des import port_job

CPU = DESOptions(device="cpu")
KW = dict(seed=0, pop_size=12, max_generations=5, patience=10**9,
          time_limit=1e9)
GA = GAOptions(**KW, des_options=CPU)
JAX_GA = jax_ga.GAOptions(**KW, backend="jax",
                          des_options=des_jax.DESOptions(backend="ref"))


@pytest.fixture(scope="module")
def tiny():
    """gpt-7b with 2 microbatches (the reference tests' `tiny_dag`), in
    the port and in the reference."""
    return build_comm_dag(port_job(2)), jax_build_comm_dag(gpt7b_job(2))


# ------------------------------------------------------------ the GA
def test_failure_scenarios_equal_reference(tiny):
    dag, ref = tiny
    for planes, k in ((4, 1), (2, 1), (4, 4)):
        got = failure_scenarios(dag, num_planes=planes, k=k)
        want = jax_ga.failure_scenarios(ref, num_planes=planes, k=k)
        assert len(got) == len(want) == len(dag.undirected_pairs()) + 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(failure_scenarios(dag, include_healthy=False)) \
        == len(dag.undirected_pairs())


@pytest.mark.parametrize("objective", FAILSAFE_OBJECTIVES)
def test_delta_failsafe_matches_reference(tiny, objective):
    """Same seed and scenarios: the port's delta_failsafe on the torch
    ensemble DES (one member per scenario) gives the reference's x."""
    dag, ref = tiny
    got = delta_failsafe(dag, GA, objective=objective)
    want = jax_ga.delta_failsafe(ref, JAX_GA, objective=objective)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_allclose(got.makespans, want.makespans, rtol=1e-12)
    assert got.objective_value == pytest.approx(want.objective_value,
                                                rel=1e-5)
    assert got.evaluations == want.evaluations
    assert got.feasible and got.objective == objective
    # the per-scenario makespans are the exact masked ones
    for m, ms in zip(failure_scenarios(dag), got.makespans):
        assert ms == simulate(DESProblem(dag), got.x * m).makespan


def test_failsafe_fitness_scores_every_scenario(tiny):
    """One batched call scores genomes x scenarios within rel 5e-5 of the
    masked numpy DES; a worst-case score is the max over scenarios."""
    dag, _ = tiny
    scen = failure_scenarios(dag)
    space = TopologySpace(dag)
    fit = FailsafeFitness(dag, scen, space, GA, "max-regret",
                          np.ones(len(scen)))
    genomes = space.random_init_batch(np.random.default_rng(2), 5)
    ms = fit.member_makespans(genomes)
    assert ms.shape == (5, len(scen)) and fit.batch_calls == 1
    for g, x in enumerate(space.to_matrix_batch(genomes)):
        want = [simulate(DESProblem(dag), x * m).makespan for m in scen]
        np.testing.assert_allclose(ms[g], want, rtol=5e-5)
    np.testing.assert_array_equal(fit.scalarize(ms), ms.max(axis=1))
    with pytest.raises(ValueError, match="objective"):
        delta_failsafe(dag, GA, objective="mean-typo")
    with pytest.raises(ValueError, match="at least one scenario"):
        delta_failsafe(dag, GA, scenarios=[])


def test_plan_failsafe(tiny):
    dag, _ = tiny
    res = plan(PlanRequest(dag=dag, failure=FailureModel(), ga_options=GA))
    want = delta_failsafe(dag, GA)
    assert res.method == "delta-failsafe" and res.feasible
    np.testing.assert_array_equal(res.x, want.x)
    assert res.details["scenario_makespans"] == want.makespans.tolist()
    assert res.details["worst_scenario_makespan"] == want.makespans.max()
    assert res.makespan == simulate(DESProblem(dag), want.x).makespan


# ------------------------------------------------- the device is not hidden
def test_ensemble_engine_is_not_guarded(tiny, monkeypatch):
    """A failure to build the ensemble engine raises out of the GA: with
    no CUDA device and none named, and when the engine itself fails."""
    dag, _ = tiny
    ens = DagEnsemble([dag, dag])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        delta_robust(ens, GAOptions(**KW), refs=[1.0, 1.0])
    with pytest.raises(RuntimeError, match="CUDA device"):
        delta_failsafe(dag, GAOptions(**KW))

    def broken(*a, **kw):
        raise RuntimeError("kernel build failed")
    monkeypatch.setattr(port_ga, "EnsembleTorchDES", broken)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        delta_robust(ens, GA, refs=[1.0, 1.0])


# ------------------------------------------------- solver fallback chain
def _force_milp_timeout(monkeypatch, module="repro_torch.core.milp"):
    """scipy.optimize.milp returning time-limit with NO incumbent."""
    class FakeRes:
        status = 1
        x = None
        mip_gap = None
        message = "time limit reached (no incumbent)"

    monkeypatch.setattr(f"{module}.milp", lambda *a, **kw: FakeRes())


def _assert_same_schedule(got, want):
    """Two MILPResults with the same status, topology and schedule, value
    for value."""
    assert (got.status, got.feasible, got.total_ports) \
        == (want.status, want.feasible, want.total_ports)
    assert (got.degraded, got.fallback_stage) \
        == (want.degraded, want.fallback_stage)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.makespan == want.makespan
    for name in ("t", "start", "finish"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.w == want.w and got.y == want.y
    assert got.stats == want.stats


def test_milp_time_limit_without_incumbent_is_infeasible(tiny, monkeypatch):
    _force_milp_timeout(monkeypatch)
    res = solve_delta_milp(tiny[0], MILPOptions(time_limit=1.0))
    assert res.status == "time_limit"
    assert not np.isfinite(res.makespan)
    assert not res.feasible


def test_solve_resilient_milp_timeout_falls_back_to_ga(tiny, monkeypatch):
    _force_milp_timeout(monkeypatch)
    dag = tiny[0]
    res = solve_resilient(dag, MILPOptions(time_limit=1.0), budget_s=5.0,
                          ga_options=GA)
    assert res.feasible and res.degraded and res.fallback_stage == "ga"
    assert validate_solution(dag, res) == []


def test_solve_resilient_solver_exception_falls_back(tiny, monkeypatch):
    calls = {"n": 0}

    def boom(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("solver crashed")

    monkeypatch.setattr("repro_torch.core.milp.milp", boom)
    dag = tiny[0]
    res = solve_resilient(dag, MILPOptions(time_limit=1.0), budget_s=5.0,
                          retries=1, backoff_s=0.0, ga_options=GA)
    assert calls["n"] >= 2           # retried before falling back
    assert res.feasible and res.degraded and res.fallback_stage == "ga"
    assert validate_solution(dag, res) == []


def test_solve_resilient_last_resort_current_plan(tiny, monkeypatch):
    """A GA that finds no feasible topology hands over to the masked
    current plan."""
    _force_milp_timeout(monkeypatch)
    dag = tiny[0]
    P = dag.cluster.num_pods

    def ga_infeasible(*a, **kw):
        return GAResult(x=np.zeros((P, P), dtype=np.int64), makespan=np.inf,
                        generations=0, evaluations=0, elapsed=0.0,
                        feasible=False)

    monkeypatch.setattr("repro_torch.core.milp.delta_fast", ga_infeasible)
    mask = np.full((P, P), 0.5)
    cur = 2 * one_circuit_topology(dag)
    res = solve_resilient(dag, MILPOptions(time_limit=1.0), budget_s=5.0,
                          current_x=cur, mask=mask)
    assert res.feasible and res.degraded and res.fallback_stage == "current"
    assert (res.x == cur).all()
    assert validate_solution(dag, res) == []
    want = simulate(DESProblem(dag), cur.astype(np.float64) * mask).makespan
    assert res.makespan == pytest.approx(want, rel=1e-9)


def test_resilient_ga_error_raises(tiny, monkeypatch):
    """The GA stage is not guarded: an error of the device or a kernel in
    it raises out of plan() and never becomes a stage-3 plan."""
    def ga_down(*a, **kw):
        raise RuntimeError("fill_maxmin launch failed")

    monkeypatch.setattr("repro_torch.core.milp.delta_fast", ga_down)
    with pytest.raises(RuntimeError, match="fill_maxmin launch failed"):
        plan(PlanRequest(dag=tiny[0], ga_options=GA,
                         failure=FailureModel(resilient=True, budget_s=0)))


def test_plan_resilient(tiny):
    """budget 0: straight to the GA stage, validate-clean; a budget that
    the MILP makes: its optimal schedule, not degraded."""
    dag = tiny[0]
    res = plan(PlanRequest(dag=dag, ga_options=GA,
                           failure=FailureModel(resilient=True, budget_s=0)))
    assert res.method == "delta-resilient" and res.feasible
    assert res.details["fallback_stage"] == "ga" and res.details["degraded"]
    assert validate_solution(dag, res.details["schedule"]) == []
    np.testing.assert_array_equal(res.x, port_ga.delta_fast(dag, GA).x)
    ok = plan(PlanRequest(dag=dag, ga_options=GA,
                          milp_options=MILPOptions(time_limit=60,
                                                   fairness=True),
                          failure=FailureModel(resilient=True)))
    assert ok.details["milp_status"] == "optimal"
    assert ok.details["fallback_stage"] == "" and not ok.details["degraded"]
    assert validate_solution(dag, ok.details["schedule"]) == []


def test_result_from_topology_is_validate_clean(tiny):
    dag = tiny[0]
    x = one_circuit_topology(dag)
    res = result_from_topology(dag, x)
    assert res.feasible
    assert validate_solution(dag, res) == []
    P = dag.cluster.num_pods
    dead = result_from_topology(dag, x, mask=np.zeros((P, P)))
    assert dead.status == "infeasible" and not dead.feasible


@pytest.mark.parametrize("mask", ["healthy", "one-plane-dark", "dark"])
def test_result_from_topology_matches_reference(tiny, mask):
    """The DES trace turned into a schedule, the port's against the
    reference's on one x: unmasked, with 1 of 4 planes dark on one pair,
    and with every link dark (infeasible); the reference's validator
    passes the port's feasible schedules."""
    dag, ref = tiny
    P = dag.cluster.num_pods
    x = 2 * one_circuit_topology(dag)
    m = {"healthy": None, "one-plane-dark": failure_scenarios(dag)[1],
         "dark": np.zeros((P, P))}[mask]
    got = result_from_topology(dag, x, mask=m)
    want = jax_milp.result_from_topology(ref, x, mask=m)
    _assert_same_schedule(got, want)
    assert got.feasible == (mask != "dark")
    if got.feasible:
        assert jax_milp.validate_solution(ref, got) == []


@pytest.mark.parametrize("case", ["milp-timeout", "solver-error",
                                  "ga-infeasible"])
def test_solve_resilient_matches_reference(tiny, monkeypatch, case):
    """The fallback chain of both packages under the same forced failure:
    the MILP times out without an incumbent or its solver raises (both
    land on the GA stage, whose GA gives the same x from the same seed),
    or the GA finds nothing as well (both land on the masked current
    plan).  The same stage, x and schedule, which the reference's
    validator passes."""
    dag, ref = tiny
    P = dag.cluster.num_pods
    for module in ("repro_torch.core.milp", "repro.core.milp"):
        if case == "solver-error":
            def boom(*a, **kw):
                raise RuntimeError("solver crashed")
            monkeypatch.setattr(f"{module}.milp", boom)
        else:
            _force_milp_timeout(monkeypatch, module)
    if case == "ga-infeasible":
        for where, result in (("repro_torch.core.milp.delta_fast", GAResult),
                              ("repro.core.ga.delta_fast",
                               jax_ga.GAResult)):
            monkeypatch.setattr(where, lambda *a, _r=result, **kw: _r(
                x=np.zeros((P, P), dtype=np.int64), makespan=np.inf,
                generations=0, evaluations=0, elapsed=0.0, feasible=False))
    kw = dict(budget_s=30.0, retries=1, backoff_s=0.0,
              current_x=2 * one_circuit_topology(dag),
              mask=failure_scenarios(dag)[2])
    got = solve_resilient(dag, MILPOptions(time_limit=1.0), ga_options=GA,
                          **kw)
    want = jax_milp.solve_resilient(ref, jax_milp.MILPOptions(time_limit=1.0),
                                    ga_options=JAX_GA, **kw)
    assert got.fallback_stage == ("current" if case == "ga-infeasible"
                                  else "ga")
    _assert_same_schedule(got, want)
    assert jax_milp.validate_solution(ref, got) == []
