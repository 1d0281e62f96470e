"""The port's MILP planners on the CPU: the event-interval model against
the JAX reference's array for array, one solve of each package, the
hot-started Joint through `plan()`, and the reference's checks of the
independent validator and of infeasible port budgets.

The model is numpy and HiGHS on the host in both packages, so the arrays
must be equal, not close, and one solve of each gives the same x with
makespans within rel 1e-9 (the same model and solver; the last digits may
differ only through the tolerance HiGHS works to).  The hot-started plan
must be `validate_solution`-clean and no worse than its own `delta-fast`
GA incumbent, within rel 1e-6 (the hot start's cut slack)."""
import copy

import numpy as np
import pytest

from conftest import gpt7b_job
from repro.core import des as jax_des_np
from repro.core import milp as jax_milp
from repro.core import pruning as jax_pruning
from repro.core import xbound as jax_xbound
from repro.core.milp_fixed import solve_fixed_step as jax_solve_fixed_step
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core import des as port_des
from repro_torch.core import milp, pruning, xbound
from repro_torch.core.api import PlanRequest, plan
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.dag import CommDAG, CommTask, Dep, make_virtual
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.milp import MILPOptions, MILPResult, validate_solution
from repro_torch.core.milp_fixed import solve_fixed_step
from repro_torch.core.schedule import build_comm_dag
from test_torch_des import port_job

pytestmark = pytest.mark.milp

CPU = DESOptions(device="cpu")
GA = GAOptions(seed=0, pop_size=8, max_generations=4, patience=10**9,
               time_limit=1e9)
_MODEL_FIELDS = ("lb", "ub", "integrality", "rows_i", "rows_j", "rows_v",
                 "row_lb", "row_ub")


def _model(pkg, des, dag, fairness: bool, prune: bool):
    """`_build` of one package on its own DAG, with its own pruning
    windows, Alg. 2 bound and t_up, as `solve_delta_milp` assembles it."""
    mil, prn, xb = pkg
    problem = des.DESProblem(dag)
    _, anchors, k = prn.profile_anchors(problem)
    t_up = prn.estimate_t_up(problem)
    windows = prn.task_time_index_pruning(
        dag, k, anchors if prune else None, anchor_margin=1)
    xbar = xb.x_upper_bound(dag, t_up=t_up)
    opts = mil.MILPOptions(fairness=fairness, prune=prune)
    return mil._build(dag, opts, windows, xbar, t_up)


@pytest.mark.parametrize("fairness", [True, False])
@pytest.mark.parametrize("prune", [True, False])
def test_build_equals_reference(fairness, prune):
    """gpt-7b with 3 microbatches: the port assembles the reference's
    model -- constraint matrix, row and column bounds, integrality -- and
    the same variable layout (the objective is C, the makespan)."""
    got, lay = _model((milp, pruning, xbound), port_des,
                      build_comm_dag(port_job(3)), fairness, prune)
    want, want_lay = _model((jax_milp, jax_pruning, jax_xbound),
                            jax_des_np, jax_build_comm_dag(gpt7b_job(3)),
                            fairness, prune)
    assert (got.nvar, got.nrow) == (want.nvar, want.nrow)
    for name in _MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert lay.C == want_lay.C and lay.K == want_lay.K
    for name in ("x", "t", "delta", "S", "Cm"):
        np.testing.assert_array_equal(getattr(lay, name),
                                      getattr(want_lay, name))
    assert (lay.w, lay.y, lay.s) == (want_lay.w, want_lay.y, want_lay.s)


@pytest.fixture(scope="module")
def dag2():
    return build_comm_dag(port_job(2))


@pytest.fixture(scope="module")
def hotstart(dag2):
    """plan(delta-joint-hotstart) on gpt-7b with 2 microbatches, and its
    own delta-fast plan from the same GA options."""
    opts = MILPOptions(time_limit=60)
    hot = plan(PlanRequest(dag=dag2, method="delta-joint-hotstart",
                           ga_options=GA, des_options=CPU,
                           milp_options=opts))
    fast = plan(PlanRequest(dag=dag2, method="delta-fast", ga_options=GA,
                            des_options=CPU))
    return hot, fast, opts


def test_topo_solve_matches_reference(dag2):
    """One DELTA-Topo solve of each package on gpt-7b with 2 microbatches
    (the port's through plan()): the same status, x and makespan."""
    got = plan(PlanRequest(dag=dag2, method="delta-topo", des_options=CPU,
                           milp_options=MILPOptions(time_limit=60)))
    want = jax_milp.solve_delta_milp(
        jax_build_comm_dag(gpt7b_job(2)),
        jax_milp.MILPOptions(fairness=True, time_limit=60))
    sched = got.details["schedule"]
    assert got.details["milp_status"] == want.status == "optimal"
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(sched.x, want.x)
    assert sched.makespan == pytest.approx(want.makespan, rel=1e-9)
    assert validate_solution(dag2, sched) == []
    assert jax_milp.validate_solution(jax_build_comm_dag(gpt7b_job(2)),
                                      sched) == []


def test_hotstart_plan_is_valid_and_no_worse_than_its_ga(dag2, hotstart):
    hot, fast, opts = hotstart
    assert hot.feasible and hot.details["milp_status"] == "optimal"
    assert validate_solution(dag2, hot.details["schedule"]) == []
    assert hot.makespan <= fast.makespan * (1 + 1e-6)
    assert hot.details["hotstart_ga_makespan"] == fast.makespan
    # the caller's options object is copied, never mutated
    assert opts == MILPOptions(time_limit=60)
    assert opts.seed_x is None and opts.upper_bound is None


def test_validate_rejects_corrupted_feasible_schedule(dag2, hotstart):
    """A real solved schedule with its volumes inflated must fail the
    conservation and capacity checks."""
    sched = hotstart[0].details["schedule"]
    assert validate_solution(dag2, sched) == []
    bad = copy.deepcopy(sched)
    bad.w = {k: 10.0 * v for k, v in bad.w.items()}
    errors = validate_solution(dag2, bad)
    assert any("conservation" in e for e in errors)
    assert any("link cap" in e or e.startswith("nic") for e in errors)


def test_reference_validator_judges_port_schedules(dag2, hotstart):
    """The reference's `validate_solution` on the port's schedules: the
    hot-started Joint and its delta-fast schedule pass it, and an
    inflated copy fails it with the port validator's errors, word for
    word."""
    ref_dag = jax_build_comm_dag(gpt7b_job(2))
    hot, fast, _ = hotstart
    sched = hot.details["schedule"]
    assert jax_milp.validate_solution(ref_dag, sched) == []
    assert jax_milp.validate_solution(
        ref_dag, milp.result_from_topology(dag2, fast.x)) == []
    bad = copy.deepcopy(sched)
    bad.w = {k: 10.0 * v for k, v in bad.w.items()}
    errors = jax_milp.validate_solution(ref_dag, bad)
    assert errors and errors == validate_solution(dag2, bad)


def _two_task_result(tasks, deps, cluster, w, x
                     ) -> tuple[CommDAG, MILPResult]:
    dag = CommDAG(tasks=tasks, deps=deps, cluster=cluster)
    n = len(tasks)
    res = MILPResult(x=x, makespan=1.0, status="optimal", solve_time=0.0,
                     start=np.zeros(n), finish=np.ones(n),
                     t=np.array([0.0, 1.0]), w=w)
    return dag, res


def test_validate_catches_aggregate_link_violation():
    """Two tasks each within the per-task link capacity whose *sum*
    exceeds it: only the aggregate per-(pair, interval) check sees it."""
    B = 1e9
    cluster = ClusterSpec(num_pods=2, port_limits=(2, 2), nic_bandwidth=B)
    tasks = [make_virtual(),
             CommTask(1, 0, 1, 1, 0.6 * B, (0,), (100,), kind="rand"),
             CommTask(2, 0, 1, 1, 0.6 * B, (1,), (101,), kind="rand")]
    deps = [Dep(0, 1, 0.0), Dep(0, 2, 0.0)]
    x = np.array([[0, 1], [1, 0]], dtype=np.int64)
    dag, res = _two_task_result(tasks, deps, cluster,
                                {(1, 1): 0.6 * B, (2, 1): 0.6 * B}, x)
    errors = validate_solution(dag, res)
    assert any("link cap pair" in e for e in errors), errors
    assert not any("conservation" in e for e in errors)
    res.x = x * 2
    assert validate_solution(dag, res) == []


def test_validate_catches_nic_class_violation():
    """Two tasks on different pairs sharing a source GPU: each link is
    fine but the GPU's NIC injection (Eq. 10) is oversubscribed."""
    B = 1e9
    cluster = ClusterSpec(num_pods=3, port_limits=(4, 4, 4),
                          nic_bandwidth=B)
    tasks = [make_virtual(),
             CommTask(1, 0, 1, 1, 0.8 * B, (0,), (100,), kind="rand"),
             CommTask(2, 0, 2, 1, 0.8 * B, (0,), (200,), kind="rand")]
    deps = [Dep(0, 1, 0.0), Dep(0, 2, 0.0)]
    x = np.zeros((3, 3), dtype=np.int64)
    x[0, 1] = x[1, 0] = x[0, 2] = x[2, 0] = 1
    dag, res = _two_task_result(tasks, deps, cluster,
                                {(1, 1): 0.8 * B, (2, 1): 0.8 * B}, x)
    errors = validate_solution(dag, res)
    assert any(e.startswith("nic src") for e in errors), errors
    assert not any("link cap" in e for e in errors)


def test_infeasible_ports_detected():
    # 1 stage/pod -> middle pods need 3 pairs but only have 2 ports
    dag_bad = build_comm_dag(port_job(2, tp=2, gpus_per_pod_per_replica=2))
    res = milp.solve_delta_milp(dag_bad, MILPOptions(time_limit=30,
                                                     hot_start=False))
    assert res.status == "infeasible" and not res.feasible
    out = plan(PlanRequest(dag=dag_bad, method="delta-joint",
                           des_options=CPU,
                           milp_options=MILPOptions(time_limit=30,
                                                    hot_start=False)))
    assert not out.feasible and out.details["milp_status"] == "infeasible"


def test_fixed_step_matches_reference():
    """The Appendix-A fixed-step MILP, the port's copy against the
    reference's on one 3-pod, two-task DAG at a coarse step."""
    def tiny(pkg_dag, cluster):
        CommDAG_, CommTask_, Dep_, virtual = pkg_dag
        tasks = [virtual(),
                 CommTask_(1, 0, 1, flows=2, volume=4e9, src_gpus=(0, 1),
                           dst_gpus=(2, 3)),
                 CommTask_(2, 1, 2, flows=2, volume=1e9, src_gpus=(4, 5),
                           dst_gpus=(6, 7))]
        return CommDAG_(tasks=tasks, deps=[Dep_(0, 1, 0.0),
                                           Dep_(0, 2, 0.01)],
                        cluster=cluster)
    from repro.core import cluster as jax_cluster
    from repro.core import dag as jax_dag
    kw = dict(num_pods=3, port_limits=(3, 3, 3), nic_bandwidth=50e9)
    got = solve_fixed_step(tiny((CommDAG, CommTask, Dep, make_virtual),
                                ClusterSpec(**kw)), dt=0.01, time_limit=30)
    want = jax_solve_fixed_step(
        tiny((jax_dag.CommDAG, jax_dag.CommTask, jax_dag.Dep,
              jax_dag.make_virtual), jax_cluster.ClusterSpec(**kw)),
        dt=0.01, time_limit=30)
    assert got.status == want.status == "optimal"
    assert got.num_slices == want.num_slices
    np.testing.assert_array_equal(got.x, want.x)
    assert got.makespan == pytest.approx(want.makespan, rel=1e-9)

