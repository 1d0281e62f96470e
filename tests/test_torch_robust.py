"""The port's ensemble engine on the CPU: `EnsembleTorchDES`, the member
axis of the fused filling step's plain version, `delta_robust`, the
shared-x robust MILP and `plan()` of an ensemble, against the numpy DES
and the JAX reference.

Inputs are the reference's gpt-7b DAGs at two sequence lengths (the
`seq_mix` of tests/test_robust.py) and its mirror-image 3-pod DAGs,
genomes and masks drawn with numpy from a seed.  Tolerances: rel 5e-5
for the float32 DES against the exact numpy DES (tests/test_des_jax.py's
bound); rel 1e-5 against `EnsembleJaxDES` and the reference's `_maxmin`
on the reference's own arrays (both float32, sums in another order);
none where the port must equal itself (a singleton ensemble and
`TorchDES`, the member axis and single-member calls: the same operations
on the same bits); and the same `x` as the reference's GA from the same
seed, with the objective values at rel 1e-5.  The robust MILP is HiGHS on
the host in both packages, on models that must be equal: a solve of each
gives the same status, x and total ports, with the member makespans and
the objective within rel 1e-9 (the last digits only through the
tolerance HiGHS works to), and the reference's validator passes the
port's member schedules.  Beside the reference's own checks, it is held
against the reference on the mirror pair and on gpt-7b with one
microbatch at two sequence lengths (`seq_mix` itself takes HiGHS
minutes per objective)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from conftest import gpt7b_job
from repro.core import des as jax_des_np
from repro.core import des_jax
from repro.core import ga as jax_ga
from repro.core import milp as jax_milp
from repro.core.cluster import ClusterSpec as JaxClusterSpec
from repro.core.dag import CommDAG as JaxCommDAG
from repro.core.dag import CommTask as JaxCommTask
from repro.core.dag import DagEnsemble as JaxDagEnsemble
from repro.core.dag import Dep as JaxDep
from repro.core.dag import make_virtual as jax_make_virtual
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.convert import des_arrays_from_numpy
from repro_torch.core.api import (ROBUST_METHODS, EnsemblePlanResult,
                                  PlanRequest, evaluate_on_ensemble, plan)
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.dag import CommDAG, CommTask, DagEnsemble, Dep, \
    make_virtual
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import (DESOptions, EnsembleTorchDES,
                                        PadSpec, TorchDES, _incidence_csr,
                                        _rate_step, member_pad,
                                        stack_problems)
from repro_torch.core.ga import (GAOptions, TopologySpace, delta_fast,
                                 delta_robust, ensemble_x_upper_bound)
from repro_torch.core.milp import (MILPOptions, solve_delta_milp,
                                   solve_robust_milp, validate_solution)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.kernels.ref import fill_maxmin_ref
from test_torch_des import port_job

CPU = DESOptions(device="cpu")
DES_RTOL = 5e-5
JAX_RTOL = 1e-5
# generation-bounded (never wall-clock-bounded), as tests/test_robust.py
KW = dict(seed=0, pop_size=12, max_generations=5, patience=10**9,
          time_limit=1e9)
OPTS = GAOptions(**KW, backend="torch", des_options=CPU)
JAX_OPTS = jax_ga.GAOptions(**KW, backend="jax",
                            des_options=des_jax.DESOptions(backend="ref"))
JOBS = ((3, {}), (2, {"micro_tokens": 16384}))


@pytest.fixture(scope="module")
def seq_mix():
    """gpt-7b at two sequence lengths on one cluster, in both packages."""
    port = [build_comm_dag(port_job(mb, **kw)) for mb, kw in JOBS]
    ref = [jax_build_comm_dag(gpt7b_job(mb, **kw)) for mb, kw in JOBS]
    return port, ref


@pytest.fixture(scope="module")
def lanes(seq_mix):
    """Random genomes over the union pairs and one mask per member."""
    port, _ = seq_mix
    space = TopologySpace.for_ensemble(DagEnsemble(port))
    genomes = space.random_init_batch(np.random.default_rng(7), 6)
    P = space.P
    masks = np.stack([np.ones((P, P)), np.full((P, P), 0.5)])
    masks[0, 0, 1] = masks[0, 1, 0] = 0.75
    return space, genomes, masks


PORT_DAG = (ClusterSpec, CommDAG, CommTask, Dep, make_virtual)
JAX_DAG = (JaxClusterSpec, JaxCommDAG, JaxCommTask, JaxDep, jax_make_virtual)


def _tiny(heavy_pair, light_pair, hv=4e9, lv=1e9, pkg=PORT_DAG):
    """3-pod two-task DAG; `heavy_pair` carries 4x the volume (the
    mirror-image members of tests/test_robust.py), built from the port's
    classes or, with `pkg=JAX_DAG`, the reference's."""
    cluster, dag, task, dep, virtual = pkg
    cl = cluster(num_pods=3, port_limits=(3, 3, 3), nic_bandwidth=50e9)
    tasks = [virtual(),
             task(1, *heavy_pair, flows=2, volume=hv,
                  src_gpus=(0, 1), dst_gpus=(2, 3)),
             task(2, *light_pair, flows=2, volume=lv,
                  src_gpus=(4, 5), dst_gpus=(6, 7))]
    deps = [dep(0, 1, 0.0), dep(0, 2, 0.01)]
    return dag(tasks=tasks, deps=deps, cluster=cl)


# ------------------------------------------------ the stacked arrays
def test_stack_problems_equal_reference(seq_mix):
    """The port stacks the members into the reference's arrays, field for
    field, at the reference's bucketed member pad."""
    port, ref = seq_mix
    ref_probs = [jax_des_np.DESProblem(d) for d in ref]
    ref_pad = des_jax.member_pad(ref_probs).bucketed(
        des_jax.DESOptions().resolve())
    pad = member_pad([DESProblem(d) for d in port]).bucketed()
    assert tuple(pad) == tuple(ref_pad)
    got = stack_problems([DESProblem(d) for d in port], pad, device="cpu")
    want = des_jax.stack_problems(ref_probs, ref_pad)
    for k in des_jax._ARRAY_FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape == (2, getattr(got, k).shape[1]), k
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
    with pytest.raises(ValueError, match="at least one"):
        stack_problems([], device="cpu")


# ----------------------------------------- the filling step's member axis
def test_fill_maxmin_ref_members_match_reference(seq_mix):
    """`fill_maxmin_ref` over two members' CSRs (lane s reads member
    s % 2) against the reference's `_maxmin` on each member's own arrays,
    lane by lane, and bit-equal to one call per member."""
    _, ref = seq_mix
    probs = [jax_des_np.DESProblem(d) for d in ref]
    pad = des_jax.member_pad(probs).bucketed(des_jax.DESOptions().resolve())
    stacked = des_jax.stack_problems(probs, pad)
    fields = {k: np.asarray(getattr(stacked, k))
              for k in des_jax._ARRAY_FIELDS}
    arrays = des_arrays_from_numpy(fields, pad, "cpu")
    csr = _incidence_csr(arrays)
    pop, m, n = 4, 2, pad.n
    rng = np.random.default_rng(11)
    real = fields["task_valid"].copy()
    real[:, 0] = False
    active = (rng.random((pop, m, n)) < 0.4) & real
    link = rng.integers(1, 4, (pop, m, pad.links)).astype(np.float32)
    caps = np.concatenate([link, np.ones((pop, m, pad.cons - pad.links),
                                         np.float32)], -1)
    rates, rounds = fill_maxmin_ref(
        *csr, torch.from_numpy(active.reshape(pop * m, n)),
        torch.from_numpy(caps.reshape(pop * m, -1)), arrays.flows)
    rates = rates.view(pop, m, n).numpy()
    for j in range(m):
        jarr = des_jax.DESArrays(
            **{k: jnp.asarray(v[j]) for k, v in fields.items()},
            num_cons=pad.cons, num_link_cons=pad.links, nic_bandwidth=1.0,
            n=pad.n)
        want = np.asarray(jax.vmap(lambda a, c: des_jax._maxmin(
            jarr, a, c, backend="ref"))(jnp.asarray(active[:, j]),
                                        jnp.asarray(caps[:, j])))
        np.testing.assert_allclose(rates[:, j], want, rtol=JAX_RTOL, atol=0)
        one, one_rounds = fill_maxmin_ref(
            *(t[j:j + 1] for t in csr),
            torch.from_numpy(active[:, j].copy()),
            torch.from_numpy(caps[:, j].copy()), arrays.flows[j:j + 1])
        np.testing.assert_array_equal(one.numpy(), rates[:, j])
        np.testing.assert_array_equal(one_rounds.numpy(),
                                      rounds.view(pop, m)[:, j].numpy())
    with pytest.raises(ValueError, match="multiple of 2 members"):
        fill_maxmin_ref(*csr, torch.from_numpy(active.reshape(-1, n)[:3]),
                        torch.from_numpy(caps.reshape(pop * m, -1)[:3]),
                        arrays.flows)


# ------------------------------------------------------- the engine
@pytest.mark.parametrize("backend", ["ref", "segment"])
def test_ensemble_des_matches_numpy(seq_mix, lanes, backend):
    port, _ = seq_mix
    space, genomes, masks = lanes
    probs = [DESProblem(d) for d in port]
    ens = EnsembleTorchDES(probs, options=DESOptions(backend=backend,
                                                     device="cpu"))
    assert ens.M == 2 and ens.backend == backend
    ms, feas = ens.ensemble_genome_makespan(genomes, space.edge_u,
                                            space.edge_v, masks)
    assert ms.shape == feas.shape == (len(genomes), 2)
    for g, x in enumerate(space.to_matrix_batch(genomes)):
        for m, prob in enumerate(probs):
            want = simulate(prob, x * masks[m])
            assert bool(feas[g, m]) == want.feasible
            assert ms[g, m] == pytest.approx(want.makespan, rel=DES_RTOL)
    # one (P, P) mask serves every member; `makespans` is one genome's row
    ms1, _ = ens.ensemble_genome_makespan(genomes[:2], space.edge_u,
                                          space.edge_v, masks[1])
    x = space.to_matrix(genomes[1])
    row, row_feas = ens.makespans(x, masks[1])
    np.testing.assert_array_equal(row, ms1[1])
    assert row_feas.all()


def test_ensemble_des_matches_jax_on_reference_arrays(seq_mix, lanes):
    """EnsembleTorchDES on the reference's own stacked arrays against
    EnsembleJaxDES (backend ref), with per-member masks."""
    port, ref = seq_mix
    space, genomes, masks = lanes
    jd = des_jax.EnsembleJaxDES([jax_des_np.DESProblem(d) for d in ref],
                                options=des_jax.DESOptions(backend="ref"))
    fields = {k: np.asarray(getattr(jd.arrays, k))
              for k in des_jax._ARRAY_FIELDS}
    arrays = des_arrays_from_numpy(fields, jd.pad, "cpu")
    td = EnsembleTorchDES([DESProblem(d) for d in port], options=CPU,
                          arrays=arrays)
    assert td.pad == PadSpec(*jd.pad)
    ms_j, feas_j = jd.ensemble_genome_makespan(genomes, space.edge_u,
                                               space.edge_v, masks)
    ms_t, feas_t = td.ensemble_genome_makespan(genomes, space.edge_u,
                                               space.edge_v, masks)
    np.testing.assert_array_equal(feas_t, feas_j)
    np.testing.assert_allclose(ms_t, ms_j, rtol=JAX_RTOL)


def test_singleton_ensemble_is_torch_des(seq_mix, lanes):
    """The one-member ensemble is TorchDES, bit for bit: one event loop."""
    port, _ = seq_mix
    space, genomes, masks = lanes
    prob = DESProblem(port[0])
    one = EnsembleTorchDES([prob], options=CPU)
    ms_e, feas_e = one.ensemble_genome_makespan(genomes, space.edge_u,
                                                space.edge_v, masks[1])
    ms_t, feas_t = TorchDES(prob, options=CPU).batch_genome_makespan(
        genomes, space.edge_u, space.edge_v, masks[1])
    np.testing.assert_array_equal(ms_e[:, 0], ms_t)
    np.testing.assert_array_equal(feas_e[:, 0], feas_t)
    pair = EnsembleTorchDES([prob, prob], options=CPU).arrays
    with pytest.raises(ValueError, match="2 members"):
        TorchDES(prob, options=CPU, arrays=pair)
    with pytest.raises(ValueError, match="one problem"):
        _rate_step(pair, "cuda-round")


# ----------------------------------------------------------- the GA
def test_singleton_robust_is_delta_fast(seq_mix):
    """A 1-member ensemble under the weighted objective with refs [1] IS
    the delta-fast path: the same x and makespan."""
    dag = seq_mix[0][0]
    fast = delta_fast(dag, OPTS)
    rob = delta_robust(DagEnsemble.singleton(dag), OPTS,
                       objective="weighted", refs=[1.0])
    assert rob.makespans[0] == fast.makespan
    np.testing.assert_array_equal(rob.x, fast.x)
    assert rob.feasible


@pytest.mark.parametrize("objective", ["max-regret", "weighted"])
def test_delta_robust_matches_reference(seq_mix, objective):
    """Same seed, same options, same refs: the port's delta_robust on the
    torch ensemble DES returns the reference's topology."""
    port, ref = seq_mix
    refs = np.array([1.2, 0.9])
    want = jax_ga.delta_robust(JaxDagEnsemble(ref), JAX_OPTS,
                               objective=objective, refs=refs)
    got = delta_robust(DagEnsemble(port), OPTS, objective=objective,
                       refs=refs)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_allclose(got.makespans, want.makespans, rtol=1e-12)
    assert got.objective_value == pytest.approx(want.objective_value,
                                                rel=JAX_RTOL)
    assert got.generations == want.generations == 5
    assert got.evaluations == want.evaluations


def test_robust_objective_and_refs_validation(seq_mix):
    ens = DagEnsemble(seq_mix[0])
    with pytest.raises(ValueError, match="objective"):
        delta_robust(ens, OPTS, objective="minimax-typo")
    with pytest.raises(ValueError, match="one entry per ensemble member"):
        delta_robust(ens, OPTS, refs=[1.0])
    with pytest.raises(ValueError, match="finite positive"):
        delta_robust(ens, OPTS, refs=[1.0, float("inf")])


def test_ensemble_x_upper_bound_is_the_members_max(seq_mix):
    port, ref = seq_mix
    np.testing.assert_array_equal(
        ensemble_x_upper_bound(DagEnsemble(port)),
        jax_ga.ensemble_x_upper_bound(JaxDagEnsemble(ref)))
    space = TopologySpace.for_ensemble(DagEnsemble(port),
                                       port_limits=[4] * 4, min_circuits=0)
    assert space.g_min == 0 and (space.U == 4).all()
    with pytest.raises(ValueError, match="port_limits"):
        TopologySpace.for_ensemble(DagEnsemble(port), port_limits=[4] * 3)


# ----------------------------------------------------- the robust MILP
def test_robust_milp_weighted_tiny():
    dag_a, dag_b = _tiny((0, 1), (1, 2)), _tiny((1, 2), (0, 1))
    ens = DagEnsemble([dag_a, dag_b], names=["a", "b"])
    opts = MILPOptions(time_limit=60, mip_rel_gap=1e-3)
    res = solve_robust_milp(ens, opts, objective="weighted")
    assert res.status == "optimal"
    assert (res.x == res.x.T).all()
    U = np.asarray(ens.cluster.port_limits)
    assert (res.x.sum(axis=1) <= U).all()
    for dag_m, mres in zip(ens.members, res.members):
        assert validate_solution(dag_m, mres) == []
    assert res.objective_value == pytest.approx(
        float(ens.weights @ res.makespans), rel=1e-6)


def test_robust_milp_singleton_matches_single():
    dag = _tiny((0, 1), (1, 2))
    opts = MILPOptions(time_limit=60, mip_rel_gap=1e-3)
    single = solve_delta_milp(dag, opts)
    assert single.feasible
    rob = solve_robust_milp(DagEnsemble.singleton(dag), opts,
                            objective="weighted")
    assert rob.makespans[0] == pytest.approx(single.makespan, rel=1e-5)


def test_robust_milp_max_regret_tiny():
    """Mirror-image members: the port budget admits only one 'fat' pair,
    so the optimal max regret is exactly 2 with the other member at 1."""
    dag_a, dag_b = _tiny((0, 1), (1, 2)), _tiny((1, 2), (0, 1))
    ens = DagEnsemble([dag_a, dag_b], names=["a", "b"])
    opts = MILPOptions(time_limit=60, mip_rel_gap=1e-3)
    refs = np.array([solve_delta_milp(d, opts).makespan
                     for d in (dag_a, dag_b)])
    res = solve_robust_milp(ens, opts, objective="max-regret", refs=refs)
    assert res.status == "optimal"
    regrets = res.makespans / refs
    assert res.objective_value == pytest.approx(2.0, rel=1e-3)
    assert sorted(np.round(regrets, 3)) == [1.0, 2.0]
    with pytest.raises(ValueError, match="finite positive"):
        solve_robust_milp(ens, opts, objective="max-regret",
                          refs=[1.0, 0.0])


def test_robust_milp_seed_cut_and_port_min():
    ens = DagEnsemble([_tiny((0, 1), (1, 2)), _tiny((1, 2), (0, 1))])
    base = solve_robust_milp(ens, MILPOptions(time_limit=60,
                                              mip_rel_gap=1e-3),
                             objective="weighted")
    assert base.feasible
    seeded = solve_robust_milp(
        ens, MILPOptions(time_limit=60, mip_rel_gap=1e-3, port_min=True,
                         seed_x=base.x), objective="weighted")
    assert seeded.feasible
    assert seeded.objective_value <= base.objective_value * (1 + 1e-5)
    assert seeded.total_ports <= base.total_ports


# ------------------------------------------------------------ the facade
def test_plan_ensemble(seq_mix):
    """plan() of an ensemble: the GA's refs are the members' delta-fast
    plans, the regrets are exact numpy-DES makespans over them, and the
    MILP method plans the tiny mirror pair."""
    port, _ = seq_mix
    ens = DagEnsemble(port, names=["s4k", "s16k"])
    res = plan(PlanRequest(ensemble=ens, ga_options=GAOptions(**KW),
                           des_options=CPU))
    assert isinstance(res, EnsemblePlanResult)
    assert res.method == "delta-robust" and res.objective == "max-regret"
    assert res.member_names == ["s4k", "s16k"]
    refs = [delta_fast(d, OPTS).makespan for d in port]
    np.testing.assert_array_equal(res.refs, refs)
    np.testing.assert_array_equal(res.makespans,
                                  evaluate_on_ensemble(ens, res.x))
    np.testing.assert_allclose(res.regrets, res.makespans / res.refs)
    assert res.feasible and res.worst_regret >= 1.0 - 1e-9
    tiny = DagEnsemble([_tiny((0, 1), (1, 2)), _tiny((1, 2), (0, 1))])
    milp = plan(PlanRequest(ensemble=tiny, method="delta-robust-milp",
                            objective="weighted", des_options=CPU,
                            milp_options=MILPOptions(time_limit=60,
                                                     mip_rel_gap=1e-3)))
    assert milp.method == ROBUST_METHODS[1] and milp.feasible
    assert milp.details["milp_status"] == "optimal"
    with pytest.raises(ValueError, match="unknown method"):
        plan(PlanRequest(ensemble=tiny, method="delta-fast",
                         des_options=CPU))
    with pytest.raises(ValueError, match="unknown objective"):
        plan(PlanRequest(ensemble=tiny, objective="nope", des_options=CPU))


def test_plan_delta_robust_on_a_dag_is_delta_fast(seq_mix):
    dag = seq_mix[0][0]
    rob = plan(PlanRequest(dag=dag, method="delta-robust",
                           ga_options=GAOptions(**KW), des_options=CPU))
    fast = plan(PlanRequest(dag=dag, method="delta-fast",
                            ga_options=GAOptions(**KW), des_options=CPU))
    np.testing.assert_array_equal(rob.x, fast.x)
    assert rob.makespan == fast.makespan and rob.nct == fast.nct


@pytest.fixture(scope="module")
def milp_mixes():
    """The robust MILP's ensembles in both packages: the mirror pair, and
    gpt-7b with one microbatch at 4,096 and 16,384 tokens (members that
    differ in their volumes and their pruning windows)."""
    pairs = ((0, 1), (1, 2)), ((1, 2), (0, 1))
    jobs = ((1, {}), (1, {"micro_tokens": 16384}))
    return {
        "mirror": (DagEnsemble([_tiny(*p) for p in pairs]),
                   JaxDagEnsemble([_tiny(*p, pkg=JAX_DAG) for p in pairs])),
        "gpt7b-mb1": (
            DagEnsemble([build_comm_dag(port_job(mb, **kw))
                         for mb, kw in jobs]),
            JaxDagEnsemble([jax_build_comm_dag(gpt7b_job(mb, **kw))
                            for mb, kw in jobs]))}


# (mix, objective, refs, options): a seeded case starts from the
# unseeded optimum's x, as tests/test_robust.py does, so its objective cut
# binds (a seed re-profiles gpt-7b's windows, and HiGHS then takes ~4x as
# long there)
ROBUST_MILP_CASES = [
    ("mirror", "weighted", None, dict(mip_rel_gap=1e-3)),
    ("mirror", "max-regret", (0.1, 0.1), dict(mip_rel_gap=1e-3)),
    ("mirror", "weighted", None, dict(mip_rel_gap=1e-3, seed=True,
                                      port_min=True)),
    ("mirror", "max-regret", (0.1, 0.1), dict(mip_rel_gap=1e-3, seed=True,
                                              port_min=True)),
    ("gpt7b-mb1", "weighted", None, dict(mip_rel_gap=0.05)),
    ("gpt7b-mb1", "max-regret", (0.6, 2.4), dict(mip_rel_gap=1e-3,
                                                 port_min=True)),
]


@pytest.mark.parametrize(
    "mix,objective,refs,kw", ROBUST_MILP_CASES,
    ids=[f"{m}-{o}" + "-seed" * ("seed" in k) + "-portmin" * ("port_min" in k)
         for m, o, _, k in ROBUST_MILP_CASES])
def test_robust_milp_matches_reference(milp_mixes, mix, objective, refs,
                                       kw):
    """One shared-x robust MILP solve of each package on the same
    ensemble: the union bound, the shared topology, the objective (with
    the max-regret epigraph and its tie-break), the seed's objective cut
    and the port-minimising second phase all give the reference's
    status, x and member makespans."""
    port, ref = milp_mixes[mix]
    kw = dict(kw)
    if kw.pop("seed", False):
        kw["seed_x"] = jax_milp.solve_robust_milp(
            ref, jax_milp.MILPOptions(time_limit=600,
                                      mip_rel_gap=kw["mip_rel_gap"]),
            objective=objective, refs=refs).x
    got = solve_robust_milp(port, MILPOptions(time_limit=600, **kw),
                            objective=objective, refs=refs)
    want = jax_milp.solve_robust_milp(
        ref, jax_milp.MILPOptions(time_limit=600, **kw),
        objective=objective, refs=refs)
    assert got.status == want.status == "optimal"
    np.testing.assert_array_equal(got.x, want.x)
    assert got.total_ports == want.total_ports
    np.testing.assert_allclose(got.makespans, want.makespans, rtol=1e-9)
    assert got.objective_value == pytest.approx(want.objective_value,
                                                rel=1e-9)
    assert ("phase2" in got.stats) == ("phase2" in want.stats) \
        == bool(kw.get("port_min"))
    assert got.stats["K"] == want.stats["K"]
    for dag_p, dag_r, m_got, m_want in zip(port.members, ref.members,
                                           got.members, want.members):
        np.testing.assert_array_equal(m_got.x, got.x)
        np.testing.assert_allclose(m_got.t, m_want.t, rtol=1e-9)
        assert validate_solution(dag_p, m_got) == []
        assert jax_milp.validate_solution(dag_r, m_got) == []
