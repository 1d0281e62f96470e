"""Surplus-port reallocation engine (paper Sec. VI, Fig. 10).

Port-minimized DELTA plans free >= 20% of a tenant's fair-share ports; this
module waterfills that surplus across bandwidth-bottlenecked co-tenants and
re-optimizes each boosted tenant's topology.

Two deliberately cheap mechanisms replace a full re-solve:

  * `waterfill_grants` -- max-min fair progressive filling of the per-pod
    surplus pool over tenant demands.  The inner used/denominator reductions
    are the same fused matvec pair as the DES fair-share loop, so they run
    through `repro_torch.kernels.ops.fill_matvec` (the Hopper kernel on a
    CUDA device, its plain version on the CPU) whenever there is more than
    one item to fill.

  * `reallocate` -- generates a portfolio of boosted candidate genomes
    (traffic-weighted, concentrated, round-robin, randomized) over the
    active pod pairs and evaluates the *whole portfolio* in ONE
    `TorchDES.batch_genome_makespan` call: the genome->topology scatter and
    the batched DES run on the device, so the host ships (K, E) ints
    instead of (K, P, P) matrices.  The incumbent is always candidate 0, and the
    winner is certified against the exact numpy DES, so a reallocation can
    never worsen a tenant's NCT.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.dag import CommDAG
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.xbound import x_upper_bound
from repro_torch.kernels import ops
from repro_torch.obs import get_counter

INF = float("inf")

_ROUNDS = get_counter("fleet_waterfill_rounds_total",
                      "progressive-filling rounds run by waterfill_grants")


# ------------------------------------------------------------- waterfilling
def waterfill_grants(demands: np.ndarray, supply: np.ndarray,
                     use_kernel: bool | None = None,
                     device: torch.device | str | None = None
                     ) -> np.ndarray:
    """Max-min fair integer split of per-pod surplus among tenants.

    demands: (T, P) max extra ports tenant t can exploit in pod p.
    supply:  (P,)  grantable pool ports per pod.
    Returns integer grants (T, P) with column sums <= supply and
    grants <= demands.

    With the kernel, each round's (used, denom) pair is one `fill_matvec`
    of the (P, N) item incidence and the (N, 2) [level, unfrozen] stack,
    float32 tensors on `device` (None: the CUDA device, as everywhere in
    the port; the CPU takes the kernel's plain version).  Each round adds
    one to the `fleet_waterfill_rounds_total` counter.
    """
    demands = np.asarray(demands, dtype=np.float64)
    supply = np.asarray(supply, dtype=np.float64)
    T, P = demands.shape
    if T == 0 or P == 0 or demands.sum() == 0 or supply.sum() == 0:
        return np.zeros((T, P), dtype=np.int64)

    # items = (tenant, pod) cells; constraint p sums its column cells
    demand = demands.reshape(-1)                       # (N,) N = T*P
    item_pod = np.tile(np.arange(P), T)
    N = len(demand)
    if use_kernel is None:
        use_kernel = N >= 2
    W = np.zeros((P, N))
    W[item_pod, np.arange(N)] = 1.0
    if use_kernel:
        dev = DESOptions(device=device).resolve_device()
        w = torch.as_tensor(W, dtype=torch.float32, device=dev)

    level = np.zeros(N)
    unfrozen = demand > 0
    for _ in range(N + P + 1):
        if not unfrozen.any():
            break
        _ROUNDS.inc()
        if use_kernel:
            rhs = torch.as_tensor(
                np.stack([level, unfrozen.astype(np.float64)], axis=1),
                dtype=torch.float32, device=dev)
            out = ops.fill_matvec(w, rhs).cpu().numpy()
            used, denom = out[:, 0], out[:, 1]
        else:
            used = np.bincount(item_pod, weights=level, minlength=P)
            denom = np.bincount(item_pod, weights=unfrozen.astype(float),
                                minlength=P)
        slack = np.maximum(supply - used, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_pod = np.where(denom > 0, slack / np.maximum(denom, 1e-300),
                                 INF)
        alpha_item = np.where(unfrozen, demand - level, INF)
        alpha = min(float(alpha_pod.min()), float(alpha_item.min()))
        if not np.isfinite(alpha):
            break
        level = np.where(unfrozen, level + alpha, level)
        pod_sat = alpha_pod <= alpha * (1 + 1e-12) + 1e-12
        unfrozen &= ~(pod_sat[item_pod]) & (level < demand - 1e-12)
        if alpha <= 0 and not pod_sat.any():   # pragma: no cover
            break

    # integerize: floor, then hand out each pod's remaining whole ports to
    # the cells with the largest fractional part (and demand headroom)
    grants = np.floor(level + 1e-9).astype(np.int64)
    frac = level - grants
    demand_i = demands.astype(np.int64).reshape(-1)
    grants = np.minimum(grants, demand_i)
    for p in range(P):
        cells = np.nonzero(item_pod == p)[0]
        left = int(supply[p]) - int(grants[cells].sum())
        for i in cells[np.argsort(-frac[cells])]:
            if left <= 0:
                break
            if grants[i] < demand_i[i]:
                grants[i] += 1
                left -= 1
    return grants.reshape(T, P)


def circuit_changes(x_new: np.ndarray, x_old: np.ndarray) -> int:
    """Circuits the OCS must tear down or set up to move between plans."""
    d = np.abs(np.asarray(x_new, np.int64) - np.asarray(x_old, np.int64))
    return int(np.triu(d, k=1).sum())


def plane_circuit_changes(planes_new: np.ndarray,
                          planes_old: np.ndarray) -> np.ndarray:
    """Per-plane rewire sizes between two (k, P, P) lane decompositions:
    entry p is the `circuit_changes` of plane p alone, i.e. the work (and
    dark time) of that plane's step in a staggered transition."""
    a = np.asarray(planes_new, np.int64)
    b = np.asarray(planes_old, np.int64)
    if a.shape != b.shape or a.ndim != 3:
        raise ValueError(f"plane stacks disagree: {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    return np.triu(d, k=1).sum(axis=(1, 2)).astype(np.int64)


def _edge_arrays(pairs) -> tuple[np.ndarray, np.ndarray]:
    earr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return earr[:, 0], earr[:, 1]


def port_demand(dag: CommDAG, x: np.ndarray,
                xbar: np.ndarray | None = None) -> np.ndarray:
    """Max useful extra ports per local pod: beyond the Alg. 2 concurrency
    bound X̄ extra circuits cannot raise any task's rate."""
    if xbar is None:
        xbar = x_upper_bound(dag)
    want = np.zeros(dag.cluster.num_pods, dtype=np.int64)
    pairs = dag.undirected_pairs()
    if not pairs:
        return want
    eu, ev = _edge_arrays(pairs)
    extra = np.maximum(np.asarray(xbar)[eu, ev].astype(np.int64)
                       - np.asarray(x)[eu, ev].astype(np.int64), 0)
    np.add.at(want, eu, extra)
    np.add.at(want, ev, extra)
    return want


# ------------------------------------------------------- candidate topologies
def _greedy_fill(g0: np.ndarray, usage0: np.ndarray, limits: np.ndarray,
                 eu: np.ndarray, ev: np.ndarray, weight_fn,
                 max_add: int | None = None) -> np.ndarray:
    """Add circuits one at a time to the heaviest addable pair.

    Genome-array form: `g0` is the (E,) circuit vector over the undirected
    pairs (eu, ev), `usage0` the per-pod ports already consumed outside the
    genome, and `weight_fn(g) -> (E,)` the current per-pair weights (-inf
    marks pairs a strategy never fills).  Each step is one vectorized
    argmax instead of a Python scan over pairs."""
    g = g0.copy()
    usage = usage0.copy()
    np.add.at(usage, eu, g)
    np.add.at(usage, ev, g)
    added = 0
    while max_add is None or added < max_add:
        addable = (usage[eu] < limits[eu]) & (usage[ev] < limits[ev])
        w = np.where(addable, weight_fn(g), -INF)
        e = int(np.argmax(w))
        if not np.isfinite(w[e]):
            break
        g[e] += 1
        usage[eu[e]] += 1
        usage[ev[e]] += 1
        added += 1
    return g


def _candidate_genomes(dag: CommDAG, g0: np.ndarray, usage0: np.ndarray,
                       limits: np.ndarray, eu: np.ndarray, ev: np.ndarray,
                       rng: np.random.Generator,
                       num_random: int = 8) -> np.ndarray:
    """Portfolio of boosted genomes within per-pod `limits`; row 0 is
    always `g0` itself, so the portfolio minimum can never be worse than
    the incumbent."""
    vol = dag.traffic_matrix()
    uvol = vol[eu, ev] + vol[ev, eu]
    cands = [g0.copy()]
    # (a) per-circuit volume: relieve the most oversubscribed pair first
    cands.append(_greedy_fill(g0, usage0, limits, eu, ev,
                              lambda g: uvol / np.maximum(g, 1)))
    # (b) concentrated: everything to the single heaviest pair
    hot = np.where(np.arange(len(eu)) == int(np.argmax(uvol)), 1.0, -INF)
    cands.append(_greedy_fill(g0, usage0, limits, eu, ev, lambda g: hot))
    # (c) round-robin: spread evenly (least-loaded pair first)
    cands.append(_greedy_fill(g0, usage0, limits, eu, ev,
                              lambda g: -g.astype(np.float64)))
    # (d) randomized greedy fills
    for _ in range(num_random):
        jitter = rng.random(len(eu))
        cands.append(_greedy_fill(g0, usage0, limits, eu, ev,
                                  lambda g: jitter * uvol / np.maximum(g, 1)))
    G = np.stack(cands)
    # vectorized dedup, keeping first occurrences (incumbent stays row 0)
    _, first = np.unique(G, axis=0, return_index=True)
    return G[np.sort(first)]


def _scatter(g: np.ndarray, eu: np.ndarray, ev: np.ndarray,
             P: int) -> np.ndarray:
    x = np.zeros((P, P), dtype=np.int64)
    x[eu, ev] = g
    x[ev, eu] = g
    return x


def _genome_view(x0: np.ndarray, pairs, P: int):
    """Split a topology into (eu, ev, genome, rem): the active-pair circuit
    vector plus the off-pair remainder `rem` (circuits on pairs without
    traffic, preserved verbatim through candidate generation)."""
    eu, ev = _edge_arrays(pairs)
    g0 = np.asarray(x0)[eu, ev].astype(np.int64)
    rem = np.asarray(x0) - _scatter(g0, eu, ev, P)
    return eu, ev, g0, rem


def candidate_boosts(dag: CommDAG, x0: np.ndarray, limits: np.ndarray,
                     rng: np.random.Generator,
                     num_random: int = 8) -> np.ndarray:
    """Portfolio of boosted topologies within per-pod `limits` (matrix
    view of `_candidate_genomes`; candidate 0 is always `x0`)."""
    pairs = dag.undirected_pairs()
    if not pairs:
        return np.asarray(x0)[None].copy()
    P = dag.cluster.num_pods
    eu, ev, g0, rem = _genome_view(x0, pairs, P)
    G = _candidate_genomes(dag, g0, rem.sum(axis=1),
                           np.asarray(limits, np.int64),
                           eu, ev, rng, num_random=num_random)
    return np.stack([_scatter(g, eu, ev, P) + rem for g in G])


# ------------------------------------------------------------- reallocation
@dataclass
class ReallocResult:
    x: np.ndarray
    makespan: float
    comm_time: float
    nct: float
    improved: bool
    num_candidates: int
    batch_calls: int = 1
    details: dict = field(default_factory=dict)


def reallocate(dag: CommDAG, x0: np.ndarray, boosted_limits: np.ndarray,
               ideal_comm_time: float, des=None,
               rng: np.random.Generator | None = None,
               num_random: int = 8,
               base_makespan: float | None = None,
               base_comm_time: float | None = None,
               mask: np.ndarray | None = None,
               dwell_s: float | None = None,
               reconfig_s_per_circuit: float = 0.0,
               des_options: DESOptions | None = None) -> ReallocResult:
    """Re-optimize one tenant's topology under boosted port limits.

    All candidate genomes are scored by a single
    `TorchDES.batch_genome_makespan` call on `des` (None: a `TorchDES`
    built here with `des_options` and `warn_on_miss`); the winner is
    certified with the exact numpy DES and only accepted if it does not
    worsen the tenant's communication time.
    Pass `base_makespan`/`base_comm_time` (the incumbent's known exact
    quality, e.g. from the committed plan) to skip re-simulating `x0`.
    With `mask` (a (P, P) fabric availability factor), every evaluation --
    batch scoring, base and certification sims -- runs at degraded
    capacity, so grants to a tenant on a damaged fabric are priced against
    the fabric it actually has.
    With `dwell_s` (the tenant's expected remaining phase dwell) and a
    positive `reconfig_s_per_circuit`, an improving winner must also clear
    the reconfiguration break-even: the comm time it saves over the dwell,
    `dwell_s * (1 - comm_new / comm_base)`, must cover the rewiring delay
    `changed_circuits * reconfig_s_per_circuit` -- otherwise the boost is
    declined (`details["rejected"] = "break_even"`).
    """

    def _sim(x):
        xe = np.asarray(x, dtype=np.float64)
        return simulate(problem, xe * mask if mask is not None else xe)

    rng = rng or np.random.default_rng(0)
    problem = DESProblem(dag)
    pairs = dag.undirected_pairs()
    if not pairs:
        if base_makespan is None or base_comm_time is None:
            base = _sim(x0)
            base_makespan, base_comm_time = base.makespan, base.comm_time
        nct = base_comm_time / ideal_comm_time if ideal_comm_time > 0 else INF
        return ReallocResult(x=np.asarray(x0).copy(), makespan=base_makespan,
                             comm_time=base_comm_time, nct=nct,
                             improved=False, num_candidates=1, batch_calls=0)
    P = dag.cluster.num_pods
    eu, ev, g0, rem = _genome_view(x0, pairs, P)
    G = _candidate_genomes(dag, g0, rem.sum(axis=1),
                           np.asarray(boosted_limits, dtype=np.int64),
                           eu, ev, rng, num_random=num_random)
    if des is None:
        # reallocation runs inside the fleet's replanning loop: a new
        # engine-cache bucket here would repeat per surplus pass, so
        # surface it (the bucketed cache makes it a one-off per shape)
        des = TorchDES(problem, options=dataclasses.replace(
            des_options or DESOptions(), warn_on_miss=True))
    # ONE genome-scatter + batched DES call over the whole portfolio
    ms, feas = des.batch_genome_makespan(G, eu, ev, mask=mask)
    score = np.where(feas, ms, INF)
    # lexicographic tie-break: fewer total ports on ~equal makespan
    ports = 2 * G.sum(axis=1) + int(rem.sum())
    finite = score[np.isfinite(score)]
    ref = float(finite.min()) if len(finite) and finite.min() > 0 else 1.0
    rel = np.where(np.isfinite(score), np.round(score / ref, 6), INF)
    best = int(np.lexsort((ports, rel))[0])

    if base_makespan is None or base_comm_time is None:
        base = _sim(x0)
        base_makespan, base_comm_time = base.makespan, base.comm_time
    makespan, comm_time = base_makespan, base_comm_time
    x_best = _scatter(G[best], eu, ev, P) + rem
    details = {"scores_finite": int(np.isfinite(score).sum())}
    if best != 0:
        cand = _sim(x_best)                       # certify the winner
        accept = cand.feasible \
            and cand.comm_time <= base_comm_time * (1 + 1e-9)
        if accept and dwell_s is not None and reconfig_s_per_circuit > 0:
            # break-even gate: rewiring for the boost must pay for itself
            # within the tenant's expected remaining dwell
            delay = circuit_changes(x_best, x0) * reconfig_s_per_circuit
            if np.isfinite(base_comm_time) and base_comm_time > 0 \
                    and np.isfinite(cand.comm_time):
                saved = dwell_s * (1.0 - cand.comm_time / base_comm_time)
            else:
                saved = INF
            if saved < delay:
                accept = False
                details["rejected"] = "break_even"
                details["delay_s"] = float(delay)
                details["saved_s"] = float(saved)
        if accept:
            makespan, comm_time = cand.makespan, cand.comm_time
        else:
            best = 0                              # never worsen the tenant
            x_best = _scatter(G[0], eu, ev, P) + rem
    nct = comm_time / ideal_comm_time if ideal_comm_time > 0 else INF
    return ReallocResult(
        x=x_best, makespan=makespan, comm_time=comm_time,
        nct=nct, improved=best != 0, num_candidates=len(G),
        details=details)
