"""DELTA-Fast: DES-accelerated domain-adapted genetic algorithm
(paper Sec. IV-B, Algs. 3, 5, 6) -- population-array-resident engine.

The port of `repro/core/ga.py`: the single-DAG path (`delta_fast`), its
ensemble engines (`delta_robust`: one topology for the members of a
`DagEnsemble`; `delta_failsafe`: one topology under fabric-failure
scenarios; `delta_planes`: one robust topology split across k OCS planes,
scored on every one-plane-dark fabric state), which score genomes x
members in one batched call of `EnsembleTorchDES`, and the greedy port
trimming sweeps (`trim_ports`, `trim_ports_ensemble`).  Genome = integer
circuit counts over the active undirected pod pairs, bounded by the Alg. 2
capacity bounds X̄ and repaired against the physical port budgets U.
Fitness = DES makespan (primary) and total allocated circuits (secondary,
lexicographic tie-break exploiting O4's port saving).

The search loop stays host-side numpy, exactly as in the reference (the
same `Generator` stream gives the same populations); fitness is one fused
genome->topology scatter + batched DES call per generation on the device
(`TorchDES.batch_genome_makespan`), padded to a fixed batch shape.  A
vectorized `np.unique` dedup backed by a bytes-keyed cache keeps duplicate
genomes away from the simulator entirely.

Fitness backends:
  'numpy' -- repro_torch.core.des.simulate per unique candidate
  'torch' -- repro_torch.core.des_torch batched evaluation on the device
  'auto'  -- torch for DAGs of at most `device_task_limit` tasks, numpy
             beyond.
"""
from __future__ import annotations

import itertools
import time
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dag import CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import (DESOptions, EnsembleTorchDES,
                                        TorchDES, plane_state_genomes)
from repro_torch.core.xbound import x_upper_bound
from repro_torch.obs import get_counter, span

_GENERATIONS = get_counter(
    "ga_generations_total", "GA generations executed")
_EVALUATIONS = get_counter(
    "ga_fitness_evaluations_total",
    "unique genomes scored by the DES (cache misses)")

INF = float("inf")


class InfeasiblePlacement(ValueError):
    """A pod has more active pairs than ports: no topology with one circuit
    per active pair fits its budget.  The fleet degrades on this error
    alone (a robust replan to a single-DAG plan, a reduced replan to a
    shrunk topology); every other error of a planning path propagates."""


# float32 relative slack for the batched-DES pre-filter in the trimming
# sweeps: accepts are always certified with the exact numpy DES, so the
# filter margin only guards against false *negatives*
_TRIM_FILTER_SLACK = 1e-3
# candidates the float32 filter rejected by more than this relative band
# are not exact-rechecked on termination: the engines agree to ~1e-5 on
# the equivalence suites, so a >5% f32 overshoot of an exactly-acceptable
# drop would need an f32 fair-share freeze flip with outsized schedule
# impact.  If one ever occurs, the cost is bounded -- the sweep retains
# ports it could have dropped; an accepted drop is always numpy-certified,
# so the makespan budget is never violated either way.
_TRIM_BACKSTOP_BAND = 5e-2
TRIM_BACKENDS = ("auto", "torch", "numpy")


def _trim_filter_bands(ms: np.ndarray, feas: np.ndarray, budgets
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(fits, near) f32 pre-filter bands shared by the trimming sweeps.

    `fits` passes the conservative accept filter; `near` is the ambiguous
    band exact-rechecked before termination.  f32-infeasible rows stay in
    the ambiguous band: the band bounds makespan divergence only, not a
    feasibility misjudgment (rare, and cheap to recheck exactly).
    Elementwise -- the ensemble sweep reduces across members afterwards.
    """
    fits = feas & (ms <= budgets * (1 + _TRIM_FILTER_SLACK) + 1e-12)
    near = ~feas | (ms <= budgets * (1 + _TRIM_BACKSTOP_BAND) + 1e-12)
    return fits, near


@dataclass
class GAOptions:
    pop_size: int = 48
    max_generations: int = 400
    patience: int = 60            # stop after N gens without improvement
    elite_frac: float = 0.15
    tournament: int = 3
    crossover_rate: float = 0.9
    mutation_rate: float = 0.25   # per-gene probability of a +/-1 step
    seed: int = 0
    backend: str = "auto"         # numpy | torch | auto
    device_task_limit: int = 1200
    time_limit: float = 120.0
    port_weight: float = 1e-9     # lexicographic secondary objective
    # engine knobs for the torch DES (device, kernel backend, buckets);
    # None is DESOptions(): the CUDA device and its kernel
    des_options: DESOptions | None = None


@dataclass
class GAResult:
    x: np.ndarray
    makespan: float
    generations: int
    evaluations: int
    elapsed: float
    history: list[float] = field(default_factory=list)
    feasible: bool = True

    @property
    def total_ports(self) -> int:
        return int(self.x.sum())


class TopologySpace:
    """Genome <-> symmetric topology matrix mapping + Algs. 5/6.

    All hot-path operations take whole populations: genomes are rows of a
    (S, E) int array and every transform below is a single numpy expression
    over that array (incidence matvecs, fancy-indexed scatters).
    """

    def __init__(self, dag: CommDAG, xbar: np.ndarray | None = None):
        self.dag = dag
        xbar_m = np.asarray(xbar if xbar is not None else x_upper_bound(dag))
        self._setup(dag.cluster, dag.undirected_pairs(), xbar_m)

    @classmethod
    def for_ensemble(cls, ensemble: DagEnsemble,
                     xbar: np.ndarray | None = None, *,
                     port_limits: Sequence[int] | None = None,
                     min_circuits: int = 1) -> "TopologySpace":
        """Search space over the *union* of the members' active pairs.

        Per-pair capacity bound: the member-wise max of the Alg. 2 bounds
        (a circuit count useful to any member must stay reachable).

        `port_limits` overrides the cluster's per-pod budgets -- the
        k-plane decomposition searches sub-fabrics (a subset of each pod's
        ports) over the same pair space.  `min_circuits=0` admits empty
        pairs, which a *supplementary* plane needs (its lane only tops up
        pairs the base planes already connect)."""
        obj = cls.__new__(cls)
        obj.dag = None
        xbar_m = np.asarray(xbar if xbar is not None
                            else ensemble_x_upper_bound(ensemble))
        obj._setup(ensemble.cluster, ensemble.undirected_pairs(), xbar_m,
                   port_limits=port_limits, min_circuits=min_circuits)
        return obj

    def _setup(self, cluster, edges: list[tuple[int, int]],
               xbar_m: np.ndarray, *,
               port_limits: Sequence[int] | None = None,
               min_circuits: int = 1) -> None:
        self.P = cluster.num_pods
        self.U = np.asarray(port_limits if port_limits is not None
                            else cluster.port_limits, dtype=np.int64)
        if self.U.shape != (self.P,):
            raise ValueError(f"port_limits needs {self.P} entries, "
                             f"got shape {self.U.shape}")
        if min_circuits not in (0, 1):
            raise ValueError(f"min_circuits must be 0 or 1, "
                             f"got {min_circuits}")
        self.g_min = int(min_circuits)
        self.edges = edges
        self.E = len(self.edges)
        earr = np.asarray(self.edges, dtype=np.int64).reshape(-1, 2)
        self.edge_u = earr[:, 0]
        self.edge_v = earr[:, 1]
        self.xbar = np.maximum(
            self.g_min,
            np.minimum(xbar_m[self.edge_u, self.edge_v].astype(np.int64),
                       np.minimum(self.U[self.edge_u],
                                  self.U[self.edge_v])))
        # pod x edge incidence (each edge touches exactly two pods)
        self.inc = np.zeros((self.P, self.E), dtype=np.int64)
        self.inc[self.edge_u, np.arange(self.E)] = 1
        self.inc[self.edge_v, np.arange(self.E)] = 1
        self.degree = self.inc.sum(axis=1)
        # quick feasibility: connectivity needs one port per incident edge
        # (moot when empty pairs are admitted)
        if self.g_min > 0 and (self.degree > self.U).any():
            p = int(np.argmax(self.degree - self.U))
            raise InfeasiblePlacement(
                f"pod {p} has {int(self.degree[p])} active pairs but "
                f"only {self.U[p]} ports; placement is infeasible")

    # ------------------------------------------------------ genome <-> matrix
    def genome_of(self, x: np.ndarray) -> np.ndarray:
        """Project a (P, P) topology matrix onto the active-pair genome."""
        return np.asarray(x)[self.edge_u, self.edge_v].astype(np.int64)

    def to_matrix_batch(self, genomes: np.ndarray) -> np.ndarray:
        """(S, E) genomes -> (S, P, P) symmetric topologies in one scatter."""
        G = np.asarray(genomes, dtype=np.int64).reshape(-1, self.E)
        X = np.zeros((len(G), self.P, self.P), dtype=np.int64)
        X[:, self.edge_u, self.edge_v] = G
        X[:, self.edge_v, self.edge_u] = G
        return X

    def to_matrix(self, genome: np.ndarray) -> np.ndarray:
        return self.to_matrix_batch(np.asarray(genome)[None])[0]

    # ------------------------------------------------------------ feasibility
    def port_usage_batch(self, genomes: np.ndarray) -> np.ndarray:
        """(S, E) genomes -> (S, P) ports used per pod (incidence matvec)."""
        return np.asarray(genomes, dtype=np.int64).reshape(-1, self.E) \
            @ self.inc.T

    def port_usage(self, genome: np.ndarray) -> np.ndarray:
        return self.port_usage_batch(np.asarray(genome)[None])[0]

    def is_feasible_batch(self, genomes: np.ndarray) -> np.ndarray:
        G = np.asarray(genomes, dtype=np.int64).reshape(-1, self.E)
        return ((G >= self.g_min).all(axis=1) & (G <= self.xbar).all(axis=1)
                & (self.port_usage_batch(G) <= self.U).all(axis=1))

    def is_feasible(self, genome: np.ndarray) -> bool:
        return bool(self.is_feasible_batch(np.asarray(genome)[None])[0])

    # ---------------------------------------------------------------- Alg. 5
    def random_init_batch(self, rng: np.random.Generator,
                          size: int) -> np.ndarray:
        """Feasible random population: uniform in [1, X̄] then batched
        Alg. 6 repair.  Repair always succeeds here: the constructor
        guarantees degree <= U, and any over-budget pod necessarily has an
        incident edge with g > 1 to reduce."""
        if self.E == 0:
            return np.zeros((size, 0), dtype=np.int64)
        G = rng.integers(self.g_min, self.xbar + 1, size=(size, self.E),
                         dtype=np.int64)
        return self.repair_batch(G, rng)[0]

    def feasible_random_init(self, rng: np.random.Generator) -> np.ndarray:
        return self.random_init_batch(rng, 1)[0]

    # ---------------------------------------------------------------- Alg. 6
    def repair_batch(self, genomes: np.ndarray, rng: np.random.Generator
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Whole-population repair: clip to [1, X̄], then per round every
        over-budget pod of every genome drops one circuit from a random
        reducible incident edge (all genomes and pods act simultaneously;
        total over-usage strictly decreases each round, so the loop is
        bounded by the initial excess).  Returns (repaired, ok) where ok[s]
        marks genomes whose port budgets are satisfied."""
        G = np.clip(np.asarray(genomes, dtype=np.int64).reshape(-1, self.E),
                    self.g_min, self.xbar)
        S = len(G)
        if self.E == 0 or S == 0:
            return G, np.ones(S, dtype=bool)
        inc_b = self.inc.astype(bool)
        rounds = int(self.xbar.sum()) - self.E + 1
        for _ in range(max(rounds, 1)):
            over = self.port_usage_batch(G) > self.U        # (S, P)
            viol = np.nonzero(over.any(axis=1))[0]
            if len(viol) == 0:
                break
            Gv, overv = G[viol], over[viol]
            keys = rng.random((len(viol), self.E))
            cand = overv[:, :, None] & inc_b[None] \
                & (Gv > self.g_min)[:, None, :]
            masked = np.where(cand, keys[:, None, :], -1.0)  # (V, P, E)
            e_star = masked.argmax(axis=2)                   # (V, P)
            valid = masked.max(axis=2) >= 0.0                # (V, P)
            if not valid.any():
                break
            dec = np.zeros_like(Gv)
            s_idx, p_idx = np.nonzero(valid)
            np.add.at(dec, (s_idx, e_star[s_idx, p_idx]), 1)
            G[viol] = np.maximum(Gv - dec, self.g_min)
        return G, (self.port_usage_batch(G) <= self.U).all(axis=1)

    def repair(self, genome: np.ndarray, rng: np.random.Generator
               ) -> tuple[np.ndarray, bool]:
        G, ok = self.repair_batch(np.asarray(genome)[None], rng)
        return G[0], bool(ok[0])


class _CachedFitness:
    """Shared population-fitness plumbing for the single-DAG and ensemble
    engines: vectorized `np.unique` dedup backed by a bytes-keyed score
    cache, fixed-shape padding (a multiple of `pop_size`, so every
    generation is one batch of the same shape with O(1) host<->device
    transfers), and the lexicographic port penalty.  Subclasses provide
    `_raw_scores` mapping unique (S, E) genomes to makespan-like scores
    (lower is better, INF marks infeasible)."""

    def __init__(self, space: TopologySpace, opts: GAOptions, n_tasks: int):
        self.space = space
        self.opts = opts
        self.cache: dict[bytes, float] = {}
        self.evaluations = 0
        self.batch_calls = 0
        self._use_device = opts.backend == "torch" or (
            opts.backend == "auto" and n_tasks <= opts.device_task_limit)
        self._pad = max(int(opts.pop_size), 1)

    def _padded(self, genomes: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad to the fixed batch shape; extra lanes are near-free on the
        batched event loop, whose cost is the max-lane trip count."""
        k = len(genomes)
        pad = (-k) % self._pad
        if pad:
            genomes = np.concatenate(
                [genomes, np.repeat(genomes[:1], pad, axis=0)])
        return genomes, k

    def _raw_scores(self, genomes: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, population: np.ndarray) -> np.ndarray:
        G = np.ascontiguousarray(
            np.asarray(population, dtype=np.int64).reshape(-1, self.space.E))
        uniq, inv = np.unique(G, axis=0, return_inverse=True)
        inv = np.asarray(inv).reshape(-1)   # numpy 2.x inverse-shape drift
        keys = [row.tobytes() for row in uniq]
        miss = [i for i, key in enumerate(keys) if key not in self.cache]
        if miss:
            self.evaluations += len(miss)
            _EVALUATIONS.inc(len(miss))
            with span("ga.fitness_batch", pop=len(G), unique=len(uniq),
                      misses=len(miss)):
                vals = self._raw_scores(uniq[miss])
            sums = uniq[miss].sum(axis=1)
            for i, v, s in zip(miss, vals, sums):
                score = float(v)
                if np.isfinite(score):
                    score += self.opts.port_weight * float(s)
                self.cache[keys[i]] = score
        return np.array([self.cache[k] for k in keys])[inv]


class BatchedFitness(_CachedFitness):
    """Single-DAG fitness: one fused genome-scatter + batched DES call per
    generation on the torch backend (`TorchDES.batch_genome_makespan`).
    Building the engine is not guarded: a device or kernel that fails
    raises here."""

    def __init__(self, dag: CommDAG, space: TopologySpace, opts: GAOptions):
        self.problem = DESProblem(dag)
        super().__init__(space, opts, self.problem.n)
        self._des = None
        if self._use_device and space.E > 0:
            self._des = TorchDES(self.problem, options=opts.des_options)

    def _raw_makespans(self, genomes: np.ndarray) -> np.ndarray:
        """Makespan (INF if infeasible) for each unique genome row."""
        if self._des is not None:
            genomes, k = self._padded(genomes)
            ms, feas = self._des.batch_genome_makespan(
                genomes, self.space.edge_u, self.space.edge_v)
            self.batch_calls += 1
            return np.where(feas, ms, INF)[:k]
        return np.array([simulate(self.problem, x).makespan
                         for x in self.space.to_matrix_batch(genomes)])

    _raw_scores = _raw_makespans


def _tournament_batch(fitness: np.ndarray, rng: np.random.Generator,
                      num: int, k: int) -> np.ndarray:
    """`num` independent k-way tournaments over the population, at once."""
    idx = rng.integers(0, len(fitness), size=(num, k))
    return idx[np.arange(num), np.argmin(fitness[idx], axis=1)]


def _variation_batch(pop: np.ndarray, fitness: np.ndarray,
                     space: TopologySpace, opts: GAOptions,
                     rng: np.random.Generator, num: int) -> np.ndarray:
    """Selection + uniform crossover + ±1 mutation for `num` children,
    as whole-population array ops (no per-genome loops)."""
    pa = _tournament_batch(fitness, rng, num, opts.tournament)
    pb = _tournament_batch(fitness, rng, num, opts.tournament)
    A, B = pop[pa], pop[pb]
    cross = rng.random(num) < opts.crossover_rate
    take_b = rng.random((num, space.E)) < 0.5
    children = np.where(cross[:, None] & take_b, B, A)
    mut = rng.random((num, space.E)) < opts.mutation_rate
    step = rng.integers(0, 2, size=(num, space.E)) * 2 - 1
    return np.clip(children + np.where(mut, step, 0), space.g_min,
                   space.xbar)


def _evolve(space: TopologySpace, fit, opts: GAOptions,
            rng: np.random.Generator, t0: float,
            seeds: list[np.ndarray] | None = None
            ) -> tuple[np.ndarray, float, list[float], int]:
    """The shared GA loop (Alg. 3 body): init + repair + generational
    loop, fitness-agnostic.  `fit` maps a (S, E) population to (S,) scores
    (lower is better).  It consumes the `Generator` exactly as the
    reference's `_evolve`, so equal scores give equal populations.
    Returns (best_g, best_f, history, gen)."""
    pop = space.random_init_batch(rng, opts.pop_size)
    # seed candidates (e.g. baselines) -- repaired into the population
    for s in (seeds or []):
        g, ok = space.repair(space.genome_of(s), rng)
        if ok:
            pop[rng.integers(len(pop))] = g
    fitness = fit(pop)
    best_i = int(np.argmin(fitness))
    best_g, best_f = pop[best_i].copy(), float(fitness[best_i])
    history = [best_f]
    n_elite = max(1, int(opts.elite_frac * opts.pop_size))
    num_children = opts.pop_size - n_elite
    stall = 0
    gen = 0

    for gen in range(1, opts.max_generations + 1):
        if time.time() - t0 > opts.time_limit or stall >= opts.patience:
            break
        with span("ga.generation", gen=gen, pop=opts.pop_size):
            order = np.argsort(fitness, kind="stable")
            elite = pop[order[:n_elite]]
            children = _variation_batch(pop, fitness, space, opts, rng,
                                        num_children)
            children, _ = space.repair_batch(children, rng)
            pop = np.concatenate([elite, children], axis=0)
            fitness = fit(pop)
        _GENERATIONS.inc()
        i = int(np.argmin(fitness))
        if fitness[i] < best_f - 1e-15:
            best_f, best_g = float(fitness[i]), pop[i].copy()
            stall = 0
        else:
            stall += 1
        history.append(best_f)
    return best_g, best_f, history, gen


def _exact_rerank(fit: _CachedFitness, best_g: np.ndarray,
                  score_of: Callable[[np.ndarray], float],
                  port_weight: float, top: int = 8) -> np.ndarray:
    """The winner among the `top` best distinct cached genomes, re-ranked
    by `score_of` (the exact numpy DES; the batched torch fitness runs in
    float32, with ~1e-5 ranking noise) plus the port penalty; `best_g`
    when none of them scores finite.  One `ga.rerank` span, whichever GA
    flavour calls it."""
    with span("ga.rerank", top=top) as sp:
        ranked = sorted(fit.cache.items(), key=lambda kv: kv[1])[:top]
        best_key, best_score = best_g.tobytes(), INF
        scored = 0
        for key, fval in ranked:
            if not np.isfinite(fval):
                continue
            g = np.frombuffer(key, dtype=np.int64)
            score = score_of(g)
            scored += 1
            if np.isfinite(score):
                score += port_weight * float(g.sum())
            if score < best_score:
                best_score, best_key = score, key
        sp.set(scored=scored)
    return np.frombuffer(best_key, dtype=np.int64)


def delta_fast(dag: CommDAG, opts: GAOptions | None = None,
               xbar: np.ndarray | None = None,
               seeds: list[np.ndarray] | None = None) -> GAResult:
    """Alg. 3: SimBasedDomainAdaptedGA (population-array-resident)."""
    opts = opts or GAOptions()
    rng = np.random.default_rng(opts.seed)
    space = TopologySpace(dag, xbar)
    fit = BatchedFitness(dag, space, opts)
    t0 = time.time()

    if space.E == 0:    # no inter-pod traffic: the empty topology is optimal
        x = np.zeros((space.P, space.P), dtype=np.int64)
        ms = simulate(fit.problem, x).makespan
        return GAResult(x=x, makespan=float(ms), generations=0,
                        evaluations=1, elapsed=time.time() - t0,
                        history=[float(ms)], feasible=np.isfinite(ms))

    with span("ga.evolve", kind="delta_fast", pop=opts.pop_size,
              edges=space.E):
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0, seeds)

    best_x = space.to_matrix(_exact_rerank(
        fit, best_g,
        lambda g: simulate(fit.problem, space.to_matrix(g)).makespan,
        opts.port_weight))
    ms = simulate(fit.problem, best_x).makespan
    return GAResult(x=best_x, makespan=float(ms), generations=gen,
                    evaluations=fit.evaluations, elapsed=time.time() - t0,
                    history=history, feasible=np.isfinite(ms))


# ------------------------------------------------------------- DELTA-Robust
ROBUST_OBJECTIVES = ("weighted", "max-regret")


def ensemble_x_upper_bound(ensemble: DagEnsemble) -> np.ndarray:
    """Union-space Alg. 2 bound: elementwise max of the member bounds."""
    return np.maximum.reduce([x_upper_bound(m) for m in ensemble.members])


class EnsembleFitness(_CachedFitness):
    """Population fitness over a `DagEnsemble`.

    Same plumbing as `BatchedFitness` (shared `_CachedFitness` base), but
    every unique genome is scored against *all* ensemble members in one
    `EnsembleTorchDES.ensemble_genome_makespan` call (genomes x members
    lanes in one event loop), then scalarized:

      weighted   : sum_m w_m * makespan_m
      max-regret : max_m  makespan_m / refs_m

    `masks`, one (P, P) link-availability mask per member (None: the
    healthy fabric), scale each member's link capacities.  Any
    member-infeasible genome scores INF.  Building the engine is not
    guarded: a device or kernel that fails raises here.
    """

    def __init__(self, ensemble: DagEnsemble, space: TopologySpace,
                 opts: GAOptions, objective: str, refs: np.ndarray,
                 masks: np.ndarray | None = None):
        self.ensemble = ensemble
        self.problems = [DESProblem(m) for m in ensemble.members]
        super().__init__(space, opts, max(p.n for p in self.problems))
        self.objective = objective
        self.refs = np.asarray(refs, dtype=np.float64)
        self.weights = np.asarray(ensemble.weights, dtype=np.float64)
        self.masks = masks if masks is None else np.asarray(
            masks, dtype=np.float64)
        self._des = None
        if self._use_device and space.E > 0:
            self._des = EnsembleTorchDES(self.problems,
                                         options=opts.des_options)

    def scalarize(self, ms: np.ndarray) -> np.ndarray:
        """(S, M) member makespans -> (S,) objective values (INF-safe)."""
        ms = np.asarray(ms, dtype=np.float64).reshape(-1, len(self.problems))
        with np.errstate(invalid="ignore"):
            if self.objective == "weighted":
                out = ms @ self.weights
            else:
                out = (ms / self.refs).max(axis=1)
        out[~np.isfinite(ms).all(axis=1)] = INF
        return out

    def member_makespans(self, genomes: np.ndarray) -> np.ndarray:
        """(S, E) genomes -> (S, M) makespans (INF where infeasible)."""
        genomes = np.asarray(genomes, dtype=np.int64).reshape(-1,
                                                              self.space.E)
        if self._des is not None:
            genomes, k = self._padded(genomes)
            ms, feas = self._des.ensemble_genome_makespan(
                genomes, self.space.edge_u, self.space.edge_v,
                masks=self.masks)
            self.batch_calls += 1
            return np.where(feas, ms, INF)[:k]
        return np.array([self._exact(x) for x in
                         self.space.to_matrix_batch(genomes)]).reshape(
                             len(genomes), len(self.problems))

    def exact_member_makespans(self, genome: np.ndarray) -> np.ndarray:
        """Exact (numpy DES) per-member makespans of one genome."""
        return self._exact(self.space.to_matrix(genome))

    def _exact(self, x: np.ndarray) -> np.ndarray:
        if self.masks is None:
            return np.array([simulate(p, x).makespan for p in self.problems])
        return np.array([simulate(p, x * m).makespan
                         for p, m in zip(self.problems, self.masks)])

    def _raw_scores(self, genomes: np.ndarray) -> np.ndarray:
        return self.scalarize(self.member_makespans(genomes))


def _rerank_members(fit: EnsembleFitness, best_g: np.ndarray,
                    opts: GAOptions) -> tuple[np.ndarray, np.ndarray]:
    """`_exact_rerank` by the scalarized exact per-member makespans: the
    winner genome and its (M,) makespans."""
    g = _exact_rerank(
        fit, best_g,
        lambda g: float(fit.scalarize(fit.exact_member_makespans(g)[None])
                        [0]), opts.port_weight)
    return g, fit.exact_member_makespans(g)


@dataclass
class RobustGAResult:
    """One static topology scored against every ensemble member."""

    x: np.ndarray
    makespans: np.ndarray          # (M,) exact per-member DES makespans
    regrets: np.ndarray            # (M,) makespans / refs
    refs: np.ndarray               # (M,) reference (best single-DAG) spans
    weights: np.ndarray            # (M,) normalized mixture weights
    objective: str
    objective_value: float
    generations: int
    evaluations: int
    elapsed: float
    history: list[float] = field(default_factory=list)
    feasible: bool = True

    @property
    def worst_regret(self) -> float:
        return float(self.regrets.max()) if len(self.regrets) else INF

    @property
    def weighted_makespan(self) -> float:
        return float(self.makespans @ self.weights)

    @property
    def total_ports(self) -> int:
        return int(self.x.sum())


def delta_robust(ensemble: DagEnsemble, opts: GAOptions | None = None,
                 objective: str = "max-regret",
                 refs: np.ndarray | None = None,
                 xbar: np.ndarray | None = None,
                 seeds: list[np.ndarray] | None = None,
                 port_limits: Sequence[int] | None = None) -> RobustGAResult:
    """DELTA-Robust: one static topology for a *set* of DAGs.

    Runs the same domain-adapted GA as `delta_fast` (identical RNG stream
    and loop -- a singleton ensemble reduces exactly to the single-DAG
    path) over the union pair space, with per-genome fitness scored
    against every member in one batched DES call.

    `refs` are the per-member reference makespans defining regret
    (member's best single-DAG plan).  When omitted they are computed here
    by running `delta_fast` per member with the same options.  `seeds`
    are (P, P) topologies repaired into the initial population.

    `port_limits` overrides the cluster's per-pod budgets: the k-plane
    decomposition (`delta_planes`) searches the base topology inside the
    first k-1 planes' combined budget.
    """
    opts = opts or GAOptions()
    if objective not in ROBUST_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick from {ROBUST_OBJECTIVES}")
    t_start = time.time()
    if refs is None:
        refs = np.array([delta_fast(m, opts).makespan
                         for m in ensemble.members])
    refs = np.asarray(refs, dtype=np.float64)
    if refs.shape != (ensemble.num_members,):
        raise ValueError("refs must have one entry per ensemble member")
    if not (np.isfinite(refs) & (refs > 0)).all():
        raise ValueError(f"refs must be finite positive makespans: {refs}")

    rng = np.random.default_rng(opts.seed)
    space = TopologySpace.for_ensemble(ensemble, xbar,
                                       port_limits=port_limits)
    fit = EnsembleFitness(ensemble, space, opts, objective, refs)
    # the robust GA gets its own full time budget: the per-member ref
    # runs above must not eat into _evolve's wall-clock limit
    t0 = time.time()

    if space.E == 0:    # no member has inter-pod traffic
        x = np.zeros((space.P, space.P), dtype=np.int64)
        ms = fit.exact_member_makespans(np.zeros(0, dtype=np.int64))
        obj = float(fit.scalarize(ms[None])[0])
        return RobustGAResult(
            x=x, makespans=ms, regrets=ms / refs, refs=refs,
            weights=np.asarray(ensemble.weights),
            objective=objective, objective_value=obj, generations=0,
            evaluations=1, elapsed=time.time() - t_start, history=[obj],
            feasible=bool(np.isfinite(ms).all()))

    with span("ga.evolve", kind="delta_robust", pop=opts.pop_size,
              edges=space.E, members=ensemble.num_members):
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0, seeds)
    best_g, best_ms = _rerank_members(fit, best_g, opts)
    obj = float(fit.scalarize(best_ms[None])[0])
    return RobustGAResult(
        x=space.to_matrix(best_g), makespans=best_ms,
        regrets=best_ms / refs, refs=refs,
        weights=np.asarray(ensemble.weights), objective=objective,
        objective_value=obj, generations=gen, evaluations=fit.evaluations,
        elapsed=time.time() - t_start, history=history,
        feasible=bool(np.isfinite(best_ms).all()))


# ----------------------------------------------------------- DELTA-Failsafe
FAILSAFE_OBJECTIVES = ("worst", "weighted")


def failure_scenarios(dag: CommDAG, num_planes: int = 4, k: int = 1,
                      include_healthy: bool = True) -> list[np.ndarray]:
    """Fractional k-plane-loss masks for the k-failure worst-case plan.

    One scenario per active pod pair: k of the `num_planes` OCS planes
    serving that pair go dark, leaving (num_planes - k)/num_planes of its
    circuit capacity.  The haircut is *fractional* on purpose -- circuits
    are the only route between a pair, so a full kill would make the worst
    case inf for every topology.  The healthy fabric is scenario 0, keeping
    the worst-case plan honest on the intact fabric too.
    """
    P = dag.cluster.num_pods
    frac = max(num_planes - k, 0) / num_planes
    out = [np.ones((P, P))] if include_healthy else []
    for (i, j) in dag.undirected_pairs():
        m = np.ones((P, P))
        m[i, j] = m[j, i] = frac
        out.append(m)
    return out


class FailsafeFitness(EnsembleFitness):
    """k-failure fitness: ONE DAG scored under a stack of degradation
    masks through the per-member mask lane of `EnsembleTorchDES`.  Reuses
    the whole ensemble plumbing by treating each failure scenario as a
    member whose DAG is the same object."""

    def __init__(self, dag: CommDAG, scenarios: list[np.ndarray],
                 space: TopologySpace, opts: GAOptions, objective: str,
                 refs: np.ndarray):
        super().__init__(DagEnsemble([dag] * len(scenarios)), space, opts,
                         objective, refs, masks=np.stack(scenarios))


def delta_failsafe(dag: CommDAG, opts: GAOptions | None = None,
                   scenarios: list[np.ndarray] | None = None,
                   num_planes: int = 4, k: int = 1,
                   objective: str = "worst",
                   xbar: np.ndarray | None = None,
                   seeds: list[np.ndarray] | None = None) -> RobustGAResult:
    """k-failure worst-case plan: one topology whose DES makespan is
    minimized across a set of fabric-degradation scenarios (capacity
    masks), scored in one genomes x masks batched DES call per
    generation.

    `scenarios` is a list of (P, P) availability masks (1 = healthy);
    omitted, it defaults to `failure_scenarios(dag, num_planes, k)`.
    `objective` is 'worst' (minimize the max scenario makespan) or
    'weighted' (uniform mean).  `seeds` are (P, P) topologies repaired
    into the initial population.  The repair policy also calls this with a
    single scenario -- the *current* fabric damage -- to produce a full
    replan optimized for the degraded fabric.
    """
    opts = opts or GAOptions()
    if objective not in FAILSAFE_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick from {FAILSAFE_OBJECTIVES}")
    if scenarios is None:
        scenarios = failure_scenarios(dag, num_planes=num_planes, k=k)
    scenarios = [np.asarray(m, dtype=np.float64) for m in scenarios]
    if not scenarios:
        raise ValueError("delta_failsafe needs at least one scenario")
    t_start = time.time()
    rng = np.random.default_rng(opts.seed)
    space = TopologySpace(dag, xbar)
    refs = np.ones(len(scenarios))   # worst == max-regret w.r.t. unit refs
    eff = "max-regret" if objective == "worst" else "weighted"
    fit = FailsafeFitness(dag, scenarios, space, opts, eff, refs)
    t0 = time.time()

    if space.E == 0:    # no inter-pod traffic: nothing to degrade
        x = np.zeros((space.P, space.P), dtype=np.int64)
        ms = fit.exact_member_makespans(np.zeros(0, dtype=np.int64))
        obj = float(fit.scalarize(ms[None])[0])
        return RobustGAResult(
            x=x, makespans=ms, regrets=ms / refs, refs=refs,
            weights=np.asarray(fit.ensemble.weights), objective=objective,
            objective_value=obj, generations=0, evaluations=1,
            elapsed=time.time() - t_start, history=[obj],
            feasible=bool(np.isfinite(ms).all()))

    with span("ga.evolve", kind="delta_failsafe", pop=opts.pop_size,
              edges=space.E, members=len(scenarios)):
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0, seeds)
    # masked makespans are certified exactly before the winner is named
    best_g, best_ms = _rerank_members(fit, best_g, opts)
    obj = float(fit.scalarize(best_ms[None])[0])
    return RobustGAResult(
        x=space.to_matrix(best_g), makespans=best_ms,
        regrets=best_ms / refs, refs=refs,
        weights=np.asarray(fit.ensemble.weights), objective=objective,
        objective_value=obj, generations=gen, evaluations=fit.evaluations,
        elapsed=time.time() - t_start, history=history,
        feasible=bool(np.isfinite(best_ms).all()))


# -------------------------------------------------------------- DELTA-Planes
def split_across_planes(x: np.ndarray, plane_budgets) -> np.ndarray:
    """Split one topology across OCS planes, balanced per pair.

    `x` is a (P, P) symmetric circuit matrix; `plane_budgets` is (k', P)
    per-plane per-pod port budgets.  Circuits are assigned one at a time,
    heaviest pair first; each circuit goes to the plane with the smallest
    share of that pair so far (then the most endpoint headroom, then the
    lowest plane id), so every pair's per-plane share is within one of
    c/k' wherever budgets permit -- losing any single plane then costs a
    pair at most ceil(c/k') of its c circuits.  Deterministic: the fleet
    rebuilds plane books from journal replays and must land on identical
    arrays.

    When the balanced choice has no port headroom the circuit falls to
    any plane that fits; if none fits, one single-circuit swap between
    planes is attempted before giving up (per-plane budgets are near-
    uniform, so a feasible global topology virtually always splits).
    """
    x = np.asarray(x)
    budgets = np.asarray(plane_budgets, dtype=np.int64)
    if budgets.ndim != 2 or budgets.shape[1] != x.shape[0]:
        raise ValueError(f"plane_budgets shape {budgets.shape} does not "
                         f"match {x.shape[0]} pods")
    k, P = budgets.shape
    planes = np.zeros((k, P, P), dtype=np.int64)
    head = budgets.copy()

    def place(u: int, v: int) -> bool:
        fits = np.nonzero((head[:, u] > 0) & (head[:, v] > 0))[0]
        if len(fits) == 0:
            return False
        share = planes[fits, u, v]
        room = np.minimum(head[fits, u], head[fits, v])
        p = fits[np.lexsort((fits, -room, share))[0]]
        planes[p, u, v] += 1
        planes[p, v, u] += 1
        head[p, u] -= 1
        head[p, v] -= 1
        return True

    def swap_then_place(u: int, v: int) -> bool:
        # free a slot: move one circuit (a, b) out of a plane p that has
        # headroom at one endpoint, into a plane q that fits it, so (u, v)
        # can land in p
        for u0, v0 in ((u, v), (v, u)):
            for p in np.nonzero(head[:, u0] > 0)[0]:
                for b in np.nonzero(planes[p, v0] > 0)[0]:
                    for q in np.nonzero((head[:, v0] > 0)
                                        & (head[:, b] > 0))[0]:
                        if q == p:
                            continue
                        planes[p, v0, b] -= 1
                        planes[p, b, v0] -= 1
                        planes[q, v0, b] += 1
                        planes[q, b, v0] += 1
                        head[p, v0] += 1
                        head[p, b] += 1
                        head[q, v0] -= 1
                        head[q, b] -= 1
                        if place(u, v):
                            return True
        return False

    iu, iv = np.triu_indices(P, k=1)
    counts = np.asarray(x)[iu, iv].astype(np.int64)
    for idx in np.lexsort((iv, iu, -counts)):
        u, v, c = int(iu[idx]), int(iv[idx]), int(counts[idx])
        for _ in range(c):
            if not place(u, v) and not swap_then_place(u, v):
                raise ValueError(
                    f"cannot split pair ({u}, {v}) of {x[u, v]} circuits "
                    f"across plane budgets {budgets.tolist()}")
    return planes


class PlanesFitness(EnsembleFitness):
    """Spare-plane fitness for the k-plane decomposition.

    The genome is the SPARE plane's lane only; the first k-1 lanes are
    frozen to the balanced split of the stage-A weighted optimum.  Every
    candidate is scored across k+1 fabric states -- the full fabric plus
    each single plane dark (`plane_state_genomes`, the staggered-rewire /
    PlaneFailure states the scheduler actually visits) -- and all M
    ensemble members, in ONE `ensemble_genome_makespan` call over the
    (S*(k+1), E) float state stack: one lane per state x member.
    Objective: worst state/member regret against the stage-A reference
    makespans, so the spare lane is shaped to absorb whichever plane loss
    hurts the worst member most.
    """

    def __init__(self, ensemble: DagEnsemble, base_lanes: np.ndarray,
                 space: TopologySpace, opts: GAOptions, refs: np.ndarray):
        super().__init__(ensemble, space, opts, "max-regret", refs)
        self.base_lanes = np.asarray(base_lanes, dtype=np.int64) \
            .reshape(-1, space.E)
        self.num_planes = len(self.base_lanes) + 1

    def _lane_stack(self, genomes: np.ndarray) -> np.ndarray:
        """(S, E) spare lanes -> (S, k, E) full per-plane lane stacks."""
        S = len(genomes)
        base = np.broadcast_to(self.base_lanes[None],
                               (S,) + self.base_lanes.shape)
        return np.concatenate(
            [base, genomes[:, None, :].astype(np.int64)], axis=1)

    def state_makespans(self, genomes: np.ndarray) -> np.ndarray:
        """(S, E) spare lanes -> (S, k+1, M) fabric-state makespans."""
        genomes = np.asarray(genomes, dtype=np.int64).reshape(
            -1, self.space.E)
        S, M = len(genomes), len(self.problems)
        k1 = self.num_planes + 1
        states = plane_state_genomes(self._lane_stack(genomes)) \
            .reshape(S * k1, self.space.E)
        if self._des is not None:
            padded, n = self._padded(states)
            ms, feas = self._des.ensemble_genome_makespan(
                padded, self.space.edge_u, self.space.edge_v)
            self.batch_calls += 1
            return np.where(feas, ms, INF)[:n].reshape(S, k1, M)
        out = np.empty((S * k1, M))
        for s, g in enumerate(states):
            X = self._float_matrix(g)
            out[s] = [simulate(p, X).makespan for p in self.problems]
        return out.reshape(S, k1, M)

    def _float_matrix(self, g: np.ndarray) -> np.ndarray:
        """Float scatter (fractional trickle lanes break `to_matrix`)."""
        X = np.zeros((self.space.P, self.space.P))
        X[self.space.edge_u, self.space.edge_v] = g
        X[self.space.edge_v, self.space.edge_u] = g
        return X

    def exact_state_makespans(self, genome: np.ndarray) -> np.ndarray:
        """Exact (numpy DES) (k+1, M) state/member makespans of one
        spare lane."""
        lanes = self._lane_stack(
            np.asarray(genome, dtype=np.int64).reshape(1, -1))
        states = plane_state_genomes(lanes)[0]          # (k+1, E)
        out = np.empty((len(states), len(self.problems)))
        for s, g in enumerate(states):
            X = self._float_matrix(g)
            out[s] = [simulate(p, X).makespan for p in self.problems]
        return out

    def _raw_scores(self, genomes: np.ndarray) -> np.ndarray:
        ms = self.state_makespans(genomes)              # (S, k+1, M)
        flat = ms.reshape(len(ms), -1)
        with np.errstate(invalid="ignore"):
            out = (ms / self.refs).reshape(len(ms), -1).max(axis=1)
        out[~np.isfinite(flat).all(axis=1)] = INF
        return out


@dataclass
class PlanesGAResult:
    """k-plane decomposition of one robust topology."""

    planes: np.ndarray             # (k, P, P) per-plane circuit counts
    lane_genomes: np.ndarray       # (k, E) the same, on the union pairs
    edges: list                    # the E union pairs
    x: np.ndarray                  # (P, P) total topology (planes.sum(0))
    makespans: np.ndarray          # (M,) exact full-fabric member makespans
    dark_makespans: np.ndarray     # (k, M) exact one-plane-dark makespans
    refs: np.ndarray               # (M,) stage-A reference makespans
    plane_port_limits: tuple       # (k, P) per-plane per-pod budgets
    objective_value: float         # worst state/member regret
    generations: int
    evaluations: int
    elapsed: float
    history: list = field(default_factory=list)
    feasible: bool = True

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def worst_dark_regret(self) -> float:
        if not len(self.dark_makespans):
            return INF
        return float((self.dark_makespans / self.refs).max())

    @property
    def total_ports(self) -> int:
        return int(self.x.sum())


def delta_planes(ensemble: DagEnsemble, opts: GAOptions | None = None,
                 num_planes: int = 4,
                 xbar: np.ndarray | None = None,
                 seeds: list[np.ndarray] | None = None) -> PlanesGAResult:
    """DELTA-Planes: decompose one robust topology across a k-plane OCS
    fabric so any single plane can go dark (fault OR staggered rewire)
    with bounded, pre-certified inflation.

    Two structured stages over the plane-indexed genome:

      1. base -- `delta_robust` (weighted objective) confined to the
         first k-1 planes' combined port budget, then split balanced
         across those planes (`split_across_planes`): the always-on
         carry capacity.
      2. spare -- a GA over the k-th plane's lane alone
         (`TopologySpace.for_ensemble(..., port_limits=spare,
         min_circuits=0)`), scored on the k+1 fabric states every
         staggered transition actually visits; the spare lane is shaped
         to absorb the worst-case member under the worst plane loss.

    Exact numpy re-rank certifies the winner's full state/member matrix
    before it is returned (same f32-noise guard as the other engines).
    """
    opts = opts or GAOptions()
    if num_planes < 2:
        raise ValueError(f"num_planes must be >= 2, got {num_planes}")
    t_start = time.time()
    budgets = np.asarray(ensemble.plane_port_limits(num_planes),
                         dtype=np.int64)
    base_budget = budgets[:-1].sum(axis=0)

    base = delta_robust(ensemble, opts, objective="weighted",
                        refs=np.ones(ensemble.num_members),
                        port_limits=base_budget)
    refs = np.asarray(base.makespans, dtype=np.float64)
    if not (np.isfinite(refs) & (refs > 0)).all():
        raise ValueError(
            f"base stage is infeasible under the first {num_planes - 1} "
            f"planes' budget {base_budget.tolist()}: makespans {refs}")
    base_planes = split_across_planes(base.x, budgets[:-1])

    space = TopologySpace.for_ensemble(ensemble, xbar,
                                       port_limits=budgets[-1],
                                       min_circuits=0)
    # the spare lane tops up what the base left under the union Alg. 2
    # bound (at least one extra circuit per pair stays searchable)
    extra = ensemble_x_upper_bound(ensemble)[
        space.edge_u, space.edge_v].astype(np.int64) \
        - base.x[space.edge_u, space.edge_v].astype(np.int64)
    space.xbar = np.minimum(space.xbar, np.maximum(extra, 1))
    base_lanes = base_planes[:, space.edge_u, space.edge_v]
    fit = PlanesFitness(ensemble, base_lanes, space, opts, refs)
    rng = np.random.default_rng(opts.seed + 1)   # distinct from stage 1
    t0 = time.time()

    def finish(spare_g: np.ndarray, gen: int,
               history: list[float]) -> PlanesGAResult:
        exact = fit.exact_state_makespans(spare_g)   # (k+1, M)
        spare_x = space.to_matrix(spare_g)
        planes = np.concatenate([base_planes, spare_x[None]], axis=0)
        lanes = np.concatenate([base_lanes, spare_g[None].astype(np.int64)],
                               axis=0)
        with np.errstate(invalid="ignore"):
            obj = float((exact / refs).max())
        return PlanesGAResult(
            planes=planes, lane_genomes=lanes, edges=list(space.edges),
            x=planes.sum(axis=0), makespans=exact[0],
            dark_makespans=exact[1:], refs=refs,
            plane_port_limits=tuple(map(tuple, budgets.tolist())),
            objective_value=obj, generations=gen,
            evaluations=fit.evaluations, elapsed=time.time() - t_start,
            history=history, feasible=bool(np.isfinite(exact).all()))

    if space.E == 0:    # no inter-pod traffic: all-dark states are free
        return finish(np.zeros(0, dtype=np.int64), 0, [])

    with span("ga.evolve", kind="delta_planes", pop=opts.pop_size,
              edges=space.E, members=ensemble.num_members,
              planes=num_planes):
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0, seeds)

    def worst_regret(g: np.ndarray) -> float:
        with np.errstate(invalid="ignore"):
            return float((fit.exact_state_makespans(g) / refs).max())

    # exact numpy re-rank of the top spare lanes across the full
    # state/member matrix (f32-noise guard)
    return finish(_exact_rerank(fit, best_g, worst_regret, opts.port_weight,
                                top=4), gen, history)


# ------------------------------------------------------------ port trimming
def _batched_trim(backend: str, n_tasks: int, pairs: int,
                  droppable: int) -> bool:
    """Whether a trimming sweep scores its drop-one candidates on the torch
    DES: always for 'torch', never for 'numpy'; 'auto' only where one
    batched call per round can win -- a wide fabric (16+ pairs) with
    enough droppable circuits (32+) to amortize building the engine, and
    a DAG small enough for the device path (`GAOptions.device_task_limit`).
    On narrow pipeline DAGs the serial numpy sweep is faster."""
    if backend not in TRIM_BACKENDS:
        raise ValueError(f"unknown trim backend {backend!r}; "
                         f"pick from {TRIM_BACKENDS}")
    return backend == "torch" or (
        backend == "auto" and n_tasks <= GAOptions.device_task_limit
        and pairs >= 16 and droppable >= 32)


def trim_ports_ensemble(ensemble: DagEnsemble, x: np.ndarray,
                        rel_tol: float = 1e-6, backend: str = "auto",
                        options: DESOptions | None = None) -> np.ndarray:
    """Robust analog of `trim_ports`: greedy port minimization certified
    against EVERY ensemble member -- a circuit is dropped only if no
    member's exact (numpy DES) makespan degrades beyond `rel_tol` of its
    value under the input topology.

    Batched like the single-DAG `trim_ports`: each round scores all
    drop-one candidates against all members in ONE
    `EnsembleTorchDES.ensemble_genome_makespan` call (candidates x members
    lanes of one event loop, the engine built with `options`), then
    accepts the first fitting drop in the serial cyclic order after
    certifying it per member with the exact numpy DES.  The float32 batch
    is a pre-filter only; the termination backstop exact-rechecks the
    ambiguous band (see `trim_ports`).  Circuits outside the union pairs
    are invisible to the genome scatter, so such a topology always takes
    the serial member sweep."""
    problems = [DESProblem(m) for m in ensemble.members]
    x = np.asarray(x)
    base = np.array([simulate(p, x).makespan for p in problems])
    if not np.isfinite(base).all():
        return x
    x = x.copy()
    budgets = base * (1 + rel_tol)
    pairs = ensemble.undirected_pairs()
    E = len(pairs)
    if E == 0:
        return x
    earr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    eu, ev = earr[:, 0], earr[:, 1]

    def exact_fits(xt: np.ndarray) -> bool:
        return all(simulate(p, xt).makespan <= b
                   for p, b in zip(problems, budgets))

    droppable_total = int(np.maximum(x[eu, ev] - 1, 0).sum())
    off_pair = x.copy()
    off_pair[eu, ev] = 0
    off_pair[ev, eu] = 0
    des = None
    if _batched_trim(backend, max(p.n for p in problems), E,
                     droppable_total) and off_pair.sum() == 0:
        des = EnsembleTorchDES(problems, options=options)

    ptr = 0   # cyclic sweep pointer (matches trim_ports' pair ordering)
    while True:
        droppable = np.nonzero(x[eu, ev] > 1)[0]
        k = len(droppable)
        if k == 0:
            break
        g0 = x[eu, ev].astype(np.int64)
        G = np.repeat(g0[None], k, axis=0)
        G[np.arange(k), droppable] -= 1
        if des is not None:
            pad = E - k
            batch = np.concatenate([G, np.repeat(G[:1], pad, axis=0)]) \
                if pad > 0 else G
            ms, feas = des.ensemble_genome_makespan(batch, eu, ev)
            fits, near = _trim_filter_bands(ms, feas, budgets)
            # a candidate is worth exact-checking only if EVERY member is
            # in band: one member clearly over budget rejects it outright
            fits = fits.all(axis=1)[:k]
            near = near.all(axis=1)[:k]
        else:
            fits = np.ones(k, dtype=bool)   # certified serially below
            near = fits
        accepted = False
        scan = np.argsort((droppable - ptr) % E, kind="stable")
        for certify_band in (fits, ~fits & near) if des is not None \
                else (fits,):
            for i in scan:
                if not certify_band[i]:
                    continue
                xt = x.copy()
                e = droppable[i]
                xt[eu[e], ev[e]] -= 1
                xt[ev[e], eu[e]] -= 1
                if exact_fits(xt):
                    x = xt
                    ptr = (int(e) + 1) % E
                    accepted = True
                    break
            if accepted:
                break
        if not accepted:
            break
    return x


def trim_ports(dag: CommDAG, x: np.ndarray, rel_tol: float = 1e-6,
               backend: str = "auto",
               options: DESOptions | None = None) -> np.ndarray:
    """Greedy port minimization for heuristic topologies (beyond-paper
    DELTA-Fast counterpart of Eq. 4): repeatedly drop the circuit whose
    removal leaves the DES makespan unchanged, exploiting the temporal
    slack of non-critical tasks.

    Batched: each round scores *all* drop-one candidates from the current
    topology in a single `TorchDES.batch_makespan` call (padded to a fixed
    shape; the engine built with `options`), then accepts the first
    fitting drop in the serial cyclic sweep order after certifying it
    against the exact numpy DES.  The float32 batch is only a pre-filter
    (with a conservative `_TRIM_FILTER_SLACK` margin): every accept is
    numpy-certified, so the budget is never violated, and before
    terminating the sweep exact-rechecks the batched scores' ambiguous
    band -- candidates the filter rejected by less than
    `_TRIM_BACKSTOP_BAND`, or flagged infeasible by the f32 engine: the
    only ones a bounded float32 DES error could have misjudged.  A float32
    false negative mid-round can at most reorder accepts relative to the
    serial sweep; on the tested workloads the results are identical.
    """
    problem = DESProblem(dag)
    base = simulate(problem, np.asarray(x)).makespan
    if not np.isfinite(base):
        return x
    x = np.asarray(x).copy()
    budget = base * (1 + rel_tol)
    pairs = dag.undirected_pairs()
    E = len(pairs)
    if E == 0:
        return x
    earr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    eu, ev = earr[:, 0], earr[:, 1]
    droppable_total = int(np.maximum(x[eu, ev] - 1, 0).sum())
    des = TorchDES(problem, options=options) \
        if _batched_trim(backend, problem.n, E, droppable_total) else None

    ptr = 0   # cyclic sweep pointer (matches the serial pair ordering)
    while True:
        droppable = np.nonzero(x[eu, ev] > 1)[0]
        k = len(droppable)
        if k == 0:
            break
        xs = np.repeat(x[None], k, axis=0)
        rows = np.arange(k)
        xs[rows, eu[droppable], ev[droppable]] -= 1
        xs[rows, ev[droppable], eu[droppable]] -= 1
        if des is not None:
            pad = E - k
            batch = np.concatenate([xs, np.repeat(xs[:1], pad, axis=0)]) \
                if pad else xs
            ms, feas = des.batch_makespan(batch)
            # float32 filter with slack; every accept is numpy-certified
            fits, near = _trim_filter_bands(ms, feas, budget)
            fits, near = fits[:k], near[:k]
        else:
            fits = np.ones(k, dtype=bool)   # certified serially below
            near = fits
        accepted = False
        scan = np.argsort((droppable - ptr) % E, kind="stable")
        # first pass: filter-approved candidates; termination backstop:
        # the batched scores' ambiguous band (~fits & near), the only
        # candidates a bounded f32 DES error could have misjudged
        for certify_band in ((fits, ~fits & near) if des is not None
                             else (fits,)):
            for i in scan:
                if not certify_band[i]:
                    continue
                if simulate(problem, xs[i]).makespan <= budget:
                    x = xs[i]
                    ptr = (int(droppable[i]) + 1) % E
                    accepted = True
                    break
            if accepted:
                break
        if not accepted:
            break
    return x


def exhaustive_search(dag: CommDAG, limit: int = 200000
                      ) -> tuple[np.ndarray, float, int]:
    """Exact topology search by enumeration (tests / tiny instances)."""
    space = TopologySpace(dag)
    problem = DESProblem(dag)
    ranges = [range(1, int(b) + 1) for b in space.xbar]
    total = int(np.prod([len(r) for r in ranges]))
    if total > limit:
        raise ValueError(f"{total} combinations exceed limit {limit}")
    best = (INF, None)
    count = 0
    for combo in itertools.product(*ranges):
        g = np.asarray(combo, dtype=np.int64)
        if not space.is_feasible(g):
            continue
        count += 1
        ms = simulate(problem, space.to_matrix(g)).makespan
        if ms < best[0]:
            best = (ms, g)
    if best[1] is None:
        raise RuntimeError("no feasible topology")
    return space.to_matrix(best[1]), float(best[0]), count
