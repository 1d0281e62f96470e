"""DELTA-Fast: DES-accelerated domain-adapted genetic algorithm
(paper Sec. IV-B, Algs. 3, 5, 6) -- population-array-resident engine.

The port of `repro/core/ga.py`'s single-DAG path (`delta_fast`) and its
ensemble engines (`delta_robust`: one topology for the members of a
`DagEnsemble`; `delta_failsafe`: one topology under fabric-failure
scenarios), which score genomes x members in one batched call of
`EnsembleTorchDES`.  Genome = integer
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

import time
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dag import CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, EnsembleTorchDES, TorchDES
from repro_torch.core.xbound import x_upper_bound
from repro_torch.obs import get_counter, span

_GENERATIONS = get_counter(
    "ga_generations_total", "GA generations executed")
_EVALUATIONS = get_counter(
    "ga_fitness_evaluations_total",
    "unique genomes scored by the DES (cache misses)")

INF = float("inf")


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
            raise ValueError(
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
                  port_weight: float) -> np.ndarray:
    """The winner among the 8 best distinct cached genomes, re-ranked by
    `score_of` (the exact numpy DES; the batched torch fitness runs in
    float32, with ~1e-5 ranking noise) plus the port penalty; `best_g`
    when none of them scores finite."""
    ranked = sorted(fit.cache.items(), key=lambda kv: kv[1])[:8]
    best_key, best_score = best_g.tobytes(), INF
    for key, fval in ranked:
        if not np.isfinite(fval):
            continue
        g = np.frombuffer(key, dtype=np.int64)
        score = score_of(g)
        if np.isfinite(score):
            score += port_weight * float(g.sum())
        if score < best_score:
            best_score, best_key = score, key
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
                 xbar: np.ndarray | None = None) -> RobustGAResult:
    """DELTA-Robust: one static topology for a *set* of DAGs.

    Runs the same domain-adapted GA as `delta_fast` (identical RNG stream
    and loop -- a singleton ensemble reduces exactly to the single-DAG
    path) over the union pair space, with per-genome fitness scored
    against every member in one batched DES call.

    `refs` are the per-member reference makespans defining regret
    (member's best single-DAG plan).  When omitted they are computed here
    by running `delta_fast` per member with the same options.
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
    space = TopologySpace.for_ensemble(ensemble, xbar)
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
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0)
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
                   xbar: np.ndarray | None = None) -> RobustGAResult:
    """k-failure worst-case plan: one topology whose DES makespan is
    minimized across a set of fabric-degradation scenarios (capacity
    masks), scored in one genomes x masks batched DES call per
    generation.

    `scenarios` is a list of (P, P) availability masks (1 = healthy);
    omitted, it defaults to `failure_scenarios(dag, num_planes, k)`.
    `objective` is 'worst' (minimize the max scenario makespan) or
    'weighted' (uniform mean).  The repair policy also calls this with a
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
        best_g, _, history, gen = _evolve(space, fit, opts, rng, t0)
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
