"""Legacy (pre-vectorization) DELTA-Fast engine -- a baseline only (the
reference's `repro.core._ga_legacy`).

This is the per-genome Python-loop implementation of Algs. 3/5/6 that
`repro_torch.core.ga` replaced with population-array ops, its logic kept
verbatim so that a GA bench can measure the vectorized engine against the
exact pre-refactor hot loop at a fixed seed, and tests can hold the new
engine's makespans and `trim_ports` outputs no worse than / identical to
the old ones.  Its batched fitness runs on `TorchDES.batch_makespan`
(one `fill_maxmin` launch per event trip on the card) where the reference
ran `JaxDES`; building that engine is not guarded: a device or kernel
that fails raises.

Do not import this from production code paths; use `repro_torch.core.ga`.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dag import CommDAG
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.xbound import x_upper_bound

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
    """Genome <-> symmetric topology matrix mapping + Algs. 5/6."""

    def __init__(self, dag: CommDAG, xbar: np.ndarray | None = None):
        self.dag = dag
        self.P = dag.cluster.num_pods
        self.U = np.asarray(dag.cluster.port_limits, dtype=np.int64)
        self.edges = dag.undirected_pairs()
        self.E = len(self.edges)
        xbar = xbar if xbar is not None else x_upper_bound(dag)
        self.xbar = np.array(
            [max(1, min(int(xbar[i, j]), int(self.U[i]), int(self.U[j])))
             for i, j in self.edges], dtype=np.int64)
        self.pod_edges: list[list[int]] = [[] for _ in range(self.P)]
        for e, (i, j) in enumerate(self.edges):
            self.pod_edges[i].append(e)
            self.pod_edges[j].append(e)
        # quick feasibility: connectivity needs one port per incident edge
        for p in range(self.P):
            if len(self.pod_edges[p]) > self.U[p]:
                raise ValueError(
                    f"pod {p} has {len(self.pod_edges[p])} active pairs but "
                    f"only {self.U[p]} ports; placement is infeasible")

    def to_matrix(self, genome: np.ndarray) -> np.ndarray:
        x = np.zeros((self.P, self.P), dtype=np.int64)
        for e, (i, j) in enumerate(self.edges):
            x[i, j] = x[j, i] = int(genome[e])
        return x

    def port_usage(self, genome: np.ndarray) -> np.ndarray:
        used = np.zeros(self.P, dtype=np.int64)
        for e, (i, j) in enumerate(self.edges):
            used[i] += genome[e]
            used[j] += genome[e]
        return used

    def is_feasible(self, genome: np.ndarray) -> bool:
        return bool((genome >= 1).all() and (genome <= self.xbar).all()
                    and (self.port_usage(genome) <= self.U).all())

    # ---------------------------------------------------------------- Alg. 5
    def feasible_random_init(self, rng: np.random.Generator) -> np.ndarray:
        genome = np.zeros(self.E, dtype=np.int64)
        used = np.zeros(self.P, dtype=np.int64)
        deg = np.array([len(self.pod_edges[p]) for p in range(self.P)])
        for e, (u, v) in enumerate(self.edges):
            deg[u] -= 1
            deg[v] -= 1
            ru = self.U[u] - used[u] - deg[u]   # reserve future connectivity
            rv = self.U[v] - used[v] - deg[v]
            limit = max(1, min(ru, rv, self.xbar[e]))
            genome[e] = rng.integers(1, limit + 1)
            used[u] += genome[e]
            used[v] += genome[e]
        return genome

    # ---------------------------------------------------------------- Alg. 6
    def repair(self, genome: np.ndarray, rng: np.random.Generator
               ) -> tuple[np.ndarray, bool]:
        g = np.clip(genome, 1, self.xbar)
        used = self.port_usage(g)
        guard = int(g.sum()) + self.P + 1
        for _ in range(guard):
            over = np.nonzero(used > self.U)[0]
            if len(over) == 0:
                return g, True
            p = int(rng.choice(over))
            reducible = [e for e in self.pod_edges[p] if g[e] > 1]
            if not reducible:
                return g, False
            e = int(rng.choice(reducible))
            g[e] -= 1
            i, j = self.edges[e]
            used[i] -= 1
            used[j] -= 1
        return g, bool((self.port_usage(g) <= self.U).all())


class _Fitness:
    def __init__(self, dag: CommDAG, space: TopologySpace, opts: GAOptions):
        self.problem = DESProblem(dag)
        self.space = space
        self.opts = opts
        self.cache: dict[tuple, float] = {}
        self.evaluations = 0
        use_device = opts.backend == "torch" or (
            opts.backend == "auto"
            and self.problem.n <= opts.device_task_limit)
        self._jd = TorchDES(self.problem, options=opts.des_options) \
            if use_device else None

    def __call__(self, genomes: list[np.ndarray]) -> np.ndarray:
        out = np.empty(len(genomes))
        todo: list[int] = []
        for i, g in enumerate(genomes):
            key = tuple(int(v) for v in g)
            if key in self.cache:
                out[i] = self.cache[key]
            else:
                todo.append(i)
        if todo:
            self.evaluations += len(todo)
            if self._jd is not None:
                xs = np.stack([self.space.to_matrix(genomes[i])
                               for i in todo])
                ms, feas = self._jd.batch_makespan(xs)
                vals = np.where(feas, ms, INF)
            else:
                vals = np.array([
                    simulate(self.problem,
                             self.space.to_matrix(genomes[i])).makespan
                    for i in todo])
            for i, v in zip(todo, vals):
                key = tuple(int(x) for x in genomes[i])
                score = float(v)
                if np.isfinite(score):
                    score += self.opts.port_weight * float(genomes[i].sum())
                self.cache[key] = score
                out[i] = score
        return out


def delta_fast(dag: CommDAG, opts: GAOptions | None = None,
               xbar: np.ndarray | None = None,
               seeds: list[np.ndarray] | None = None) -> GAResult:
    """Alg. 3: SimBasedDomainAdaptedGA."""
    opts = opts or GAOptions()
    rng = np.random.default_rng(opts.seed)
    space = TopologySpace(dag, xbar)
    fit = _Fitness(dag, space, opts)
    t0 = time.time()

    pop = [space.feasible_random_init(rng) for _ in range(opts.pop_size)]
    # seed candidates (e.g. baselines) -- repaired into the population
    for s in (seeds or []):
        g = np.array([s[i, j] for (i, j) in space.edges], dtype=np.int64)
        g, ok = space.repair(g, rng)
        if ok:
            pop[rng.integers(len(pop))] = g
    fitness = fit(pop)
    best_i = int(np.argmin(fitness))
    best_g, best_f = pop[best_i].copy(), float(fitness[best_i])
    history = [best_f]
    n_elite = max(1, int(opts.elite_frac * opts.pop_size))
    stall = 0
    gen = 0

    while gen < opts.max_generations:
        gen += 1
        if time.time() - t0 > opts.time_limit or stall >= opts.patience:
            break
        order = np.argsort(fitness)
        new_pop = [pop[i].copy() for i in order[:n_elite]]
        while len(new_pop) < opts.pop_size:
            a = _tournament(pop, fitness, rng, opts.tournament)
            b = _tournament(pop, fitness, rng, opts.tournament)
            child = _crossover(a, b, rng) if \
                rng.random() < opts.crossover_rate else a.copy()
            child = _mutate(child, space, rng, opts.mutation_rate)
            child, ok = space.repair(child, rng)
            if not ok:
                child = space.feasible_random_init(rng)
            new_pop.append(child)
        pop = new_pop
        fitness = fit(pop)
        i = int(np.argmin(fitness))
        if fitness[i] < best_f - 1e-15:
            best_f, best_g = float(fitness[i]), pop[i].copy()
            stall = 0
        else:
            stall += 1
        history.append(best_f)

    # re-rank the best distinct candidates with the exact numpy DES (the
    # batched torch fitness runs in float32; ~1e-5 ranking noise)
    ranked = sorted(fit.cache.items(), key=lambda kv: kv[1])[:8]
    best_x, best_ms = space.to_matrix(best_g), INF
    for key, fval in ranked:
        if not np.isfinite(fval):
            continue
        x = space.to_matrix(np.asarray(key, dtype=np.int64))
        ms = simulate(fit.problem, x).makespan
        port_pen = opts.port_weight * float(np.asarray(key).sum())
        if ms + port_pen < best_ms:
            best_ms, best_x = ms + port_pen, x
    ms = simulate(fit.problem, best_x).makespan
    return GAResult(x=best_x, makespan=float(ms), generations=gen,
                    evaluations=fit.evaluations, elapsed=time.time() - t0,
                    history=history, feasible=np.isfinite(ms))


def _tournament(pop, fitness, rng, k) -> np.ndarray:
    idx = rng.integers(0, len(pop), size=k)
    return pop[idx[np.argmin(fitness[idx])]]


def _crossover(a: np.ndarray, b: np.ndarray, rng) -> np.ndarray:
    mask = rng.random(len(a)) < 0.5
    return np.where(mask, a, b)


def _mutate(g: np.ndarray, space: TopologySpace, rng, rate: float
            ) -> np.ndarray:
    out = g.copy()
    for e in range(len(out)):
        if rng.random() < rate:
            out[e] += rng.choice((-1, 1))
    return np.clip(out, 1, space.xbar)


def trim_ports(dag: CommDAG, x: np.ndarray, rel_tol: float = 1e-6
               ) -> np.ndarray:
    """Greedy port minimization for heuristic topologies (beyond-paper
    DELTA-Fast counterpart of Eq. 4): repeatedly drop the circuit whose
    removal leaves the DES makespan unchanged, exploiting the temporal
    slack of non-critical tasks."""
    problem = DESProblem(dag)
    base = simulate(problem, x).makespan
    if not np.isfinite(base):
        return x
    x = x.copy()
    budget = base * (1 + rel_tol)
    improved = True
    while improved:
        improved = False
        for i, j in dag.undirected_pairs():
            if x[i, j] <= 1:
                continue
            x[i, j] -= 1
            x[j, i] -= 1
            if simulate(problem, x).makespan <= budget:
                improved = True
            else:
                x[i, j] += 1
                x[j, i] += 1
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
