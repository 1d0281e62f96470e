"""The comparison with the plain reference that decides `correct`.

It runs once the window has closed, on what the timed path produced:

  lane_gap       the torch DES on the card: the widest relative gap
                 between a lane's makespan and the reference's float64
                 DES of the same genome, over a sample of the window's
                 scored lanes drawn from the seed, each plan's best lane
                 with them (a feasibility that disagrees is an infinite
                 gap)
  plan_ms_gap    each plan's certified makespan against the reference's
  plan_nct_gap   each plan's NCT against the reference's (its ideal run
                 and critical path worked out again)
  plan_excess    how far each plan's topology is worse, by the reference,
                 than the best lane its own search scored (0 when better)
  xbar_diff      entries of the X̄ the GA searched within that differ
                 from the reference's Alg. 2
  x_outside      entries of a plan's topology outside [1, X̄] on an active
                 pair, off zero elsewhere or not symmetric, plus ports
                 over a pod's limit
  ports_diff     a plan's reported port count against its topology's
  xbar_sum_diff  the reference's X̄ total over the active pairs against
                 the configuration's

`control_readings` gives the same gaps with the reference itself put in
the program's place, one precision lower (bfloat16 for the card's float32
lanes, float32 for the host's float64 certification).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from reference.des import BFLOAT16, FLOAT32, FLOAT64, Problem, Precision, \
    ideal_run, simulate
from reference.xbound import x_upper_bound

INF = float("inf")


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)     # a NaN fails


def rel_gap(got: float, want: float) -> float:
    if np.isfinite(want) and np.isfinite(got):
        return abs(got - want) / max(abs(want), 1e-300)
    return 0.0 if got == want else INF


def topology(genome: np.ndarray, edge_u: np.ndarray, edge_v: np.ndarray,
             pods: int) -> np.ndarray:
    x = np.zeros((pods, pods), dtype=np.int64)
    x[edge_u, edge_v] = genome
    x[edge_v, edge_u] = genome
    return x


@dataclass
class Lane:
    request: int
    genome: np.ndarray
    edge_u: np.ndarray
    edge_v: np.ndarray
    makespan: float          # the card's
    feasible: bool


def lanes_of(probe) -> list[Lane]:
    """Every distinct (request, genome) the card scored, once."""
    seen: set[tuple[int, bytes]] = set()
    out: list[Lane] = []
    for b in probe.batches:
        for g, ms, ok in zip(b.genomes, b.makespan, b.feasible):
            key = (b.request, g.tobytes())
            if key not in seen:
                seen.add(key)
                out.append(Lane(b.request, g, b.edge_u, b.edge_v, float(ms),
                                bool(ok)))
    return out


def pick_lanes(lanes: list[Lane], k: int, seed: int
               ) -> tuple[list[Lane], dict[int, Lane]]:
    """Each request's best lane (the card's lowest feasible makespan) and
    `k` more drawn from the seed among the rest."""
    best: dict[int, Lane] = {}
    for ln in lanes:
        if ln.feasible and (ln.request not in best
                            or ln.makespan < best[ln.request].makespan):
            best[ln.request] = ln
    rest = [ln for ln in lanes if not any(ln is b for b in best.values())]
    rng = np.random.default_rng([abs(int(seed)), 1])
    idx = rng.choice(len(rest), size=min(k, len(rest)), replace=False)
    return list(best.values()) + [rest[i] for i in sorted(idx)], best


class Judge:
    """The reference's view of one DAG: X̄, the ideal run and the float64
    makespan of any topology (memoised)."""

    def __init__(self, raw):
        self.raw = raw
        self.problem = Problem(raw)
        self.xbar = x_upper_bound(raw)
        self.ideal = ideal_run(self.problem)
        self._runs: dict[tuple[str, bytes], object] = {}

    def run(self, x: np.ndarray, pr: Precision = FLOAT64):
        key = (pr.name, np.ascontiguousarray(x, dtype=np.int64).tobytes())
        res = self._runs.get(key)
        if res is None:
            res = self._runs[key] = simulate(self.problem, x, pr=pr)
        return res

    def nct(self, res) -> float:
        ideal = self.ideal.comm_time
        return res.comm_time / ideal if ideal > 0 else INF

    def xbar_sum(self) -> int:
        """X̄ summed over the active pod pairs, each pair once."""
        return int(sum(self.xbar[i, j]
                       for i, j in self.raw.undirected_pairs()))

    def outside(self, x: np.ndarray) -> int:
        """Entries of `x` out of bounds, plus ports over the pods' limits."""
        x = np.asarray(x, dtype=np.int64)
        active = self.xbar > 0
        bad = (active & ((x < 1) | (x > self.xbar))) | (~active & (x != 0))
        over = np.clip(x.sum(axis=1) - np.asarray(self.raw.port_limits),
                       0, None)
        return int(bad.sum() + (x != x.T).sum() + over.sum())


def compare(records, probe, judge: Judge, config: dict, lanes_k: int,
            seed: int, limits: dict[str, float]
            ) -> tuple[list[Check], dict]:
    """The checks of one run, each with its limit, and what they covered."""
    worst = {name: 0.0 for name in limits}
    P = judge.raw.num_pods
    sample, best = pick_lanes(lanes_of(probe), lanes_k, seed)
    for ln in sample:
        ref = judge.run(topology(ln.genome, ln.edge_u, ln.edge_v, P))
        gap = rel_gap(ln.makespan, ref.makespan) \
            if ln.feasible == ref.feasible else INF
        worst["lane_gap"] = max(worst["lane_gap"], gap)
    for rec in records:
        if not rec.ok:
            continue
        ref = judge.run(rec.x)
        worst["plan_ms_gap"] = max(worst["plan_ms_gap"],
                                   rel_gap(rec.makespan, ref.makespan))
        worst["plan_nct_gap"] = max(worst["plan_nct_gap"],
                                    rel_gap(rec.nct, judge.nct(ref)))
        worst["x_outside"] += judge.outside(rec.x)
        worst["ports_diff"] += abs(rec.total_ports - int(rec.x.sum()))
        lane = best.get(rec.request)
        if lane is None:
            worst["plan_excess"] = INF      # a plan that scored no lane
        else:
            ref_best = judge.run(topology(lane.genome, lane.edge_u,
                                          lane.edge_v, P))
            worst["plan_excess"] = max(worst["plan_excess"], max(
                0.0, ref.makespan / ref_best.makespan - 1.0))
    for _, xbar in probe.xbars:
        worst["xbar_diff"] += int((np.asarray(xbar) != judge.xbar).sum())
    worst["xbar_sum_diff"] = abs(judge.xbar_sum()
                                 - int(config["expect"]["xbar_sum"]))
    checks = [Check(name, float(worst[name]), float(limit))
              for name, limit in limits.items()]
    info = {"lanes_checked": len(sample),
            "lanes_scored": sum(len(b.genomes) for b in probe.batches),
            "plans_checked": sum(1 for r in records if r.ok)}
    return checks, info


def control_readings(records, probe, judge: Judge, lanes_k: int, seed: int
                     ) -> dict[str, float]:
    """The gaps the reference one precision lower would read in the
    program's place, on the same lanes and plans as `compare`."""
    P = judge.raw.num_pods
    sample, _ = pick_lanes(lanes_of(probe), lanes_k, seed)
    lane_gap = 0.0
    for ln in sample:
        x = topology(ln.genome, ln.edge_u, ln.edge_v, P)
        low, ref = judge.run(x, BFLOAT16), judge.run(x)
        gap = rel_gap(low.makespan, ref.makespan) \
            if low.feasible == ref.feasible else INF
        lane_gap = max(lane_gap, gap)
    ms_gap = nct_gap = 0.0
    low_ideal = ideal_run(judge.problem, FLOAT32)
    for rec in records:
        if rec.ok:
            low, ref = judge.run(rec.x, FLOAT32), judge.run(rec.x)
            ms_gap = max(ms_gap, rel_gap(low.makespan, ref.makespan))
            low_nct = low.comm_time / low_ideal.comm_time
            nct_gap = max(nct_gap, rel_gap(low_nct, judge.nct(ref)))
    return {"lane_gap": lane_gap, "plan_ms_gap": ms_gap,
            "plan_nct_gap": nct_gap}
