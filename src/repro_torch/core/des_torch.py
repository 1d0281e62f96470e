"""PyTorch discrete-event simulator, batched over topologies.

The port of `repro/core/des_jax.py` (the TPU-native "ParallelEvalDES" of
paper Alg. 3 line 2).  Semantics match `repro_torch.core.des.simulate`,
the exact numpy oracle, to float32 tolerance; only makespan, feasibility,
start and finish are produced (the critical path stays on the numpy
engine).

Where the reference runs `jax.vmap` over a `lax.while_loop`, this engine
carries the population as a leading axis of every state tensor and drives
the loops from Python:

  * the event loop advances every lane to its next *distinct* event time
    per trip and retires every completion and start landing there, so
    the trip count is bounded by the distinct event times (<= 2n + 16);
  * the inner max-min rounds run their fused (used, denom) reduction
    through `repro_torch.kernels.ops.fill_round`: the hand-written Hopper
    kernel on a CUDA device (backend 'cuda'), a dense torch matmul on the
    CPU ('ref'), or an `index_add_` over the incidence entries
    ('segment');
  * a lane whose own loop condition is false is frozen: every state
    update is masked with the lane's running flag, as a batched
    `while_loop` selects only the lanes whose condition holds.  (A
    finished lane has t = -inf; stepping it would give NaN.)

The host reads one flag per event trip and one per filling round; a loop
without host syncs (a CUDA graph or a persistent kernel) is later work.

Problems are padded to quantized (tasks, deps, incidence, links) buckets
with ghost semantics (`_problem_fields`), so padded results equal the
exact-shape simulation up to float summation order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import (DESArrays, des_arrays_from_numpy,
                                 topology_from_numpy)
from repro_torch.core.des import DESProblem
from repro_torch.kernels import ops
from repro_torch.obs import get_counter, span

__all__ = ["DESArrays", "DESOptions", "PadSpec", "TorchDES",
           "default_max_events", "MAXMIN_BACKENDS"]

INF = math.inf
MAXMIN_BACKENDS = ("auto", "cuda", "ref", "segment")
BUCKET_QUANTUM = 64        # tasks, deps and incidence entries round up to this
BUCKET_QUANTUM_CONS = 8    # link and NIC constraint blocks round up to this

# float32 coalescing bands of the reference engine (des_jax.py:359-363)
EPS = 1e-6      # start events: ready <= t * (1 + EPS) + EPS * 1e-3
VEPS = 1e-5     # completion: remaining volume below VEPS * volume
# completion: remaining *time* below the float time resolution at t --
# otherwise `t + dt == t` stalls the simulation
TEPS = 1e-5

_TRIPS = get_counter("des_event_trips_total",
                     "torch DES event-loop trips (batched over lanes)")
_ROUNDS = get_counter("des_fill_rounds_total",
                      "torch DES max-min filling rounds (batched over lanes)")


# ------------------------------------------------------------------ options
@dataclass(frozen=True)
class DESOptions:
    """Engine knobs for `TorchDES`.

      backend  'auto' -> 'cuda' (the Hopper kernel) on a CUDA device,
               'ref' (dense torch matmul) on the CPU; 'segment' is the
               index_add path over the incidence entries
      device   None -> 'cuda'; without a CUDA device that raises rather
               than run on the CPU, which needs device='cpu'
      bucket   pad the problem to the BUCKET_QUANTUM buckets
    """

    backend: str = "auto"
    device: str | None = None
    bucket: bool = True

    def resolve_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the torch DES runs on a CUDA device and none is "
                "available; pass DESOptions(device='cpu') to run it on "
                "the CPU")
        return torch.device("cuda")

    def resolve_backend(self, device: torch.device) -> str:
        if self.backend not in MAXMIN_BACKENDS:
            raise ValueError(f"unknown DES backend {self.backend!r}; "
                             f"pick from {MAXMIN_BACKENDS}")
        if self.backend == "auto":
            return "cuda" if device.type == "cuda" else "ref"
        if self.backend == "cuda" and device.type != "cuda":
            raise ValueError(f"DES backend 'cuda' needs a CUDA device, "
                             f"got {device}")
        return self.backend


class PadSpec(NamedTuple):
    """Padded array sizes: tasks, deps, incidence entries, link constraints
    and total constraints (links + NIC classes, by position in `caps`)."""
    n: int
    d: int
    e: int
    links: int
    cons: int

    @classmethod
    def exact(cls, p: DESProblem) -> "PadSpec":
        return cls(n=p.n, d=len(p.dep_pre), e=len(p.con_task),
                   links=p.num_link_cons, cons=p.num_cons)

    def bucketed(self, quantum: int = BUCKET_QUANTUM,
                 quantum_cons: int = BUCKET_QUANTUM_CONS) -> "PadSpec":
        links = _round_up(self.links, quantum_cons)
        return PadSpec(n=_round_up(self.n, quantum),
                       d=_round_up(self.d, quantum),
                       e=_round_up(self.e, quantum), links=links,
                       cons=links + _round_up(self.cons - self.links,
                                              quantum_cons))


def _round_up(v: int, q: int) -> int:
    return int(math.ceil(max(int(v), 1) / q) * q)


def default_max_events(n: int) -> int:
    """Safety bound on event-loop trips: every trip retires at least one
    start or one completion event, and each task does each exactly once."""
    return 2 * int(n) + 16


def _pad_to(a: np.ndarray, size: int, fill) -> np.ndarray:
    """Right-pad a 1-D array to `size` with `fill`."""
    a = np.asarray(a)
    if len(a) == size:
        return a
    out = np.full(size, fill, dtype=a.dtype)
    out[:len(a)] = a
    return out


def _problem_fields(p: DESProblem, pad: PadSpec) -> dict[str, np.ndarray]:
    """One problem's DES arrays padded to `pad` with ghost semantics.

      * ghost tasks: volume 0, flows 1, `task_valid` False -- born done,
        never scheduled;
      * ghost deps: (0 -> 0, delta 0) -- target the virtual task, which is
        done at t=0, so they never gate readiness;
      * ghost incidence entries: (task 0, constraint 0, weight 0) -- zero
        contribution to every used/denom reduction;
      * ghost link constraints: pair (0, 0) -- capacity x[0,0] == 0 with
        no members, never binding;
      * ghost NIC constraints: capacity 1 with no members, never binding.

    Constraint ids are remapped so the NIC block starts at the padded link
    count.  Volumes are rescaled to seconds at one-circuit rate (B == 1).
    Equal, array for array, to the JAX reference's `_problem_fields`.
    """
    cp = p.con_ptr
    con_id = np.repeat(np.arange(p.num_cons), np.diff(cp))
    con_id = np.where(con_id >= p.num_link_cons,
                      con_id + (pad.links - p.num_link_cons), con_id)
    pairs = np.array(p.pairs, dtype=np.int32).reshape(-1, 2)
    if p.volume[1:].min(initial=np.inf) <= 0:
        raise ValueError("the torch DES requires positive real-task volumes")
    return {
        "volume": _pad_to(p.volume / p.B, pad.n, 0.0),
        "flows": _pad_to(p.flows, pad.n, 1.0),
        "dep_pre": _pad_to(p.dep_pre.astype(np.int32), pad.d, 0),
        "dep_succ": _pad_to(p.dep_succ.astype(np.int32), pad.d, 0),
        "dep_delta": _pad_to(p.dep_delta, pad.d, 0.0),
        "indegree": _pad_to(p.indegree.astype(np.int32), pad.n, 0),
        "con_task": _pad_to(p.con_task.astype(np.int32), pad.e, 0),
        "con_id": _pad_to(con_id.astype(np.int32), pad.e, 0),
        "con_w": _pad_to(p.con_w, pad.e, 0.0),
        "link_pair_a": _pad_to(pairs[:, 0], pad.links, 0),
        "link_pair_b": _pad_to(pairs[:, 1], pad.links, 0),
        "task_valid": _pad_to(np.ones(p.n, dtype=bool), pad.n, False),
    }


def _dense_incidence(a: DESArrays) -> torch.Tensor:
    """(C, n) constraint-task weight matrix for the dense backends (ghost
    incidence entries add zero weight)."""
    w = torch.zeros((a.num_cons, a.n), dtype=torch.float32,
                    device=a.volume.device)
    return w.index_put_((a.con_id, a.con_task), a.con_w, accumulate=True)


# --------------------------------------------------------- fair-share rates
def _maxmin(a: DESArrays, active: torch.Tensor, caps: torch.Tensor,
            backend: str = "segment", W: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Weighted max-min fair task rates (progressive filling) for an
    (S, n) batch of active sets under (S, C) capacities.

    Each filling round needs, per constraint c, the fused reduction pair
    ``used_c = sum_m W[c,m] phi_m active_m`` / ``denom_c = sum_m W[c,m]
    unfrozen_m``: 'segment' takes it as one `index_add_` over the
    incidence entries, 'cuda'/'ref' as `ops.fill_round` over the dense
    incidence `W` (`_dense_incidence`).  A lane whose unfrozen set is
    empty has stopped: every update is masked with `unfrozen`, so it
    stays as it was while the other lanes go on."""
    S, n, C = active.shape[0], a.n, a.num_cons
    dev, f32 = a.volume.device, torch.float32
    if backend != "segment" and W is None:
        W = _dense_incidence(a)
    active_f = active.to(f32)
    phi = torch.zeros((S, n), dtype=f32, device=dev)
    unfrozen = active.clone()
    if backend == "segment":
        # loop-invariant active-membership weights
        act_w = torch.where(active[:, a.con_task], a.con_w, 0.0)
    for _ in range(C + 1):
        if not bool(unfrozen.any()):          # one host sync per round
            break
        _ROUNDS.inc()
        if backend == "segment":
            unf_w = torch.where(unfrozen[:, a.con_task], a.con_w, 0.0)
            vals = torch.stack([act_w * phi[:, a.con_task], unf_w], -1)
            out = torch.zeros((S, C, 2), dtype=f32, device=dev)
            out.index_add_(1, a.con_id, vals)
            used, denom = out[..., 0], out[..., 1]
        else:
            used, denom = ops.fill_round(W, phi * active_f, unfrozen.to(f32),
                                         backend=backend)
        # the reference divides by max(denom, 1e-300); in float32 that
        # clamp is 0, and where() drops the denom == 0 constraints
        alpha_c = torch.where(denom > 0, (caps - used) / denom, INF)
        alpha = alpha_c.amin(1).clamp_min(0.0)
        phi = torch.where(unfrozen, phi + alpha[:, None], phi)
        # (1 + 1e-9) rounds to 1 in float32, as in the reference
        sat = torch.isfinite(alpha_c) & (
            alpha_c <= (alpha * (1 + 1e-9) + 1e-18)[:, None])
        hits = torch.zeros((S, n), dtype=f32, device=dev)
        hits.index_add_(1, a.con_task, sat[:, a.con_id].to(f32))
        unfrozen = unfrozen & (hits == 0)
    return a.flows * phi * active_f


# ------------------------------------------------------------------ engine
class TorchDES:
    """Single and batched simulation of one CommDAG on one device.

    `arrays` replaces the problem's own padded arrays (`convert.
    des_arrays_from_numpy` of another engine's fields); `problem` then
    still gives the pod count and the task count of the result.
    """

    def __init__(self, problem: DESProblem, max_events: int | None = None,
                 options: DESOptions | None = None,
                 arrays: DESArrays | None = None):
        self.problem = problem
        self.options = options or DESOptions()
        self.device = self.options.resolve_device()
        self.backend = self.options.resolve_backend(self.device)
        if arrays is None:
            pad = PadSpec.exact(problem)
            if self.options.bucket:
                pad = pad.bucketed()
            arrays = des_arrays_from_numpy(_problem_fields(problem, pad),
                                           pad, self.device)
        elif arrays.volume.device != self.device:
            raise ValueError(f"arrays live on {arrays.volume.device}, the "
                             f"engine on {self.device}")
        self.arrays = a = arrays
        self.pad = PadSpec(n=a.n, d=len(a.dep_pre), e=len(a.con_task),
                           links=a.num_link_cons, cons=a.num_cons)
        self.max_events = int(max_events or default_max_events(a.n))
        self.P = problem.dag.cluster.num_pods
        # dense incidence for the kernel backends, built once per engine
        # and shared by every round of every trip of every lane
        self.W = _dense_incidence(a) if self.backend != "segment" else None
        # x-independent initial state: virtual task 0 and the padding
        # ghosts are born done at t=0; deps from task 0 are met
        self._started0 = ~a.task_valid
        self._started0[0] = True
        from_virtual = torch.zeros(a.n, dtype=torch.int32, device=self.device)
        from_virtual.index_add_(0, a.dep_succ, (a.dep_pre == 0).to(
            torch.int32))
        self._missing0 = a.indegree - from_virtual

    # ------------------------------------------------------------ event loop
    def _retire_starts(self, t_now, started, finish, missing):
        """Start every pending task whose ready time has arrived at
        `t_now` (S,); returns the next pending ready time as well."""
        a = self.arrays
        lag = finish[:, a.dep_pre] + a.dep_delta
        ready = torch.zeros_like(finish)
        ready.scatter_reduce_(1, a.dep_succ.expand(finish.shape[0], -1),
                              lag, "amax", include_self=True)
        ready = torch.where((missing == 0) & ~started, ready, INF)
        newly = ready <= (t_now * (1 + EPS) + EPS * 1e-3)[:, None]
        t_ready = torch.where(newly, INF, ready).amin(1)
        return started | newly, newly, ready, t_ready

    def _simulate(self, xs: torch.Tensor, mask: torch.Tensor,
                  ideal: bool = False):
        """(S, P, P) topologies -> (makespan, feasible, start, finish),
        each with a leading lane axis."""
        a = self.arrays
        S, n, dev = xs.shape[0], a.n, self.device
        f32 = torch.float32
        pa, pb = a.link_pair_a, a.link_pair_b
        link_caps = xs[:, pa, pb].to(f32) * mask[pa, pb].to(f32)
        if ideal:
            link_caps = torch.full_like(link_caps, INF)
        caps = torch.cat([link_caps, torch.ones(
            (S, a.num_cons - a.num_link_cons), dtype=f32, device=dev)], 1)

        rem = a.volume.expand(S, n)
        started = self._started0.expand(S, n)
        done = started
        start = torch.where(started, 0.0, INF)
        finish = start
        missing = self._missing0.expand(S, n)
        t = torch.zeros(S, dtype=f32, device=dev)
        # retire the t=0 start events before the loop
        started, newly, ready, t_ready = self._retire_starts(
            t, started, finish, missing)
        start = torch.where(newly, ready, start)
        feasible = torch.ones(S, dtype=torch.bool, device=dev)

        for _ in range(self.max_events):
            run = torch.isfinite(t) & feasible
            if not bool(run.any()):           # one host sync per trip
                break
            _TRIPS.inc()
            active = started & ~done
            rates = _maxmin(a, active & run[:, None], caps,
                            self.backend, self.W)
            feas_new = feasible & torch.where(active, rates > 0, True).all(1)
            # rem / max(rates, 1e-300) in the reference: the clamp is 0 in
            # float32 and where() drops the rate-0 tasks
            dt_done = torch.where(active & (rates > 0), rem / rates, INF)
            t_next = torch.minimum(t + dt_done.amin(1), t_ready)
            dt = (t_next - t).clamp_min(0.0)
            rem_new = torch.where(
                active, (rem - rates * dt[:, None]).clamp_min(0.0), rem)
            dt_rem = dt_done - dt[:, None]
            newdone = active & torch.isfinite(t_next)[:, None] & (
                (rem_new <= VEPS * a.volume.clamp_min(1e-9))
                | (dt_rem <= (TEPS * t_next.clamp_min(1e-9))[:, None]))
            finish_new = torch.where(newdone, t_next[:, None], finish)
            done_new = done | newdone
            met = torch.zeros((S, n), dtype=torch.int32, device=dev)
            met.index_add_(1, a.dep_succ, newdone[:, a.dep_pre].to(
                torch.int32))
            missing_new = missing - met
            # retire the start events at t_next in the same trip (readiness
            # against the post-completion finish/missing state)
            started_new, newly, ready, t_ready_new = self._retire_starts(
                t_next, started, finish_new, missing_new)
            start_new = torch.where(newly, ready, start)
            t_new = torch.where(done_new.all(1), -INF, t_next)  # exit flag

            r = run[:, None]
            t = torch.where(run, t_new, t)
            t_ready = torch.where(run, t_ready_new, t_ready)
            feasible = torch.where(run, feas_new, feasible)
            rem = torch.where(r, rem_new, rem)
            started = torch.where(r, started_new, started)
            done = torch.where(r, done_new, done)
            start = torch.where(r, start_new, start)
            finish = torch.where(r, finish_new, finish)
            missing = torch.where(r, missing_new, missing)

        feasible = feasible & done.all(1)
        last = torch.where(torch.isfinite(finish), finish, -INF).amax(1)
        makespan = torch.where(feasible, last, INF)
        return makespan, feasible, start, finish

    # ------------------------------------------------------------ entries
    def _mask(self, mask) -> torch.Tensor:
        """(P, P) link-availability factor (1 = healthy, 0 = dark); None
        means a healthy fabric.  It scales link capacities only."""
        if mask is None:
            return torch.ones((self.P, self.P), dtype=torch.float32,
                              device=self.device)
        return topology_from_numpy(np.asarray(mask, dtype=np.float32),
                                   self.device)

    def makespan(self, x, ideal: bool = False, mask=None) -> float:
        return self.simulate(x, ideal=ideal, mask=mask)[0]

    def simulate(self, x, ideal: bool = False, mask=None):
        """(makespan, feasible, start, finish) of one (P, P) topology, with
        the padding ghosts stripped from start/finish."""
        with span("des.simulate", entry="single", n=self.pad.n):
            xs = topology_from_numpy(x, self.device)[None]
            ms, feas, start, finish = self._simulate(xs, self._mask(mask),
                                                     ideal)
            n = self.problem.n
            return (float(ms[0]), bool(feas[0]),
                    start[0, :n].cpu().numpy(), finish[0, :n].cpu().numpy())

    def batch_makespan(self, xs, mask=None) -> tuple[np.ndarray, np.ndarray]:
        """Makespans + feasibility for a (pop, P, P) batch of topologies."""
        xs = topology_from_numpy(xs, self.device)
        with span("des.simulate", entry="batch_x", n=self.pad.n,
                  pop=int(xs.shape[0])):
            ms, feas, _, _ = self._simulate(xs, self._mask(mask))
            return ms.cpu().numpy(), feas.cpu().numpy()

    def batch_genome_makespan(self, genomes, edge_u, edge_v, mask=None
                              ) -> tuple[np.ndarray, np.ndarray]:
        """GA generation-step fitness: scatter a (pop, E) genome batch onto
        (pop, P, P) topologies on the device and simulate them as one
        batch -- one host->device copy of the genomes, one device->host
        copy of (makespan, feasible)."""
        g = topology_from_numpy(genomes, self.device)
        eu = topology_from_numpy(np.asarray(edge_u, dtype=np.int64),
                                 self.device)
        ev = topology_from_numpy(np.asarray(edge_v, dtype=np.int64),
                                 self.device)
        with span("des.simulate", entry="batch_genomes", n=self.pad.n,
                  pop=int(g.shape[0])):
            xs = torch.zeros((g.shape[0], self.P, self.P), dtype=g.dtype,
                             device=self.device)
            xs[:, eu, ev] = g
            xs[:, ev, eu] = g
            ms, feas, _, _ = self._simulate(xs, self._mask(mask))
            return ms.cpu().numpy(), feas.cpu().numpy()
