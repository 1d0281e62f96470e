"""PyTorch discrete-event simulator, batched over topologies.

The port of `repro/core/des_jax.py` (the TPU-native "ParallelEvalDES" of
paper Alg. 3 line 2).  Semantics match `repro_torch.core.des.simulate`,
the exact numpy oracle, to float32 tolerance; only makespan, feasibility,
start and finish are produced (the critical path stays on the numpy
engine).

Where the reference runs `jax.vmap` over a `lax.while_loop`, this engine
carries the lanes as leading axes of every state tensor and drives the
loops from Python.  A lane is one (genome, member) pair: `TorchDES`
simulates one problem (one member), `EnsembleTorchDES` the M members of a
`DagEnsemble` padded to one shape (`stack_problems`), as the reference's
`EnsembleJaxDES` vmaps over them; both run the one event loop of
`_LaneDES`, whose state is (genomes, members, tasks) and whose gathers and
scatters read each lane's own member's arrays.

  * the event loop advances every lane to its next *distinct* event time
    per trip and retires every completion and start landing there, so
    the trip count is bounded by the distinct event times (<= 2n + 16);
  * the max-min fair rates of a trip (progressive filling) come from
    `repro_torch.kernels.ops.fill_maxmin`: on a CUDA device (backend
    'cuda') one launch of the hand-written Hopper kernel runs every
    filling round of every lane, with the incidence as CSR in shared
    memory; on the CPU ('ref') its plain version drives the rounds.
    'cuda-round' drives the rounds from the host with one
    `ops.fill_round` launch each (the per-round kernel over the dense
    incidence), 'segment' with one `index_add_` over the incidence
    entries;
  * a lane whose own loop condition is false is frozen: every state
    update is masked with the lane's running flag, as a batched
    `while_loop` selects only the lanes whose condition holds.  (A
    finished lane has t = -inf; stepping it would give NaN.)

On 'cuda' the event loop runs as a CUDA graph of GRAPH_TRIPS trips
(`_TripGraph`): the host replays it and reads one exit flag per replay,
none per trip and none per filling round.  Each trip of the graph also
stops every lane at `max_events` trips, and trips after every lane has
stopped change nothing, so the graph gives the eager loop's results to
the bit.  The eager loop, which reads one flag per trip, serves the other
backends; the host-driven ones read one flag per round as well.

Nothing is counted inside a trip: each simulation counts its trips (those
in which some lane ran; on 'cuda' summed on the device and read with the
exit flag) and its host reads of device values (the exit tests, the
rounds read; not the host-driven backends' round flags) and adds them to
`des_event_trips_total` and `des_host_syncs_total` once at its end; the
entry points' result copies add to `des_host_syncs_total` where they are
made (`_to_host`).  `des_fill_rounds_total` is kept on the device and read
once per simulation, and only while the tracer is on (decided at the
simulation's start), so an untraced trip launches nothing for it.  On
'cuda', `des_graph_captures_total` and `des_graph_replays_total` count
the graphs' work, and `des_graph_idle_trips_total` the trips the device
ran after every lane had stopped (each still launches `fill_maxmin`):
the trips taken, counted on the device, less the trips in which some lane
ran.  `waterfill.maxmin_launches` counts only the launches made from the
host (the warm-up's); a replay's GRAPH_TRIPS launches are seen in a device
trace, and the host knows them only as GRAPH_TRIPS per replay.

Problems are padded to quantized (tasks, deps, incidence, links) buckets
with ghost semantics (`_problem_fields`), so padded results equal the
exact-shape simulation up to float summation order.  Every construction
counts its bucket in a module-level LRU of bucket signatures (the
reference's compile cache): fleet replans, ensemble members and trim
candidates that land in an existing bucket count as hits, a new bucket as
a miss (`des_cache_stats()`).  An entry holds the bucket's trip graphs on
'cuda', one per lane count and tracing state, captured at the first
simulation that needs one; every engine of the bucket replays them on its
own arrays.  At most GRAPHS_KEPT graphs are kept, the least recently
replayed dropped first, and a bucket's graphs go with it when it is
evicted, so the device memory they hold does not grow with the buckets.
"""
from __future__ import annotations

import functools
import math
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.convert import (DESArrays, des_arrays_from_numpy,
                                 topology_from_numpy)
from repro_torch.core.des import DESProblem
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (csr_con_id, csr_warp_sums,
                                     progressive_filling)
from repro_torch.obs import TRACER, get_counter, get_gauge, get_logger, span

__all__ = ["DESArrays", "DESOptions", "EnsembleTorchDES", "PadSpec",
           "TorchDES", "default_max_events", "des_cache_clear",
           "des_cache_stats", "member_pad", "plane_state_genomes",
           "stack_problems", "MAXMIN_BACKENDS"]

INF = math.inf
MAXMIN_BACKENDS = ("auto", "cuda", "cuda-round", "ref", "segment")
BUCKET_QUANTUM = 64        # tasks, deps and incidence entries round up to this
BUCKET_QUANTUM_CONS = 8    # link and NIC constraint blocks round up to this
CACHE_SIZE = 64           # engine-cache buckets kept, least recent evicted
GRAPH_TRIPS = 16          # event trips per CUDA-graph replay on 'cuda'
GRAPHS_KEPT = 16          # trip graphs kept on 'cuda', least recent dropped

# float32 coalescing bands of the reference engine (des_jax.py:359-363)
EPS = 1e-6      # start events: ready <= t * (1 + EPS) + EPS * 1e-3
VEPS = 1e-5     # completion: remaining volume below VEPS * volume
# completion: remaining *time* below the float time resolution at t --
# otherwise `t + dt == t` stalls the simulation
TEPS = 1e-5

_TRIPS = get_counter("des_event_trips_total",
                     "torch DES event-loop trips in which some lane ran "
                     "(batched over lanes)")
_ROUNDS = get_counter("des_fill_rounds_total",
                      "torch DES max-min filling rounds (batched over lanes; "
                      "counted while tracing is on)")
_SYNCS = get_counter("des_host_syncs_total",
                     "torch DES host reads of device values: exit tests (one "
                     "per trip, or per graph replay on 'cuda'), the rounds "
                     "read, result copies")
_CAPTURES = get_counter("des_graph_captures_total",
                        "torch DES event-trip CUDA graphs captured")
_REPLAYS = get_counter("des_graph_replays_total",
                       "torch DES event-trip CUDA graph replays")
_IDLE_TRIPS = get_counter("des_graph_idle_trips_total",
                          "torch DES trips a graph or its warm-up ran after "
                          "every lane had stopped (counted on the device)")

_log = get_logger("repro_torch.des_torch")


def _to_host(*ts: torch.Tensor) -> list[np.ndarray]:
    """Copy device results to the host, each copy one counted host sync."""
    _SYNCS.inc(len(ts))
    return [t.cpu().numpy() for t in ts]

# engine-cache accounting lives in the shared metrics registry so callers
# (e.g. a FleetPlanner) can read scoped deltas instead of process-wide
# totals; `des_cache_stats()` is the dict-shaped view of the same series.
# The names are the reference's, whose entries are compiled executables.
_HITS = get_counter("des_compile_hits_total",
                    "simulator constructions reusing a cached bucket")
_MISSES = get_counter("des_compile_miss_total",
                      "simulator constructions opening a new bucket")
_EVICTIONS = get_counter("des_compile_evictions_total",
                         "engine-cache LRU evictions")
_ENTRIES = get_gauge("des_compile_cache_entries",
                     "live engine-cache buckets")


# ------------------------------------------------------------------ options
@dataclass(frozen=True)
class DESOptions:
    """Engine knobs for `TorchDES`/`EnsembleTorchDES`.

      backend  'auto' -> 'cuda' on a CUDA device, 'ref' on the CPU.
               'cuda': every filling round of a trip in one launch of
               the fused Hopper kernel (`ops.fill_maxmin`), GRAPH_TRIPS
               trips replayed as one CUDA graph; 'cuda-round':
               one launch of the per-round kernel (`ops.fill_round`) per
               round, driven from the host; 'ref': the fused kernel's
               plain version, bit-equal to it, driven from the host;
               'segment': an index_add per round over the incidence
               entries.  The two 'cuda' backends need a CUDA device
      device   None -> 'cuda'; a CUDA device (named or not) raises
               without one rather than run on the CPU, which needs
               device='cpu'
      bucket   pad the problem to the BUCKET_QUANTUM buckets
      warn_on_miss  log a warning whenever a construction opens a new
               engine-cache bucket; the fleet sets it so bucket churn
               inside online replanning shows in the logs
    """

    backend: str = "auto"
    device: str | None = None
    bucket: bool = True
    warn_on_miss: bool = False

    def resolve_device(self) -> torch.device:
        device = torch.device("cuda" if self.device is None else self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the torch DES runs on a CUDA device and none is "
                "available; pass DESOptions(device='cpu') to run it on "
                "the CPU")
        return device

    def resolve_backend(self, device: torch.device) -> str:
        if self.backend not in MAXMIN_BACKENDS:
            raise ValueError(f"unknown DES backend {self.backend!r}; "
                             f"pick from {MAXMIN_BACKENDS}")
        if self.backend == "auto":
            return "cuda" if device.type == "cuda" else "ref"
        if self.backend in ("cuda", "cuda-round") and device.type != "cuda":
            raise ValueError(f"DES backend {self.backend!r} needs a CUDA "
                             f"device, got {device}")
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


def member_pad(problems: list[DESProblem]) -> PadSpec:
    """Across-member maxima of the exact per-member pad specs."""
    links = max(p.num_link_cons for p in problems)
    return PadSpec(
        n=max(p.n for p in problems),
        d=max(len(p.dep_pre) for p in problems),
        e=max(len(p.con_task) for p in problems),
        links=links,
        cons=links + max(p.num_cons - p.num_link_cons for p in problems))


def stack_problems(problems: list[DESProblem], pad: PadSpec | None = None,
                   *, device: torch.device | str) -> DESArrays:
    """Pad member DES problems to one fixed shape and stack them on `device`.

    Every array field gains a leading member axis; the shapes take the
    across-member maxima (or the caller's larger `pad`, e.g. a bucket) so
    the one event loop serves all members.  Ghost-padding semantics are
    `_problem_fields`'s; the stacked fields equal the reference's
    `stack_problems`, array for array.
    """
    if not problems:
        raise ValueError("stack_problems needs at least one member")
    if pad is None:
        pad = member_pad(problems)
    if any(p.B != problems[0].B for p in problems):
        raise ValueError("ensemble members must share the NIC bandwidth")
    member_fields = [_problem_fields(p, pad) for p in problems]
    return des_arrays_from_numpy(
        {k: np.stack([f[k] for f in member_fields]) for k in member_fields[0]},
        pad, device)


def _dense_incidence(a: DESArrays) -> torch.Tensor:
    """(C, n) constraint-task weight matrix of one-member arrays for the
    dense backends (ghost incidence entries add zero weight)."""
    w = torch.zeros((a.num_cons, a.n), dtype=torch.float32,
                    device=a.volume.device)
    return w.index_put_((a.con_id[0], a.con_task[0]), a.con_w[0],
                        accumulate=True)


def _incidence_csr(a: DESArrays
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The incidence of each member as CSR by constraint for the fused
    kernel: (con_ptr (M, C+1) int32, ent_task (M, E) int32, ent_w (M, E)
    float32).

    Each member's entries are sorted stably by constraint, so each
    constraint keeps its entries in their order; the ghost entries (task
    0, constraint 0, weight 0), which sit at the end of `con_id`, stay at
    the end of constraint 0's row and add zero.  Raises on an entry
    outside (C, n)."""
    c, dev = a.num_cons, a.con_id.device
    if bool((a.con_id < 0).any() | (a.con_id >= c).any()) \
            or bool(((a.con_task < 0) | (a.con_task >= a.n)).any()):
        raise ValueError(f"incidence entries outside {c} constraints x "
                         f"{a.n} tasks")
    order = torch.sort(a.con_id, dim=1, stable=True).indices
    counts = torch.zeros((a.con_id.shape[0], c), dtype=torch.int64,
                         device=dev)
    counts.scatter_add_(1, a.con_id, torch.ones_like(a.con_id))
    con_ptr = torch.zeros((a.con_id.shape[0], c + 1), dtype=torch.int32,
                          device=dev)
    con_ptr[:, 1:] = counts.cumsum(1)
    return (con_ptr,
            a.con_task.gather(1, order).to(torch.int32).contiguous(),
            a.con_w.gather(1, order).contiguous())


# --------------------------------------------------------- fair-share rates
def _segment_sums(a: DESArrays
                  ) -> Callable[[torch.Tensor, torch.Tensor],
                                tuple[torch.Tensor, torch.Tensor]]:
    """One filling round's per-constraint ``(used, denom)`` from (S, n)
    ``level``/``unfrozen`` as one `index_add_` over the incidence entries
    (of every member: member m's constraints take the m-th block of C,
    lane s reading member s % M)."""
    m, c = a.con_id.shape[0], a.num_cons
    index = (a.con_id + c * torch.arange(
        m, device=a.con_id.device)[:, None]).reshape(-1)

    def reduce(level, unfrozen):
        pop = level.shape[0] // m

        def at(x):
            return a.con_w * torch.gather(x.view(pop, m, -1), 2,
                                          a.con_task.expand(pop, m, -1))
        vals = torch.stack([at(level), at(unfrozen)], -1)
        out = torch.zeros((pop, m * c, 2), dtype=torch.float32,
                          device=level.device)
        out.index_add_(1, index, vals.view(pop, -1, 2))
        out = out.view(pop * m, c, 2)
        return out[..., 0], out[..., 1]
    return reduce


def _rate_step(a: DESArrays, backend: str
               ) -> Callable[[torch.Tensor, torch.Tensor],
                             tuple[torch.Tensor, torch.Tensor]]:
    """The max-min fair rate step of an event trip on `backend`, with the
    incidence it reads built here once: ``(active (S, n), caps (S, C)) ->
    (rates (S, n), rounds (S,))``, the rounds each lane ran; lane s reads
    member s % M.

    'cuda' runs every filling round of every lane in one launch of the
    fused kernel (`ops.fill_maxmin`) over the CSR incidence
    (`_incidence_csr`); 'ref' is its plain version (`ref.fill_maxmin_ref`:
    the host-driven loop `ref.progressive_filling` with the kernel's
    summation order, `ref.csr_warp_sums`).  'cuda-round' and 'segment'
    drive the same loop with a round's fused reduction pair ``used_c =
    sum_m W[c,m] phi_m active_m`` / ``denom_c = sum_m W[c,m] unfrozen_m``
    taken by one `ops.fill_round` launch over the dense incidence `W`
    (`_dense_incidence`; one problem only) or by one `index_add_` over
    the incidence entries (`_segment_sums`)."""
    if backend == "cuda":
        csr = _incidence_csr(a)
        return lambda active, caps: ops.fill_maxmin(
            *csr, active, caps, a.flows, backend="cuda")
    con_id, con_task = a.con_id, a.con_task
    if backend == "ref":
        csr = _incidence_csr(a)
        reduce = csr_warp_sums(*csr)
        con_id, con_task = csr_con_id(csr[0]), csr[1].long()
    elif backend == "cuda-round":
        if a.con_id.shape[0] != 1:
            raise ValueError("DES backend 'cuda-round' serves one problem; "
                             "an ensemble runs on 'cuda', 'ref' or "
                             "'segment'")
        W = _dense_incidence(a)

        def reduce(level, unfrozen):
            return ops.fill_round(W, level, unfrozen, backend="cuda")
    elif backend == "segment":
        reduce = _segment_sums(a)
    else:
        raise ValueError(f"unknown DES backend {backend!r}; pick from "
                         f"{MAXMIN_BACKENDS[1:]}")
    return lambda active, caps: progressive_filling(
        reduce, con_id, con_task, active, caps, a.flows)


def _maxmin(a: DESArrays, active: torch.Tensor, caps: torch.Tensor,
            backend: str = "segment", rounds: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Weighted max-min fair task rates (progressive filling) for an
    (S, n) batch of active sets under (S, C) capacities, by `_rate_step`
    on `backend`.  `rounds`, an int64 scalar on the device, gains the
    batch's rounds (the most any lane ran) without a host sync."""
    rates, lane_rounds = _rate_step(a, backend)(active, caps)
    if rounds is not None and lane_rounds.numel():
        rounds += lane_rounds.amax()
    return rates


# ------------------------------------------------------------ engine cache
class BucketKey(NamedTuple):
    """Hashable static configuration of one bucket (the reference's
    `_StaticCfg`, with the device in place of Pallas's interpret flag)."""
    n: int
    num_cons: int
    num_link_cons: int
    P: int
    max_events: int
    backend: str
    device: str
    members: int            # 0 = single problem, M = stacked ensemble


# (BucketKey, d, e) -> the bucket's trip graphs by (lanes, traced)
_ENGINE_CACHE: OrderedDict[tuple, dict[tuple[int, bool], "_TripGraph"]] = \
    OrderedDict()
# every trip graph the entries hold, least recently replayed first:
# (id of the entry, (lanes, traced)) -> the entry
_GRAPHS: OrderedDict[tuple[int, tuple[int, bool]], dict] = OrderedDict()


def des_cache_stats() -> dict:
    """Module-level engine-cache counters: `hits` are simulator
    constructions that landed in an existing bucket, `misses` opened a new
    one.  Backed by the `repro_torch.obs` registry (`des_compile_*`
    series), so planner-scoped deltas are available via
    `REGISTRY.scope()`."""
    return {"hits": int(_HITS.value()), "misses": int(_MISSES.value()),
            "evictions": int(_EVICTIONS.value()),
            "entries": len(_ENGINE_CACHE)}


def des_cache_clear() -> None:
    for entry in _ENGINE_CACHE.values():
        entry.clear()
    _ENGINE_CACHE.clear()
    _GRAPHS.clear()
    for c in (_HITS, _MISSES, _EVICTIONS):
        c.reset()
    _ENTRIES.set(0)


def _count_bucket(key: BucketKey, pad: PadSpec, warn_on_miss: bool = False
                  ) -> tuple[bool, dict[tuple[int, bool], "_TripGraph"]]:
    """Count one construction in its bucket, least recently used evicted
    first beyond CACHE_SIZE buckets: (whether the bucket was there, its
    entry, the trip graphs by (lanes, traced) that its engines share)."""
    k = (key, pad.d, pad.e)
    entry = _ENGINE_CACHE.get(k)
    if entry is not None:
        _HITS.inc()
        _ENGINE_CACHE.move_to_end(k)
        return True, entry
    # every miss counts whether or not the caller asked for the warning,
    # so the counter is the one authoritative churn signal
    _MISSES.inc()
    if warn_on_miss:
        _log.warning(
            "DES engine-cache miss: new bucket n=%d deps=%d inc=%d "
            "cons=%d/%d P=%d members=%d backend=%s device=%s", key.n, pad.d, pad.e, key.num_link_cons,
            key.num_cons, key.P, key.members, key.backend, key.device)
    entry = _ENGINE_CACHE[k] = {}
    while len(_ENGINE_CACHE) > CACHE_SIZE:
        _drop_graphs(_ENGINE_CACHE.popitem(last=False)[1])
        _EVICTIONS.inc()
    _ENTRIES.set(len(_ENGINE_CACHE))
    return False, entry


def _keep_graph(entry: dict, lanes_traced: tuple[int, bool]) -> None:
    """Mark an entry's trip graph as the one replayed last, and drop the
    least recently replayed graphs beyond GRAPHS_KEPT from their entries
    (an engine of theirs captures again when it next simulates)."""
    k = (id(entry), lanes_traced)
    _GRAPHS[k] = entry
    _GRAPHS.move_to_end(k)
    while len(_GRAPHS) > GRAPHS_KEPT:
        (_, old), held = _GRAPHS.popitem(last=False)
        held.pop(old, None)


def _drop_graphs(entry: dict) -> None:
    """Drop an evicted bucket's trip graphs."""
    for k in [k for k in _GRAPHS if k[0] == id(entry)]:
        del _GRAPHS[k]
    entry.clear()


def plane_state_genomes(lane_genomes: np.ndarray) -> np.ndarray:
    """Fabric-state expansion of a k-plane lane decomposition.

    `lane_genomes` is (..., k, E): per-plane circuit counts on the E
    union pairs, summing (over planes) to the total topology genome.
    Returns a float (..., k+1, E) stack -- state 0 is the full fabric
    (lane sum) and state p+1 is plane p dark (total minus lane p).  A
    pair carried entirely by the dark plane keeps a fractional
    ``total / k`` trickle instead of zeroing out: circuits are the only
    route between a pair, so a hard zero would price every single-lane
    pair as an infinite makespan (the same transient-buffering
    convention as `repro_torch.core.ga.failure_scenarios`).  These are
    exactly the states a staggered rewire visits, so the GA's spare-lane
    fitness and the transition scheduler price the same physics.
    """
    lanes = np.asarray(lane_genomes, dtype=np.float64)
    if lanes.ndim < 2:
        raise ValueError(f"lane_genomes needs a (k, E) tail, "
                         f"got shape {lanes.shape}")
    k = lanes.shape[-2]
    total = lanes.sum(axis=-2, keepdims=True)           # (..., 1, E)
    eff = total - lanes                                 # (..., k, E)
    eff = np.where((eff <= 0) & (total > 0), total / k, eff)
    return np.concatenate([total, eff], axis=-2)        # (..., k+1, E)


# -------------------------------------------------------------- event trips
def _retire_starts(t_now, started, finish, missing, dep_pre, dep_succ,
                   dep_delta):
    """Start every pending task whose ready time has arrived at `t_now`
    (G, M); returns the next pending ready time as well.  `dep_pre`/
    `dep_succ` are the members' deps expanded to (G, M, d), `dep_delta`
    their (M, d) lags."""
    lag = torch.gather(finish, 2, dep_pre) + dep_delta
    ready = torch.zeros_like(finish)
    ready.scatter_reduce_(2, dep_succ, lag, "amax", include_self=True)
    ready = torch.where((missing == 0) & ~started, ready, INF)
    newly = ready <= (t_now * (1 + EPS) + EPS * 1e-3)[..., None]
    t_ready = torch.where(newly, INF, ready).amin(-1)
    return started | newly, newly, ready, t_ready


def _outcome(feasible, done, start, finish):
    """The loop's final state -> (makespan, feasible, start, finish): a
    lane is feasible where every task is done."""
    feasible = feasible & done.all(-1)
    last = torch.where(torch.isfinite(finish), finish, -INF).amax(-1)
    return torch.where(feasible, last, INF), feasible, start, finish


@functools.cache
def _graph_pool():
    """The memory pool every trip graph captures into.  `run_trips` keeps
    none of the tensors it allocates (the state and inputs live outside
    the pool), so a capture leaves nothing of the pool alive unless a
    wrapper of `ops.fill_maxmin` holds on to what the captured calls
    return (such a tensor is overwritten by every replay of its graph):
    graphs replayed in any order share the pool, and it is as large as
    the largest capture, however many graphs are kept."""
    return torch.cuda.graph_pool_handle()


class _TripGraph:
    """Event trips of one bucket at one lane count on static buffers, and
    on 'cuda' their CUDA graph of GRAPH_TRIPS trips.

    The buffers, all outside the graphs' pool: the inputs, copies of an
    engine's arrays, its CSR incidence and a simulation's lane capacities
    (`load`); the loop's state as (G, M) and (G, M, n) tensors; and
    `status`, on the device: whether any lane still runs, the trips in
    which some lane ran, the filling rounds (counted where `traced`) and
    `step`, the trips taken.  Each graph holds its own buffers, about
    18 bytes per lane and task besides the inputs.  `run_trips` is the body the graph captures:
    it also runs eagerly, as the warm-up before the capture and on the
    CPU."""

    def __init__(self, a: DESArrays, csr: tuple[torch.Tensor, ...], g: int,
                 max_events: int, traced: bool):
        m, n, dev, f32 = a.volume.shape[0], a.n, a.volume.device, \
            torch.float32
        self.max_events, self.traced = max_events, traced
        self.dep_pre, self.dep_succ, self.dep_delta, self.volume, \
            self.flows = (torch.empty_like(x) for x in (
                a.dep_pre, a.dep_succ, a.dep_delta, a.volume, a.flows))
        self.csr = tuple(torch.empty_like(x) for x in csr)
        # the rate step on the buffers: the fused kernel for CUDA tensors,
        # its plain version on the CPU
        self._fill = functools.partial(ops.fill_maxmin, *self.csr,
                                       flows=self.flows)
        self.lane_caps = torch.empty((g * m, a.num_cons), dtype=f32,
                                     device=dev)
        self.t, self.t_ready = (torch.empty((g, m), dtype=f32, device=dev)
                                for _ in range(2))
        self.feasible = torch.empty((g, m), dtype=torch.bool, device=dev)
        self.rem, self.start, self.finish = (
            torch.empty((g, m, n), dtype=f32, device=dev) for _ in range(3))
        self.started, self.done = (
            torch.empty((g, m, n), dtype=torch.bool, device=dev)
            for _ in range(2))
        self.missing = torch.empty((g, m, n), dtype=torch.int32, device=dev)
        self.status = torch.zeros(4, dtype=torch.int64, device=dev)
        self.running, self.trips, self.rounds, self.step = \
            self.status.unbind()
        self.graph: torch.cuda.CUDAGraph | None = None

    def load(self, a: DESArrays, csr: tuple[torch.Tensor, ...],
             lane_caps: torch.Tensor, state: tuple[torch.Tensor, ...]
             ) -> None:
        """Copy an engine's arrays and CSR, the lane capacities and the
        loop's state after the t=0 starts (`_LaneDES._initial`) into the
        buffers, and zero the status."""
        for dst, src in zip(
                (self.dep_pre, self.dep_succ, self.dep_delta, self.volume,
                 self.flows, *self.csr, self.lane_caps, self.t, self.t_ready,
                 self.feasible, self.rem, self.started, self.done,
                 self.start, self.finish, self.missing),
                (a.dep_pre, a.dep_succ, a.dep_delta, a.volume, a.flows, *csr,
                 lane_caps, *state)):
            dst.copy_(src)
        self.status.zero_()

    def run_trips(self, k: int) -> None:
        """k event trips in place: the eager loop's trip, with every lane
        also stopped once `max_events` trips were taken; then the running
        flag of `status`.  Nothing here runs on the host per trip."""
        g, m, n = self.rem.shape
        dep_pre = self.dep_pre.expand(g, m, -1)
        dep_succ = self.dep_succ.expand(g, m, -1)
        for _ in range(k):
            run = torch.isfinite(self.t) & self.feasible \
                & (self.step < self.max_events)
            self.step += 1
            self.trips += run.any()
            active = self.started & ~self.done
            rates, lane_rounds = self._fill(
                (active & run[..., None]).view(g * m, n), self.lane_caps)
            rates = rates.view(g, m, n)
            if self.traced:
                self.rounds += lane_rounds.amax()
            feas_new = self.feasible & torch.where(active, rates > 0,
                                                   True).all(-1)
            dt_done = torch.where(active & (rates > 0), self.rem / rates, INF)
            t_next = torch.minimum(self.t + dt_done.amin(-1), self.t_ready)
            dt = (t_next - self.t).clamp_min(0.0)
            rem_new = torch.where(
                active, (self.rem - rates * dt[..., None]).clamp_min(0.0),
                self.rem)
            dt_rem = dt_done - dt[..., None]
            newdone = active & torch.isfinite(t_next)[..., None] & (
                (rem_new <= VEPS * self.volume.clamp_min(1e-9))
                | (dt_rem <= (TEPS * t_next.clamp_min(1e-9))[..., None]))
            finish_new = torch.where(newdone, t_next[..., None], self.finish)
            done_new = self.done | newdone
            met = torch.zeros((g, m, n), dtype=torch.int32,
                              device=self.rem.device)
            met.scatter_add_(2, dep_succ, torch.gather(newdone, 2, dep_pre)
                             .to(torch.int32))
            missing_new = self.missing - met
            started_new, newly, ready, t_ready_new = _retire_starts(
                t_next, self.started, finish_new, missing_new, dep_pre,
                dep_succ, self.dep_delta)
            start_new = torch.where(newly, ready, self.start)
            t_new = torch.where(done_new.all(-1), -INF, t_next)
            r = run[..., None]
            for mask, new, old in (
                    (run, t_new, self.t), (run, t_ready_new, self.t_ready),
                    (run, feas_new, self.feasible), (r, rem_new, self.rem),
                    (r, started_new, self.started), (r, done_new, self.done),
                    (r, start_new, self.start), (r, finish_new, self.finish),
                    (r, missing_new, self.missing)):
                torch.where(mask, new, old, out=old)
        self.running.copy_((torch.isfinite(self.t) & self.feasible).any()
                           & (self.step < self.max_events))

    def capture(self) -> None:
        """Warm up, as CUDA graphs need, with GRAPH_TRIPS eager trips on a
        side stream (real trips of the simulation loaded), then capture
        GRAPH_TRIPS trips into `graph`; the capture runs nothing (and
        `ops.fill_maxmin` counts no launch while a capture records it)."""
        side = torch.cuda.Stream(self.t.device)
        side.wait_stream(torch.cuda.current_stream(self.t.device))
        with torch.cuda.stream(side):
            self.run_trips(GRAPH_TRIPS)
        torch.cuda.current_stream(self.t.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=_graph_pool()):
            self.run_trips(GRAPH_TRIPS)


# ------------------------------------------------------------------ engines
class _LaneDES:
    """The batched event loop over lanes of (genome, member).

    The state tensors are (G, M, n): G topologies, each simulated on all
    M members of the stacked arrays.  The lanes of the rate step are the
    same tensors flattened genome-major and member-minor (lane g * M + m
    reads member m), the order of the reference's (pop, M) ensemble
    output.  Every lane has its own event clock.
    """

    def _setup(self, problems: list[DESProblem], arrays: DESArrays | None,
               max_events: int | None, options: DESOptions | None,
               members: int) -> None:
        """`members` is the bucket key's: 0 for one problem, M for an
        ensemble, as the reference's cache keys them."""
        with span("des.build", members=members) as sp:
            self.options = options or DESOptions()
            self.device = self.options.resolve_device()
            self.backend = self.options.resolve_backend(self.device)
            if arrays is None:
                pad = member_pad(problems)
                if self.options.bucket:
                    pad = pad.bucketed()
                arrays = stack_problems(problems, pad, device=self.device)
            elif arrays.volume.device != self.device:
                raise ValueError(f"arrays live on {arrays.volume.device}, "
                                 f"the engine on {self.device}")
            self.arrays = a = arrays
            self.M = a.volume.shape[0]
            self.pad = PadSpec(n=a.n, d=a.dep_pre.shape[1],
                               e=a.con_task.shape[1], links=a.num_link_cons,
                               cons=a.num_cons)
            self.max_events = int(max_events or default_max_events(a.n))
            self.P = problems[0].dag.cluster.num_pods
            # the bucket's trip graphs, shared with its other engines; an
            # engine whose bucket is evicted keeps them while it lives
            hit, self._graphs = _count_bucket(
                BucketKey(n=a.n, num_cons=a.num_cons,
                          num_link_cons=a.num_link_cons, P=self.P,
                          max_events=self.max_events, backend=self.backend,
                          device=str(self.device), members=members),
                self.pad, self.options.warn_on_miss)
            sp.set(hit=hit)
            # the incidence the rate step reads, built once per engine and
            # shared by every round of every trip of every lane: on 'cuda'
            # the CSR a trip graph's copy is loaded from, else the rate step
            if self.backend == "cuda":
                self._csr = _incidence_csr(a)
            else:
                self._rates = _rate_step(a, self.backend)
            # x-independent initial state: virtual task 0 and the padding
            # ghosts are born done at t=0; deps from task 0 are met
            self._started0 = ~a.task_valid
            self._started0[:, 0] = True
            from_virtual = torch.zeros((self.M, a.n), dtype=torch.int32,
                                       device=self.device)
            from_virtual.scatter_add_(1, a.dep_succ, (a.dep_pre == 0).to(
                torch.int32))
            self._missing0 = a.indegree - from_virtual

    # ------------------------------------------------------------ event loop
    def _initial(self, xs: torch.Tensor, masks: torch.Tensor, ideal: bool):
        """The lane capacities (G * M, C) of (G, P, P) topologies under
        (M, P, P) masks, and the loop's state after the t=0 start events:
        (t, t_ready, feasible, rem, started, done, start, finish,
        missing)."""
        a, m = self.arrays, self.M
        g, n, dev, p = xs.shape[0], a.n, self.device, self.P
        f32 = torch.float32
        links = a.link_pair_a * p + a.link_pair_b               # (M, L)
        link_caps = xs.reshape(g, p * p)[:, links].to(f32) \
            * masks.reshape(m, p * p).gather(1, links).to(f32)
        if ideal:
            link_caps = torch.full_like(link_caps, INF)
        caps = torch.cat([link_caps, torch.ones(
            (g, m, a.num_cons - a.num_link_cons), dtype=f32, device=dev)], -1)
        lane_caps = caps.view(g * m, a.num_cons)

        rem = a.volume.expand(g, m, n)
        started = self._started0.expand(g, m, n)
        done = started
        start = torch.where(started, 0.0, INF)
        finish = start
        missing = self._missing0.expand(g, m, n)
        t = torch.zeros((g, m), dtype=f32, device=dev)
        # retire the t=0 start events before the loop
        started, newly, ready, t_ready = _retire_starts(
            t, started, finish, missing, a.dep_pre.expand(g, m, -1),
            a.dep_succ.expand(g, m, -1), a.dep_delta)
        start = torch.where(newly, ready, start)
        feasible = torch.ones((g, m), dtype=torch.bool, device=dev)
        return lane_caps, (t, t_ready, feasible, rem, started, done, start,
                           finish, missing)

    def _simulate(self, xs: torch.Tensor, masks: torch.Tensor,
                  ideal: bool = False):
        """(G, P, P) topologies under (M, P, P) link-availability masks ->
        (makespan, feasible, start, finish), each with leading (G, M), on
        the device; the caller copies what it returns with `_to_host`.
        'cuda' replays the bucket's trip graph (`_replay`); the other
        backends run the loop here, one exit test per trip."""
        lane_caps, state = self._initial(xs, masks, ideal)
        traced = TRACER.is_enabled and _ROUNDS.enabled
        if self.backend == "cuda":
            return _outcome(*self._replay(lane_caps, state, traced))
        a, m = self.arrays, self.M
        t, t_ready, feasible, rem, started, done, start, finish, missing = \
            state
        g, n, dev = t.shape[0], a.n, self.device
        dep_pre = a.dep_pre.expand(g, m, -1)
        dep_succ = a.dep_succ.expand(g, m, -1)
        rounds = torch.zeros((), dtype=torch.int64, device=dev) \
            if traced else None
        trips = syncs = 0       # counted here, added once at the end

        for _ in range(self.max_events):
            run = torch.isfinite(t) & feasible
            syncs += 1
            if not bool(run.any()):  # sentinel: ignore[RPR006] one sync per trip: the exit test
                break
            trips += 1
            active = started & ~done
            rates, lane_rounds = self._rates(
                (active & run[..., None]).view(g * m, n), lane_caps)
            rates = rates.view(g, m, n)
            if rounds is not None:
                rounds += lane_rounds.amax()
            feas_new = feasible & torch.where(active, rates > 0, True).all(-1)
            # rem / max(rates, 1e-300) in the reference: the clamp is 0 in
            # float32 and where() drops the rate-0 tasks
            dt_done = torch.where(active & (rates > 0), rem / rates, INF)
            t_next = torch.minimum(t + dt_done.amin(-1), t_ready)
            dt = (t_next - t).clamp_min(0.0)
            rem_new = torch.where(
                active, (rem - rates * dt[..., None]).clamp_min(0.0), rem)
            dt_rem = dt_done - dt[..., None]
            newdone = active & torch.isfinite(t_next)[..., None] & (
                (rem_new <= VEPS * a.volume.clamp_min(1e-9))
                | (dt_rem <= (TEPS * t_next.clamp_min(1e-9))[..., None]))
            finish_new = torch.where(newdone, t_next[..., None], finish)
            done_new = done | newdone
            met = torch.zeros((g, m, n), dtype=torch.int32, device=dev)
            met.scatter_add_(2, dep_succ, torch.gather(newdone, 2, dep_pre)
                             .to(torch.int32))
            missing_new = missing - met
            # retire the start events at t_next in the same trip (readiness
            # against the post-completion finish/missing state)
            started_new, newly, ready, t_ready_new = _retire_starts(
                t_next, started, finish_new, missing_new, dep_pre, dep_succ,
                a.dep_delta)
            start_new = torch.where(newly, ready, start)
            t_new = torch.where(done_new.all(-1), -INF, t_next)  # exit flag

            r = run[..., None]
            t = torch.where(run, t_new, t)
            t_ready = torch.where(run, t_ready_new, t_ready)
            feasible = torch.where(run, feas_new, feasible)
            rem = torch.where(r, rem_new, rem)
            started = torch.where(r, started_new, started)
            done = torch.where(r, done_new, done)
            start = torch.where(r, start_new, start)
            finish = torch.where(r, finish_new, finish)
            missing = torch.where(r, missing_new, missing)

        _TRIPS.inc(trips)
        if rounds is not None:
            _ROUNDS.inc(int(rounds))          # one host read per simulation
            syncs += 1
        _SYNCS.inc(syncs)
        return _outcome(feasible, done, start, finish)

    def _replay(self, lane_caps, state, traced: bool):
        """The event loop on 'cuda': the bucket's trip graph for this lane
        count and tracing state (captured on first use, after its warm-up
        trips) replayed on this engine's arrays, GRAPH_TRIPS trips per
        replay and one read of `status` after each; the final (feasible,
        done, start, finish), start and finish copied out of the graph's
        buffers.  The idle trips are the trips taken less those in which
        some lane ran, both counted on the device."""
        g = state[0].shape[0]
        key = (g * self.M, traced)
        tg = self._graphs.get(key)
        if tg is None:
            tg = self._graphs[key] = _TripGraph(
                self.arrays, self._csr, g, self.max_events, traced)
        _keep_graph(self._graphs, key)
        tg.load(self.arrays, self._csr, lane_caps, state)
        replays = syncs = 0
        # a graph is captured and replayed on its device's current stream
        with torch.cuda.device(self.device):
            if tg.graph is None:
                with span("des.capture", lanes=g * self.M,
                          trips=GRAPH_TRIPS, traced=traced):
                    tg.capture()
                _CAPTURES.inc()
            else:
                tg.graph.replay()
                replays = 1
            for _ in range(-(-self.max_events // GRAPH_TRIPS)):
                syncs += 1
                running, trips, rounds, steps = tg.status.tolist()  # sentinel: ignore[RPR006] one sync per replay: the exit test
                if not running:
                    break
                tg.graph.replay()
                replays += 1
        _TRIPS.inc(trips)
        _IDLE_TRIPS.inc(steps - trips)
        _REPLAYS.inc(replays)
        if traced:
            _ROUNDS.inc(rounds)
        _SYNCS.inc(syncs)
        return tg.feasible, tg.done, tg.start.clone(), tg.finish.clone()

    def _genome_topologies(self, genomes, edge_u, edge_v) -> torch.Tensor:
        """(G, E) genomes over the pairs (edge_u, edge_v) -> (G, P, P)
        symmetric topologies, scattered on the device."""
        g = topology_from_numpy(genomes, self.device)
        eu = topology_from_numpy(np.asarray(edge_u, dtype=np.int64),
                                 self.device)
        ev = topology_from_numpy(np.asarray(edge_v, dtype=np.int64),
                                 self.device)
        xs = torch.zeros((g.shape[0], self.P, self.P), dtype=g.dtype,
                         device=self.device)
        xs[:, eu, ev] = g
        xs[:, ev, eu] = g
        return xs

    def _masks(self, masks) -> torch.Tensor:
        """(M, P, P) per-member link-availability factors (1 = healthy,
        0 = dark); None means a healthy fabric, and one (P, P) mask serves
        every member.  They scale link capacities only."""
        if masks is None:
            return torch.ones((self.M, self.P, self.P), dtype=torch.float32,
                              device=self.device)
        t = topology_from_numpy(np.asarray(masks, dtype=np.float32),
                                self.device)
        return t.expand(self.M, self.P, self.P) if t.dim() == 2 else t


class TorchDES(_LaneDES):
    """Single and batched simulation of one CommDAG on one device: the
    event loop with one member.

    `arrays` replaces the problem's own padded arrays with one-member
    arrays (`convert.des_arrays_from_numpy` of another engine's fields,
    each with a member axis of 1); `problem` then still gives the pod
    count and the task count of the result.
    """

    def __init__(self, problem: DESProblem, max_events: int | None = None,
                 options: DESOptions | None = None,
                 arrays: DESArrays | None = None):
        self.problem = problem
        self._setup([problem], arrays, max_events, options, members=0)
        if self.M != 1:
            raise ValueError(f"TorchDES simulates one problem; the arrays "
                             f"hold {self.M} members (EnsembleTorchDES)")

    def makespan(self, x, ideal: bool = False, mask=None) -> float:
        return self.simulate(x, ideal=ideal, mask=mask)[0]

    def simulate(self, x, ideal: bool = False, mask=None):
        """(makespan, feasible, start, finish) of one (P, P) topology, with
        the padding ghosts stripped from start/finish."""
        with span("des.simulate", entry="single", n=self.pad.n):
            xs = topology_from_numpy(x, self.device)[None]
            ms, feas, start, finish = self._simulate(xs, self._masks(mask),
                                                     ideal)
            n = self.problem.n
            ms, feas, start, finish = _to_host(
                ms[0, 0], feas[0, 0], start[0, 0, :n], finish[0, 0, :n])
            return float(ms), bool(feas), start, finish

    def batch_makespan(self, xs, mask=None) -> tuple[np.ndarray, np.ndarray]:
        """Makespans + feasibility for a (pop, P, P) batch of topologies."""
        xs = topology_from_numpy(xs, self.device)
        with span("des.simulate", entry="batch_x", n=self.pad.n,
                  pop=int(xs.shape[0])):
            ms, feas, _, _ = self._simulate(xs, self._masks(mask))
            return tuple(_to_host(ms[:, 0], feas[:, 0]))

    def batch_genome_makespan(self, genomes, edge_u, edge_v, mask=None
                              ) -> tuple[np.ndarray, np.ndarray]:
        """GA generation-step fitness: scatter a (pop, E) genome batch onto
        (pop, P, P) topologies on the device and simulate them as one
        batch -- one host->device copy of the genomes, one device->host
        copy of (makespan, feasible)."""
        with span("des.simulate", entry="batch_genomes", n=self.pad.n,
                  pop=int(np.shape(genomes)[0])):
            xs = self._genome_topologies(genomes, edge_u, edge_v)
            ms, feas, _, _ = self._simulate(xs, self._masks(mask))
            return tuple(_to_host(ms[:, 0], feas[:, 0]))


class EnsembleTorchDES(_LaneDES):
    """Batched DES over the members of a `DagEnsemble`: genomes x members
    in one event loop, one `fill_maxmin` launch per trip for all lanes.

    Member problems are padded to one shape (`stack_problems`), so GA
    fitness over a whole population is one (pop, E) genome upload and one
    (pop, M) (makespan, feasible) download per generation, whatever the
    ensemble's size.  `arrays` replaces the stacked arrays (`convert.
    des_arrays_from_numpy` of the reference's `stack_problems` fields).
    """

    def __init__(self, problems: list[DESProblem],
                 max_events: int | None = None,
                 options: DESOptions | None = None,
                 arrays: DESArrays | None = None):
        if not problems:
            raise ValueError("EnsembleTorchDES needs at least one member")
        self.problems = problems
        self._setup(problems, arrays, max_events, options,
                    members=len(problems))
        if self.M != len(problems):
            raise ValueError(f"{len(problems)} problems but the arrays hold "
                             f"{self.M} members")

    def ensemble_genome_makespan(self, genomes, edge_u, edge_v, masks=None
                                 ) -> tuple[np.ndarray, np.ndarray]:
        """(pop, E) genomes over the union pairs -> (pop, M) makespans and
        feasibility under the (M, P, P) or (P, P) `masks`: one batch of
        pop x M lanes."""
        with span("des.simulate", entry="ensemble_genomes", n=self.pad.n,
                  pop=int(np.shape(genomes)[0]), members=self.M):
            xs = self._genome_topologies(genomes, edge_u, edge_v)
            ms, feas, _, _ = self._simulate(xs, self._masks(masks))
            return tuple(_to_host(ms, feas))

    def makespans(self, x, masks=None) -> tuple[np.ndarray, np.ndarray]:
        """Per-member (makespan, feasible) for one (P, P) topology."""
        with span("des.simulate", entry="ensemble_x", n=self.pad.n,
                  members=self.M):
            xs = topology_from_numpy(x, self.device)[None]
            ms, feas, _, _ = self._simulate(xs, self._masks(masks))
            return tuple(_to_host(ms[0], feas[0]))
