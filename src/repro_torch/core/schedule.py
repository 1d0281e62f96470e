"""1F1B schedule -> full computation-communication DAG -> reduced inter-pod
communication DAG (paper Sec. III-A, Fig. 3).

The full DAG contains three node kinds:
  * compute nodes  F(r, b, s) / B(r, b, s) with fixed durations,
  * intra-pod communication nodes (fixed durations, electrical network),
  * inter-pod communication nodes (durations decided by the topology).

Dependency categories (paper Fig. 3a):
  (1) data dependencies  (activation / gradient / encoder-output arrival,
      plus the expert-parallel all-to-all of MoE stages: dispatch + combine
      per MoE layer, aggregated per (replica, microbatch, stage, direction)
      and wired between the F/B compute nodes so it contends with the PP
      transfer on the same boundary),
  (2) scheduling dependencies (1F1B op order per stage GPU),
  (3) gradient dependencies (DP sync waits for the last microbatch backward).

EP placement assumption: EP groups stride across DP replicas within a
stage (Placement.ep_groups), so the all-to-all is inter-pod even when a
replica's whole pipeline fits in one pod.  Under the single-replica
projection (reduce_replicas=True) each EP group is represented by the pair
0 -> 1 plus its isomorphic wraparound image 1 -> 0 -- the same
representative-pair treatment as the DP ring, port-exact per pod but
concentrating the (ep-1)-peer fan-out onto one pod pair.  jobs with ep == 1
build DAGs bit-identical to the pre-MoE builder.

Graph reduction replaces chains of intra-pod nodes between inter-pod tasks by
rigid-delay edges delta (Eq. 2).  Because completion-to-start edges over a
stage's op chain are quadratic in microbatch count, we prune every candidate
edge that is *dominated* by a two-edge path (o -> m -> n) with
delta1 + tau_min(m) + delta2 >= delta, where tau_min(m) = V_m / (F_m * B) is
m's minimum physical duration (valid in every feasible schedule because
Eq. 10 caps r_m <= F_m * B).  Domination is transitive, so one-hop checking
is sound; for homogeneous pipelines this brings |D| back to O(|M|).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from dataclasses import dataclass, field

from repro_torch.core.cluster import ClusterSpec, Placement
from repro_torch.core.dag import VIRTUAL, CommDAG, CommTask, Dep, make_virtual
from repro_torch.core.traffic import JobSpec


# --------------------------------------------------------------------- 1F1B
def order_1f1b(stage: int, num_stages: int, num_microbatches: int
               ) -> list[tuple[str, int]]:
    """Execution order of ('F'|'B', microbatch) ops on one stage GPU."""
    mb = num_microbatches
    warmup = min(num_stages - stage - 1, mb)
    order: list[tuple[str, int]] = [("F", b) for b in range(1, warmup + 1)]
    for i in range(1, mb - warmup + 1):
        order.append(("F", warmup + i))
        order.append(("B", i))
    for b in range(mb - warmup + 1, mb + 1):
        order.append(("B", b))
    return order


# ----------------------------------------------------------------- full DAG
@dataclass
class _Node:
    kind: str                 # comp | intra | inter
    duration: float = 0.0     # comp / intra only
    task: CommTask | None = None  # inter only (tid assigned later)


@dataclass
class FullDAG:
    """Intermediate complete computation-communication DAG."""
    nodes: list[_Node] = field(default_factory=list)
    edges: list[tuple[int, int]] = field(default_factory=list)

    def add(self, node: _Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def link(self, u: int | None, v: int | None) -> None:
        if u is not None and v is not None:
            self.edges.append((u, v))

    def stats(self) -> dict:
        kinds = collections.Counter(n.kind for n in self.nodes)
        return {"nodes": len(self.nodes), "edges": len(self.edges),
                **dict(kinds)}


def build_full_dag(job: JobSpec, cluster: ClusterSpec,
                   placement: Placement | None = None,
                   reduce_replicas: bool = True) -> FullDAG:
    """Build the complete computation-communication DAG of one iteration."""
    placement = placement or job.placement()
    S, MB = job.pp, job.num_microbatches
    replicas = [0] if (reduce_replicas or job.dp == 1) else list(range(job.dp))
    g = FullDAG()

    def comm_node(src_pod: int, dst_pod: int, volume: float, flows: int,
                  src_gpus, dst_gpus, kind: str, tag: tuple) -> int:
        if src_pod == dst_pod:
            dur = volume / (flows * cluster.intra_pod_bandwidth)
            return g.add(_Node("intra", duration=dur))
        task = CommTask(tid=-1, src_pod=src_pod, dst_pod=dst_pod, flows=flows,
                        volume=volume, src_gpus=tuple(src_gpus),
                        dst_gpus=tuple(dst_gpus), kind=kind, tag=tag)
        return g.add(_Node("inter", task=task))

    # compute nodes per (replica, microbatch, stage)
    fwd: dict[tuple[int, int, int], int] = {}
    bwd: dict[tuple[int, int, int], int] = {}
    for r, s in itertools.product(replicas, range(S)):
        for b in range(1, MB + 1):
            fwd[(r, b, s)] = g.add(_Node("comp", duration=job.fwd_duration(s)))
            bwd[(r, b, s)] = g.add(_Node("comp", duration=job.bwd_duration(s)))

    # (2) scheduling dependencies: 1F1B op order per stage
    for r, s in itertools.product(replicas, range(S)):
        order = order_1f1b(s, S, MB)
        nodes = [fwd[(r, b, s)] if k == "F" else bwd[(r, b, s)]
                 for k, b in order]
        for u, v in zip(nodes, nodes[1:]):
            g.link(u, v)

    # (1) data dependencies via PP / xattn communications
    pp_fwd: dict[tuple[int, int, int], int] = {}
    pp_bwd: dict[tuple[int, int, int], int] = {}
    for r in replicas:
        for s in range(S - 1):
            pod_s, pod_n = placement.pod_of(r, s), placement.pod_of(r, s + 1)
            for b in range(1, MB + 1):
                cf = comm_node(pod_s, pod_n, job.pp_volume(), job.tp,
                               placement.gpu_ids(r, s),
                               placement.gpu_ids(r, s + 1),
                               "pp_fwd", (r, b, s))
                pp_fwd[(r, b, s)] = cf
                g.link(fwd[(r, b, s)], cf)
                g.link(cf, fwd[(r, b, s + 1)])
                cb = comm_node(pod_n, pod_s, job.pp_volume(), job.tp,
                               placement.gpu_ids(r, s + 1),
                               placement.gpu_ids(r, s),
                               "pp_bwd", (r, b, s + 1))
                pp_bwd[(r, b, s + 1)] = cb
                g.link(bwd[(r, b, s + 1)], cb)
                g.link(cb, bwd[(r, b, s)])
        # last stage: backward directly follows its own forward (loss);
        # covered by the scheduling chain, add the data edge for clarity.
        for b in range(1, MB + 1):
            g.link(fwd[(r, b, S - 1)], bwd[(r, b, S - 1)])

    # encoder-decoder cross-attention broadcast (whisper-style pipelines)
    if job.enc_stages and job.enc_stages < S:
        e_last = job.enc_stages - 1
        for r in replicas:
            for s_dec in range(job.enc_stages, S):
                pod_e = placement.pod_of(r, e_last)
                pod_d = placement.pod_of(r, s_dec)
                for b in range(1, MB + 1):
                    cx = comm_node(pod_e, pod_d, job.xattn_volume(), job.tp,
                                   placement.gpu_ids(r, e_last),
                                   placement.gpu_ids(r, s_dec),
                                   "xattn", (r, b, s_dec))
                    g.link(fwd[(r, b, e_last)], cx)
                    g.link(cx, fwd[(r, b, s_dec)])

    # (1c) expert-parallel all-to-all (MoE dispatch + combine per stage).
    # EP groups stride across DP replicas within a stage, so the all-to-all
    # crosses pods even when a replica's whole pipeline fits in one pod.
    # Each task aggregates one replica's full a2a egress for one
    # (microbatch, MoE stage, direction) onto its representative ring pair;
    # under the single-replica projection we keep the pair 0 -> 1 plus the
    # isomorphic wraparound image 1 -> 0, exactly like the DP ring below.
    # The fwd a2a is wired F(s) -> a2a -> F(s+1) (B(s) at the last stage)
    # and the bwd a2a B(s) -> a2a -> B(s-1): with atomic compute nodes the
    # intra-layer dispatch/combine collapses onto the stage boundary, where
    # it contends with the PP transfer -- the concurrent-demand burst the
    # traffic-matrix view obscures.
    ep_span = placement.ep_span
    if ep_span >= 2 and any(job.moe_stage_layers):
        if reduce_replicas:
            # projection: pair 0 -> 1 plus wraparound image, replica-0 gates
            # (ep_span >= 2 implies dp >= 2, so replica 1's pods exist)
            ep_groups = [([(0, 1), (1, 0)], [0])]
        else:
            # collective gating: every group member's compute node bounds
            # every pair task of its group
            ep_groups = [
                ([(g * ep_span + i, g * ep_span + (i + 1) % ep_span)
                  for i in range(ep_span)],
                 list(range(g * ep_span, (g + 1) * ep_span)))
                for g in range(job.dp // ep_span)]
        for pairs, gates in ep_groups:
            for s in range(S):
                vol = job.ep_a2a_stage_volume(s)
                if vol <= 0.0:
                    continue
                for b in range(1, MB + 1):
                    for r_src, r_dst in pairs:
                        pod_s = placement.pod_of(r_src, s)
                        pod_d = placement.pod_of(r_dst, s)
                        ca = comm_node(pod_s, pod_d, vol, job.tp,
                                       placement.gpu_ids(r_src, s),
                                       placement.gpu_ids(r_dst, s),
                                       "ep_a2a_fwd", (r_src, b, s))
                        cb = comm_node(pod_d, pod_s, vol, job.tp,
                                       placement.gpu_ids(r_dst, s),
                                       placement.gpu_ids(r_src, s),
                                       "ep_a2a_bwd", (r_dst, b, s))
                        for r in gates:
                            g.link(fwd[(r, b, s)], ca)
                            g.link(ca, fwd[(r, b, s + 1)] if s < S - 1
                                   else bwd[(r, b, s)])
                            g.link(bwd[(r, b, s)], cb)
                            if s > 0:
                                g.link(cb, bwd[(r, b, s - 1)])

    # (3) gradient dependencies: DP ring sync per stage after last backward
    if job.dp >= 2:
        if reduce_replicas:
            # single-replica projection: model the ring link 0 -> 1 plus the
            # isomorphic wraparound image (dp-1 -> 0) mapped onto pods 1 -> 0.
            ring_pairs = [(0, 1), (1, 0)]
        else:
            ring_pairs = [(r, (r + 1) % job.dp) for r in range(job.dp)]
        for s in range(S):
            for r_src, r_dst in ring_pairs:
                pod_s = placement.pod_of(r_src, s)
                pod_d = placement.pod_of(r_dst, s)
                dpn = comm_node(pod_s, pod_d, job.dp_volume(s), job.tp,
                                placement.gpu_ids(r_src, s),
                                placement.gpu_ids(r_dst, s),
                                "dp", (r_src, r_dst, s))
                # collective start: every participating replica must finish
                # its last backward; in the projection replicas are
                # synchronized so replica 0's suffices.
                for r in replicas:
                    g.link(bwd[(r, MB, s)], dpn)
    return g


# ---------------------------------------------------------------- reduction
def reduce_dag(full: FullDAG, cluster: ClusterSpec,
               prune_dominated: bool = True,
               meta: dict | None = None) -> CommDAG:
    """Collapse intra-pod nodes into rigid-delay edges between inter-pod
    tasks (paper Fig. 3b) with dominance pruning."""
    n = len(full.nodes)
    preds: list[list[int]] = [[] for _ in range(n)]
    succs: list[list[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for u, v in full.edges:
        succs[u].append(v)
        preds[v].append(u)
        indeg[v] += 1

    # assign tids to inter-pod tasks in topological order
    order: list[int] = []
    queue = collections.deque(i for i in range(n) if indeg[i] == 0)
    deg = list(indeg)
    while queue:
        u = queue.popleft()
        order.append(u)
        for v in succs[u]:
            deg[v] -= 1
            if deg[v] == 0:
                queue.append(v)
    if len(order) != n:
        raise ValueError("full DAG has a cycle")

    tasks: list[CommTask] = [make_virtual()]
    tid_of: dict[int, int] = {}
    for u in order:
        node = full.nodes[u]
        if node.kind == "inter":
            tid = len(tasks)
            tid_of[u] = tid
            tasks.append(dataclasses.replace(node.task, tid=tid))

    # propagate {origin inter-pod task -> max accumulated intra-pod lag}
    lag: list[dict[int, float]] = [dict() for _ in range(n)]
    edges: dict[tuple[int, int], float] = {}
    for u in order:
        node = full.nodes[u]
        acc: dict[int, float] = {}
        if not preds[u]:
            acc[VIRTUAL] = 0.0
        for p in preds[u]:
            for o, d in lag[p].items():
                if d > acc.get(o, -1.0):
                    acc[o] = d
        if node.kind == "inter":
            tid = tid_of[u]
            for o, d in acc.items():
                key = (o, tid)
                if d > edges.get(key, -1.0):
                    edges[key] = d
            lag[u] = {tid: 0.0}
        else:
            dur = node.duration
            lag[u] = {o: d + dur for o, d in acc.items()}

    if prune_dominated:
        edges = _prune_dominated(edges, tasks, cluster)

    deps = [Dep(pre, succ, delta) for (pre, succ), delta in sorted(edges.items())]
    return CommDAG(tasks=tasks, deps=deps, cluster=cluster, meta=meta or {})


def _prune_dominated(edges: dict[tuple[int, int], float],
                     tasks: list[CommTask], cluster: ClusterSpec,
                     eps: float = 1e-12) -> dict[tuple[int, int], float]:
    """Drop (o, n, delta) if some 2-path o -> m -> n already enforces it."""
    tau_min = [0.0] * len(tasks)
    for t in tasks:
        if not t.is_virtual:
            tau_min[t.tid] = t.volume / (t.flows * cluster.nic_bandwidth)
    out_of: dict[int, list[tuple[int, float]]] = collections.defaultdict(list)
    for (o, m), d in edges.items():
        out_of[o].append((m, d))
    kept: dict[tuple[int, int], float] = {}
    for (o, nn), delta in edges.items():
        dominated = False
        for m, d1 in out_of[o]:
            if m == nn:
                continue
            d2 = edges.get((m, nn))
            if d2 is not None and d1 + tau_min[m] + d2 >= delta - eps:
                dominated = True
                break
        if not dominated:
            kept[(o, nn)] = delta
    return kept


# ------------------------------------------------------------------- facade
def build_comm_dag(job: JobSpec, inter_pod_gbps: float = 400.0,
                   reduce_replicas: bool = True,
                   reverse_stages: bool = False,
                   cluster: ClusterSpec | None = None,
                   prune_dominated: bool = True) -> CommDAG:
    """JobSpec -> reduced inter-pod CommDAG (the paper's (M, D) input)."""
    placement = job.placement(reverse_stages)
    if cluster is None:
        cluster = job.cluster(inter_pod_gbps, reverse_stages=reverse_stages)
    full = build_full_dag(job, cluster, placement,
                          reduce_replicas=reduce_replicas)
    meta = {"job": job.name, "full_dag": full.stats(),
            "reduce_replicas": reduce_replicas,
            "reverse_stages": reverse_stages,
            "inter_pod_gbps": inter_pod_gbps}
    return reduce_dag(full, cluster, prune_dominated=prune_dominated,
                      meta=meta)
