"""Cluster and placement model for OCS-AIDC topology optimization.

Pods are interconnected by optical circuit switches (OCS); within a pod the
electrical network is treated as non-blocking (intra-pod tasks are collapsed
into the rigid deltas of the reduced DAG, per paper Sec. III-A).

Units used throughout repro_torch.core:
    time        -> seconds
    data volume -> bytes
    bandwidth   -> bytes / second
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

GBPS = 1e9 / 8.0  # 1 Gb/s in bytes/s


def split_port_budgets(port_limits: Sequence[int],
                       num_planes: int) -> tuple[tuple[int, ...], ...]:
    """Split per-pod port budgets across `num_planes` parallel OCS planes.

    Each pod's U_p ports are divided as evenly as possible: every plane
    gets ``U_p // k`` and the first ``U_p % k`` planes one extra, so the
    per-plane budgets sum to U_p exactly and differ by at most one.  The
    deterministic remainder placement (low plane ids first) matters: the
    fleet's plane book must be bit-identically reconstructible from a
    journal replay.
    """
    k = int(num_planes)
    if k < 1:
        raise ValueError(f"num_planes must be >= 1, got {num_planes}")
    limits = [int(u) for u in port_limits]
    if any(u < 0 for u in limits):
        raise ValueError(f"port budgets must be non-negative: {limits}")
    return tuple(
        tuple(u // k + (1 if p < u % k else 0) for u in limits)
        for p in range(k))


@dataclass(frozen=True)
class ClusterSpec:
    """A set of pods with OCS port budgets and per-NIC injection bandwidth.

    Attributes:
      num_pods:     number of pods |P| hosting the job.
      port_limits:  U_p -- max OCS ports available to this job per pod.  The
                    paper constrains U_p to the number of GPUs the job owns in
                    pod p (fairness); callers can pass larger budgets to model
                    surplus-port reallocation (Fig. 10).
      nic_bandwidth: B -- injection bandwidth of a single NIC == capacity of a
                    single OCS port (bytes/s).
      intra_pod_bandwidth: per-GPU intra-pod electrical bandwidth used only to
                    derive durations of intra-pod communication before DAG
                    reduction (bytes/s).
      ep_spans:     one tuple of pod ids per expert-parallel group, listing
                    the pods the group's GPUs span (empty when the job has
                    no cross-replica EP traffic).  Purely descriptive:
                    recorded in the tab1 benchmark payload so consumers of
                    the workload JSON can reason about concurrent EP
                    all-to-all demand without re-deriving the placement.
    """

    num_pods: int
    port_limits: tuple[int, ...]
    nic_bandwidth: float
    intra_pod_bandwidth: float = 900e9
    ep_spans: tuple[tuple[int, ...], ...] = ()

    def __post_init__(self) -> None:
        if len(self.port_limits) != self.num_pods:
            raise ValueError(
                f"port_limits has {len(self.port_limits)} entries, expected "
                f"{self.num_pods}")
        if self.nic_bandwidth <= 0:
            raise ValueError("nic_bandwidth must be positive")

    @classmethod
    def uniform(cls, num_pods: int, ports_per_pod: int,
                nic_bandwidth: float, **kw) -> "ClusterSpec":
        return cls(num_pods=num_pods,
                   port_limits=(ports_per_pod,) * num_pods,
                   nic_bandwidth=nic_bandwidth, **kw)

    def with_port_limits(self, port_limits: Sequence[int]) -> "ClusterSpec":
        return dataclasses.replace(self, port_limits=tuple(port_limits))

    def plane_port_limits(self, num_planes: int
                          ) -> tuple[tuple[int, ...], ...]:
        """Per-plane port budgets for a k-plane fabric (see
        `split_port_budgets`): k tuples of per-pod budgets summing to
        `port_limits` elementwise."""
        return split_port_budgets(self.port_limits, num_planes)


@dataclass(frozen=True)
class Placement:
    """Maps (replica, stage, tp_rank) -> (pod, global gpu id).

    Fragmented multi-tenant placement (paper Sec. V-A1): each DP replica owns
    `gpus_per_pod_per_replica` GPUs in each pod it touches, so a replica with
    tp*pp GPUs spans ceil(tp*pp / gppr) pods, stages packed contiguously.
    `reverse_stages=True` gives the Model^T deployment of Fig. 10 (reversed
    stage-to-pod mapping over the same pods).

    `ep` is the expert-parallel degree: EP groups stride across DP replicas
    within a stage, so group g covers replicas [g*span, (g+1)*span) with
    span = min(ep, dp).  A replica's stage-s expert shard exchanges
    all-to-all traffic with the stage-s shards of its group peers, which
    live in the peers' pods.
    """

    tp: int
    pp: int
    dp: int
    gpus_per_pod_per_replica: int
    ep: int = 1
    reverse_stages: bool = False

    def __post_init__(self) -> None:
        gppr = self.gpus_per_pod_per_replica
        if gppr % self.tp != 0:
            raise ValueError(
                f"gpus_per_pod_per_replica={gppr} must be a multiple of tp="
                f"{self.tp} so stages do not straddle pods")
        if self.ep > 1:
            if self.ep <= self.dp and self.dp % self.ep:
                raise ValueError(f"ep={self.ep} must divide dp={self.dp}")
            if self.ep > self.dp and self.ep % self.dp:
                raise ValueError(f"ep={self.ep} > dp={self.dp} needs dp | ep")

    @property
    def gpus_per_replica(self) -> int:
        return self.tp * self.pp

    @property
    def pods_per_replica(self) -> int:
        return math.ceil(self.gpus_per_replica /
                         self.gpus_per_pod_per_replica)

    @property
    def stages_per_pod(self) -> int:
        return max(1, self.gpus_per_pod_per_replica // self.tp)

    @property
    def num_pods(self) -> int:
        return self.pods_per_replica * self.dp

    @property
    def num_gpus(self) -> int:
        return self.gpus_per_replica * self.dp

    def stage_pod_offset(self, stage: int) -> int:
        s = (self.pp - 1 - stage) if self.reverse_stages else stage
        return min(s // self.stages_per_pod, self.pods_per_replica - 1)

    def pod_of(self, replica: int, stage: int) -> int:
        return replica * self.pods_per_replica + self.stage_pod_offset(stage)

    def gpu_ids(self, replica: int, stage: int) -> tuple[int, ...]:
        base = replica * self.gpus_per_replica + stage * self.tp
        return tuple(range(base, base + self.tp))

    def gpus_in_pod(self, pod: int) -> int:
        count = 0
        for r in range(self.dp):
            for s in range(self.pp):
                if self.pod_of(r, s) == pod:
                    count += self.tp
        return count

    def port_limits(self) -> tuple[int, ...]:
        """Default U_p = number of job GPUs in each pod (paper fairness rule)."""
        return tuple(self.gpus_in_pod(p) for p in range(self.num_pods))

    # ------------------------------------------------------------ EP groups
    @property
    def ep_span(self) -> int:
        """DP replicas spanned by one EP group (1 -> no cross-replica EP)."""
        return min(self.ep, self.dp) if self.ep > 1 else 1

    def ep_groups(self) -> list[tuple[int, ...]]:
        """Replica ids per EP group; empty when EP stays within a replica."""
        span = self.ep_span
        if span < 2:
            return []
        return [tuple(range(g * span, (g + 1) * span))
                for g in range(self.dp // span)]

    def ep_group_pods(self, group: Sequence[int]) -> tuple[int, ...]:
        """Pods spanned by one EP group's GPUs (all stages)."""
        return tuple(sorted({self.pod_of(r, s)
                             for r in group for s in range(self.pp)}))

    def ep_spans(self) -> tuple[tuple[int, ...], ...]:
        return tuple(self.ep_group_pods(g) for g in self.ep_groups())

    def cluster(self, nic_bandwidth: float, **kw) -> ClusterSpec:
        kw.setdefault("ep_spans", self.ep_spans())
        return ClusterSpec(num_pods=self.num_pods,
                           port_limits=self.port_limits(),
                           nic_bandwidth=nic_bandwidth, **kw)

    def reversed(self) -> "Placement":
        return dataclasses.replace(self, reverse_stages=not self.reverse_stages)
