"""Analytic traffic/duration model for LLM training iterations (paper F1).

The paper generates communication traces with simAI; because LLM traffic is
deterministic given (model, parallelism, schedule) -- feature F1 -- we compute
the same quantities analytically:

  PP activation/gradient volume per microbatch boundary:
      V_pp = micro_tokens * d_model * act_bytes
  DP gradient-sync volume per stage (unidirectional ring all-reduce, so the
  single-replica projection of Sec. IV-A1 stays port-exact):
      V_dp = 2 * (dp-1)/dp * stage_param_bytes   per ring link r -> r+1
  EP all-to-all volume per MoE dispatch (== combine) per replica:
      V_ep = micro_tokens * d_model * act_bytes * top_k * (ep-1)/ep
  (each routed token copy leaves the local expert shard with probability
  (ep-1)/ep; forward and backward each perform one dispatch + one combine
  per MoE layer, so one stage contributes 2 * n_moe_layers(stage) * V_ep
  per direction).  EP groups stride across DP replicas within a stage --
  replica r exchanges tokens with the other min(ep, dp) - 1 replicas of its
  group, whose stage-s shards live in different pods.  When ep > dp
  (jamba-style expert sharding inside the TP group) the cross-replica span
  saturates at dp and the intra-pod fraction of the all-to-all is still
  charged to V_ep -- a deliberate, slightly conservative upper bound.
  compute durations from a FLOPs model:
      fwd(b, s) = 2 * active_stage_params[s] * micro_tokens / (tp * gpu_flops)
      bwd       = 2 * fwd
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.cluster import GBPS, ClusterSpec, Placement


@dataclass(frozen=True)
class JobSpec:
    """Everything DELTA needs to know about one training job.

    stage_params: parameters *synchronized by DP* per pipeline stage (bytes
      are derived with grad_bytes).  For MoE models this includes all experts.
    active_stage_params: parameters touched per token (MoE: routed experts
      only) -- drives compute durations.
    moe_experts / moe_top_k / moe_every: MoE routing shape (from
      ModelConfig); moe_top_k drives the EP all-to-all volume.
    moe_stage_layers: number of MoE layers hosted by each pipeline stage
      (pp entries; make_job derives it from ModelConfig.is_moe_layer).
      Empty means no EP traffic is modeled even if ep > 1.
    ep: expert-parallel degree.  EP groups stride across DP replicas within
      a stage (see module docstring); ep == 1 disables EP traffic entirely
      and yields DAGs bit-identical to the pre-MoE builder.
    """

    name: str
    tp: int
    pp: int
    dp: int
    num_microbatches: int
    micro_tokens: int
    d_model: int
    stage_params: tuple[float, ...]
    active_stage_params: tuple[float, ...] = ()
    gpus_per_pod_per_replica: int = 16
    ep: int = 1
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1
    moe_stage_layers: tuple[int, ...] = ()
    act_bytes: int = 2
    grad_bytes: int = 2
    gpu_flops: float = 140e12   # effective per-GPU throughput (bf16 * MFU)
    enc_stages: int = 0         # >0: first enc_stages stages form an encoder
    enc_tokens: int = 0         # encoder frames per microbatch (whisper stub)
    seq_len: int = 4096

    def __post_init__(self) -> None:
        if len(self.stage_params) != self.pp:
            raise ValueError("stage_params must have pp entries")
        if self.active_stage_params and \
                len(self.active_stage_params) != self.pp:
            raise ValueError("active_stage_params must have pp entries")
        if self.num_microbatches < 1 or self.pp < 1:
            raise ValueError("bad schedule sizes")
        if self.moe_stage_layers and len(self.moe_stage_layers) != self.pp:
            raise ValueError("moe_stage_layers must have pp entries")
        if self.ep > 1:
            if self.ep <= self.dp and self.dp % self.ep:
                raise ValueError(
                    f"ep={self.ep} must divide dp={self.dp} (EP groups "
                    f"stride across DP replicas within a stage)")
            if self.ep > self.dp and self.ep % self.dp:
                raise ValueError(
                    f"ep={self.ep} > dp={self.dp} requires dp | ep (the "
                    f"per-replica remainder shards inside the TP group)")

    @property
    def active(self) -> tuple[float, ...]:
        return self.active_stage_params or self.stage_params

    # ------------------------------------------------------------- placement
    def placement(self, reverse_stages: bool = False) -> Placement:
        return Placement(tp=self.tp, pp=self.pp, dp=self.dp,
                         gpus_per_pod_per_replica=self.gpus_per_pod_per_replica,
                         ep=self.ep,
                         reverse_stages=reverse_stages)

    def cluster(self, inter_pod_gbps: float = 400.0,
                reverse_stages: bool = False, **kw) -> ClusterSpec:
        return self.placement(reverse_stages).cluster(
            nic_bandwidth=inter_pod_gbps * GBPS, **kw)

    # --------------------------------------------------------------- volumes
    def pp_volume(self) -> float:
        """Activation (== gradient) bytes crossing one stage boundary per
        microbatch, aggregated over the TP group (paper task aggregation)."""
        return float(self.micro_tokens * self.d_model * self.act_bytes)

    def xattn_volume(self) -> float:
        """Encoder-output bytes consumed by each decoder stage (enc-dec)."""
        return float(self.enc_tokens * self.d_model * self.act_bytes)

    def dp_volume(self, stage: int) -> float:
        bytes_ = self.stage_params[stage] * self.grad_bytes
        return float(2.0 * (self.dp - 1) / self.dp * bytes_)

    def ep_a2a_volume(self) -> float:
        """Bytes a replica's stage GPUs inject per MoE dispatch (== per
        combine), aggregated over the TP group: each of the top_k routed
        token copies leaves the local expert shard with prob. (ep-1)/ep."""
        if self.ep <= 1 or self.moe_top_k <= 0:
            return 0.0
        return float(self.micro_tokens * self.d_model * self.act_bytes
                     * self.moe_top_k * (self.ep - 1) / self.ep)

    def ep_a2a_stage_volume(self, stage: int) -> float:
        """Per-direction (fwd or bwd) EP all-to-all bytes for one
        (replica, microbatch) at `stage`: dispatch + combine for every MoE
        layer the stage hosts."""
        if not self.moe_stage_layers:
            return 0.0
        return 2.0 * self.moe_stage_layers[stage] * self.ep_a2a_volume()

    # -------------------------------------------------------------- durations
    def fwd_duration(self, stage: int) -> float:
        tokens = self.micro_tokens
        if self.enc_stages and stage < self.enc_stages:
            tokens = max(self.enc_tokens, 1)
        return 2.0 * self.active[stage] * tokens / (self.tp * self.gpu_flops)

    def bwd_duration(self, stage: int) -> float:
        return 2.0 * self.fwd_duration(stage)

    def intra_pp_duration(self, cluster: ClusterSpec) -> float:
        """Duration of a stage-boundary transfer when both stages share a
        pod (electrical intra-pod network)."""
        return self.pp_volume() / (self.tp * cluster.intra_pod_bandwidth)

    # ------------------------------------------------------------- reporting
    def total_params(self) -> float:
        return float(sum(self.stage_params))

    def iteration_tokens(self) -> int:
        return self.num_microbatches * self.micro_tokens

    def scaled(self, **overrides) -> "JobSpec":
        return dataclasses.replace(self, **overrides)


def ideal_step_compute_time(job: JobSpec) -> float:
    """Pipeline-unaware lower bound on compute time (for sanity checks)."""
    per_mb = sum(job.fwd_duration(s) + job.bwd_duration(s)
                 for s in range(job.pp))
    return per_mb * job.num_microbatches / job.pp
