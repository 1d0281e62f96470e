"""Architecture / parallelism-plan schema and `make_job`.

The port carries the schema and the traffic-generator entry point; its
only architectures are the paper's Table-I workloads
(`repro_torch.configs.paper_workloads.PAPER_WORKLOADS`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | encdec
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // heads
    # --- MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1        # MoE FFN every k-th layer (jamba: 2)
    moe_capacity: float = 1.25  # capacity factor (tokens may drop beyond)
    # --- SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0       # hybrid: 1 attention layer per this many
    # --- modality frontends (stubs provide precomputed embeddings)
    cross_attn_every: int = 0  # vlm: cross-attn layer per this many
    num_image_tokens: int = 0
    encoder_layers: int = 0    # encdec decoder cross-attends to these
    enc_tokens: int = 0        # whisper: 1500 frames after conv frontend
    # --- flags
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.heads)

    @property
    def group_size(self) -> int:
        """Layer-pattern period (scan groups stack identical periods)."""
        g = 1
        for v in (self.attn_every, self.moe_every, self.cross_attn_every):
            if v and v > 1:
                g = math.lcm(g, v)
        return g

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_every:
            return (i % self.attn_every) == self.attn_every - 1
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_experts <= 0:
            return False
        return (i % self.moe_every) == self.moe_every - 1

    def is_xattn_layer(self, i: int) -> bool:
        if not self.cross_attn_every:
            return False
        return (i % self.cross_attn_every) == self.cross_attn_every - 1

    # ------------------------------------------------------- param counting
    def layer_params(self, i: int) -> int:
        d, hd = self.d_model, self.hd
        n = 0
        if self.is_attn_layer(i):
            q = d * self.heads * hd
            kv = 2 * d * self.kv_heads * hd
            o = self.heads * hd * d
            n += q + kv + o
            if self.qkv_bias:
                n += (self.heads + 2 * self.kv_heads) * hd
        else:  # mamba2 block
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            n += d * (2 * d_in + 2 * self.ssm_state + nheads)  # in_proj
            n += self.ssm_conv * (d_in + 2 * self.ssm_state)   # conv
            n += d_in * d                                       # out_proj
            n += 2 * nheads                                     # A_log, dt_b
        if self.is_moe_layer(i):
            n += d * self.moe_experts                           # router
            n += self.moe_experts * 3 * d * self.d_ff
        elif self.d_ff > 0:
            n += 3 * d * self.d_ff                              # swiglu
        if self.is_xattn_layer(i):
            n += 2 * d * self.heads * hd + 2 * d * self.kv_heads * hd
        n += 2 * d                                              # 2 rmsnorms
        return n

    def layer_active_params(self, i: int) -> int:
        n = self.layer_params(i)
        if self.is_moe_layer(i):
            n -= self.moe_experts * 3 * self.d_model * self.d_ff
            n += self.moe_top_k * 3 * self.d_model * self.d_ff
        return n

    def embed_params(self) -> int:
        return self.vocab * self.d_model

    def head_params(self) -> int:
        return 0 if self.tie_embeddings else self.vocab * self.d_model

    def encoder_params(self) -> int:
        if not self.encoder_layers:
            return 0
        d, hd = self.d_model, self.hd
        per = (self.heads * hd * d * 2 + 2 * d * self.kv_heads * hd
               + 3 * d * self.d_ff + 2 * d)
        return self.encoder_layers * per

    def total_params(self) -> int:
        n = self.embed_params() + self.head_params() + self.encoder_params()
        n += sum(self.layer_params(i) for i in range(self.layers))
        return n

    def total_active_params(self) -> int:
        n = self.embed_params() + self.head_params() + self.encoder_params()
        n += sum(self.layer_active_params(i) for i in range(self.layers))
        return n


@dataclass(frozen=True)
class ParallelismPlan:
    """Training parallelization feeding DELTA's inter-pod DAG."""
    tp: int
    pp: int
    dp: int
    ep: int = 1
    gpus_per_pod_per_replica: int = 16
    microbatches: int = 0          # 0 -> 8 * pp (paper Sec. V-A1)
    micro_batch_size: int = 1      # sequences per microbatch
    gpu_flops: float = 140e12      # effective bf16/GPU incl. MFU

    @property
    def num_gpus(self) -> int:
        return self.tp * self.pp * self.dp

    @property
    def num_microbatches(self) -> int:
        return self.microbatches or 8 * self.pp


@dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    plan: ParallelismPlan
    # provenance strings for humans reading the spec tables, not the code
    source: str = ""
    notes: str = ""


def make_job(arch: ArchSpec, seq_len: int = 4096,
             microbatches: int | None = None, act_bytes: int = 2,
             grad_bytes: int = 2):
    """ArchSpec -> repro_torch.core.traffic.JobSpec (DELTA's input)."""
    from repro_torch.core.traffic import JobSpec
    cfg, plan = arch.config, arch.plan
    pp = plan.pp
    dec_layers = cfg.layers
    enc_layers = cfg.encoder_layers
    total_layers = dec_layers + enc_layers
    if total_layers % pp:
        raise ValueError(f"{cfg.name}: {total_layers} layers not divisible "
                         f"by pp={pp}")
    per_stage = total_layers // pp
    stage_params: list[float] = []
    stage_active: list[float] = []
    stage_moe: list[int] = []
    enc_stages = enc_layers // per_stage if enc_layers else 0
    d = cfg.d_model
    enc_layer_p = (cfg.encoder_params() / max(enc_layers, 1)) \
        if enc_layers else 0.0
    for s in range(pp):
        lo, hi = s * per_stage, (s + 1) * per_stage
        p = a = 0.0
        n_moe = 0
        for li in range(lo, hi):
            if li < enc_layers:
                p += enc_layer_p
                a += enc_layer_p
            else:
                i = li - enc_layers
                p += cfg.layer_params(i)
                a += cfg.layer_active_params(i)
                n_moe += int(cfg.is_moe_layer(i))
        if s == 0:
            p += cfg.embed_params()
            a += cfg.embed_params() / max(seq_len, 1)  # sparse lookup
        if s == pp - 1:
            p += cfg.head_params()
            a += cfg.head_params()
        stage_params.append(p)
        stage_active.append(a)
        stage_moe.append(n_moe)
    mb = microbatches or plan.num_microbatches
    return JobSpec(
        name=cfg.name,
        tp=plan.tp, pp=pp, dp=plan.dp, ep=plan.ep,
        num_microbatches=mb,
        micro_tokens=plan.micro_batch_size * seq_len,
        d_model=d,
        stage_params=tuple(stage_params),
        active_stage_params=tuple(stage_active),
        moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
        moe_every=cfg.moe_every,
        moe_stage_layers=tuple(stage_moe) if cfg.moe_experts else (),
        gpus_per_pod_per_replica=plan.gpus_per_pod_per_replica,
        act_bytes=act_bytes, grad_bytes=grad_bytes,
        gpu_flops=plan.gpu_flops,
        enc_stages=enc_stages,
        enc_tokens=plan.micro_batch_size * cfg.enc_tokens,
        seq_len=seq_len,
    )
