"""The paper's four evaluation workloads (Table I) + the GPT-7B profiling
example of Fig. 1/3.  Parallelism configs match Table I exactly; model
dimensions are representative published configs with matching totals (the
DELTA benchmarks only consume parallelism + parameter/activation volumes).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

GPT_7B = ArchSpec(
    ModelConfig(name="gpt-7b", family="dense", layers=32, d_model=4096,
                heads=32, kv_heads=32, d_ff=11008, vocab=50257),
    ParallelismPlan(tp=2, pp=4, dp=2, gpus_per_pod_per_replica=4,
                    microbatches=8),
    source="paper Fig. 1", notes="profiling example; 4 pods")

MEGATRON_177B = ArchSpec(
    ModelConfig(name="megatron-177b", family="dense", layers=96,
                d_model=12288, heads=96, kv_heads=96, d_ff=32768,
                vocab=51200),
    ParallelismPlan(tp=8, pp=6, dp=8, gpus_per_pod_per_replica=16,
                    microbatches=48),
    source="paper Table I / Megatron benchmarks [59-61]")

MIXTRAL_8X22B = ArchSpec(
    ModelConfig(name="mixtral-8x22b", family="moe", layers=56,
                d_model=6144, heads=48, kv_heads=8, d_ff=16384,
                vocab=32768, moe_experts=8, moe_top_k=2, moe_every=1),
    ParallelismPlan(tp=2, pp=8, dp=8, ep=8, gpus_per_pod_per_replica=16,
                    microbatches=64),
    source="paper Table I [arXiv:2401.04088]")

MEGATRON_462B = ArchSpec(
    ModelConfig(name="megatron-462b", family="dense", layers=128,
                d_model=17408, heads=136, kv_heads=136, d_ff=46080,
                vocab=51200),
    ParallelismPlan(tp=8, pp=16, dp=8, gpus_per_pod_per_replica=32,
                    microbatches=128),
    source="paper Table I / Megatron benchmarks [59-61]")

DEEPSEEK_671B = ArchSpec(
    ModelConfig(name="deepseek-671b", family="moe", layers=64,
                d_model=7168, heads=56, kv_heads=8, d_ff=1888,
                vocab=129280, moe_experts=256, moe_top_k=8, moe_every=1),
    ParallelismPlan(tp=2, pp=16, dp=8, ep=8, gpus_per_pod_per_replica=32,
                    microbatches=128),
    source="paper Table I [DeepSeek-V3]")

PAPER_WORKLOADS = {
    "gpt-7b": GPT_7B,
    "megatron-177b": MEGATRON_177B,
    "mixtral-8x22b": MIXTRAL_8X22B,
    "megatron-462b": MEGATRON_462B,
    "deepseek-671b": DEEPSEEK_671B,
}
