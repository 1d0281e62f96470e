"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) dff24576
vocab 65536, MoE 16e top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    layers=72, d_model=8192, heads=64, kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    moe_experts=16, moe_top_k=2, moe_every=2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    attn_every=8, rope_theta=1e6)
PLAN = ParallelismPlan(tp=8, pp=9, dp=8, ep=16,
                       gpus_per_pod_per_replica=32)
ARCH = ArchSpec(CONFIG, PLAN, source="arXiv:2403.19887",
                notes="Mamba/attn 1:7, MoE every 2nd layer")
