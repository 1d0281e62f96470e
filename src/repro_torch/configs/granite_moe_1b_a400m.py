"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) dff512,
MoE 32e top-8, vocab 49155 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    layers=24, d_model=1024, heads=16, kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, moe_experts=32, moe_top_k=8, moe_every=1,
    rope_theta=1e4)
PLAN = ParallelismPlan(tp=1, pp=4, dp=8, ep=8,
                       gpus_per_pod_per_replica=2)
ARCH = ArchSpec(CONFIG, PLAN, source="hf:ibm-granite/granite-3.0-1b-a400m",
                notes="32 experts top-8")
