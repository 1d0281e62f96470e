"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) dff32768 vocab 131072,
MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    layers=64, d_model=6144, heads=48, kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128, moe_experts=8, moe_top_k=2, moe_every=1,
    rope_theta=1e4)
PLAN = ParallelismPlan(tp=8, pp=8, dp=8, ep=8,
                       gpus_per_pod_per_replica=32)
ARCH = ArchSpec(CONFIG, PLAN, source="hf:xai-org/grok-1",
                notes="8 experts top-2, every layer MoE")
