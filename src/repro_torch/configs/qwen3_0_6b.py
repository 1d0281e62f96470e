"""qwen3-0.6b [dense]: 28L d1024 16H (GQA kv=8) dff3072 vocab 151936,
qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    layers=28, d_model=1024, heads=16, kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=64, qk_norm=True, rope_theta=1e6)
PLAN = ParallelismPlan(tp=1, pp=4, dp=8, gpus_per_pod_per_replica=2)
ARCH = ArchSpec(CONFIG, PLAN, source="hf:Qwen/Qwen3-8B",
                notes="qk_norm, GQA")
