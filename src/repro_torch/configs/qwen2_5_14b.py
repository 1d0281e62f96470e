"""qwen2.5-14b [dense]: 48L d5120 40H (GQA kv=8) dff13824 vocab 152064,
QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    layers=48, d_model=5120, heads=40, kv_heads=8, d_ff=13824,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6)
PLAN = ParallelismPlan(tp=4, pp=4, dp=4, gpus_per_pod_per_replica=8)
ARCH = ArchSpec(CONFIG, PLAN, source="hf:Qwen/Qwen2.5-0.5B",
                notes="GQA with QKV bias")
