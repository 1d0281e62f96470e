"""yi-6b [dense]: 32L d4096 32H (GQA kv=4) dff11008 vocab 64000
[arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    layers=32, d_model=4096, heads=32, kv_heads=4, d_ff=11008,
    vocab=64000, head_dim=128, rope_theta=5e6)
PLAN = ParallelismPlan(tp=2, pp=4, dp=4, gpus_per_pod_per_replica=4)
ARCH = ArchSpec(CONFIG, PLAN, source="arXiv:2403.04652",
                notes="llama-arch GQA")
