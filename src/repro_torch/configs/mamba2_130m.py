"""mamba2-130m [ssm]: 24L d768 attn-free, ssm_state=128, SSD
[arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    layers=24, d_model=768, heads=12, kv_heads=12, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True)
PLAN = ParallelismPlan(tp=1, pp=4, dp=8, gpus_per_pod_per_replica=2)
ARCH = ArchSpec(CONFIG, PLAN, source="arXiv:2405.21060",
                notes="SSD state-space duality; no attention, no FFN")
