"""phi3-mini-3.8b [dense]: 32L d3072 32H (GQA kv=32) dff8192 vocab 32064,
RoPE SwiGLU [arXiv:2404.14219; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    layers=32, d_model=3072, heads=32, kv_heads=32, d_ff=8192,
    vocab=32064, head_dim=96, rope_theta=1e4)
PLAN = ParallelismPlan(tp=2, pp=4, dp=4, gpus_per_pod_per_replica=4)
ARCH = ArchSpec(CONFIG, PLAN, source="arXiv:2404.14219",
                notes="MHA (kv=heads), RoPE + SwiGLU")
