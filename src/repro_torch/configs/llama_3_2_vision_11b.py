"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) dff14336
vocab 128256, cross-attn image layers every 5
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    layers=40, d_model=4096, heads=32, kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=5e5,
    cross_attn_every=5, num_image_tokens=1601)
PLAN = ParallelismPlan(tp=4, pp=5, dp=4, gpus_per_pod_per_replica=4)
ARCH = ArchSpec(CONFIG, PLAN, source="hf:meta-llama/Llama-3.2-11B-Vision",
                notes="vision frontend stubbed: input_specs provides "
                      "precomputed patch embeddings")
