"""whisper-large-v3 [audio/encdec]: 32L(+32 enc) d1280 20H dff5120
vocab 51866, conv frontend stubbed [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ParallelismPlan

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    layers=32, d_model=1280, heads=20, kv_heads=20, d_ff=5120,
    vocab=51866, head_dim=64, rope_theta=1e4,
    cross_attn_every=1, encoder_layers=32, enc_tokens=1500)
PLAN = ParallelismPlan(tp=1, pp=8, dp=8, gpus_per_pod_per_replica=2)
ARCH = ArchSpec(CONFIG, PLAN, source="arXiv:2212.04356",
                notes="conv frontend stub: input_specs provides "
                      "precomputed frame embeddings (1500 x d_model)")
