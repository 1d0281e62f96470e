"""Architecture registry.

REGISTRY       -- the 10 assigned architectures (dry-run / roofline matrix)
PAPER_WORKLOADS -- the paper's Table-I workloads + GPT-7B (DELTA benchmarks)
"""
from repro_torch.configs.base import (SHAPES, ArchSpec, ModelConfig,
                                      ParallelismPlan, ShapeSpec, make_job,
                                      shape_applicable)
from repro_torch.configs import (granite_moe_1b_a400m, grok_1_314b,
                                 jamba_1_5_large_398b, llama_3_2_vision_11b,
                                 mamba2_130m, phi3_mini_3_8b, qwen2_5_14b,
                                 qwen3_0_6b, whisper_large_v3, yi_6b)
from repro_torch.configs.paper_workloads import PAPER_WORKLOADS

REGISTRY: dict[str, ArchSpec] = {
    "jamba-1.5-large-398b": jamba_1_5_large_398b.ARCH,
    "yi-6b": yi_6b.ARCH,
    "qwen2.5-14b": qwen2_5_14b.ARCH,
    "phi3-mini-3.8b": phi3_mini_3_8b.ARCH,
    "qwen3-0.6b": qwen3_0_6b.ARCH,
    "mamba2-130m": mamba2_130m.ARCH,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.ARCH,
    "whisper-large-v3": whisper_large_v3.ARCH,
    "grok-1-314b": grok_1_314b.ARCH,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.ARCH,
}

ALL_ARCHS = {**REGISTRY, **PAPER_WORKLOADS}

__all__ = ["REGISTRY", "PAPER_WORKLOADS", "ALL_ARCHS", "ArchSpec",
           "ModelConfig", "ParallelismPlan", "SHAPES", "ShapeSpec",
           "make_job", "shape_applicable"]
