"""The paper's Table-I workloads (`PAPER_WORKLOADS`) and `make_job`."""
from repro_torch.configs.base import (ArchSpec, ModelConfig, ParallelismPlan,
                                      make_job)
from repro_torch.configs.paper_workloads import PAPER_WORKLOADS

__all__ = ["PAPER_WORKLOADS", "ArchSpec", "ModelConfig", "ParallelismPlan",
           "make_job"]
