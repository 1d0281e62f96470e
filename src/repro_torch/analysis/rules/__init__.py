"""Sentinel rules of the port: importing this package registers every rule.

Catalog (codes kept from the reference's `repro.analysis`, so that each
rule's counterpart is found under the same code; RPR010-011 are new):

  RPR001  unread-field              the `JobSpec.ep` bug
  RPR002  caller-options-mutation   the `MILPOptions` bug
  RPR003  float64-on-device         the float64 dtype seam, on the card
  RPR004  bare-host-array-hot-path  the float64 seam's host-side twin
  RPR005  solver-status-gate        the time_limit/no-incumbent bug
  RPR006  host-sync-in-hot-loop     syncs per iteration of the event loop
  RPR007  capture-impurity          obs/time/random under CUDA-graph capture
  RPR008  cache-key-hygiene         engine-cache keys (tensors hash by id)
  RPR009  deprecated-facade-call    the plan() API unification
  RPR010  device-fallback           a device failure swallowed, not raised
  RPR011  reduced-precision-matmul  TF32 against float32 tolerances
"""
from repro_torch.analysis.rules import (cachekey, dtype, facade, fallback,
                                        fields, jit, mutation, precision,
                                        solver)

__all__ = ["cachekey", "dtype", "facade", "fallback", "fields", "jit",
           "mutation", "precision", "solver"]
