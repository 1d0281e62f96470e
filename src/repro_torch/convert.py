"""Carrying the planner's state across to the port's tensors.

DELTA has no weights: its state is the DES problem (task volumes, the
dependency lists, the constraint incidence) and the topology.  Both
packages pad a problem into the same flat numpy arrays (`_problem_fields`
in `repro.core.des_jax` and `repro_torch.core.des_torch`, equal array for
array), so these functions are the one place where numpy state becomes
device tensors: the torch DES builds its arrays through them, and the
parity tests feed the JAX reference's arrays through them.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

if TYPE_CHECKING:   # pragma: no cover - annotation-only import
    from repro_torch.core.des_torch import PadSpec

_FLOAT_FIELDS = ("volume", "flows", "dep_delta", "con_w")
_INDEX_FIELDS = ("dep_pre", "dep_succ", "con_task", "con_id",
                 "link_pair_a", "link_pair_b")
# array length of each field, by PadSpec attribute
_FIELD_SIZE = {"volume": "n", "flows": "n", "indegree": "n",
               "task_valid": "n", "dep_pre": "d", "dep_succ": "d",
               "dep_delta": "d", "con_task": "e", "con_id": "e",
               "con_w": "e", "link_pair_a": "links", "link_pair_b": "links"}


class DESArrays(NamedTuple):
    """Static problem arrays of the torch DES, on one device.

    Volumes are in seconds at one-circuit rate (the NIC bandwidth is
    rescaled to 1), so every quantity stays O(1) in float32.
    """
    volume: torch.Tensor       # (n,) float32
    flows: torch.Tensor        # (n,) float32
    dep_pre: torch.Tensor      # (d,) int64
    dep_succ: torch.Tensor     # (d,) int64
    dep_delta: torch.Tensor    # (d,) float32
    indegree: torch.Tensor     # (n,) int32
    con_task: torch.Tensor     # (e,) int64 incidence: task index
    con_id: torch.Tensor       # (e,) int64 incidence: constraint index
    con_w: torch.Tensor        # (e,) float32 weight on phi
    link_pair_a: torch.Tensor  # (L,) int64 src pod per link constraint
    link_pair_b: torch.Tensor  # (L,) int64 dst pod per link constraint
    task_valid: torch.Tensor   # (n,) bool, False for padding ghost tasks
    num_cons: int
    num_link_cons: int
    n: int


def des_arrays_from_numpy(fields: dict[str, np.ndarray], pad: "PadSpec",
                          device: torch.device | str) -> DESArrays:
    """One padded problem's numpy fields -> `DESArrays` on `device`.

    Floats become float32 (as the JAX reference's float32 arrays round
    them), indices int64, `indegree` int32 and `task_valid` bool.  Raises
    on a missing or extra field or a length that disagrees with `pad`.
    """
    if set(fields) != set(_FIELD_SIZE):
        raise ValueError(f"DES fields {sorted(fields)} differ from "
                         f"{sorted(_FIELD_SIZE)}")
    out = {}
    for name, size_attr in _FIELD_SIZE.items():
        a = np.asarray(fields[name])
        if a.shape != (getattr(pad, size_attr),):
            raise ValueError(f"DES field {name!r} has shape {a.shape}, pad "
                             f"{size_attr}={getattr(pad, size_attr)}")
        if name in _FLOAT_FIELDS:
            a = a.astype(np.float32)
        elif name in _INDEX_FIELDS:
            a = a.astype(np.int64)
        elif name == "indegree":
            a = a.astype(np.int32)
        else:
            a = a.astype(bool)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DESArrays(**out, num_cons=pad.cons, num_link_cons=pad.links,
                     n=pad.n)


def topology_from_numpy(x, device: torch.device | str) -> torch.Tensor:
    """Genomes (S, E) or topologies (P, P) / (S, P, P) -> a tensor on
    `device`: circuit counts as int64, fractional capacities (masks) as
    float32."""
    a = np.asarray(x)
    if a.dtype.kind in "biu":
        return torch.from_numpy(a.astype(np.int64)).to(device)
    if a.dtype.kind == "f":
        return torch.from_numpy(a.astype(np.float32)).to(device)
    raise TypeError(f"topology of dtype {a.dtype} is neither integer nor "
                    f"float")
