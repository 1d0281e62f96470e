"""Carrying the planner's state across to the port's tensors.

DELTA has no weights: its state is the DES problem (task volumes, the
dependency lists, the constraint incidence) and the topology.  Both
packages pad a problem into the same flat numpy arrays (`_problem_fields`
in `repro.core.des_jax` and `repro_torch.core.des_torch`, equal array for
array), so these functions are the one place where numpy state becomes
device tensors: the torch DES builds its arrays through them, and the
parity tests feed the JAX reference's arrays through them.  An ensemble's
members, padded to one shape, stack on a leading member axis
(`stack_problems` in both packages), and cross the same way.

The LM model zoo has weights: `lm_params_from_jax` is the one place where
the reference's parameter pytree crosses over, as the port's
`state_dict`.
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

    Every array carries a leading member axis: the M members of an
    ensemble, padded to one shape, or M = 1 for one problem; the shapes
    below are one member's, e.g. volume (M, n).  Volumes are in seconds
    at one-circuit rate (the NIC bandwidth is rescaled to 1), so every
    quantity stays O(1) in float32.
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
    """Padded numpy fields -> `DESArrays` on `device`: M members'
    stacked on a leading member axis, each field (M, size) as
    `stack_problems` gives them (one problem's fields take `[None]`).

    Floats become float32 (as the JAX reference's float32 arrays round
    them), indices int64, `indegree` int32 and `task_valid` bool.  Raises
    on a missing or extra field, or a shape that disagrees with `pad` or
    with the other fields' member count.
    """
    if set(fields) != set(_FIELD_SIZE):
        raise ValueError(f"DES fields {sorted(fields)} differ from "
                         f"{sorted(_FIELD_SIZE)}")
    shape = np.shape(fields["volume"])
    if len(shape) != 2:
        raise ValueError(f"DES fields have shape {shape}: they need a "
                         f"leading member axis")
    out = {}
    for name, size_attr in _FIELD_SIZE.items():
        a = np.asarray(fields[name])
        if a.shape != (shape[0], getattr(pad, size_attr)):
            raise ValueError(f"DES field {name!r} has shape {a.shape}, pad "
                             f"{size_attr}={getattr(pad, size_attr)}, "
                             f"members {shape[0]}")
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


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of its own (a copy); bfloat16
    (ml_dtypes) by its bits."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_jax(cfg, params) -> dict[str, torch.Tensor]:
    """The reference's `init_params` pytree (numpy arrays, or anything
    `np.asarray` takes) -> a `state_dict` of `repro_torch.models.model.LM`
    for `cfg`, on the CPU.

    `params["groups"][j]`'s leaves are stacked over the n_groups
    repetitions of pattern position j: entry g becomes layer
    `g * cfg.group_size + j`.  `params["encoder"]`'s leaves are stacked
    over the encoder layers.
    """
    out: dict[str, torch.Tensor] = {}

    def put(prefix: str, tree, index: int | None = None) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                put(f"{prefix}{name}.", leaf, index)
            else:
                a = np.asarray(leaf)
                out[prefix + name] = _tensor(a if index is None
                                             else a[index])

    put("", {k: v for k, v in params.items()
             if k not in ("groups", "encoder")})
    g = cfg.group_size
    if len(params["groups"]) != g:
        raise ValueError(f"{cfg.name}: {len(params['groups'])} pattern "
                         f"positions, group size {g}")
    for j, stacked in enumerate(params["groups"]):
        for gi in range(cfg.layers // g):
            put(f"layers.{gi * g + j}.", stacked, gi)
    for e in range(cfg.encoder_layers):
        put(f"encoder.{e}.", params["encoder"], e)
    return out
