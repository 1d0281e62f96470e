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

The LM model zoo has weights: `lm_params_from_jax` and `lm_params_to_jax`
carry the reference's parameter pytree across as the port's `state_dict`
and back, `train_state_from_jax` / `train_state_to_jax` a whole train
state (parameters and AdamW moments), and `ref_leaves` is the one map
from the port's parameter names to the reference's stacked leaves, which
the checkpoints' layout also keys by.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Mapping, NamedTuple

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


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of its own (a copy); bfloat16 by its
    bits, from an ml_dtypes array or from 2-byte words (dtype V2, what
    `np.load` reads back from a bfloat16 array's .npy file)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own on the host; bfloat16, which
    numpy lacks, as 2-byte words (dtype V2)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


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
                out[prefix + name] = tensor_from_numpy(
                    a if index is None else a[index])

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


def ref_leaves(cfg, names: Iterable[str]) -> dict[str, str | list[str]]:
    """The reference's leaf path ("embed", "groups/[j]/attn/wq",
    "encoder/mlp/w1") of each of the port's parameter names -> the name,
    or, for a leaf the reference stacks, the names stacked into it in
    order along its leading axis (layer g * group_size + j at entry g of
    "groups/[j]/...", encoder layer e at entry e of "encoder/...")."""
    g = cfg.group_size
    stacked: dict[str, dict[int, str]] = {}
    out: dict[str, str | list[str]] = {}
    for name in names:
        kind, _, rest = name.partition(".")
        if kind not in ("layers", "encoder"):
            out[name.replace(".", "/")] = name
            continue
        index, _, leaf = rest.partition(".")
        i = int(index)
        path = (f"groups/[{i % g}]" if kind == "layers" else "encoder") \
            + "/" + leaf.replace(".", "/")
        stacked.setdefault(path, {})[i // g if kind == "layers" else i] = name
    for path, by_index in stacked.items():
        out[path] = [by_index[k] for k in range(len(by_index))]
    return out


def stack_leaf(named: Mapping[str, torch.Tensor], names: str | list[str]
               ) -> torch.Tensor:
    """The reference's leaf from the port's tensors: `names` from
    `ref_leaves`, stacked along a new leading axis when a list."""
    if isinstance(names, str):
        return named[names]
    return torch.stack([named[n] for n in names])


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}, with "groups"' "[j]" entries as the
    reference's tuple."""
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    if "groups" in tree:
        tree["groups"] = tuple(tree["groups"][f"[{j}]"]
                               for j in range(len(tree["groups"])))
    return tree


def lm_params_to_jax(cfg, state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `lm_params_from_jax`: a `state_dict` of the port's
    `LM` (or the moments keyed likewise) -> the reference's `init_params`
    pytree of numpy arrays, the layers stacked into "groups" and
    "encoder".  bfloat16 leaves come as 2-byte words (numpy has no
    bfloat16: `.view(ml_dtypes.bfloat16)` reads them)."""
    return _nest({path: tensor_to_numpy(stack_leaf(state_dict, names))
                  for path, names in ref_leaves(cfg, state_dict).items()})


def train_state_to_jax(cfg, state: dict) -> dict:
    """The port's train state {"params": LM, "opt": {"m", "v", "step"}}
    -> the reference's (`repro.training.train_step.init_train_state`'s
    tree) as numpy arrays."""
    opt = state["opt"]
    return {"params": lm_params_to_jax(cfg, state["params"].state_dict()),
            "opt": {"m": lm_params_to_jax(cfg, opt["m"]),
                    "v": lm_params_to_jax(cfg, opt["v"]),
                    "step": tensor_to_numpy(opt["step"])}}


def train_state_from_jax(cfg, tree) -> dict:
    """The reference's train state (numpy arrays, or anything `np.asarray`
    takes) -> {"params": a `state_dict` of the port's `LM`, "opt": {"m",
    "v": keyed by the same names, "step": 0-d int32}}, on the CPU."""
    opt = tree["opt"]
    return {"params": lm_params_from_jax(cfg, tree["params"]),
            "opt": {"m": lm_params_from_jax(cfg, opt["m"]),
                    "v": lm_params_from_jax(cfg, opt["v"]),
                    "step": tensor_from_numpy(np.asarray(opt["step"]))}}
