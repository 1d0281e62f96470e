"""Sharding rules for every architecture on the production meshes (the
reference's `repro.distributed.sharding`), turned into DTensor placements.

Meshes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
The pod axis extends data parallelism across pods (which is exactly the
inter-pod DP traffic DELTA plans for).

Assignment is divisibility-driven: each rule lists candidate tensor dims in
priority order and takes the first one divisible by the axis-group size, so
the same rules cover kv_heads=8 on a 16-way model axis (falls through to
head_dim), 32 experts on 16 (expert-parallel), 8 experts on 16 (expert
tensor-parallel on d_ff), batch=1 on long_500k (falls through to the KV
sequence dim), etc.  FSDP (ZeRO-3-style data-axis parameter sharding) is
enabled automatically for models above `FSDP_THRESHOLD` parameters.

A spec (`P`) is a tuple with one entry per tensor dim: None, an axis name,
or a tuple of axis names (that dim sharded over those mesh axes, the first
outermost), as the reference's `PartitionSpec`.  The port holds one
`Layer` per layer where the reference stacks each pattern position's
leaves over the layer groups, so the reference's leading stack dim (its
`off`/`skip_dims=(0,)` shift) does not occur here, for parameters and
cache alike.  A spec reads only a mesh's axis names and sizes: a
`DeviceMesh` or a `launch.mesh.AbstractMesh`.

`named` pairs specs with a mesh; `place` puts a tree of tensors (or an
`LM`'s parameters) where they say: a DTensor per leaf, except on a mesh
of one device, where every placement is the identity and the tensors
stay plain (no DTensor dispatch on the host for a one-card step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig

FSDP_THRESHOLD = 30e9

MODEL_AXES = ("model",)


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name or a
    tuple of names); a tree leaf wherever specs sit in a tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, a FoldedMesh or an
    AbstractMesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def device_mesh(mesh):
    """The DeviceMesh under `mesh` (itself, or a FoldedMesh's)."""
    return getattr(mesh, "device_mesh", mesh)


def mesh_dims(mesh) -> tuple[tuple[str, ...], ...]:
    """The logical axes of each dim of `device_mesh(mesh)`."""
    if hasattr(mesh, "dims"):
        return mesh.dims
    return tuple((a,) for a in axis_sizes(mesh))


def data_axes(mesh) -> tuple[str, ...]:
    names = tuple(axis_sizes(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def _group_size(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def assign(shape: tuple[int, ...], mesh,
           rules: list[tuple[tuple[str, ...], list[int]]],
           skip_dims: tuple[int, ...] = ()) -> P:
    """First-divisible-dim assignment of axis groups to tensor dims."""
    spec: list = [None] * len(shape)
    for axes, dims in rules:
        need = _group_size(mesh, axes)
        if need <= 1:
            continue
        for d in dims:
            if d >= len(shape) or d in skip_dims:
                continue
            if spec[d] is None and shape[d] % need == 0 and shape[d] >= need:
                spec[d] = axes if len(axes) > 1 else axes[0]
                break
    return P(*spec)


def param_spec(pathstr: str, shape: tuple[int, ...], mesh,
               fsdp: bool) -> P:
    """The spec of the parameter (or moment) at `pathstr` ("embed",
    "layers/3/attn/wq", "opt/m/layers/0/moe/wi", ...)."""
    d_ax = data_axes(mesh)
    m = MODEL_AXES

    def R(*rules) -> P:
        return assign(shape, mesh, list(rules))

    leaf = pathstr.rsplit("/", 1)[-1]
    if len(shape) < 1 or leaf in ("step",):
        return P()
    if leaf in ("ln1", "ln2", "lnx", "final_ln", "norm_w", "conv_b",
                "A_log", "dt_bias", "qn", "kn"):
        return P()
    if leaf == "embed":
        return R((m, [0, 1]))
    if leaf == "head":
        return R((m, [1, 0]))
    if leaf == "router":
        return R((m, [1]))
    if leaf == "wq":                               # (D, H, hd)
        rules = [(m, [1, 2, 0])]
        if fsdp:
            rules.append((d_ax, [0]))
        return R(*rules)
    if leaf in ("wk", "wv"):                       # (D, KV, hd)
        # shard KV heads when divisible, otherwise REPLICATE: head_dim
        # sharding turns every attention einsum into an all-reduce of the
        # (Sq x Sk) scores (GQA KV tensors are small; expanded at use)
        rules = [(m, [1])]
        if fsdp:
            rules.append((d_ax, [0]))
        return R(*rules)
    if leaf in ("bq", "bk", "bv"):                 # (H, hd)
        return R((m, [0, 1]))
    if leaf == "wo" and "attn" in pathstr:         # (H, hd, D)
        rules = [(m, [0, 1])]
        if fsdp:
            rules.append((d_ax, [2]))
        return R(*rules)
    if leaf in ("wi", "wg") and "moe" in pathstr:  # (E, D, F)
        rules = [(m, [0, 2, 1])]
        if fsdp:
            rules.append((d_ax, [1]))
        return R(*rules)
    if leaf == "wo" and "moe" in pathstr:          # (E, F, D)
        rules = [(m, [0, 1])]
        if fsdp:
            rules.append((d_ax, [2]))
        return R(*rules)
    if leaf in ("wi", "wg"):                       # (D, F)
        rules = [(m, [1])]
        if fsdp:
            rules.append((d_ax, [0]))
        return R(*rules)
    if leaf == "wo":                               # (F, D)
        rules = [(m, [0])]
        if fsdp:
            rules.append((d_ax, [1]))
        return R(*rules)
    if leaf == "in_proj":                          # (D, Z)
        rules = [(m, [1])]
        if fsdp:
            rules.append((d_ax, [0]))
        return R(*rules)
    if leaf == "out_proj":                         # (d_in, D)
        rules = [(m, [0])]
        if fsdp:
            rules.append((d_ax, [1]))
        return R(*rules)
    if leaf == "conv_w":                           # (K, C)
        return R((m, [1]))
    # fallback: model-shard the last divisible dim
    return R((m, list(range(len(shape) - 1, -1, -1))))


def cache_spec(pathstr: str, shape: tuple[int, ...], mesh) -> P:
    d_ax = data_axes(mesh)
    m = MODEL_AXES
    leaf = pathstr.rsplit("/", 1)[-1]
    if leaf in ("pos",) or len(shape) == 0:
        return P()
    if leaf in ("k", "v"):       # (B, S, KV, hd)
        return assign(shape, mesh, [(d_ax, [0, 1]), (m, [2, 3])])
    if leaf == "conv":           # (B, W, C)
        return assign(shape, mesh, [(d_ax, [0]), (m, [2])])
    if leaf == "ssm":            # (B, nh, hd, n)
        return assign(shape, mesh, [(d_ax, [0]), (m, [1, 2])])
    if leaf == "enc":            # (B, T, D)
        return assign(shape, mesh, [(d_ax, [0])])
    return P()


def batch_spec(shape: tuple[int, ...], mesh) -> P:
    return assign(shape, mesh, [(data_axes(mesh), [0])])


def map_tree(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """fn(path, leaf) over a tree of dicts, lists and tuples whose leaves
    are tensors (anything with a `.shape`), specs or ints; an `nn.Module`
    stands for the dict of its parameters by name.  A parameter name's
    "." reads as "/" in the path (the moments are keyed by those
    names)."""
    def sub(key) -> str:
        key = str(key).replace(".", "/")
        return f"{path}/{key}" if path else key

    if isinstance(tree, nn.Module):
        return {n: fn(sub(n), p) for n, p in tree.named_parameters()}
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_specs(tree: Any, mesh, kind: str,
               cfg: ModelConfig | None = None,
               fsdp: bool | None = None) -> Any:
    """kind: params | state | cache | batch.  The tree of specs has the
    structure of `tree`, an `LM` read as {name: spec} (a train state's
    moments are keyed by the same names)."""
    if fsdp is None:
        fsdp = bool(cfg and cfg.total_params() > FSDP_THRESHOLD)

    def one(path: str, leaf) -> P:
        shape = tuple(getattr(leaf, "shape", ()))
        if kind in ("params", "state"):
            return param_spec(path, shape, mesh, fsdp)
        if kind == "cache":
            return cache_spec(path, shape, mesh)
        return batch_spec(shape, mesh)

    return map_tree(one, tree)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec` on `device_mesh(mesh)`: Shard(d) on
    each mesh dim whose axes shard tensor dim d, Replicate() on the
    others."""
    out = []
    for axes in mesh_dims(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if set(axes) <= set(e if isinstance(e, tuple)
                                        else (e,))), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's `jax.sharding.NamedSharding`)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the mesh: a DTensor of these placements, or, on a mesh of
        one device, `t` itself on the mesh's device type.  A tensor on
        `meta` stays there (the dry run places no data)."""
        dm = device_mesh(self.mesh)
        if isinstance(t, DTensor):
            return t.redistribute(dm, self.placements)
        if dm.size() == 1:
            return t if t.is_meta else t.to(dm.device_type)
        if t.is_meta:
            local = list(t.shape)
            for p, n in zip(self.placements, dm.shape):
                if isinstance(p, Shard):
                    local[p.dim] //= n
            return DTensor.from_local(
                torch.empty(local, dtype=t.dtype, device="meta"), dm,
                self.placements, run_check=False, shape=t.shape,
                stride=t.stride())
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.to(dm.device_type), dm, self.placements)


def named(specs: Any, mesh) -> Any:
    return map_tree(lambda _, s: NamedSharding(mesh, s), specs)


def place(tree: Any, shardings: Any) -> Any:
    """`tree` with each tensor placed by its sharding (the reference's
    `jax.device_put(tree, shardings)`).  An `LM`'s parameters are
    replaced in the module itself, which is returned; ints (a cache's
    position) pass through."""
    if isinstance(tree, nn.Module):
        for name, sh in shardings.items():
            mod, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(mod) if mod else tree
            p = owner._parameters[leaf]
            d = p.detach()
            t = sh.place(d)
            if t is not d:
                owner._parameters[leaf] = nn.Parameter(
                    t, requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return shardings.place(tree)
    return tree
