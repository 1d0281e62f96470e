"""Checkpoint save/restore in the reference's on-disk layout (the
reference's `repro.training.checkpoint`), so a checkpoint of either
package restores in the other.

Layout per checkpoint directory `step_{step:08d}` (written as `.tmp`,
renamed when complete):
    manifest.json    step, time, extra, and each leaf's file, dtype, shape
    <leaf-key>.npy   one array per leaf of the reference's train-state tree

Leaves are keyed by the reference's logical path: `params/embed`,
`params/groups/[j]/attn/wq` (layers j, j + group_size, ... stacked),
`params/encoder/...`, `opt/m/...`, `opt/v/...`, `opt/step`
(`convert.ref_leaves` maps the port's names).  A bfloat16 leaf is
written as the reference's `np.save` of an ml_dtypes array writes it:
2-byte words under the descr '<V2', its manifest dtype "bfloat16".
"""
from __future__ import annotations

import copy
import json
import os
import re
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch import convert


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\[\]-]", "_", key)


def _groups(state: dict) -> Iterator[tuple[str, str, dict,
                                          str | list[str]]]:
    """(prefix, the reference's path, the tensors by port name, the names
    stacked into that leaf) for the parameters and the moments: the key
    of each leaf is f"{prefix}/{path}"."""
    params = state["params"]
    named = dict(params.named_parameters())
    layout = convert.ref_leaves(params.cfg, named)
    for prefix, tensors in (("params", named), ("opt/m", state["opt"]["m"]),
                            ("opt/v", state["opt"]["v"])):
        for path, names in layout.items():
            yield prefix, path, tensors, names


def _write(path: str, t: torch.Tensor) -> str:
    """One leaf as a .npy file; returns the manifest's dtype."""
    a = convert.tensor_to_numpy(t)
    if t.dtype != torch.bfloat16:
        np.save(path, a)
        return str(a.dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        a.tofile(f)
    return "bfloat16"


def save(directory: str, step: int, state: dict,
         extra: dict | None = None) -> str:
    """Write a checkpoint of the train state {"params": LM, "opt": ...};
    returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": {}}
    leaves = ((f"{prefix}/{leaf}", convert.stack_leaf(tensors, names))
              for prefix, leaf, tensors, names in _groups(state))
    for key, t in (*leaves, ("opt/step", state["opt"]["step"])):
        fname = _sanitize(key) + ".npy"
        dtype = _write(os.path.join(tmp, fname), t)
        manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                   "shape": list(t.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):   # pragma: no cover - overwrite guard
        raise FileExistsError(path)
    os.rename(tmp, path)       # atomic publish
    return path


def latest(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore(path: str, template: dict,
            device: torch.device | str | None = None,
            shardings: dict | None = None) -> tuple[dict, int, dict]:
    """Restore into the structure of the train state `template`: returns
    (a new train state, its step, the manifest's extra).

    Each leaf is cast to the template's dtype, as the reference's restore
    casts, and placed on `device` (default: the template leaf's).
    shardings: optional tree of `sharding.NamedSharding` matching the
    state (`sharding.named(sharding.tree_specs(state, mesh, "state"),
    mesh)`); when given each leaf is placed with its sharding (elastic
    restore onto whatever mesh the shardings reference; on a mesh of one
    device, plain tensors on its device).  Raises KeyError for a leaf the
    checkpoint lacks and ValueError for a shape that differs from the
    template's.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]

    def read(key: str, like: torch.Tensor, shape: tuple) -> torch.Tensor:
        meta = leaves_meta.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(path, meta["file"]))
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        return convert.tensor_from_numpy(arr).to(device or like.device,
                                                 like.dtype)

    params = copy.deepcopy(template["params"])
    if device is not None:
        params.to(device)
    out: dict[str, dict] = {"params": {}, "opt/m": {}, "opt/v": {}}
    for prefix, leaf, tensors, names in _groups(template):
        members = [names] if isinstance(names, str) else names
        like = tensors[members[0]]
        stacked = () if isinstance(names, str) else (len(names),)
        t = read(f"{prefix}/{leaf}", like, (*stacked, *like.shape))
        for i, n in enumerate(members):
            out[prefix][n] = t[i] if stacked else t
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(out["params"][n])
    step = template["opt"]["step"]
    state = {"params": params,
             "opt": {"m": out["opt/m"], "v": out["opt/v"],
                     "step": read("opt/step", step, tuple(step.shape))}}
    if shardings is not None:
        from repro_torch.distributed import sharding
        state = sharding.place(state, shardings)
    return state, int(manifest["step"]), manifest.get("extra", {})
