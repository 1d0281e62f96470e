"""Per-device cost of one eager step, read below DTensor (the port's
counterpart of the reference's `repro.launch.hloanalysis`, which parses
compiled, partitioned HLO).

`CostMode` is a `TorchDispatchMode` over a run of the step (on the `meta`
device in the dry run; on real tensors it counts the same).  It declines
every DTensor op, so DTensor's own dispatch handles it and the mode sees
the local ops that DTensor then runs on each device's shard, and the
collectives it issues: every count is per device.  (A counter placed
above DTensor, such as `torch.utils.flop_counter.FlopCounterMode` over
DTensors, counts the global product: a (2048 x 1024) @ (1024 x 4096)
product sharded over a 2 x 16 x 16 mesh reads 17,179,869,184 FLOPs there,
where each device does 33,554,432.)  The fake-tensor runs of DTensor's
sharding propagation are not counted.

Accounting model (the reference's fields):
  flops  -- 2 * prod(result dims) * prod(contracting dims) per matrix
            product (aten mm, addmm, bmm, baddbmm: what einsum and matmul
            dispatch to).  Elementwise flops are ignored.
  bytes  -- sum over non-view ops of (result + operand) bytes: an eager
            step reads every input and writes every output of each op
            (no fusion).
  coll   -- per-kind result bytes of every collective (all-gather /
            all-reduce / reduce-scatter / all-to-all, and send/recv as
            collective-permute), with their count.
An eager run has no loop body to multiply by a trip count: every trip of
a Python loop is dispatched, and counted, as it runs.  The mode also
tracks the bytes of the storages the step allocates that are alive at
once; `peak_bytes` is their peak (the step's temporaries and outputs,
the arguments it was given not included).
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_NO_DATA = {"_wrap_tensor_autograd", "wait_tensor", "detach", "alias",
            "lift_fresh"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: {
        k: 0.0 for k in COLLECTIVES})
    collective_count: float = 0.0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)) and all(
            isinstance(t, torch.Tensor) for t in tree):
        return list(tree)
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class CostMode(TorchDispatchMode):
    """Counts a run's per-device `cost` and `peak_bytes` (see the module's
    docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, tuple[weakref.ref, int]] = {}
        self._nested = 0     # inside a collective counted as one op

    def _track(self, outs: list[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            n = st.nbytes()

            def gone(_, key=key, n=n):
                self._live.pop(key, None)
                self.live_bytes -= n

            self._live[key] = (weakref.ref(st, gone), n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track_args(self, tree) -> None:
        """Mark the storages of the step's arguments as pre-existing, so
        that an op writing into one in place does not count it."""
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            st = t.untyped_storage()
            self._live.setdefault(id(st), (weakref.ref(st), 0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if self._nested or any(_is_fake(t) for t in ins):
            return func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        kind = _KINDS.get(name) if ns in _COLLECTIVE_NS else None
        if kind is not None:
            self._nested += 1
            try:
                out = func(*args, **kwargs)
            finally:
                self._nested -= 1
            res = sum(_nbytes(t) for t in _tensors(out))
            if name == "recv_":
                res = sum(_nbytes(t) for t in _tensors(args[0]))
            self.cost.collective_bytes[kind] += res
            self.cost.collective_count += 1
            self.cost.bytes += res
            self._track(_tensors(out))
            return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in outs):
            return out
        if ns == "aten" and name in _MATMULS:
            a = args[_MATMULS[name]]
            self.cost.flops += 2.0 * math.prod(outs[0].shape) * a.shape[-1]
        if not func.is_view and name not in _NO_DATA:
            self.cost.bytes += sum(_nbytes(t) for t in (*outs, *ins))
        if not func.is_view:
            self._track(outs)
        return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in `tree` (an `nn.Module`
    counts its parameters), one device's share."""
    total = 0
    for t in _tensors(_plain(tree)):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += _nbytes(t)
    return total


def _plain(tree):
    from torch import nn
    if isinstance(tree, nn.Module):
        return [p for p in tree.parameters()]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree
