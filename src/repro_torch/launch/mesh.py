"""Device meshes (the reference's `repro.launch.mesh`).

Functions, never module-level meshes, so that importing this module
creates no process group.  Axis names are the reference's: ("data",
"model") on one pod, ("pod", "data", "model") across two.

`make_host_mesh` builds a `DeviceMesh` over the process group that
exists (a `torchrun` launch sets the environment that
`init_process_group` reads), or over a world-size-1 group that it
creates itself from an in-memory store: NCCL on a CUDA device, gloo on
the CPU.  `make_production_mesh` builds the dry run's 16 x 16 and
2 x 16 x 16 meshes over a fake process group of `PRODUCTION_WORLD`
ranks: no collective runs, and the tensors placed on them live on the
`meta` device.

The multi-pod mesh is a `FoldedMesh`: its three logical axes run on a
two-dimensional `DeviceMesh` of (pod x data, model) ranks.  Every
sharding rule uses "pod" and "data" together, as the data axes (the
pod axis extends data parallelism across pods), so sharding a tensor
dim over the folded dim places the same shards, and its collectives
move the same bytes, as over the two axes; DTensor's sharding
propagation over a three-dimensional mesh is slower by orders of
magnitude and fails on some products.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_WORLD = 512     # ranks of the fake group: both production meshes
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


class AbstractMesh:
    """A mesh's axis names and sizes, without devices or a process group
    (the sharding rules read nothing else): `shape` maps each axis name to
    its size, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, sizes: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class FoldedMesh:
    """Logical mesh axes over a `DeviceMesh` whose dims each carry one or
    more of them, outermost first: `dims[i]` are the axes of device-mesh
    dim i.  `shape` maps each logical axis to its size, as
    `AbstractMesh.shape` does."""

    def __init__(self, device_mesh: DeviceMesh, sizes: tuple[int, ...],
                 axis_names: tuple[str, ...],
                 dims: tuple[tuple[str, ...], ...]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.dims = tuple(tuple(d) for d in dims)
        for d, n in zip(self.dims, device_mesh.shape):
            if math.prod(self.shape[a] for a in d) != n:
                raise ValueError(f"axes {d} do not fold into a mesh dim "
                                 f"of {n}")
        self.device_type = device_mesh.device_type

    def size(self) -> int:
        return self.device_mesh.size()

    def __repr__(self) -> str:
        return f"FoldedMesh({self.shape}, dims={self.dims})"


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device and none is "
                               "available; pass device='cpu'")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def make_host_mesh(model_parallel: int = 1,
                   device: torch.device | str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group,
    `model_parallel` clamped to [1, world] as the reference clamps it to
    the device count.  Without a process group it initialises one: from
    the environment `torchrun` sets, or else a world of one rank."""
    device = torch.device(device)
    backend = _backend(device)
    if not dist.is_initialized():
        if all(k in os.environ for k in _TORCHRUN_ENV):
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return init_device_mesh(device.type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def launch_mesh(model_parallel: int = 1,
                device: torch.device | str = "cuda") -> DeviceMesh | None:
    """The mesh a launcher places its state on: `make_host_mesh`'s where
    a process group exists or `torchrun`'s environment is set; None in a
    process of its own, which runs the plain path (on one device every
    placement is the identity) and creates no process group."""
    if dist.is_initialized() or all(k in os.environ for k in _TORCHRUN_ENV):
        return make_host_mesh(model_parallel, device)
    return None


def _fake_group() -> None:
    """The dry run's fake process group of PRODUCTION_WORLD ranks (this
    process is rank 0).  An existing group of another kind, or a smaller
    one, raises: a process group is process-global."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or \
                dist.get_world_size() < PRODUCTION_WORLD:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; the production "
                f"meshes need the fake group of {PRODUCTION_WORLD} ranks "
                f"(run the dry run in a process of its own)")
        return
    # FakeStore and the "fake" backend live in torch's internal testing
    # package (importing it registers the backend); they are the one way
    # to give DTensor a process group of 512 ranks in one process, and
    # nothing else of this package imports that module
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=PRODUCTION_WORLD)


def make_production_mesh(*, multi_pod: bool = False
                         ) -> DeviceMesh | FoldedMesh:
    """The 16 x 16 ("data", "model") mesh, or the 2 x 16 x 16 ("pod",
    "data", "model") one folded onto (32, 16) ranks, over the fake group
    (the single-pod mesh on its first 256 ranks).  Its device type is
    "cuda", a GPU cluster's, whose all-to-all DTensor issues as one
    (on "cpu" it falls back to an all-gather); the tensors placed on it
    live on "meta"."""
    _fake_group()
    if not multi_pod:
        return DeviceMesh("cuda", torch.arange(256).reshape(16, 16),
                          mesh_dim_names=("data", "model"))
    dm = DeviceMesh("cuda", torch.arange(512).reshape(32, 16),
                    mesh_dim_names=("pod_data", "model"))
    return FoldedMesh(dm, (2, 16, 16), ("pod", "data", "model"),
                      (("pod", "data"), ("model",)))
