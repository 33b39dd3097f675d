"""Device meshes: the serving mesh the data-parallel embed lanes span, and
the ``torch.distributed`` meshes of a sharded run.

``make_serving_mesh`` is a 1-D ``("data",)`` mesh over the first
``device_count`` devices :func:`visible_devices` lists: an ordered tuple of
``torch.device``s, held in a :class:`ServingMesh`. Building it touches no
process group. ``visible_devices`` is the one seam that tests replace to
simulate devices a host does not have (the reference's tests force host
devices with ``--xla_force_host_platform_device_count``).

A ``ServingMesh`` built from an explicit tuple may name one device more
than once (``ServingMesh((cuda0, cuda0))``): rows then split into that
many shards, each run on its device in turn, which is how the split runs
on the CPU and on one card. jax's ``Mesh`` refuses duplicate devices.

``make_host_mesh`` and ``make_production_mesh`` are
``torch.distributed.device_mesh.init_device_mesh`` over the initialised
world (single pod: 16 x 16 = 256 ranks ``("data", "model")``; multi-pod:
2 x 16 x 16 = 512 ranks ``("pod", "data", "model")``). The caller starts
the process group; a world of another size than the mesh raises. The mesh
is a ``"cuda"`` one over NCCL, and over a ``"fake"`` world (the dry-run's)
where CUDA is present; else ``"cpu"``.

Nothing here falls back to the CPU when it finds no GPU.

Port of ``src/repro/launch/mesh.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist


def visible_devices(device_type: str = "cuda") -> Tuple[torch.device, ...]:
    """Every device of ``device_type`` this process can use, in index
    order: each CUDA index, or the one CPU device."""
    if device_type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if device_type == "cpu":
        return (torch.device("cpu"),)
    raise ValueError(f"unsupported device type {device_type!r}")


@dataclass(frozen=True)
class ServingMesh:
    """A 1-D ``("data",)`` mesh: ``devices[i]`` runs the i-th contiguous
    shard of a batch's rows."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a serving mesh needs at least one device")
        if self.axis_names != ("data",):
            raise ValueError(f"a serving mesh is 1-D ('data',), got "
                             f"{self.axis_names}")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        """The axis names under ``DeviceMesh``'s name for them."""
        return self.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.devices),)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def make_serving_mesh(device_count: int,
                      device_type: str = "cuda") -> ServingMesh:
    """1-D ``("data",)`` mesh over the first ``device_count`` visible
    devices of ``device_type``, clamped to at least one and at most what
    is visible. Raises when no such device is visible."""
    avail = visible_devices(device_type)
    if not avail:
        raise RuntimeError(f"no {device_type!r} device is visible; pass "
                           "device_type='cpu' explicitly to run on the CPU")
    n = max(1, min(int(device_count), len(avail)))
    return ServingMesh(tuple(avail[:n]))


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    if not dist.is_initialized():
        raise RuntimeError(f"a {names} mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world, size = dist.get_world_size(), 1
    for s in shape:
        size *= s
    if world != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} {names} mesh needs "
                         f"{size} ranks; the process group has {world}")
    backend = dist.get_backend()
    # a fake world (the dry-run's) stands for NCCL ranks where CUDA is
    # present: its DTensors then redistribute as NCCL ranks' do
    device_type = ("cuda" if backend == "nccl" or (
        backend == "fake" and torch.cuda.is_available()) else "cpu")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: 256 ranks ``("data", "model")``, or 512 ranks
    ``("pod", "data", "model")`` for two pods."""
    if multi_pod:
        return _device_mesh((2, 16, 16), ("pod", "data", "model"))
    return _device_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 2, model: int = 4):
    """A small ``("data", "model")`` mesh over the world's ranks, for
    multi-process tests."""
    return _device_mesh((data, model), ("data", "model"))


def _dim(mesh, name: str) -> int:
    return int(mesh.shape[list(mesh.mesh_dim_names).index(name)])


def dp_size(mesh) -> int:
    """Data-parallel width: ``"data"`` times ``"pod"`` where there is one."""
    n = _dim(mesh, "data")
    if "pod" in mesh.mesh_dim_names:
        n *= _dim(mesh, "pod")
    return n


def tp_size(mesh) -> int:
    return _dim(mesh, "model")
