"""Meshes: the shape and axis names of the devices a run spans, and the
communicator of the current process group.

The reference builds ``jax.sharding.Mesh`` objects (``repro.launch.mesh``);
the port keeps only what its rules read, the axis sizes by name
(``Mesh.shape``, as a jax mesh's ``.shape``).  The processes themselves
come from ``torch.distributed``: ``init_group`` initialises the group the
way a launcher such as ``torchrun`` describes it in the environment, and
``comm.communicator.DistComm`` runs the collectives over it.  A ``D x M``
mesh lays its ranks out as the reference's mesh lays out its devices:
global rank ``r = d·M + m`` sits at data index ``d`` and model index
``m`` (``grid``), with one data group for each ``m`` and one model group
for each ``d``.

    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        -m repro_torch.launch.train --mesh 2 --device cpu ...
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh", "make_mesh",
           "init_group", "Grid", "grid"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes ``axis_sizes`` under the names ``axis_names``."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} does not match "
                             f"its axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}``, in axis order."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(shape=None, axes=None) -> Mesh:
    """A mesh over the processes of the current group (one without a
    group), as the reference's over the devices it sees."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n,) if n == 1 else (2, n // 2)
    if axes is None:
        axes = ("data",) if len(shape) == 1 else ("data", "model")
    return Mesh(tuple(shape), tuple(axes))


def make_mesh(spec: str) -> Mesh:
    """``launch.train``'s ``--mesh``: ``local``, ``pod`` / ``16x16``,
    ``multipod`` / ``2x16x16``, or ``D`` / ``DxM`` (data × model)."""
    if spec == "local":
        return make_local_mesh()
    if spec in ("16x16", "pod"):
        return make_production_mesh()
    if spec in ("2x16x16", "multipod"):
        return make_production_mesh(multi_pod=True)
    try:
        dims = tuple(int(d) for d in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: give 'local', 'pod', "
                         "'multipod', 'D' or 'DxM'") from None
    return Mesh(dims, ("data", "model")[: len(dims)])


def init_group(device) -> None:
    """Initialise the default process group from the environment that a
    launcher sets (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), with the backend that serves ``device``: gloo for
    the CPU, NCCL for the card (each process on card ``LOCAL_RANK``).  A
    group that is already initialised is kept."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place ``(d, m)`` on a ``D x M`` mesh, and the
    communicators of its data group (the ``D`` ranks of model index ``m``)
    and its model group (the ``M`` ranks of data index ``d``), each a
    ``DistComm`` of one rank a process."""

    d: int
    m: int
    data: object
    model: object


def grid(mesh: Mesh, device) -> Grid:
    """The groups of ``mesh`` (axes ``data`` and ``model``) over the
    default process group, whose world must be the mesh's size: every
    process creates every group (``torch.distributed.new_group``), the
    data groups in ``m`` order and then the model groups in ``d`` order,
    as ``new_group`` asks, and keeps its own two."""
    from repro_torch.comm.communicator import DistComm

    dd, mm = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    world = dist.get_world_size()
    if world != dd * mm:
        raise ValueError(f"the {dd} x {mm} mesh has {dd * mm} ranks; the "
                         f"process group has {world}")
    data = [dist.new_group([d * mm + m for d in range(dd)])
            for m in range(mm)]
    model = [dist.new_group([d * mm + m for m in range(mm)])
             for d in range(dd)]
    d, m = divmod(dist.get_rank(), mm)
    return Grid(d, m, DistComm(1, device, group=data[m]),
                DistComm(1, device, group=model[d]))
