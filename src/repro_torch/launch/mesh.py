"""Meshes: the shape and axis names of the devices a run spans, and the
communicator of the current process group.

The reference builds ``jax.sharding.Mesh`` objects (``repro.launch.mesh``);
the port keeps only what its rules read, the axis sizes by name
(``Mesh.shape``, as a jax mesh's ``.shape``).  The processes themselves
come from ``torch.distributed``: ``init_group`` initialises the group the
way a launcher such as ``torchrun`` describes it in the environment, and
``comm.communicator.DistComm`` runs the collectives over it.  A ``P x D
x M`` mesh (``pod x data x model``; ``D x M`` is ``P = 1`` without a pod
axis) lays its ranks out as the reference's mesh lays out its devices:
global rank ``r = (p·D + d)·M + m`` sits at pod index ``p``, data index
``d`` and model index ``m`` (``grid``), with a data group for each ``(p,
m)``, a model group for each ``(p, d)`` and, on a pod axis, a pod group
for each ``(d, m)`` and a batch group (``dp_axes = ("pod", "data")``) for
each ``m``.

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


def make_mesh(spec) -> Mesh:
    """``launch.train``'s ``--mesh``: ``local``, ``pod`` / ``16x16``,
    ``multipod`` / ``2x16x16``, or ``D`` / ``DxM`` (data × model); a
    ``Mesh`` is taken as it is (a small ``pod x data x model`` mesh, which
    the grammar has no spec for)."""
    if isinstance(spec, Mesh):
        return spec
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
    """This process's place ``(d, m)`` on a ``D x M`` mesh (and ``p`` on a
    ``P x D x M`` one), and the communicators of its groups, each a
    ``DistComm`` of one rank a process: ``data`` (the ``D`` ranks at its
    ``(p, m)``), ``model`` (the ``M`` ranks at its ``(p, d)``), ``pod``
    (the ``P`` ranks at its ``(d, m)``; None without a pod axis) and
    ``batch`` (the ``P·D`` ranks at its ``m``, in order ``p·D + d``: what
    ``dp_axes`` spans; the data group itself without a pod axis)."""

    d: int
    m: int
    data: object
    model: object
    p: int = 0
    pod: object = None
    batch: object = None

    def __post_init__(self):
        if self.batch is None:
            object.__setattr__(self, "batch", self.data)

    def gather_for(self, rules, model=None):
        """``sharding.make_gather`` of ``rules`` at this place: over the
        group that ``rules.fsdp_axes`` spans (the data group, or the batch
        group where they name the pod axis too; ``dp_axes``' where they
        are None), the batch group for the rows and lanes, and the pod
        group for the gradients' reduction over pods."""
        from repro_torch.runtime import sharding
        names = sharding.axis_names(rules.fsdp_axes
                                    if rules.fsdp_axes is not None
                                    else rules.dp_axes)
        comm = self.batch if "pod" in names else self.data
        return sharding.make_gather(rules, comm, model=model,
                                    batch=self.batch, pod=self.pod)


def grid(mesh: Mesh, device) -> Grid:
    """The groups of ``mesh`` (axes ``data`` and ``model``, and ``pod``)
    over the default process group, whose world must be the mesh's size:
    every process creates every group (``torch.distributed.new_group``)
    in one fixed order, as ``new_group`` asks: the data groups in ``(p,
    m)`` order, then on a pod axis the pod groups in ``(d, m)`` order,
    then the model groups in ``(p, d)`` order, then on a pod axis the
    batch groups in ``m`` order; and keeps its own.  A ``D x M`` mesh
    makes the data and model groups alone."""
    from repro_torch.comm.communicator import DistComm

    shape = mesh.shape
    pp, dd, mm = shape.get("pod", 1), shape.get("data", 1), \
        shape.get("model", 1)
    world = dist.get_world_size()
    if world != pp * dd * mm:
        dims = " x ".join(str(n) for n in mesh.axis_sizes)
        raise ValueError(f"the {dims} mesh has {pp * dd * mm} ranks; the "
                         f"process group has {world}")
    pods = "pod" in shape

    def rank(p, d, m):
        return (p * dd + d) * mm + m

    data = {(p, m): dist.new_group([rank(p, d, m) for d in range(dd)])
            for p in range(pp) for m in range(mm)}
    pod = {(d, m): dist.new_group([rank(p, d, m) for p in range(pp)])
           for d in range(dd) for m in range(mm)} if pods else {}
    model = {(p, d): dist.new_group([rank(p, d, m) for m in range(mm)])
             for p in range(pp) for d in range(dd)}
    batch = {m: dist.new_group([rank(p, d, m) for p in range(pp)
                                for d in range(dd)])
             for m in range(mm)} if pods else {}
    pd, m = divmod(dist.get_rank(), mm)
    p, d = divmod(pd, dd)

    def comm(group):
        return DistComm(1, device, group=group)

    return Grid(d, m, comm(data[p, m]), comm(model[p, d]), p,
                comm(pod[d, m]) if pods else None,
                comm(batch[m]) if pods else None)
