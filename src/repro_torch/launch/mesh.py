"""Meshes: the shape and axis names of the devices a run spans, and the
communicator of the current process group.

The reference builds ``jax.sharding.Mesh`` objects (``repro.launch.mesh``);
the port keeps only what its rules read, the axis sizes by name
(``Mesh.shape``, as a jax mesh's ``.shape``).  The processes themselves
come from ``torch.distributed``: ``init_group`` initialises the group the
way a launcher such as ``torchrun`` describes it in the environment, and
``comm.communicator.DistComm`` runs the collectives over it.

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
           "init_group"]


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
