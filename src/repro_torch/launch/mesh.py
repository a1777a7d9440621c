"""Mesh construction: the port of ``repro.launch.mesh`` on ``torch.distributed``.

``make_production_mesh`` and ``make_mesh`` are *functions*, as in the
reference, so that importing this module touches no device and no process
group.  They build an ``init_device_mesh`` over the default process group,
which the caller has initialised (``torch.distributed.init_process_group``
with the mesh's world size): on ``"cuda"`` unless the caller asks for
``"cpu"``.

Mesh shapes, as the reference's:

* single-pod: ``(16, 16)`` with axes ``("data", "model")``; DP over ``data``,
  TP/EP over ``model``;
* multi-pod: ``(2, 16, 16)`` with ``("pod", "data", "model")``; ``pod`` is the
  outer data-parallel axis.

:class:`AbstractMesh` is the counterpart of ``jax.sharding.AbstractMesh``: a
shape and axis names without devices, which is all the spec functions of
:mod:`repro_torch.launch.sharding` read.  They read a mesh only through
:func:`axis_size` and :func:`data_axes`, which take an ``AbstractMesh`` or a
``DeviceMesh`` (its ``mesh_dim_names`` and ``size(i)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

Mesh = Any  # an AbstractMesh or a torch DeviceMesh


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, without devices."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for {len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh: Mesh) -> tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def _size(mesh: Mesh, axis: str) -> int:
    if isinstance(mesh, AbstractMesh):
        return mesh.shape[axis]
    return mesh.size(axis_names(mesh).index(axis))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world size must be the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs a process group of {n} ranks, got {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The (possibly compound) batch-sharding axes of a mesh."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"


def axis_size(mesh: Mesh, axes: tuple[str, ...] | str) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return n
