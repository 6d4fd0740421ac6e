"""Meshes for sharded training (port of ``repro/launch/mesh.py``).

:class:`AbstractMesh` names mesh axes and their sizes and holds no
process group: the sharding rules (``repro_torch.sharding``) read only
that, so their specs can be computed for any mesh, the reference's
(16, 16) and (2, 16, 16) pods included.  :func:`make_host_mesh` builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one device per rank.  Importing this module touches no process
group.

The reference's TPU v5e constants, its production pod shapes
(``make_production_mesh``) and ``make_mesh_compat`` serve only its
dry-run and are not carried over (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import rank_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: ``mesh.shape["model"]`` as on the
    reference's ``jax.sharding.AbstractMesh``."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ("data", "model") ``DeviceMesh`` over the default process group,
    whose world size must be ``data * model`` (``ValueError`` otherwise,
    and where no group is initialised).  Rank r's device is ``cuda:LOCAL_RANK``
    unless ``device`` asks for the CPU (:func:`repro_torch.device.rank_device`)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"make_host_mesh({data}, {model}): no process group is initialised; "
                         "start the ranks with torch.distributed.run (or call "
                         "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"make_host_mesh({data}, {model}) needs {data * model} ranks, the "
                         f"process group has {world}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return mesh.axis_names if isinstance(mesh, AbstractMesh) else tuple(mesh.mesh_dim_names)


def n_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
