"""Meshes for sharded training and the dry-run (port of
``repro/launch/mesh.py``).

:class:`AbstractMesh` names mesh axes and their sizes and holds no
process group: the sharding rules (``repro_torch.sharding``) read only
that, so their specs can be computed for any mesh, the reference's
(16, 16) and (2, 16, 16) pods included.  :func:`make_host_mesh` builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one device per rank.  Importing this module touches no process
group.

The hardware constants are the NVIDIA H100 SXM's (the card the port runs
on), and the production meshes are H100 clusters: 256 GPUs, the
reference's chip count, as (32, 8) over ("data", "model") with the model
axis inside one 8-GPU NVLink domain, and two such pods as (2, 32, 8) over
("pod", "data", "model").  :func:`make_production_mesh` builds one over a
``fake`` process group (``torch.testing``'s ``FakeStore``), so that the
dry-run (``launch/dryrun.py``) traces a 256-rank program in one process as
rank 0.  The reference's TPU v5e constants (197 TFLOP/s, 819 GB/s HBM,
50 GB/s ICI, 16 GiB) and its (16, 16) pods stay in the reference;
``workloads/profiles.py`` keeps its v5e roofline constants, which define
the simulated jobs, not this card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import rank_device

#: NVIDIA H100 SXM constants used by the roofline analysis (data sheet).
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core rate per GPU [FLOP/s]
HBM_BW = 3.35e12              # per GPU [B/s]
HBM_BYTES = 80 * 1024**3      # per GPU
NVLINK_BW = 450e9             # per GPU per direction (NVLink 4, 18 links) [B/s]
NET_BW = 50e9                 # one 400 Gb/s NIC per GPU [B/s]
GPUS_PER_NODE = 8             # one NVLink domain

SINGLE_POD_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


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


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh``: :data:`SINGLE_POD_SHAPE` over ("data",
    "model") or :data:`MULTI_POD_SHAPE` over ("pod", "data", "model"), this
    process as rank 0 of a ``fake`` process group of that many ranks, which
    it initialises where no group exists.  Collectives on a fake group
    complete at once and move nothing: the mesh, of the card's device
    type, exists to be traced on (with meta shards,
    ``sharding.abstract_place``; no card is needed).
    Raises ``ValueError`` where a group of another size is initialised."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"make_production_mesh: the process group has "
                         f"{dist.get_world_size()} ranks, the {shape} mesh needs {world}")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return mesh.axis_names if isinstance(mesh, AbstractMesh) else tuple(mesh.mesh_dim_names)


def n_chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())
