"""Device-mesh construction and topology helpers (port of
horovod_tpu/parallel/mesh.py).

The reference's mesh is a ``jax.sharding.Mesh`` of devices; the port's is
a ``torch.distributed`` ``DeviceMesh`` of ranks, one process a GPU (or a
CPU process under gloo).  Each named dimension of it has a process group
(``mesh.get_group(name)``), over which the port's collectives, the GSPMD
plane (``ops.gspmd``) and sequence-parallel attention run.  The mesh is
laid out row-major over the ranks, earlier axes changing slowest, as the
reference's ``reshape`` fallback lays out its devices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

# Canonical axis names used across the framework.
DATA = "data"       # data parallel (allreduce axis)
FSDP = "fsdp"       # sharded data parallel (zero-style weight sharding)
TENSOR = "model"    # tensor/model parallel (megatron-style)
SEQUENCE = "seq"    # sequence/context parallel (ring attention / ulysses)
PIPELINE = "pipe"   # pipeline parallel
EXPERT = "expert"   # expert parallel (MoE alltoall)


def _device_type() -> str:
    """The runtime's device type: ``cuda`` under NCCL, ``cpu`` under
    gloo."""
    from ..core.basics import _check_init
    from ..core.state import global_state
    _check_init()
    return global_state.device.type


def create_mesh(shape: Dict[str, int], devices: Optional[Sequence[int]] = None,
                allow_split_physical_axes: bool = True):
    """A ``DeviceMesh`` from {axis_name: size} over the first ranks of
    ``devices`` (global ranks; default the world, in rank order).

    Every rank of the world calls it (the mesh's groups are made
    together).  ``allow_split_physical_axes`` is accepted for the
    reference's signature; ranks have no physical axes to split.
    """
    del allow_split_physical_axes
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(shape.keys())
    dims = tuple(int(v) for v in shape.values())
    device_type = _device_type()
    pool = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    total = 1
    for d in dims:
        total *= d
    if total > len(pool):
        raise ValueError(f"mesh shape {shape} has {total} slots but there are "
                         f"only {len(pool)} devices")
    ranks = torch.tensor(pool[:total], dtype=torch.int64).reshape(dims)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def data_parallel_mesh():
    """1-D mesh over the world, axis "data" — the Horovod-equivalent
    communicator."""
    import torch.distributed as dist
    _device_type()
    return create_mesh({DATA: dist.get_world_size()})


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse "data:8,model:4" → {"data": 8, "model": 4}."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        name, _, dim = part.partition(":")
        out[name.strip()] = int(dim)
    return out


def local_mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[name]
