"""init / shutdown / topology queries (port of horovod_tpu/core/basics.py).

``init()`` resolves the process topology from the launcher's environment
contract (``HOROVOD_RANK``/``SIZE``/``LOCAL_RANK``/..., reference
gloo_run.py:64-75) and brings up ``torch.distributed``: NCCL on
``cuda:local_rank`` by default, gloo when the caller asks for
``device="cpu"``.  The data-parallel group is the world, and when the
launcher places the same number of processes (more than one) on each of
more than one host, ``init()`` also makes the groups of the two-level
topology (the reference's ``("local", "cross")`` mesh axes).  A launch
whose hosts hold different numbers of processes trains over the world as
before; only the ``("local", "cross")`` axis is refused there.
``mesh()`` is the ``torch.distributed`` ``DeviceMesh`` of the reference's
``mesh()``, built on first use (reference basics.py:305-425).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import config as _cfg
from .exceptions import NotInitializedError
from .state import global_state

DeviceLike = Union[str, torch.device, None]


def _cuda_or_raise(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device unless device='cpu' is passed, "
            "and no CUDA device is available")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point computes on.  ``None`` means the device
    ``init()`` chose, else the current CUDA device; with no CUDA device it
    raises instead of carrying on quietly on the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda":
            _cuda_or_raise("horovod_tpu_torch")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if global_state.initialized:
        return global_state.device
    _cuda_or_raise("horovod_tpu_torch")
    return torch.device("cuda", torch.cuda.current_device())


def _is_grid(size: int, topo, dev: torch.device) -> bool:
    """Whether every rank's (local_rank, local_size, cross_rank,
    cross_size) puts it at cross_rank × L + local_rank of one C × L grid.
    Decided on the table gathered from every rank, so all agree: where the
    hosts hold different numbers of ranks, the ranks' local sizes differ,
    and one rank's own numbers can fit a grid the others' do not."""
    table = [list(topo)]
    if size > 1:
        mine = torch.tensor(topo, dtype=torch.int64, device=dev)
        gathered = torch.empty(size * len(topo), dtype=torch.int64,
                               device=dev)
        dist.all_gather_into_tensor(gathered, mine)
        table = gathered.view(size, len(topo)).tolist()
    L, C = table[0][1], table[0][3]
    return L * C == size and all(row == [r % L, L, r // L, C]
                                 for r, row in enumerate(table))


def init(device: DeviceLike = None, init_method: Optional[str] = None,
         mesh=None, axes: Optional[Sequence[str]] = None) -> None:
    """Initialize the runtime and the ``torch.distributed`` world.

    Args:
      device: ``None`` or ``"cuda"`` computes on ``cuda:local_rank`` over
        NCCL; ``"cpu"`` computes on the CPU over gloo.
      init_method: rendezvous URL for a world of more than one process
        (``tcp://host:port``, ``file:///path``); default ``env://``, which
        reads ``MASTER_ADDR``/``MASTER_PORT``.  A world of one needs none:
        it rendezvouses through an in-process store.
      mesh: a ``DeviceMesh`` for ``mesh()`` to return; by default
        ``mesh()`` builds one on first use.
      axes: kept as the default mesh's hint, as the reference keeps it
        (``_build_default_mesh``).
    """
    if global_state.initialized:
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        _cuda_or_raise("horovod_tpu_torch.init()")

    env_rank, env_size = _cfg.get_int(_cfg.RANK), _cfg.get_int(_cfg.SIZE)
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        if env_rank is not None and (env_rank, env_size) != (rank, size):
            raise RuntimeError(
                f"torch.distributed world (rank {rank} of {size}) disagrees "
                f"with the launcher environment (rank {env_rank} of "
                f"{env_size})")
    elif env_rank is not None and env_size is not None:
        rank, size = env_rank, env_size
    else:
        rank, size = 0, 1
    local_rank = _cfg.get_int(_cfg.LOCAL_RANK) or 0
    local_size = _cfg.get_int(_cfg.LOCAL_SIZE) or 1
    cross_rank = _cfg.get_int(_cfg.CROSS_RANK) or 0
    cross_size = _cfg.get_int(_cfg.CROSS_SIZE) or 1

    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev, backend = torch.device("cuda", local_rank), "nccl"
        torch.cuda.set_device(dev)

    owns = False
    if not dist.is_initialized():
        if size == 1 and init_method is None:
            # In-process store: no port to collide with parallel workers.
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend,
                                    init_method=init_method or "env://",
                                    rank=rank, world_size=size)
        owns = True

    two_level = _is_grid(size, (local_rank, local_size, cross_rank,
                                cross_size), dev)
    if two_level and local_size > 1 and cross_size > 1:
        # new_group is collective over the world: every rank makes every
        # group, in the same order.
        L, C = local_size, cross_size
        local_groups = [dist.new_group([c * L + i for i in range(L)])
                        for c in range(C)]
        cross_groups = [dist.new_group([c * L + i for c in range(C)])
                        for i in range(L)]
        global_state.local_group = local_groups[cross_rank]
        global_state.cross_group = cross_groups[local_rank]

    global_state.rank = rank
    global_state.size = size
    global_state.local_rank = local_rank
    global_state.local_size = local_size
    global_state.cross_rank = cross_rank
    global_state.cross_size = cross_size
    global_state.two_level = two_level
    global_state.compression = _cfg.compression()
    global_state.quant_block = _cfg.quant_block()
    for kind in ("allreduce", "allgather"):
        setattr(global_state, f"hierarchical_{kind}", _cfg.hierarchical(kind))
        setattr(global_state, f"hierarchical_{kind}_pin",
                _cfg.hierarchical_pin(kind))
    global_state.mesh = mesh
    global_state.mesh_axes_hint = None if mesh is not None or not axes \
        else tuple(axes)
    global_state.device = dev
    global_state.owns_process_group = owns
    global_state.initialized = True


def shutdown() -> None:
    """Tear down the runtime; destroys the process groups ``init()`` made
    (all of them with the world, when ``init()`` made the world)."""
    if dist.is_initialized():
        if global_state.owns_process_group:
            dist.destroy_process_group()
        else:
            for group in (global_state.local_group,
                          global_state.cross_group):
                if group is not None:
                    dist.destroy_process_group(group)
    global_state.reset()


def is_initialized() -> bool:
    return global_state.initialized


def _check_init():
    if not global_state.initialized:
        raise NotInitializedError()


def rank() -> int:
    """Global rank of this process (one process per GPU)."""
    _check_init()
    return global_state.rank


def size() -> int:
    """Number of processes (GPUs) in the world."""
    _check_init()
    return global_state.size


def local_rank() -> int:
    _check_init()
    return global_state.local_rank


def local_size() -> int:
    _check_init()
    return global_state.local_size


def cross_rank() -> int:
    """Rank among hosts (one per node) — reference common.h:119-123."""
    _check_init()
    return global_state.cross_rank


def cross_size() -> int:
    _check_init()
    return global_state.cross_size


def device() -> torch.device:
    """The device ``init()`` placed this process on."""
    _check_init()
    return global_state.device


def _build_default_mesh(axes: Optional[Sequence[str]] = None):
    """``HVD_TPU_MESH_AXES`` ("data:8,model:4") when set and no axes were
    given, else a 1-D ``"data"`` mesh over the world: the reference's
    ``_build_default_mesh``, which reads the hint only to skip the knob."""
    from ..parallel import mesh as mesh_lib
    spec = _cfg.mesh_axes()
    if axes is None and spec:
        return mesh_lib.create_mesh(mesh_lib.parse_mesh_spec(spec))
    return mesh_lib.create_mesh({mesh_lib.DATA: global_state.size})


def mesh():
    """The global ``DeviceMesh``, built on first use (its groups are made
    by every rank together, so every rank calls this the first time)."""
    _check_init()
    if global_state.mesh is None:
        global_state.mesh = _build_default_mesh(global_state.mesh_axes_hint)
    return global_state.mesh


def is_homogeneous() -> bool:
    """True when every node has the same number of processes."""
    _check_init()
    return global_state.size % max(global_state.cross_size, 1) == 0
