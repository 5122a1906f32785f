"""init / shutdown / topology queries (port of horovod_tpu/core/basics.py).

``init()`` resolves the process topology from the launcher's environment
contract (``HOROVOD_RANK``/``SIZE``/``LOCAL_RANK``/..., reference
gloo_run.py:64-75) and brings up ``torch.distributed``: NCCL on
``cuda:local_rank`` by default (``cuda:0`` of a slot the launcher gave
its own cards, ``device_index``), gloo when the caller asks for
``device="cpu"`` or the launcher pinned the slot to the CPU
(``HVD_TPU_WORKER_PLATFORM=cpu``).  A launched world of more than one
process rendezvouses at the launcher's ``MASTER_ADDR``/``MASTER_PORT``
(the launcher runs a python command through runner/bootstrap.py, which
resolves the port that a remote rank 0 publishes).
The data-parallel group is the world, and when the launcher places the
same number of processes (more than one) on each of
more than one host, ``init()`` also makes the groups of the two-level
topology (the reference's ``("local", "cross")`` mesh axes).  A launch
whose hosts hold different numbers of processes trains over the world as
before; only the ``("local", "cross")`` axis is refused there.
``mesh()`` is the ``torch.distributed`` ``DeviceMesh`` of the reference's
``mesh()``, built on first use (reference basics.py:305-425).

With ``use_controller=True`` (or ``HVD_TPU_CONTROLLER_ADDR`` set),
``init()`` also attaches the native controller of the eager negotiated
plane and makes the process group its device executor alone runs on,
then probes the schedule dispatch table (reference basics.py:163-190).
A controller that was asked for and cannot be built, reached, or lined up
with the torch world raises.

A worker the elastic driver spawned (``HVD_TPU_ELASTIC_SLOT`` set) takes
its place from the driver's current rendezvous round instead of the
environment (reference basics.py:68-103): each ``init()`` fetches a round
newer than the one its last world belonged to, forms the round's torch
world on the store address the round names, attaches the native
controller at the round's controller address, and starts the world watch
of ``core/failure.py``.  ``shutdown()`` then returns on a world whose peer
died (the communicators of a failed world are aborted, not destroyed),
and the ``/metrics`` and debug endpoints stay up across the reset, as in the
reference.
"""

from __future__ import annotations

import os
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


def launcher_pinned_cpu() -> bool:
    """Whether the launcher pinned this slot to the CPU
    (runner/chips.py): then ``init()`` runs gloo on the CPU."""
    return os.environ.get("HVD_TPU_WORKER_PLATFORM") == "cpu"


def device_index(local_rank: int) -> int:
    """The card this worker computes on.  Under the launcher's partition
    (``HVD_TPU_DEVICE_PARTITION``) the slot sees only its own cards
    through ``CUDA_VISIBLE_DEVICES`` and takes the first of them;
    otherwise it takes ``cuda:local_rank`` of the host's cards."""
    from ..runner.chips import PARTITION_ENV
    return 0 if os.environ.get(PARTITION_ENV) else local_rank


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


def _attach_controller(rank: int, size: int, local_size: int,
                       coord_addr: Optional[str] = None) -> None:
    """Attach the native controller (at ``coord_addr``, else the
    environment's), make its executor's process group (collective over
    the world: every rank, in the same order) and run the dispatch
    bootstrap.  The controller's rendezvous and the torch world must
    agree on every rank's place."""
    from ..native import runtime as native_runtime
    from ..ops import dispatch
    group = dist.new_group(list(range(size)))
    ctl = native_runtime.attach(rank=rank, size=size, local_size=local_size,
                                coord_addr=coord_addr)
    if (ctl.rank(), ctl.size()) != (dist.get_rank(), dist.get_world_size()):
        ctl.shutdown()
        raise RuntimeError(
            f"the native controller's rendezvous put this process at rank "
            f"{ctl.rank()} of {ctl.size()}, the torch world at rank "
            f"{dist.get_rank()} of {dist.get_world_size()}; set "
            "HVD_TPU_CONTROLLER_RANK/SIZE (or RANK/SIZE) to the torch "
            "world's")
    global_state.controller = ctl
    global_state.controller_group = group
    dispatch.bootstrap(ctl, ctl.config, local_size)


def init(device: DeviceLike = None, init_method: Optional[str] = None,
         mesh=None, axes: Optional[Sequence[str]] = None,
         use_controller: Optional[bool] = None) -> None:
    """Initialize the runtime and the ``torch.distributed`` world.

    Args:
      device: ``None`` or ``"cuda"`` computes on
        ``cuda:device_index(local_rank)`` over NCCL; ``"cpu"`` computes
        on the CPU over gloo, as ``None`` does on a slot the launcher
        pinned to the CPU.  Without a card and without either, it raises.
      init_method: rendezvous URL for a world of more than one process
        (``tcp://host:port``, ``file:///path``); default ``env://``, which
        reads ``MASTER_ADDR``/``MASTER_PORT``.  A world of one needs none:
        it rendezvouses through an in-process store.
      mesh: a ``DeviceMesh`` for ``mesh()`` to return; by default
        ``mesh()`` builds one on first use.
      axes: kept as the default mesh's hint, as the reference keeps it
        (``_build_default_mesh``).
      use_controller: attach the native controller (``ops.eager``);
        ``None`` attaches it when ``HVD_TPU_CONTROLLER_ADDR`` is set.
    """
    if global_state.initialized:
        return
    from . import failure
    cpu = (torch.device(device).type == "cpu" if device is not None
           else launcher_pinned_cpu())
    if not cpu:
        _cuda_or_raise("horovod_tpu_torch.init()")

    elastic = _elastic_assignment()
    env_rank, env_size = _cfg.get_int(_cfg.RANK), _cfg.get_int(_cfg.SIZE)
    if elastic is not None:
        if dist.is_initialized():
            raise RuntimeError(
                "an elastic worker's torch.distributed world is formed by "
                "init() from each rendezvous round; do not initialize one "
                "before it")
        rank, size = elastic["rank"], elastic["size"]
    elif dist.is_initialized():
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
    if elastic is not None:
        local_rank, local_size = elastic["local_rank"], elastic["local_size"]
        cross_rank, cross_size = elastic["cross_rank"], elastic["cross_size"]
    else:
        local_rank = _cfg.get_int(_cfg.LOCAL_RANK) or 0
        local_size = _cfg.get_int(_cfg.LOCAL_SIZE) or 1
        cross_rank = _cfg.get_int(_cfg.CROSS_RANK) or 0
        cross_size = _cfg.get_int(_cfg.CROSS_SIZE) or 1

    if cpu:
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev, backend = torch.device("cuda", device_index(local_rank)), \
            "nccl"
        torch.cuda.set_device(dev)

    owns = False
    if not dist.is_initialized():
        kwargs = {}
        if elastic is not None:
            kwargs.update(failure.world_options(backend))
            if size > 1 and init_method is None:
                kwargs["store"] = _round_store(elastic, rank, size)
        if "store" in kwargs:
            dist.init_process_group(backend, rank=rank, world_size=size,
                                    **kwargs)
        elif size == 1 and init_method is None:
            # In-process store: no port to collide with parallel workers.
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kwargs)
        else:
            if init_method is None and \
                    os.environ.get("MASTER_PORT") == "auto":
                raise RuntimeError(
                    "MASTER_PORT=auto: the launcher's bootstrap resolves "
                    "a remote rank 0's store port before a python command "
                    "runs (runner/bootstrap.py); a command it does not "
                    "wrap, such as a shell script, cannot form this "
                    "world: launch the python interpreter directly")
            if init_method is None:
                _form_static_world(backend, rank, size, **kwargs)
            else:
                dist.init_process_group(backend, init_method=init_method,
                                        rank=rank, world_size=size,
                                        **kwargs)
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
    global_state.metrics_sync_steps = _cfg.metrics_sync_steps()
    global_state.metrics_tree = _cfg.metrics_tree()
    if elastic is not None:
        global_state.elastic_round = elastic["round"]
    global_state.elastic_enabled = _cfg.elastic()
    if use_controller is None:
        use_controller = bool(_cfg.get_env(_cfg.CONTROLLER_ADDR)) or \
            elastic is not None
    if use_controller:
        try:
            _attach_controller(rank, size, local_size,
                               elastic["controller_addr"] if elastic
                               else None)
        except BaseException:
            if owns:
                dist.destroy_process_group()
            global_state.reset()
            raise
    if elastic is not None:
        failure.start_watch(elastic["round"])
    else:
        failure.reset()
    _start_telemetry()
    _serve_replicas()
    global_state.initialized = True
    _start_observer()


def _start_observer() -> None:
    """Tree mode: local rank 0 hosts the per-host observer (the host's
    one serving slot, the metrics port's gate) that merges its ranks'
    snapshots and runs the O(hosts) digest exchange (reference
    core/basics.py:284-296).  A failure to start degrades to a warning,
    as every telemetry server's does: the sync then reports itself as a
    local-only digest, named."""
    if not (global_state.metrics_tree and global_state.local_rank == 0):
        return
    from ..metrics.observer import start_host_observer
    try:
        start_host_observer()
    except Exception as e:  # noqa: BLE001 — telemetry never kills
        from ..utils import logging as log
        log.warning("metrics tree: cannot start host observer (%r); "
                    "sync degrades to local-only digests", e)


# The launcher's store at MASTER_ADDR/MASTER_PORT, one a process, and
# the number of static worlds formed on it: (addr, port, serves) ->
# [TCPStore, worlds].
_static_stores: dict = {}


def _static_store(rank: int, size: int):
    """The store of a static world at the launcher's ``MASTER_ADDR`` /
    ``MASTER_PORT`` and the prefix the next world takes there:
    ``([store, worlds formed], PrefixStore)``.  One process may form
    several worlds one after the other (init, shutdown, init), and every
    world writes the same keys: had each formed its own store at the one
    port, a rank quick to re-init could read the previous world's gloo
    addresses from rank 0's store before rank 0 took it down, and wait on
    them forever.  So the store outlives its worlds (rank 0 serves it until
    the process exits, whatever the size of its later worlds) and the
    n-th world every rank forms reads and writes under ``world<n>/``:
    ranks form their worlds in the same order, so they agree on n
    (``_form_static_world`` counts a world once it formed)."""
    import datetime
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise RuntimeError(
            f"a world of {size} processes rendezvouses at MASTER_ADDR/"
            "MASTER_PORT, and they are not set: launch with hvdrun-torch "
            "or pass init_method")
    port = int(port)
    key = (addr, port, rank == 0)
    entry = _static_stores.get(key)
    if entry is None:
        store = dist.TCPStore(addr, port, size, is_master=rank == 0,
                              timeout=datetime.timedelta(minutes=30))
        entry = _static_stores[key] = [store, 0]
    return entry, dist.PrefixStore(f"world{entry[1] + 1}/", entry[0])


def _form_static_world(backend: str, rank: int, size: int, **kwargs) -> None:
    """``init_process_group`` on the launcher's store under the next
    world's prefix.  A world counts once it formed: a failed attempt's
    retry takes the prefix its peers still wait under."""
    entry, store = _static_store(rank, size)
    dist.init_process_group(backend, rank=rank, world_size=size,
                            store=store, **kwargs)
    entry[1] += 1


def _round_store(elastic: dict, rank: int, size: int):
    """The round's ``torch.distributed`` store, at the address the round
    names.  It waits for the round's members as long as a worker waits
    for its round: the world's own timeout is the operation deadline
    (``core/failure.py``), which a worker slow to start must not fail."""
    import datetime
    from ..runner.worker import ROUND_TIMEOUT_S
    host, port = elastic["store_addr"].rsplit(":", 1)
    return dist.TCPStore(host, int(port), size, is_master=rank == 0,
                         timeout=datetime.timedelta(seconds=ROUND_TIMEOUT_S))


def _elastic_assignment():
    """This worker's place in the elastic driver's newest round (one past
    the round of its last world), or None outside an elastic job."""
    if not os.environ.get("HVD_TPU_ELASTIC_SLOT"):
        return None
    from ..runner.worker import fetch_assignment
    return fetch_assignment(min_round=global_state.elastic_round + 1)


def _start_telemetry() -> None:
    """The topology gauges, the Prometheus endpoint when
    ``HVD_TPU_METRICS_PORT`` is set (on local rank 0; a bind failure
    degrades to a warning, as in the reference), and the flight
    recorder's identity and SIGUSR1 dump trigger (reference
    core/basics.py:192-240)."""
    from ..metrics.registry import registry
    reg = registry()
    reg.counter("hvd_init_total", "Runtime initializations").inc()
    reg.gauge("hvd_rank", "Chip-level rank of this process").set(
        global_state.rank)
    reg.gauge("hvd_size", "Total chips in the communicator").set(
        global_state.size)
    reg.gauge("hvd_elastic_round", "Current elastic rendezvous round "
              "(-1 outside elastic jobs)").set(global_state.elastic_round)
    port = _cfg.metrics_port()
    if port and global_state.local_rank == 0:
        from .. import metrics
        try:
            metrics.serve(port=port)
        except OSError as e:
            from ..utils import logging as log
            log.warning("metrics: cannot serve on port %d (%s); continuing "
                        "without a scrape endpoint", port, e)
    if not _cfg.flight_disable():
        from .. import debug
        debug.flight.set_identity(rank=global_state.rank,
                                  world=global_state.size)
        debug.flight.record("init", None, rank=global_state.rank,
                            size=global_state.size,
                            round=global_state.elastic_round,
                            wire=global_state.compression)
        debug.install_signal_handler()
        _serve_debug(debug)


def _serve_debug(debug) -> None:
    """The triage plumbing of a job with a rendezvous KV and a native
    controller (reference core/basics.py:240-258): the coordinator
    clock-offset estimate, the per-rank debug endpoint with its address
    published on the KV (it stays up across elastic resets), and, on the
    coordinator under ``HVD_TPU_FLIGHT_ESCALATE``, the stall → hang-report
    watchdog.  A failure degrades to a warning: telemetry never kills."""
    from ..utils import logging as log
    rdv = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if rdv:
        try:
            debug.estimate_clock_offset(rdv, samples=3)
        except Exception as e:  # noqa: BLE001 — telemetry never kills
            log.debug("flight: clock-offset estimate failed: %r", e)
    ctl = global_state.controller
    if ctl is None:
        return
    if rdv:
        try:
            debug.serve_and_publish(rank=ctl.rank(), rdv_addr=rdv,
                                    port=_cfg.flight_port())
        except OSError as e:
            log.warning("flight: cannot serve debug endpoint (%s); "
                        "continuing without one", e)
    if _cfg.flight_escalate() and ctl.rank() == 0:
        debug.start_stall_watchdog(ctl, report_dir=_cfg.flight_dir(),
                                   rdv_addr=rdv)


def _serve_replicas() -> None:
    """Multi-process jobs with a rendezvous KV publish this process's
    replica endpoint, so that buddies can push committed shards to it
    (reference basics.py:263-279).  Serving is idempotent across elastic
    rounds, and a bind failure degrades the peer tier to the disk."""
    rdv = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not (rdv and _cfg.recovery() and global_state.controller is not None):
        return
    from .. import recovery
    try:
        recovery.transport.serve_and_publish(rank=global_state.rank,
                                             rdv_addr=rdv)
    except OSError as e:
        from ..utils import logging as log
        log.warning("recovery: cannot serve replica endpoint (%s); peer "
                    "tier degraded to disk", e)


def shutdown() -> None:
    """Tear down the runtime: the world watch and the hang watchdog (before
    the controller it polls), the native controller (it waits for every
    rank to ask to leave, and gives up on a dead one; a failed world's
    gives up at once), then the process groups ``init()`` made (all of
    them with the world, when ``init()`` made the world).  A world marked
    failed had its communicators aborted when it was marked
    (``core/failure.py``), so they are destroyed without the clean
    teardown a dead peer never answers.  The ``/metrics`` and debug
    endpoints keep serving, as the reference's do across elastic resets
    (reference basics.py:328-363).  The host observer stops first of
    all: its identity (cross rank, local ranks) is the world's, so a
    re-init after an elastic renumber builds a fresh one."""
    from .. import debug
    from ..metrics.observer import stop_host_observer
    from . import failure
    stop_host_observer()
    debug.stop_stall_watchdog()
    debug.flight.record("shutdown", None)
    failure.stop_watch()
    ctl = global_state.controller
    if ctl is not None:
        from ..ops import dispatch
        global_state.controller = None
        dispatch.reset()
        ctl.shutdown()
    if dist.is_initialized():
        if global_state.owns_process_group:
            dist.destroy_process_group()
        else:
            for group in (global_state.local_group,
                          global_state.cross_group,
                          global_state.controller_group):
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


def process_rank() -> int:
    """Rank of this process: one process per GPU, so ``rank()``."""
    _check_init()
    return global_state.rank


def process_count() -> int:
    """Number of processes: ``size()``."""
    _check_init()
    return global_state.size


def mpi_threads_supported() -> bool:
    """API parity; there is no MPI in the port."""
    return False


# Build-capability queries (reference common/util.py:137-220), answered for
# the port's build: its collectives are torch.distributed's, so NCCL and
# gloo are there where torch has them; the native controller is the
# gloo-analog control plane, as in the reference.

def mpi_built(verbose: bool = False) -> bool:
    return False


def gloo_built(verbose: bool = False) -> bool:
    return dist.is_available() and dist.is_gloo_available()


def nccl_built(verbose: bool = False) -> bool:
    return dist.is_available() and dist.is_nccl_available()


def ddl_built(verbose: bool = False) -> bool:
    return False


def ccl_built(verbose: bool = False) -> bool:
    return False


def cuda_built(verbose: bool = False) -> bool:
    return torch.version.cuda is not None


def rocm_built(verbose: bool = False) -> bool:
    return getattr(torch.version, "hip", None) is not None


def start_timeline(filename: str, mark_cycles: bool = False) -> None:
    """Start the Chrome-trace timeline of the negotiated plane at run time
    (reference horovod_start_timeline, operations.cc:740-769).  Needs the
    native controller; without one it warns, as the reference does."""
    del mark_cycles  # the runtime marks cycles whenever the timeline is on
    _check_init()
    if global_state.controller is None:
        import warnings
        warnings.warn("start_timeline: no native controller attached; the "
                      "timeline records the negotiated plane only")
        return
    global_state.controller.start_timeline(filename)


def stop_timeline() -> None:
    _check_init()
    if global_state.controller is not None:
        global_state.controller.stop_timeline()
