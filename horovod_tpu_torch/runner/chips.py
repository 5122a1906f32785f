"""Per-process GPU partitioning for launched workers (port of
horovod_tpu/runner/chips.py).

The reference splits a host's TPU chips among its worker processes with
the libtpu multi-process env (``TPU_VISIBLE_DEVICES`` and the
``TPU_PROCESS_*`` bounds).  On a GPU host the split is
``CUDA_VISIBLE_DEVICES``, which CUDA reads at its first call, so the env
alone reaches the device: slot *i* of *N* sees the cards
``[i·G/N, (i+1)·G/N)`` of the host's *G*, numbered from its own
``cuda:0``.

Policy (``plan_host_platform``), the reference's three modes:
  * 1 worker on the host → it inherits the host's cards (``inherit``).
  * N workers and N divides the host's cards → a per-slot card partition
    (``partition``).  A GPU host has no ICI grid, so divisibility is the
    whole condition: the reference also needs its chip count in
    ``_HOST_TOPOLOGY`` ({1, 2, 4, 8}) and a factorisation of N over the
    chip grid.  On {1, 2, 4, 8} cards the two decide alike; on 3 or 6
    cards the port partitions where the reference pins to the CPU.
  * otherwise → workers are pinned to the CPU (``cpu``): gloo and the
    eager TCP plane still give them working collectives, and the launcher
    says which slots it pinned and why.

``--worker-platform gpu`` (the reference's ``tpu``) inherits the card
view whatever the count; ``cpu`` pins every slot.

One torch world runs one backend, NCCL on cards or gloo on the CPU, so a
launch whose plan would pin some hosts' slots to the CPU while others
compute on cards is refused (``check_one_platform``); the reference
plans per host and has no such check.

An elastic job plans each slot, not each host (``elastic_slot_env``):
its rounds change a host's slot count under survivors whose cards were
fixed at their spawn, so slot ``host:i`` takes the host's card *i*
whatever the round's size.

The plan also names the launch's torch world (``torch_world_env``):
``MASTER_ADDR``/``MASTER_PORT``, the counterpart of the reference's
``HVD_TPU_JAX_COORD_ADDR``, from a per-launch free port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

# The slot's partition, "<part>/<parts>": a worker that sees only its own
# cards computes on the first of them (core/basics.py).
PARTITION_ENV = "HVD_TPU_DEVICE_PARTITION"
# MASTER_PORT of a world whose rank 0 runs on a remote host: rank 0
# probes a port there and publishes it through the rendezvous KV
# (bootstrap.apply_torch_world).
AUTO_PORT = "auto"
POLICIES = ("auto", "cpu", "gpu")
CPU_ENV = {"HVD_TPU_WORKER_PLATFORM": "cpu", "CUDA_VISIBLE_DEVICES": ""}


def local_chip_inventory(visible: Optional[List[str]] = None
                         ) -> Tuple[int, bool]:
    """(card count, partitionable) for the local host, without touching any
    device runtime (the launcher must never initialise CUDA).  Order:
    ``HVD_TPU_CHIPS_PER_HOST``, then ``visible`` (default
    ``gpu_discovery.local_devices()``)."""
    from .gpu_discovery import cards_per_host
    n = cards_per_host(visible)
    return n, n > 0


def host_chip_inventory(hostname: str, is_local: bool) -> Tuple[int, bool]:
    """(card count, partitionable) for an arbitrary host.  Local hosts are
    probed directly; remote hosts use the env override or the discovered
    host list (``gpu_discovery``).  Unknown remote inventory returns
    (-1, False): never partition or CPU-pin a remote host based on
    launcher-local evidence alone."""
    if is_local:
        return local_chip_inventory()
    override = os.environ.get("HVD_TPU_CHIPS_PER_HOST")
    if override:
        try:
            return max(int(override), 0), True
        except ValueError:
            pass
    from . import gpu_discovery
    found = gpu_discovery.discover_gpu_hosts()
    if found:
        hosts, cph = found
        if any(h.hostname == hostname for h in hosts):
            return cph, cph > 0
    return -1, False


def host_cards(hostname: str) -> Tuple[int, Optional[List[str]]]:
    """(card count, card names) of a host: a local host lists its own
    cards (the names the launcher's ``CUDA_VISIBLE_DEVICES`` gives them,
    or None for plain indices); a remote one gives its count only, -1
    when it is unknown."""
    from .exec import _is_local
    if not _is_local(hostname):
        return host_chip_inventory(hostname, False)[0], None
    from .gpu_discovery import local_devices
    visible = local_devices()
    chips = local_chip_inventory(visible)[0]
    return chips, (visible if len(visible) == chips else None)


def partition_env(local_rank: int, local_size: int, chips: int,
                  devices: Optional[Sequence[str]] = None
                  ) -> Optional[Dict[str, str]]:
    """The per-slot env splitting ``chips`` cards among ``local_size``
    processes on one host; None when ``local_size`` does not divide them.
    ``devices`` names the host's cards (the launcher's own
    ``CUDA_VISIBLE_DEVICES`` entries on its host), indices by default."""
    if chips <= 0 or chips % local_size:
        return None
    names = list(devices) if devices is not None else \
        [str(i) for i in range(chips)]
    per_proc = chips // local_size
    first = local_rank * per_proc
    return {
        "CUDA_VISIBLE_DEVICES": ",".join(names[first:first + per_proc]),
        PARTITION_ENV: f"{local_rank}/{local_size}",
    }


def _free_port() -> int:
    """Probe a free port on the launcher.  Authoritative on localhost
    launches minus a close->bind race; for a remote host an ephemeral
    port is merely unlikely to be taken there."""
    import socket
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass
class HostPlatformPlan:
    """Resolved platform decision for one host's workers."""
    mode: str                      # "inherit" | "partition" | "cpu"
    chips: int = 0
    devices: Optional[List[str]] = None
    reason: str = ""               # why a "cpu" plan pins its slots

    def slot_env(self, local_rank: int, local_size: int) -> Dict[str, str]:
        if self.mode == "partition":
            env = partition_env(local_rank, local_size, self.chips,
                                self.devices)
            assert env is not None, (local_size, self.chips)
            return env
        return dict(CPU_ENV) if self.mode == "cpu" else {}


def plan_host_platform(local_size: int, policy: str = "auto",
                       chips: Optional[int] = None,
                       partitionable: Optional[bool] = None,
                       devices: Optional[Sequence[str]] = None
                       ) -> HostPlatformPlan:
    """Decide how ``local_size`` workers on one host share its cards.

    policy: "auto" (described in the module docstring), "cpu" (force CPU
    workers), "gpu" (force inherit — the user takes responsibility for
    contention, e.g. an externally partitioned environment)."""
    if policy not in POLICIES:
        raise ValueError(f"worker platform {policy!r}: expected one of "
                         f"{', '.join(POLICIES)}")
    if policy == "cpu":
        return HostPlatformPlan("cpu", reason="--worker-platform cpu")
    if chips is None or partitionable is None:
        chips, devices = host_cards("localhost")
        partitionable = chips > 0
    devices = list(devices) if devices is not None else None
    if policy == "gpu" or local_size <= 1:
        # A sole worker on its host cannot contend — inherit whatever
        # the host offers (chips == -1 means unknown remote).
        return HostPlatformPlan("inherit", chips, devices)
    if partitionable and chips >= local_size and \
            partition_env(0, local_size, chips) is not None:
        return HostPlatformPlan("partition", chips, devices)
    why = ("its cards are unknown" if chips < 0 else
           f"{chips} card(s) do not split among {local_size} workers")
    return HostPlatformPlan("cpu", chips, devices, reason=why)


def check_one_platform(on_cpu: Dict[str, str],
                       on_cards: Sequence[str]) -> None:
    """Refuse a world whose slots would not all run one backend:
    ``on_cpu`` maps each host whose slots are pinned to the CPU to why,
    ``on_cards`` lists the hosts whose slots compute on cards."""
    if on_cpu and on_cards:
        why = "; ".join(f"{h}: {r}" for h, r in on_cpu.items())
        raise ValueError(
            f"host(s) {sorted(on_cpu)} would pin their slots to the CPU "
            f"({why}) while host(s) {sorted(set(on_cards))} compute on "
            "cards, and one torch world runs gloo or NCCL, not both; pass "
            "--worker-platform cpu to pin every slot, or --worker-platform "
            "gpu to give every slot its host's cards")


def elastic_slot_env(local_rank: int, policy: str, chips: int,
                     devices: Optional[Sequence[str]] = None
                     ) -> Optional[Dict[str, str]]:
    """The platform env of elastic slot ``host:local_rank``, or None when
    the host has no card left for it.  Under "auto" the slot takes the
    host's card ``local_rank`` alone: a slot keeps its index for the life
    of its worker, so no two live slots share a card however the rounds
    grow and shrink (a per-round partition of 4 cards hands a newcomer
    of 4 slots the card 2 that survivor 1 of 2 holds in "2,3").  A host
    with no card pins its slots to the CPU; an unknown remote host, and
    policy "gpu", inherit (``cuda:local_rank``)."""
    if policy not in POLICIES:
        raise ValueError(f"worker platform {policy!r}: expected one of "
                         f"{', '.join(POLICIES)}")
    if policy == "cpu":
        return dict(CPU_ENV)
    if policy == "gpu" or chips < 0:
        return {}
    if chips == 0:
        return dict(CPU_ENV)
    if local_rank >= chips:
        return None
    names = list(devices) if devices is not None else \
        [str(i) for i in range(chips)]
    return {"CUDA_VISIBLE_DEVICES": names[local_rank],
            PARTITION_ENV: f"{local_rank}/{chips}"}


def torch_world_env(slots, rendezvous_addr: Optional[str] = None
                    ) -> Dict[str, str]:
    """``MASTER_ADDR``/``MASTER_PORT`` of a static launch's torch world,
    which ``init()`` forms through ``env://``.  Rank 0's host serves the
    store: on this machine at a fresh port (loopback when every slot is
    local, else the host of the NIC-probed rendezvous address); on a
    remote host at ``AUTO_PORT``, which rank 0 resolves there and
    publishes through the rendezvous KV."""
    from .exec import _is_local
    if all(_is_local(s.hostname) for s in slots):
        return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    if not rendezvous_addr:
        raise ValueError("a launch with remote hosts names its torch world "
                         "through the rendezvous KV, and this one has none")
    host0 = slots[0].hostname
    if _is_local(host0):
        return {"MASTER_ADDR": rendezvous_addr.rsplit(":", 1)[0],
                "MASTER_PORT": str(_free_port())}
    return {"MASTER_ADDR": host0, "MASTER_PORT": AUTO_PORT}


def needs_bootstrap(env: Dict[str, str]) -> bool:
    """True when the slot env declares something that must be made
    concrete in-process before the user's code runs: a torch world whose
    store port rank 0 publishes (``MASTER_PORT=auto``), which a plain
    ``env://`` rendezvous could not read.  Everything else of the plan is
    env that CUDA and ``init()`` read themselves."""
    return env.get("MASTER_PORT") == AUTO_PORT


# Interpreter options that consume a following value and so must travel
# with the interpreter, not be mistaken for the worker script.
_PY_VALUE_FLAGS = {"-W", "-X", "--check-hash-based-pycs"}


def wrap_python_command(command: List[str]) -> List[str]:
    """Rewrite ``python [interp flags] script.py ...`` to run through the
    bootstrap module so the world's env is concrete before user code.
    Interpreter flags (``-u``, ``-O``, ``-W x``, ...) stay on the
    interpreter; ``-m mod`` / ``-c cmd`` / script+args are handled by the
    bootstrap itself.  Non-python commands are returned unchanged (env-only
    best effort)."""
    if not command:
        return command
    base = os.path.basename(command[0])
    if not (base.startswith("python") or base == "pypy"):
        return command
    interp = [command[0]]
    rest = list(command[1:])
    while rest and rest[0].startswith("-") and rest[0] not in ("-m", "-c"):
        flag = rest.pop(0)
        interp.append(flag)
        if flag in _PY_VALUE_FLAGS and rest:
            interp.append(rest.pop(0))
    return interp + ["-m", "horovod_tpu_torch.runner.bootstrap", "--"] + rest
