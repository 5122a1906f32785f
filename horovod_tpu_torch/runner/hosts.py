"""Host/slot parsing and rank assignment (port of
horovod_tpu/runner/hosts.py).

Capability parity with the upstream runner/common/util/hosts.py
(parse_hosts:87, get_host_assignments:110-155): "-H h1:4,h2:4" or a hostfile
produce per-slot (rank, local_rank, local_size, cross_rank, cross_size)
assignments, ranks ordered host-major so consecutive ranks share a host,
which keeps ring neighbours on one host's NVLink.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """"h1:2,h2:4" → [HostInfo("h1", 2), HostInfo("h2", 4)]; a bare host
    means 1 slot."""
    out = []
    for part in hosts_string.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, slots = part.partition(":")
        out.append(HostInfo(name, int(slots) if slots else 1))
    return out


def parse_hostfile(path: str) -> List[HostInfo]:
    """One host per line: "hostname slots=N" (mpirun style) or "hostname:N"."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, rest = line.partition(" ")
                slots = int(rest.split("slots=")[1].split()[0])
                out.append(HostInfo(name.strip(), slots))
            else:
                out.extend(parse_hosts(line))
    return out


def get_host_assignments(hosts: List[HostInfo], np_: int,
                         min_np: Optional[int] = None,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign np_ ranks to hosts in order; error if capacity is short of
    min_np (defaults to np_)."""
    total_slots = sum(h.slots for h in hosts)
    need = min_np if min_np is not None else np_
    if total_slots < need:
        raise ValueError(
            f"requested {need} processes but hosts offer only "
            f"{total_slots} slots")
    np_eff = min(np_, total_slots) if max_np is None else \
        min(max_np, np_, total_slots)
    assignments: List[SlotInfo] = []
    rank = 0
    cross_size = 0
    for h in hosts:
        if rank >= np_eff:
            break
        cross_size += 1
        local = min(h.slots, np_eff - rank)
        for li in range(local):
            assignments.append(SlotInfo(
                hostname=h.hostname, rank=rank, size=np_eff,
                local_rank=li, local_size=local,
                cross_rank=cross_size - 1, cross_size=0))
            rank += 1
    for a in assignments:
        a.cross_size = cross_size
    return assignments


def slot_env(slot: SlotInfo, controller_addr: str) -> Dict[str, str]:
    """The launcher→worker env contract (reference gloo_run.py:64-75 exports
    HOROVOD_RANK/SIZE/...; we export both prefixes for drop-in use)."""
    env = {}
    pairs = {
        "RANK": slot.rank,
        "SIZE": slot.size,
        "LOCAL_RANK": slot.local_rank,
        "LOCAL_SIZE": slot.local_size,
        "CROSS_RANK": slot.cross_rank,
        "CROSS_SIZE": slot.cross_size,
    }
    for key, val in pairs.items():
        env[f"HVD_TPU_{key}"] = str(val)
        env[f"HOROVOD_{key}"] = str(val)
    env["HVD_TPU_CONTROLLER_ADDR"] = controller_addr
    env["HVD_TPU_CONTROLLER_RANK"] = str(slot.rank)
    env["HVD_TPU_CONTROLLER_SIZE"] = str(slot.size)
    env["HVD_TPU_HOSTNAME"] = slot.hostname
    env["HOROVOD_HOSTNAME"] = slot.hostname
    return env
