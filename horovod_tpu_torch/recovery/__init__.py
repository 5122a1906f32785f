"""Peer-to-peer hot recovery: the in-memory tier between a failure and
the disk manifest (port of horovod_tpu/recovery/).

With every rank's ZeRO shard already partitioned across the fleet, the
surviving ranks together hold what a replacement needs; this package
keeps it that way:

* :mod:`buddy` — the pairwise ring: rank *r*'s committed shard is
  replicated into ``replica_holder(r)``'s memory, stride-shifted so
  buddies land on other hosts;
* :mod:`store` — the per-process replica memory (sealed/pending
  two-phase entries, checksummed payloads);
* :mod:`peer` — commit-time replication and the restore-time peer
  reassembly tried before the disk;
* :mod:`transport` — the rendezvous-published HTTP replica endpoints the
  buddy pushes ride between processes;
* :mod:`chaos` — seeded fault injection (kills, commit-window crashes,
  slow peers, torn replication), so the recovery paths are drilled.

Every restore records a :class:`RecoveryReport` (path peer/disk/none,
bytes, latency) in the metrics and the flight recorder.
"""

from .buddy import buddy_map, replica_held, replica_holder, uncovered_ranks
from .chaos import Chaos, ChaosCrash, ChaosKill, chaos, reset_chaos
from .peer import (
    PeerRestoreUnavailable, RecoveryReport, last_report, peer_restore,
    record_report, replicate, seal_commit,
)
from .store import (
    ReplicaEntry, ReplicaStore, entry_from_bytes, entry_to_bytes,
    payload_checksum, reset_store, store, verify_entry,
)
from . import transport

__all__ = [
    "buddy_map", "replica_held", "replica_holder", "uncovered_ranks",
    "Chaos", "ChaosCrash", "ChaosKill", "chaos", "reset_chaos",
    "PeerRestoreUnavailable", "RecoveryReport", "last_report",
    "peer_restore", "record_report", "replicate", "seal_commit",
    "ReplicaEntry", "ReplicaStore", "entry_from_bytes", "entry_to_bytes",
    "payload_checksum", "reset_store", "store", "verify_entry",
    "transport",
]
