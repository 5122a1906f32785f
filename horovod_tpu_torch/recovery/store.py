"""In-memory replica store: the RAM tier committed shards live in (port
of horovod_tpu/recovery/store.py).

Every rank keeps two kinds of entries, one per ``(tree key, old rank)``:

* **own** — the bytes this rank committed (its shard of each ZeRO tree
  and the manifest describing them), so a surviving rank serves itself
  in a peer restore without the disk;
* **held** — the buddy copy: the payload of the rank whose replica this
  rank holds (``buddy.replica_held``), pushed to it at commit.

Entries carry the commit's identity (step, old world, run fingerprint,
manifest JSON) and a checksum the owner computed before the payload left
its process: a buddy copy torn in flight (``HVD_TPU_CHAOS_TORN_RANKS``)
fails verification at restore and counts as absent.

Two-phase commit: entries land **pending** and are **sealed** once the
owner's whole commit landed (disk manifest and replication); coverage
counts sealed entries only, so a rank that died inside its commit window
contributes no half-committed step.

Arrays are the host values ``checkpoint.zero.extract_zero_state`` gave
(the bytes a shard file holds; bf16 as raw 2-byte words), so a peer
restore is memory traffic.  The store holds no device tensor.  The wire
form (:func:`entry_to_bytes`, the reference's) is an 8-byte header
length, the JSON header and an npz payload.

A bf16 leaf's checksum names its dtype as numpy does, ``|V2``: the
reference's, taken on its host value (an ``ml_dtypes.bfloat16`` array),
names it ``bfloat16``, so the two differ on such a leaf though the bytes
are equal; on the raw words a reference process decodes from the wire,
its checksum is the port's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import buddy as B
from .chaos import chaos


@dataclasses.dataclass
class ReplicaEntry:
    """One rank's committed payload for one tree key."""

    key: str                  # tree key ("opt_state", "params", ...)
    rank: int                 # old-world rank whose shard this is
    step: int
    world: int                # world size at commit
    fingerprint: str          # run fingerprint (leaf-spec sha256)
    manifest_json: str        # the step's manifest (specs + extra)
    arrays: Dict[str, np.ndarray]
    checksum: str
    sealed: bool = False

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self.arrays.values())


def payload_checksum(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over each array's key, dtype, shape and bytes, in key
    order: stamped by the owner, verified before a restore uses a
    copy."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}|{a.dtype}|{a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def verify_entry(entry: ReplicaEntry) -> bool:
    return payload_checksum(entry.arrays) == entry.checksum


def entry_to_bytes(entry: ReplicaEntry) -> bytes:
    """The wire form: the header's length (8 bytes, big-endian), the JSON
    header, the npz payload."""
    head = json.dumps({
        "key": entry.key, "rank": entry.rank, "step": entry.step,
        "world": entry.world, "fingerprint": entry.fingerprint,
        "manifest_json": entry.manifest_json,
        "checksum": entry.checksum, "sealed": entry.sealed,
    }).encode()
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in entry.arrays.items()})
    return len(head).to_bytes(8, "big") + head + buf.getvalue()


def entry_from_bytes(data: bytes) -> ReplicaEntry:
    n = int.from_bytes(data[:8], "big")
    meta = json.loads(data[8:8 + n].decode())
    with np.load(io.BytesIO(data[8 + n:])) as z:
        arrays = {k: z[k] for k in z.files}
    return ReplicaEntry(arrays=arrays, **meta)


class _Slot:
    """One ``(key, rank)`` position: the last sealed entry and at most
    one pending one.  The sealed entry survives until the next one
    seals, so a crash inside the commit window keeps the last good
    step."""

    __slots__ = ("sealed", "pending")

    def __init__(self):
        self.sealed: Optional[ReplicaEntry] = None
        self.pending: Optional[ReplicaEntry] = None


class ReplicaStore:
    """Process-local replica memory: this process's own entries and the
    buddy copies pushed to it.  One process holding several ranks (a
    single-process test) holds all their entries, and
    :meth:`simulate_death` drops a rank's."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[Tuple[str, int], _Slot]] = {
            "own": {}, "held": {}}

    def _slot(self, role: str, key: str, rank: int) -> _Slot:
        table = self._tables[role]
        k = (key, int(rank))
        if k not in table:
            table[k] = _Slot()
        return table[k]

    # -- writes ------------------------------------------------------------

    def put_own(self, entry: ReplicaEntry) -> None:
        with self._lock:
            self._put(self._slot("own", entry.key, entry.rank), entry)

    def put_held(self, entry: ReplicaEntry) -> None:
        """Store a buddy copy.  The torn-replication drill corrupts the
        copy here, after the owner checksummed it, as a torn transfer
        would."""
        if chaos().torn(entry.rank) and entry.arrays:
            arrays = {k: np.array(v, copy=True)
                      for k, v in entry.arrays.items()}
            for k in sorted(arrays):
                a = arrays[k]
                if not a.size:
                    continue
                # Flip the first payload byte (any dtype or shape,
                # 0-d scalars included, tears).
                raw = np.frombuffer(a.tobytes(), np.uint8).copy()
                raw[0] ^= 0xFF
                arrays[k] = np.frombuffer(
                    raw.tobytes(), a.dtype).reshape(a.shape)
                break
            entry = dataclasses.replace(entry, arrays=arrays)
        with self._lock:
            self._put(self._slot("held", entry.key, entry.rank), entry)

    @staticmethod
    def _put(slot: _Slot, entry: ReplicaEntry) -> None:
        # An entry that arrives sealed (a fetched repair of a committed
        # step) lands in the sealed position.
        if entry.sealed:
            slot.sealed, slot.pending = entry, None
        else:
            slot.pending = entry

    def seal(self, key: str, step: int) -> None:
        """Promote the pending entries of ``(key, step)`` to sealed: the
        owner's commit landed.  Sealing also drops the slots of ranks
        outside the sealed world (the tail of a superseded larger world),
        so a stale world cannot win a later coverage vote.  In-world slots
        with nothing at this step stay: a buddy's push may still be in
        flight, and its older sealed copy is the rank's only
        redundancy."""
        step = int(step)
        with self._lock:
            world = None
            for table in self._tables.values():
                for k in list(table):
                    if k[0] != key:
                        continue
                    slot = table[k]
                    if slot.pending is not None and \
                            slot.pending.step == step:
                        slot.pending.sealed = True
                        slot.sealed, slot.pending = slot.pending, None
                        world = slot.sealed.world
            if world is None:
                return  # the seal arrived before any payload
            for table in self._tables.values():
                for k in list(table):
                    if k[0] != key or k[1] < world:
                        continue
                    slot = table[k]
                    if slot.pending is None and (
                            slot.sealed is None
                            or slot.sealed.step < step):
                        table.pop(k)

    # -- reads -------------------------------------------------------------

    def get(self, key: str, rank: int) -> Optional[ReplicaEntry]:
        """The sealed entry of ``(key, rank)``, the owner's copy first
        (no transfer tore it)."""
        with self._lock:
            for role in ("own", "held"):
                slot = self._tables[role].get((key, int(rank)))
                if slot is not None and slot.sealed is not None:
                    return slot.sealed
        return None

    def contribution(self, key: str,
                     role: Optional[str] = None) -> List[ReplicaEntry]:
        """Every sealed entry this process can serve for a peer restore of
        ``key``, own entries first, so the merge prefers the owner's copy.
        ``role`` restricts to one table."""
        roles = ("own", "held") if role is None else (role,)
        with self._lock:
            out = []
            for r in roles:
                for k in sorted(self._tables[r]):
                    if k[0] != key:
                        continue
                    slot = self._tables[r][k]
                    if slot.sealed is not None:
                        out.append(slot.sealed)
        return out

    def keys(self) -> List[str]:
        with self._lock:
            return sorted({k for t in self._tables.values() for (k, _r)
                           in t})

    def total_bytes(self) -> int:
        """Resident payload bytes, each entry once (an own and a held
        slot may hold the same entry object)."""
        with self._lock:
            seen = set()
            total = 0
            for table in self._tables.values():
                for slot in table.values():
                    for e in (slot.sealed, slot.pending):
                        if e is not None and id(e) not in seen:
                            seen.add(id(e))
                            total += e.nbytes()
            return total

    # -- lifecycle ---------------------------------------------------------

    def reset_key(self, key: str) -> None:
        with self._lock:
            for table in self._tables.values():
                for k in [k for k in table if k[0] == key]:
                    table.pop(k)

    def clear(self) -> None:
        with self._lock:
            for table in self._tables.values():
                table.clear()

    def simulate_death(self, ranks: List[int], world: int,
                       stride: int = 1) -> None:
        """Drop what rank *r*'s process held: its own entries and the
        buddy copies it kept (of ``replica_held(r)``)."""
        with self._lock:
            for r in ranks:
                for k in [k for k in self._tables["own"]
                          if k[1] == int(r)]:
                    self._tables["own"].pop(k)
                held_src = B.replica_held(int(r), world, stride)
                if held_src is not None:
                    for k in [k for k in self._tables["held"]
                              if k[1] == held_src]:
                        self._tables["held"].pop(k)


_store: Optional[ReplicaStore] = None
_store_lock = threading.Lock()


def store() -> ReplicaStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = ReplicaStore()
        return _store


def reset_store() -> None:
    global _store
    with _store_lock:
        _store = None
