"""Buddy topology for pairwise shard replication (port of
horovod_tpu/recovery/buddy.py).

Rank *r*'s committed shard is replicated into the memory of
``replica_holder(r) = (r + stride) % world``, its buddy.  A ring works
for every world size, odd ones included, sends and receives one shard a
rank, and gives the failure matrix a clean shape:

* a **single rank** dies → its shard survives in its buddy's memory;
* two **adjacent** ranks die (*r* and its holder, e.g. both slots of one
  preempted host when ranks are placed contiguously) → *r*'s shard is
  gone from memory and recovery falls back to the disk manifest;
* two **non-adjacent** ranks die → both shards survive in their buddies.

``stride=local_size`` puts every buddy on another host, so only a
correlated two-host loss forces the disk.  World 1 has no buddy.

Pure integer arithmetic, shared by the commit-time replicator and the
restore-time coverage check.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _shift(world: int, stride: int) -> int:
    stride = max(1, int(stride)) % world
    return stride or 1


def replica_holder(rank: int, world: int, stride: int = 1) -> Optional[int]:
    """The rank that holds ``rank``'s replica (its buddy), or None when
    the world is too small to replicate."""
    if world <= 1:
        return None
    holder = (int(rank) + _shift(world, stride)) % world
    return None if holder == int(rank) else holder


def replica_held(rank: int, world: int, stride: int = 1) -> Optional[int]:
    """The rank whose replica ``rank`` holds: the inverse of
    :func:`replica_holder`."""
    if world <= 1:
        return None
    held = (int(rank) - _shift(world, stride)) % world
    return None if held == int(rank) else held


def buddy_map(world: int, stride: int = 1) -> Dict[int, Optional[int]]:
    """{rank: replica_holder(rank)} for the whole world."""
    return {r: replica_holder(r, world, stride) for r in range(world)}


def uncovered_ranks(dead: List[int], world: int,
                    stride: int = 1) -> List[int]:
    """Old-world ranks whose shard survives in no live memory once the
    ranks in ``dead`` die: the rank and its buddy are both dead.  Empty
    = the peer path can still rebuild the whole state."""
    gone = set(int(d) for d in dead)
    out = []
    for r in sorted(gone):
        holder = replica_holder(r, world, stride)
        if holder is None or holder in gone:
            out.append(r)
    return out
