"""Shard spec + manifest format for sharded checkpoints (the port's own
copy of horovod_tpu/checkpoint/manifest.py: the same format, field for
field, so either package restores what the other wrote).

A checkpoint step is a directory::

    <root>/step_0000000042/
        shard-00000-of-00004.npz     # rank 0's leaves
        ...
        shard-00003-of-00004.npz     # rank 3's leaves
        MANIFEST.json                # committed LAST, by rank 0

The manifest is the commit record: it names the world size the step was
written at, the step number, and one :class:`LeafSpec` per pytree leaf
(key path, kind, logical shape/size, dtype).  A step directory without a
parseable manifest — or whose manifest lists a shard file that does not
exist — is *torn* and must never be selected by ``latest`` resolution.

Leaf kinds:

* ``sharded`` — rank-distinct 1-D flat shards.  The logical value is the
  concatenation of the ``world_size`` shards truncated to ``true_size``
  elements (ZeRO-1 flat-moment layout: pad to a multiple of the world
  size, rank *r* owns row *r* of the ``(world, k)`` view).
* ``replicated`` — identical on every rank; stored in every shard file
  so any single rank can restore it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"

SHARDED = "sharded"
REPLICATED = "replicated"

# manifest.extra key of the run fingerprint (mesh shape + leaf-spec
# hash) stamped by save_zero_state; restore refuses a mismatched
# leaf-spec hash unless HVD_TPU_CKPT_ALLOW_FOREIGN=1.
RUN_FINGERPRINT_KEY = "run_fingerprint"


def spec_fingerprint(leaves: List["LeafSpec"]) -> str:
    """Content hash of a leaf-spec list: path, kind, dtype and logical
    size per leaf.  Deliberately world-size-invariant — an elastic N→M
    restore of the SAME run must keep the same fingerprint; a different
    model/optimizer (a different *run*) must not."""
    h = hashlib.sha256()
    for leaf in leaves:
        kind = leaf.kind
        if len(leaf.shape) == 1 and int(leaf.shape[0]) == int(leaf.true_size):
            # A full 1-D vector of true_size elements is the one layout
            # two planes describe differently: the flat ZeRO plane calls
            # it SHARDED (a padded buffer threaded over ranks), the GSPMD
            # plane REPLICATED (a dense value the partitioner shards).
            # Which label a restore TARGET gets depends on the world the
            # plan is evaluated under, so hashing the label would make
            # the fingerprint world-dependent exactly where the logical
            # content is identical.  Canonicalize it.
            kind = "vector"
        h.update(f"{leaf.path}|{kind}|{leaf.dtype}|"
                 f"{leaf.true_size}\n".encode())
    return h.hexdigest()


def step_dirname(step: int) -> str:
    return f"step_{int(step):010d}"


def parse_step_dirname(name: str) -> Optional[int]:
    if name.startswith("step_") and name[5:].isdigit():
        return int(name[5:])
    return None


def shard_filename(rank: int, world_size: int) -> str:
    return f"shard-{int(rank):05d}-of-{int(world_size):05d}.npz"


@dataclasses.dataclass
class LeafSpec:
    """Layout of one pytree leaf across the checkpoint's shard files."""

    path: str                 # key-path string, e.g. ".inner[0].mu['w']"
    kind: str                 # SHARDED | REPLICATED
    shape: List[int]          # logical (unpadded, unsharded) shape
    dtype: str                # numpy dtype string of the stored value
    true_size: int            # logical element count (before ZeRO padding)

    @property
    def key(self) -> str:
        """Array key inside the shard .npz files (order-stable)."""
        return self.path

    def padded_size(self, world_size: int) -> int:
        """Flat size after padding to a multiple of ``world_size``."""
        pad = (-self.true_size) % world_size
        return self.true_size + pad

    def shard_size(self, world_size: int) -> int:
        return self.padded_size(world_size) // world_size


@dataclasses.dataclass
class Manifest:
    """The commit record of one checkpoint step."""

    step: int
    world_size: int
    leaves: List[LeafSpec]
    format_version: int = FORMAT_VERSION
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def shard_filenames(self) -> List[str]:
        return [shard_filename(r, self.world_size)
                for r in range(self.world_size)]

    def to_json(self) -> str:
        payload = {
            "format_version": self.format_version,
            "step": self.step,
            "world_size": self.world_size,
            "leaves": [dataclasses.asdict(l) for l in self.leaves],
            "extra": self.extra,
        }
        return json.dumps(payload, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        payload = json.loads(text)
        if payload.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint manifest format_version "
                f"{payload.get('format_version')!r} (engine speaks "
                f"{FORMAT_VERSION})")
        return cls(
            step=int(payload["step"]),
            world_size=int(payload["world_size"]),
            leaves=[LeafSpec(**l) for l in payload["leaves"]],
            format_version=int(payload["format_version"]),
            extra=payload.get("extra", {}),
        )
