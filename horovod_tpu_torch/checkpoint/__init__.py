"""Sharded checkpoint engine — ZeRO state save/restore with elastic
resharding (port of horovod_tpu/checkpoint/).

The piece ``broadcast_optimizer_state`` points at when it refuses
rank-distinct ZeRO state: every rank writes its own shard, rank 0
commits the manifest last (a partial write is never restorable), and a
checkpoint written at world size N restores into a job running at world
size M by reassembling the flat buffers and re-slicing.  Storage is
plain numpy ``.npz`` + JSON in the reference's format, so a step written
by ``horovod_tpu`` restores here and the reverse; ``utils/checkpoint.py``
writes replicated state from rank 0 beside it.

The reference's JAX-only helpers (``zero_init``, ``zero_shard_params``,
``zero_state_specs``, ``is_zero_state``, ``has_zero_leaves``) have no
public counterpart: the
``ZeroShardedOptimizer`` object holds its state, and
:class:`ShardedParams` names its stage-3 parameter shards.
"""

from .manifest import (
    FORMAT_VERSION, MANIFEST_NAME, REPLICATED, SHARDED,
    LeafSpec, Manifest, shard_filename, step_dirname,
)
from .engine import (
    commit, gc_steps, is_committed, latest_step, list_steps, open_step,
    read_manifest, read_shard, restore_leaves, save_leaves, step_dir,
    write_shard, LazyStep, RestoredStep,
)
from .reshard import (
    mesh_shard_of, pad_flat, reassemble, reassemble_mesh, reshard,
    reshard_mesh, shard_of,
)
from .zero import (
    extract_zero_state, fingerprint_extra, rebuild_restored,
    restore_zero_state, save_extracted, save_zero_state, ExtractedState,
    ShardedParams,
)
from .data_state import (
    DATA_ITERS_KEY, restore_data_state, save_data_state,
)

__all__ = [
    "FORMAT_VERSION", "MANIFEST_NAME", "REPLICATED", "SHARDED",
    "LeafSpec", "Manifest", "shard_filename", "step_dirname",
    "commit", "gc_steps", "is_committed", "latest_step", "list_steps",
    "open_step", "read_manifest", "read_shard", "restore_leaves",
    "save_leaves", "step_dir", "write_shard", "LazyStep", "RestoredStep",
    "mesh_shard_of", "pad_flat", "reassemble", "reassemble_mesh",
    "reshard", "reshard_mesh", "shard_of",
    "extract_zero_state", "fingerprint_extra", "rebuild_restored",
    "restore_zero_state", "save_extracted", "save_zero_state",
    "ExtractedState", "ShardedParams",
    "DATA_ITERS_KEY", "restore_data_state", "save_data_state",
]
