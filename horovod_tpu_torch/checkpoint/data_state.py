"""Iterator-state persistence through the engine's manifest (port of
horovod_tpu/checkpoint/data_state.py).

A checkpointable data iterator's state is a small JSON-serializable
dict (epoch, cursor, seed, world size — rank-invariant by design, see
``horovod_tpu_torch/data/sampler.py``).  It rides checkpoints as the
``"data_iters"`` key of a manifest's ``extra`` field, ``{name:
loader.state_dict()}``:

* alongside ZeRO shards — pass ``extra={DATA_ITERS_KEY: {...}}`` to
  ``save_zero_state`` (or ``ZeroShardedOptimizer.state_dict``), so one
  committed step atomically pairs moments AND input position (a restore
  can never resume the data stream at a different step than the
  optimizer);
* standalone — when a run checkpoints iterators but no ZeRO state,
  :func:`save_data_state` writes a dedicated engine step (one
  empty world-1 shard + a manifest whose payload IS the extra field),
  inheriting the engine's whole durability protocol: tmp+rename
  atomicity, manifest-last commit, torn steps never restorable,
  retention via ``gc_steps``.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from . import engine as E
from . import manifest as M

DATA_ITERS_KEY = "data_iters"


def _check_serializable(state: Dict) -> None:
    try:
        json.dumps(state)
    except (TypeError, ValueError) as exc:
        raise ValueError(
            f"iterator state must be JSON-serializable to ride the "
            f"checkpoint manifest; got {exc}") from exc


def save_data_state(root: str, state: Dict, step: int,
                    keep: Optional[int] = None) -> M.Manifest:
    """Commit one engine step whose only payload is iterator state.

    Single-writer: call from one process (rank 0) — the state is
    rank-invariant, so one copy is the whole truth.
    """
    _check_serializable(state)
    E.write_shard(root, step, rank=0, world_size=1, arrays={})
    manifest = M.Manifest(step=step, world_size=1, leaves=[],
                          extra={DATA_ITERS_KEY: state})
    E.commit(root, step, manifest)
    if keep is not None:
        E.gc_steps(root, keep=keep)
    return manifest


def restore_data_state(root: str,
                       step: Optional[int] = None) -> Optional[Dict]:
    """The ``data_iters`` payload of a committed step (default: the
    newest), or None when no committed step carries one."""
    if step is None:
        step = E.latest_step(root)
    if step is None or not E.is_committed(root, step):
        return None
    return E.read_manifest(root, step).extra.get(DATA_ITERS_KEY)
