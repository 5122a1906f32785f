"""Checkpoint save/restore helpers (port of horovod_tpu/utils/checkpoint.py).

Replicated state keeps the reference's rank-0-writes convention in its
form without Orbax: a pickle of the state as a plain nested structure of
numpy arrays at ``<path>[-<step>].pkl``, which
``horovod_tpu.utils.checkpoint.restore_checkpoint`` reads, and the
reverse.  The card has no Orbax and the port needs none; an Orbax
checkpoint directory is refused with an error that names this form.

Rank-DISTINCT state (a ``ZeroShardedOptimizer``: rank 0's slice is 1/N of
it) cannot use the rank-0-writes convention, so a state holding one is
handed to the sharded engine in ``horovod_tpu_torch.checkpoint``: every
rank writes its own shard, rank 0 commits the manifest last, and a
restore reshards across world-size changes.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import torch

from ..checkpoint import engine as E
from ..checkpoint import zero as Z


def _host_tree(tree):
    """``tree`` with every tensor as a host numpy array (bf16 as its raw
    2-byte words, ``checkpoint.zero.to_host``), dicts, lists and tuples
    kept."""
    if isinstance(tree, torch.Tensor):
        return Z.to_host(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _host_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_host_tree(v) for v in tree)
    return tree


def _into(target, value, path: str = ""):
    """Copy ``value``'s arrays into ``target``'s tensors in place (each of
    the tensor's shape); returns ``target``'s structure holding them (and
    ``value``'s other leaves)."""
    if isinstance(target, torch.Tensor):
        return Z._copy_into(target, value, path or "checkpoint")
    if isinstance(target, dict):
        return type(target)((k, _into(v, value[k], f"{path}[{k!r}]"))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)) and not hasattr(target, "_fields"):
        if len(value) != len(target):
            raise ValueError(f"checkpoint{path}: {len(value)} stored "
                             f"values for {len(target)} targets")
        return type(target)(_into(t, v, f"{path}[{i}]")
                            for i, (t, v) in enumerate(zip(target, value)))
    return value


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    rank: Optional[int] = None) -> None:
    """Write a checkpoint; for replicated state only rank 0 writes (pass
    ``rank``, or the runtime's rank is used).

    State holding a ``ZeroShardedOptimizer`` goes to the sharded engine
    (``checkpoint.save_zero_state``): every rank takes part, so do not
    gate the call on rank yourself.  With ``step=None`` each save appends
    a new engine step and keeps the newest 3; explicit steps are
    immutable and retention is the caller's."""
    if Z.has_zero_leaves(state):
        root = os.path.abspath(path)
        keep = None
        if step is None:
            latest = E.latest_step(root)
            step = 0 if latest is None else latest + 1
            keep = 3
        try:
            Z.save_zero_state(root, state, step=step, keep=keep)
        except FileExistsError as e:
            raise FileExistsError(
                f"{e}  (sharded checkpoints are append-only: restore "
                "before resuming so your step counter continues from "
                "the checkpoint, or pass step=None to auto-append)"
            ) from None
        return
    if rank is None:
        from ..core.state import global_state
        rank = global_state.rank if global_state.initialized else 0
    if rank != 0:
        return
    path = os.path.abspath(path if step is None else f"{path}-{step}")
    E._atomic_write_bytes(path + ".pkl", pickle.dumps(_host_tree(state)))


def restore_checkpoint(path: str, target: Any = None,
                       step: Optional[int] = None) -> Any:
    """Load a checkpoint written by ``save_checkpoint`` (either package's).

    With ``target`` (tensors in a like-shaped structure), the stored
    arrays are copied into its tensors in place and its structure is
    returned; without, the stored structure of numpy arrays.  A
    ``target`` holding ZeRO state routes to the sharded engine's restore
    (newest committed step when ``step`` is None), resharded for the
    current world; for engine checkpoints ``target`` is required."""
    if target is not None and Z.has_zero_leaves(target):
        return Z.restore_zero_state(os.path.abspath(path), target, step=step)
    if target is None and E.latest_step(os.path.abspath(path)) is not None:
        raise ValueError(
            f"{path} is a sharded engine checkpoint (step dirs + "
            "MANIFEST.json); pass target= a like-structured state "
            "holding the ZeroShardedOptimizer so restore knows the layout")
    path = os.path.abspath(path if step is None else f"{path}-{step}")
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint: the port reads "
            "the form without Orbax, a pickle of numpy arrays at "
            "<path>[-<step>].pkl (save_checkpoint in either package "
            "writes it where Orbax is not installed)")
    # Unpickles what save_checkpoint wrote: trust the checkpoint's source.
    with open(path + ".pkl", "rb") as f:
        value = pickle.load(f)
    return value if target is None else _into(target, value)


def latest_step(directory: str, prefix: str) -> Optional[int]:
    """Find the newest ``{prefix}-{step}`` checkpoint in a directory."""
    steps = []
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        if name.startswith(prefix + "-"):
            tail = name[len(prefix) + 1:].replace(".pkl", "")
            if tail.isdigit():
                steps.append(int(tail))
    return max(steps) if steps else None
