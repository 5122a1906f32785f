"""Elastic sharded input pipeline (port of horovod_tpu/data/).

Deterministic per-rank sharding, background prefetch with the copy to
the card on a side stream, and checkpointable iterators that resume
mid-epoch — at the same or a different world size — with no duplicated
and no dropped samples.

Quick start::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, data

    source = data.ArraySource(tokens)            # or Memmap/FileList
    loader = data.DataLoader(source, batch_size=8, seed=0, device="cuda")
    for batch in loader:
        loss = step(batch)
    opt.state_dict(ckpt_dir, step=n, extra={
        checkpoint.DATA_ITERS_KEY: {"train": loader.state_dict()}})
"""

from .loader import DataLoader
from .prefetch import InlineIterator, PrefetchIterator
from .sampler import DROP, PAD, ShardedIndexSampler
from .sources import (ArraySource, DataSource, FileListSource,
                      MemmapSource)
from ..core.exceptions import DataStallError

__all__ = [
    "DataLoader",
    "InlineIterator", "PrefetchIterator",
    "DROP", "PAD", "ShardedIndexSampler",
    "ArraySource", "DataSource", "FileListSource", "MemmapSource",
    "DataStallError",
]
