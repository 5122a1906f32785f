"""`DataLoader` — sharded, prefetched, checkpointable batch feed (port of
horovod_tpu/data/loader.py, with ``device=`` in place of ``sharding=``).

One object ties the pipeline together:

* a :class:`~horovod_tpu_torch.data.sampler.ShardedIndexSampler` decides
  which sample indices this rank feeds (deterministic per-rank sharding,
  seed-keyed per-epoch shuffle, drop/pad tail policy) — the reference's
  index streams, element for element;
* a :class:`~horovod_tpu_torch.data.sources.DataSource` gathers those
  indices into host batches;
* a :class:`~horovod_tpu_torch.data.prefetch.PrefetchIterator` (or its
  inline twin when prefetch is off) overlaps the gather and the copy to
  the device with the training step.

Topology: one process per rank, so each process gets its own rank's
shard of every global batch (``hvd.rank()`` of ``hvd.size()``).

The copy to a CUDA device (``device="cuda"``): the producer copies each
host batch into pinned host memory and from there to the card with
``non_blocking=True`` on a side stream, and records an event; the
consumer makes its current stream wait on that event and calls
``record_stream`` before it hands the batch out.  The pinned buffers
form a ring of ``queue depth + 1`` slots, and a slot is written again
only after the event of its last copy has completed, so a gather never
overwrites a batch whose copy is still in flight.

Checkpointing: ``state_dict()`` / ``load_state_dict()`` capture the
(epoch, cursor, seed, world size) tuple at the **consumer** position —
batches the prefetch producer ran ahead on are not counted — so a
mid-epoch restore resumes with no duplicated and no dropped samples, at
the same or a different world size.  Pass it as the ``extra`` of a ZeRO
checkpoint (``{checkpoint.DATA_ITERS_KEY: {name: loader.state_dict()}}``)
so one committed step pairs the optimizer state with the input position.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import config as _cfg
from .prefetch import InlineIterator, PrefetchIterator
from .sampler import PAD, ShardedIndexSampler
from .sources import ArraySource, DataSource


def _resolve_topology() -> tuple:
    """(world_size, rank) from the runtime; (1, 0) when uninitialized
    (plain library use)."""
    from ..core.state import global_state
    if not global_state.initialized:
        return 1, 0
    return max(int(global_state.size), 1), int(global_state.rank)


def _components(batch) -> List[np.ndarray]:
    return list(batch) if isinstance(batch, tuple) else [batch]


def _pack(batch, tensors):
    return tuple(tensors) if isinstance(batch, tuple) else tensors[0]


class _DeviceFeed:
    """Host batch → tensors on ``device``.  On the CPU the arrays become
    tensors; on a CUDA device through a ring of ``slots`` pinned buffers
    and a side stream (module docstring).  ``transfer`` runs in the
    producer, ``finish`` in the consumer."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._next = 0
        self._ring: List[Optional[dict]] = [None] * slots
        self._stream = None

    def transfer(self, batch):
        tensors = [torch.from_numpy(np.ascontiguousarray(a))
                   for a in _components(batch)]
        if not self.cuda:
            return _pack(batch, tensors)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            slot = self._ring[self._next]
            if slot is not None:
                slot["event"].synchronize()   # its last copy has landed
            if slot is None or [(b.shape, b.dtype) for b in slot["pinned"]] \
                    != [(t.shape, t.dtype) for t in tensors]:
                slot = {"pinned": [torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=True)
                                   for t in tensors],
                        "event": torch.cuda.Event()}
                self._ring[self._next] = slot
            self._next = (self._next + 1) % len(self._ring)
            for buf, t in zip(slot["pinned"], tensors):
                buf.copy_(t)
            with torch.cuda.stream(self._stream):
                out = [buf.to(self.device, non_blocking=True)
                       for buf in slot["pinned"]]
                slot["event"].record(self._stream)
        return _pack(batch, out), slot["event"]

    def finish(self, item):
        if not self.cuda:
            return item
        batch, event = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in _components(batch):
            t.record_stream(stream)   # allocated on the side stream
        return batch


class DataLoader:
    """Iterate per-epoch over sharded batches of ``source``.

    Args:
      source: a :class:`DataSource` (bare arrays/tuples are wrapped in
        :class:`ArraySource` for convenience).
      batch_size: per-rank batch size.
      shuffle / seed / policy / epoch: sampler knobs (see sampler.py).
      world_size / rank: explicit topology override; by default the
        runtime's (re-resolved after an elastic reset via
        ``load_state_dict``).
      prefetch: background prefetch on/off; default from
        ``HVD_TPU_DATA_PREFETCH`` (on).
      queue_depth: prefetch queue depth; default
        ``HVD_TPU_DATA_QUEUE_DEPTH`` (2 = double buffering).
      device: where batches are delivered, as torch tensors: a CUDA
        device (through the pinned ring and a side stream) or ``"cpu"``.
        ``None`` means the runtime's card (``init()``'s device, else the
        current CUDA device) and raises when there is none.
      transfer: applied to each host batch in the producer, in place of
        ``device``'s copy (``transfer=lambda b: b`` yields the host
        numpy batches).
      stall_timeout_s: hard ceiling on waiting for one batch; default
        ``HVD_TPU_DATA_STALL_TIMEOUT_SECONDS`` (0 = warn only).
    """

    def __init__(self, source, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, policy: str = PAD,
                 epoch: int = 0,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 prefetch: Optional[bool] = None,
                 queue_depth: Optional[int] = None,
                 device=None,
                 transfer: Optional[Callable[[Any], Any]] = None,
                 stall_timeout_s: Optional[float] = None,
                 name: str = "data"):
        if not isinstance(source, DataSource):
            if isinstance(source, (tuple, list)):
                source = ArraySource(*source)
            else:
                source = ArraySource(source)
        self.source = source
        self._name = name
        self._prefetch = _cfg.data_prefetch() if prefetch is None \
            else bool(prefetch)
        self._depth = _cfg.data_queue_depth() if queue_depth is None \
            else int(queue_depth)
        self._stall_timeout_s = _cfg.data_stall_timeout_seconds() \
            if stall_timeout_s is None else float(stall_timeout_s)
        self._stall_warning_s = _cfg.stall_warning_seconds()
        if device is not None and transfer is not None:
            raise ValueError("pass either transfer= or device=, not both")
        self._feed = None
        if transfer is None:
            from ..core.basics import resolve_device
            self._feed = _DeviceFeed(resolve_device(device),
                                     slots=self._depth + 1)
            transfer = self._feed.transfer
        self._transfer = transfer

        self._explicit_topology = world_size is not None
        if self._explicit_topology:
            world = int(world_size)
            rank = 0 if rank is None else int(rank)
            if not 0 <= rank < world:
                # An out-of-range rank would slice past the global batch
                # and numpy would silently clamp to undersized batches.
                raise ValueError(
                    f"rank {rank} out of range for world size {world}")
        else:
            if rank is not None:
                raise ValueError("rank needs an explicit world_size")
            world, rank = _resolve_topology()
        self.sampler = ShardedIndexSampler(
            len(source), batch_size, world_size=world, rank=rank,
            shuffle=shuffle, seed=seed, policy=policy, epoch=epoch)

        self._active = None        # live epoch iterator, if any
        self._iter_start_state: Dict[str, Any] = self.sampler.state_dict()

    # -- iteration ---------------------------------------------------------
    def _epoch_gen(self):
        while True:
            idx = self.sampler.next_batch()
            if idx is None:
                break
            yield self.source.gather(idx)
        # Natural exhaustion (not close()): the next epoch begins here,
        # so the post-epoch state snapshot already points at it.
        self.sampler.advance_epoch()

    def __iter__(self):
        """One epoch (resuming mid-epoch when state says so).  Building
        a new iterator closes the previous one — a single producer
        owns the sampler at any time."""
        self.close()
        self._iter_start_state = self.sampler.state_dict()
        gen = self._epoch_gen()
        finish = None if self._feed is None else self._feed.finish
        if self._prefetch:
            self._active = PrefetchIterator(
                gen, depth=self._depth, transfer=self._transfer,
                state_fn=self.sampler.state_dict, finish=finish,
                stall_warning_s=self._stall_warning_s,
                stall_timeout_s=self._stall_timeout_s,
                name=self._name)
        else:
            self._active = InlineIterator(
                gen, transfer=self._transfer,
                state_fn=self.sampler.state_dict, finish=finish)
        return self._active

    def __len__(self) -> int:
        """Batches left in the current epoch (consumer view when no
        iterator is live; the producer may have run ahead otherwise)."""
        return self.sampler.batches_remaining()

    def close(self) -> None:
        """Shut down any live prefetch producer (idempotent).  The
        sampler rewinds to the consumer position: batches the producer
        drew but never delivered are NOT skipped — they come back on
        the next iteration."""
        if self._active is not None:
            state = self._active.consumer_state()
            self._active.close()
            self._active = None
            if state is None:
                state = self._iter_start_state
            self.sampler.load_state_dict(state)

    # -- resumable state ---------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Consumer-position snapshot, safe to call mid-iteration: while
        a prefetch producer is running ahead, the state of the last
        batch the training thread actually received is returned."""
        if self._active is not None:
            state = self._active.consumer_state()
            if state is not None:
                return dict(state)
            return dict(self._iter_start_state)
        return self.sampler.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Adopt a snapshot and re-seat in the CURRENT topology: after
        an elastic resize the remaining indices of the epoch reshard
        across the new world (pure index arithmetic, no replays)."""
        self.close()
        self.sampler.load_state_dict(state)
        if not self._explicit_topology:
            self.sampler.reshard(*_resolve_topology())
        self._iter_start_state = self.sampler.state_dict()

    def __repr__(self) -> str:
        s = self.sampler
        return (f"DataLoader(n={s.num_samples}, batch={s.batch_size}, "
                f"world={s.world_size}, rank={s.rank}, "
                f"epoch={s.epoch}, cursor={s.cursor}, "
                f"prefetch={'on' if self._prefetch else 'off'})")
