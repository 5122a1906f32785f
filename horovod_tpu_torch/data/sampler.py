"""Deterministic, elastic-resumable index sharding (the port's own copy of
horovod_tpu/data/sampler.py: the same index streams, element for element,
for the same seed, world and rank).

The reference makes lossless restarts possible by making the *sampler*
the unit of resumable state (``horovod/torch/elastic/sampler.py``): what
a rank feeds its model is a pure function of (dataset size, seed, epoch,
world size, position).  ``ShardedIndexSampler`` carries that idea with
one structural change: its state is **global**, not per-rank.

* The epoch order is a pure function ``epoch_order(epoch)`` of
  ``(seed, epoch, num_samples)`` — every rank derives the identical
  permutation without communicating.
* One ``cursor`` counts globally consumed samples.  A *global batch* is
  ``batch_size x world_size`` consecutive entries of the order; rank
  *r* owns the contiguous slice ``[r*b, (r+1)*b)`` of it.  Because all
  ranks advance in lockstep (one global batch per training step), the
  (epoch, cursor, seed) triple is rank-invariant — it can ride a rank-0
  broadcast, live in a checkpoint manifest, and restore into ANY world
  size.
* Resharding N→M is therefore a pure function of the remaining indices:
  nothing is recorded per rank, so nothing is lost or duplicated when
  the world resizes mid-epoch — the survivors simply re-slice
  ``order[cursor:]`` by the new world.

End-of-epoch policies when the remainder does not fill a global batch:

* ``"drop"`` — drop the tail (the classic ``drop_last``);
* ``"pad"``  — wrap indices from the epoch head so every rank still
  draws a full batch (the reference sampler's pad-to-even behavior).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

DROP = "drop"
PAD = "pad"
_POLICIES = (DROP, PAD)


class ShardedIndexSampler:
    """Partition ``range(num_samples)`` across ``world_size`` ranks with a
    seed-keyed per-epoch shuffle and a resumable global cursor."""

    def __init__(self, num_samples: int, batch_size: int, *,
                 world_size: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 policy: str = PAD, epoch: int = 0):
        if num_samples <= 0:
            raise ValueError(f"num_samples must be positive, got "
                             f"{num_samples}")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got "
                             f"{batch_size}")
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got "
                             f"{policy!r}")
        self.num_samples = int(num_samples)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.policy = policy
        self.epoch = int(epoch)
        self.cursor = 0          # globally consumed samples this epoch
        self._order: Optional[np.ndarray] = None
        self.reshard(world_size, rank)

    # -- pure functions ----------------------------------------------------
    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's global index order — pure in (seed, epoch, n), so
        every rank (and every restore, at any world size) derives the
        identical permutation without a collective."""
        if not self.shuffle:
            return np.arange(self.num_samples, dtype=np.int64)
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.num_samples).astype(np.int64)

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.world_size

    # -- topology ----------------------------------------------------------
    def reshard(self, world_size: int, rank: int = 0) -> None:
        """Re-seat this sampler in a (possibly different) world.  Pure
        over the global state: epoch/cursor/seed are untouched, so the
        *remaining* indices ``order[cursor:]`` are simply re-sliced by
        the new world — no sample is dropped or replayed."""
        world_size = int(world_size)
        rank = int(rank)
        if world_size <= 0:
            raise ValueError(f"world_size must be positive, got "
                             f"{world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world "
                             f"{world_size}")
        self.world_size = world_size
        self.rank = rank

    # -- iteration ---------------------------------------------------------
    def _epoch_order_cached(self) -> np.ndarray:
        if self._order is None or len(self._order) != self.num_samples:
            self._order = self.epoch_order(self.epoch)
        return self._order

    def next_global_batch(self) -> Optional[np.ndarray]:
        """The next global batch (all ranks' indices, rank-major), or
        None when the epoch is exhausted under the configured policy."""
        order = self._epoch_order_cached()
        gbs = self.global_batch_size
        remaining = self.num_samples - self.cursor
        if remaining <= 0:
            return None
        if remaining >= gbs:
            g = order[self.cursor:self.cursor + gbs]
        elif self.policy == DROP:
            self.cursor = self.num_samples
            return None
        else:  # PAD: wrap from the epoch head so every rank gets a
            # batch; np.resize tiles cyclically, so even a global batch
            # larger than the whole dataset (tiny set, big elastic
            # world) comes back full-size.
            g = np.concatenate([order[self.cursor:],
                                np.resize(order, gbs - remaining)])
        self.cursor += min(remaining, gbs)
        return g

    def shard(self, global_batch: np.ndarray,
              ranks: Optional[Sequence[int]] = None) -> np.ndarray:
        """The contiguous slice of a global batch owned by ``ranks``
        (default: this sampler's rank).  ``ranks`` must be contiguous —
        a single-controller process feeding several chips takes them in
        rank order so the device sharding lines up."""
        if ranks is None:
            ranks = (self.rank,)
        ranks = sorted(int(r) for r in ranks)
        if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
            raise ValueError(f"ranks must be contiguous, got {ranks}")
        b = self.batch_size
        return global_batch[ranks[0] * b:(ranks[-1] + 1) * b]

    def next_batch(self, ranks: Optional[Sequence[int]] = None
                   ) -> Optional[np.ndarray]:
        g = self.next_global_batch()
        return None if g is None else self.shard(g, ranks)

    def advance_epoch(self) -> None:
        self.set_epoch(self.epoch + 1)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self.cursor = 0
        self._order = None

    def batches_remaining(self) -> int:
        """Global batches left in the current epoch from the cursor."""
        remaining = self.num_samples - self.cursor
        if remaining <= 0:
            return 0
        gbs = self.global_batch_size
        whole, tail = divmod(remaining, gbs)
        return whole + (1 if tail and self.policy == PAD else 0)

    def __len__(self) -> int:
        return self.batches_remaining()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            batch = self.next_batch()
            if batch is None:
                return
            yield batch

    # -- resumable state ---------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """JSON-serializable snapshot: (epoch, cursor, seed, world size)
        plus the static shape of the epoch, enough to resume with no
        duplicated and no dropped samples at any world size."""
        return {
            "epoch": int(self.epoch),
            "cursor": int(self.cursor),
            "seed": int(self.seed),
            "world_size": int(self.world_size),
            "num_samples": int(self.num_samples),
            "batch_size": int(self.batch_size),
            "shuffle": bool(self.shuffle),
            "policy": self.policy,
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Adopt a snapshot.  The *current* world/rank seating is kept —
        the recorded ``world_size`` documents where the state was
        written; the remaining indices reshard to wherever this sampler
        is seated now (the elastic N→M path)."""
        if int(state["num_samples"]) != self.num_samples:
            raise ValueError(
                f"sampler state is for a dataset of "
                f"{state['num_samples']} samples; this sampler covers "
                f"{self.num_samples}")
        self.seed = int(state["seed"])
        self.shuffle = bool(state["shuffle"])
        self.policy = str(state["policy"])
        self.batch_size = int(state["batch_size"])
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self._order = None
