"""Elastic state of the torch front end (port of
horovod_tpu/torch/elastic.py): ``TorchState`` and ``ElasticSampler``.

* ``TorchState(model=..., optimizer=..., **objs)``: ``commit``/``restore``
  snapshot the model's and the optimizer's ``state_dict`` (deep copies,
  on the tensors' own devices); ``sync`` gives every rank the root's.
  Where the reference pickles whole snapshots through
  ``broadcast_object``, the port broadcasts the tensors in place on the
  world's backend and pickles only the rest (the optimizer's
  hyperparameters, its state's layout and scalars): a tensor on the card
  never crosses to the host.  The values are the reference's.
* ``ElasticSampler``: a rank-sharded sampler that records processed
  indices, so a restored epoch resumes mid-way after the world changes.

    state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
    @hvd.elastic.run
    def train(state): ...
"""

from __future__ import annotations

import copy
from typing import Iterator, List, Optional

import torch

from ..core.state import global_state
from ..elastic.state import ObjectState, run  # noqa: F401 (re-export)
from ..ops import collective as _C
from ..optimizers import broadcast_object


def _broadcast_inplace(t: torch.Tensor, root: int) -> None:
    """``t`` from ``root`` in place; state held on the host (an
    optimizer's step count) travels through the world's device."""
    dev = global_state.device
    with torch.no_grad():
        if dev is None or t.device.type == dev.type:
            _C.broadcast_(t, root)
        else:
            t.copy_(_C.broadcast_(t.to(dev), root))


def _layout(state_dict: dict):
    """The optimizer state dict with each tensor replaced by its
    (shape, dtype, device type): what a member with no state yet needs to
    allocate the root's."""
    out = {k: v for k, v in state_dict.items() if k != "state"}
    out["state"] = {
        pid: {k: (("tensor", tuple(v.shape), v.dtype, v.device.type)
                  if torch.is_tensor(v) else ("value", v))
              for k, v in st.items()}
        for pid, st in state_dict["state"].items()}
    return out


def _sync_optimizer(optimizer, root: int) -> None:
    """The root's optimizer state on every rank: its layout and scalars
    pickled, its tensors broadcast in place."""
    mine = optimizer.state_dict()
    layout = broadcast_object(_layout(mine) if global_state.rank == root
                              else None, root_rank=root,
                              name="torchstate.opt")
    dev = global_state.device
    state = {}
    for pid, entries in layout["state"].items():
        have = mine["state"].get(pid, {})
        st = {}
        for key, entry in entries.items():     # the root's order, on all
            if entry[0] == "value":
                st[key] = entry[1]
                continue
            _, shape, dtype, dev_type = entry
            t = have.get(key)
            if not (torch.is_tensor(t) and tuple(t.shape) == shape
                    and t.dtype == dtype):
                t = torch.empty(shape, dtype=dtype,
                                device=dev if dev_type == dev.type
                                else dev_type)
            _broadcast_inplace(t, root)
            st[key] = t
        state[pid] = st
    sd = {k: v for k, v in layout.items() if k != "state"}
    sd["state"] = state
    optimizer.load_state_dict(sd)


class TorchState(ObjectState):
    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 **kwargs):
        self._model = model
        self._optimizer = optimizer
        self._model_snapshot = None
        self._opt_snapshot = None
        super().__init__(**kwargs)
        self.save()

    def save(self):
        if self._model is not None:
            self._model_snapshot = copy.deepcopy(self._model.state_dict())
        if self._optimizer is not None:
            self._opt_snapshot = copy.deepcopy(
                self._optimizer.state_dict())
        super().save()

    def restore(self):
        if self._model is not None and self._model_snapshot is not None:
            self._model.load_state_dict(self._model_snapshot)
        if self._optimizer is not None and self._opt_snapshot is not None:
            self._optimizer.load_state_dict(self._opt_snapshot)
        super().restore()

    def sync(self):
        root = self.elect_sync_root()
        if self._model is not None:
            # The snapshot first, then the live model from it: what the
            # reference's broadcast of the snapshot gives.
            snap = self._model_snapshot
            for key in sorted(snap):
                if torch.is_tensor(snap[key]):
                    _broadcast_inplace(snap[key], root)
            self._model.load_state_dict(snap)
        if self._optimizer is not None:
            self._optimizer.load_state_dict(self._opt_snapshot)
            _sync_optimizer(self._optimizer, root)
            self._opt_snapshot = copy.deepcopy(self._optimizer.state_dict())
        super().sync(root=root)


class ElasticSampler(torch.utils.data.Sampler):
    """Rank-sharded sampler that can resume an epoch after re-rendezvous:
    indices already processed (recorded through ``record_batch``) are
    left out when the world re-shards (reference
    torch/elastic/sampler.py)."""

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.reset()

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Mark one local batch as processed (call after each step)."""
        start = batch_idx * batch_size
        self.processed_indices.update(self.indices[start:start + batch_size])

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

    def state_dict(self):
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def reset(self):
        """Re-shard the unprocessed indices over the current world; called
        on init, set_epoch and an elastic reset."""
        from ..core.basics import is_initialized, rank
        size = _C.communicator_size() if is_initialized() else 1
        my_rank = rank() % size if is_initialized() and size > 1 else 0

        remaining = [i for i in range(len(self.dataset))
                     if i not in self.processed_indices]
        if self.shuffle:
            g = torch.Generator().manual_seed(self.seed + self.epoch)
            order = torch.randperm(len(remaining), generator=g).tolist()
            remaining = [remaining[i] for i in order]
        # Pad so every rank draws the same number of batches.
        if size > 1 and len(remaining) % size != 0:
            pad = size - len(remaining) % size
            remaining = remaining + remaining[:pad]
        self.num_samples = len(remaining) // size if remaining else 0
        self.indices: List[int] = remaining[my_rank::size] if remaining \
            else []

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples
