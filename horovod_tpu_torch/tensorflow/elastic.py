"""Elastic state objects of the TensorFlow front end (port of
horovod_tpu/tensorflow/elastic.py), on the port's ``elastic.state``:

* ``TensorFlowState`` (reference :156-175) — elastic state over an explicit
  list of ``tf.Variable``s.
* ``TensorFlowKerasState`` (reference :91-155) — elastic state over a Keras
  model + optimizer (+ arbitrary picklable attributes).
* ``run`` (reference :53-66) — the elastic retry decorator, additionally
  translating TF-wrapped collective failures (a bridged op surfacing as
  ``tf.errors.OpError``) into ``HorovodInternalError`` so the common retry
  loop can restore state.

Snapshots live in host memory (``.numpy()`` copies): a worker's reset
cannot lose them, and ``restore`` re-assigns them into the live variables.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, List, Optional

import numpy as np
import tensorflow as _tf

from ..core.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..elastic.state import State, run as _common_run
from ..optimizers import broadcast_object
from . import broadcast_variables


class TensorFlowState(State):
    """Elastic state for a list of tf.Variables (e.g.
    ``tf.global_variables()`` equivalents or ``model.variables``)."""

    def __init__(self, variables: Optional[List] = None, **kwargs):
        self.variables = list(variables or [])
        self._object_keys = list(kwargs.keys())
        self._snapshot: List[np.ndarray] = []
        self._object_snapshot: dict = {}
        super().__init__(**kwargs)
        self.save()

    def save(self):
        self._snapshot = [v.numpy() for v in self.variables]
        self._object_snapshot = {
            k: copy.deepcopy(getattr(self, k)) for k in self._object_keys}

    def restore(self):
        for v, snap in zip(self.variables, self._snapshot):
            v.assign(snap)
        for k, val in self._object_snapshot.items():
            setattr(self, k, copy.deepcopy(val))

    def sync(self):
        root = self.elect_sync_root()
        broadcast_variables(self.variables, root_rank=root)
        if self._object_keys:
            synced = broadcast_object(
                {k: getattr(self, k) for k in self._object_keys},
                root_rank=root, name="tf.state.objects")
            for k, v in synced.items():
                setattr(self, k, v)
        self.save()
        self.adopt_sync_generation()


class TensorFlowKerasState(State):
    """Elastic state for a Keras model + optimizer: weights snapshotted to
    host memory on commit, broadcast from rank 0 on sync."""

    def __init__(self, model, optimizer=None, **kwargs):
        self.model = model
        self.optimizer = optimizer or getattr(model, "optimizer", None)
        self._object_keys = list(kwargs.keys())
        self._model_snapshot: List[np.ndarray] = []
        self._opt_snapshot: List[np.ndarray] = []
        self._object_snapshot: dict = {}
        super().__init__(**kwargs)
        self.save()

    def _opt_variables(self) -> List:
        opt = self.optimizer
        if opt is None:
            return []
        # Keras 3 exposes .variables; legacy optimizers .weights.
        for attr in ("variables", "weights"):
            vs = getattr(opt, attr, None)
            if vs:
                return list(vs)
        return []

    @staticmethod
    def _var_key(v, index: int) -> str:
        return getattr(v, "path", None) or getattr(v, "name", None) or \
            f"var.{index}"

    def save(self):
        self._model_snapshot = [np.asarray(w)
                                for w in self.model.get_weights()]
        # Name-keyed: Keras builds slot variables lazily, so the variable
        # list can grow between save and restore — a positional zip would
        # mispair (or silently skip) optimizer state.
        self._opt_snapshot = {
            self._var_key(v, i): v.numpy()
            for i, v in enumerate(self._opt_variables())}
        self._object_snapshot = {
            k: copy.deepcopy(getattr(self, k)) for k in self._object_keys}

    def restore(self):
        if self._model_snapshot:
            self.model.set_weights(self._model_snapshot)
        for i, v in enumerate(self._opt_variables()):
            snap = self._opt_snapshot.get(self._var_key(v, i))
            if snap is not None:
                v.assign(snap)
            else:
                # Variable did not exist at the last commit (optimizer was
                # unbuilt): fresh state, consistent with the committed
                # snapshot, instead of keeping post-failure values.
                v.assign(_tf.zeros_like(v))
        for k, val in self._object_snapshot.items():
            setattr(self, k, copy.deepcopy(val))

    def sync(self):
        root = self.elect_sync_root()
        broadcast_variables(self.model.variables, root_rank=root)
        opt_vars = self._opt_variables()
        if opt_vars:
            broadcast_variables(opt_vars, root_rank=root)
        if self._object_keys:
            synced = broadcast_object(
                {k: getattr(self, k) for k in self._object_keys},
                root_rank=root, name="keras.state.objects")
            for k, v in synced.items():
                setattr(self, k, v)
        self.save()
        self.adopt_sync_generation()


def run(func):
    """Elastic retry decorator for TF training functions.  Collective
    failures raised through the TF op bridge can surface as tf.errors
    OpError (the reference maps UnknownError the same way,
    tensorflow/elastic.py:53-66); translate before the common loop."""

    @functools.wraps(func)
    def translated(state, *args, **kwargs):
        try:
            return func(state, *args, **kwargs)
        except _tf.errors.OpError as e:
            msg = getattr(e, "message", str(e))
            # Only errors that actually wrap our runtime's failure: a
            # broader heuristic would reclassify deterministic user errors
            # (NotFoundError etc.) and loop the retry forever.
            if "HorovodInternalError" in msg:
                raise HorovodInternalError(msg) from e
            raise

    return _common_run(translated)


__all__ = ["TensorFlowState", "TensorFlowKerasState", "run",
           "HorovodInternalError", "HostsUpdatedInterrupt"]
