"""Keras callbacks of the port (port of horovod_tpu/keras/callbacks.py;
reference horovod/_keras/callbacks.py:23-131)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import tensorflow as _tf

from .. import tensorflow as hvd_tf


class BroadcastGlobalVariablesCallback(_tf.keras.callbacks.Callback):
    """Broadcast all model/optimizer variables from root at train begin so
    every rank starts identical."""

    def __init__(self, root_rank: int = 0):
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_batch_end(self, batch, logs=None):
        if self._done:
            return
        hvd_tf.broadcast_variables(self.model.variables, self.root_rank)
        if hasattr(self.model, "optimizer") and \
                hasattr(self.model.optimizer, "variables"):
            try:
                hvd_tf.broadcast_variables(
                    list(self.model.optimizer.variables), self.root_rank)
            except Exception:
                pass
        self._done = True


class MetricAverageCallback(_tf.keras.callbacks.Callback):
    """Average epoch metrics over ranks (reference _keras/callbacks.py:49-91)
    so logged/monitored values agree everywhere."""

    def on_epoch_end(self, epoch, logs=None):
        if logs is None or hvd_tf.size() == 1:
            return
        for key in list(logs.keys()):
            try:
                value = np.asarray([float(logs[key])], dtype=np.float64)
            except (TypeError, ValueError):
                continue
            logs[key] = float(np.asarray(hvd_tf.allreduce(
                _tf.constant(value), op=hvd_tf.Average,
                name=f"metric.{epoch}.{key}"))[0])


class LearningRateWarmupCallback(_tf.keras.callbacks.Callback):
    """Linear LR warmup from lr/size to lr over N epochs (reference
    LearningRateWarmupCallback): large-batch training ramps the scaled LR."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 momentum_correction: bool = True, steps_per_epoch=None,
                 verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        self._current_epoch = 0

    def on_epoch_begin(self, epoch, logs=None):
        self._current_epoch = epoch
        if epoch >= self.warmup_epochs:
            return
        progress = (epoch + 1) / self.warmup_epochs
        scale = (1.0 / hvd_tf.size()) + progress * (1 - 1.0 / hvd_tf.size())
        lr = self.initial_lr * scale
        self._set_lr(lr)
        if self.verbose:
            print(f"\nEpoch {epoch}: warmup lr = {lr:.6f}")

    def _set_lr(self, lr):
        opt = self.model.optimizer
        if hasattr(opt, "learning_rate"):
            try:
                opt.learning_rate = lr
            except Exception:
                _tf.keras.backend.set_value(opt.learning_rate, lr)


class LearningRateScheduleCallback(_tf.keras.callbacks.Callback):
    """Multiply the LR by ``multiplier`` within [start_epoch, end_epoch)
    (reference LearningRateScheduleCallback)."""

    def __init__(self, initial_lr: float, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, verbose: int = 0):
        super().__init__()
        self.initial_lr = initial_lr
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.verbose = verbose
        if callable(multiplier):
            self._mult = multiplier
        else:
            self._mult = lambda epoch: multiplier

    def on_epoch_begin(self, epoch, logs=None):
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        lr = self.initial_lr * self._mult(epoch)
        opt = self.model.optimizer
        try:
            opt.learning_rate = lr
        except Exception:
            _tf.keras.backend.set_value(opt.learning_rate, lr)
        if self.verbose:
            print(f"\nEpoch {epoch}: lr = {lr:.6f}")


class MetricsCallback(_tf.keras.callbacks.Callback):
    """Feed ``hvd.metrics`` from a Keras training loop: one
    ``step_end(batch_time)`` per batch (driving the step-time histogram
    and — on the ``HVD_TPU_METRICS_SYNC_STEPS`` cadence — the cross-rank
    aggregation + straggler detector), plus an optional per-epoch JSONL
    snapshot in the registry's snapshot schema, as the Prometheus endpoint
    exposes it.

    Args:
      jsonl_path: when given, append one registry snapshot per epoch to
        this rotating JSONL file.
      serve_port: when given, start the Prometheus endpoint on this port
        at train begin (idempotent with ``init()``'s
        ``HVD_TPU_METRICS_PORT`` auto-start).
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 serve_port: Optional[int] = None):
        super().__init__()
        self._jsonl_path = jsonl_path
        self._serve_port = serve_port
        self._sink = None
        self._batch_t0: Optional[float] = None
        self._epoch = 0

    def on_train_begin(self, logs=None):
        from .. import metrics
        if self._jsonl_path:
            self._sink = metrics.JsonlSink(self._jsonl_path)
        if self._serve_port is not None:
            metrics.serve(port=self._serve_port)

    def on_train_batch_begin(self, batch, logs=None):
        import time
        self._batch_t0 = time.perf_counter()

    def on_train_batch_end(self, batch, logs=None):
        import time
        from .. import metrics
        dt = None
        if self._batch_t0 is not None:
            dt = time.perf_counter() - self._batch_t0
        metrics.step_end(dt)

    def on_epoch_end(self, epoch, logs=None):
        self._epoch = epoch + 1
        if self._sink is not None:
            from .. import metrics
            self._sink.write_snapshot(
                epoch=epoch, rank=hvd_tf.rank(),
                step=int(metrics.registry().counter(
                    "hvd_steps_total", "Training steps observed").value))


class CommitStateCallback(_tf.keras.callbacks.Callback):
    """Commit the elastic state every ``batches_per_commit`` batches
    (reference _keras/elastic.py:17-45): a worker failure rolls training
    back at most that many batches."""

    def __init__(self, state, batches_per_commit: int = 1):
        super().__init__()
        self.state = state
        self.batches_per_commit = max(int(batches_per_commit), 1)
        self._batches = 0

    def on_batch_end(self, batch, logs=None):
        self._batches += 1
        if self._batches % self.batches_per_commit == 0:
            self.state.commit()


class UpdateEpochStateCallback(_tf.keras.callbacks.Callback):
    """Track the current epoch in the elastic state (reference
    _keras/elastic.py:66-80) so a restarted worker resumes from the right
    epoch instead of epoch 0."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_begin(self, epoch, logs=None):
        self.state.epoch = epoch

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch + 1
