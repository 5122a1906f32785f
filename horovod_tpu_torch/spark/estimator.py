"""Estimator API: fit DataFrames, get back transformers (port of
horovod_tpu/spark/estimator.py).

Capability parity with the reference horovod/spark Estimators
(spark/common/estimator.py + spark/keras/ + spark/torch/): an Estimator
holds a model + training params + a ``Store``; ``fit(df)`` materializes the
DataFrame to Parquet in the store, trains it data-parallel (in-process at
``num_proc`` 1, through ``runner.run`` above it), checkpoints into the
store, and returns a Model transformer whose ``transform(df)`` appends
predictions.

The Torch and Lightning estimators compute where the port's ``init()``
puts them: ``device=None`` on the card (``cuda:0`` at world 1, each
worker's slot card under ``runner.run``), ``device="cpu"`` on the CPU over
gloo (the workers pinned with ``worker_platform="cpu"``); without a card
and without ``"cpu"``, ``fit`` raises through ``init()``.  The training
loop moves the model and every batch to the world's device, validation
runs there, and predictions come back to the host as numpy.  The Keras
estimator runs on the port's Keras front end, which computes on the CPU
(``init(device="cpu")``).
"""

from __future__ import annotations

import io
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .store import Store, dataframe_to_arrays


class _EstimatorParams:
    def __init__(self, store: Optional[Store] = None,
                 num_proc: Optional[int] = None,
                 batch_size: int = 32, epochs: int = 1,
                 feature_cols: Sequence[str] = ("features",),
                 label_cols: Sequence[str] = ("label",),
                 validation: Optional[float] = None,
                 run_id: Optional[str] = None,
                 verbose: int = 1,
                 shuffle: bool = True,
                 shuffle_seed: int = 0,
                 prefetch: int = 2):
        if store is None:
            raise ValueError("an Estimator requires a store= (Store.create "
                             "or LocalStore) for intermediate data and "
                             "checkpoints")
        self.store = store
        self.num_proc = num_proc
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.validation = validation
        self.run_id = run_id or "run_" + uuid.uuid4().hex[:8]
        self.verbose = verbose
        # Feed behavior (the Petastorm roles, reference
        # spark/keras/remote.py:102): per-epoch seeded row-group shuffle
        # identical across ranks, and async read-ahead depth.
        self.shuffle = bool(shuffle)
        self.shuffle_seed = int(shuffle_seed)
        self.prefetch = int(prefetch)

    def _materialize(self, df):
        """DataFrame → (train_path, val_path|None) parquet in the store
        (reference util.prepare_data).  Spark DataFrames split and write
        executor-side (randomSplit + distributed parquet write) — nothing
        funnels through driver memory."""
        store = self.store
        train_path = store.get_train_data_path(self.run_id)
        val_path = None
        if hasattr(df, "toPandas"):  # Spark DataFrame
            if self.validation:
                v = float(self.validation)
                val_df, train_df = df.randomSplit([v, 1.0 - v], seed=17)
            else:
                val_df, train_df = None, df
            store.write_dataframe(train_df, train_path)
            if val_df is not None:
                val_path = store.get_val_data_path(self.run_id)
                store.write_dataframe(val_df, val_path)
            return train_path, val_path
        n = len(df)
        if self.validation:
            # Shuffle before splitting: ordered input (time- or
            # label-sorted warehouse extracts) must not yield a biased
            # validation set (the reference splits randomized too).
            df = df.sample(frac=1.0, random_state=17).reset_index(drop=True)
            n_val = int(n * float(self.validation))
            val_df, train_df = df.iloc[:n_val], df.iloc[n_val:]
        else:
            val_df, train_df = None, df
        store.write_dataframe(train_df, train_path)
        if val_df is not None and len(val_df):
            val_path = store.get_val_data_path(self.run_id)
            store.write_dataframe(val_df, val_path)
        return train_path, val_path

    def _load_arrays(self, path):
        df = self.store.read_dataframe(path)
        return dataframe_to_arrays(df, self.feature_cols, self.label_cols)


def _rank_local_batches(store, path, feature_cols, label_cols, rank, size,
                        chunk_rows=65536, epoch=0, shuffle_seed=None,
                        prefetch=0):
    """Rank-local (X, y) chunks from the store feed.  Stores implementing
    the sharded reader (rank=/size= kwargs) yield rank-local data with a
    lockstep chunk schedule — plus per-epoch seeded shuffle and async
    prefetch when supported; legacy user Store subclasses overriding the
    old iter_array_batches signature fall back to shared reads + strided
    row slicing (the pre-sharding behavior)."""
    import inspect
    try:
        params = inspect.signature(store.iter_array_batches).parameters
    except (TypeError, ValueError):  # builtins / exotic callables
        params = {}
    if "rank" in params and "size" in params:
        extra = {}
        if "epoch" in params:
            extra = {"epoch": epoch, "shuffle_seed": shuffle_seed,
                     "prefetch": prefetch}
        yield from store.iter_array_batches(
            path, feature_cols, label_cols, chunk_rows=chunk_rows,
            rank=rank, size=size, **extra)
        return
    # Legacy override: pass only the kwargs its signature accepts.
    legacy_kw = {"chunk_rows": chunk_rows} if "chunk_rows" in params else {}
    for x, y in store.iter_array_batches(path, feature_cols, label_cols,
                                         **legacy_kw):
        n_local = len(x) // size if size > 1 else len(x)
        if size > 1:
            x, y = x[rank::size][:n_local], y[rank::size][:n_local]
        if n_local:
            yield x, y


class KerasEstimator(_EstimatorParams):
    """Fit a tf.keras model on a DataFrame (reference
    spark/keras/estimator.py KerasEstimator)."""

    def __init__(self, model=None, optimizer: Any = "sgd",
                 loss: Any = "mse", metrics: Sequence[str] = (),
                 custom_objects: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(**kw)
        if model is None:
            raise ValueError("KerasEstimator requires model=")
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.metrics = list(metrics)
        self.custom_objects = custom_objects or {}

    def fit(self, df) -> "KerasModel":
        if self.num_proc and self.num_proc > 1:
            raise ValueError(
                "KerasEstimator in-process fit is single-rank; for "
                "distributed keras training launch the script under "
                "hvdrun-torch or use horovod_tpu_torch.spark.run on a "
                "pyspark cluster (keras models don't survive spawn "
                "pickling)")
        train_path, val_path = self._materialize(df)
        x, y = self._load_arrays(train_path)
        val = self._load_arrays(val_path) if val_path else None

        import horovod_tpu_torch.keras as hvd_keras
        hvd_keras.init(device="cpu")   # the Keras front end's one device
        model = self.model
        opt = hvd_keras.DistributedOptimizer(
            self._build_optimizer(model))
        model.compile(optimizer=opt, loss=self.loss,
                      metrics=self.metrics or None)
        callbacks = [hvd_keras.callbacks.
                     BroadcastGlobalVariablesCallback(0)]
        # shuffle= honors the estimator-level feed knob (the in-memory
        # keras path shuffles rows via model.fit itself; prefetch is
        # moot here — the arrays are already resident).
        model.fit(x, y, batch_size=self.batch_size, epochs=self.epochs,
                  validation_data=val, verbose=self.verbose,
                  shuffle=self.shuffle, callbacks=callbacks)

        import tempfile, os, pathlib
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "model.keras")
            model.save(p)
            payload = pathlib.Path(p).read_bytes()
        self.store.save_checkpoint(self.run_id, payload)
        return KerasModel(model=model, feature_cols=self.feature_cols,
                          label_cols=self.label_cols, store=self.store,
                          run_id=self.run_id)

    def _build_optimizer(self, model):
        import tensorflow as tf
        if isinstance(self.optimizer, str):
            return tf.keras.optimizers.get(self.optimizer)
        return self.optimizer


class _Model:
    """Shared transformer shape for fitted models: ``transform(df)``
    appends one output column per label column."""

    def __init__(self, model, feature_cols, label_cols, store=None,
                 run_id=None, output_cols: Optional[List[str]] = None):
        self.model = model
        self.feature_cols = list(feature_cols)
        self.label_cols = list(label_cols)
        self.store = store
        self.run_id = run_id
        self.output_cols = output_cols or [
            c + "__output" for c in self.label_cols]

    def _predict(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform(self, df):
        if hasattr(df, "toPandas"):
            df = df.toPandas()
        x, _ = dataframe_to_arrays(
            df.assign(**{c: 0.0 for c in self.label_cols
                         if c not in df.columns}),
            self.feature_cols, self.label_cols)
        preds = np.asarray(self._predict(x))
        out = df.copy()
        for i, c in enumerate(self.output_cols):
            col = preds[:, i] if preds.ndim > 1 and preds.shape[1] > i \
                else preds.reshape(len(out), -1)[:, 0]
            out[c] = col
        return out


class KerasModel(_Model):
    """Transformer returned by KerasEstimator.fit (reference
    spark/keras/estimator.py KerasModel)."""

    def _predict(self, x):
        return self.model.predict(x, verbose=0)


class TorchEstimator(_EstimatorParams):
    """Fit a torch model on a DataFrame (reference
    spark/torch/estimator.py TorchEstimator)."""

    def __init__(self, model=None, optimizer: Optional[Callable] = None,
                 loss: Optional[Callable] = None, lr: float = 0.01,
                 device: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is None:
            raise ValueError("TorchEstimator requires model=")
        self.model = model
        self.optimizer_fn = optimizer
        self.loss_fn = loss
        self.lr = lr
        self.device = device

    def fit(self, df) -> "TorchModel":
        import torch
        train_path, val_path = self._materialize(df)

        spec = {
            "model": self.model, "optimizer_fn": self.optimizer_fn,
            "loss_fn": self.loss_fn, "lr": self.lr, "epochs": self.epochs,
            "batch_size": self.batch_size, "store": self.store,
            "train_path": train_path,
            "feature_cols": self.feature_cols,
            "label_cols": self.label_cols,
            "shuffle_seed": self.shuffle_seed if self.shuffle else None,
            "prefetch": self.prefetch, "device": self.device,
        }
        if self.num_proc and self.num_proc > 1:
            # Data-parallel fit: one local rank per process, batches
            # sharded by rank, gradients averaged by DistributedOptimizer
            # (the reference distributes over Spark executors; pyspark jobs
            # should use horovod_tpu_torch.spark.run with a module-level
            # fn).
            self.model.load_state_dict(_fit_on_workers(
                _torch_fit_worker, spec, self.num_proc, self.device))
        else:
            _torch_train_loop(spec)

        val_loss = None
        if val_path:
            xv, yv = self._load_arrays(val_path)
            loss_fn = self.loss_fn or torch.nn.MSELoss()
            dev = _model_device(_to_device(self.model,
                                           _fit_device(self.device)))
            with torch.no_grad():
                val_loss = float(loss_fn(
                    self.model(torch.from_numpy(xv).to(dev)),
                    torch.from_numpy(yv).to(dev)))
            if self.verbose:
                print(f"[TorchEstimator {self.run_id}] "
                      f"validation loss: {val_loss:.6f}")

        self.store.save_checkpoint(self.run_id, _state_bytes(self.model))
        out = TorchModel(model=self.model, feature_cols=self.feature_cols,
                         label_cols=self.label_cols, store=self.store,
                         run_id=self.run_id)
        out.validation_loss = val_loss
        return out


def _fit_device(device):
    """The device a fit computes on in this process: the world's once
    ``init()`` has run, else the one asked for (None: the card, raising
    without one).  A world already computing on another kind of device
    than the one asked for is refused, never silently used."""
    import torch
    from ..core.basics import resolve_device
    from ..core.state import global_state
    if global_state.initialized:
        dev = global_state.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(
                f"the estimator asks for {device}, and this process's "
                f"world already computes on {dev}: shut it down first or "
                "ask for its device")
        return dev
    return resolve_device(device)


def _to_device(model, dev):
    """Move ``model``'s parameters to ``dev`` in place (an ``nn.Module``
    through ``.to``; a LightningModule-style object that only exposes
    ``parameters()`` parameter by parameter), so an optimizer over them
    stays valid."""
    if hasattr(model, "to"):
        model.to(dev)
    else:
        for p in model.parameters():
            p.data = p.data.to(dev)
    return model


def _model_device(model):
    for p in model.parameters():
        return p.device
    import torch
    return torch.device("cpu")


def _state_bytes(model) -> bytes:
    """``model``'s state_dict as ``torch.save`` bytes of host copies, so
    a checkpoint or a worker's result loads without a card."""
    import torch
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               buf)
    return buf.getvalue()


def _fit_on_workers(worker, spec, num_proc, device):
    """Run ``worker(spec)`` as ``num_proc`` ranks through ``runner.run``
    and return rank 0's fitted state_dict.  ``device="cpu"`` pins every
    worker to the CPU; otherwise each inherits the host's cards and
    computes on ``cuda:local_rank`` (``worker_platform="gpu"``: never the
    launcher's CPU pinning of a count the cards do not divide), and a
    worker without its card raises in ``init()``.  The controller listens
    on a free port, so fits in parallel do not collide.

    The spec crosses to the workers as pickled bytes: handed to a spawned
    process as an argument, the model's tensors would go through
    torch's multiprocessing pickler, which moves their storage to shared
    memory, so every rank (and the caller) would step one set of
    parameters at once."""
    import pickle
    import torch
    from ..runner import run as _run
    from ..runner.chips import _free_port
    states = _run(_spec_worker, args=(worker, pickle.dumps(spec)),
                  np=int(num_proc), controller_port=_free_port(),
                  worker_platform=worker_platform(device))
    state = next(s for s in states if s is not None)
    return torch.load(io.BytesIO(state), weights_only=True)


def worker_platform(device) -> str:
    """The launcher's plan for workers asked to compute on ``device``:
    "cpu" pins them to the CPU, and every other choice (``None``, the
    card) is "gpu", each worker on its host's cards, never pinned to the
    CPU behind the caller's back."""
    import torch
    cpu = device is not None and torch.device(device).type == "cpu"
    return "cpu" if cpu else "gpu"


def _spec_worker(worker, spec_bytes: bytes):
    """``worker`` on this rank's own copy of the pickled spec."""
    import pickle
    return worker(pickle.loads(spec_bytes))


def _rank_world(spec):
    """``init()`` on the spec's device, the model moved there, and this
    rank's place in the feed: ``(dev, model, rank, size)``.
    Shard by the communicator (the participating processes)."""
    import horovod_tpu_torch.torch as hvd_torch
    from ..ops.collective import communicator_size
    hvd_torch.init(device=spec.get("device"))
    dev = _fit_device(spec.get("device"))
    model = _to_device(spec["model"], dev)
    size = communicator_size()
    rank = hvd_torch.rank() % size if size > 1 else 0
    return dev, model, rank, size


def _device_batches(spec, dev, rank, size):
    """This rank's ``(x, y)`` batches on ``dev``, epoch after epoch.  The
    store's sharded reader guarantees an identical fixed-size chunk
    schedule on every rank (truncated to the common per-rank row count;
    legacy Store overrides fall back to shared reads + strided rows), so
    the blocking per-gradient allreduces stay in lockstep; chunks come in
    a fresh seeded order each epoch with async read-ahead.  One copy of
    each chunk goes to the device; the seeded permutation is drawn on the
    host (the reference's stream) and indexes there."""
    import torch
    g = torch.Generator().manual_seed(13)
    for epoch in range(spec["epochs"]):
        for x, y in _rank_local_batches(
                spec["store"], spec["train_path"], spec["feature_cols"],
                spec["label_cols"], rank, size, epoch=epoch,
                shuffle_seed=spec.get("shuffle_seed"),
                prefetch=spec.get("prefetch", 0)):
            n_local = len(x)
            if n_local == 0:
                continue
            xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            perm = torch.randperm(n_local, generator=g).to(dev)
            for s in range(0, n_local, spec["batch_size"]):
                idx = perm[s:s + spec["batch_size"]]
                yield xt[idx], yt[idx]


def _torch_train_loop(spec) -> None:
    """One rank's training loop: parquet chunks streamed from the store
    (never the whole dataset in memory — the reference's Petastorm role),
    rows sharded by rank, the model and every batch on the world's
    device, grads allreduced through DistributedOptimizer, initial params
    synced from rank 0."""
    import torch
    import horovod_tpu_torch.torch as hvd_torch
    dev, model, rank, size = _rank_world(spec)
    base_opt = (spec["optimizer_fn"](model.parameters())
                if spec["optimizer_fn"]
                else torch.optim.SGD(model.parameters(), lr=spec["lr"]))
    opt = hvd_torch.DistributedOptimizer(
        base_opt, named_parameters=model.named_parameters())
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    loss_fn = spec["loss_fn"] or torch.nn.MSELoss()
    for xb, yb in _device_batches(spec, dev, rank, size):
        opt.zero_grad()
        loss = loss_fn(model(xb), yb)
        loss.backward()
        opt.step()


def _torch_fit_worker(spec):
    """Module-level worker for runner.run (spawn requires picklability):
    trains a rank; rank 0 returns the state_dict bytes."""
    from .store import prefer_system_arrow_pool
    prefer_system_arrow_pool()  # before the worker's first arrow touch
    import horovod_tpu_torch.torch as hvd_torch
    _torch_train_loop(spec)
    return _state_bytes(spec["model"]) if hvd_torch.rank() == 0 else None


class TorchModel(_Model):
    """Transformer returned by TorchEstimator.fit: predicts on the
    device the model's parameters live on, returns host numpy."""

    def _predict(self, x):
        return _predict_on_model_device(self.model, x)


def _predict_on_model_device(model, x):
    import torch
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(_model_device(model)))
        return out.cpu().numpy()


class LightningEstimator(_EstimatorParams):
    """Fit a LightningModule-style model on a DataFrame (reference
    spark/lightning/estimator.py LightningEstimator).

    Duck-typed against the LightningModule protocol —
    ``configure_optimizers()`` and ``training_step(batch, batch_idx)`` on a
    torch ``nn.Module`` — so it works with real ``pytorch_lightning``
    modules *and* without the lightning package installed (the card's
    machines do not ship it).  The optimizer the module configures is
    wrapped with hvd.DistributedOptimizer; batches stream from the store in
    chunks."""

    def __init__(self, model=None, device: Optional[str] = None, **kw):
        super().__init__(**kw)
        if model is None:
            raise ValueError("LightningEstimator requires model= (a "
                             "LightningModule or any nn.Module with "
                             "configure_optimizers + training_step)")
        for required in ("configure_optimizers", "training_step"):
            if not callable(getattr(model, required, None)):
                raise TypeError(f"model lacks {required}(); pass a "
                                "LightningModule-style module")
        self.model = model
        self.device = device

    def fit(self, df) -> "LightningModel":
        train_path, _val_path = self._materialize(df)
        spec = {
            "model": self.model, "epochs": self.epochs,
            "batch_size": self.batch_size, "store": self.store,
            "train_path": train_path,
            "feature_cols": self.feature_cols,
            "label_cols": self.label_cols,
            "shuffle_seed": self.shuffle_seed if self.shuffle else None,
            "prefetch": self.prefetch, "device": self.device,
        }
        if self.num_proc and self.num_proc > 1:
            self.model.load_state_dict(_fit_on_workers(
                _lightning_fit_worker, spec, self.num_proc, self.device))
        else:
            _lightning_train_loop(spec)
        self.store.save_checkpoint(self.run_id, _state_bytes(self.model))
        return LightningModel(
            model=self.model, feature_cols=self.feature_cols,
            label_cols=self.label_cols, store=self.store,
            run_id=self.run_id)


def _first_optimizer(configured):
    """configure_optimizers may return an optimizer, a list, or the
    lightning ([optimizers], [schedulers]) pair."""
    if isinstance(configured, (list, tuple)):
        first = configured[0]
        if isinstance(first, (list, tuple)):
            first = first[0]
        return first
    return configured


def _lightning_train_loop(spec) -> None:
    """``_torch_train_loop`` through the module's ``training_step`` and
    the first optimizer it configures."""
    import horovod_tpu_torch.torch as hvd_torch
    dev, model, rank, size = _rank_world(spec)
    base_opt = _first_optimizer(model.configure_optimizers())
    opt = hvd_torch.DistributedOptimizer(
        base_opt, named_parameters=model.named_parameters())
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    for batch_idx, batch in enumerate(_device_batches(spec, dev, rank,
                                                      size)):
        opt.zero_grad()
        loss = model.training_step(batch, batch_idx)
        if isinstance(loss, dict):  # lightning allows {"loss": t}
            loss = loss["loss"]
        loss.backward()
        opt.step()


def _lightning_fit_worker(spec):
    """Module-level lightning worker for runner.run: trains a rank;
    rank 0 returns the state_dict bytes."""
    from .store import prefer_system_arrow_pool
    prefer_system_arrow_pool()  # before the worker's first arrow touch
    import horovod_tpu_torch.torch as hvd_torch
    _lightning_train_loop(spec)
    return _state_bytes(spec["model"]) if hvd_torch.rank() == 0 else None


class LightningModel(_Model):
    """Transformer returned by LightningEstimator.fit: predicts on the
    device the model's parameters live on, returns host numpy."""

    def _predict(self, x):
        return _predict_on_model_device(self.model, x)
