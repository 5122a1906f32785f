"""``horovod_tpu_torch.spark``'s estimators against ``horovod_tpu.spark``'s
on the same seeded DataFrame.

At world 1, in this process (the reference initializing itself in its
fit, the port with ``device="cpu"``): ``TorchEstimator`` (SGD and Adam,
with and without a validation split and the feed's shuffle, and through
a store subclass with the legacy ``iter_array_batches`` signature) and
``LightningEstimator`` (a LightningModule-style object without the
lightning package) give the reference's fitted weights, validation loss
and ``transform`` outputs bit for bit; ``KerasEstimator`` (on each
package's Keras front end) its weights and outputs within 1e-6.  Two gloo
ranks: ``TorchEstimator(num_proc=2)`` through ``runner.run`` against the
reference's two-rank fit within 1e-5.  Refusals: without a card and
without ``device="cpu"`` a fit raises in ``init()``; a fit asking for
another kind of device than this process's world computes on raises;
the reference's argument checks."""

import time

import numpy as np
import pandas as pd
import pytest
import torch

import horovod_tpu.spark as ref_spark
import horovod_tpu_torch.spark as port_spark
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.runner.chips import _free_port


@pytest.fixture
def port_world():
    """The port's world, shut down after each test (a fit leaves it up,
    as the reference's does)."""
    yield
    if basics.is_initialized():
        basics.shutdown()


def _regression_df(n=64, d=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = np.arange(1, d + 1, dtype=np.float32)
    return pd.DataFrame({"features": [row.tolist() for row in x],
                         "label": (x @ w).astype(np.float32)})


def _linear(seed=0, d=3):
    torch.manual_seed(seed)
    return torch.nn.Linear(d, 1)


def _sgd(params):
    return torch.optim.SGD(params, lr=0.05, momentum=0.9)


def _adam(params):
    return torch.optim.Adam(params, lr=0.01)


def _fit_torch(pkg, tmp_path, **kw):
    store = pkg.LocalStore(str(tmp_path / pkg.__name__))
    extra = {"device": "cpu"} if pkg is port_spark else {}
    est = pkg.TorchEstimator(model=_linear(), store=store,
                             feature_cols=["features"],
                             label_cols=["label"], verbose=0,
                             **extra, **kw)
    return est, est.fit(_regression_df(96))


def _state(model):
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def _assert_same_fit(got, want, df):
    gs, ws = _state(got.model), _state(want.model)
    assert gs.keys() == ws.keys()
    for k in gs:
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    pd.testing.assert_frame_equal(got.transform(df), want.transform(df))


@pytest.mark.parametrize("kw", [
    dict(lr=0.1, epochs=3, batch_size=24, validation=0.25),
    dict(optimizer=_sgd, epochs=2, batch_size=16, shuffle=False),
    dict(optimizer=_adam, epochs=2, batch_size=32, validation=0.25,
         shuffle_seed=5)], ids=["sgd-val", "momentum-noshuffle", "adam"])
def test_torch_estimator_world1_equals_reference(kw, tmp_path, port_world):
    ref_est, want = _fit_torch(ref_spark, tmp_path, **kw)
    port_est, got = _fit_torch(port_spark, tmp_path, **kw)
    _assert_same_fit(got, want, _regression_df(40, seed=1))
    assert got.validation_loss == want.validation_loss
    if kw.get("validation"):
        assert got.validation_loss is not None
    # The checkpoint in the store holds the fitted weights (host copies).
    sd = torch.load(__import__("io").BytesIO(
        port_est.store.load_checkpoint(port_est.run_id)), weights_only=True)
    for k, v in _state(got.model).items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


def test_torch_estimator_legacy_store_override_equals_reference(
        tmp_path, port_world):
    """A store subclass overriding ``iter_array_batches`` with the old
    signature (no rank/size): the loop falls back to shared reads, in
    both packages alike."""
    fits, calls = {}, {}
    for pkg in (ref_spark, port_spark):
        class LegacyStore(pkg.LocalStore):
            def iter_array_batches(self, path, feature_cols, label_cols,
                                   chunk_rows=65536):
                calls.setdefault(pkg.__name__, []).append(path)
                yield from pkg.Store.iter_array_batches(
                    self, path, feature_cols, label_cols,
                    chunk_rows=chunk_rows)

        extra = {"device": "cpu"} if pkg is port_spark else {}
        fits[pkg] = pkg.TorchEstimator(
            model=_linear(), lr=0.1, epochs=4, batch_size=24,
            store=LegacyStore(str(tmp_path / pkg.__name__)),
            feature_cols=["features"], label_cols=["label"], verbose=0,
            **extra).fit(_regression_df(96))
    assert len(calls) == 2
    _assert_same_fit(fits[port_spark], fits[ref_spark], _regression_df(96))


class _DuckLightningModule:
    """The LightningModule protocol without the lightning package (the
    reference's tests/test_spark_estimators.py:446)."""

    def __init__(self):
        torch.manual_seed(3)
        self._m = torch.nn.Linear(3, 1, bias=False)

    def named_parameters(self):
        return self._m.named_parameters()

    def parameters(self):
        return self._m.parameters()

    def state_dict(self):
        return self._m.state_dict()

    def load_state_dict(self, sd):
        return self._m.load_state_dict(sd)

    def __call__(self, x):
        return self._m(x)

    def configure_optimizers(self):
        return [torch.optim.SGD(self._m.parameters(), lr=0.05)], []

    def training_step(self, batch, batch_idx):
        x, y = batch
        return {"loss": torch.nn.functional.mse_loss(self._m(x), y)}


@pytest.mark.parametrize("module", ["duck", "nn"])
def test_lightning_estimator_world1_equals_reference(module, tmp_path,
                                                     port_world):
    class NNLightning(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(4)
            self.lin = torch.nn.Linear(3, 1)

        def forward(self, x):
            return self.lin(x)

        def configure_optimizers(self):
            return torch.optim.Adam(self.parameters(), lr=0.02)

        def training_step(self, batch, batch_idx):
            x, y = batch
            return torch.nn.functional.mse_loss(self(x), y)

    fits = {}
    for pkg in (ref_spark, port_spark):
        model = _DuckLightningModule() if module == "duck" else NNLightning()
        extra = {"device": "cpu"} if pkg is port_spark else {}
        est = pkg.LightningEstimator(
            model=model, store=pkg.LocalStore(str(tmp_path / pkg.__name__)),
            epochs=5, batch_size=16, feature_cols=["features"],
            label_cols=["label"], **extra)
        fits[pkg] = est.fit(_regression_df(64))
        assert est.store.exists(est.store.get_checkpoint_path(est.run_id))
    _assert_same_fit(fits[port_spark], fits[ref_spark], _regression_df(64))


def test_keras_estimator_equals_reference(tmp_path, monkeypatch,
                                          port_world):
    tf = pytest.importorskip("tensorflow")
    import horovod_tpu.tensorflow as ref_tf
    # The suite's JAX has 8 virtual CPU devices, which the reference's
    # size() counts; its process world is 1, as the port's is here.
    monkeypatch.setattr(ref_tf, "size", lambda: 1)
    fits = {}
    for pkg in (ref_spark, port_spark):
        tf.keras.utils.set_random_seed(0)
        model = tf.keras.Sequential([tf.keras.layers.Input(shape=(3,)),
                                     tf.keras.layers.Dense(1)])
        est = pkg.KerasEstimator(
            model=model, optimizer=tf.keras.optimizers.SGD(0.05),
            loss="mse", epochs=3, batch_size=16, shuffle=False,
            store=pkg.LocalStore(str(tmp_path / pkg.__name__)),
            feature_cols=["features"], label_cols=["label"], verbose=0)
        fits[pkg] = est.fit(_regression_df(64))
        assert est.store.exists(est.store.get_checkpoint_path(est.run_id))
    for g, w in zip(fits[port_spark].model.get_weights(),
                    fits[ref_spark].model.get_weights()):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    df = _regression_df(32, seed=2)
    np.testing.assert_allclose(
        fits[port_spark].transform(df)["label__output"].values,
        fits[ref_spark].transform(df)["label__output"].values,
        rtol=1e-6, atol=1e-6)


def test_keras_estimator_rejects_inprocess_num_proc(tmp_path):
    tf = pytest.importorskip("tensorflow")
    m = tf.keras.Sequential([tf.keras.layers.Input(shape=(3,)),
                             tf.keras.layers.Dense(1)])
    est = port_spark.KerasEstimator(
        model=m, store=port_spark.LocalStore(str(tmp_path)), num_proc=4)
    with pytest.raises(ValueError, match="hvdrun|spark"):
        est.fit(_regression_df(16))


@pytest.mark.timeout(240)
def test_torch_estimator_two_ranks_equals_reference(tmp_path, capsys):
    """``num_proc=2``: two gloo ranks of the port through ``runner.run``
    against two ranks of the reference's ``_torch_fit_worker`` (through
    its ``runner.run``, on a free controller port) on the spec its fit
    builds, each rank on its own rows, within 1e-5.  The reference's own
    ``fit`` hands the model to its workers as a process argument, whose
    tensors then share one storage across the ranks (see
    ``_torch_port_spark_workers``), so its result depends on how the
    ranks' steps interleave; the port's ranks each train a copy."""
    import io
    import pickle
    import horovod_tpu.runner as ref_runner
    import _torch_port_spark_workers as SW
    df = _regression_df(128)
    kw = dict(lr=0.1, epochs=3, batch_size=16, num_proc=2,
              feature_cols=["features"], label_cols=["label"],
              validation=0.25, verbose=0)
    t0 = time.perf_counter()
    ref = ref_spark.TorchEstimator(
        model=_linear(), store=ref_spark.Store.create(
            f"file://{tmp_path / 'ref'}"), **kw)
    train_path, val_path = ref._materialize(df)
    spec = {"model": ref.model, "optimizer_fn": None, "loss_fn": None,
            "lr": ref.lr, "epochs": ref.epochs,
            "batch_size": ref.batch_size, "store": ref.store,
            "train_path": train_path, "feature_cols": ref.feature_cols,
            "label_cols": ref.label_cols,
            "shuffle_seed": ref.shuffle_seed, "prefetch": ref.prefetch}
    states = ref_runner.run(SW.ref_fit_from_bytes,
                            args=(pickle.dumps(spec),), np=2,
                            controller_port=_free_port())
    want = torch.load(io.BytesIO(next(s for s in states if s)),
                      weights_only=True)
    t1 = time.perf_counter()
    got = port_spark.TorchEstimator(
        model=_linear(), device="cpu", store=port_spark.Store.create(
            f"file://{tmp_path / 'port'}"), **kw).fit(df)
    t2 = time.perf_counter()
    gs = _state(got.model)
    assert gs.keys() == want.keys()
    for k in gs:
        np.testing.assert_allclose(gs[k], want[k].numpy(), rtol=1e-5,
                                   atol=1e-5)
    # The reference's validation loss on its fitted weights.
    ref.model.load_state_dict(want)
    xv, yv = ref._load_arrays(val_path)
    with torch.no_grad():
        ref_val = float(torch.nn.MSELoss()(ref.model(torch.from_numpy(xv)),
                                           torch.from_numpy(yv)))
    np.testing.assert_allclose(got.validation_loss, ref_val, rtol=1e-5)
    with capsys.disabled():
        print(f"\n[two-rank fits] seconds: reference {t1 - t0:.1f}, "
              f"port {t2 - t1:.1f}")


def test_fit_without_a_card_raises(tmp_path, port_world):
    """No card here and no ``device="cpu"``: ``init()`` raises, and the fit
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the fit would compute on it")
    store = port_spark.LocalStore(str(tmp_path))
    for est in (port_spark.TorchEstimator(model=_linear(), store=store,
                                          verbose=0),
                port_spark.LightningEstimator(model=_DuckLightningModule(),
                                              store=store)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            est.fit(_regression_df(16))
        assert not basics.is_initialized()


def test_fit_refuses_a_world_on_another_device(tmp_path, port_world):
    basics.init(device="cpu")
    est = port_spark.TorchEstimator(model=_linear(), device="cuda",
                                    store=port_spark.LocalStore(
                                        str(tmp_path)), verbose=0)
    with pytest.raises(ValueError, match="already computes on cpu"):
        est.fit(_regression_df(16))


def test_estimator_argument_checks_equal_reference(tmp_path):
    store = port_spark.LocalStore(str(tmp_path))
    for pkg in (ref_spark, port_spark):
        with pytest.raises(ValueError, match="store"):
            pkg.TorchEstimator(model=_linear())
        with pytest.raises(ValueError, match="model"):
            pkg.TorchEstimator(store=store)
        with pytest.raises(TypeError, match="configure_optimizers"):
            pkg.LightningEstimator(model=torch.nn.Linear(2, 1), store=store)
        with pytest.raises(ValueError, match="model"):
            pkg.KerasEstimator(store=store)
