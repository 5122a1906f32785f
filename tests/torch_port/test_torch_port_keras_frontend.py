"""``horovod_tpu_torch.keras`` against ``horovod_tpu.keras`` on the same
inputs, in one process at world 1 (a gloo world on the CPU for the
port): a model fitted under the callbacks (broadcast, metric average,
learning-rate warm-up and schedule, the port's metrics callback) with
``DistributedOptimizer``, the Keras elastic state (commit, restore,
sync), the commit and epoch callbacks, and Adasum's delta optimizer at
one rank against the plain optimizer — weights, logs and learning rates
equal bit for bit.  ``horovod_tpu_torch.tensorflow.keras`` is the same
module surface."""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu_torch.keras as hvd_keras  # noqa: E402


@pytest.fixture
def both(monkeypatch):
    """The reference at one process: the suite's JAX has 8 virtual CPU
    devices, which the reference's ``size()`` counts, and its callbacks
    read ``size()`` from ``horovod_tpu.tensorflow``, pinned to the port's
    world of 1 here."""
    import horovod_tpu
    import horovod_tpu.keras as ref
    import horovod_tpu.tensorflow as ref_tf
    horovod_tpu.init()
    monkeypatch.setattr(ref_tf, "size", lambda: 1)
    hvd_keras.init(device="cpu")
    yield ref, hvd_keras
    hvd_keras.shutdown()


def _model(seed=0):
    rng = np.random.default_rng(seed)
    m = tf.keras.Sequential([tf.keras.Input(shape=(3,)),
                             tf.keras.layers.Dense(4, activation="tanh"),
                             tf.keras.layers.Dense(2)])
    m.set_weights([rng.standard_normal(w.shape).astype(np.float32)
                   for w in m.get_weights()])
    return m


def _fit(mod):
    from importlib import import_module
    cbs = import_module(mod.__name__ + ".callbacks")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    y = rng.standard_normal((16, 2)).astype(np.float32)
    model = _model()
    model.compile(optimizer=mod.DistributedOptimizer(
        tf.keras.optimizers.SGD(0.1, momentum=0.5)), loss="mse")
    lrs = []

    class Record(tf.keras.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            lrs.append(float(np.asarray(self.model.optimizer.learning_rate)))

    hist = model.fit(x, y, epochs=3, batch_size=4, verbose=0, shuffle=False,
                     callbacks=[
                         cbs.BroadcastGlobalVariablesCallback(0),
                         cbs.MetricAverageCallback(),
                         cbs.LearningRateWarmupCallback(initial_lr=0.1,
                                                        warmup_epochs=2),
                         cbs.LearningRateScheduleCallback(
                             initial_lr=0.1, multiplier=0.5, start_epoch=2),
                         cbs.MetricsCallback(),
                         Record()])
    return [np.asarray(w) for w in model.get_weights()], \
        hist.history["loss"], lrs


def test_fit_under_the_callbacks_matches_reference(both):
    ref, port = both
    w_ref, loss_ref, lr_ref = _fit(ref)
    w_port, loss_port, lr_port = _fit(port)
    assert loss_port == loss_ref and lr_port == lr_ref
    for a, b in zip(w_port, w_ref):
        np.testing.assert_array_equal(a, b)


def test_keras_state_commit_restore_sync_match_reference(both):
    outs = []
    for mod in both:
        m = _model(2)
        opt = tf.keras.optimizers.SGD(0.1, momentum=0.9)
        m.compile(optimizer=opt, loss="mse")
        m.fit(np.ones((4, 3), np.float32), np.zeros((4, 2), np.float32),
              epochs=1, verbose=0)
        state = mod.elastic.KerasState(m, opt, epoch=0, batch=0)
        w0 = [np.array(w) for w in m.get_weights()]
        m.set_weights([w + 1.0 for w in w0])
        for v in opt.variables:
            v.assign(v + tf.ones_like(v))
        state.epoch = 5
        state.restore()
        got = [np.asarray(w) for w in m.get_weights()] + \
            [np.asarray(v) for v in opt.variables] + [np.int64(state.epoch)]
        state.sync()
        got += [np.asarray(w) for w in m.get_weights()]
        outs.append(got)
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(a, b)


def test_commit_and_epoch_callbacks_match_reference(both):
    counts = []
    for mod in both:
        class FakeState:
            commits, epoch = 0, 0

            def commit(self):
                self.commits += 1

        st = FakeState()
        cb = mod.elastic.CommitStateCallback(st, batches_per_commit=2)
        for b in range(7):
            cb.on_batch_end(b)
        ecb = mod.elastic.UpdateEpochStateCallback(st)
        ecb.on_epoch_begin(4)
        begin = st.epoch
        ecb.on_epoch_end(4)
        counts.append((st.commits, begin, st.epoch))
    assert counts[1] == counts[0] == (3, 4, 5)


def test_adasum_delta_at_one_rank_is_the_plain_optimizer(both):
    """At one rank Adasum's combined delta is the local delta: the wrapped
    optimizer's weights equal the unwrapped one's, in both packages."""
    outs = []
    for wrap in (None,) + tuple(both):
        rng = np.random.default_rng(4)
        w = tf.Variable(rng.standard_normal((3, 2)).astype(np.float32))
        inner = tf.keras.optimizers.Adam(0.05)
        opt = inner if wrap is None else \
            wrap.DistributedOptimizer(inner, op=wrap.Adasum)
        for _ in range(3):
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(tf.square(w - 1.0))
            opt.apply_gradients([(tape.gradient(loss, w), w)])
        outs.append(w.numpy())
    np.testing.assert_array_equal(outs[2], outs[1])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)


def test_tensorflow_keras_alias_and_public_names(both):
    ref, port = both
    import horovod_tpu_torch.tensorflow.keras as alias
    assert alias.DistributedOptimizer is port.DistributedOptimizer
    assert alias.callbacks is port.callbacks
    names = [n for n in dir(ref) if not n.startswith("_")
             and n not in ("np", "Optional", "annotations")]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
