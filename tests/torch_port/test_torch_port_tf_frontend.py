"""``horovod_tpu_torch.tensorflow`` against ``horovod_tpu.tensorflow`` on
the same inputs, in one process at world 1 (the reference after
``horovod_tpu.init()``, the port after ``init()``, a gloo world on the
CPU): the collectives and their gradients, eagerly and inside
``tf.function`` (the py_function bridge without a controller),
``IndexedSlices``, the tape, ``DistributedOptimizer`` (with
``backward_passes_per_step`` inside ``tf.function`` and Adasum's delta
model), ``SyncBatchNormalization``, the object calls and the elastic
states — equal bit for bit.  The custom op (its source is held to the
reference's in test_torch_port_package.py) builds into
``horovod_tpu_torch/_build/tf_ops/`` and serves graph allreduce,
broadcast, allgather and alltoall to two ranks launched by
``hvdrun-torch`` with the controller attached."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu_torch.tensorflow as hvd  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def both():
    import horovod_tpu
    import horovod_tpu.tensorflow as ref
    horovod_tpu.init()
    hvd.init(device="cpu")
    yield ref, hvd
    hvd.shutdown()


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, tf.IndexedSlices):
        return [_np(x.values), _np(x.indices)]
    return None if x is None else np.asarray(x)


def _equal(got, want, path="out"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


DTYPES = [tf.uint8, tf.int8, tf.int32, tf.int64, tf.float16, tf.float32,
          tf.float64, tf.bfloat16]


def _collectives(mod):
    out = {}
    t = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    out["sum"] = mod.allreduce(t, op=mod.Sum)
    out["avg"] = mod.allreduce(t, op=mod.Average, prescale_factor=0.5,
                               postscale_factor=3.0)
    out["gather"] = mod.allgather(t)
    out["bcast"] = mod.broadcast(t, root_rank=0)
    out["a2a"] = list(mod.alltoall(tf.constant([1.0, 2.0, 3.0, 4.0])))
    out["a2a_splits"] = list(mod.alltoall(tf.constant([[1], [2], [3]]),
                                          splits=[3]))
    out["slices"] = mod.allreduce(tf.IndexedSlices(
        values=tf.constant([[1.0, 2.0]]), indices=tf.constant([1]),
        dense_shape=tf.constant([3, 2])), op=mod.Average, name="sl")
    for dt in DTYPES:
        x = tf.cast(tf.reshape(tf.range(12), (3, 4)), dt)
        out[f"dtype-{dt.name}"] = mod.allreduce(x, op=mod.Sum)
    out["int-scaled"] = mod.allreduce(tf.constant([3, 5, 7]), op=mod.Sum,
                                      prescale_factor=0.5)
    out["scalar"] = [mod.allreduce(tf.constant(2.5)),
                     mod.broadcast(tf.constant(7), root_rank=0),
                     mod.allgather(tf.constant(1.5))]
    out["grouped"] = mod.grouped_allreduce(
        [tf.constant([1.0, 2.0]), tf.constant([3])], op=mod.Sum)
    out["fp16"] = mod.allreduce(tf.constant([1.0001, 2.0]),
                                compression=mod.Compression.fp16)
    out["bf16"] = mod.allreduce(tf.constant([1.0001, 2.0]),
                                compression=mod.Compression.bf16)
    out["join"] = np.int64(mod.join())
    mod.barrier()
    obj = {"epoch": 3, "names": ["a", "b"]}
    assert mod.broadcast_object(obj, root_rank=0) == obj
    assert mod.allgather_object(obj) == [obj]
    assert mod.broadcast_object_fn(root_rank=0)(obj) == obj
    v = tf.Variable([1.0, 2.0])
    mod.broadcast_variables([v], root_rank=0)
    out["bv"] = v
    return {k: _np(v) for k, v in out.items()}


def test_collectives_match_reference(both):
    ref, port = both
    _equal(_collectives(port), _collectives(ref))


def _gradients(mod):
    out = {}
    x = tf.Variable([[1.0, 2.0], [3.0, 4.0]])
    for name, f in (
            ("allreduce", lambda: tf.reduce_sum(
                mod.allreduce(x, op=mod.Sum) ** 2)),
            ("allgather", lambda: tf.reduce_sum(mod.allgather(x) ** 2)),
            ("broadcast", lambda: tf.reduce_sum(3.0 * mod.broadcast(x, 0))),
            ("alltoall", lambda: tf.reduce_sum(
                5.0 * mod.alltoall(tf.reshape(x, [-1]))[0]))):
        with tf.GradientTape() as tape:
            y = f()
        out[name] = tape.gradient(y, x)
    s = tf.Variable(3.0)
    with tf.GradientTape() as tape:
        y = 2.0 * tf.reduce_sum(mod.allgather(s))
    out["scalar-allgather"] = tape.gradient(y, s)

    @tf.function
    def graph(v):
        with tf.GradientTape() as tape:
            tape.watch(v)
            a = tf.reduce_sum(mod.allreduce(v, op=mod.Sum) ** 2)
            b = tf.reduce_sum(5.0 * mod.alltoall(v)[0])
            c = tf.reduce_sum(mod.allgather(v) * 2.0)
            d = tf.reduce_sum(mod.broadcast(v, 0))
        return tape.gradient(a + b + c + d, v)

    out["graph"] = graph(tf.constant([1.0, -2.0]))
    return {k: _np(v) for k, v in out.items()}


def test_gradients_match_reference(both):
    ref, port = both
    _equal(_gradients(port), _gradients(ref))


def _tape(mod):
    w = tf.Variable([[2.0, -1.0]])
    emb = tf.Variable(np.arange(12, dtype=np.float32).reshape(4, 3))
    out = {}
    for dense in (False, True):
        with mod.DistributedGradientTape(tf.GradientTape(),
                                         sparse_as_dense=dense) as tape:
            loss = tf.reduce_sum(w * w) + tf.reduce_sum(
                tf.gather(emb, [1, 3]) ** 2)
        out[f"dense-{dense}"] = tape.gradient(loss, [w, emb])
    with mod.DistributedGradientTape(
            tf.GradientTape(), compression=mod.Compression.fp16) as tape:
        loss = tf.reduce_sum(w * w)
    out["fp16"] = tape.gradient(loss, [w])
    return {k: _np(v) for k, v in out.items()}


def test_tape_matches_reference(both):
    ref, port = both
    _equal(_tape(port), _tape(ref))


def _optimizer(mod, kind, bpps=1, op=None, comp=None):
    rng = np.random.default_rng(5)
    w = tf.Variable(rng.standard_normal((4, 3)).astype(np.float32))
    b = tf.Variable(rng.standard_normal(3).astype(np.float32))
    xs = rng.standard_normal((3 * bpps, 6, 4)).astype(np.float32)
    inner = tf.keras.optimizers.SGD(0.1, momentum=0.9) if kind == "sgd" \
        else tf.keras.optimizers.Adam(0.01)
    kw = dict(backward_passes_per_step=bpps, compression=comp)
    if op is not None:
        kw["op"] = op
    opt = mod.DistributedOptimizer(inner, **kw)

    @tf.function
    def step(x):
        with tf.GradientTape() as tape:
            loss = tf.reduce_mean(tf.square(x @ w + b))
        opt.apply_gradients(zip(tape.gradient(loss, [w, b]), [w, b]))

    for x in xs:
        step(tf.constant(x))
    return [w.numpy(), b.numpy()]


OPT_CASES = {"sgd": dict(kind="sgd"), "adam": dict(kind="adam"),
             "sgd-bpps2": dict(kind="sgd", bpps=2),
             "adam-bpps2": dict(kind="adam", bpps=2),
             "sgd-fp16": dict(kind="sgd", comp="fp16"),
             "adam-adasum": dict(kind="adam", op="Adasum")}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_distributed_optimizer_matches_reference(both, case):
    """Three applied steps inside tf.function (six passes at
    backward_passes_per_step=2), the weights equal bit for bit."""
    outs = []
    for mod in both:
        kw = dict(OPT_CASES[case])
        if kw.get("op"):
            kw["op"] = getattr(mod, kw["op"])
        if kw.get("comp"):
            kw["comp"] = getattr(mod.Compression, kw["comp"])
        outs.append(_optimizer(mod, **kw))
    _equal(outs[1], outs[0])


def test_sync_batch_norm_matches_reference(both):
    outs = []
    x = tf.constant(np.random.default_rng(3).standard_normal(
        (6, 3)).astype(np.float32))
    for mod in both:
        layer = mod.SyncBatchNormalization()
        outs.append([layer(x, training=True).numpy(),
                     layer.moving_mean.numpy(),
                     layer.moving_variance.numpy()])
    _equal(outs[1], outs[0])


def test_elastic_states_match_reference(both):
    outs = []
    for mod in both:
        v = tf.Variable([1.0, 2.0])
        state = mod.elastic.TensorFlowState([v], epoch=1)
        v.assign([5.0, 6.0])
        state.epoch = 4
        state.restore()
        got = [v.numpy(), np.int64(state.epoch)]
        v.assign([7.0, 8.0])
        state.epoch = 2
        state.commit()
        state.sync()
        v.assign([0.0, 0.0])
        state.restore()
        got += [v.numpy(), np.int64(state.epoch)]
        outs.append(got)
    _equal(outs[1], outs[0])


# ---------------------------------------------------------------------------
# the compiled custom op
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
def test_custom_op_builds_into_the_port_build_dir(monkeypatch):
    # The loader points HVD_TPU_NATIVE_LIB at the port's runtime; the
    # reference's loader (and the workers it launches), later in this
    # process, must not inherit it: set here, so the teardown restores it.
    monkeypatch.setenv("HVD_TPU_NATIVE_LIB", "")
    so = hvd.build_custom_ops()
    assert os.path.dirname(so) == os.path.join(
        ROOT, "horovod_tpu_torch", "_build", "tf_ops")
    assert hvd.build_custom_ops() == so          # current: not built again
    lib = hvd._load_custom_ops()
    for op in ("allreduce", "broadcast", "allgather", "alltoall", "size",
               "rank", "local_rank", "local_size"):
        assert hasattr(lib, f"hvd_tpu_torch_{op}"), op
    assert os.environ["HVD_TPU_NATIVE_LIB"].startswith(os.path.join(
        ROOT, "horovod_tpu_torch", "_build", "native"))
    ops_dir = os.path.dirname(hvd.OPS_SRC)
    assert sorted(os.listdir(ops_dir)) == ["hvd_tf_ops.cc"]


def test_query_ops_read_the_live_env(both, monkeypatch):
    for k, v in {"HVD_TPU_LOCAL_RANK": "3", "HVD_TPU_LOCAL_SIZE": "4",
                 "HVD_TPU_RANK": "7", "HVD_TPU_SIZE": "8"}.items():
        monkeypatch.setenv(k, v)
    assert int(hvd.local_rank_op()) == 3
    assert int(hvd.local_size_op()) == 4
    assert int(hvd.size_op()) == 8
    assert int(hvd.rank_op()) == 7

    @tf.function
    def f():
        return hvd.size_op() + hvd.rank_op()

    assert int(f()) == 15


GRAPH_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import tensorflow as tf
    import horovod_tpu_torch.tensorflow as hvd

    hvd.init()
    rank, size = hvd.rank(), hvd.size()

    @tf.function(input_signature=[tf.TensorSpec((4,), tf.float32)])
    def reduced(x):
        return hvd.allreduce(x, op=hvd.Sum, name="g.sum")

    ops = {{op.type for op in
           reduced.get_concrete_function().graph.get_operations()}}
    out = reduced(tf.fill((4,), float(rank + 1)))
    assert np.allclose(out.numpy(), 3.0), out.numpy()

    @tf.function(input_signature=[tf.TensorSpec((3,), tf.float32)])
    def bcasted(x):
        return hvd.broadcast(x, root_rank=1, name="g.bc")

    assert np.allclose(bcasted(tf.fill((3,), float(rank * 10))).numpy(),
                       10.0)

    @tf.function
    def gathered(x):
        return hvd.allgather(x, name="g.ag")

    g = gathered(tf.fill((rank + 1, 2), float(rank))).numpy()
    assert g.shape == (3, 2) and (g[0] == 0).all() and (g[1:] == 1).all()

    @tf.function
    def exchanged(x):
        return hvd.alltoall(x, name="g.a2a")

    vals = tf.constant([[float(rank * size + d)] for d in range(size)])
    got, recv = exchanged(vals)
    assert recv.numpy().tolist() == [1, 1]
    assert np.allclose(got.numpy().ravel(),
                       [float(s * size + rank) for s in range(size)])
    assert int(hvd.size_op()) == 2 and int(hvd.rank_op()) == rank
    with open({out!r} + f".{{rank}}", "w") as f:
        json.dump({{"custom_op": "HvdTpuTorchAllreduce" in ops,
                    "py_function": any("PyFunc" in t for t in ops)}}, f)
    hvd.shutdown()
""")


@pytest.mark.timeout(240)
def test_graph_collectives_take_the_custom_op(tmp_path):
    """Two ranks under ``hvdrun-torch`` (gloo, the controller attached):
    collectives inside ``tf.function`` lower to the compiled op, not to
    py_function, and give the cross-rank results."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_port_pool as pool
    hvd.build_custom_ops()       # once, before the ranks start
    out = str(tmp_path / "res")
    script = tmp_path / "worker.py"
    script.write_text(GRAPH_WORKER.format(root=ROOT, out=out))
    port, rdv = pool.free_ports(2)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--worker-platform", "cpu", "--controller-port", str(port),
         "--rendezvous-port", str(rdv), sys.executable, str(script)],
        cwd=ROOT, capture_output=True, text=True, timeout=220)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in range(2):
        with open(f"{out}.{r}") as f:
            res = json.load(f)
        assert res == {"custom_op": True, "py_function": False}, res
