"""``horovod_tpu_torch.mxnet`` against ``horovod_tpu.mxnet`` on the same
NDArrays, at world 1 in this process.  mxnet is installed nowhere: both
packages run against the in-test fake of the NDArray and Gluon surface
that tests/test_mxnet_frontend.py uses, copied here.  The collectives'
values, dtypes and contexts, ``broadcast_parameters`` (and its refusal
of a list), ``DistributedOptimizer``'s delegation and
``DistributedTrainer``'s scale agree."""

import sys
import types

import numpy as np
import pytest


class FakeNDArray:
    def __init__(self, arr, ctx="cpu(0)", dtype=None):
        self._arr = np.array(arr, dtype=dtype or np.asarray(arr).dtype)
        self.context = ctx
        self.dtype = self._arr.dtype

    def asnumpy(self):
        return self._arr.copy()

    def copyto(self, other):
        other._arr[...] = self._arr
        return other

    def __array__(self, dtype=None):
        return self._arr if dtype is None else self._arr.astype(dtype)


class FakeParameter:
    def __init__(self, arr, grad=None, grad_req="write"):
        self._data = FakeNDArray(arr)
        self._grad = FakeNDArray(grad if grad is not None
                                 else np.zeros_like(np.asarray(arr)))
        self.grad_req = grad_req

    def data(self):
        return self._data

    def list_grad(self):
        return [self._grad]


@pytest.fixture()
def fake_mxnet(monkeypatch):
    mx = types.ModuleType("mxnet")
    nd = types.ModuleType("mxnet.nd")

    def array(a, ctx=None, dtype=None):
        return FakeNDArray(a, ctx=ctx or "cpu(0)", dtype=dtype)

    nd.array = array
    mx.nd = nd

    gluon = types.ModuleType("mxnet.gluon")

    class Trainer:
        def __init__(self, params, optimizer, optimizer_params=None,
                     kvstore=None):
            self._params = list(params.values()) \
                if hasattr(params, "values") else list(params)
            self._optimizer = optimizer
            self._scale = (optimizer_params or {}).get("rescale_grad", 1.0)

        def step(self, batch_size):
            self._allreduce_grads()

        def _allreduce_grads(self):
            pass

    gluon.Trainer = Trainer
    mx.gluon = gluon
    monkeypatch.setitem(sys.modules, "mxnet", mx)
    monkeypatch.setitem(sys.modules, "mxnet.nd", nd)
    monkeypatch.setitem(sys.modules, "mxnet.gluon", gluon)
    return mx



@pytest.fixture
def both(fake_mxnet):
    import horovod_tpu
    import horovod_tpu.mxnet as ref
    import horovod_tpu_torch.mxnet as port
    horovod_tpu.init()
    port.init(device="cpu")
    yield ref, port
    port.shutdown()


def test_import_without_mxnet_is_gated(monkeypatch):
    import horovod_tpu_torch.mxnet as port
    monkeypatch.setitem(sys.modules, "mxnet", None)
    with pytest.raises(ImportError, match="mxnet"):
        port._mx()


def _collectives(hvd):
    t = FakeNDArray(np.arange(6, dtype=np.float32).reshape(2, 3))
    out = {"sum": hvd.allreduce(t, average=False),
           "avg": hvd.allreduce(t, op=hvd.Average),
           "scaled": hvd.allreduce(t, op=hvd.Sum, prescale_factor=0.5,
                                   postscale_factor=4.0),
           "int": hvd.allreduce(FakeNDArray(np.arange(4, dtype=np.int64)),
                                average=False),
           "f64": hvd.allreduce(FakeNDArray(np.ones(3) / 3.0)),
           "gather": hvd.allgather(t),
           "bcast": hvd.broadcast(t, root_rank=0)}
    t2 = FakeNDArray(np.full((2, 3), 2.0, np.float32))
    assert hvd.broadcast_(t2, root_rank=0) is t2
    out["bcast_"] = t2
    for i, o in enumerate(hvd.grouped_allreduce([t, t2], average=False)):
        out[f"grouped{i}"] = o
    t3 = FakeNDArray(np.ones((4,), np.float32) * 3)
    assert hvd.allreduce_(t3, average=True) is t3
    out["allreduce_"] = t3
    got, splits = hvd.alltoall(FakeNDArray(np.arange(4, dtype=np.float32)))
    out["a2a"] = got
    assert np.asarray(splits).tolist() == [4]
    assert hvd.join() == 0
    hvd.barrier()
    return out


def test_collectives_match_reference(both):
    ref, port = both
    want, got = _collectives(ref), _collectives(port)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].context == want[k].context, k
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy(),
                                      err_msg=k)


def test_broadcast_parameters_match_reference(both):
    outs = []
    for hvd in both:
        params = {"w": FakeParameter(np.ones((2, 2))),
                  "b": FakeNDArray(np.arange(2.0))}
        hvd.broadcast_parameters(params, root_rank=0)
        outs.append([params["w"].data().asnumpy(), params["b"].asnumpy()])
        with pytest.raises(ValueError):
            hvd.broadcast_parameters([1, 2, 3])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_distributed_optimizer_delegates_as_the_reference(both):
    logs = []
    for hvd in both:
        calls = []

        class Opt:
            def update(self, index, weight, grad, state):
                calls.append(("update", index, grad.asnumpy().tolist()))

            def update_multi_precision(self, index, weight, grad, state):
                calls.append(("ump", index, [g.asnumpy().tolist()
                                             for g in grad]))

            def set_learning_rate(self, lr):
                calls.append(("lr", lr))

            def set_lr_mult(self, m):
                calls.append(("lr_mult", m))

            def set_wd_mult(self, m):
                calls.append(("wd_mult", m))

        opt = hvd.DistributedOptimizer(Opt(), gradient_predivide_factor=2.0)
        g = FakeNDArray(np.ones(3, np.float32))
        w = FakeNDArray(np.zeros(3, np.float32))
        opt.update(0, w, g, None)
        opt.update_multi_precision([1, 2], [w, w], [g, g], None)
        opt.set_learning_rate(0.5)
        opt.set_lr_mult({"a": 2.0})
        opt.set_wd_mult({"a": 0.0})
        logs.append(calls)
    assert logs[1] == logs[0]


def test_distributed_trainer_matches_reference(both):
    scales = []
    for hvd in both:
        params = {"w": FakeParameter(np.ones((2, 2)),
                                     grad=np.full((2, 2), 4.0))}
        trainer = hvd.DistributedTrainer(params, "sgd",
                                         {"rescale_grad": 1.0})
        trainer.step(1)
        scales.append((trainer._scale,
                       params["w"].list_grad()[0].asnumpy().tolist()))
        with pytest.raises(ValueError):
            hvd.DistributedTrainer(params,
                                   hvd.DistributedOptimizer(object()), {})
    # The reference counts the suite's 8 virtual JAX devices in size();
    # the port's world is one process.
    assert scales[1] == (1.0, [[4.0, 4.0], [4.0, 4.0]])
    assert scales[0][1] == scales[1][1]
