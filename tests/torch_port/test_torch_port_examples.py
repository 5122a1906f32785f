"""The port's examples that stand for the reference's remaining ones
(``examples/torch_port/{spark_estimator,ray_executor_train,mnist,
elastic_train,zero_optimizer,bert_pretrain,long_context_attention,
serving_client}.py``), each run as ``__main__`` in this process through
``runpy`` at world 1 in a slot pinned to the CPU, as ``hvdrun-torch
--worker-platform cpu`` pins one (``HVD_TPU_WORKER_PLATFORM=cpu``), at a
small size; the ray example against the fake ``ray`` of
_torch_port_fake_ray.py.  Each must finish and print what shows it ran
through (a falling loss, ring = Ulysses, a hot swap, the ranks'
results)."""

import os
import re
import runpy
import sys

import pytest

from horovod_tpu_torch.core import basics

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(HERE)), "examples",
                        "torch_port")


@pytest.fixture
def run_example(monkeypatch, capsys):
    snapshot = dict(os.environ)

    def run(script, *args):
        monkeypatch.setenv("HVD_TPU_WORKER_PLATFORM", "cpu")
        path = os.path.join(EXAMPLES, script)
        monkeypatch.setattr(sys, "argv", [path, *args])
        capsys.readouterr()
        runpy.run_path(path, run_name="__main__")
        return capsys.readouterr().out

    yield run
    if basics.is_initialized():   # the estimator leaves its world up
        basics.shutdown()
    os.environ.clear()
    os.environ.update(snapshot)


def _floats(pattern, text):
    return [float(m) for m in re.findall(pattern, text)]


def test_spark_estimator(run_example):
    out = run_example("spark_estimator.py", "--rows", "128", "--epochs",
                      "5", "--batch", "16")
    mse = _floats(r"train MSE: ([0-9.e-]+)", out)
    assert mse and mse[0] < 0.5, out
    assert "validation loss:" in out and "checkpoint:" in out


def test_ray_executor_train(run_example, monkeypatch):
    sys.path.insert(0, HERE)
    from _torch_port_fake_ray import fake_ray_modules
    for name, module in fake_ray_modules({}).items():
        monkeypatch.setitem(sys.modules, name, module)
    out = run_example("ray_executor_train.py", "--workers", "1",
                      "--device", "cpu")
    assert "rank 0/1 on cpu: allreduce -> 1.00" in out
    assert "results: [1.0]" in out


@pytest.mark.parametrize("extra", [[], ["--overlap"]])
def test_mnist(run_example, extra):
    out = run_example("mnist.py", "--epochs", "3", "--samples", "128",
                      "--hidden", "32", *extra)
    losses = _floats(r"epoch \d+: loss ([0-9.]+)", out)
    assert len(losses) == 3 and losses[-1] < losses[0], out


def test_elastic_train(run_example):
    out = run_example("elastic_train.py", "--epochs", "3", "--size", "4")
    assert _floats(r"w0=([-0-9.]+)", out) == [-0.01, -0.02, -0.03], out


@pytest.mark.parametrize("stage", ["1", "2"])
def test_zero_optimizer(run_example, stage):
    out = run_example("zero_optimizer.py", "--steps", "10", "--hidden",
                      "16", "--stage", stage)
    assert "per-rank opt state" in out, out


def test_bert_pretrain(run_example):
    out = run_example("bert_pretrain.py", "--steps", "2", "--layers", "1",
                      "--seq-len", "32", "--d-model", "64",
                      "--batch-per-rank", "2")
    assert len(_floats(r"mlm_loss ([0-9.]+)", out)) == 2, out


def test_long_context_attention(run_example):
    out = run_example("long_context_attention.py", "--seq", "128",
                      "--heads", "2", "--head-dim", "16")
    err = _floats(r"max \|ring - ulysses\| = ([0-9.e+-]+)", out)
    assert err and err[0] < 1e-5, out


def test_serving_client(run_example):
    out = run_example("serving_client.py", "--requests", "4", "--layers",
                      "1", "--d-model", "32")
    assert "open-loop: 4/4 completed" in out, out
    assert "after hot-swap, weights step: 2" in out, out
