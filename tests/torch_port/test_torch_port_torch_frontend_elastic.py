"""The torch front end's elastic state and its examples:
``horovod_tpu_torch.torch.elastic`` against ``horovod_tpu.torch.elastic``
in one process at world 1 (``TorchState`` commit, restore and sync of a
model, an optimizer and objects; ``ElasticSampler``'s shards, its
mid-epoch resume and its re-shard over 2 and 3 ranks, the world read
through each package's ``communicator_size``/``rank``), equal bit for
bit; then the ported examples at their small flags:
``elastic_pytorch_train.py`` on two gloo ranks launched by
``hvdrun-torch``, and in this process, at world 1 on the CPU,
``pytorch_synthetic_benchmark.py``, ``transformer_lm.py`` through the
hooks, with ``--overlap`` and with ``--zero-stage 3`` (the same
losses), and the TensorFlow synthetic benchmark.  The two-rank
``TorchState.sync`` and the hooks at two ranks are held in
test_torch_port_torch_frontend.py."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch.torch as hvd

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXAMPLES = os.path.join(ROOT, "examples", "torch_port")


@pytest.fixture
def both():
    import horovod_tpu
    import horovod_tpu.torch as ref
    horovod_tpu.init()
    hvd.init(device="cpu")
    yield ref, hvd
    hvd.shutdown()


def _state_run(mod, wrapped=False):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    inner = torch.optim.Adam(model.parameters(), lr=0.05)
    opt = mod.DistributedOptimizer(
        inner, named_parameters=model.named_parameters())
    state = mod.elastic.TorchState(model=model,
                                   optimizer=opt if wrapped else inner,
                                   epoch=0, batch=0)
    x = torch.linspace(-1, 1, 8).reshape(2, 4)
    seen = []
    for step in range(4):
        opt.zero_grad()
        (model(x) ** 2).sum().backward()
        opt.step()
        state.batch = step
        if step == 1:
            state.commit()
    seen += [p.detach().clone() for p in model.parameters()]
    state.restore()            # back to the commit after step 1
    seen += [p.detach().clone() for p in model.parameters()]
    seen.append(torch.tensor(state.batch))
    state.sync()
    opt.zero_grad()
    (model(x) ** 2).sum().backward()
    opt.step()
    seen += [p.detach().clone() for p in model.parameters()]
    sd = opt.state_dict()
    seen += [v for st in sd["state"].values() for v in st.values()]
    return seen


def test_torch_state_commit_restore_sync_match_reference(both):
    """The state holds the inner optimizer in both packages, and, in the
    port, the ``DistributedOptimizer`` as the examples pass it: its
    ``load_state_dict`` reaches the inner optimizer (the reference's
    wrapper loads into itself, so its restore keeps the optimizer's
    post-failure state)."""
    ref, port = both
    want = _state_run(ref)
    for got in (_state_run(port), _state_run(port, wrapped=True)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def _sampler_run(mod, monkeypatch, size, rank, collective, basics):
    monkeypatch.setattr(collective, "communicator_size", lambda: size)
    monkeypatch.setattr(basics, "rank", lambda: rank)
    s = mod.elastic.ElasticSampler(list(range(23)), shuffle=True, seed=5)
    s.set_epoch(2)
    first = list(iter(s))
    s.record_batch(0, 3)
    s.record_batch(1, 3)
    sd = s.state_dict()
    resumed = mod.elastic.ElasticSampler(list(range(23)), shuffle=True,
                                         seed=5)
    resumed.load_state_dict(sd)
    return first, sd, list(iter(resumed)), len(resumed)


@pytest.mark.parametrize("size,rank", [(1, 0), (2, 1), (3, 2)])
def test_elastic_sampler_matches_reference(both, monkeypatch, size, rank):
    import horovod_tpu.core.basics as ref_basics
    import horovod_tpu.ops.collective as ref_collective
    import horovod_tpu_torch.core.basics as port_basics
    import horovod_tpu_torch.ops.collective as port_collective
    want = _sampler_run(both[0], monkeypatch, size, rank, ref_collective,
                        ref_basics)
    got = _sampler_run(both[1], monkeypatch, size, rank, port_collective,
                       port_basics)
    assert got == want
    assert got[2] and not set(got[2]) & set(got[1]["processed_indices"]) \
        or size == 1


def _run_example(monkeypatch, capsys, script, *args):
    """``script`` run as ``__main__`` in this process, in a slot pinned to
    the CPU as ``hvdrun-torch --worker-platform cpu`` pins one (each
    example inits and shuts down its own world): its output."""
    import runpy
    monkeypatch.setenv("HVD_TPU_WORKER_PLATFORM", "cpu")
    path = os.path.join(EXAMPLES, script)
    monkeypatch.setattr(sys, "argv", [path, *args])
    capsys.readouterr()
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.timeout(240)
def test_elastic_example_runs_under_hvdrun_torch():
    """The one launch of this file: two gloo ranks under ``hvdrun-torch``
    with the controller attached."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_port_pool as pool
    ctl, rdv = pool.free_ports(2)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--worker-platform", "cpu", "--controller-port", str(ctl),
         "--rendezvous-port", str(rdv), sys.executable,
         os.path.join(EXAMPLES, "elastic_pytorch_train.py"), "--epochs",
         "2"], cwd=ROOT, capture_output=True, text=True, timeout=200)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    losses = [float(x) for x in re.findall(
        r"epoch \d: loss ([0-9.]+) \(world size 2\)", proc.stdout)]
    assert len(losses) == 2 and losses[1] < losses[0], proc.stdout


@pytest.mark.timeout(120)
def test_synthetic_benchmark_example_runs_under_hvdrun_torch(monkeypatch,
                                                             capsys):
    out = _run_example(monkeypatch, capsys, "pytorch_synthetic_benchmark.py",
                       "--num-iters", "1", "--num-batches-per-iter", "2",
                       "--image-size", "32", "--batch-size", "8")
    assert re.search(r"total img/sec on 1 worker\(s\): [0-9.]+", out), out


def _lm_losses(out):
    return [float(x) for x in re.findall(r"step \d+: loss ([0-9.]+)", out)]


LM_FLAGS = ("--layers", "2", "--d-model", "32", "--seq", "16", "--batch",
            "2", "--steps", "3")


@pytest.mark.timeout(120)
def test_transformer_lm_example_paths_give_the_same_losses(monkeypatch,
                                                           capsys):
    """The front end's hooks, the bucketed ``--overlap`` and
    ``--zero-stage 3``: the same losses."""
    hooks = _lm_losses(_run_example(monkeypatch, capsys, "transformer_lm.py",
                                    *LM_FLAGS))
    assert len(hooks) == 3 and all(np.isfinite(hooks))
    for flags in (("--overlap",), ("--zero-stage", "3")):
        got = _lm_losses(_run_example(monkeypatch, capsys,
                                      "transformer_lm.py", *LM_FLAGS,
                                      *flags))
        assert got == hooks, flags


@pytest.mark.timeout(120)
def test_tensorflow_synthetic_benchmark_example_runs(monkeypatch, capsys):
    """TensorFlow runs on the CPU only: the slot is pinned to it."""
    pytest.importorskip("tensorflow")
    out = _run_example(monkeypatch, capsys,
                       "tensorflow2_synthetic_benchmark.py", "--num-iters",
                       "1", "--num-batches-per-iter", "1",
                       "--num-warmup-batches", "1", "--image-size", "16",
                       "--batch-size", "4")
    assert re.search(r"total img/sec on 1 worker\(s\): [0-9.]+", out), out
