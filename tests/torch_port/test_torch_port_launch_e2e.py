"""The port's launcher end to end on this machine's CPU, held to the
reference tests' expected values: ``main()`` with two CPU slots
(tests/test_runner.py:90-125) and its fail-fast case (:175-185), and
``runner.run(fn)`` locally and through the launcher's machinery
(``hosts=``) with its failure propagation (:208-272).  Each launch
starts at most two ranks, pinned to the CPU by ``--worker-platform cpu``
(``worker_platform="cpu"``)."""

import json
import os
import sys

import pytest

from horovod_tpu_torch.runner import run
from horovod_tpu_torch.runner.chips import _free_port
from horovod_tpu_torch.runner.launch import main

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _torch_port_launch_workers as workers  # noqa: E402

WORKERS = os.path.join(HERE, "_torch_port_launch_workers.py")


@pytest.mark.timeout(240)
def test_static_launch_two_cpu_slots(tmp_path, capfd):
    outfile = str(tmp_path / "result")
    rc = main(["-np", "2", "--worker-platform", "cpu", "-v",
               "--controller-port", str(_free_port()),
               sys.executable, WORKERS, "static",
               json.dumps({"outfile": outfile})])
    assert rc == 0
    results = [json.load(open(f"{outfile}.{r}")) for r in range(2)]
    for r, data in enumerate(results):
        assert (data["rank"], data["size"], data["sum"], data["device"]) \
            == (r, 2, 3.0, "cpu")
        assert data["secret_present"]
    # One world: both ranks read the launcher's store port.
    assert results[0]["master_port"] == results[1]["master_port"]
    assert "rank(s) [0, 1] pinned to the CPU (--worker-platform cpu)" in \
        capfd.readouterr().err


@pytest.mark.timeout(120)
def test_static_launch_forms_a_second_world_in_one_process(tmp_path):
    """init, allreduce, shutdown, twice in each launched worker, rank 0
    taking its first world's store down 2 s after rank 1 has left it: the
    second world must not read the first one's addresses (it hung in
    gloo's pair setup when both worlds shared the store's keys)."""
    outfile = str(tmp_path / "result")
    rc = main(["-np", "2", "--worker-platform", "cpu",
               "--controller-port", str(_free_port()),
               sys.executable, WORKERS, "reinit",
               json.dumps({"outfile": outfile, "delay_s": 2.0})])
    assert rc == 0
    for r in range(2):
        assert json.load(open(f"{outfile}.{r}")) == \
            {"rank": r, "sums": [3.0, 3.0]}


def test_static_world_counts_only_the_worlds_that_formed(monkeypatch):
    """A world whose ``init_process_group`` failed is not counted: the
    retry forms under the prefix its peers wait under (``world1/``), and
    the next world after it under ``world2/``.  One store serves every
    world of the process, whatever their sizes."""
    import torch.distributed as dist
    from horovod_tpu_torch.core import basics
    base, made, prefixes = dist.HashStore(), [], []
    monkeypatch.setattr(basics, "_static_stores", {})
    monkeypatch.setattr(dist, "TCPStore",
                        lambda *a, **kw: made.append(a) or base)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    fail = [True]

    def init_process_group(backend, rank, world_size, store):
        store.set("k", str(world_size))
        seen = [p for p in ("world1/", "world2/")
                if dist.PrefixStore(p, base).check(["k"])]
        prefixes.append(seen[-1])
        dist.PrefixStore(seen[-1], base).delete_key("k")
        if fail.pop() if fail else False:
            raise RuntimeError("store timeout")

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    with pytest.raises(RuntimeError, match="store timeout"):
        basics._form_static_world("gloo", 0, 2)
    basics._form_static_world("gloo", 0, 2)
    basics._form_static_world("gloo", 0, 3)
    assert prefixes == ["world1/", "world1/", "world2/"]
    assert len(made) == 1


@pytest.mark.timeout(120)
def test_static_launch_failfast(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['HVD_TPU_RANK'] == '1':\n"
                      "    sys.exit(3)\n"
                      "time.sleep(60)\n")
    rc = main(["-np", "2", "--worker-platform", "cpu",
               "--controller-port", str(_free_port()),
               sys.executable, str(script)])
    assert rc == 3


@pytest.mark.timeout(240)
def test_run_api_two_ranks():
    results = run(workers.rank_sum_fn, args=(1.0,), np=2,
                  controller_port=_free_port(), worker_platform="cpu")
    # ranks 0,1 with base 1 -> 1+2 = 3 on both
    assert results == [(3.0, 0, 2, "cpu"), (3.0, 1, 2, "cpu")]


@pytest.mark.timeout(120)
def test_run_api_propagates_failure():
    with pytest.raises(RuntimeError, match="failed"):
        run(workers.failing_fn, np=1, controller_port=_free_port(),
            worker_platform="cpu")


@pytest.mark.timeout(240)
def test_run_api_with_hosts(tmp_path):
    """run(fn, hosts=...) goes through fn_exec and the launcher's
    machinery and returns rank-ordered results; a failing fn fails the
    run."""
    def fn(base):   # a closure: cloudpickle ships it by value
        import torch
        import horovod_tpu_torch as hvd
        torch.set_num_threads(1)
        hvd.init()
        out = hvd.allreduce(torch.tensor([float(hvd.rank() + base)]),
                            op=hvd.Sum, name="runfn")
        result = (float(out[0]), hvd.rank(), hvd.size(), hvd.device().type)
        hvd.shutdown()
        return result

    results = run(fn, args=(10.0,), np=2,
                  hosts="localhost:2", controller_port=_free_port(),
                  work_dir=str(tmp_path / "wd"), worker_platform="cpu")
    assert results == [(21.0, 0, 2, "cpu"), (21.0, 1, 2, "cpu")]
    def boom():
        raise RuntimeError("worker boom")

    with pytest.raises(RuntimeError, match="failed"):
        run(boom, np=1, hosts="localhost:1",
            controller_port=_free_port(), worker_platform="cpu")
