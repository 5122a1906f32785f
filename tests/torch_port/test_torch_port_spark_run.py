"""``horovod_tpu_torch.spark.run`` / ``run_elastic`` against the
reference's ``horovod_tpu.spark``.

Without pyspark, ``run`` refuses as the reference's does
(tests/test_integrations.py:50).  ``_resolve_slot`` gives the reference's
slots over every partition order of a few host layouts.  A fake
``pyspark`` in ``sys.modules`` runs barrier tasks as threads of this
process (``allGather`` on a barrier, ``BarrierTaskContext.get()`` per
thread, after tests/test_integrations.py:85-160's fake ray): at
``num_proc`` 1 ``run(fn, device="cpu")`` forms a real gloo world from
the task's env, and without a card and without ``device="cpu"`` the
task refuses in ``init()``; at ``num_proc`` 2 each task's env is checked
— its slot, the torch world (one ``MASTER_ADDR``/``MASTER_PORT`` for
every task, rank 0's host) and the device (``HVD_TPU_WORKER_PLATFORM``
under ``device="cpu"`` only).  Executor discovery
through the fake equals the reference's.  ``run_elastic(hosts=
[localhost:2])`` runs the elastic driver locally and returns the ranks'
results in rank order."""

import itertools
import os
import socket
import sys
import threading
import types

import pytest

import horovod_tpu.spark as ref_spark
import horovod_tpu_torch.spark as port_spark
from horovod_tpu_torch.runner.chips import _free_port
from horovod_tpu_torch.runner.hosts import HostInfo


def test_run_refuses_without_pyspark():
    for pkg in (ref_spark, port_spark):
        with pytest.raises(ImportError, match="pyspark"):
            pkg.run(lambda: None)


@pytest.mark.parametrize("hosts", [["b", "a", "b", "a"], ["a", "a", "b"],
                                   ["c", "a", "b", "a", "c"]])
def test_resolve_slot_equals_reference(hosts):
    for infos in set(itertools.permutations(hosts)):
        for pid in range(len(infos)):
            got = port_spark._resolve_slot(list(infos), pid)
            want = ref_spark._resolve_slot(list(infos), pid)
            assert got[1] == want[1]
            assert vars(got[0]) == vars(want[0])
            assert got[0].hostname == infos[pid]


class _FakeBarrier:
    """The barrier tasks of one stage: ``allGather`` waits for every task
    and returns their messages in partition order."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=30)
        self.rounds = {}
        self.lock = threading.Lock()


class _Ctx:
    def __init__(self, stage, pid):
        self.stage, self.pid, self.gathers = stage, pid, 0

    def partitionId(self):
        return self.pid

    def allGather(self, message=""):
        st, k = self.stage, self.gathers
        self.gathers += 1
        with st.lock:
            st.rounds.setdefault(k, [None] * st.n)[self.pid] = message
        st.barrier.wait()
        out = list(st.rounds[k])
        st.barrier.wait()
        return out


def _fake_pyspark(monkeypatch, parallelism=1, hostnames=None):
    """``pyspark`` and ``pyspark.sql`` with the surface ``run`` uses; each
    partition's task runs in a thread of its own, its hostname
    ``hostnames[pid]`` when given."""
    local = threading.local()
    real_hostname = socket.gethostname

    class BarrierTaskContext:
        @staticmethod
        def get():
            return local.ctx

    class _RDD:
        def __init__(self, n):
            self.n = n

        def barrier(self):
            return self

        def mapPartitions(self, f):
            self.f = f
            return self

        def collect(self):
            stage = _FakeBarrier(self.n)
            out, errors = [None] * self.n, []

            def task(pid):
                local.ctx = _Ctx(stage, pid)
                local.hostname = hostnames[pid] if hostnames else None
                try:
                    out[pid] = list(self.f(iter([pid])))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)
                    stage.barrier.abort()

            threads = [threading.Thread(target=task, args=(p,))
                       for p in range(self.n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            if errors:
                raise errors[0]
            return [v for part in out for v in part]

    class _SC:
        defaultParallelism = parallelism

        def parallelize(self, data, n):
            return _RDD(n)

    class SparkSession:
        class builder:
            @staticmethod
            def getOrCreate():
                return types.SimpleNamespace(sparkContext=_SC())

    pyspark = types.ModuleType("pyspark")
    pyspark.BarrierTaskContext = BarrierTaskContext
    sql = types.ModuleType("pyspark.sql")
    sql.SparkSession = SparkSession
    pyspark.sql = sql
    monkeypatch.setitem(sys.modules, "pyspark", pyspark)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)
    monkeypatch.setattr(socket, "gethostname", lambda: getattr(
        local, "hostname", None) or real_hostname())


@pytest.fixture
def env_snapshot():
    """Fake tasks run in this process and export their env into it."""
    snapshot = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(snapshot)


def test_run_one_task_forms_a_real_cpu_world(monkeypatch, env_snapshot):
    _fake_pyspark(monkeypatch)
    before = dict(os.environ)

    def fn(scale):
        import torch
        import horovod_tpu_torch as hvd
        hvd.init()
        out = hvd.allreduce(torch.full((2,), float(hvd.rank() + 1)),
                            op=hvd.Sum)
        got = (hvd.rank(), hvd.size(), str(hvd.device()),
               float(out[0]) * scale, os.environ["MASTER_ADDR"])
        hvd.shutdown()
        return got

    assert port_spark.run(fn, args=(10.0,), num_proc=1,
                          controller_port=_free_port(),
                          device="cpu") == \
        [(0, 1, "cpu", 10.0, "127.0.0.1")]
    # The task's env lasted its fn.
    assert {k: os.environ.get(k) for k in ("HVD_TPU_RANK", "MASTER_PORT")} \
        == {k: before.get(k) for k in ("HVD_TPU_RANK", "MASTER_PORT")}


def test_run_without_a_card_refuses_unless_asked_for_the_cpu(
        monkeypatch, env_snapshot):
    """``device=None`` computes on the card: on a machine without one the
    task's ``init()`` raises, and nothing carries on on the CPU."""
    import torch
    _fake_pyspark(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HVD_TPU_WORKER_PLATFORM", raising=False)

    def fn():
        import horovod_tpu_torch as hvd
        hvd.init()
        hvd.shutdown()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_spark.run(fn, num_proc=1, controller_port=_free_port())


def _envs(monkeypatch, n, hostnames=None, device=None):
    """Each of ``n`` barrier tasks' env, built in a thread of its own."""
    envs = [None] * n
    stage = _FakeBarrier(n)
    local_names = threading.local()
    real = socket.gethostname
    monkeypatch.setattr(socket, "gethostname", lambda: getattr(
        local_names, "name", None) or real())

    def run(pid):
        local_names.name = hostnames[pid] if hostnames else None
        envs[pid] = port_spark._task_env(_Ctx(stage, pid), 29100, device)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return envs


@pytest.mark.parametrize("device", [None, "cpu"])
def test_two_tasks_on_one_host_share_a_world(monkeypatch, device):
    """Two tasks of this host: ranks 0 and 1, one torch world on loopback
    at rank 0's free port.  ``device=None`` leaves each task on the card
    (no CPU pin, whatever cards this host has: ``init()`` raises where
    there is none); ``device="cpu"`` pins both to the CPU."""
    envs = _envs(monkeypatch, 2, device=device)
    assert sorted(int(e["HVD_TPU_RANK"]) for e in envs) == [0, 1]
    for pid, e in enumerate(envs):
        assert e["HVD_TPU_SIZE"] == e["HOROVOD_SIZE"] == "2"
        assert e["HVD_TPU_LOCAL_RANK"] == str(pid)
        assert e["HVD_TPU_LOCAL_SIZE"] == "2"
        assert e["MASTER_ADDR"] == "127.0.0.1"
        assert e["MASTER_PORT"] == envs[0]["MASTER_PORT"] != ""
        assert e["HVD_TPU_CONTROLLER_ADDR"] == \
            f"{socket.gethostname()}:29100"
        if device == "cpu":
            assert e["HVD_TPU_WORKER_PLATFORM"] == "cpu"
            assert e["CUDA_VISIBLE_DEVICES"] == ""
        else:
            assert "HVD_TPU_WORKER_PLATFORM" not in e
            assert "CUDA_VISIBLE_DEVICES" not in e
            assert "HVD_TPU_DEVICE_PARTITION" not in e


def test_tasks_on_two_hosts_name_rank0s_host(monkeypatch):
    """Partitions interleaved over two hosts, ``b`` first: each task's
    slot is the reference's for its partition, the world's address is
    rank 0's host (``a``), every task reads one port, and pinning to the
    CPU (``device="cpu"``) exports the launcher's CPU env."""
    hostnames = ["host-b", "host-a", "host-b", "host-a"]
    envs = _envs(monkeypatch, 4, hostnames, device="cpu")
    for pid, e in enumerate(envs):
        slot, ctl = ref_spark._resolve_slot(hostnames, pid)
        assert e["HVD_TPU_RANK"] == str(slot.rank)
        assert e["HVD_TPU_LOCAL_RANK"] == str(slot.local_rank)
        assert e["HVD_TPU_CROSS_RANK"] == str(slot.cross_rank)
        assert e["HVD_TPU_HOSTNAME"] == hostnames[pid]
        assert e["HVD_TPU_CONTROLLER_ADDR"] == f"{ctl}:29100"
        assert e["MASTER_ADDR"] == "host-a"
        assert e["MASTER_PORT"] == envs[1]["MASTER_PORT"] != ""
        assert e["HVD_TPU_WORKER_PLATFORM"] == "cpu"
    assert int(envs[1]["HVD_TPU_RANK"]) == 0


def test_discover_executor_hosts_equals_reference(monkeypatch):
    _fake_pyspark(monkeypatch, hostnames=["h2", "h1", "h2"])
    got = port_spark._discover_executor_hosts(3)
    want = ref_spark._discover_executor_hosts(3)
    assert [(h.hostname, h.slots) for h in got] == \
        [(h.hostname, h.slots) for h in want] == [("h1", 1), ("h2", 2)]


@pytest.mark.timeout(240)
def test_run_elastic_local(tmp_path):
    # A closure: cloudpickle ships it by value, so the spawned elastic
    # workers do not need this test module importable.
    def elastic_fn(scale):
        import torch
        import horovod_tpu_torch as hvd
        hvd.init()
        out = hvd.allreduce(torch.full((2,), float(hvd.rank() + 1)),
                            op=hvd.Sum)
        result = (hvd.rank(), float(out[0]) * scale)
        hvd.shutdown()
        return result

    results = port_spark.run_elastic(
        elastic_fn, args=(10.0,), num_proc=2, min_np=2,
        hosts=[HostInfo("localhost", 2)],
        controller_base_port=_free_port(), work_dir=str(tmp_path / "work"))
    # The sum over ranks of (rank + 1) is 3: both ranks return 30.0, in
    # rank order (each written under its own rank after its shutdown).
    assert results == [(0, 30.0), (1, 30.0)]
