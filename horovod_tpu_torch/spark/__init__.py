"""Spark integration — run a training function on Spark executors as ranks
(port of horovod_tpu/spark/).

Capability parity with the reference horovod.spark (spark/runner.py):

* ``run(fn, ...)`` (reference runner.py:47-156) — one barrier-mode task per
  executor registers its hostname, ranks are assigned host-major, the
  launcher env is injected, and ``fn`` runs inside each task.
* ``run_elastic(fn, ...)`` (reference runner.py:306) — elastic variant:
  executor hosts feed the elastic driver, workers are (re)spawned across
  rendezvous rounds, and per-rank results are collected from the round
  that completes.
* Estimator API (store.py ``Store``/``LocalStore``, estimator.py
  ``KerasEstimator``/``TorchEstimator``/``LightningEstimator``).

A task's env is the launcher's for its slot: ``slot_env``, the torch
world that ``init()`` forms through ``env://`` (``MASTER_ADDR`` rank 0's
host, ``MASTER_PORT`` a free port there, which rank 0's task shares with
the others through the barrier), and its device, spelled as the
estimators spell it: ``device=None`` computes on the card
(``cuda:local_rank`` of the executor's cards, and ``init()`` raises in a
task without one), ``device="cpu"`` pins every task to the CPU, where
the world runs gloo.  Every task of a run takes the same choice, so one
world never mixes gloo and NCCL ranks.  The env lasts the task's ``fn``:
an executor's Python worker may run the next job's tasks.

``pyspark`` is an optional dependency; a clear error is raised without it.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

from .store import (Store, LocalStore, FsspecStore,       # noqa: F401
                    GCSStore)
from .estimator import (KerasEstimator, KerasModel,       # noqa: F401
                        TorchEstimator, TorchModel,
                        LightningEstimator, LightningModel)
from ..runner.hosts import (HostInfo, SlotInfo, get_host_assignments,
                            slot_env)


def _require_pyspark():
    try:
        from pyspark import BarrierTaskContext
        from pyspark.sql import SparkSession
        return BarrierTaskContext, SparkSession
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark; install pyspark or "
            "use the hvdrun-torch launcher instead") from e


def _resolve_slot(infos: List[str], pid: int) -> Tuple[SlotInfo, str]:
    """Map this barrier task to its slot from the gathered hostname list.

    ``infos[i]`` is partition i's hostname (BarrierTaskContext.allGather
    preserves partition order).  Slots are host-major over sorted
    hostnames, but partition→host placement is arbitrary — so the task's
    slot is found by its OWN hostname and its index among same-host
    partitions, never by raw partition id (which mis-assigns whenever
    partition order differs from sorted-host order; the controller then
    binds on the wrong machine and the job cannot form).

    Returns (slot, controller_host) where controller_host is rank 0's
    actual hostname.
    """
    hostname = infos[pid]
    counts: dict = {}
    for h in infos:
        counts[h] = counts.get(h, 0) + 1
    hosts = [HostInfo(h, c) for h, c in sorted(counts.items())]
    slots = get_host_assignments(hosts, len(infos))
    local_idx = sum(1 for h in infos[:pid] if h == hostname)
    my_slot = next(s for s in slots
                   if s.hostname == hostname and s.local_rank == local_idx)
    return my_slot, slots[0].hostname


def _task_env(ctx, controller_port: int,
              device: Optional[str] = None) -> Dict[str, str]:
    """The env of the barrier task ``ctx`` runs: its slot's launcher env,
    the torch world and, with ``device="cpu"``, the launcher's CPU pin.
    Two ``allGather`` rounds, which every task of the barrier makes: the
    hostnames, then rank 0's store port (a free port on rank 0's host)."""
    from ..runner import chips
    from .estimator import worker_platform
    infos = list(ctx.allGather(socket.gethostname()))
    my_slot, controller_host = _resolve_slot(infos, ctx.partitionId())
    ports = list(ctx.allGather(
        str(chips._free_port()) if my_slot.rank == 0 else ""))
    env = slot_env(my_slot, f"{controller_host}:{controller_port}")
    one_host = all(h == my_slot.hostname for h in infos)
    env["MASTER_ADDR"] = "127.0.0.1" if one_host else controller_host
    env["MASTER_PORT"] = next(p for p in ports if p)
    if worker_platform(device) == "cpu":
        env.update(chips.CPU_ENV)
    return env


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        controller_port: int = 29100,
        device: Optional[str] = None) -> List[Any]:
    """``fn(*args, **kwargs)`` in ``num_proc`` Spark barrier tasks, each a
    rank of one torch world; the results in rank order.  ``device=None``
    computes on the executors' cards, ``device="cpu"`` on the CPU."""
    BarrierTaskContext, SparkSession = _require_pyspark()
    kwargs = kwargs or {}
    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    num_proc = num_proc or int(sc.defaultParallelism)

    def _task(_):
        ctx = BarrierTaskContext.get()
        env = _task_env(ctx, controller_port, device)
        saved = dict(os.environ)
        os.environ.update(env)
        try:
            return [(int(env["HVD_TPU_RANK"]), fn(*args, **kwargs))]
        finally:
            os.environ.clear()
            os.environ.update(saved)

    rdd = sc.parallelize(range(num_proc), num_proc).barrier()
    results = rdd.mapPartitions(_task).collect()
    return [value for _rank, value in sorted(results)]


def _discover_executor_hosts(num_proc: int) -> List[HostInfo]:
    """Barrier-mode job gathering executor hostnames → HostInfo list (the
    reference's driver/task registration, spark/runner.py:47+).  Barrier
    mode forces one concurrent task per slot, so the host→slot counts
    reflect real executor capacity — a plain job could run every task on
    one fast executor and oversubscribe it."""
    BarrierTaskContext, SparkSession = _require_pyspark()
    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext

    def _task(_):
        BarrierTaskContext.get()
        return [socket.gethostname()]

    names = sc.parallelize(range(num_proc), num_proc).barrier() \
        .mapPartitions(_task).collect()
    counts: dict = {}
    for h in names:
        counts[h] = counts.get(h, 0) + 1
    return [HostInfo(h, c) for h, c in sorted(counts.items())]


def run_elastic(fn: Callable, args=(), kwargs=None,
                num_proc: Optional[int] = None,
                min_np: Optional[int] = None,
                max_np: Optional[int] = None,
                controller_base_port: int = 29400,
                work_dir: Optional[str] = None,
                hosts: Optional[List[HostInfo]] = None,
                gateway: Optional[str] = None,
                priority: int = 0,
                tenant: str = "default",
                verbose: bool = False) -> List[Any]:
    """Elastic Spark run (reference spark/runner.py:306 run_elastic).

    ``fn`` must be importable/picklable (module-level) and should drive its
    training with ``hvd.elastic.run(state)`` so worker failures restore
    committed state.  Completed ranks' return values are collected (rank
    order).  Worker payload and results travel through ``work_dir`` — a
    path visible to every executor host (defaults to a local temp dir,
    which is correct for local-mode Spark; pass a shared-filesystem path,
    e.g. a Store prefix, on real clusters).

    ``hosts`` overrides executor discovery (test seam / static clusters).
    Each slot takes its device by the elastic driver's plan (slot
    ``host:i`` the host's card *i*; a host without cards pins its slots
    to the CPU).

    With ``gateway=`` the job is SUBMITTED to a fleet gateway instead of
    this process owning the device fleet: the gateway schedules it onto
    its inventory (priority/quota/preemption apply), and ``work_dir``
    must be visible to the gateway's hosts.
    """
    from ..runner.fnpickle import collect_results, dump_payload

    kwargs = kwargs or {}
    num_proc = num_proc or (sum(h.slots for h in hosts) if hosts else 1)
    if hosts is None and gateway is None:
        hosts = _discover_executor_hosts(num_proc)
    min_np = min_np or num_proc

    own_tmp = work_dir is None
    work_dir = work_dir or tempfile.mkdtemp(prefix="hvd_spark_elastic_")
    payload_path, results_dir = dump_payload(work_dir, fn, args, kwargs)

    command = [sys.executable, "-m", "horovod_tpu_torch.spark.elastic_exec",
               payload_path, results_dir]
    if gateway is not None:
        from ..fleet import JobSpec, client
        rec = client.submit_job(
            JobSpec(command=command, min_np=min_np, max_np=max_np,
                    priority=priority, tenant=tenant), addr=gateway)
        if rec.state == "queued":
            rec = client.wait_job(rec.id, addr=gateway)
        if rec.state != "done":
            raise RuntimeError(
                f"fleet job {rec.id} ended {rec.state}"
                + (f": {rec.reason}" if rec.reason else ""))
    else:
        from ..runner.elastic_driver import ElasticDriver, FixedHosts
        # The workers run ``-m`` from any working directory: the
        # package's root goes on their path.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.pathsep.join([root] + [
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p])
        driver = ElasticDriver(
            FixedHosts(hosts), command, min_np=min_np, max_np=max_np,
            controller_base_port=controller_base_port,
            extra_env={"PYTHONPATH": path}, verbose=verbose)
        rc = driver.run()
        if rc != 0:
            raise RuntimeError(f"elastic spark job failed (exit {rc})")

    out = collect_results(results_dir)
    if own_tmp:
        import shutil
        shutil.rmtree(work_dir, ignore_errors=True)
    return out
