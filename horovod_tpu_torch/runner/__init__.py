"""Launcher package + the in-process ``run()`` API (port of
horovod_tpu/runner/).

The ``hvdrun`` CLI is ``launch`` (``python -m
horovod_tpu_torch.runner.launch``, or the ``hvdrun-torch`` console
script); beside it live the rendezvous KV server and its clients
(``rendezvous``), host and slot parsing (``hosts``), host and GPU
discovery (``gpu_discovery``), the per-slot ``CUDA_VISIBLE_DEVICES`` plan
(``chips``), the NIC probe (``probe``), the worker bootstrap
(``bootstrap``), worker processes (``exec``), the elastic worker's
rendezvous client (``worker``) and the elastic driver
(``elastic_driver``).

``horovod_tpu_torch.runner.run(fn, ...)`` is the programmatic launcher the
reference exposes as ``horovod.run`` (runner/__init__.py:92): it spawns
``np`` local worker processes, establishes the same env contract as the
CLI, executes ``fn`` in each as a rank, and returns the results ordered
by rank.  The reference pins every such worker to the CPU, because the
calling process may hold the host's one TPU chip; here a worker takes its
slot's card by the launcher's plan (``worker_platform="auto"``), and
``worker_platform="cpu"`` runs it on the CPU over gloo.
"""

from __future__ import annotations

import multiprocessing as _mp
import os
import socket
import sys
from typing import Any, Callable, List, Optional

from .hosts import HostInfo, get_host_assignments, slot_env


def _worker_main(fn, args, kwargs, env, q, rank):
    # Before fn's first CUDA call: the slot's CUDA_VISIBLE_DEVICES.
    os.environ.update(env)
    try:
        q.put((rank, True, fn(*args, **kwargs)))
    except Exception as e:  # surface the failure to the parent
        q.put((rank, False, repr(e)))


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 1, hosts: Optional[str] = None,
        use_mpi: Optional[bool] = None,
        use_gloo: Optional[bool] = None,
        controller_port: int = 28500,
        env: Optional[dict] = None,
        work_dir: Optional[str] = None,
        worker_platform: str = "auto") -> List[Any]:
    """Run ``fn`` as ``np`` distributed ranks and return the list of
    per-rank results (rank order).

    Without ``hosts``: ``np`` local processes (multiprocessing spawn),
    each on its slot's cards by the launcher's plan
    (``exec.plan_hosts``).  With ``hosts`` ("h1:2,h2:2" like hvdrun
    -H): ``fn`` is pickled into
    ``work_dir`` (must be visible on every host — defaults to a local
    temp dir, correct for localhost slot lists) and executed through the
    same launcher/ssh machinery as ``hvdrun``, the reference's per-host
    fn semantics (runner/__init__.py:92).

    The control plane is always the TCP controller (the gloo analog), so
    ``use_gloo`` may be None or True; ``use_mpi=True`` or
    ``use_gloo=False`` asks for MPI and raises, as ``hvdrun --mpi`` does.
    """
    from . import chips
    from .exec import plan_hosts
    if use_mpi or use_gloo is False:
        raise ValueError("an MPI control plane is not available; the TCP "
                         "controller (the gloo analog) is the only one")
    kwargs = kwargs or {}
    if hosts is not None:
        return _run_on_hosts(fn, args, kwargs, np, hosts, controller_port,
                             env, work_dir, worker_platform)
    hostname = socket.gethostname()
    slots = get_host_assignments([HostInfo(hostname, np)], np)
    controller_addr = f"{hostname}:{controller_port}"
    plan = plan_hosts(slots, worker_platform)[hostname]
    world = chips.torch_world_env(slots)

    ctx = _mp.get_context("spawn")
    q = ctx.Queue()
    procs = []
    for slot in slots:
        wenv = slot_env(slot, controller_addr)
        wenv.update(plan.slot_env(slot.local_rank, slot.local_size))
        wenv.update(world)
        wenv.update(env or {})
        p = ctx.Process(target=_worker_main,
                        args=(fn, args, kwargs, wenv, q, slot.rank))
        p.start()
        procs.append(p)

    import queue as _queue
    results: dict = {}
    try:
        while len(results) < len(procs):
            try:
                rank, ok, value = q.get(timeout=1.0)
            except _queue.Empty:
                # Any worker that exited before reporting — crash, spawn
                # re-import failure (stdin/REPL callers), sys.exit(0), or
                # an unpicklable return value — would otherwise hang this
                # loop forever.  Drain stragglers already in the queue
                # before declaring the run dead.
                if not q.empty():
                    continue
                lost = [(r, p.exitcode) for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if lost:
                    raise RuntimeError(
                        f"worker(s) {lost} (rank, exitcode) exited before "
                        "reporting a result. Note: run(fn) uses spawn, so "
                        "it must be called from an importable module (not "
                        "stdin/REPL), fn must be module-level, and its "
                        "return value picklable.")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed: {value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    return [results[r] for r in sorted(results)]


def _run_on_hosts(fn, args, kwargs, np_, hosts, controller_port, env,
                  work_dir, worker_platform):
    """Spawn fn-workers across a host list through the launcher machinery
    (rendezvous + slot env + plan + ssh/local exec), collecting per-rank
    result pickles from the shared work dir."""
    import shutil
    import tempfile

    from . import exec as exec_mod
    from .fnpickle import collect_results, dump_payload
    from .hosts import parse_hosts
    from .launch import _controller_addr, start_rendezvous

    host_infos = parse_hosts(hosts)
    slots = get_host_assignments(host_infos, np_)
    controller_addr = _controller_addr(host_infos, controller_port)
    plans = exec_mod.plan_hosts(slots, worker_platform)

    own_tmp = work_dir is None
    work_dir = work_dir or tempfile.mkdtemp(prefix="hvd_run_")
    payload_path, results_dir = dump_payload(work_dir, fn, args, kwargs)

    rendezvous, extra_env = start_rendezvous(host_infos)
    # The workers run ``-m horovod_tpu_torch.runner.fn_exec`` from any
    # working directory: the package's root goes on their path.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    extra_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    extra_env.update(env or {})
    command = [sys.executable, "-m", "horovod_tpu_torch.runner.fn_exec",
               payload_path, results_dir]
    try:
        workers = exec_mod.launch_workers(slots, command, controller_addr,
                                          extra_env=extra_env,
                                          plans=plans)
        rc = exec_mod.wait_all(workers)
        if rc != 0:
            raise RuntimeError(f"run(fn) workers failed (exit {rc})")
        results = collect_results(results_dir)
        if len(results) != len(slots):
            raise RuntimeError(
                f"collected {len(results)} results for {len(slots)} ranks "
                f"(work_dir {work_dir} must be visible on every host)")
        return results
    finally:
        rendezvous.stop()
        if own_tmp:
            shutil.rmtree(work_dir, ignore_errors=True)
