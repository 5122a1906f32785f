"""Worker process execution: local subprocess or ssh fan-out, with env
injection, rank-prefixed output forwarding and fail-fast semantics (port
of horovod_tpu/runner/exec.py).

Capability parity with the upstream threaded exec
(runner/gloo_run.py:105-268 + common/util/safe_shell_exec.py): each slot
runs the user command with the slot env; the first non-zero exit
terminates the job; output lines are prefixed "[rank]<stream>".

Before it launches them, the launcher plans how each host's workers
share its cards (``chips.plan_host_platform``): inherit, a per-slot
``CUDA_VISIBLE_DEVICES`` partition, or CPU-pinned workers, and says
which slots it pinned and why; it refuses a launch that would pin some
hosts' slots to the CPU while others compute on cards.  A static launch
also names its torch world (``chips.torch_world_env``:
``MASTER_ADDR``/``MASTER_PORT``), and a python command whose world
needs resolving in the worker runs through ``runner/bootstrap.py``.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .hosts import SlotInfo, slot_env


def _is_local(hostname: str) -> bool:
    import socket
    return hostname in ("localhost", "127.0.0.1", socket.gethostname())


def build_command(slot: SlotInfo, command: List[str], env: Dict[str, str],
                  ssh_port: Optional[int] = None,
                  ssh_identity_file: Optional[str] = None
                  ) -> Tuple[List[str], Optional[str]]:
    """Returns (argv, stdin_payload).  Secrets never travel in the remote
    argv — /proc/*/cmdline is world-readable on both machines, which would
    hand the rendezvous-forging capability the HMAC exists to deny back to
    any local user.  They are piped through ssh stdin instead."""
    if _is_local(slot.hostname):
        return command, None
    env = dict(env)
    secret = env.pop("HVD_TPU_RENDEZVOUS_SECRET", None)
    # Remote: ssh with env assignments inline (reference gloo_run.py builds
    # the same "env k=v ... cmd" remote line).
    assignments = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items())
    remote = f"cd {shlex.quote(os.getcwd())} && env {assignments} " + \
        " ".join(shlex.quote(c) for c in command)
    payload = None
    if secret is not None:
        remote = ("IFS= read -r HVD_TPU_RENDEZVOUS_SECRET && "
                  "export HVD_TPU_RENDEZVOUS_SECRET && " + remote)
        payload = secret + "\n"
    ssh_cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh_cmd += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh_cmd += ["-i", ssh_identity_file]
    return ssh_cmd + [slot.hostname, remote], payload


class WorkerProcess:
    def __init__(self, slot: SlotInfo, proc: subprocess.Popen):
        self.slot = slot
        self.proc = proc
        self.exit_code: Optional[int] = None


def launch_workers(slots: List[SlotInfo], command: List[str],
                   controller_addr: str,
                   extra_env: Optional[Dict[str, str]] = None,
                   on_exit: Optional[Callable[[SlotInfo, int], None]] = None,
                   prefix_output: bool = True,
                   platform_policy: Optional[str] = "auto",
                   ssh_port: Optional[int] = None,
                   ssh_identity_file: Optional[str] = None,
                   output_dir: Optional[str] = None,
                   prefix_timestamp: bool = False,
                   cpu_jax_world: Optional[bool] = None,
                   torch_world: bool = True,
                   plans: Optional[Dict[str, object]] = None
                   ) -> List[WorkerProcess]:
    """Start one process per slot; returns immediately with handles.

    ``platform_policy`` ("auto", "cpu" or "gpu") decides how each host's
    workers share its cards (``plan_hosts``), unless the caller planned
    already (``plans``, by hostname); None leaves it to the caller's
    ``extra_env`` (the elastic driver plans each slot itself,
    chips.elastic_slot_env).  ``torch_world``
    exports the launch's ``MASTER_ADDR``/``MASTER_PORT``; the elastic
    driver turns it off, since each of its rounds names its own store.
    ``cpu_jax_world`` is the reference's CPU JAX world, which the port has
    no counterpart of."""
    from . import chips as chips_mod
    if cpu_jax_world:
        raise ValueError("cpu_jax_world: the port forms no JAX world")
    if plans is None and platform_policy is not None:
        plans = plan_hosts(slots, platform_policy)
    world = {}
    if torch_world and slots:
        world = chips_mod.torch_world_env(
            slots, (extra_env or {}).get("HVD_TPU_RENDEZVOUS_ADDR"))
    workers = []
    for slot in slots:
        declared = {**slot_env(slot, controller_addr),
                    **(plans[slot.hostname].slot_env(slot.local_rank,
                                                     slot.local_size)
                       if plans else {}),
                    **world, **(extra_env or {})}
        env = dict(os.environ)
        env.update(declared)
        slot_command = chips_mod.wrap_python_command(command) \
            if chips_mod.needs_bootstrap(declared) else command
        cmd, stdin_payload = build_command(
            slot, slot_command, declared,
            ssh_port=ssh_port, ssh_identity_file=ssh_identity_file)
        proc = subprocess.Popen(
            cmd, env=env,
            stdin=subprocess.PIPE if stdin_payload else subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1, start_new_session=True)
        if stdin_payload:
            try:
                proc.stdin.write(stdin_payload)
                proc.stdin.close()
            except OSError:
                pass  # worker died instantly; exit watcher reports it
        w = WorkerProcess(slot, proc)
        workers.append(w)
        if prefix_output:
            threading.Thread(
                target=_forward_output,
                args=(w, output_dir, prefix_timestamp),
                daemon=True).start()
        if on_exit is not None:
            threading.Thread(target=_watch_exit, args=(w, on_exit),
                             daemon=True).start()
    return workers


def plan_hosts(slots: List[SlotInfo], policy: str) -> Dict[str, object]:
    """Each host's ``chips.HostPlatformPlan``.  Says which slots a plan
    pinned to the CPU, and why: a worker never falls back to the CPU
    unannounced.  Raises when some hosts' slots would be pinned to the
    CPU and others' compute on cards (chips.check_one_platform)."""
    from . import chips as chips_mod
    plans, on_cpu = {}, {}
    for slot in slots:
        if slot.hostname in plans:
            continue
        chips, devices = chips_mod.host_cards(slot.hostname)
        plan = plans[slot.hostname] = chips_mod.plan_host_platform(
            slot.local_size, policy, chips=chips, partitionable=chips > 0,
            devices=devices)
        if plan.mode == "cpu":
            on_cpu[slot.hostname] = plan.reason
    chips_mod.check_one_platform(
        on_cpu, [h for h in plans if h not in on_cpu])
    for host, why in on_cpu.items():
        report_pinned(host, [s.rank for s in slots if s.hostname == host],
                      why)
    return plans


def report_pinned(hostname: str, ranks: List[int], reason: str) -> None:
    print(f"[hvdrun] host {hostname}: rank(s) {ranks} pinned to the "
          f"CPU ({reason})", file=sys.stderr)


def _forward_output(w: WorkerProcess, output_dir: Optional[str] = None,
                    prefix_timestamp: bool = False):
    assert w.proc.stdout is not None
    sink = None
    if output_dir:
        # Per-rank capture files (reference --output-filename layout:
        # <dir>/<rank>/stdout; stderr is merged into stdout here).
        rank_dir = os.path.join(output_dir, str(w.slot.rank))
        os.makedirs(rank_dir, exist_ok=True)
        # Append: elastic respawns of the same rank must not truncate the
        # earlier rounds' capture.
        sink = open(os.path.join(rank_dir, "stdout"), "a")
    try:
        import datetime
        for line in w.proc.stdout:
            stamp = ""
            if prefix_timestamp:
                stamp = datetime.datetime.now().isoformat(
                    timespec="milliseconds") + " "
            sys.stdout.write(f"{stamp}[{w.slot.rank}]<stdout> {line}")
            sys.stdout.flush()
            if sink is not None:
                sink.write(line)
                sink.flush()
    finally:
        if sink is not None:
            sink.close()


def _watch_exit(w: WorkerProcess, on_exit: Callable[[SlotInfo, int], None]):
    code = w.proc.wait()
    w.exit_code = code
    on_exit(w.slot, code)


def wait_all(workers: List[WorkerProcess],
             timeout: Optional[float] = None) -> int:
    """Wait for all workers; on the first failure — in EXIT order, not
    rank order — terminate the rest (fail-fast) and return its exit
    code.  Waiting on workers sequentially would leave a crash of rank
    k unnoticed while rank 0 still runs, hanging the job on survivors
    blocked in collectives with a dead peer (the reference's
    safe_shell_exec terminates everything on any failure immediately).
    ``timeout`` is the overall deadline; 124 on expiry."""
    import queue as queue_mod
    import time as time_mod
    done: "queue_mod.Queue" = queue_mod.Queue()
    for w in workers:
        threading.Thread(target=lambda w=w: done.put((w, w.proc.wait())),
                         daemon=True).start()
    result = 0
    remaining = len(workers)
    # Monotonic: an NTP step must neither fire the timeout early nor
    # push it out indefinitely.
    deadline = None if timeout is None else time_mod.monotonic() + timeout
    while remaining:
        try:
            wait_s = (None if deadline is None
                      else max(deadline - time_mod.monotonic(), 0.001))
            w, code = done.get(timeout=wait_s)
        except queue_mod.Empty:
            terminate_all([x for x in workers if x.proc.poll() is None])
            return 124
        w.exit_code = code
        remaining -= 1
        if code != 0 and result == 0:
            result = code
            terminate_all([x for x in workers if x.proc.poll() is None])
    return result


def terminate_all(workers: List[WorkerProcess], sig=signal.SIGTERM):
    for w in workers:
        if w.proc.poll() is None:
            try:
                os.killpg(os.getpgid(w.proc.pid), sig)
            except (ProcessLookupError, PermissionError):
                pass
    for w in workers:
        try:
            w.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(w.proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
