"""``hvdrun`` for the port — the launcher CLI (port of
horovod_tpu/runner/launch.py).

    python -m horovod_tpu_torch.runner.launch -np 4 python train.py
    hvdrun-torch -np 8 -H host1:4,host2:4 python train.py

Capability parity with the upstream ``horovodrun``
(runner/launch.py:300-520 arg surface, gloo_run.py launch flow): parse
-np/-H/--hostfile (or discover the hosts, ``gpu_discovery``), compute
slot assignments, start the rendezvous KV server with a NIC-probed
address, plan each host's cards (``chips``), export the env contract per
worker (the torch world's ``MASTER_ADDR``/``MASTER_PORT`` included), exec
workers locally or over ssh with fail-fast, and (with --min-np/--max-np +
--host-discovery-script) run the elastic driver instead.

Config file (--config-file, JSON or YAML) keys mirror CLI flags
(reference runner/common/util/config_parser.py).

``--submit`` (with ``--gateway``, ``--priority``, ``--tenant``) hands the
command to a fleet gateway (``fleet/``) instead of launching it, and a
taken ``--rendezvous-port`` that a fleet gateway holds says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from . import exec as exec_mod
from . import gpu_discovery
from .hosts import HostInfo, get_host_assignments, parse_hostfile, parse_hosts
from .rendezvous import RendezvousServer


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch a data-parallel job across hosts and their "
                    "GPUs.")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of worker processes")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list "h1:slots,h2:slots"')
    p.add_argument("--hostfile", default=None,
                   help="hostfile path (mpirun-style slots=N supported)")
    p.add_argument("--controller-port", type=int, default=26000)
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None,
                   help="ssh -i identity file for remote hosts")
    p.add_argument("--network-interface", default=None,
                   help="restrict the advertised driver/rendezvous address "
                        "to this interface (reference --network-interface)")
    p.add_argument("--output-filename", default=None,
                   help="directory for per-rank output capture "
                        "(<dir>/<rank>/stdout; streams still forwarded)")
    p.add_argument("--prefix-output-with-timestamp", action="store_true")
    p.add_argument("--start-timeout", type=float, default=None,
                   help="seconds workers may wait for the controller/"
                        "rendezvous to come up before giving up")
    p.add_argument("--elastic-timeout", type=float, default=None,
                   help="seconds an elastic rendezvous round may wait for "
                        "min-np workers")
    p.add_argument("--version", action="store_true",
                   help="print the version and exit")
    # Controller selection (reference --gloo/--mpi/--jsrun/--tcp): the
    # control plane is always the TCP controller (the gloo analog), so
    # --tcp/--gloo are accepted no-ops and --mpi/--jsrun fail with an
    # explanation instead of a silent fallback.
    p.add_argument("--tcp", action="store_true",
                   help="use the TCP controller (always on; compat flag)")
    p.add_argument("--gloo", action="store_true",
                   help="compat alias for the TCP controller (gloo analog)")
    p.add_argument("--mpi", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--jsrun", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--worker-platform", choices=("auto", "cpu", "gpu"),
                   default="auto",
                   help="how workers share each host's GPUs: auto = "
                        "inherit/partition CUDA_VISIBLE_DEVICES/fall back "
                        "to cpu, cpu = CPU workers on gloo, gpu = inherit "
                        "the card view (externally partitioned)")
    p.add_argument("--config-file", default=None)
    # Fleet service mode (fleet/): submit through a running job gateway
    # instead of owning the cards for the process lifetime.
    p.add_argument("--submit", action="store_true",
                   help="submit this command to the fleet gateway "
                        "instead of launching directly (multi-tenant "
                        "fleet mode)")
    p.add_argument("--gateway", default=None,
                   help="fleet gateway address host:port for --submit "
                        "(default: HVD_TPU_FLEET_ADDR, then "
                        "127.0.0.1:<HVD_TPU_FLEET_PORT>)")
    p.add_argument("--priority", type=int, default=0,
                   help="job priority for --submit (higher preempts "
                        "lower)")
    p.add_argument("--tenant", default="default",
                   help="tenant name for --submit (quota/fair-share "
                        "accounting)")
    p.add_argument("--rendezvous-port", type=int, default=None,
                   help="bind the rendezvous KV server to this fixed "
                        "port (default: ephemeral)")
    # Elastic.
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None)
    p.add_argument("--slots", type=int, default=None,
                   help="slots per discovered host (elastic)")
    p.add_argument("--reset-limit", type=int, default=None)
    # Tunables → env knobs (reference config_parser mapping).
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--disable-cache", action="store_true")
    p.add_argument("--hierarchical-allreduce", action="store_true")
    p.add_argument("--hierarchical-allgather", action="store_true")
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None)
    p.add_argument("--no-stall-check", action="store_true")
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None)
    p.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   default=None)
    p.add_argument("--log-level", default=None)
    p.add_argument("--log-hide-timestamp", action="store_true",
                   help="hide timestamps in runtime log lines")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--check-build", action="store_true",
                   help="print available frameworks/features and exit "
                        "(reference horovodrun --check-build)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command (e.g. python train.py)")
    args = p.parse_args(argv)
    if args.config_file:
        _apply_config_file(args, p, args.config_file)
    if args.check_build or args.version:
        return args
    if args.mpi or args.jsrun:
        p.error("MPI/jsrun control planes are not available; the TCP "
                "controller (the gloo analog) is the only control plane — "
                "drop --mpi/--jsrun (or pass --tcp/--gloo, which are "
                "accepted aliases)")
    if not args.command:
        p.error("no worker command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    return args


def _apply_config_file(args, parser, path: str):
    with open(path) as f:
        text = f.read()
    try:
        cfg = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml  # type: ignore
            cfg = yaml.safe_load(text)
        except ImportError as e:
            raise SystemExit(f"config file {path} is not JSON and PyYAML "
                             f"is unavailable: {e}")
    for key, value in (cfg or {}).items():
        attr = key.replace("-", "_")
        if hasattr(args, attr) and getattr(args, attr) in (None, False):
            setattr(args, attr, value)


def knob_env(args: argparse.Namespace) -> Dict[str, str]:
    env = {}
    if args.fusion_threshold_mb is not None:
        env["HVD_TPU_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env["HVD_TPU_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HVD_TPU_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.disable_cache:
        env["HVD_TPU_CACHE_CAPACITY"] = "0"
    if args.hierarchical_allreduce:
        env["HVD_TPU_HIERARCHICAL_ALLREDUCE"] = "1"
    if args.hierarchical_allgather:
        env["HVD_TPU_HIERARCHICAL_ALLGATHER"] = "1"
    if args.start_timeout is not None:
        env["HVD_TPU_START_TIMEOUT"] = str(args.start_timeout)
    if args.elastic_timeout is not None:
        env["HVD_TPU_ELASTIC_TIMEOUT"] = str(args.elastic_timeout)
    if args.network_interface:
        env["HVD_TPU_IFACE"] = args.network_interface
    if args.timeline_filename:
        env["HVD_TPU_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HVD_TPU_TIMELINE_MARK_CYCLES"] = "1"
    if args.autotune:
        env["HVD_TPU_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HVD_TPU_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.autotune_warmup_samples is not None:
        env["HVD_TPU_AUTOTUNE_WARMUP_SAMPLES"] = str(
            args.autotune_warmup_samples)
    if args.autotune_steps_per_sample is not None:
        env["HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE"] = str(
            args.autotune_steps_per_sample)
    if args.autotune_bayes_opt_max_samples is not None:
        env["HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"] = str(
            args.autotune_bayes_opt_max_samples)
    if args.autotune_gaussian_process_noise is not None:
        env["HVD_TPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"] = str(
            args.autotune_gaussian_process_noise)
    if args.no_stall_check:
        env["HVD_TPU_STALL_CHECK_DISABLE"] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env["HVD_TPU_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env["HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS"] = str(
            args.stall_check_shutdown_time_seconds)
    if args.log_level:
        env["HVD_TPU_LOG_LEVEL"] = args.log_level
    if args.log_hide_timestamp:
        env["HVD_TPU_LOG_HIDE_TIME"] = "1"
    return env


def resolve_hosts(args: argparse.Namespace) -> List[HostInfo]:
    if args.hosts:
        return parse_hosts(args.hosts)
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    found = gpu_discovery.discover_gpu_hosts()
    if found is not None:
        hosts, _ = found
        if args.verbose:
            print(f"discovered hosts: "
                  f"{','.join(h.hostname for h in hosts)}")
        return hosts
    np_ = args.num_proc or 1
    return [HostInfo("localhost", np_)]


def _controller_addr(hosts: List[HostInfo], port: int) -> str:
    first = hosts[0].hostname
    if first in ("localhost", "127.0.0.1"):
        first = "127.0.0.1"
    return f"{first}:{port}"


def bind_rendezvous(port: Optional[int],
                    secret: Optional[str] = None) -> RendezvousServer:
    """Construct the KV server on ``port`` (None/0 = ephemeral).  A bind
    failure on a fixed port says which port, instead of an opaque
    ``Address already in use`` traceback; when the listener there is a
    fleet gateway — the one service that parks on a well-known port — it
    says to submit the job instead."""
    try:
        return RendezvousServer(port=port or 0, secret=secret)
    except OSError as e:
        if port:
            from ..fleet.client import detect_gateway
            if detect_gateway(f"127.0.0.1:{port}") is not None:
                raise SystemExit(
                    f"port {port} is serving a fleet gateway: fleet mode "
                    "is active on this machine — the cards are managed "
                    "by the gateway, so submit the job instead of "
                    "launching it directly:\n"
                    f"    hvdrun-torch --submit --gateway 127.0.0.1:{port} "
                    "... <command>\n"
                    "(or python -m horovod_tpu_torch.fleet.submit)"
                ) from None
            raise SystemExit(
                f"rendezvous port {port} is already bound ({e}); pick "
                "another --rendezvous-port or free the port") from None
        raise


def start_rendezvous(hosts: List[HostInfo],
                     ssh_port: Optional[int] = None,
                     iface: Optional[str] = None,
                     port: Optional[int] = None):
    """Per-launch rendezvous bring-up shared by every launch path: HMAC
    secret, KV server, and a driver address NIC-probed so every remote
    host can route to it (reference driver_service.py:49-218 —
    gethostname() may resolve to an unreachable interface on multi-NIC
    machines).  Returns (server, worker_env_fragment)."""
    from .probe import advertised_driver_host
    from .rendezvous import generate_secret
    secret = generate_secret()
    rendezvous = bind_rendezvous(port, secret=secret)
    rdv_port = rendezvous.start()
    try:
        rdv_host = advertised_driver_host(
            [h.hostname for h in hosts
             if not exec_mod._is_local(h.hostname)],
            ssh_port=ssh_port, iface=iface)
    except BaseException:
        rendezvous.stop()
        raise
    return rendezvous, {
        "HVD_TPU_RENDEZVOUS_ADDR": f"{rdv_host}:{rdv_port}",
        "HVD_TPU_RENDEZVOUS_SECRET": secret,
    }


def run_static(args: argparse.Namespace) -> int:
    hosts = resolve_hosts(args)
    np_ = args.num_proc or sum(h.slots for h in hosts)
    slots = get_host_assignments(hosts, np_)
    controller_addr = _controller_addr(hosts, args.controller_port)
    try:
        plans = exec_mod.plan_hosts(slots, args.worker_platform)
    except ValueError as e:
        print(f"hvdrun: {e}", file=sys.stderr)
        return 2

    rendezvous, rdv_env = start_rendezvous(
        hosts, ssh_port=args.ssh_port, iface=args.network_interface,
        port=getattr(args, "rendezvous_port", None))
    try:
        extra_env = knob_env(args)
        extra_env.update(rdv_env)
        rendezvous.put("global", "controller", controller_addr.encode())

        if args.verbose:
            print(f"rendezvous at {rdv_env['HVD_TPU_RENDEZVOUS_ADDR']}")
            for s in slots:
                print(f"rank {s.rank} -> {s.hostname} (local "
                      f"{s.local_rank}/{s.local_size}, cross "
                      f"{s.cross_rank}/{s.cross_size})")
        workers = exec_mod.launch_workers(
            slots, args.command, controller_addr,
            extra_env=extra_env, plans=plans,
            ssh_port=args.ssh_port,
            ssh_identity_file=args.ssh_identity_file,
            output_dir=args.output_filename,
            prefix_timestamp=args.prefix_output_with_timestamp)
        return exec_mod.wait_all(workers)
    finally:
        rendezvous.stop()


def run_elastic(args: argparse.Namespace) -> int:
    from .elastic_driver import run_elastic
    return run_elastic(args)


def run_submit(args: argparse.Namespace) -> int:
    """``hvdrun-torch --submit``: hand the command to the fleet gateway
    (multi-tenant fleet mode) instead of owning the cards.  The launch
    knobs ride the job spec as worker env, so a submitted job tunes
    exactly like a directly-launched one."""
    from ..fleet import JobSpec, client
    min_np = args.min_np if args.min_np is not None else \
        (args.num_proc or 1)
    max_np = args.max_np if args.max_np is not None else args.num_proc
    spec = JobSpec(command=list(args.command), min_np=min_np,
                   max_np=max_np, priority=args.priority,
                   tenant=args.tenant, env=knob_env(args))
    addr = client.default_addr(args.gateway)
    if client.detect_gateway(addr) is None:
        raise SystemExit(
            f"no fleet gateway answering at {addr} — start one "
            "(horovod_tpu_torch.fleet.FleetGateway.serve()) or drop "
            "--submit to launch directly")
    rec = client.submit_job(spec, addr=addr)
    print(f"job {rec.id}: {rec.state}"
          + (f" ({rec.reason})" if rec.reason else ""))
    return 0 if rec.state == "queued" else 1


def check_build() -> int:
    """Available frameworks/features (reference horovodrun --check-build):
    each probed live, not baked at build time.  Built-ness is reported
    from the files alone: a diagnostic builds nothing and initialises no
    device."""
    def probe(fn):
        try:
            return fn()
        except Exception:  # noqa: BLE001
            return False

    import importlib.util as iu

    import torch
    import torch.distributed as dist

    from .. import version
    from ..native import _build as native_build
    from ..ops import _build as kernel_build

    def kernels_built():
        srcs = [os.path.join(kernel_build.CSRC, f)
                for f in sorted(os.listdir(kernel_build.CSRC))
                if f.endswith(".cu")]
        return bool(srcs) and all(
            os.path.exists(kernel_build.library_path(s)) for s in srcs)

    cards = probe(lambda: len(gpu_discovery.local_devices())) or 0
    print(f"horovod_tpu_torch v{version.__version__}\n")
    print("Available frameworks:")
    print(f"    [X] PyTorch {torch.__version__}")
    print("\nAvailable runtime features:")
    for label, fn in [
            (f"CUDA {torch.version.cuda} (PyTorch build), {cards} card(s) "
             "visible", lambda: torch.version.cuda is not None and cards),
            ("NCCL (torch.distributed)", dist.is_nccl_available),
            ("gloo (torch.distributed)", dist.is_gloo_available),
            ("nvcc (builds csrc/ at first use)",
             lambda: kernel_build.find_nvcc()),
            ("flash-attention kernels built (csrc/flash_attention.cu, "
             "sm_90a)", kernels_built),
            ("native eager runtime built (TCP controller)",
             lambda: os.path.exists(native_build.library_path())),
            ("elastic training", lambda: True),
            ("Adasum", lambda: True),
            ("cloudpickle (run(fn, hosts=...) ships fn by value)",
             lambda: iu.find_spec("cloudpickle") is not None)]:
        mark = "X" if probe(fn) else " "
        print(f"    [{mark}] {label}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import version
        print(version.__version__)
        return 0
    if args.check_build:
        return check_build()
    if args.submit:
        return run_submit(args)
    if args.host_discovery_script or args.min_np or args.max_np:
        return run_elastic(args)
    return run_static(args)


if __name__ == "__main__":
    sys.exit(main())
