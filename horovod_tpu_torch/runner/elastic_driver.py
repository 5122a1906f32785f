"""Elastic driver: dynamic world membership with host discovery, blacklist,
re-rendezvous rounds and worker respawn (port of
horovod_tpu/runner/elastic_driver.py, all but ``run_elastic``).

Capability parity with the upstream elastic runner (runner/elastic/
driver.py:69-313, discovery.py, registration.py): a background thread polls
a user-provided host-discovery script; host additions/removals trigger a new
rendezvous round; failed hosts are blacklisted; workers re-fetch their
assignment from the rendezvous KV on every (re)init; the job fails when the
world would drop below --min-np or the reset count exceeds --reset-limit.

As in the reference, worker notification is pull-based: workers poll the
KV's host-event key at ``state.commit()``, and each round's assignment is
published under ``elastic/round.<n>`` with a fresh controller port and a
fresh ``torch.distributed`` store port, because both worlds are fixed per
``init()``.  A worker also watches ``elastic/current_round`` while it
trains (``core/failure.py``): a round published after a failure or a
shrink aborts its collectives, so a survivor blocked on a dead peer's
NCCL collective returns and raises ``HorovodInternalError``.

``run_elastic`` is the ``hvdrun`` entry (runner/launch.py).  With a
remote host in the set, the driver advertises the NIC-probed address
(``probe.advertised_driver_host``) for its rendezvous; an all-local set
advertises ``rendezvous.advertised_host()``.  The platform policy
reaches every respawn: each round plans its slots with
``chips.elastic_slot_env`` (slot ``host:i`` on the host's card *i*,
fixed for the life of its worker), and a round whose slots would not
all run one backend (a slot beyond its host's cards, or CPU-pinned slots
beside slots on cards) is refused and ends the job.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Set

from . import exec as exec_mod
from .hosts import HostInfo, SlotInfo, get_host_assignments, parse_hosts
from ..debug import flight as _flight

# Exit status a preempted job reports from run(): distinct from worker
# failure codes (and from ssh's 255) so a scheduler — the fleet gateway —
# can tell "suspend me and requeue" from "I failed".  78 = EX_CONFIG's
# neighbor in the sysexits range, unused by the toolchain here.
PREEMPTED_EXIT = 78


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> List[HostInfo]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs the user script; each output line is "hostname[:slots]"
    (reference discovery.py:146-180)."""

    def __init__(self, script: str, default_slots: int):
        self._script = script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> List[HostInfo]:
        out = subprocess.run([self._script], shell=False,
                             capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed: {out.stderr.strip()}")
        hosts = []
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                hosts.extend(parse_hosts(line))
            else:
                hosts.append(HostInfo(line, self._default_slots))
        return hosts


class FixedHosts(HostDiscovery):
    """Test discovery with a mutable host set (reference test pattern)."""

    def __init__(self, hosts: List[HostInfo]):
        self._hosts = hosts
        self._lock = threading.Lock()

    def set(self, hosts: List[HostInfo]):
        with self._lock:
            self._hosts = hosts

    def find_available_hosts_and_slots(self) -> List[HostInfo]:
        with self._lock:
            return list(self._hosts)


class ElasticDriver:
    def __init__(self, discovery: HostDiscovery, command: List[str],
                 min_np: int, max_np: Optional[int],
                 controller_base_port: int = 27000,
                 discovery_interval: float = 1.0,
                 reset_limit: Optional[int] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 verbose: bool = False,
                 platform_policy: str = "auto",
                 iface: Optional[str] = None,
                 ssh_identity_file: Optional[str] = None,
                 output_dir: Optional[str] = None,
                 prefix_timestamp: bool = False,
                 health_hook=None,
                 rendezvous_port: Optional[int] = None,
                 ssh_port: Optional[int] = None):
        self._discovery = discovery
        # Optional straggler-health hint (hvd.metrics): a callable
        # returning hostnames to keep out of new rounds — a SOFT
        # blacklist re-evaluated each discovery, unlike the hard
        # failure blacklist.  Typical wiring: a sidecar maps
        # hvd.metrics.blacklist_hint() ranks to hostnames via the
        # round's slot assignment and feeds them here.
        self._health_hook = health_hook
        self._command = command
        self._platform_policy = platform_policy
        # Card inventory by host (chips.host_cards), and the current
        # round's platform env by slot id (_plan_round).
        self._cards: Dict[str, tuple] = {}
        self._platform: Dict[str, Dict[str, str]] = {}
        # The cards a fleet scheduler gave this job, by host (seed_cards):
        # indices into the host's cards, slot host:i on the i-th.
        self._card_sets: Dict[str, List[int]] = {}
        self._min_np = min_np
        self._max_np = max_np
        self._base_port = controller_base_port
        self._interval = float(os.environ.get(
            "HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", discovery_interval))
        self._reset_limit = reset_limit
        self._extra_env = dict(extra_env or {})
        self._verbose = verbose
        self._iface = iface
        self._ssh_identity_file = ssh_identity_file
        self._ssh_port = ssh_port
        self._output_dir = output_dir
        self._prefix_timestamp = prefix_timestamp

        from .rendezvous import generate_secret
        self._rdv_secret = generate_secret()
        # A fixed port (hvdrun --rendezvous-port) binds there.
        from .launch import bind_rendezvous
        self._rendezvous = bind_rendezvous(rendezvous_port,
                                           secret=self._rdv_secret)
        self._lock = threading.RLock()
        self._round = -1
        self._resets = 0
        self._blacklist: Set[str] = set()
        self._current_hosts: List[HostInfo] = []
        self._workers: Dict[str, exec_mod.WorkerProcess] = {}  # slot_id →
        # Slots the driver itself terminated on scale-down, keyed by the
        # spawn generation of the terminated worker: the marker matches
        # exactly one process's exit, so a replacement's real failure can
        # never be misread as an expected scale-down exit (and a stale
        # exit can never consume the replacement's marker).
        self._expected_exits: Dict[str, int] = {}
        # Spawn generation per slot: exit events carry the generation they
        # belong to, so a stale callback from a superseded process can
        # never untrack or fail its replacement.
        self._gen: Dict[str, int] = {}
        # Spawn wall-clock per slot generation + the one SSH-retry credit:
        # a remote worker dying with ssh's transport exit code (255)
        # within seconds of spawn is a dropped handshake, not a bad host —
        # it gets one respawn before the blacklist path.
        self._spawn_ts: Dict[str, tuple] = {}
        self._ssh_retried: Set[tuple] = set()
        self._ssh_retry_window_s = float(os.environ.get(
            "HVD_TPU_ELASTIC_SSH_RETRY_WINDOW", "8"))
        self._shutdown = threading.Event()
        self._finished: Dict[str, int] = {}
        # Cascade-failure leniency (see _on_worker_exit): failures within
        # this window of the previous failure respawn without blacklist.
        self._last_failure_ts: Optional[float] = None
        self._cascade_grace_s = float(os.environ.get(
            "HVD_TPU_ELASTIC_CASCADE_GRACE", "10"))
        # Debounce for the cascade republish (see _on_worker_exit): one
        # incident's collateral exits usually arrive within this window
        # and fold into a single fresh round.
        self._cascade_debounce_s = float(os.environ.get(
            "HVD_TPU_ELASTIC_CASCADE_DEBOUNCE", "1.0"))
        self._cascade_timer: Optional[threading.Timer] = None
        self._succeeded = False  # any worker exited 0: job is completing
        self._result: Optional[int] = None
        self._result_cv = threading.Condition()
        # External resize cap (request_resize): tightens max_np without
        # touching discovery — the scheduler's lever for handing slots
        # between jobs.  None = uncapped.
        self._np_cap: Optional[int] = None
        self._preempted = False
        # announce_resize() published a host event whose round does not
        # exist yet: workers park at their next commit awaiting it, so
        # the next request_resize/preempt MUST produce that round (or
        # end the job) even when the host set turns out unchanged.
        self._resize_announced = False

    @staticmethod
    def _metric(name: str, help: str, **labels):
        """Driver-side counters/gauges (the driver process has its own
        registry; serve it with hvd.metrics.serve() for scraping)."""
        from ..metrics.registry import registry
        return registry().counter(name, help, **labels)

    @staticmethod
    def _gauge(name: str, help: str):
        from ..metrics.registry import registry
        return registry().gauge(name, help)

    # -- public ------------------------------------------------------------

    def run(self) -> int:
        port = self._rendezvous.start()
        try:
            # One discovery (it may be a user subprocess) serves both the
            # capacity check and the NIC-matching probe.  The advertised
            # address is fixed for the job: later-joining hosts must be
            # able to route to an address probed against the initial set
            # (the practical assumption: elastic pools share a network).
            # --elastic-timeout (reference default 600 s): wait for the
            # pool to offer min_np slots before giving up — discovery may
            # be provisioning hosts.
            deadline = time.time() + float(os.environ.get(
                "HVD_TPU_ELASTIC_TIMEOUT", "600"))
            hosts = self._discover_filtered()
            while (sum(h.slots for h in hosts) < self._min_np
                   and time.time() < deadline
                   and not self._shutdown.is_set()):
                time.sleep(self._interval)
                hosts = self._discover_filtered()
            if self._shutdown.is_set():
                return 1  # interrupted while waiting for capacity
            if sum(h.slots for h in hosts) < self._min_np:
                raise RuntimeError(
                    f"not enough slots to reach --min-np {self._min_np} "
                    f"within the elastic timeout")
            remote = [h.hostname for h in hosts
                      if not exec_mod._is_local(h.hostname)]
            if remote:
                from .probe import advertised_driver_host
                rdv_host = advertised_driver_host(
                    remote, ssh_port=self._ssh_port, iface=self._iface)
            else:
                from .rendezvous import advertised_host
                rdv_host = advertised_host()
            self._extra_env["HVD_TPU_RENDEZVOUS_ADDR"] = f"{rdv_host}:{port}"
            self._extra_env["HVD_TPU_RENDEZVOUS_SECRET"] = self._rdv_secret
            self._extra_env["HVD_TPU_ELASTIC"] = "1"
            self._start_round(hosts)
            watcher = threading.Thread(target=self._discovery_loop,
                                       daemon=True)
            watcher.start()
            with self._result_cv:
                self._result_cv.wait_for(lambda: self._result is not None)
            return int(self._result)
        finally:
            self._shutdown.set()
            with self._lock:
                if self._cascade_timer is not None:
                    self._cascade_timer.cancel()
                    self._cascade_timer = None
                exec_mod.terminate_all(list(self._workers.values()))
            self._rendezvous.stop()

    def request_resize(self, np: int, reason: str = "") -> bool:
        """Resize this job's world to ``np`` slots NOW — the public API
        carve-out a scheduler (the fleet gateway) drives, instead of
        mutating the discovery source and waiting for the poll loop.

        Shrinks publish a host event (survivors take the
        ``HostsUpdatedInterrupt`` at their next commit — the checkpoint-
        mediated preemption path) and start a trimmed round, terminating
        removed workers as expected scale-down exits.  Grows lift the cap
        and round up to whatever discovery offers.  The cap persists: the
        discovery loop respects it until the next ``request_resize``.

        Returns False (and changes nothing) when ``np`` < min_np, the job
        already ended, or discovery cannot cover min_np."""
        with self._lock:
            if (self._result is not None or self._shutdown.is_set()
                    or self._succeeded):
                return False
            np = int(np)
            if np < self._min_np:
                return False
            prev_cap = self._np_cap
            self._np_cap = np
            try:
                hosts = self._discover_filtered()
            except RuntimeError:
                hosts = [h for h in self._current_hosts
                         if h.hostname not in self._blacklist]
            if sum(h.slots for h in hosts) < self._min_np:
                # Unlaunchable round: keep the world AND the previous
                # cap — "returns False and changes nothing" must include
                # the cap, or a failed grow would let the discovery loop
                # regrow a shrunk victim past its reservation.
                self._np_cap = prev_cap
                return False
            announced = self._resize_announced
            cur = {h.hostname: h.slots for h in self._current_hosts}
            new = {h.hostname: h.slots for h in hosts}
            if new == cur:
                if announced:
                    # A host event already promised the next round (the
                    # announce raced a failure-path round that consumed
                    # its shape change): workers are parked polling for
                    # it, so publish a fresh round with the unchanged
                    # host set — the cascade-round rule — or they wait
                    # out their fetch timeout and read as failures.
                    self._start_round(hosts)
                return True  # already at the requested shape
            self._metric("hvd_elastic_resize_requests_total",
                         "External resize requests (fleet scheduler)").inc()
            # Flight event (was metrics-only): a scheduler-driven shrink
            # is a preemption the drift diagnoser must see — a job that
            # slows down right after losing slots should name the fleet
            # layer, not read as an unexplained regression.  Grows land
            # as elastic.resize (same correlation table).
            shrinking = sum(new.values()) < sum(cur.values())
            _flight.record(
                "fleet.preempt" if shrinking else "elastic.resize", None,
                mode="shrink" if shrinking else "grow", np=np,
                reason=reason or None)
            if self._verbose:
                print(f"[elastic] resize to {np} slots requested"
                      f"{' (' + reason + ')' if reason else ''}: "
                      f"{cur} -> {new}")
            added_only = (set(cur).issubset(set(new)) and
                          all(new[h] >= cur[h] for h in cur))
            self._publish_host_event(added_only=added_only)
            self._start_round(hosts)
            return True

    def seed_cards(self, card_sets: Dict[str, List[int]]) -> None:
        """Name the cards this job may use on each host: slot ``host:i``
        takes the host's card ``card_sets[host][i]`` (an index into the
        host's cards) instead of card *i*.  The fleet scheduler seeds them
        before each start and resize, so two jobs seated on one host never
        share a card: a shrink frees the tail of the set (the survivors
        keep theirs) and a grow appends free cards.  A host pinned to the
        CPU ignores its set."""
        with self._lock:
            self._card_sets = {h: [int(i) for i in v]
                               for h, v in card_sets.items()}

    def announce_resize(self) -> float:
        """Phase one of a graceful (checkpoint-mediated) resize: publish
        a host event so every worker parks at its next ``commit()`` —
        the ``HostsUpdatedInterrupt`` path — polling for the next round
        instead of entering another collective with about-to-die peers.
        Returns the publish wall time; callers wait for
        ``last_commit()`` newer than it (every rank is then at or past
        that commit) before ``request_resize``/``preempt`` — the world
        changes between steps, never mid-collective."""
        with self._lock:
            self._resize_announced = True
            self._publish_host_event(added_only=False)
        return time.time()

    def preempt(self, reason: str = "") -> bool:
        """Suspend the whole job: every live worker is terminated as an
        expected exit (no blacklist, no failure round) and ``run()``
        returns ``PREEMPTED_EXIT``.  The caller — the fleet gateway —
        requeues the job; its entrypoint resumes from its last committed
        checkpoint when rescheduled.  Returns False if the job already
        ended."""
        with self._lock:
            if (self._result is not None or self._shutdown.is_set()
                    or self._succeeded):
                return False
            self._preempted = True
            self._metric("hvd_elastic_preemptions_total",
                         "Jobs suspended by an external preempt()").inc()
            _flight.record("fleet.preempt", None, mode="suspend",
                           reason=reason or None)
            if self._verbose:
                print(f"[elastic] preempted"
                      f"{' (' + reason + ')' if reason else ''}; "
                      "suspending all workers")
            for sid, w in self._workers.items():
                if w.proc.poll() is None:
                    self._expected_exits[sid] = self._gen.get(sid, 0)
        # run()'s finally terminates the workers once the result lands;
        # setting it outside the lock avoids holding it across the wait.
        self._set_result(PREEMPTED_EXIT)
        return True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def last_commit(self) -> Optional[Dict]:
        """The newest commit announcement workers published to this
        job's rendezvous KV (``elastic/commit``): ``{"ts", "generation",
        "slot"}``, or None before the first commit.  The fleet
        scheduler's evidence for checkpoint-mediated preemption — shrink
        only after the victim committed."""
        blob = self._rendezvous.get("elastic", "commit")
        if blob is None:
            return None
        try:
            return json.loads(blob.decode())
        except (ValueError, UnicodeDecodeError):
            return None

    # -- internals ---------------------------------------------------------

    def _discover_filtered(self) -> List[HostInfo]:
        hosts = self._discovery.find_available_hosts_and_slots()
        hosts = [h for h in hosts if h.hostname not in self._blacklist]
        if self._health_hook is not None:
            try:
                hinted = set(self._health_hook() or ())
            except Exception as e:  # noqa: BLE001 — a hint, not an oracle
                if self._verbose:
                    print(f"[elastic] health hook error (ignored): {e}")
                hinted = set()
            if hinted:
                kept = [h for h in hosts if h.hostname not in hinted]
                # Never hint the job below min-np: a flaky detector must
                # not be able to starve the world a hard failure would.
                if sum(h.slots for h in kept) >= self._min_np:
                    dropped = [h.hostname for h in hosts
                               if h.hostname in hinted]
                    if dropped and self._verbose:
                        print(f"[elastic] health hint excludes "
                              f"{','.join(dropped)} from this round")
                    self._metric("hvd_elastic_health_exclusions_total",
                                 "Hosts excluded by the health "
                                 "hint").inc(len(hosts) - len(kept))
                    if dropped:
                        # A watchdog eviction takes the SAME recovery
                        # path as a crash: the next round's sync tries
                        # the evicted ranks' buddy replicas before the
                        # disk manifest.  Record the eviction so a hang
                        # report (whose `recovery` field then shows the
                        # restore outcome) can tie the two together.
                        self._metric(
                            "hvd_recovery_evictions_total",
                            "Hosts evicted by the health hint whose "
                            "state the peer-restore path must cover")\
                            .inc(len(dropped))
                        from ..debug import flight as _flight
                        _flight.record("recovery.evict", None,
                                       hosts=",".join(sorted(dropped)))
                    hosts = kept
        cap = self._effective_max()
        if cap is not None:
            # Trim to the effective slot cap.
            out, total = [], 0
            for h in hosts:
                if total >= cap:
                    break
                take = min(h.slots, cap - total)
                out.append(HostInfo(h.hostname, take))
                total += take
            hosts = out
        return hosts

    def _effective_max(self) -> Optional[int]:
        """max_np tightened by any external resize cap."""
        caps = [c for c in (self._max_np, self._np_cap) if c is not None]
        return min(caps) if caps else None

    def _slot_id(self, s: SlotInfo) -> str:
        return f"{s.hostname}:{s.local_rank}"

    def _controller_port(self, hostname: str) -> Optional[int]:
        """A fresh port for this round (the controller's, the torch
        store's).  The rank-0 worker binds it on ``hostname``; when that
        is this machine, probe a genuinely free port (two concurrent
        elastic jobs on one host must not collide, as a ``base_port +
        round`` scheme did).  For a remote rank-0 host a local probe
        proves nothing: return None and the round's rank-0 WORKER probes
        a port on its own host and publishes it through the rendezvous KV
        (worker._resolve_auto_addr)."""
        if exec_mod._is_local(hostname):
            from .chips import _free_port
            return _free_port()
        return None

    def _plan_round(self, slots: List[SlotInfo]) -> Dict[str, Dict[str, str]]:
        """Each slot's platform env (``chips.elastic_slot_env``: slot
        ``host:i`` on the host's card *i*, or on the *i*-th card of the set
        ``seed_cards`` gave the host).  Raises when the round cannot
        run one backend: a slot beyond its host's cards, or slots pinned
        to the CPU beside slots on cards."""
        from . import chips
        envs, on_cpu, on_cards, short = {}, {}, [], []
        for s in slots:
            if s.hostname not in self._cards:
                self._cards[s.hostname] = chips.host_cards(s.hostname)
            n, devices = self._cards[s.hostname]
            policy = self._platform_policy
            seeded = self._card_sets.get(s.hostname)
            if seeded is not None and n != 0 and policy != "cpu":
                names = devices if devices is not None else [
                    str(i) for i in range(max(n, max(seeded, default=-1) + 1))]
                n, devices, policy = (len(seeded),
                                      [names[i] for i in seeded], "auto")
            env = chips.elastic_slot_env(s.local_rank, policy, n, devices)
            if env is None:
                short.append(f"{s.hostname} ({n} card(s), slot "
                             f"{s.local_rank})")
            elif env.get("HVD_TPU_WORKER_PLATFORM") == "cpu":
                on_cpu[s.hostname] = (
                    "--worker-platform cpu" if self._platform_policy
                    == "cpu" else "the host has no card")
            else:
                on_cards.append(s.hostname)
            envs[self._slot_id(s)] = env
        if short:
            raise ValueError(
                f"host(s) {', '.join(short)} offer an elastic slot beyond "
                "their cards (each slot takes the card of its index); cap "
                "the slots at the cards, or pass --worker-platform cpu|gpu")
        chips.check_one_platform(on_cpu, on_cards)
        for host, why in on_cpu.items():
            exec_mod.report_pinned(
                host, [s.rank for s in slots if s.hostname == host], why)
        return envs

    def _start_round(self, hosts: List[HostInfo]):
        with self._lock:
            np_ = sum(h.slots for h in hosts)
            slots = get_host_assignments(hosts, np_)
            try:
                self._platform = self._plan_round(slots)
            except ValueError as e:
                print(f"[elastic] round refused: {e}", file=sys.stderr)
                self._set_result(1)
                return
            # Any published round fulfills an outstanding announce: its
            # number is the _round+1 the announce's host event promised
            # (or later), so parked workers' min_round is satisfied.
            self._resize_announced = False
            self._round += 1
            self._metric("hvd_elastic_rounds_total",
                         "Rendezvous rounds published").inc()
            self._gauge("hvd_elastic_world_slots",
                        "Slots in the current round").set(
                sum(h.slots for h in hosts))
            self._gauge("hvd_elastic_blacklisted_hosts",
                        "Hosts on the hard blacklist").set(
                len(self._blacklist))
            self._current_hosts = hosts
            host0 = ("127.0.0.1" if hosts[0].hostname in ("localhost",)
                     else hosts[0].hostname)

            def round_addr():
                port = self._controller_port(hosts[0].hostname)
                return (f"{host0}:{port}" if port is not None
                        else f"auto:{host0}")

            assignment = {
                "round": self._round,
                "size": np_,
                "controller_addr": round_addr(),
                # The round's torch.distributed store, which its rank 0
                # serves (the reference's per-round JAX coordinator).
                "store_addr": round_addr(),
                "slots": {self._slot_id(s): {
                    "rank": s.rank, "size": s.size,
                    "local_rank": s.local_rank, "local_size": s.local_size,
                    "cross_rank": s.cross_rank, "cross_size": s.cross_size,
                } for s in slots},
            }
            self._rendezvous.put("elastic", f"round.{self._round}",
                                 json.dumps(assignment).encode())
            self._rendezvous.put("elastic", "current_round",
                                 str(self._round).encode())
            if self._verbose:
                print(f"[elastic] round {self._round}: "
                      f"{np_} procs on "
                      f"{','.join(h.hostname for h in hosts)}")
            # Terminate workers whose slot left the assignment
            # (scale-down): a stranded worker would time out waiting for
            # a round that can never include it and read as a failure.
            # One batched terminate_all call: per-worker calls would
            # serialize up-to-10 s drain waits under the driver lock.
            wanted = {self._slot_id(s) for s in slots}
            removed = []
            for sid, w in list(self._workers.items()):
                if sid not in wanted and w.proc.poll() is None:
                    self._expected_exits[sid] = self._gen.get(sid, 0)
                    removed.append(w)
                    if self._verbose:
                        print(f"[elastic] slot {sid} removed by "
                              "scale-down; stopping its worker")
            if removed:
                exec_mod.terminate_all(removed)
            # Spawn workers for slots without a live process (a worker the
            # driver already asked to die counts as absent — its exit
            # event is generation-stale once the slot respawns).
            for s in slots:
                sid = self._slot_id(s)
                w = self._workers.get(sid)
                if (w is not None and w.proc.poll() is None
                        and sid not in self._expected_exits):
                    continue  # surviving worker re-rendezvouses in place
                self._spawn(s)

    def _spawn(self, s: SlotInfo, _retry: bool = True):
        sid = self._slot_id(s)
        env = dict(self._extra_env)
        env.update(self._platform[sid])
        env["HVD_TPU_ELASTIC_SLOT"] = sid
        env["HVD_TPU_HOSTNAME"] = s.hostname
        env["HOROVOD_HOSTNAME"] = s.hostname
        self._gen[sid] = gen = self._gen.get(sid, 0) + 1
        # Any scale-down marker belongs to a superseded generation; the
        # replacement's exits are real events.
        self._expected_exits.pop(sid, None)

        def _launch():
            return exec_mod.launch_workers(
                [s], self._command, controller_addr="elastic",
                extra_env=env,
                on_exit=lambda slot, code, sid=sid, gen=gen:
                    self._on_worker_exit(sid, gen, slot, code),
                platform_policy=None,
                ssh_port=self._ssh_port,
                ssh_identity_file=self._ssh_identity_file,
                output_dir=self._output_dir,
                prefix_timestamp=self._prefix_timestamp,
                torch_world=False)

        try:
            ws = _launch()
        except OSError as e:
            # A dropped SSH handshake / transient exec failure gets ONE
            # bounded backed-off retry before it can cost a blacklist +
            # discovery round (hvd.net rung-1 semantics for the spawn
            # plane).  The second failure takes the normal worker-
            # failure path: blacklist + re-rendezvous with survivors.
            if not _retry:
                raise
            from .. import net as _net
            delay_s = _net.Policy.from_env().backoff_ms(
                1, f"spawn.{sid}") / 1e3
            self._metric("hvd_elastic_spawn_retries_total",
                         "Worker spawns retried after a transient "
                         "exec/SSH failure").inc()
            if self._verbose:
                print(f"[elastic] spawn of {sid} failed ({e}); retrying "
                      f"once in {delay_s * 1e3:.0f}ms")
            time.sleep(delay_s)
            ws = _launch()
        self._spawn_ts[sid] = (gen, time.monotonic())
        self._workers[sid] = ws[0]

    def _on_worker_exit(self, sid: str, gen: int, slot: SlotInfo,
                        code: int):
        if self._shutdown.is_set():
            return
        with self._lock:
            if self._gen.get(sid) != gen:
                # A superseded process's exit (the slot respawned since):
                # must not untrack or fail its replacement.  Only its OWN
                # generation's marker may be consumed here.
                if self._expected_exits.get(sid) == gen:
                    self._expected_exits.pop(sid, None)
                if self._succeeded and not self._workers:
                    self._set_result(0)
                return
            self._workers.pop(sid, None)
            self._finished[sid] = code
            if self._expected_exits.get(sid) == gen:
                # Scale-down termination the driver requested: no
                # blacklist, no new round, and never a job failure — but
                # the completion check must still run (this exit may be
                # the last one the driver was waiting on).
                self._expected_exits.pop(sid, None)
                if self._succeeded and not self._workers:
                    self._set_result(0)
                return
            if code == 0:
                # Success of any worker ends the job successfully once all
                # live workers drain (reference: results registered per
                # rank; first completed round wins).
                self._succeeded = True
                if not self._workers:
                    self._set_result(0)
                return
            if self._succeeded:
                # A rank already completed the job: a straggler failing on
                # the way out must not blacklist hosts or spawn a new round.
                if not self._workers:
                    self._set_result(0)
                return
            # SSH-transport exception: exit 255 is ssh's own failure code
            # (connection refused/reset mid-handshake), and arriving
            # within seconds of spawn it means the COMMAND likely never
            # ran.  One respawn credit per (slot, generation) — a single
            # dropped handshake must not cost a blacklist + discovery
            # round.  A second 255, or one outside the window, is treated
            # as the host failure it probably is.
            spawn_gen, spawn_t = self._spawn_ts.get(sid, (None, None))
            if (code == 255 and spawn_gen == gen and spawn_t is not None
                    and time.monotonic() - spawn_t
                    < self._ssh_retry_window_s
                    and (sid, gen) not in self._ssh_retried
                    # One credit per incident: if the RESPAWN also dies
                    # with 255, its predecessor's burned credit denies a
                    # second one — no crash-looping past the blacklist.
                    and (sid, gen - 1) not in self._ssh_retried):
                self._ssh_retried.add((sid, gen))
                self._metric("hvd_elastic_spawn_retries_total",
                             "Worker spawns retried after a transient "
                             "exec/SSH failure").inc()
                if self._verbose:
                    print(f"[elastic] worker {sid} died with ssh exit "
                          f"255 {time.monotonic() - spawn_t:.1f}s after "
                          "spawn; respawning once before blacklist")
                # Backoff + SSH round-trip on a timer, NOT under the
                # exit callback's lock hold — a correlated blip would
                # serialize every other slot's exit handling behind a
                # sleeping respawn.
                from .. import net as _net
                delay_s = _net.Policy.from_env().backoff_ms(
                    1, f"respawn.{sid}") / 1e3

                def _respawn(slot=slot):
                    with self._lock:
                        if (self._shutdown.is_set()
                                or self._result is not None):
                            return
                        self._spawn(slot)

                t = threading.Timer(delay_s, _respawn)
                t.daemon = True
                t.start()
                return
            # Failure: blacklist the host (reference registration.py) and
            # re-rendezvous with the survivors.  CASCADE exception: a
            # failure arriving shortly after another failure is usually
            # collateral damage of the first (a peer death can fatally
            # terminate a survivor that observes the broken world before
            # the elastic reset reaches it) —
            # respawn the worker on its host without condemning the host.
            now = time.monotonic()
            cascade = (self._last_failure_ts is not None and
                       now - self._last_failure_ts <
                       self._cascade_grace_s)
            if cascade:
                # Collateral exit of the incident already being handled:
                # no blacklist, no reset charge.  The slot must NOT be
                # respawned into the CURRENT round: survivors of the
                # broken round re-init with min_round = current+1
                # (core/basics.py fetch_assignment), so they would block
                # on a round this branch never publishes, die on the
                # fetch timeout outside the grace window, and wrongly
                # blacklist a collateral host.  Instead publish ONE
                # fresh round with the unchanged host set — a short
                # debounce folds the incident's other collateral exits
                # into the same round instead of churning survivors
                # with a round per exit.
                if self._verbose:
                    print(f"[elastic] worker {sid} failed (exit {code});"
                          f" cascade within {self._cascade_grace_s:.0f}s"
                          " - scheduling a fresh round (same hosts)")
                self._schedule_cascade_round()
                return
            # Anchor the window at the blacklisting failure (a sliding
            # window would let a fast crash-looper read as an endless
            # cascade and never trip blacklist/min-np).
            self._last_failure_ts = now
            # A real failure resolves the slot's SSH-retry incident; a
            # LATER transient 255 on a fresh generation earns a fresh
            # credit.
            self._ssh_retried = {t for t in self._ssh_retried
                                 if t[0] != sid}
            self._blacklist.add(slot.hostname)
            self._metric("hvd_elastic_worker_failures_total",
                         "Worker failures that blacklisted a host").inc()
            if self._verbose:
                print(f"[elastic] worker {sid} failed (exit {code}); "
                      f"blacklisting {slot.hostname}")
            if self._bump_reset():
                return
            try:
                hosts = self._discover_filtered()
            except RuntimeError:
                hosts = [h for h in self._current_hosts
                         if h.hostname not in self._blacklist]
            live = sum(h.slots for h in hosts)
            if live < self._min_np:
                print(f"[elastic] only {live} slots remain "
                      f"(< min-np {self._min_np}); aborting")
                self._set_result(code if code else 1)
                return
            self._publish_host_event(added_only=False)
            self._start_round(hosts)

    def _schedule_cascade_round(self):
        """Arrange one fresh round (unchanged hosts, no blacklist, no
        reset charge) for a cascade incident; caller holds the lock."""
        if self._cascade_timer is not None:
            return  # a republish for this incident is already pending
        t = threading.Timer(self._cascade_debounce_s, self._cascade_round)
        t.daemon = True
        self._cascade_timer = t
        t.start()

    def _cascade_round(self):
        with self._lock:
            self._cascade_timer = None
            if (self._shutdown.is_set() or self._result is not None
                    or self._succeeded):
                return
            # A blacklist-path round may have been published meanwhile
            # (its _start_round spawns every dead slot); republish only
            # if some slot of the current assignment still lacks a live
            # worker.
            np_ = sum(h.slots for h in self._current_hosts)
            slots = get_host_assignments(self._current_hosts, np_)
            if all(self._slot_id(s) in self._workers for s in slots):
                return
            self._publish_host_event(added_only=False)
            self._start_round(self._current_hosts)

    def _bump_reset(self) -> bool:
        """Count a reset; True (job over) once the limit is exceeded."""
        self._resets += 1
        if self._reset_limit is not None and self._resets > self._reset_limit:
            print(f"[elastic] reset limit {self._reset_limit} exceeded")
            self._set_result(1)
            return True
        return False

    def _set_result(self, code: int):
        with self._result_cv:
            if self._result is None:
                self._result = code
            self._result_cv.notify_all()

    def _publish_host_event(self, added_only: bool):
        # "round" = the round this change leads to; workers already at (or
        # past) it treat the event as stale (they reached the new world
        # through the failure path instead of the interrupt path).
        event = {"ts": time.time(), "added_only": added_only,
                 "round": self._round + 1}
        self._rendezvous.put("elastic", "host_event",
                             json.dumps(event).encode())

    def _discovery_loop(self):
        while not self._shutdown.is_set():
            time.sleep(self._interval)
            try:
                hosts = self._discover_filtered()
            except RuntimeError as e:
                if self._verbose:
                    print(f"[elastic] discovery error: {e}")
                continue
            with self._lock:
                if self._succeeded or self._result is not None:
                    # A rank already completed the job: host churn must not
                    # respawn finished slots in a fresh round.
                    return
                cur = {h.hostname: h.slots for h in self._current_hosts}
                new = {h.hostname: h.slots for h in hosts}
                if new == cur:
                    continue
                if sum(new.values()) < self._min_np:
                    # Shrunk below min-np: do not publish an unlaunchable
                    # round — keep the current one and wait for capacity
                    # (worker failures on lost hosts take the blacklist
                    # path, which enforces min-np with an abort).
                    if self._verbose:
                        print(f"[elastic] capacity {sum(new.values())} < "
                              f"min-np {self._min_np}; waiting")
                    continue
                added_only = (set(cur).issubset(set(new)) and
                              all(new[h] >= cur[h] for h in cur))
                cap = self._effective_max()
                if cap is not None and added_only and \
                        sum(cur.values()) >= cap:
                    continue  # already at capacity
                if self._verbose:
                    print(f"[elastic] host change: {cur} -> {new}")
                self._publish_host_event(added_only=added_only)
                self._bump_reset()
                if self._result is not None:
                    return
                self._start_round(hosts)


def run_elastic(args) -> int:
    """Entry from hvdrun (launch.py) for elastic mode."""
    from .launch import knob_env
    if not args.host_discovery_script:
        raise SystemExit("--host-discovery-script is required for elastic "
                         "mode (with --min-np/--max-np)")
    slots = args.slots or 1
    if getattr(args, "elastic_timeout", None) is not None:
        os.environ["HVD_TPU_ELASTIC_TIMEOUT"] = str(args.elastic_timeout)
    discovery = HostDiscoveryScript(args.host_discovery_script, slots)
    min_np = args.min_np or args.num_proc or 1
    driver = ElasticDriver(
        discovery, args.command, min_np=min_np, max_np=args.max_np,
        reset_limit=args.reset_limit, extra_env=knob_env(args),
        verbose=args.verbose,
        platform_policy=getattr(args, "worker_platform", "auto"),
        iface=getattr(args, "network_interface", None),
        ssh_identity_file=getattr(args, "ssh_identity_file", None),
        output_dir=getattr(args, "output_filename", None),
        prefix_timestamp=getattr(args, "prefix_output_with_timestamp",
                                 False),
        rendezvous_port=getattr(args, "rendezvous_port", None),
        ssh_port=getattr(args, "ssh_port", None))
    return driver.run()
