"""Ray integration — RayExecutor with colocation placement strategies
(port of horovod_tpu/ray/).

Capability parity with the reference horovod/ray (runner.py:121 RayExecutor,
strategy.py placement groups, runner.py:41-119 Coordinator): Ray actors are
placed with pack/spread strategies, a coordinator collects hostnames, ranks
are assigned host-major, the rendezvous env is established on every worker,
and the user function runs as a rank.

Each actor takes the slot of its own host (``worker_slots``; actor 0
is rank 0).  Its env is the launcher's for that slot (``slot_env``), the
torch world that ``init()`` forms through ``env://`` (``MASTER_ADDR``
rank 0's host, ``MASTER_PORT`` a free port that rank 0's actor probes
there) and its device plan: with ``use_gpu`` Ray gives each actor its own card
through ``CUDA_VISIBLE_DEVICES``, so the actor is a partitioned slot and
computes on the first card of its view (``cuda:0``); without it the actor
is a slot pinned to the CPU (``HVD_TPU_WORKER_PLATFORM=cpu``), which
``init()`` runs on gloo.  Placement plans, bundles and the rank
assignment are the reference's.

``ray`` is an optional dependency: the executor raises a clear error at
construction when it is unavailable; the placement/rank math
(``plan_placement``, ``assign_ranks``) is pure Python and testable without
a cluster.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..runner.hosts import HostInfo, SlotInfo, get_host_assignments, slot_env


@dataclass
class PlacementPlan:
    """num_workers actors → bundle list, one bundle per host group.

    ``workers_per_bundle[i]`` says how many actors bundle i hosts; actors
    are pinned to their bundle by index (reference strategy.py colocators
    schedule workers into specific bundles the same way)."""
    bundles: List[Dict[str, float]]
    strategy: str  # "PACK" | "SPREAD" | "STRICT_PACK" | "STRICT_SPREAD"
    workers_per_bundle: List[int]
    cpus_per_worker: float = 1.0
    gpus_per_worker: float = 0.0

    def bundle_index(self, worker: int) -> int:
        b, seen = 0, 0
        for b, k in enumerate(self.workers_per_bundle):
            if worker < seen + k:
                return b
            seen += k
        return b


def plan_placement(num_workers: int, cpus_per_worker: float = 1.0,
                   use_gpu: bool = False, gpus_per_worker: float = 0.0,
                   workers_per_host: Optional[int] = None) -> PlacementPlan:
    """Reference strategy.py: colocate workers_per_host per bundle (PACK)
    or one worker per bundle (SPREAD)."""
    resources = {"CPU": cpus_per_worker}
    if use_gpu:
        resources["GPU"] = gpus_per_worker or 1.0
    if workers_per_host:
        n_hosts = (num_workers + workers_per_host - 1) // workers_per_host
        bundles, per_bundle = [], []
        remaining = num_workers
        for _ in range(n_hosts):
            k = min(workers_per_host, remaining)
            bundles.append({r: v * k for r, v in resources.items()})
            per_bundle.append(k)
            remaining -= k
        return PlacementPlan(bundles=bundles, strategy="STRICT_PACK"
                             if n_hosts == 1 else "PACK",
                             workers_per_bundle=per_bundle,
                             cpus_per_worker=cpus_per_worker,
                             gpus_per_worker=gpus_per_worker if use_gpu
                             else 0.0)
    return PlacementPlan(bundles=[dict(resources)] * num_workers,
                         strategy="SPREAD",
                         workers_per_bundle=[1] * num_workers,
                         cpus_per_worker=cpus_per_worker,
                         gpus_per_worker=gpus_per_worker if use_gpu
                         else 0.0)


def assign_ranks(hostnames: List[str]) -> List[SlotInfo]:
    """Reference Coordinator (ray/runner.py:41-119): group actor hostnames,
    assign ranks host-major so intra-host ranks are adjacent."""
    counts: Dict[str, int] = {}
    for h in hostnames:
        counts[h] = counts.get(h, 0) + 1
    hosts = [HostInfo(h, c) for h, c in counts.items()]
    return get_host_assignments(hosts, len(hostnames))


def worker_slots(hostnames: List[str]) -> List[SlotInfo]:
    """Each actor's slot of ``assign_ranks(hostnames)``: the slot of its
    own host whose local rank is its index among that host's actors
    (``spark._resolve_slot``'s rule).  Slots are host-major, and under
    SPREAD the actors' hosts interleave (a, b, a, b): pairing by position
    would give actor 1, on b, a slot of a, with a's local and cross ranks
    and a's share of the cards."""
    slots = assign_ranks(hostnames)
    seen: Dict[str, int] = {}
    out = []
    for h in hostnames:
        out.append(next(s for s in slots
                        if s.hostname == h and s.local_rank == seen.get(h, 0)))
        seen[h] = seen.get(h, 0) + 1
    return out


class RayExecutor:
    """Run a function as N distributed ranks on a Ray cluster."""

    def __init__(self, num_workers: int, cpus_per_worker: float = 1.0,
                 use_gpu: bool = False, gpus_per_worker: float = 0.0,
                 workers_per_host: Optional[int] = None,
                 controller_port: int = 29000):
        try:
            import ray  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RayExecutor requires the `ray` package; install ray or "
                "use the hvdrun-torch launcher instead") from e
        self.num_workers = num_workers
        self.use_gpu = use_gpu
        self.plan = plan_placement(num_workers, cpus_per_worker, use_gpu,
                                   gpus_per_worker, workers_per_host)
        self._controller_port = controller_port
        self._workers: List[Any] = []

    def start(self):
        import ray

        @ray.remote
        class _Worker:
            def hostname(self):
                return socket.gethostname()

            def free_port(self):
                from ..runner.chips import _free_port
                return _free_port()

            def run(self, fn, env, args, kwargs):
                import os
                os.environ.update(env)
                return fn(*args, **kwargs)

        pg = ray.util.placement_group(self.plan.bundles,
                                      strategy=self.plan.strategy)
        ray.get(pg.ready())
        self._pg = pg
        # Pin each actor to its bundle (reference strategy.py colocators):
        # without the index, Ray may place all actors in one bundle and
        # the PACK/SPREAD intent is lost.
        self._workers = []
        for i in range(self.num_workers):
            bundle = self.plan.bundle_index(i)
            try:
                from ray.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
                opts = {"scheduling_strategy":
                        PlacementGroupSchedulingStrategy(
                            placement_group=pg,
                            placement_group_bundle_index=bundle)}
            except ImportError:  # older ray: legacy options
                opts = {"placement_group": pg,
                        "placement_group_bundle_index": bundle}
            # The bundle holds a card a worker under use_gpu whatever
            # gpus_per_worker says (plan_placement), and the actor asks
            # for it: Ray then sets the actor's CUDA_VISIBLE_DEVICES.
            gpus = self.plan.gpus_per_worker or (1.0 if self.use_gpu
                                                 else 0.0)
            if gpus:
                opts["num_gpus"] = gpus
            self._workers.append(
                _Worker.options(num_cpus=self.plan.cpus_per_worker,
                                **opts).remote())
        self._hostnames = ray.get(
            [w.hostname.remote() for w in self._workers])

    def run(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """``fn`` on every actor as its rank; the results in rank order."""
        import ray
        kwargs = kwargs or {}
        slots = worker_slots(self._hostnames)
        controller_addr = (f"{slots[0].hostname}:"
                           f"{self._controller_port}")
        world = {
            "MASTER_ADDR": ("127.0.0.1" if len(set(self._hostnames)) == 1
                            else slots[0].hostname),
            "MASTER_PORT": str(ray.get(self._workers[0].free_port.remote())),
        }
        futures = []
        for worker, slot in zip(self._workers, slots):
            env = slot_env(slot, controller_addr)
            env.update(world)
            env.update(self._device_env(slot))
            futures.append(worker.run.remote(fn, env, args, kwargs))
        results = ray.get(futures)
        return [results[i] for i in sorted(range(len(slots)),
                                           key=lambda i: slots[i].rank)]

    def _device_env(self, slot: SlotInfo) -> Dict[str, str]:
        """With GPUs, Ray sets each actor's ``CUDA_VISIBLE_DEVICES`` to the
        cards it assigned: the actor is a partitioned slot and takes the
        first card of that view.  Without, the actor is pinned to the
        CPU."""
        from ..runner.chips import CPU_ENV, PARTITION_ENV
        if self.use_gpu:
            return {PARTITION_ENV: f"{slot.local_rank}/{slot.local_size}"}
        return dict(CPU_ENV)

    def shutdown(self):
        import ray
        for w in self._workers:
            ray.kill(w)
        self._workers = []
        pg = getattr(self, "_pg", None)
        if pg is not None:
            try:
                ray.util.remove_placement_group(pg)
            except Exception:  # noqa: BLE001 — cluster may be going down
                pass
            self._pg = None


class RayHostDiscovery:
    """HostDiscovery over the Ray cluster inventory (reference
    horovod/ray/elastic.py RayHostDiscovery): every alive Ray node with
    enough CPUs (or GPUs when use_gpu) contributes slots."""

    def __init__(self, use_gpu: bool = False, cpus_per_slot: float = 1.0,
                 gpus_per_slot: float = 1.0):
        self.use_gpu = use_gpu
        self.cpus_per_slot = cpus_per_slot
        self.gpus_per_slot = gpus_per_slot

    def find_available_hosts_and_slots(self) -> List[HostInfo]:
        import ray
        hosts: List[HostInfo] = []
        for node in ray.nodes():
            if not node.get("Alive"):
                continue
            res = node.get("Resources", {})
            if self.use_gpu:
                slots = int(res.get("GPU", 0) // self.gpus_per_slot)
            else:
                slots = int(res.get("CPU", 0) // self.cpus_per_slot)
            if slots > 0:
                hosts.append(HostInfo(node.get("NodeManagerHostname",
                                               node.get("NodeID", "?")),
                                      slots))
        return sorted(hosts, key=lambda h: h.hostname)


def submit_to_fleet(command: List[str], min_np: int = 1,
                    max_np: Optional[int] = None, priority: int = 0,
                    tenant: str = "default", gateway: Optional[str] = None,
                    secret: Optional[str] = None, wait: bool = False):
    """Fleet-mode front door: submit a worker command through the job
    gateway instead of assuming this Ray driver owns the device fleet
    Returns the JobRecord (terminal when ``wait``)."""
    from ..fleet import JobSpec, client
    rec = client.submit_job(
        JobSpec(command=list(command), min_np=min_np, max_np=max_np,
                priority=priority, tenant=tenant),
        addr=gateway, secret=secret)
    if wait and rec.state == "queued":
        rec = client.wait_job(rec.id, addr=gateway, secret=secret)
    return rec


class ElasticRayExecutor:
    """Elastic variant: the ElasticDriver polls RayHostDiscovery and
    respawns worker commands as the Ray cluster grows or shrinks
    (reference horovod/ray/elastic.py ElasticRayExecutor wiring
    RayHostDiscovery into the elastic driver)."""

    def __init__(self, min_np: int = 1, max_np: Optional[int] = None,
                 use_gpu: bool = False, cpus_per_slot: float = 1.0,
                 reset_limit: Optional[int] = None,
                 controller_port: int = 29000):
        try:
            import ray  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ElasticRayExecutor requires the `ray` package") from e
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.use_gpu = use_gpu
        self.discovery = RayHostDiscovery(use_gpu=use_gpu,
                                          cpus_per_slot=cpus_per_slot)
        self._controller_port = controller_port

    def run(self, command: List[str], gateway: Optional[str] = None,
            secret: Optional[str] = None) -> int:
        """Drive the job on this Ray cluster — or, with ``gateway=``,
        submit it through a fleet gateway and wait: the executor then
        shares the device fleet with other tenants instead of owning
        it."""
        if gateway is not None:
            rec = submit_to_fleet(list(command), min_np=self.min_np,
                                  max_np=self.max_np, gateway=gateway,
                                  secret=secret, wait=True)
            return 0 if rec.state == "done" else 1
        from ..runner.elastic_driver import ElasticDriver
        # A slot takes its host's card by the driver's plan with GPUs,
        # and is pinned to the CPU without, as RayExecutor's actors are.
        driver = ElasticDriver(
            discovery=self.discovery, command=list(command),
            min_np=self.min_np, max_np=self.max_np,
            controller_base_port=self._controller_port,
            reset_limit=self.reset_limit,
            platform_policy="auto" if self.use_gpu else "cpu")
        return driver.run()
