"""``horovod_tpu_torch.ray`` against ``horovod_tpu.ray``.

The placement plans (bundles, strategy, workers a bundle, the resources
a worker), GPU bundles included, equal the reference's over a grid of
worker counts, workers per host and resources, and its goldens
(tests/test_integrations.py:10-42); so do ``assign_ranks`` and
``RayHostDiscovery`` over a fake node list.  Through a fake ``ray``
(``_torch_port_fake_ray.py``, after tests/test_integrations.py:85-160's:
its actors run in this process, and it sets each GPU actor's
``CUDA_VISIBLE_DEVICES`` to the cards it assigned, as Ray does),
``RayExecutor`` pins each actor to its bundle, gives each the slot of
its own host when SPREAD interleaves the hosts, and returns the results
in rank order; each actor's env is the port's ``slot_env`` plus the
torch world
(one ``MASTER_ADDR``/``MASTER_PORT``) and its device plan: with
``use_gpu`` a partitioned slot, on which ``basics.device_index`` answers
0, without it a slot pinned to the CPU.  One actor runs a real gloo
world.  ``ElasticRayExecutor`` drives the port's elastic driver over a
fake one-host cluster; ``submit_to_fleet`` hands the job to the fleet
client."""

import itertools
import os
import sys
import types

import pytest

import horovod_tpu.ray as ref_ray
import horovod_tpu_torch.ray as port_ray
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.runner.hosts import slot_env

from _torch_port_fake_ray import fake_ray_modules


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_placement_plans_equal_reference(n):
    for per_host, use_gpu, gpus, cpus in itertools.product(
            [None, 1, 2, 3, 4, 8], [False, True], [0.0, 0.5, 2.0],
            [1.0, 2.0]):
        kw = dict(cpus_per_worker=cpus, use_gpu=use_gpu,
                  gpus_per_worker=gpus, workers_per_host=per_host)
        got, want = port_ray.plan_placement(n, **kw), \
            ref_ray.plan_placement(n, **kw)
        assert vars(got) == vars(want), kw
        assert [got.bundle_index(w) for w in range(n)] == \
            [want.bundle_index(w) for w in range(n)]


def test_placement_goldens():
    plan = port_ray.plan_placement(4, cpus_per_worker=2.0)
    assert plan.strategy == "SPREAD"
    assert plan.bundles == [{"CPU": 2.0}] * 4
    plan = port_ray.plan_placement(8, cpus_per_worker=1.0,
                                   workers_per_host=4)
    assert plan.strategy == "PACK"
    assert plan.bundles == [{"CPU": 4.0}, {"CPU": 4.0}]
    plan = port_ray.plan_placement(4, workers_per_host=8)
    assert plan.strategy == "STRICT_PACK"
    assert plan.bundles == [{"CPU": 4.0}]
    plan = port_ray.plan_placement(2, use_gpu=True, gpus_per_worker=1.0)
    assert all(b["GPU"] == 1.0 for b in plan.bundles)


@pytest.mark.parametrize("hostnames", [["a", "b", "a", "b"], ["x"],
                                       ["c", "c", "a", "b", "a", "c"]])
def test_assign_ranks_equals_reference(hostnames):
    assert [vars(s) for s in port_ray.assign_ranks(hostnames)] == \
        [vars(s) for s in ref_ray.assign_ranks(hostnames)]


def test_gated_without_ray():
    for pkg in (ref_ray, port_ray):
        with pytest.raises(ImportError, match="ray"):
            pkg.RayExecutor(num_workers=2)
        with pytest.raises(ImportError, match="ray"):
            pkg.ElasticRayExecutor(min_np=1)


def test_ray_host_discovery_equals_reference(monkeypatch):
    _install_fake_ray(monkeypatch, {}, nodes=[
        {"Alive": True, "NodeManagerHostname": "b",
         "Resources": {"CPU": 4.0}},
        {"Alive": True, "NodeManagerHostname": "a",
         "Resources": {"CPU": 2.0, "GPU": 1.0}},
        {"Alive": False, "NodeManagerHostname": "dead",
         "Resources": {"CPU": 8.0}},
        {"Alive": True, "NodeManagerHostname": "nores", "Resources": {}},
        {"Alive": True, "NodeID": "n5", "Resources": {"GPU": 4.0,
                                                      "CPU": 3.0}},
    ])
    for kw in ({}, {"use_gpu": True}, {"cpus_per_slot": 2.0},
               {"use_gpu": True, "gpus_per_slot": 2.0}):
        got = port_ray.RayHostDiscovery(**kw).find_available_hosts_and_slots()
        want = ref_ray.RayHostDiscovery(**kw).find_available_hosts_and_slots()
        assert [(h.hostname, h.slots) for h in got] == \
            [(h.hostname, h.slots) for h in want]


def _install_fake_ray(monkeypatch, record, **kw):
    for name, module in fake_ray_modules(record, **kw).items():
        monkeypatch.setitem(sys.modules, name, module)


@pytest.fixture
def env_snapshot():
    """Fake actors run in this process and export their env into it."""
    snapshot = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(snapshot)


def _actor_view():
    """What an actor's function sees: its env and the card ``init()``
    would take."""
    keys = [k for k in os.environ if k.startswith(("HVD_TPU_", "HOROVOD_"))
            or k in ("MASTER_ADDR", "MASTER_PORT", "CUDA_VISIBLE_DEVICES")]
    env = {k: os.environ[k] for k in keys}
    return env, basics.device_index(int(os.environ["HVD_TPU_LOCAL_RANK"]))


@pytest.mark.parametrize("use_gpu", [False, True])
def test_executor_pins_actors_and_exports_each_env(use_gpu, monkeypatch,
                                                   env_snapshot):
    record = {}
    _install_fake_ray(monkeypatch, record)
    for k in ("CUDA_VISIBLE_DEVICES", "HVD_TPU_DEVICE_PARTITION",
              "HVD_TPU_WORKER_PLATFORM"):
        monkeypatch.delenv(k, raising=False)
    ex = port_ray.RayExecutor(num_workers=4, cpus_per_worker=2.0,
                              workers_per_host=2, use_gpu=use_gpu)
    ex.start()
    want_plan = ref_ray.plan_placement(4, 2.0, use_gpu, 0.0, 2)
    assert record["pg"].strategy == want_plan.strategy == "PACK"
    assert record["pg"].bundles == want_plan.bundles
    assert [o["scheduling_strategy"].placement_group_bundle_index
            for o in record["actor_opts"]] == [0, 0, 1, 1]
    assert all(o["num_cpus"] == 2.0 for o in record["actor_opts"])
    assert [o.get("num_gpus") for o in record["actor_opts"]] == \
        ([1.0] * 4 if use_gpu else [None] * 4)
    views = ex.run(_actor_view)
    slots = port_ray.assign_ranks(ex._hostnames)
    ports = {v["MASTER_PORT"] for v, _ in views}
    assert len(ports) == 1 and ports != {""}
    port = ports.pop()
    for (env, index), slot in zip(views, slots):
        want = slot_env(slot, f"{slots[0].hostname}:29000")
        want.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        if use_gpu:
            want["HVD_TPU_DEVICE_PARTITION"] = \
                f"{slot.local_rank}/{slot.local_size}"
            want["CUDA_VISIBLE_DEVICES"] = str(slot.rank)
            assert index == 0
        else:
            want.update(HVD_TPU_WORKER_PLATFORM="cpu",
                        CUDA_VISIBLE_DEVICES="")
        assert env == want
    ex.shutdown()
    assert len(record["killed"]) == 4
    assert record["pg_removed"] is record["pg"]


@pytest.mark.parametrize("hostnames", [["a", "b", "a", "b"],
                                       ["b", "a", "a", "c", "b"]])
def test_spread_actors_take_their_own_hosts_slots(hostnames, monkeypatch,
                                                  env_snapshot):
    """Under SPREAD the actors' hosts interleave: each actor's slot is one
    of its own host's, its local rank its index among that host's actors,
    actor 0 is rank 0, and ``run`` returns the ranks' results in rank
    order; the slots are ``assign_ranks``'s, the reference's."""
    _install_fake_ray(monkeypatch, {}, hostnames=hostnames)
    n = len(hostnames)
    ex = port_ray.RayExecutor(num_workers=n)
    ex.start()
    assert ex.plan.strategy == "SPREAD"
    views = ex.run(_actor_view)
    envs = [env for env, _ in views]
    assert [e["HVD_TPU_RANK"] for e in envs] == [str(r) for r in range(n)]
    want = {s.rank: vars(s) for s in ref_ray.assign_ranks(hostnames)}
    by_rank = {int(e["HVD_TPU_RANK"]): e for e in envs}
    for i, host in enumerate(hostnames):
        slot = port_ray.worker_slots(hostnames)[i]
        assert slot.hostname == host
        assert slot.local_rank == hostnames[:i].count(host)
        assert vars(slot) == want[slot.rank]
        e = by_rank[slot.rank]
        assert e["HVD_TPU_HOSTNAME"] == host
        assert e["HVD_TPU_LOCAL_RANK"] == str(slot.local_rank)
        assert e["HVD_TPU_CROSS_RANK"] == str(slot.cross_rank)
    assert port_ray.worker_slots(hostnames)[0].rank == 0
    ex.shutdown()


def test_gpu_actor_without_a_card_refuses(monkeypatch, env_snapshot):
    """``use_gpu`` actors compute on the card: on a machine without one
    the actor's ``init()`` raises, and nothing carries on on the CPU."""
    import torch
    _install_fake_ray(monkeypatch, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HVD_TPU_WORKER_PLATFORM", raising=False)

    def fn():
        import horovod_tpu_torch as hvd
        hvd.init(use_controller=False)

    ex = port_ray.RayExecutor(num_workers=1, use_gpu=True)
    ex.start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run(fn)
    ex.shutdown()


def test_one_cpu_actor_runs_a_real_world(monkeypatch, env_snapshot):
    _install_fake_ray(monkeypatch, {})

    def fn(base):
        import torch
        import horovod_tpu_torch as hvd
        hvd.init(use_controller=False)
        out = hvd.allreduce(torch.tensor([float(hvd.rank() + base)]),
                            op=hvd.Sum)
        got = (hvd.rank(), hvd.size(), str(hvd.device()), float(out[0]))
        hvd.shutdown()
        return got

    ex = port_ray.RayExecutor(num_workers=1)
    ex.start()
    assert ex.run(fn, args=(2.0,)) == [(0, 1, "cpu", 2.0)]
    ex.shutdown()


def test_elastic_ray_executor_runs_driver(monkeypatch, tmp_path):
    """The port's ElasticDriver over a fake one-host ray cluster: the
    command runs as two ranks, each a slot pinned to the CPU (no
    ``use_gpu``), and exits 0."""
    _install_fake_ray(monkeypatch, {}, nodes=[
        {"Alive": True, "NodeManagerHostname": "localhost",
         "Resources": {"CPU": 2.0}}])
    monkeypatch.setenv("HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", "0.1")
    marker = tmp_path / "ran.txt"
    ex = port_ray.ElasticRayExecutor(min_np=2, max_np=2)
    code = ex.run([sys.executable, "-c",
                   "import os;"
                   f"open(r'{marker}','a').write(os.environ['HVD_TPU_RANK']"
                   "+':'+os.environ.get('HVD_TPU_WORKER_PLATFORM','')"
                   "+'\\n')"])
    assert code == 0
    assert sorted(marker.read_text().split()) == ["0:cpu", "1:cpu"]


def test_submit_to_fleet_hands_the_job_to_the_client(monkeypatch):
    from horovod_tpu_torch.fleet import client
    calls = []

    def submit_job(spec, addr=None, secret=None):
        calls.append(("submit", spec, addr, secret))
        return types.SimpleNamespace(id="j1", state="queued")

    def wait_job(job_id, addr=None, secret=None):
        calls.append(("wait", job_id, addr, secret))
        return types.SimpleNamespace(id=job_id, state="done")

    monkeypatch.setattr(client, "submit_job", submit_job)
    monkeypatch.setattr(client, "wait_job", wait_job)
    rec = port_ray.submit_to_fleet(["python", "t.py"], min_np=2, max_np=4,
                                   priority=3, tenant="t", gateway="g:1",
                                   secret="s", wait=True)
    assert rec.state == "done"
    spec = calls[0][1]
    assert (spec.command, spec.min_np, spec.max_np, spec.priority,
            spec.tenant) == (["python", "t.py"], 2, 4, 3, "t")
    assert calls[1] == ("wait", "j1", "g:1", "s")
