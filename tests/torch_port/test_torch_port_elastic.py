"""horovod_tpu_torch's elastic plane against horovod_tpu's, in one process:
the host and slot arithmetic, the launch command, the worker's rendezvous
client, the driver's soft exclusions, the peer-failure guard and world
watch (core/failure.py), the worker notification's stale-event filter,
and the elastic loop's hooks into the telemetry (the aggregator's
cadence after a reset, the attribution's re-anchor after the sync).

The driver drills (workers spawned and killed) are in
test_torch_port_elastic_drills*.py, the ``TpuState`` drills on four gloo
ranks in test_torch_port_elastic_state.py."""

import json
import os
import socket
import time

import pytest
import torch

from horovod_tpu.runner import exec as exec_jax
from horovod_tpu.runner import hosts as hosts_jax
from horovod_tpu.runner import worker as worker_jax
from horovod_tpu_torch.core import failure
from horovod_tpu_torch.core.exceptions import (HorovodInternalError,
                                               HostsUpdatedInterrupt)
from horovod_tpu_torch.runner import exec as exec_t
from horovod_tpu_torch.runner import hosts as hosts_t
from horovod_tpu_torch.runner import worker as worker_t
from horovod_tpu_torch.runner.rendezvous import RendezvousServer

H = hosts_t.HostInfo

HOST_LISTS = [
    ("h1:2,h2:4", 6, None, None),
    ("h1:2,h2:4", 4, None, None),
    ("h1:2,h2:4", 6, 2, 3),
    ("a,b:3, c:1,,", 5, None, None),
    ("a:1,b:1,c:1,d:1", 3, 2, None),
    ("x:8", 8, None, 8),
    ("x:3,y:3,z:2", 8, 4, 6),
]


@pytest.mark.parametrize("spec,np_,min_np,max_np", HOST_LISTS)
def test_host_assignments_equal_reference(spec, np_, min_np, max_np):
    got = hosts_t.get_host_assignments(hosts_t.parse_hosts(spec), np_,
                                       min_np=min_np, max_np=max_np)
    want = hosts_jax.get_host_assignments(hosts_jax.parse_hosts(spec), np_,
                                          min_np=min_np, max_np=max_np)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    for s, r in zip(got, want):
        assert hosts_t.slot_env(s, "c:1") == hosts_jax.slot_env(r, "c:1")


@pytest.mark.parametrize("hosts,np_,min_np", [
    ([H("a", 1)], 2, None), ([H("a", 2), H("b", 1)], 4, 4),
    ([], 1, None)])
def test_insufficient_hosts_raise_as_reference(hosts, np_, min_np):
    """reference tests/test_runner.py:37-47."""
    with pytest.raises(ValueError) as got:
        hosts_t.get_host_assignments(hosts, np_, min_np=min_np)
    with pytest.raises(ValueError) as want:
        hosts_jax.get_host_assignments(
            [hosts_jax.HostInfo(h.hostname, h.slots) for h in hosts], np_,
            min_np=min_np)
    assert str(got.value) == str(want.value)
    assert "slots" in str(got.value)


def test_hostfile_equals_reference(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text("# the pool\nnode1 slots=4\nnode2:2  # two\n\n"
                    "node3 slots=1 max_slots=8\nnode4\n")
    assert [vars(h) for h in hosts_t.parse_hostfile(str(path))] == \
        [vars(h) for h in hosts_jax.parse_hostfile(str(path))]


@pytest.mark.parametrize("host", ["localhost", "127.0.0.1", "remote-node"])
def test_build_command_equals_reference_and_keeps_the_secret_off_argv(
        host):
    slot_t = hosts_t.get_host_assignments([H(host, 1)], 1)[0]
    slot_j = hosts_jax.get_host_assignments(
        [hosts_jax.HostInfo(host, 1)], 1)[0]
    env = {"HVD_TPU_RENDEZVOUS_SECRET": "s3cr3t-token",
           "HVD_TPU_RANK": "0", "PATH_LIKE": "a b"}
    cmd = ["python", "train.py", "--flag", "x y"]
    got = exec_t.build_command(slot_t, cmd, env, ssh_port=2222,
                               ssh_identity_file="/k")
    assert got == exec_jax.build_command(slot_j, cmd, env, ssh_port=2222,
                                         ssh_identity_file="/k")
    argv, payload = got
    assert not any("s3cr3t-token" in a for a in argv)
    if host == "remote-node":
        assert argv[0] == "ssh" and payload == "s3cr3t-token\n"
    else:
        assert argv == cmd and payload is None


def test_launch_workers_refuses_a_chip_plan():
    slot = hosts_t.get_host_assignments([H("localhost", 1)], 1)[0]
    for kwargs in ({"platform_policy": "partition"},
                   {"cpu_jax_world": True}):
        with pytest.raises(ValueError):
            exec_t.launch_workers([slot], ["true"], "c:1", **kwargs)


def test_launch_workers_runs_the_slot_env_and_fails_fast(tmp_path):
    slots = hosts_t.get_host_assignments([H("localhost", 2)], 2)
    out = tmp_path / "env"
    code = ("import os, sys, time; "
            f"open({str(out)!r} + os.environ['HVD_TPU_RANK'], 'w').write("
            "os.environ['HVD_TPU_LOCAL_SIZE'] + os.environ['EXTRA']); "
            "sys.exit(3) if os.environ['HVD_TPU_RANK'] == '1' "
            "else time.sleep(30)")
    workers = exec_t.launch_workers(
        slots, ["python", "-c", code], "c:1", extra_env={"EXTRA": "x"},
        prefix_output=False)
    t0 = time.monotonic()
    assert exec_t.wait_all(workers, timeout=60) == 3
    assert time.monotonic() - t0 < 20   # the sleeper was terminated
    assert (tmp_path / "env1").read_text() == "2x"


# ---------------------------------------------------------------------------
# the worker's rendezvous client
# ---------------------------------------------------------------------------

@pytest.fixture
def kv(monkeypatch):
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", f"127.0.0.1:{port}")
    monkeypatch.delenv("HVD_TPU_RENDEZVOUS_SECRET", raising=False)
    yield server
    server.stop()


def _publish(kv, rnd, slots, ctl="127.0.0.1:4000", store="127.0.0.1:4001"):
    kv.put("elastic", f"round.{rnd}", json.dumps({
        "round": rnd, "size": len(slots), "controller_addr": ctl,
        "store_addr": store, "jax_coord_addr": None,
        "slots": {sid: {"rank": r, "size": len(slots), "local_rank": r,
                        "local_size": len(slots), "cross_rank": 0,
                        "cross_size": 1}
                  for r, sid in enumerate(slots)}}).encode())
    kv.put("elastic", "current_round", str(rnd).encode())


def test_fetch_assignment_takes_the_newest_round_with_this_slot(
        kv, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "h:1")
    _publish(kv, 0, ["h:0", "h:1"])
    got = worker_t.fetch_assignment(min_round=0, timeout=5)
    want = worker_jax.fetch_assignment(min_round=0, timeout=5)
    assert got["rank"] == want["rank"] == 1
    assert (got["round"], got["size"], got["controller_addr"]) == \
        (want["round"], want["size"], want["controller_addr"])
    assert got["store_addr"] == "127.0.0.1:4001"
    # A worker that left round 0 waits for a newer one.
    with pytest.raises(TimeoutError):
        worker_t.fetch_assignment(min_round=1, timeout=0.5)
    _publish(kv, 1, ["h:1"])
    assert worker_t.fetch_assignment(min_round=1, timeout=5)["rank"] == 0


def test_auto_addresses_resolve_through_rank_0(kv, monkeypatch):
    """``auto:<host>``: the round's rank 0 publishes a port of its own
    host under one key per round and address; its peers poll it."""
    _publish(kv, 3, ["h:0", "h:1"], ctl="auto:h", store="auto:h")
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "h:0")
    mine = worker_t.fetch_assignment(min_round=3, timeout=5)
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "h:1")
    peer = worker_t.fetch_assignment(min_round=3, timeout=5)
    for field, key in (("controller_addr", "ctlport.3"),
                       ("store_addr", "storeport.3")):
        port = int(kv.get("elastic", key).decode())
        assert mine[field] == peer[field] == f"h:{port}"


def test_poll_host_event_equals_reference(kv):
    assert worker_t.poll_host_event(0.0) is None
    kv.put("elastic", "host_event", json.dumps(
        {"ts": 5.0, "added_only": True, "round": 2}).encode())
    for last in (0.0, 4.9, 5.0, 6.0):
        assert worker_t.poll_host_event(last) == \
            worker_jax.poll_host_event(last)


# ---------------------------------------------------------------------------
# the driver's soft exclusions (reference tests/test_metrics.py:412)
# ---------------------------------------------------------------------------

def test_elastic_driver_health_hook_soft_excludes_hosts():
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    hosts = [H("a", 2), H("b", 2), H("c", 2)]
    hints = {"c"}
    driver = ElasticDriver(FixedHosts(hosts), ["true"], min_np=2,
                           max_np=None, health_hook=lambda: hints)
    try:
        assert [h.hostname for h in driver._discover_filtered()] == \
            ["a", "b"]
        # A hint never pushes the world below min-np.
        hints = {"a", "b", "c"}
        assert [h.hostname for h in driver._discover_filtered()] == \
            ["a", "b", "c"]
        # A crashing hook is ignored: a hint, not an oracle.
        driver._health_hook = lambda: 1 / 0
        assert [h.hostname for h in driver._discover_filtered()] == \
            ["a", "b", "c"]
        # The resize cap trims as max_np does.
        driver._np_cap = 3
        assert [(h.hostname, h.slots)
                for h in driver._discover_filtered()] == [("a", 2),
                                                          ("b", 1)]
    finally:
        driver._rendezvous.stop()


def test_driver_refuses_remote_hosts_naming_the_nic_probe(monkeypatch):
    """The NIC probe is ported, so a remote host is no longer refused:
    the driver asks the probe for the address it advertises to the
    remote hosts, with the launch's ssh port and interface (the probe
    stands in here and stops the run; test_torch_port_launch_ssh.py
    drives the real one)."""
    from horovod_tpu_torch.runner import probe
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    seen = {}

    def advertised_driver_host(hosts, ssh_port=None, iface=None):
        seen.update(hosts=hosts, ssh_port=ssh_port, iface=iface)
        raise RuntimeError("NIC probe stand-in")

    monkeypatch.setattr(probe, "advertised_driver_host",
                        advertised_driver_host)
    driver = ElasticDriver(FixedHosts([H("remote-node", 1)]), ["true"],
                           min_np=1, max_np=1, ssh_port=2299, iface="lo")
    with pytest.raises(RuntimeError, match="NIC probe"):
        driver.run()
    assert seen == {"hosts": ["remote-node"], "ssh_port": 2299,
                    "iface": "lo"}


# ---------------------------------------------------------------------------
# peer-failure detection (core/failure.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_failure():
    failure.stop_watch()
    failure.reset()
    yield
    failure.stop_watch()
    failure.reset()


@pytest.mark.parametrize("elastic", [True, False])
@pytest.mark.parametrize("exc,backend", [
    (RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by "
                  "peer [127.0.0.1]:1234"), True),
    (RuntimeError("NCCL communicator was aborted on rank 1"), True),
    (torch.distributed.DistBackendError("watchdog timeout"), True),
    (RuntimeError("shape mismatch in all_gather"), False),
    (ValueError("not a backend failure"), False),
])
def test_guard_turns_backend_failures_into_internal_errors(
        kv, clean_failure, exc, backend, elastic):
    """In an elastic world a backend error marks the world failed and
    comes out as ``HorovodInternalError``; in any other job every error
    comes out unchanged and nothing is marked."""
    if elastic:
        kv.put("elastic", "current_round", b"0")
        failure.start_watch(0)
    converts = backend and elastic
    with pytest.raises(HorovodInternalError if converts else type(exc)) \
            as raised:
        with failure.guard():
            raise exc
    if not converts:
        assert raised.value is exc
    assert (failure.failed() is not None) == converts
    if converts:
        # Once marked, every later collective raises before the wire.
        ran = []
        with pytest.raises(HorovodInternalError):
            with failure.guard():
                ran.append(1)
        assert ran == []


@pytest.mark.parametrize("added_only,fails", [(True, False),
                                              (False, True)])
def test_world_watch_marks_failure_rounds_only(kv, clean_failure,
                                               added_only, fails):
    """A round published past this worker's fails its world unless its
    host event is a pure growth (the peers all live; the interrupt comes
    at the next commit)."""
    kv.put("elastic", "current_round", b"0")
    failure.start_watch(0)
    assert failure.watching()
    time.sleep(3 * failure.WATCH_INTERVAL_S)
    assert failure.failed() is None
    kv.put("elastic", "host_event", json.dumps(
        {"ts": time.time(), "added_only": added_only,
         "round": 1}).encode())
    t0 = time.monotonic()
    kv.put("elastic", "current_round", b"1")
    while failure.failed() is None and time.monotonic() - t0 < 2.0:
        time.sleep(0.01)
    assert (failure.failed() is not None) == fails
    if fails:
        assert time.monotonic() - t0 < 1.0
        assert "round 1" in failure.failed()
        with pytest.raises(HorovodInternalError):
            failure.check()
    failure.stop_watch()
    assert not failure.watching()


class _Beacon:
    """A stand-in for a beacon's CUDA event."""

    def __init__(self, reached):
        self.reached = reached

    def query(self):
        return self.reached


@pytest.mark.parametrize("stuck", [True, False])
def test_world_watch_fails_a_card_past_the_deadline(kv, clean_failure,
                                                     monkeypatch, stuck):
    """A beacon (an event on the card's stream, ``failure.beacon``) still
    pending past the operation deadline fails the world with no round
    published: a peer hung alive holds a collective before it.  Beacons
    reached are dropped."""
    monkeypatch.setenv("HVD_TPU_NET_OP_DEADLINE_S", "0.3")
    kv.put("elastic", "current_round", b"0")
    failure.start_watch(0)
    t0 = time.monotonic()
    failure._beacons.extend([(t0, _Beacon(True)), (t0, _Beacon(not stuck))])
    while failure.failed() is None and time.monotonic() - t0 < 1.5:
        time.sleep(0.01)
    assert (failure.failed() is not None) == stuck
    if stuck:
        assert 0.3 <= time.monotonic() - t0 < 1.0
        assert "deadline" in failure.failed()
    else:
        assert not failure._beacons


@pytest.mark.parametrize("round_", [0, 3])
def test_world_watch_publishes_and_follows_a_members_verdict(
        kv, clean_failure, monkeypatch, round_):
    """A member that fails its world publishes the verdict under
    ``elastic/world_failed_<round>``; a watch that finds it there fails
    its own world at once, and does not publish again.  Another round's
    verdict is not this world's."""
    kv.put("elastic", "current_round", str(round_).encode())
    kv.put("elastic", "world_failed_9", b"an older world")
    failure.start_watch(round_)
    time.sleep(3 * failure.WATCH_INTERVAL_S)
    assert failure.failed() is None
    t0 = time.monotonic()
    kv.put("elastic", f"world_failed_{round_}", b"rank 1's deadline")
    while failure.failed() is None and time.monotonic() - t0 < 2.0:
        time.sleep(0.01)
    assert time.monotonic() - t0 < 1.0
    assert failure.failed() == (f"a member of round {round_} failed the "
                                "world: rank 1's deadline")
    assert kv.get("elastic", f"world_failed_{round_}") == \
        b"rank 1's deadline"
    failure.stop_watch()
    # A member's own verdict goes to the KV for the others.
    failure.reset()
    failure.start_watch(round_ + 1)
    failure.mark_failed("this member's deadline")
    assert kv.get("elastic", f"world_failed_{round_ + 1}") == \
        b"this member's deadline"
    failure.stop_watch()


def test_notification_filters_stale_events_by_round(kv, monkeypatch):
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.elastic import state as es
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "h:0")
    monkeypatch.setattr(global_state, "elastic_round", 2)
    nm = es.WorkerNotificationManager()
    nm.init()
    state = elastic.ObjectState(epoch=0)
    nm.register_listener(state)
    # An event for a round this worker already joined: no interrupt.
    kv.put("elastic", "host_event", json.dumps(
        {"ts": 10.0, "added_only": False, "round": 2}).encode())
    nm.poll()
    state.check_host_updates()
    # A newer round's event interrupts at the next check, once.
    kv.put("elastic", "host_event", json.dumps(
        {"ts": 11.0, "added_only": True, "round": 3}).encode())
    nm.poll()
    with pytest.raises(HostsUpdatedInterrupt) as e:
        state.check_host_updates()
    assert e.value.skip_sync
    nm.poll()
    state.check_host_updates()


def test_announce_commit_only_for_fleet_jobs(kv, monkeypatch):
    from horovod_tpu_torch.elastic import state as es
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "h:0")
    nm = es.WorkerNotificationManager()
    nm.init()
    nm.announce_commit(1)
    assert kv.get("elastic", "commit") is None
    monkeypatch.setenv("HVD_TPU_FLEET_JOB_ID", "job-7")
    nm.announce_commit(4)
    got = json.loads(kv.get("elastic", "commit").decode())
    assert (got["generation"], got["slot"]) == (4, "h:0")


# ---------------------------------------------------------------------------
# the elastic loop and the telemetry (reference tests/test_metrics.py:459,
# tests/test_perf_observatory.py:768)
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_elastic_reset_realigns_aggregator_cadence(world1):
    from horovod_tpu_torch.elastic import state as es
    from horovod_tpu_torch.metrics.aggregate import aggregator
    agg = aggregator()
    agg.step_end(0.01)
    agg.step_end(0.01)
    assert agg._step >= 2
    es._reset()
    assert aggregator()._step == 0
    assert world1.is_initialized() and world1.device().type == "cpu"


def test_elastic_run_reanchors_after_sync_restore_work():
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.elastic import state as es
    from horovod_tpu_torch.metrics.attribution import attribution
    ckpt = metrics.registry().counter(
        "hvd_checkpoint_blocking_seconds_total",
        "Save/restore wall seconds paid on the calling thread")

    class _S(es.State):
        def sync(self):
            ckpt.inc(5.0)   # restore work done between runs

        def save(self):
            pass

        def restore(self):
            pass

    eng = attribution()
    eng.reanchor()

    @es.run
    def train(state):
        return "done"

    assert train(_S()) == "done"
    rec = eng.close_step(1, 0.1)
    assert rec is not None
    assert rec["components"]["checkpoint"] == pytest.approx(0.0)


def test_shutdown_keeps_metrics_serving(world1, monkeypatch):
    """/metrics stays up across an elastic reset, as the reference's."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.elastic import state as es
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("HVD_TPU_METRICS_PORT", str(port))
    metrics.stop_serving()
    try:
        es._reset()
        server = metrics.serve()
        es._reset()
        assert metrics.serve() is server and server.port == port
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            assert b"hvd_init_total" in r.read()
    finally:
        metrics.stop_serving()
