"""The reference's elastic drills (tests/test_elastic.py) through the
port's ``ElasticDriver`` and workers: scripted discovery, a worker
failure, blacklist, re-rendezvous, survivors continuing from their
committed state, a cascade inside the grace window, and a peer that dies
inside a collective.  Each drill gives the per-epoch sums and world sizes
the reference's tests assert.

The workers (``_torch_port_elastic_workers.py``, torch only) run on the
CPU over gloo with the native controller attached at each round's
address.  The growth drills are in test_torch_port_elastic_scale.py."""

import json
import os
import socket
import sys

import pytest

from horovod_tpu_torch.runner.elastic_driver import ElasticDriver, FixedHosts
from horovod_tpu_torch.runner.hosts import HostInfo

WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_port_elastic_workers.py")
# The time a survivor may take to raise HorovodInternalError after its
# peer died inside a collective (PERF.md, core/failure.py).
DETECT_BOUND_S = 5.0
# The time a survivor may take from its HorovodInternalError (or, after
# a hang, from the hung peer's exit, before which no round is published)
# to the end of its reset: the failed world torn down and the next one
# formed.  The reset takes 0.7-1.0 s on an idle CPU (PERF.md); it took
# ~20 s while the native runtime's shutdown waited out its reconnect
# ladder on the dead peer.  The margin is for the load of parallel tests.
RESET_BOUND_S = 5.0
# The operation deadline of the hang drill (HVD_TPU_NET_OP_DEADLINE_S):
# long enough for a world of three CPU workers to form under it.
HANG_DEADLINE_S = 8


def command(kind, **args):
    return [sys.executable, WORKERS, kind, json.dumps(args)]


def read_logs(prefix, slots):
    events = []
    for slot in slots:
        path = f"{prefix}.{slot}"
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    ev = json.loads(line)
                    ev["slot"] = slot
                    events.append(ev)
    return events


def _check_resets(events, errors, survivors, death_t):
    """Each survivor's reset ends within RESET_BOUND_S of its error, or
    of the death when that came later."""
    resets = {e["slot"]: e["t"] for e in events if e["event"] == "reset"}
    assert sorted(resets) == survivors, resets
    for e in errors:
        took = resets[e["slot"]] - max(e["t"], death_t)
        assert 0 <= took <= RESET_BOUND_S, (e["slot"], took)


@pytest.fixture
def elastic_env(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", "0.2")
    # Rank 0's stall watchdog writes its hang reports here, not in the
    # working directory.
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


@pytest.mark.timeout(300)
def test_elastic_worker_failure_recovers(tmp_path, elastic_env):
    """3 single-slot 'hosts'; rank 1's worker dies at epoch 1; the job
    re-rendezvouses with 2 survivors and finishes all epochs."""
    log = str(tmp_path / "log")
    hosts = [HostInfo("localhost", 1), HostInfo("127.0.0.1", 1),
             HostInfo(socket.gethostname(), 1)]
    driver = ElasticDriver(
        FixedHosts(hosts), command("allreduce", log=log, epochs=4,
                                   fail_slot="127.0.0.1:0", fail_epoch=1),
        min_np=2, max_np=3, verbose=True)
    assert driver.run() == 0
    events = read_logs(log, [f"{h.hostname}:0" for h in hosts])
    assert any(e["size"] == 3 and e["epoch"] == 0 for e in events)
    finals = [e for e in events if e["epoch"] == 3]
    assert finals and all(e["size"] == 2 for e in finals)
    for e in finals:
        assert e["sum"] == pytest.approx(3.0)   # ranks 0, 1 -> 1 + 2


@pytest.mark.timeout(300)
def test_elastic_completes_without_failures(tmp_path, elastic_env):
    log = str(tmp_path / "log")
    driver = ElasticDriver(
        FixedHosts([HostInfo("localhost", 2)]),
        command("allreduce", log=log, epochs=3), min_np=2, max_np=2)
    assert driver.run() == 0
    events = read_logs(log, ["localhost:0", "localhost:1"])
    assert len([e for e in events if e["epoch"] == 2]) == 2
    assert all(e["size"] == 2 and e["sum"] == 3.0 for e in events)


@pytest.mark.timeout(300)
def test_elastic_cascade_failure_publishes_fresh_round(tmp_path,
                                                       elastic_env,
                                                       monkeypatch):
    """A failure inside the cascade grace window publishes a FRESH round
    with the unchanged host set, and respawns the slot without
    blacklisting its host; sync seeds the round from a survivor's
    committed state, never the respawned process's initial one."""
    monkeypatch.setenv("HVD_TPU_ELASTIC_CASCADE_GRACE", "60")
    log = str(tmp_path / "log")
    local = socket.gethostname()
    hosts = [HostInfo("127.0.0.1", 1), HostInfo("localhost", 1),
             HostInfo(local, 2)]
    driver = ElasticDriver(
        FixedHosts(hosts), command("cascade", log=log,
                                   mark=str(tmp_path / "mark"), epochs=6),
        min_np=2, max_np=4, verbose=True)
    assert driver.run() == 0
    assert driver._blacklist == {"127.0.0.1"}
    slots = ["127.0.0.1:0", "localhost:0", f"{local}:0", f"{local}:1"]
    events = read_logs(log, slots)
    assert any(e["size"] == 4 and e["epoch"] == 0 for e in events)
    finals = [e for e in events if e["epoch"] == 5]
    assert len(finals) == 3 and all(e["size"] == 3 for e in finals)
    assert any(e["slot"] == "localhost:0" for e in finals)
    for e in finals:
        assert e["sum"] == pytest.approx(6.0)
    size3 = [e for e in events if e["size"] == 3]
    assert not any(e["epoch"] == 0 for e in size3)
    for slot in (f"{local}:0", f"{local}:1"):
        eps = [e["epoch"] for e in size3 if e["slot"] == slot]
        assert len(eps) == len(set(eps)), (slot, eps)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("op", ["negotiated", "zero"])
def test_peer_death_inside_a_collective_reaches_every_survivor(
        tmp_path, elastic_env, op):
    """A rank dies while its peers wait in a collective: a negotiated
    allreduce through the controller, or the ZeRO step's raw gloo
    reduce-scatter and all-gather.  Every survivor raises
    ``HorovodInternalError`` within DETECT_BOUND_S of the death, its
    process alive: it restores the commit, re-forms a world of 2 and
    finishes in the same process."""
    log = str(tmp_path / "log")
    hosts = [HostInfo("localhost", 1), HostInfo("127.0.0.1", 1),
             HostInfo(socket.gethostname(), 1)]
    slots = [f"{h.hostname}:0" for h in hosts]
    driver = ElasticDriver(
        FixedHosts(hosts), command("detect", log=log, op=op,
                                   victim="127.0.0.1:0", epochs=4,
                                   die_epoch=2, ckpt=str(tmp_path / "ck")),
        min_np=2, max_np=3, verbose=True)
    assert driver.run() == 0
    assert driver._blacklist == {"127.0.0.1"}
    events = read_logs(log, slots)
    (death,) = [e for e in events if e["event"] == "death"]
    errors = [e for e in events if e["event"] == "error"]
    survivors = sorted(s for s in slots if s != "127.0.0.1:0")
    assert sorted(e["slot"] for e in errors) == survivors
    for e in errors:
        assert e["epoch"] == 2 and e["size"] == 3
        assert 0 <= e["t"] - death["t"] <= DETECT_BOUND_S, (e, death)
    _check_resets(events, errors, survivors, death["t"])
    for slot in survivors:
        epochs = [e for e in events if e["event"] == "epoch"
                  and e["slot"] == slot]
        assert [e["epoch"] for e in epochs] == [0, 1, 2, 3]
        assert [e["size"] for e in epochs] == [3, 3, 2, 2]
        assert len({e["pid"] for e in epochs}) == 1   # alive throughout
    if op == "negotiated":
        finals = [e for e in events if e.get("epoch") == 3
                  and e["event"] == "epoch"]
        assert all(e["value"] == 2.0 for e in finals)


@pytest.mark.timeout(300)
def test_peer_that_hangs_alive_fails_the_commit_at_the_deadline(
        tmp_path, elastic_env, monkeypatch):
    """A peer takes the step and then hangs, alive, so that the driver
    publishes no round: every survivor's commit raises
    ``HorovodInternalError`` at the operation deadline instead of
    committing (core/failure.py ``verify``), and the step is redone from
    the previous commit once the hung peer has exited."""
    monkeypatch.setenv("HVD_TPU_NET_OP_DEADLINE_S", str(HANG_DEADLINE_S))
    log = str(tmp_path / "log")
    hosts = [HostInfo("localhost", 1), HostInfo("127.0.0.1", 1),
             HostInfo(socket.gethostname(), 1)]
    slots = [f"{h.hostname}:0" for h in hosts]
    driver = ElasticDriver(
        FixedHosts(hosts), command("detect", log=log, op="zero",
                                   victim="127.0.0.1:0", epochs=4,
                                   die_epoch=2, ckpt=str(tmp_path / "ck"),
                                   hang_s=HANG_DEADLINE_S + 4),
        min_np=2, max_np=3, verbose=True)
    assert driver.run() == 0
    assert driver._blacklist == {"127.0.0.1"}
    events = read_logs(log, slots)
    (hang,) = [e for e in events if e["event"] == "hang"]
    (death,) = [e for e in events if e["event"] == "death"]
    errors = [e for e in events if e["event"] == "error"]
    survivors = sorted(s for s in slots if s != "127.0.0.1:0")
    assert sorted(e["slot"] for e in errors) == survivors
    for e in errors:
        assert e["epoch"] == 2 and e["size"] == 3
        assert "before the commit" in e["error"], e
        assert HANG_DEADLINE_S - 1 <= e["t"] - hang["t"] <= \
            HANG_DEADLINE_S + DETECT_BOUND_S, (e, hang)
        assert e["t"] < death["t"]   # detected with the peer alive
    _check_resets(events, errors, survivors, death["t"])
    for slot in survivors:
        epochs = [e for e in events if e["event"] == "epoch"
                  and e["slot"] == slot]
        # Epoch 2's commit never happened at size 3: it is redone at 2.
        assert [e["epoch"] for e in epochs] == [0, 1, 2, 3]
        assert [e["size"] for e in epochs] == [3, 3, 2, 2]
        assert len({e["pid"] for e in epochs}) == 1   # alive throughout
