"""The reference's growth and shrink drills (tests/test_elastic.py)
through the port's ``ElasticDriver``: two concurrent jobs on one host,
host capacity growing and shrinking under a running job.  The workers
are ``_torch_port_elastic_workers.py``'s ``allreduce`` worker on gloo;
the failure drills are in test_torch_port_elastic_drills.py."""

import threading
import time

import pytest

from horovod_tpu_torch.runner.elastic_driver import ElasticDriver, FixedHosts
from horovod_tpu_torch.runner.hosts import HostInfo

from test_torch_port_elastic_drills import command, read_logs


@pytest.fixture
def elastic_env(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DISCOVERY_INTERVAL", "0.2")
    # Rank 0's stall watchdog writes its hang reports here, not in the
    # working directory.
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path / "flight"))


@pytest.mark.timeout(300)
def test_elastic_two_concurrent_jobs_one_host(tmp_path):
    """Two elastic jobs on one host must not collide: each round probes a
    fresh free port for its controller and its store."""
    rcs = {}

    def job(tag):
        driver = ElasticDriver(
            FixedHosts([HostInfo("localhost", 2)]),
            command("allreduce", log=str(tmp_path / f"log{tag}"),
                    epochs=2),
            min_np=2, max_np=2, controller_base_port=28400)
        rcs[tag] = driver.run()

    threads = [threading.Thread(target=job, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert rcs == {"a": 0, "b": 0}
    for tag in "ab":
        events = read_logs(str(tmp_path / f"log{tag}"),
                           ["localhost:0", "localhost:1"])
        assert sorted((e["epoch"], e["sum"]) for e in events) == \
            [(0, 3.0), (0, 3.0), (1, 3.0), (1, 3.0)]


def _resize_after_first_epoch(log, slots, discovery, hosts):
    deadline = time.time() + 120
    while time.time() < deadline and not read_logs(log, slots):
        time.sleep(0.2)
    discovery.set(hosts)


@pytest.mark.timeout(300)
def test_elastic_scale_up_adds_worker(tmp_path, elastic_env):
    """Host capacity grows mid-run: survivors take the
    HostsUpdatedInterrupt at commit, re-rendezvous, and later epochs run
    with the larger world."""
    log = str(tmp_path / "log")
    discovery = FixedHosts([HostInfo("localhost", 2)])
    driver = ElasticDriver(
        discovery, command("allreduce", log=log, epochs=8, sleep=0.4),
        min_np=2, max_np=3, verbose=True)
    threading.Thread(target=_resize_after_first_epoch, daemon=True,
                     args=(log, ["localhost:0", "localhost:1"], discovery,
                           [HostInfo("localhost", 3)])).start()
    assert driver.run() == 0
    events = read_logs(log, [f"localhost:{i}" for i in range(3)])
    sizes = {e["size"] for e in events}
    assert {2, 3} <= sizes
    finals = [e for e in events if e["epoch"] == 7]
    assert len(finals) == 3 and all(e["size"] == 3 for e in finals)
    assert all(e["sum"] == 6.0 for e in finals)


@pytest.mark.timeout(300)
def test_elastic_scale_down_removes_worker(tmp_path, elastic_env):
    """Host capacity shrinks mid-run: the removed slot's worker is
    stopped by the driver (an expected exit, no blacklist), survivors
    re-rendezvous, and the job completes at the smaller world."""
    log = str(tmp_path / "log")
    discovery = FixedHosts([HostInfo("localhost", 3)])
    driver = ElasticDriver(
        discovery, command("allreduce", log=log, epochs=8, sleep=0.4),
        min_np=2, max_np=3, verbose=True)
    slots = [f"localhost:{i}" for i in range(3)]
    threading.Thread(target=_resize_after_first_epoch, daemon=True,
                     args=(log, slots, discovery,
                           [HostInfo("localhost", 2)])).start()
    assert driver.run() == 0
    events = read_logs(log, slots)
    sizes = {e["size"] for e in events}
    assert {2, 3} <= sizes
    finals = [e for e in events if e["epoch"] == 7]
    assert len(finals) == 2 and all(e["size"] == 2 for e in finals)
    assert all(e["sum"] == 3.0 for e in finals)
    assert driver._blacklist == set()
