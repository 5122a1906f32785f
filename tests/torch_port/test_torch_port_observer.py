"""horovod_tpu_torch.metrics.observer against horovod_tpu.metrics.observer:
the host-sharded telemetry plane.

Each package's ``HostObserver`` runs against its own ``RendezvousServer``
on the same seeded snapshots, in two threads at once: two hosts exchange
to one fleet digest, a crashed host is named in ``failed_hosts``, a dead
host does not starve later hosts, a laggard local rank is named missing
(the fleet digests equal field for field: floats, sketch quantiles among
them, to 1e-12, outliers and ``failed_hosts`` exactly); a late snapshot
for a sealed round is dropped and counted, ``reset_rounds`` restarts the
round clock, the HTTP snapshot push and fleet fetch, the one-request
dump fan-in, the aggregator's local-only fallback (the reference's
``TestHostObserver``).  The port alone: the ``/observe/*`` HMAC gate,
the metrics port serving a running observer, the refused gateway push
(item 10b), and the elastic ``_reset`` path refusing the old world's
higher-round digest.  Four gloo ranks as two hosts of two
(``_torch_port_telemetry_workers.observe_part``): the tree sync's
straggler verdicts equal the flat allgather's, a hang report is filled
one request per host and names each host's fan-in, and a host whose
observer stopped is named failed while the sync returns."""

import importlib
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch.distributed as dist

import _torch_port_pool as pool
import _torch_port_telemetry_workers as W

PKGS = ("horovod_tpu", "horovod_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _snap(rank, mean=0.1, steps=10, wait=0.002, scalars=None, step=10):
    """A rank's wire snapshot from seeded step times (the reference
    test's shape)."""
    from horovod_tpu_torch.metrics.digest import QuantileSketch
    rng = np.random.default_rng(1000 * rank + int(mean * 1000))
    times = [float(mean * (1.0 + 0.05 * z))
             for z in rng.standard_normal(steps)]
    wall = sum(times)
    return {
        "rank": rank, "step": step,
        "step_time_sum": wall, "step_count": steps,
        "data_wait_sum": wait * steps, "data_wait_count": steps,
        "sketch": QuantileSketch.of(times).to_dict(),
        "attr": {"steps": float(steps), "flops": 0.0, "wall": wall,
                 "compute": wall - 2 * wait * steps,
                 "comm_exposed": wait * steps, "input": wait * steps,
                 "checkpoint": 0.0, "host": 0.0},
        "scalars": dict(scalars or {"hvd_steps_total": float(steps)}),
    }


def _same(a, b, path=""):
    """Field-for-field equality: floats to 1e-12 relative, the rest
    exactly."""
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {set(a) ^ set(b)}"
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: len {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-15), \
            f"{path}: {a} vs {b}"
    else:
        assert a == b, f"{path}: {a} vs {b}"


@pytest.fixture()
def kvs():
    """One rendezvous KV of each package, by package name."""
    servers = {}
    for pkg in PKGS:
        srv = _mod(pkg, "runner.rendezvous").RendezvousServer(
            host="127.0.0.1")
        srv.start()
        servers[pkg] = srv
    yield {pkg: f"127.0.0.1:{s.port}" for pkg, s in servers.items()}
    for s in servers.values():
        s.stop()


@pytest.fixture(autouse=True)
def _observer_hygiene():
    for pkg in PKGS:
        _mod(pkg, "metrics.observer").reset_addr_cache()
    yield
    for pkg in PKGS:
        ob = _mod(pkg, "metrics.observer")
        ob.stop_host_observer()
        ob.reset_addr_cache()


def _observer(pkg, addr, cross_rank=0, cross_size=1, ranks=(0, 1),
              host=None):
    return _mod(pkg, "metrics.observer").HostObserver(
        host or f"h{cross_rank}", list(ranks), cross_rank=cross_rank,
        cross_size=cross_size, rdv_addr=addr).start()


def _both(case, kvs):
    """``case(pkg, kv address)`` in both packages at once: (reference's
    result, port's)."""
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(case, pkg, kvs[pkg]) for pkg in PKGS]
        return tuple(f.result() for f in futs)


# ---------------------------------------------------------------------------
# the exchange: fleet digests field for field
# ---------------------------------------------------------------------------

def _two_hosts(pkg, addr):
    ob0 = _observer(pkg, addr, 0, 2, (0, 1))
    ob1 = _observer(pkg, addr, 1, 2, (2, 3))
    try:
        for r in (0, 1):
            ob0.submit_snapshot(1, _snap(r))
        for r in (2, 3):
            ob1.submit_snapshot(1, _snap(r, mean=0.3 if r == 3 else 0.1))
        return {"root": ob0.fleet_digest(min_round=1, wait_s=10),
                "host1": ob1.fleet_digest(min_round=1, wait_s=10)}
    finally:
        ob0.stop()
        ob1.stop()


def _crashed_host(pkg, addr):
    ob0 = _observer(pkg, addr, 0, 2, (0, 1))
    try:
        for r in (0, 1):
            ob0.submit_snapshot(1, _snap(r))
        return {"root": ob0.fleet_digest(min_round=1, wait_s=10)}
    finally:
        ob0.stop()


def _dead_host(pkg, addr):
    ob0 = _observer(pkg, addr, 0, 3, (0, 1))
    ob2 = _observer(pkg, addr, 2, 3, (4, 5))
    try:
        for r in (4, 5):
            ob2.submit_snapshot(1, _snap(r))
        for r in (0, 1):
            ob0.submit_snapshot(1, _snap(r))
        return {"root": ob0.fleet_digest(min_round=1, wait_s=10)}
    finally:
        ob0.stop()
        ob2.stop()


def _laggard(pkg, addr):
    ob = _observer(pkg, addr, 0, 1, (0, 1, 2))
    try:
        ob.submit_snapshot(1, _snap(0))
        ob.submit_snapshot(1, _snap(1))      # rank 2 never shows
        return {"root": ob.fleet_digest(min_round=1, wait_s=10)}
    finally:
        ob.stop()


EXCHANGES = {
    # case: (body, grace s, exchange deadline s, the root's expected
    # ranks, hosts, failed_hosts, missing)
    "two_hosts": (_two_hosts, "0.3", "10", 4, ["h0", "h1"], [], []),
    "crashed_host": (_crashed_host, "0.2", "1", 2, ["h0"], ["host1"], []),
    "dead_host_does_not_starve_later_hosts": (
        _dead_host, "0.2", "3", 4, ["h0", "h2"], ["host1"], []),
    "laggard_local_rank_named_missing": (
        _laggard, "0.2", "10", 2, ["h0"], [], [2]),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_fleet_digest_matches_reference(case, kvs, monkeypatch):
    body, grace, timeout, ranks, hosts, failed, missing = EXCHANGES[case]
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", grace)
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_TIMEOUT_S", timeout)
    ref, port = _both(body, kvs)
    _same(port, ref)
    root = port["root"]
    assert root is not None and root["round"] == 1
    assert (root["ranks"], root["hosts"], root["failed_hosts"],
            root["missing"]) == (ranks, hosts, failed, missing)
    if case == "two_hosts":
        assert port["host1"]["ranks"] == 4        # the root's fleet back
        assert [o["rank"] for o in root["outliers"]][0] == 3


# ---------------------------------------------------------------------------
# the observer's other behaviours
# ---------------------------------------------------------------------------

def _late_snapshot(pkg, addr):
    reg = _mod(pkg, "metrics.registry").registry()
    late = reg.counter("hvd_observe_late_snapshots_total", "")
    ob = _observer(pkg, addr, 0, 1, (0, 1))
    try:
        for r in (0, 1):
            ob.submit_snapshot(1, _snap(r))
        fleet = ob.fleet_digest(min_round=1, wait_s=10)
        before = late.value
        ob.submit_snapshot(1, _snap(0))      # the delayed retry
        return {"fleet": fleet, "late": late.value - before,
                "host_ranks": ob.host_digest()["ranks"]}
    finally:
        ob.stop()


def _reset_rounds(pkg, addr):
    ob = _observer(pkg, addr, 0, 1, (0,))
    try:
        for r in (1, 2, 3):
            ob.submit_snapshot(r, _snap(0, mean=0.5))
        before = ob.fleet_digest(min_round=3, wait_s=10)["round"]
        ob.reset_rounds()
        stale = ob.fleet_digest(min_round=1, wait_s=0)
        ob.submit_snapshot(1, _snap(0, mean=0.1))
        return {"before": before, "stale": stale,
                "fleet": ob.fleet_digest(min_round=1, wait_s=10)}
    finally:
        ob.stop()


def _http_push_and_fetch(pkg, addr):
    OB = _mod(pkg, "metrics.observer")
    ob = _observer(pkg, addr, 0, 1, (0,))
    try:
        pushed = OB.push_snapshot(ob.addr, 1, _snap(0))
        fleet = OB.fetch_fleet_digest(ob.addr, min_round=1, wait_s=5)
        found = OB.observer_addr_for(0, rdv_addr=addr,
                                     cached=False) == ob.addr
    finally:
        ob.stop()
    # stop() unpublishes the address.
    gone = OB.observer_addr_for(0, rdv_addr=addr, cached=False) is None
    return {"pushed": pushed, "fleet": fleet, "found": found,
            "gone": gone}


def _dump_fan_in(pkg, addr):
    OB = _mod(pkg, "metrics.observer")
    _mod(pkg, "debug.flight").set_identity(rank=0, world=2)
    ob = _observer(pkg, addr, 0, 1, (0, 7777))   # 7777: no endpoint
    try:
        dumps = OB.fetch_host_dumps(ob.addr)
        return {"answered": sorted(r for r, d in dumps.items()
                                   if d is not None),
                "unanswered": sorted(r for r, d in dumps.items()
                                     if d is None),
                "own_dump_events": "events" in dumps[0]}
    finally:
        ob.stop()


BEHAVIOURS = {
    "late_snapshot_for_sealed_round_dropped": _late_snapshot,
    "reset_rounds_survives_elastic_reset": _reset_rounds,
    "http_snapshot_push_and_fleet_fetch": _http_push_and_fetch,
    "dump_fan_in_one_request_per_host": _dump_fan_in,
}


@pytest.mark.parametrize("case", sorted(BEHAVIOURS))
def test_observer_behaviour_matches_reference(case, kvs, monkeypatch):
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", "0.2")
    ref, port = _both(BEHAVIOURS[case], kvs)
    _same(port, ref)
    if case.startswith("late"):
        assert port["late"] == 1 and port["host_ranks"] == 2
    elif case.startswith("reset"):
        assert port["before"] == 3 and port["stale"] is None
        # The post-reset world's digest (mean 0.1, not 0.5).
        assert port["fleet"]["round"] == 1
        assert port["fleet"]["window"]["step_time_sum"] == \
            pytest.approx(1.0, rel=0.1)
    elif case.startswith("http"):
        assert port["pushed"] and port["found"] and port["gone"]
        assert port["fleet"]["ranks"] == 1
    else:
        assert port == {"answered": [0], "unanswered": [7777],
                        "own_dump_events": True}


def test_aggregator_tree_sync_local_fallback(monkeypatch):
    """METRICS_TREE with no observer reachable: the sync degrades to a
    local-only digest (never a collective), as the reference's does."""
    monkeypatch.setenv("HVD_TPU_METRICS_TREE", "1")
    digests = []
    for pkg in PKGS:
        agg = _mod(pkg, "metrics.aggregate").Aggregator()
        # Anchor the window at the registry's lifetime data-wait
        # counters, which earlier tests in this process moved.
        agg.reset()
        for i in range(5):
            agg.step_end(0.01, step=i)
        assert isinstance(agg.sync(), list)
        d = agg.fleet_digest()
        digests.append({k: d[k] for k in (
            "round", "ranks", "hosts", "failed_hosts", "missing",
            "window", "steps", "top_k")})
    _same(digests[1], digests[0])
    assert digests[1]["ranks"] == 1
    assert digests[1]["window"]["step_count"] == 5


def test_hang_report_hosts_section():
    status = {"host[0]@127.0.0.1:80": "ok",
              "host[1]@1.2.3.4:80": "unreachable (per-rank fallback)"}
    reports = [_mod(pkg, "debug.hang").build_hang_report(
        [{"name": "t", "type": 0, "missing": [1]}],
        {0: {"events": []}, 1: None}, world=2, step=3,
        host_status=status) for pkg in PKGS]
    assert reports[1]["hosts"] == reports[0]["hosts"] == status


# ---------------------------------------------------------------------------
# the port's surfaces
# ---------------------------------------------------------------------------

def _get(url, sign=None):
    req = urllib.request.Request(url)
    if sign is not None:
        sign(req)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_observe_routes_hmac_gated(monkeypatch):
    """Under a secret every ``/observe/*`` route and the snapshot PUT
    need the KV scheme's signature (scope ``observe``); a request
    signed by either package's ``sign_request`` passes, an unsigned or
    wrongly signed one answers 403."""
    from horovod_tpu_torch.metrics import observer as OB
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", "s3cret")
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", "0.2")
    ob = OB.HostObserver("hS", [0]).start()
    try:
        assert OB.push_snapshot(ob.addr, 1, _snap(0))      # signed PUT
        assert OB.fetch_fleet_digest(ob.addr, min_round=1,
                                     wait_s=5)["ranks"] == 1
        base = f"http://127.0.0.1:{ob.port}"
        for route in ("digest", "fleet", "dumps"):
            assert _get(f"{base}/observe/{route}")[0] == 403
            for pkg in PKGS:
                sign = _mod(pkg, "runner.rendezvous").sign_request
                code, body = _get(f"{base}/observe/{route}", lambda r:
                                  sign(r, "GET", "observe", route))
                assert code == 200, (pkg, route, code)
                json.loads(body)
        from horovod_tpu_torch.runner import rendezvous as rdv
        code, _ = _get(f"{base}/observe/fleet", lambda r: r.add_header(
            rdv._SIG_HEADER, "0" * 64))
        assert code == 403
        put = urllib.request.Request(
            f"{base}/observe/snapshot", method="PUT",
            data=json.dumps({"round": 2, "snap": _snap(0)}).encode())
        assert _get(put.full_url, lambda r: (
            setattr(r, "data", put.data), setattr(r, "method", "PUT")))[0] \
            == 403
        assert _get(f"{base}/healthz") == (200, b"ok")
    finally:
        ob.stop()


def test_metrics_port_serves_observer_when_running(kvs, monkeypatch):
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.metrics import observer as OB
    from horovod_tpu_torch.metrics.exporters import MetricsServer
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", "0.2")
    server = MetricsServer(host="127.0.0.1")
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _get(f"{base}/observe/digest")[0] == 404     # none runs
        monkeypatch.setattr(global_state, "initialized", True)
        ob = OB.start_host_observer(
            host="hX", local_ranks=[0], cross_rank=0, cross_size=1,
            rdv_addr=kvs["horovod_tpu_torch"])
        assert OB.current_observer() is ob
        ob.submit_snapshot(1, _snap(0))
        ob.fleet_digest(min_round=1, wait_s=5)
        for route in ("digest", "fleet"):
            code, body = _get(f"{base}/observe/{route}")
            assert code == 200 and json.loads(body)["hosts"] == ["hX"]
        code, body = _get(f"{base}/observe/dumps")
        assert code == 200 and json.loads(body)["host"] == "hX"
    finally:
        server.stop()


def test_gateway_push_is_refused_naming_item_10b(monkeypatch):
    """A push configuration is no longer refused: the observer starts
    with its push thread, filed under the job at the gateway, and
    ``init()`` through it (the pushes reaching a gateway:
    test_torch_port_fleet.py)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.metrics import observer as OB
    monkeypatch.setenv("HVD_TPU_METRICS_TREE", "1")
    monkeypatch.setenv("HVD_TPU_FLEET_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("HVD_TPU_FLEET_JOB_ID", "j")
    monkeypatch.setenv("HVD_TPU_FLEET_OBSERVE_PUSH_S", "1")
    ob = OB.start_host_observer(host="hP", local_ranks=[0])
    try:
        assert (ob.job_id, ob.gateway_addr, ob.push_interval_s) == \
            ("j", "127.0.0.1:1", 1.0)
        assert "hvd-tpu-observer-push" in [t.name for t in ob._threads]
    finally:
        OB.stop_host_observer()
    hvd.init(device="cpu")
    try:
        assert OB.current_observer() is not None
        assert OB.current_observer().job_id == "j"
    finally:
        hvd.shutdown()
    assert not dist.is_initialized()


def test_elastic_reset_refuses_the_old_worlds_rounds(kvs, monkeypatch):
    """A world of two hosts syncs two rounds; host 1 leaves and the
    survivor passes through the elastic ``_reset``.  Its new observer's
    round 1 must not merge host 1's round-2 digest still on the KV (the
    old world's): host 1 is named failed and the digest covers the
    survivor alone."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.elastic import state as el_state
    from horovod_tpu_torch.metrics import observer as OB
    addr = kvs["horovod_tpu_torch"]
    for k, v in {"HVD_TPU_RENDEZVOUS_ADDR": addr,
                 "HVD_TPU_METRICS_TREE": "1", "HOROVOD_CROSS_SIZE": "2",
                 "HOROVOD_CROSS_RANK": "0",
                 "HVD_TPU_METRICS_TREE_GRACE_S": "0.2",
                 "HVD_TPU_METRICS_TREE_TIMEOUT_S": "1"}.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu")
    metrics.aggregator().reset()
    host1 = OB.HostObserver("h1", [1], cross_rank=1, cross_size=2,
                            rdv_addr=addr).start()
    try:
        for r in (1, 2):
            host1.submit_snapshot(r, _snap(1))
            metrics.step_end(0.01)
            metrics.sync()
            assert metrics.fleet_digest()["ranks"] == 2
        host1.stop()
        el_state._reset()
        assert OB.current_observer() is not None
        metrics.step_end(0.01)
        metrics.sync()              # returns: the exchange is still out
        d = OB.current_observer().fleet_digest(min_round=1, wait_s=5)
        assert d["round"] == 1
        assert (d["ranks"], d["hosts"], d["failed_hosts"]) == \
            (1, ["host0"], ["host1"])
    finally:
        host1.stop()
        hvd.shutdown()


# ---------------------------------------------------------------------------
# four gloo ranks, two hosts of two
# ---------------------------------------------------------------------------

_KV = {}


def _observe_prepare(out):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    kv = RendezvousServer(host="127.0.0.1", port=0)
    kv.start()
    _KV["server"] = kv
    with open(f"{out}/kv.txt", "w") as f:
        f.write(f"127.0.0.1:{kv.port}")


@pytest.fixture(scope="module")
def observe_ranks(tmp_path_factory):
    try:
        return pool.part_results(tmp_path_factory, "observe",
                                 _observe_prepare)
    finally:
        if "server" in _KV:
            _KV.pop("server").stop()


def test_gloo_tree_verdicts_equal_flat(observe_ranks):
    for r, res in enumerate(observe_ranks):
        assert res["observer"] == (r % W.OBSERVE_LOCAL == 0)
        d = res["tree_digest"]
        assert (d["round"], d["ranks"], d["hosts"], d["failed_hosts"],
                d["missing"]) == (1, 4, ["127.0.0.1", "localhost"], [], [])
        assert res["tree_outliers"][0] == W.OBSERVE_STRAGGLER
        assert res["flat_ranks"] == [0, 1, 2, 3]
        assert res["tree"] == res["flat"]
        assert [(h, c) for h, f, c in res["tree"] if f] == \
            [(W.OBSERVE_STRAGGLER, "input")]
    assert all(res["tree_digest"] == observe_ranks[0]["tree_digest"]
               for res in observe_ranks)


def test_gloo_hang_report_names_each_host(observe_ranks):
    hang = observe_ranks[0]["hang"]
    assert sorted(hang["hosts"].values()) == ["ok", "ok"]
    assert sorted(h.split("@")[0] for h in hang["hosts"]) == \
        ["host[0]", "host[1]"]
    assert hang["per_rank"] == [[]]           # every rank via its host
    assert hang["reachable"] == [True] * W.OBSERVE_WORLD


def test_gloo_stopped_observer_named_failed(observe_ranks):
    timeout = float(W.OBSERVE_TIMEOUT_S)
    for r, res in enumerate(observe_ranks):
        sync = res["failed_sync"]
        # The sync returned within its wait: with the previous round's
        # fleet digest (counted stale) or a digest of this rank alone.
        assert res["failed_round_s"] < timeout + 10
        assert (sync["round"], sync["ranks"], sync["stale"]) in \
            ((1, 4, 1), (2, 1, 0)), sync
        if r < W.OBSERVE_LOCAL:       # host 0's observer, round 2
            d = res["failed_digest"]
            assert (d["round"], d["ranks"], d["hosts"], d["missing"]) \
                == (2, 2, ["127.0.0.1"], [])
            # Named by its last published address when one is known.
            (failed,) = d["failed_hosts"]
            assert failed.split("@")[0] == "host1"
