"""horovod_tpu_torch.debug's hang diagnosis, debug endpoints and fleet merge
against horovod_tpu.debug's: ``attribute`` and ``build_hang_report`` on
the same seeded stall lists and dumps give the same report with the
timestamp masked; ``merge_dumps``, ``filter_trace`` and the merge CLI on
the reference's golden dumps and a truncated native timeline give the
same trace; the ``/debug/*`` bodies, their HMAC refusal and the metrics
port's mounts answer as the reference's (its tests/test_debug_flight.py);
and the reference's forced hang through the port's ``init()`` at two
gloo ranks (``_torch_port_telemetry_workers.hang_part``) writes the hang
report the reference's watchdog writes for the same evidence."""

import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import _torch_port_pool as pool
import _torch_port_telemetry_workers as W

hang_j = importlib.import_module("horovod_tpu.debug.hang")
hang_t = importlib.import_module("horovod_tpu_torch.debug.hang")
http_j = importlib.import_module("horovod_tpu.debug.http")
http_t = importlib.import_module("horovod_tpu_torch.debug.http")
merge_j = importlib.import_module("horovod_tpu.debug.merge")
merge_t = importlib.import_module("horovod_tpu_torch.debug.merge")
debug_t = importlib.import_module("horovod_tpu_torch.debug")

KINDS = ["collective.enqueue", "collective.done", "collective",
         "negotiate.execute", "collective.error", "data.wait",
         "data.stall_warning", "data.stall_timeout", "data.producer_dead",
         "checkpoint.save.begin", "checkpoint.save.commit",
         "checkpoint.restore.begin", "checkpoint.restore.done",
         "elastic.commit", "init", "native.attach", "perf.drift"]


def _seeded_events(rng, n):
    return [{"seq": i, "t_mono": float(i), "t_wall": 1000.0 + i,
             "kind": KINDS[int(k)], "name": f"t{int(k) % 3}"}
            for i, k in enumerate(rng.integers(0, len(KINDS), n))]


def _golden_cases():
    """The reference's attribution goldens, then seeded sequences."""
    cases = [
        [],
        [{"kind": "collective.done", "name": "a"},
         {"kind": "data.wait", "name": "loader"}],
        [{"kind": "data.wait", "name": "loader"},
         {"kind": "collective.done", "name": "a"}],
        [{"kind": "checkpoint.save.begin", "name": "/ckpt"}],
        [{"kind": "checkpoint.save.begin", "name": "/ckpt"},
         {"kind": "checkpoint.save.commit", "name": "/ckpt"},
         {"kind": "collective.enqueue", "name": "grad"}],
    ]
    rng = np.random.default_rng(61)
    cases += [_seeded_events(rng, int(n)) for n in rng.integers(1, 12, 40)]
    return cases


def test_attribute_matches_reference():
    for events in _golden_cases():
        assert hang_t.attribute(events) == hang_j.attribute(events), events


def _stall_case(seed):
    """A seeded world, its stall snapshot and rank dumps (None for an
    unreachable rank), as the native inspector and the fetches give
    them."""
    rng = np.random.default_rng(seed)
    world = int(rng.integers(2, 6))
    stalled = []
    for i in range(int(rng.integers(1, 3))):
        missing = sorted(int(r) for r in rng.choice(
            world, int(rng.integers(1, world)), replace=False))
        stalled.append({"name": f"grad.{i}", "type": int(rng.integers(0, 7)),
                        "age_s": float(rng.uniform(1, 90)),
                        "missing": missing,
                        "submitted": [r for r in range(world)
                                      if r not in missing]})
    dumps = {}
    for r in range(world):
        if rng.random() < 0.2:
            dumps[r] = None
            continue
        meta = {}
        if rng.random() < 0.3:
            meta["serving_slots"] = [{"slot": 0, "trace": f"tr{r}"}]
        dumps[r] = {"version": 1, "rank": r, "world": world,
                    "host": f"h{r}", "pid": 100 + r,
                    "clock": {"offset_s": float(rng.normal())},
                    "meta": meta,
                    "events": _seeded_events(rng, int(rng.integers(0, 30)))}
    return stalled, dumps, world


@pytest.mark.parametrize("seed", range(6))
def test_build_hang_report_matches_reference(seed, monkeypatch):
    """The same evidence gives the same report; ``generated_wall`` is
    masked, and the process-local recovery and net sections (each
    package's own state) are pinned to the same values."""
    stalled, dumps, world = _stall_case(seed)
    recovery = {"path": "peer", "step": 4}
    net = {"native": None, "http_retries": 0, "retrying": False,
           "verdict": "no recent wire recovery activity"}
    for mod in (hang_j, hang_t):
        monkeypatch.setattr(mod, "_last_recovery", lambda: recovery)
        monkeypatch.setattr(mod, "_net_status", lambda: net)
    hosts = {"h0": "ok"} if seed % 2 else None
    kw = dict(world=world, step=7 + seed, last_n=5 + seed,
              host_status=hosts)
    got = hang_t.build_hang_report(stalled, dumps, **kw)
    want = hang_j.build_hang_report(stalled, dumps, **kw)
    assert got.pop("generated_wall") > 0
    want.pop("generated_wall")
    assert got == want


def test_hang_report_sections_are_the_reference_shape():
    """Unpinned, the recovery and net sections are the port's own:
    ``recovery`` None before any restore, ``net`` the keys of the
    reference's ``net.status()``."""
    from horovod_tpu_torch import recovery
    stalled, dumps, world = _stall_case(0)
    got = hang_t.build_hang_report(stalled, dumps, world=world, step=1)
    want = hang_j.build_hang_report(stalled, dumps, world=world, step=1)
    if recovery.last_report() is None:
        assert got["recovery"] is None
    assert sorted(got["net"]) == sorted(want["net"])


def _golden_dumps():
    """The reference's merge goldens (tests/test_debug_flight.py)."""
    d0 = {"version": 1, "rank": 0, "world": 2, "host": "h0", "pid": 10,
          "clock": {"offset_s": 0.0},
          "meta": {"native_init_wall": 1000.0},
          "events": [
              {"seq": 0, "t_mono": 1.0, "t_wall": 1000.0,
               "kind": "native.attach", "name": None},
              {"seq": 1, "t_mono": 2.0, "t_wall": 1001.0,
               "kind": "collective.done", "name": "g",
               "op": "allreduce", "dur_s": 0.25}]}
    d1 = {"version": 1, "rank": 1, "world": 2, "host": "h1", "pid": 11,
          "clock": {"offset_s": 2.0},
          "meta": {},
          "events": [
              {"seq": 0, "t_mono": 1.0, "t_wall": 1002.5,
               "kind": "collective.enqueue", "name": "g",
               "op": "allreduce"}]}
    return d0, d1


TRUNCATED_TIMELINE = (
    '[\n{"name":"process_name","ph":"M","pid":0,"tid":0,'
    '"args":{"name":"rank 0"}},\n'
    '{"name":"g","cat":"NEGOTIATE","ph":"B","ts":100,"pid":0,"tid":0},\n'
    '{"name":"g","cat":"NEGOTIATE_READY","ph":"i","ts":200,"pid":1,'
    '"tid":0,"s":"g","args":{"rank":1}},\n')


def _seeded_dumps(seed):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(3):
        events = _seeded_events(rng, 8)
        for e in events:
            e["t_wall"] += float(rng.uniform(0, 0.5))
            if e["kind"] == "collective.done":
                e["dur_s"] = float(rng.uniform(0, 0.1))
            if rng.random() < 0.4:
                e["kind"], e["name"] = "trace.decode", f"tr{r % 2}"
        out.append({"rank": r, "host": f"h{r}", "events": events,
                    "clock": {"offset_s": float(rng.normal() * 0.1)},
                    "meta": ({"timeline_start_wall": 1000.2}
                             if r == 0 and seed % 2 else {})})
    return out


@pytest.mark.parametrize("case", ["golden", "seeded0", "seeded1"])
def test_merge_dumps_matches_reference(case, tmp_path):
    if case == "golden":
        dumps = list(_golden_dumps())
    else:
        dumps = _seeded_dumps(int(case[-1]))
    tl = tmp_path / "tl.json"
    tl.write_text(TRUNCATED_TIMELINE)
    timeline = merge_t.load_timeline(str(tl))
    assert timeline == merge_j.load_timeline(str(tl))
    for events in (None, timeline):
        assert merge_t.merge_dumps(dumps, events) == \
            merge_j.merge_dumps(dumps, events)
    assert merge_t.filter_trace(dumps, "tr1") == \
        merge_j.filter_trace(dumps, "tr1")
    if case == "golden":
        # The reference's alignment golden: rank 1's enqueue at 1002.5
        # with offset +2.0 lands 500 ms after rank 0's first event.
        evs = merge_t.merge_dumps(dumps)["traceEvents"]
        enq = next(e for e in evs if e.get("cat") == "collective.enqueue")
        assert (enq["pid"], enq["ts"]) == (1, 500_000)


def test_merge_cli_matches_reference(tmp_path):
    d0, d1 = _golden_dumps()
    paths = []
    for i, d in enumerate((d0, d1)):
        p = tmp_path / f"flight_rank{i}.json"
        p.write_text(json.dumps(d))
        paths.append(str(p))
    tl = tmp_path / "tl.json"
    tl.write_text(TRUNCATED_TIMELINE)
    outs = []
    for main in (merge_t.main, merge_j.main):
        out = tmp_path / f"merged_{len(outs)}.json"
        assert main(paths + ["--timeline", str(tl), "-o", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]
    with pytest.raises(SystemExit):
        merge_t.main([])   # neither dumps nor a fleet


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture
def servers():
    """A port DebugServer and a reference one, on loopback."""
    from horovod_tpu_torch.debug import regression
    regression.reset()
    pair = [http_t.DebugServer(host="127.0.0.1", port=0),
            http_j.DebugServer(host="127.0.0.1", port=0)]
    for s in pair:
        s.start()
    yield [f"http://127.0.0.1:{s.port}" for s in pair]
    for s in pair:
        s.stop()


def test_debug_endpoints_answer_as_the_reference(servers):
    port, ref = servers
    debug_t.record("test.http", "served")
    code, ctype, body = _get(port + "/debug/flight")
    assert code == 200 and ctype == "application/json"
    dump = json.loads(body)
    assert any(e["kind"] == "test.http" for e in dump["events"])
    code, ctype, body = _get(port + "/debug/stacks")
    assert code == 200 and ctype == "text/plain; charset=utf-8"
    # faulthandler names this very function's frame in the dump.
    assert b"test_debug_endpoints_answer_as_the_reference" in body
    assert b"Thread" in body
    for path in ("/healthz", "/debug/regression", "/debug/autotune",
                 "/debug/nope", "/elsewhere"):
        assert _get(port + path) == _get(ref + path), path
    code, _, body = _get(port + "/debug/fleet_scalars")
    assert code == 200 and json.loads(body) == {"ranks": {}}


def test_regression_route_serves_the_last_report(servers):
    from horovod_tpu_torch.debug import regression
    from horovod_tpu_torch.metrics.baseline import DriftEvent
    port, _ = servers
    event = DriftEvent(12, 9, 1000.0, 5.0, 2.0, "input", 0.01, 0.02, 0.3)
    rep = regression.build_regression_report(
        event, write=False, events=[{"kind": "data.chaos_delay",
                                     "name": "inline", "t_mono": 4.0}])
    code, ctype, body = _get(port + "/debug/regression")
    assert code == 200 and ctype == "application/json"
    assert json.loads(body) == json.loads(json.dumps(rep, default=str))
    regression.reset()


def test_debug_endpoints_require_signature_with_secret(monkeypatch):
    """With a launch secret, unsigned dump requests are refused (403) on
    the endpoint and on the metrics port's mount, as the reference's are;
    the watchdog's signed fetch works and liveness stays open."""
    from horovod_tpu_torch.metrics import exporters
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_SECRET", "s3cret")
    srv = http_t.DebugServer(host="127.0.0.1", port=0)
    met = exporters.MetricsServer(host="127.0.0.1", port=0)
    srv.start()
    met.start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        for base in (f"http://{addr}", f"http://127.0.0.1:{met.port}"):
            for key in ("flight", "regression", "stacks", "autotune",
                        "fleet_scalars"):
                assert _get(f"{base}/debug/{key}")[0] == 403, (base, key)
            assert _get(base + "/healthz")[::2] == (200, b"ok")
        d = http_t.fetch_flight_dump(addr, timeout=5)   # signs the request
        assert d is not None and "events" in d
        # The reference's client signs the same way.
        assert http_j.fetch_flight_dump(addr, timeout=5) is not None
    finally:
        srv.stop()
        met.stop()
    assert http_t.fetch_flight_dump(addr, timeout=1) is None   # gone


def test_metrics_server_mounts_debug_endpoints():
    from horovod_tpu_torch.metrics import exporters
    debug_t.record("test.viametrics", "x")
    srv = exporters.MetricsServer(host="127.0.0.1", port=0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, _, body = _get(base + "/debug/flight")
        assert code == 200 and any(e["kind"] == "test.viametrics"
                                   for e in json.loads(body)["events"])
        assert _get(base + "/debug/stacks")[0] == 200
        assert _get(base + "/debug/fleet_scalars")[0] == 200
        code, _, body = _get(base + "/debug/autotune")
        assert code == 404 and json.loads(body) == {
            "error": "no active tuner in this process"}
    finally:
        srv.stop()


def test_serve_and_publish_puts_the_address_on_the_kv(monkeypatch):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer, http_get
    monkeypatch.setenv("HVD_TPU_FLIGHT_HOST", "127.0.0.1")
    kv = RendezvousServer(host="127.0.0.1", port=0)
    kv.start()
    try:
        rdv = f"127.0.0.1:{kv.port}"
        addr = debug_t.serve_and_publish(rank=3, rdv_addr=rdv)
        assert addr == f"127.0.0.1:{http_t._server.port}"
        assert http_get(rdv, "debug", "flight_addr_3").decode() == addr
        dumps = merge_t.fetch_fleet_dumps(rdv, timeout=5)
        assert list(dumps) == [3] and "events" in dumps[3]
    finally:
        debug_t.stop_serving()
        kv.stop()


# ---------------------------------------------------------------------------
# the forced hang at two gloo ranks, through init()
# ---------------------------------------------------------------------------

_KV = {}


def _hang_prepare(out):
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    pool.write_ports(1)(out)
    kv = RendezvousServer(host="127.0.0.1", port=0)
    kv.start()
    _KV["server"] = kv
    with open(f"{out}/kv.txt", "w") as f:
        f.write(f"127.0.0.1:{kv.port}")


@pytest.fixture(scope="module")
def hang_ranks(tmp_path_factory):
    try:
        return pool.part_results(tmp_path_factory, "hang", _hang_prepare)
    finally:
        if "server" in _KV:
            _KV.pop("server").stop()


def test_forced_hang_produces_hang_report(hang_ranks):
    """Rank 1 never submits "never": rank 0's watchdog, started by
    ``init()``, writes one report naming the stuck allreduce, the missing
    rank and its last flight events (fetched from its published
    ``/debug/flight``) with an input-bound attribution."""
    r0, r1 = hang_ranks
    assert r0["warmup"] == r1["warmup"] == 2.0
    assert r0["error"] and "stall" in r0["error"].lower()
    (rep,) = r0["reports"]
    (never,) = [s for s in rep["stalled"] if s["name"] == "never"]
    assert never["type_name"] == "allreduce" and never["missing"] == [1]
    assert rep["missing_ranks"] == [1] and rep["world"] == W.WORLD
    one = rep["ranks"]["1"]
    assert one["missing"] and one["reachable"]
    assert one["attribution"] == "input-bound"
    kinds = [e["kind"] for e in one["last_events"]]
    assert "data.wait" in kinds and "native.attach" in kinds
    assert one["host"] == rep["ranks"]["0"]["host"]
    assert rep["ranks"]["0"]["missing"] is False


def test_forced_hang_report_is_the_reference_report(hang_ranks,
                                                    monkeypatch):
    """The reference's ``build_hang_report`` on the evidence the port's
    report quotes (the stall and each rank's last events, clock and host)
    gives the same report."""
    (rep,) = hang_ranks[0]["reports"]
    stalled = [{k: v for k, v in s.items() if k != "type_name"}
               for s in rep["stalled"]]
    dumps = {int(r): {"events": e["last_events"], "clock": e["clock"],
                      "host": e["host"], "meta": {}}
             for r, e in rep["ranks"].items() if e["reachable"]}
    monkeypatch.setattr(hang_j, "_last_recovery", lambda: rep["recovery"])
    monkeypatch.setattr(hang_j, "_net_status", lambda: rep["net"])
    want = hang_j.build_hang_report(stalled, dumps, world=rep["world"],
                                    step=rep["step"])
    got = dict(rep)
    got.pop("generated_wall")
    want.pop("generated_wall")
    assert got == want
