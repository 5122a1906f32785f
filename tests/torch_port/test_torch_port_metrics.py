"""horovod_tpu_torch.metrics' registry and exporters against
horovod_tpu.metrics': the same seeded operation sequence through both
registries renders the same Prometheus text byte for byte, with equal
``snapshot()``, ``scalars()`` and ``scalar_kinds()``; the JSONL sink
rotates and prunes to the same file set; the scrape endpoint serves the
registry, answers ``/healthz``, mounts the ``/debug/*`` routes and answers
the host observer's ``/observe/*`` routes with 404 when no observer runs
(``test_torch_port_observer.py`` serves them through a running one); the
tree knobs take effect."""

import importlib
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from horovod_tpu.metrics import exporters as ex_j
from horovod_tpu_torch.metrics import exporters as ex_t

# The packages re-export the accessor ``registry()`` under the
# submodule's name, so the submodules are imported by their full names.
reg_j = importlib.import_module("horovod_tpu.metrics.registry")
reg_t = importlib.import_module("horovod_tpu_torch.metrics.registry")

BUCKETS = (0.001, 0.01, 0.1, 1.0)


def _drive(mod, seed: int):
    """A seeded sequence of counter/gauge/histogram operations over a
    fresh registry of ``mod``, with labels, escapes and exemplars."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    kinds = ["allreduce", "allgather", 'we"ird\\kind']
    for _ in range(200):
        op = int(rng.integers(0, 6))
        kind = kinds[int(rng.integers(0, len(kinds)))]
        v = float(rng.exponential(0.05))
        if op == 0:
            reg.counter("hvd_test_ops_total", "Ops\nsecond line",
                        kind=kind).inc()
        elif op == 1:
            reg.counter("hvd_test_bytes_total", "Bytes",
                        kind=kind).inc(float(rng.integers(0, 1 << 20)))
        elif op == 2:
            reg.gauge("hvd_test_ratio", "A ratio").set(v)
        elif op == 3:
            reg.gauge("hvd_test_depth", "Depth", queue=kind).inc(
                float(rng.integers(-3, 4)))
        elif op == 4:
            reg.histogram("hvd_test_latency_seconds", "Latency",
                          buckets=BUCKETS, kind=kind).observe(
                v, exemplar=f"t{int(rng.integers(0, 9))}")
        else:
            reg.histogram("hvd_test_default_seconds", "Default buckets"
                          ).observe(v * 100)
    reg.counter("hvd_test_int_total", "Integral").inc(3)
    reg.gauge("hvd_test_inf", "Infinite").set(float("inf"))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_equal_byte_for_byte(seed):
    rj, rt = _drive(reg_j, seed), _drive(reg_t, seed)
    text = ex_t.render_prometheus(rt)
    assert text.encode() == ex_j.render_prometheus(rj).encode()
    assert "# TYPE hvd_test_latency_seconds histogram" in text


@pytest.mark.parametrize("seed", [3, 4])
def test_snapshot_scalars_and_kinds_equal(seed):
    rj, rt = _drive(reg_j, seed), _drive(reg_t, seed)
    assert rt.snapshot() == rj.snapshot()
    assert rt.scalars() == rj.scalars()
    assert rt.scalar_kinds() == rj.scalar_kinds()
    for name in ("hvd_test_latency_seconds", "hvd_test_ops_total"):
        for cj, ct in zip(rj.children_of(name), rt.children_of(name)):
            assert ct.labels == cj.labels
            if hasattr(cj, "exemplars"):
                assert ct.exemplars() == cj.exemplars()
    rj.reset()
    rt.reset()
    assert rt.snapshot() == rj.snapshot()


def test_registry_refusals_match():
    for mod in (reg_j, reg_t):
        reg = mod.MetricsRegistry()
        reg.counter("hvd_x_total")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("hvd_x_total")
        reg.histogram("hvd_h", buckets=(1.0,))
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("hvd_h", buckets=(2.0,))
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("1bad")
        with pytest.raises(ValueError, match="invalid label name"):
            reg.counter("hvd_y", **{"bad-label": "v"})
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("hvd_x_total").inc(-1)


def test_disable_switch_matches():
    for mod in (reg_j, reg_t):
        reg = mod.MetricsRegistry()
        c = reg.counter("hvd_c_total")
        mod.set_enabled(False)
        try:
            c.inc(5)
            assert not mod.enabled()
        finally:
            mod.set_enabled(True)
        c.inc(2)
        assert c.value == 2.0


def _files(d):
    return sorted(os.listdir(d))


@pytest.mark.parametrize("backups", [1, 2, 3])
def test_jsonl_sink_rotates_to_the_same_files(tmp_path, backups):
    got = {}
    for name, mod in (("j", ex_j), ("t", ex_t)):
        d = tmp_path / name
        sink = mod.JsonlSink(str(d / "m.jsonl"), max_bytes=200,
                             backups=backups)
        for i in range(40):
            sink.write({"i": i, "pad": "x" * (i % 7)})
        reg = (reg_j if name == "j" else reg_t).MetricsRegistry()
        reg.counter("hvd_w_total").inc(i)
        sink.write_snapshot(reg, step=i)
        got[name] = {f: (d / f).read_text() for f in _files(d)}
    assert got["t"] == got["j"]
    # A tighter sink over the same files prunes the same backups.
    for name, mod in (("j", ex_j), ("t", ex_t)):
        mod.JsonlSink(str(tmp_path / name / "m.jsonl"), max_bytes=200,
                      backups=1)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_retention_knob_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_METRICS_RETAIN_FILES", "2")
    assert ex_t.JsonlSink(str(tmp_path / "a.jsonl")).backups == \
        ex_j.JsonlSink(str(tmp_path / "b.jsonl")).backups == 2


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_server_serves_the_registry():
    reg = _drive(reg_t, 7)
    server = ex_t.MetricsServer(host="127.0.0.1", port=0, reg=reg)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, ctype, body = _get(base + "/metrics")
        assert code == 200 and ctype == ex_j._CONTENT_TYPE
        assert body.decode() == ex_t.render_prometheus(reg)
        assert _get(base + "/healthz")[::2] == (200, b"ok")
        # The debug routes are mounted (test_torch_port_debug.py holds
        # their bodies); the observer's answer 404 while none runs.
        code, ctype, body = _get(base + "/debug/flight")
        assert code == 200 and ctype == "application/json"
        assert "events" in json.loads(body)
        code, ctype, body = _get(base + "/debug/stacks")
        assert code == 200 and b"Thread" in body
        from horovod_tpu_torch.metrics import observer
        assert observer.current_observer() is None
        code, _, body = _get(base + "/observe/digest")
        assert code == 404 and b"no host observer running" in body
        json.loads(body)
        assert _get(base + "/nope")[0] == 404
    finally:
        server.stop()


def test_serve_is_idempotent_and_stops():
    try:
        s1 = ex_t.serve(port=0, host="127.0.0.1")
        assert ex_t.serve(port=0, host="127.0.0.1") is s1
        assert _get(f"http://127.0.0.1:{s1.port}/healthz")[0] == 200
    finally:
        ex_t.stop_serving()
    assert ex_t._server is None


@pytest.mark.parametrize("knob,value", [("METRICS_TREE", "1"),
                                        ("METRICS_TOPK", "8")])
def test_tree_knobs_take_effect(monkeypatch, knob, value):
    """Each tree knob takes effect where the reference reads it: with
    METRICS_TREE, ``init()`` starts the host observer on local rank 0,
    the sync is the tree sync (no collective runs) and ``shutdown()``
    stops the observer; METRICS_TOPK caps a digest's outlier
    evidence."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, optimizers
    from horovod_tpu_torch.metrics import observer
    monkeypatch.setenv("HVD_TPU_" + knob, value)
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", "0.1")

    def no_collective(*a, **k):
        raise AssertionError("the tree sync ran a collective")

    monkeypatch.setattr(optimizers, "allgather_object", no_collective)
    hvd.init(device="cpu")
    try:
        agg = metrics.Aggregator()
        for i in range(3):
            agg.step_end(0.01, step=i)
        if knob == "METRICS_TREE":
            ob = observer.current_observer()
            assert ob is not None and ob.local_ranks == [0]
            agg.sync()
            d = agg.fleet_digest()
            assert d["round"] == 1 and d["ranks"] == 1
            assert d["hosts"] == [ob.host] and d["top_k"] == 4
        else:
            assert observer.current_observer() is None
            assert len(agg.sync()) == 1        # the flat sync
            assert agg.fleet_digest() is None
            agg.sync_tree()                    # a local-only digest
            assert agg.fleet_digest()["top_k"] == 8
    finally:
        hvd.shutdown()
    assert observer.current_observer() is None


def test_package_surface_matches_the_reference():
    """The reference's ``hvd.metrics`` names, and ``metrics.attribution``
    is the submodule (the accessor is deliberately not re-exported)."""
    import types

    import horovod_tpu.metrics as metrics_j
    import horovod_tpu_torch.metrics as metrics_t
    assert set(metrics_t.__all__) == set(metrics_j.__all__)
    assert isinstance(metrics_t.attribution, types.ModuleType)
    # The observer is a submodule, outside the package's names.
    assert "observer" not in metrics_t.__all__
    assert isinstance(importlib.import_module(
        "horovod_tpu_torch.metrics.observer"), types.ModuleType)
