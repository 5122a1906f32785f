"""horovod_tpu_torch.debug.regression against horovod_tpu.debug.regression:
the same event vocabulary and classification; ``build_regression_report``
on the same ``DriftEvent``, seeded flight events and fleet view gives the
same suspect, subsystem, verdict and quoted events (the whole report, its
rank and world aside); the report is written under the same name and
amended by ``record_tuning`` alike; and the reference's input drill
(tests/test_perf_observatory.py): ``HVD_TPU_CHAOS_INPUT_DELAY_MS``
through the port's ``InlineIterator`` fires one drift whose report names
the input component and the data subsystem.  The comm drill
(``HVD_TPU_CHAOS_COMM_DELAY_MS``) is held to its flight event and its
delay inside the collective's span."""

import importlib
import json
import os
import time

import numpy as np
import pytest

reg_j = importlib.import_module("horovod_tpu.debug.regression")
reg_t = importlib.import_module("horovod_tpu_torch.debug.regression")
base_j = importlib.import_module("horovod_tpu.metrics.baseline")
base_t = importlib.import_module("horovod_tpu_torch.metrics.baseline")
agg_j = importlib.import_module("horovod_tpu.metrics.aggregate")
agg_t = importlib.import_module("horovod_tpu_torch.metrics.aggregate")

COMPONENTS = ["input", "comm_exposed", "checkpoint", "compute",
              "pipeline_bubble", "host", "other"]
KINDS = sorted(reg_j.EVENT_SUBSYSTEM) + [
    "checkpoint.extract.begin", "recovery.restore.miss", "perf.drift",
    "perf.report", "collective.enqueue", "negotiate.execute", "trace.x.y",
    "elastic.world_failed", "net", "", None]


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (reg_j, reg_t):
        mod.reset()
    yield
    for mod in (reg_j, reg_t):
        mod.reset()


def test_vocabulary_is_the_reference():
    assert reg_t.EVENT_SUBSYSTEM == reg_j.EVENT_SUBSYSTEM
    assert reg_t.COMPONENT_SUBSYSTEMS == reg_j.COMPONENT_SUBSYSTEMS
    assert reg_t._CORROBORATING == reg_j._CORROBORATING
    for kind in KINDS:
        assert reg_t._classify(kind) == reg_j._classify(kind), kind


def _event(mod, seed, component):
    rng = np.random.default_rng(seed)
    return mod.DriftEvent(
        step=int(rng.integers(20, 200)), onset_step=int(rng.integers(5, 20)),
        onset_wall=1000.0 + float(rng.uniform()), onset_mono=500.0,
        ratio=float(rng.uniform(1.2, 3.0)), component=component,
        baseline_s=float(rng.uniform(0.01, 0.02)),
        current_s=float(rng.uniform(0.02, 0.05)),
        share_delta=float(rng.uniform(0.1, 0.6)))


def _flight_events(seed, n=60):
    """Seeded flight events around the onset (t_mono 500): in and out of
    the look-back, before and after the causal slack, discrete and
    corroborating, classified and not."""
    rng = np.random.default_rng(100 + seed)
    return [{"seq": i, "t_mono": 500.0 + float(rng.uniform(-150, 5)),
             "t_wall": 2000.0 + i,
             "kind": KINDS[int(rng.integers(0, len(KINDS) - 2))],
             "name": f"n{int(rng.integers(0, 4))}",
             "bytes": int(rng.integers(0, 1 << 20))}
            for i in range(n)]


FLEET = [{"rank": 0, "step_time_sum": 0.6, "step_count": 30,
          "attr": {"steps": 30.0, "flops": 1e12, "wall": 0.6,
                   "input": 0.3, "compute": 0.25, "comm_exposed": 0.05}},
         {"rank": 1, "step_time_sum": 0.9, "step_count": 30,
          "attr": {"steps": 30.0, "wall": 0.9, "input": 0.6,
                   "compute": 0.3}},
         {"rank": 2, "step_time_sum": 0.0, "step_count": 0, "attr": {}}]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("component", COMPONENTS)
def test_build_regression_report_matches_reference(seed, component,
                                                   monkeypatch):
    monkeypatch.setenv("HVD_TPU_PERF_DRIFT_LOOKBACK_S",
                       ["120", "30", "7.5", "400"][seed])
    if seed % 2:
        for mod in (agg_j, agg_t):
            monkeypatch.setattr(mod.aggregator(), "fleet", lambda: FLEET)
    events = _flight_events(seed)
    got = reg_t.build_regression_report(
        _event(base_t, seed, component), write=False, events=events)
    want = reg_j.build_regression_report(
        _event(base_j, seed, component), write=False, events=events)
    for rep in (got, want):
        rep.pop("rank")
        rep.pop("world")
    assert got == want
    assert reg_t.last_report() is got
    if seed % 2:
        assert got["slowest_rank"]["rank"] == 1


def test_report_written_and_amended_as_the_reference(tmp_path, monkeypatch):
    """The reference's atomic-write test, then ``record_tuning``: both
    packages write ``perf_regression_step42.json`` with the same body and
    amend it alike."""
    bodies = []
    for mod, base in ((reg_t, base_t), (reg_j, base_j)):
        d = tmp_path / mod.__name__.split(".")[0]
        monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(d))
        event = base.DriftEvent(42, 39, 1000.0, 50.0, 2.0, "checkpoint",
                                0.01, 0.02, 0.3)
        rep = mod.build_regression_report(
            event, write=True, events=[{"kind": "checkpoint.save.commit",
                                        "name": None, "t_mono": 49.5}])
        path = d / "perf_regression_step42.json"
        assert rep["path"] == str(path) and mod.last_report() is rep
        assert mod.record_tuning({"retune": "skipped"})["tuning"] == {
            "retune": "skipped"}
        body = json.loads(path.read_text())
        assert body["tuning"] == {"retune": "skipped"}
        assert not [p for p in os.listdir(d) if ".tmp." in p]
        for k in ("rank", "world", "path"):
            body.pop(k)
        bodies.append(body)
    assert bodies[0] == bodies[1]
    assert bodies[0]["suspect"]["subsystem"] == "checkpoint"


def test_record_tuning_before_any_report():
    assert reg_t.record_tuning({"x": 1}) is reg_j.record_tuning({"x": 1}) \
        is None


# ---------------------------------------------------------------------------
# the drills
# ---------------------------------------------------------------------------

def _drill_loop(agg, iterator, n):
    """The reference's drill loop: ``InlineIterator`` brackets its own
    ``next()`` in a data_wait span; 4 ms of "compute" a step."""
    step = agg.local_snapshot()["step"]
    it = iter(iterator)
    for _ in range(n):
        next(it)
        time.sleep(0.004)
        step += 1
        agg.step_end(step=step)


def test_drift_drill_input_slowdown_names_the_input_component(
        monkeypatch, tmp_path):
    from horovod_tpu_torch.data.prefetch import InlineIterator
    from horovod_tpu_torch.metrics import Aggregator, drift_detector
    reset_drift_detector = base_t.reset_drift_detector
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_TPU_PERF_DRIFT_WARMUP", "10")
    monkeypatch.setenv("HVD_TPU_PERF_DRIFT_THRESHOLD", "6")
    monkeypatch.setenv("HVD_TPU_PERF_DRIFT_MIN_PCT", "50")
    monkeypatch.setenv("HVD_TPU_PERF_DRIFT_COOLDOWN", "100")
    reset_drift_detector()
    try:
        agg = Aggregator()
        _drill_loop(agg, InlineIterator(iter(range(10_000))), 20)
        assert drift_detector().events() == []
        # The injection: every batch now pays 30 ms in the input path.
        monkeypatch.setenv("HVD_TPU_CHAOS_INPUT_DELAY_MS", "30")
        _drill_loop(agg, InlineIterator(iter(range(10_000))), 25)
        (ev,) = drift_detector().events()
        assert ev.component == "input" and ev.ratio > 1.5
        assert ev.step <= 20 + 25
        rep = reg_t.last_report()
        assert rep["component"] == "input"
        assert rep["suspect"]["subsystem"] == "data"
        assert rep["suspect"]["kind"] == "data.chaos_delay"
        assert "input pipeline" in rep["verdict"]
        assert os.path.exists(rep["path"]) and ev.report_path == rep["path"]
    finally:
        reset_drift_detector()


def test_prefetch_producer_pays_the_input_delay(monkeypatch):
    from horovod_tpu_torch.data.prefetch import PrefetchIterator
    from horovod_tpu_torch.debug import flight
    monkeypatch.setenv("HVD_TPU_CHAOS_INPUT_DELAY_MS", "20")
    # New events by sequence number: once the 4096-event ring is full (a
    # long run of earlier tests in this process), its length stops
    # growing and a slice by position would be empty.
    seq0 = max((e["seq"] for e in flight.snapshot()), default=-1)
    # The clock starts before the producer thread does: it pays the first
    # item's delay as soon as it is constructed.
    t0 = time.perf_counter()
    it = PrefetchIterator(iter(range(5)), depth=1, name="drill")
    try:
        assert list(it) == list(range(5))
        assert time.perf_counter() - t0 >= 5 * 0.020
    finally:
        it.close()
    assert ("data.chaos_delay", "drill") in [
        (e["kind"], e["name"]) for e in flight.snapshot()
        if e["seq"] > seq0]


def test_comm_delay_is_paid_inside_the_collective(monkeypatch):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.debug import flight
    from horovod_tpu_torch.ops import collective
    monkeypatch.setenv("HVD_TPU_CHAOS_COMM_DELAY_MS", "25")
    collective.reset_comm_chaos()
    hvd.init(device="cpu")
    try:
        seq0 = max((e["seq"] for e in flight.snapshot()), default=-1)
        t0 = time.perf_counter()
        out = hvd.allreduce(torch.ones(3), name="drill")
        assert time.perf_counter() - t0 >= 0.025
        assert out.tolist() == [1.0, 1.0, 1.0]
        events = [e for e in flight.snapshot() if e["seq"] > seq0]
        assert ("net.chaos_delay", "eager") in [
            (e["kind"], e["name"]) for e in events]
        (done,) = [e for e in events if e["kind"] == "collective.done"]
        assert done["dur_s"] >= 0.025
        assert reg_t._classify("net.chaos_delay") == "net"
    finally:
        hvd.shutdown()
        monkeypatch.delenv("HVD_TPU_CHAOS_COMM_DELAY_MS")
        collective.reset_comm_chaos()
