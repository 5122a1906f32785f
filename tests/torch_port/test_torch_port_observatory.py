"""horovod_tpu_torch.metrics' observatory against horovod_tpu.metrics':
the same source deltas, compute seconds and FLOPs give attribution
records equal within 1e-12 relative (``HVD_TPU_PEAK_TFLOPS`` set in
both); seeded per-rank windows give the same digests, quantiles, shares
and straggler verdicts; a seeded step-time series fires the same drift
event; and ``step_end`` + ``sync`` on two gloo ranks
(``_torch_port_telemetry_workers``) gives the fleet snapshot, straggler
report and fleet MFU the reference's ``Aggregator`` gives for the same
per-rank step series.  Timings are not compared, only arithmetic."""

import importlib

import numpy as np
import pytest

import _torch_port_pool as pool
import _torch_port_telemetry_workers as W

attr_j = importlib.import_module("horovod_tpu.metrics.attribution")
attr_t = importlib.import_module("horovod_tpu_torch.metrics.attribution")
agg_j = importlib.import_module("horovod_tpu.metrics.aggregate")
agg_t = importlib.import_module("horovod_tpu_torch.metrics.aggregate")
base_j = importlib.import_module("horovod_tpu.metrics.baseline")
base_t = importlib.import_module("horovod_tpu_torch.metrics.baseline")
dig_j = importlib.import_module("horovod_tpu.metrics.digest")
dig_t = importlib.import_module("horovod_tpu_torch.metrics.digest")
hl_j = importlib.import_module("horovod_tpu.metrics.health")
hl_t = importlib.import_module("horovod_tpu_torch.metrics.health")
reg_j = importlib.import_module("horovod_tpu.metrics.registry")
reg_t = importlib.import_module("horovod_tpu_torch.metrics.registry")

REL = 1e-12


@pytest.fixture
def peak(monkeypatch):
    monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", W.PEAK_TFLOPS)
    for mod in (attr_j, attr_t):
        mod.reset_peak_cache()
    yield float(W.PEAK_TFLOPS) * 1e12
    monkeypatch.delenv("HVD_TPU_PEAK_TFLOPS")
    for mod in (attr_j, attr_t):
        mod.reset_peak_cache()


def _close(a, b, rel=REL):
    if isinstance(a, dict):
        assert set(a) == set(b), (a, b)
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=1e-300), (a, b)
    else:
        assert a == b


_SOURCES = (("hvd_data_wait_seconds_total", "counter"),
            ("hvd_collective_latency_seconds", "histogram"),
            ("hvd_overlap_comm_exposed_seconds_total", "counter"),
            ("hvd_overlap_fallback_latency_seconds_total", "counter"),
            ("hvd_overlap_comm_hidden_seconds_total", "counter"),
            ("hvd_checkpoint_blocking_seconds_total", "counter"),
            ("hvd_pipeline_bubble_seconds_total", "counter"))


def _attribution_run(mod_attr, mod_reg, seed: int, measured: bool,
                     reset_at=None):
    reg = mod_reg.MetricsRegistry()
    eng = mod_attr.StepAttribution(reg)
    eng.set_step_flops(2.5e12)
    rng = np.random.default_rng(seed)
    records = []
    for step in range(12):
        dur = float(rng.uniform(0.05, 0.2))
        for name, kind in _SOURCES:
            v = float(rng.uniform(0.0, dur / 12))
            if kind == "histogram":
                reg.histogram(name, kind="allreduce").observe(v)
            else:
                reg.counter(name).inc(v)
        if measured:
            eng.note_compute(float(rng.uniform(0.3, 1.1)) * dur)
        if step == reset_at:
            reg.counter("hvd_data_wait_seconds_total").reset()
        records.append(eng.close_step(step, dur))
    return records, reg.snapshot(), eng.window_components(), \
        eng.window_shares()


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_attribution_records_equal(peak, measured, seed):
    got = _attribution_run(attr_t, reg_t, seed, measured)
    want = _attribution_run(attr_j, reg_j, seed, measured)
    assert got[0][0] is None and want[0][0] is None   # the anchor
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2], want[2])
    _close(got[3], want[3])
    assert all(r["mfu"] is not None for r in got[0][1:])
    assert got[0][5]["mfu"] == pytest.approx(
        2.5e12 / (got[0][5]["dur_s"] * peak), rel=REL)


def test_attribution_skips_a_reset_window(peak):
    got = _attribution_run(attr_t, reg_t, 2, True, reset_at=5)[0]
    want = _attribution_run(attr_j, reg_j, 2, True, reset_at=5)[0]
    assert got[5] is None and want[5] is None
    _close(got, want)


def test_components_sum_to_the_wall(peak):
    records = _attribution_run(attr_t, reg_t, 3, True)[0]
    for r in records[1:]:
        wall = sum(r["components"][k] for k in attr_t.WALL_COMPONENTS)
        assert wall == pytest.approx(r["dur_s"], rel=1e-9)


def test_peak_by_card_name_and_override(monkeypatch):
    assert attr_t.peak_for_name("NVIDIA H100 80GB HBM3") == 989.4e12
    assert attr_t.peak_for_name("NVIDIA H100 PCIe") == 756e12
    assert attr_t.peak_for_name("NVIDIA H100 SXM5 80GB") == 989.4e12
    assert attr_t.peak_for_name("Some Other GPU") is None
    monkeypatch.delenv("HVD_TPU_PEAK_TFLOPS", raising=False)
    attr_t.reset_peak_cache()
    try:
        assert attr_t.peak_flops() is None      # no CUDA device here
        monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", "500")
        assert attr_t.peak_flops() is None      # cached
        attr_t.reset_peak_cache()
        assert attr_t.peak_flops() == 500e12
    finally:
        attr_t.reset_peak_cache()


def test_compute_span_measures_on_the_cpu():
    eng = attr_t.StepAttribution(reg_t.MetricsRegistry())
    with eng.compute_span():
        sum(range(10000))
    assert eng._compute_total > 0


def test_collective_time_inside_the_span_counts_once(peak):
    """A collective's CUDA-event seconds recorded inside a compute span
    (``note_comm_in_span``) come out of ``compute``: comm_exposed holds
    them, and host is the step's time outside the span."""
    assert not attr_t.in_compute_span()
    with attr_t.StepAttribution(reg_t.MetricsRegistry()).compute_span():
        assert attr_t.in_compute_span()
    assert not attr_t.in_compute_span()
    reg = reg_t.MetricsRegistry()
    eng = attr_t.StepAttribution(reg)
    lat = reg.histogram("hvd_collective_latency_seconds", kind="allreduce")
    eng.close_step(0, 0.01)                 # the anchor
    eng.note_compute(0.010)
    lat.observe(0.002)
    eng.note_comm_in_span(0.002)
    rec = eng.close_step(1, 0.0115)
    c = rec["components"]
    assert c["compute"] == pytest.approx(0.008, rel=REL)
    assert c["comm_exposed"] == pytest.approx(0.002, rel=REL)
    assert c["host"] == pytest.approx(0.0015, rel=1e-9)


def _rank_snapshots(seed: int, n: int, slow=(), cause="input"):
    """Per-rank window snapshots (Aggregator.local_snapshot's shape)."""
    rng = np.random.default_rng(seed)
    snaps = []
    for r in range(n):
        steps = int(rng.integers(5, 20))
        times = rng.uniform(0.09, 0.11, steps) * (2.5 if r in slow else 1)
        sk = dig_t.QuantileSketch.of(times.tolist())
        comps = {k: float(rng.uniform(0.0, 0.01)) * steps
                 for k in attr_t.WALL_COMPONENTS}
        if r in slow:
            comps[cause] += float(times.sum()) * 0.5
        comps.update(steps=float(steps), flops=1e12 * steps,
                     wall=float(times.sum()), comm_hidden=0.0)
        snaps.append({"rank": r, "step": 100, "step_time_sum":
                      float(times.sum()), "step_count": steps,
                      "data_wait_sum": comps["input"],
                      "data_wait_count": steps, "sketch": sk.to_dict(),
                      "attr": comps,
                      "scalars": {"hvd_x_total": float(r),
                                  "hvd_g": float(rng.random())}})
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digests_quantiles_and_shares_equal(seed, peak):
    snaps = _rank_snapshots(seed, 8, slow=(3, 6), cause="checkpoint")
    kinds = {"hvd_x_total": "counter", "hvd_g": "gauge"}
    host = {}
    for name, mod in (("j", dig_j), ("t", dig_t)):
        a = mod.snapshot_digest(snaps[:3], host="h0", top_k=2,
                                expected_ranks=[0, 1, 2, 9],
                                scalar_kinds=kinds, peak=peak)
        b = mod.snapshot_digest(snaps[3:], host="h1", top_k=2,
                                scalar_kinds=kinds, peak=peak)
        fleet = mod.merge_digests(a, b)
        host[name] = (a, b, fleet, mod.merge_all([b, a]),
                      mod.digest_step_quantiles(fleet),
                      mod.digest_shares(fleet), mod.digest_mfu(fleet),
                      mod.digest_median_step(fleet),
                      mod.digest_component_medians(fleet))
    _close(host["t"], host["j"])
    assert host["t"][2]["missing"] == [9]


@pytest.mark.parametrize("cause", ["checkpoint", "input", "comm_exposed"])
def test_straggler_verdicts_equal(cause):
    snaps = _rank_snapshots(7, 6, slow=(4,), cause=cause)
    got, want = [], []
    for mod, out in ((hl_t, got), (hl_j, want)):
        det = mod.StragglerDetector(factor=1.5, min_seconds=1e-3,
                                    patience=2)
        for _ in range(2):
            out.append([(h.rank, h.score, h.flagged, h.cause,
                         h.components) for h in det.score_ranks(snaps)])
            det.evaluate(snaps, warn=False)
        out.append(det.blacklist_hint())
        dig = (dig_t if mod is hl_t else dig_j).snapshot_digest(
            snaps, host="h", top_k=3)
        out.append([(h.rank, h.flagged, h.cause)
                    for h in det.score_digest(dig)])
    _close(got, want)
    assert got[-2] == [4] and (4, True, cause) in got[-1]


def _drift_series(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(90):
        slow = i >= 50
        dur = float((0.014 if slow else 0.010) * (1 + 0.02 *
                                                    rng.standard_normal()))
        shares = {"compute": 0.7, "input": 0.25 if slow else 0.05,
                  "comm_exposed": 0.05 if slow else 0.25,
                  "checkpoint": 0.0, "pipeline_bubble": 0.0, "host": 0.0}
        out.append((i, dur, shares))
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_drift_event_equal(seed):
    got = {}
    for name, mod in (("j", base_j), ("t", base_t)):
        det = mod.DriftDetector(warmup=20, threshold=8.0, min_pct=10.0,
                                cooldown=10, emit_report=False)
        fired = [det.update(i, d, shares=s) for i, d, s in
                 _drift_series(seed)]
        got[name] = ([None if e is None else
                      {k: v for k, v in e.as_dict().items()
                       if k != "onset_wall"} for e in fired],
                     det.state())
    _close(got["t"], got["j"])
    events = [e for e in got["t"][0] if e is not None]
    assert events and events[0]["component"] == "input"
    assert events[0]["step"] >= 50 and events[0]["onset_step"] > 20


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "telemetry")


def _reference_snapshots(monkeypatch):
    """The reference Aggregator's window snapshot of each rank's step
    series, closed through the reference's own attribution engine on a
    registry of its own: this process's may hold the reference's
    instruments of other test files, still recording."""
    monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", W.PEAK_TFLOPS)
    attr_j.reset_peak_cache()
    # The ranks' series run one after the other here: keep them out of
    # the process's drift detector (and its report files).
    base_j.set_drift_enabled(False)
    snaps = []
    for r in range(W.WORLD):
        reg = reg_j.MetricsRegistry()
        monkeypatch.setattr(agg_j, "_registry", lambda: reg)
        monkeypatch.setattr(attr_j, "_attribution",
                            attr_j.StepAttribution(reg))
        attr_j.set_step_flops(W.STEP_FLOPS)
        agg = agg_j.Aggregator()
        for i, t in enumerate(W.step_times(r)):
            agg.step_end(step_time_s=t, step=i)
        agg.step_end(step_time_s=1.0, step=W.N_STEPS - 1)
        snap = agg.local_snapshot()
        snap["rank"] = r
        snaps.append(snap)
    attr_j.reset_peak_cache()
    base_j.set_drift_enabled(None)
    return snaps


def test_two_rank_fleet_snapshot_equals_the_reference(ranks, monkeypatch):
    want = _reference_snapshots(monkeypatch)
    for r in range(W.WORLD):
        assert ranks[r]["fleet"]
        got = ranks[r]["gathered"]
        assert [s["rank"] for s in got] == list(range(W.WORLD))
        for g, w in zip(got, want):
            _close(g, {k: v for k, v in w.items() if k != "scalars"})
        assert "hvd_steps_total" in ranks[r]["scalar_keys"][r]
        assert ranks[r]["steps_total"] == W.N_STEPS


def test_two_rank_straggler_report_and_fleet_mfu(ranks, monkeypatch):
    want = _reference_snapshots(monkeypatch)
    report = [(h.rank, h.step_time_mean, h.data_wait_mean, h.score,
               h.flagged, h.cause, h.steps, h.components)
              for h in hl_j.StragglerDetector().score_ranks(want)]
    monkeypatch.setenv("HVD_TPU_PEAK_TFLOPS", W.PEAK_TFLOPS)
    attr_j.reset_peak_cache()
    reg = reg_j.MetricsRegistry()
    agg_j.Aggregator._fleet_mfu_gauges(want, reg)
    attr_j.reset_peak_cache()
    snap = reg.snapshot()
    for r in range(W.WORLD):
        _close([tuple(x) for x in ranks[r]["report"]], report)
        gauges = ranks[r]["fleet_gauges"]
        for name in ("hvd_mfu_fleet_min", "hvd_mfu_fleet_mean"):
            _close(gauges[name], snap[name]["series"][0]["value"])
        assert gauges["hvd_straggler_ranks"] == 1.0
        assert gauges["hvd_metrics_syncs_total"] == 1.0
        assert ranks[r]["dump"] == f"flight_rank{r}.json"
    assert report[1][4] and not report[0][4]


def test_step_end_is_idempotent_per_index():
    got = []
    for mod in (agg_t, agg_j):
        agg = mod.Aggregator()
        for i in (0, 1, 1, 0, 2, 5, 3):
            agg.step_end(step_time_s=0.01, step=i)
        got.append((agg._step, agg._step_count, agg._step_sum))
    assert got[0] == got[1] == (4, 4, pytest.approx(0.04))
