"""The port's instrumented paths record the reference's metric families
and flight events: for the eager collectives (two gloo ranks of
``_torch_port_telemetry_workers`` against the reference at world 1 on
the same per-rank inputs), a checkpoint save and restore, the prefetch
and inline loaders, and a ``DecodeEngine`` burst, the set of (family,
kind, label keys) each path moves is equal, and so are the event
counters (ops, bytes, saves, restores, spans, requests, tokens) and the
flight events' kinds.  Likewise for a KV migration on the int8 wire with
the autoscaler's resizes (its bytes, migrations and resizes by
direction), and for the tree sync's rounds through a host observer
(late snapshots, a stale round; the gateway push, which no gateway
is configured for here, moves in neither: test_torch_port_fleet.py holds
it).  Timings are not compared."""

import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_pool as pool
import _torch_port_telemetry_workers as W
import horovod_tpu as hvd_j
from horovod_tpu.checkpoint import engine as ckpt_j
from horovod_tpu.checkpoint import manifest as man_j
from horovod_tpu.data import prefetch as pf_j
from horovod_tpu.debug import flight as fl_j
from horovod_tpu.models import transformer as tfm_j
from horovod_tpu.serving import engine as eng_j
from horovod_tpu.serving import loadgen as load_j
from horovod_tpu_torch import convert
from horovod_tpu_torch.checkpoint import engine as ckpt_t
from horovod_tpu_torch.checkpoint import manifest as man_t
from horovod_tpu_torch.data import prefetch as pf_t
from horovod_tpu_torch.debug import flight as fl_t
from horovod_tpu_torch.models import transformer as tfm_t
from horovod_tpu_torch.serving import engine as eng_t
from horovod_tpu_torch.serving import loadgen as load_t

reg_j = importlib.import_module("horovod_tpu.metrics.registry")
reg_t = importlib.import_module("horovod_tpu_torch.metrics.registry")

# Families that count events (compared by value, not only by name).
EVENT_FAMILIES = (
    "hvd_collective_ops_total", "hvd_collective_bytes_total",
    "hvd_wire_bytes_raw_total", "hvd_wire_bytes_sent_total",
    "hvd_collective_latency_seconds", "hvd_checkpoint_saves_total",
    "hvd_checkpoint_restores_total", "hvd_checkpoint_bytes_read_total",
    "hvd_checkpoint_save_seconds", "hvd_checkpoint_restore_seconds",
    "hvd_data_wait_spans_total", "hvd_data_wait_seconds",
    "hvd_serving_tokens_total", "hvd_serving_requests_total",
    "hvd_serving_shed_total", "hvd_serving_ttft_seconds",
    "hvd_serving_token_seconds", "hvd_serving_prefix_hits_total",
    "hvd_serving_prefix_misses_total",
    "hvd_serving_prefix_tokens_reused_total",
    "hvd_serving_migrate_bytes_total", "hvd_serving_migrations_total",
    "hvd_serving_autoscale_total", "hvd_metrics_tree_stale_rounds_total",
    "hvd_observe_late_snapshots_total", "hvd_observe_pushes_total",
    "hvd_metrics_syncs_total")


def _signature(delta: dict) -> set:
    return {(name, fam["kind"],
             tuple(sorted(k.split("=")[0] for k in key.split(",") if k)))
            for name, fam in delta.items() for key in fam["series"]}


def _events(delta: dict) -> dict:
    return {name: fam["series"] for name, fam in delta.items()
            if name in EVENT_FAMILIES}


class _Watch:
    """Registry and flight deltas of both packages around a block."""

    def __enter__(self):
        self.before = (reg_j.registry().snapshot(),
                       reg_t.registry().snapshot())
        # Sequence numbers, not lengths: a full ring stops growing.
        self.n = tuple(max((e["seq"] for e in fl.snapshot()), default=-1)
                       for fl in (fl_j, fl_t))
        return self

    def __exit__(self, *exc):
        self.ref = W.family_delta(self.before[0], reg_j.registry().snapshot())
        self.port = W.family_delta(self.before[1],
                                   reg_t.registry().snapshot())
        self.ref_events = [e["kind"] for e in fl_j.snapshot()
                           if e["seq"] > self.n[0]]
        self.port_events = [e["kind"] for e in fl_t.snapshot()
                            if e["seq"] > self.n[1]]

    def assert_equal(self):
        assert _signature(self.port) == _signature(self.ref)
        assert _events(self.port) == _events(self.ref)
        assert sorted(self.port_events) == sorted(self.ref_events)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "telemetry")


@pytest.fixture(scope="module")
def reference_ops():
    """The reference's eager collectives at world 1 on each rank's
    inputs: (family delta, flight events)."""
    hvd_j.init()
    out = []
    for r in range(W.WORLD):
        # Each port rank is a fresh process: start the reference's
        # last-op gauges from zero too, so setting them counts as moved.
        for c in reg_j.registry().children_of("hvd_wire_compression_ratio"):
            c.reset()
        before = reg_j.registry().snapshot()
        # New events by sequence number, not position: a full ring
        # stops growing.
        seq0 = max((e["seq"] for e in fl_j.snapshot()), default=-1)
        W.run_ops(hvd_j, W.op_inputs(r))
        out.append((W.family_delta(before, reg_j.registry().snapshot()),
                    [(e["kind"], e["name"], e.get("op"))
                     for e in fl_j.snapshot() if e["seq"] > seq0]))
    return out


@pytest.mark.parametrize("rank", range(W.WORLD))
def test_eager_collective_families(ranks, reference_ops, rank):
    ref, ref_events = reference_ops[rank]
    got = ranks[rank]["families"]
    assert _signature(got) == _signature(ref)
    assert _events(got) == _events(ref)
    assert got["hvd_collective_ops_total"]["series"]["kind=allreduce"] == 3
    assert [tuple(e) for e in ranks[rank]["events"]] == ref_events


def _specs(mod):
    return [mod.LeafSpec(path="w", kind=mod.SHARDED, shape=[6, 3],
                         dtype="float32", true_size=18),
            mod.LeafSpec(path="b", kind=mod.REPLICATED, shape=[3],
                         dtype="float32", true_size=3)]


def test_checkpoint_save_and_restore_families(tmp_path):
    rng = np.random.default_rng(3)
    vals = {r: [rng.standard_normal(9).astype(np.float32),
                rng.standard_normal(3).astype(np.float32)]
            for r in range(2)}
    with _Watch() as w:
        for name, eng, man in (("j", ckpt_j, man_j), ("t", ckpt_t, man_t)):
            eng.save_leaves(str(tmp_path / name), 1, _specs(man), vals, 2)
            eng.restore_leaves(str(tmp_path / name), 1, 2)
            with eng.open_step(str(tmp_path / name), 1, 1) as step:
                step.full_value(_specs(man)[0])
    w.assert_equal()
    assert w.port["hvd_checkpoint_saves_total"]["series"][""] == 1
    assert w.port["hvd_checkpoint_restores_total"]["series"][""] == 2
    assert w.port["hvd_checkpoint_blocking_seconds_total"]["series"][""] > 0


def test_prefetch_and_inline_loader_families():
    with _Watch() as w:
        for mod in (pf_j, pf_t):
            it = mod.PrefetchIterator(iter(range(5)), depth=2)
            assert list(it) == list(range(5))
            assert list(mod.InlineIterator(iter(range(3)))) == [0, 1, 2]
    w.assert_equal()
    assert w.port["hvd_data_wait_spans_total"]["series"][""] == 10


def _slow_source(n):
    for i in range(n):
        time.sleep(0.01)
        yield i


def test_prefetch_wait_feeds_the_input_component():
    from horovod_tpu_torch.metrics.attribution import StepAttribution
    eng = StepAttribution()
    eng.close_step(0, 0.05)                 # the anchor
    it = pf_t.PrefetchIterator(_slow_source(2), depth=1)
    next(it)
    rec = eng.close_step(1, 0.05)
    assert rec["components"]["input"] > 0
    it.close()


SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=64, remat=False)


def test_decode_engine_burst_families():
    cfg_j = tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL)
    cfg_t = tfm_t.TransformerConfig(dtype=torch.float32, **SMALL)
    pj = tfm_j.init_params(jax.random.PRNGKey(0), cfg_j,
                           tfm_j.ParallelConfig())
    model = tfm_t.Transformer(cfg_t, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    kw = dict(slots=3, page_tokens=8, max_len=64, prefix_cache=True,
              prefill_chunk=8)
    ej = eng_j.DecodeEngine(cfg_j, pj, **kw)
    et = eng_t.DecodeEngine(cfg_t, model, **kw)
    sj = load_j.synthetic_workload(9, 6, 0.0, vocab=64)
    st = load_t.synthetic_workload(9, 6, 0.0, vocab=64)
    tok0 = et.tokens_out
    with _Watch() as w:
        for r in range(6):
            eng_j.record_request("default")
            eng_t.record_request("default")
        out_j = load_j.drive(ej, sj)
        out_t = load_t.drive(et, st)
    w.assert_equal()
    assert {k: v.get("tokens") for k, v in out_t["results"].items()} == \
        {k: v.get("tokens") for k, v in out_j["results"].items()}
    tokens = w.port["hvd_serving_tokens_total"]["series"][""]
    assert tokens == et.tokens_out - tok0 > 0
    assert w.port["hvd_serving_requests_total"]["series"][
        "tenant=default"] == 6
    served = sum(1 for r in out_t["results"].values() if r.get("tokens"))
    shed = sum(w.port["hvd_serving_shed_total"]["series"].values())
    assert served > 0 and served + shed == 6
    assert w.port["hvd_serving_ttft_seconds"]["series"][""] == served
    assert w.port_events.count("serving.admit") == served
    assert w.port_events.count("serving.retire") == served


def test_migration_and_autoscale_families():
    from horovod_tpu.serving import autoscale as auto_j
    from horovod_tpu.serving import disagg as dis_j
    from horovod_tpu_torch.serving import autoscale as auto_t
    from horovod_tpu_torch.serving import disagg as dis_t
    cfg_j = tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL)
    cfg_t = tfm_t.TransformerConfig(dtype=torch.float32, **SMALL)
    pj = tfm_j.init_params(jax.random.PRNGKey(0), cfg_j,
                           tfm_j.ParallelConfig())
    model = tfm_t.Transformer(cfg_t, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    kw = dict(slots=2, page_tokens=8, max_len=32, prefix_cache=False)

    class Driver:
        def request_resize(self, np_, reason):
            return True

    with _Watch() as w:
        for eng, cfg, p, dis, auto in (
                (eng_j, cfg_j, pj, dis_j, auto_j),
                (eng_t, cfg_t, model, dis_t, auto_t)):
            src = eng.DecodeEngine(cfg, p, **kw)
            dst = eng.DecodeEngine(cfg, p, **kw)
            src.admit(eng.Request(id="q", prompt=list(range(3, 20)),
                                  max_new_tokens=4))
            dis.migrate(src, "q", dst, bits=8)
            status = {"np": 1, "queue_depth": 9}
            a = auto.Autoscaler(Driver(), lambda: status, min_np=1,
                                max_np=3, target_queue=4.0, cooldown_s=0)
            a.maybe_resize(now=10.0)
            status.update(np=2, queue_depth=0)
            a.maybe_resize(now=20.0)
    w.assert_equal()
    assert w.port["hvd_serving_migrations_total"]["series"][""] == 1
    assert w.port["hvd_serving_migrate_bytes_total"]["series"][""] == \
        w.ref["hvd_serving_migrate_bytes_total"]["series"][""] > 0
    assert w.port["hvd_serving_autoscale_total"]["series"] == \
        {"direction=up": 1, "direction=down": 1}
    assert w.port_events.count("serving.migrate") == 1
    assert w.port_events.count("serving.autoscale") == 2


def test_tree_sync_families(monkeypatch):
    """A late snapshot at an observer, then a fresh and a stale tree
    round of an aggregator, in each package."""
    from horovod_tpu.metrics import aggregate as agg_j
    from horovod_tpu.metrics import observer as ob_j
    from horovod_tpu_torch.metrics import aggregate as agg_t
    from horovod_tpu_torch.metrics import observer as ob_t
    monkeypatch.setenv("HVD_TPU_METRICS_TREE", "1")
    monkeypatch.setenv("HVD_TPU_METRICS_TREE_GRACE_S", "0.1")
    with _Watch() as w:
        for agg, ob in ((agg_j, ob_j), (agg_t, ob_t)):
            observer = ob.HostObserver("h", [0]).start()
            try:
                snap = agg.Aggregator().local_snapshot()
                observer.submit_snapshot(1, snap)
                fresh = observer.fleet_digest(min_round=1, wait_s=10)
                observer.submit_snapshot(1, snap)          # late
            finally:
                observer.stop()
            served = []
            monkeypatch.setattr(ob, "rank_sync",
                                lambda s, r: served.pop(0))
            a = agg.Aggregator()
            served += [dict(fresh, round=1), dict(fresh, round=1)]
            a.sync()                                   # round 1: fresh
            a.sync()                                   # round 2: stale
    w.assert_equal()
    assert w.port["hvd_metrics_tree_stale_rounds_total"]["series"][""] == 1
    assert w.port["hvd_observe_late_snapshots_total"]["series"][""] == 1
    assert w.port["hvd_metrics_syncs_total"]["series"][""] == 2
    assert "hvd_observe_pushes_total" not in w.port


# -- the public views keep their own counts ----------------------------------

@pytest.fixture
def telemetry_off():
    """The registry and the flight recorder switched off for one test."""
    reg_t.set_enabled(False)
    fl_t.set_enabled(False)
    try:
        yield
    finally:
        reg_t.set_enabled(True)
        fl_t.set_enabled(True)


def test_controller_stats_with_telemetry_off(telemetry_off, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR",
                       f"127.0.0.1:{pool.free_ports(1)[0]}")
    hvd.init(device="cpu", use_controller=True)
    try:
        x = torch.arange(6.0)
        hvd.allreduce(x, name="a")
        hvd.allreduce(x, name="a")
        hvd.allgather(x, name="g")
        s = global_state.controller.stats()
    finally:
        hvd.shutdown()
    assert s["enqueued"] == 3 and s["responses"] == 3 and s["names"] == 3
    assert s["names_per_response"] == {1: 3}
    assert s["bytes_raw"] == s["bytes_sent"] == 3 * x.numel() * 4
    assert s["cache_hits"] == 1


def test_slo_gauges_are_per_tracker_with_telemetry_off(telemetry_off):
    from horovod_tpu_torch.serving.slo import SloTracker
    a, b = SloTracker(0.9, 60.0), SloTracker(0.9, 60.0)
    for i in range(4):
        a.record("t", True, float(i))
        b.record("t", i % 2 == 0, float(i))
    assert a.gauges["t"] == {"burn_rate": 0.0, "budget_remaining": 1.0}
    assert b.gauges["t"]["burn_rate"] == pytest.approx(5.0)
    assert b.gauges["t"]["budget_remaining"] == 0.0


def test_trace_spans_with_telemetry_off(telemetry_off):
    from horovod_tpu_torch.serving import tracing
    ctx = tracing.TraceContext(trace_id="f" * 32, span_id="e" * 16,
                               sampled=True)
    tracing.span(ctx, "admit", slot=1)
    assert tracing.spans(ctx.trace_id)[-1] == (
        "admit", ctx.trace_id, tracing.derive_span_id(ctx.trace_id, "admit"),
        ctx.span_id, {"slot": 1})


def test_plane_counters_and_wire_totals_with_telemetry_off(telemetry_off):
    from horovod_tpu_torch.ops import xla_collectives as XC
    before = eng_t.plane_counters()
    raw0, sent0 = XC.wire_totals("views")
    eng_t.record_request("views")
    eng_t.record_shed("r0", "views", "views-test")
    eng_t.set_queue_depth(7)
    XC.record_wire_bytes(400, 100, kind="views")
    after = eng_t.plane_counters()
    assert after["requests"]["views"] == \
        before["requests"].get("views", 0) + 1
    assert after["shed"]["views-test"] == \
        before["shed"].get("views-test", 0) + 1
    assert after["queue_depth"] == 7
    assert XC.wire_totals("views") == (raw0 + 400, sent0 + 100)
