"""horovod_tpu_torch's wire fabric (``net/``) and the native ladder's
counters against horovod_tpu's.

* The seeded arithmetic, value for value: ``Policy.backoff_ms`` over
  seeds, names and attempts, ``Policy.from_env``, ``NetChaos.draw`` and
  the injection schedule a sequence of requests replays, and
  ``retry_call``'s sleeps, budget and deadline.
* Rung 1 under seeded chaos: ``http_get`` and ``request_bytes`` against a
  ``RendezvousServer`` survive ``CHAOS_NET_RESET_PCT`` and
  ``CHAOS_NET_TRUNCATE``, retrying exactly where the reference retries on
  the same schedule, counted in ``hvd_net_retries_total{plane="http"}``
  and ``net.retry`` flight events.  ``poll_kv`` waits for a publication
  and honours its deadline and accept filter.
* The native ladder: ``NativeController.net_counters()`` has the
  reference's keys; two ranks of the port's controller under
  ``HVD_TPU_CHAOS_NET_RESET_PCT`` keep the host plane bit-exact (no count
  of reconnects is asserted: that depends on timing), and their Adasum's
  scratch peak reads and resets.
  ``sync_native_metrics`` and ``status()`` give the reference's families,
  events and verdicts on the same counters."""

import multiprocessing as mp
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from horovod_tpu import net as net_jax
from horovod_tpu.core import state as state_jax
from horovod_tpu.debug import flight as flight_jax
from horovod_tpu.native.controller import NativeController as CtlJax
from horovod_tpu.runner import rendezvous as rdv_jax
from horovod_tpu_torch import net as net_t
from horovod_tpu_torch.core import state as state_t
from horovod_tpu_torch.debug import flight as flight_t
from horovod_tpu_torch.native import controller as ctl_t
from horovod_tpu_torch.runner import rendezvous as rdv_t

import _torch_port_pool as pool

# The packages export a function ``registry`` beside the module.
reg_t = sys.modules["horovod_tpu_torch.metrics.registry"]
reg_jax = sys.modules["horovod_tpu.metrics.registry"]

PACKAGES = {"port": (net_t, rdv_t, reg_t, flight_t),
            "ref": (net_jax, rdv_jax, reg_jax, flight_jax)}
CHAOS_KNOBS = ("SEED", "DROP_PCT", "RESET_PCT", "DELAY_MS", "TRUNCATE")


@pytest.fixture(autouse=True)
def _fresh_schedules(monkeypatch):
    for knob in CHAOS_KNOBS:
        monkeypatch.delenv(f"HVD_TPU_CHAOS_NET_{knob}", raising=False)
    for knob in ("NET_HTTP_RETRIES", "NET_HTTP_BACKOFF_MS",
                 "RENDEZVOUS_SECRET"):
        monkeypatch.delenv(f"HVD_TPU_{knob}", raising=False)
    for net, *_ in PACKAGES.values():
        net.reset_net_chaos()
    yield
    for net, *_ in PACKAGES.values():
        net.reset_net_chaos()


# ---------------------------------------------------------------------------
# The seeded arithmetic
# ---------------------------------------------------------------------------

def test_package_surface_equals_reference():
    assert net_t.__all__ == net_jax.__all__
    native_t = sys.modules["horovod_tpu_torch.net.native"]
    native_j = sys.modules["horovod_tpu.net.native"]
    assert native_t._FIELDS == native_j._FIELDS == CtlJax.NET_COUNTER_FIELDS
    assert native_t.RECENT_RECOVERY_MS == native_j.RECENT_RECOVERY_MS


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_backoff_equals_reference(seed):
    for base, cap in ((50.0, 2000.0), (1.0, 5.0), (250.0, 400.0)):
        a = net_t.Policy(base_ms=base, max_ms=cap, seed=seed)
        b = net_jax.Policy(base_ms=base, max_ms=cap, seed=seed)
        for name in ("", "kv.get.recovery", "recovery.replica"):
            for attempt in range(0, 9):
                assert a.backoff_ms(attempt, name) == \
                    b.backoff_ms(attempt, name)


def test_policy_from_env_equals_reference(monkeypatch):
    assert net_t.Policy.from_env() == net_t.Policy()
    for env in ({"HVD_TPU_NET_HTTP_RETRIES": "5",
                 "HVD_TPU_NET_HTTP_BACKOFF_MS": "7.5",
                 "HVD_TPU_CHAOS_NET_SEED": "11"},
                {"HOROVOD_NET_HTTP_RETRIES": "0",
                 "HVD_TPU_NET_HTTP_BACKOFF_MS": "x"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        a = net_t.Policy.from_env(deadline_s=3.0)
        b = net_jax.Policy.from_env(deadline_s=3.0)
        assert (a.attempts, a.base_ms, a.max_ms, a.deadline_s, a.seed) == \
            (b.attempts, b.base_ms, b.max_ms, b.deadline_s, b.seed)
        for k in env:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("env", [
    {},
    {"HVD_TPU_RECOVERY": "0", "HVD_TPU_RECOVERY_STRIDE": "2",
     "HVD_TPU_NET_HTTP_RETRIES": "5", "HVD_TPU_NET_HTTP_BACKOFF_MS": "7.5"},
    {"HOROVOD_RECOVERY": "yes", "HOROVOD_RECOVERY_STRIDE": "-3",
     "HVD_TPU_NET_HTTP_RETRIES": "0", "HVD_TPU_NET_HTTP_BACKOFF_MS": "x"},
])
def test_recovery_knobs_equal_reference(env, monkeypatch):
    from horovod_tpu.core import config as cfg_jax
    from horovod_tpu_torch.core import config as cfg_t
    for knob in ("RECOVERY", "RECOVERY_STRIDE"):
        for prefix in ("HVD_TPU_", "HOROVOD_"):
            monkeypatch.delenv(prefix + knob, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = cfg_jax.Config.from_env()
    assert (cfg_t.recovery(), cfg_t.recovery_stride(),
            cfg_t.net_http_retries(), cfg_t.net_http_backoff_ms()) == \
        (ref.recovery, ref.recovery_stride, ref.net_http_retries,
         ref.net_http_backoff_ms)
    for name in ("RECOVERY", "RECOVERY_STRIDE", "CHAOS_SEED",
                 "CHAOS_KILL_STEPS", "CHAOS_COMMIT_CRASH",
                 "CHAOS_SLOW_PEER_MS", "CHAOS_TORN_RANKS", "NET_RESILIENCE",
                 "NET_PROBE_MS", "NET_RECONNECT_S", "NET_OP_DEADLINE_S",
                 "NET_MAX_RENEG", "NET_RENEGOTIATE", "NET_HTTP_RETRIES",
                 "NET_HTTP_BACKOFF_MS", "CHAOS_NET_SEED", "CHAOS_NET_DROP_PCT",
                 "CHAOS_NET_RESET_PCT", "CHAOS_NET_DELAY_MS",
                 "CHAOS_NET_TRUNCATE", "CHAOS_NET_BLACKHOLE"):
        assert getattr(cfg_t, name) == getattr(cfg_jax, name) == name


def _replay(chaos, keys, n):
    """The outcome of ``n`` requests on each key: the injected fault's
    type or None, and whether the response was truncated."""
    out = []
    for i in range(n):
        for key in keys:
            try:
                chaos.before_request(key)
                fault = None
            except OSError as e:
                fault = type(e).__name__
            _, cut = chaos.mangle_response(key, b"x" * (i + 1))
            out.append((key, fault, cut))
    return out


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_net_chaos_schedule_equals_reference(seed):
    kw = dict(seed=seed, drop_pct=10.0, reset_pct=15.0, truncate_pct=20.0)
    a, b = net_t.NetChaos(**kw), net_jax.NetChaos(**kw)
    for i in range(50):
        assert a.draw(f"k{i}", i) == b.draw(f"k{i}", i)
    keys = ["kv.get.recovery", "recovery.put", "http"]
    got = _replay(a, keys, 40)
    assert got == _replay(b, keys, 40)
    faults = {f for _, f, _ in got}
    assert {"ChaosNetReset", "ChaosNetFault", None} <= faults
    assert any(cut for *_, cut in got)
    assert not net_t.NetChaos(seed=seed).enabled


def test_net_chaos_from_env_equals_reference(monkeypatch):
    for knob, v in zip(CHAOS_KNOBS, ("5", "1.5", "2", "0", "3")):
        monkeypatch.setenv(f"HVD_TPU_CHAOS_NET_{knob}", v)
    a, b = net_t.net_chaos(), net_jax.net_chaos()
    assert (a.seed, a.drop_pct, a.reset_pct, a.delay_ms, a.truncate_pct,
            a.enabled) == (b.seed, b.drop_pct, b.reset_pct, b.delay_ms,
                           b.truncate_pct, b.enabled) == \
        (5, 1.5, 2.0, 0.0, 3.0, True)
    assert net_t.net_chaos() is a
    net_t.reset_net_chaos()
    assert net_t.net_chaos() is not a


def _retry_count(reg):
    return reg.registry().counter(
        "hvd_net_retries_total", "Wire-fabric recovery attempts by plane",
        plane="http").value


def _ladder(pkg, failures, policy, exc=OSError, raise_on=()):
    """``retry_call`` on a function failing ``failures`` times: its
    result or exception, the sleeps, the retries counted and the
    ``net.retry`` events recorded."""
    net, _, reg, flight = PACKAGES[pkg]
    calls, sleeps = [], []
    before = _retry_count(reg)
    seq0 = max([e["seq"] for e in flight.snapshot()], default=-1)

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise exc(f"fault {len(calls)}")
        return "ok"

    try:
        out = net.retry_call(fn, policy=policy, name="drill",
                             raise_on=raise_on, sleep=sleeps.append)
    except OSError as e:
        out = repr(e)
    events = [(e["name"], e["attempt"], e["backoff_ms"])
              for e in flight.snapshot()
              if e["seq"] > seq0 and e["kind"] == "net.retry"]
    return out, sleeps, len(calls), _retry_count(reg) - before, events


@pytest.mark.parametrize("case", ["recovers", "exhausted", "deadline",
                                  "raise_on"])
def test_retry_call_equals_reference(case):
    failures, kw, exc, raise_on = {
        "recovers": (2, dict(attempts=3), OSError, ()),
        "exhausted": (9, dict(attempts=4), ConnectionResetError, ()),
        "deadline": (9, dict(attempts=9, base_ms=400.0, deadline_s=1.0),
                     OSError, ()),
        "raise_on": (9, dict(attempts=3), FileNotFoundError,
                     (FileNotFoundError,)),
    }[case]
    got = {pkg: _ladder(pkg, failures, PACKAGES[pkg][0].Policy(seed=4, **kw),
                        exc, raise_on) for pkg in PACKAGES}
    assert got["port"] == got["ref"]
    out, sleeps, calls, counted, events = got["port"]
    assert counted == len(sleeps) == len(events)
    if case == "recovers":
        assert out == "ok" and calls == 3 and counted == 2
    elif case == "raise_on":
        assert calls == 1 and counted == 0


# ---------------------------------------------------------------------------
# Rung 1 on the wire under seeded chaos
# ---------------------------------------------------------------------------

def _chaos_env(monkeypatch):
    monkeypatch.setenv("HVD_TPU_CHAOS_NET_SEED", "21")
    monkeypatch.setenv("HVD_TPU_CHAOS_NET_RESET_PCT", "25")
    monkeypatch.setenv("HVD_TPU_CHAOS_NET_TRUNCATE", "25")
    monkeypatch.setenv("HVD_TPU_NET_HTTP_RETRIES", "8")
    monkeypatch.setenv("HVD_TPU_NET_HTTP_BACKOFF_MS", "1")


def test_rung_one_survives_seeded_chaos(monkeypatch):
    """Thirty GETs through each package's client, on one schedule: every
    value arrives, and both retry the same number of times (> 0)."""
    _chaos_env(monkeypatch)
    server = rdv_t.RendezvousServer(host="127.0.0.1")
    server.start()
    addr = f"127.0.0.1:{server.port}"
    server.put("scope", "k", b"v" * 64)
    try:
        retries = {}
        for pkg, (net, rdv, reg, _) in PACKAGES.items():
            net.reset_net_chaos()
            before = _retry_count(reg)
            for _ in range(30):
                assert rdv.http_get(addr, "scope", "k") == b"v" * 64
            req = urllib.request.Request(f"http://{addr}/scope/k")
            for _ in range(10):
                assert net.request_bytes(req, name="drill") == b"v" * 64
            retries[pkg] = _retry_count(reg) - before
        assert retries["port"] == retries["ref"] > 0
        assert net_t.net_chaos().enabled
    finally:
        server.stop()


def test_rung_one_gives_up_within_its_budget(monkeypatch):
    """A dead address: ``http_get`` answers None after the policy's
    attempts, ``request_bytes`` raises the transport fault."""
    monkeypatch.setenv("HVD_TPU_NET_HTTP_BACKOFF_MS", "1")
    port = pool.free_ports(1)[0]
    addr = f"127.0.0.1:{port}"
    before = _retry_count(reg_t)
    assert rdv_t.http_get(addr, "scope", "k", timeout=0.5) is None
    assert _retry_count(reg_t) - before == 2
    req = urllib.request.Request(f"http://{addr}/scope/k")
    with pytest.raises(OSError, match="transport failure"):
        net_t.request_bytes(req, timeout=0.5,
                            policy=net_t.Policy(attempts=1))


def test_poll_kv_waits_filters_and_times_out():
    server = rdv_t.RendezvousServer(host="127.0.0.1", secret="s")
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        server.put("scope", "flag", b"not-yet")
        timer = threading.Timer(0.3, server.put, ("scope", "flag", b"ready"))
        timer.start()
        t0 = time.monotonic()
        got = net_t.poll_kv(addr, "scope", "flag", deadline_s=5.0,
                            interval_s=0.05, secret="s",
                            accept=lambda b: b if b == b"ready" else None)
        assert got == b"ready" and time.monotonic() - t0 >= 0.25
        timer.join()
        t0 = time.monotonic()
        with pytest.raises(net_t.DeadlineExceeded, match="scope/missing"):
            net_t.poll_kv(addr, "scope", "missing", deadline_s=0.4,
                          interval_s=0.05, secret="s")
        assert 0.35 <= time.monotonic() - t0 < 3.0
        with pytest.raises(PermissionError):
            net_t.poll_kv(addr, "scope", "flag", deadline_s=0.4,
                          secret="wrong")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The native ladder
# ---------------------------------------------------------------------------

class _FakeController:
    def __init__(self, counters):
        self.counters = counters

    def net_counters(self):
        return dict(self.counters)


def _native_view(pkg, monkeypatch, snapshots):
    """``sync_native_metrics`` over ``snapshots`` of the counters, then
    ``status()``: the deltas counted, the events recorded, the verdict."""
    net, _, reg, flight = PACKAGES[pkg]
    state = (state_t if pkg == "port" else state_jax).global_state
    fake = _FakeController(snapshots[0])
    monkeypatch.setattr(state, "controller", fake, raising=False)
    monkeypatch.setattr(reg, "_REGISTRY", reg.MetricsRegistry())
    net.reset_sync_state()
    seq0 = max([e["seq"] for e in flight.snapshot()], default=-1)
    for snap in snapshots:
        fake.counters = snap
        assert net.sync_native_metrics() == snap
    families = {f.name: sorted((k, c.value) for k, c in children)
                for f, children in reg.registry().collect()
                if f.name.startswith("hvd_net_")}
    events = [(e["kind"], {k: v for k, v in e.items()
                           if k not in ("seq", "t_mono", "t_wall")})
              for e in flight.snapshot() if e["seq"] > seq0]
    status = net.status()
    net.reset_sync_state()
    return families, events, status


@pytest.mark.parametrize("recovering", [0, 1])
def test_native_sync_and_status_equal_reference(monkeypatch, recovering):
    fields = CtlJax.NET_COUNTER_FIELDS
    zero = dict.fromkeys(fields, 0)
    snapshots = [dict(zero, last_recovery_age_ms=-1),
                 dict(zero, retries=3, resets_avoided=1, chaos_injected=2,
                      last_recovery_age_ms=40000),
                 dict(zero, retries=5, reconnects=2, renegotiations=1,
                      resets_avoided=2, chaos_injected=4,
                      recovering_now=recovering,
                      last_recovery_age_ms=40000)]
    got = {pkg: _native_view(pkg, monkeypatch, snapshots)
           for pkg in PACKAGES}
    assert got["port"][:2] == got["ref"][:2]
    for pkg in PACKAGES:
        assert got[pkg][2]["native"] == snapshots[-1]
    port, ref = got["port"][2], got["ref"][2]
    assert (port["retrying"], port["verdict"]) == \
        (ref["retrying"], ref["verdict"])
    assert port["verdict"] == ("retrying, deadline not yet reached"
                               if recovering else
                               "no recent wire recovery activity")
    kinds = [k for k, _ in got["port"][1]]
    assert kinds == ["net.recovery", "net.reconnect", "net.renegotiate",
                     "net.recovery"]


def test_status_without_a_controller_equals_reference(monkeypatch):
    for pkg in PACKAGES:
        state = (state_t if pkg == "port" else state_jax).global_state
        monkeypatch.setattr(state, "controller", None, raising=False)
    a, b = net_t.status(), net_jax.status()
    assert a["native"] is b["native"] is None
    assert (a["retrying"], a["verdict"]) == (b["retrying"], b["verdict"]) \
        == (False, "no recent wire recovery activity")


def _chaos_rank(rank, size, port, iters, out_q):
    """One rank of the port's controller, host plane only, under the
    seeded reset schedule of the environment."""
    os.environ.update({"HVD_TPU_CYCLE_TIME": "1",
                       "HVD_TPU_DISABLE_SHM": "1",
                       "HVD_TPU_NET_PROBE_MS": "300",
                       "HVD_TPU_CHAOS_NET_SEED": "13",
                       "HVD_TPU_CHAOS_NET_RESET_PCT": "2"})
    from horovod_tpu_torch.native.controller import NativeController
    ctl = NativeController(rank, size, f"127.0.0.1:{port}")
    try:
        exact = True
        for i in range(iters):
            x = np.arange(4096, dtype=np.float32) + rank * 100 + i
            want = sum(np.arange(4096, dtype=np.float32) + r * 100 + i
                       for r in range(size))
            exact &= np.array_equal(ctl.allreduce(x, op=1, name=f"ar.{i}"),
                                    want)
            g = ctl.allgather(np.full((2,), float(rank), np.float32),
                              name=f"ag.{i}")
            exact &= np.array_equal(
                g, np.repeat(np.arange(size, dtype=np.float32), 2))
        ctl.allreduce(np.arange(64, dtype=np.float32) + rank, op=2,
                      name="adasum")
        peak = ctl.adasum_scratch_peak()
        ctl.adasum_scratch_reset()
        out_q.put((rank, exact, ctl.net_counters(),
                   (peak, ctl.adasum_scratch_peak())))
    finally:
        ctl.shutdown()


@pytest.mark.timeout(120)
def test_native_counters_under_seeded_resets():
    port = pool.free_ports(1)[0]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_chaos_rank, args=(r, 2, port, 6, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(q.get(timeout=90) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for rank, exact, counters, (peak, after_reset) in got:
        assert exact, rank
        assert peak > 0 and after_reset == 0, (peak, after_reset)
        assert tuple(counters) == CtlJax.NET_COUNTER_FIELDS
        assert ctl_t.NativeController.NET_COUNTER_FIELDS == \
            CtlJax.NET_COUNTER_FIELDS
        assert all(isinstance(v, int) for v in counters.values())
        assert counters["chaos_injected"] >= 0
    assert all(p.exitcode == 0 for p in procs)
