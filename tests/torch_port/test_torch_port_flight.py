"""horovod_tpu_torch.debug's flight recorder against horovod_tpu.debug's:
the same seeded event sequence dumps the same object except for the
clocks, host and pid; the ring keeps the newest ``capacity`` events;
``dump`` writes the same file name; the item-9b entry points raise; the
clock offset aligns against a rendezvous server's clock.  And
the port's ``utils.logging`` / ``utils.profiler`` beside the
reference's."""

import importlib
import json
import logging
import os

import numpy as np
import pytest
import torch

from horovod_tpu.debug import flight as fl_j
from horovod_tpu_torch import debug as debug_t
from horovod_tpu_torch.debug import flight as fl_t
from horovod_tpu_torch.utils import logging as log_t
from horovod_tpu_torch.utils import profiler as prof_t

_CLOCK = ("t_mono", "t_wall")


def _record_sequence(rec, seed: int, n: int):
    rng = np.random.default_rng(seed)
    kinds = ["collective.enqueue", "collective.done", "data.wait",
             "checkpoint.save.begin", "serving.admit"]
    for i in range(n):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        if rng.random() < 0.3:
            rec.record(kind, None)
        else:
            rec.record(kind, f"name{i}", op="allreduce",
                       bytes=int(rng.integers(0, 1 << 20)),
                       dur_s=float(rng.random()))
    rec.set_identity(rank=3, world=8)
    rec.set_clock(0.25, rtt_s=0.01)
    rec.meta["k"] = {"slots": [1, 2]}


def _strip(obj):
    obj = dict(obj)
    for k in ("host", "pid"):
        obj.pop(k)
    obj["events"] = [{k: v for k, v in e.items() if k not in _CLOCK}
                     for e in obj["events"]]
    return obj


@pytest.mark.parametrize("capacity,n", [(4096, 50), (16, 50), (1, 3)])
def test_dump_obj_equal_but_clock_host_pid(capacity, n):
    rj = fl_j.FlightRecorder(capacity=capacity, enabled=True)
    rt = fl_t.FlightRecorder(capacity=capacity, enabled=True)
    _record_sequence(rj, 11, n)
    _record_sequence(rt, 11, n)
    oj, ot = rj.dump_obj(), rt.dump_obj()
    assert _strip(ot) == _strip(oj)
    assert len(rt) == min(capacity, n)
    assert [e["seq"] for e in ot["events"]][-1] == n - 1
    assert _strip(rt.dump_obj(last=2)) == _strip(rj.dump_obj(last=2))


def test_disabled_recorder_records_nothing():
    for mod in (fl_j, fl_t):
        rec = mod.FlightRecorder(enabled=False)
        rec.record("x", "y")
        assert len(rec) == 0


def test_capacity_and_disable_knobs(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLIGHT_CAPACITY", "7")
    monkeypatch.setenv("HVD_TPU_FLIGHT_DISABLE", "1")
    monkeypatch.setenv("HVD_TPU_FLIGHT_LAST_EVENTS", "0")
    rj, rt = fl_j.FlightRecorder(), fl_t.FlightRecorder()
    assert (rt.capacity, rt.enabled) == (rj.capacity, rj.enabled) == \
        (7, False)
    assert fl_t.last_events_limit() == fl_j.last_events_limit() == 1


def test_dump_writes_the_same_file(tmp_path, monkeypatch):
    paths = {}
    for name, mod in (("j", fl_j), ("t", fl_t)):
        d = tmp_path / name
        monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(d))
        rec = mod.FlightRecorder(capacity=8, enabled=True)
        _record_sequence(rec, 5, 12)
        paths[name] = rec.dump()
        with open(paths[name]) as f:
            paths[name + "obj"] = _strip(json.load(f))
    assert os.path.basename(paths["t"]) == os.path.basename(paths["j"]) \
        == "flight_rank3.json"
    assert paths["tobj"] == paths["jobj"]


def test_signal_handler_keeps_one_already_installed(tmp_path, monkeypatch):
    """The port's SIGUSR1 dump installs over the default action only: a
    handler the process already has (here the reference's) stays, and
    the signal still dumps the reference's ring."""
    import signal
    prev = signal.getsignal(signal.SIGUSR1)
    monkeypatch.setattr(fl_j, "_signal_installed", False)
    monkeypatch.setattr(fl_t, "_signal_installed", False)
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    try:
        assert fl_j.install_signal_handler()
        ref_handler = signal.getsignal(signal.SIGUSR1)
        assert fl_t.install_signal_handler() is False
        assert signal.getsignal(signal.SIGUSR1) is ref_handler
        fl_j.record("test.marker", "ref")
        os.kill(os.getpid(), signal.SIGUSR1)
        (path,) = tmp_path.glob("flight_rank*.json")
        assert any(e["kind"] == "test.marker"
                   for e in json.loads(path.read_text())["events"])
        path.unlink()
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
        assert fl_t.install_signal_handler() is True
        fl_t.record("test.marker", "port")
        os.kill(os.getpid(), signal.SIGUSR1)
        (path,) = tmp_path.glob("flight_rank*.json")
        assert ("test.marker", "port") in [
            (e["kind"], e["name"])
            for e in json.loads(path.read_text())["events"]]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_module_surface_and_item_9b_entry_points():
    assert set(debug_t.__all__) == set(
        importlib.import_module("horovod_tpu.debug").__all__)
    fl_t.snapshot()
    for fn, args in ((debug_t.serve, ()), (debug_t.serve_and_publish, ()),
                     (debug_t.start_stall_watchdog, (None,)),
                     (debug_t.last_regression_report, ()),
                     (debug_t.build_regression_report, (None,))):
        with pytest.raises(NotImplementedError, match="item 9b"):
            fn(*args)
    debug_t.stop_serving()
    debug_t.stop_stall_watchdog()
    # No rendezvous server answers: no estimate, as in the reference.
    assert debug_t.estimate_clock_offset("127.0.0.1:1", samples=1,
                                         timeout=0.2) is None
    assert debug_t.estimate_clock_offset(None) is None


@pytest.mark.parametrize("server", ["port", "reference"])
def test_clock_offset_against_a_skewed_rendezvous_server(server,
                                                         monkeypatch):
    """A rendezvous server whose clock runs 2.5 s ahead: the offset
    estimate is -2.5 s within loopback noise (the reference's golden),
    from either package's server, stored on the recorder."""
    import time
    from horovod_tpu.runner import rendezvous as rdv_j
    from horovod_tpu_torch.runner import rendezvous as rdv_t
    rdv = rdv_t if server == "port" else rdv_j
    skew = 2.5
    monkeypatch.setattr(rdv, "_now_wall", lambda: time.time() + skew)
    monkeypatch.setattr(fl_t, "_recorder", fl_t.FlightRecorder(enabled=True))
    srv = rdv.RendezvousServer(host="127.0.0.1", port=0)
    srv.start()
    try:
        est = debug_t.estimate_clock_offset(f"127.0.0.1:{srv.port}",
                                            samples=4)
        assert abs(est["offset_s"] + skew) < 0.25, est
        assert est["rtt_s"] < 1.0 and est["method"] == "rendezvous"
        assert fl_t.recorder().clock == est
    finally:
        srv.stop()


def test_logging_levels_and_rank_prefix(monkeypatch, capsys):
    # A fresh logger: its handler binds the stream capsys captures.
    named = logging.getLogger("horovod_tpu_torch")
    saved = (list(named.handlers), named.level)
    named.handlers.clear()
    monkeypatch.setattr(log_t, "_logger", None)
    monkeypatch.setenv("HVD_TPU_LOG_LEVEL", "debug")
    monkeypatch.setenv("HVD_TPU_LOG_HIDE_TIME", "1")
    logger = log_t.get_logger()
    try:
        assert logger.level == logging.DEBUG
        log_t.debug("hello %d", 5)
        log_t.trace("not shown")
        err = capsys.readouterr().err
        assert "[DEBUG] [-]: hello 5" in err and "not shown" not in err
    finally:
        named.handlers[:] = saved[0]
        named.setLevel(saved[1])
        monkeypatch.setattr(log_t, "_logger", None)


def test_profiler_ranges_and_data_wait(tmp_path):
    prof_t.reset_data_wait_stats()
    with prof_t.data_wait() as span:
        pass
    with prof_t.data_wait():
        pass
    stats = prof_t.data_wait_stats()
    assert stats["count"] == 2 and span.seconds >= 0.0
    assert stats["mean_s"] == pytest.approx(stats["total_s"] / 2)
    with pytest.raises(KeyError):       # the block's exception passes
        with prof_t.op_range("hvd.allreduce.x", 8):
            raise KeyError("boom")
    prof_t.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already"):
        prof_t.start_trace(str(tmp_path))
    with prof_t.op_range("hvd.allreduce.grad", 1024):
        torch.ones(4).sum()
    path = prof_t.stop_trace()
    assert prof_t.stop_trace() is None
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "hvd.allreduce.grad#bytes=1024" in names


def test_trace_ranges_switch_off(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_DISABLE_NVTX_RANGES", "1")
    with prof_t.trace(str(tmp_path)):
        with prof_t.op_range("hvd.allgather.off"):
            torch.ones(2).sum()
    (path,) = list(tmp_path.iterdir())
    assert "hvd.allgather.off" not in path.read_text()
