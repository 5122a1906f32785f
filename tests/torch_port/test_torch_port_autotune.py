"""horovod_tpu_torch's autotuner (``autotune.py``) and the native
controller's tuner hooks against horovod_tpu's.

The tuner is numpy on the host in both packages, so the same seed and the
same score stream must give the same thing bit for bit: the GP's fit and
prediction, expected improvement, the Bayesian optimizer's proposals, and
``ParameterManager``'s applied configs, journal, CSV log and freeze point
in each of its modes (toggles free or pinned, dispatch shifts, the
compression and overlap dims, the attribution-guided plan, warm-up).  The
score a window earns is a function of the config applied — the same
"workload" for both — or, through ``record_bytes``, bytes over a scripted
clock.

The controller's hooks: the tuner is built on rank 0 only, gated per
dimension as the reference gates it; the dispatch probe runs paused; a
proposal reaches the runtime (SetParams, SetTunedToggles, the shifted
dispatch tables, the wire format, the overlap session); a window closes
with one wait on the device plane; and ``hvdrun-torch -np 2 --autotune``
tunes a live gloo job to its ``final`` line."""

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import horovod_tpu.autotune as ref_at
import horovod_tpu_torch.autotune as at
from horovod_tpu_torch.native import controller as C

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# GP, EI, the optimizer
# ---------------------------------------------------------------------------

def _points(seed, n, d=3):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d), rng.randn(n) * 5.0 + 10.0


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_gp_fit_predict_bit_equal(seed):
    x, y = _points(seed, 9)
    xs = np.random.RandomState(seed + 100).rand(32, 3)
    got, ref = at.GaussianProcess(0.3, 0.8), ref_at.GaussianProcess(0.3, 0.8)
    # Before any fit: the prior.
    for a, b in zip(got.predict(xs), ref.predict(xs)):
        assert np.array_equal(a, b)
    got.fit(x, y)
    ref.fit(x, y)
    for a, b in zip(got.predict(xs), ref.predict(xs)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("xi", [0.0, 0.01, 0.5])
def test_expected_improvement_bit_equal(xi):
    rng = np.random.RandomState(3)
    mu, sigma = rng.randn(64), rng.rand(64) + 0.05
    assert np.array_equal(at.expected_improvement(mu, sigma, 0.2, xi),
                          ref_at.expected_improvement(mu, sigma, 0.2, xi))


@pytest.mark.parametrize("focus", [None, (1,), (0, 2)])
def test_bayesian_optimizer_suggest_bit_equal(focus):
    bounds = [(20.0, 28.0), (0.5, 25.0), (0.0, 1.0)]
    got = at.BayesianOptimizer(bounds, seed=5, pinned={2: 1.0})
    ref = ref_at.BayesianOptimizer(bounds, seed=5, pinned={2: 1.0})
    for i in range(8):
        a, b = got.suggest(focus=focus), ref.suggest(focus=focus)
        assert np.array_equal(a, b), i
        score = float(-(a[0] - 24.0) ** 2 - 0.1 * a[1])
        got.observe(a, score)
        ref.observe(b, score)
    for a, b in zip(got.best(), ref.best()):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# ParameterManager under a scripted score stream
# ---------------------------------------------------------------------------

def _score(cfg):
    """A deterministic "workload": throughput of one applied config."""
    fusion, cycle, h_ar, h_ag, cache, comp, ov = cfg
    s = 1e9 / (1.0 + abs(math.log2(fusion) - 24.5)) - 1e7 * cycle
    s += 3e7 * (int(h_ar) == 0) + 1e7 * int(h_ag) + 2e7 * bool(cache)
    s += {"none": 0.0, "bf16": 4e7, "int8": 2e7}.get(comp, 0.0)
    return s + 1e-3 * ov


def _drive(mod, tmp, tag, windows=30, **kw):
    applied = []
    log = os.path.join(str(tmp), f"{tag}.csv")
    kw.setdefault("attribution_source", lambda: None)
    pm = mod.ParameterManager(lambda *a: applied.append(a), log_file=log,
                              **kw)
    frozen_at = None
    for i in range(windows):
        if pm.frozen:
            frozen_at = i if frozen_at is None else frozen_at
            break
        pm._observe(_score(pm.current))
    with open(log) as f:
        lines = f.read()
    return {"applied": applied, "journal": pm.journal(), "log": lines,
            "frozen": pm.frozen, "frozen_at": frozen_at,
            "status": pm.loop_status(), "dims": pm.gp_dims()}


COMM = {"comm_exposed": 0.6, "input": 0.05, "checkpoint": 0.0, "host": 0.1,
        "compute": 0.25}

MODES = {
    "toggles_free": dict(max_samples=9, warmup_samples=1,
                         tune_toggles=True),
    "toggles_pinned": dict(max_samples=6, warmup_samples=0,
                           tune_toggles=(False, False, True),
                           initial_toggles=(True, False, True)),
    "all_pinned": dict(max_samples=5, warmup_samples=2, tune_toggles=False),
    "dispatch_shifts": dict(max_samples=10, warmup_samples=1,
                            dispatch_shifts=True,
                            initial_toggles=(0, 1, True)),
    "compression_overlap": dict(max_samples=12, warmup_samples=1,
                                tune_toggles=(False, False, False),
                                tune_compression=True, tune_overlap=True,
                                initial_overlap=8 << 20),
    "overlap_sizes_only": dict(max_samples=6, tune_overlap=True,
                               initial_overlap=2 << 20,
                               overlap_choices=(2 << 20, 8 << 20, 32 << 20)),
    "pinned_offgrid": dict(max_samples=4, initial_compression="int4",
                           tune_compression=True, initial_overlap=12345,
                           tune_overlap=True),
    "attribution_comm": dict(max_samples=10, warmup_samples=0,
                             tune_compression=True, tune_overlap=True,
                             attribution_source=lambda: dict(COMM)),
    "seeded": dict(max_samples=7, seed=11, gp_noise=0.3),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_parameter_manager_bit_equal(mode, tmp_path):
    got = _drive(at, tmp_path, "port", **MODES[mode])
    ref = _drive(ref_at, tmp_path, "ref", **MODES[mode])
    assert got["applied"] == ref["applied"]
    assert got["journal"] == ref["journal"]
    assert got["log"] == ref["log"] and got["log"]
    assert (got["frozen"], got["frozen_at"]) == \
        (ref["frozen"], ref["frozen_at"])
    assert got["frozen"]
    assert got["status"] == ref["status"] and got["dims"] == ref["dims"]
    tags = [ln.split(",")[0] for ln in got["log"].splitlines()]
    assert tags[-1] == "final" and tags.count("final") == 1


def test_log_lines_have_the_reference_columns(tmp_path):
    got = _drive(at, tmp_path, "port", **MODES["attribution_comm"])
    lines = [ln.split(",") for ln in got["log"].splitlines()]
    assert all(len(ln) == 10 for ln in lines), lines
    assert all("comm_exposed=0.600" in ln[9] for ln in lines)
    assert got["journal"][0]["attr"]["comm_exposed"] == 0.6


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.125
        return self.t


@pytest.mark.parametrize("steps_per_sample", [0, 3])
def test_record_bytes_windows_bit_equal(steps_per_sample, monkeypatch):
    """Windows closed by ``record_bytes`` (timed, or step-counted) over the
    same clock and bytes: the same scores, proposals and freeze."""
    out = {}
    for name, mod in (("port", at), ("ref", ref_at)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        applied = []
        pm = mod.ParameterManager(
            lambda *a: applied.append(a), max_samples=5, warmup_samples=1,
            window_seconds=0.5, steps_per_sample=steps_per_sample,
            attribution_source=lambda: None)
        for i in range(200):
            if pm.frozen:
                break
            pm.record_bytes(1000 * (i % 7) + 3)
        out[name] = (applied, pm.journal(), pm.frozen)
    assert out["port"] == out["ref"] and out["port"][2]


def test_window_sync_runs_once_a_closed_window(monkeypatch):
    """The port's one hook: ``window_sync`` runs as a window closes, before
    its clock is read (so the wait counts in the window), and never on a
    report that does not close one."""
    clock = _Clock()
    monkeypatch.setattr(at, "time", clock)
    calls = []

    def sync():
        calls.append(clock.t)
        clock.t += 5.0     # the device work the window waits for

    pm = at.ParameterManager(lambda *a: None, max_samples=50,
                             warmup_samples=0, steps_per_sample=4,
                             attribution_source=lambda: None,
                             window_sync=sync)
    for _ in range(12):
        pm.record_bytes(100)
    assert len(calls) == 3
    scores = [e["score"] for e in pm.journal()]
    # Each window: 4 reports of 100 bytes over its clock, the 5 s wait in.
    assert all(s < 400 / 5.0 for s in scores), scores


# ---------------------------------------------------------------------------
# The closed loop: retune, rollback, confirm, notify_drift
# ---------------------------------------------------------------------------

def _frozen_pair(**kw):
    pms = []
    for mod in (at, ref_at):
        applied = []
        pm = mod.ParameterManager(lambda *a, out=applied: out.append(a),
                                  max_samples=4, warmup_samples=0,
                                  attribution_source=lambda: None, **kw)
        while not pm.frozen:
            pm._observe(_score(pm.current))
        pms.append((pm, applied))
    return pms


@pytest.mark.parametrize("case", ["rollback", "accept", "confirm"])
def test_retune_episode_bit_equal(case, monkeypatch):
    monkeypatch.setenv("HVD_TPU_AUTOTUNE_ROLLBACK_PCT", "5")
    pairs = _frozen_pair()
    outcomes = []
    for pm, applied in pairs:
        base = pm.loop_status()["frozen_score"]
        assert pm.request_retune(windows=3, focus_component="comm_exposed")
        assert not pm.request_retune()        # already in an episode
        i = 0
        while not pm.frozen:
            if case == "rollback":
                s = base * 0.5                # nothing recovers
            elif case == "accept":
                s = base * (0.9 + 0.2 * i)    # a later candidate wins
            else:
                s = base * (1.0 if i == 0 else 0.97)   # incumbent best
            pm._observe(s)
            i += 1
        outcomes.append((applied, pm.journal(), pm.loop_status()))
    assert outcomes[0] == outcomes[1]
    want = {"rollback": "rolled_back", "accept": "accepted",
            "confirm": "confirmed"}[case]
    assert outcomes[0][2]["last_outcome"]["outcome"] == want
    assert outcomes[0][2]["rollbacks"] == (case == "rollback")


class _Event:
    def __init__(self, component):
        self.component = component


@pytest.mark.parametrize("case", [
    ("comm_exposed", None, True, None),
    ("input", {"suspect": {"subsystem": "data"}}, True, None),
    ("input", {"suspect": {"subsystem": "autotune"}}, True, None),
    ("comm_exposed", None, False, None),
    ("comm_exposed", None, True, "0")])
def test_notify_drift_gating_bit_equal(case, monkeypatch):
    component, report, frozen, knob = case
    if knob is not None:
        monkeypatch.setenv("HVD_TPU_AUTOTUNE_RETUNE", knob)
    got = []
    for mod in (at, ref_at):
        pm = mod.ParameterManager(lambda *a: None, max_samples=2,
                                  warmup_samples=0,
                                  attribution_source=lambda: None)
        if frozen:
            while not pm.frozen:
                pm._observe(_score(pm.current))
        mod.set_active_manager(pm)
        try:
            started = mod.notify_drift(_Event(component), report)
            got.append((started, pm.loop_status()))
        finally:
            mod.set_active_manager(None)
        assert mod.notify_drift(_Event(component), report) is False
    assert got[0] == got[1]
    assert got[0][0] == (frozen and knob is None and (
        component == "comm_exposed"
        or (report or {}).get("suspect", {}).get("subsystem") == "autotune"))


# ---------------------------------------------------------------------------
# The controller's hooks
# ---------------------------------------------------------------------------

class _Lib:
    """The runtime's tuner entry points, recorded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, a))


def _bare(rank=0, local_size=1):
    ctl = C.NativeController.__new__(C.NativeController)
    ctl._lib = _Lib()
    ctl._dispatch_table = None
    ctl._local_size = local_size
    ctl._last_done = None
    ctl.rank = lambda: rank
    return ctl


def _cfg(**kw):
    from horovod_tpu_torch.core import config
    return config.ControllerConfig(autotune=True, **kw)


@pytest.fixture
def clean_loop():
    yield
    at.set_active_manager(None)


@pytest.mark.parametrize("case", [
    # (rank, size, local, cfg kwargs, env) -> expected gates
    (1, 2, 1, {}, {}, None),
    (0, 1, 1, {}, {}, ((False, False, True), True, False, None)),
    (0, 4, 2, {}, {}, ((True, True, True), True, False,
                       (2 << 20, 8 << 20, 32 << 20))),
    (0, 2, 1, {"cache_capacity": 0}, {"HVD_TPU_COMPRESSION": "none"},
     ((False, False, False), False, False, (2 << 20, 8 << 20, 32 << 20))),
    (0, 1, 1, {"overlap": True}, {"HVD_TPU_EAGER_DEVICE_PLANE": "0"},
     ((False, False, True), False, True, None)),
    (0, 1, 1, {"overlap": True}, {"HVD_TPU_OVERLAP_BUCKET_BYTES": "4096"},
     ((False, False, True), True, False, None)),
])
def test_tuner_built_on_rank0_with_reference_gating(case, monkeypatch,
                                                    clean_loop):
    rank, size, local, kw, env, want = case
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ctl = _bare(rank, local)
    ctl._build_tuner(_cfg(**kw), rank, size, local)
    if want is None:
        assert ctl._autotune is None and at.active_manager() is None
        return
    k = ctl._autotune_kwargs
    assert (k["tune_toggles"], k["tune_compression"], k["tune_overlap"],
            k["overlap_choices"]) == want
    assert at.active_manager() is ctl._autotune
    # The proposal reached the runtime at construction.
    names = [n for n, _ in ctl._lib.calls]
    assert names[:3] == ["hvd_native_set_params",
                         "hvd_native_set_tuned_toggles",
                         "hvd_native_set_wire_compression"]


def test_apply_tuned_reaches_runtime_and_overlap_session():
    from horovod_tpu_torch.ops import compression, overlap
    ctl = _bare()
    try:
        ctl._apply_tuned(1 << 22, 3.5, True, False, True, "int8", 2 << 20)
        assert ctl._lib.calls == [
            ("hvd_native_set_params", (1 << 22, 3.5)),
            ("hvd_native_set_tuned_toggles", (1, 0, 1)),
            ("hvd_native_set_wire_compression",
             (compression.WIRE_CODES["int8"],))]
        assert overlap.session_bucket_bytes() == 2 << 20
    finally:
        overlap.set_session_bucket_bytes(None)


def test_adopt_dispatch_table_rebuilds_in_shift_mode(clean_loop, monkeypatch):
    from horovod_tpu_torch.ops import dispatch
    ctl = _bare(local_size=2)
    ctl._build_tuner(_cfg(), 0, 4, 2)
    first = ctl._autotune
    table = dispatch.constant_table({k: False for k in dispatch.KINDS},
                                    source="probe")
    try:
        ctl.adopt_dispatch_table(table)
        pm = ctl._autotune
        assert pm is not first and at.active_manager() is pm
        assert pm.gp_dims()[2] == "hier_allreduce:shift3"
        assert pm.current[2:4] == (0, 0)
        # Shift mode applies shifted tables and the cache bit, not the
        # whole-range toggles.
        names = [n for n, _ in ctl._lib.calls]
        assert "hvd_native_set_schedule_table" in names
        assert "hvd_native_set_cache_enabled" in names
        # A tuner that scored a window keeps its state.
        pm._samples = 1
        ctl.adopt_dispatch_table(table)
        assert ctl._autotune is pm
    finally:
        dispatch.reset()


def test_dispatch_probe_runs_with_the_tuner_paused(monkeypatch):
    from horovod_tpu_torch.ops import dispatch
    seen = []

    class Ctl:
        _autotune_pause = False
        autotune_paused = C.NativeController.autotune_paused

        def size(self):
            return 4

        def rank(self):
            return 0

        def allgather(self, arr, name=None):
            return np.asarray([2, 2, 2, 2], dtype=np.int32)

        def broadcast(self, arr, root_rank=0, name=None):
            return arr

        def set_schedule_table(self, *a):
            pass

    ctl = Ctl()

    def probe(controller, kinds, **kw):
        seen.append(controller._autotune_pause)
        return {}

    monkeypatch.setattr(dispatch, "run_probe", probe)
    monkeypatch.setattr(dispatch, "build_table", lambda ms, pins: (
        dispatch.constant_table({k: False for k in dispatch.KINDS},
                                source="probe")))
    try:
        dispatch.bootstrap(ctl, _cfg(), local_size=2)
    finally:
        dispatch.reset()
    assert seen == [True] and ctl._autotune_pause is False


def test_window_closes_on_the_last_done_event(clean_loop):
    """``_window_sync`` waits once a window, on the executor's latest
    completion event; a paused tick closes nothing."""
    ctl = _bare()
    waited = []

    class Done:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            waited.append(self.i)

    ctl._build_tuner(_cfg(autotune_steps_per_sample=2,
                          autotune_warmup_samples=0), 0, 1, 1)
    ctl._lib.hvd_native_counters = lambda b, s: None
    ctl._autotune_pause = False
    for i in range(4):
        ctl.note_done(Done(i))
        ctl._autotune_tick()
    assert waited == [1, 3]
    assert len(ctl._autotune.journal()) == 2
    with ctl.autotune_paused():
        for _ in range(2):
            ctl._autotune_tick()
    assert waited == [1, 3] and len(ctl._autotune.journal()) == 2


def test_world1_controller_tunes_live_ops(monkeypatch, tmp_path):
    """init(use_controller=True) with the tuner at world 1 on the CPU:
    negotiated allreduces feed it, proposals change mid-run, it freezes and
    writes its log; shutdown deregisters it."""
    import torch
    import _torch_port_pool as pool
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    log = str(tmp_path / "at.csv")
    for k, v in {"HVD_TPU_AUTOTUNE": "1", "HVD_TPU_AUTOTUNE_LOG": log,
                 "HVD_TPU_AUTOTUNE_WARMUP_SAMPLES": "1",
                 "HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE": "4",
                 "HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "5",
                 "HVD_TPU_CONTROLLER_ADDR":
                     f"127.0.0.1:{pool.free_ports(1)[0]}"}.items():
        monkeypatch.setenv(k, v)
    hvd.init(device="cpu", use_controller=True)
    try:
        pm = global_state.controller._autotune
        seen = set()
        for i in range(60):
            hvd.allreduce(torch.ones(1024), name=f"t.{i % 2}")
            seen.add(pm.current)
            if pm.frozen:
                break
        assert pm.frozen and len(seen) >= 2
    finally:
        hvd.shutdown()
    assert at.active_manager() is None
    tags = [ln.split(",")[0] for ln in open(log).read().splitlines()]
    assert tags[0] == "warmup" and tags.count("sample") == 5
    assert tags[-1] == "final"


# ---------------------------------------------------------------------------
# hvdrun-torch -np 2 --autotune, live on gloo
# ---------------------------------------------------------------------------

AUTOTUNE_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state

    torch.set_num_threads(1)
    hvd.init()
    rank = hvd.rank()
    ctl = global_state.controller
    assert ctl is not None
    if rank == 0:
        assert ctl._autotune is not None, "--autotune did not engage"
    # 16 concurrent 1 MB tensors a step: the proposed thresholds (1 MB
    # to 256 MB) fuse them into visibly different responses.
    bufs = [torch.full((262144,), float(rank + 1)) for _ in range(16)]
    fused, params, frozen_at = set(), set(), None
    for it in range(40):
        hs = [hvd.allreduce_async(b, op=hvd.Sum, name=f"at.{{it % 2}}.{{j}}")
              for j, b in enumerate(bufs)]
        for h in hs:
            hvd.synchronize(h)
        fused.add(int(ctl.last_fused_names()))
        if rank == 0:
            params.add(ctl._autotune.current)
            if ctl._autotune.frozen and frozen_at is None:
                frozen_at = it
    with open({out!r} + f".{{rank}}", "w") as f:
        json.dump({{"fused_counts": sorted(fused),
                    "params_seen": len(params), "frozen_at": frozen_at}}, f)
    hvd.shutdown()
""")


@pytest.mark.timeout(60)
def test_hvdrun_np2_autotune_on_gloo(tmp_path):
    out = str(tmp_path / "result")
    log = str(tmp_path / "autotune.csv")
    script = tmp_path / "worker.py"
    script.write_text(AUTOTUNE_WORKER.format(repo=ROOT, out=out))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--worker-platform", "cpu", "--autotune",
         "--autotune-log-file", log, "--autotune-warmup-samples", "1",
         "--autotune-steps-per-sample", "16",
         # The bootstrap's six arms (base, each hierarchical toggle and
         # the cache flipped: two ranks a host; bf16, int8) hold the
         # numerics fixed; EI varies them after.
         "--autotune-bayes-opt-max-samples", "12", sys.executable,
         str(script)],
        cwd=ROOT, capture_output=True, text=True, timeout=55,
        env=dict(os.environ, HVD_TPU_SCHEDULE_PROBE="0"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    # SetParams fired mid-run with distinct proposals, and the tuner froze
    # before the end (how the fused responses vary with them is timing on
    # a CPU host: tools/multi_gpu_fleet.py --runs autotune holds it on
    # the cards).
    r0 = json.load(open(out + ".0"))
    assert r0["params_seen"] >= 2 and r0["frozen_at"] is not None, r0
    assert all(json.load(open(f"{out}.{r}"))["fused_counts"]
               for r in range(2))
    lines = [ln.split(",") for ln in open(log).read().splitlines()]
    tags = [ln[0] for ln in lines]
    assert tags.count("sample") >= 2 and tags[-1] == "final", tags
    assert tags.count("final") == 1
    assert len({(ln[1], ln[2]) for ln in lines}) >= 2, lines
