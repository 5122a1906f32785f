"""horovod_tpu_torch's native runtime and controller (``native/``) against
horovod_tpu's.

The C++ sources are the reference's, byte for byte, but for the lines
marked ``// port: response-cache hit counter`` (a counter of the tensors
a rank announced as a cache bit, and its C entry point).  The library
builds from them into ``_build/native`` and a failed build raises.

Four gloo ranks with the controller attached (started once per test
process by ``_torch_port_pool.part_results``, bodies in
``_torch_port_eager_workers``) run the host plane's collectives on
rank-seeded numpy inputs — allreduce Sum/Average/Min/Max/Product and on
int64, the ragged allgather, broadcast, alltoall with uneven splits,
reducescatter, Adasum and a bfloat16 sum (crossing as its 2-byte words) —
and four ranks of the reference's controller run the same calls: the
results are equal bit for bit.  The same ranks then show what the
reference's test_native_runtime.py, test_response_cache.py, test_stall.py
and test_timeline.py show: enqueue orders permuted by rank complete, a
name enqueued twice in flight raises ``DuplicateNameError``, the stall
inspector warns and names the missing rank, recovers when it arrives,
and errors an op nobody else submits after the shutdown window; shutdown
errors an op still pending; the timeline is a Chrome trace of the
negotiated names; a joined rank contributes zeros; and the response cache
hits at each capacity of test_response_cache.py."""

import json
import multiprocessing as mp
import os
import re
import shutil

import numpy as np
import pytest
import torch

import _torch_port_eager_workers as workers
import _torch_port_pool as pool
from horovod_tpu_torch.native import _build

# The module's two fixtures start four gloo ranks and four reference
# ranks (each importing JAX) inside the setup of the first test that uses
# them; under a loaded suite that has run past the default 180 s limit.
pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_SRC = os.path.join(ROOT, "horovod_tpu", "native", "src")
# The port's own lines, each marked: the response-cache hit counter, and
# the wake-up of waits on a failed elastic world (core/failure.py).
MARKS = ("// port: response-cache hit counter", "// port: elastic wake-up",
         "// port: failed-world reset",
         "// port: stall snapshot without iostreams")
WORLD = pool.WORLD


def _sources(path):
    return sorted(f for f in os.listdir(path) if f.endswith((".cc", ".h")))


@pytest.mark.parametrize("name", _sources(REF_SRC))
def test_source_is_the_reference_copy(name):
    with open(os.path.join(REF_SRC, name)) as f:
        ref = f.read()
    with open(os.path.join(_build.SRC, name)) as f:
        port = f.read()
    kept = "".join(line for line in port.splitlines(keepends=True)
                   if not any(m in line for m in MARKS))
    assert kept == ref


def test_sources_are_the_reference_files_and_a_makefile():
    assert _sources(_build.SRC) == _sources(REF_SRC)
    assert sorted(os.listdir(_build.SRC)) == sorted(
        _sources(REF_SRC) + ["Makefile"])


def test_library_builds_into_build_dir():
    path = _build.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "horovod_tpu_torch",
                                                 "_build", "native")
    assert re.fullmatch(r"libhvdtpu_core-[0-9a-f]{16}\.so",
                        os.path.basename(path))
    assert _build.build() == path       # current: not built again
    assert not [f for f in os.listdir(_build.SRC) if f.endswith(".o")]


def test_failed_build_raises(tmp_path, monkeypatch):
    """Sources g++ refuses: the build raises and leaves no library."""
    src = tmp_path / "src"
    shutil.copytree(_build.SRC, src)
    for name in os.listdir(src):
        if name.endswith(".cc"):
            (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(_build, "SRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(_build.BuildError, match="failed"):
        _build.build()
    assert not os.path.exists(_build.library_path())


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "native",
                             prepare=pool.write_ports(2))


@pytest.fixture(scope="module")
def reference_host(tmp_path_factory):
    """The reference's controller on four ranks (their own processes)
    running ``host_plane_ops``, on its runtime built once from a copy of
    its sources (``workers.reference_native_library``)."""
    out = str(tmp_path_factory.mktemp("ref_host"))
    library = workers.reference_native_library()
    port = pool.free_ports(1)[0]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.reference_host_rank,
                         args=(r, WORLD, port, out, library))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    return [dict(np.load(os.path.join(out, f"ref_host{r}.npz")))
            for r in range(WORLD)]


@pytest.mark.parametrize("op", workers.HOST_OPS)
def test_host_plane_equals_reference_controller(native, reference_host, op):
    for rank in range(WORLD):
        got = native[rank]["host"][op]
        ref = reference_host[rank]
        if op == "alltoall_splits":
            recv, splits = got
            assert torch.equal(recv, torch.from_numpy(ref[op]))
            assert splits.tolist() == ref[op + ".splits"].tolist()
            continue
        want = torch.from_numpy(ref[op])
        assert got.dtype == want.dtype and torch.equal(got, want), (rank, op)


def test_rank_permuted_enqueue_order_completes(native):
    orders = [native[r]["order"] for r in range(WORLD)]
    assert len({tuple(o) for o in orders}) == WORLD
    vals = native[0]["permuted_inputs"]
    for i in range(workers.N_PERMUTED):
        want = sum(vals[i] * (r + 1) for r in range(WORLD))
        for r in range(WORLD):
            got = native[r]["permuted"][i]
            assert torch.equal(got, native[0]["permuted"][i])
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("plane", ["device", "host"])
def test_duplicate_name_raises(native, plane):
    for r in range(WORLD):
        assert "already in flight" in native[r]["duplicate"][plane]


def test_stall_warning_names_the_late_rank_then_recovers(native):
    stalled = native[0]["stalled"]
    assert [(s["name"], s["missing"]) for s in stalled] == [("late", [1])]
    assert stalled[0]["age_s"] >= 1.0
    # The reference's snapshot fields (the port builds it without
    # iostreams): an allreduce (type 0) the other three submitted.
    assert sorted(stalled[0]) == ["age_s", "missing", "name", "submitted",
                                  "type"]
    assert (stalled[0]["type"], stalled[0]["submitted"]) == (0, [0, 2, 3])
    for r in range(WORLD):
        assert native[r]["late"].tolist() == [4.0] * 4
    with open(os.path.join(pool.part_dir("native"), "stderr0.txt")) as f:
        err = f.read()
    assert any("stall" in line and "late" in line and "[1]" in line
               for line in err.splitlines()), err


def test_stall_shutdown_window_errors_the_lone_op(native):
    msg = native[0]["never"]
    assert "stall" in msg.lower() and "[1,2,3]" in msg, msg
    assert "5s" in msg, msg


def test_shutdown_errors_an_op_still_pending(native):
    assert "shut down with pending" in native[0]["orphan"]


def test_timeline_is_a_chrome_trace_of_the_negotiated_names(native):
    for r in range(WORLD):
        with open(native[r]["timeline_path"]) as f:
            events = json.load(f)
        names = {e.get("name") for e in events}
        assert set(workers.TIMELINE_NAMES) <= names
        cats = {e.get("cat") for e in events}
        assert {"NEGOTIATE", "DEVICE_COLLECTIVE"} <= cats, cats
        assert {"B", "E"} <= {e["ph"] for e in events}


def test_join_with_a_zero_proxy_rank(native):
    for r in range(WORLD - 1):
        # Ranks 0-2 contribute 1, 2, 3; the joined rank 3 zeros.
        assert native[r]["join_device"].tolist() == [6.0] * 6
        assert native[r]["join_host"].tolist() == [1.5] * 6
    assert {native[r]["join_last"] for r in range(WORLD)} == {WORLD - 1}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return pool.part_results(
        tmp_path_factory, "cache",
        prepare=pool.write_ports(1 + len(workers.CACHE_CAPACITIES)))


# Cache hits a rank: every iteration after the first announces its 9 names
# (4 host, 4 device, the allgather) as bits at capacity 1024; at 2 the LRU
# cycle of 9 names evicts each before its turn; 0 is off.
HITS = {1024: 5 * 9, 2: 0, 0: 0}


@pytest.mark.parametrize("capacity", workers.CACHE_CAPACITIES)
def test_response_cache_hits(cache, capacity):
    for r in range(WORLD):
        res = cache[r][capacity]
        assert res["hits"] == HITS[capacity], (r, res["stats"])
        outs = iter(res["outs"])
        for it in range(6):
            want = sum(q + 1 + it for q in range(WORLD))
            for _ in range(4):
                assert next(outs).tolist() == [want] * 32
                assert next(outs).tolist() == [want] * 16
            g = next(outs)
            assert g.shape == (sum(q + 1 for q in range(WORLD)), 2)
        assert next(outs).tolist() == [WORLD] * 8


def test_controller_asked_for_without_an_address_raises(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native.controller import NativeError
    for knob in ("HVD_TPU_CONTROLLER_ADDR", "HOROVOD_CONTROLLER_ADDR"):
        monkeypatch.delenv(knob, raising=False)
    with pytest.raises(NativeError, match="CONTROLLER_ADDR"):
        hvd.init(device="cpu", use_controller=True)
    assert not hvd.is_initialized()
    assert not torch.distributed.is_initialized()


def test_controller_off_the_torch_world_raises(monkeypatch):
    """A controller whose rendezvous placed this process elsewhere than
    the torch world did is refused at init, and shut down."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import runtime

    class Elsewhere:
        shut = False

        def rank(self):
            return 1

        def size(self):
            return 2

        def shutdown(self):
            Elsewhere.shut = True

    monkeypatch.setattr(runtime, "attach", lambda **kw: Elsewhere())
    with pytest.raises(RuntimeError, match="rendezvous"):
        hvd.init(device="cpu", use_controller=True)
    assert Elsewhere.shut and not hvd.is_initialized()


def test_autotune_is_refused(monkeypatch):
    """The knob is no longer refused: init builds rank 0's tuner and
    registers it with the closed loop; shutdown deregisters it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.core.state import global_state
    monkeypatch.setenv("HVD_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR",
                       f"127.0.0.1:{pool.free_ports(1)[0]}")
    hvd.init(device="cpu", use_controller=True)
    try:
        pm = global_state.controller._autotune
        assert pm is not None and autotune.active_manager() is pm
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized() and autotune.active_manager() is None


def test_world_one_controller_on_the_cpu(monkeypatch, tmp_path):
    """init(use_controller=True) at world 1: every collective negotiated,
    the counters and the timeline, then a clean shutdown."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR",
                       f"127.0.0.1:{pool.free_ports(1)[0]}")
    hvd.init(device="cpu", use_controller=True)
    try:
        ctl = global_state.controller
        assert ctl.size() == 1 and global_state.controller_group is not None
        x = torch.arange(6.0)
        hvd.start_timeline(str(tmp_path / "t.json"))
        assert torch.equal(hvd.allreduce(x, name="a"), x)
        assert torch.equal(hvd.allreduce(x, name="a"), x)
        assert np.array_equal(hvd.allreduce(x.numpy(), name="h"), x.numpy())
        hvd.stop_timeline()
        assert ctl.cache_hits() == 1   # "a" the second time
        assert ctl.stats()["responses"] == 2
        with open(tmp_path / "t.json") as f:
            assert {"a", "h"} <= {e.get("name") for e in json.load(f)}
    finally:
        hvd.shutdown()
    assert global_state.controller is None
    assert not torch.distributed.is_initialized()
