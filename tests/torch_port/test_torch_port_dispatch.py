"""horovod_tpu_torch's schedule dispatch (``ops.dispatch``) against
horovod_tpu's: the bucket arithmetic, table construction, encoding,
shifts, the native form and the probe's plan (under a fake controller and
a counting timer) equal the reference's on the same inputs; the
bootstrap's branches (pins, degenerate and heterogeneous topologies) do
too.  On four gloo ranks in a 2 x 2 layout with the controller attached
(``_torch_port_pool.part_results``), ``init()`` probes and installs one
table on every rank, and ``choose_schedule`` reads it before the pins;
``plan_allreduce_step`` prices each leaf by its verdict."""

import numpy as np
import pytest

from horovod_tpu.core.config import Config as ConfigJax
from horovod_tpu.ops import dispatch as D_jax
from horovod_tpu.ops import xla_collectives as XC_jax

import _torch_port_pool as pool
from horovod_tpu_torch.core import config as _cfg
from horovod_tpu_torch.ops import dispatch as D
from horovod_tpu_torch.ops import quantization as Q
from horovod_tpu_torch.ops import xla_collectives as XC

WORLD = pool.WORLD
SIZES = [0, 1, 16 << 10, (16 << 10) + 1, 100 << 10, 1 << 20, 5 << 20,
         64 << 20, (64 << 20) + 1, 1 << 30]
MEASUREMENTS = [  # (kind, schedule, nbytes, seconds)
    ("allreduce", "flat", 64 << 10, 1.0), ("allreduce", "hier", 64 << 10, 2.0),
    ("allreduce", "flat", 1 << 20, 3.0), ("allreduce", "hier", 1 << 20, 2.0),
    ("allreduce", "flat", 8 << 20, 9.0), ("allreduce", "hier", 8 << 20, 4.0),
    ("allgather", "flat", 128 << 10, 2.0),
    ("allgather", "hier", 128 << 10, 1.0),
    ("allgather", "flat", 2 << 20, 5.0)]   # incomplete arm: ignored


@pytest.fixture(autouse=True)
def _clean_tables():
    D.reset()
    D_jax.reset()
    yield
    D.reset()
    D_jax.reset()


def test_buckets_equal_the_reference():
    assert D.PAYLOAD_BUCKET_BOUNDS == D_jax.PAYLOAD_BUCKET_BOUNDS
    assert D.BUCKET_LABELS == D_jax.BUCKET_LABELS
    assert D.PROBE_PAYLOADS == D_jax.PROBE_PAYLOADS
    assert D.KIND_CODES == D_jax.KIND_CODES
    assert [D.bucket_of(n) for n in SIZES] == \
        [D_jax.bucket_of(n) for n in SIZES]


@pytest.mark.parametrize("pins,fallback", [
    ({}, {}), ({"allreduce": True}, {}), ({"allgather": False}, {}),
    ({}, {"allgather": True}), ({"allreduce": False, "allgather": True},
                                {"allreduce": True})])
def test_build_table_equals_the_reference(pins, fallback):
    port = D.build_table([D.ProbeMeasurement(*m) for m in MEASUREMENTS],
                         pins=pins, fallback=fallback)
    ref = D_jax.build_table([D_jax.ProbeMeasurement(*m)
                             for m in MEASUREMENTS], pins=pins,
                            fallback=fallback)
    assert tuple(port) == tuple(ref)
    np.testing.assert_array_equal(port.encode(), ref.encode())
    assert D.DispatchTable.decode(port.encode()) == port
    for kind in D.KINDS:
        assert port.to_native(kind) == ref.to_native(kind)
        assert port.crossover_bytes(kind) == ref.crossover_bytes(kind)
        assert [port.choose(kind, n) for n in SIZES] == \
            [ref.choose(kind, n) for n in SIZES]
    for shift in (-2, -1, 0, 1, 3):
        shifts = {"allreduce": shift, "allgather": -shift}
        assert tuple(port.shifted(shifts)) == tuple(ref.shifted(shifts))


class _FakeController:
    """rank/size/barrier/allgather/broadcast/set_schedule_table, recording
    the tables installed and the probe's ops."""

    def __init__(self, rank=0, size=4, local_sizes=None):
        self._rank, self._size = rank, size
        self._local_sizes = local_sizes
        self.table_calls, self.ops = [], []

    def rank(self):
        return self._rank

    def size(self):
        return self._size

    def barrier(self):
        pass

    def allgather(self, arr, name=None):
        if self._local_sizes is not None:
            return np.asarray(self._local_sizes, dtype=np.int32)
        return np.tile(np.asarray(arr), self._size)

    def broadcast(self, arr, root_rank=0, name=None):
        return arr

    def set_schedule_table(self, kind, bounds, choices):
        self.table_calls.append((kind, tuple(bounds), tuple(choices)))


def _probe(module, rank, seed):
    ctl = _FakeController(rank=rank)
    t = [0.0]

    def timer():
        t[0] += 0.001 * (1 + len(ctl.ops) % 3)
        return t[0]

    def run(kind, arr, name):
        ctl.ops.append((kind, name, arr.size, float(np.sum(arr))))

    ms = module.run_probe(ctl, ("allreduce", "allgather"), seed=seed,
                          reps=2, runner=run, timer=timer)
    return [tuple(m) for m in ms], ctl.ops, ctl.table_calls


@pytest.mark.parametrize("rank,seed", [(0, 0), (0, 7), (2, 7)])
def test_probe_equals_the_reference(rank, seed):
    assert _probe(D, rank, seed) == _probe(D_jax, rank, seed)


@pytest.mark.parametrize("case", ["pinned", "degenerate", "heterogeneous",
                                  "world1", "probed"])
def test_bootstrap_equals_the_reference(case, monkeypatch):
    ref_cfg, cfg = ConfigJax(), _cfg.ControllerConfig()
    local, sizes, size = 2, None, 4
    if case == "pinned":
        for c in (ref_cfg, cfg):
            c.hierarchical_allreduce_pin = True
            c.hierarchical_allgather_pin = False
    elif case == "degenerate":
        local = 4
    elif case == "heterogeneous":
        sizes = [2, 2, 1, 1]
    elif case == "world1":
        size, local = 1, 1
    tables = []
    for module, c in ((D, cfg), (D_jax, ref_cfg)):
        ctl = _FakeController(size=size, local_sizes=sizes)
        if case == "probed":
            # The probe's timings: hierarchical wins below 1 MiB.
            monkeypatch.setattr(module, "run_probe", lambda *a, **k: [
                module.ProbeMeasurement(*m) for m in MEASUREMENTS])
        table = module.bootstrap(ctl, c, local_size=local)
        tables.append((tuple(table), ctl.table_calls,
                       module.active_table() is table))
    assert tables[0] == tables[1]


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "dispatch",
                             prepare=pool.write_ports(1))


def test_init_probes_one_table_on_every_rank(probed):
    for r in range(WORLD):
        assert probed[r]["table"] == probed[0]["table"]
        assert probed[r]["table"][2] == "probe"
        assert probed[r]["reduced"].tolist() == [6.0] * 3
        assert probed[r]["after_shutdown"] is None


def test_choose_schedule_reads_the_probed_table(probed):
    for r in range(WORLD):
        assert probed[r]["choose"] == probed[r]["table_choose"]


@pytest.mark.parametrize("pin", ["1", "0"])
def test_choose_schedule_table_before_pins(monkeypatch, pin):
    monkeypatch.setenv("HVD_TPU_HIERARCHICAL_ALLREDUCE", pin)
    pinned = "hier" if pin == "1" else "flat"
    assert XC.choose_schedule("allreduce", 1 << 20) == pinned
    table = D.build_table([D.ProbeMeasurement(*m) for m in MEASUREMENTS])
    D.set_active(table)
    for n in SIZES:
        assert XC.choose_schedule("allreduce", n) == \
            table.choose("allreduce", n)


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_allreduce_step_takes_the_tables_verdict(bits):
    sizes = [100, 5000, 70000, 3 << 20]
    table = D.build_table([D.ProbeMeasurement(*m) for m in MEASUREMENTS])
    D.set_active(table)
    D_jax.set_active(D_jax.DispatchTable(*table))
    port = XC.plan_allreduce_step(sizes, 2, 2, Q.QuantSpec(bits, 256))
    ref = XC_jax.plan_allreduce_step(sizes, 2, 2,
                                     XC_jax.QuantSpec(bits, 256))
    assert tuple(port) == tuple(ref)
    D.reset()
    flat = XC.plan_allreduce_step(sizes, 2, 2, Q.QuantSpec(bits, 256))
    assert flat != port
