"""horovod_tpu_torch's input pipeline (``data/``) against horovod_tpu's,
modelled on tests/test_data_pipeline.py.

* ``ShardedIndexSampler``'s index streams equal the reference's element
  for element: shuffle on and off, drop and pad, worlds 1, 3 and 4, two
  epochs, every rank.
* The sources gather what the reference's gather.
* Prefetch: close joins the producer, a producer exception re-raises in
  the consumer, a stall raises ``DataStallError``, the queue depth bounds
  the run-ahead, the state is the consumer's position.
* Resume: K batches at world 4, state saved, restored at world 4 and at
  world 2: the union of consumed indices is the epoch's, exactly; the
  state rides a ZeRO checkpoint's manifest, and the reference reads it.
* ``DataLoader(device="cpu")`` yields tensors equal to the reference
  loader's batches; without ``device`` it delivers to the card and
  raises where there is none; the knobs parse as the reference's do."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as ckpt_jax
from horovod_tpu import data as data_jax
from horovod_tpu.core.config import Config
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch.core import config as cfg
from horovod_tpu_torch.data import (
    ArraySource, DataLoader, DataStallError, FileListSource, MemmapSource,
    PrefetchIterator, ShardedIndexSampler)


def _live_producer_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("hvd-tpu-") and t.is_alive()]


# ---------------------------------------------------------------------------
# Sampler and sources against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("policy", ["drop", "pad"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sampler_streams_equal_reference(world, policy, shuffle):
    for n, batch in ((50, 4), (7, 3)):     # 7 < one global batch at 3, 4
        for rank in range(world):
            kw = dict(world_size=world, rank=rank, shuffle=shuffle, seed=9,
                      policy=policy)
            port = ShardedIndexSampler(n, batch, **kw)
            ref = data_jax.ShardedIndexSampler(n, batch, **kw)
            for _ in range(2):
                assert len(port) == len(ref)
                got, want = list(port), list(ref)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                assert port.state_dict() == ref.state_dict()
                port.advance_epoch()
                ref.advance_epoch()


def test_sources_gather_as_reference(tmp_path):
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.arange(20) % 3
    idx = np.asarray([5, 0, 19, 5])
    got = ArraySource(x, y).gather(idx)
    want = data_jax.ArraySource(x, y).gather(idx)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="leading dimension"):
        ArraySource(x, y[:3])
    path = str(tmp_path / "rows.bin")
    x.tofile(path)
    mm = MemmapSource(path, np.float32, (3,))
    assert len(mm) == 20
    np.testing.assert_array_equal(
        mm.gather(idx), data_jax.MemmapSource(path, np.float32,
                                              (3,)).gather(idx))
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], np.full((3,), i))
    np.testing.assert_array_equal(FileListSource(paths).gather(idx[:2] % 5),
                                  [[0, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(
        FileListSource(paths).gather(np.asarray([3, 1])),
        data_jax.FileListSource(paths).gather(np.asarray([3, 1])))


@pytest.mark.parametrize("prefetch", [True, False])
def test_cpu_loader_yields_the_reference_batches(prefetch):
    x = np.arange(40 * 5, dtype=np.int32).reshape(40, 5)
    port = DataLoader(x, 4, seed=2, world_size=3, rank=2, prefetch=prefetch,
                      device="cpu")
    ref = data_jax.DataLoader(x, 4, seed=2, world_size=3, rank=2,
                              prefetch=prefetch)
    for _ in range(2):   # two epochs
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), b)
    assert port.state_dict() == ref.state_dict()
    port.close()
    ref.close()
    assert not _live_producer_threads()


# ---------------------------------------------------------------------------
# Prefetch: hygiene and failure modes
# ---------------------------------------------------------------------------

class _SlowSource(ArraySource):
    def __init__(self, n, gather_s):
        super().__init__(np.arange(n))
        self._gather_s = gather_s

    def gather(self, indices):
        time.sleep(self._gather_s)
        return super().gather(indices)


def test_prefetch_close_joins_producer_thread():
    loader = DataLoader(_SlowSource(400, 0.01), 4, prefetch=True,
                        queue_depth=2, device="cpu")
    next(iter(loader))
    assert _live_producer_threads()
    loader.close()
    assert not _live_producer_threads()
    loader.close()                  # idempotent
    next(iter(loader))
    loader.close()
    assert not _live_producer_threads()


def test_prefetch_propagates_producer_exception():
    class _Boom(ArraySource):
        def gather(self, indices):
            if int(indices[0]) >= 8:
                raise RuntimeError("decode failed at sample 8")
            return super().gather(indices)

    loader = DataLoader(_Boom(np.arange(16)), 4, shuffle=False,
                        prefetch=True, device="cpu")
    it = iter(loader)
    next(it), next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    loader.close()
    assert not _live_producer_threads()


def test_prefetch_stall_timeout_raises_instead_of_hanging():
    def _wedged():
        yield np.zeros(2)
        time.sleep(1.2)   # a dead filesystem
        yield np.zeros(2)

    it = PrefetchIterator(_wedged(), depth=2, stall_warning_s=0.0,
                          stall_timeout_s=0.6)
    next(it)
    t0 = time.perf_counter()
    with pytest.raises(DataStallError):
        next(it)
    assert time.perf_counter() - t0 < 1.9   # raised, not waited out
    it.close()
    assert not _live_producer_threads()
    assert issubclass(DataStallError, hvd.HorovodTpuError)


def test_prefetch_depth_bounds_runahead_and_state_is_the_consumers():
    loader = DataLoader(_SlowSource(400, 0.0), 4, shuffle=False,
                        prefetch=True, queue_depth=3, device="cpu")
    assert loader.state_dict()["cursor"] == 0
    it = iter(loader)
    next(it), next(it)
    time.sleep(0.2)      # the producer free-runs against the bounded queue
    assert it.max_queued <= 3
    assert loader.sampler.cursor <= (2 + 3 + 2) * 4
    assert loader.sampler.cursor > 8          # it really ran ahead
    assert loader.state_dict()["cursor"] == 8  # exactly 2 consumed
    loader.close()     # rewinds to the consumer: nothing is skipped
    rest = [i for b in loader for i in b.tolist()]
    assert rest[0] == 8 and len(rest) == 400 - 8
    loader.close()


# ---------------------------------------------------------------------------
# Resume with no duplicated and no dropped samples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("restore_world", [4, 2])
def test_resume_no_dupes_no_drops(shuffle, restore_world):
    n, batch, k = 64, 2, 3
    src = ArraySource(np.arange(n))
    loaders = [DataLoader(src, batch, world_size=4, rank=r, shuffle=shuffle,
                          seed=3, prefetch=True, device="cpu")
               for r in range(4)]
    its = [iter(ld) for ld in loaders]
    consumed = [i for _ in range(k) for it in its
                for i in next(it).tolist()]
    state = loaders[0].state_dict()
    for ld in loaders:
        ld.close()
    # A relaunch with wrong knobs: the state fixes them.
    new = [DataLoader(src, batch, world_size=restore_world, rank=r,
                      shuffle=not shuffle, seed=999, prefetch=True,
                      device="cpu")
           for r in range(restore_world)]
    for ld in new:
        ld.load_state_dict(state)
        st = ld.state_dict()
        assert (st["cursor"], st["seed"], st["shuffle"]) == \
            (k * batch * 4, 3, shuffle)
    for ld in new:
        consumed += [i for b in ld for i in b.tolist()]
        ld.close()
    assert sorted(consumed) == list(range(n)), "duplicated or dropped"


def test_loader_state_rides_the_zero_manifest(tmp_path):
    """The loader's consumer position is stamped into the ZeRO step's
    manifest beside the shards; both packages read it back, and a loader
    restored from it resumes where the first stopped."""
    hvd.init(device="cpu")
    try:
        p = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 12))
        opt = hvd.ZeroShardedOptimizer([p], torch.optim.Adam)
        loader = DataLoader(ArraySource(np.arange(64)), 2, world_size=4,
                            rank=0, seed=5, prefetch=True)
        it = iter(loader)
        next(it), next(it)
        root = str(tmp_path / "opt")
        opt.state_dict(root, step=0, extra={
            ckpt.DATA_ITERS_KEY: {"train": loader.state_dict()}})
        following = next(it).tolist()
        loader.close()
        manifest = ckpt.read_manifest(root, 0)
        assert manifest.extra["data_iters"]["train"]["cursor"] == 16
        assert ckpt.restore_data_state(root) == \
            ckpt_jax.restore_data_state(root) == manifest.extra["data_iters"]
        assert not os.path.isdir(str(tmp_path / "data_iters"))
        again = DataLoader(ArraySource(np.arange(64)), 2, world_size=4,
                           rank=0, shuffle=False, prefetch=False)
        again.load_state_dict(opt.load_state_dict(root).extra[
            ckpt.DATA_ITERS_KEY]["train"])
        assert next(iter(again)).tolist() == following
        again.close()
    finally:
        hvd.shutdown()


def test_loader_topology_follows_the_runtime():
    """Without world_size the loader reads the runtime's rank and size
    (world 1 here), and refuses a rank without a world."""
    hvd.init(device="cpu")
    try:
        loader = DataLoader(ArraySource(np.arange(8)), 2, prefetch=False)
        assert (loader.sampler.world_size, loader.sampler.rank) == (1, 0)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="explicit world_size"):
        DataLoader(ArraySource(np.arange(8)), 2, rank=1, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        DataLoader(ArraySource(np.arange(32)), 8, world_size=4, rank=4,
                   device="cpu")
    with pytest.raises(ValueError, match="not both"):
        DataLoader(ArraySource(np.arange(8)), 2, device="cpu",
                   transfer=lambda b: b)


def test_data_knobs_parse_as_reference(monkeypatch):
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        for knob in ("DATA_PREFETCH", "DATA_QUEUE_DEPTH",
                     "DATA_STALL_TIMEOUT_SECONDS",
                     "STALL_CHECK_TIME_SECONDS"):
            monkeypatch.delenv(prefix + knob, raising=False)
    for env, want in (({}, (True, 2, 0.0, 60.0)),
                      ({"HVD_TPU_DATA_PREFETCH": "0",
                        "HVD_TPU_DATA_QUEUE_DEPTH": "7",
                        "HVD_TPU_DATA_STALL_TIMEOUT_SECONDS": "12.5",
                        "HOROVOD_STALL_CHECK_TIME_SECONDS": "30"},
                       (False, 7, 12.5, 30.0)),
                      ({"HVD_TPU_DATA_QUEUE_DEPTH": "0"},
                       (False, 1, 12.5, 30.0))):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ref = Config.from_env()
        got = (cfg.data_prefetch(), cfg.data_queue_depth(),
               cfg.data_stall_timeout_seconds(), cfg.stall_warning_seconds())
        assert got == want == (ref.data_prefetch, ref.data_queue_depth,
                               ref.data_stall_timeout_seconds,
                               ref.stall_warning_time_seconds)
    loader = DataLoader(ArraySource(np.arange(8)), 2, device="cpu")
    assert loader._prefetch is False and loader._depth == 1
    loader.close()


def test_loader_delivers_to_the_card_unless_asked(monkeypatch):
    """Without ``device`` the loader delivers to the runtime's card and
    raises where there is none; ``device="cpu"`` delivers CPU tensors and
    ``transfer=`` the caller's form (here the host numpy batches)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = ArraySource(np.arange(8, dtype=np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader(src, 2)
    for kw, kind in (({"device": "cpu"}, torch.Tensor),
                     ({"transfer": lambda b: b}, np.ndarray)):
        loader = DataLoader(src, 2, shuffle=False, prefetch=False, **kw)
        got = list(loader)
        assert all(isinstance(b, kind) for b in got)
        assert [int(i) for b in got for i in b] == list(range(8))
        loader.close()
    hvd.init(device="cpu")
    try:     # the runtime's device is the default's card
        loader = DataLoader(src, 2, prefetch=False)
        assert loader._feed.device == torch.device("cpu")
        loader.close()
    finally:
        hvd.shutdown()
