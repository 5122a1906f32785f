"""``horovod_tpu_torch.spark.store`` against ``horovod_tpu.spark.store``.

The reference's store cases (tests/test_spark_estimators.py:30-290, 440)
run on both packages' stores, parametrized by package: the layout, the
DataFrame and checkpoint round trips, the fsspec ``memory://`` store and
its pickling, ``gs://`` selecting ``GCSStore`` (no bucket is reached),
the sharded reader's disjoint reads on an equal chunk schedule and its
strided fallback, the per-epoch seeded shuffle, the prefetch thread and
its degrade under a foreign arrow pool, and the chunked stream.  Beyond
them: the Parquet either store writes is read by the other with equal
arrays, and on the same files the two sharded readers yield the same
chunks, rank by rank and epoch by epoch, so a shuffle is identical
across ranks and packages."""

import pickle

import numpy as np
import pandas as pd
import pytest

import horovod_tpu.spark.store as ref_store
import horovod_tpu_torch.spark.store as port_store

PACKAGES = {"ref": ref_store, "port": port_store}


@pytest.fixture(params=sorted(PACKAGES))
def S(request):
    return PACKAGES[request.param]


def _regression_df(n=64, d=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = np.arange(1, d + 1, dtype=np.float32)
    return pd.DataFrame({"features": [row.tolist() for row in x],
                         "label": (x @ w).astype(np.float32)})


def _parts(path, rows, width=3):
    """One Parquet file a part, one row group each, labels numbering the
    rows across parts."""
    base = 0
    for i, n in enumerate(rows):
        pd.DataFrame({
            "features": [[float(base + j)] + [0.0] * (width - 1)
                         for j in range(n)],
            "label": [float(base + j) for j in range(n)],
        }).to_parquet(f"{path}/part-{i:05d}.parquet")
        base += n


def _labels(chunks):
    return np.concatenate([y.ravel() for _, y in chunks]) if chunks \
        else np.zeros(0, np.float32)


def test_store_create_and_layout(S, tmp_path):
    s = S.Store.create(str(tmp_path))
    assert isinstance(s, S.LocalStore)
    assert "intermediate_train_data" in s.get_train_data_path("abc")
    assert "runs" in s.get_checkpoint_path("r1")
    s.makedirs(s.get_train_data_path("abc"))
    assert s.exists(s.get_train_data_path("abc"))
    s.delete(s.get_train_data_path("abc"))
    assert not s.exists(s.get_train_data_path("abc"))


def test_layouts_equal_reference(tmp_path):
    for prefix in (str(tmp_path), "memory://bucket/p", "gs://b/jobs"):
        ref, port = ref_store.Store.create(prefix), \
            port_store.Store.create(prefix)
        assert type(ref).__name__ == type(port).__name__
        for fn in ("get_train_data_path", "get_val_data_path",
                   "get_checkpoint_path", "get_logs_path"):
            assert getattr(port, fn)("r7") == getattr(ref, fn)("r7")


def test_store_dataframe_roundtrip(S, tmp_path):
    store = S.Store.create(str(tmp_path))
    df = _regression_df(32)
    path = store.get_train_data_path("rt")
    assert store.write_dataframe(df, path) == 32
    back = store.read_dataframe(path)
    assert len(back) == 32
    np.testing.assert_allclose(back["label"].values, df["label"].values)


def test_store_checkpoint_roundtrip(S, tmp_path):
    store = S.Store.create(str(tmp_path))
    p = store.save_checkpoint("r9", b"\x01\x02payload")
    assert store.exists(p)
    assert store.load_checkpoint("r9") == b"\x01\x02payload"


def test_fsspec_store_memory_roundtrip(S, request):
    s = S.Store.create(f"memory://bucket-{request.node.callspec.id}/prefix")
    assert isinstance(s, S.FsspecStore)
    df = _regression_df(24)
    path = s.get_train_data_path("mem")
    assert s.write_dataframe(df, path) == 24
    back = s.read_dataframe(path)
    np.testing.assert_allclose(back["label"].values, df["label"].values)
    p = s.save_checkpoint("rr", b"ckpt-bytes")
    assert s.exists(p)
    assert s.load_checkpoint("rr") == b"ckpt-bytes"
    s.delete(path)
    assert not s.exists(path)
    # Stores travel to worker processes: they pickle (fs handle dropped).
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.load_checkpoint("rr") == b"ckpt-bytes"


def test_gcs_store_selected_by_prefix(S):
    s = S.Store.create("gs://some-bucket/jobs")
    assert isinstance(s, S.GCSStore)
    assert s.get_checkpoint_path("r1").startswith("gs://some-bucket/jobs")
    with pytest.raises(ValueError):
        S.GCSStore("/local/path")


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_parquet_crosses_packages(writer, reader, tmp_path):
    """A DataFrame one package's store writes, the other's reads: equal
    frames, equal arrays from the chunked feed and equal checkpoint
    bytes."""
    w = PACKAGES[writer].Store.create(str(tmp_path))
    r = PACKAGES[reader].Store.create(str(tmp_path))
    df = _regression_df(100, seed=3)
    path = w.get_train_data_path("x")
    assert w.write_dataframe(df, path) == 100
    back = r.read_dataframe(path)
    pd.testing.assert_frame_equal(back, df)
    want = PACKAGES[writer].dataframe_to_arrays(df, ["features"], ["label"])
    got = list(r.iter_array_batches(path, ["features"], ["label"],
                                    chunk_rows=32))
    np.testing.assert_array_equal(np.concatenate([x for x, _ in got]),
                                  want[0])
    np.testing.assert_array_equal(np.concatenate([y for _, y in got]),
                                  want[1])
    w.save_checkpoint("c", b"\x00state")
    assert r.load_checkpoint("c") == b"\x00state"


def test_sharded_reader_disjoint_reads_equal_schedule(S, tmp_path):
    s = S.Store.create(str(tmp_path))
    path = s.get_train_data_path("sh")
    s.makedirs(path)
    _parts(path, [40, 30, 20, 34])   # 4 parts x 1 row group, unequal
    got = {rank: list(s.iter_array_batches(path, ["features"], ["label"],
                                           chunk_rows=16, rank=rank,
                                           size=2))
           for rank in range(2)}
    # Identical chunk-size schedule on both ranks (lockstep collectives).
    assert [len(x) for x, _ in got[0]] == [len(x) for x, _ in got[1]]
    # Rank 0 read parts {0,2} (60 rows), rank 1 parts {1,3} (64): common
    # truncation = 60 rows each.
    lab0, lab1 = _labels(got[0]), _labels(got[1])
    assert len(lab0) == len(lab1) == 60
    assert not set(lab0.tolist()) & set(lab1.tolist())
    # Fewer row groups than ranks -> strided rows, still an equal
    # schedule and disjoint.
    got8 = [list(s.iter_array_batches(path, ["features"], ["label"],
                                      chunk_rows=8, rank=r, size=8))
            for r in range(8)]
    sched = [[len(x) for x, _ in c] for c in got8]
    assert all(sc == sched[0] for sc in sched)
    rows = np.concatenate([_labels(c) for c in got8])
    assert len(set(rows.tolist())) == len(rows)


def test_per_epoch_shuffle_order_differs_membership_same(S, tmp_path):
    s = S.Store.create(str(tmp_path))
    path = s.get_train_data_path("shuf")
    s.makedirs(path)
    _parts(path, [12] * 8)

    def labels_per_rank(epoch):
        return {rank: _labels(list(s.iter_array_batches(
            path, ["features"], ["label"], chunk_rows=12, rank=rank,
            size=2, epoch=epoch, shuffle_seed=7))) for rank in range(2)}

    ep0, ep1 = labels_per_rank(0), labels_per_rank(1)
    for ep in (ep0, ep1):
        assert not set(ep[0].tolist()) & set(ep[1].tolist())
        assert set(np.concatenate([ep[0], ep[1]]).tolist()) == \
            set(float(v) for v in range(96))
    order0 = np.concatenate([ep0[0], ep0[1]])
    order1 = np.concatenate([ep1[0], ep1[1]])
    assert not np.array_equal(order0, order1)
    assert set(order0.tolist()) == set(order1.tolist())
    again = labels_per_rank(1)
    for rank in range(2):
        np.testing.assert_array_equal(ep1[rank], again[rank])


@pytest.mark.parametrize("size,rows,chunk,seed", [
    (2, [40, 30, 20, 34], 16, None),
    (2, [12] * 8, 12, 7),
    (3, [25, 7, 33, 18, 9], 10, 11),
    (8, [40, 30, 20, 34], 8, None)])
def test_sharded_reader_equals_reference(size, rows, chunk, seed, tmp_path):
    """On the same files, every rank's chunks from the port's reader equal
    the reference's bit for bit over two epochs: the same units, the
    same permutation (identical on every rank: a pure function of seed
    and epoch), the same truncation."""
    path = str(tmp_path / "d")
    port_store.LocalStore(str(tmp_path)).makedirs(path)
    _parts(path, rows)
    ref, port = ref_store.LocalStore(str(tmp_path)), \
        port_store.LocalStore(str(tmp_path))
    for epoch in (0, 1):
        for rank in range(size):
            kw = dict(chunk_rows=chunk, rank=rank, size=size, epoch=epoch,
                      shuffle_seed=seed)
            want = list(ref.iter_array_batches(path, ["features"],
                                               ["label"], **kw))
            got = list(port.iter_array_batches(path, ["features"],
                                               ["label"], **kw))
            assert len(got) == len(want)
            for (gx, gy), (wx, wy) in zip(got, want):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gy, wy)


def test_prefetch_overlaps_reads_with_compute(S, tmp_path, monkeypatch):
    """With prefetch, the next chunk's store reads run on a background
    thread during the consumer's compute.  This process imported pandas
    (hence pyarrow's mimalloc pool) before the store could set the system
    pool, so the allocator guard would degrade prefetch: the test
    overrides it, as the reference's does."""
    import threading
    import time as _time

    monkeypatch.setattr(S, "_arrow_background_thread_safe", lambda: True)
    s = S.Store.create(str(tmp_path))
    path = s.get_train_data_path("pf")
    s.makedirs(path)
    for i in range(6):
        pd.DataFrame({
            "features": [[float(j), 0.0, 0.0] for j in range(64)],
            "label": [float(i * 64 + j) for j in range(64)],
        }).to_parquet(f"{path}/part-{i:05d}.parquet")
    opens = []
    orig_open = S.Store._open

    def traced_open(self, p, mode):
        opens.append((threading.current_thread().name, _time.monotonic()))
        return orig_open(self, p, mode)

    monkeypatch.setattr(S.Store, "_open", traced_open)
    seen, windows = 0, []
    for x, _y in s.iter_array_batches(path, ["features"], ["label"],
                                      chunk_rows=64, prefetch=2, rank=0,
                                      size=1, shuffle_seed=3):
        t0 = _time.monotonic()
        _time.sleep(0.05)   # the "train step"
        windows.append((t0, _time.monotonic()))
        seen += len(x)
    assert seen == 6 * 64
    assert opens and all("prefetch" in name for name, _ in opens), opens
    assert any(a <= t <= b for _, t in opens for a, b in windows)


def test_prefetch_degrades_safely_under_foreign_arrow_pool(S, tmp_path):
    s = S.Store.create(str(tmp_path))
    path = s.get_train_data_path("dg")
    s.makedirs(path)
    pd.DataFrame({
        "features": [[float(j), 0.0, 0.0] for j in range(48)],
        "label": [float(j) for j in range(48)],
    }).to_parquet(f"{path}/part-00000.parquet")
    import pyarrow as pa
    chunks = list(s.iter_array_batches(path, ["features"], ["label"],
                                       chunk_rows=16, prefetch=2))
    assert sum(len(x) for x, _ in chunks) == 48
    if pa.default_memory_pool().backend_name == "mimalloc":
        assert not S._arrow_background_thread_safe()


def test_prefetch_iter_stops_its_reader_when_abandoned():
    """Abandoning the iterator mid-stream stops the reader thread at its
    next put (the cancellation flag), in both packages."""
    import threading
    import time as _time

    for S in PACKAGES.values():
        before = {t.ident for t in threading.enumerate()}
        it = S._prefetch_iter(iter(range(1000)), 2)
        assert next(it) == 0
        it.close()
        deadline = _time.time() + 5
        while _time.time() < deadline and any(
                t.name == "hvd-store-prefetch" and t.ident not in before
                for t in threading.enumerate()):
            _time.sleep(0.05)
        assert not any(t.name == "hvd-store-prefetch"
                       and t.ident not in before
                       for t in threading.enumerate())


def test_prefer_system_arrow_pool_matches_reference(monkeypatch):
    """pyarrow is loaded in this process, so both leave the env alone;
    without it both default ARROW_DEFAULT_MEMORY_POOL to the system pool
    and keep a value the user set."""
    import sys
    monkeypatch.delenv("ARROW_DEFAULT_MEMORY_POOL", raising=False)
    port_store.prefer_system_arrow_pool()
    assert "ARROW_DEFAULT_MEMORY_POOL" not in __import__("os").environ
    monkeypatch.delitem(sys.modules, "pyarrow")
    for S in PACKAGES.values():
        monkeypatch.delenv("ARROW_DEFAULT_MEMORY_POOL", raising=False)
        S.prefer_system_arrow_pool()
        assert __import__("os").environ["ARROW_DEFAULT_MEMORY_POOL"] == \
            "system"
        monkeypatch.setenv("ARROW_DEFAULT_MEMORY_POOL", "jemalloc")
        S.prefer_system_arrow_pool()
        assert __import__("os").environ["ARROW_DEFAULT_MEMORY_POOL"] == \
            "jemalloc"


def test_store_iter_array_batches_streams_chunks(S, tmp_path):
    store = S.Store.create(str(tmp_path))
    path = store.get_train_data_path("chunks")
    store.write_dataframe(_regression_df(100), path)
    chunks = list(store.iter_array_batches(path, ["features"], ["label"],
                                           chunk_rows=32))
    assert [len(x) for x, _y in chunks] == [32, 32, 32, 4]
    assert np.concatenate([x for x, _ in chunks]).shape == (100, 3)


def test_dataframe_to_arrays_equal_reference():
    df = _regression_df(17, d=4, seed=5).assign(
        extra=np.arange(17, dtype=np.float64))
    for feats in (["features"], ["features", "extra"], ["extra"]):
        want = ref_store.dataframe_to_arrays(df, feats, ["label"])
        got = port_store.dataframe_to_arrays(df, feats, ["label"])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
