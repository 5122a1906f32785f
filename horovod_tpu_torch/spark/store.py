"""Storage for the estimators' data and checkpoints (port of
horovod_tpu/spark/store.py).

Capability parity with the reference horovod/spark/common/store.py:32-520:
a ``Store`` owns three sub-trees (intermediate train/val data, checkpoints,
logs) under a prefix path, knows how to materialize a DataFrame to Parquet
and read it back, and is subclassed per filesystem: ``LocalStore`` (local
disk, NFS, FUSE mounts) and ``FsspecStore`` / ``GCSStore`` (remote object
stores addressed by URL, any fsspec protocol; ``gs://`` selects
``GCSStore``).  ``Store.create`` picks by prefix like the reference's
``Store.create`` (store.py:46-58).  Nothing here needs torch: the Parquet
this store writes is the reference store's, and each reads the other's.

The worker feed (``iter_array_batches``) streams parquet row groups without
materializing the dataset (the reference's Petastorm reader role,
spark/keras/remote.py:102) and shards *reads* per rank: with enough row
groups each rank reads only its own ~1/size of the files.  Chunks are
re-batched to a fixed size and truncated to the common per-rank row count
so every rank executes an identical optimizer-step schedule — the blocking
per-gradient allreduces stay in lockstep (the reference equalizes with
steps_per_epoch = rows / batch / np the same way).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

def prefer_system_arrow_pool() -> None:
    """pyarrow's bundled mimalloc segfaults in mi_thread_init when arrow
    is first exercised from a freshly-created Python thread in processes
    with certain loader states (observed: estimator worker processes;
    kernel log points the fault into libarrow's mi_thread_init).  The
    async prefetch reader is exactly such a thread.  The pool is baked at
    pyarrow import, so estimator WORKERS call this before their first
    arrow touch to default to the system allocator — scoped there rather
    than at library import, which would silently change the allocator of
    any host application that merely imports horovod_tpu_torch.spark.  No-op
    once pyarrow is loaded (the runtime guard in iter_array_batches then
    degrades prefetch instead).  An explicitly set
    ARROW_DEFAULT_MEMORY_POOL always wins."""
    import sys
    if "pyarrow" not in sys.modules:
        os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")


def _prefetch_iter(gen, depth: int):
    """Run ``gen`` on a background thread through a bounded queue of
    ``depth`` items: the next chunk's (possibly remote) store reads
    overlap the consumer's compute.  Exceptions re-raise at the consuming
    site.  Abandoning the iterator (consumer raised mid-epoch /
    generator closed) stops the reader promptly via a cancellation flag
    — a reader permanently parked on the bounded queue would leak the
    thread plus ``depth`` buffered chunks per retried fit."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def put_checked(item) -> bool:
        """Bounded put that gives up when the consumer abandoned the
        iterator — EVERY reader put must go through this, including the
        end sentinel and the exception relay, or the thread parks on the
        full queue forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def reader():
        try:
            for item in gen:
                if not put_checked(item):
                    return
            put_checked(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            put_checked(e)

    t = threading.Thread(target=reader, daemon=True,
                         name="hvd-store-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # Closing `gen` from this thread would race the reader executing
        # it (generators are single-threaded); the flag makes the reader
        # exit at its next put and the generator unwinds with its thread.
        stop.set()


_WARNED_NO_PREFETCH = False


def _arrow_background_thread_safe() -> bool:
    """True when arrow's default pool is not mimalloc (the module-import
    env default took effect, or the user picked another pool): exercising
    arrow from a fresh Python thread is then safe."""
    try:
        import pyarrow as pa
    except Exception:  # noqa: BLE001 — no arrow in the process
        return True  # prefetch cannot touch arrow; nothing to trip
    try:
        return pa.default_memory_pool().backend_name != "mimalloc"
    except Exception:  # noqa: BLE001 — older pyarrow, no backend_name
        # pyarrow IS present but the pool cannot be identified: the
        # mimalloc hazard the guard exists for cannot be ruled out —
        # degrade to synchronous reads.
        return False


class Store:
    """Base class: path layout + parquet materialization."""

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path

    @staticmethod
    def create(prefix_path: str) -> "Store":
        if "://" in prefix_path:
            if prefix_path.startswith("gs://"):
                return GCSStore(prefix_path)
            return FsspecStore(prefix_path)  # file://, s3://, memory://, …
        # FUSE mounts and local paths are both filesystem paths.
        return LocalStore(prefix_path)

    # -- path layout (reference store.py:60-101) --
    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        return self._join(self.prefix_path, "intermediate_train_data",
                          idx or "")

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        return self._join(self.prefix_path, "intermediate_val_data",
                          idx or "")

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join(self.prefix_path, "runs", run_id, "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return self._join(self.prefix_path, "runs", run_id, "logs")

    @staticmethod
    def _join(*parts: str) -> str:
        return "/".join(p.rstrip("/") for p in parts if p)

    # -- filesystem primitives (overridden per backend) --
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    # Local-filesystem defaults, NOT abstract: pre-existing user Store
    # subclasses implemented only exists/makedirs/delete (the reference's
    # abstract surface) and must keep working when the base data paths
    # call these.
    def _open(self, path: str, mode: str):
        return open(path, mode)

    def _listdir(self, path: str):
        return [os.path.join(path, f) for f in os.listdir(path)]

    # -- data materialization --
    def write_dataframe(self, df, path: str) -> int:
        """Materialize a DataFrame as Parquet under ``path``; returns the
        row count.  Spark DataFrames are written executor-side
        (``df.write.parquet``) — the dataset never funnels through driver
        memory, unlike a ``toPandas()`` materialization (the reference
        streams through Petastorm for the same reason,
        spark/keras/remote.py:102)."""
        if hasattr(df, "write") and hasattr(df, "toPandas"):
            # Spark DataFrame: distributed write straight to the store.
            # Row count comes from the written parquet footers — a
            # pre-write df.count() would execute the input lineage twice.
            df.write.mode("overwrite").parquet(path)
            try:
                import pyarrow.parquet as pq
                total = 0
                for p in self._parquet_parts(path):
                    with self._open(p, "rb") as f:
                        total += pq.ParquetFile(f).metadata.num_rows
                return total
            except Exception:
                return -1  # listing unsupported; count unknown
        self.makedirs(path)
        target = self._join(path, "part-00000.parquet")
        with self._open(target, "wb") as f:
            df.to_parquet(f)
        return len(df)

    def _parquet_parts(self, path: str):
        return sorted(p for p in self._listdir(path)
                      if p.endswith(".parquet"))

    def read_dataframe(self, path: str):
        import pandas as pd
        frames = []
        for p in self._parquet_parts(path):
            with self._open(p, "rb") as f:
                frames.append(pd.read_parquet(f))
        return pd.concat(frames, ignore_index=True)

    def iter_array_batches(self, path: str, feature_cols, label_cols,
                           chunk_rows: int = 65536, rank: int = 0,
                           size: int = 1, epoch: int = 0,
                           shuffle_seed: Optional[int] = None,
                           prefetch: int = 0):
        """Stream (X, y) float32 chunks from the parquet files under
        ``path`` without loading the dataset into memory.

        With ``size > 1`` the stream is *rank-local*: row groups are
        sharded ``rank::size`` when there are at least ``size`` of them
        (each rank reads only its own files — the remote-store fast path),
        falling back to a strided row split over shared reads otherwise.
        Either way every rank yields chunks of identical sizes (fixed
        ``chunk_rows``, truncated to the common per-rank row count), so
        per-batch blocking collectives across ranks stay in lockstep.

        ``shuffle_seed`` enables a per-``epoch`` seeded permutation of the
        row-group unit schedule (the Petastorm shuffle role,
        reference spark/keras/remote.py:102): the permutation is a pure
        function of (seed, epoch) over the deterministic unit table, so
        it is identical on every rank with no communication — epochs
        traverse the dataset in different orders while rank shards stay
        disjoint and globally complete.  Row-group granularity (the
        strided-row fallback for tiny datasets streams unshuffled;
        estimators additionally shuffle rows within each chunk).

        ``prefetch > 0`` reads ahead through a bounded background-thread
        queue of that depth, overlapping the next chunk's store reads
        with the caller's train step (the Petastorm pooled-reader role).
        """
        # use_threads=False on the arrow calls below: the feed streams
        # sequentially (arrow's pool buys nothing here) and the prefetch
        # reader must not fan out further foreign threads on top of the
        # mimalloc thread-init hazard handled at module import.
        gen = self._iter_array_batches_impl(
            path, feature_cols, label_cols, chunk_rows, rank, size,
            epoch, shuffle_seed)
        if prefetch > 0 and not _arrow_background_thread_safe():
            # The allocator default at module import came too late (the
            # caller touched pyarrow first and it picked mimalloc):
            # running arrow from a fresh thread risks the mi_thread_init
            # segfault documented above — degrade to synchronous reads.
            global _WARNED_NO_PREFETCH
            if not _WARNED_NO_PREFETCH:
                import sys
                print("[horovod_tpu_torch] warning: pyarrow initialized "
                      "with the mimalloc pool before "
                      "horovod_tpu_torch.spark was "
                      "imported; disabling feed prefetch (set "
                      "ARROW_DEFAULT_MEMORY_POOL=system before importing "
                      "pyarrow to re-enable).", file=sys.stderr)
                _WARNED_NO_PREFETCH = True
            prefetch = 0
        if prefetch > 0:
            gen = _prefetch_iter(gen, prefetch)
        return gen

    def _iter_array_batches_impl(self, path, feature_cols, label_cols,
                                 chunk_rows, rank, size, epoch,
                                 shuffle_seed):
        import pyarrow.parquet as pq
        parts = self._parquet_parts(path)
        if size <= 1 and shuffle_seed is None:
            for part in parts:
                with self._open(part, "rb") as f:
                    pf = pq.ParquetFile(f)
                    for rb in pf.iter_batches(batch_size=chunk_rows,
                                              use_threads=False):
                        yield dataframe_to_arrays(rb.to_pandas(),
                                                  feature_cols, label_cols)
            return

        # Deterministic unit table (identical on every rank: same listing,
        # same metadata) — the shard plan needs no communication.  Cached
        # per path: estimator epochs re-iterate the same materialized
        # dataset, and footer reads are round trips on remote stores.
        units = self._row_group_units(path, parts)

        if shuffle_seed is not None and len(units) > 1:
            # Identical permutation on every rank: pure function of
            # (seed, epoch) over the deterministic unit table.  Sharding
            # the PERMUTED table keeps rank shards disjoint and globally
            # complete while both the per-rank read order and the
            # rank->unit assignment change each epoch.
            perm = np.random.default_rng(
                [int(shuffle_seed) & 0x7FFFFFFF,
                 int(epoch)]).permutation(len(units))
            units = [units[i] for i in perm]

        if len(units) >= size:
            mine = units[rank::size]
            common = min(sum(u[2] for u in units[r::size])
                         for r in range(size))

            def frames():
                # Per-part handle cache: the shuffled schedule interleaves
                # parts, so open each file once on first use and reuse its
                # handle for later row groups (on remote stores every
                # open+footer parse is a round trip).  Row groups stream
                # in chunk_rows batches — a single row group can be the
                # whole file, and materializing it would break the
                # bounded-memory contract the unsharded path keeps.
                # LRU-capped handle cache: reuse per-part handles under
                # the shuffled (interleaved) schedule without holding one
                # fd/remote connection per part of an arbitrarily large
                # dataset open at once.
                from collections import OrderedDict
                _CAP = 64
                open_files: "OrderedDict" = OrderedDict()  # part -> (f, pf)

                def _close(part):
                    f, _pf = open_files.pop(part)
                    try:
                        f.close()
                    except Exception:  # noqa: BLE001
                        pass

                try:
                    for part, rg, _rows in mine:
                        ent = open_files.get(part)
                        if ent is None:
                            if len(open_files) >= _CAP:
                                _close(next(iter(open_files)))
                            f = self._open(part, "rb")
                            ent = (f, pq.ParquetFile(f))
                            open_files[part] = ent
                        else:
                            open_files.move_to_end(part)
                        for rb in ent[1].iter_batches(
                                batch_size=chunk_rows,
                                row_groups=[rg],
                                use_threads=False):
                            yield rb.to_pandas()
                finally:
                    for part in list(open_files):
                        _close(part)
        else:
            total = sum(u[2] for u in units)
            common = min(len(range(r, total, size)) for r in range(size))

            def frames():
                offset = 0
                for part in parts:
                    with self._open(part, "rb") as f:
                        pf = pq.ParquetFile(f)
                        for rb in pf.iter_batches(batch_size=chunk_rows,
                                                  use_threads=False):
                            df = rb.to_pandas()
                            sel = [i for i in range(len(df))
                                   if (offset + i) % size == rank]
                            offset += len(df)
                            yield df.iloc[sel]

        # Re-batch to fixed-size chunks truncated at the common row count:
        # identical chunk schedule on every rank.
        pend_x = pend_y = None
        emitted = 0
        for df in frames():
            if not len(df):
                continue
            x, y = dataframe_to_arrays(df, feature_cols, label_cols)
            pend_x = x if pend_x is None else np.concatenate([pend_x, x])
            pend_y = y if pend_y is None else np.concatenate([pend_y, y])
            while len(pend_x) >= chunk_rows and \
                    emitted + chunk_rows <= common:
                yield pend_x[:chunk_rows], pend_y[:chunk_rows]
                pend_x = pend_x[chunk_rows:]
                pend_y = pend_y[chunk_rows:]
                emitted += chunk_rows
            # Stop reading once enough rows are buffered for the tail:
            # a skewed shard must not keep downloading surplus row groups
            # that would only be discarded.
            if emitted + len(pend_x) >= common:
                break
        tail = common - emitted
        if tail > 0 and pend_x is not None and len(pend_x) >= tail:
            yield pend_x[:tail], pend_y[:tail]

    def _row_group_units(self, path: str, parts):
        """(part, row_group, rows) table for ``path``, cached on the
        instance (datasets under a run id are written once)."""
        import pyarrow.parquet as pq
        cache = getattr(self, "_unit_cache", None)
        if cache is None:
            cache = self._unit_cache = {}
        key = (path, tuple(parts))
        if key not in cache:
            units = []
            for part in parts:
                with self._open(part, "rb") as f:
                    md = pq.ParquetFile(f).metadata
                    for rg in range(md.num_row_groups):
                        units.append((part, rg,
                                      md.row_group(rg).num_rows))
            cache[key] = units
        return cache[key]

    def save_checkpoint(self, run_id: str, payload: bytes) -> str:
        path = self.get_checkpoint_path(run_id)
        self.makedirs(self._dirname(path))
        with self._open(path, "wb") as f:
            f.write(payload)
        return path

    def load_checkpoint(self, run_id: str) -> bytes:
        with self._open(self.get_checkpoint_path(run_id), "rb") as f:
            return f.read()

    @staticmethod
    def _dirname(path: str) -> str:
        return path.rsplit("/", 1)[0] if "/" in path else path


class LocalStore(Store):
    """Filesystem store (reference LocalStore, store.py:105-132); covers
    local disk, NFS and FUSE mounts.  _open/_listdir come from the base's
    local-filesystem defaults."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


class FsspecStore(Store):
    """URL-addressed remote store over any fsspec filesystem (the
    reference's HDFSStore role, store.py:337-471, generalized): ``gs://``,
    ``s3://``, ``memory://`` (tests), ...  Workers re-resolve the
    filesystem lazily so Store objects stay picklable across process
    boundaries."""

    def __init__(self, prefix_path: str):
        super().__init__(prefix_path.rstrip("/"))
        self._protocol = prefix_path.split("://", 1)[0]
        self.__fs = None

    @property
    def _fs(self):
        if self.__fs is None:
            import fsspec
            self.__fs = fsspec.filesystem(self._protocol)
        return self.__fs

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_FsspecStore__fs"] = None  # filesystems may hold sockets
        return state

    def _with_protocol(self, path: str) -> str:
        return path if "://" in path else f"{self._protocol}://{path}"

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def makedirs(self, path: str) -> None:
        self._fs.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if self._fs.exists(path):
            self._fs.rm(path, recursive=True)

    def _open(self, path: str, mode: str):
        return self._fs.open(path, mode)

    def _listdir(self, path: str):
        # fs.ls returns protocol-less paths; keep them addressable.
        return [self._with_protocol(p)
                for p in self._fs.ls(path, detail=False)]


class GCSStore(FsspecStore):
    """Google Cloud Storage store (an analog of the reference's
    HDFSStore, store.py:337): a ``gs://bucket/prefix`` path served by
    gcsfs.  Credentials come from the machine's application-default
    service account; pass nothing here.  Selecting it reaches no bucket:
    the filesystem resolves at the first read or write."""

    def __init__(self, prefix_path: str):
        if not prefix_path.startswith("gs://"):
            raise ValueError("GCSStore requires a gs:// prefix path")
        super().__init__(prefix_path)


def dataframe_to_arrays(df, feature_cols, label_cols):
    """Split a pandas DataFrame into (X, y) float32 arrays; list-valued
    cells (vector columns) are stacked."""
    def col_to_array(c):
        v = df[c].to_numpy()
        if len(v) and isinstance(v[0], (list, tuple, np.ndarray)):
            return np.stack([np.asarray(x, dtype=np.float32) for x in v])
        return v.astype(np.float32)[:, None]

    x = np.concatenate([col_to_array(c) for c in feature_cols], axis=1)
    y = np.concatenate([col_to_array(c) for c in label_cols], axis=1)
    return x, y
