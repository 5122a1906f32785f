"""Atomic sharded-checkpoint writer/reader (port of
horovod_tpu/checkpoint/engine.py).

Durability protocol (the tentpole's invariant: *a partial write is never
restorable*):

1. every rank writes its shard file via tmp-file + ``os.rename`` (atomic
   on POSIX) into the step directory;
2. rank 0 — after all shards exist — writes ``MANIFEST.json`` the same
   way, as the LAST file of the step;
3. ``latest`` resolution only ever selects a step whose manifest parses
   AND whose listed shard files all exist.

A crash at any point between (1) and (2) leaves a step directory with no
manifest: invisible to restores, reclaimed by :func:`gc_steps`.  Orbax is
never required — storage is plain ``.npz`` — and the layout is the
reference's, byte for byte, so either package reads the other's steps.

Saves and restores feed the ``hvd_checkpoint_*`` metric families: bytes
written and read, saves and restores, their durations, and the seconds
paid on the calling thread (``hvd_checkpoint_blocking_seconds_total``,
the step attribution's ``checkpoint`` component).
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import manifest as M
from . import reshard as R

_ckpt_metrics = None


# Foreground/background discrimination for the step attribution: the
# async committer's flushes run on a daemon thread and overlap training,
# so their wall time must not land in the blocking-seconds counter the
# per-step decomposition reads (metrics/attribution.py).
_io_context = threading.local()


@contextlib.contextmanager
def background_io():
    """Mark this thread's engine calls as background (the async commit
    of ``elastic.TpuState``): save/restore durations still feed the
    ``hvd_checkpoint_*_seconds`` histograms, but are excluded from
    ``hvd_checkpoint_blocking_seconds_total``."""
    prev = getattr(_io_context, "background", False)
    _io_context.background = True
    try:
        yield
    finally:
        _io_context.background = prev


def _record_io_seconds(hist, seconds: float) -> None:
    hist.observe(seconds)
    if not getattr(_io_context, "background", False):
        _metrics()[6].inc(max(seconds, 0.0))


def _metrics():
    """Cached checkpoint metric children (the metrics registry)."""
    global _ckpt_metrics
    if _ckpt_metrics is None:
        from ..metrics.registry import registry
        reg = registry()
        buckets = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)
        _ckpt_metrics = (
            reg.counter("hvd_checkpoint_bytes_written_total",
                        "Shard + manifest bytes written"),
            reg.counter("hvd_checkpoint_bytes_read_total",
                        "Shard bytes read on restore"),
            reg.counter("hvd_checkpoint_saves_total",
                        "Committed checkpoint save operations"),
            reg.counter("hvd_checkpoint_restores_total",
                        "Checkpoint restore operations"),
            reg.histogram("hvd_checkpoint_save_seconds",
                          "save_leaves wall time", buckets=buckets),
            reg.histogram("hvd_checkpoint_restore_seconds",
                          "restore_leaves wall time", buckets=buckets),
            reg.counter("hvd_checkpoint_blocking_seconds_total",
                        "Save/restore wall seconds paid on the calling "
                        "thread (async-committer flushes excluded) — "
                        "the step attribution's checkpoint component"),
        )
    return _ckpt_metrics

def _atomic_write_bytes(path: str, data: bytes) -> None:
    """Write via a same-directory tempfile + rename so readers never see
    a half-written file."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        # The rename itself lives in the directory entry: without a
        # directory fsync a power loss can roll back a "committed"
        # manifest even though the file's bytes were synced.
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, M.step_dirname(step))


def _refuse_committed(root: str, step: int) -> None:
    # Committed steps are immutable: rewriting shards under a live
    # manifest would make a crash mid-rewrite RESTORABLE torn state
    # (old and new shards mixed under a parseable manifest).
    if os.path.exists(os.path.join(step_dir(root, step), M.MANIFEST_NAME)):
        raise FileExistsError(
            f"step {step} in {root} is already committed; checkpoint "
            "steps are immutable — write a new step instead")


def write_shard(root: str, step: int, rank: int, world_size: int,
                arrays: Dict[str, np.ndarray]) -> str:
    """Atomically write one rank's shard file for a step."""
    _refuse_committed(root, step)
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    path = os.path.join(step_dir(root, step),
                        M.shard_filename(rank, world_size))
    data = buf.getvalue()
    _atomic_write_bytes(path, data)
    _metrics()[0].inc(len(data))
    return path


def commit(root: str, step: int, manifest: M.Manifest) -> str:
    """Write the manifest — the step becomes restorable at the rename.

    Refuses to commit while any listed shard file is missing, so a
    mis-sequenced caller cannot publish a torn step.
    """
    _refuse_committed(root, step)
    d = step_dir(root, step)
    missing = [f for f in manifest.shard_filenames()
               if not os.path.exists(os.path.join(d, f))]
    if missing:
        raise FileNotFoundError(
            f"refusing to commit step {step}: missing shard files "
            f"{missing} in {d}")
    # Every shard file must carry every manifest leaf (sharded leaves:
    # that rank's slice; replicated: a full copy) — committing a file
    # with a missing key would publish a step that fails only at
    # restore time.  Reads just the .npz central directories.
    required = {leaf.key for leaf in manifest.leaves}
    for f in manifest.shard_filenames():
        with np.load(os.path.join(d, f)) as z:
            absent = required.difference(z.files)
        if absent:
            raise ValueError(
                f"refusing to commit step {step}: shard {f} is missing "
                f"leaves {sorted(absent)}")
    path = os.path.join(d, M.MANIFEST_NAME)
    _atomic_write_bytes(path, manifest.to_json().encode("utf-8"))
    return path


def read_manifest(root: str, step: int) -> M.Manifest:
    with open(os.path.join(step_dir(root, step), M.MANIFEST_NAME),
              encoding="utf-8") as f:
        return M.Manifest.from_json(f.read())


def is_committed(root: str, step: int) -> bool:
    """True iff the step's manifest parses and all its shards exist."""
    d = step_dir(root, step)
    try:
        manifest = read_manifest(root, step)
    except (OSError, ValueError, KeyError):
        return False
    return all(os.path.exists(os.path.join(d, f))
               for f in manifest.shard_filenames())


def list_steps(root: str, committed_only: bool = True) -> List[int]:
    """Step numbers present under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in sorted(os.listdir(root)):
        step = M.parse_step_dirname(name)
        if step is None:
            continue
        if committed_only and not is_committed(root, step):
            continue
        steps.append(step)
    return steps


def latest_step(root: str) -> Optional[int]:
    """Newest *committed* step — torn steps are never selected."""
    steps = list_steps(root, committed_only=True)
    return steps[-1] if steps else None


def read_shard(root: str, step: int, rank: int,
               world_size: int) -> Dict[str, np.ndarray]:
    path = os.path.join(step_dir(root, step),
                        M.shard_filename(rank, world_size))
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    try:
        _metrics()[1].inc(os.path.getsize(path))
    except OSError:
        pass
    return out


def gc_steps(root: str, keep: int = 3) -> List[int]:
    """Retention: drop committed steps beyond the newest ``keep``, plus
    every torn step older than the newest committed one (crash debris).
    Returns the deleted step numbers."""
    committed = list_steps(root, committed_only=True)
    deleted = []
    for step in committed[:-keep] if keep > 0 else committed:
        shutil.rmtree(step_dir(root, step), ignore_errors=True)
        deleted.append(step)
    if committed:
        newest = committed[-1]
        for step in list_steps(root, committed_only=False):
            if step < newest and not is_committed(root, step):
                shutil.rmtree(step_dir(root, step), ignore_errors=True)
                deleted.append(step)
    return sorted(set(deleted))


# ---------------------------------------------------------------------------
# Leaf-level save/restore used by the front-ends (zero.py)
# ---------------------------------------------------------------------------

def save_leaves(root: str, step: int, specs: List[M.LeafSpec],
                rank_values: Dict[int, List[Optional[np.ndarray]]],
                world_size: int, *, committer: bool = True,
                extra: Optional[dict] = None,
                barrier=None, pre_commit=None) -> M.Manifest:
    """Write shard files for the ranks this process owns, then commit.

    ``rank_values[r]`` is the list of per-leaf host arrays for rank *r*
    (sharded leaves: that rank's flat shard; replicated leaves: the full
    value, duplicated into every rank's file so any single rank restores
    it).  Multi-controller callers pass only their own rank(s) and
    ``committer=rank 0``; ``barrier`` (when given) runs between the shard
    writes and the manifest commit so the committer cannot outrun a slow
    writer.
    """
    t0 = time.perf_counter()
    for rank, values in sorted(rank_values.items()):
        arrays = {}
        for spec, val in zip(specs, values):
            if val is None:
                continue
            arrays[spec.key] = np.asarray(val)
        write_shard(root, step, rank, world_size, arrays)
    if barrier is not None:
        barrier()
    if pre_commit is not None:
        pre_commit()
    manifest = M.Manifest(step=step, world_size=world_size, leaves=specs,
                          extra=extra or {})
    if committer:
        commit(root, step, manifest)
    m = _metrics()
    m[2].inc()
    _record_io_seconds(m[4], time.perf_counter() - t0)
    return manifest


def restore_leaves(root: str, step: int,
                   new_world_size: int) -> "RestoredStep":
    """Load a committed step and expose its leaves resharded for a world
    of ``new_world_size`` ranks."""
    if not is_committed(root, step):
        raise FileNotFoundError(
            f"step {step} in {root} is not a committed checkpoint "
            "(torn write or wrong directory)")
    t0 = time.perf_counter()
    manifest = read_manifest(root, step)
    shards = [read_shard(root, step, r, manifest.world_size)
              for r in range(manifest.world_size)]
    m = _metrics()
    m[3].inc()
    _record_io_seconds(m[5], time.perf_counter() - t0)
    return RestoredStep(manifest, shards, new_world_size)


class _StepReader:
    """Shared reshard-on-read logic for an opened committed step.

    One copy of the replicated/same-world/resharded branching serves
    every reader — the eager :class:`RestoredStep` and the streaming
    :class:`LazyStep` both go through it, which is what makes their
    outputs bit-identical *by construction*.  Subclasses supply only how bytes are fetched:
    ``_one_shard(spec, rank)`` and ``_replicated_value(spec)``."""

    manifest: M.Manifest
    new_world_size: int

    def _one_shard(self, spec: M.LeafSpec, rank: int) -> np.ndarray:
        raise NotImplementedError

    def _replicated_value(self, spec: M.LeafSpec) -> np.ndarray:
        raise NotImplementedError

    def _leaf_shards(self, spec: M.LeafSpec) -> List[np.ndarray]:
        return [self._one_shard(spec, r)
                for r in range(self.manifest.world_size)]

    def full_value(self, spec: M.LeafSpec) -> np.ndarray:
        """The logical (unsharded, unpadded) value of a leaf."""
        if spec.kind == M.REPLICATED:
            return self._replicated_value(spec).reshape(spec.shape)
        flat = R.reassemble(self._leaf_shards(spec), spec.true_size)
        return flat.reshape(spec.shape)

    def shard_value(self, spec: M.LeafSpec, rank: int) -> np.ndarray:
        """Leaf value for rank ``rank`` of the NEW world (resharded)."""
        if spec.kind == M.REPLICATED:
            return self._replicated_value(spec).reshape(spec.shape)
        if self.new_world_size == self.manifest.world_size:
            return self._one_shard(spec, rank).reshape(-1)
        return R.reshard(self._leaf_shards(spec), spec.true_size,
                         self.new_world_size)[rank]


class RestoredStep(_StepReader):
    """A committed step opened for restore, with reshard-on-read."""

    def __init__(self, manifest: M.Manifest,
                 shards: List[Dict[str, np.ndarray]],
                 new_world_size: int):
        self.manifest = manifest
        self._shards = shards
        self.new_world_size = int(new_world_size)

    def _one_shard(self, spec: M.LeafSpec, rank: int) -> np.ndarray:
        return self._shards[rank][spec.key]

    def _replicated_value(self, spec: M.LeafSpec) -> np.ndarray:
        return self._shards[0][spec.key]


def open_step(root: str, step: int, new_world_size: int) -> "LazyStep":
    """Open a committed step for STREAMING restore: shard files stay on
    disk as lazily-indexed ``.npz`` handles and each leaf's arrays are
    read only when that leaf is rebuilt — the restore machinery's
    transient memory is O(largest leaf x old world) instead of O(total
    state).  Same read surface (and bit-identical values) as
    :func:`restore_leaves`; close the handle (context manager) when the
    rebuild is done."""
    if not is_committed(root, step):
        raise FileNotFoundError(
            f"step {step} in {root} is not a committed checkpoint "
            "(torn write or wrong directory)")
    manifest = read_manifest(root, step)
    d = step_dir(root, step)
    handles = [np.load(os.path.join(d, f))
               for f in manifest.shard_filenames()]
    _metrics()[3].inc()
    return LazyStep(manifest, handles, new_world_size)


class LazyStep(_StepReader):
    """A committed step opened for per-leaf streaming reads: shard
    bytes are fetched (and metered) from the lazily-indexed ``.npz``
    handles only when the shared read logic asks for them."""

    def __init__(self, manifest: M.Manifest, handles: List,
                 new_world_size: int):
        self.manifest = manifest
        self._handles = handles
        self.new_world_size = int(new_world_size)

    def _one_shard(self, spec: M.LeafSpec, rank: int) -> np.ndarray:
        a = self._handles[rank][spec.key]  # reads ONE zip member
        _metrics()[1].inc(int(a.nbytes))
        return a

    def _replicated_value(self, spec: M.LeafSpec) -> np.ndarray:
        return self._one_shard(spec, 0)

    def close(self) -> None:
        for h in self._handles:
            try:
                h.close()
            except OSError:  # best-effort teardown
                pass
        self._handles = []

    def __enter__(self) -> "LazyStep":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
