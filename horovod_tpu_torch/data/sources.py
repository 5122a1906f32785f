"""Data sources: one ``gather(indices)`` protocol for everything (port of
horovod_tpu/data/sources.py; numpy on the host).

The sampler decides *which* sample indices a rank consumes; a source
answers *what* those samples are.  Keeping the boundary index-based is
what makes the pipeline checkpointable — the resumable state is pure
index arithmetic (``sampler.py``) and sources stay stateless.

* :class:`ArraySource` — in-memory arrays (the existing synthetic
  generators plug in here unchanged: ``ArraySource(x, y)``).
* :class:`MemmapSource` — ``np.memmap`` over a binary file; rows are
  materialized to RAM only when gathered, so datasets far larger than
  host memory stream through the prefetch queue.
* :class:`FileListSource` — one file per sample (``.npy`` by default),
  loaded lazily and stacked per batch.

A gathered batch is either a single array or a tuple of arrays (one per
component), always batch-major — exactly what ``DataLoader`` copies to
its device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


class DataSource:
    """Protocol: ``len(source)`` samples, ``gather(indices)`` batches.

    Subclasses override both; ``gather`` receives a 1-D integer index
    array and returns the corresponding batch (array or tuple of
    arrays, batch-major).  It may be called from a background prefetch
    thread, so implementations must be thread-safe for reads.
    """

    def __len__(self) -> int:
        raise NotImplementedError

    def gather(self, indices: np.ndarray):
        raise NotImplementedError

    def __getitem__(self, index: int):
        return self.gather(np.asarray([index]))


class ArraySource(DataSource):
    """In-memory arrays sharing a leading (sample) dimension."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("ArraySource needs at least one array")
        self._arrays: Tuple[np.ndarray, ...] = tuple(
            np.asarray(a) for a in arrays)
        n = self._arrays[0].shape[0]
        for a in self._arrays[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    f"all arrays must share the leading dimension; got "
                    f"{[a.shape[0] for a in self._arrays]}")
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def gather(self, indices: np.ndarray):
        out = tuple(a[indices] for a in self._arrays)
        return out[0] if len(out) == 1 else out


class MemmapSource(DataSource):
    """Rows of one ``np.memmap`` file (sample-major binary layout).

    The map is opened lazily and read-only; ``gather`` copies the
    gathered rows into a fresh in-RAM array so downstream transforms
    (and the device copy) never hold the mapping open.
    """

    def __init__(self, path: str, dtype, row_shape: Sequence[int],
                 num_samples: Optional[int] = None):
        self._path = path
        self._dtype = np.dtype(dtype)
        self._row_shape = tuple(int(d) for d in row_shape)
        row_bytes = int(np.prod(self._row_shape)) * self._dtype.itemsize
        if num_samples is None:
            size = os.path.getsize(path)
            if size % row_bytes:
                raise ValueError(
                    f"{path}: {size} bytes is not a whole number of "
                    f"{row_bytes}-byte rows of shape {self._row_shape}")
            num_samples = size // row_bytes
        self._n = int(num_samples)
        self._mm: Optional[np.memmap] = None

    def _map(self) -> np.memmap:
        if self._mm is None:
            self._mm = np.memmap(self._path, dtype=self._dtype, mode="r",
                                 shape=(self._n,) + self._row_shape)
        return self._mm

    def __len__(self) -> int:
        return self._n

    def gather(self, indices: np.ndarray):
        return np.array(self._map()[indices])  # copy out of the mapping


class FileListSource(DataSource):
    """One file per sample, loaded lazily and stacked per batch."""

    def __init__(self, paths: Sequence[str],
                 loader: Optional[Callable[[str], np.ndarray]] = None):
        if not paths:
            raise ValueError("FileListSource needs at least one path")
        self._paths = list(paths)
        self._loader = loader if loader is not None else np.load

    def __len__(self) -> int:
        return len(self._paths)

    def gather(self, indices: np.ndarray):
        return np.stack([np.asarray(self._loader(self._paths[int(i)]))
                         for i in indices])
