"""Pure-numpy flat-shard math: pad, slice, reassemble, reshard (the
port's own copy of horovod_tpu/checkpoint/reshard.py).

The ZeRO shard layout (``ops.overlap._rows_of``, the optimizer's
``_my_shard``): a leaf's flat value is zero-padded to a multiple of the
world size N and viewed as ``(N, k)``; rank *r* owns row *r*.
Everything here is host-side numpy, so the engine's durability and
elastic-reshard logic work in any environment.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def pad_flat(x: np.ndarray, world_size: int) -> np.ndarray:
    """Flatten and zero-pad to a multiple of ``world_size``."""
    flat = np.asarray(x).reshape(-1)
    pad = (-flat.size) % world_size
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), dtype=flat.dtype)])
    return flat


def shard_of(x: np.ndarray, world_size: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s flat shard of a full (unpadded) value."""
    flat = pad_flat(x, world_size)
    return flat.reshape(world_size, flat.size // world_size)[rank]


def reassemble(shards: Sequence[np.ndarray], true_size: int) -> np.ndarray:
    """Concatenate world-ordered shards and truncate the ZeRO padding."""
    flat = np.concatenate([np.asarray(s).reshape(-1) for s in shards])
    if flat.size < true_size:
        raise ValueError(
            f"shards hold {flat.size} elements < true_size {true_size}")
    return flat[:true_size]


def reshard(shards: Sequence[np.ndarray], true_size: int,
            new_world_size: int) -> List[np.ndarray]:
    """Re-slice shards written at world N into ``new_world_size`` shards.

    The logical value is reassembled (padding dropped), re-padded for the
    new world size, and split — bit-identical logical elements, only the
    padding tail differs.  This is the elastic-resize path: a checkpoint
    written by N ranks restores into a job running M ranks.
    """
    flat = reassemble(shards, true_size)
    flat = pad_flat(flat, new_world_size)
    k = flat.size // new_world_size
    return [flat[r * k:(r + 1) * k] for r in range(new_world_size)]


# ---------------------------------------------------------------------------
# (dp, mp, ep/pp, ...) mesh layouts — the nested N-level shard math
# ---------------------------------------------------------------------------
#
# A multi-axis mesh stores a leaf in nested levels, outermost split by
# the LAST axis: the flat value is zero-padded to a multiple of the
# last axis size and split into that many contiguous slices (rank-major:
# rank m along the last axis owns slice m); each slice recurses on the
# remaining axes, bottoming out in the ZeRO layout over the first axis.
# For the classic (dp, mp) pair that is: mp model slices, each
# ZeRO-sharded over dp.  A third axis — (dp, mp, ep) for expert
# parallelism, (dp, mp, pp) for pipeline stages — just adds one more
# split level; nothing else changes, which is why a mesh change across
# ANY axis combination restores bit-identically as a plain reshard.
# The flat shard list is row-major over the rank tuple: shard index =
# ((r0 * n1) + r1) * n2 + r2 ..., the axes' joint index in row-major
# order.  With trailing axes of size 1 every function below
# degrades exactly to the lower-dimensional case.

def _check_mesh(mesh) -> tuple:
    dims = tuple(int(d) for d in mesh)
    if not dims:
        raise ValueError("mesh needs at least one axis")
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh sizes must be >= 1, got {dims}")
    return dims


def mesh_shard_of(x: np.ndarray, mesh: Sequence[int],
                  *ranks: int) -> np.ndarray:
    """Rank ``ranks``'s flat shard of a full value under an N-axis mesh
    (``mesh_shard_of(x, (dp, mp), dp_rank, mp_rank)`` for the 2-D case,
    one more rank per extra axis)."""
    dims = _check_mesh(mesh)
    if len(ranks) != len(dims):
        raise ValueError(
            f"mesh {dims} needs {len(dims)} ranks, got {len(ranks)}")
    if len(dims) == 1:
        return shard_of(x, dims[0], ranks[0])
    last = dims[-1]
    slice_ = pad_flat(x, last).reshape(last, -1)[ranks[-1]]
    return mesh_shard_of(slice_, dims[:-1], *ranks[:-1])


def reassemble_mesh(shards: Sequence[np.ndarray], true_size: int,
                    mesh: Sequence[int]) -> np.ndarray:
    """Reassemble the logical value from an N-axis mesh's row-major
    shard list, dropping every padding level.

    Refuses incompatible inputs loudly: a shard count that does not
    match the mesh, or ragged shard sizes (every shard of one leaf has
    the same length by construction — a mismatch means the shards come
    from different leaves or a different layout).
    """
    dims = _check_mesh(mesh)
    total = int(np.prod(dims))
    if len(shards) != total:
        raise ValueError(
            f"mesh {dims} stores {total} shards per leaf, "
            f"got {len(shards)}")
    sizes = {np.asarray(s).size for s in shards}
    if len(sizes) != 1:
        raise ValueError(
            f"ragged shard sizes {sorted(sizes)}: shards do not share "
            f"one {dims} layout")
    if len(dims) == 1:
        return reassemble(shards, true_size)
    last = dims[-1]
    slice_padded = (true_size + (-true_size) % last) // last
    slices = []
    for m in range(last):
        # Row-major rank order: the last-axis rank is the fastest-
        # varying index, so slice m's shards sit at indices ≡ m mod last.
        sub = [shards[i] for i in range(total) if i % last == m]
        slices.append(reassemble_mesh(sub, slice_padded, dims[:-1]))
    return np.concatenate(slices)[:true_size]


def reshard_mesh(shards: Sequence[np.ndarray], true_size: int,
                 old_mesh: Sequence[int],
                 new_mesh: Sequence[int]) -> List[np.ndarray]:
    """Re-slice a leaf's shards from ``old_mesh`` into ``new_mesh`` —
    the arbitrary-mesh-change generalization of :func:`reshard` (the
    all-axes-but-one-equal-1 special case).  The meshes may differ in
    rank count as well as axis sizes ((2, 2, 2) → (2, 2, 1) → (4,) all
    hold the same logical elements); bit-identical logical values, only
    the padding levels differ.  The returned list is row-major over the
    new mesh's rank tuple."""
    dims2 = _check_mesh(new_mesh)
    flat = reassemble_mesh(shards, true_size, old_mesh)
    return [mesh_shard_of(flat, dims2, *rk)
            for rk in np.ndindex(*dims2)]
