"""A model's parameter tree on a ``DeviceMesh``: this rank's place on the
mesh, its shards of the tree, and the autograd seams that differentiate
a per-rank body as the reference differentiates its ``shard_map`` from
outside (check_vma=False).

A spec is a tuple naming, per dim of a leaf, the mesh axis that shards it
(None: not sharded); ``()`` replicates the leaf.  ``enter_tree`` wraps
each leaf entering the body in :class:`Enter`, whose backward sums the
gradient over the axes its spec does not name; the body's replicated
loss leaves through :class:`Leave`, whose backward divides the cotangent
by the mesh size.  After ``loss.backward()`` every shard holds the
reference's gradient of that shard.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from ..parallel import tensor_parallel as tp


class MeshAxes:
    """This rank's place on a mesh with dimensions ``axes``: each axis's
    process group, size and this rank's index on it."""

    def __init__(self, mesh, axes: Sequence[str]):
        axes = tuple(axes)
        if tuple(mesh.mesh_dim_names or ()) != axes:
            raise ValueError(f"the mesh's dimensions must be {axes}, got "
                             f"{mesh.mesh_dim_names}")
        self.axes = axes
        self.group = {a: mesh.get_group(a) for a in axes}
        self.size = dict(zip(axes, (int(n) for n in mesh.mesh.shape)))
        self.index = dict(zip(axes, mesh.get_coordinate()))

    @property
    def n(self) -> int:
        """The mesh's size: the number of ranks on it."""
        out = 1
        for s in self.size.values():
            out *= s
        return out


def leaves(tree, prefix=""):
    """(dotted path, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def map_tree(fn, tree, specs):
    """``tree`` with each leaf ``fn(leaf, its spec)``."""
    return {k: map_tree(fn, v, specs[k]) if isinstance(v, dict)
            else fn(v, specs[k]) for k, v in tree.items()}


def shard_tree(tree: Dict[str, Any], specs, ax: MeshAxes) -> Dict[str, Any]:
    """This rank's shard of the full tree: each dim a spec names cut into
    the axis's size and the chunk at this rank's coordinate taken."""

    def cut(t, spec):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = ax.size[axis]
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide over {axis}={n}")
            chunk = t.shape[dim] // n
            t = t.narrow(dim, ax.index[axis] * chunk, chunk)
        return t.clone()

    return map_tree(cut, tree, specs)


def gather_tree(tree: Dict[str, Any], specs, ax: MeshAxes) -> Dict[str, Any]:
    """The inverse of :func:`shard_tree`: every rank gets the full tree
    (all-gathers over the axes each spec names)."""

    def gather(t, spec):
        t = t.detach()
        for dim, axis in enumerate(spec):
            if axis is not None and ax.size[axis] > 1:
                t = tp._all_gather(t, ax.group[axis], dim)
        return t

    return map_tree(gather, tree, specs)


class Enter(torch.autograd.Function):
    """A shard entering the per-rank body: the identity, whose backward
    sums the gradient over the mesh axes its spec does not name (the
    transpose of ``shard_map``'s input)."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = tp._psum(g, group)
        return g, None


class Leave(torch.autograd.Function):
    """The replicated loss leaving the per-rank body: the identity, whose
    backward divides the cotangent by the mesh size (the transpose of
    ``shard_map``'s replicated output)."""

    @staticmethod
    def forward(ctx, loss, n):
        ctx.n = n
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def enter_tree(tree: Dict[str, Any], specs, ax: MeshAxes) -> Dict[str, Any]:
    """Each leaf through :class:`Enter` over the axes (of size > 1) its
    spec leaves unnamed."""

    def enter(t, spec):
        groups = [ax.group[a] for a in ax.axes
                  if a not in spec and ax.size[a] > 1]
        return Enter.apply(t, groups) if groups else t

    return map_tree(enter, tree, specs)


def leave(loss: torch.Tensor, ax: MeshAxes) -> torch.Tensor:
    return Leave.apply(loss, ax.n) if ax.n > 1 else loss


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group``; its backward the same mean of the
    cotangents (``lax.pmean`` under check_vma=False)."""
    n = tp._size(group)
    return x if n == 1 else tp.psum(x, group) / n
