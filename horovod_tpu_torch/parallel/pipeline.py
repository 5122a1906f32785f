"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over a stage
ring (port of horovod_tpu/parallel/pipeline.py).

Stages are the members of a process group, in member order; activations
travel stage to stage as point-to-point messages.

* **GPipe** (:func:`pipeline_apply`): every stage runs its microbatches
  in tick order, stage s microbatch m at tick m + s, and the backward
  runs the ticks in reverse.  The whole stage may be rematerialised in
  the backward (``remat``), which keeps one input a microbatch.
* **1F1B** (:func:`pipeline_apply_1f1b`): an autograd Function whose
  forward is the GPipe forward (the outputs are bit-identical) and whose
  backward replays :func:`build_1f1b_schedule`'s table: each forward
  slot rematerialises a stage forward under ``torch.enable_grad()`` and
  stashes it, each backward slot consumes one, so at most
  ``stash_depth`` microbatches are live, not ``n_micro``.

Both run through one executor of (stage, slot) tables.  The reference
runs both lanes on every slot and masks them, because XLA needs a static
scan with unconditional collectives; here a stage runs only the op its
table row names, and a message travels only where the table says one
does: at the end of each slot a stage posts, in one
``batch_isend_irecv``, its send and the receives its neighbours' ops of
that slot imply.  Collectives inside ``stage_fn`` (over another mesh
axis) stay matched, because every member of such a group is the same
stage and so runs the same table row.  With P stages and M microbatches a
stage runs M forward ops (and, in the backward, M backward ops under
GPipe, M forward + M backward ops under 1F1B) and idles the other slots.

Bubble arithmetic: both schedules idle ``(P-1)/(M+P-1)`` of their work
slots; :func:`bubble_fraction` is the analytic bound and the 1F1B builder
measures the realised share from its own table.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, List, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.utils import _pytree as pytree

from .ring_attention import _group_of

# Schedule-table op kinds.
_IDLE, _FWD, _BWD = 0, 1, 2


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Analytic pipeline-bubble fraction ``(P-1)/(M+P-1)``: the share of
    work slots each stage idles in either schedule."""
    if n_stages < 1 or n_micro < 1:
        raise ValueError(f"need n_stages, n_micro >= 1, got "
                         f"{(n_stages, n_micro)}")
    return (n_stages - 1) / (n_micro + n_stages - 1)


class Schedule1F1B(NamedTuple):
    """Static per-(stage, slot) op tables for the 1F1B backward replay."""
    kind: np.ndarray        # (n_stages, n_slots) int32 in {IDLE, FWD, BWD}
    mb: np.ndarray          # (n_stages, n_slots) int32 microbatch, -1 idle
    n_slots: int
    stash_depth: int        # max live microbatch inputs held by any stage
    measured_bubble: float  # idle work slots / total slots, from the table


def build_1f1b_schedule(n_stages: int, n_micro: int) -> Schedule1F1B:
    """Greedy discrete-event build of the non-interleaved 1F1B schedule
    (the reference's, table for table).

    One op (forward of one microbatch, backward of one microbatch, or
    idle) per stage per slot.  F(s, m) needs F(s-1, m) a slot earlier;
    B(s, m) needs B(s+1, m) a slot earlier and F(s, m) done.  A stage
    admits a new forward only while forwards minus backwards stays below
    ``n_stages - s``, which bounds the live stash by the pipeline depth.
    The builder verifies every invariant and measures the realised
    bubble fraction from its own table."""
    P, M = int(n_stages), int(n_micro)
    if P < 1 or M < 1:
        raise ValueError(f"need n_stages, n_micro >= 1, got {(P, M)}")
    f_done = [0] * P
    b_done = [0] * P
    f_slot = [[-1] * M for _ in range(P)]
    b_slot = [[-1] * M for _ in range(P)]
    kind_rows, mb_rows = [], []
    t = 0
    cap = 4 * (M + P) + 8
    while any(b < M for b in b_done):
        if t >= cap:
            raise AssertionError("1F1B schedule builder failed to converge")
        krow, mrow = [_IDLE] * P, [-1] * P
        for s in range(P):
            # Backward first (that is what 1F1B means after warmup).
            m = b_done[s]
            b_ready = (m < M and f_slot[s][m] != -1
                       and (s == P - 1 or (0 <= b_slot[s + 1][m] < t)))
            if b_ready:
                krow[s], mrow[s] = _BWD, m
                b_slot[s][m] = t
                b_done[s] += 1
                continue
            m = f_done[s]
            f_ready = (m < M and (s == 0 or (0 <= f_slot[s - 1][m] < t))
                       and f_done[s] - b_done[s] < P - s)
            if f_ready:
                krow[s], mrow[s] = _FWD, m
                f_slot[s][m] = t
                f_done[s] += 1
        kind_rows.append(krow)
        mb_rows.append(mrow)
        t += 1
    n_slots = t
    kind = np.array(kind_rows, dtype=np.int32).T     # (P, n_slots)
    mb = np.array(mb_rows, dtype=np.int32).T

    # A stage holds microbatch m from the slot its input arrives (upstream
    # F + 1 hop; its own F slot on stage 0) until its backward retires it.
    depth = 0
    for s in range(P):
        for m in range(M):
            assert f_slot[s][m] != -1 and b_slot[s][m] != -1
            assert f_slot[s][m] <= b_slot[s][m]
            if s > 0:
                assert f_slot[s][m] > f_slot[s - 1][m]
            if s < P - 1:
                assert b_slot[s][m] > b_slot[s + 1][m]
        enter = [f_slot[0][m] if s == 0 else f_slot[s - 1][m] + 1
                 for m in range(M)]
        for tt in range(n_slots):
            live = sum(1 for m in range(M)
                       if enter[m] <= tt <= b_slot[s][m])
            depth = max(depth, live)
    assert depth <= P + 1, f"stash depth {depth} exceeds pipeline bound"
    measured = 1.0 - (2.0 * M * P) / (P * n_slots)
    return Schedule1F1B(kind=kind, mb=mb, n_slots=n_slots,
                        stash_depth=depth, measured_bubble=measured)


def _gpipe_table(n_stages: int, n_micro: int, op: int, reverse: bool):
    """GPipe's (kind, mb) tables: stage s runs microbatch m at tick
    m + s; the backward's ticks run in reverse."""
    ticks = n_micro + n_stages - 1
    kind = np.full((n_stages, ticks), _IDLE, np.int32)
    mb = np.full((n_stages, ticks), -1, np.int32)
    for s in range(n_stages):
        for m in range(n_micro):
            t = ticks - 1 - (m + s) if reverse else m + s
            kind[s, t], mb[s, t] = op, m
    return kind, mb


class _Stages:
    """This member's place on the stage ring of ``group``."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.stage = dist.get_rank(group)

    def peer(self, stage: int) -> int:
        import torch.distributed as dist
        if self.group is None:
            return stage
        return dist.get_global_rank(self.group, stage)

    def exchange(self, sends, recvs) -> List[torch.Tensor]:
        """Post ``sends`` [(tensor, stage)] and ``recvs`` [(like, stage)]
        in one batch and wait; returns the received tensors."""
        import torch.distributed as dist
        ops, out = [], []
        for t, stage in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.peer(stage), self.group))
        for like, stage in recvs:
            r = torch.empty_like(like, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, r, self.peer(stage),
                                  self.group))
            out.append(r)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out


def _run_table(stages: _Stages, kind, mb, fwd=None, bwd=None, x=None,
               g=None):
    """Run this stage's row of (kind, mb).  ``fwd(m, a_in) -> y`` on a
    forward slot (a_in: ``x[m]`` on stage 0, else the upstream stage's
    y); ``bwd(m, cot) -> da`` on a backward slot (cot: ``g[m]`` on the
    last stage, else the downstream stage's da).  y travels down, da up,
    each posted at the end of its slot with the receives the
    neighbours' ops of that slot imply."""
    P, s = stages.n, stages.stage
    acts, cots = {}, {}
    for t in range(kind.shape[1]):
        k, m = int(kind[s, t]), int(mb[s, t])
        sends = []
        if k == _FWD:
            y = fwd(m, x[m] if s == 0 else acts.pop(m))
            if s < P - 1:
                sends.append((y, s + 1))
        elif k == _BWD:
            da = bwd(m, g[m] if s == P - 1 else cots.pop(m))
            if s > 0:
                sends.append((da, s - 1))
        recvs, into = [], []
        if s > 0 and kind[s - 1, t] == _FWD:
            recvs.append((x[0], s - 1))
            into.append((acts, int(mb[s - 1, t])))
        if s < P - 1 and kind[s + 1, t] == _BWD:
            recvs.append((g[0], s + 1))
            into.append((cots, int(mb[s + 1, t])))
        for (buf, mi), r in zip(into, stages.exchange(sends, recvs)):
            buf[mi] = r
    assert not acts and not cots, "a message was received but not used"


_READY = weakref.WeakSet()      # the stage groups past _first_use


def _first_use(stages: _Stages, device) -> None:
    """A collective over the stage group before its first point-to-point
    batch, once a group: NCCL needs every member in a group's first
    collective call, and a pipeline slot's batch names only neighbours."""
    import torch.distributed as dist
    group = stages.group if stages.group is not None \
        else dist.distributed_c10d._get_default_group()
    if group in _READY:
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group)
    _READY.add(group)


def _detached(leaves, needs):
    return [p.detach().requires_grad_(n) for p, n in zip(leaves, needs)]


def _vjp(stage_fn, leaves, needs, spec, a, cot):
    """(da, d_leaves) of ``stage_fn`` at input ``a``, on a graph built
    here (``a`` and the leaves detached)."""
    a = a.detach().requires_grad_()
    req = _detached(leaves, needs)
    with torch.enable_grad():
        y = stage_fn(pytree.tree_unflatten(req, spec), a)
    return _grads(y, a, req, cot)


def _grads(y, a, req, cot):
    wrt = [a] + [p for p in req if p.requires_grad]
    got = iter(torch.autograd.grad(y, wrt, cot, allow_unused=True))
    da = next(got)
    dps = [next(got) if p.requires_grad else None for p in req]
    return da, dps


def _accumulate(acc, dps):
    for i, d in enumerate(dps):
        if d is not None:
            acc[i] = d if acc[i] is None else acc[i] + d


class _Pipeline(torch.autograd.Function):
    """``stage_fn`` over the stage ring: the GPipe forward; the backward
    is GPipe's reverse ticks (``schedule="gpipe"``; the stage recomputed
    from its stashed input when ``remat``, else from the graph the
    forward kept) or the 1F1B replay (``schedule="1f1b"``)."""

    @staticmethod
    def forward(ctx, stage_fn, stages, schedule, remat, spec, x, *leaves):
        P, s, M = stages.n, stages.stage, x.shape[0]
        keep = schedule == "gpipe" and not remat
        req = _detached(leaves, [p.requires_grad for p in leaves]) \
            if keep else None
        params = pytree.tree_unflatten(req if keep else list(leaves), spec)
        out = torch.zeros_like(x)
        graphs = {}

        def fwd(m, a_in):
            if keep:
                a_in = a_in.detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, a_in)
                graphs[m] = (a_in, y)
            else:
                if schedule == "gpipe":
                    graphs[m] = a_in
                y = stage_fn(params, a_in)
            if s == P - 1:
                out[m] = y
            return y.detach()

        if P > 1:
            _first_use(stages, x.device)
        _run_table(stages, *_gpipe_table(P, M, _FWD, False), fwd=fwd, x=x)
        ctx.stage_fn, ctx.stages, ctx.spec = stage_fn, stages, spec
        ctx.schedule, ctx.keep, ctx.req = schedule, keep, req
        ctx.graphs = graphs if schedule == "gpipe" else None
        ctx.save_for_backward(x, *leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        stages, stage_fn, spec = ctx.stages, ctx.stage_fn, ctx.spec
        needs = ctx.needs_input_grad[6:]
        P, s, M = stages.n, stages.stage, x.shape[0]
        g = g.contiguous()
        dx = torch.zeros_like(x)
        acc: List[Any] = [None] * len(leaves)

        def land(m, da):
            if s == 0:
                dx[m] = da
            return da

        if ctx.schedule == "gpipe":
            graphs = ctx.graphs

            def bwd(m, cot):
                if ctx.keep:
                    a, y = graphs.pop(m)
                    da, dps = _grads(y, a, ctx.req, cot)
                else:
                    da, dps = _vjp(stage_fn, leaves, needs, spec,
                                   graphs.pop(m), cot)
                _accumulate(acc, dps)
                return land(m, da)

            _run_table(stages, *_gpipe_table(P, M, _BWD, True), bwd=bwd,
                       x=x, g=g)
        else:
            sched = build_1f1b_schedule(P, M)
            stash = {}
            req = _detached(leaves, needs)
            params = pytree.tree_unflatten(req, spec)

            def fwd(m, a_in):
                a = a_in.detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, a)
                stash[m] = (a, y)
                assert len(stash) <= sched.stash_depth, (len(stash), sched)
                return y.detach()

            def bwd(m, cot):
                a, y = stash.pop(m)
                da, dps = _grads(y, a, req, cot)
                _accumulate(acc, dps)
                return land(m, da)

            _run_table(stages, sched.kind, sched.mb, fwd=fwd, bwd=bwd, x=x,
                       g=g)
        grads = [a if a is not None else
                 (torch.zeros_like(p) if n else None)
                 for a, p, n in zip(acc, leaves, needs)]
        return (None, None, None, None, None, dx, *grads)


def _apply(stage_fn, stage_params, x_microbatches, axis_name, schedule,
           remat):
    if x_microbatches.shape[0] < 1:
        raise ValueError("need at least one microbatch")
    stages = _Stages(_group_of(axis_name))
    if stages.n == 1 and schedule == "gpipe":
        # One stage: the tick loop is a loop, and autograd differentiates
        # it as it stands.
        fn = stage_fn
        if remat:
            def fn(p, a):
                return torch.utils.checkpoint.checkpoint(
                    stage_fn, p, a, use_reentrant=False)
        return torch.stack([fn(stage_params, a) for a in x_microbatches])
    leaves, spec = pytree.tree_flatten(stage_params)
    return _Pipeline.apply(stage_fn, stages, schedule, remat, spec,
                           x_microbatches, *leaves)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor,
                   axis_name, remat: bool = True) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline over ``axis_name``.

    stage_fn: ``(params_for_this_stage, activation) -> activation``, the
    activation's shape and dtype the same in and out.  stage_params: this
    member's stage parameters (a pytree of tensors).  x_microbatches:
    (n_micro, mb, ...), consumed by stage 0; ``n_micro < n_stages`` is
    legal (the pipeline never fills).  ``axis_name``: a ``mesh()``
    dimension, a process group, or None (the world).  ``remat``:
    rematerialise the stage in the backward.

    Returns (n_micro, mb, ...) outputs, valid on the last stage; other
    stages hold zeros (reduce with :func:`last_stage_mask`)."""
    return _apply(stage_fn, stage_params, x_microbatches, axis_name,
                  "gpipe", remat)


def pipeline_apply_1f1b(stage_fn: Callable[[Any, torch.Tensor],
                                           torch.Tensor],
                        stage_params: Any, x_microbatches: torch.Tensor,
                        axis_name) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline with the 1F1B backward schedule.

    Same contract as :func:`pipeline_apply`, outputs bit-identical to
    GPipe's.  Its backward runs the Megatron 1F1B schedule: at most
    ``build_1f1b_schedule(...).stash_depth`` microbatches' stage graphs
    live at once, at the cost of running every stage forward twice (the
    rematerialisation is inherent, so there is no ``remat`` flag)."""
    return _apply(stage_fn, stage_params, x_microbatches, axis_name,
                  "1f1b", False)


def note_bubble(n_stages: int, n_micro: int, span_seconds: float) -> float:
    """Attribute the bubble share of a measured pipeline span to the
    ``pipeline_bubble`` wall component of the step-attribution engine
    (``hvd_pipeline_bubble_seconds_total``).  Returns the bubble seconds
    credited."""
    bubble = bubble_fraction(n_stages, n_micro) * max(0.0, span_seconds)
    from ..metrics import attribution
    attribution.note_pipeline_bubble(bubble)
    return bubble


def last_stage_mask(axis_name, device=None) -> torch.Tensor:
    """1.0 on the last pipeline stage, 0.0 elsewhere: for masking losses
    computed from ``pipeline_apply`` output before a psum over the axis."""
    import torch.distributed as dist
    group = _group_of(axis_name)
    last = dist.get_rank(group) == dist.get_world_size(group) - 1
    return torch.tensor(float(last), device=device)


def stack_microbatches(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B // n_micro, ...)."""
    if batch.shape[0] % n_micro != 0:
        raise ValueError(
            f"batch {batch.shape[0]} not divisible by {n_micro} microbatches")
    return batch.reshape(n_micro, batch.shape[0] // n_micro,
                         *batch.shape[1:])


def unstack_microbatches(x: torch.Tensor) -> torch.Tensor:
    """(n_micro, mb, ...) -> (n_micro * mb, ...)."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])
