"""Distributed optimizer front-end (port of horovod_tpu/optimizers.py, the
synchronous data-parallel part).

* ``DistributedOptimizer`` wraps a ``torch.optim`` optimizer so that its
  ``step()`` first averages every gradient over the world, then runs the
  inner step.  By default one collective per parameter in parameter order
  after backward: the reference's per-leaf barrier schedule.  With
  ``overlap=`` the gradients move in size-bounded buckets, each launched
  from a post-accumulate-grad hook as soon as backward has completed it
  (``ops.overlap``).  With ``backward_passes_per_step`` = N, N calls of
  ``step()`` accumulate the local gradients and only the Nth communicates
  and updates (reference ``_AggState``, optimizers.py:84-221).
  ``compression=`` puts the gradients on a compressed wire; a quantized
  wire carries an error-feedback residual, as the reference's
  ``_AggState.residual``.  ``op=Adasum`` runs the inner step on the local
  gradients and Adasum-reduces the parameter delta (reference
  optimizers.py:177-183).
* ``ZeroShardedOptimizer``: ZeRO weight-update sharding, stages 1-3
  (reference optimizers.py:277-590); its rank-distinct state is saved and
  restored through the sharded checkpoint engine (``checkpoint/``).
* ``allreduce_gradients``, ``grad``/``value_and_grad``,
  ``broadcast_parameters``, ``broadcast_optimizer_state``,
  ``broadcast_object`` and ``allgather_object`` (reference
  optimizers.py:76, :617-734).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import (Any, Callable, List, Mapping, NamedTuple, Optional,
                    Sequence)

import torch

from .core import config as _cfg
from .ops import collective as C
from .ops import overlap as O
from .ops import quantization as Q
from .ops.compression import NoneCompressor

_tree_map = O._tree_map


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a state dict, a module, (name, tensor) pairs or a
    plain sequence, in order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    out: List[torch.Tensor] = []
    for item in tree:
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[0], str):
            item = item[1]
        out.extend(_tensors(item))
    return out


def _allreduce_tree(tree, op, compression, prescale_factor=1.0,
                    postscale_factor=1.0, axis_name=None):
    """Allreduce every tensor of ``tree`` (reference optimizers.py:38-73).
    A compressible leaf goes through ``allreduce(compression=)`` (the
    two-pass schedule, fp32 accumulation); the others compress →
    allreduce → decompress.  The session compression knob does not reach
    here: the compressor is the caller's, or none."""
    comp = C._resolve_compression(compression, session_default=False) \
        or NoneCompressor

    def one(x):
        if comp is not NoneCompressor and C._compressible(x, op):
            return C.allreduce(x, op, axis_name, prescale_factor,
                               postscale_factor, compression=comp)
        cx, ctx = comp.compress(x)
        red = C.allreduce(cx, op, axis_name, prescale_factor,
                          postscale_factor, compression=NoneCompressor)
        return comp.decompress(red, ctx)

    return _tree_map(one, tree)


def allreduce_gradients(grads, op: int = C.Average, compression=None):
    """Allreduce a tensor, a sequence or a dict of gradients; returns the
    same structure reduced (the reference's pytree in, pytree out)."""
    return _allreduce_tree(grads, op, compression)


def _feed_back(grad: torch.Tensor, residual: torch.Tensor, spec,
               keep_sent: bool = False) -> torch.Tensor:
    """Error feedback on a quantized wire: returns ``grad + residual``, the
    value that goes on the wire.  Unless ``keep_sent`` (the caller then
    sets the residual from what the wire's first pass sent), the residual
    becomes that value less its quantize-dequantize on the flat grid that
    starts at element 0."""
    fed = grad + residual.view_as(grad).to(grad.dtype)
    if not keep_sent:
        f32 = fed.to(torch.float32)
        residual.copy_((f32 - Q.qdq(f32, spec)).reshape(residual.shape))
    return fed


def _quant_spec(compression, op):
    """The quantized wire's spec when its error feedback applies (a lossy
    quantized wire on a Sum/Average reduction), else None.  Cast wires
    round-trip through fp32 accumulation and need no residual."""
    if getattr(compression, "bits", None) is not None and \
            op in (C.Average, C.Sum):
        return compression.spec()
    return None


class DistributedOptimizer:
    """Wrap ``optimizer`` for synchronous data-parallel training.

    Call ``step()`` after every backward pass and zero the gradients after
    it, as with the inner optimizer.  Attribute access other than
    ``step``, ``synchronize``, ``state_dict`` and ``load_state_dict`` goes
    to the inner optimizer (``param_groups``, ``state``, ``zero_grad``...).

    ``axis_name`` is ``None`` (the world) or ``("local", "cross")``, where a
    compressed wire runs the hierarchical schedule.

    ``overlap`` selects the bucketed schedule (``ops.overlap``): ``True``
    buckets at ``HVD_TPU_OVERLAP_BUCKET_BYTES`` (8 MiB), an int is the
    bucket size in bytes, ``None`` defers to the ``HVD_TPU_OVERLAP`` knob,
    ``False`` keeps one collective per parameter (one-parameter buckets,
    launched by ``step()``).  Each bucket's collective starts from the
    hook of its last gradient, asynchronously on the uncompressed wire,
    and ``step()`` waits for them all.  The values are those of the
    per-parameter schedule (error feedback included; see ``ops.overlap``
    on the uncompressed wire's summation order).  A second backward
    before ``step()`` raises, since its buckets have already left.  Not
    applied to ``op=Adasum``, whose reduction is not
    concatenation-invariant.

    ``compression`` (``Compression.{fp16,bf16,int8,int4}`` or a name) is
    taken only from the caller; the ``HVD_TPU_COMPRESSION`` session default
    does not reach the optimizer.  With a quantized wire and Sum/Average,
    each parameter carries an fp32 error-feedback residual r: the step
    communicates g + r and keeps r = (g + r) − Q(g + r), Q the quantizer
    on the flat grid that starts at element 0 (``residual``).  With
    ``backward_passes_per_step`` > 1 the feedback applies on the step that
    communicates, after the 1/N scaling.  ``state_dict()`` carries the
    residual under ``"hvd_residual"`` beside the inner optimizer's state.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 op: int = C.Average, compression=None,
                 backward_passes_per_step: int = 1,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 average_aggregated_gradients: bool = True,
                 overlap=None, axis_name=None):
        C._check_op(op)
        if int(backward_passes_per_step) < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self.op = op
        self.axis = C._check_axis(axis_name)
        self.compression = C._resolve_compression(compression,
                                                  session_default=False)
        self.backward_passes_per_step = int(backward_passes_per_step)
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.average_aggregated_gradients = average_aggregated_gradients
        self._passes = 0
        self._acc: Optional[List[Optional[torch.Tensor]]] = None
        self._quant_spec = _quant_spec(self.compression, op)
        params = self._params()
        self.residual: Optional[List[torch.Tensor]] = None
        if self._quant_spec is not None:
            self.residual = [torch.zeros_like(p, dtype=torch.float32)
                             for p in params]
        # The bucketed schedule and its hooks (never for Adasum), else
        # one-parameter buckets.
        self.bucket_bytes = None if op == C.Adasum else \
            O.resolve_bucket_bytes(overlap)
        self._plan = O.plan_buckets(params, self.bucket_bytes) \
            if self.bucket_bytes else O.per_leaf_plan(len(params))
        self._hooks = None
        self._inflight: list = []
        if self.bucket_bytes:
            self._hooks = O.GradHooks(params, self._plan, self._launch,
                                      self._communicates)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["optimizer"], name)

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def _communicates(self) -> bool:
        """Whether this backward pass is the one ``step()`` communicates."""
        return self._passes == self.backward_passes_per_step - 1

    def _accumulate(self, params, idxs=None) -> None:
        if self._acc is None:
            self._acc = [None] * len(params)
        for i in range(len(params)) if idxs is None else idxs:
            p = params[i]
            if p.grad is None:
                continue
            if self._acc[i] is None:
                self._acc[i] = p.grad.detach().clone()
            else:
                self._acc[i].add_(p.grad)

    def _fold_passes(self, idxs, params) -> None:
        """On the communicating pass of ``backward_passes_per_step`` > 1:
        each parameter's gradient becomes the scaled sum of the passes."""
        if self.backward_passes_per_step == 1:
            return
        self._accumulate(params, idxs)
        scale = 1.0 / self.backward_passes_per_step \
            if self.average_aggregated_gradients else 1.0
        for i in idxs:
            if self._acc[i] is not None:
                params[i].grad = self._acc[i].mul_(scale)

    def _launch(self, b: int) -> None:
        """Start bucket ``b``'s collective (from a hook, or from
        ``synchronize()`` for a bucket the hooks did not launch)."""
        params = self._params()
        self._fold_passes(self._plan.buckets[b], params)
        idxs = [i for i in self._plan.buckets[b]
                if params[i].grad is not None]
        grads = [params[i].grad for i in idxs]
        if not grads:
            return
        keep_sent = False
        if self._quant_spec is not None:
            # The first pass quantizes the fed value itself: what it sent
            # is its qdq, so the residual needs no quantizer of its own.
            keep_sent = self.prescale_factor == 1.0 and self.axis is None
            grads = [_feed_back(g, self.residual[i], self._quant_spec,
                                keep_sent) for i, g in zip(idxs, grads)]
        work, finish = O.issue_bucket_allreduce(
            grads, self.op, self.axis, self.compression,
            self.prescale_factor, self.postscale_factor, keep_sent)
        self._inflight.append((idxs, grads, work, finish))

    def synchronize(self) -> None:
        """Reduce the gradients over the axis, in place (with error
        feedback on a quantized wire), bucket by bucket: launch the buckets
        the hooks did not, then wait on them all."""
        params = self._params()
        launched = () if self._hooks is None else self._hooks.launched
        for b in range(self._plan.n_buckets):
            if b not in launched:
                self._launch(b)
        inflight, self._inflight = self._inflight, []
        if self._hooks is not None:
            self._hooks.reset()
        for idxs, fed, work, finish in inflight:
            work.wait()
            reduced, sent = finish()
            for j, i in enumerate(idxs):
                # A hook's stream may have allocated these: keep their
                # memory until this stream has read them.
                O._record_stream(reduced[j])
                if sent is not None:
                    O._record_stream(fed[j])
                    O._record_stream(sent[j])
                    self.residual[i].copy_(fed[j].to(torch.float32)
                                           - sent[j].view_as(fed[j]))
                params[i].grad.copy_(reduced[j])

    def step(self, closure=None):
        params = self._params()
        bpps = self.backward_passes_per_step
        if bpps > 1 and not self._communicates():
            self._accumulate(params)
            self._passes += 1
            return None  # a skipped step leaves the parameters as they are
        self._passes = 0          # each bucket folds the passes at launch
        if self.op == C.Adasum:
            loss = self._adasum_step(params, closure)
        else:
            self.synchronize()
            loss = self.optimizer.step(closure)
        self._acc = None
        return loss

    def _adasum_step(self, params, closure):
        """The delta model (reference optimizers.py:177-183): the inner
        step on local gradients, then the parameters move by the Adasum of
        every rank's delta.  With ``backward_passes_per_step`` > 1 the
        local gradients are first the scaled sum of the passes, as on the
        other path (reference :200-207)."""
        self._fold_passes(range(len(params)), params)
        with torch.no_grad():
            before = [p.detach().clone() for p in params]
        loss = self.optimizer.step(closure)
        with torch.no_grad():
            for p, p0 in zip(params, before):
                delta = _allreduce_tree(p.detach() - p0, C.Adasum,
                                        self.compression,
                                        axis_name=self.axis)
                p.copy_(p0 + delta)
        return loss

    def state_dict(self) -> dict:
        """The inner optimizer's state dict, plus the error-feedback
        residual (one fp32 tensor per parameter) when there is one."""
        sd = self.optimizer.state_dict()
        if self.residual is not None:
            sd["hvd_residual"] = [r.clone() for r in self.residual]
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore a ``state_dict()``: the residual into this optimizer's,
        the rest into the inner optimizer unchanged."""
        state_dict = dict(state_dict)
        residual = state_dict.pop("hvd_residual", None)
        if residual is not None and self.residual is not None:
            if len(residual) != len(self.residual):
                raise ValueError(
                    f"state dict holds {len(residual)} residuals for "
                    f"{len(self.residual)} parameters")
            for r, saved in zip(self.residual, residual):
                r.copy_(saved)
        self.optimizer.load_state_dict(state_dict)


class _ZeroState(NamedTuple):
    """The GSPMD plane's optimizer state on a compressed wire (reference
    ``optimizers._ZeroState``): ``inner`` the optimizer
    (``ops.gspmd.OptimizerState``), ``sizes`` the parameters' true sizes
    (int32, params-structured), ``residual`` the error-feedback residual
    (params-structured flat fp32, globally world × size, each rank's slice
    its own; None on a cast wire).  The checkpoint engine plans it as the
    reference plans its ``_ZeroState``."""
    inner: Any
    sizes: Any
    residual: Any = None


_ZERO_STAGE_REFUSAL = (
    "ZeRO stage {stage} takes gradient shards, not full gradients: call "
    "reduce_grads() after backward, construct with overlap= so that "
    "backward reduce-scatters them{stage3}; full gradients are taken only "
    "by a quantized wire's error feedback")


_ZERO_CHECKPOINT = (
    "ZeRO state is rank-distinct: its shards cannot travel in one dict.  "
    "Save and restore it through the sharded checkpoint engine: "
    "state_dict(path, step) / load_state_dict(path, step=None), or "
    "horovod_tpu_torch.checkpoint.save_zero_state / restore_zero_state")


class ZeroShardedOptimizer:
    """ZeRO weight-update sharding over the data-parallel axis (reference
    optimizers.py:277-590): each of the N members owns one flat fp32 1/N
    shard of every parameter, and ``optimizer`` (a constructor such as
    ``functools.partial(torch.optim.AdamW, lr=…)``) is built on those
    shards, so its state is 1/N of the replicated optimizer's.  It must be
    elementwise (SGD, Adam, AdamW, RMSprop, ...): it sees only its shard.

    ``params`` is a module, its ``named_parameters()``, or a sequence of
    parameters; they must hold the same values on every member.

    * **Stage 1**: ``step()`` reduce-scatters the full gradients into
      gradient shards, steps the shards, and all-gathers the updated
      shards into the parameters: the replicated optimizer's update.
    * **Stage 2**: the gradient shards are the persistent gradients:
      ``reduce_grads()`` (or, with ``overlap=``, backward's hooks) turns the
      full gradients into shards and drops them.  ``step()`` refuses full
      gradients unless a quantized wire's error feedback needs them.
    * **Stage 3**: the parameters live as the shards.  ``gather_params()``
      rebuilds the full tensors, one all-gather per bucket in forward order
      (``ops.overlap.gather_in_forward``), for a forward through
      ``torch.func.functional_call``; its backward reduce-scatters the
      cotangents, so the gradients arrive as shards.  ``step()`` updates
      the shards and gathers nothing.  The shards are the only copy: when
      the optimizer is built, each parameter of ``params`` gives up its
      storage (it becomes an empty tensor; ``self.params`` keeps meta
      templates of the shapes), so a forward or ``state_dict()`` of the
      module raises or shows empty tensors rather than stale values.

    ``stage`` defaults to ``HVD_TPU_ZERO_STAGE`` (1).  ``axis_name`` is
    ``None`` (the world) or ``("local", "cross")``, over whose joint order
    the shards are dealt.  ``compression`` puts the gradient reduce-scatter
    on the cast or quantized wire (fp32 accumulation); a quantized wire
    keeps a flat fp32 error-feedback residual per parameter (``residual``)
    for gradients reduced from full (stages 1-2, and ``reduce_grads()``);
    stage-3 gradients reduced inside the backward ride it without one.
    ``quantize_gather`` (default ``HVD_TPU_ZERO_QUANT_GATHER``, off) also
    puts the stage-3 gather on that wire.  ``overlap`` (as for
    ``DistributedOptimizer``) reduce-scatters bucket by bucket from
    backward's hooks (stages 1-2) and sizes the stage-3 gather's buckets;
    ``HVD_TPU_ZERO_PREFETCH=0`` makes that gather one bucket.
    """

    def __init__(self, params, optimizer: Callable, op: int = C.Average,
                 axis_name=None, compression=None, overlap=None,
                 stage: Optional[int] = None,
                 quantize_gather: Optional[bool] = None):
        if op not in (C.Sum, C.Average):
            raise ValueError("ZeroShardedOptimizer reduces with Sum or "
                             f"Average, got op {int(op)}")
        stage = _cfg.zero_stage() if stage is None else int(stage)
        if stage not in (1, 2, 3):
            raise ValueError(f"ZeRO stage must be 1, 2 or 3, got {stage}")
        if isinstance(params, torch.nn.Module):
            params = params.named_parameters()
        params = list(params)
        self.names = None
        if params and isinstance(params[0], tuple):
            self.names = [n for n, _ in params]
            params = [p for _, p in params]
        self.params: List[torch.nn.Parameter] = params
        self.stage, self.op = stage, op
        self.axis = C._check_axis(axis_name)
        self.world = len(C._axis_ranks(self.axis))
        self.index = C._axis_index(self.axis)
        self.compression = C._resolve_compression(compression,
                                                  session_default=False)
        self.quantize_gather = _cfg.zero_quant_gather() \
            if quantize_gather is None else bool(quantize_gather)
        self.bucket_bytes = O.resolve_bucket_bytes(overlap)
        with torch.no_grad():
            self.shards = [torch.nn.Parameter(self._my_shard(p))
                           for p in params]
        self.optimizer = optimizer(self.shards)
        self._quant_spec = _quant_spec(self.compression, op)
        self.residual: Optional[List[torch.Tensor]] = None
        if self._quant_spec is not None:
            self.residual = [torch.zeros(p.numel(), dtype=torch.float32,
                                         device=p.device) for p in params]
        if stage == 3:
            # Only shape and dtype are needed now (the gather's templates).
            self.params = [torch.empty_like(p, device="meta")
                           for p in params]
            for p in params:
                p.data = p.data.new_empty(0)
        plan = O.plan_buckets(self.params, self.bucket_bytes) \
            if self.bucket_bytes else O.per_leaf_plan(len(params))
        self._plan = plan
        self._reduced: set = set()   # parameters reduced this pass
        self._hooks = None
        if self.bucket_bytes and stage < 3:
            self._hooks = O.GradHooks(
                params, plan, lambda b: self._scatter(plan.buckets[b]))

    def __getattr__(self, name: str) -> Any:
        return getattr(self.__dict__["optimizer"], name)

    def _my_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This member's flat fp32 shard of ``x``: row ``index`` of its
        zero-padded ravel viewed as (world, ceil(n / world))."""
        return O._rows_of(x.detach().float(), self.world)[self.index].clone()

    def _scatter(self, idxs: Sequence[int],
                 grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        """Reduce-scatter the full local gradients of parameters ``idxs``
        (``grads``, else their ``.grad``) into the shards' ``.grad``: one
        exchange for the lot, error feedback first on a quantized wire.
        From stage 2 the full gradients are dropped."""
        if grads is None:
            idxs = [i for i in idxs if self.params[i].grad is not None
                    and i not in self._reduced]
            grads = [self.params[i].grad for i in idxs]
        if not idxs:
            return
        self._reduced.update(idxs)
        grads = list(grads)
        if self.residual is not None:
            # The flat qdq of each gradient: its blocks are those of the
            # flat grid, an approximation of the per-row grids of the
            # reduce-scatter (reference optimizers.py:479-494).
            grads = [_feed_back(g, self.residual[i], self._quant_spec)
                     for i, g in zip(idxs, grads)]
        shards = O.bucket_reducescatter(grads, self.op, self.axis,
                                        self.compression)
        for i, g in zip(idxs, shards):
            self.shards[i].grad = g.to(torch.float32)
            if self.stage >= 2:
                self.params[i].grad = None

    def _grads_are_full(self, grads: Sequence[torch.Tensor]) -> bool:
        """Whether ``grads`` are full local gradients rather than flat
        shards (reference optimizers.py:496-510): any leaf not 1-D is full;
        at world 1 a 1-D tree is taken as shards (the two are identical);
        else it is full iff every leaf has its parameter's true size."""
        if any(g.dim() != 1 for g in grads):
            return True
        if self.world == 1:
            return False
        return len(grads) == len(self.params) and all(
            g.numel() == p.numel() for g, p in zip(grads, self.params))

    def reduce_grads(self) -> None:
        """Turn the parameters' full local gradients into gradient shards
        (the bucket plan's exchanges); a no-op for what backward's hooks
        already reduced."""
        for idxs in self._plan.buckets:
            self._scatter(idxs)

    def gather_params(self, prefetch: Optional[bool] = None):
        """The full parameters from the shards, differentiable: their
        backward leaves gradient shards on ``shards``.  A dict by
        parameter name when ``params`` was named (ready for
        ``torch.func.functional_call``), else a list."""
        full = O.gather_in_forward(
            self.shards, self.params, self.op, self.axis, self.compression,
            bucket_bytes=self.bucket_bytes, prefetch=prefetch,
            quantize_gather=self.quantize_gather)
        return full if self.names is None else dict(zip(self.names, full))

    def _gather_updates(self) -> None:
        """Stages 1-2: all-gather the updated shards into the replicated
        parameters."""
        with torch.no_grad():
            for idxs in self._plan.buckets:
                fulls = O.bucket_allgather([self.shards[i] for i in idxs],
                                           [self.params[i] for i in idxs],
                                           self.axis)
                for i, full in zip(idxs, fulls):
                    self.params[i].copy_(full)

    def step(self, closure=None,
             grads: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """One update.  The gradients are the shards' ``.grad`` (reduced by
        ``reduce_grads()``, the hooks or stage 3's backward) and, for
        parameters not reduced yet, their full ``.grad``; or ``grads``, one
        per parameter, full local gradients or flat shards."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        n = len(self.params)
        if grads is not None:
            grads = list(grads)
            if self.stage == 1 or self._grads_are_full(grads):
                full_idx, full = list(range(n)), grads
            else:
                full_idx, full = [], []
                for s, g in zip(self.shards, grads):
                    if g.shape != s.shape:
                        raise ValueError(
                            f"ZeRO stage {self.stage} takes flat shards of "
                            f"shape {tuple(s.shape)}, got {tuple(g.shape)}")
                    s.grad = g.to(torch.float32)
        else:
            full_idx = [i for i, p in enumerate(self.params)
                        if p.grad is not None and i not in self._reduced]
            full = [self.params[i].grad for i in full_idx]
        if full_idx and self.stage >= 2 and self.residual is None:
            raise ValueError(_ZERO_STAGE_REFUSAL.format(
                stage=self.stage, stage3=", or differentiate through "
                "gather_params()" if self.stage == 3 else ""))
        by_index = dict(zip(full_idx, full))
        for idxs in self._plan.buckets:
            mine = [i for i in idxs if i in by_index]
            self._scatter(mine, [by_index[i] for i in mine])
        if self.stage < 3:
            # The replicated parameters are the truth at stages 1-2.
            with torch.no_grad():
                for p, s in zip(self.params, self.shards):
                    s.copy_(self._my_shard(p))
        self.optimizer.step()
        if self.stage < 3:
            self._gather_updates()
        self._new_pass()
        for s in self.shards:
            s.grad = None
        return loss

    def _new_pass(self) -> None:
        self._reduced.clear()
        if self._hooks is not None:
            self._hooks.reset()

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the full gradients and the shard gradients."""
        self._new_pass()
        for t in list(self.params) + list(self.shards):
            if set_to_none:
                t.grad = None
            elif t.grad is not None:
                t.grad.zero_()

    def state_dict(self, path: Optional[str] = None,
                   step: Optional[int] = None, keep: Optional[int] = None,
                   extra: Optional[dict] = None,
                   params_path: Optional[str] = None):
        """Write one committed step of this optimizer's state through the
        sharded checkpoint engine (reference ``ZeroGradientTransformation.
        state_dict``, optimizers.py:252-262): every member writes its
        shard under ``path``, rank 0 commits the manifest last; call it on
        every rank.  At stage 3 the parameter shards go to a root of their
        own at the same step, ``params_path`` (default ``<path>-params``),
        written first: the optimizer root's manifest commits the pair, so
        its newest step always has its parameters.  ``keep`` retains the
        newest steps; ``extra`` rides the manifest (the loaders' state
        under ``checkpoint.DATA_ITERS_KEY``).  Returns the optimizer
        state's manifest.

        Called without ``path`` and ``step`` (torch's idiom) it raises
        ``TypeError``: rank-distinct shards cannot travel in one dict."""
        if path is None or step is None:
            raise TypeError(_ZERO_CHECKPOINT)
        from . import checkpoint as ckpt
        if self.stage < 3:
            return ckpt.save_zero_state(path, self, step, keep=keep,
                                        extra=extra)
        proot = self._params_root(path, params_path)
        if self.index == 0 and ckpt.is_committed(proot, step) \
                and not ckpt.is_committed(path, step):
            # The parameters of a save that died before its optimizer
            # step: no pair holds them, so this save replaces them.
            shutil.rmtree(ckpt.step_dir(proot, step))
        if self.world > 1:
            C.barrier()
        ckpt.save_zero_state(proot, ckpt.ShardedParams(self), step)
        manifest = ckpt.save_zero_state(path, self, step, keep=keep,
                                        extra=extra)
        if keep is not None and self.index == 0:
            ckpt.gc_steps(proot, keep=keep)
        return manifest

    def load_state_dict(self, path, step: Optional[int] = None,
                        params_path: Optional[str] = None):
        """Restore the newest committed step under ``path`` (or ``step``)
        in place, resharded for this world (reference
        ``load_state_dict``, optimizers.py:264-271): the inner optimizer's
        state (its shard tensors keep their identity), the residual and,
        at stage 3, the parameter shards from ``params_path`` (default
        ``<path>-params``; the newest step is then the newest committed
        under both roots, and a step missing from either is refused before
        any tensor changes).  Returns the restored step's manifest, whose
        ``extra`` holds what ``state_dict`` stamped there.  A dict
        (torch's idiom) raises ``TypeError``."""
        if not isinstance(path, (str, os.PathLike)):
            raise TypeError(_ZERO_CHECKPOINT)
        from . import checkpoint as ckpt
        roots = [path]
        if self.stage == 3:
            roots.append(self._params_root(path, params_path))
        if step is None:
            common = set.intersection(*(set(ckpt.list_steps(r))
                                        for r in roots))
            if not common:
                raise FileNotFoundError(
                    "no checkpoint step committed under "
                    + " and ".join(map(str, roots)))
            step = max(common)
        for r in roots:
            if not ckpt.is_committed(r, step):
                raise FileNotFoundError(
                    f"step {step} is not committed under {r}")
        ckpt.restore_zero_state(path, self, step)
        if self.stage == 3:
            ckpt.restore_zero_state(roots[1], ckpt.ShardedParams(self), step)
        return ckpt.read_manifest(path, step)

    @staticmethod
    def _params_root(path, params_path) -> str:
        """Stage 3's parameter root: ``params_path``, else beside
        ``path``."""
        return params_path if params_path is not None else \
            os.path.normpath(os.fspath(path)) + "-params"


# ---------------------------------------------------------------------------
# Gradient-tape analog: functional transforms (reference :617-658)
# ---------------------------------------------------------------------------

def _grad_fn(fun: Callable, op, compression, argnums: int,
             overlap) -> Callable:
    # An explicit opt-in (True or bucket bytes): the transform does not
    # follow the HVD_TPU_OVERLAP session default (reference :617-628).
    bucket_bytes = O.resolve_bucket_bytes(overlap) if overlap else None

    def value_and_grads(*args, **kwargs):
        args = list(args)
        leaves: List[torch.Tensor] = []

        def leaf(t):
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t

        tree = args[argnums] = _tree_map(leaf, args[argnums])
        with torch.enable_grad():
            if bucket_bytes:
                # Each bucket's allreduce runs inside the backward
                # (reference _overlap_fun, :597-615).
                args[argnums] = O.sync_in_backward(
                    tree, op, compression=compression,
                    bucket_bytes=bucket_bytes)
            value = fun(*args, **kwargs)
            grads = O._tree_replace(tree,
                                    torch.autograd.grad(value, leaves))
        if not bucket_bytes:
            grads = _allreduce_tree(grads, op, compression)
        return value.detach(), grads
    return value_and_grads


def grad(fun: Callable, op: int = C.Average, compression=None,
         argnums: int = 0, overlap=None) -> Callable:
    """``fun``'s gradient with respect to ``args[argnums]`` (a tensor, a
    sequence or a dict of tensors), allreduced — the functional
    ``DistributedGradientTape``.  ``fun`` returns a scalar tensor.
    ``overlap`` (``True`` or bucket bytes) reduces the gradients bucket by
    bucket inside the backward (``ops.overlap.sync_in_backward``); the
    values are those of the per-tensor reduction."""
    vg = _grad_fn(fun, op, compression, argnums, overlap)
    return lambda *args, **kwargs: vg(*args, **kwargs)[1]


def value_and_grad(fun: Callable, op: int = C.Average, compression=None,
                   argnums: int = 0, overlap=None) -> Callable:
    """As :func:`grad`, returning ``(value, grads)``; the value is this
    rank's, detached."""
    return _grad_fn(fun, op, compression, argnums, overlap)


# ---------------------------------------------------------------------------
# Parameter / object broadcast (reference functions.py)
# ---------------------------------------------------------------------------

def broadcast_parameters(params, root_rank: int = 0):
    """Overwrite parameters in place with the root's values.  ``params`` is
    a module, a state dict, (name, tensor) pairs or a sequence of tensors;
    it is returned."""
    with torch.no_grad():
        for t in _tensors(params):
            C.broadcast_(t, root_rank)
    return params


def _wraps_zero(optimizer) -> bool:
    """Whether ``optimizer`` is a ``ZeroShardedOptimizer`` or wraps one
    through its ``optimizer`` attributes."""
    while optimizer is not None:
        if isinstance(optimizer, ZeroShardedOptimizer):
            return True
        # __dict__, not getattr: ZeroShardedOptimizer forwards attributes.
        optimizer = getattr(optimizer, "__dict__", {}).get("optimizer")
    return False


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Overwrite the tensors of an optimizer's state in place with the
    root's (every rank must hold the same state structure — call it before
    the first step or after one).  Tensors that live off the communicator's
    device (AdamW's ``step`` counts on the CPU) travel through it.

    ZeRO state is rank-distinct and refused with ``ValueError``, as the
    reference refuses it (optimizers.py:674-690): it goes through the
    sharded checkpoint engine instead."""
    if _wraps_zero(optimizer):
        raise ValueError(
            "broadcast_optimizer_state on ZeroShardedOptimizer state "
            "would overwrite rank-distinct shards with rank 0's slice; "
            "use the sharded checkpoint engine instead — "
            "horovod_tpu_torch.checkpoint.save_zero_state / "
            "restore_zero_state (or the optimizer's state_dict(path, step) "
            "/ load_state_dict(path) hooks), which writes per-rank shards "
            "and reshards on restore when the world size changed")
    from .core.state import global_state
    opt = getattr(optimizer, "optimizer", optimizer)
    dev = global_state.device
    with torch.no_grad():
        for p in [p for g in opt.param_groups for p in g["params"]]:
            st = opt.state.get(p, {})
            for key in sorted(st):
                val = st[key]
                if not isinstance(val, torch.Tensor):
                    continue
                if val.device == dev:
                    C.broadcast_(val, root_rank)
                else:
                    val.copy_(C.broadcast_(val.to(dev), root_rank))
    return optimizer


def _world() -> int:
    from .core.basics import size
    return size()


def _bytes_tensor(payload: bytes) -> torch.Tensor:
    from .core.basics import device
    return torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(
        device())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None):
    """Pickle-based object broadcast (reference functions.py
    broadcast_object): the length first, then the payload, both as uint8
    tensors on the communicator's device.  Unpickles what the root sent,
    so every rank must trust the root."""
    del name
    if _world() == 1:
        return obj
    from .core.basics import device, rank
    if rank() == root_rank:
        buf = _bytes_tensor(pickle.dumps(obj))
        length = torch.tensor([buf.numel()], dtype=torch.int64,
                              device=device())
    else:
        buf = None
        length = torch.zeros(1, dtype=torch.int64, device=device())
    C.broadcast_(length, root_rank)
    if buf is None:
        buf = torch.empty(int(length.item()), dtype=torch.uint8,
                          device=device())
    C.broadcast_(buf, root_rank)
    return pickle.loads(buf.cpu().numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> list:
    """Gather a picklable object from every member into a list, in rank
    order."""
    del name
    if _world() == 1:
        return [obj]
    payload = _bytes_tensor(pickle.dumps(obj))
    sizes = C.allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=payload.device)).tolist()
    gathered = C.allgather(payload).cpu().numpy()
    out, off = [], 0
    for s in sizes:
        out.append(pickle.loads(gathered[off: off + s].tobytes()))
        off += s
    return out
