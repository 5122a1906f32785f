"""Service composition — the train→serve loop closed (port of
horovod_tpu/serving/service.py).

:func:`load_params` turns a committed training checkpoint step into a
serving weight tree through the checkpoint engine's streaming read path
(``open_step`` + ``rebuild_restored``, one leaf at a time), so a service
replica's weights are what a training worker would restore from the same
step, by construction.  A step written by either package loads.

:class:`CheckpointWatcher` is the hot-swap half: a daemon thread polls the
checkpoint directory's ``latest_step`` every
``HVD_TPU_SERVING_SWAP_POLL_S``; when the training job commits a newer
step the watcher loads it with the SAME :func:`load_params`, waits for its
host-to-device copies, and parks it on the engine, which applies it
between decode iterations — so a hot swap equals a cold load of that
step.

:class:`ServingService` composes engine + request plane + watcher into
one long-lived replica.  The reference's fleet job kind and autoscaler
come with the port's launcher.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import config as _config
from ..core.basics import DeviceLike, resolve_device
from ..models import transformer as tfm
from .engine import DecodeEngine
from .server import ServingServer

log = logging.getLogger("horovod_tpu_torch.serving")


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def save_params(ckpt_dir: str, params, step: int, **kwargs):
    """Commit a weight tree (a ``Transformer`` or its tensor tree) as one
    checkpoint step, every leaf replicated, as the reference's trainer
    commits its params with ``save_zero_state``; ``kwargs`` go to
    ``checkpoint.save_zero_state`` (``keep``, ``extra``)."""
    from ..checkpoint.zero import save_zero_state
    return save_zero_state(ckpt_dir, tfm._tree(params), int(step), **kwargs)


def load_params(ckpt_dir: str, like, step: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[Any, int]:
    """Load a committed step's weight tree (streaming, mesh-free) onto
    ``device`` (default: the card).

    ``like`` (a ``Transformer`` or a tree, e.g. ``init_params``') supplies
    the structure, shapes and dtypes only; the step is read into fresh
    tensors.  Returns (params, step); the copies to the device are
    complete when it returns.  Raises FileNotFoundError when no committed
    step exists yet."""
    from ..checkpoint import engine as E
    from ..checkpoint.zero import rebuild_restored
    dev = resolve_device(device)
    if step is None:
        step = E.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint step under {ckpt_dir}")
    target = _map_tree(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype),
                       tfm._tree(like))
    with E.open_step(ckpt_dir, int(step), 1) as restored:
        params = rebuild_restored(
            restored, target, source=f"step {step} under {ckpt_dir}")
    params = _map_tree(lambda t: t.to(dev), params)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return params, int(step)


class CheckpointWatcher:
    """Poll a checkpoint dir; park newer committed steps on the engine."""

    def __init__(self, engine: DecodeEngine, ckpt_dir: str, like,
                 poll_s: Optional[float] = None):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.like = like
        self.poll_s = max(0.05, (_config.serving_swap_poll_s()
                                 if poll_s is None else float(poll_s)))
        self.current_step: Optional[int] = (
            engine.params_tag if isinstance(engine.params_tag, int)
            else None)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> Optional[int]:
        """One poll: swap if a newer committed step exists.  Returns
        the step parked on the engine, else None."""
        from ..checkpoint import engine as E
        try:
            latest = E.latest_step(self.ckpt_dir)
        except OSError:
            return None
        if latest is None or latest == self.current_step:
            return None
        try:
            params, step = load_params(self.ckpt_dir, self.like,
                                       step=latest,
                                       device=self.engine.device)
        except (OSError, ValueError) as e:
            log.warning("serving: checkpoint watch failed to load step "
                        "%s from %s: %r", latest, self.ckpt_dir, e)
            return None
        self.engine.swap_params(params, step)
        self.current_step = step
        return step

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-tpu-serving-ckpt-watch",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception as e:  # noqa: BLE001 — the watch survives
                log.warning("serving: checkpoint watch error: %r", e)


class ServingService:
    """One replica: engine + request plane + hot-swap watcher.

    ``checkpoint_dir`` cold-loads its newest committed step (or pass
    ``params=``, a tree or ``Transformer`` on the device to serve on);
    ``device`` is where a loaded step goes (default: the card).
    ``draft_layers`` > 0 drafts speculatively with the serving weights'
    first layers, ``HVD_TPU_SPEC_K`` (else 4) tokens a round."""

    def __init__(self, cfg: tfm.TransformerConfig,
                 checkpoint_dir: Optional[str] = None,
                 params=None, params_tag: Any = "cold",
                 like=None, port: Optional[int] = None,
                 secret: Optional[str] = None,
                 swap_poll_s: Optional[float] = None,
                 watch: bool = True,
                 draft_layers: int = 0,
                 device: DeviceLike = None,
                 **engine_kwargs):
        self.cfg = cfg
        if like is None:
            like = tfm.init_params(cfg, tfm.ParallelConfig(),
                                   torch.Generator().manual_seed(0))
        self.like = like
        if params is None:
            if not checkpoint_dir:
                raise ValueError(
                    "ServingService needs params= or checkpoint_dir=")
            params, params_tag = load_params(checkpoint_dir, like,
                                             device=device)
        if draft_layers > 0 and "draft" not in engine_kwargs:
            # Self-drafting: a layer-prefix of the serving weights
            # proposes SPEC_K tokens per round (exact under greedy, so
            # this is safe to enable from a knob alone — no second
            # checkpoint needed).  An explicit draft= kwarg wins.
            from .speculative import DraftSpec
            engine_kwargs["draft"] = DraftSpec(
                cfg=tfm.draft_config(cfg, draft_layers),
                params=tfm.draft_params_from(params, draft_layers),
                k=min(32, max(1, _config.spec_k() or 4)))
        self.engine = DecodeEngine(cfg, params, params_tag=params_tag,
                                   **engine_kwargs)
        self.server = ServingServer(self.engine, port=port, secret=secret)
        self.watcher = (CheckpointWatcher(self.engine, checkpoint_dir,
                                          like, poll_s=swap_poll_s)
                        if (checkpoint_dir and watch) else None)

    @property
    def port(self) -> int:
        return self.server.port

    def serve(self) -> int:
        port = self.server.serve()
        if self.watcher is not None:
            self.watcher.start()
        return port

    def close(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        self.server.close()

    def status(self) -> Dict[str, Any]:
        s = self.engine.stats()
        s["queue_depth"] = self.server.queue_depth()
        return s
