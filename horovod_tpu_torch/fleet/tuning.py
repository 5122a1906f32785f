"""Fleet-level tuning memory (port of horovod_tpu/fleet/tuning.py) — the
autotune analog of the response cache (arXiv:1802.05799).

The GP autotuner used to re-derive the same best config from a cold
start on every submission of the same job.  This module persists tuned
configs keyed by::

    (model fingerprint, world size, topology signature)

* **model fingerprint** — the checkpoint engine's leaf-spec sha256
  (``checkpoint.manifest.spec_fingerprint``): world-size-invariant,
  changes exactly when the model/optimizer structure does.  The port
  computes it without JAX over the same key paths: a module or a state
  dict is nested at the dots of its names (``layers.wqkv`` is
  ``['layers']['wqkv']``, as ``checkpoint/zero.py`` names parameters), an
  optimizer or a loader is its ``state_dict()``, and dict keys sort at
  every level, as ``jax.tree_util`` flattens a dict; dtypes are numpy's
  names.  So a record one package stores is found by the other for the
  same model, world and topology.
* **world size** — the process count the config was tuned at (fusion
  thresholds and hierarchical crossovers are world-dependent).
* **topology signature** — local world size plus the probe-built
  dispatch table's content hash (ops/dispatch.py), so a config tuned on
  one schedule regime never seeds a different one.

Two stores speak the same records:

* :class:`LocalTuningStore` — one JSON file with the fleet queue's
  durability discipline (tmp + fsync + rename + dir-fsync), the
  gateway-less fallback (``HVD_TPU_AUTOTUNE_MEMORY_DIR``).
* :class:`GatewayTuningStore` — ``GET/PUT /fleet/tuning/<key>`` on the
  fleet gateway (HMAC-gated like every fleet endpoint, riding the
  hvd.net retry ladder), so resubmitted fleet jobs start warm from a
  durable store the gateway owns.

Every record carries a schema version AND the GP dimension tuple it was
tuned over (``ParameterManager.gp_dims()``): the knob space has grown
twice already (the compression dim was added, then the hierarchical
booleans were rebased to crossover shifts) and a mismatched record is
refused with a pointed :class:`TuningSchemaMismatch` instead of
silently mis-seeding the tuner.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from typing import Optional

SCHEMA_VERSION = 1
_STORE_FILE = "tuned_configs.json"


class TuningSchemaMismatch(RuntimeError):
    """A stored tuned-config record does not match this job's knob
    space (schema version or GP dimension tuple) — warm-starting from
    it would seed coordinates the tuner would misread."""


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _nest(state: dict) -> dict:
    """A flat state dict nested at the dots of its names."""
    out: dict = {}
    for name, value in state.items():
        node = out
        *parents, last = str(name).split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value
    return out


def _plain_tree(x):
    """``x`` as nested dicts, lists and tuples of leaves: a module, or a
    dict whose every value is a tensor (a state dict), nests at the dots;
    anything else with a ``state_dict`` (an optimizer, a loader) is that."""
    import torch
    if isinstance(x, torch.nn.Module):
        return _nest(x.state_dict())
    if isinstance(x, dict):
        if x and all(isinstance(v, torch.Tensor) for v in x.values()):
            return _nest(x)
        return type(x)((k, _plain_tree(v)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_plain_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain_tree(v) for v in x)
    if not isinstance(x, torch.Tensor) and \
            callable(getattr(x, "state_dict", None)):
        return _plain_tree(x.state_dict())
    return x


def model_fingerprint(tree) -> str:
    """Leaf-spec sha256 of a params/optimizer tree — the checkpoint
    engine's run fingerprint (path, dtype, logical size per leaf;
    world-size-invariant, see checkpoint/manifest.py), equal to the
    reference's for the same parameters."""
    import torch
    from ..checkpoint import manifest as M
    from ..checkpoint.zero import _container_children
    specs = []

    def walk(node, path):
        kids = _container_children(node)
        if kids is None:
            if isinstance(node, torch.Tensor):
                shape = tuple(node.shape)
                dtype = str(node.dtype).replace("torch.", "")
            else:
                shape = tuple(getattr(node, "shape", ()) or ())
                dtype = str(getattr(node, "dtype", type(node).__name__))
            size = int(math.prod(shape)) if shape else 1
            specs.append(M.LeafSpec(
                path=path, kind=M.REPLICATED, shape=list(shape),
                dtype=dtype, true_size=size))
            return
        for step, child in kids:
            walk(child, path + step)

    walk(_plain_tree(tree), "")
    return M.spec_fingerprint(specs)


def topology_signature() -> str:
    """The comm-regime half of the key: local world size plus the
    active dispatch table's content hash.  World size is NOT folded in
    here — it is its own key component."""
    parts = []
    from ..core.config import LOCAL_SIZE, get_env
    local = get_env(LOCAL_SIZE)  # honors both knob prefixes
    if local:
        parts.append(f"l{local}")
    try:
        from ..ops import dispatch as _dispatch
        table = _dispatch.active_table()
    except Exception:  # noqa: BLE001 — dispatch plane optional
        table = None
    if table is not None:
        h = hashlib.sha256(table.encode().tobytes()).hexdigest()[:12]
        parts.append(f"t{h}")
    return ".".join(parts) or "flat"


def config_key(fingerprint: str, world: int, topo: str) -> str:
    """The store key for one (model, world, topology) triple."""
    h = hashlib.sha256(
        f"{fingerprint}|{int(world)}|{topo}".encode()).hexdigest()
    return h[:32]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def make_record(config: dict, score: Optional[float] = None,
                dims=()) -> dict:
    """One tuned-config record: the named config, the score it froze
    at, and the knob space it is only valid over."""
    return {
        "schema": SCHEMA_VERSION,
        "dims": list(dims),
        "config": dict(config),
        "score": None if score is None else float(score),
        "updated_at": time.time(),
    }


def check_record(record, dims=None) -> dict:
    """Validate a record against this job's knob space; raises
    :class:`TuningSchemaMismatch` with a pointed message on any
    mismatch.  Returns the record."""
    if not isinstance(record, dict) or \
            not isinstance(record.get("config"), dict):
        raise TuningSchemaMismatch(
            "stored tuned-config record is not a config record "
            f"(got {type(record).__name__})")
    schema = record.get("schema")
    if schema != SCHEMA_VERSION:
        raise TuningSchemaMismatch(
            f"stored tuned-config record has schema {schema!r}, this "
            f"build speaks schema {SCHEMA_VERSION} — refusing to "
            "warm-start from it; delete the record or re-tune cold")
    if dims is not None:
        stored = list(record.get("dims") or [])
        expected = list(dims)
        if stored != expected:
            raise TuningSchemaMismatch(
                f"stored tuned config was tuned over GP dims {stored}, "
                f"but this job's knob space is {expected} — the tuner's "
                "dimensionality changed between runs (it grew a "
                "compression dim, and dispatch-probe mode rebases the "
                "hierarchical dims to shifts), and seeding mismatched "
                "coordinates would silently mis-tune.  Refusing to "
                "warm-start; delete the record or re-tune cold")
    return record


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

class LocalTuningStore:
    """Durable JSON store: ``<dir>/tuned_configs.json`` holding
    ``{key: record}``, written with the fleet queue's tmp + fsync +
    rename + dir-fsync discipline so a torn write is never loadable."""

    def __init__(self, directory: str):
        self._dir = directory
        self._path = os.path.join(directory, _STORE_FILE)
        self._lock = threading.Lock()

    def _load(self) -> dict:
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        configs = data.get("configs")
        return configs if isinstance(configs, dict) else {}

    def _flush(self, configs: dict) -> None:
        os.makedirs(self._dir, exist_ok=True)
        payload = json.dumps({"version": 1, "configs": configs},
                             indent=0).encode()
        tmp = f"{self._path}.tmp.{os.getpid()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, payload)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, self._path)
        try:
            dfd = os.open(self._dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platform without directory fsync

    def get(self, key: str, dims=None) -> Optional[dict]:
        """The stored record for ``key`` (None on miss).  With ``dims``
        the record is validated against that knob space — a mismatch
        raises :class:`TuningSchemaMismatch` rather than returning a
        record that would mis-seed the tuner."""
        with self._lock:
            rec = self._load().get(key)
        if rec is None:
            return None
        if dims is not None:
            check_record(rec, dims)
        return rec

    def put(self, key: str, record: dict) -> dict:
        record = check_record(dict(record))
        with self._lock:
            configs = self._load()
            configs[str(key)] = record
            self._flush(configs)
        return record

    def keys(self):
        with self._lock:
            return sorted(self._load().keys())


class GatewayTuningStore:
    """The same surface over the fleet gateway's HMAC-gated
    ``/fleet/tuning/<key>`` endpoints (requests ride the hvd.net
    rung-1 retry ladder via fleet/client.py)."""

    def __init__(self, addr: Optional[str] = None,
                 secret: Optional[str] = None):
        from .client import default_addr
        self.addr = default_addr(addr)
        self._secret = secret

    def get(self, key: str, dims=None) -> Optional[dict]:
        from .client import _request
        rec = _request("GET", self.addr, f"tuning/{key}",
                       secret=self._secret, none_on_404=True)
        if rec is None:
            return None
        if dims is not None:
            check_record(rec, dims)
        return rec

    def put(self, key: str, record: dict) -> dict:
        from .client import _request
        record = check_record(dict(record))
        return _request("PUT", self.addr, f"tuning/{key}",
                        json.dumps(record).encode(), secret=self._secret)


def resolve_store(addr: Optional[str] = None):
    """The store this job should use: the fleet gateway when one is
    addressed (explicitly or via ``HVD_TPU_FLEET_ADDR`` — fleet-
    submitted jobs carry it), else the local-file fallback under
    ``HVD_TPU_AUTOTUNE_MEMORY_DIR``."""
    from ..core import config as _cfg
    addr = addr or _cfg.fleet_addr()
    if addr:
        return GatewayTuningStore(addr)
    return LocalTuningStore(_cfg.autotune_memory_dir())
