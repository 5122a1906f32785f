"""Worker-side elastic rendezvous client (port of
horovod_tpu/runner/worker.py).

On each (re)init an elastic worker fetches its assignment for the current
round from the launcher's rendezvous KV (upstream gloo workers re-run the
HTTPStore rendezvous on reset, gloo_context.cc:71-108).  Workers are
identified by their spawn slot id ("hostname:local_slot"); a worker whose
slot is absent from the current round polls until a round includes it.

A round names two addresses: the native controller's and the
``torch.distributed`` store's the round's world forms on (the port's
counterpart of the reference's per-round JAX coordinator).  Each is
``host:port``, or ``auto:<host>`` when the round's rank-0 host is not
the driver's: the round's rank 0 then probes a free port on its own host
and publishes it under a key of that round (``ctlport.<round>``,
``storeport.<round>``), which its peers poll.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from .rendezvous import http_get, http_put


def rendezvous_addr() -> Optional[str]:
    return os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")


def my_slot_id() -> Optional[str]:
    return os.environ.get("HVD_TPU_ELASTIC_SLOT")


# How long a worker waits for a round that includes it.
ROUND_TIMEOUT_S = 120.0


def fetch_assignment(min_round: int = 0, timeout: float = ROUND_TIMEOUT_S,
                     poll_interval: float = 0.1) -> Dict[str, Any]:
    """Block until a rendezvous round >= min_round includes this worker's
    slot; returns {round, size, controller_addr, store_addr, rank,
    local_rank, ...}.  ``min_round`` keeps a worker that just left a
    failed round from re-joining it before the driver publishes the
    replacement round.  The polling loop is ``net.poll_kv``."""
    from .. import net as _net
    addr = rendezvous_addr()
    slot = my_slot_id()
    if not addr or not slot:
        raise RuntimeError("elastic worker without rendezvous env "
                           "(HVD_TPU_RENDEZVOUS_ADDR / HVD_TPU_ELASTIC_SLOT)")
    deadline = time.time() + timeout
    state = {"last_round": -1}

    def accept(cur: bytes):
        rnd = int(cur.decode())
        if rnd == state["last_round"] or rnd < min_round:
            return None
        state["last_round"] = rnd
        blob = http_get(addr, "elastic", f"round.{rnd}", timeout=5)
        if blob is None:
            return None
        assignment = json.loads(blob.decode())
        mine = assignment["slots"].get(slot)
        if mine is None:
            return None
        return assignment, mine

    try:
        assignment, mine = _net.poll_kv(
            addr, "elastic", "current_round", deadline_s=timeout,
            interval_s=poll_interval, timeout_s=5, accept=accept)
    except _net.DeadlineExceeded:
        raise TimeoutError(
            f"no rendezvous round >= {min_round} included slot {slot} "
            f"within {timeout}s (last round seen: "
            f"{state['last_round']})") from None
    ctl_addr = _resolve_controller_addr(
        addr, assignment, mine, deadline - time.time(), poll_interval)
    store_addr = _resolve_auto_addr(
        addr, assignment, mine, "store_addr", "storeport",
        deadline - time.time(), poll_interval)
    return {
        "round": assignment["round"],
        "size": assignment["size"],
        "controller_addr": ctl_addr,
        "store_addr": store_addr,
        **mine,
    }


def _resolve_auto_addr(rdv_addr: str, assignment: Dict[str, Any],
                       mine: Dict[str, Any], field: str, prefix: str,
                       budget: float, poll_interval: float) -> str:
    """Resolve an ``auto:<host>`` address of the round: its rank-0
    worker probes a free port ON ITS OWN HOST and publishes it under
    ``<prefix>.<round>``; peers poll for it.  The key has one writer and
    belongs to one round: every respawn goes through a fresh driver
    round, so no second incarnation of a round's rank 0 can overwrite it
    after its peers resolved it."""
    value = assignment[field]
    if not value.startswith("auto:"):
        return value
    host = value[len("auto:"):]
    key = f"{prefix}.{assignment['round']}"
    if mine["rank"] == 0:
        from .chips import _free_port
        port = _free_port()
        http_put(rdv_addr, "elastic", key, str(port).encode())
        return f"{host}:{port}"
    from .. import net as _net
    try:
        blob = _net.poll_kv(rdv_addr, "elastic", key,
                            deadline_s=max(budget, 5.0),
                            interval_s=poll_interval, timeout_s=5)
    except _net.DeadlineExceeded:
        raise TimeoutError(
            f"rank 0 never published {key} for round "
            f"{assignment['round']}") from None
    return f"{host}:{int(blob.decode())}"


def _resolve_controller_addr(rdv_addr: str, assignment: Dict[str, Any],
                             mine: Dict[str, Any], budget: float,
                             poll_interval: float) -> str:
    """The round's native controller address (``ctlport.<round>`` when
    the driver published ``auto:<host>``)."""
    return _resolve_auto_addr(rdv_addr, assignment, mine,
                              "controller_addr", "ctlport", budget,
                              poll_interval)


def poll_host_event(last_ts: float) -> Optional[Dict[str, Any]]:
    """Returns the latest host event if newer than last_ts (pull-based
    worker notification; see elastic_driver._publish_host_event)."""
    addr = rendezvous_addr()
    if not addr:
        return None
    blob = http_get(addr, "elastic", "host_event", timeout=5)
    if blob is None:
        return None
    event = json.loads(blob.decode())
    if event.get("ts", 0) > last_ts:
        return event
    return None
