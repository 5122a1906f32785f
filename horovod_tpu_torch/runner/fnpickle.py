"""Shared fn-shipping protocol of the programmatic launcher (port of
horovod_tpu/runner/fnpickle.py): ``runner.run`` with ``hosts=``
cloudpickles {fn, args, kwargs} into a work dir every host can see;
workers run it and drop finalized ``rank_N.pkl`` results (tmp-file +
atomic rename, so a worker killed mid-write leaves only an orphaned
``.tmp`` the collector ignores).  ``cloudpickle`` ships ``fn`` by value,
closures included, as in the reference; the GPU machines the port runs
on have it."""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, List, Tuple


def dump_payload(work_dir: str, fn: Callable, args: tuple,
                 kwargs: dict) -> Tuple[str, str]:
    """Returns (payload_path, results_dir) under ``work_dir``."""
    import cloudpickle
    payload_path = os.path.join(work_dir, "payload.pkl")
    results_dir = os.path.join(work_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    # Purge leftovers from a reused work_dir: stale rank_N.pkl files from
    # a previous (larger) run would be collected as this run's results.
    for name in os.listdir(results_dir):
        if name.endswith(".pkl") or name.endswith(".tmp"):
            try:
                os.remove(os.path.join(results_dir, name))
            except OSError:
                pass
    with open(payload_path, "wb") as f:
        cloudpickle.dump({"fn": fn, "args": tuple(args),
                          "kwargs": dict(kwargs)}, f)
    return payload_path, results_dir


def load_payload(payload_path: str) -> dict:
    import cloudpickle
    with open(payload_path, "rb") as f:
        return cloudpickle.load(f)


def write_result(results_dir: str, rank: int, result: Any) -> None:
    tmp = os.path.join(results_dir, f".rank_{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump((rank, result), f)
    os.replace(tmp, os.path.join(results_dir, f"rank_{rank}.pkl"))


def collect_results(results_dir: str) -> List[Any]:
    """Rank-ordered values from finalized result files only (a worker
    killed mid-write — the failure mode elastic exists for — leaves an
    orphaned .tmp behind, which must not crash or duplicate)."""
    results = []
    for name in sorted(os.listdir(results_dir)):
        if not (name.startswith("rank_") and name.endswith(".pkl")):
            continue
        with open(os.path.join(results_dir, name), "rb") as f:
            results.append(pickle.load(f))
    results.sort(key=lambda rv: rv[0])
    return [v for _r, v in results]
