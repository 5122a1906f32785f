"""Static function-worker main for the programmatic ``runner.run(fn, ...)``
API when slots span hosts (port of horovod_tpu/runner/fn_exec.py): runs
the pickled user fn as this rank and drops the (rank, result) pickle for
the driver to collect; the transport is the same launcher/slot-env
machinery as the ``hvdrun`` CLI."""

from __future__ import annotations

import os
import sys

from .fnpickle import load_payload, write_result


def main(payload_path: str, results_dir: str) -> int:
    payload = load_payload(payload_path)
    result = payload["fn"](*payload["args"], **payload["kwargs"])
    rank = int(os.environ.get("HVD_TPU_RANK",
                              os.environ.get("HOROVOD_RANK", "0")))
    write_result(results_dir, rank, result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
