"""Elastic Spark worker main (port of horovod_tpu/spark/elastic_exec.py),
spawned by spark.run_elastic through the elastic driver: runs the
cloudpickled user function as this rank and drops the (rank, result)
pickle into the shared results directory."""

from __future__ import annotations

import sys

from ..runner.fnpickle import load_payload, write_result


def main(payload_path: str, results_dir: str) -> int:
    payload = load_payload(payload_path)
    result = payload["fn"](*payload["args"], **payload["kwargs"])

    # global_state keeps the last world's topology across the user fn's
    # own shutdown() (GlobalState.reset) — hvd.rank() itself refuses to
    # answer post-shutdown.
    from ..core.state import global_state
    write_result(results_dir, global_state.rank, result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
