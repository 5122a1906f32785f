"""Worker bootstrap (port of horovod_tpu/runner/bootstrap.py): make the
launch's torch world concrete *before* the user script runs, then exec
it in-process.

In the reference this module also exists because a sitecustomize may pin
JAX's platform through ``jax.config`` at interpreter start, where an env
var is ignored (its ``apply_platform``).  CUDA reads
``CUDA_VISIBLE_DEVICES`` at its first call, so on the card the slot's env
alone reaches the device, and the port has no ``apply_platform``.  What
remains is the world's env contract (``apply_torch_world``, the
reference's ``apply_jax_distributed``): a world whose rank 0 runs on a
remote host has ``MASTER_PORT=auto``, and rank 0 probes a port there and
publishes it through the signed rendezvous KV for its peers.  This
module is the one place that resolves it: the launcher runs a python
command of such a world through it (``chips.wrap_python_command``), and
``init()`` refuses an unresolved ``auto``, so a world with a remote rank
0 needs a python command, not a shell wrapper.  A launcher-declared
world that fails to form is fatal: a worker falling back to a world of
one would reduce over the wrong world while its peers hang.

The reference's ``teardown_jax_world``/``rebuild_jax_world`` re-form an
elastic worker's JAX world between rounds.  The port has no counterpart
here: ``init()``'s elastic branch forms each round's torch world on the
round's store, and ``shutdown()`` takes the old one down
(core/basics.py).

Env contract (set by the launcher, see runner/chips.py):
  HVD_TPU_WORKER_PLATFORM      "cpu" | unset (the slot's cards)
  CUDA_VISIBLE_DEVICES         the slot's cards ("" on a CPU slot)
  MASTER_ADDR / MASTER_PORT    the torch world's store ("auto" port above)
"""

from __future__ import annotations

import os
import runpy
import sys

# The KV key of the store port a remote rank 0 publishes.
WORLD_PORT_KEY = "torch_world_port"
WORLD_PORT_TIMEOUT_S = 120.0


def apply_torch_world(timeout_s: float = WORLD_PORT_TIMEOUT_S) -> None:
    """Resolve ``MASTER_PORT=auto``: rank 0 probes a free port on its own
    host and publishes it under ``global/torch_world_port`` of the
    rendezvous KV; its peers poll for it.  Raises when the world cannot
    be resolved."""
    if os.environ.get("MASTER_PORT") != "auto":
        return
    from .. import net as _net
    from .rendezvous import http_put
    rdv = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not rdv:
        raise RuntimeError("MASTER_PORT=auto needs the launcher's "
                           "rendezvous (HVD_TPU_RENDEZVOUS_ADDR)")
    rank = int(os.environ.get("HVD_TPU_RANK",
                              os.environ.get("HOROVOD_RANK", "0")))
    if rank == 0:
        from .chips import _free_port
        port = str(_free_port())
        if not http_put(rdv, "global", WORLD_PORT_KEY, port.encode()):
            raise RuntimeError(f"cannot publish the torch world's port "
                               f"to the rendezvous at {rdv}")
    else:
        try:
            port = _net.poll_kv(rdv, "global", WORLD_PORT_KEY,
                                deadline_s=timeout_s).decode()
        except _net.DeadlineExceeded:
            raise RuntimeError(
                f"rank 0 never published the torch world's port within "
                f"{timeout_s:.0f}s") from None
    os.environ["MASTER_PORT"] = port


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    try:
        apply_torch_world()
    except Exception as e:  # noqa: BLE001 — fatal, named
        print(f"[hvd_tpu bootstrap] the launcher's torch world cannot "
              f"form: {e}", file=sys.stderr)
        raise SystemExit(1)
    if not argv:
        return 0
    if argv[0] == "-m":
        if len(argv) < 2:
            print("bootstrap: -m requires a module name", file=sys.stderr)
            return 2
        sys.argv = argv[1:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    elif argv[0] == "-c":
        if len(argv) < 2:
            print("bootstrap: -c requires a command", file=sys.stderr)
            return 2
        sys.argv = ["-c"] + argv[2:]
        exec(compile(argv[1], "<string>", "exec"),  # noqa: S102
             {"__name__": "__main__", "__builtins__": __builtins__})
    else:
        sys.argv = argv
        runpy.run_path(argv[0], run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
