"""Launcher port probe (port of ``_free_port`` of
horovod_tpu/runner/chips.py:148-160).

The reference's module plans how each host's workers share its TPU
chips (exclusive, a per-slot partition, or CPU-pinned workers).  Its
CUDA counterpart, a per-slot ``CUDA_VISIBLE_DEVICES`` plan, is not
ported yet: an elastic worker takes ``cuda:local_rank`` as ``init()``
does.  Only the free-port probe the elastic driver publishes per round
lives here.
"""

from __future__ import annotations


def _free_port() -> int:
    """Probe a free port on the launcher.  Authoritative on localhost
    launches minus a close->bind race; for a remote host an ephemeral
    port is merely unlikely to be taken there."""
    import socket
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port
