"""Host and GPU discovery for the launcher: the port's counterpart of
horovod_tpu/runner/tpu_discovery.py (:63-84).

The reference reads a TPU slice's worker inventory from the TPU runtime's
environment (``TPU_WORKER_HOSTNAMES``, ``TPU_ACCELERATOR_TYPE``), then
from the GCE metadata server.  A GPU cluster has neither, so the port
reads:

1. ``HVD_TPU_WORKER_HOSTNAMES`` (comma-separated, in rank order; also
   the test seam);
2. the cards of each host: ``HVD_TPU_CHIPS_PER_HOST`` when set (as in the
   reference), else this host's own count (the hosts of one job are
   alike).

Nothing is fetched: there is no metadata request, the documented
difference from the reference.

The launcher must never touch a device (reference chips.py:36-42), so
the count here does not initialise CUDA: it reads
``CUDA_VISIBLE_DEVICES``, then ``nvidia-smi -L`` (NVML, under a
timeout), then the ``/dev/nvidia[0-9]*`` device files.  The device files
come last because a container may show more of them than it lets CUDA
open (one card's machine showed ``/dev/nvidia0`` and ``/dev/nvidia1``).
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

from .hosts import HostInfo

NVIDIA_SMI_TIMEOUT_S = 10.0


def _visible_entries(value: str) -> List[str]:
    """The devices a ``CUDA_VISIBLE_DEVICES`` value names, in order: CUDA
    stops at the first entry it cannot read (a negative index)."""
    out = []
    for tok in value.split(","):
        tok = tok.strip()
        if not tok or tok.startswith("-"):
            break
        out.append(tok)
    return out


def _nvidia_smi_count() -> Optional[int]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                             timeout=NVIDIA_SMI_TIMEOUT_S)
    except (subprocess.TimeoutExpired, OSError):
        return None
    if out.returncode != 0:
        return None
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def local_devices() -> List[str]:
    """This host's cards as ``CUDA_VISIBLE_DEVICES`` names them (indices,
    or the UUIDs the variable already holds), found without initialising
    CUDA."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return _visible_entries(visible)
    n = _nvidia_smi_count()
    if n is None:
        n = len(glob.glob("/dev/nvidia[0-9]*"))
    return [str(i) for i in range(n)]


def cards_per_host(visible: Optional[List[str]] = None) -> int:
    """``HVD_TPU_CHIPS_PER_HOST`` when set, else this host's count
    (of ``visible`` when the caller already listed the cards)."""
    override = os.environ.get("HVD_TPU_CHIPS_PER_HOST")
    if override:
        try:
            return max(int(override), 0)
        except ValueError:
            pass
    return len(visible if visible is not None else local_devices())


def discover_gpu_hosts() -> Optional[Tuple[List[HostInfo], int]]:
    """Returns (hosts, cards_per_host) of the job's hosts, one slot per
    card (one when a host has none), or None when no host list is
    given."""
    hostnames = os.environ.get("HVD_TPU_WORKER_HOSTNAMES")
    if not hostnames:
        return None
    cph = cards_per_host()
    hosts = [HostInfo(h.strip(), max(cph, 1)) for h in hostnames.split(",")
             if h.strip()]
    return hosts, cph
