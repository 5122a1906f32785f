"""Build and load the port's native runtime (``native/src``).

The sources are the port's own copy of the reference's C++ runtime; the
Makefile beside them compiles them with ``g++ -O3 -fPIC -std=c++17
-pthread`` and links ``-lrt``.  The library goes into
``horovod_tpu_torch/_build/native/``, keyed by a hash of the sources and
the Makefile (which holds the flags), so an unchanged checkout reuses it
and nothing is ever written beside the sources.  The first user builds it
under an ``fcntl`` lock into a fresh directory and renames the library
into place, so concurrent processes (test workers, ranks) build it once.
A failed build raises: there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

from ..ops._build import BUILD_DIR as _PORT_BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(_PORT_BUILD_DIR, "native")
LIB = "libhvdtpu_core"


class BuildError(RuntimeError):
    """make or g++ is missing, or refused a source."""


def _inputs():
    return sorted(f for f in os.listdir(SRC)
                  if f.endswith((".cc", ".h")) or f == "Makefile")


def digest() -> str:
    h = hashlib.sha256()
    for name in _inputs():
        h.update(name.encode() + b"\0")
        with open(os.path.join(SRC, name), "rb") as f:
            h.update(f.read())
    h.update((os.environ.get("CXX") or "g++").encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"{LIB}-{digest()}.so")


def build() -> str:
    """The library's path, built first unless it is current."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):        # another process built it meanwhile
            return out
        make = shutil.which("make")
        if make is None:
            raise BuildError("make not found; the native runtime is built "
                             "from native/src at first use")
        tmp = tempfile.mkdtemp(dir=BUILD_DIR)
        try:
            proc = subprocess.run(
                [make, "-j", str(os.cpu_count() or 1), "-C", SRC,
                 f"OUT={tmp}"], capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(f"building native/src failed (rc "
                                 f"{proc.returncode}):\n"
                                 f"{proc.stderr[-8000:]}")
            os.replace(os.path.join(tmp, LIB + ".so"), out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out
