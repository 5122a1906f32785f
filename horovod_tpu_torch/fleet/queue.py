"""Durable job queue (port of horovod_tpu/fleet/queue.py) — the
gateway's single source of truth.  Its file is the reference's, byte
for byte, so either package's gateway reloads the other's queue.

One JSON file (``<fleet_dir>/jobs.json``) holds every job record plus
the submission sequence counter.  Writes follow the checkpoint engine's
durability discipline in miniature: serialize to a tmp file, fsync,
rename over the live file, fsync the directory — a torn write is never
loadable, and a gateway restart reloads exactly the committed queue.
Jobs that were RUNNING/PREEMPTING when the previous gateway died are
requeued on load (their workers died with the gateway's drivers; the
entrypoints resume from their checkpoints when rescheduled).
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from typing import Callable, Dict, List, Optional

from .job import (JobRecord, JobSpec, PREEMPTED, PREEMPTING, QUEUED,
                  RUNNING)

_QUEUE_FILE = "jobs.json"
_FORMAT_VERSION = 1


class DurableJobQueue:
    def __init__(self, fleet_dir: str):
        self._dir = fleet_dir
        self._path = os.path.join(fleet_dir, _QUEUE_FILE)
        self._lock = threading.RLock()
        self._jobs: Dict[str, JobRecord] = {}
        self._seq = 0
        os.makedirs(fleet_dir, exist_ok=True)
        self._load()

    # -- durability --------------------------------------------------------

    def _load(self):
        if not os.path.exists(self._path):
            return  # fresh gateway
        try:
            with open(self._path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            # An unreadable-but-present queue must not be silently
            # overwritten by the next flush: sideline it for forensics
            # and say so loudly, then start empty.
            import time
            from ..utils import logging as log
            quarantine = f"{self._path}.unreadable-{int(time.time())}"
            try:
                os.replace(self._path, quarantine)
            except OSError:
                quarantine = "<could not sideline>"
            log.warning(
                "fleet queue %s is unreadable (%r); sidelined to %s and "
                "starting with an empty queue", self._path, e, quarantine)
            return
        self._seq = int(data.get("seq", 0))
        for d in data.get("jobs", []):
            try:
                rec = JobRecord.from_dict(d)
            except (KeyError, TypeError):
                continue  # one corrupt record must not drop the queue
            if rec.state in (RUNNING, PREEMPTING, PREEMPTED):
                # The previous gateway died with this job's driver; its
                # workers are gone.  Requeue — the entrypoint restores
                # from its committed checkpoint when rescheduled.
                rec.state = QUEUED
                rec.np = 0
                rec.resumes += 1
                rec.reason = "requeued after gateway restart"
            self._jobs[rec.id] = rec

    def _flush_locked(self):
        payload = json.dumps({
            "version": _FORMAT_VERSION,
            "seq": self._seq,
            "jobs": [r.to_dict() for r in self._jobs.values()],
        }, indent=0).encode()
        tmp = self._path + ".tmp"
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

    # -- queue API ---------------------------------------------------------

    def submit(self, spec: JobSpec, state: str = QUEUED,
               reason: str = "") -> JobRecord:
        import time
        with self._lock:
            self._seq += 1
            rec = JobRecord(id=uuid.uuid4().hex[:12], spec=spec,
                            state=state, submit_seq=self._seq,
                            submitted_at=time.time(), reason=reason)
            self._jobs[rec.id] = rec
            self._flush_locked()
            return rec

    def get(self, job_id: str) -> Optional[JobRecord]:
        with self._lock:
            return self._jobs.get(job_id)

    def list(self) -> List[JobRecord]:
        with self._lock:
            return sorted(self._jobs.values(), key=lambda r: r.submit_seq)

    def update(self, job_id: str,
               mutate: Callable[[JobRecord], None]) -> Optional[JobRecord]:
        """Apply ``mutate`` to the record under the lock and persist."""
        with self._lock:
            rec = self._jobs.get(job_id)
            if rec is None:
                return None
            mutate(rec)
            self._flush_locked()
            return rec

    def remove(self, job_id: str) -> bool:
        with self._lock:
            if self._jobs.pop(job_id, None) is None:
                return False
            self._flush_locked()
            return True
