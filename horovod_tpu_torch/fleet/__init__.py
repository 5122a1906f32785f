"""``hvd.fleet`` — fleet service mode (port of horovod_tpu/fleet/): a
multi-tenant job gateway on the elastic fabric.

Instead of one job owning the device fleet from ``hvdrun-torch`` to exit,
an always-on :class:`FleetGateway` owns it: tenants submit job specs
(HTTP, the :mod:`.submit` CLI, or ``hvdrun-torch --submit``) into a
durable queue, and the scheduler multiplexes them onto the inventory by
driving per-job ``ElasticDriver``s — priority + per-tenant quota + fair
share, **checkpoint-mediated preemption** (the victim commits, shrinks
through the existing ``HostsUpdatedInterrupt`` path, and later resumes
bit-identically from its committed step), and SLO-driven admission
control fed by the health plane.  On a GPU host each job holds named
cards (``scheduler.py``'s card sets), so two jobs never share one.
"""

from .client import (cancel_job, default_addr, detect_gateway,
                     get_job, get_observation, list_jobs,
                     list_observed_jobs, push_observation, submit_job,
                     wait_job)
from .gateway import SERVICE_NAME, FleetGateway
from .observe import FleetSeriesStore
from .job import (ACTIVE_STATES, CANCELLED, DENIED, DONE, FAILED,
                  PREEMPTED, PREEMPTING, QUEUED, RUNNING,
                  TERMINAL_STATES, JobRecord, JobSpec)
from .policy import JobView, plan
from .queue import DurableJobQueue
from .scheduler import ElasticJobRunner, Scheduler
from .tuning import (GatewayTuningStore, LocalTuningStore,
                     TuningSchemaMismatch, config_key, make_record,
                     model_fingerprint, resolve_store,
                     topology_signature)

__all__ = [
    "ACTIVE_STATES", "CANCELLED", "DENIED", "DONE", "FAILED",
    "PREEMPTED", "PREEMPTING", "QUEUED", "RUNNING", "TERMINAL_STATES",
    "SERVICE_NAME",
    "DurableJobQueue", "ElasticJobRunner", "FleetGateway",
    "FleetSeriesStore", "JobRecord", "JobSpec", "JobView", "Scheduler",
    "cancel_job", "default_addr", "detect_gateway", "get_job",
    "get_observation", "list_jobs", "list_observed_jobs", "plan",
    "push_observation", "submit_job", "wait_job",
    "GatewayTuningStore", "LocalTuningStore", "TuningSchemaMismatch",
    "config_key", "make_record", "model_fingerprint", "resolve_store",
    "topology_signature",
]
