"""``python -m horovod_tpu_torch.fleet.submit`` — the tenant-side CLI
(port of horovod_tpu/fleet/submit.py).

Submits a job spec to a running fleet gateway (the alternative surface
is ``hvdrun-torch --submit``, runner/launch.py)::

    python -m horovod_tpu_torch.fleet.submit --gateway host:28642 \\
        --min-np 2 --max-np 8 --priority 5 --tenant research \\
        -- python train.py --model bert

Prints the job id and state; ``--wait`` polls to a terminal state and
exits 0 only on DONE.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import client
from .job import DONE, JobSpec


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.fleet.submit",
        description="Submit a job to the fleet gateway.")
    p.add_argument("--gateway", default=None,
                   help="gateway address host:port (default: "
                        "HVD_TPU_FLEET_ADDR, then 127.0.0.1:"
                        "<HVD_TPU_FLEET_PORT>)")
    p.add_argument("--secret", default=None,
                   help="fleet HMAC secret (default: HVD_TPU_FLEET_SECRET)")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="exact width (sets min-np and max-np together)")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--priority", type=int, default=0,
                   help="higher preempts lower")
    p.add_argument("--tenant", default="default")
    p.add_argument("--name", default="")
    p.add_argument("--checkpoint-dir", default="",
                   help="where the job commits state (resume-from on "
                        "preemption)")
    p.add_argument("--max-queue-s", type=float, default=0.0,
                   help="queue-wait SLO target in seconds (dashboard + "
                        "equal-priority ordering hint)")
    p.add_argument("--kind", default="batch",
                   choices=("batch", "service"),
                   help="'service' marks a long-lived job that never "
                        "completes (a serving replica — "
                        "serving/service.py)")
    p.add_argument("--env", action="append", default=[],
                   metavar="KEY=VALUE", help="worker env (repeatable)")
    p.add_argument("--wait", action="store_true",
                   help="block until the job reaches a terminal state")
    p.add_argument("--wait-timeout", type=float, default=3600.0)
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command (e.g. python train.py)")
    args = p.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        p.error("no worker command given")
    return args


def build_spec(args: argparse.Namespace) -> JobSpec:
    env = {}
    for kv in args.env:
        key, sep, value = kv.partition("=")
        if not sep:
            raise SystemExit(f"--env expects KEY=VALUE, got {kv!r}")
        env[key] = value
    min_np = args.min_np if args.min_np is not None else \
        (args.num_proc or 1)
    max_np = args.max_np if args.max_np is not None else args.num_proc
    return JobSpec(command=list(args.command), min_np=min_np,
                   max_np=max_np, priority=args.priority,
                   tenant=args.tenant, name=args.name, env=env,
                   checkpoint_dir=args.checkpoint_dir,
                   max_queue_s=args.max_queue_s, kind=args.kind)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    spec = build_spec(args)
    rec = client.submit_job(spec, addr=args.gateway, secret=args.secret)
    print(f"job {rec.id}: {rec.state}"
          + (f" ({rec.reason})" if rec.reason else ""))
    if rec.state != "queued":
        return 0 if rec.state == DONE else 1
    if not args.wait:
        return 0
    rec = client.wait_job(rec.id, addr=args.gateway, secret=args.secret,
                          timeout=args.wait_timeout)
    print(f"job {rec.id}: {rec.state}"
          + (f" ({rec.reason})" if rec.reason else ""))
    return 0 if rec.state == DONE else 1


if __name__ == "__main__":
    sys.exit(main())
