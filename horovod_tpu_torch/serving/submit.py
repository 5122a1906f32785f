"""``python -m horovod_tpu_torch.serving.submit`` — the open-loop load
client (port of horovod_tpu/serving/submit.py).

Fires a seeded synthetic workload (Poisson arrivals, mixed
prompt/output lengths — the same :func:`~.loadgen.synthetic_workload`
schedule the tests use) at a running serving replica and prints a
latency summary::

    python -m horovod_tpu_torch.serving.submit --server host:28643 \\
        --requests 50 --rate 5 --prompt-len 8,32 --max-tokens 4,64

Its HTTP helpers (:func:`generate`, :func:`run_load`) are importable.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..core import config as _config
from ..runner.rendezvous import _signature


def _addr(server: Optional[str]) -> str:
    if server:
        return server
    return (_config.serving_addr()
            or f"127.0.0.1:{_config.serving_port()}")


def generate(payload: dict, server: Optional[str] = None,
             secret: Optional[str] = None,
             timeout: float = 120.0) -> dict:
    """POST one /serve/generate request (non-streaming) and return the
    response dict.  A 503 shed comes back as ``{"shed": ...}`` instead
    of raising — open-loop clients must observe sheds, not die on
    them."""
    secret = secret if secret is not None else _config.serving_secret()
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://{_addr(server)}/serve/generate", data=body,
        headers={"Content-Type": "application/json"})
    if secret:
        req.add_header("X-HVD-Signature",
                       _signature(secret, "POST", "serve", "generate",
                                  body))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        if e.code == 503:
            return json.loads(e.read().decode())
        raise


def run_load(schedule: List[Tuple[float, "object"]],
             server: Optional[str] = None,
             secret: Optional[str] = None,
             timeout: float = 120.0) -> Dict[str, dict]:
    """Fire an open-loop schedule (arrival offsets honored with real
    sleeps, one thread per in-flight request) and return per-request
    response dicts keyed by request id."""
    results: Dict[str, dict] = {}
    lock = threading.Lock()
    threads = []
    t0 = time.monotonic()

    def _one(req):
        payload = {
            "id": req.id, "tokens": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "tenant": req.tenant, "priority": req.priority,
            "deadline_s": req.deadline_s,
            "temperature": req.temperature, "seed": req.seed,
            "timeout_s": timeout,
        }
        sent = time.monotonic()
        try:
            out = generate(payload, server=server, secret=secret,
                           timeout=timeout)
        except (urllib.error.URLError, OSError) as e:
            out = {"error": repr(e)}
        out["client_latency_s"] = time.monotonic() - sent
        with lock:
            results[req.id] = out

    for at, req in sorted(schedule, key=lambda ar: ar[0]):
        delay = at - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=_one, args=(req,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout)
    return results


def _pair(text: str) -> Tuple[int, int]:
    lo, _, hi = text.partition(",")
    return int(lo), int(hi or lo)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving.submit",
        description="Open-loop load client for a serving replica.")
    p.add_argument("--server", default=None,
                   help="replica address host:port (default: "
                        "HVD_TPU_SERVING_ADDR, then 127.0.0.1:"
                        "<HVD_TPU_SERVING_PORT>)")
    p.add_argument("--secret", default=None,
                   help="request HMAC secret (default: "
                        "HVD_TPU_SERVING_SECRET)")
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--rate", type=float, default=5.0,
                   help="Poisson arrival rate, requests/second")
    p.add_argument("--prompt-len", type=_pair, default=(8, 32),
                   metavar="LO,HI")
    p.add_argument("--max-tokens", type=_pair, default=(4, 64),
                   metavar="LO,HI")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tenant", default="default")
    p.add_argument("--timeout", type=float, default=120.0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from .loadgen import synthetic_workload
    schedule = synthetic_workload(
        args.seed, args.requests, args.rate,
        prompt_lens=args.prompt_len, output_lens=args.max_tokens,
        vocab=args.vocab, tenants=(args.tenant,))
    results = run_load(schedule, server=args.server, secret=args.secret,
                       timeout=args.timeout)
    from .loadgen import percentile
    done = [r for r in results.values() if "tokens" in r]
    shed = [r for r in results.values() if r.get("shed")]
    ttfts = [r["ttft_s"] for r in done if r.get("ttft_s") is not None]
    summary = {
        "requests": args.requests,
        "completed": len(done),
        "shed": len(shed),
        "errors": args.requests - len(done) - len(shed),
        "ttft_p50_s": percentile(ttfts, 0.50),
        "ttft_p99_s": percentile(ttfts, 0.99),
        "tokens": sum(len(r["tokens"]) for r in done),
    }
    print(json.dumps(summary, indent=1))
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
