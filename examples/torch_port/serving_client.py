"""Serving-plane walkthrough on the port (the counterpart of
examples/serving_client.py): stand up one replica, fire an open-loop
load at it, and watch a weight hot-swap.

    python examples/torch_port/serving_client.py
    python examples/torch_port/serving_client.py --device cpu

Against an already-running replica, use the load-client CLI instead::

    python -m horovod_tpu_torch.serving.submit --server host:port \
        --requests 50 --rate 5
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.serving import (ServingService,  # noqa: E402
                                       save_params, synthetic_workload)
from horovod_tpu_torch.serving.submit import generate, run_load  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu to serve on the CPU")
    args = ap.parse_args()

    hvd.init(device=args.device)
    dev = hvd.device()
    cfg = tfm.TransformerConfig(
        vocab_size=128, d_model=args.d_model, n_heads=4,
        d_ff=4 * args.d_model, n_layers=args.layers, seq_len=128,
        dtype=torch.float32, remat=False)
    params = tfm.init_params(cfg, tfm.ParallelConfig(),
                             torch.Generator().manual_seed(0))

    with tempfile.TemporaryDirectory(prefix="hvd_serving_demo_") as ckpt:
        # "Training" commits a step; the service cold-loads it.
        save_params(ckpt, params, step=1)
        service = ServingService(cfg, checkpoint_dir=ckpt, port=0,
                                 swap_poll_s=0.2, slots=4, page_tokens=16,
                                 device=dev)
        port = service.serve()
        addr = f"127.0.0.1:{port}"
        print(f"replica at {addr}, weights step {service.engine.params_tag}")
        try:
            # One interactive request...
            out = generate({"tokens": [3, 1, 4, 1, 5], "max_new_tokens": 8},
                           server=addr)
            print("one request:", json.dumps(out))
            # ...then a seeded open-loop schedule.
            schedule = synthetic_workload(seed=0, n=args.requests,
                                          rate_rps=20.0, prompt_lens=(4, 16),
                                          output_lens=(4, 16),
                                          vocab=cfg.vocab_size)
            results = run_load(schedule, server=addr, timeout=60.0)
            done = [r for r in results.values() if "tokens" in r]
            print(f"open-loop: {len(done)}/{len(results)} completed; "
                  f"status {json.dumps(service.status())}")
            # The trainer commits a newer step: the watcher hot-swaps it
            # between decode iterations.
            save_params(ckpt, {k: (v * 1.01 if torch.is_tensor(v) else
                                   {n: t * 1.01 for n, t in v.items()})
                               for k, v in params.items()}, step=2)
            deadline = time.monotonic() + 10
            while service.engine.params_tag != 2 and \
                    time.monotonic() < deadline:
                generate({"tokens": [3, 1, 4], "max_new_tokens": 2},
                         server=addr)
                time.sleep(0.2)
            print("after hot-swap, weights step:", service.engine.params_tag)
        finally:
            service.close()
    hvd.shutdown()


if __name__ == "__main__":
    main()
