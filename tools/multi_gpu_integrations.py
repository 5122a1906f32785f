#!/usr/bin/env python3
"""The port's cluster integrations across the GPUs of one host.

    python3 tools/multi_gpu_integrations.py [--world 4] [--device cuda|cpu]
        [--small] [--runs estimator,run_elastic]

The model is the flagship of chip_smoke.py (vocab 8192, d_model 512, 8
heads, d_ff 2048, 8 layers, seq 512, bf16; ``--small``: a 2-layer fp32
toy), trained with AdamW on next-token cross entropy.

* ``estimator`` — ``horovod_tpu_torch.spark.TorchEstimator(num_proc=
  world)`` fits it through ``runner.run``: one worker a card (NCCL; with
  ``--device cpu`` the estimator's ``device="cpu"``, gloo), 10 steps at
  batch 8 a rank from a DataFrame the store writes as 2 row groups a
  rank.  Each row carries its index as a second feature column, which
  the model drops and writes down: every rank must have read whole row
  groups of its own (disjoint, covering the data), and every rank's
  fitted parameters must be bit-equal (a SHA-256 of their bytes after
  the last step, which the optimizer writes) and equal to what the fit
  returns.  Each rank's host step (the optimizer's steps, synchronised).
* ``run_elastic`` — ``horovod_tpu_torch.spark.run_elastic`` with
  ``hosts=[localhost:world]``: the elastic driver's workers (slot
  ``localhost:i`` on card *i*) train 3 flagship steps on one batch under
  ``hvd.elastic.run`` with a ``TorchState`` committed after each; the
  results come back in rank order, each rank on its own card, its
  parameters bit-equal across the ranks.

Prints one JSON line per run, writes them to
chiprun_out/multi_gpu_integrations.json, and exits non-zero if a check
fails.
"""

import argparse
import functools
import hashlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from horovod_tpu_torch.models import transformer as tfm  # noqa: E402
from horovod_tpu_torch.spark.store import LocalStore  # noqa: E402

ESTIMATOR_STEPS, BATCH, GROUPS_PER_RANK, ELASTIC_STEPS = 10, 8, 2, 3


def flagship(small):
    if small:
        return tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                     d_ff=64, n_layers=2, seq_len=16,
                                     dtype=torch.float32, remat=False)
    return tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                 d_ff=2048, n_layers=8, seq_len=512,
                                 dtype=torch.bfloat16, remat=False)


def digest(params) -> str:
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_file(directory, suffix):
    return os.path.join(directory,
                        f"rank_{os.environ.get('HVD_TPU_RANK', '0')}.{suffix}")


class RowLM(torch.nn.Module):
    """The flagship as an estimator's model: its features a row's tokens
    and the row's index, which it drops and writes down (one line a
    batch, in ``seen_dir``'s file of this rank)."""

    def __init__(self, cfg, seen_dir):
        super().__init__()
        self.cfg, self.seen_dir = cfg, seen_dir
        self.lm = tfm.Transformer(cfg, tfm.ParallelConfig(), seed=0,
                                  device="cpu")

    def forward(self, x):
        with open(rank_file(self.seen_dir, "rows"), "a") as f:
            f.write(" ".join(str(int(r)) for r in x[:, -1].tolist()) + "\n")
        return tfm.serial_forward_logits(self.cfg, self.lm,
                                         x[:, :-1].long())


class GroupStore(LocalStore):
    """A LocalStore writing ``per_group`` rows a Parquet row group."""

    def __init__(self, prefix_path, per_group):
        super().__init__(prefix_path)
        self.per_group = per_group

    def write_dataframe(self, df, path):
        self.makedirs(path)
        with self._open(self._join(path, "part-00000.parquet"), "wb") as f:
            df.to_parquet(f, row_group_size=self.per_group)
        return len(df)


def lm_loss(logits, y):
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.long().reshape(-1))


def digest_adamw(params, out_dir, steps):
    """AdamW whose ``steps``-th step writes a SHA-256 of the parameters and
    the host times of its steps (each synchronised) to ``out_dir``."""
    params = list(params)
    opt = torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)
    times = []
    inner = opt.step

    def step(closure=None):
        out = inner(closure)
        if params[0].is_cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        if len(times) == steps:
            with open(rank_file(out_dir, "json"), "w") as f:
                json.dump({"sha": digest(params), "times": times,
                           "device": str(params[0].device)}, f)
        return out

    opt.step = step
    return opt


def run_estimator(world, device, small):
    import numpy as np
    import pandas as pd
    import horovod_tpu_torch.spark as spark

    cfg = flagship(small)
    rows = world * ESTIMATOR_STEPS * BATCH
    per_group = rows // (world * GROUPS_PER_RANK)
    tokens, labels = tfm.synthetic_batch(cfg, rows, seed=3, device="cpu")
    df = pd.DataFrame({"tokens": [t.float().tolist() for t in tokens],
                       "row": np.arange(rows, dtype=np.float32),
                       "next": [t.float().tolist() for t in labels]})

    with tempfile.TemporaryDirectory(prefix="hvd_integrations_") as tmp:
        seen = os.path.join(tmp, "seen")
        os.makedirs(seen)
        est = spark.TorchEstimator(
            model=RowLM(cfg, seen), loss=lm_loss, epochs=1,
            batch_size=BATCH, num_proc=world,
            store=GroupStore(os.path.join(tmp, "store"), per_group),
            optimizer=functools.partial(digest_adamw, out_dir=seen,
                                        steps=ESTIMATOR_STEPS),
            feature_cols=["tokens", "row"], label_cols=["next"],
            device="cpu" if device == "cpu" else None, verbose=0)
        t0 = time.perf_counter()
        fitted = est.fit(df)
        fit_s = time.perf_counter() - t0
        reports = []
        for r in range(world):
            with open(os.path.join(seen, f"rank_{r}.json")) as f:
                rep = json.load(f)
            with open(os.path.join(seen, f"rank_{r}.rows")) as f:
                rep["rows"] = sorted(int(x) for x in f.read().split())
            reports.append(rep)
    groups = [sorted({i // per_group for i in rep["rows"]})
              for rep in reports]
    for rep, gs in zip(reports, groups):
        # Whole row groups, each read once a rank.
        assert rep["rows"] == sorted(i for g in gs for i in
                                     range(g * per_group,
                                           (g + 1) * per_group)), gs
    flat = [g for gs in groups for g in gs]
    assert sorted(flat) == list(range(world * GROUPS_PER_RANK)), groups
    shas = {rep["sha"] for rep in reports}
    assert len(shas) == 1, shas
    assert digest(fitted.model.parameters()) in shas
    devices = [rep["device"] for rep in reports]
    if device == "cuda":
        assert devices == [f"cuda:{r}" for r in range(world)], devices
    steps = [float(np.median(np.diff(rep["times"]))) * 1e3
             for rep in reports]
    return {"fit_s": fit_s, "row_groups_by_rank": groups,
            "devices": devices, "params_bit_equal": True,
            "host_step_ms_by_rank": steps, "rows": rows}


def elastic_train(small, steps):
    """run_elastic's function: ``steps`` flagship steps under
    ``hvd.elastic.run``, a TorchState committed after each."""
    import horovod_tpu_torch.torch as hvd

    hvd.init()
    cfg, par = flagship(small), tfm.ParallelConfig()
    dev = hvd.device()
    model = tfm.Transformer(cfg, par, seed=0, device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    tokens, labels = tfm.synthetic_batch(cfg, BATCH, seed=1, device=dev)
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
    losses = []

    @hvd.elastic.run
    def train(state):
        while state.step < steps:
            opt.zero_grad()
            loss = tfm.forward_loss(cfg, par, model, tokens, labels)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            state.step += 1
            state.commit()

    train(state)
    out = {"rank": hvd.rank(), "size": hvd.size(), "device": str(dev),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "losses": losses, "sha": digest(model.parameters())}
    hvd.shutdown()
    return out


def run_elastic(world, device, small):
    import horovod_tpu_torch.spark as spark
    from horovod_tpu_torch.runner.chips import _free_port
    from horovod_tpu_torch.runner.hosts import HostInfo
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hvd_spark_elastic_") as tmp:
        results = spark.run_elastic(
            elastic_train, args=(small, ELASTIC_STEPS), num_proc=world,
            min_np=world, hosts=[HostInfo("localhost", world)],
            controller_base_port=_free_port(), work_dir=tmp)
    seconds = time.perf_counter() - t0
    assert [r["rank"] for r in results] == list(range(world)), results
    assert all(r["size"] == world for r in results), results
    assert len({r["sha"] for r in results}) == 1, results
    assert all(len(r["losses"]) == ELASTIC_STEPS and
               r["losses"][-1] < r["losses"][0] for r in results), results
    if device == "cuda":
        assert [(r["device"], r["visible"]) for r in results] == \
            [("cuda:0", str(i)) for i in range(world)], results
    return {"seconds": seconds, "results": results}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--runs", default="estimator,run_elastic")
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"needs {args.world} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    runs = {"estimator": run_estimator, "run_elastic": run_elastic}
    report = {"world": args.world, "device": args.device,
              "small": args.small}
    if args.device == "cuda":
        report["kind"] = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    for name in args.runs.split(","):
        t = time.perf_counter()
        report[name] = runs[name](args.world, args.device, args.small)
        report[name]["run_s"] = time.perf_counter() - t
        print(json.dumps({"run": name, **report[name]}), flush=True)
    report["seconds"] = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_integrations.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"world": args.world, "device": args.device,
                      "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
