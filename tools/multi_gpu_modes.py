#!/usr/bin/env python3
"""The flagship's parallel modes across four GPUs.

    python3 tools/multi_gpu_modes.py [--device cuda|cpu] [--small]

The flagship of chip_smoke.py (vocab 8192, d_model 512, 8 heads, d_ff
2048, 8 layers, seq 512, bf16, remat off, seeded weights; ``--small``: a
4-layer bf16 toy with ``--device cpu``, gloo, to rehearse the same
program) on (dp, pp, mp) meshes of four processes, one a GPU (NCCL):

* (1, 1, 4) in megatron (tp + SP), ring and ulysses attention;
* (1, 4, 1) with GPipe and 1F1B at 8 microbatches (2 layers a stage);
* (4, 1, 1) with 8 MoE experts (2 a rank), capacity factor 1.25, top_k 1;
* (2, 1, 2) megatron; (2, 2, 1) 1F1B at 4 microbatches.

Each run takes a batch of 8 sequences a dp member and 5 steps of
``make_train_step`` on a mesh ``Transformer`` with AdamW(3e-4, wd 1e-4),
and checks step 0 against world-1 steps on the same global batch,
computed first in a process of its own on GPU 0, in bf16 through the
kernels and in fp32 through the plain attention (``HVD_TPU_FLASH=0``;
the kernels take bf16 only):

* the loss within 1e-2 of the world-1 bf16 step's;
* every gradient leaf, gathered with ``gather_params``, no further from
  the world-1 fp32 gradient (normwise) than ``GRAD_NOISE_MULTIPLE`` times
  the world-1 bf16 gradient's own distance from it: the bar is what bf16
  rounding does to this leaf in this run, read beside the mesh step.
  The distance to the world-1 bf16 gradient is reported too, ungated
  (two correct bf16 computations sit about √2 times one's rounding apart);
* step 0 once more in fp32 with the plain attention against the world-1
  fp32 step: loss within rtol 1e-5, gradients within 1e-4 normwise, so
  that a fault of the mesh path's own code cannot hide in bf16's
  rounding.

A pipeline run (pp > 1) then takes two more steps under the step
telemetry (``metrics.compute_span``, ``pipeline.note_bubble`` of the
span, ``metrics.step_end``): on every rank the second step's attribution
record carries the bubble seconds ``note_bubble`` credited, more than 0.

The world-1 step is the serial flagship's (a (1, 1, 1) mesh); for MoE it
takes the dp members' rows as microbatches, so each routes its tokens
with the same capacity as on its member.  Reported per run: host step
(median of steps 1-4, each ending in a synchronize and a barrier), peak
memory allocated on a rank over steps 1-4, collectives a step (calls at
torch.distributed, point-to-point batches included), and the bytes of
the matmul weights a rank holds.

Prints one JSON line per run from rank 0, then the cards' names and
power limits as nvidia-smi reports them, and writes them to
chiprun_out/multi_gpu_modes.json; exits non-zero if a check fails.
"""

import argparse
import datetime
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ROWS = 8              # sequences a dp member
N_STEPS = 5
TOL_LOSS = 1e-2
# A mesh step rounds to bf16 at more places than the world-1 step (tp's
# bf16 partial sums reduced over NCCL, the ring's per-block outputs
# merged): up to this many times the world-1 step's own distance from
# fp32 on a leaf.  A fault (a lost shard, microbatch or psum, a wrong
# transpose) moves a leaf by 1/8 of its norm or more.
GRAD_NOISE_MULTIPLE = 3.0
TOL_FP32_LOSS_REL = 1e-5
TOL_FP32_GRAD_REL = 1e-4
TOL_BUBBLE_S = 1e-9     # the credited bubble through the counter's window
COUNTED = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
           "all_to_all_single", "batch_isend_irecv")
MATMUL = ("wqkv", "wo", "w1", "w2", "w_in", "w_out")
# name, (dp, pp, mp), TransformerConfig fields, ParallelConfig fields.
RUNS = [
    ("megatron_tp4", (1, 1, 4), {}, {}),
    ("ring_sp4", (1, 1, 4), dict(attn_mode="ring"), {}),
    ("ulysses_sp4", (1, 1, 4), dict(attn_mode="ulysses"), {}),
    ("gpipe_pp4", (1, 4, 1), {}, dict(n_microbatches=8)),
    ("1f1b_pp4", (1, 4, 1), {}, dict(n_microbatches=8,
                                      pp_schedule="1f1b")),
    ("moe_ep4", (4, 1, 1), dict(n_experts=8, capacity_factor=1.25,
                                top_k=1), {}),
    ("megatron_dp2_tp2", (2, 1, 2), {}, {}),
    ("1f1b_dp2_pp2", (2, 2, 1), {}, dict(n_microbatches=4,
                                          pp_schedule="1f1b")),
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _config(torch, tfm, small):
    if small:
        return tfm.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                     d_ff=128, n_layers=4, seq_len=32,
                                     dtype=torch.bfloat16, remat=False)
    return tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                 d_ff=2048, n_layers=8, seq_len=512,
                                 dtype=torch.bfloat16, remat=False)


def _reference_key(shape, cf, dtype):
    """Runs whose world-1 step is the same: the global batch, MoE, and
    the compute dtype."""
    return (shape[0], bool(cf.get("n_experts")), str(dtype))


def _grad_tree(model):
    return {"embed": model.embed.grad, "pos": model.pos.grad,
            "final_norm": model.final_norm.grad,
            "layers": {k: p.grad for k, p in model.layers.items()}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _step0(torch, tfm, cfg, par, mesh, dev, tokens, labels):
    """Step 0's loss and gradient tree of a fresh seed-0 model on
    ``mesh``; in fp32 through the plain attention."""
    plain = cfg.dtype == torch.float32
    if plain:
        os.environ["HVD_TPU_FLASH"] = "0"
    try:
        model = tfm.Transformer(cfg, par, seed=0, device=dev, mesh=mesh)
        loss = tfm.make_loss_fn(cfg, par, mesh)(model, tokens, labels)
        loss.backward()
    finally:
        if plain:
            del os.environ["HVD_TPU_FLASH"]
    return loss.item(), _grad_tree(model)


def references(device, small, path):
    """World 1 in this process: step 0's loss and gradients of every
    distinct reference, saved to ``path``."""
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    hvd.init(device=device)
    out = {}
    try:
        dev = hvd.device()
        base = _config(torch, tfm, small)
        mesh = hvd.parallel.create_mesh({"dp": 1, "pp": 1, "mp": 1})
        for _, shape, cf, _ in RUNS:
            for dtype in (base.dtype, torch.float32):
                key = _reference_key(shape, cf, dtype)
                if key in out:
                    continue
                cfg = base._replace(dtype=dtype, **cf)
                dp, moe, _ = key
                par = tfm.ParallelConfig(n_microbatches=dp if moe else 1)
                tokens, labels = tfm.synthetic_batch(cfg, ROWS * dp, seed=1,
                                                     device=dev)
                loss, grads = _step0(torch, tfm, cfg, par, mesh, dev, tokens,
                                     labels)
                out[key] = (loss, {k: g.float().cpu() for k, g in
                                   _flat(grads).items()})
    finally:
        hvd.shutdown()
    torch.save(out, path)


class _Counted:
    """Counts the calls of ``COUNTED`` at torch.distributed."""

    def __init__(self, dist):
        self.dist = dist
        self.counts = dict.fromkeys(COUNTED, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in COUNTED}
        for n in COUNTED:
            def call(*a, _n=n, **kw):
                self.counts[_n] += 1
                return self.saved[_n](*a, **kw)
            setattr(self.dist, n, call)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.dist, n, f)


def _sync(torch, dist, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def run_mode(torch, dist, hvd, tfm, dev, small, meshes, refs, spec):
    name, shape, cf, pf = spec
    cfg = _config(torch, tfm, small)._replace(**cf)
    par = tfm.ParallelConfig(*shape, **pf)
    if shape not in meshes:
        meshes[shape] = hvd.parallel.create_mesh(dict(zip(("dp", "pp",
                                                           "mp"), shape)))
    mesh = meshes[shape]
    dp_index = mesh.get_coordinate()[0]
    tokens, labels = tfm.synthetic_batch(cfg, ROWS * shape[0], seed=1,
                                         device=dev)
    rows = slice(dp_index * ROWS, (dp_index + 1) * ROWS)
    tokens, labels = tokens[rows], labels[rows]
    gc.collect()     # the last run's model and optimizer, held in cycles
    model = tfm.Transformer(cfg, par, seed=0, device=dev, mesh=mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    step = tfm.make_train_step(cfg, par, model, opt)
    out = {"mesh": dict(zip(("dp", "pp", "mp"), shape)),
           "matmul_weight_bytes_a_rank": sum(
               p.numel() * p.element_size()
               for k, p in model.layers.items() if k in MATMUL)}
    losses, times = [], []
    for i in range(N_STEPS):
        _sync(torch, dist, dev)
        if i == 1 and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 1:
            with _Counted(dist) as counted:
                loss = step(tokens, labels)
        else:
            loss = step(tokens, labels)
        _sync(torch, dist, dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if i == 0:
            grads = _flat(tfm.gather_params(cfg, par, _grad_tree(model),
                                            mesh))
            if dist.get_rank() == 0:
                out.update(_against_bf16(
                    refs[_reference_key(shape, cf, cfg.dtype)],
                    refs[_reference_key(shape, cf, torch.float32)],
                    losses[0], grads))
            del grads
    if dev.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out.update(losses=losses, step_ms=statistics.median(times[1:]) * 1e3,
               calls_per_step={n: c for n, c in counted.counts.items() if c})
    assert all(x == x for x in losses) and losses[-1] < losses[0], losses
    if shape[1] > 1:
        out["pipeline_bubble"] = _bubble(torch, dist, dev, step, tokens,
                                         labels, shape[1], par.n_microbatches,
                                         1000 * (RUNS.index(spec) + 1))
    del model, opt, step
    fp32 = cfg._replace(dtype=torch.float32)
    loss, grads = _step0(torch, tfm, fp32, par, mesh, dev, tokens, labels)
    grads = _flat(tfm.gather_params(fp32, par, grads, mesh))
    if dist.get_rank() == 0:
        ref = refs[_reference_key(shape, cf, torch.float32)]
        assert abs(loss - ref[0]) <= TOL_FP32_LOSS_REL * abs(ref[0]), \
            (loss, ref[0])
        rel = _rel(grads, ref[1])
        assert max(rel.values()) <= TOL_FP32_GRAD_REL, rel
        out["fp32"] = {"step0_loss": loss, "world1_loss": ref[0],
                       "step0_grad_rel": rel}
    return out


def _bubble(torch, dist, dev, step, tokens, labels, n_stages, n_micro,
            first_index):
    """Two steps under compute_span, each crediting note_bubble with its
    span and closed by step_end: the second's record (the first may
    anchor the attribution's window) holds the credited bubble."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.parallel import pipeline as pp
    for i in range(2):
        _sync(torch, dist, dev)
        t0 = time.perf_counter()
        with metrics.compute_span():
            step(tokens, labels)
        credited = pp.note_bubble(n_stages, n_micro, time.perf_counter() - t0)
        metrics.step_end(time.perf_counter() - t0, step=first_index + i)
    rec = metrics.last_attribution()
    bubble = rec["components"]["pipeline_bubble"]
    assert credited > 0 and abs(bubble - credited) <= TOL_BUBBLE_S, \
        (bubble, credited)
    return {"fraction": pp.bubble_fraction(n_stages, n_micro),
            "credited_s": credited, "components_s": rec["components"]}


def _rel(grads, ref_grads):
    """Per leaf, ||grads - ref|| / ||ref|| (the pipeline's (n_pp, layers,
    ...) stacks read as the reference's (1, n_layers, ...))."""
    out = {}
    for k, g in ref_grads.items():
        got = grads[k].float().cpu().reshape(g.shape)
        out[k] = ((got - g).norm() / g.norm().clamp_min(1e-30)).item()
    return out


def _against_bf16(ref16, ref32, loss, grads):
    """The bf16 step 0 against the world-1 steps: the loss against the
    bf16 one; per leaf, the distance from the fp32 gradient against
    ``GRAD_NOISE_MULTIPLE`` times the world-1 bf16 gradient's."""
    assert abs(loss - ref16[0]) <= TOL_LOSS, (loss, ref16[0])
    noise = _rel(ref16[1], ref32[1])
    err = _rel(grads, ref32[1])
    over = {k: (err[k], noise[k]) for k in err
            if not err[k] <= GRAD_NOISE_MULTIPLE * noise[k]}
    assert not over, over
    return {"step0_loss": loss, "world1_loss": ref16[0],
            "step0_grad_rel_fp32": err, "world1_grad_rel_fp32": noise,
            "step0_grad_rel": _rel(grads, ref16[1]),
            "noise_multiple": max(err[k] / noise[k] for k in err)}


def rank_main(rank, world, port, device, small, tmp):
    sys.path.insert(0, ROOT)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1")
    import torch
    import torch.distributed as dist
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    hvd.init(device=device)
    try:
        dev = hvd.device()
        refs = torch.load(os.path.join(tmp, "refs.pt")) if rank == 0 \
            else None
        meshes, report = {}, {}
        for spec in RUNS:
            report[spec[0]] = run_mode(torch, dist, hvd, tfm, dev, small,
                                       meshes, refs, spec)
        if rank == 0:
            report = {"device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu", "world": world,
                      "runs": report}
            with open(os.path.join(tmp, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import tempfile
    import torch
    import torch.multiprocessing as mp
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        print(f"needs {WORLD} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        proc = ctx.Process(target=references,
                           args=(args.device, args.small,
                                 os.path.join(tmp, "refs.pt")))
        proc.start()
        proc.join()
        if proc.exitcode != 0:
            return 1
        mp.start_processes(rank_main, args=(WORLD, _free_port(), args.device,
                                            args.small, tmp),
                           nprocs=WORLD, join=True, start_method="spawn")
        with open(os.path.join(tmp, "report.json")) as f:
            report = json.load(f)
    report["cards"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines() \
        if args.device == "cuda" else []
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "multi_gpu_modes.json"), "w") as f:
        json.dump(report, f, indent=1)
    for name, res in report["runs"].items():
        print(json.dumps({"name": name, **res}))
    print(json.dumps({"device": report["device"], "world": report["world"],
                      "cards": report["cards"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
