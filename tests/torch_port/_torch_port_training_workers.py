"""Worker bodies of the port's bucketed-overlap, Adasum, ZeRO and sync
batch norm tests (test_torch_port_overlap.py, …_adasum.py, …_zero.py,
…_sync_batch_norm.py).  ``_torch_port_pool.part_results`` starts four gloo
ranks once per part and test process; each part's body runs on them and
writes ``<part><rank>.pt``.  Torch and the port only: the ranks must not
import JAX."""

import os

from _torch_port_workers import _topology_env

WIRES = ("none", "bf16", "int8", "int4")
JOINT = ("local", "cross")


def _init(rank, world, init_method, local_size):
    _topology_env(rank, world, local_size)
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)   # the ranks share the host's cores
    hvd.init(device="cpu", init_method=init_method)
    return torch, hvd


def _leaves(torch, data, rank):
    """This rank's leaves; the one ``data["bf16"]`` names in bf16."""
    return [torch.from_numpy(data[f"leaf{i}"][rank].copy()).to(
        torch.bfloat16 if i == int(data["bf16"]) else torch.float32)
        for i in range(int(data["n_leaves"]))]


# ---------------------------------------------------------------------------
# overlap
# ---------------------------------------------------------------------------

def _bucket_cases(hvd, O, C, leaves, axis, wires=WIRES):
    """Per wire: the leaves reduced one by one and bucket by bucket (a
    bucket bound that packs several leaves), allreduce and reduce-scatter;
    the shards of the per-leaf reduce-scatter are the padded ravels'."""
    out = {}
    world = hvd.size()
    for wire in wires:
        comp = None if wire == "none" else wire
        for op_name, op, pre, post in (("average", hvd.Average, 1.0, 1.0),
                                       ("sum", hvd.Sum, 0.5, 3.0)):
            per = [C.allreduce(t, op, axis, pre, post,
                               compression=comp or "none") for t in leaves]
            bucketed = O.bucketed_allreduce_tree(
                leaves, op, axis, comp, pre, post, bucket_bytes=4096)
            out[f"allreduce-{wire}-{op_name}"] = (per, bucketed)
        per = [C.reducescatter(O._rows_of(t, world).reshape(-1),
                               axis_name=axis, compression=comp or "none")
               for t in leaves]
        bucketed = O.bucketed_reducescatter_tree(leaves, axis_name=axis,
                                                 compression=comp,
                                                 bucket_bytes=4096)
        out[f"reducescatter-{wire}"] = (per, bucketed)
    return out


def _small_model(torch, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g))
            for s in ((16, 40), (40,), (40, 24), (24,), (3, 24))]


def _model_loss(ps, x):
    h = (x @ ps[0] + ps[1]).tanh()
    return ((h @ ps[2] + ps[3]) * ps[4].sum(0)).square().mean()


def _optimizer_runs(torch, hvd, rank):
    """SGD(0.1) on the small model, each rank its own batch, with the
    per-parameter schedule and with hooks (bucket bound 2 KiB), on every
    wire and at bpps 1 and 2: per pass the parameters, the residuals and
    the buckets the hooks launched during the pass' backward."""
    out = {}
    for wire in WIRES:
        for bpps in (1, 2):
            for overlap in (False, 2048):
                ps = _small_model(torch)
                opt = hvd.DistributedOptimizer(
                    torch.optim.SGD(ps, lr=0.1), compression=None
                    if wire == "none" else wire, overlap=overlap,
                    backward_passes_per_step=bpps)
                traj = []
                for s in range(3 * bpps):
                    g = torch.Generator().manual_seed(100 * s + rank)
                    x = torch.randn(8, 16, generator=g)
                    _model_loss(ps, x).backward()
                    launched = None if opt._hooks is None \
                        else list(opt._hooks.launched)
                    opt.step()
                    opt.zero_grad()
                    traj.append({
                        "params": [p.detach().clone() for p in ps],
                        "residual": None if opt.residual is None else
                        [r.clone() for r in opt.residual],
                        "launched": launched})
                out[f"{wire}-bpps{bpps}-{bool(overlap)}"] = traj
    return out


def _grad_cases(torch, hvd, rank):
    """grad() and grad(overlap=) of the small model's loss, on this rank's
    batch, uncompressed and on int8."""
    ps = [p.detach() for p in _small_model(torch)]
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(rank))
    out = {}
    for comp in (None, "int8"):
        for overlap in (None, 2048):
            out[f"{comp}-{overlap}"] = hvd.grad(
                _model_loss, compression=comp, overlap=overlap)(ps, x)
    return out


def overlap_part(rank, world, rendezvous, out_dir):
    import numpy as np
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import overlap as O
    data = np.load(os.path.join(out_dir, "overlap.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_overlap4", 2)
    res = {}
    try:
        leaves = _leaves(torch, data, rank)
        res["world"] = _bucket_cases(hvd, O, C, leaves, None)
        res["joint"] = _bucket_cases(hvd, O, C, leaves, JOINT,
                                     ("none", "int8"))
        res["grad4"] = _grad_cases(torch, hvd, rank)
        # ZeRO-3's gather: this rank's rows of the parameters, gathered
        # into the full tensors, and the shard gradients of sum(full * ct).
        params = [torch.from_numpy(data[f"param{i}"].copy())
                  for i in range(int(data["n_params"]))]
        cts = [torch.from_numpy(data[f"ct{i}"][rank].copy())
               for i in range(len(params))]
        for label, kw in (("plain", {}),
                          ("int8", dict(compression="int8",
                                        quantize_gather=True))):
            shards = [O._rows_of(p, world)[rank].clone().requires_grad_()
                      for p in params]
            full = O.gather_in_forward(shards, params, bucket_bytes=1024,
                                       **kw)
            sum((f * c).sum() for f, c in zip(full, cts)).backward()
            res[f"gather-{label}"] = ([f.detach() for f in full],
                                      [s.grad for s in shards])
    finally:
        hvd.shutdown()
    if rank < 2:
        torch, hvd = _init(rank, 2, f"file://{rendezvous}_overlap2", 2)
        try:
            res["optimizer"] = _optimizer_runs(torch, hvd, rank)
            res["grad2"] = _grad_cases(torch, hvd, rank)
            leaves = _leaves(torch, data, rank)
            res["world2"] = _bucket_cases(hvd, O, C, leaves, None,
                                          ("none",))
        finally:
            hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"overlap{rank}.pt"))


# ---------------------------------------------------------------------------
# Adasum
# ---------------------------------------------------------------------------

def adasum_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "adasum.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_adasum4", 2)
    x = torch.from_numpy(data["x"][rank].copy())
    y = torch.from_numpy(data["y"][rank].copy())
    res = {}
    try:
        res["world"] = hvd.allreduce(x, op=hvd.Adasum)
        res["world_y"] = hvd.allreduce(y, op=hvd.Adasum)
        res["scaled"] = hvd.allreduce(x, op=hvd.Adasum, prescale_factor=0.5,
                                      postscale_factor=3.0)
        res["grouped"] = hvd.grouped_allreduce([x, y], op=hvd.Adasum)
        z = torch.from_numpy(data["z"][rank].copy())
        t = torch.from_numpy(data["t"][rank].copy())
        for wire in (None, "int8", "bf16"):
            res[f"hier-{wire}"] = hvd.allreduce(
                x, op=hvd.Adasum, axis_name=JOINT, compression=wire)
            res[f"hier_z-{wire}"] = hvd.allreduce(
                z, op=hvd.Adasum, axis_name=JOINT, compression=wire)
        res["hier_t-None"] = hvd.allreduce(t, op=hvd.Adasum,
                                           axis_name=JOINT)
        try:
            hvd.allreduce(x, op=hvd.Adasum, compression="int8")
            res["world_int8"] = None
        except ValueError as e:
            res["world_int8"] = str(e)
        # The delta model: SGD(0.1) steps on seeded per-rank gradients.
        w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                       op=hvd.Adasum)
        res["optimizer"] = []
        for s in range(2):
            w.grad = torch.from_numpy(data["g"][s, rank].copy())
            opt.step()
            res["optimizer"].append(w.detach().clone())
    finally:
        hvd.shutdown()
    if rank < 3:
        torch, hvd = _init(rank, 3, f"file://{rendezvous}_adasum3", 3)
        try:
            res["world3"] = hvd.allreduce(x, op=hvd.Adasum)
        finally:
            hvd.shutdown()
    if rank < 2:
        # The delta model at backward_passes_per_step 2: pass q takes
        # g[q // 2, 2 * (q % 2) + rank].
        torch, hvd = _init(rank, 2, f"file://{rendezvous}_adasum2", 2)
        try:
            w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
            opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                           op=hvd.Adasum,
                                           backward_passes_per_step=2)
            res["bpps2"] = []
            for q in range(4):
                w.grad = torch.from_numpy(
                    data["g"][q // 2, 2 * (q % 2) + rank].copy())
                opt.step()
                res["bpps2"].append(w.detach().clone())
        finally:
            hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"adasum{rank}.pt"))


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------

def _zero_loss(p, x):
    return ((x @ p[0]) ** 2).sum() * 1e-3 + (p[1] ** 2).sum() * 1e-2


def _zero_run(torch, hvd, data, rank, stage, steps=3, **kw):
    """The reference's stage-parity problem (tests/test_zero_stages.py):
    AdamW(1e-2, wd 1e-3) from its parameters, each rank its own batch row;
    the full parameters after ``steps`` updates.  Stage 0 is the
    replicated DistributedOptimizer."""
    import functools
    ps = [torch.nn.Parameter(torch.from_numpy(data[k].copy()))
          for k in ("w", "b")]
    x = torch.from_numpy(data["x"][rank].copy())
    adamw = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-3)
    if stage == 0:
        opt = hvd.DistributedOptimizer(adamw(ps), **kw)
    else:
        opt = hvd.ZeroShardedOptimizer(ps, adamw, stage=stage, **kw)
    for _ in range(steps):
        opt.zero_grad()
        if stage == 3:
            _zero_loss(opt.gather_params(), x).backward()
        else:
            _zero_loss(ps, x).backward()
            if stage == 2:
                opt.reduce_grads()
        opt.step()
    if stage == 3:
        with torch.no_grad():
            return [t.clone() for t in opt.gather_params()]
    return [p.detach().clone() for p in ps]


def _lm_runs(torch, hvd, out_dir, rank, world):
    """The small transformer, 2 steps of make_train_step on this rank's
    batch shard, replicated and at each ZeRO stage: losses and the full
    parameters after."""
    import functools
    import json
    import numpy as np
    from horovod_tpu_torch.models import transformer as tfm
    lm = np.load(os.path.join(out_dir, "lm.npz"))
    cfg = tfm.TransformerConfig(dtype=torch.float32,
                                **json.loads(str(lm["cfg"])))
    shard = len(lm["tokens"]) // world
    tokens, labels = (torch.from_numpy(lm[k][rank * shard:
                                             (rank + 1) * shard])
                      for k in ("tokens", "labels"))
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    out = {}
    for stage in (0, 1, 2, 3):
        model = tfm.Transformer(cfg, device="cpu")
        model.load_state_dict({k[len("param."):]: torch.from_numpy(lm[k])
                               for k in lm.files if k.startswith("param.")})
        opt = hvd.DistributedOptimizer(sgd(model.parameters())) \
            if stage == 0 else hvd.ZeroShardedOptimizer(model, sgd,
                                                        stage=stage)
        step = tfm.make_train_step(cfg, tfm.ParallelConfig(), model, opt)
        losses = [step(tokens, labels).item() for _ in range(2)]
        if stage == 3:
            with torch.no_grad():
                params = {k: v.clone()
                          for k, v in opt.gather_params().items()}
        else:
            params = {k: v.detach().clone()
                      for k, v in model.named_parameters()}
        out[stage] = (losses, params)
    return out


def zero_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "zero.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_zero4", 2)
    res = {}
    try:
        for stage in (0, 1, 2, 3):
            res[f"stage{stage}"] = _zero_run(torch, hvd, data, rank, stage)
        res["stage3-bucketed"] = _zero_run(torch, hvd, data, rank, 3,
                                           overlap=64)
        res["stage3-barrier"] = _zero_run(torch, hvd, data, rank, 3,
                                          overlap=1 << 20)
        res["stage3-bucketed-int8"] = _zero_run(
            torch, hvd, data, rank, 3, overlap=64, compression="int8")
        res["stage3-barrier-int8"] = _zero_run(
            torch, hvd, data, rank, 3, overlap=1 << 20, compression="int8")
        for stage in (1, 2):
            res[f"stage{stage}-hooks"] = _zero_run(torch, hvd, data, rank,
                                                   stage, overlap=64)
        res["stage1-joint"] = _zero_run(torch, hvd, data, rank, 1,
                                        axis_name=JOINT)
        res["stage0-int8"] = _zero_run(torch, hvd, data, rank, 0,
                                       compression="int8")
        res["stage1-int8"] = _zero_run(torch, hvd, data, rank, 1,
                                       compression="int8")
        # Stage 2 refuses full gradients on an uncompressed wire.
        ps = [torch.nn.Parameter(torch.ones(6))]
        opt = hvd.ZeroShardedOptimizer(ps, torch.optim.SGD, stage=2)
        ps[0].grad = torch.ones(6)
        try:
            opt.step()
            res["refusal"] = None
        except ValueError as e:
            res["refusal"] = str(e)
        res["lm"] = _lm_runs(torch, hvd, out_dir, rank, world)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"zero{rank}.pt"))


# ---------------------------------------------------------------------------
# sync batch norm
# ---------------------------------------------------------------------------

def sync_batch_norm_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "sbn.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_sbn", 2)
    res = {}
    try:
        x, ct = (torch.from_numpy(data[k][rank].copy()) for k in ("x", "ct"))
        stats = [torch.from_numpy(data[k].copy()) for k in ("rm", "rv")]
        for label, kw in (("train", {}), ("local", dict(axis_name=None)),
                          ("joint", dict(axis_name=JOINT)),
                          ("eval", dict(training=False))):
            leaves = [t.clone().requires_grad_() for t in
                      (x, torch.from_numpy(data["scale"].copy()),
                       torch.from_numpy(data["bias"].copy()))]
            out, mean, var = hvd.sync_batch_norm(*leaves, *stats, **kw)
            (out * ct).sum().backward()
            res[label] = {"out": out.detach(), "mean": mean, "var": var,
                          "grads": [t.grad for t in leaves]}
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"sbn{rank}.pt"))
