"""Worker bodies of the port's parallel-mode tests
(test_torch_port_modes_units.py, test_torch_port_modes.py,
test_torch_port_modes_moe.py): four gloo ranks, started once per part and
test process by ``_torch_port_pool.part_results``, each writing
``<part><rank>.pt``.  Torch and the port only: the ranks must not import
JAX.  The case tables are plain data, read by the test modules too."""

import os

from _torch_port_training_workers import _init

# The tiny flagship of the mode tests: fp32, vocab 61, d 32, 4 heads,
# d_ff 48, seq 16; a global batch of 8 sequences.
TINY = dict(vocab_size=61, d_model=32, n_heads=4, d_ff=48, seq_len=16)
BATCH = 8

# name: ((dp, pp, mp), TransformerConfig fields, ParallelConfig fields).
# Cases with the same config and pp share their parameters.
MODE_CASES = {
    "megatron": ((1, 1, 4), dict(n_layers=2), {}),
    "megatron_remat": ((1, 1, 4), dict(n_layers=2, remat=True), {}),
    "ring": ((1, 1, 4), dict(n_layers=2, attn_mode="ring"), {}),
    "ulysses": ((1, 1, 4), dict(n_layers=2, attn_mode="ulysses"), {}),
    "gpipe4": ((1, 2, 2), dict(n_layers=4), dict(n_microbatches=4)),
    "1f1b4": ((1, 2, 2), dict(n_layers=4),
              dict(n_microbatches=4, pp_schedule="1f1b")),
    "gpipe1": ((1, 2, 2), dict(n_layers=4), dict(n_microbatches=1)),
    "1f1b1": ((1, 2, 2), dict(n_layers=4),
              dict(n_microbatches=1, pp_schedule="1f1b")),
    "gpipe4_remat": ((1, 2, 2), dict(n_layers=4, remat=True),
                     dict(n_microbatches=4)),
    "1f1b_dp2": ((2, 2, 1), dict(n_layers=4),
                 dict(n_microbatches=2, pp_schedule="1f1b")),
}
MOE_CASES = {
    "ep4_k1": ((4, 1, 1), dict(n_layers=2, n_experts=8, top_k=1), {}),
    "ep4_k2": ((4, 1, 1), dict(n_layers=2, n_experts=8, top_k=2), {}),
    "ep2_mp2_k1": ((2, 1, 2), dict(n_layers=2, n_experts=4, top_k=1), {}),
    "ep2_mp2_k2": ((2, 1, 2), dict(n_layers=2, n_experts=4, top_k=2,
                                   remat=True), {}),
}
# One SGD(0.1) step of the mesh train step.
TRAIN_CASES = {"train": ((2, 1, 2), dict(n_layers=2), {})}
LR = 0.1

# Units at an axis of 4: tensor parallel, pipeline, MoE.
PIPE_CASES = [(sched, remat, n_micro) for n_micro in (4, 2)
              for sched, remat in (("gpipe", True), ("gpipe", False),
                                   ("1f1b", False))]
MOE_UNIT_CASES = {"k1": dict(capacity_factor=1.25, top_k=1),
                  "k2": dict(capacity_factor=1.25, top_k=2),
                  "tight": dict(capacity_factor=0.25, top_k=1)}


def case_params_key(cases, name):
    """The name of the case whose parameters ``name`` uses."""
    mesh, cf, _ = cases[name]
    for other, (m, c, _) in cases.items():
        if m[1] == mesh[1] and {k: v for k, v in c.items() if k != "remat"} \
                == {k: v for k, v in cf.items() if k != "remat"}:
            return other
    return name


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


_MESHES = {}


def _mesh(hvd, shape):
    if shape not in _MESHES:
        _MESHES[shape] = hvd.parallel.create_mesh(dict(zip(("dp", "pp",
                                                            "mp"), shape)))
    return _MESHES[shape]


def _configs(torch, tfm, case):
    shape, cf, pf = case
    cfg = tfm.TransformerConfig(dtype=torch.float32,
                                **{**TINY, "remat": False, **cf})
    par = tfm.ParallelConfig(*shape, **pf)
    return cfg, par


def _mode_run(torch, hvd, out_dir, cases, name, data, steps=0):
    """loss, the gathered gradient tree (flat) and, with ``steps``, the
    gathered parameters after that many SGD steps of make_train_step."""
    import numpy as np
    from horovod_tpu_torch.models import transformer as tfm
    cfg, par = _configs(torch, tfm, cases[name])
    mesh = _mesh(hvd, (par.dp, par.pp, par.mp))
    key = case_params_key(cases, name)
    flat = np.load(os.path.join(out_dir, f"params_{key}.npz"))
    full = _nest({k: torch.from_numpy(flat[k].copy()) for k in flat.files})
    shards = tfm.shard_params(cfg, par, full, mesh)
    for _, t in tfm._leaves(shards):
        t.requires_grad_()
    rows = BATCH // par.dp
    i = mesh.get_coordinate()[0]
    tokens = torch.from_numpy(data["tokens"][i * rows:(i + 1) * rows])
    labels = torch.from_numpy(data["labels"][i * rows:(i + 1) * rows])
    if steps:
        model = tfm.Transformer(cfg, par, device="cpu", mesh=mesh)
        model.load_state_dict({k: v for k, v in tfm._leaves(shards)})
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        step = tfm.make_train_step(cfg, par, model, opt)
        losses = [step(tokens, labels) for _ in range(steps)]
        return {"losses": [x.item() for x in losses],
                "params": _flat(tfm.gather_params(cfg, par, model, mesh))}
    loss = tfm.make_loss_fn(cfg, par, mesh)(shards, tokens, labels)
    loss.backward()
    grads = tfm._map(lambda t, _: t.grad, shards, tfm.param_specs(cfg, par))
    return {"loss": loss.detach(),
            "grads": _flat(tfm.gather_params(cfg, par, grads, mesh))}


def _roundtrip(torch, hvd, out_dir):
    """gather_params(shard_params(tree)) is the tree on every mesh of the
    MoE cases (a Transformer on the mesh holds the shards)."""
    import numpy as np
    from horovod_tpu_torch.models import transformer as tfm
    ok = True
    for name, case in MOE_CASES.items():
        cfg, par = _configs(torch, tfm, case)
        mesh = _mesh(hvd, (par.dp, par.pp, par.mp))
        flat = np.load(os.path.join(out_dir, "params_"
                                    f"{case_params_key(MOE_CASES, name)}.npz"))
        full = {k: torch.from_numpy(flat[k].copy()) for k in flat.files}
        model = tfm.Transformer(cfg, par, device="cpu", mesh=mesh)
        model.load_state_dict(_flat(tfm.shard_params(cfg, par, _nest(full),
                                                     mesh)))
        back = _flat(tfm.gather_params(cfg, par, model, mesh))
        ok = ok and sorted(back) == sorted(full) and all(
            torch.equal(back[k], full[k]) for k in full)
    return ok


def modes_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "modes.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_modes4", 2)
    res = {}
    try:
        for name in MODE_CASES:
            res[name] = _mode_run(torch, hvd, out_dir, MODE_CASES, name,
                                  data)
        res["train"] = _mode_run(torch, hvd, out_dir, TRAIN_CASES, "train",
                                 data, steps=1)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"modes{rank}.pt"))


def moe_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "moe.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_moe4", 2)
    res = {}
    try:
        for name in MOE_CASES:
            res[name] = _mode_run(torch, hvd, out_dir, MOE_CASES, name, data)
        res["roundtrip"] = _roundtrip(torch, hvd, out_dir)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"moe{rank}.pt"))


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _tp_units(torch, tp, group, data, rank):
    """Each function on this member's shards; the output's cotangent is
    this member's row of ``ct*``.  Gradients of replicated inputs are
    summed over the axis, as the reference's transpose sums them."""
    import torch.distributed as dist

    def t(name, rows=None):
        a = data[name] if rows is None else data[name][rows]
        return torch.from_numpy(a.copy()).requires_grad_()

    def summed(g):
        dist.all_reduce(g, group=group)
        return g

    out = {}
    n = dist.get_world_size(group)
    # Column then row parallel (psum).
    mid = data["w1"].shape[1] // n
    x, w1, w2 = t("x"), t("w1"), t("w2")
    w1s = w1[:, rank * mid:(rank + 1) * mid]
    w2s = w2[rank * mid:(rank + 1) * mid]
    y = tp.row_parallel(torch.relu(tp.column_parallel(x, w1s)), w2s, group)
    (y * torch.from_numpy(data["ct_row"][rank])).sum().backward()
    out["row"] = (y.detach(), summed(x.grad), w1.grad[:, rank * mid:
                                                      (rank + 1) * mid],
                  w2.grad[rank * mid:(rank + 1) * mid])
    # Row parallel scattering the sequence (dim -2).
    h = t("h")[..., rank * mid:(rank + 1) * mid].detach().requires_grad_()
    w2 = t("w2")
    w2s = w2[rank * mid:(rank + 1) * mid]
    y = tp.row_parallel(h, w2s, group, scatter_sequence=True)
    (y * torch.from_numpy(data["ct_scatter"][rank])).sum().backward()
    out["scatter"] = (y.detach(), h.grad, w2.grad[rank * mid:
                                                  (rank + 1) * mid])
    # Gather the sequence.
    s = data["seq"].shape[1] // n
    xs = torch.from_numpy(data["seq"][:, rank * s:(rank + 1) * s].copy()
                          ).requires_grad_()
    y = tp.gather_sequence(xs, group, dim=1)
    (y * torch.from_numpy(data["ct_gather"][rank])).sum().backward()
    out["gather"] = (y.detach(), xs.grad)
    # Vocab-parallel logits and cross entropy.
    v = data["emb"].shape[0] // n
    x, emb = t("x"), t("emb")
    logits = tp.vocab_parallel_logits(x, emb[rank * v:(rank + 1) * v], group)
    ce = tp.vocab_parallel_cross_entropy(
        logits, torch.from_numpy(data["labels"]), v, group)
    (ce * torch.from_numpy(data["ct_ce"][rank])).sum().backward()
    out["ce"] = (ce.detach(), summed(x.grad),
                 emb.grad[rank * v:(rank + 1) * v])
    return out


def _pipe_units(torch, pp, group, data, rank):
    """Toy tanh stages over the 4 members: the last stage's output and
    the gradients of sum(out**2) on the last stage (x's summed over the
    stages: only stage 0's is nonzero)."""
    import torch.distributed as dist

    def stage_fn(w, a):
        return torch.tanh(a @ w["w"])

    out = {}
    for sched, remat, n_micro in PIPE_CASES:
        w = torch.from_numpy(data["ws"][rank].copy()).requires_grad_()
        x = torch.from_numpy(data["xs"][:n_micro].copy()).requires_grad_()
        if sched == "1f1b":
            y = pp.pipeline_apply_1f1b(stage_fn, {"w": w}, x, group)
        else:
            y = pp.pipeline_apply(stage_fn, {"w": w}, x, group, remat=remat)
        loss = (y ** 2).sum() * pp.last_stage_mask(group)
        loss.backward()
        dist.all_reduce(x.grad, group=group)
        out[(sched, remat, n_micro)] = (loss.detach(), y.detach(), w.grad,
                                        x.grad)
    return out


def _moe_units(torch, moe, group, data, rank):
    """moe_layer on this member's tokens and experts; the gate's gradient
    summed over the axis."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    e_local = data["w_in"].shape[0] // n
    t_local = data["x_moe"].shape[0] // n
    experts = slice(rank * e_local, (rank + 1) * e_local)
    toks = slice(rank * t_local, (rank + 1) * t_local)
    out = {}
    for name, kw in MOE_UNIT_CASES.items():
        gate = torch.from_numpy(data["gate"].copy()).requires_grad_()
        w_in = torch.from_numpy(data["w_in"][experts].copy()
                                ).requires_grad_()
        w_out = torch.from_numpy(data["w_out"][experts].copy()
                                 ).requires_grad_()
        x = torch.from_numpy(data["x_moe"][toks].copy()).requires_grad_()
        y, stats = moe.moe_layer(moe.MoEParams(gate, w_in, w_out), x, group,
                                 return_stats=True, **kw)
        (y * torch.from_numpy(data["ct_moe"][toks])).sum().backward()
        dist.all_reduce(gate.grad, group=group)
        out[name] = dict(out=y.detach(), x=x.grad, gate=gate.grad,
                         w_in=w_in.grad, w_out=w_out.grad,
                         dropped=stats.dropped.item(),
                         aux=stats.aux_loss.item(), capacity=stats.capacity)
    return out


def units_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "units.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_units4", 2)
    from horovod_tpu_torch.parallel import moe
    from horovod_tpu_torch.parallel import pipeline as pp
    from horovod_tpu_torch.parallel import tensor_parallel as tp
    res = {}
    try:
        group = hvd.parallel.create_mesh({"ax": world}).get_group("ax")
        res["tp"] = _tp_units(torch, tp, group, data, rank)
        res["pipe"] = _pipe_units(torch, pp, group, data, rank)
        res["moe"] = _moe_units(torch, moe, group, data, rank)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"units{rank}.pt"))
