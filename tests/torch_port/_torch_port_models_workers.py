"""Worker bodies of the port's model tests (test_torch_port_resnet.py,
test_torch_port_bert.py, test_torch_port_moe_transformer.py): four gloo
ranks, started once per part and test process by
``_torch_port_pool.part_results``, each writing ``<part><rank>.pt``.
Torch and the port only: the ranks must not import JAX.  The case tables
are plain data, read by the test modules too."""

import os

from _torch_port_training_workers import _init

# ResNet-18 at width 8, 10 classes, 32x32 images, fp32; a global batch of
# 16 images, 4 a rank, batch norm synchronised over the world.
RESNET = dict(depth=18, num_classes=10, width=8)
RESNET_BATCH, RESNET_IMAGE = 16, 32

# BERT at the reference test's size (tests/test_bert.py), fp32; a global
# batch of 8 sequences on a (dp, mp) = (2, 2) mesh.
BERT = dict(vocab_size=211, d_model=32, n_heads=4, d_ff=64, n_layers=2,
            seq_len=16)
BERT_BATCH = 8
BERT_MESH = (2, 2)
# name: (gathered head, remat)
BERT_CASES = {"dense": (False, False), "gathered": (True, False),
              "dense_dots": (False, "dots"), "gathered_full": (True, True)}

# The MoE transformer: fp32, vocab 61, d 32, 4 heads, per-expert d_ff 48,
# 2 layers, seq 16, 8 experts, top_k 1, capacity factor 1.0 (so that
# routes drop), 32-element wire blocks; a global batch of 8 sequences.
MOET = dict(vocab_size=61, d_model=32, n_heads=4, d_ff=48, n_layers=2,
            seq_len=16, n_experts=8, top_k=1, capacity_factor=1.0,
            dispatch_block=32)
MOET_BATCH = 8
# name: ((dp, ep), dispatch_bits)
MOET_CASES = {f"dp{dp}_ep{ep}_b{bits}": ((dp, ep), bits)
              for dp, ep in ((2, 2), (1, 4)) for bits in (0, 8, 4)}
MOET_METERED = "dp2_ep2_b8"      # one SGD step, its wire bytes counted
LR = 0.1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _load(torch, out_dir, name):
    import numpy as np
    flat = np.load(os.path.join(out_dir, f"{name}.npz"))
    return {k: torch.from_numpy(flat[k].copy()) for k in flat.files}


# ---------------------------------------------------------------------------
# ResNet: synchronised batch norm at dp 4
# ---------------------------------------------------------------------------

def resnet_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "resnet.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_resnet4", 2)
    import torch.distributed as dist
    from horovod_tpu_torch.models import resnet
    try:
        cfg = resnet.ResNetConfig(dtype=torch.float32, sync_bn_axis="data",
                                  **RESNET)
        model = resnet.ResNet(cfg, device="cpu")
        model.load_state_dict(_load(torch, out_dir, "resnet_state"))
        rows = slice(rank * RESNET_BATCH // world,
                     (rank + 1) * RESNET_BATCH // world)
        logits = model(torch.from_numpy(data["images"][rows].copy()))
        loss = resnet.cross_entropy_loss(
            logits, torch.from_numpy(data["labels"][rows].copy()))
        loss.backward()
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad.clone()
            dist.all_reduce(g)
            grads[n] = g / world
        res = {"logits": logits.detach(), "grads": grads,
               "stats": {n: b.clone() for n, b in model.named_buffers()}}
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"resnet{rank}.pt"))


# ---------------------------------------------------------------------------
# BERT on a (dp, mp) = (2, 2) mesh
# ---------------------------------------------------------------------------

def bert_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "bert.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_bert4", 2)
    from horovod_tpu_torch.models import bert
    res = {}
    try:
        dp, mp = BERT_MESH
        mesh = hvd.parallel.create_mesh({"dp": dp, "mp": mp})
        full = _load(torch, out_dir, "bert_params")
        i = mesh.get_coordinate()[0]
        rows = slice(i * BERT_BATCH // dp, (i + 1) * BERT_BATCH // dp)

        def t(name):
            return torch.from_numpy(data[name][rows].copy())

        for name, (gathered, remat) in BERT_CASES.items():
            cfg = bert.BertConfig(dtype=torch.float32, remat=remat, **BERT)
            model = bert.Bert(cfg, device="cpu", mesh=mesh)
            model.load_state_dict(_flat(bert.shard_params(
                cfg, _nest(full), mesh)))
            batch = (t("mlm_inputs"), t("positions"), t("mlm_labels")) \
                if gathered else (t("inputs"), t("labels"))
            loss = bert.make_loss_fn(cfg, mesh, gathered=gathered)(
                model, *batch)
            loss.backward()
            grads = bert.gather_params(
                cfg, {**{k: getattr(model, k).grad for k in bert._TOP},
                      "layers": {k: p.grad for k, p in
                                 model.layers.items()}}, mesh)
            res[name] = {"loss": loss.detach(), "grads": _flat(grads)}
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"bert{rank}.pt"))


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# ---------------------------------------------------------------------------
# The MoE transformer on (dp, ep) = (2, 2) and (1, 4)
# ---------------------------------------------------------------------------

def _moet_run(torch, hvd, moet, meshes, full, data, name, steps=0):
    (dp, ep), bits = MOET_CASES[name]
    cfg = moet.MoEConfig(dtype=torch.float32, remat=False,
                         dispatch_bits=bits, **MOET)
    par = moet.MoEParallelConfig(dp, ep)
    if (dp, ep) not in meshes:
        meshes[(dp, ep)] = hvd.parallel.create_mesh({"dp": dp, "ep": ep})
    mesh = meshes[(dp, ep)]
    model = moet.MoETransformer(cfg, par, device="cpu", mesh=mesh)
    model.load_state_dict(_flat(moet.shard_params(cfg, par, _nest(full),
                                                  mesh)))
    i, j = mesh.get_coordinate()
    n = MOET_BATCH // (dp * ep)
    rows = slice((i * ep + j) * n, (i * ep + j + 1) * n)
    tokens = torch.from_numpy(data["tokens"][rows].copy())
    labels = torch.from_numpy(data["labels"][rows].copy())
    if steps:
        from horovod_tpu_torch.ops import xla_collectives as XC
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        step = moet.make_train_step(cfg, par, model, opt)
        before = XC.wire_totals()
        losses = [step(tokens, labels)[0].item() for _ in range(steps)]
        after = XC.wire_totals()
        return {"losses": losses, "wire": (after.raw - before.raw,
                                           after.sent - before.sent)}
    total, metrics = model(tokens, labels)
    total.backward()
    grads = moet.gather_params(cfg, par, {
        "embed": model.embed.grad, "pos": model.pos.grad,
        "final_norm": model.final_norm.grad,
        "layers": {k: p.grad for k, p in model.layers.items()}}, mesh)
    return {"loss": total.detach(), "metrics": metrics,
            "grads": _flat(grads)}


def moet_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "moet.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_moet4", 2)
    from horovod_tpu_torch.models import moe_transformer as moet
    res = {}
    try:
        meshes = {}
        full = _load(torch, out_dir, "moet_params")
        for name in MOET_CASES:
            res[name] = _moet_run(torch, hvd, moet, meshes, full, data, name)
        res["metered"] = _moet_run(torch, hvd, moet, meshes, full, data,
                                   MOET_METERED, steps=1)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"moet{rank}.pt"))
