"""Worker body of the torch front end's two-rank test
(test_torch_port_torch_frontend.py): ``horovod_tpu_torch.torch`` on two
gloo ranks, then on the same ranks with the native controller attached.
``_torch_port_pool.part_results`` starts the ranks once per test
process; the body writes ``frontend<rank>.pt``.  Torch and the port only:
the ranks must not import JAX."""

import json
import os

import numpy as np

from _torch_port_workers import _topology_env

WORLD = 2
STEPS = 3
JOIN_STEPS = (3, 2)        # rank 0 trains three batches, rank 1 two
OPTIMIZERS = ("sgd", "adam")
COMPRESSIONS = ("none", "fp16", "bf16")


def make_linear(torch, data):
    model = torch.nn.Linear(5, 3)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(data["w"]))
        model.bias.copy_(torch.from_numpy(data["b"]))
    return model


def make_optimizer(torch, kind, params):
    if kind == "sgd":
        return torch.optim.SGD(params, lr=0.1, momentum=0.9)
    return torch.optim.Adam(params, lr=0.01)


def linear_loss(torch, model, x):
    return (model(torch.from_numpy(x)) ** 2).mean()


def make_embedding(torch, data):
    emb = torch.nn.Embedding(10, 4, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(data["emb"]))
    return emb


def embedding_loss(torch, emb, idx):
    return (emb(torch.from_numpy(idx)) ** 2).sum()


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def gloo_cases(torch, hvd, data, rank):
    res = {}
    for kind in OPTIMIZERS:
        for comp in COMPRESSIONS:
            model = make_linear(torch, data)
            opt = hvd.DistributedOptimizer(
                make_optimizer(torch, kind, model.parameters()),
                named_parameters=model.named_parameters(),
                compression=getattr(hvd.Compression, comp))
            for step in range(STEPS):
                linear_loss(torch, model, data["x"][step, rank]).backward()
                opt.step()
                opt.zero_grad()
            res[f"opt-{kind}-{comp}"] = _params(model)
    for dense in (False, True):
        emb = make_embedding(torch, data)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.1),
            named_parameters=emb.named_parameters(), sparse_as_dense=dense)
        for step in range(STEPS):
            embedding_loss(torch, emb, data["idx"][step, rank]).backward()
            opt.step()
            opt.zero_grad()
        res[f"sparse-{dense}"] = _params(emb)
    # sparse_allreduce of distinct rows per rank
    idx = torch.from_numpy(data["idx"][0, rank]).unsqueeze(0)
    vals = torch.from_numpy(data["emb"][data["idx"][0, rank]])
    sp = torch.sparse_coo_tensor(idx, vals, (10, 4))
    res["sparse_allreduce"] = hvd.sparse_allreduce(sp, name="sp").to_dense()
    # SyncBatchNorm over both ranks' batches
    bn = hvd.SyncBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["bn_w"]))
        bn.bias.copy_(torch.from_numpy(data["bn_b"]))
    x = torch.from_numpy(data["bn_x"][rank]).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(data["bn_ct"][rank])).sum().backward()
    res["sbn"] = [out.detach(), x.grad, bn.weight.grad, bn.bias.grad,
                  bn.running_mean.clone(), bn.running_var.clone()]
    # Adasum's delta model
    model = make_linear(torch, data)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    linear_loss(torch, model, data["x"][0, rank]).backward()
    opt.step()
    res["adasum"] = _params(model)
    # The differentiable allgather of unequal rows, and its gradient.
    x = torch.from_numpy(data["x"][0, rank][: rank + 2]).requires_grad_()
    g = hvd.allgather(x, name="ag")
    (g * torch.arange(g.numel(), dtype=g.dtype).view_as(g)).sum().backward()
    res["allgather"] = (g.detach(), x.grad)
    res["torch_state"] = torch_state_case(torch, data, rank)
    res["opt_state"] = optimizer_state_case(torch, hvd, data, rank)
    return res


def _holds_tensor(obj) -> bool:
    if hasattr(obj, "dtype") and hasattr(obj, "shape") and \
            type(obj).__module__.startswith("torch"):
        return True
    if isinstance(obj, dict):
        return any(_holds_tensor(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_holds_tensor(v) for v in obj)
    return False


def torch_state_case(torch, data, rank):
    """``TorchState.sync`` to a member whose optimizer holds no state yet
    (rank 1, as a respawned worker): the root's model, Adam state and
    objects, with no tensor in what ``broadcast_object`` pickles."""
    from horovod_tpu_torch.torch import elastic as E
    pickled = []
    real = E.broadcast_object

    def spy(obj, *args, **kwargs):
        pickled.append(_holds_tensor(obj))
        return real(obj, *args, **kwargs)

    E.broadcast_object = spy
    try:
        model = make_linear(torch, data)
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        if rank == 0:
            linear_loss(torch, model, data["x"][0, 0]).backward()
            opt.step()
            opt.zero_grad()
        state = E.TorchState(model=model, optimizer=opt, epoch=rank + 3)
        state.sync()
        sd = opt.state_dict()
        return {"params": _params(model), "epoch": state.epoch,
                "opt_state": {f"{pid}.{k}": v for pid, st in
                              sd["state"].items() for k, v in st.items()},
                "pickled_tensor": any(pickled), "pickles": len(pickled)}
    finally:
        E.broadcast_object = real


def optimizer_state_case(torch, hvd, data, rank):
    """``broadcast_optimizer_state`` to a member whose optimizer holds no
    state yet (rank 1): every rank ends with rank 0's Adam state."""
    model = make_linear(torch, data)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    if rank == 0:
        linear_loss(torch, model, data["x"][1, 0]).backward()
        opt.step()
        opt.zero_grad()
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    sd = opt.state_dict()
    return {"state": {f"{pid}.{k}": v for pid, st in sd["state"].items()
                      for k, v in st.items()},
            "groups": sd["param_groups"]}


def join_case(torch, hvd, data, rank):
    model = make_linear(torch, data)
    opt = hvd.DistributedOptimizer(
        make_optimizer(torch, "sgd", model.parameters()),
        named_parameters=model.named_parameters())
    for step in range(JOIN_STEPS[rank]):
        linear_loss(torch, model, data["x"][step, rank]).backward()
        opt.step()
        opt.zero_grad()
    last = hvd.join()
    return {"join": _params(model), "join_last": last}


def frontend_part(rank, world, rendezvous, out_dir):
    data = dict(np.load(os.path.join(out_dir, "frontend.npz")))
    _topology_env(rank, world, 1)
    import torch
    import horovod_tpu_torch.torch as hvd
    torch.set_num_threads(1)   # the ranks share the host's cores
    hvd.init(device="cpu", init_method=f"file://{rendezvous}")
    res = gloo_cases(torch, hvd, data, rank)
    hvd.shutdown()
    with open(os.path.join(out_dir, "ports.json")) as f:
        port = json.load(f)[0]
    os.environ.update({"HVD_TPU_CONTROLLER_ADDR": f"127.0.0.1:{port}",
                       "HVD_TPU_CYCLE_TIME": "1"})
    hvd.init(device="cpu", init_method=f"file://{out_dir}/rendezvous_ctl")
    res.update(join_case(torch, hvd, data, rank))
    hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"frontend{rank}.pt"))
