"""Worker bodies for the port's multi-process gloo tests
(tests/torch_port/test_torch_port_train.py).  Kept out of the test module so spawned
workers import torch and the port only, not JAX."""

import json
import os


def _train_step_loss(rank: int, world: int, out_dir: str) -> dict:
    """The transformer's training step on this rank's contiguous batch
    shard, from the parameters and batch in ``out_dir/lm.npz``: the
    shard's own loss and gradients (``serial_forward_loss``), then the loss
    ``make_train_step`` returns and the gradients after the step.  The
    gradients go to ``out_dir/rank<r>_lm_grads.pt``."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm

    data = np.load(os.path.join(out_dir, "lm.npz"))
    cfg = tfm.TransformerConfig(dtype=torch.float32,
                                **json.loads(str(data["cfg"])))
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict({k[len("param."):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("param.")})
    shard = len(data["tokens"]) // world
    tokens, labels = (torch.from_numpy(data[k][rank * shard:
                                               (rank + 1) * shard])
                      for k in ("tokens", "labels"))
    local = tfm.serial_forward_loss(cfg, model, tokens, labels)
    local.backward()
    local_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    loss = tfm.make_train_step(cfg, tfm.ParallelConfig(), model, opt)(
        tokens, labels)
    torch.save({"local": local_grads,
                "synced": {n: p.grad for n, p in model.named_parameters()}},
               os.path.join(out_dir, f"rank{rank}_lm_grads.pt"))
    return {"lm_local_loss": local.item(), "lm_step_loss": loss.item(),
            "lm_step_loss_requires_grad": loss.requires_grad}


def two_rank_checks(rank: int, world: int, init_method: str,
                    out_dir: str) -> None:
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
        "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": str(world),
        "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1"})
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", init_method=init_method)
    res = {}
    try:
        res["topology"] = [hvd.rank(), hvd.size(), hvd.local_rank(),
                           hvd.local_size(), hvd.cross_rank(),
                           hvd.cross_size()]
        x = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
        res["average"] = hvd.allreduce(x).tolist()
        res["input_untouched"] = x.tolist()
        res["sum"] = hvd.allreduce(x, op=hvd.Sum).tolist()
        res["min"] = hvd.allreduce(x, op=hvd.Min).tolist()
        res["max"] = hvd.allreduce(x, op=hvd.Max).tolist()
        res["product"] = hvd.allreduce(x, op=hvd.Product).tolist()
        ints = torch.tensor([[3, -3, 7], [4, 0, 0]][rank], dtype=torch.int32)
        avg = hvd.allreduce(ints)
        res["int_average"] = [avg.tolist(), str(avg.dtype)]
        scaled = hvd.allreduce(torch.tensor([3, 4][rank:rank + 1]),
                               op=hvd.Sum, prescale_factor=0.5)
        res["int_prescaled_sum"] = [scaled.tolist(), str(scaled.dtype)]
        res["scaled_average"] = hvd.allreduce(
            x, prescale_factor=2.0, postscale_factor=0.25).tolist()
        grouped = hvd.grouped_allreduce(
            [x, ints, x.view(3, 1) * 10], op=hvd.Sum)
        res["grouped"] = [t.tolist() for t in grouped]
        res["broadcast"] = hvd.broadcast(x, root_rank=1).tolist()

        # DistributedOptimizer: rank-specific data, averaged gradients.
        torch.manual_seed(rank)               # rank-distinct initial weights
        model = torch.nn.Linear(4, 2)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        res["params_after_broadcast"] = [p.tolist()
                                         for p in model.parameters()]
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=0.1, weight_decay=1e-4))
        data = torch.arange(8.0).view(2, 4) * (rank + 1)
        for i in range(2):
            opt.zero_grad()
            model(data).square().sum().backward()
            if i == 0:
                res["local_grad"] = [p.grad.tolist()
                                     for p in model.parameters()]
            opt.step()
            if i == 0:
                res["synced_grad"] = [p.grad.tolist()
                                      for p in model.parameters()]
                res["params_after_step"] = [p.tolist()
                                            for p in model.parameters()]
        res["params_after_steps"] = [p.tolist() for p in model.parameters()]
        if rank == 1:  # perturb the moments: the broadcast must undo it
            for st in opt.state.values():
                st["exp_avg"].add_(1.0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        res["opt_state"] = [
            [st["exp_avg"].tolist(), st["exp_avg_sq"].tolist(),
             float(st["step"])] for st in opt.state.values()]
        res["allreduce_gradients"] = {
            k: v.tolist() for k, v in hvd.allreduce_gradients(
                {"a": x, "b": x * 2}).items()}
        res.update(_train_step_loss(rank, world, out_dir))
    finally:
        hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
