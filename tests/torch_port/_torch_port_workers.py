"""Worker bodies for the port's multi-process gloo tests
(tests/torch_port/test_torch_port_train.py, and the four-rank pool of
test_torch_port_collectives.py and test_torch_port_compressed_optimizer.py,
``four_rank_pool``).  Kept out of the test modules so spawned workers
import torch and the port only, not JAX."""

import io
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
    cfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
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
        # ZeRO's shards are rank-distinct: the broadcast must refuse them.
        zp = torch.nn.Parameter(torch.zeros(6))
        zero = hvd.ZeroShardedOptimizer([zp], torch.optim.Adam)
        zp.grad = torch.ones(6)
        zero.step()
        (shard,) = zero.shards
        zero.optimizer.state[shard]["exp_avg"].fill_(1.0 + rank)
        try:
            hvd.broadcast_optimizer_state(zero)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        res["zero_broadcast"] = [refusal, [
            zero.optimizer.state[shard]["exp_avg"].tolist()]]
        res["allreduce_gradients"] = {
            k: v.tolist() for k, v in hvd.allreduce_gradients(
                {"a": x, "b": x * 2}).items()}
        res.update(_train_step_loss(rank, world, out_dir))
    finally:
        hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# Four ranks on a 2 x 2 (cross, local) topology: the collective API
# ---------------------------------------------------------------------------

WIRES = ("int8", "int4", "bf16", "fp16")


def _topology_env(rank: int, world: int, local_size: int) -> None:
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
        "HOROVOD_LOCAL_RANK": str(rank % local_size),
        "HOROVOD_LOCAL_SIZE": str(local_size),
        "HOROVOD_CROSS_RANK": str(rank // local_size),
        "HOROVOD_CROSS_SIZE": str(world // local_size)})
    for knob in ("HVD_TPU_COMPRESSION", "HOROVOD_COMPRESSION",
                 "HVD_TPU_QUANT_BLOCK", "HOROVOD_QUANT_BLOCK"):
        os.environ.pop(knob, None)


def compressed_cases(hvd, Q, x, rs, ag):
    """The compressed schedules on this rank's inputs, keyed as the test
    module keys the reference's: (x (5, 130) for allreduce, rs (8, 33)
    for reducescatter, ag (3, 50) for allgather)."""
    import torch
    ops = {"sum": hvd.Sum, "average": hvd.Average}
    out = {}
    for wire in WIRES:
        for op in ("sum", "average"):
            out[f"allreduce-{wire}-{op}"] = hvd.allreduce(
                x, op=ops[op], compression=wire)
    out["allreduce-int8-scaled"] = hvd.allreduce(
        x, prescale_factor=0.5, postscale_factor=3.0, compression="int8")
    for wire in ("int8", "bf16"):
        out[f"allreduce-{wire}-bf16input"] = hvd.allreduce(
            x.to(torch.bfloat16), op=hvd.Sum, compression=wire)
    for wire, op in (("int8", "sum"), ("int4", "sum"), ("bf16", "sum"),
                     ("int8", "average")):
        out[f"hier-{wire}-{op}"] = hvd.allreduce(
            x, op=ops[op], axis_name=("local", "cross"), compression=wire)
    for wire, op in (("int8", "sum"), ("int8", "average"), ("int4", "sum"),
                     ("bf16", "average")):
        out[f"reducescatter-{wire}-{op}"] = hvd.reducescatter(
            rs, op=ops[op], compression=wire)
    specs = {"int8": dict(spec=Q.QuantSpec(8, 256)),
             "int4": dict(spec=Q.QuantSpec(4, 256)),
             "bf16": dict(wire_dtype=torch.bfloat16)}
    for wire, axis in (("int8", "world"), ("int4", "world"),
                       ("bf16", "world"), ("int8", "nested"),
                       ("int4", "nested"), ("bf16", "nested")):
        out[f"allgather-{wire}-{axis}"] = Q.compressed_allgather(
            ag, None if axis == "world" else ("local", "cross"),
            **specs[wire])
    return out


def _record_wire(dist, log):
    """Wrap the two calls the compressed schedules move bytes with; each
    call appends (name, dtype, numel of what this rank sends)."""
    saved = dist.all_to_all_single, dist.all_gather_into_tensor

    def a2a(out, inp, *args, **kwargs):
        log.append(("all_to_all_single", str(inp.dtype), inp.numel()))
        return saved[0](out, inp, *args, **kwargs)

    def gather(out, inp, *args, **kwargs):
        log.append(("all_gather_into_tensor", str(inp.dtype), inp.numel()))
        return saved[1](out, inp, *args, **kwargs)

    dist.all_to_all_single, dist.all_gather_into_tensor = a2a, gather
    return saved


def four_rank_collectives(rank: int, world: int, init_method: str,
                          out_dir: str) -> None:
    """The collective API on four gloo ranks laid out 2 x 2; the results go
    to ``out_dir/collectives<r>.pt``."""
    _topology_env(rank, world, local_size=2)
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import quantization as Q

    torch.set_num_threads(1)   # four ranks share the host's cores
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    x, rs, ag = (torch.from_numpy(data[k][rank]) for k in ("x", "rs", "ag"))
    hvd.init(device="cpu", init_method=init_method)
    res = {}
    try:
        res["compressed"] = compressed_cases(hvd, Q, x, rs, ag)

        # Wire bytes of one compressed allreduce of 2048 elements: what
        # this rank sends on each pass.
        for wire in WIRES:
            log = []
            saved = _record_wire(dist, log)
            try:
                hvd.allreduce(torch.ones(2048), compression=wire)
            finally:
                dist.all_to_all_single, dist.all_gather_into_tensor = saved
            res[f"wire-{wire}"] = log

        # A compressed group goes member by member.
        res["grouped-int8"] = hvd.grouped_allreduce(
            [x, rs], op=hvd.Sum, compression="int8")
        res["rs-allreduce-int8"] = hvd.allreduce(rs, op=hvd.Sum,
                                                 compression="int8")

        # Uncompressed collectives.
        mine = torch.arange(3.0 * (rank + 1)).view(rank + 1, 3) + 100 * rank
        res["allgather-unequal"] = hvd.allgather(mine)
        res["allgather-joint"] = hvd.allgather(
            mine, axis_name=("local", "cross"))
        splits = [(rank + d) % 3 for d in range(world)]
        rows = torch.arange(float(sum(splits)))[:, None] * 10 + rank
        res["alltoall"] = hvd.alltoall(rows, splits=splits)
        res["alltoall-equal"] = hvd.alltoall(torch.arange(8.0) + 8 * rank)
        ints = torch.arange(8, dtype=torch.int32) * (rank + 1) + rank
        res["reducescatter-sum"] = hvd.reducescatter(ints.float(), op=hvd.Sum)
        res["reducescatter-int-average"] = hvd.reducescatter(ints)
        # Ops other than Sum reduce as Average (the reference's eager path).
        res["reducescatter-other-ops"] = {
            name: hvd.reducescatter(x[:4], op=op) for name, op in
            (("max", hvd.Max), ("min", hvd.Min), ("product", hvd.Product),
             ("average", hvd.Average))}
        # The joint axis: members counted local-major, as the reference's
        # ("local", "cross") mesh axis counts them.
        joint = ("local", "cross")
        res["joint"] = {
            "broadcast": hvd.broadcast(x, root_rank=1, axis_name=joint),
            "alltoall": hvd.alltoall(rs, axis_name=joint),
            "alltoall-splits": hvd.alltoall(rows, splits=splits,
                                            axis_name=joint),
            "reducescatter": hvd.reducescatter(rs, axis_name=joint),
            "reducescatter-sum": hvd.reducescatter(rs, op=hvd.Sum,
                                                   axis_name=joint),
            "reducescatter-int8": hvd.reducescatter(
                rs, axis_name=joint, compression="int8")}
        handles = {
            "allreduce": hvd.allreduce_async(x, op=hvd.Sum,
                                             postscale_factor=0.5),
            "allreduce-int8": hvd.allreduce_async(x, compression="int8"),
            "allgather": hvd.allgather_async(mine),
            "broadcast": hvd.broadcast_async(mine[:1], root_rank=3),
            "alltoall": hvd.alltoall_async(rows, splits=splits),
        }
        res["poll"] = {k: isinstance(hvd.poll(h), bool)
                       for k, h in handles.items()}
        res["async"] = {k: hvd.synchronize(h) for k, h in handles.items()}
        res["join"] = hvd.join()
        hvd.barrier()
        res["broadcast_object"] = hvd.broadcast_object(
            {"from": rank, "list": [rank] * 3}, root_rank=2)
        res["allgather_object"] = hvd.allgather_object(("rank", rank) * rank)

        errors = {}
        for label, call in (
                ("int-explicit", lambda: hvd.allreduce(
                    ints, compression="int8")),
                ("min-explicit", lambda: hvd.allreduce(
                    x, op=hvd.Min, compression=hvd.Compression.int4)),
                ("rs-int-explicit", lambda: hvd.reducescatter(
                    ints, compression="bf16")),
                ("rs-max", lambda: hvd.reducescatter(
                    x[:4], op=hvd.Max, compression="int8")),
                ("rs-ragged", lambda: hvd.reducescatter(x)),
                ("axis", lambda: hvd.allreduce(x, axis_name="data"))):
            try:
                call()
                errors[label] = None
            except ValueError as e:
                errors[label] = str(e)
        res["errors"] = errors
    finally:
        hvd.shutdown()

    # The session knob: a direct allreduce goes on the int8 wire; an
    # integer tensor, Max and the optimizer are left alone.
    os.environ["HVD_TPU_COMPRESSION"] = "int8"
    hvd.init(device="cpu", init_method=init_method + "_knob")
    try:
        w = torch.nn.Parameter(x.clone())
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.0))
        w.grad = x.clone()
        opt.step()
        res["knob"] = {"allreduce": hvd.allreduce(x),
                       "explicit": hvd.allreduce(x, compression="int8"),
                       "int": hvd.allreduce(ints),
                       "max": hvd.allreduce(x, op=hvd.Max),
                       "grouped": hvd.grouped_allreduce([x, ints]),
                       "optimizer": w.grad.clone()}
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"collectives{rank}.pt"))


def uneven_layout(rank: int, world: int, init_method: str,
                  out_dir: str) -> None:
    """Three gloo ranks laid out as the launcher lays out hosts of 2 and 1
    slots (``-H h1:2,h2:1``): local sizes 2, 2, 1 and cross size 2, no
    grid.  init() and the world's collectives work; the ("local",
    "cross") axis is refused on every rank.  The results go to
    ``out_dir/uneven<r>.pt``."""
    local_rank, cross_rank = [(0, 0), (1, 0), (0, 1)][rank]
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(world),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(2 - cross_rank),
        "HOROVOD_CROSS_RANK": str(cross_rank), "HOROVOD_CROSS_SIZE": "2"})
    os.environ.pop("HVD_TPU_COMPRESSION", None)
    import torch
    import horovod_tpu_torch as hvd

    x = torch.arange(600.0).view(2, 300) / 7 * (rank + 1)
    hvd.init(device="cpu", init_method=init_method)
    res = {}
    try:
        res["topology"] = [hvd.rank(), hvd.size(), hvd.local_rank(),
                           hvd.local_size(), hvd.cross_rank(),
                           hvd.cross_size()]
        res["sum"] = hvd.allreduce(x, op=hvd.Sum)
        res["int8"] = hvd.allreduce(x, op=hvd.Sum, compression="int8")
        res["allgather"] = hvd.allgather(x[:rank + 1])
        try:
            hvd.allreduce(x, axis_name=("local", "cross"),
                          compression="int8")
            res["joint"] = None
        except ValueError as e:
            res["joint"] = str(e)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"uneven{rank}.pt"))


# ---------------------------------------------------------------------------
# Two ranks: the compressing DistributedOptimizer, grad / value_and_grad
# ---------------------------------------------------------------------------

OPT_CASES = [("int8", 1), ("int4", 1), ("bf16", 1), ("int4", 2)]
PARAMS = ("w", "b")


def _sgd_run(hvd, torch, data, rank, wire, bpps, n_passes, momentum=0.0):
    """SGD(0.1) through a DistributedOptimizer on the wire, fed this rank's
    seeded gradients; returns the optimizer, its parameters and, after
    each pass, the parameters and residuals."""
    ps = [torch.nn.Parameter(torch.from_numpy(data[k].copy())) for k in PARAMS]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(ps, lr=0.1, momentum=momentum), compression=wire,
        backward_passes_per_step=bpps)
    traj = []
    for s in range(n_passes):
        for p, k in zip(ps, PARAMS):
            p.grad = torch.from_numpy(data[f"g_{k}"][s, rank].copy())
        opt.step()
        traj.append({"params": [p.detach().clone() for p in ps],
                     "residual": None if opt.residual is None
                     else [r.clone() for r in opt.residual]})
    return opt, ps, traj


def two_rank_optimizer(rank: int, world: int, init_method: str,
                       out_dir: str) -> None:
    """The compressing DistributedOptimizer's trajectories, a state_dict
    round trip, and grad / value_and_grad of the small transformer's loss
    on this rank's batch shard; the results go to
    ``out_dir/optimizer<r>.pt``."""
    _topology_env(rank, world, local_size=world)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm

    torch.set_num_threads(1)   # the ranks share the host's cores
    data = np.load(os.path.join(out_dir, "opt.npz"))
    hvd.init(device="cpu", init_method=init_method)
    res = {}
    try:
        for wire, bpps in OPT_CASES:
            res[f"{wire}-bpps{bpps}"] = _sgd_run(
                hvd, torch, data, rank, wire, bpps, 3 * bpps)[2]

        # state_dict() -> torch.save -> torch.load -> load_state_dict() into
        # a fresh wrapper: the residual and the inner momentum come back;
        # the next step agrees.
        opt, ps, _ = _sgd_run(hvd, torch, data, rank, "int4", 1, 2,
                              momentum=0.9)
        buf = io.BytesIO()
        torch.save(opt.state_dict(), buf)
        buf.seek(0)
        sd = torch.load(buf)
        ps2 = [torch.nn.Parameter(p.detach().clone()) for p in ps]
        opt2 = hvd.DistributedOptimizer(
            torch.optim.SGD(ps2, lr=0.1, momentum=0.9), compression="int4")
        opt2.load_state_dict(sd)
        res["roundtrip"] = {
            "keys": sorted(sd),
            "residual": [r.clone() for r in opt.residual],
            "loaded_residual": [r.clone() for r in opt2.residual],
            "momentum": [opt.state[p]["momentum_buffer"].clone()
                         for p in ps],
            "loaded_momentum": [opt2.state[p]["momentum_buffer"].clone()
                                for p in ps2]}
        for o, group in ((opt, ps), (opt2, ps2)):
            for p, k in zip(group, PARAMS):
                p.grad = torch.from_numpy(data[f"g_{k}"][2, rank].copy())
            o.step()
        res["roundtrip"]["next"] = [[p.detach() for p in ps],
                                    [p.detach() for p in ps2]]

        lm = np.load(os.path.join(out_dir, "lm.npz"))
        cfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
                                    **json.loads(str(lm["cfg"])))
        model = tfm.Transformer(cfg, device="cpu")
        model.load_state_dict({k[len("param."):]: torch.from_numpy(lm[k])
                               for k in lm.files if k.startswith("param.")})
        shard = len(lm["tokens"]) // world
        tokens, labels = (torch.from_numpy(lm[k][rank * shard:
                                                 (rank + 1) * shard])
                          for k in ("tokens", "labels"))
        params = {n: p.detach() for n, p in model.named_parameters()}

        def loss(p, tok, lab):
            return torch.func.functional_call(model, p, (tok, lab))

        value, grads = hvd.value_and_grad(loss)(params, tokens, labels)
        res["value"], res["value_and_grad"] = value, grads
        res["grad"] = hvd.grad(loss, argnums=0)(params, tokens, labels)
        res["grad_int8"] = hvd.grad(loss, compression="int8")(
            params, tokens, labels)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"optimizer{rank}.pt"))


def world_one_feedback(out_dir: str) -> None:
    """One process (world 1): the int8 optimizer's residual and
    synchronised gradient after each of two steps, at prescale 1 and 0.5,
    on rank 0's seeded gradients; the results go to
    ``out_dir/feedback0.pt``."""
    _topology_env(0, 1, local_size=1)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    data = np.load(os.path.join(out_dir, "opt.npz"))
    hvd.init(device="cpu")
    res = {}
    try:
        for prescale in (1.0, 0.5):
            w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([w], lr=0.0), compression="int8",
                prescale_factor=prescale)
            res[prescale] = []
            for s in range(2):
                w.grad = torch.from_numpy(data["g_w"][s, 0].copy())
                opt.step()
                res[prescale].append((opt.residual[0].clone(),
                                      w.grad.clone()))
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, "feedback0.pt"))


def four_rank_pool(rank: int, world: int, rendezvous: str,
                   out_dir: str) -> None:
    """One spawn of four ranks for the multi-rank parity tests: the
    collective API on all four, then the uneven layout on ranks 0-2, the
    compressing optimizer on ranks 0-1 and the same at world 1 on rank 3,
    each in a world of its own (``rendezvous`` is a path prefix for the
    file rendezvous)."""
    four_rank_collectives(rank, world, f"file://{rendezvous}_collectives",
                          out_dir)
    if rank == 3:
        world_one_feedback(out_dir)
    if rank < 3:
        uneven_layout(rank, 3, f"file://{rendezvous}_uneven", out_dir)
    if rank < 2:
        two_rank_optimizer(rank, 2, f"file://{rendezvous}_optimizer",
                           out_dir)
