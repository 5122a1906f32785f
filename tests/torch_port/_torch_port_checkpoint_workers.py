"""Worker body of the port's sharded-checkpoint tests
(test_torch_port_checkpoint.py) and the problem both packages train.
``_torch_port_pool.part_results`` starts four gloo ranks once per test
process; ``checkpoint_part`` runs on them and writes ``ckpt<rank>.pt``.
Torch and the port only: the ranks must not import JAX.

The problem: parameters w (4, 3), b (10,) and layers.{u (2, 3), a (7,)}
(sizes that pad at worlds 2 and 4; registered in an order that is not
the reference's sorted one), each rank its own row of x, a loss that
gives every parameter a rank-distinct gradient."""

import functools
import os

from _torch_port_training_workers import _init

# name -> (ZeRO stage, inner optimizer, wire)
CASES = {
    "s1-adamw": (1, "adamw", None),
    "s2-adamw": (2, "adamw", None),
    "s3-adamw": (3, "adamw", None),
    "s1-int8": (1, "adamw", "int8"),
    "s1-sgdm": (1, "sgdm", None),
    "s2-sgdm": (2, "sgdm", None),
    "s3-sgdm": (3, "sgdm", None),
    "s1-int8-sgdm": (1, "sgdm", "int8"),
}
NEXT2 = "s3-adamw"          # the case that also steps on at world 2
NAMES = ("w", "b", "layers.u", "layers.a")   # registration order
STEPS = 2                   # steps before the checkpoint
# torch state key -> optax field
FIELDS = (("exp_avg", "mu"), ("exp_avg_sq", "nu"),
          ("momentum_buffer", "trace"))


def model(torch, params):
    """A module holding ``params`` ({name: array}) under ``NAMES``."""
    m = torch.nn.Module()
    m.layers = torch.nn.Module()
    for name in NAMES:
        owner = m.layers if name.startswith("layers.") else m
        setattr(owner, name.split(".")[-1], torch.nn.Parameter(
            torch.from_numpy(params[name].copy())))
    # Registration order w, b, layers.u, layers.a (the submodule's
    # parameters come after the module's own in named_parameters()).
    return m


def loss(p, x):
    s = x.sum() * 0.1
    return (((x @ p["w"]) ** 2).sum() * 1e-3
            + ((p["b"] * s) ** 2).sum() * 1e-3
            + ((p["layers.u"] * x[:, :3]) ** 2).sum() * 1e-2
            + (p["layers.a"].sin() * s).sum() * 1e-2)


def optimizer(torch, hvd, m, case):
    stage, inner, wire = CASES[case]
    make = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-3) \
        if inner == "adamw" else \
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    return hvd.ZeroShardedOptimizer(m, make, stage=stage, compression=wire)


def step(m, opt, x):
    opt.zero_grad()
    if opt.stage == 3:
        loss(opt.gather_params(), x).backward()
    else:
        loss(dict(m.named_parameters()), x).backward()
        if opt.stage == 2:
            opt.reduce_grads()
    opt.step()


def full_params(torch, m, opt) -> dict:
    with torch.no_grad():
        if opt.stage == 3:
            return {k: v.clone() for k, v in opt.gather_params().items()}
        return {k: v.detach().clone() for k, v in m.named_parameters()}


def dump(opt) -> dict:
    """This rank's ZeRO state by (optax field, parameter name): the inner
    optimizer's moments, the count, the residual and, at stage 3, the
    parameter shards."""
    out = {}
    for i, name in enumerate(opt.names):
        st = opt.optimizer.state.get(opt.shards[i], {})
        for tkey, field in FIELDS:
            if st.get(tkey) is not None:
                out[(field, name)] = st[tkey].clone()
        if "step" in st:
            out[("count", None)] = float(st["step"])
        if opt.residual is not None:
            out[("residual", name)] = opt.residual[i].clone()
        if opt.stage == 3:
            out[("param", name)] = opt.shards[i].detach().clone()
    return out


def _restored(torch, hvd, data, case, root):
    """A fresh model and optimizer with the reference's step restored:
    stages 1-2 from the reference's replicated parameters after the
    steps, stage 3 from zeros (the parameter root overwrites them)."""
    stage = CASES[case][0]
    params = {n: data[f"ref{STEPS}.{case}.{n}"] if stage < 3 else
              0 * data[f"param.{n}"] for n in NAMES}
    m = model(torch, params)
    opt = optimizer(torch, hvd, m, case)
    opt.load_state_dict(os.path.join(root, "opt"),
                        params_path=os.path.join(root, "params"))
    return m, opt


def checkpoint_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "ckpt.npz"))
    initial = {n: data[f"param.{n}"] for n in NAMES}
    torch, hvd = _init(rank, world, f"file://{rendezvous}_ckpt4", 2)
    x = torch.from_numpy(data["x"][rank].copy())
    res = {}
    try:
        for case in CASES:
            # reference -> port, at the writing world
            m, opt = _restored(torch, hvd, data, case,
                               os.path.join(out_dir, "ref", case))
            res[f"{case}-restored4"] = dump(opt)
            step(m, opt, x)
            res[f"{case}-next4"] = full_params(torch, m, opt)
            # port -> reference: the port's own steps, then its checkpoint
            m = model(torch, initial)
            opt = optimizer(torch, hvd, m, case)
            for _ in range(STEPS):
                step(m, opt, x)
            root = os.path.join(out_dir, "port", case)
            opt.state_dict(os.path.join(root, "opt"), step=STEPS,
                           params_path=os.path.join(root, "params"))
            res[f"{case}-saved"] = dump(opt)
    finally:
        hvd.shutdown()
    if rank < 2:
        # reference -> port at world 2: resharded, or refused (residual)
        torch, hvd = _init(rank, 2, f"file://{rendezvous}_ckpt2", 2)
        try:
            for case in CASES:
                try:
                    m, opt = _restored(torch, hvd, data, case,
                                       os.path.join(out_dir, "ref", case))
                except ValueError as e:
                    res[f"{case}-restored2"] = str(e)
                    continue
                res[f"{case}-restored2"] = dump(opt)
                if case == NEXT2:
                    step(m, opt, x)
                    res[f"{case}-next2"] = full_params(torch, m, opt)
        finally:
            hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"ckpt{rank}.pt"))
