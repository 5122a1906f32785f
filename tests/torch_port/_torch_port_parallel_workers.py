"""Worker bodies of the port's GSPMD-plane and sequence-parallel tests
(test_torch_port_gspmd.py, test_torch_port_ring.py): four gloo ranks,
started once per part and test process by
``_torch_port_pool.part_results``, each writing ``<part><rank>.pt``.
Torch and the port only: the ranks must not import JAX."""

import os

from _torch_port_training_workers import _init

STAGES = (1, 2, 3)
GSPMD_CASES = [(s, c) for s in STAGES for c in (None, "none", "int8")]
PARAM_KEYS = ("b", "c", "w")


def gspmd_loss(p, batch):
    """The reference's stage-parity toy (tests/test_zero_stages.py) with
    one more leaf, ``c``, whose dim 0 (5) does not divide the world."""
    (x,) = batch
    return ((x @ p["w"]) ** 2).mean() * 0.1 + (p["b"] ** 2).sum() + \
        (p["c"] ** 2).sum()


def _adamw(torch):
    return lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-3)


def _gspmd_state(torch, hvd, G, data, rank, stage, comp, steps):
    """The toy's parameters and state after ``steps`` GSPMD steps on this
    rank's batch rows, and the last loss."""
    params = {k: torch.from_numpy(data["param." + k].copy())
              for k in PARAM_KEYS}
    x = torch.from_numpy(data["x"][rank].copy())
    fns = G.make_zero_train_step(gspmd_loss, _adamw(torch), hvd.mesh(),
                                 stage=stage, compression=comp)
    p, s = fns.init(params)
    loss = None
    for _ in range(steps):
        p, s, loss = fns.step(p, s, (x,))
    return p, s, loss


def _gspmd_run(torch, hvd, G, data, rank, stage, comp, steps=2):
    p, s, loss = _gspmd_state(torch, hvd, G, data, rank, stage, comp, steps)
    opt = s.inner if comp == "int8" else s
    out = {
        "loss": loss.item(),
        "params": {k: v.full_tensor() for k, v in p.items()},
        "param_placements": {k: str(v.placements) for k, v in p.items()},
        "moment_placements": sorted({str(st[key].placements)
                                     for st in opt.optimizer.state.values()
                                     for key in ("exp_avg", "exp_avg_sq")
                                     if st[key].shape[0] % 4 == 0}),
        "report": G.residency_report((p, s), hvd.mesh()),
        "wrapped": type(s).__name__,
    }
    if comp == "int8":
        out["residual"] = {k: (r.to_local().clone(), str(r.placements),
                               tuple(r.shape))
                           for k, r in s.residual.items()}
    return out


def _state_values(G, state):
    """{key path: full value} of a GSPMD state, a DTensor's gathered."""
    import torch.distributed.tensor as dt
    return {path: (leaf.full_tensor() if isinstance(leaf, dt.DTensor)
                   else leaf).clone() for path, leaf in G._paths(state)}


def _scheduled(torch, hvd, XC, data, rank):
    """The scheduled collectives over the ("local", "cross") pair of a
    2 x 2 mesh, flat and hierarchical (the pins), on the fp32 and int8
    wires; and all_to_all_wire over "local"."""
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.ops import quantization as Q
    mesh = hvd.parallel.create_mesh({"local": 2, "cross": 2})
    pair = ("local", "cross")
    x = torch.from_numpy(data["sched_x"][rank].copy())
    rs = torch.from_numpy(data["sched_rs"][rank].copy())
    v = torch.from_numpy(data["sched_v"][rank].copy())
    out = {}
    for wire in (None, "int8"):
        spec = None if wire is None else Q.QuantSpec(8, 256)
        for pin in (False, True):
            global_state.hierarchical_allreduce_pin = pin
            global_state.hierarchical_allgather_pin = pin
            out[(wire, pin, "allreduce")] = XC.allreduce_scheduled(
                x, hvd.Sum, pair, spec=spec, mesh=mesh)
            out[(wire, pin, "allgather")] = XC.allgather_scheduled(
                x, pair, spec=spec, mesh=mesh)
        out[(wire, "reducescatter")] = XC.reducescatter_scheduled(
            rs, hvd.Average, pair, spec=spec, mesh=mesh)
        out[(wire, "all_to_all")] = XC.all_to_all_wire(v, "local", spec,
                                                       mesh=mesh)
    global_state.hierarchical_allreduce_pin = None
    global_state.hierarchical_allgather_pin = None
    return out


LEAF_SHAPES = [(32, 3), (5,), (), (8,), (4, 4)]


def _placements(torch, hvd, G):
    """leaf_spec of each shape, sharded and not; place and constrain round
    trips of the toy's parameters."""
    mesh = hvd.mesh()
    out = {}
    for shape in LEAF_SHAPES:
        for sharded in (True, False):
            out[(shape, sharded)] = str(G.leaf_spec(torch.empty(shape), mesh,
                                                    sharded))
    t = {"w": torch.arange(96.0).reshape(32, 3), "c": torch.arange(5.0)}
    placed = G.place(t, mesh, False)
    sharded = G.constrain(placed, mesh, True)
    back = G.constrain(sharded, mesh, False)
    out["constrain"] = {k: (str(sharded[k].placements),
                            sharded[k].to_local().clone(),
                            torch.equal(back[k].full_tensor(), t[k]))
                        for k in t}
    return out


def _gspmd_sgd(torch, hvd, G, data, rank):
    """Stage 3 with SGD(momentum 0.9): the trace state, its residency."""
    params = {k: torch.from_numpy(data["param." + k].copy())
              for k in PARAM_KEYS}
    x = torch.from_numpy(data["x"][rank].copy())
    fns = G.make_zero_train_step(
        gspmd_loss, lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
        hvd.mesh(), stage=3)
    p, s = fns.init(params)
    for _ in range(2):
        p, s, loss = fns.step(p, s, (x,))
    return {"loss": loss.item(),
            "params": {k: v.full_tensor() for k, v in p.items()},
            "report": G.residency_report((p, s), hvd.mesh())}


def gspmd_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "gspmd.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_gspmd4", 2)
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.ops import gspmd as G
    from horovod_tpu_torch.ops import xla_collectives as XC
    res = {}
    try:
        mesh = hvd.mesh()
        res["mesh"] = {"names": mesh.mesh_dim_names,
                       "shape": tuple(mesh.mesh.shape),
                       "grid": hvd.parallel.create_mesh(
                           {"data": 2, "model": 2}).mesh.tolist()}
        for stage, comp in GSPMD_CASES:
            res[(stage, comp)] = _gspmd_run(torch, hvd, G, data, rank,
                                            stage, comp)
        # The reference's int8 stage-2 step restored here; then this
        # package's own, written for the reference to restore.
        _, s, _ = _gspmd_state(torch, hvd, G, data, rank, 2, "int8", 0)
        ckpt.restore_zero_state(os.path.join(out_dir, "ref_int8"), s)
        res["restored"] = _state_values(G, s)
        _, s, _ = _gspmd_state(torch, hvd, G, data, rank, 2, "int8", 3)
        ckpt.save_zero_state(os.path.join(out_dir, "port_int8"), s, step=3)
        res["saved"] = _state_values(G, s)
        res["wire"] = tuple(XC.wire_totals())
        res["scheduled"] = _scheduled(torch, hvd, XC, data, rank)
        res["placement"] = _placements(torch, hvd, G)
        res["sgd"] = _gspmd_sgd(torch, hvd, G, data, rank)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"gspmd{rank}.pt"))


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def ring_part(rank, world, rendezvous, out_dir):
    import numpy as np
    data = np.load(os.path.join(out_dir, "ring.npz"))
    torch, hvd = _init(rank, world, f"file://{rendezvous}_ring4", 2)
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.parallel import ulysses
    res = {}
    try:
        mesh = hvd.parallel.create_mesh({"sp": world})
        group = mesh.get_group("sp")
        s_local = data["q"].shape[1] // world
        rows = slice(rank * s_local, (rank + 1) * s_local)
        fns = {"ring": ra.ring_attention, "ulysses": ulysses.ulysses_attention}
        for flash in ("0", "1"):
            os.environ["HVD_TPU_FLASH"] = flash
            for causal in (True, False):
                for name, fn in fns.items():
                    q, k, v = (torch.from_numpy(data[n][:, rows].copy())
                               .requires_grad_() for n in ("q", "k", "v"))
                    out = fn(q, k, v, group, causal=causal)
                    (out * torch.from_numpy(data["ct"][:, rows].copy())
                     ).sum().backward()
                    res[(name, flash, causal)] = (
                        out.detach(), q.grad, k.grad, v.grad)
        os.environ.pop("HVD_TPU_FLASH")
        q = torch.zeros(1, 8, 3, 4)     # 3 heads over 4 members
        try:
            ulysses.ulysses_attention(q, q, q, group)
            res["indivisible"] = None
        except ValueError as e:
            res["indivisible"] = str(e)
    finally:
        hvd.shutdown()
    torch.save(res, os.path.join(out_dir, f"ring{rank}.pt"))
