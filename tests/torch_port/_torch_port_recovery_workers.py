"""Worker body of the port's peer-recovery test
(test_torch_port_recovery.py).  ``_torch_port_pool.part_results`` starts
four gloo ranks once per test process; ``recovery_part`` runs on them and
writes ``recovery<rank>.pt``.  Torch and the port only: the ranks must
not import JAX.

Each rank is its own process, as in a real job: rank 0 serves a signed
``RendezvousServer`` KV, every rank serves its ``RecoveryServer`` and
publishes it there, so every buddy copy crosses HTTP.  The small
transformer of ``lm.npz`` trains two AdamW steps at ZeRO stages 1, 2 and
3 on world 4; each stage's state commits at step 2 (``replicate`` →
``save_extracted`` → ``seal_commit``), then restores through the peer
tier and from the disk into fresh optimizers at world 4, again at world 2
(ranks 1 and 3 gone) and at world 3 (rank 2's memory emptied and gone).
World 4 also drills a buddy-pair loss, an unsealed step and a torn
copy."""

import json
import os

from _torch_port_training_workers import _init

STAGES = (1, 2, 3)
STEPS = 2                   # steps before the commit
SECRET_FILE = "secret.txt"
# The worlds re-formed after the commit: {new world: old ranks that
# survive, in new-rank order}.
REFORMED = {2: (0, 2), 3: (0, 1, 3)}
DRILL_STAGE = 2


def keys(stage):
    return [f"s{stage}.opt_state"] + ([f"s{stage}.params"] if stage == 3
                                      else [])


def _lm(torch, out_dir, rank, world):
    import numpy as np
    from horovod_tpu_torch.models import transformer as tfm
    lm = np.load(os.path.join(out_dir, "lm.npz"))
    cfg = tfm.TransformerConfig(dtype=torch.float32, remat=False,
                                **json.loads(str(lm["cfg"])))
    shard = len(lm["tokens"]) // world
    batch = [torch.from_numpy(lm[k][rank * shard:(rank + 1) * shard])
             for k in ("tokens", "labels")]
    params = {k[len("param."):]: torch.from_numpy(lm[k])
              for k in lm.files if k.startswith("param.")}
    return tfm, cfg, batch, params


def _build(torch, hvd, tfm, cfg, params, stage, scale=1.0):
    """The model with ``params`` × ``scale`` and its ZeRO AdamW."""
    import functools
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict({k: v * scale for k, v in params.items()})
    adamw = functools.partial(torch.optim.AdamW, lr=1e-2,
                              weight_decay=1e-3)
    return model, hvd.ZeroShardedOptimizer(model, adamw, stage=stage)


def trees(opt, ckpt):
    """{replica key: state tree} of one stage's optimizer."""
    out = {keys(opt.stage)[0]: opt}
    if opt.stage == 3:
        out[keys(3)[1]] = ckpt.ShardedParams(opt)
    return out


def values(ckpt, tree) -> dict:
    """{leaf path: this rank's host value} of a state tree."""
    ext = ckpt.extract_zero_state(tree)
    (vals,) = ext.rank_values.values()
    return {s.path: v for s, v in zip(ext.specs, vals)}


def _tensors(torch, vals: dict) -> dict:
    """Host values as tensors (the results file holds tensors only)."""
    return {k: torch.from_numpy(v) for k, v in vals.items()}


def specs(ckpt, tree) -> dict:
    ext = ckpt.extract_zero_state(tree)
    return {s.path: (s.kind, s.true_size) for s in ext.specs}


def _equal(a: dict, b: dict) -> bool:
    import numpy as np
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _count(registry, name) -> float:
    return sum(c.value for c in registry().children_of(name))


def _restore_all(torch, hvd, ckpt, rec, tfm, cfg, params, root, world):
    """Each stage's committed step, restored into fresh optimizers through
    the peer tier and from the disk: per key, the peer's values, whether
    they equal the disk's bit for bit, the report and the specs."""
    out = {}
    for stage in STAGES:
        _, peer_opt = _build(torch, hvd, tfm, cfg, params, stage, 0.5)
        _, disk_opt = _build(torch, hvd, tfm, cfg, params, stage, 0.5)
        peer_trees, disk_trees = trees(peer_opt, ckpt), trees(disk_opt, ckpt)
        for key in keys(stage):
            _, extra, report = rec.peer_restore(key, peer_trees[key])
            ckpt.restore_zero_state(os.path.join(root, key), disk_trees[key],
                                    step=STEPS)
            got = values(ckpt, peer_trees[key])
            on_device = {str(t.device) for st in
                         peer_opt.optimizer.state.values()
                         for t in st.values() if torch.is_tensor(t)}
            out[key] = {"peer": _tensors(torch, got), "specs": specs(ckpt, peer_trees[key]),
                        "equal_disk": _equal(got, values(
                            ckpt, disk_trees[key])),
                        "report": report.to_dict(), "extra": extra,
                        "last_report": rec.last_report() is report,
                        "devices": sorted(on_device)}
    return out


def _drills(torch, hvd, ckpt, rec, tfm, cfg, params, batch, rank):
    """At world 4, on stage ``DRILL_STAGE``'s state: an unsealed step, a
    torn copy, a buddy-pair loss (each on a key of its own)."""
    from horovod_tpu_torch.metrics.registry import registry
    model, opt = _build(torch, hvd, tfm, cfg, params, DRILL_STAGE)
    step = tfm.make_train_step(cfg, tfm.ParallelConfig(), model, opt)
    out = {}

    def commit(key, n, seal=True):
        ext = ckpt.extract_zero_state(opt)
        rec.replicate(key, n, ext)
        if seal:
            rec.seal_commit(key, n, ext)
        hvd.barrier()
        return ext, values(ckpt, opt)

    def restore(key, pin=None):
        _, like = _build(torch, hvd, tfm, cfg, params, DRILL_STAGE, 0.5)
        try:
            _, _, report = rec.peer_restore(key, like, step=pin)
        except rec.PeerRestoreUnavailable as e:
            return {"error": str(e)}
        return {"report": report.to_dict(), "values": values(ckpt, like)}

    # An unsealed step never restores; the sealed one before it does.
    step(*batch)
    _, sealed = commit("unsealed", 1)
    step(*batch)
    ext, later = commit("unsealed", 2, seal=False)
    r = restore("unsealed")
    out["unsealed"] = {"newest": r["report"]["step"],
                       "newest_is_sealed": _equal(r["values"], sealed),
                       "pinned": restore("unsealed", 2)}
    rec.seal_commit("unsealed", 2, ext)
    hvd.barrier()
    r = restore("unsealed")
    out["unsealed"]["after_seal"] = r["report"]["step"]
    out["unsealed"]["after_seal_is_later"] = _equal(r["values"], later)

    # A torn copy: rank 1's buddy copy tears on arrival at rank 2.
    os.environ["HVD_TPU_CHAOS_TORN_RANKS"] = "1"
    rec.reset_chaos()
    hvd.barrier()
    torn0 = _count(registry, "hvd_recovery_torn_replicas_total")
    commit("torn", 2)
    del os.environ["HVD_TPU_CHAOS_TORN_RANKS"]
    rec.reset_chaos()
    out["torn"] = {"owner_alive": restore("torn")}
    if rank == 1:
        rec.store().reset_key("torn")     # rank 1's process is gone
    hvd.barrier()
    out["torn"]["owner_gone"] = restore("torn")
    out["torn"]["counted"] = _count(
        registry, "hvd_recovery_torn_replicas_total") - torn0

    # Buddy pairs: ranks 0 and 2 lost (not adjacent), then rank 1 too.
    commit("pair", 2)
    if rank in (0, 2):
        rec.store().reset_key("pair")
    hvd.barrier()
    out["pair"] = {"nonadjacent": restore("pair")}
    if rank == 1:
        rec.store().reset_key("pair")
    hvd.barrier()
    out["pair"]["adjacent"] = restore("pair")
    for r in out.values():
        for v in r.values():
            if isinstance(v, dict):
                v.pop("values", None)
    return out


def recovery_part(rank, world, rendezvous, out_dir):
    with open(os.path.join(out_dir, SECRET_FILE)) as f:
        os.environ["HVD_TPU_RENDEZVOUS_SECRET"] = f.read().strip()
    os.environ["HVD_TPU_FLIGHT_HOST"] = "127.0.0.1"
    torch, hvd = _init(rank, world, f"file://{rendezvous}_rec4", 1)
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import recovery as rec
    from horovod_tpu_torch.debug import flight
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    root = os.path.join(out_dir, "disk")
    rdv = None
    if rank == 0:
        rdv = RendezvousServer(host="127.0.0.1",
                               secret=os.environ["HVD_TPU_RENDEZVOUS_SECRET"])
        rdv.start()
    addr = hvd.broadcast_object(
        f"127.0.0.1:{rdv.port}" if rdv is not None else None)
    os.environ["HVD_TPU_RENDEZVOUS_ADDR"] = addr
    res = {"published": rec.transport.serve_and_publish(rank)}
    hvd.barrier()
    tfm, cfg, batch, params = _lm(torch, out_dir, rank, world)
    try:
        committed = {}
        for stage in STAGES:
            model, opt = _build(torch, hvd, tfm, cfg, params, stage)
            step = tfm.make_train_step(cfg, tfm.ParallelConfig(), model, opt)
            for _ in range(STEPS):
                step(*batch)
            for key, tree in trees(opt, ckpt).items():
                ext = ckpt.extract_zero_state(tree)
                n = rec.replicate(key, STEPS, ext)
                ckpt.save_extracted(os.path.join(root, key), ext, STEPS)
                rec.seal_commit(key, STEPS, ext)
                committed[key] = {"values": _tensors(torch,
                                                     values(ckpt, tree)),
                                  "replicated": n,
                                  "payload": sum(int(v.nbytes) for v in
                                                 ext.rank_values[rank])}
        hvd.barrier()
        res["committed"] = committed
        res["held"] = sorted({(e.key, e.rank) for k in rec.store().keys()
                              for e in rec.store().contribution(k, "held")})
        res["restored4"] = _restore_all(torch, hvd, ckpt, rec, tfm, cfg,
                                        params, root, world)
        res["drills"] = _drills(torch, hvd, ckpt, rec, tfm, cfg, params,
                                batch, rank)
    finally:
        hvd.shutdown()
        # The KV served the commits' address lookups, all made above.
        if rdv is not None:
            rdv.stop()
    # Re-formed worlds: the survivors' processes keep their memory.
    for new_world, survivors in sorted(REFORMED.items()):
        if new_world == 3 and rank == 2:
            rec.reset_store()             # rank 2's process is gone
        if rank not in survivors:
            continue
        torch, hvd = _init(survivors.index(rank), new_world,
                           f"file://{rendezvous}_rec{new_world}", 1)
        try:
            res[f"restored{new_world}"] = _restore_all(
                torch, hvd, ckpt, rec, tfm, cfg, params, root, new_world)
        finally:
            hvd.shutdown()
    rec.transport.stop_serving()
    families = {f.name: children for f, children in registry().collect()}
    res["families"] = sorted(n for n in families
                             if n.startswith("hvd_recovery_"))
    res["restore_paths"] = sorted(
        dict(k)["path"] for k, _ in families["hvd_recovery_restores_total"])
    res["events"] = sorted({e["kind"] for e in flight.snapshot()
                            if e["kind"].startswith("recovery.")})
    torch.save(res, os.path.join(out_dir, f"recovery{rank}.pt"))
