"""Worker bodies of the port's elastic tests (test_torch_port_elastic*.py),
run by the port's ``ElasticDriver`` as

    python _torch_port_elastic_workers.py <kind> '<json arguments>'

Torch and the port only: the workers must not import JAX.  Every worker
runs on the CPU over gloo (``init(device="cpu")``) with the native
controller attached at its round's address, and appends one JSON line
per epoch to ``<log>.<slot>``.

* ``allreduce`` — the reference's ELASTIC_WORKER / SCALEUP_WORKER
  (tests/test_elastic.py): an ``ObjectState(epoch, total)``, a named
  ``allreduce`` of ``rank + 1`` an epoch through the controller, a commit
  an epoch; ``fail_slot`` dies hard at ``fail_epoch``; ``sleep`` gives
  the driver time to change the host set between epochs.
* ``cascade`` — the reference's CASCADE_WORKER: two slots fail once
  each, at epochs 1 and 2.
* ``fleet`` — the fleet drill's job (test_torch_port_fleet.py): the
  narrow ZeRO-2 transformer committing every step to its checkpoint
  directory, so a job stopped by a preemption resumes from the disk.
* ``detect`` — a rank dies inside a collective: every rank enters
  ``op`` (a negotiated allreduce, or the ZeRO step's raw reduce-scatter
  and all-gather of a small transformer) while ``victim`` sleeps and
  then exits; the survivors log the ``HorovodInternalError`` with its
  delay after the death, restore, re-form and finish at the smaller
  world; a reset callback logs ``reset`` when the failed world is torn
  down and the next one formed.  With ``hang_s``, the victim instead takes the step with its
  peers and then sleeps ``hang_s`` alive before its commit (logging
  ``hang``), and only then exits: the survivors' commits fail at the
  operation deadline.

``elastic_part`` is the body of the pool's part "elastic"
(test_torch_port_elastic_state.py): four gloo ranks, each its own
process with its own replica store and ``RecoveryServer`` published in a
signed KV, run ``TpuState`` on the checkpoint tests' problem
(``_torch_port_checkpoint_workers``, ZeRO stage 2 AdamW) with a
``DataLoader`` over the sample ids: a commit at world 4 for the
reference to restore at mesh 2, the reference's mesh-4 commit restored
at world 2, and the recovery drills (disk-free restart, peer = disk, a
buddy pair lost, the two commit-window crashes, recovery off).
"""

import contextlib
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def _log(path, **fields):
    slot = os.environ["HVD_TPU_ELASTIC_SLOT"]
    with open(f"{path}.{slot}", "a") as f:
        f.write(json.dumps(fields) + "\n")


def allreduce_worker(log, epochs, fail_slot="", fail_epoch=-1, sleep=0.0):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    torch.set_num_threads(1)   # the workers share the host's cores
    hvd.init(device="cpu")
    state = elastic.ObjectState(epoch=0, total=0.0)

    @elastic.run
    def train(state):
        while state.epoch < epochs:
            if sleep:
                time.sleep(sleep)
            if (fail_slot and os.environ["HVD_TPU_ELASTIC_SLOT"] == fail_slot
                    and state.epoch == fail_epoch):
                os._exit(1)   # a hard failure
            x = torch.full((4,), float(hvd.rank() + 1))
            out = hvd.allreduce(x, op=hvd.Sum, name=f"ep.{state.epoch}")
            state.total += float(out[0])
            _log(log, epoch=state.epoch, rank=hvd.rank(), size=hvd.size(),
                 sum=float(out[0]))
            state.epoch += 1
            state.commit()

    train(state)
    hvd.shutdown()


def cascade_worker(log, mark, epochs):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    fails = {"127.0.0.1:0": 1, "localhost:0": 2}   # slot -> fail epoch
    torch.set_num_threads(1)   # the workers share the host's cores
    hvd.init(device="cpu")
    state = elastic.ObjectState(epoch=0)

    @elastic.run
    def train(state):
        while state.epoch < epochs:
            slot = os.environ["HVD_TPU_ELASTIC_SLOT"]
            marker = mark + "." + slot.replace(":", "_")
            if (fails.get(slot) == state.epoch
                    and not os.path.exists(marker)):
                open(marker, "w").close()   # fail once per slot
                os._exit(1)
            x = torch.full((4,), float(hvd.rank() + 1))
            out = hvd.allreduce(x, op=hvd.Sum, name=f"ep.{state.epoch}")
            _log(log, epoch=state.epoch, rank=hvd.rank(), size=hvd.size(),
                 sum=float(out[0]))
            state.epoch += 1
            state.commit()

    train(state)
    hvd.shutdown()


def _small_zero(torch, hvd, seed):
    """A 2-layer flagship-shaped transformer (narrow) and its ZeRO-2
    AdamW, with the step counter as a tensor in the committed tree."""
    import functools
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                d_ff=64, n_layers=2, seq_len=16,
                                dtype=torch.float32, remat=False)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, seed=seed, device="cpu")
    opt = hvd.ZeroShardedOptimizer(
        model, functools.partial(torch.optim.AdamW, lr=1e-2,
                                 weight_decay=1e-3), stage=2)
    return tfm, cfg, par, model, opt


def detect_worker(log, op, victim, epochs, die_epoch, ckpt, hang_s=0.0):
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    torch.set_num_threads(1)   # the workers share the host's cores
    hvd.init(device="cpu")
    slot = os.environ["HVD_TPU_ELASTIC_SLOT"]
    tfm, cfg, par, model, opt = _small_zero(torch, hvd, seed=0)
    step_t = torch.zeros((), dtype=torch.int64)
    state = elastic.TpuState(
        opt_state={"model": model.state_dict(), "opt": opt,
                   "step": step_t},
        checkpoint_dir=ckpt)
    # The reset's end: the failed world torn down and the next one formed.
    state.register_reset_callbacks([lambda: _log(
        log, event="reset", t=time.time(), size=hvd.size())])
    step = tfm.make_train_step(cfg, par, model, opt)

    @elastic.run
    def train(state):
        while int(step_t) < epochs:
            i = int(step_t)
            tokens, labels = tfm.synthetic_batch(
                cfg, 2, seed=100 * i + hvd.rank(), device="cpu")
            if slot == victim and i == die_epoch:
                if hang_s:
                    # Take the step, then hang alive while the peers
                    # commit it, then die.
                    step(tokens, labels)
                    _log(log, event="hang", t=time.time())
                    time.sleep(hang_s)
                else:
                    # Sleep while the peers enter the collective.
                    time.sleep(1.0)
                _log(log, event="death", t=time.time())
                os._exit(1)
            try:
                if op == "negotiated":
                    loss = hvd.allreduce(torch.full((1 << 16,), 1.0),
                                         op=hvd.Sum, name=f"ep.{i}")[0]
                else:
                    loss = step(tokens, labels)
                value = float(loss)
                step_t.add_(1)
                state.commit()
            except hvd.HorovodInternalError as e:
                _log(log, event="error", t=time.time(), epoch=i,
                     rank=hvd.rank(), size=hvd.size(), error=str(e)[:200])
                raise
            _log(log, event="epoch", epoch=i, rank=hvd.rank(),
                 size=hvd.size(), value=value, pid=os.getpid())

    train(state)
    hvd.shutdown()


# The pool part's problem: the checkpoint tests' case, the loader's
# samples and batch, and the batches each rank takes before a commit.
CASE = "s2-adamw"
SAMPLES, BATCH, TAKEN = 64, 2, 3
SECRET_FILE = "secret.txt"


def _values(ckpt, tree):
    """{leaf path: this rank's host value} and {path: (kind, true size)}."""
    ext = ckpt.extract_zero_state(tree)
    (vals,) = ext.rank_values.values()
    return ({s.path: v for s, v in zip(ext.specs, vals)},
            {s.path: (s.kind, s.true_size) for s in ext.specs})


def _problem(torch, hvd, data, loader_world=None, loader_rank=None,
             loader_seed=3):
    """The case's model and optimizer from the initial parameters, and a
    loader over the sample ids (this rank's shard)."""
    import _torch_port_checkpoint_workers as CK
    from horovod_tpu_torch.data import ArraySource, DataLoader
    m = CK.model(torch, {n: data[f"param.{n}"] for n in CK.NAMES})
    opt = CK.optimizer(torch, hvd, m, CASE)
    loader = DataLoader(ArraySource(np.arange(SAMPLES)), BATCH,
                        shuffle=True, seed=loader_seed, prefetch=False,
                        device="cpu", world_size=loader_world,
                        rank=loader_rank)
    return m, opt, loader


def _train(torch, m, opt, loader, x, steps):
    """``steps`` steps, each taking one batch; the ids taken."""
    import _torch_port_checkpoint_workers as CK
    it = iter(loader)
    taken = []
    for _ in range(steps):
        taken += [int(i) for i in next(it)]
        CK.step(m, opt, x)
    return taken


def _finish(loader):
    return [int(i) for b in loader for i in b]


def _sync_fresh(torch, hvd, data, x, **state_kw):
    """A fresh problem synced by a new TpuState: the restored values, the
    report, and the ids the loader takes to the end of the epoch."""
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic, recovery
    m, opt, loader = _problem(torch, hvd, data, loader_seed=999)
    state = elastic.TpuState(opt_state=opt, train_loader=loader,
                             **state_kw)
    state.sync(root=0)
    vals, _ = _values(ckpt, opt)
    rep = recovery.last_report()
    return {"values": vals, "path": rep.path if rep else None,
            "step": rep.step if rep else None,
            "loader": loader.state_dict(), "rest": _finish(loader)}


@contextlib.contextmanager
def _world(rank, survivors, rendezvous, tag):
    """The world of ``survivors`` (old ranks, in new-rank order) for this
    rank, or None when it is not among them; shut down on exit."""
    from _torch_port_training_workers import _init
    if rank not in survivors:
        yield None
        return
    torch, hvd = _init(survivors.index(rank), len(survivors),
                       f"file://{rendezvous}_{tag}", 1)
    try:
        yield torch, hvd
    finally:
        hvd.shutdown()


ALL = (0, 1, 2, 3)


def elastic_part(rank, world, rendezvous, out_dir):
    import torch
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic, recovery
    from horovod_tpu_torch.recovery.chaos import ChaosCrash
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    with open(os.path.join(out_dir, SECRET_FILE)) as f:
        os.environ["HVD_TPU_RENDEZVOUS_SECRET"] = f.read().strip()
    os.environ["HVD_TPU_FLIGHT_HOST"] = "127.0.0.1"
    data = np.load(os.path.join(out_dir, "elastic.npz"))
    x = torch.from_numpy(data["x"][rank].copy())
    res = {}
    rdv = None
    if rank == 0:
        rdv = RendezvousServer(host="127.0.0.1",
                               secret=os.environ["HVD_TPU_RENDEZVOUS_SECRET"])
        rdv.start()
        with open(os.path.join(out_dir, "kv.txt"), "w") as f:
            f.write(f"127.0.0.1:{rdv.port}")
    store = recovery.store()
    tags = iter(range(100))

    def committed(key, dead=(), **state_kw):
        """A world of 4 trains the problem TAKEN steps and commits it
        once; then ``dead`` ranks lose their replica memory.  The fleet
        memory holds this commit only."""
        with _world(rank, ALL, rendezvous, f"c{next(tags)}") as (t, hvd):
            if "HVD_TPU_RENDEZVOUS_ADDR" not in os.environ:
                os.environ["HVD_TPU_RENDEZVOUS_ADDR"] = hvd.broadcast_object(
                    open(os.path.join(out_dir, "kv.txt")).read()
                    if rank == 0 else None)
                recovery.transport.serve_and_publish(rank)
                hvd.barrier()
            store.clear()
            hvd.barrier()
            m, opt, loader = _problem(torch, hvd, data)
            taken = _train(torch, m, opt, loader, x, TAKEN)
            state = elastic.TpuState(opt_state=opt, train_loader=loader,
                                     **state_kw)
            keys0 = store.keys()
            state.commit()
            vals, specs = _values(ckpt, opt)
            res[key] = {"values": vals, "specs": specs, "taken": taken,
                        "loader": loader.state_dict(),
                        "store_keys": (keys0, store.keys())}
            hvd.barrier()
        if rank in dead:
            store.reset_key("opt_state")

    def synced(key, survivors, **state_kw):
        with _world(rank, survivors, rendezvous,
                    f"s{next(tags)}") as got:
            if got:
                res[key] = _sync_fresh(torch, got[1], data, x, **state_kw)

    # Port -> reference: the reference restores this step at mesh 2.
    committed("port", checkpoint_dir=os.path.join(out_dir, "port"))
    # Reference -> port at world 2.
    store.clear()
    synced("ref2", (0, 1), checkpoint_dir=os.path.join(out_dir, "ref"))
    # Disk-free restart: rank 3's process (and memory) gone.
    committed("diskfree", dead=(3,))
    synced("diskfree3", (0, 1, 2))
    # Peer = disk at world 2 (ranks 1 and 3 gone; their buddies 2 and 0
    # hold their copies), then the whole fleet memory lost.
    both = os.path.join(out_dir, "both")
    committed("both", dead=(1, 3), checkpoint_dir=both)
    synced("both2_peer", (0, 2), checkpoint_dir=both)
    store.clear()
    synced("both2_disk", (0, 2), checkpoint_dir=both)
    # A buddy pair lost together (rank 1 and its holder, rank 2).
    pair = os.path.join(out_dir, "pair")
    committed("pair", dead=(1, 2), checkpoint_dir=pair)
    synced("pair2", (0, 3), checkpoint_dir=pair)
    # Recovery off: the disk only, the replica store untouched.
    committed("off", checkpoint_dir=os.path.join(out_dir, "off"),
              peer_recovery=False)
    # The commit-window crashes: the second commit dies inside its
    # window; the first stays the newest restorable step.
    for point in ("after_replicate", "pre_manifest"):
        d = os.path.join(out_dir, point)
        with _world(rank, ALL, rendezvous, f"x{next(tags)}") as (t, hvd):
            store.clear()
            hvd.barrier()
            m, opt, loader = _problem(torch, hvd, data)
            state = elastic.TpuState(opt_state=opt, train_loader=loader,
                                     checkpoint_dir=d)
            _train(torch, m, opt, loader, x, 1)
            state.commit()
            first, _ = _values(ckpt, opt)
            os.environ["HVD_TPU_CHAOS_COMMIT_CRASH"] = f"{point}@1"
            recovery.reset_chaos()
            _train(torch, m, opt, loader, x, 1)
            try:
                state.commit()
                crashed = False
            except ChaosCrash:
                crashed = True
            del os.environ["HVD_TPU_CHAOS_COMMIT_CRASH"]
            recovery.reset_chaos()
            hvd.barrier()
            zdir = os.path.join(d, "opt_state")
            res[point] = {"crashed": crashed, "first": first,
                          "latest": ckpt.latest_step(zdir),
                          "torn_step_dir": os.path.isdir(
                              ckpt.step_dir(zdir, 1)),
                          "committed": dict(state._ckpt_committed_step)}
            state.sync(root=0)
            rep = recovery.last_report()
            res[point].update(synced=_values(ckpt, opt)[0], path=rep.path,
                              step=rep.step)
    if rdv is not None:
        rdv.stop()
    recovery.transport.stop_serving()
    torch.save(_as_tensors(torch, res),
               os.path.join(out_dir, f"elastic{rank}.pt"))


def _as_tensors(torch, obj):
    """Host arrays as tensors (the results file holds tensors only)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, dict):
        return {k: _as_tensors(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as_tensors(torch, v) for v in obj)
    return obj


def fleet_steps(torch, hvd, ckpt=None, steps=0, log=None, pace=0.0):
    """The fleet drill's job (test_torch_port_fleet.py): the narrow ZeRO-2
    transformer of ``_small_zero`` on seeded batches, its TpuState
    committing {"model", "opt", "step"} to ``ckpt`` after every step.
    Returns the losses of the steps this process took, by step."""
    from horovod_tpu_torch import elastic
    tfm, cfg, par, model, opt = _small_zero(torch, hvd, seed=0)
    step_t = torch.zeros((), dtype=torch.int64)
    state = elastic.TpuState(
        opt_state={"model": model.state_dict(), "opt": opt,
                   "step": step_t}, checkpoint_dir=ckpt)
    step = tfm.make_train_step(cfg, par, model, opt)
    losses = {}

    @elastic.run
    def train(state):
        if log:
            _log(log, event="sync", step=int(step_t), pid=os.getpid(),
                 t=time.time())
        while int(step_t) < steps:
            i = int(step_t)
            tokens, labels = tfm.synthetic_batch(cfg, 2, seed=500 + i,
                                                 device="cpu")
            losses[i] = float(step(tokens, labels))
            step_t.add_(1)
            try:
                state.commit()
            finally:
                # A commit that answers a host event raises after it
                # saved: the step is taken either way.
                if log:
                    _log(log, event="step", step=i, loss=losses[i],
                         pid=os.getpid(), t=time.time())
            time.sleep(pace)

    train(state)
    return losses


def fleet_worker(log, ckpt, steps, pace):
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)   # the workers share the host's cores
    hvd.init(device="cpu")
    fleet_steps(torch, hvd, ckpt=ckpt, steps=steps, log=log, pace=pace)
    hvd.shutdown()


KINDS = {"allreduce": allreduce_worker, "cascade": cascade_worker,
         "detect": detect_worker, "fleet": fleet_worker}

if __name__ == "__main__":
    KINDS[sys.argv[1]](**json.loads(sys.argv[2]))
