"""Worker bodies of the port's negotiated-plane tests
(test_torch_port_native.py, …_eager.py, …_dispatch.py): four gloo ranks
with the native controller attached, started once per part and test
process by ``_torch_port_pool.part_results``, each writing
``<part><rank>.pt``.  ``host_plane_ops`` is shared with the reference's
ranks (``reference_host_rank``), which run it through horovod_tpu's
controller in their own processes: the port's ranks import neither JAX
nor horovod_tpu."""

import json
import os
import time

import numpy as np

from _torch_port_workers import _topology_env

N_PERMUTED = 8
CACHE_CAPACITIES = (1024, 2, 0)
TIMELINE_NAMES = ("tl.grad.0", "tl.grad.1", "tl.grad.2")


def host_inputs(rank: int) -> dict:
    """Rank-seeded host-plane inputs: ``x`` (5, 7) for the reductions,
    ``g`` (rank + 1, 3) for the ragged allgather, ``a`` (10, 2) for the
    alltoall with ``splits``, ``rs`` (8, 3) for the reducescatter, ``ad``
    (64,) for Adasum and ``bf`` (33,) (bfloat16 words)."""
    rng = np.random.default_rng(100 + rank)
    return {"x": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
            "g": rng.standard_normal((rank + 1, 3)).astype(np.float32),
            "a": rng.standard_normal((10, 2)).astype(np.float32),
            "rs": rng.standard_normal((8, 3)).astype(np.float32),
            "ad": rng.standard_normal(64).astype(np.float32),
            "bf": rng.standard_normal(33).astype(np.float32)}


def splits_of(rank: int, world: int) -> list:
    """Uneven alltoall splits of 10 rows: a zero for the next rank."""
    s = [10 // world] * world
    s[(rank + 1) % world] = 0
    s[rank] += 10 - sum(s)
    return s


def host_plane_ops(ops: dict, rank: int, world: int) -> dict:
    """The host plane's collectives on this rank's inputs through
    ``ops`` — callables ``allreduce(x, op, name)``, ``allgather(x,
    name)``, ``broadcast(x, root, name)``, ``alltoall(x, splits, name)``,
    ``bf16_sum(x, name)`` (float32 in, the bf16 result's words out) —
    so the port's and the reference's controllers run the same calls."""
    inp = host_inputs(rank)
    x = inp["x"]
    out = {}
    for label, code in (("sum", 1), ("average", 0), ("min", 3), ("max", 4),
                        ("product", 5)):
        out[f"allreduce_{label}"] = ops["allreduce"](x, code, f"h.{label}")
    out["allreduce_int"] = ops["allreduce"](
        (x * 10).astype(np.int64), 1, "h.int")
    out["allgather_ragged"] = ops["allgather"](inp["g"], "h.gather")
    out["broadcast"] = ops["broadcast"](x, 2, "h.bcast")
    recv, splits = ops["alltoall"](inp["a"], splits_of(rank, world),
                                   "h.a2a")
    out["alltoall_splits"] = (recv, np.asarray(splits))
    red = ops["allreduce"](inp["rs"], 0, "h.rs")
    chunk = red.shape[0] // world
    out["reducescatter"] = red[rank * chunk: (rank + 1) * chunk]
    out["adasum"] = ops["allreduce"](inp["ad"], 2, "h.adasum")
    out["bf16_sum"] = ops["bf16_sum"](inp["bf"], "h.bf16")
    return out


HOST_OPS = ("allreduce_sum", "allreduce_average", "allreduce_min",
            "allreduce_max", "allreduce_product", "allreduce_int",
            "allgather_ragged", "broadcast", "alltoall_splits",
            "reducescatter", "adasum", "bf16_sum")


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_NATIVE_SRC = os.path.join(ROOT, "horovod_tpu", "native", "src")
REF_NATIVE_BUILD = os.path.join(ROOT, "horovod_tpu_torch", "_build",
                                "reference_native")


def reference_native_library() -> str:
    """The reference's runtime, built once from a pristine copy of
    ``horovod_tpu/native/src`` into ``_build/reference_native/`` (keyed by
    the sources' hash) under an ``fcntl`` lock, the library renamed into
    place whole.  The reference's own loader runs ``make`` in its source
    tree in every process that finds no library there, so concurrent
    processes (these ranks, other test workers) race on its ``.o`` files
    and link a broken library; its ranks here load this one instead."""
    import fcntl
    import hashlib
    import shutil
    import subprocess
    import tempfile
    h = hashlib.sha256()
    for name in sorted(os.listdir(REF_NATIVE_SRC)):
        if name.endswith((".cc", ".h")) or name == "Makefile":
            h.update(name.encode() + b"\0")
            with open(os.path.join(REF_NATIVE_SRC, name), "rb") as f:
                h.update(f.read())
    out = os.path.join(REF_NATIVE_BUILD,
                       f"libhvdtpu_core-{h.hexdigest()[:16]}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(REF_NATIVE_BUILD, exist_ok=True)
    with open(os.path.join(REF_NATIVE_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):           # built by another process
            return out
        tmp = tempfile.mkdtemp(dir=REF_NATIVE_BUILD)
        try:
            src = os.path.join(tmp, "src")
            shutil.copytree(REF_NATIVE_SRC, src, ignore=shutil.ignore_patterns(
                "*.o", "*.so", "__pycache__"))
            subprocess.run(["make", "-j", str(os.cpu_count() or 1), "-C",
                            src], check=True, capture_output=True)
            # The Makefile links ../libhvdtpu_core.so beside its sources.
            os.replace(os.path.join(tmp, "libhvdtpu_core.so"), out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def reference_host_rank(rank, world, port, out_dir, library):
    """One rank of the reference's controller (horovod_tpu) running
    ``host_plane_ops`` on the runtime at ``library``
    (:func:`reference_native_library`); writes ``ref_host<rank>.npz``."""
    os.environ["HVD_TPU_CYCLE_TIME"] = "1"
    import ml_dtypes
    from horovod_tpu.native import controller
    from horovod_tpu.native.controller import NativeController
    controller._lib_path = lambda: library
    ctl = NativeController(rank, world, f"127.0.0.1:{port}")
    try:
        ops = {
            "allreduce": lambda x, op, nm: ctl.allreduce(x, op=op, name=nm),
            "allgather": lambda x, nm: ctl.allgather(x, name=nm),
            "broadcast": lambda x, r, nm: ctl.broadcast(x, root_rank=r,
                                                        name=nm),
            "alltoall": lambda x, s, nm: ctl.alltoall(x, splits=s, name=nm),
            "bf16_sum": lambda x, nm: ctl.allreduce(
                x.astype(ml_dtypes.bfloat16), op=1, name=nm).view(np.int16),
        }
        res = host_plane_ops(ops, rank, world)
    finally:
        ctl.shutdown()
    flat = {}
    for k, v in res.items():
        if isinstance(v, tuple):
            flat[k], flat[k + ".splits"] = v
        else:
            flat[k] = v
    np.savez(os.path.join(out_dir, f"ref_host{rank}.npz"), **flat)


def _ports(out_dir) -> list:
    with open(os.path.join(out_dir, "ports.json")) as f:
        return json.load(f)


def _init_ctl(rank, world, out_dir, tag, port, local_size=1, env=None):
    """The port on gloo with the controller of ``port`` attached."""
    _topology_env(rank, world, local_size)
    os.environ.update({"HVD_TPU_CONTROLLER_ADDR": f"127.0.0.1:{port}",
                       "HVD_TPU_CYCLE_TIME": "1"})
    os.environ.update(env or {})
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)   # the ranks share the host's cores
    hvd.init(device="cpu",
             init_method=f"file://{out_dir}/rendezvous_{tag}")
    from horovod_tpu_torch.core.state import global_state
    return torch, hvd, global_state.controller


def _port_host_ops(torch, hvd):
    def bf16_sum(x, nm):
        os.environ["HVD_TPU_EAGER_DEVICE_PLANE"] = "0"
        try:
            out = hvd.allreduce(torch.from_numpy(x).bfloat16(), op=hvd.Sum,
                                name=nm)
        finally:
            del os.environ["HVD_TPU_EAGER_DEVICE_PLANE"]
        return out.view(torch.int16).numpy()

    return {
        "allreduce": lambda x, op, nm: hvd.allreduce(x, op=op, name=nm),
        "allgather": lambda x, nm: hvd.allgather(x, name=nm),
        "broadcast": lambda x, r, nm: hvd.broadcast(x, r, name=nm),
        "alltoall": lambda x, s, nm: hvd.alltoall(x, s, name=nm),
        "bf16_sum": bf16_sum,
    }


def _as_tensors(torch, obj):
    """numpy arrays (and the host plane's results) as tensors, so that
    ``torch.load`` reads them without pickled numpy."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj, dtype=obj.dtype.base
                                         if obj.dtype.metadata is None
                                         else np.int16))
    if isinstance(obj, dict):
        return {k: _as_tensors(torch, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as_tensors(torch, v) for v in obj)
    return obj


def _save(torch, out_dir, part, rank, res):
    torch.save(_as_tensors(torch, res),
               os.path.join(out_dir, f"{part}{rank}.pt"))


# ---------------------------------------------------------------------------
# native: the host plane, negotiation, the stall inspector, the timeline
# ---------------------------------------------------------------------------

def native_part(rank, world, rendezvous, out_dir):
    del rendezvous
    # The runtime's warnings go to fd 2: keep each rank's.
    err = os.open(os.path.join(out_dir, f"stderr{rank}.txt"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)
    # The stall warning after 1 s; the shutdown window only on the second
    # controller, below, so that a rank slowed by a loaded host elsewhere
    # in the part is not shut down.
    torch, hvd, ctl = _init_ctl(
        rank, world, out_dir, "native", _ports(out_dir)[0],
        env={"HVD_TPU_STALL_CHECK_TIME_SECONDS": "1",
             "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS": "0"})
    res = {}
    res["host"] = host_plane_ops(_port_host_ops(torch, hvd), rank, world)
    # Rank-permuted enqueue order, device and host plane together.
    rng = np.random.default_rng(7)
    order = np.random.default_rng(rank).permutation(N_PERMUTED).tolist()
    vals = [rng.standard_normal((3, i + 1)).astype(np.float32)
            for i in range(N_PERMUTED)]
    handles = {}
    for i in order:
        x = vals[i] * (rank + 1)
        handles[i] = hvd.allreduce_async(
            torch.from_numpy(x) if i % 2 else x, op=hvd.Sum,
            name=f"perm.{i}")
    got = {i: hvd.synchronize(h) for i, h in handles.items()}
    res["permuted"] = {i: np.asarray(got[i]) for i in range(N_PERMUTED)}
    res["permuted_inputs"] = vals
    res["order"] = order
    # A name enqueued twice while in flight.
    dup = {}
    for plane, x in (("device", torch.ones(3)), ("host", np.ones(3))):
        h = hvd.allreduce_async(x, name=f"dup.{plane}")
        try:
            hvd.allreduce_async(x, name=f"dup.{plane}")
            dup[plane] = None
        except hvd.DuplicateNameError as e:
            dup[plane] = str(e)
        hvd.synchronize(h)
    res["duplicate"] = dup
    # The timeline of a few fused names.
    path = os.path.join(out_dir, f"timeline{rank}.json")
    hvd.start_timeline(path)
    hs = [hvd.allreduce_async(torch.full((4,), float(i)), name=nm)
          for i, nm in enumerate(TIMELINE_NAMES)]
    [hvd.synchronize(h) for h in hs]
    hvd.stop_timeline()
    res["timeline_path"] = path
    # join: rank 3 has no more data; ranks 0-2 reduce on both planes with
    # a zero proxy for it.
    if rank == world - 1:
        res["join_last"] = hvd.join()
    else:
        x = torch.full((6,), float(rank + 1))
        res["join_device"] = hvd.allreduce(x, op=hvd.Sum, name="j.dev")
        res["join_host"] = hvd.allreduce(x.numpy(), op=hvd.Average,
                                         name="j.host")
        res["join_last"] = hvd.join()
    # Stall: rank 1 is late past the 1 s warning, well within the 5 s
    # shutdown window; rank 0 reads the inspector meanwhile, from 1.1 s
    # on until it lists the stall (the barrier starts the ranks' clocks
    # together, so rank 1 cannot arrive early and leave nothing stalled).
    hvd.barrier()
    if rank == 1:
        time.sleep(2.0)
    h = hvd.allreduce_async(torch.ones(4), op=hvd.Sum, name="late")
    if rank == 0:
        time.sleep(1.1)
        res["stalled"] = ctl.stalled()
        while not res["stalled"] and not hvd.poll(h):
            time.sleep(0.05)
            res["stalled"] = ctl.stalled()
    res["late"] = hvd.synchronize(h)
    hvd.shutdown()
    # Stall shutdown (a 5 s window): only rank 0 submits "never"; the
    # others stay up 3 s past the window.
    torch, hvd, ctl = _init_ctl(
        rank, world, out_dir, "native_shutdown", _ports(out_dir)[1],
        env={"HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS": "5"})
    if rank == 0:
        try:
            hvd.allreduce(torch.ones(4), name="never")
            res["never"] = None
        except hvd.HorovodInternalError as e:
            res["never"] = str(e)
    else:
        time.sleep(8.0)
    # Shutdown errors an op still pending on it.
    h = hvd.allreduce_async(torch.ones(2), name="orphan") if rank == 0 \
        else None
    hvd.shutdown()
    if h is not None:
        try:
            hvd.synchronize(h)
            res["orphan"] = None
        except hvd.HorovodInternalError as e:
            res["orphan"] = str(e)
    _save(torch, out_dir, "native", rank, res)


def cache_part(rank, world, rendezvous, out_dir):
    """The reference's response-cache iterations (test_response_cache.py)
    at each capacity, one controller each, with this rank's cache hits."""
    del rendezvous
    res = {}
    torch = None
    for cap, port in zip(CACHE_CAPACITIES, _ports(out_dir)[1:]):
        torch, hvd, ctl = _init_ctl(
            rank, world, out_dir, f"cache{cap}", port,
            env={"HVD_TPU_CACHE_CAPACITY": str(cap)})
        hits0 = ctl.cache_hits()
        outs = []
        for it in range(6):
            for t in range(4):
                x = np.full((32,), float(rank + 1 + it), dtype=np.float32)
                dev = torch.full((16,), float(rank + 1 + it))
                outs.append(hvd.allreduce(x, op=hvd.Sum, name=f"grad.{t}"))
                outs.append(hvd.allreduce(dev, op=hvd.Sum,
                                          name=f"dgrad.{t}"))
            outs.append(hvd.allgather(np.full((rank + 1, 2), float(rank),
                                              dtype=np.float32),
                                      name="gath"))
        # A shape change on a cached name renegotiates.
        outs.append(hvd.allreduce(np.ones(8, np.float32), op=hvd.Sum,
                                  name="grad.0"))
        res[cap] = {"outs": outs, "hits": ctl.cache_hits() - hits0,
                    "stats": ctl.stats()}
        hvd.shutdown()
    _save(torch, out_dir, "cache", rank, res)


# ---------------------------------------------------------------------------
# eager: the gloo device executor
# ---------------------------------------------------------------------------

FUSE_SHAPES = [(7, 300), (300,), (2, 3, 130), (40,), (513,), (1,)]
GATHER_SHAPES = [(5, 7), (33,), (3, 4, 5), (2,)]


def _flat_average(torch, dist, tensors, world):
    """Per-tensor ``dist.all_reduce`` on the world group, then / world:
    the flat plane's average."""
    outs = []
    for t in tensors:
        y = t.clone()
        dist.all_reduce(y)
        outs.append(y / world)
    return outs


def _in_one_round(rank, world, hvd, ctl, dist, tag, enqueue):
    """Run ``enqueue`` (which submits named asynchronous collectives and
    waits for none) on every rank, the last rank's submissions reaching
    the coordinator in one round; returns what ``enqueue`` returns.

    A name is ready once every rank has sent it, and a rank's background
    loop sends everything pending each time it wakes, which it does at
    the first enqueue: a burst could reach the coordinator over several
    rounds.  So the other ranks send their names first and then a gate
    allreduce, and rank 0 holds the gate's PREPARE, which every rank's
    loop takes part in, until the last rank has submitted its whole
    burst.  The last rank starts its burst only once the gate is held,
    so after its loop has sent the gate; the burst then waits whole for
    the loop's next drain.  The hold is a condition (two keys of the
    process group's store), not a time."""
    assert world > 1
    import torch
    store = dist.distributed_c10d._get_default_store()
    held, sent, gate = f"{tag}.held", f"{tag}.sent", f"{tag}.gate"
    impl = ctl._device_exec_impl
    validate = impl.validate
    if rank == 0:
        def hold(rtype, names, *args):
            if gate in names:
                store.set(held, b"1")
                store.wait([sent])
            return validate(rtype, names, *args)
        impl.validate = hold
    out = None
    if rank != world - 1:
        out = enqueue()
    h = hvd.allreduce_async(torch.zeros(1), name=gate)
    if rank == world - 1:
        store.wait([held])
        out = enqueue()
        store.set(sent, b"1")
    hvd.synchronize(h)
    impl.validate = validate
    return out


def eager_part(rank, world, rendezvous, out_dir):
    del rendezvous
    torch, hvd, ctl = _init_ctl(rank, world, out_dir, "eager",
                                _ports(out_dir)[0])
    import torch.distributed as dist
    from horovod_tpu_torch.ops import quantization as Q
    res = {}
    rng = np.random.default_rng(20 + rank)
    xs = [torch.from_numpy((rng.standard_normal(s) * 3).astype(np.float32))
          for s in FUSE_SHAPES]
    # Fusion: every name in flight before any wait, the last rank's six
    # in one coordinator round.
    before = ctl.stats()
    hs = _in_one_round(rank, world, hvd, ctl, dist, "fuse", lambda: [
        hvd.allreduce_async(x, name=f"fuse.{i}") for i, x in enumerate(xs)])
    res["fused"] = [hvd.synchronize(h) for h in hs]
    res["fused_names"] = ctl.last_fused_names()
    res["fuse_stats"] = (before, ctl.stats())
    res["flat"] = _flat_average(torch, dist, xs, world)
    # grouped_allreduce: one joint enqueue.
    res["grouped"] = hvd.grouped_allreduce(xs[:3], op=hvd.Sum, name="grp")
    # The other device-plane collectives against the host plane's.
    g = torch.from_numpy(host_inputs(rank)["g"])
    a = torch.from_numpy(host_inputs(rank)["a"])
    res["device"] = {
        "allgather": hvd.allgather(g, name="d.gather"),
        "broadcast": hvd.broadcast(xs[0], 1, name="d.bcast"),
        "alltoall": hvd.alltoall(a, splits_of(rank, world), name="d.a2a"),
        "reducescatter": hvd.reducescatter(torch.from_numpy(
            host_inputs(rank)["rs"]), name="d.rs"),
        "int_average": hvd.allreduce(torch.arange(7) * (rank + 3),
                                     name="d.int"),
        "scaled": hvd.allreduce(xs[1], op=hvd.Sum, prescale_factor=0.5,
                                postscale_factor=3.0, name="d.scaled"),
        "max": hvd.allreduce(xs[3], op=hvd.Max, name="d.max"),
        "bf16": hvd.allreduce(xs[4].bfloat16(), op=hvd.Sum, name="d.bf16"),
    }
    res["host"] = {
        "allgather": hvd.allgather(g.numpy(), name="h.gather"),
        "broadcast": hvd.broadcast(xs[0].numpy(), 1, name="h.bcast"),
        "alltoall": hvd.alltoall(a.numpy(), splits_of(rank, world),
                                 name="h.a2a"),
    }
    # Async: poll, then synchronize.
    h = hvd.allreduce_async(xs[2], name="async")
    polled = hvd.poll(h)
    res["async"] = (polled, hvd.synchronize(h))
    # The coordinator's stamped int8 wire on the device plane, against
    # the compressed two-pass allreduce on the world group.
    if rank == 0:
        ctl.set_wire_compression("int8")
    hvd.barrier()
    s0 = ctl.stats()
    res["int8"] = ctl.allreduce_device(xs[0], op=hvd.Average, name="w8")
    s1 = ctl.stats()
    res["int8_wire"] = (ctl.wire_compression(),
                        s1["bytes_raw"] - s0["bytes_raw"],
                        s1["bytes_sent"] - s0["bytes_sent"])
    # Every round re-stamps the wire, so rank 0 may take the stamp back
    # only once every rank has read the one w8 ran on.
    hvd.barrier()
    if rank == 0:
        ctl.set_wire_compression("none")
    hvd.barrier()
    res["int8_flat"] = Q.compressed_allreduce(
        xs[0], None, hvd.Average, spec=Q.QuantSpec(8, Q.default_block()))
    # An executor that fails on rank 1 in PREPARE fails every rank.
    impl = ctl._device_exec_impl
    validate = impl.validate
    if rank == 1:
        def refuse(*args):
            raise RuntimeError("refused on rank 1")
        impl.validate = refuse
    t0 = time.perf_counter()
    try:
        hvd.allreduce(xs[3], name="fail")
        res["failure"] = None
    except hvd.HorovodInternalError as e:
        res["failure"] = str(e)
    res["failure_s"] = time.perf_counter() - t0
    impl.validate = validate
    res["after_failure"] = hvd.allreduce(xs[3], op=hvd.Sum, name="after")
    # DistributedOptimizer under the controller: per-parameter and
    # bucketed, against the flat plane's averages of the same gradients.
    res["optimizer"] = {}
    for overlap in (False, True):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(16, 32),
                                    torch.nn.Tanh(), torch.nn.Linear(32, 4))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), overlap=overlap)
        inp = torch.from_numpy(rng.standard_normal((8, 16)).astype(
            np.float32))
        if overlap:
            # The hooks submit the bucket's names from the backward: the
            # last rank's in one coordinator round, as above.
            _in_one_round(rank, world, hvd, ctl, dist, "optimizer",
                          lambda: model(inp).square().mean().backward())
        else:
            model(inp).square().mean().backward()
        local = [p.grad.clone() for p in model.parameters()]
        opt.synchronize()
        res["optimizer"][overlap] = (
            [p.grad.clone() for p in model.parameters()],
            _flat_average(torch, dist, local, world), ctl.last_fused_names())
        opt.zero_grad()
    # The eager queues: a bucket plan that packs several leaves, launched
    # bucket by bucket as named async allreduces; numpy leaves donated to
    # the host plane; a ZeRO-3 gather of parameter shards by bucket.
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import overlap as O
    plan = O.plan_buckets(xs, 8 * 1024)
    q = O.EagerBucketQueue(plan, op=hvd.Average, name="bq")
    for b, idxs in enumerate(plan.buckets):
        q.launch(b, [xs[i] for i in idxs])
    res["bucket_queue"] = (q.finish(), plan.buckets, q.comm_hidden_ratio)
    donated = [x.numpy().copy() for x in xs[:2]]
    dq = O.EagerBucketQueue(O.per_leaf_plan(2), op=hvd.Average, name="dq",
                            donate=True)
    for b in range(2):
        dq.launch(b, [donated[b]])
    out = dq.finish()
    res["donated"] = (out, all(o is d for o, d in zip(out, donated)))
    params = [torch.from_numpy(np.random.default_rng(30).standard_normal(
        s).astype(np.float32)) for s in GATHER_SHAPES]
    gplan = O.plan_buckets(params, 300, order="forward")
    shards = [F.pad(p.reshape(-1), (0, (-p.numel()) % world)).view(
        world, -1)[rank] for p in params]
    gq = O.EagerGatherQueue(gplan, like=params, name="zg")
    for b, idxs in enumerate(gplan.buckets):
        gq.launch(b, [shards[i] for i in idxs])
    full = [None] * len(params)
    for b, idxs in enumerate(gplan.buckets):
        for i, t in zip(idxs, gq.take(b)):
            full[i] = t
    gq.drain()
    res["gather_queue"] = (full, params, gplan.buckets,
                           gq.exposed_s + gq.hidden_s)
    res["stats"] = ctl.stats()
    hvd.shutdown()
    _save(torch, out_dir, "eager", rank, res)


# ---------------------------------------------------------------------------
# dispatch: the init-time probe on a 2 x 2 layout
# ---------------------------------------------------------------------------

def dispatch_part(rank, world, rendezvous, out_dir):
    del rendezvous
    torch, hvd, ctl = _init_ctl(
        rank, world, out_dir, "dispatch", _ports(out_dir)[0], local_size=2,
        env={"HVD_TPU_SCHEDULE_PROBE_REPS": "1"})
    from horovod_tpu_torch.ops import dispatch as D
    from horovod_tpu_torch.ops import xla_collectives as XC
    table = D.active_table()
    sizes = [1 << 10, 100 << 10, 4 << 20, 100 << 20]
    res = {"table": tuple(table), "encoded": table.encode(),
           "choose": {(k, n): XC.choose_schedule(k, n)
                      for k in D.KINDS for n in sizes},
           "table_choose": {(k, n): table.choose(k, n)
                            for k in D.KINDS for n in sizes},
           "reduced": hvd.allreduce(torch.full((3,), float(rank)),
                                    op=hvd.Sum, name="after.probe")}
    hvd.shutdown()
    res["after_shutdown"] = D.active_table()
    _save(torch, out_dir, "dispatch", rank, res)
