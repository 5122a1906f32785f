"""``horovod_tpu_torch.torch`` (the ``horovod.torch`` API on the port)
against ``horovod_tpu.torch`` on the same seeded numpy inputs.

World 1, in this process (the reference after ``horovod_tpu.init()``,
the port after ``init(device="cpu")``): the parameters after 3 steps of
SGD with momentum and of Adam through each package's
``DistributedOptimizer`` are equal bit for bit, under compression
none/fp16/bf16, ``backward_passes_per_step=2``, sparse gradients with and
without ``sparse_as_dense``, the clip pattern under ``skip_synchronize``
and ``gradient_predivide_factor``; so are ``SyncBatchNorm``,
``broadcast_optimizer_state`` and the async, grouped and differentiable
calls.

Two gloo ranks (``_torch_port_pool.part_results``, part "frontend",
bodies in ``_torch_port_frontend_workers.py``): each rank's parameters
against the reference's single-process step (its ``DistributedOptimizer``
at world 1) fed the ranks' mean gradient — the mean on the wire's dtype
for fp16/bf16 — equal bit for bit (a sum of two values has one order);
sparse gradients of distinct rows; ``SyncBatchNorm`` against
``nn.BatchNorm1d`` on the concatenated batch (rtol 1e-5); Adasum's delta
model against the reference's ``adasum_pair`` of the two ranks' deltas
(rtol 1e-5, atol 1e-7: the dot products sum in another order); the
differentiable allgather of unequal rows; ``join`` with uneven batches
under the native controller (the joined rank's zeros in the mean)."""

import warnings

import numpy as np
import pytest
import torch

import horovod_tpu_torch.torch as hvd
import _torch_port_frontend_workers as W
import _torch_port_pool as pool
from horovod_tpu_torch.core.state import global_state


@pytest.fixture
def both():
    """The reference initialized for this test (the suite's conftest
    shuts it down after each), the port for the module."""
    import horovod_tpu
    import horovod_tpu.torch as ref
    horovod_tpu.init()
    hvd.init(device="cpu")
    yield ref, hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def data():
    return pool.part_inputs("frontend")


def _train(mod, data, kind, comp="none", bpps=1, sparse=None, clip=False,
           predivide=1.0):
    """3 steps through ``mod``'s DistributedOptimizer on rank 0's batches
    (2 backward passes a step under ``bpps=2``); returns the parameters."""
    torch.manual_seed(0)
    if sparse is None:
        model = W.make_linear(torch, data)
        inner = W.make_optimizer(torch, kind, model.parameters())
    else:
        model = W.make_embedding(torch, data)
        inner = torch.optim.SGD(model.parameters(), lr=0.1)
    opt = mod.DistributedOptimizer(
        inner, named_parameters=model.named_parameters(),
        compression=getattr(mod.Compression, comp),
        backward_passes_per_step=bpps, sparse_as_dense=bool(sparse),
        gradient_predivide_factor=predivide)
    for step in range(W.STEPS):
        for p in range(bpps):
            if sparse is None:
                x = data["x"][(step + p) % W.STEPS, p % 2]
                W.linear_loss(torch, model, x).backward()
            else:
                W.embedding_loss(torch, model,
                                 data["idx"][step, p % 2]).backward()
        if clip:
            opt.synchronize()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 0.05)
            with opt.skip_synchronize():
                opt.step()
        else:
            opt.step()
        opt.zero_grad()
    return [p.detach().clone() for p in model.parameters()]


CASES = {f"{k}-{c}": dict(kind=k, comp=c) for k in W.OPTIMIZERS
         for c in W.COMPRESSIONS}
CASES.update({
    "sgd-bpps2": dict(kind="sgd", bpps=2),
    "adam-fp16-bpps2": dict(kind="adam", comp="fp16", bpps=2),
    "sparse": dict(kind="sgd", sparse=False),
    "sparse-as-dense": dict(kind="sgd", sparse=True),
    "sparse-bpps2": dict(kind="sgd", sparse=False, bpps=2),
    "clip-skip-synchronize": dict(kind="sgd", clip=True),
    "adam-predivide": dict(kind="adam", predivide=4.0),
})


@pytest.mark.parametrize("case", list(CASES))
def test_world1_parameters_match_reference_bit_for_bit(both, data, case):
    ref, port = both
    want = _train(ref, data, **CASES[case])
    got = _train(port, data, **CASES[case])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), case


def test_world1_sync_batch_norm_matches_reference(both, data):
    ref, port = both
    outs = []
    for mod in (ref, port):
        bn = mod.SyncBatchNorm(3)
        x = torch.from_numpy(data["bn_x"][0]).requires_grad_()
        out = bn(x)
        (out * torch.from_numpy(data["bn_ct"][0])).sum().backward()
        bn.eval()
        outs.append([out, x.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var, bn(x)])
    for g, w in zip(outs[1], outs[0]):
        assert torch.equal(g, w)


def test_world1_broadcast_optimizer_state_matches_reference(both, data):
    ref, port = both
    states = []
    for mod in (ref, port):
        model = W.make_linear(torch, data)
        opt = torch.optim.Adam(model.parameters(), lr=0.01)
        W.linear_loss(torch, model, data["x"][0, 0]).backward()
        opt.step()
        mod.broadcast_optimizer_state(opt, root_rank=0)
        mod.broadcast_parameters(model.state_dict(), root_rank=0)
        states.append(opt.state_dict())
    (ref_sd, port_sd) = states
    assert ref_sd["param_groups"] == port_sd["param_groups"]
    for pid, st in ref_sd["state"].items():
        for k, v in st.items():
            assert torch.equal(port_sd["state"][pid][k], v), (pid, k)


def _api_calls(mod):
    """The async, grouped and differentiable calls of
    tests/test_torch_async_grouped.py and the matrix's corners, at
    world 1."""
    out = {}
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out["allreduce_async"] = mod.synchronize(mod.allreduce_async(
        x, op=mod.Sum, name="a.ar"))
    t = torch.full((4,), 2.0)
    assert mod.synchronize(mod.allreduce_async_(t, op=mod.Sum)) is t
    out["allreduce_async_"] = t
    t = torch.randn(3, 3, generator=torch.Generator().manual_seed(1))
    assert mod.synchronize(mod.broadcast_async_(t, root_rank=0)) is t
    out["broadcast_async_"] = t
    out["allgather_async"] = mod.synchronize(
        mod.allgather_async(torch.ones(2, 2)))
    got, splits = mod.synchronize(mod.alltoall_async(
        torch.arange(4, dtype=torch.float32)))
    out["alltoall_async"] = (got, splits.to(torch.int64))
    out["grouped"] = mod.grouped_allreduce(
        [torch.full((3,), float(i)) for i in range(4)], op=mod.Sum)
    ins = [torch.full((2,), 5.0), torch.full((2,), 7.0)]
    assert mod.grouped_allreduce_(ins, op=mod.Average)[0] is ins[0]
    out["grouped_"] = ins
    for dtype in (torch.uint8, torch.int32, torch.int64, torch.float16,
                  torch.float64, torch.bfloat16):
        t = torch.arange(12).reshape(3, 4).to(dtype)
        out[f"dtype-{dtype}"] = mod.allreduce(t, op=mod.Sum)
    # Differentiable: allreduce, allgather (also of a scalar), broadcast,
    # alltoall and the grouped allreduce.
    v = torch.tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    (mod.allreduce(v, op=mod.Sum) ** 2).sum().backward()
    (mod.allgather(v) * 3).sum().backward()
    mod.broadcast(v, root_rank=0).sum().backward()
    a, _ = mod.alltoall(v)
    (5 * a).sum().backward()
    g0, g1 = mod.grouped_allreduce([v, v * 2], op=mod.Sum)
    (g0 + g1).sum().backward()
    s = torch.tensor(3.0, requires_grad=True)
    (2 * mod.allgather(s)).sum().backward()
    out["grads"] = (v.grad, s.grad)
    out["sparse"] = mod.sparse_allreduce(torch.sparse_coo_tensor(
        torch.tensor([[0, 2], [1, 0]]), torch.tensor([3.0, 4.0]), (3, 2)),
        name="sp1", op=mod.Sum).to_dense()
    out["join"] = mod.join()
    mod.barrier()
    out["fp16"] = mod.allreduce(v.detach(), compression=mod.Compression.fp16)
    out["bf16"] = mod.allreduce(v.detach(), compression=mod.Compression.bf16)
    return out


def _assert_equal_tree(got, want, path="out"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_equal_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_tree(g, w, f"{path}[{i}]")
    elif torch.is_tensor(want):
        assert g_eq(got, want), path
    else:
        assert got == want, path


def g_eq(a, b):
    return torch.is_tensor(a) and a.dtype == b.dtype and torch.equal(a, b)


def test_world1_api_calls_match_reference(both):
    ref, port = both
    _assert_equal_tree(_api_calls(port), _api_calls(ref))


def test_optimizer_guards_match_reference(both, data):
    """zero_grad with handles in flight, a second backward before step()
    and step() after synchronize() without skip_synchronize() raise or
    warn in both packages."""
    for mod in both:
        model = W.make_linear(torch, data)
        opt = mod.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        W.linear_loss(torch, model, data["x"][0, 0]).backward()
        with pytest.raises(AssertionError):
            opt.zero_grad()
        with pytest.raises(AssertionError):
            W.linear_loss(torch, model, data["x"][1, 0]).backward()
        opt.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt.step()
        assert any("skip_synchronize" in str(w.message) for w in caught)
        opt.zero_grad()
        with pytest.raises(ValueError):
            mod.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=[("a", model.weight), ("a", model.bias)])
        with pytest.raises(ValueError):
            mod.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1),
                                     op=mod.Adasum,
                                     backward_passes_per_step=2)


def test_built_shims_and_public_names(both):
    ref, port = both
    names = [n for n in dir(ref) if not n.startswith("_")
             and n not in ("np", "Any", "Dict", "Iterable", "List",
                           "Optional", "Tuple", "annotations")]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for shim in ("mpi_built", "gloo_built", "nccl_built", "ddl_built",
                 "ccl_built", "cuda_built", "rocm_built",
                 "mpi_threads_supported"):
        assert isinstance(getattr(port, shim)(), bool)


def test_cpu_tensor_in_an_nccl_world_is_refused(both, monkeypatch):
    """A CPU tensor handed to a world on the card is never copied there:
    without a controller every front-end collective refuses it, and the
    hooks refuse a CPU gradient."""
    monkeypatch.setattr(global_state, "device", torch.device("cuda", 0))
    x = torch.ones(3)
    for call in (lambda: hvd.allreduce(x), lambda: hvd.allgather(x),
                 lambda: hvd.broadcast(x, 0), lambda: hvd.alltoall(x),
                 lambda: hvd.allreduce_async(x), lambda: hvd.allreduce_(x),
                 lambda: hvd.grouped_allreduce([x])):
        with pytest.raises(ValueError, match="move it there first"):
            call()
    model = torch.nn.Linear(3, 1)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    with pytest.raises(ValueError, match="move it there first"):
        model(x).sum().backward()
    assert x.device.type == "cpu"
    del opt


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "frontend",
                             prepare=pool.write_ports(1))


def _grads(model, loss):
    return [g.detach() for g in torch.autograd.grad(loss, list(
        model.parameters()))]


WIRE = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16}


def _wire_mean(gs, comp):
    """The mean of the ranks' gradients as the wire computes it: the sum
    and the division in the wire's dtype."""
    dt = WIRE[comp]
    if dt is None:
        return (gs[0] + gs[1]) / 2
    return ((gs[0].to(dt) + gs[1].to(dt)) / 2).to(gs[0].dtype)


def _fed_reference(data, kind, comp, steps=W.STEPS, join=False):
    """The reference's DistributedOptimizer at world 1 fed the two ranks'
    mean gradient (after ``join``, rank 1's zeros from step 3 on)."""
    import horovod_tpu
    import horovod_tpu.torch as ref
    horovod_tpu.init()
    model = W.make_linear(torch, data)
    opt = ref.DistributedOptimizer(
        W.make_optimizer(torch, kind, model.parameters()),
        named_parameters=model.named_parameters())
    for step in range(steps):
        per_rank = [_grads(model, W.linear_loss(torch, model,
                                                data["x"][step, r]))
                    for r in range(2)]
        if join and step >= W.JOIN_STEPS[1]:
            per_rank[1] = [torch.zeros_like(g) for g in per_rank[1]]
        for p, g0, g1 in zip(model.parameters(), *per_rank):
            p.grad = _wire_mean([g0, g1], comp)
        opt.step()
        opt.zero_grad()
    return [p.detach() for p in model.parameters()]


@pytest.mark.timeout(150)
@pytest.mark.parametrize("case", [f"{k}-{c}" for k in W.OPTIMIZERS
                                  for c in W.COMPRESSIONS])
def test_two_ranks_match_the_fed_reference(ranks, data, case):
    kind, comp = case.split("-")
    want = _fed_reference(data, kind, comp)
    for r, res in enumerate(ranks):
        for g, w in zip(res[f"opt-{case}"], want):
            assert torch.equal(g, w), (case, r)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("dense", [False, True])
def test_two_ranks_sparse_gradients(ranks, data, dense):
    emb = W.make_embedding(torch, data)
    opt = torch.optim.SGD(emb.parameters(), lr=0.1)
    for step in range(W.STEPS):
        gs = [torch.autograd.grad(W.embedding_loss(
            torch, emb, data["idx"][step, r]), emb.weight)[0].to_dense()
            for r in range(2)]
        emb.weight.grad = (gs[0] + gs[1]) / 2
        opt.step()
        opt.zero_grad()
    for r, res in enumerate(ranks):
        (got,) = res[f"sparse-{dense}"]
        assert torch.equal(got, emb.weight.detach()), (dense, r)
    rows = [data["idx"][0, r] for r in range(2)]
    want = torch.zeros(10, 4)
    for r in range(2):
        for i in set(rows[r].tolist()):
            want[i] += torch.from_numpy(data["emb"][i]) * \
                int((rows[r] == i).sum())
    for res in ranks:
        torch.testing.assert_close(res["sparse_allreduce"], want / 2,
                                   rtol=0, atol=0)


@pytest.mark.timeout(150)
def test_two_ranks_sync_batch_norm_is_batch_norm_of_both(ranks, data):
    bn = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["bn_w"]))
        bn.bias.copy_(torch.from_numpy(data["bn_b"]))
    x = torch.from_numpy(np.concatenate(data["bn_x"])).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(np.concatenate(data["bn_ct"]))).sum().backward()
    n = data["bn_x"].shape[1]
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, res in enumerate(ranks):
        y, gx, gw, gb, rm, rv = res["sbn"]
        torch.testing.assert_close(y, out.detach()[r * n:(r + 1) * n], **tol)
        torch.testing.assert_close(gx, x.grad[r * n:(r + 1) * n], **tol)
        torch.testing.assert_close(rm, bn.running_mean, **tol)
        torch.testing.assert_close(rv, bn.running_var, **tol)
    # The affine gradients are each rank's own; their sum is the batch's.
    torch.testing.assert_close(ranks[0]["sbn"][2] + ranks[1]["sbn"][2],
                               bn.weight.grad, **tol)
    torch.testing.assert_close(ranks[0]["sbn"][3] + ranks[1]["sbn"][3],
                               bn.bias.grad, **tol)


@pytest.mark.timeout(150)
def test_two_ranks_adasum_delta_matches_reference_pair(ranks, data):
    import jax.numpy as jnp
    from horovod_tpu.ops.adasum import adasum_pair
    deltas = []
    for r in range(2):
        model = W.make_linear(torch, data)
        start = [p.detach().clone() for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        W.linear_loss(torch, model, data["x"][0, r]).backward()
        opt.step()
        deltas.append([p.detach() - s for p, s in
                       zip(model.parameters(), start)])
    for i, s in enumerate(start):
        want = s.numpy() + np.asarray(adasum_pair(
            jnp.asarray(deltas[0][i].numpy()),
            jnp.asarray(deltas[1][i].numpy())))
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res["adasum"][i].numpy(), want,
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"param {i} rank {r}")
    for a, b in zip(ranks[0]["adasum"], ranks[1]["adasum"]):
        assert torch.equal(a, b)


@pytest.mark.timeout(150)
def test_two_ranks_allgather_unequal_rows_and_its_gradient(ranks, data):
    rows = [torch.from_numpy(data["x"][0, r][: r + 2]) for r in range(2)]
    want = torch.cat(rows)
    ct = torch.arange(want.numel(), dtype=want.dtype).view_as(want)
    for r, res in enumerate(ranks):
        g, gx = res["allgather"]
        assert torch.equal(g, want)
        assert torch.equal(gx, ct[2 * r: 2 * r + r + 2])


@pytest.mark.timeout(150)
def test_two_ranks_torch_state_sync_broadcasts_tensors_in_place(ranks,
                                                                data):
    """Rank 1's optimizer held no state before the sync (a respawned
    member); after it both hold rank 0's parameters, Adam state and
    objects, and no tensor went through ``broadcast_object``'s pickle."""
    root, other = ranks[0]["torch_state"], ranks[1]["torch_state"]
    for a, b in zip(root["params"], other["params"]):
        assert torch.equal(a, b)
    assert sorted(other["opt_state"]) == sorted(root["opt_state"]) != []
    for k, v in root["opt_state"].items():
        assert torch.equal(other["opt_state"][k], v), k
    assert root["epoch"] == other["epoch"] == 3
    for res in (root, other):
        assert res["pickles"] == 1 and not res["pickled_tensor"]


@pytest.mark.timeout(150)
def test_two_ranks_broadcast_optimizer_state_to_a_stateless_member(ranks):
    """Rank 1's optimizer held no state: it takes rank 0's, as the
    elastic sync does (the same collectives on both ranks)."""
    root, other = ranks[0]["opt_state"], ranks[1]["opt_state"]
    assert sorted(other["state"]) == sorted(root["state"]) != []
    for k, v in root["state"].items():
        assert torch.equal(other["state"][k], v), k
    assert other["groups"] == root["groups"]


@pytest.mark.timeout(150)
def test_two_ranks_join_with_uneven_batches(ranks, data):
    """Rank 1 joins after two batches; rank 0's third allreduce averages
    its gradient with the joined rank's zeros."""
    # Both ranks read the same answer from the runtime (the one
    # test_torch_port_native.py holds to the reference's).
    assert len({res["join_last"] for res in ranks}) == 1
    want = _fed_reference(data, "sgd", "none", join=True)
    for g, w in zip(ranks[0]["join"], want):
        assert torch.equal(g, w)
    two = _fed_reference(data, "sgd", "none", steps=2)
    for g, w in zip(ranks[1]["join"], two):
        assert torch.equal(g, w)
