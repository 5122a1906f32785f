"""horovod_tpu_torch's data-parallel training step against horovod_tpu's.

World 1 (gloo, ``device="cpu"``): ``DistributedOptimizer(AdamW)`` steps on
the small flagship configuration track ``hvd.DistributedOptimizer(
optax.adamw)`` on the same parameters and batch, fp32.  World 2 (two gloo
processes): gradients are averaged, integer ``Average`` is floored, and
the other reduce ops, scale factors, grouped reduction and broadcasts keep
the reference's semantics."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as hvd_jax
import horovod_tpu_torch as hvd
from horovod_tpu.compat import shard_map
from horovod_tpu.models import transformer as tfm_jax
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm

SMALL = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=64)
LR, WD = 3e-4, 1e-4


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _jax_train(params, tokens, labels, n_steps):
    cfg = tfm_jax.TransformerConfig(dtype=jnp.float32, **SMALL)
    tx = hvd_jax.DistributedOptimizer(optax.adamw(LR, weight_decay=WD))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

    def step(p, s, tok, lab):
        loss, g = jax.value_and_grad(tfm_jax.serial_forward_loss,
                                     argnums=1)(cfg, p, tok, lab)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    step = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), P(), P(), P()),
                             out_specs=(P(), P(), P()), check_vma=False))
    state, losses = tx.init(params), []
    tok, lab = jnp.asarray(tokens, jnp.int32), jnp.asarray(labels, jnp.int32)
    for _ in range(n_steps):
        params, state, loss = step(params, state, tok, lab)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_steps_track_optax(world1, n_steps):
    cfg_j = tfm_jax.TransformerConfig(dtype=jnp.float32, **SMALL)
    params = tfm_jax.init_params(jax.random.PRNGKey(0), cfg_j,
                                 tfm_jax.ParallelConfig())
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SMALL["vocab_size"], (2, SMALL["seq_len"]))
    labels = np.roll(tokens, -1, axis=1)

    cfg = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=LR, weight_decay=WD))
    step = tfm.make_train_step(cfg, par, model, opt)
    losses = [step(torch.from_numpy(tokens), torch.from_numpy(labels)).item()
              for _ in range(n_steps)]

    ref_params, ref_losses = _jax_train(params, tokens, labels, n_steps)
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5, rtol=0)
    # Each step moves a weight by about lr (3e-4); Adam divides by |g|, so
    # a weight whose gradient is near zero amplifies fp32 summation-order
    # differences: 1e-5 is 3% of one step.
    for name, ref in convert.params_from_jax(ref_params).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   ref.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_backward_passes_per_step_matches_reference(world1):
    """Two passes accumulate, the second communicates and updates; the
    first leaves the parameters as they were (reference _AggState)."""
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32)
             for _ in range(4)]

    tx = hvd_jax.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                      backward_passes_per_step=2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    upd = jax.jit(shard_map(lambda g, s, p: tx.update(g, s, p), mesh=mesh,
                            in_specs=(P(), P(), P()), out_specs=(P(), P()),
                            check_vma=False))
    p_ref, state, ref_traj = jnp.asarray(w0), tx.init(jnp.asarray(w0)), []
    for g in grads:
        u, state = upd(jnp.asarray(g), state, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
        ref_traj.append(np.asarray(p_ref))

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1, momentum=0.9),
                                   backward_passes_per_step=2)
    for g, ref in zip(grads, ref_traj):
        opt.zero_grad()
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), ref, atol=1e-6)


def test_adasum_backward_passes_equal_average_at_world_one(world1):
    """With backward_passes_per_step 2, Adasum's delta model steps on the
    scaled sum of the passes (reference optimizers.py:200-207); at world 1
    its reduction is the identity, so it equals Average: SGD(lr 1) on
    (1, 2, 3, 4) then (3, 2, 1, 0) moves p by -(2, 2, 2, 2).  Unscaled
    and unsummed it would move by the last pass alone."""
    got = {}
    for op in (hvd.Average, hvd.Adasum):
        for average in (True, False):
            p = torch.nn.Parameter(torch.zeros(4))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([p], lr=1.0), op=op,
                backward_passes_per_step=2,
                average_aggregated_gradients=average)
            traj = []
            for g in ([1.0, 2.0, 3.0, 4.0], [3.0, 2.0, 1.0, 0.0]) * 2:
                p.grad = torch.tensor(g)
                opt.step()
                traj.append(p.detach().clone())
            got[op, average] = traj
    want = torch.tensor([-2.0, -2.0, -2.0, -2.0])
    for average, scale in ((True, 1.0), (False, 2.0)):
        adasum, mean = got[hvd.Adasum, average], got[hvd.Average, average]
        assert torch.equal(adasum[0], torch.zeros(4))   # pass 1 waits
        torch.testing.assert_close(adasum[1], scale * want, rtol=0, atol=0)
        torch.testing.assert_close(adasum[3], 2 * scale * want, rtol=0,
                                   atol=0)
        for a, b in zip(adasum, mean):
            assert torch.equal(a, b)


def test_unported_options_raise(world1):
    """What is refused says where to go instead (ZeRO state: the sharded
    checkpoint engine, not a dict); Adasum, which once raised, runs: at
    world 1 its reduction is the identity, so an SGD step moves p by
    -lr g through p + (p' - p)."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                   op=hvd.Adasum)
    p.grad = torch.tensor([1.0, -2.0])
    opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([-0.1, 0.2]))
    zero = hvd.ZeroShardedOptimizer([p], torch.optim.SGD)
    with pytest.raises(TypeError, match="sharded checkpoint engine"):
        zero.state_dict()
    with pytest.raises(ValueError, match="floating tensor"):
        hvd.allreduce(torch.zeros(2, dtype=torch.int32), compression="int8")
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                 backward_passes_per_step=0)


@pytest.mark.parametrize("overlap", [False, True])
def test_optimizer_min_max_on_cast_wire_reduce_unrounded(world1, overlap):
    """DistributedOptimizer(op=Max, compression=fp16) reduces the gradient
    in its own dtype on both schedules (the port's per-parameter schedule
    is one-parameter buckets), as the reference's bucketed schedule does
    (``bucketed_allreduce_tree``); the reference's per-leaf schedule casts
    to fp16 first (ROADMAP.md queue 3)."""
    from horovod_tpu.ops import overlap as Oj
    g = np.array([1.0 + 2.0 ** -20, -3.3, 7e-6], np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ref = jax.jit(shard_map(
        lambda x: Oj.bucketed_allreduce_tree(
            [x], op=hvd_jax.Max, axis_name="data",
            compression=hvd_jax.Compression.fp16, bucket_bytes=1024)[0],
        mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False))(
        jnp.asarray(g))
    p = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                   op=hvd.Max, compression="fp16",
                                   overlap=overlap)
    p.grad = torch.from_numpy(g.copy())
    opt.synchronize()
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(p.grad.numpy(), g)


def test_world1_collectives_keep_dtype(world1):
    x = torch.tensor([5, -5, 7], dtype=torch.int64)
    out = hvd.allreduce(x)
    assert out.dtype == torch.int64 and out.tolist() == [5, -5, 7]
    f = torch.tensor([1.5, 2.5], dtype=torch.bfloat16)
    assert hvd.allreduce(f, op=hvd.Sum, postscale_factor=2.0).tolist() == \
        [3.0, 5.0]
    assert hvd.broadcast(f).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Two gloo processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_case():
    """The reference's parameters (PRNGKey(1)) and a batch of 4 sequences,
    which the two ranks split into contiguous shards of 2."""
    cfg = tfm_jax.TransformerConfig(dtype=jnp.float32, **SMALL)
    params = tfm_jax.init_params(jax.random.PRNGKey(1), cfg,
                                 tfm_jax.ParallelConfig())
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, SMALL["vocab_size"], (4, SMALL["seq_len"]))
    return cfg, params, tokens, np.roll(tokens, -1, axis=1)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, lm_case):
    import torch.multiprocessing as mp
    import _torch_port_workers as workers
    out = tmp_path_factory.mktemp("two_ranks")
    _, params, tokens, labels = lm_case
    np.savez(os.path.join(out, "lm.npz"), cfg=json.dumps(SMALL),
             tokens=tokens, labels=labels,
             **{"param." + k: v.numpy()
                for k, v in convert.params_from_jax(params).items()})
    mp.start_processes(workers.two_rank_checks,
                       args=(2, f"file://{out}/rendezvous", str(out)),
                       nprocs=2, join=True, start_method="spawn")
    res = [json.load(open(os.path.join(out, f"rank{r}.json")))
           for r in range(2)]
    for r in range(2):
        res[r]["lm_grads"] = torch.load(
            os.path.join(out, f"rank{r}_lm_grads.pt"))
    return res


def _same_on_both(two_ranks, key):
    assert two_ranks[0][key] == two_ranks[1][key], key
    return two_ranks[0][key]


@pytest.mark.timeout(150)
def test_two_ranks_topology(two_ranks):
    for r, res in enumerate(two_ranks):
        assert res["topology"] == [r, 2, r, 2, 0, 1]


X = np.array([1.0, 2.0, 3.0])


@pytest.mark.timeout(150)
@pytest.mark.parametrize("key,expected", [
    ("average", 1.5 * X), ("sum", 3 * X), ("min", X), ("max", 2 * X),
    ("product", 2 * X * X), ("scaled_average", 1.5 * X * 2 * 0.25),
    ("broadcast", 2 * X)])
def test_two_ranks_float_ops(two_ranks, key, expected):
    np.testing.assert_allclose(_same_on_both(two_ranks, key), expected)


@pytest.mark.timeout(150)
def test_two_ranks_integer_average_floors(two_ranks):
    # sums [7, -3, 7] floor-divided by 2; the dtype stays int32.
    assert _same_on_both(two_ranks, "int_average") == [[3, -2, 3],
                                                       "torch.int32"]
    # A fractional prescale goes through float: 1.5 + 2.0 -> 3 (truncated).
    assert _same_on_both(two_ranks, "int_prescaled_sum") == [[3],
                                                             "torch.int64"]
    for r, res in enumerate(two_ranks):
        assert res["input_untouched"] == (X * (r + 1)).tolist()


@pytest.mark.timeout(150)
def test_two_ranks_grouped_allreduce(two_ranks):
    got = _same_on_both(two_ranks, "grouped")
    np.testing.assert_allclose(got[0], 3 * X)
    assert got[1] == [7, -3, 7]
    np.testing.assert_allclose(np.ravel(got[2]), 30 * X)
    np.testing.assert_allclose(
        np.ravel(_same_on_both(two_ranks, "allreduce_gradients")["b"]),
        3 * X)


@pytest.mark.timeout(150)
def test_two_ranks_optimizer_averages_gradients(two_ranks):
    """Each rank's local gradient differs (rank r's data is r+1 times rank
    0's); after step() both hold their mean, and the update is AdamW's on
    that mean, from rank 0's broadcast weights."""
    local = [res["local_grad"] for res in two_ranks]
    assert local[0] != local[1]
    synced = _same_on_both(two_ranks, "synced_grad")
    for i, g in enumerate(synced):
        np.testing.assert_allclose(
            g, (np.array(local[0][i]) + np.array(local[1][i])) / 2,
            rtol=1e-6)
    init = _same_on_both(two_ranks, "params_after_broadcast")
    ps = [torch.nn.Parameter(torch.tensor(w)) for w in init]
    opt = torch.optim.AdamW(ps, lr=0.1, weight_decay=1e-4)
    for p, g in zip(ps, synced):
        p.grad = torch.tensor(g)
    opt.step()
    after = _same_on_both(two_ranks, "params_after_step")
    for p, w in zip(ps, after):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6)
    _same_on_both(two_ranks, "params_after_steps")


@pytest.mark.timeout(150)
def test_two_ranks_train_step_returns_dp_mean_loss(two_ranks, lm_case):
    """Each rank trains on its own shard; ``make_train_step`` returns the
    same loss on both, bit for bit: the mean of the shards' losses, which
    is what the reference's ``make_loss_fn`` computes on a 2-device dp
    mesh (its pmean over dp)."""
    step_loss = _same_on_both(two_ranks, "lm_step_loss")
    local = [res["lm_local_loss"] for res in two_ranks]
    assert local[0] != local[1]
    np.testing.assert_allclose(step_loss, np.mean(local), rtol=1e-6)
    assert not _same_on_both(two_ranks, "lm_step_loss_requires_grad")

    cfg, params, tokens, labels = lm_case
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1),
                ("dp", "pp", "mp"))
    ref = tfm_jax.make_loss_fn(cfg, tfm_jax.ParallelConfig(dp=2), mesh)(
        params, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(labels, jnp.int32))
    np.testing.assert_allclose(step_loss, float(ref), atol=1e-5, rtol=0)


@pytest.mark.timeout(150)
def test_two_ranks_train_step_averages_gradients_once(two_ranks):
    """The loss's value is the dp mean but its gradient is the rank's own:
    after the step each rank holds the mean of the shards' gradients, as
    before the loss was averaged."""
    grads = [res["lm_grads"] for res in two_ranks]
    for name, g0 in grads[0]["local"].items():
        g1 = grads[1]["local"][name]
        assert not torch.equal(g0, g1), name
        mean = (g0 + g1) / 2
        for r in range(2):
            torch.testing.assert_close(grads[r]["synced"][name], mean,
                                       rtol=1e-6, atol=1e-9)


def test_world1_train_step_returns_serial_loss(world1, lm_case):
    """At world 1 the dp mean is the rank's own loss, exactly."""
    _, params, tokens, labels = lm_case
    cfg = tfm.TransformerConfig(dtype=torch.float32, **SMALL)
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    with torch.no_grad():
        serial = tfm.serial_forward_loss(cfg, model, tok, lab).item()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.0))
    loss = tfm.make_train_step(cfg, tfm.ParallelConfig(), model, opt)(tok,
                                                                      lab)
    assert loss.item() == serial


@pytest.mark.timeout(150)
def test_two_ranks_broadcast_optimizer_state(two_ranks):
    """Rank 1 perturbed its moments; the broadcast restored rank 0's."""
    state = _same_on_both(two_ranks, "opt_state")
    assert [s[2] for s in state] == [2.0, 2.0]


@pytest.mark.timeout(150)
def test_two_ranks_broadcast_refuses_zero_state(two_ranks):
    """ZeRO state is rank-distinct: broadcast_optimizer_state refuses it on
    every rank, as the reference does (optimizers.py:674-690), and points
    at the checkpoint engine; each rank's shard moments stay its own."""
    for r, res in enumerate(two_ranks):
        msg, moments = res["zero_broadcast"]
        assert "rank-distinct" in msg and "save_zero_state" in msg
        assert moments == [[1.0 + r] * 3]
    assert two_ranks[0]["zero_broadcast"][1] != \
        two_ranks[1]["zero_broadcast"][1]
