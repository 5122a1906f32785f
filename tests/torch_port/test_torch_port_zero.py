"""horovod_tpu_torch's ``ZeroShardedOptimizer`` (stages 1-3) against the
port's replicated ``DistributedOptimizer`` and against horovod_tpu's
``ZeroShardedOptimizer``, on four gloo ranks laid out 2 x 2 (started once
per test process by ``_torch_port_pool.part_results``).

The problem is the reference's own stage-parity drill
(tests/test_zero_stages.py): w (4, 3) and b (16,) from linspaces, each
rank its own batch row, AdamW(1e-2, wd 1e-3), 3 steps; its bar is the
reference's, rtol 1e-5 and atol 1e-6 (the reduce-scatter and the
allreduce add in different orders).  The reference runs under
``shard_map`` on a 4-device CPU mesh.  Stage 3's bucketed gather (64-byte
buckets) equals its one-bucket gather bit for bit on the int8 wire; on the
uncompressed wire the backend's reduce-scatter sums a bucket in an order
that follows the element's offset, so there the bar applies.  The small
transformer's ``make_train_step`` at every stage tracks the replicated
step within the same bar."""

import functools

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
from horovod_tpu.core import config as cfg_jax

import _torch_port_pool as pool

WORLD = pool.WORLD
BAR = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "zero")


def _loss(p, x):
    return jnp.sum((x @ p["w"]) ** 2) * 1e-3 + jnp.sum(p["b"] ** 2) * 1e-2


def _reference_run(stage, steps=3, **kw):
    """The reference's _run_stage (tests/test_zero_stages.py) at world 4;
    stage 0 is its replicated DistributedOptimizer."""
    inputs = pool.part_inputs("zero")
    params = {k: jnp.asarray(inputs[k]) for k in ("w", "b")}
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    inner = optax.adamw(1e-2, weight_decay=1e-3)
    tx = hvd_jax.DistributedOptimizer(inner) if stage == 0 else \
        hvd_jax.ZeroShardedOptimizer(inner, stage=stage, **kw)

    def step(p, x):
        x = x[0]
        if stage == 3:
            ps = tx.shard_params(p)
            st = tx.init(ps)
            for _ in range(steps):
                g = jax.grad(lambda s: _loss(tx.gather_params(s, p), x))(
                    ps.inner)
                u, st = tx.update(g, st, ps)
                ps = tx.apply_updates(ps, u)
            return tx.gather_params(ps, p)
        st = tx.init(p)
        out = p
        for _ in range(steps):
            g = jax.grad(_loss)(out, x)
            if stage == 2:
                g = tx.reduce_grads(g)
            u, st = tx.update(g, st, out)
            out = optax.apply_updates(out, u)
        return out

    hvd_jax.init()
    out = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), P("data")),
                            out_specs=P(), check_vma=False))(
        params, jnp.asarray(inputs["x"]))
    return [np.asarray(out["w"]), np.asarray(out["b"])]


@pytest.mark.timeout(150)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_replicated_and_reference(ranks, stage):
    ref = _reference_run(stage)
    for r, res in enumerate(ranks):
        for got, rep, want in zip(res[f"stage{stage}"], res["stage0"], ref):
            torch.testing.assert_close(got, rep, **BAR)
            np.testing.assert_allclose(got.numpy(), want, **BAR)
        for got, want in zip(res[f"stage{stage}"], ranks[0][f"stage{stage}"]):
            assert torch.equal(got, want), r     # replicated, bit for bit
    # The steps moved the parameters.
    assert not np.allclose(ranks[0]["stage0"][0].numpy(),
                           pool.ZERO_PARAMS["w"], atol=1e-3)


@pytest.mark.timeout(150)
def test_replicated_matches_reference(ranks):
    ref = _reference_run(0)
    for res in ranks:
        for got, want in zip(res["stage0"], ref):
            np.testing.assert_allclose(got.numpy(), want, **BAR)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("wire", ["none", "int8"])
def test_stage3_bucketed_gather_matches_barrier(ranks, wire):
    suffix = "" if wire == "none" else "-int8"
    for res in ranks:
        for a, b in zip(res["stage3-bucketed" + suffix],
                        res["stage3-barrier" + suffix]):
            if wire == "int8":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, **BAR)


@pytest.mark.timeout(150)
@pytest.mark.parametrize("variant", ["stage1-hooks", "stage2-hooks",
                                     "stage1-joint"])
def test_hooks_and_joint_axis_match_replicated(ranks, variant):
    """Stages 1-2 reduce-scattering from backward's hooks (64-byte
    buckets), and stage 1 sharded over ("local", "cross")."""
    for res in ranks:
        for got, rep in zip(res[variant], res["stage0"]):
            torch.testing.assert_close(got, rep, **BAR)


@pytest.mark.timeout(150)
def test_stage1_int8_matches_reference(ranks):
    """Stage 1 on the int8 wire with error feedback, against the
    reference's, within the same bar; the wire moved the result off the
    uncompressed run's."""
    ref = _reference_run(1, compression=hvd_jax.Compression.int8)
    for res in ranks:
        for got, want in zip(res["stage1-int8"], ref):
            np.testing.assert_allclose(got.numpy(), want, **BAR)
        assert any(not torch.allclose(a, b, rtol=0, atol=1e-6) for a, b in
                   zip(res["stage1-int8"], res["stage1"]))


@pytest.mark.timeout(150)
def test_stage2_refuses_full_gradients(ranks):
    for res in ranks:
        assert "takes gradient shards" in res["refusal"]
        assert "reduce_grads()" in res["refusal"]


@pytest.mark.timeout(150)
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_make_train_step_matches_replicated(ranks, stage):
    """The small transformer, 2 steps of SGD(0.1, momentum 0.9) at world 4
    (one sequence a rank): every stage's losses and parameters track the
    replicated step."""
    for res in ranks:
        losses, params = res["lm"][stage]
        rep_losses, rep_params = res["lm"][0]
        np.testing.assert_allclose(losses, rep_losses, rtol=1e-6)
        assert sorted(params) == sorted(rep_params)
        for name, p in params.items():
            torch.testing.assert_close(p, rep_params[name], **BAR,
                                       msg=lambda m, n=name: f"{n}: {m}")
    assert ranks[0]["lm"][0][0][1] < ranks[0]["lm"][0][0][0]


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("value,expected", [
    (None, 1), ("2", 2), ("3", 3), ("7", 3), ("0", 1), ("-1", 1),
    ("garbage", 1)])
def test_stage_knob_matches_reference(monkeypatch, world1, value, expected):
    for prefix in ("HVD_TPU_", "HOROVOD_"):
        monkeypatch.delenv(prefix + "ZERO_STAGE", raising=False)
    if value is not None:
        monkeypatch.setenv("HOROVOD_ZERO_STAGE", value)
    assert cfg_jax.Config.from_env().zero_stage == expected
    opt = hvd.ZeroShardedOptimizer([torch.nn.Parameter(torch.ones(3))],
                                   torch.optim.SGD)
    assert opt.stage == expected


@pytest.mark.parametrize("stage", [0, 4, -1])
def test_stage_validation(world1, stage):
    with pytest.raises(ValueError, match="ZeRO stage must be 1, 2 or 3"):
        hvd.ZeroShardedOptimizer([torch.nn.Parameter(torch.ones(3))],
                                 torch.optim.SGD, stage=stage)


def test_zero_state_dict_names_its_roadmap_item(world1):
    """torch's dict idiom is refused with a TypeError that names the
    sharded checkpoint engine, which saves ZeRO state instead."""
    opt = hvd.ZeroShardedOptimizer([torch.nn.Parameter(torch.ones(3))],
                                   functools.partial(torch.optim.SGD, lr=0.1))
    for call in (opt.state_dict, lambda: opt.load_state_dict({})):
        with pytest.raises(TypeError, match="sharded checkpoint engine"):
            call()
    with pytest.raises(ValueError, match="Sum or Average"):
        hvd.ZeroShardedOptimizer([torch.nn.Parameter(torch.ones(3))],
                                 torch.optim.SGD, op=hvd.Max)


def test_grads_are_full_at_world_one(world1):
    """At world 1 a shard is the whole ravel: 1-D gradients are taken as
    shards, anything else as full (reference optimizers.py:496-510)."""
    ps = [torch.nn.Parameter(torch.ones(2, 3)),
          torch.nn.Parameter(torch.ones(4))]
    opt = hvd.ZeroShardedOptimizer(ps, functools.partial(torch.optim.SGD,
                                                         lr=1.0), stage=2)
    assert opt._grads_are_full([torch.ones(2, 3), torch.ones(4)])
    assert not opt._grads_are_full([torch.ones(6), torch.ones(4)])
    opt.step(grads=[torch.full((6,), 0.5), torch.full((4,), 0.25)])
    torch.testing.assert_close(ps[0].detach(), torch.full((2, 3), 0.5))
    torch.testing.assert_close(ps[1].detach(), torch.full((4,), 0.75))
    with pytest.raises(ValueError, match="takes gradient shards"):
        opt.step(grads=[torch.ones(2, 3), torch.ones(4)])


def test_stage3_keeps_only_the_shards(world1):
    """At stage 3 the shards are the parameters' only copy: the module's
    parameters give up their storage (meta templates keep the shapes), so
    a forward through the module raises rather than reading the step-0
    weights, and ``gather_params()`` gives the updated values."""
    model = torch.nn.Linear(4, 3)
    w0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = hvd.ZeroShardedOptimizer(
        model, functools.partial(torch.optim.SGD, lr=0.1), stage=3)
    assert all(p.numel() == 0 for p in model.parameters())
    assert all(t.is_meta for t in opt.params)
    with pytest.raises(RuntimeError):
        model(torch.ones(2, 4))
    full = opt.gather_params()
    for k, v in w0.items():
        assert torch.equal(full[k], v), k
    torch.func.functional_call(model, full, (torch.ones(2, 4),)) \
        .sum().backward()
    opt.step()
    with torch.no_grad():
        after = opt.gather_params()
    # d(sum of outputs)/d(bias) is the batch size, 2.
    torch.testing.assert_close(after["bias"], w0["bias"] - 0.1 * 2)
    torch.testing.assert_close(after["weight"], w0["weight"] - 0.1 * 2)
