"""The building blocks of horovod_tpu_torch's parallel modes against
horovod_tpu's, on the same seeded numpy inputs.

Four gloo ranks (one start per test process,
``_torch_port_pool.part_results("units")``, bodies in
``_torch_port_modes_workers.py``) run on an axis of 4:

* tensor_parallel's five functions, outputs and gradients, against the
  reference under ``shard_map`` on a 4-device CPU mesh differentiated from
  outside (check_vma=False), each member's output its own row;
* ``pipeline_apply`` (GPipe, with and without remat) and
  ``pipeline_apply_1f1b`` on toy tanh stages against the serial stages
  (tests/test_parallel.py:81-143's bars), at 4 microbatches and at 2 (a
  batch shorter than the pipeline), 1F1B's loss bit-equal to GPipe's;
* ``moe_layer`` at ep 4 (top_k 1 and 2, and a capacity of one slot),
  outputs, stats and the gradients of the tokens, gate and experts: the
  tokens' and the gate's reach them through the all-to-all.

In this process: ``build_1f1b_schedule``'s tables, ``top_k_routing`` on
the reference's goldens and ``expert_capacity``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import moe as moe_jax
from horovod_tpu.parallel import pipeline as pp_jax
from horovod_tpu.parallel import tensor_parallel as tp_jax

from horovod_tpu_torch.parallel import moe
from horovod_tpu_torch.parallel import pipeline as pp

import _torch_port_modes_workers as W
import _torch_port_pool as pool

WORLD = pool.WORLD
TP_BAR = dict(rtol=1e-5, atol=1e-5)        # tests/test_parallel.py
GRAD_BAR = dict(atol=5e-5, rtol=1e-4)      # tests/test_moe_pipeline.py


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "units")


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("ax",))


def _vjp(fn, in_specs, args, ct):
    """The reference's per-member outputs (stacked on a leading axis of 4)
    and the gradients of sum(out * ct) for ``args``."""
    f = shard_map(lambda *a: fn(*a)[None], mesh=_mesh(), in_specs=in_specs,
                  out_specs=P("ax"), check_vma=False)

    def fwd_bwd(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)

    out, grads = jax.jit(fwd_bwd)([jnp.asarray(a) for a in args],
                                  jnp.asarray(ct))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in grads)


def _close(got, want, bar, what):
    np.testing.assert_allclose(np.asarray(got), want, **bar, err_msg=what)


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------

def test_column_then_row_parallel(ranks):
    d = pool.part_inputs("units")
    out, gx, gw1, gw2 = _vjp(
        lambda x, w1, w2: tp_jax.row_parallel(
            jax.nn.relu(tp_jax.column_parallel(x, w1)), w2, "ax"),
        (P(), P(None, "ax"), P("ax", None)), (d["x"], d["w1"], d["w2"]),
        d["ct_row"])
    mid = d["w1"].shape[1] // WORLD
    for r, res in enumerate(ranks):
        y, x_g, w1_g, w2_g = res["tp"]["row"]
        _close(y, out[r], TP_BAR, "out")
        _close(x_g, gx, TP_BAR, "x")
        _close(w1_g, gw1[:, r * mid:(r + 1) * mid], TP_BAR, "w1")
        _close(w2_g, gw2[r * mid:(r + 1) * mid], TP_BAR, "w2")


def test_row_parallel_scatters_the_sequence(ranks):
    d = pool.part_inputs("units")
    out, gh, gw2 = _vjp(
        lambda h, w2: tp_jax.row_parallel(h, w2, "ax",
                                          scatter_sequence=True),
        (P(None, None, "ax"), P("ax", None)), (d["h"], d["w2"]),
        d["ct_scatter"])
    mid = d["w1"].shape[1] // WORLD
    for r, res in enumerate(ranks):
        y, h_g, w2_g = res["tp"]["scatter"]
        _close(y, out[r], TP_BAR, "out")
        _close(h_g, gh[..., r * mid:(r + 1) * mid], TP_BAR, "h")
        _close(w2_g, gw2[r * mid:(r + 1) * mid], TP_BAR, "w2")


def test_gather_sequence(ranks):
    d = pool.part_inputs("units")
    out, gs = _vjp(lambda s: tp_jax.gather_sequence(s, "ax", dim=1),
                   (P(None, "ax"),), (d["seq"],), d["ct_gather"])
    s = d["seq"].shape[1] // WORLD
    for r, res in enumerate(ranks):
        y, s_g = res["tp"]["gather"]
        _close(y, out[r], TP_BAR, "out")
        _close(s_g, gs[:, r * s:(r + 1) * s], TP_BAR, "seq")


def test_vocab_parallel_cross_entropy(ranks):
    """Outputs against the reference under shard_map.  JAX has no
    differentiation rule for the reference's pmax, so the gradients are
    held to the unsharded cross entropy's: every member's output is the
    whole loss, so the psums' transposes sum the members' cotangents."""
    d = pool.part_inputs("units")
    v = d["emb"].shape[0] // WORLD
    labels = jnp.asarray(d["labels"], jnp.int32)
    out = np.asarray(shard_map(
        lambda x, emb: tp_jax.vocab_parallel_cross_entropy(
            tp_jax.vocab_parallel_logits(x, emb, "ax"), labels, v,
            "ax")[None],
        mesh=_mesh(), in_specs=(P(), P("ax", None)), out_specs=P("ax"),
        check_vma=False)(jnp.asarray(d["x"]), jnp.asarray(d["emb"])))

    def unsharded(x, emb):
        ce = -jnp.take_along_axis(jax.nn.log_softmax(x @ emb.T),
                                  labels[:, None], axis=1)[:, 0]
        return jnp.sum(ce * d["ct_ce"].sum(0)), ce

    (_, want), (gx, gemb) = jax.value_and_grad(
        unsharded, argnums=(0, 1), has_aux=True)(jnp.asarray(d["x"]),
                                                 jnp.asarray(d["emb"]))
    for r, res in enumerate(ranks):
        ce, x_g, emb_g = res["tp"]["ce"]
        _close(ce, out[r], TP_BAR, "ce")
        _close(ce, np.asarray(want), TP_BAR, "ce against the unsharded")
        _close(x_g, np.asarray(gx), TP_BAR, "x")
        _close(emb_g, np.asarray(gemb)[r * v:(r + 1) * v], TP_BAR, "emb")


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _serial(n_micro):
    """The serial stages' output and the gradients of sum(out**2) for the
    stacked stage weights and the input."""
    d = pool.part_inputs("units")

    def serial(ws, x):
        for s in range(WORLD):
            x = jnp.tanh(x @ ws[s])
        return x

    ws, x = jnp.asarray(d["ws"]), jnp.asarray(d["xs"][:n_micro])
    loss = lambda ws, x: jnp.sum(serial(ws, x) ** 2)   # noqa: E731
    gw, gx = jax.grad(loss, argnums=(0, 1))(ws, x)
    return (float(loss(ws, x)), np.asarray(serial(ws, x)), np.asarray(gw),
            np.asarray(gx))


@pytest.mark.parametrize("sched,remat,n_micro", W.PIPE_CASES)
def test_pipeline_matches_serial_stages(ranks, sched, remat, n_micro):
    loss, out, gw, gx = _serial(n_micro)
    last = ranks[-1]["pipe"][(sched, remat, n_micro)]
    np.testing.assert_allclose(last[1].numpy(), out, rtol=1e-5, atol=1e-6)
    assert float(last[0]) == pytest.approx(loss, rel=1e-5)
    for r, res in enumerate(ranks):
        _, y, w_g, x_g = res["pipe"][(sched, remat, n_micro)]
        if r < WORLD - 1:
            assert not y.any()          # the reference's zeros off the end
        np.testing.assert_allclose(w_g.numpy(), gw[r], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(x_g.numpy(), gx, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_micro", [4, 2])
def test_1f1b_loss_is_gpipes_bit_for_bit(ranks, n_micro):
    for res in ranks:
        gpipe = res["pipe"][("gpipe", False, n_micro)]
        for other in (res["pipe"][("1f1b", False, n_micro)],
                      res["pipe"][("gpipe", True, n_micro)]):
            assert torch.equal(other[0], gpipe[0])
            assert torch.equal(other[1], gpipe[1])


@pytest.mark.parametrize("n_stages,n_micro",
                         [(2, 3), (4, 8), (4, 2), (2, 1), (1, 4), (8, 8),
                          (4, 4), (3, 7)])
def test_1f1b_tables_equal_the_reference(n_stages, n_micro):
    got = pp.build_1f1b_schedule(n_stages, n_micro)
    want = pp_jax.build_1f1b_schedule(n_stages, n_micro)
    np.testing.assert_array_equal(got.kind, want.kind)
    np.testing.assert_array_equal(got.mb, want.mb)
    assert (got.n_slots, got.stash_depth, got.measured_bubble) == \
        (want.n_slots, want.stash_depth, want.measured_bubble)
    assert got.measured_bubble == pytest.approx(
        pp.bubble_fraction(n_stages, n_micro), abs=1e-9)
    assert pp.bubble_fraction(n_stages, n_micro) == \
        pp_jax.bubble_fraction(n_stages, n_micro)


def test_microbatch_stacking_and_note_bubble():
    x = torch.arange(24.0).reshape(6, 4)
    xs = pp.stack_microbatches(x, 3)
    assert xs.shape == (3, 2, 4)
    np.testing.assert_array_equal(
        xs.numpy(), np.asarray(pp_jax.stack_microbatches(jnp.asarray(
            x.numpy()), 3)))
    assert torch.equal(pp.unstack_microbatches(xs), x)
    with pytest.raises(ValueError, match="divisible"):
        pp.stack_microbatches(x, 4)
    # note_bubble credits hvd_pipeline_bubble_seconds_total as the
    # reference's does: the same seconds, into the same family.
    from horovod_tpu.metrics.registry import registry as registry_jax
    from horovod_tpu_torch.metrics.registry import registry

    def bubble_total(reg):
        return sum(c.value for c in reg().children_of(
            "hvd_pipeline_bubble_seconds_total"))

    before = (bubble_total(registry), bubble_total(registry_jax))
    got = pp.note_bubble(4, 8, 1.0)
    want = pp_jax.note_bubble(4, 8, 1.0)
    assert got == want == pp.bubble_fraction(4, 8)
    assert bubble_total(registry) - before[0] == \
        bubble_total(registry_jax) - before[1] == want
    assert registry().snapshot()["hvd_pipeline_bubble_seconds_total"][
        "help"] == registry_jax().snapshot()[
        "hvd_pipeline_bubble_seconds_total"]["help"]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_expert_capacity_matches_reference():
    for args in [(2, 8, 0.1), (1, 64, 1.0), (128, 8, 1.25, 1),
                 (128, 8, 1.25, 2), (4096, 8, 1.25, 1), (4096, 8, 1.25, 2),
                 (33, 5, 0.7, 3)]:
        assert moe.expert_capacity(*args) == moe_jax.expert_capacity(*args)


def _routing_pair(logits, capacity, top_k):
    got = moe.top_k_routing(torch.from_numpy(np.asarray(logits)), capacity,
                            top_k)
    want = moe_jax.top_k_routing(jnp.asarray(logits), capacity, top_k)
    for name in ("dispatch", "combine", "aux_loss", "dropped"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert got.capacity == want.capacity
    return got


def test_top_k_routing_goldens():
    """The reference's goldens (tests/test_moe_pipeline.py:52-105), held
    to its values and to the reference's function."""
    logits = np.array([[2.0, 0.0], [2.0, 0.0], [2.0, 0.0], [0.0, 2.0]],
                      np.float32)
    info = _routing_pair(logits, 2, 1)
    d = info.dispatch.numpy()
    assert d[0, 0, 0] == 1.0 and d[1, 0, 1] == 1.0 and d[3, 1, 0] == 1.0
    assert d[2].sum() == 0.0 and float(info.dropped) == 1.0
    t, e, cap = 8, 2, 3
    logits = np.stack([np.linspace(1.0, 2.0, t), np.linspace(2.0, 1.0, t)],
                      axis=1).astype(np.float32)
    info = _routing_pair(logits, cap, 2)
    d = info.dispatch.numpy()
    assert float(info.dropped) == t * 2 - e * cap
    assert d.sum() == e * cap and (d.sum(axis=0) <= 1.0 + 1e-6).all()
    with pytest.raises(ValueError):
        moe.top_k_routing(torch.from_numpy(logits), cap, 3)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_top_k_routing_with_drops_matches_reference(top_k):
    """Random logits over 6 experts with ties in some rows (equal logits
    go to the lower expert first, as lax.top_k orders them) and a
    capacity that drops routes."""
    rng = np.random.default_rng(5 + top_k)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    logits[::7, 2] = logits[::7, 4]
    info = _routing_pair(logits, 5, top_k)
    assert 0 < float(info.dropped) < 40 * top_k


@pytest.mark.parametrize("case", list(W.MOE_UNIT_CASES))
def test_moe_layer_at_ep4_matches_reference(ranks, case):
    d = pool.part_inputs("units")
    kw = W.MOE_UNIT_CASES[case]

    def fn(gate, w_in, w_out, x):
        out, st = moe_jax.moe_layer(moe_jax.MoEParams(gate, w_in, w_out),
                                    x, "ax", return_stats=True, **kw)
        return out, st.dropped[None], st.aux_loss[None]

    f = shard_map(fn, mesh=_mesh(),
                  in_specs=(P(), P("ax"), P("ax"), P("ax")),
                  out_specs=(P("ax"), P("ax"), P("ax")), check_vma=False)
    def fwd_bwd(args, ct):
        (out, dropped, aux), vjp = jax.vjp(f, *args)
        return (out, dropped, aux), vjp((ct, jnp.zeros_like(dropped),
                                         jnp.zeros_like(aux)))

    args = [jnp.asarray(d[k]) for k in ("gate", "w_in", "w_out", "x_moe")]
    (out, dropped, aux), grads = jax.jit(fwd_bwd)(args,
                                                  jnp.asarray(d["ct_moe"]))
    g_gate, g_in, g_out, g_x = (np.asarray(g) for g in grads)
    t, e = d["x_moe"].shape[0] // WORLD, d["w_in"].shape[0] // WORLD
    for r, res in enumerate(ranks):
        got = res["moe"][case]
        toks, ex = slice(r * t, (r + 1) * t), slice(r * e, (r + 1) * e)
        _close(got["out"], np.asarray(out)[toks], GRAD_BAR, "out")
        assert got["dropped"] == float(dropped[r])
        assert got["aux"] == pytest.approx(float(aux[r]), rel=1e-5)
        assert got["capacity"] == moe.expert_capacity(t, 8, **kw)
        # The tokens and the gate get their gradients through the
        # exchange; were it cut, these would miss the experts' part.
        assert got["x"] is not None and got["x"].abs().sum() > 0
        _close(got["x"], g_x[toks], GRAD_BAR, "x")
        _close(got["gate"], g_gate, GRAD_BAR, "gate")
        _close(got["w_in"], g_in[ex], GRAD_BAR, "w_in")
        _close(got["w_out"], g_out[ex], GRAD_BAR, "w_out")
    if case == "tight":
        assert all(res["moe"][case]["dropped"] > 0 for res in ranks)


def test_quantized_wire_refuses_a_gradient():
    """The quantized all-to-all has no gradient yet (ROADMAP queue 1 item
    6): asked for one it raises, where it would cut the graph; without
    one it runs."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.ops import xla_collectives as XC
    hvd.init(device="cpu")
    try:
        v = torch.randn(1, 4, 256, requires_grad=True)
        spec = Q.QuantSpec(8, 256)
        with pytest.raises(NotImplementedError, match="item 6"):
            XC.all_to_all_wire(v, None, spec)
        with torch.no_grad():
            out = XC.all_to_all_wire(v, None, spec)
        assert out.shape == v.shape and out.dtype == torch.float32
        assert XC.all_to_all_wire(v, None, None).requires_grad
    finally:
        hvd.shutdown()
