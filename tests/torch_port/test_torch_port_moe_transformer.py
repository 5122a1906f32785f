"""horovod_tpu_torch's MoE transformer against horovod_tpu's, on the
reference's weights (``convert.params_from_jax``) and the same tokens.

The configuration (``_torch_port_models_workers.MOET``): fp32, vocab 61,
d 32, 4 heads, per-expert d_ff 48, 2 layers, seq 16, 8 experts, top_k 1,
capacity factor 1.0 (routes drop), 32-element wire blocks; a global batch
of 8 sequences.  Every case holds the loss at rtol 1e-5, the metrics
(``ce`` and ``aux`` at rtol 1e-5, ``dropped`` and ``routed`` exactly)
and every gradient leaf at atol 5e-5, rtol 1e-4 against
``jax.value_and_grad`` of the reference's ``make_loss_fn`` under
``shard_map``, on the fp32, int8 and int4 dispatch wires (the quantized
wires' gradients flow through the block scales, as the reference's):

* (dp, ep) = (1, 1) in this process;
* (2, 2) and (1, 4) on four gloo ranks
  (``_torch_port_pool.part_results("moet")``, bodies in
  ``_torch_port_models_workers.py``), against a 4-device CPU mesh;
* one SGD step of ``make_train_step`` at (2, 2) on int8: the gspmd wire
  counters move by what the reference's metered step records.

Also the no-capacity serial oracle against the sharded forward where
nothing drops, and the FLOPs and wire-ratio helpers."""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.models import moe_transformer as moet_jax
from horovod_tpu.models import transformer as tfm_jax

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import moe_transformer as moet
from horovod_tpu_torch.models import transformer as tfm

import _torch_port_models_workers as W
import _torch_port_pool as pool

LOSS_RTOL = 1e-5
GRAD_BAR = dict(atol=5e-5, rtol=1e-4)      # tests/test_moe_pipeline.py


def _cfg_j(**kw):
    return moet_jax.MoEConfig(**{**W.MOET, "dtype": jnp.float32,
                                 "remat": False, **kw})


def _cfg_t(**kw):
    return moet.MoEConfig(**{**W.MOET, "dtype": torch.float32,
                             "remat": False, **kw})


def _data():
    params = moet_jax.init_params(jax.random.PRNGKey(0), _cfg_j(),
                                  moet_jax.MoEParallelConfig(1, 4))
    rng = np.random.default_rng(41)
    tokens = rng.integers(0, W.MOET["vocab_size"],
                          (W.MOET_BATCH, W.MOET["seq_len"]))
    return params, tokens, np.roll(tokens, -1, axis=1)


def _reference(shape, bits, **kw):
    """The reference's loss, metrics and flat gradients at (dp, ep) =
    ``shape`` on the global batch."""
    params, tokens, labels = _data()
    dp, ep = shape
    mesh = Mesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep),
                ("dp", "ep"))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        moet_jax.make_loss_fn(_cfg_j(dispatch_bits=bits, **kw),
                              moet_jax.MoEParallelConfig(dp, ep), mesh),
        has_aux=True))(params, jnp.asarray(tokens, jnp.int32),
                       jnp.asarray(labels, jnp.int32))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in convert.params_from_jax(grads).items()})


def _check(got_loss, got_metrics, got_grads, want):
    loss, metrics, grads = want
    assert float(got_loss) == pytest.approx(loss, rel=LOSS_RTOL)
    assert float(got_metrics["ce"]) == pytest.approx(metrics["ce"],
                                                     rel=LOSS_RTOL)
    assert float(got_metrics["aux"]) == pytest.approx(metrics["aux"],
                                                      rel=LOSS_RTOL)
    for k in ("dropped", "routed"):
        assert float(got_metrics[k]) == metrics[k], k
    assert sorted(got_grads) == sorted(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(got_grads[k], g, **GRAD_BAR, err_msg=k)


@pytest.fixture
def world1():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        yield hvd.parallel.create_mesh({"dp": 1, "ep": 1})
    finally:
        hvd.shutdown()


def _port_model(mesh, **kw):
    params, _, _ = _data()
    model = moet.MoETransformer(_cfg_t(**kw), moet.MoEParallelConfig(1, 1),
                                device="cpu", mesh=mesh)
    model.load_state_dict(convert.params_from_jax(params))
    return model


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_world1_loss_metrics_and_gradients_match_reference(world1, bits):
    _, tokens, labels = _data()
    model = _port_model(world1, dispatch_bits=bits)
    total, metrics = model(torch.from_numpy(tokens),
                           torch.from_numpy(labels))
    total.backward()
    want = _reference((1, 1), bits)
    assert want[1]["dropped"] > 0          # the capacity clamp is exercised
    _check(total.detach(), metrics,
           {n: p.grad.numpy() for n, p in model.named_parameters()}, want)


def test_serial_oracle_equals_sharded_forward_when_nothing_drops(world1):
    params, tokens, labels = _data()
    model = _port_model(world1, capacity_factor=8.0)
    with torch.no_grad():
        total, metrics = model(torch.from_numpy(tokens),
                               torch.from_numpy(labels))
        oracle = moet.serial_forward_loss(_cfg_t(), model,
                                          torch.from_numpy(tokens),
                                          torch.from_numpy(labels))
        logits = model(torch.from_numpy(tokens))
    assert float(metrics["dropped"]) == 0.0
    assert float(metrics["routed"]) == tokens.size * W.MOET["n_layers"]
    assert float(metrics["ce"]) == pytest.approx(oracle.item(), rel=1e-5)
    assert total.item() == pytest.approx(
        float(metrics["ce"]) + _cfg_t().aux_weight * float(metrics["aux"]),
        rel=1e-6)
    want = moet_jax.serial_forward_logits(_cfg_j(), params,
                                          jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_train_step_learns_on_a_mesh(world1):
    _, tokens, labels = _data()
    model = _port_model(world1, dispatch_bits=8)
    step = moet.make_train_step(_cfg_t(dispatch_bits=8),
                                moet.MoEParallelConfig(1, 1), model,
                                torch.optim.SGD(model.parameters(), lr=0.1))
    losses = [step(torch.from_numpy(tokens), torch.from_numpy(labels))[0]
              .item() for _ in range(3)]
    assert losses[-1] < losses[0], losses


def test_helpers_match_reference():
    for kw in ({}, dict(top_k=2, dispatch_bits=8),
               dict(dispatch_bits=4, n_experts=4)):
        cfg_j, cfg_t = _cfg_j(**kw), _cfg_t(**kw)
        assert moet.train_flops_per_seq(cfg_t) == \
            moet_jax.train_flops_per_seq(cfg_j)
        for shape in ((1, 1), (2, 2), (1, 4)):
            for n_tok in (16, 4096):
                assert moet.dispatch_wire_ratio(
                    cfg_t, moet.MoEParallelConfig(*shape), n_tok) == \
                    moet_jax.dispatch_wire_ratio(
                        cfg_j, moet_jax.MoEParallelConfig(*shape), n_tok)
        dense_t = moet.flops_matched_dense_config(cfg_t)
        dense_j = moet_jax.flops_matched_dense_config(cfg_j)
        assert isinstance(dense_t, tfm.TransformerConfig)
        assert tfm.train_flops_per_seq(dense_t) == \
            tfm_jax.train_flops_per_seq(dense_j)
    assert moet.MoEConfig().quant_spec() is None
    assert tuple(_cfg_t(dispatch_bits=4).quant_spec()) == (4, 32)


# ---------------------------------------------------------------------------
# (2, 2) and (1, 4) on four gloo ranks
# ---------------------------------------------------------------------------

def _write(out):
    params, tokens, labels = _data()
    np.savez(os.path.join(out, "moet_params.npz"),
             **{k: v.numpy() for k, v in
                convert.params_from_jax(params).items()})
    np.savez(os.path.join(out, "moet.npz"), tokens=tokens, labels=labels)


def _metered_reference():
    """The bytes the reference's metered step records for one step of
    the metered case, on the global batch."""
    from horovod_tpu.ops import xla_collectives as XC_jax
    (dp, ep), bits = W.MOET_CASES[W.MOET_METERED]
    params, tokens, labels = _data()
    mesh = Mesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep),
                ("dp", "ep"))

    class _SGD:
        def update(self, grads, state, params):
            return jax.tree_util.tree_map(lambda g: -W.LR * g, grads), state

    step, shard = moet_jax.make_train_step(
        _cfg_j(dispatch_bits=bits), moet_jax.MoEParallelConfig(dp, ep),
        mesh, _SGD())
    recorded = []
    saved = XC_jax.record_wire_bytes
    XC_jax.record_wire_bytes = lambda raw, sent, kind="gspmd": \
        recorded.append((raw, sent, kind))
    try:
        _, _, loss, _ = step(shard(params), (), jnp.asarray(tokens, jnp.int32),
                             jnp.asarray(labels, jnp.int32))
    finally:
        XC_jax.record_wire_bytes = saved
    return float(loss), recorded


_REFERENCE = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def compute():
        for name, (shape, bits) in W.MOET_CASES.items():
            _REFERENCE[name] = _reference(shape, bits)
        _REFERENCE["metered"] = _metered_reference()

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(compute)
        out = pool.part_results(tmp_path_factory, "moet", prepare=_write)
        ref.result()
    return out


@pytest.mark.parametrize("name", list(W.MOET_CASES))
def test_mesh_loss_metrics_and_gradients_match_reference(ranks, name):
    got = ranks[0][name]
    for r in ranks:
        assert torch.equal(r[name]["loss"], got["loss"])
    _check(got["loss"], got["metrics"],
           {k: v.numpy() for k, v in got["grads"].items()},
           _REFERENCE[name])


def test_metered_step_counts_the_reference_wire_plan(ranks):
    loss, recorded = _REFERENCE["metered"]
    assert len(recorded) == 1 and recorded[0][2] == "gspmd"
    raw, sent, _ = recorded[0]
    assert sent < raw
    for r in ranks:
        assert r["metered"]["wire"] == (raw, sent)
        assert r["metered"]["losses"][0] == pytest.approx(loss, rel=LOSS_RTOL)
