"""horovod_tpu_torch's BERT against horovod_tpu's, at the reference
test's size (vocab 211, d 32, 4 heads, d_ff 64, 2 layers, seq 16, fp32),
on the reference's weights (``convert.params_from_jax``) and batches.

In this process: the serial dense and gathered MLM losses and every
gradient against the reference's ``serial_forward_loss``; the three remat
modes equal (the reference's bars), "dots" recomputing no matrix product
and keeping less than no remat; a few AdamW steps on a (1, 1) mesh;
``max_predictions``, ``train_flops_per_seq`` and the synthetic batches'
masking rules.

Four gloo ranks (``_torch_port_pool.part_results("bert")``, bodies in
``_torch_port_models_workers.py``) run the sharded loss on a (dp, mp) =
(2, 2) mesh, dense and gathered, with and without remat: loss and the
gathered gradients against ``jax.value_and_grad`` of the reference's
``make_loss_fn`` on a 4-device CPU mesh."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu.models import bert as bert_jax

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import bert

import _torch_port_models_workers as W
import _torch_port_pool as pool

LOSS_RTOL = 1e-5
GRAD_BAR = dict(atol=5e-5, rtol=1e-4)      # tests/test_moe_pipeline.py
REMAT_GRAD_BAR = dict(rtol=1e-4, atol=1e-6)  # tests/test_bert.py


def _cfg_j(**kw):
    return bert_jax.BertConfig(**{**W.BERT, "dtype": jnp.float32,
                                  "remat": False, **kw})


def _cfg_t(**kw):
    return bert.BertConfig(**{**W.BERT, "dtype": torch.float32,
                              "remat": False, **kw})


def _data():
    """The reference's params and batches, numpy: the dense batch, and
    the gathered one with its dense labels."""
    cfg = _cfg_j()
    params = bert_jax.init_params(jax.random.PRNGKey(0), cfg)
    inputs, labels = bert_jax.synthetic_batch(jax.random.PRNGKey(1), cfg,
                                              W.BERT_BATCH)
    mlm_inputs, positions, mlm_labels = bert_jax.synthetic_mlm_batch(
        jax.random.PRNGKey(2), cfg, W.BERT_BATCH)
    return params, {k: np.asarray(v) for k, v in dict(
        inputs=inputs, labels=labels, mlm_inputs=mlm_inputs,
        positions=positions, mlm_labels=mlm_labels).items()}


def _batch(data, gathered):
    keys = ("mlm_inputs", "positions", "mlm_labels") if gathered \
        else ("inputs", "labels")
    return [data[k] for k in keys]


def _port(params, cfg):
    model = bert.Bert(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    return model


def _port_loss_and_grads(model, data, gathered):
    tokens, *rest = [torch.from_numpy(a.astype(np.int64))
                     for a in _batch(data, gathered)]
    loss = model(tokens, rest[-1], rest[0] if gathered else None)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


def _check_grads(got, want, bar):
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g.numpy(), **bar, err_msg=k)


@pytest.mark.parametrize("gathered", [False, True],
                         ids=["dense", "gathered"])
def test_serial_loss_and_gradients_match_reference(gathered):
    params, data = _data()
    cfg_j = _cfg_j()
    batch = [jnp.asarray(a) for a in _batch(data, gathered)]
    if gathered:
        def fn(p):
            return bert_jax.serial_forward_loss(cfg_j, p, batch[0], batch[2],
                                                positions=batch[1])
    else:
        def fn(p):
            return bert_jax.serial_forward_loss(cfg_j, p, *batch)
    want_loss, want = jax.jit(jax.value_and_grad(fn))(params)
    loss, got = _port_loss_and_grads(_port(params, _cfg_t()), data, gathered)
    assert loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    _check_grads(got, convert.params_from_jax(want), GRAD_BAR)


def test_gathered_head_equals_dense_head():
    """The gathered head over the same masked positions computes the
    dense head's cross entropy (tests/test_bert.py's bar)."""
    params, data = _data()
    dense = np.full_like(data["mlm_inputs"], bert.IGNORE_INDEX)
    np.put_along_axis(dense, data["positions"], data["mlm_labels"], axis=1)
    model = _port(params, _cfg_t())
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    with torch.no_grad():
        l_dense = model(t(data["mlm_inputs"]), t(dense))
        l_gath = model(t(data["mlm_inputs"]), t(data["mlm_labels"]),
                       t(data["positions"]))
    assert l_gath.item() == pytest.approx(l_dense.item(), rel=1e-4)


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
       torch.ops.aten.bmm.default)


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MM:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_keeping(model, tokens, labels, positions):
    """The loss and the bytes its graph keeps for the backward."""
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(tokens, labels, positions)
    return loss, sum(kept)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_modes_same_loss_and_grad(remat):
    """Rematerialization changes what is kept, never a value.  Full remat
    replays every layer's weight products in the backward; "dots" replays
    none of them (only the layer norms), and keeps less than no remat."""
    params, data = _data()
    base_loss, base = _port_loss_and_grads(_port(params, _cfg_t()), data,
                                           True)
    model = _port(params, _cfg_t(remat=remat))
    tokens, positions, labels = [torch.from_numpy(a.astype(np.int64))
                                 for a in _batch(data, True)]
    loss, kept = _loss_keeping(model, tokens, labels, positions)
    with _CountMM() as counted:
        loss.backward()
    assert loss.item() == pytest.approx(base_loss, rel=1e-5)
    _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                 {k: torch.from_numpy(v) for k, v in base.items()},
                 REMAT_GRAD_BAR)
    model = _port(params, _cfg_t(remat=False))
    loss, plain_kept = _loss_keeping(model, tokens, labels, positions)
    with _CountMM() as plain:
        loss.backward()
    if remat == "dots":
        # A checkpoint keeps its inputs past the hooks: each layer's x and
        # attention output, (B, S, d) each.
        kept += 2 * W.BERT["n_layers"] * tokens.numel() * \
            W.BERT["d_model"] * 4
    assert kept < plain_kept, (kept, plain_kept)
    if remat == "dots":
        assert counted.n == plain.n
    else:
        assert counted.n > plain.n


def test_train_step_on_a_mesh_reduces_loss():
    import horovod_tpu_torch as hvd
    params, data = _data()
    hvd.init(device="cpu")
    try:
        mesh = hvd.parallel.create_mesh({"dp": 1, "mp": 1})
        cfg = _cfg_t()
        model = bert.Bert(cfg, device="cpu", mesh=mesh)
        model.load_state_dict(convert.params_from_jax(params))
        step = bert.make_train_step(cfg, model, torch.optim.AdamW(
            model.parameters(), lr=1e-2, weight_decay=0.0), gathered=True)
        batch = [torch.from_numpy(a.astype(np.int64))
                 for a in _batch(data, True)]
        losses = [step(*batch).item() for _ in range(8)]
    finally:
        hvd.shutdown()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("seq,rate", [(16, 0.15), (512, 0.15), (128, 0.15),
                                      (64, 0.5), (8, 0.15)])
def test_max_predictions_matches_reference(seq, rate):
    assert bert.max_predictions(_cfg_t(seq_len=seq), rate) == \
        bert_jax.max_predictions(_cfg_j(seq_len=seq), rate)


@pytest.mark.parametrize("n_pred", [None, 3, 80])
def test_train_flops_per_seq_matches_reference(n_pred):
    for kw in ({}, dict(vocab_size=30522, d_model=768, n_heads=12,
                        d_ff=3072, n_layers=12, seq_len=512)):
        assert bert.train_flops_per_seq(_cfg_t(**kw), n_pred) == \
            bert_jax.train_flops_per_seq(_cfg_j(**kw), n_pred)


def test_synthetic_batches_mask_as_the_reference():
    cfg = _cfg_t()
    inputs, labels = bert.synthetic_batch(cfg, 4, mask_rate=0.5, device="cpu")
    masked = labels != bert.IGNORE_INDEX
    assert bool(masked.any()) and not bool(masked.all())
    assert bool((inputs[masked] == 0).all())
    assert bool((inputs[~masked] > 0).all())
    inputs, positions, labels = bert.synthetic_mlm_batch(cfg, 4,
                                                         device="cpu")
    n_pred = bert.max_predictions(cfg)
    assert positions.shape == (4, n_pred) and labels.shape == (4, n_pred)
    for row_pos, row_in, row_lb in zip(positions, inputs, labels):
        assert len(set(row_pos.tolist())) == n_pred
        assert bool((row_in[row_pos] == 0).all())
        assert bool((row_lb > 0).all())
        assert int((row_in == 0).sum()) == n_pred


# ---------------------------------------------------------------------------
# The (dp, mp) = (2, 2) mesh on four gloo ranks
# ---------------------------------------------------------------------------

def _write(out):
    params, data = _data()
    np.savez(os.path.join(out, "bert_params.npz"),
             **{k: v.numpy() for k, v in
                convert.params_from_jax(params).items()})
    np.savez(os.path.join(out, "bert.npz"),
             **{k: v.astype(np.int64) for k, v in data.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "bert", prepare=_write)


@pytest.mark.parametrize("name", list(W.BERT_CASES))
def test_sharded_loss_and_gradients_match_reference(ranks, name):
    """The reference's remat changes no value, so a remat case is held to
    the reference's computation without it."""
    gathered, _ = W.BERT_CASES[name]
    params, data = _data()
    dp, mp = W.BERT_MESH
    mesh = Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                ("dp", "mp"))
    batch = [jnp.asarray(a) for a in _batch(data, gathered)]
    loss, grads = jax.jit(jax.value_and_grad(bert_jax.make_loss_fn(
        _cfg_j(), mesh, gathered=gathered)))(params, *batch)
    want = convert.params_from_jax(grads)
    for r in ranks:
        assert torch.equal(r[name]["loss"], ranks[0][name]["loss"])
    assert float(ranks[0][name]["loss"]) == pytest.approx(float(loss),
                                                          rel=LOSS_RTOL)
    _check_grads({k: v.numpy() for k, v in ranks[0][name]["grads"].items()},
                 want, GRAD_BAR)
