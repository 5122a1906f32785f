"""horovod_tpu_torch's flagship transformer against horovod_tpu's.

The reference's parameters go through ``convert.params_from_jax`` into the
port; tokens come from numpy.  The fp32 configuration compares the math
(loss and every parameter's gradient to ~1e-5); the bf16 configuration
holds the loss to 1e-2 absolute (the two frameworks round bf16 at
different places) and the gradients to 5% of each tensor's largest
entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import transformer as tfm_jax
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm

SMALL = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=64)


def _configs(dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (tfm_jax.TransformerConfig(dtype=jd, **SMALL),
            tfm.TransformerConfig(dtype=td, remat=False, **SMALL))


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SMALL["vocab_size"], (b, SMALL["seq_len"]))
    return tokens, np.roll(tokens, -1, axis=1)


def _both(dtype, seed=0):
    cfg_j, cfg_t = _configs(dtype)
    params = tfm_jax.init_params(jax.random.PRNGKey(seed), cfg_j,
                                 tfm_jax.ParallelConfig())
    model = tfm.Transformer(cfg_t, device="cpu")
    model.load_state_dict(convert.params_from_jax(params))
    return cfg_j, cfg_t, params, model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _jax_loss_and_grads(cfg_j, params, tokens, labels):
    loss, grads = jax.value_and_grad(tfm_jax.serial_forward_loss, argnums=1)(
        cfg_j, params, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(labels, jnp.int32))
    return float(loss), _flat(grads)


def _torch_loss_and_grads(cfg_t, model, tokens, labels):
    model.zero_grad()
    loss = tfm.serial_forward_loss(cfg_t, model, torch.from_numpy(tokens),
                                   torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in
                         model.named_parameters()}


@pytest.mark.parametrize("flash", ["auto", "1"])
def test_fp32_loss_and_grads_match_reference(monkeypatch, flash):
    """``flash=1`` takes the port's flash autograd path (the kernels' plain
    versions on the CPU) against the reference's plain attention."""
    cfg_j, cfg_t, params, model = _both("float32")
    tokens, labels = _batch()
    loss_j, g_j = _jax_loss_and_grads(cfg_j, params, tokens, labels)
    monkeypatch.setenv("HVD_TPU_FLASH", flash)
    loss_t, g_t = _torch_loss_and_grads(cfg_t, model, tokens, labels)
    assert abs(loss_t - loss_j) < 1e-5
    assert sorted(g_t) == sorted(g_j)
    for name in g_j:
        np.testing.assert_allclose(g_t[name], g_j[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_bf16_loss_and_grads_match_reference():
    cfg_j, cfg_t, params, model = _both("bfloat16")
    tokens, labels = _batch()
    loss_j, g_j = _jax_loss_and_grads(cfg_j, params, tokens, labels)
    loss_t, g_t = _torch_loss_and_grads(cfg_t, model, tokens, labels)
    assert abs(loss_t - loss_j) < 1e-2
    for name in g_j:
        scale = np.abs(g_j[name]).max()
        assert np.abs(g_t[name] - g_j[name]).max() <= 0.05 * scale + 1e-6, \
            name


def test_logits_match_reference():
    cfg_j, cfg_t, params, model = _both("float32", seed=3)
    tokens, _ = _batch(b=3, seed=4)
    ref = tfm_jax.serial_forward_logits(cfg_j, params,
                                        jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; PyTorch's F.gelu defaults to erf."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    erf = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, ref, atol=1e-6)
    assert np.abs(erf - ref).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    jd = getattr(jnp, dtype)
    ref = tfm_jax._rmsnorm(jnp.asarray(x, jd), jnp.asarray(scale))
    got = tfm._rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(scale))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=1e-6 if dtype == "float32" else 1e-2,
                               rtol=1e-6 if dtype == "float32" else 1e-2)


def test_init_params_tree_matches_reference():
    cfg_j, cfg_t = _configs("float32")
    ref = _flat(tfm_jax.init_params(jax.random.PRNGKey(0), cfg_j,
                                    tfm_jax.ParallelConfig()))
    tree = tfm.init_params(cfg_t, generator=torch.Generator().manual_seed(0))
    got = _flat(tree)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    for name in ("embed", "layers.wqkv", "layers.w1"):
        assert abs(got[name].std() - 0.02) < 2e-3, name
    out_std = 0.02 / np.sqrt(2 * SMALL["n_layers"])
    for name in ("layers.wo", "layers.w2"):
        assert abs(got[name].std() - out_std) < 1e-3, name
    assert np.all(got["layers.ln1"] == 1) and np.all(got["final_norm"] == 1)
    again = tfm.init_params(cfg_t, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], tree["embed"])


def test_params_from_jax_is_the_module_state():
    cfg_j, cfg_t, params, model = _both("float32")
    state = convert.params_from_jax(params)
    assert sorted(state) == sorted(model.state_dict())
    for k, v in state.items():
        assert v.dtype == torch.float32
        assert torch.equal(model.state_dict()[k], v)
    assert state["layers.wqkv"].shape == (1, 2, 64, 3 * 64)


@pytest.mark.parametrize("cfg", [
    dict(SMALL), dict(vocab_size=8192, d_model=512, n_heads=8, d_ff=2048,
                      n_layers=8, seq_len=512)])
def test_train_flops_match_reference(cfg):
    assert tfm.train_flops_per_seq(tfm.TransformerConfig(**cfg)) == \
        tfm_jax.train_flops_per_seq(tfm_jax.TransformerConfig(**cfg))


def test_synthetic_batch():
    cfg = tfm.TransformerConfig(**SMALL)
    tok, lab = tfm.synthetic_batch(cfg, 3, seed=5, device="cpu")
    assert tok.shape == (3, 64) and tok.dtype == torch.int64
    assert torch.equal(lab, torch.roll(tok, -1, dims=1))
    assert int(tok.min()) >= 0 and int(tok.max()) < 128
    assert torch.equal(tfm.synthetic_batch(cfg, 3, seed=5, device="cpu")[0],
                       tok)


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU refusal needs a machine without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.Transformer(tfm.TransformerConfig(**SMALL))


@pytest.mark.parametrize("change", [dict(n_experts=2),
                                    dict(attn_mode="ring")])
def test_unported_modes_raise(change):
    """MoE and the sequence-parallel modes are ported: their trees are the
    reference's.  What raises is the data-parallel path (no mesh) given
    what needs a (dp, pp, mp) mesh: MoE layers, pp or mp above 1; and
    the reference's own refusals."""
    cfg = tfm.TransformerConfig(dtype=torch.float32, **{**SMALL, **change})
    cfg_j = tfm_jax.TransformerConfig(dtype=jnp.float32,
                                      **{**SMALL, **change})
    for pp in (1, 2):
        ref = _flat(tfm_jax.init_params(jax.random.PRNGKey(0), cfg_j,
                                        tfm_jax.ParallelConfig(pp=pp)))
        got = _flat(tfm.init_params(cfg, tfm.ParallelConfig(pp=pp)))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in ref.items()}
    model = tfm.Transformer(cfg, device="cpu")
    tokens, labels = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="mesh"):
        if cfg.n_experts:
            model(tokens, labels)
        else:
            tfm.forward_loss(cfg, tfm.ParallelConfig(pp=2), model, tokens,
                             labels)
    with pytest.raises(ValueError, match="divisible"):
        tfm.init_params(cfg, tfm.ParallelConfig(pp=3, dp=4))
