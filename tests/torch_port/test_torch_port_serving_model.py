"""The port's serving entry points of the flagship transformer against
horovod_tpu's: ``prefill`` (a padded and an exact prompt), ``decode_step``,
``decode_verify`` (K 1 and K 5, at and past the page table's extent), the
KV pools after each call, ``_moe_mlp_serving`` at top_k 1 and 2, and the
draft helpers.

The reference's test configuration (vocab 64, d_model 32, 4 heads, d_ff
64, 2 layers, seq 64, fp32, pages of 8 tokens), its parameters through
``convert.params_from_jax``, numpy inputs from a seed; every output and
pool held at rtol 1e-5, atol 1e-5.  Physical page 0 is the scratch page:
where several writes of one call land on it (inactive slots, positions
past the table) the winner is unspecified in both packages, and where a
slot has reached the table's extent the reference drops the write that
the port routes there, so page 0 is compared only where one write or none
lands on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as tfm_j
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as tfm

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             seq_len=64, remat=False)
PAGE = 8
N_PAGES = 10                    # page 0 scratch + 9
TOL = dict(rtol=1e-5, atol=1e-5)


def _jit(fn):
    """The reference's entry point under jit (cfg static), as its engine
    calls it: one compile a shape instead of eager dispatch."""
    return jax.jit(fn, static_argnums=0)


PREFILL_J = _jit(tfm_j.prefill)
DECODE_J = _jit(tfm_j.decode_step)
VERIFY_J = _jit(tfm_j.decode_verify)


def _cfgs(**kw):
    return (tfm_j.TransformerConfig(dtype=jnp.float32, **SMALL, **kw),
            tfm.TransformerConfig(dtype=torch.float32, **SMALL, **kw))


@pytest.fixture(scope="module")
def dense():
    cfg_j, cfg = _cfgs()
    pj = tfm_j.init_params(jax.random.PRNGKey(0), cfg_j,
                           tfm_j.ParallelConfig())
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    return cfg_j, cfg, pj, model


def _pools(cfg_j, cfg, seed=0):
    """Both pools holding the same seeded K/V (so every gather reads real
    values, not zeros)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, N_PAGES, PAGE, cfg.n_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    kv_j = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    kv_t = tfm.init_kv_pages(cfg, N_PAGES, PAGE, device="cpu")
    kv_t["k"].copy_(torch.from_numpy(k))
    kv_t["v"].copy_(torch.from_numpy(v))
    return kv_j, kv_t


def _check_pools(kv_j, kv_t, scratch=True):
    lo = 0 if scratch else 1
    for name in ("k", "v"):
        np.testing.assert_allclose(kv_t[name].numpy()[:, lo:],
                                   np.asarray(kv_j[name])[:, lo:], **TOL)


def test_kv_page_geometry():
    _, cfg = _cfgs()
    kv = tfm.init_kv_pages(cfg, n_pages=5, page_size=4, device="cpu")
    assert kv["k"].shape == (cfg.n_layers, 5, 4, cfg.n_heads,
                             cfg.head_dim)
    assert kv["k"].dtype == cfg.dtype and not kv["v"].any()


@pytest.mark.parametrize("length", [16, 11])
def test_prefill_matches_reference(dense, length):
    """An exact 2-page prompt and a padded one (length 11 of 16)."""
    cfg_j, cfg, pj, model = dense
    rng = np.random.default_rng(length)
    tokens = rng.integers(0, 64, 16).astype(np.int32)
    rows = np.array([3, 7], np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg)
    lj, kv_j = PREFILL_J(cfg_j, pj, jnp.asarray(tokens),
                             jnp.int32(length), kv_j, jnp.asarray(rows))
    lt, kv_t = tfm.prefill(cfg, model, torch.from_numpy(tokens), length,
                           kv_t, torch.from_numpy(rows))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _check_pools(kv_j, kv_t)
    # The row equals the training forward's at the last valid position.
    oracle = tfm.serial_forward_logits(
        cfg, model, torch.from_numpy(tokens[:length]).long()[None])
    np.testing.assert_allclose(lt.numpy(), oracle[0, -1].detach().numpy(),
                               **TOL)


# Page tables of 4 slots, 4 pages each (max_len 32): slot 3 is inactive
# (all scratch), slot 1 holds two pages.
TABLES = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 0],
                   [0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("lengths", [[13, 5, 20, 0], [31, 15, 23, 0],
                                     [32, 9, 24, 0]],
                         ids=["inside", "last-position", "at-extent"])
def test_decode_step_matches_reference(dense, lengths):
    """One token a slot.  "at-extent": slot 0's length is the table's
    32, so it has no page to write (the reference drops the write, the
    port routes it to scratch) and its position row is clamped."""
    cfg_j, cfg, pj, model = dense
    lengths = np.array(lengths, np.int32)
    tokens = np.array([7, 9, 63, 0], np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg, seed=1)
    lj, kv_j = DECODE_J(cfg_j, pj, jnp.asarray(tokens),
                                 jnp.asarray(lengths), kv_j,
                                 jnp.asarray(TABLES))
    lt, kv_t = tfm.decode_step(cfg, model, torch.from_numpy(tokens),
                               torch.from_numpy(lengths), kv_t,
                               torch.from_numpy(TABLES))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # Slot 3 (inactive) writes page 0 in both; at the extent slot 0 adds
    # a port-only write there.
    _check_pools(kv_j, kv_t, scratch=lengths[0] < 32)


@pytest.mark.parametrize("kq, lengths", [
    (1, [13, 5, 20, 0]),
    (5, [3, 8, 17, 0]),
    (5, [29, 12, 22, 0]),     # slot 0's positions 32, 33 past the table
    (5, [32, 10, 23, 0]),     # slot 0 starts at the extent
], ids=["k1", "k5-inside", "k5-past-extent", "k5-at-extent"])
def test_decode_verify_matches_reference(dense, kq, lengths):
    cfg_j, cfg, pj, model = dense
    rng = np.random.default_rng(kq + lengths[0])
    tokens = rng.integers(0, 64, (4, kq)).astype(np.int32)
    lengths = np.array(lengths, np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg, seed=2)
    lj, kv_j = VERIFY_J(cfg_j, pj, jnp.asarray(tokens),
                                   jnp.asarray(lengths), kv_j,
                                   jnp.asarray(TABLES))
    lt, kv_t = tfm.decode_verify(cfg, model, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), kv_t,
                                 torch.from_numpy(TABLES))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # Several writes land on page 0 (inactive slot 3, positions past the
    # table): its content is whichever write won.
    _check_pools(kv_j, kv_t, scratch=False)


# max_len = seq_len = 64: two slots of 8 pages.
TABLES_64 = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 0, 0, 0, 0, 0, 0, 0]],
                     np.int32)


@pytest.mark.parametrize("kq, lengths", [(1, [64, 3]), (5, [62, 3]),
                                         (5, [64, 2])],
                         ids=["step-at-extent", "verify-past-extent",
                              "verify-at-extent"])
def test_positional_table_extent_matches_reference(dense, kq, lengths):
    """Where the table's extent is the positional table's (max_len =
    seq_len), the positions at and past it read the last position row,
    as JAX's clamped gather reads it."""
    cfg_j, cfg, pj, model = dense
    tokens = np.random.default_rng(kq).integers(0, 64, (2, kq)).astype(
        np.int32)
    lengths = np.array(lengths, np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg, seed=6)
    if kq == 1:
        lj, kv_j = DECODE_J(cfg_j, pj, jnp.asarray(tokens[:, 0]),
                                     jnp.asarray(lengths), kv_j,
                                     jnp.asarray(TABLES_64))
        lt, kv_t = tfm.decode_step(cfg, model,
                                   torch.from_numpy(tokens[:, 0]),
                                   torch.from_numpy(lengths), kv_t,
                                   torch.from_numpy(TABLES_64))
    else:
        lj, kv_j = VERIFY_J(cfg_j, pj, jnp.asarray(tokens),
                                       jnp.asarray(lengths), kv_j,
                                       jnp.asarray(TABLES_64))
        lt, kv_t = tfm.decode_verify(cfg, model, torch.from_numpy(tokens),
                                     torch.from_numpy(lengths), kv_t,
                                     torch.from_numpy(TABLES_64))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _check_pools(kv_j, kv_t, scratch=False)


def test_decode_verify_k1_equals_decode_step(dense):
    _, cfg, _, model = dense
    lengths = torch.tensor([13, 5, 20, 0])
    tokens = torch.tensor([7, 9, 63, 0])
    kv_a = tfm.init_kv_pages(cfg, N_PAGES, PAGE, device="cpu")
    kv_b = tfm.init_kv_pages(cfg, N_PAGES, PAGE, device="cpu")
    la, _ = tfm.decode_step(cfg, model, tokens, lengths, kv_a,
                            torch.from_numpy(TABLES))
    lb, _ = tfm.decode_verify(cfg, model, tokens[:, None], lengths, kv_b,
                              torch.from_numpy(TABLES))
    torch.testing.assert_close(lb[:, 0], la, rtol=0, atol=0)
    torch.testing.assert_close(kv_b["k"], kv_a["k"], rtol=0, atol=0)


def test_out_of_range_tokens_clamp_as_jax(dense):
    """A token id outside the vocabulary reads the row JAX's gather
    clamps it to (a negative one counts from the end first)."""
    cfg_j, cfg, pj, model = dense
    tokens = np.array([[70, -1], [-100, 5], [63, 64], [0, 0]], np.int32)
    lengths = np.array([3, 4, 5, 0], np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg, seed=3)
    lj, _ = VERIFY_J(cfg_j, pj, jnp.asarray(tokens),
                                jnp.asarray(lengths), kv_j,
                                jnp.asarray(TABLES))
    lt, _ = tfm.decode_verify(cfg, model, torch.from_numpy(tokens),
                              torch.from_numpy(lengths), kv_t,
                              torch.from_numpy(TABLES))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_serving_matches_reference(top_k):
    cfg_j, cfg = _cfgs(n_experts=4, top_k=top_k)
    pj = tfm_j.init_params(jax.random.PRNGKey(2), cfg_j,
                           tfm_j.ParallelConfig())
    tree = convert.params_from_jax(pj)
    lp_j = {k: v[0, 0] for k, v in pj["layers"].items()}
    lp_t = {k.split(".")[1]: v[0, 0] for k, v in tree.items()
            if k.startswith("layers.")}
    tok = np.random.default_rng(top_k).standard_normal(
        (12, cfg.d_model)).astype(np.float32)
    tok[5] = tok[4]                # equal rows route equally
    want = tfm_j._moe_mlp_serving(cfg_j, lp_j, jnp.asarray(tok))
    got = tfm._moe_mlp_serving(cfg, lp_t, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # A tied router: both experts score equal, the lower index wins.
    lp_tie = dict(lp_t, gate=torch.zeros_like(lp_t["gate"]))
    lp_tie_j = dict(lp_j, gate=jnp.zeros_like(lp_j["gate"]))
    np.testing.assert_allclose(
        tfm._moe_mlp_serving(cfg, lp_tie, torch.from_numpy(tok)).numpy(),
        np.asarray(tfm_j._moe_mlp_serving(cfg_j, lp_tie_j,
                                          jnp.asarray(tok))), **TOL)


def test_moe_decode_matches_reference():
    """The MoE configuration through decode_verify (prefill of a chunk)."""
    cfg_j, cfg = _cfgs(n_experts=4, top_k=2)
    pj = tfm_j.init_params(jax.random.PRNGKey(3), cfg_j,
                           tfm_j.ParallelConfig())
    model = tfm.Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(pj))
    tokens = np.random.default_rng(4).integers(0, 64, (4, 5)).astype(
        np.int32)
    lengths = np.array([3, 8, 17, 0], np.int32)
    kv_j, kv_t = _pools(cfg_j, cfg, seed=5)
    lj, kv_j = VERIFY_J(cfg_j, pj, jnp.asarray(tokens),
                                   jnp.asarray(lengths), kv_j,
                                   jnp.asarray(TABLES))
    lt, kv_t = tfm.decode_verify(cfg, model, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths), kv_t,
                                 torch.from_numpy(TABLES))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _check_pools(kv_j, kv_t, scratch=False)


def test_draft_helpers_match_reference(dense):
    cfg_j, cfg, pj, model = dense
    assert tfm.draft_config(cfg, 1) == cfg._replace(n_layers=1)
    for bad in (0, cfg.n_layers + 1):
        with pytest.raises(ValueError):
            tfm.draft_config(cfg, bad)
        with pytest.raises(ValueError):
            tfm.draft_params_from(model, bad)
    dj = tfm_j.draft_params_from(pj, 1)
    dt = tfm.draft_params_from(model, 1)
    assert dt["embed"] is model.embed          # shared, not copied
    for k, v in dj["layers"].items():
        np.testing.assert_array_equal(dt["layers"][k].detach().numpy(),
                                      np.asarray(v))
    for ctx in (1, 100, 512):
        assert tfm.decode_flops_per_token(cfg, ctx) == \
            tfm_j.decode_flops_per_token(cfg_j, ctx)
    moe_j, moe_t = _cfgs(n_experts=4, top_k=2)
    assert tfm.decode_flops_per_token(moe_t, 64) == \
        tfm_j.decode_flops_per_token(moe_j, 64)
