"""horovod_tpu_torch's flagship on a (dp, pp, mp) mesh against horovod_tpu's
``make_loss_fn`` / ``make_train_step`` under ``shard_map``.

The tiny flagship (fp32, vocab 61, d 32, 4 heads, d_ff 48, seq 16, 2-4
layers, a global batch of 8) with the reference's parameters
(``convert.params_from_jax``) runs on four gloo ranks
(``_torch_port_pool.part_results("modes")``, bodies in
``_torch_port_modes_workers.py``): each rank takes its shards
(``shard_params``) and its dp rows, ``make_loss_fn``'s loss goes
backward, and ``gather_params`` assembles the gradients.  The reference's
``jax.value_and_grad(make_loss_fn(...))`` runs on a 4-device CPU mesh of
the same shape.  Meshes: (1, 1, 4) in megatron (tp + SP), ring and
Ulysses; (1, 2, 2) with GPipe and 1F1B at 4 microbatches and at 1 (a
batch shorter than the pipeline); (2, 2, 1) with 1F1B; remat on and off.
Bars: the loss at rtol 1e-5, every gradient leaf at atol 5e-5, rtol 1e-4
(the reference's own 1F1B bar, tests/test_moe_pipeline.py:245-246); 1F1B's
loss equals GPipe's bit for bit.  Then one plain-SGD step of
``make_train_step`` on (2, 1, 2) against the reference's."""

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as tfm_jax

from horovod_tpu_torch.models import transformer as tfm

import _torch_port_modes_workers as W
import _torch_port_pool as pool

LOSS_RTOL, GRAD_BAR = pool.MODE_LOSS_RTOL, pool.MODE_GRAD_BAR


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.mode_results(tmp_path_factory, "modes", "MODE_CASES",
                             extra=("TRAIN_CASES",))


@pytest.mark.parametrize("name", list(W.MODE_CASES))
def test_mode_matches_reference(ranks, name):
    pool.check_mode_case(ranks, "MODE_CASES", name, "modes")


@pytest.mark.parametrize("n_micro", [4, 1])
def test_1f1b_loss_is_gpipes_bit_for_bit(ranks, n_micro):
    for r in ranks:
        assert torch.equal(r[f"1f1b{n_micro}"]["loss"],
                           r[f"gpipe{n_micro}"]["loss"])


def test_remat_changes_no_value(ranks):
    for plain, remat in (("megatron", "megatron_remat"),
                         ("gpipe4", "gpipe4_remat")):
        for r in ranks:
            assert torch.equal(r[remat]["loss"], r[plain]["loss"])
            for leaf, g in r[plain]["grads"].items():
                assert torch.equal(r[remat]["grads"][leaf], g), leaf


class _SGD:
    def update(self, grads, state, params):
        return jax.tree_util.tree_map(lambda g: -W.LR * g, grads), state


def test_train_step_matches_reference(ranks):
    from jax.sharding import Mesh
    import jax.numpy as jnp
    (shape, _, _) = W.TRAIN_CASES["train"]
    cfg, par = pool._mode_configs(W.TRAIN_CASES["train"])
    mesh = Mesh(np.array(jax.devices()[:pool.WORLD]).reshape(shape),
                ("dp", "pp", "mp"))
    step, shard = tfm_jax.make_train_step(cfg, par, mesh, _SGD())
    data = pool.part_inputs("modes")
    params, _, loss = step(shard(pool._mode_params("TRAIN_CASES", "train")),
                           (), jnp.asarray(data["tokens"], jnp.int32),
                           jnp.asarray(data["labels"], jnp.int32))
    want = pool._flat_np(params)
    for r in ranks:
        got = r["train"]
        assert got["losses"][0] == pytest.approx(float(loss), rel=LOSS_RTOL)
        assert sorted(got["params"]) == sorted(want)
        for leaf, p in want.items():
            np.testing.assert_allclose(got["params"][leaf].numpy(), p,
                                       **GRAD_BAR, err_msg=leaf)


def test_config_fields_are_the_references():
    assert tfm.TransformerConfig._fields == \
        tfm_jax.TransformerConfig._fields
    assert tfm.ParallelConfig._fields == tfm_jax.ParallelConfig._fields
    for ours, ref in ((tfm.TransformerConfig(), tfm_jax.TransformerConfig()),
                      (tfm.ParallelConfig(), tfm_jax.ParallelConfig())):
        for f in ours._fields:
            if f != "dtype":
                assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("change", [dict(), dict(attn_mode="ring"),
                                    dict(n_experts=4)])
@pytest.mark.parametrize("pp", [1, 2])
def test_param_specs_equal_the_references(change, pp):
    from jax.sharding import PartitionSpec as P
    cfg = tfm.TransformerConfig(**change)
    ref = tfm_jax.param_specs(tfm_jax.TransformerConfig(**change),
                              tfm_jax.ParallelConfig(pp=pp, dp=2))
    got = tfm.param_specs(cfg, tfm.ParallelConfig(pp=pp, dp=2))
    flat = dict(tfm._leaves(got))
    for leaf, spec in pool._flat_specs(ref).items():
        assert P(*flat[leaf]) == spec, leaf
    assert sorted(flat) == sorted(pool._flat_specs(ref))
