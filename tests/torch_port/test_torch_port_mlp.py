"""horovod_tpu_torch's MLP (the MNIST slice's model) against
horovod_tpu's: on the reference's weights (``convert.tree_from_jax``)
and the same seeded inputs, logits, loss and every gradient within fp32
summation order (rtol 1e-5, atol 1e-6); the port's own init draws the
reference's shapes and scales."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import mlp as mlp_jax

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import mlp

BAR = dict(rtol=1e-5, atol=1e-6)
SIZES = (784, 64, 32, 10)


def _inputs():
    rng = np.random.default_rng(8)
    return (rng.standard_normal((6, 28, 28)).astype(np.float32),
            rng.integers(0, 10, 6))


def test_logits_loss_and_gradients_match_reference():
    params = mlp_jax.init_params(jax.random.PRNGKey(0), SIZES)
    x, labels = _inputs()
    want_logits = mlp_jax.apply(params, jnp.asarray(x))
    want_loss, want = jax.value_and_grad(mlp_jax.loss_fn)(
        params, jnp.asarray(x), jnp.asarray(labels))
    tree = convert.tree_from_jax(params)
    for layer in tree:
        for t in layer.values():
            t.requires_grad_()
    np.testing.assert_allclose(
        mlp.apply(tree, torch.from_numpy(x)).detach().numpy(),
        np.asarray(want_logits), **BAR)
    loss = mlp.loss_fn(tree, torch.from_numpy(x), torch.from_numpy(labels))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    for got, ref in zip(tree, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].grad.numpy(),
                                       np.asarray(ref[k]), **BAR, err_msg=k)


def test_init_draws_the_reference_shapes_and_scales():
    ref = mlp_jax.init_params(jax.random.PRNGKey(0), SIZES)
    got = mlp.init_params(SIZES, torch.Generator().manual_seed(0),
                          device="cpu")
    assert len(got) == len(ref)
    for g, r, din in zip(got, ref, SIZES[:-1]):
        assert tuple(g["w"].shape) == r["w"].shape
        assert tuple(g["b"].shape) == r["b"].shape
        assert not g["b"].any()
        assert g["w"].std().item() == pytest.approx((2.0 / din) ** 0.5,
                                                    rel=0.1)


def test_sgd_steps_reduce_loss():
    x, labels = _inputs()
    params = mlp.init_params(SIZES, torch.Generator().manual_seed(1),
                             device="cpu")
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    opt = torch.optim.SGD(leaves, lr=0.1)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = mlp.loss_fn(params, torch.from_numpy(x),
                           torch.from_numpy(labels))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
