"""horovod_tpu_torch's ``sync_batch_norm`` against horovod_tpu's, on four
gloo ranks laid out 2 x 2 (started once per test process by
``_torch_port_pool.part_results``): each rank normalizes its own (8, 5, 16)
batch with the moments averaged over the four, and differentiates
sum(out * ct) for its own cotangent.  The reference runs under
``shard_map`` on a 4-device CPU mesh with ``jax.vjp``.  Outputs, running
statistics and the gradients of x, scale and bias agree within 1e-5 of
each tensor's largest magnitude (fp32; the moments are summed in another
order); ``axis_name=None`` keeps each rank's own moments, and
``training=False`` uses the running ones, as in the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.ops.sync_batch_norm import sync_batch_norm as sbn_jax

import _torch_port_pool as pool

WORLD = pool.WORLD
LABELS = {"train": {}, "local": dict(axis_name=None),
          "joint": {}, "eval": dict(training=False)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "sbn")


@pytest.fixture(scope="module")
def references():
    inputs = pool.part_inputs("sbn")
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    rm, rv = jnp.asarray(inputs["rm"]), jnp.asarray(inputs["rv"])
    out = {}
    for label, kw in LABELS.items():
        def per_rank(x, ct, scale, bias, kw=kw):
            x, ct = x[0], ct[0]

            def f(x_, s_, b_):
                return sbn_jax(x_, s_, b_, rm, rv, **kw)
            (y, mean, var), vjp = jax.vjp(f, x, scale, bias)
            gx, gs, gb = vjp((ct, jnp.zeros_like(mean), jnp.zeros_like(var)))
            return {"out": y[None], "mean": mean[None], "var": var[None],
                    "grads": [gx[None], gs[None], gb[None]]}

        f = jax.jit(shard_map(per_rank, mesh=mesh,
                              in_specs=(P("data"), P("data"), P(), P()),
                              out_specs=P("data"), check_vma=False))
        res = f(*(jnp.asarray(inputs[k]) for k in
                  ("x", "ct", "scale", "bias")))
        out[label] = jax.tree_util.tree_map(np.asarray, res)
    return out


@pytest.mark.timeout(150)
@pytest.mark.parametrize("label", list(LABELS))
def test_sync_batch_norm_matches_reference(ranks, references, label):
    ref = references[label]
    for r, res in enumerate(ranks):
        got = res[label]
        pairs = [(got[k], ref[k][r]) for k in ("out", "mean", "var")] + \
            [(g, x[r]) for g, x in zip(got["grads"], ref["grads"])]
        for i, (g, want) in enumerate(pairs):
            g = g.detach().numpy()
            assert g.shape == want.shape, (label, i)
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{label} rank {r} #{i}")
        assert got["mean"].grad_fn is None   # running stats are detached
    if label in ("train", "joint"):   # the moments are the world's
        for r in range(1, WORLD):
            assert torch.equal(ranks[r][label]["mean"],
                               ranks[0][label]["mean"])
    if label == "local":
        assert not torch.equal(ranks[1][label]["mean"],
                               ranks[0][label]["mean"])
