"""horovod_tpu_torch's ResNet v1.5 against horovod_tpu's, on the same
seeded numpy images and the reference's weights
(``convert.resnet_from_jax``: conv kernels HWIO -> OIHW).

In this process, fp32 on the CPU:

* ResNet-18 at width 8, 32x32 images: logits, the new batch-norm
  statistics and every gradient; the same at 33x33 (odd sizes, so every
  stride-2 SAME pad is asymmetric on another side);
* ResNet-50 at width 8, 32x32, in float64 on both sides: logits, loss,
  the new statistics and every gradient;
* XLA's SAME padding of each conv and of the max pool, odd and even
  sizes, against ``lax.conv_general_dilated``/``lax.reduce_window``;
* ``stem_s2d`` against the default stem (the reference's bars);
* the module's buffers, the eval path, ``train_flops_per_image``.

Four gloo ranks (``_torch_port_pool.part_results("resnet")``, bodies in
``_torch_port_models_workers.py``) run ResNet-18 with
``sync_bn_axis="data"`` on 4 images each: the statistics equal batch
norm over all 16 images, and logits, statistics and the rank-averaged
gradients equal the reference's under ``shard_map`` on a 4-device CPU
mesh."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.models import resnet as resnet_jax

from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet

import _torch_port_models_workers as W
import _torch_port_pool as pool

# fp32 on both sides; the convolutions sum in another order (XLA's CPU
# convs against oneDNN's), which ResNet-18's 8 blocks amplify to ~3e-5 in
# the logits and ~1e-4 normwise in a gradient.
LOGIT_BAR = dict(rtol=1e-4, atol=1e-4)
STATS_BAR = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-3
# ResNet-50 at 32x32 normalizes its last stage over 1x1 maps, 4 values a
# channel: a 1e-7 relative change of the input moves its own fp32 logits
# by 2.3e-3.  So it is compared in float64, where that amplification
# leaves the two packages' rounding far below this bar (normwise, each
# tensor).
R50_F64_REL = 1e-9


def _configs(**kw):
    base = dict(W.RESNET, **kw)
    return (resnet_jax.ResNetConfig(dtype=jnp.float32, **base),
            resnet.ResNetConfig(dtype=torch.float32, **base))


def _images(n, size, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, W.RESNET["num_classes"], n))


def _flat(tree):
    """{path: numpy} of a port tree (dicts and lists of tensors)."""
    return {k: v.detach().numpy() for k, v in convert.params_from_jax(
        _numpy(tree)).items()}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def _reference(cfg, images, labels, seed=0):
    """The reference's params, stats, loss, logits, new stats and
    gradients (jitted)."""
    params, stats = resnet_jax.init_params(jax.random.PRNGKey(seed), cfg)

    def loss_fn(p):
        logits, new = resnet_jax.apply(p, stats, images, cfg)
        return resnet_jax.cross_entropy_loss(logits, labels), (logits, new)

    (loss, (logits, new)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, stats, float(loss), np.asarray(logits), new, grads


def _port_model(cfg_t, params, stats):
    p, s = convert.resnet_from_jax(params, stats)
    return resnet.ResNet(cfg_t, device="cpu", params=p, stats=s)


def _check_model(depth, size):
    cfg_j, cfg_t = _configs(depth=depth)
    images, labels = _images(4, size)
    params, stats, loss, logits, new, grads = _reference(
        cfg_j, jnp.asarray(images), jnp.asarray(labels))
    model = _port_model(cfg_t, params, stats)
    got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), logits, **LOGIT_BAR)
    got_stats = {k[len("stats."):]: v.numpy()
                 for k, v in model.state_dict().items()
                 if k.startswith("stats.")}
    want_stats = _flat(convert.tree_from_jax(new))
    assert sorted(got_stats) == sorted(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, **STATS_BAR, err_msg=k)
    port_loss = resnet.cross_entropy_loss(got, torch.from_numpy(labels))
    assert port_loss.item() == pytest.approx(loss, rel=1e-5)
    port_loss.backward()
    want = _flat(convert.resnet_from_jax(grads, stats)[0])
    got_g = {n[len("params."):]: p.grad.numpy()
             for n, p in model.named_parameters()}
    assert sorted(got_g) == sorted(want)
    for k, g in want.items():
        rel = np.linalg.norm(got_g[k] - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= GRAD_REL, (k, rel)


def test_resnet18_logits_stats_and_gradients_match_reference():
    _check_model(18, 32)


def test_resnet18_odd_image_matches_reference():
    """33x33: the stem pads (3, 3), the max pool and every stride-2 3x3
    conv symmetric or not by their own sizes (17 -> 9 -> 5 -> 3)."""
    _check_model(18, 33)


class _Float64Widening(types.ModuleType):
    """``jax.numpy`` with its ``float32`` read as float64.  The reference
    widens to fp32 by that name (batch-norm moments, the head, the loss),
    so with it and x64 on, its ResNet runs wholly in float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _paths(tree, prefix=""):
    """{dotted path: leaf} of a nested tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}{k}."))
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def resnet50_f64():
    """ResNet-50 (width 8, 32x32, 4 images) in float64 through both
    packages on the reference's fp32 weights: {name: (port, reference)}
    for the loss, the logits, each new statistic and each gradient."""
    cfg_j, _ = _configs(depth=50)
    params, stats = resnet_jax.init_params(jax.random.PRNGKey(0), cfg_j)
    images, labels = _images(4, 32)
    images = images.astype(np.float64)
    cfg_j = cfg_j._replace(dtype=jnp.float64)
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet_jax, "jnp", _Float64Widening("jnp"))
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      (params, stats))

        def loss_fn(p):
            logits, new = resnet_jax.apply(p, wide[1], jnp.asarray(images),
                                           cfg_j)
            return resnet_jax.cross_entropy_loss(
                logits, jnp.asarray(labels)), (logits, new)

        (loss, (logits, new)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(wide[0])
        want = {"loss": np.asarray(loss)[None], "logits": np.asarray(logits)}
        want.update({"stats." + k: np.asarray(v)
                     for k, v in _paths(new).items()})
        want.update({"params." + k: np.asarray(v).transpose(3, 2, 0, 1)
                     if v.ndim == 4 else np.asarray(v)
                     for k, v in _paths(grads).items()})
    _, cfg_t = _configs(depth=50)
    model = _port_model(cfg_t._replace(dtype=torch.float64), params, stats)
    logits = model(torch.from_numpy(images))
    loss = resnet.cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()
    got = {"loss": loss.detach().numpy()[None],
           "logits": logits.detach().numpy()}
    got.update({k: v.numpy() for k, v in model.state_dict().items()
                if k.startswith("stats.")})
    got.update({n: p.grad.numpy() for n, p in model.named_parameters()})
    assert sorted(got) == sorted(want)
    assert all(v.dtype == np.float64 for v in (*got.values(),
                                                *want.values()))
    return {k: (got[k], want[k]) for k in want}


def test_resnet50_forward_and_stats_match_reference(resnet50_f64):
    for k, (got, want) in resnet50_f64.items():
        if not k.startswith("params."):
            assert _rel(got, want) <= R50_F64_REL, (k, _rel(got, want))


def test_resnet50_gradients_match_reference(resnet50_f64):
    grads = {k: v for k, v in resnet50_f64.items() if k.startswith("params.")}
    assert len(grads) == 161
    for k, (got, want) in grads.items():
        assert _rel(got, want) <= R50_F64_REL, (k, _rel(got, want))


@pytest.mark.parametrize("n", [7, 8, 15, 16, 33])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (3, 1), (1, 2)])
def test_conv_same_padding_matches_xla(n, k, stride):
    rng = np.random.default_rng(n * 10 + k)
    x = rng.standard_normal((2, n, n + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [7, 8, 15, 16, 112])
def test_max_pool_same_padding_matches_xla(n):
    x = np.random.default_rng(n).standard_normal((2, n, n + 1, 3)).astype(
        np.float32)
    want = lax.reduce_window(jnp.asarray(x), -jnp.inf, lax.max,
                             (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = resnet._max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_same_pads_are_xlas():
    assert resnet._same_pads(224, 7, 2) == (2, 3)
    assert resnet._same_pads(112, 3, 2) == (0, 1)
    assert resnet._same_pads(56, 3, 2) == (0, 1)
    assert resnet._same_pads(56, 1, 2) == (0, 0)
    assert resnet._same_pads(56, 3, 1) == (1, 1)
    assert resnet._same_pads(33, 7, 2) == (3, 3)


def test_stem_s2d_equals_default_stem():
    """The reference's bars: the stem alone within 1e-5, the whole model
    within rtol 1e-4; and the port's s2d stem against the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((7, 7, 3, 16)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    s2d = resnet._stem_s2d_conv(xt, wt)
    np.testing.assert_allclose(s2d.numpy(), resnet._conv(xt, wt, 2).numpy(),
                               rtol=1e-5, atol=1e-5)
    want = resnet_jax._stem_s2d_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(s2d.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    _, cfg = _configs()
    images = torch.from_numpy(_images(2, 64)[0])
    params, stats = resnet.init_params(cfg, torch.Generator().manual_seed(2),
                                       device="cpu")
    l1, _ = resnet.apply(params, stats, images, cfg)
    l2, _ = resnet.apply(params, stats, images, cfg._replace(stem_s2d=True))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="even"):
        resnet._space_to_depth2(torch.zeros(1, 3, 31, 32))


def test_module_writes_stats_and_eval_reads_them():
    _, cfg = _configs()
    model = resnet.ResNet(cfg, seed=1, device="cpu")
    images = torch.from_numpy(_images(4, 32)[0])
    params, stats = model.params.tree(), model.stats.tree()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want, new = resnet.apply(params, stats, images, cfg)
    got = model(images)
    assert torch.equal(got, want)
    for k, v in _flat(new).items():
        np.testing.assert_array_equal(model.state_dict()["stats." + k]
                                      .numpy(), v)
        assert not torch.equal(before["stats." + k],
                               model.state_dict()["stats." + k])
    model.eval()
    with torch.no_grad():
        got = model(images)
    want, same = resnet.apply(model.params.tree(), model.stats.tree(),
                              images, cfg, training=False)
    assert torch.equal(got, want)
    assert same is not None


@pytest.mark.parametrize("depth", sorted(resnet.STAGE_BLOCKS))
def test_train_flops_per_image_matches_reference(depth):
    for size, width in ((224, 64), (32, 8), (160, 32)):
        cfg_j = resnet_jax.ResNetConfig(depth=depth, width=width)
        cfg_t = resnet.ResNetConfig(depth=depth, width=width)
        assert resnet.train_flops_per_image(cfg_t, size) == \
            resnet_jax.train_flops_per_image(cfg_j, size)


def test_init_params_shapes_match_reference():
    cfg_j = resnet_jax.ResNetConfig(depth=50, num_classes=10, width=8)
    cfg_t = resnet.ResNetConfig(depth=50, num_classes=10, width=8)
    pj, sj = resnet_jax.init_params(jax.random.PRNGKey(0), cfg_j)
    pt, st = resnet.init_params(cfg_t, device="cpu")
    want = {k: v.shape for k, v in convert.params_from_jax(
        convert.resnet_from_jax(pj, sj)[0]).items()}
    assert {k: tuple(v.shape) for k, v in _flat(pt).items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert sorted(_flat(st)) == sorted(_flat(convert.tree_from_jax(sj)))


# ---------------------------------------------------------------------------
# Synchronised batch norm at dp 4
# ---------------------------------------------------------------------------

def _sbn_data():
    images, labels = _images(W.RESNET_BATCH, W.RESNET_IMAGE, seed=5)
    cfg_j, _ = _configs()
    params, stats = resnet_jax.init_params(jax.random.PRNGKey(4), cfg_j)
    return images, labels, params, stats


def _write_sbn(out):
    images, labels, params, stats = _sbn_data()
    _, cfg_t = _configs(sync_bn_axis="data")
    model = _port_model(cfg_t, params, stats)
    np.savez(os.path.join(out, "resnet_state.npz"),
             **{k: v.numpy() for k, v in model.state_dict().items()})
    np.savez(os.path.join(out, "resnet.npz"), images=images, labels=labels)


@pytest.fixture(scope="module")
def sbn_ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "resnet", prepare=_write_sbn)


def test_sync_bn_equals_batch_norm_over_the_whole_batch(sbn_ranks):
    images, _, params, stats = _sbn_data()
    _, cfg_t = _configs()
    model = _port_model(cfg_t, params, stats)
    model(torch.from_numpy(images))
    want = {k: v for k, v in model.state_dict().items()
            if k.startswith("stats.")}
    for r in sbn_ranks:
        for k, v in want.items():
            assert torch.equal(r["stats"][k], sbn_ranks[0]["stats"][k])
            np.testing.assert_allclose(r["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_sync_bn_matches_reference_under_shard_map(sbn_ranks):
    images, labels, params, stats = _sbn_data()
    cfg_j, _ = _configs(sync_bn_axis="data")

    def body(p, s, im, lb):
        def loss_fn(p):
            logits, new = resnet_jax.apply(p, s, im, cfg_j)
            return resnet_jax.cross_entropy_loss(logits, lb), (logits, new)
        (_, (logits, new)), g = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(p)
        return logits, new, jax.lax.pmean(g, "data")

    mesh = Mesh(np.array(jax.devices()[:pool.WORLD]), ("data",))
    logits, new, grads = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P("data"), P(), P()), check_vma=False))(
            params, stats, jnp.asarray(images), jnp.asarray(labels))
    got_logits = np.concatenate([r["logits"].numpy() for r in sbn_ranks])
    np.testing.assert_allclose(got_logits, np.asarray(logits), **LOGIT_BAR)
    for k, v in _flat(convert.tree_from_jax(new)).items():
        np.testing.assert_allclose(sbn_ranks[0]["stats"]["stats." + k]
                                   .numpy(), v, **STATS_BAR, err_msg=k)
    want = _flat(convert.resnet_from_jax(grads, stats)[0])
    for k, g in want.items():
        got = sbn_ranks[0]["grads"]["params." + k].numpy()
        rel = np.linalg.norm(got - g) / max(np.linalg.norm(g), 1e-30)
        assert rel <= GRAD_REL, (k, rel)
