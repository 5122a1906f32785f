"""ResNet v1.5, depths 18/34/50/101/152 (port of
horovod_tpu/models/resnet.py): Horovod's headline benchmark model.

The functional API is the reference's: ``init_params`` gives ``(params,
batch_stats)`` trees (stage lists of blocks), ``apply(params, stats,
images, cfg, training)`` gives ``(logits, new_stats)``.  ``ResNet`` holds
the same trees as an ``nn.Module``: the parameters as parameters, the
batch-norm statistics as buffers that a training forward updates.

Layout.  Images come in NHWC, as the reference takes them; ``images.
permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW view in
``channels_last`` memory, which cuDNN's NHWC kernels read as it is.  Conv
kernels are PyTorch's OIHW (``convert.resnet_from_jax`` transposes the
reference's HWIO).  The convolutions are ``F.conv2d`` (cuDNN on the
card): the reference computes them in XLA, outside any Pallas kernel.

Numerics as the reference's.  ``padding="SAME"`` is XLA's: at stride 2
it pads asymmetrically (low = total // 2, the rest high), so the 7x7/s2
stem pads (2, 3) and a 3x3/s2 conv (0, 1) on even inputs, and the 3x3/s2
max pool pads (0, 1) with -inf (``_same_pads``).  Batch norm takes fp32
moments, var = E[x²] - E[x]² (biased), running statistics m · old +
(1 - m) · new, eps 1e-5, and normalizes in the compute dtype with
(scale · rsqrt(var + eps), shift) folded in fp32; with ``sync_bn_axis``
the two moments are averaged over that axis with a differentiable
all-reduce (``lax.pmean``'s counterpart).  The head runs in fp32.  A
float64 model keeps float64 wherever the reference widens to fp32 (the
moments, the head, the loss), so it can be held to the reference in
float64.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.basics import DeviceLike, resolve_device
from ..parallel.ring_attention import _group_of
from . import _mesh

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BOTTLENECK = {50, 101, 152}
BN_EPS = 1e-5


class ResNetConfig(NamedTuple):
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16
    # Average the batch moments over this axis: "data" (the world), a
    # dimension of the runtime's mesh(), or a process group.
    sync_bn_axis: Optional[Any] = None
    bn_momentum: float = 0.9
    # The 7x7/s2 stem as a 4x4/s1 conv over a 2x2 space-to-depth of the
    # input (3 -> 12 channels): the same function, rounded differently.
    stem_s2d: bool = False


def init_params(cfg: ResNetConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)``, fp32 on ``device`` (the card unless the
    caller names the CPU): He-normal conv kernels (OIHW), unit BN scales,
    zero biases, head normal(0, 1/sqrt(c_in)); stats mean 0, var 1."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))
        return (torch.randn((cout, cin, kh, kw), generator=generator)
                * std).to(dev)

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def bn_stats(c):
        return {"mean": torch.zeros(c, device=dev),
                "var": torch.ones(c, device=dev)}

    bottleneck = cfg.depth in BOTTLENECK
    expansion = 4 if bottleneck else 1
    params: Dict[str, Any] = {"stem": {"conv": conv(7, 7, 3, cfg.width),
                                       "bn": bn(cfg.width)}}
    stats: Dict[str, Any] = {"stem": bn_stats(cfg.width)}
    cin = cfg.width
    for si, nblocks in enumerate(STAGE_BLOCKS[cfg.depth]):
        cmid = cfg.width * (2 ** si)
        cout = cmid * expansion
        stage_p, stage_s = [], []
        for bi in range(nblocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            shapes = ([(1, 1, cin, cmid), (3, 3, cmid, cmid),
                       (1, 1, cmid, cout)] if bottleneck
                      else [(3, 3, cin, cmid), (3, 3, cmid, cout)])
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for ci, shape in enumerate(shapes):
                bp[f"conv{ci}"] = conv(*shape)
                bp[f"bn{ci}"] = bn(shape[-1])
                bs[f"bn{ci}"] = bn_stats(shape[-1])
            if bi == 0 and (stride != 1 or cin != cout):
                bp["proj"] = conv(1, 1, cin, cout)
                bp["proj_bn"] = bn(cout)
                bs["proj_bn"] = bn_stats(cout)
            stage_p.append(bp)
            stage_s.append(bs)
            cin = cout
        params[f"stage{si}"] = stage_p
        stats[f"stage{si}"] = stage_s
    params["head"] = {
        "w": (torch.randn((cin, cfg.num_classes), generator=generator)
              / math.sqrt(cin)).to(dev),
        "b": torch.zeros(cfg.num_classes, device=dev)}
    return params, stats


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: out = ceil(n / stride), the
    total padding split low = total // 2, high = the rest."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value=0.0):
    """x (N, C, H, W) padded for a SAME window: (x, symmetric padding for
    the op) where the padding is symmetric, else (explicitly padded x,
    0)."""
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME conv of x (N, C, H, W) with an OIHW kernel, in x's dtype."""
    x, pad = _pad_same(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max pool, SAME with -inf (``lax.reduce_window``)."""
    x, pad = _pad_same(x, 3, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=pad)


def _space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel order (di, dj, c)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"stem_s2d requires even input H/W, got {(h, w)}; use the "
            "default stem for odd sizes")
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def _s2d_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """The (K, C, 7, 7) stride-2 stem kernel as the (K, 4C, 4, 4) stride-1
    kernel over the space-to-depth input: tap p = 2a + di lands on
    channel (di, dj, c) at offset a; tap 7 never occurs (zero pad 7 -> 8)."""
    k, c, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the stem kernel is 7x7, got {(kh, kw)}")
    wp = F.pad(w, (0, 1, 0, 1)).reshape(k, c, 4, 2, 4, 2)  # (k,c,a,di,b,dj)
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(k, 4 * c, 4, 4)


def _stem_s2d_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = F.pad(_space_to_depth2(x), (1, 2, 1, 2))
    return F.conv2d(y, _s2d_stem_kernel(w).to(x.dtype))


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in its own dtype where that is wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _batch_norm(x: torch.Tensor, bn, stats, cfg: ResNetConfig,
                training: bool):
    """(normalized x, new stats); the moments in fp32 over (N, H, W), the
    new stats detached (they are carried, not differentiated)."""
    if training:
        xf = _wide(x)
        mean = xf.mean(dim=(0, 2, 3))
        mean_sq = (xf * xf).mean(dim=(0, 2, 3))
        if cfg.sync_bn_axis is not None:
            mean, mean_sq = _mesh.pmean(torch.stack([mean, mean_sq]),
                                        _group_of(cfg.sync_bn_axis))
        var = mean_sq - mean * mean
        m = cfg.bn_momentum
        new_stats = {"mean": (m * stats["mean"] + (1 - m) * mean).detach(),
                     "var": (m * stats["var"] + (1 - m) * var).detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    inv = torch.rsqrt(var + BN_EPS)
    w = (inv * bn["scale"]).to(x.dtype)
    b = (bn["bias"] - mean * inv * bn["scale"]).to(x.dtype)
    return x * w[:, None, None] + b[:, None, None], new_stats


def apply(params, stats, images: torch.Tensor, cfg: ResNetConfig,
          training: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Forward pass: images (N, H, W, 3) → logits (N, classes), fp32 (or
    float64).

    Returns ``(logits, new_batch_stats)`` (the stats unchanged when not
    ``training``)."""
    bottleneck = cfg.depth in BOTTLENECK
    x = images.permute(0, 3, 1, 2).to(cfg.dtype)     # channels_last NCHW
    new_stats: Dict[str, Any] = {}
    if cfg.stem_s2d:
        x = _stem_s2d_conv(x, params["stem"]["conv"])
    else:
        x = _conv(x, params["stem"]["conv"], stride=2)
    x, new_stats["stem"] = _batch_norm(x, params["stem"]["bn"],
                                       stats["stem"], cfg, training)
    x = _max_pool(F.relu(x))
    n_convs = 3 if bottleneck else 2
    for si in range(4):
        out_stage = []
        for bi, (bp, bs) in enumerate(zip(params[f"stage{si}"],
                                          stats[f"stage{si}"])):
            stride = 2 if (si > 0 and bi == 0) else 1
            shortcut, h = x, x
            nbs: Dict[str, Any] = {}
            for ci in range(n_convs):
                # v1.5: the stride is on the 3x3 conv (index 1 of a
                # bottleneck).
                s = stride if ci == (1 if bottleneck else 0) else 1
                h = _conv(h, bp[f"conv{ci}"], stride=s)
                h, nbs[f"bn{ci}"] = _batch_norm(h, bp[f"bn{ci}"],
                                                bs[f"bn{ci}"], cfg, training)
                if ci < n_convs - 1:
                    h = F.relu(h)
            if "proj" in bp:
                shortcut = _conv(shortcut, bp["proj"], stride=stride)
                shortcut, nbs["proj_bn"] = _batch_norm(
                    shortcut, bp["proj_bn"], bs["proj_bn"], cfg, training)
            x = F.relu(h + shortcut)
            out_stage.append(nbs)
        new_stats[f"stage{si}"] = out_stage
    pooled = _wide(x).mean(dim=(2, 3))
    return pooled @ params["head"]["w"] + params["head"]["b"], new_stats


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(_wide(logits), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


class _Tree(nn.Module):
    """A nested tree (dicts and lists of tensors) as a module: each leaf
    a parameter (or a buffer), each inner node a submodule, so the state
    dict's keys are the tree's paths (``stage0.1.conv2``)."""

    def __init__(self, tree, buffers: bool = False):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = enumerate(tree) if self._is_list else tree.items()
        for k, v in items:
            k = str(k)
            if isinstance(v, (dict, list)):
                self.add_module(k, _Tree(v, buffers))
            elif buffers:
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self):
        out = dict(self._parameters)
        out.update(self._buffers)
        out.update({k: m.tree() for k, m in self._modules.items()})
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


def _copy_(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy_(d, s)
    else:
        dst.copy_(src)


class ResNet(nn.Module):
    """The trees of ``init_params`` (or given ones: ``params``/``stats``,
    e.g. ``convert.resnet_from_jax``'s) as a module.  ``forward(images)``
    gives the logits; in training mode it also writes the new batch-norm
    statistics into the ``stats`` buffers."""

    def __init__(self, cfg: ResNetConfig, *, seed: int = 0,
                 device: DeviceLike = None, params=None, stats=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params, stats = init_params(cfg, torch.Generator().manual_seed(
                seed), device="cpu")
        dev = resolve_device(device)

        wide = torch.promote_types(cfg.dtype, torch.float32)

        def own(t):      # a copy: training writes the stats in place
            return t.detach().to(dev, wide, copy=True)

        self.params = _Tree(_map_tree(own, params))
        self.stats = _Tree(_map_tree(own, stats), buffers=True)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        logits, new_stats = apply(self.params.tree(), self.stats.tree(),
                                  images, self.cfg, self.training)
        if self.training:
            with torch.no_grad():
                _copy_(self.stats.tree(), new_stats)
        return logits


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def synthetic_batch(batch: int, image_size: int = 224,
                    num_classes: int = 1000, seed: int = 1,
                    device: DeviceLike = None):
    """(images fp32 (batch, size, size, 3) standard normal, labels int64
    in [0, num_classes)), from a numpy generator."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, image_size, image_size, 3),
                                 dtype=np.float32)
    labels = rng.integers(0, num_classes, (batch,))
    dev = resolve_device(device)
    return (torch.from_numpy(images).to(dev),
            torch.from_numpy(labels).to(dev))


# Forward GFLOP an image at 224x224, width 64 (the standard torchvision
# counts): the reference bench's accounting.
_FWD_GFLOP_PER_IMG = {18: 1.82, 34: 3.68, 50: 4.09, 101: 7.83, 152: 11.53}


def train_flops_per_image(cfg: ResNetConfig, image_size: int = 224) -> float:
    """Model FLOPs one training image executes (forward + backward = 3x
    forward), scaled quadratically with image size and width from the
    224 / width-64 counts.  The live-MFU input::

        hvd.metrics.set_step_flops(
            per_gpu_batch * resnet.train_flops_per_image(cfg))
    """
    fwd = _FWD_GFLOP_PER_IMG.get(cfg.depth, 4.09) * 1e9
    fwd *= (image_size / 224.0) ** 2 * (cfg.width / 64.0) ** 2
    return 3.0 * fwd
