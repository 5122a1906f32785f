"""Load the reference's parameters into the port.

JAX's PRNG stream cannot be reproduced in PyTorch, so the port's own
``init_params`` draws from a ``torch.Generator``; to compute the same
function as a ``horovod_tpu`` model, convert its parameter tree instead.

* ``params_from_jax``: a flat state dict (``embed``, ``layers.wqkv``, …)
  for a module: the flagship ``Transformer``, ``bert.Bert`` (stacked
  layers) and ``moe_transformer.MoETransformer`` (expert stacks).
* ``tree_from_jax``: the same tree, nested as it was (dicts and lists),
  for the functional entry points (``mlp``, ``bert``, ``moe_transformer``).
* ``resnet_from_jax``: ResNet's params and batch-norm stats trees (stage
  lists of blocks), conv kernels from JAX's HWIO to PyTorch's OIHW.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _items(tree):
    if isinstance(tree, Mapping):
        return tree.items()
    return ((str(i), v) for i, v in enumerate(tree))


def _tensor(val) -> torch.Tensor:
    return torch.from_numpy(np.array(val, dtype=np.float32))  # a copy


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's (nested) parameter tree — numpy arrays, or arrays
    ``np.asarray`` accepts — as a state dict for the port's module:
    ``{"embed": …, "layers.wqkv": …}``, fp32, shapes unchanged (layers
    keep their stacking; a list's entries are named by their index)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in _items(tree):
        name = prefix + key
        if isinstance(val, (Mapping, list, tuple)):
            out.update(params_from_jax(val, name + "."))
        else:
            out[name] = _tensor(val)
    return out


def tree_from_jax(tree):
    """The reference's tree with each leaf an fp32 CPU tensor, dicts and
    lists kept."""
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v) for v in tree]
    return _tensor(tree)


def _conv_to_oihw(tree):
    if isinstance(tree, dict):
        return {k: _conv_to_oihw(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_conv_to_oihw(v) for v in tree]
    return tree.permute(3, 2, 0, 1).contiguous() if tree.dim() == 4 else tree


def resnet_from_jax(params, stats) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """ResNet's ``(params, batch_stats)`` of ``horovod_tpu.models.resnet``
    as the port's trees: every conv kernel (the tree's 4-D leaves) from
    (kh, kw, c_in, c_out) to (c_out, c_in, kh, kw); the head, the
    batch-norm scales and biases and the stats as they are."""
    return _conv_to_oihw(tree_from_jax(params)), tree_from_jax(stats)
