"""Small MLP classifier, the model of the MNIST end-to-end slice (port of
horovod_tpu/models/mlp.py; ``examples/jax_mnist.py`` trains it).

The parameters are a list of ``{"w": (d_in, d_out), "b": (d_out,)}``
layers, fp32, the reference's tree; ``convert.tree_from_jax`` carries the
reference's across.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.basics import DeviceLike, resolve_device


def init_params(sizes: Sequence[int] = (784, 512, 512, 10),
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """He-normal weights (std sqrt(2 / d_in)) drawn from ``generator``,
    zero biases, on ``device`` (the card unless the caller names the
    CPU)."""
    dev = resolve_device(device)
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=generator) * math.sqrt(2.0 / din)
        params.append({"w": w.to(dev), "b": torch.zeros(dout, device=dev)})
    return params


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, classes) of x (B, ...), flattened per row."""
    h = x.reshape(x.shape[0], -1)
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = F.relu(h)
    return h


def loss_fn(params, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the logits against integer ``labels``."""
    logp = F.log_softmax(apply(params, x), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()
