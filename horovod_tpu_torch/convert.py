"""Load the reference's parameters into the port.

JAX's PRNG stream cannot be reproduced in PyTorch, so the port's own
``init_params`` draws from a ``torch.Generator``; to compute the same
function as a ``horovod_tpu`` model, convert its parameter tree instead.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's (nested) parameter tree — numpy arrays, or arrays
    ``np.asarray`` accepts — as a state dict for the port's module:
    ``{"embed": …, "layers.wqkv": …}``, fp32, shapes unchanged (layers
    keep their ``(n_pp, layers_per_stage, …)`` stacking)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = prefix + key
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, name + "."))
        else:
            arr = np.array(val, dtype=np.float32)  # a copy torch may own
            out[name] = torch.from_numpy(arr)
    return out
