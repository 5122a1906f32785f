"""Unsharded attention and its kernel dispatch (port of the
``reference_attention`` / ``full_attention`` part of
horovod_tpu/parallel/ring_attention.py; the ring itself is a later slice).

Layout: q, k, v are (batch, seq, heads, head_dim).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..ops import flash_attention as fa

_NEG_INF = -1e30


def _flash_enabled(q: torch.Tensor) -> bool:
    """Dispatch policy.  ``HVD_TPU_FLASH=0`` takes the plain path; on a
    CUDA tensor anything else takes the kernel.  On a CPU tensor the
    default is the plain path, as the reference's is off its accelerator,
    and ``HVD_TPU_FLASH=1`` takes the kernel's plain version.  Only the
    ``HVD_TPU_`` name is read, as in the reference."""
    v = os.environ.get("HVD_TPU_FLASH", "auto")
    if v == "0":
        return False
    return v == "1" or q.device.type == "cuda"


def reference_attention(q, k, v, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain unsharded attention, fp32 inside — the numerics oracle."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def full_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Unsharded attention (same layout as ring attention): the flash
    kernels on CUDA tensors, the plain path where ``HVD_TPU_FLASH=0`` says
    so (see ``_flash_enabled``)."""
    if _flash_enabled(q):
        return fa.flash_attention(q, k, v, causal=causal, scale=scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)
