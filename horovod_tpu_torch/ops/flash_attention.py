"""Flash attention: hand-written Hopper kernels and their plain versions
(port of horovod_tpu/ops/flash_attention.py).

Three kernels, in ``csrc/flash_attention.cu``:

* ``flash_fwd``      — out + logsumexp, online softmax over key tiles
  (replaces the Pallas ``_fwd_kernel``).
* ``flash_bwd_dq``   — dQ, streaming over key tiles (``_bwd_dq_kernel``),
  and δ = rowsum(dO∘O), which the reference computes outside its kernels.
* ``flash_bwd_dkv``  — dK/dV, streaming over query tiles (``_bwd_dkv_kernel``).

Each wrapper takes the kernel for CUDA tensors and the plain PyTorch
version beside it for CPU tensors; any other case raises.  There is no
fallback from the kernel to the plain version.  ``launches`` counts the
kernel launches of each wrapper.

Public API, as in the reference:

* ``flash_attention(q, k, v, causal=…)`` — differentiable
  (``torch.autograd.Function``, the reference's custom VJP).
* ``flash_attention_with_lse`` — also returns the logsumexp rows, the hook
  ring attention merges partials with (``combine_blocks``).

Layout is (batch, seq, heads, head_dim).  The kernels read q/k/v through
their strides (unit stride on head_dim), so the q/k/v slices of a fused
qkv projection are used without a copy.  ``q_offset``/``kv_offset``
globalize the causal mask.  Masked scores are ``-1e30``; a query row that
sees no key gets out = 0 and lse = ``-1e30``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

# Kernel launches per wrapper; reset_launches() zeroes them.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle the kernels are held to)
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale, q_offset, kv_offset):
    """fp32 (B, H, Sq, Sk) scores with the global causal mask applied."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    return s


def attention_with_lse_plain(q, k, v, causal: bool, scale: float,
                             q_offset: int = 0, kv_offset: int = 0):
    """(out, lse) with the semantics of the reference's
    ``_xla_attention_with_lse``: fp32 inside, out in q's dtype, lse fp32
    (B, H, Sq)."""
    s = _scores(q, k, causal, scale, q_offset, kv_offset)
    m_safe = s.amax(-1).clamp_min(_NEG_INF / 2)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m_safe[..., None]))
    l = p.sum(-1)
    l_safe = l.clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe[..., None], v.float())
    lse = torch.where(l <= 0.0, _NEG_INF, m_safe + torch.log(l_safe))
    return out.to(q.dtype), lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale, q_offset,
                       kv_offset):
    s = _scores(q, k, causal, scale, q_offset, kv_offset)
    lse = lse[..., None]
    p = torch.where((s <= _NEG_INF / 2) | (lse <= _NEG_INF / 2), 0.0,
                    torch.exp(s - lse))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def bwd_dq_plain(q, k, v, do, lse, out, causal: bool, scale: float,
                 q_offset: int = 0, kv_offset: int = 0):
    """(dQ, δ): δ = rowsum(dO∘O) (B, H, Sq) fp32 as the reference's
    ``_flash_bwd`` computes it, and dQ = Σ_k dS·K with P recomputed from
    lse (reference ``_bwd_dq_kernel``)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale,
                               q_offset, kv_offset)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype), delta


def bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                  q_offset: int = 0, kv_offset: int = 0):
    """dK = Σ_q dSᵀ·Q, dV = Σ_q Pᵀ·dO (reference ``_bwd_dkv_kernel``)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale,
                               q_offset, kv_offset)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/flash_attention.cu), bound with ctypes
# ---------------------------------------------------------------------------

class FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in csrc/flash_attention.cu."""
    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("dout", ctypes.c_void_p),
        ("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse_out", ctypes.c_void_p),
        ("dk", ctypes.c_void_p), ("dv", ctypes.c_void_p),
        ("q_stride", ctypes.c_longlong * 3),
        ("k_stride", ctypes.c_longlong * 3),
        ("v_stride", ctypes.c_longlong * 3),
        ("do_stride", ctypes.c_longlong * 3),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("Sq", ctypes.c_int),
        ("Sk", ctypes.c_int), ("D", ctypes.c_int), ("causal", ctypes.c_int),
        ("q_offset", ctypes.c_int), ("kv_offset", ctypes.c_int),
        ("scale", ctypes.c_float),
        ("o", ctypes.c_void_p), ("o_stride", ctypes.c_longlong * 3),
        ("delta_out", ctypes.c_void_p),
    ]


_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded kernel library."""
    for fn in ("hvd_flash_fwd", "hvd_flash_bwd_dq", "hvd_flash_bwd_dkv"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(FlashParams),
                                     ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.hvd_flash_error_string.argtypes = [ctypes.c_int]
    lib.hvd_flash_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    """Build (first call only) and bind the kernel library."""
    global _lib
    if _lib is None:
        from ._build import load
        _lib = _bind(load("flash_attention"))
    return _lib


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (the plain path); False when
    all are CUDA tensors (the kernel); raises on anything else."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"flash attention takes CPU or CUDA tensors, got "
                     f"devices {sorted(kinds)}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it through its strides (unit
    stride on head_dim, 16-byte aligned base and strides, as TMA needs),
    else a contiguous copy."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or \
            any(s % 8 for s in t.stride()[:3]):
        # A fresh allocation: contiguous() would keep a misaligned base.
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check_kernel_inputs(q, k, v, *rest) -> None:
    """``rest`` are q-shaped: dO, and O for dQ."""
    for t in (q, k, v) + rest:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash attention kernels take bfloat16, "
                            f"got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"expected (B, S, H, D) tensors, got shape "
                             f"{tuple(t.shape)}")
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"dO/O shape {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernels take head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid limit")


def _params(q, k, v, causal, scale, q_offset, kv_offset, **ptrs):
    p = FlashParams()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_stride[:] = [q.stride(0), q.stride(1), q.stride(2)]
    p.k_stride[:] = [k.stride(0), k.stride(1), k.stride(2)]
    p.v_stride[:] = [v.stride(0), v.stride(1), v.stride(2)]
    p.B, p.Sq, p.H, p.D = q.shape
    p.Sk = k.shape[1]
    p.causal, p.scale = int(bool(causal)), float(scale)
    p.q_offset, p.kv_offset = int(q_offset), int(kv_offset)
    for name, t in ptrs.items():
        setattr(p, name, t.data_ptr())
    return p


def _launch(fn_name: str, counter: str, p: FlashParams,
            device: torch.device) -> None:
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(ctypes.byref(p), stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.hvd_flash_error_string(err).decode()}")
    launches[counter] += 1


def flash_fwd(q, k, v, causal: bool, scale: float, q_offset: int = 0,
              kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), lse (B, H, Sq) fp32)."""
    if _on_cpu(q, k, v):
        return attention_with_lse_plain(q, k, v, causal, scale, q_offset,
                                        kv_offset)
    _check_kernel_inputs(q, k, v)
    q, k, v = map(_kernel_layout, (q, k, v))
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    p = _params(q, k, v, causal, scale, q_offset, kv_offset, out=out,
                lse_out=lse)
    _launch("hvd_flash_fwd", "flash_fwd", p, q.device)
    return out, lse


def _row_stat(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A (B, H, Sq) fp32 row statistic (lse, δ) as the kernels read it:
    contiguous, 16-byte aligned (the dK/dV kernel copies its rows with
    TMA); a copy only where ``t`` is not."""
    t = t.float().contiguous()
    if t.data_ptr() % 16:
        t = t.clone()  # a fresh allocation is aligned
    if t.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"lse/delta must be (B, H, Sq), got "
                         f"{tuple(t.shape)}")
    return t


def _bwd_params(q, k, v, do, causal, scale, q_offset, kv_offset, **ptrs):
    """The FlashParams of a backward launch, and the tensors it points at,
    which the caller keeps referenced until the launch has been
    enqueued.  ``ptrs`` name FlashParams pointer fields; an ``o`` is read
    through its strides, like q/k/v/dO."""
    q, k, v, do = map(_kernel_layout, (q, k, v, do))
    if "o" in ptrs:
        ptrs["o"] = _kernel_layout(ptrs["o"])
    p = _params(q, k, v, causal, scale, q_offset, kv_offset, dout=do,
                **ptrs)
    p.do_stride[:] = [do.stride(0), do.stride(1), do.stride(2)]
    if "o" in ptrs:
        p.o_stride[:] = list(ptrs["o"].stride()[:3])
    return p, (q, k, v, do, *ptrs.values())


def flash_bwd_dq(q, k, v, do, lse, out, causal: bool, scale: float,
                 q_offset: int = 0, kv_offset: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dQ (B, Sq, H, D), δ (B, H, Sq) fp32) from the saved lse and the
    forward's output ``out``: the kernel computes δ = rowsum(dO∘O) for its
    own rows, uses it in dS and returns it for :func:`flash_bwd_dkv`."""
    if _on_cpu(q, k, v, do, out):
        return bwd_dq_plain(q, k, v, do, lse, out, causal, scale, q_offset,
                            kv_offset)
    _check_kernel_inputs(q, k, v, do, out)
    b, sq, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    p, keep = _bwd_params(q, k, v, do, causal, scale, q_offset, kv_offset,
                          lse=_row_stat(lse, q), o=out, out=dq,
                          delta_out=delta)
    _launch("hvd_flash_bwd_dq", "flash_bwd_dq", p, q.device)
    del keep
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  q_offset: int = 0, kv_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, Sk, H, D)."""
    if _on_cpu(q, k, v, do):
        return bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale,
                             q_offset, kv_offset)
    _check_kernel_inputs(q, k, v, do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p, keep = _bwd_params(q, k, v, do, causal, scale, q_offset, kv_offset,
                          lse=_row_stat(lse, q), delta=_row_stat(delta, q),
                          dk=dk, dv=dv)
    _launch("hvd_flash_bwd_dkv", "flash_bwd_dkv", p, q.device)
    del keep
    return dk, dv


# ---------------------------------------------------------------------------
# Differentiable entry points
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP (flash_attention.py:389-430): forward
    saves (q, k, v, out, lse); backward runs dQ, which also computes
    δ = rowsum(dO∘O) (the reference computes it outside its kernels), then
    dK/dV with that δ."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_offset):
        out, lse = flash_fwd(q, k, v, causal, scale, q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        dq, delta = flash_bwd_dq(q, k, v, do, lse, out, *ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """Differentiable fused attention; (B, S, H, D) in and out."""
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 _default_scale(q, scale), int(q_offset),
                                 int(kv_offset))


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None, q_offset: int = 0,
                             kv_offset: int = 0):
    """Non-differentiable (out, lse); ``lse`` is (B, H, Sq) fp32, ``-1e30``
    where the row saw no unmasked key.  Merge partials with
    :func:`combine_blocks`."""
    with torch.no_grad():
        return flash_fwd(q, k, v, causal, _default_scale(q, scale),
                         int(q_offset), int(kv_offset))


def combine_blocks(o1, lse1, o2, lse2):
    """Merge two normalized blockwise-attention partials exactly.

    o*: (B, S, H, D); lse*: (B, H, S).  Returns (o, lse) of the union of the
    two key sets, as if softmax had been computed over both at once.
    """
    dead1, dead2 = lse1 <= _NEG_INF / 2, lse2 <= _NEG_INF / 2
    lse_new = torch.where(dead1 & dead2, _NEG_INF,
                          torch.logaddexp(lse1, lse2))
    w1 = torch.where(dead1, 0.0, torch.exp(lse1 - lse_new))
    w2 = torch.where(dead2, 0.0, torch.exp(lse2 - lse_new))
    w1 = w1.transpose(1, 2)[..., None]            # (B, S, H, 1)
    w2 = w2.transpose(1, 2)[..., None]
    o = o1.float() * w1 + o2.float() * w2
    return o.to(o1.dtype), lse_new
