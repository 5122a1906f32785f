"""Gradient wire compression (port of horovod_tpu/ops/compression.py).

Two kinds of compressor:

* **Cast compressors** (fp16/bf16) keep Horovod's ``compress() →
  collective → decompress()`` shape for API parity, but the collective
  layer recognizes them (``wire_dtype``) and routes the allreduce through
  the two-pass fp32-accumulation schedule in ``ops.quantization``.
* **Quantized compressors** (int8/int4) carry a block-scaled wire format
  (``spec``) that only exists inside the collective (per-block absmax
  scales ride next to the payload); ``compress()``/``decompress()`` are
  identities and ``ops.collective.allreduce(compression=…)`` /
  ``reducescatter(compression=…)`` do the real work.
"""

from __future__ import annotations

import torch

from .quantization import QuantSpec, default_block


class Compressor:
    """Interface: compress() -> (compressed, ctx); decompress(compressed, ctx).

    Class attributes read by the collective layer:
      ``wire``       — format name ("none", "fp16", "bf16", "int8", "int4")
      ``wire_dtype`` — cast wire dtype, or None
      ``bits``       — quantized wire bits, or None
    """

    wire = "none"
    wire_dtype = None
    bits = None

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @classmethod
    def spec(cls):
        """QuantSpec for quantized compressors (block size from the session
        quant block at call time), else None."""
        if cls.bits is None:
            return None
        return QuantSpec(bits=cls.bits, block=default_block())


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    """Cast floating tensors to ``wire_dtype`` for the wire; restore the
    dtype after."""

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire = "fp16"
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire = "bf16"
    wire_dtype = torch.bfloat16


class _QuantizedCompressor(Compressor):
    """Block-scaled quantized wire.  compress/decompress are identities:
    the format lives inside the collective (the two-pass schedule needs
    the scales next to the payload and fp32 accumulation between the
    passes), not around it."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int8Compressor(_QuantizedCompressor):
    """Per-block absmax int8 wire (~4x fewer bytes than fp32)."""

    wire = "int8"
    bits = 8


class Int4Compressor(_QuantizedCompressor):
    """Per-block absmax int4 wire, packed two per byte (~8x fewer bytes
    than fp32).  Coarse: pair with error feedback
    (``DistributedOptimizer(compression=Compression.int4)``)."""

    wire = "int4"
    bits = 4


class Compression:
    """Namespace matching ``hvd.Compression.{none,fp16}`` plus bf16 and the
    quantized engine's int8/int4."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor


_BY_NAME = {
    "none": NoneCompressor,
    "fp16": FP16Compressor,
    "bf16": BF16Compressor,
    "int8": Int8Compressor,
    "int4": Int4Compressor,
}

# Wire-format codes of the reference's native response stream
# (wire.h ResponseList::wire_compression).
WIRE_CODES = {"none": 0, "bf16": 1, "int8": 2, "int4": 3, "fp16": 4}


def by_name(name):
    """Resolve a knob string ("int8", "bf16", …) to a compressor class;
    unknown names resolve to none (a typo'd knob must not kill a job)."""
    return _BY_NAME.get((name or "none").strip().lower(), NoneCompressor)
