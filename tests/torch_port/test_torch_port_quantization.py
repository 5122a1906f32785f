"""horovod_tpu_torch's wire codecs against horovod_tpu's, on the same
seeded numpy inputs: ``quantize`` payloads and scales, ``pack_int4``,
``encode_pages`` and the byte counts are byte-identical; ``dequantize``,
``unpack_int4``, ``qdq`` and ``decode_pages`` are equal.  int8 and int4,
blocks 32, 64 and 256, ragged lengths and all-zero blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import quantization as Qj
from horovod_tpu_torch.ops import quantization as Q

SPECS = [(8, 32), (8, 256), (4, 64), (4, 256)]   # every block, both widths
LENGTHS = [1, 3 * 256 + 7]
# The reference codec runs op by op, as its eager and host paths do.  Under
# jit, XLA turns ``absmax / 127`` into ``absmax * (1/127)``, which moves a
# scale by one ulp in a few blocks (ROADMAP.md queue 3); the collective
# tests hold the compiled schedules within one grid step instead.


def _inputs(n, seed, dtype=np.float32):
    """Seeded values with magnitudes over several decades, an all-zero
    stretch (whole zero blocks at every block size) and exact halves of
    the int8 grid."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n)
    if n > 600:
        x[256:512] = 0.0
        x[600] = 127.0            # absmax: x / scale is exactly integral
        x[601:610] = np.arange(9) + 0.5
    return x.astype(dtype)


def _bytes(a):
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("bits,block", SPECS)
def test_quantize_bytes_match_reference(bits, block):
    for n in LENGTHS:
        x = _inputs(n, seed=n + bits)
        spec = Q.QuantSpec(bits, block)
        q_ref, s_ref = Qj.quantize(jnp.asarray(x), Qj.QuantSpec(bits, block))
        q, s = Q.quantize(torch.from_numpy(x), spec)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert q.shape == tuple(q_ref.shape) and s.shape == tuple(s_ref.shape)
        assert _bytes(q) == _bytes(q_ref), (n, bits, block)
        assert _bytes(s) == _bytes(s_ref), (n, bits, block)
        back = Q.dequantize(q, s, spec, n, (n,), torch.float32)
        back_ref = Qj.dequantize(q_ref, s_ref, Qj.QuantSpec(bits, block), n,
                                 (n,), jnp.float32)
        np.testing.assert_array_equal(back.numpy(), np.asarray(back_ref))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_zero_blocks_and_low_precision_inputs(bits):
    """All-zero blocks get scale 1.0; fp16 and 2-D inputs flatten to fp32
    as in the reference."""
    spec = Q.QuantSpec(bits, 4)
    q, s = Q.quantize(torch.zeros(8), spec)
    assert not q.any() and s.tolist() == [1.0, 1.0]
    x = _inputs(2 * 333, seed=5, dtype=np.float16).reshape(2, 333)
    q, s = Q.quantize(torch.from_numpy(x), Q.QuantSpec(bits, 64))
    q_ref, s_ref = Qj.quantize(jnp.asarray(x), Qj.QuantSpec(bits, 64))
    assert _bytes(q) == _bytes(q_ref) and _bytes(s) == _bytes(s_ref)
    np.testing.assert_array_equal(
        Q.qdq(torch.from_numpy(x), Q.QuantSpec(bits, 64)).numpy(),
        np.asarray(Qj.qdq(jnp.asarray(x), Qj.QuantSpec(bits, 64))))


def test_int4_pack_golden_and_full_range():
    # [1, -7] packs low nibble first: 0x1 | (0x9 << 4) = 0x91 = -111 as
    # int8; [0, 5] -> 0x50 = 80.
    q = torch.tensor([[1, -7, 0, 5]], dtype=torch.int8)
    assert Q.pack_int4(q).tolist() == [[-111, 80]]
    assert torch.equal(Q.unpack_int4(Q.pack_int4(q)), q)
    vals = np.resize(np.arange(-7, 8, dtype=np.int8), (3, 16))
    packed = Q.pack_int4(torch.from_numpy(vals))
    assert _bytes(packed) == _bytes(Qj.pack_int4(jnp.asarray(vals)))
    np.testing.assert_array_equal(Q.unpack_int4(packed).numpy(), vals)
    np.testing.assert_array_equal(
        Q.unpack_int4(packed).numpy(),
        np.asarray(Qj.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bits,block", SPECS)
def test_qdq_matches_reference(bits, block):
    x = _inputs(1000, seed=block).reshape(10, 100)
    np.testing.assert_array_equal(
        Q.qdq(torch.from_numpy(x), Q.QuantSpec(bits, block)).numpy(),
        np.asarray(Qj.qdq(jnp.asarray(x), Qj.QuantSpec(bits, block))))


@pytest.mark.parametrize("bits,block", SPECS)
def test_wire_bytes_match_reference(bits, block):
    for n in LENGTHS + [0, 29_630_976]:
        spec, spec_ref = Q.QuantSpec(bits, block), Qj.QuantSpec(bits, block)
        assert Q.wire_bytes(n, spec) == Qj.wire_bytes(n, spec_ref)
        assert Q.page_wire_bytes(n, spec) == Qj.page_wire_bytes(n, spec_ref)
    assert Q.page_wire_bytes(77, None) == Qj.page_wire_bytes(77, None) == 308


@pytest.mark.parametrize("spec", [None] + SPECS)
def test_page_codec_matches_reference(spec):
    x = _inputs(2 * 3 * 77, seed=7).reshape(2, 3, 77)
    spec_ref = None if spec is None else Qj.QuantSpec(*spec)
    spec = None if spec is None else Q.QuantSpec(*spec)
    payload, scales = Q.encode_pages(torch.from_numpy(x), spec)
    payload_ref, scales_ref = Qj.encode_pages(x, spec_ref)
    assert payload == payload_ref and scales == scales_ref
    assert Q.encode_pages(x, spec) == (payload, scales)   # numpy input
    assert len(payload) + len(scales) == Q.page_wire_bytes(x.size, spec)
    got = Q.decode_pages(payload, scales, spec, x.size, x.shape)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(
        got.numpy(), Qj.decode_pages(payload_ref, scales_ref, spec_ref,
                                     x.size, x.shape))


def test_default_block_reads_the_knob(monkeypatch):
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", "33")
    monkeypatch.setenv("HOROVOD_QUANT_BLOCK", "128")
    assert Q.default_block() == 32          # HVD_TPU_ wins; evened
    monkeypatch.setenv("HVD_TPU_QUANT_BLOCK", "1")
    assert Q.default_block() == 2
    monkeypatch.delenv("HVD_TPU_QUANT_BLOCK")
    monkeypatch.delenv("HOROVOD_QUANT_BLOCK")
    assert Q.default_block() == Q.DEFAULT_BLOCK == Qj.DEFAULT_BLOCK


@pytest.mark.parametrize("bits", [8, 4])
def test_first_pass_hands_back_qdq(bits):
    """What the two-pass allreduce's first pass sends is qdq of its input
    bit for bit (the error-feedback operator), at a ragged length; at
    world 1 the result is qdq twice."""
    import horovod_tpu_torch as hvd
    x = torch.from_numpy(_inputs(7 * 111, seed=bits).reshape(7, 111))
    spec = Q.QuantSpec(bits, 256)
    hvd.init(device="cpu")
    try:
        out, sent = Q.compressed_allreduce(x, None, hvd.Sum, spec=spec,
                                           return_sent=True)
    finally:
        hvd.shutdown()
    assert sent.shape == (x.numel(),)
    assert torch.equal(sent.view_as(x), Q.qdq(x, spec))
    assert torch.equal(out, Q.qdq(Q.qdq(x, spec), spec))
