"""horovod_tpu_torch flash attention against the reference's Pallas kernels.

The port's CPU path (the kernels' plain versions) is held to the Pallas
kernels run in interpret mode, as tests/test_flash_attention.py runs them:
forward, lse, gradients, offsets and fully masked rows.  fp32 inputs compare
the algorithms (1e-5); bf16 inputs use the reference's own tolerances.  The
CUDA kernels against their plain versions are in test_torch_port_cuda.py."""

import ctypes
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as fa_jax
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring_attention as ra

NEG = -1e30
TOL_F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(b=2, sq=128, sk=128, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_pallas(causal, dtype):
    q, k, v, _ = _inputs()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = fa_jax.flash_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                 causal=causal, interpret=True)
    td = getattr(torch, dtype)
    out = fa.flash_attention(*(_t(x, td) for x in (q, k, v)), causal=causal)
    assert out.dtype == td
    tol = TOL_F32 if dtype == "float32" else dict(atol=2e-2, rtol=1e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("offsets", [(0, 0), (128, 0), (0, 64), (32, 96)])
def test_lse_and_offsets_match_pallas(offsets):
    q, k, v, _ = _inputs()
    qo, ko = offsets
    o_ref, lse_ref = fa_jax.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, q_offset=qo,
        kv_offset=ko, interpret=True)
    o, lse = fa.flash_attention_with_lse(*(_t(x) for x in (q, k, v)),
                                         causal=True, q_offset=qo,
                                         kv_offset=ko)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL_F32)
    # Rows whose global position precedes every key see nothing.
    n_dead = max(0, min(128, ko - qo))
    dead = lse.numpy() <= NEG / 2
    assert dead.sum() == n_dead * 2 * 2
    assert np.all(lse.numpy()[:, :, :n_dead] == NEG)
    assert np.all(np.asarray(lse_ref)[:, :, :n_dead] == NEG)
    assert not o.numpy()[:, :n_dead].any()


@pytest.mark.parametrize("causal,offsets", [(True, (0, 0)), (False, (0, 0)),
                                            (True, (0, 64)), (True, (64, 0))])
def test_gradients_match_pallas(causal, offsets):
    q, k, v, w = _inputs()
    qo, ko = offsets

    def loss_jax(q, k, v):
        o = fa_jax.flash_attention(q, k, v, causal=causal, q_offset=qo,
                                   kv_offset=ko, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    g_ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, q_offset=qo,
                             kv_offset=ko)
    (out * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=1e-4)


def test_combine_blocks_matches_reference():
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 16)).astype(np.float32)
              for _ in range(2))
    l1[:, :, :4] = NEG                   # one side empty
    l1[:, :, 4:6] = l2[:, :, 4:6] = NEG  # both sides empty
    ref_o, ref_l = fa_jax.combine_blocks(*(jnp.asarray(x)
                                           for x in (o1, l1, o2, l2)))
    o, lse = fa.combine_blocks(*(_t(x) for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **TOL_F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), **TOL_F32)
    assert np.all(lse.numpy()[:, :, 4:6] == NEG)


def test_lse_combine_splits_keys_exactly():
    q, k, v, _ = (_t(x) for x in _inputs(sk=128))
    o1, l1 = fa.flash_attention_with_lse(q, k[:, :48], v[:, :48],
                                         kv_offset=0)
    o2, l2 = fa.flash_attention_with_lse(q, k[:, 48:], v[:, 48:],
                                         kv_offset=48)
    oc, _ = fa.combine_blocks(o1, l1, o2, l2)
    ref = ra.reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(oc.numpy(), ref.numpy(), **TOL_F32)


def test_plain_backward_is_the_gradient_of_plain_forward():
    """The plain dQ / dK,dV versions (the kernels' oracles) equal autograd
    through plain attention, with offsets and ragged lengths."""
    q, k, v, do = (_t(x) for x in _inputs(sq=40, sk=72, d=16, seed=5))
    args = (True, 0.25, 48, 16)
    out, lse = fa.attention_with_lse_plain(q, k, v, *args)
    dq, delta = fa.bwd_dq_plain(q, k, v, do, lse, out, *args)
    dk, dv = fa.bwd_dkv_plain(q, k, v, do, lse, delta, *args)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    fa.attention_with_lse_plain(tq, tk, tv, *args)[0].backward(do)
    for got, ref in zip((dq, dk, dv), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("causal,offsets", [(True, (0, 0)), (False, (0, 0)),
                                            (True, (0, 64)), (True, (32, 96))])
def test_bwd_dq_and_delta_match_pallas(causal, offsets):
    """The port's dQ with δ (``bwd_dq_plain``, the kernel's oracle and its
    CPU path) against the reference's Pallas ``_bwd_call`` in interpret
    mode, fed the reference's δ (``_flash_bwd``, flash_attention.py:420).
    With offsets (0, 64) the first 64 rows see no key."""
    q, k, v, do = _inputs(seed=11)
    qo, ko = offsets
    scale = 32 ** -0.5
    o, lse = (np.array(x) for x in fa_jax.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, q_offset=qo,
        kv_offset=ko, interpret=True))
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    delta_ref = jnp.sum(bhsd(do) * bhsd(o), axis=-1)
    dq_ref, _, _ = fa_jax._bwd_call(
        bhsd(q), bhsd(k), bhsd(v), bhsd(do), jnp.asarray(lse), delta_ref,
        jnp.asarray([[qo, ko]], jnp.int32), causal=causal, scale=scale,
        block_q=64, block_k=64, interpret=True)
    dq, delta = fa.bwd_dq_plain(*(_t(x) for x in (q, k, v, do, lse, o)),
                                causal, scale, qo, ko)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_ref),
                               **TOL_F32)
    np.testing.assert_allclose(
        dq.numpy(), np.asarray(dq_ref).transpose(0, 2, 1, 3), **TOL_F32)
    n_dead = max(0, ko - qo) if causal else 0
    assert np.all(lse[:, :, :n_dead] == NEG)
    assert not dq.numpy()[:, :n_dead].any()


def test_full_attention_dispatch_on_cpu(monkeypatch):
    q, k, v, _ = (_t(x) for x in _inputs())
    ref = ra.reference_attention(q, k, v)
    fa.reset_launches()
    for flag in (None, "0", "1"):
        if flag is None:
            monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
        else:
            monkeypatch.setenv("HVD_TPU_FLASH", flag)
        np.testing.assert_allclose(ra.full_attention(q, k, v).numpy(),
                                   ref.numpy(), **TOL_F32)
    assert ra._flash_enabled(q)                 # "1" set last
    monkeypatch.setenv("HVD_TPU_FLASH", "auto")
    assert not ra._flash_enabled(q)             # CPU default: plain path
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}  # CPU tensors launch nothing


def test_flash_switch_reads_only_hvd_tpu_flash(monkeypatch):
    """The attention switch is ``HVD_TPU_FLASH`` alone, as in the reference
    (horovod_tpu/parallel/ring_attention.py): ``HOROVOD_FLASH`` does not
    turn the kernel path off."""
    q = SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
    monkeypatch.setenv("HOROVOD_FLASH", "0")
    assert ra._flash_enabled(q)
    monkeypatch.setenv("HVD_TPU_FLASH", "0")
    assert not ra._flash_enabled(q)


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_fwd(q, q, q, True, 0.1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_bwd_dq(q, q, q, q, None, q, True, 0.1)


def test_strided_qkv_slices_reach_the_kernel_without_copy():
    qkv = torch.zeros((2, 16, 4, 3, 64), dtype=torch.bfloat16)
    q = qkv[..., 0, :]
    assert fa._kernel_layout(q) is q
    odd = torch.zeros((2, 16, 4, 3, 36), dtype=torch.bfloat16)[..., 1, :]
    assert fa._kernel_layout(odd).is_contiguous()


def test_flash_params_mirror_the_c_struct():
    """ctypes layout of ``struct FlashParams`` (csrc/flash_attention.cu)
    on LP64: ten pointers, four int64[3] stride triples, eight ints, a
    float, then the fields appended for dQ's δ: a pointer, an int64[3] and
    a pointer.  The prefix is unchanged, so an earlier build still reads
    it."""
    P = fa.FlashParams
    assert P.dv.offset == 72 and P.q_stride.offset == 80
    assert P.do_stride.offset == 152 and P.B.offset == 176
    assert P.scale.offset == 208 and P.o.offset == 216
    assert P.o_stride.offset == 224 and P.delta_out.offset == 248
    assert ctypes.sizeof(P) == 256
