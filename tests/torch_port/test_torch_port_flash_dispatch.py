"""The attention dispatch of horovod_tpu_torch.parallel.ring_attention
in auto mode: a CUDA tensor takes the flash kernels only where they can
take it (bfloat16, four dimensions, head_dim in {32, 64, 128}) — the
port's counterpart of the reference's ``_supported(q, k)`` check — and
the plain path elsewhere; ``HVD_TPU_FLASH=1`` still forces the kernel
(which raises on fp32 on the card) and ``HVD_TPU_FLASH=0`` the plain
path.  Decided on fake CUDA-typed inputs: no card is needed."""

from types import SimpleNamespace

import pytest
import torch

from horovod_tpu_torch.parallel import ring_attention as ra


def _fake(dtype, shape=(1, 16, 2, 64), device="cuda"):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=shape)


@pytest.mark.parametrize("dtype,shape,takes", [
    (torch.bfloat16, (1, 16, 2, 64), True),
    (torch.bfloat16, (2, 512, 8, 32), True),
    (torch.bfloat16, (1, 8, 1, 128), True),
    (torch.float32, (1, 16, 2, 64), False),
    (torch.float16, (1, 16, 2, 64), False),
    (torch.bfloat16, (1, 16, 2, 96), False),
    (torch.bfloat16, (1, 16, 2, 256), False),
    (torch.bfloat16, (16, 2, 64), False),
])
def test_auto_mode_on_cuda_takes_the_kernel_only_where_it_can(
        monkeypatch, dtype, shape, takes):
    monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
    q = _fake(dtype, shape)
    assert ra.kernel_takes(q) is takes
    assert ra._flash_enabled(q) is takes
    assert ra._flash_enabled(q, _fake(dtype, shape)) is takes
    monkeypatch.setenv("HVD_TPU_FLASH", "auto")
    assert ra._flash_enabled(q) is takes


def test_k_of_another_dtype_takes_the_plain_path(monkeypatch):
    monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
    q, k = _fake(torch.bfloat16), _fake(torch.float32)
    assert not ra._flash_enabled(q, k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_switch_still_forces(monkeypatch, dtype):
    q = _fake(dtype)
    monkeypatch.setenv("HVD_TPU_FLASH", "1")
    assert ra._flash_enabled(q)          # fp32 then raises in the kernel
    monkeypatch.setenv("HVD_TPU_FLASH", "0")
    assert not ra._flash_enabled(q)


def test_cpu_tensors_take_the_plain_path_in_auto_mode(monkeypatch):
    monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
    assert not ra._flash_enabled(_fake(torch.bfloat16, device="cpu"))
    q = torch.zeros((1, 8, 1, 64), dtype=torch.float32)
    out = ra.full_attention(q, q, q)
    assert out.dtype == torch.float32 and out.shape == q.shape
