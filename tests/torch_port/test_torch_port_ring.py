"""horovod_tpu_torch's sequence-parallel attention (``ring_attention``,
``ulysses_attention``) at sp 4 on four gloo ranks (started once per test
process by ``_torch_port_pool.part_results``) against horovod_tpu's under
``shard_map`` on a 4-device CPU mesh, on the same seeded (1, 256, 4, 32)
fp32 q/k/v and output cotangent: outputs and dq/dk/dv, causal and not.

* The plain ring (the port's default on CPU tensors) against the
  reference's XLA ring (``use_flash=False``), at the reference's own bar
  (tests/test_parallel.py: rtol 2e-4, atol 2e-5).
* The flash ring (``HVD_TPU_FLASH=1``: the kernels' plain versions inside
  the ring's custom backward) against the reference's flash ring, its
  Pallas kernels in interpret mode (``use_flash=True``), both fp32: rtol
  1e-4, atol 1e-5.
* Ulysses against the reference's Ulysses (its XLA attention inside) at
  the reference's bar (tests/test_parallel.py: 1e-4; gradients 1e-3).

At sp 1 (one process) both equal ``full_attention`` bit for bit on the
flash path, as the card's world-1 run holds them; a head count that sp
does not divide raises the reference's ``ValueError``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.compat import shard_map
from horovod_tpu.parallel import ring_attention as ra_jax
from horovod_tpu.parallel import ulysses as uly_jax

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import ring_attention as ra
from horovod_tpu_torch.parallel import ulysses

import _torch_port_pool as pool

WORLD = pool.WORLD
BARS = {("ring", "0"): dict(rtol=2e-4, atol=2e-5),
        ("ring", "1"): dict(rtol=1e-4, atol=1e-5),
        ("ulysses", "0"): dict(rtol=1e-4, atol=1e-4),
        ("ulysses", "1"): dict(rtol=1e-4, atol=1e-4)}
GRAD_BARS = {("ulysses", "0"): dict(rtol=1e-3, atol=1e-3),
             ("ulysses", "1"): dict(rtol=1e-3, atol=1e-3)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return pool.part_results(tmp_path_factory, "ring")


_REF = {}


def _reference(name, flash, causal):
    """(out, dq, dk, dv) of the reference at sp 4 over the whole
    sequence."""
    key = (name, flash, causal)
    if key not in _REF:
        data = pool.part_inputs("ring")
        q, k, v, ct = (jnp.asarray(data[n]) for n in ("q", "k", "v", "ct"))
        mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
        if name == "ring":
            def inner(q, k, v):
                return ra_jax.ring_attention(q, k, v, "sp", causal=causal,
                                             use_flash=flash == "1")
        else:
            def inner(q, k, v):
                return uly_jax.ulysses_attention(q, k, v, "sp",
                                                 causal=causal)
        f = shard_map(inner, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                      out_specs=P(None, "sp"), check_vma=False)
        def fwd_bwd(q, k, v, ct):
            out, vjp = jax.vjp(f, q, k, v)
            return (out,) + vjp(ct)
        _REF[key] = tuple(np.asarray(t)
                          for t in jax.jit(fwd_bwd)(q, k, v, ct))
    return _REF[key]


def _gathered(ranks, key):
    """The ranks' output and gradient shards, concatenated along the
    sequence."""
    return [np.concatenate([r[key][i].numpy() for r in ranks], axis=1)
            for i in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("flash", ["0", "1"])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sequence_parallel_matches_reference(ranks, name, flash, causal):
    if name == "ring" and flash == "1":
        os.environ["HVD_TPU_FLASH_INTERPRET"] = "1"
    try:
        want = _reference(name, flash, causal)
    finally:
        os.environ.pop("HVD_TPU_FLASH_INTERPRET", None)
    got = _gathered(ranks, (name, flash, causal))
    bar = BARS[(name, flash)]
    np.testing.assert_allclose(got[0], want[0], **bar, err_msg="out")
    for what, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_BARS.get((name, flash), bar),
                                   err_msg=what)


def test_ulysses_rejects_indivisible_heads(ranks):
    for r in ranks:
        assert "divisible" in r["indivisible"]
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    q = jnp.zeros((1, 32, 3, 4))
    with pytest.raises(ValueError, match="divisible") as ref:
        shard_map(lambda q, k, v: uly_jax.ulysses_attention(q, k, v, "sp"),
                  mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                  out_specs=P(None, "sp"), check_vma=False)(q, q, q)
    assert str(ref.value) == ranks[0]["indivisible"]


@pytest.mark.parametrize("causal", [True, False])
def test_sp1_equals_full_attention(monkeypatch, causal):
    """At sp 1 the flash ring is one kernel step and Ulysses is
    full_attention: equal bit for bit, outputs and gradients."""
    monkeypatch.setenv("HVD_TPU_FLASH", "1")
    data = pool.part_inputs("ring")
    hvd.init(device="cpu")
    try:
        outs = {}
        for name, fn in (("full", lambda q, k, v: ra.full_attention(
                              q, k, v, causal=causal)),
                         ("ring", lambda q, k, v: ra.ring_attention(
                             q, k, v, causal=causal)),
                         ("ulysses", lambda q, k, v: ulysses.ulysses_attention(
                             q, k, v, causal=causal))):
            q, k, v = (torch.from_numpy(data[n][:, :64].copy())
                       .requires_grad_() for n in ("q", "k", "v"))
            out = fn(q, k, v)
            (out * torch.from_numpy(data["ct"][:, :64].copy())).sum() \
                .backward()
            outs[name] = (out.detach(), q.grad, k.grad, v.grad)
    finally:
        hvd.shutdown()
    for name in ("ring", "ulysses"):
        for a, b in zip(outs[name], outs["full"]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False])
def test_one_process_ring_equals_the_distributed_ring(ranks, causal):
    """The private seam: four members' shards held in one process walk
    the same ring, the rotation a shift of the list, and give the gloo
    ranks' values bit for bit (plain kernels, HVD_TPU_FLASH=1)."""
    data = pool.part_inputs("ring")
    shards = {n: [torch.from_numpy(data[n][:, 64 * i:64 * (i + 1)].copy())
                  .requires_grad_() for i in range(WORLD)]
              for n in ("q", "k", "v")}
    os.environ["HVD_TPU_FLASH"] = "1"
    try:
        outs = ra._ring_attention_shards(shards["q"], shards["k"],
                                         shards["v"], causal=causal)
    finally:
        os.environ.pop("HVD_TPU_FLASH")
    torch.autograd.backward(outs, [
        torch.from_numpy(data["ct"][:, 64 * i:64 * (i + 1)].copy())
        for i in range(WORLD)])
    for i, r in enumerate(ranks):
        got = (outs[i].detach(), shards["q"][i].grad, shards["k"][i].grad,
               shards["v"][i].grad)
        for a, b in zip(got, r[("ring", "1", causal)]):
            assert torch.equal(a, b)
