"""horovod_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card (marker ``cuda``; each test skips without a GPU).  Imports
neither JAX nor horovod_tpu, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest tests/torch_port/test_torch_port_cuda.py -q

Tolerances (bf16 inputs): out atol 2e-2 rtol 1e-3 and gradients atol 5e-2
rtol 1e-2, as the reference's kernel tests hold the Pallas kernels; lse is
fp32 on both sides (atol 2e-3 rtol 1e-4: the fast exp and the summation
order).  Those gradient atol are near a typical gradient element at the
flagship shape, so every output is also held normwise:
||kernel - plain|| / ||plain|| <= 1e-2.  The kernels round P and dS to
bf16 before their tensor-core products; these bounds include that.  dQ's
δ = rowsum(dO∘O) is fp32 from bf16 inputs on both sides, whose products
are exact in fp32, so it differs only by the summation order (atol 1e-3,
rtol 1e-4).

The wire codec (torch ops, no kernel of its own) gives the CPU's bytes on
the card, and a world-1 NCCL allreduce on each compressed wire gives the
CPU's two-pass values bit for bit.  A ZeRO checkpoint of card-resident
shards round-trips bit for bit on the card, and the DataLoader's pinned
ring delivers batches bit-equal to their host rows while the next
gathers are in flight.  A small bf16 BERT runs the kernels non-causally
within the flagship step's bars of the plain attention, and the quantized
all-to-all's gradient equals the CPU's bit for bit."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import quantization as Q

CASES = [  # (b, sq, sk, h, d, causal, q_offset, kv_offset)
    (2, 200, 200, 3, 64, True, 0, 0),
    (2, 200, 200, 3, 64, False, 0, 0),
    (1, 96, 160, 2, 32, True, 64, 0),
    (1, 130, 70, 2, 128, True, 0, 100),   # rows < 100 see no key
    (1, 64, 64, 2, 32, True, 0, 64),      # no row sees a key
    (8, 512, 512, 8, 64, True, 0, 0),     # the flagship training shape
    # Lengths off the 128-row tiles: TMA's zero fill and the score mask.
    (1, 333, 333, 2, 64, True, 0, 0),
    (2, 129, 129, 2, 128, False, 0, 0),
    (1, 200, 333, 2, 64, True, 150, 20),  # Sq != Sk, both offsets
    (1, 333, 129, 3, 32, True, 40, 250),
    (5, 192, 192, 28, 64, True, 0, 0),    # B*H = 140 > 132 SMs
]


def assert_matches(got, ref, atol, rtol):
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    diff = (got.float() - ref.float()).norm()
    assert diff <= 1e-2 * ref.float().norm(), "normwise relative error"


def assert_dq_matches(q, k, v, do, lse, o, args):
    """flash_bwd_dq's dQ and δ against bwd_dq_plain's; returns the plain δ
    for dK/dV, so that each kernel is held to its plain version on the same
    inputs."""
    dq, delta = fa.flash_bwd_dq(q, k, v, do, lse, o, *args)
    dq_p, delta_p = fa.bwd_dq_plain(q, k, v, do, lse, o, *args)
    assert_matches(dq, dq_p, atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(delta, delta_p, atol=1e-3, rtol=1e-4)
    return delta_p


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_match_plain(cuda_device, case):
    b, sq, sk, h, d, causal, qo, ko = case
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(
        cuda_device, torch.bfloat16) for s in (sq, sk, sk, sq))
    args = (causal, d ** -0.5, qo, ko)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.attention_with_lse_plain(q, k, v, *args)
    assert_matches(o, o_p, atol=2e-2, rtol=1e-3)
    torch.testing.assert_close(lse, lse_p, atol=2e-3, rtol=1e-4)
    delta = assert_dq_matches(q, k, v, do, lse_p, o_p, args)
    bargs = (do, lse_p, delta) + args
    for got, ref in zip(fa.flash_bwd_dkv(q, k, v, *bargs),
                        fa.bwd_dkv_plain(q, k, v, *bargs)):
        assert_matches(got, ref, atol=5e-2, rtol=1e-2)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_kernels_match_plain_fused_qkv(cuda_device, d):
    """q, k, v as strided slices of a fused (B, S, H, 3, D) projection, as
    the transformer passes them: the kernels read them through their
    strides (at head_dim 128 a row is two 64-column TMA boxes)."""
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn((2, 200, 3, 3, d), generator=g).to(cuda_device,
                                                          torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    do = torch.randn(q.shape, generator=g).to(cuda_device, torch.bfloat16)
    args = (True, d ** -0.5, 0, 0)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.attention_with_lse_plain(q, k, v, *args)
    assert_matches(o, o_p, atol=2e-2, rtol=1e-3)
    torch.testing.assert_close(lse, lse_p, atol=2e-3, rtol=1e-4)
    delta = assert_dq_matches(q, k, v, do, lse_p, o_p, args)
    bargs = (do, lse_p, delta) + args
    for got, ref in zip(fa.flash_bwd_dkv(q, k, v, *bargs),
                        fa.bwd_dkv_plain(q, k, v, *bargs)):
        assert_matches(got, ref, atol=5e-2, rtol=1e-2)


@pytest.mark.cuda
def test_cuda_kernels_take_misaligned_inputs(cuda_device):
    """TMA needs 16-byte aligned bases: a contiguous q/k/v, lse or δ that
    starts 2 or 4 bytes into its storage is copied, not misread."""
    b, s, h, d = 1, 130, 2, 64
    g = torch.Generator().manual_seed(3)

    def shifted(shape, dtype):
        n = torch.Size(shape).numel()
        flat = torch.randn(n + 1, generator=g).to(cuda_device, dtype)
        return flat[1:].view(shape)

    q, k, v, do = (shifted((b, s, h, d), torch.bfloat16) for _ in range(4))
    args = (True, d ** -0.5, 0, 0)
    o_p, lse_p = fa.attention_with_lse_plain(q, k, v, *args)
    assert_matches(fa.flash_fwd(q, k, v, *args)[0], o_p, atol=2e-2, rtol=1e-3)
    lse = shifted(lse_p.shape, torch.float32).copy_(lse_p)
    delta = shifted(lse_p.shape, torch.float32).copy_(
        (do.float() * o_p.float()).sum(-1).transpose(1, 2))
    bargs = (do, lse, delta) + args
    for got, ref in zip(fa.flash_bwd_dkv(q, k, v, *bargs),
                        fa.bwd_dkv_plain(q, k, v, *bargs)):
        assert_matches(got, ref, atol=5e-2, rtol=1e-2)


@pytest.mark.cuda
def test_cuda_dq_takes_misaligned_out(cuda_device):
    """dQ reads O (for δ) with 16-byte loads: an O that starts 2 bytes
    into its storage is copied, not misread."""
    b, s, h, d = 1, 130, 2, 64
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(
        cuda_device, torch.bfloat16) for _ in range(4))
    args = (True, d ** -0.5, 0, 0)
    o_p, lse_p = fa.attention_with_lse_plain(q, k, v, *args)
    flat = torch.empty(o_p.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    o = flat[1:].view(o_p.shape).copy_(o_p)
    assert o.data_ptr() % 16
    assert_dq_matches(q, k, v, do, lse_p, o, args)


@pytest.mark.cuda
def test_cuda_backward_on_a_side_stream(cuda_device):
    """Forward and backward through autograd on a side stream, in a fresh
    process: the autograd engine's device thread then makes its first CUDA
    call in the dQ launcher, which must not encode its TMA maps before the
    runtime has made the context current in that thread."""
    code = textwrap.dedent("""
        import torch
        from horovod_tpu_torch.ops import flash_attention as fa
        g = torch.Generator().manual_seed(5)
        q, k, v, do = (torch.randn((2, 200, 3, 64), generator=g).to(
            "cuda", torch.bfloat16) for _ in range(4))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fa.flash_attention(*leaves, causal=True).backward(do)
        torch.cuda.synchronize()
        plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
        fa.attention_with_lse_plain(*plain, True, 64 ** -0.5)[0].backward(
            do.float())
        for got, ref in zip(leaves, plain):
            diff = (got.grad.float() - ref.grad).norm()
            assert diff <= 1e-2 * ref.grad.norm(), diff
        print("side stream ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "side stream ok" in proc.stdout, \
        proc.stderr[-4000:]


@pytest.mark.cuda
def test_cuda_kernels_refuse_unsupported_inputs(cuda_device):
    bad_d = torch.zeros((1, 64, 2, 96), device=cuda_device,
                        dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(bad_d, bad_d, bad_d, True, 0.1)
    f32 = torch.zeros((1, 64, 2, 64), device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(f32, f32, f32, True, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,block", [(8, 256), (4, 256), (8, 32), (4, 64)])
def test_cuda_codec_matches_cpu_bit_for_bit(cuda_device, bits, block):
    spec = Q.QuantSpec(bits, block)
    g = torch.Generator().manual_seed(bits * block)
    for n in (1, 1000, 3 * block + 7, 1 << 20):
        x = torch.randn(n, generator=g) * 10.0 ** torch.randint(
            -3, 3, (n,), generator=g)
        x[:block] = 0.0                  # an all-zero block: scale 1.0
        q, s = Q.quantize(x, spec)
        q_d, s_d = Q.quantize(x.to(cuda_device), spec)
        assert torch.equal(q_d.cpu(), q) and torch.equal(s_d.cpu(), s)
        assert torch.equal(Q.dequantize(q_d, s_d, spec, n).cpu(),
                           Q.dequantize(q, s, spec, n))
        if bits == 4:
            nibbles = Q.unpack_int4(q)
            assert torch.equal(Q.unpack_int4(q_d).cpu(), nibbles)
            assert torch.equal(Q.pack_int4(nibbles.to(cuda_device)).cpu(), q)


def _two_pass_world1(x, wire):
    """The two-pass schedule at world 1 on the CPU: quantize and
    dequantize twice (or cast twice), back in x's dtype."""
    if wire in ("bf16", "fp16"):
        dt = torch.bfloat16 if wire == "bf16" else torch.float16
        return x.float().to(dt).float().to(dt).float().to(x.dtype)
    spec = Q.QuantSpec(int(wire[3]), 256)
    return Q.qdq(Q.qdq(x.float(), spec), spec).to(x.dtype)


@pytest.mark.cuda
def test_cuda_world1_nccl_compressed_allreduce(cuda_device):
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        g = torch.Generator().manual_seed(9)
        x = torch.randn(3, 1000, generator=g)
        for wire in ("fp16", "bf16", "int8", "int4"):
            for op in (hvd.Average, hvd.Sum):
                got = hvd.allreduce(x.to(cuda_device), op=op,
                                    compression=wire)
                assert got.device.type == "cuda" and got.dtype == x.dtype
                assert torch.equal(got.cpu(), _two_pass_world1(x, wire)), wire
        h = hvd.allreduce_async(x.to(cuda_device), compression="int8")
        assert torch.equal(hvd.synchronize(h).cpu(),
                           _two_pass_world1(x, "int8"))
        rs = hvd.reducescatter(x.to(cuda_device), compression="int4")
        assert torch.equal(rs.cpu(), Q.qdq(x, Q.QuantSpec(4, 256)))
    finally:
        hvd.shutdown()


def _side_stream_run(hvd, wire, overlap, device):
    """Three SGD steps of a small MLP on ``wire`` whose forward and
    backward run on a side stream, so the post-accumulate-grad hooks (and
    the bucket launches) run there; the synchronised gradients of step 0
    and the parameters after each step."""
    g = torch.Generator().manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(s, generator=g).to(device))
          for s in ((1024, 2048), (2048,), (2048, 1024), (1024,))]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.01),
                                   compression=wire, overlap=overlap)
    side = torch.cuda.Stream()
    out = []
    for s in range(3):
        x = torch.randn(256, 1024, generator=g).to(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            h = torch.relu(x @ ps[0] + ps[1])
            ((h @ ps[2] + ps[3]) ** 2).mean().backward()
        torch.cuda.current_stream().wait_stream(side)
        opt.step()
        out.append(([p.grad.clone() for p in ps],
                    [p.detach().clone() for p in ps]))
        opt.zero_grad()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "int8"])
def test_cuda_overlap_hooks_on_a_side_stream(cuda_device, wire):
    """Bucket collectives launched from hooks on a side stream (world 1,
    NCCL) give the per-parameter schedule's gradients and parameters bit
    for bit: each launch waits on the stream that produced its
    gradients."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        per = _side_stream_run(hvd, wire, False, cuda_device)
        bucketed = _side_stream_run(hvd, wire, 4 << 20, cuda_device)
    finally:
        hvd.shutdown()
    for (g1, p1), (g2, p2) in zip(per, bucketed):
        for a, b in zip(g1 + p1, g2 + p2):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_cuda_zero_train_step_launches(cuda_device, stage):
    """A small bf16 transformer (head_dim 64) through make_train_step with
    ZeroShardedOptimizer at each stage, world 1 on NCCL: every flash kernel
    launches once per layer per step (stage 3 runs the forward on the
    gathered parameters), the losses fall, and the parameters after step 0
    are the replicated step's within rtol 1e-5, atol 1e-6."""
    import functools
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                                d_ff=512, n_layers=2, seq_len=256,
                                remat=False)
    par = tfm.ParallelConfig()
    adamw = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=1e-4)
    hvd.init()
    try:
        tokens, labels = tfm.synthetic_batch(cfg, 2)
        after = {}
        for s in (0, stage):
            model = tfm.Transformer(cfg, par, seed=0)
            opt = hvd.DistributedOptimizer(adamw(model.parameters())) \
                if s == 0 else hvd.ZeroShardedOptimizer(model, adamw,
                                                        stage=s)
            step = tfm.make_train_step(cfg, par, model, opt)
            fa.reset_launches()
            losses = [step(tokens, labels).item()]
            with torch.no_grad():
                after[s] = [t.clone() for t in (
                    opt.gather_params().values() if s == 3
                    else model.parameters())]
            losses += [step(tokens, labels).item() for _ in range(2)]
            assert all(n == 3 * cfg.n_layers for n in fa.launches.values())
            assert losses[-1] < losses[0]
        for a, b in zip(after[stage], after[0]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    finally:
        hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 3])
def test_cuda_zero_checkpoint_round_trip(cuda_device, stage, tmp_path):
    """ZeroShardedOptimizer(AdamW) on the card, world 1 on NCCL: two steps,
    state_dict, a fresh optimizer from other weights restored from it —
    moments, the step count (torch's dtype and device) and, at stage 3,
    the parameter shards equal bit for bit and stay on the card — then one
    more step on each gives the same parameters."""
    import functools
    import horovod_tpu_torch as hvd
    adamw = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-3)

    def build(seed):
        g = torch.Generator().manual_seed(seed)
        m = torch.nn.Linear(40, 24).to(cuda_device)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        return m, hvd.ZeroShardedOptimizer(m, adamw, stage=stage)

    def step(m, opt, x):
        opt.zero_grad()
        params = opt.gather_params() if stage == 3 else \
            dict(m.named_parameters())
        out = torch.func.functional_call(m, params, (x,))
        out.square().mean().backward()
        opt.step()

    def params(m, opt):
        with torch.no_grad():
            return [t.clone() for t in (opt.gather_params().values()
                                        if stage == 3 else m.parameters())]

    hvd.init()
    try:
        x = torch.randn(8, 40, generator=torch.Generator().manual_seed(1)
                        ).to(cuda_device)
        m, opt = build(0)
        step(m, opt, x)
        step(m, opt, x)
        opt.state_dict(str(tmp_path / "opt"), step=2)
        m2, opt2 = build(7)
        if stage < 3:
            with torch.no_grad():
                for a, b in zip(m2.parameters(), m.parameters()):
                    a.copy_(b)
        opt2.load_state_dict(str(tmp_path / "opt"))
        for s1, s2 in zip(opt.shards, opt2.shards):
            a, b = opt.optimizer.state[s1], opt2.optimizer.state[s2]
            assert sorted(a) == sorted(b)
            for k in a:
                assert b[k].device == a[k].device and b[k].dtype == a[k].dtype
                assert torch.equal(a[k], b[k]), k
            assert s2.is_cuda and (stage < 3 or torch.equal(s1, s2))
        step(m, opt, x)
        step(m2, opt2, x)
        for a, b in zip(params(m, opt), params(m2, opt2)):
            assert torch.equal(a, b)
    finally:
        hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_loader_pinned_ring(cuda_device, prefetch):
    """DataLoader(device="cuda"): batches arrive on the card equal, bit for
    bit, to the host rows the sampler selects, also when the side stream's
    copies are held back while the producer gathers the next batches into
    the ring's pinned slots (depth 1: two slots)."""
    from horovod_tpu_torch.data import (ArraySource, DataLoader,
                                        ShardedIndexSampler)
    x = np.random.default_rng(0).integers(0, 8192, (64, 513),
                                          dtype=np.int32)
    loader = DataLoader(ArraySource(x), 4, seed=3, prefetch=prefetch,
                        queue_depth=1, device=cuda_device)
    want = [x[i] for i in ShardedIndexSampler(64, 4, seed=3)]
    got = []
    for i, batch in enumerate(loader):
        if i == 0:
            # Hold the copies back: the producer now fills the other slot
            # and must wait for this one's copy before it writes it again.
            with torch.cuda.stream(loader._feed._stream):
                torch.cuda._sleep(200_000_000)
        assert batch.is_cuda and batch.dtype == torch.int32
        got.append(batch)
    loader.close()
    torch.cuda.synchronize()
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), torch.from_numpy(b))


@pytest.mark.cuda
def test_cuda_loader_defaults_to_the_card(cuda_device):
    """DataLoader without device: the batches arrive on the current CUDA
    device, equal to the host rows the sampler selects."""
    from horovod_tpu_torch.data import (ArraySource, DataLoader,
                                        ShardedIndexSampler)
    x = np.random.default_rng(1).integers(0, 8192, (32, 65), dtype=np.int32)
    with torch.cuda.device(cuda_device):
        loader = DataLoader(ArraySource(x), 4, seed=5)
        got = list(loader)
        loader.close()
    want = [x[i] for i in ShardedIndexSampler(32, 4, seed=5)]
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.is_cuda and a.device.index == torch.cuda.current_device()
        assert torch.equal(a.cpu(), torch.from_numpy(b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_one_process_ring_of_4_matches_one_kernel_call(cuda_device,
                                                            causal):
    """Four members' (1, 128, 4, 64) bf16 shards walk the ring in one
    process (the rotation a shift of the list): 16 launches of each kernel
    (4 members x 4 steps), and the joined output and dq/dk/dv match one
    flash_attention call over the whole 512 rows at the kernels'
    tolerances."""
    from horovod_tpu_torch.parallel import ring_attention as ra
    g = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((1, 512, 4, 64), generator=g).to(
        cuda_device, torch.bfloat16) for _ in range(4))
    split = lambda t: [s.detach().clone().requires_grad_()  # noqa: E731
                       for s in t.split(128, dim=1)]
    qs, ks, vs = split(q), split(k), split(v)
    fa.reset_launches()
    outs = ra._ring_attention_shards(qs, ks, vs, causal=causal)
    torch.autograd.backward(outs, list(do.split(128, dim=1)))
    torch.cuda.synchronize()
    assert fa.launches == {n: 16 for n in fa.launches}
    qf, kf, vf = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qf, kf, vf, causal=causal)
    out.backward(do)
    assert_matches(torch.cat(outs, dim=1).detach(), out.detach(),
                   atol=2e-2, rtol=1e-3)
    for mine, whole in ((qs, qf), (ks, kf), (vs, vf)):
        assert_matches(torch.cat([s.grad for s in mine], dim=1), whole.grad,
                       atol=5e-2, rtol=1e-2)


@pytest.mark.cuda
def test_cuda_gspmd_stage3_step_matches_the_flat_plane(cuda_device):
    """make_zero_train_step at stage 3 on a small bf16 transformer, world 1
    on NCCL: three steps' losses and the parameters after them equal
    ZeroShardedOptimizer's stage 3 within rtol 1e-5, atol 1e-6, and every
    flash kernel launches once per layer per step."""
    import functools
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import gspmd
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=256, n_heads=4,
                                d_ff=512, n_layers=2, seq_len=256,
                                remat=False)
    par = tfm.ParallelConfig()
    adamw = functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=1e-4)
    hvd.init()
    try:
        tokens, labels = tfm.synthetic_batch(cfg, 2)
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.ZeroShardedOptimizer(model, adamw, stage=3)
        step = tfm.make_train_step(cfg, par, model, opt)
        flat = [step(tokens, labels).item() for _ in range(3)]
        with torch.no_grad():
            flat_params = {n: t.clone()
                           for n, t in opt.gather_params().items()}

        model = tfm.Transformer(cfg, par, seed=0)

        def loss_fn(params, batch):
            return torch.func.functional_call(model, params, batch)

        fns = gspmd.make_zero_train_step(loss_fn, adamw, hvd.mesh(),
                                         stage=3)
        p, s = fns.init(dict(model.named_parameters()))
        fa.reset_launches()
        losses = []
        for _ in range(3):
            p, s, loss = fns.step(p, s, (tokens, labels))
            losses.append(loss.item())
        assert all(n == 3 * cfg.n_layers for n in fa.launches.values())
        assert losses[-1] < losses[0]
        torch.testing.assert_close(torch.tensor(losses), torch.tensor(flat),
                                   rtol=1e-5, atol=0)
        for n, t in p.items():
            torch.testing.assert_close(t.full_tensor(), flat_params[n],
                                       rtol=1e-5, atol=1e-6)
        assert gspmd.residency_report((p, s), hvd.mesh())[
            "ratio_to_ideal"] == 1.0
    finally:
        hvd.shutdown()


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.cuda
def test_cuda_negotiated_executor_orders_after_a_side_stream(cuda_device,
                                                             monkeypatch):
    """The native controller's device executor on CUDA tensors at world 1
    on NCCL: tensors made on a side stream and submitted there (no
    synchronize between the producers and the submit) come back right on
    that stream, fused in one response, equal to the tensors themselves
    (the sum over one rank; Average divides by 1)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR", f"127.0.0.1:{_free_port()}")
    hvd.init(use_controller=True)
    try:
        ctl = global_state.controller
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            a = torch.randn(2048, 2048, device=cuda_device)
            xs = [a @ a + i for i in range(4)]     # long producers
            hs = [hvd.allreduce_async(x, op=hvd.Sum, name=f"side.{i}")
                  for i, x in enumerate(xs)]
            outs = [hvd.synchronize(h) for h in hs]
            same = [torch.equal(o, x) for o, x in zip(outs, xs)]
            avg = hvd.allreduce(xs[0], name="side.avg")
            same.append(torch.equal(avg, xs[0]))
        assert all(same), same
        assert ctl.stats()["names"] == 5
        assert max(ctl.stats()["names_per_response"]) > 1
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_cuda_serving_prefill_runs_flash_fwd(cuda_device, monkeypatch):
    """The serving prefill on the card: one flash_fwd launch a layer and
    no backward launch; its last-position logits against the same call on
    the plain attention (HVD_TPU_FLASH=0) normwise within 1e-2, argmax
    equal where the top-2 margin exceeds 1e-2; the pages written equal."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                                d_ff=256, n_layers=2, seq_len=128,
                                dtype=torch.bfloat16, remat=False)
    model = tfm.Transformer(cfg, seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 512, (96,), generator=g).to(cuda_device)
    rows = torch.arange(1, 7, device=cuda_device)

    def run():
        kv = tfm.init_kv_pages(cfg, 8, 16, device=cuda_device)
        logits, kv = tfm.prefill(cfg, model, tokens, 90, kv, rows)
        return logits, kv

    before = dict(fa.launches)
    logits, kv = run()
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + cfg.n_layers
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"]
    assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"]
    monkeypatch.setenv("HVD_TPU_FLASH", "0")
    plain, kv_p = run()
    diff = (logits - plain).norm() / plain.norm()
    assert diff <= 1e-2, diff
    top2 = plain.topk(2).values
    if (top2[0] - top2[1]).item() > 1e-2:
        assert logits.argmax() == plain.argmax()
    # Layer 0's K/V precede any attention: equal bit for bit.
    assert torch.equal(kv["k"][0], kv_p["k"][0])
    assert not kv["k"][:, 0].any()              # scratch page untouched


@pytest.mark.cuda
def test_cuda_fp32_flagship_forward_takes_the_plain_path(cuda_device,
                                                         monkeypatch):
    """An fp32 flagship forward on the card with no HVD_TPU_FLASH set:
    the kernels cannot take fp32, so auto mode takes the plain attention
    (no kernel launch) and the logits equal the HVD_TPU_FLASH=0 run's;
    HVD_TPU_FLASH=1 still forces the kernel, which refuses fp32."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=512, d_model=128, n_heads=2,
                                d_ff=256, n_layers=2, seq_len=128,
                                dtype=torch.float32, remat=False)
    model = tfm.Transformer(cfg, seed=0, device=cuda_device)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 512, (2, 128), generator=g).to(cuda_device)
    monkeypatch.delenv("HVD_TPU_FLASH", raising=False)
    before = dict(fa.launches)
    with torch.no_grad():
        logits = tfm.serial_forward_logits(cfg, model, tokens)
    torch.cuda.synchronize()
    assert fa.launches == before
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    monkeypatch.setenv("HVD_TPU_FLASH", "0")
    with torch.no_grad():
        plain = tfm.serial_forward_logits(cfg, model, tokens)
    assert torch.equal(logits, plain)
    monkeypatch.setenv("HVD_TPU_FLASH", "1")
    with pytest.raises(TypeError, match="bfloat16"):
        with torch.no_grad():
            tfm.serial_forward_logits(cfg, model, tokens)


@pytest.mark.cuda
def test_cuda_allreduce_latency_is_device_time(cuda_device):
    """An NCCL collective returns once it is enqueued: its latency in
    hvd_collective_latency_seconds comes from CUDA events around it, and
    is observed only once they have completed.  The in-place allreduce
    puts nothing of the port's own in the timed range, but at world 1
    NCCL moves no bytes for it; the known-size transfer is an allgather,
    which NCCL serves at world 1 with a device-to-device copy of the
    input, so its latency reads at least half a copy of the same bytes
    timed by the same kind of events."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.metrics.attribution import attribution
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.ops import collective as C
    hvd.init()
    try:
        x = torch.randn(64 << 20, device=cuda_device)   # 256 MiB
        y = torch.empty_like(x)
        hvd.allreduce_(x, op=hvd.Sum)
        hvd.allgather(x)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        y.copy_(x)
        e.record()
        e.synchronize()
        copy_s = s.elapsed_time(e) / 1e3
        C.drain_device_latency()                # earlier ops' pairs
        lat = {}
        for kind, call in (("allreduce", lambda: hvd.allreduce_(x, op=hvd.Sum)),
                           ("allgather", lambda: hvd.allgather(x))):
            hist = registry().histogram("hvd_collective_latency_seconds",
                                        kind=kind)
            n0, sum0 = hist.count, hist.sum
            call()
            assert C._pending                   # not observed yet
            torch.cuda.synchronize()
            attribution()._read_sources()       # drains completed pairs
            assert not C._pending and hist.count == n0 + 1
            lat[kind] = hist.sum - sum0
        assert lat["allreduce"] > 0
        assert lat["allgather"] >= 0.5 * copy_s, (lat, copy_s)
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_cuda_compute_span_waits_for_the_device(cuda_device):
    """compute_span synchronises the current stream before it closes, so
    it reads at least the CUDA-event time of the queued matmul chain."""
    from horovod_tpu_torch.metrics.attribution import StepAttribution
    from horovod_tpu_torch.metrics.registry import MetricsRegistry
    a = torch.randn(4096, 4096, device=cuda_device)
    (a @ a).sum().item()
    eng = StepAttribution(MetricsRegistry())
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with eng.compute_span():
        s.record()
        b = a
        for _ in range(20):
            b = b @ a
        e.record()
    device_s = s.elapsed_time(e) / 1e3
    assert eng._compute_total >= device_s > 0


@pytest.mark.cuda
def test_cuda_bert_noncausal_kernels_match_plain(cuda_device, monkeypatch):
    """A small bf16 BERT through the three kernels with causal=False, one
    launch of each a layer, against the plain attention on the same
    weights and batch (the flagship step's bars: loss 1e-3, gradients
    2e-2 normwise)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert
    hvd.init()
    try:
        cfg = bert.BertConfig(vocab_size=512, d_model=256, n_heads=4,
                              d_ff=512, n_layers=2, seq_len=256,
                              remat=False)
        mesh = hvd.parallel.create_mesh({"dp": 1, "mp": 1})
        model = bert.Bert(cfg, seed=0, mesh=mesh)
        batch = bert.synthetic_mlm_batch(cfg, 4)
        loss_of = bert.make_loss_fn(cfg, mesh, gathered=True)

        def run():
            model.zero_grad(set_to_none=True)
            loss = loss_of(model, *batch)
            loss.backward()
            return loss.item(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()}

        fa.reset_launches()
        k_loss, k_grads = run()
        assert dict(fa.launches) == dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), cfg.n_layers)
        monkeypatch.setenv("HVD_TPU_FLASH", "0")
        p_loss, p_grads = run()
    finally:
        hvd.shutdown()
    assert abs(k_loss - p_loss) <= 1e-3
    for n, g in p_grads.items():
        rel = ((k_grads[n] - g).float().norm() / g.float().norm()).item()
        assert rel <= 2e-2, (n, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quantized_wire_gradient_equals_cpu(cuda_device, bits):
    """The quantized all-to-all at world 1: forward bit-equal to the CPU's
    and, with integer cotangents (each block's sum of g * q exact), the
    gradient too; it is non-zero only at the blocks' absmax elements."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import xla_collectives as XC
    hvd.init()
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        gen = torch.Generator().manual_seed(bits)
        v = torch.randn((1, 4, 64, 256), generator=gen)
        ct = torch.randint(-3, 4, v.shape, generator=gen).float()
        got = {}
        for dev, group in ((cuda_device, None), ("cpu", cpu_group)):
            t = v.to(dev, copy=True).requires_grad_()
            out = XC.all_to_all_wire(t, group, Q.QuantSpec(bits, 256))
            (out * ct.to(dev)).sum().backward()
            got[str(dev)] = (out.detach().cpu(), t.grad.cpu())
    finally:
        hvd.shutdown()
    (o_d, g_d), (o_c, g_c) = got[str(cuda_device)], got["cpu"]
    assert torch.equal(o_d, o_c) and torch.equal(g_d, g_c)
    assert int((g_c != 0).sum()) <= v.numel() // 256 * 2


def _elastic_round(kv, rnd, added_only):
    """Publish round ``rnd`` with this process as its only slot."""
    import json
    import socket

    def port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    if rnd > 0:
        kv.put("elastic", "host_event", json.dumps(
            {"ts": float(rnd), "added_only": added_only,
             "round": rnd}).encode())
    kv.put("elastic", f"round.{rnd}", json.dumps({
        "round": rnd, "size": 1,
        "controller_addr": f"127.0.0.1:{port()}",
        "store_addr": f"127.0.0.1:{port()}",
        "slots": {"localhost:0": {"rank": 0, "size": 1, "local_rank": 0,
                                  "local_size": 1, "cross_rank": 0,
                                  "cross_size": 1}}}).encode())
    kv.put("elastic", "current_round", str(rnd).encode())


@pytest.mark.cuda
@pytest.mark.parametrize("failed", [False, True])
def test_cuda_elastic_init_and_reset_in_one_process(cuda_device,
                                                    monkeypatch, failed):
    """init() under an elastic assignment on the card: the round's rank,
    NCCL on cuda:0, the native controller at the round's address and the
    world watch.  Then the reset in the same process: a round published
    for a growth (the world stays healthy) or after a failure (the watch
    marks the world and aborts its NCCL communicator, which shutdown()
    then tears down without a clean destroy); init() joins the next
    round on the same card and its collectives run."""
    import time
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import failure
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.elastic import state as es
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    kv = RendezvousServer(host="127.0.0.1")
    kv.start()
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", f"127.0.0.1:{kv.port}")
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "localhost:0")
    monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR", "elastic")
    monkeypatch.setattr(global_state, "elastic_round", -1)
    _elastic_round(kv, 0, False)
    try:
        hvd.init()
        assert (hvd.rank(), hvd.size(), global_state.elastic_round) == \
            (0, 1, 0)
        assert hvd.device() == torch.device("cuda", 0)
        assert global_state.controller is not None and failure.watching()
        x = torch.ones(1024, device=cuda_device)
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum, name="r0"), x)
        _elastic_round(kv, 1, added_only=not failed)
        time.sleep(10 * failure.WATCH_INTERVAL_S)
        assert (failure.failed() is not None) == failed
        if failed:
            with pytest.raises(hvd.HorovodInternalError):
                hvd.allreduce(x, op=hvd.Sum, name="r0.after")
        t0 = time.perf_counter()
        es._reset()
        reset_s = time.perf_counter() - t0
        assert global_state.elastic_round == 1 and failure.failed() is None
        assert hvd.device() == torch.device("cuda", 0)
        y = torch.full((1024,), 2.0, device=cuda_device)
        assert torch.equal(hvd.allreduce(y, op=hvd.Sum, name="r1"), y)
        assert reset_s < 30, reset_s
    finally:
        hvd.shutdown()
        kv.stop()


@pytest.mark.cuda
def test_cuda_elastic_commit_refuses_an_aborted_communicator(cuda_device,
                                                            monkeypatch):
    """NCCL's watchdog aborts a collective that outlives the operation
    deadline without raising in the caller and without marking the
    world.  ``TpuState.commit()`` then checks the world after its copies
    to the host: the aborted communicator refuses the check, the commit
    raises ``HorovodInternalError`` and writes nothing, and the restore
    is the previous commit."""
    import functools
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.core import failure
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    kv = RendezvousServer(host="127.0.0.1")
    kv.start()
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", f"127.0.0.1:{kv.port}")
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "localhost:0")
    monkeypatch.setattr(global_state, "elastic_round", -1)
    _elastic_round(kv, 0, False)
    try:
        hvd.init()
        assert failure.watching()
        torch.manual_seed(0)
        model = torch.nn.Linear(64, 64).to(cuda_device)
        opt = hvd.ZeroShardedOptimizer(model, functools.partial(
            torch.optim.AdamW, lr=1e-2), stage=2)
        counter = torch.zeros((), dtype=torch.int64)
        state = elastic.TpuState(
            opt_state={"model": model.state_dict(), "opt": opt,
                       "step": counter}, peer_recovery=False)

        def step():
            x = torch.randn(8, 64, device=cuda_device)
            model(x).square().mean().backward()
            opt.reduce_grads()
            opt.step()
            opt.zero_grad()
            counter.add_(1)

        step()
        state.commit()
        kept = {k: v.clone() for k, v in model.state_dict().items()}
        step()
        failure.abort_groups()   # as the watchdog does: no mark
        assert failure.failed() is None
        with pytest.raises(hvd.HorovodInternalError):
            state.commit()
        assert failure.failed() is not None
        state.restore()
        assert int(counter) == 1
        for k, v in model.state_dict().items():
            assert torch.equal(v, kept[k]), k
    finally:
        hvd.shutdown()
        kv.stop()


@pytest.mark.cuda
def test_cuda_elastic_watch_fails_a_stream_past_the_deadline(cuda_device,
                                                            monkeypatch):
    """On the card: a beacon behind work that outlives the operation
    deadline (a spin kernel, standing in for a collective that a peer
    hung alive holds) fails the world within a watch poll of the
    deadline, and the next collective raises ``HorovodInternalError``."""
    import time
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import failure
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    kv = RendezvousServer(host="127.0.0.1")
    kv.start()
    monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", f"127.0.0.1:{kv.port}")
    monkeypatch.setenv("HVD_TPU_ELASTIC_SLOT", "localhost:0")
    monkeypatch.setenv("HVD_TPU_NET_OP_DEADLINE_S", "1")
    monkeypatch.setattr(global_state, "elastic_round", -1)
    _elastic_round(kv, 0, False)
    try:
        hvd.init()
        assert failure.watching()
        torch.cuda._sleep(int(8e9))   # 4 s or more at the H100's clock
        failure.beacon()
        t0 = time.monotonic()
        while failure.failed() is None and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert failure.failed() is not None
        assert 0.9 <= time.monotonic() - t0 < 1.5
        assert "deadline" in failure.failed()
        with pytest.raises(hvd.HorovodInternalError):
            hvd.allreduce(torch.ones(8, device=cuda_device), name="late")
        torch.cuda.synchronize()
    finally:
        hvd.shutdown()
        kv.stop()


@pytest.mark.cuda
def test_cuda_partitioned_slot_takes_its_first_card(cuda_device, tmp_path):
    """A launched slot whose plan gave it one card (local rank 1 of 2, so
    ``cuda:local_rank`` names no card it sees) computes on ``cuda:0``,
    with NCCL.  Its env is what a two-card host's plan gives slot 1,
    with this machine's card standing in for that host's card 1."""
    from horovod_tpu_torch.runner import chips
    env = chips.plan_host_platform(2, chips=2,
                                   partitionable=True).slot_env(1, 2)
    assert env["CUDA_VISIBLE_DEVICES"] == "1"
    env["CUDA_VISIBLE_DEVICES"] = "0"
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        import horovod_tpu_torch as hvd
        hvd.init()
        assert torch.cuda.device_count() == 1
        assert hvd.device() == torch.device("cuda", 0), hvd.device()
        assert dist.get_backend() == "nccl"
        x = hvd.allreduce(torch.ones(4, device="cuda"), op=hvd.Sum)
        assert x.device == torch.device("cuda", 0) and x.sum().item() == 4
        hvd.shutdown()
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=180, cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        env=dict(os.environ, HVD_TPU_RANK="0", HVD_TPU_SIZE="1",
                 HVD_TPU_LOCAL_RANK="1", HVD_TPU_LOCAL_SIZE="2", **env))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.cuda
def test_cuda_tuner_window_closes_on_device_complete_work(cuda_device,
                                                          monkeypatch):
    """The negotiated plane's collectives return once they are queued on
    the card; a tuner window closes only after the executor's last
    completion event: every response it counted has completed at its
    close, and its host seconds are at least the CUDA-event span of its
    responses (first start to last completion).  Each allreduce's input
    waits on ~10 ms of device sleep, far longer than an op's host round
    trip, so a window closed on the host's clock alone fails both."""
    import importlib.util
    import socket
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"HVD_TPU_AUTOTUNE": "1",
                 "HVD_TPU_AUTOTUNE_WARMUP_SAMPLES": "0",
                 "HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE": "4",
                 "HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "50",
                 "HVD_TPU_COMPRESSION": "none",
                 "HVD_TPU_CONTROLLER_ADDR": f"127.0.0.1:{port}"}.items():
        monkeypatch.setenv(k, v)
    hvd.init(use_controller=True)
    try:
        windows = smoke.record_windows(torch, hvd, global_state.controller)
        x = torch.randn(1 << 20, device=cuda_device)
        for i in range(12):
            torch.cuda._sleep(20_000_000)
            hvd.allreduce(x, op=hvd.Sum, name=f"w.{i % 2}")
        torch.cuda.synchronize()
        windows = windows()
    finally:
        hvd.shutdown()
    assert len(windows) == 3
    for seconds, span, n, complete in windows:
        assert n == 4 and complete, windows
        assert seconds >= span > 0.03, windows


class _LateGrad(torch.autograd.Function):
    """Identity forward; the backward queues ~25 ms of device sleep
    before it writes 3 x the upstream gradient, so a collective that does
    not wait on the producing stream reads the gradient before it is
    written."""

    @staticmethod
    def forward(ctx, p):
        return p.clone()

    @staticmethod
    def backward(ctx, g):
        torch.cuda._sleep(50_000_000)
        return g * 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("controller", [False, True])
def test_cuda_frontend_hooks_wait_for_the_last_gradient(cuda_device,
                                                       monkeypatch,
                                                       controller):
    """horovod_tpu_torch.torch's DistributedOptimizer on the card, on a
    side stream: each hook fires its allreduce (op=Sum, so world 1 still
    runs a collective: NCCL, or the device plane under the controller)
    while the last gradient's producer still sleeps; the reduced
    gradients equal the local ones."""
    import horovod_tpu_torch.torch as fe
    if controller:
        monkeypatch.setenv("HVD_TPU_CONTROLLER_ADDR",
                           f"127.0.0.1:{_free_port()}")
    fe.init(use_controller=controller)
    try:
        torch.manual_seed(0)
        w = torch.nn.Parameter(torch.randn(1024, 1024, device=cuda_device))
        b = torch.nn.Parameter(torch.randn(1024, device=cuda_device))
        opt = fe.DistributedOptimizer(
            torch.optim.SGD([w, b], lr=0.0), op=fe.Sum,
            named_parameters=[("w", w), ("b", b)])
        x = torch.randn(64, 1024, device=cuda_device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            y = x @ w + _LateGrad.apply(b)
            ct = torch.randn_like(y)
            (y * ct).sum().backward()
            opt.synchronize()
            got = [w.grad.clone(), b.grad.clone()]
        torch.cuda.synchronize()
        want = [x.t() @ ct, 3.0 * ct.sum(0)]
        for g, e in zip(got, want):
            torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-3)
    finally:
        fe.shutdown()


@pytest.mark.cuda
def test_cuda_frontend_sparse_and_sync_batch_norm(cuda_device):
    """On the card: sparse_allreduce of an nn.Embedding(sparse=True)
    gradient against the dense allreduce, the optimizer's sparse path
    against sparse_as_dense, SyncBatchNorm against nn.BatchNorm2d bit
    for bit, and a CPU tensor refused by the NCCL world."""
    import horovod_tpu_torch.torch as fe
    fe.init()
    try:
        torch.manual_seed(1)
        emb = torch.nn.Embedding(1000, 64, sparse=True).to(cuda_device)
        idx = torch.randint(0, 1000, (16, 32), device=cuda_device)
        (emb(idx) ** 2).sum().backward()
        got = fe.sparse_allreduce(emb.weight.grad).to_dense()
        want = fe.allreduce(emb.weight.grad.to_dense())
        assert got.is_cuda
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        params = []
        for dense in (False, True):
            e = torch.nn.Embedding(1000, 64, sparse=True).to(cuda_device)
            with torch.no_grad():
                e.weight.copy_(emb.weight)
            opt = fe.DistributedOptimizer(
                torch.optim.SGD(e.parameters(), lr=0.1),
                named_parameters=e.named_parameters(),
                sparse_as_dense=dense)
            (e(idx) ** 2).sum().backward()
            opt.step()
            params.append(e.weight.detach())
        torch.testing.assert_close(params[0], params[1], rtol=1e-6,
                                   atol=1e-6)
        x = torch.randn(4, 16, 8, 8, device=cuda_device)
        outs = []
        for make in (torch.nn.BatchNorm2d, fe.SyncBatchNorm):
            torch.manual_seed(2)
            bn = make(16).to(cuda_device)
            xi = x.clone().requires_grad_()
            y = bn(xi)
            y.square().sum().backward()
            outs.append((y, xi.grad, bn.weight.grad, bn.running_var))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="move it there first"):
            fe.allreduce(torch.ones(3))
    finally:
        fe.shutdown()


@pytest.mark.cuda
def test_cuda_torch_estimator_holds_its_batches_on_the_card(cuda_device,
                                                            tmp_path):
    """TorchEstimator with no device fits on cuda:0: the model moves to
    the card, every batch the model sees and the validation batch are
    CUDA tensors, the checkpoint holds host copies of the fitted weights,
    and transform returns host numpy equal to the model's output."""
    import pandas as pd
    import horovod_tpu_torch.spark as spark
    from horovod_tpu_torch.core import basics

    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.lin = torch.nn.Linear(3, 1)

        def forward(self, x):
            seen.append(x.device)
            return self.lin(x)

    rng = np.random.RandomState(0)
    x = rng.randn(40, 3).astype(np.float32)
    df = pd.DataFrame({"features": [r.tolist() for r in x],
                       "label": x.sum(1).astype(np.float32)})
    try:
        est = spark.TorchEstimator(
            model=Probe(), lr=0.1, epochs=1, batch_size=8, validation=0.2,
            store=spark.LocalStore(str(tmp_path)), verbose=0,
            feature_cols=["features"], label_cols=["label"])
        fitted = est.fit(df)
        assert basics.device().type == "cuda"
    finally:
        basics.shutdown()
    assert len(seen) == 4 + 1 and all(d.type == "cuda" for d in seen), seen
    assert all(p.is_cuda for p in fitted.model.parameters())
    assert np.isfinite(fitted.validation_loss)
    import io
    state = torch.load(io.BytesIO(est.store.load_checkpoint(est.run_id)),
                       weights_only=True)
    for k, v in fitted.model.state_dict().items():
        assert state[k].device.type == "cpu"
        assert torch.equal(state[k], v.cpu())
    out = fitted.transform(df)
    with torch.no_grad():
        want = fitted.model(torch.from_numpy(x).cuda()).cpu().numpy()[:, 0]
    np.testing.assert_array_equal(out["label__output"].values, want)
