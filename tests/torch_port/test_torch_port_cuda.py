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
gathers are in flight."""

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
                                d_ff=512, n_layers=2, seq_len=256)
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
                                d_ff=512, n_layers=2, seq_len=256)
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
