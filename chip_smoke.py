#!/usr/bin/env python3
"""Smoke test of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. card    — the card's name and power limit, as nvidia-smi reports them;
2. build   — nvcc builds the flash-attention kernels from
             horovod_tpu_torch/csrc/ for sm_90a (timed);
3. kernels — each kernel against its plain PyTorch version on the card, in
             bf16, at small cases (ragged lengths off the 128-row tiles,
             Sq != Sk with offsets, fully masked rows, causal and not,
             B*H above the SM count, head_dim 32/64/128, strided q/k/v
             slices of a fused qkv) and at the flagship training shape,
             elementwise and normwise (and dQ's δ = rowsum(dO∘O) against
             the plain δ); then each kernel,
             its plain version and the library call (PyTorch's
             scaled_dot_product_attention forward; its flash-attention
             backward, dQ+dK+dV in one call) timed on the device (CUDA
             graph replays between CUDA events) at the flagship shape
             (8, 512, 8, 64) and at long context (1, 8192, 16, 64);
4. train   — init() on CUDA (NCCL, world 1), the flagship transformer
             (vocab 8192, d_model 512, 8 heads, d_ff 2048, 8 layers,
             seq 512, bf16, batch 8) from the port's seeded init,
             broadcast_parameters, DistributedOptimizer(AdamW), 10 steps on
             one synthetic batch.  Before the steps, the loss and every
             parameter's gradient through the kernels must match the plain
             attention path's (HVD_TPU_FLASH=0) on the same weights and
             batch.  Losses must be finite and fall, and every kernel must
             launch once per layer per step;
5. compressed — the same training, world 1 on NCCL, with
             DistributedOptimizer(AdamW, compression=wire) for each wire
             (fp16, bf16, int8, int4), a fresh model from seed 0 and 10
             steps each.  Step 0's synchronised gradients must equal, bit
             for bit, the CPU's two-pass schedule (quantize or cast twice)
             applied to its local gradients; each pass must move the
             compressed bytes (sum of wire_bytes over the parameters,
             recorded at dist.all_to_all_single and
             dist.all_gather_into_tensor) and no fp32 payload; int8/int4
             leave an error-feedback residual within half a block scale,
             equal bit for bit to the CPU's g - qdq(g);
             losses finite, falling, step 0 equal to phase 4's; every
             kernel once per layer per step.  Also times quantize +
             dequantize of w1's gradient (8,388,608 fp32) against its byte
             bound;
6. collectives — allgather, alltoall with splits, reducescatter (plain,
             int8, bf16), barrier, join, the async handles and the object
             collectives on CUDA tensors at world 1 over NCCL;
7. overlap, ZeRO, Adasum — the flagship's training, world 1 on NCCL,
             AdamW(3e-4, wd 1e-4), 10 steps a configuration:
             DistributedOptimizer(overlap=True) on the none and int8 wires
             beside the per-parameter schedule (the bucket plan at 8 MiB,
             6 bucket collectives a step counted at the torch.distributed
             call against 9, step 0's synchronised gradients and int8
             residuals bit-equal to the per-parameter schedule's on the
             same local gradients, losses against the per-parameter run);
             ZeroShardedOptimizer at stages 1, 2 and 3 and stage 1 on int8
             (parameters after step 0 within rtol 1e-5, atol 1e-6 of the
             replicated step on the same wire; peak memory allocated of
             each run); DistributedOptimizer(op=Adasum) (the delta
             model p0 + (p' - p0) within 1.5 eps max(|p0|, |p'|) of the
             inner step's p'); every configuration's
             losses finite and falling and every kernel launched once per
             layer per step.  Then adasum_tree of a (4, 8,388,608) fp32
             stack and one sync_batch_norm forward and backward on the card
             against the CPU (1e-6 and 1e-5 normwise).  Per-step host time
             and collective calls of each configuration are reported;
8. checkpoint — the flagship's ZeRO training (AdamW(3e-4, wd 1e-4),
             world 1 on NCCL) fed by DataLoader(batch 8, shuffle, seed 0,
             prefetch, depth 2, device="cuda") over 256 seeded sequences
             of 513 int32 tokens: the first 8 batches on the card equal the
             sampler's host rows bit for bit.  At stage 1, stage 3 and
             stage 1 on int8: two uninterrupted 8-step runs (their spread,
             if any, is printed), and a run that saves at step 4
             (state_dict with the loader's state in the manifest; the
             parameters through utils.save_checkpoint at stage 1), then
             restores into a model, optimizer and loader built from seed 1
             and takes 4 more steps: its losses, final parameters, moments
             and residuals equal the uninterrupted run's bit for bit (or
             within that spread), and every kernel launches once per layer
             per step.  Bytes a save, save and restore seconds, and the
             host step fed by the loader against one fixed batch are
             reported.  Last, Adasum at backward_passes_per_step 2 against
             Average at world 1 (within 1.5 eps max(|p0|, |p'|));
9. gspmd   — the flagship through gspmd.make_zero_train_step on
             hvd.mesh() (world 1 on NCCL, AdamW(3e-4, wd 1e-4), 10 steps)
             at stages 1, 2, 3 and stage 2 on int8, each beside the flat
             ZeroShardedOptimizer in turns (flat, gspmd, gspmd, flat): losses
             within rtol 1e-5 of the flat plane's (and of phase 7's run
             where it has the configuration), host step, peak memory,
             collectives a step, residency_report (ratio 1.0 at world 1),
             every kernel once per layer per step; int8's
             plan_allreduce_step bytes equal two of phase 5's measured
             passes;
10. sequence — ring_attention and ulysses_attention at world 1 on NCCL,
             (8, 512, 8, 64) causal, equal to full_attention bit for bit
             (out, dq, dk, dv); then a ring of 4 through the one-process
             seam (ring_attention._ring_attention_shards) at
             (1, 8192, 16, 64), causal and not, against one kernel call
             over the whole sequence (out and lse, dq/dk/dv, the kernels'
             tolerances): 16 launches of each kernel, the launches on
             fully masked blocks, the walk's device time against the one
             call's (CUDA-graph replays), combine_blocks', and one fully
             masked launch's against an unmasked one's.

The last lines are the card line, a JSON line with one entry per kernel
(``launches`` on the main path of phase 4, ``launches_by_path`` on every
path, each counted from 0 just before it ran), and
``{"ok": true, "device": {...}}``.  Detailed numbers also go to
chiprun_out/chip_smoke.json.  Without a CUDA device it exits non-zero and
prints no result.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Parity tolerances against the plain version (bf16 inputs).  out and the
# gradients as the reference's own kernel tests hold them
# (tests/test_flash_attention.py); lse is fp32 on both sides and differs
# only by the fast exp and the summation order.
TOL_OUT = dict(atol=2e-2, rtol=1e-3)
TOL_LSE = dict(atol=2e-3, rtol=1e-4)
TOL_GRAD = dict(atol=5e-2, rtol=1e-2)
# dQ's δ: fp32 sums of products of bf16 values, exact in fp32 on both
# sides, so only the summation order differs.
TOL_DELTA = dict(atol=1e-3, rtol=1e-4)
# Those atol are near a typical element of the gradients at the flagship
# shape, so each output is also held normwise: ||kernel - plain|| / ||plain||
# (bf16 rounding of the outputs and of P, dS is ~2e-3 of that).
TOL_REL = 1e-2
# Step-0 loss and per-parameter gradients of the bf16 model, kernels vs the
# plain attention path (HVD_TPU_FLASH=0) on the same weights and batch; the
# gradients normwise, as above.
TOL_LOSS = 1e-3
TOL_MODEL_GRAD_REL = 2e-2

# Phase 5: the compressed wires, and the flagship's 9 parameter tensors'
# elements (the wire-byte table is per this count at block 256).
WIRES = ("fp16", "bf16", "int8", "int4")
CAST_DTYPES = ("float16", "bfloat16")
QUANT_BLOCK = 256
W1_GRAD_ELEMS = 8 * 512 * 2048

# Phase 7: the flagship's buckets at the default 8 MiB, in backward order
# of its parameters (``nn.ParameterDict`` orders the layer tensors by
# name), by name; ZeRO's bar (the reference's tests/test_zero_stages.py);
# the normwise bars of the Adasum combine and sync batch norm, card vs CPU.
FLAGSHIP_BUCKETS = [["layers.wqkv"], ["layers.wo"], ["layers.w2"],
                    ["layers.w1"],
                    ["layers.ln2", "layers.ln1", "final_norm", "pos"],
                    ["embed"]]
ZERO_TOL = dict(rtol=1e-5, atol=1e-6)
TOL_ADASUM_REL = 1e-6
TOL_SBN_REL = 1e-5

KERNELS = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:97",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:205",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:255",
}
SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def rand_qkv(torch, b, sq, sk, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    mk = lambda s: torch.randn((b, s, h, d), generator=g).to("cuda",
                                                            torch.bfloat16)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def fused_qkv(torch, b, s, h, d, seed):
    """q, k, v as strided slices of one (b, s, h, 3, d) projection, and dO."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, s, h, 3, d), generator=g).to("cuda", torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=g).to("cuda", torch.bfloat16)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], do


def compare(torch, got, ref, tol):
    """Assert ``got`` matches ``ref`` elementwise (``tol``) and normwise
    (``TOL_REL``); returns (max abs err, normwise relative err)."""
    torch.testing.assert_close(got, ref, **tol)
    diff = got.float() - ref.float()
    rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
    assert rel <= TOL_REL, f"normwise relative error {rel} > {TOL_REL}"
    return diff.abs().max().item(), rel


def check_case(torch, fa, q, k, v, do, causal, q_off, kv_off):
    """Each kernel vs its plain version on the same inputs; returns
    {kernel: (max abs err, normwise relative err)}, dK/dV's the larger,
    and dQ's δ under "flash_bwd_dq delta"."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    args = (causal, scale, q_off, kv_off)
    o_k, lse_k = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.attention_with_lse_plain(q, k, v, *args)
    torch.cuda.synchronize()
    errs = {"flash_fwd": compare(torch, o_k, o_p, TOL_OUT)}
    torch.testing.assert_close(lse_k, lse_p, **TOL_LSE)
    dead = lse_p <= -1e29
    assert torch.equal(dead, lse_k <= -1e29), "fully masked rows differ"
    assert not o_k.transpose(1, 2)[dead].any(), "masked rows must be 0"
    dq_k, delta_k = fa.flash_bwd_dq(q, k, v, do, lse_p, o_p, *args)
    dq_p, delta_p = fa.bwd_dq_plain(q, k, v, do, lse_p, o_p, *args)
    # dK/dV on both sides with the plain δ: each kernel against its plain
    # version on the same inputs.
    bargs = (do, lse_p, delta_p) + args
    dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, *bargs)
    dk_p, dv_p = fa.bwd_dkv_plain(q, k, v, *bargs)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = compare(torch, dq_k, dq_p, TOL_GRAD)
    errs["flash_bwd_dq delta"] = compare(torch, delta_k, delta_p, TOL_DELTA)
    dk, dv = (compare(torch, dk_k, dk_p, TOL_GRAD),
              compare(torch, dv_k, dv_p, TOL_GRAD))
    errs["flash_bwd_dkv"] = (max(dk[0], dv[0]), max(dk[1], dv[1]))
    return errs


def fmt_errs(errs):
    return ", ".join(f"{n} max abs {a:.3g} rel {r:.3g}"
                     for n, (a, r) in errs.items())


def time_ms(torch, fn, iters, reps=3):
    """Device time (ms) of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    per-call cost (Python, dispatch, ctypes) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: cuBLAS, caches
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def bounds(b, s, h, d, causal=True):
    """Least time (ms) for each kernel at a (b, s, h, d) self-attention:
    bytes each input read once and each output written once over HBM
    bandwidth, vs the unmasked (q, k) pairs' tensor-core FLOPs over the
    bf16 peak; the larger wins.  dQ reads q, k, v, dO, O and lse and writes
    dQ and δ; dK/dV reads q, k, v, dO, lse and δ and writes dK and dV."""
    act = b * s * h * d * 2          # one bf16 (B, S, H, D) tensor
    row = b * h * s * 4              # one fp32 (B, H, S) row statistic
    pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
    work = {  # (bytes, flops): products of 2*d FLOPs per pair each
        "flash_fwd": (3 * act + act + row, 2 * 2 * d * pairs),
        "flash_bwd_dq": ((5 * act + row) + (act + row), 3 * 2 * d * pairs),
        "flash_bwd_dkv": (4 * act + 2 * row + 2 * act, 4 * 2 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_shape(torch, F, fa, b, s, h, d, iters, plain_iters):
    """Times (ms) of each kernel, its plain version, and the library call:
    SDPA for the forward; for both backward kernels PyTorch's flash-attention
    backward, which computes dQ, dK and dV in one call."""
    q, k, v, do = rand_qkv(torch, b, s, s, h, d, seed=7)
    scale = 1.0 / math.sqrt(d)
    args = (True, scale, 0, 0)
    o, lse = fa.flash_fwd(q, k, v, *args)
    _, delta = fa.flash_bwd_dq(q, k, v, do, lse, o, *args)
    qargs = (do, lse, o) + args
    bargs = (do, lse, delta) + args
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    aten = torch.ops.aten
    lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lfwd = aten._scaled_dot_product_flash_attention(lq, lk, lv, 0.0, True,
                                                    False, scale=scale)

    def library_bwd():
        aten._scaled_dot_product_flash_attention_backward(
            ldo, lq, lk, lv, lfwd[0], lfwd[1], lfwd[2], lfwd[3], lfwd[4],
            lfwd[5], 0.0, True, lfwd[6], lfwd[7], scale=scale)

    library_bwd_ms = time_ms(torch, library_bwd, iters)
    res = {
        "flash_fwd": (
            time_ms(torch, lambda: fa.flash_fwd(q, k, v, *args), iters),
            time_ms(torch, lambda: fa.attention_with_lse_plain(q, k, v, *args),
                    plain_iters),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters)),
        "flash_bwd_dq": (
            time_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, *qargs), iters),
            time_ms(torch, lambda: fa.bwd_dq_plain(q, k, v, *qargs),
                    plain_iters), library_bwd_ms),
        "flash_bwd_dkv": (
            time_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, *bargs), iters),
            time_ms(torch, lambda: fa.bwd_dkv_plain(q, k, v, *bargs),
                    plain_iters), library_bwd_ms),
    }
    # Forward + backward through autograd: the port's attention vs SDPA.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def port_fb():
        fa.flash_attention(qg, kg, vg, causal=True).backward(do)

    def sdpa_fb():
        F.scaled_dot_product_attention(
            qg.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            is_causal=True).backward(do.transpose(1, 2))

    fb = {"port_fwd_bwd_ms": time_ms(torch, port_fb, iters),
          "sdpa_fwd_bwd_ms": time_ms(torch, sdpa_fb, iters),
          "port_bwd_ms": res["flash_bwd_dq"][0] + res["flash_bwd_dkv"][0],
          "library_bwd_ms": library_bwd_ms}
    return res, fb


def record_wire(dist):
    """Wrap the two calls the compressed schedules move bytes with; each
    call appends (call, dtype, bytes this rank sends).  Returns the log and
    a function that restores the calls."""
    log, saved = [], (dist.all_to_all_single, dist.all_gather_into_tensor)

    def a2a(out, inp, *args, **kwargs):
        log.append(("all_to_all_single", inp.dtype,
                    inp.numel() * inp.element_size()))
        return saved[0](out, inp, *args, **kwargs)

    def gather(out, inp, *args, **kwargs):
        log.append(("all_gather_into_tensor", inp.dtype,
                    inp.numel() * inp.element_size()))
        return saved[1](out, inp, *args, **kwargs)

    def restore():
        dist.all_to_all_single, dist.all_gather_into_tensor = saved

    dist.all_to_all_single, dist.all_gather_into_tensor = a2a, gather
    return log, restore


def two_pass_world1(torch, Q, g, wire):
    """What the two-pass schedule gives at world 1, computed on the CPU:
    quantize → dequantize twice (or cast twice), in g's dtype."""
    if wire in ("fp16", "bf16"):
        dt = getattr(torch, CAST_DTYPES[WIRES.index(wire)])
        return g.float().to(dt).float().to(dt).float().to(g.dtype)
    spec = Q.QuantSpec(int(wire[3]), QUANT_BLOCK)
    return Q.qdq(Q.qdq(g.float(), spec), spec).to(g.dtype)


def phase_compressed(torch, hvd, tfm, fa, Q, cfg, par, batch, n_steps,
                     tokens, labels, loss0, card):
    """Phase 5: the flagship's training on each compressed wire."""
    import torch.distributed as dist
    out = {}
    for wire in WIRES:
        model = tfm.Transformer(cfg, par, seed=0)
        params = list(model.parameters())
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            params, lr=3e-4, weight_decay=1e-4), compression=wire)
        step = tfm.make_train_step(cfg, par, model, opt)
        seen, synchronize = {}, opt.synchronize

        def sync_and_record(opt=opt, seen=seen, synchronize=synchronize):
            seen["local"] = [p.grad.detach().cpu().clone() for p in params]
            log, restore = record_wire(dist)
            try:
                synchronize()
            finally:
                restore()
            seen["log"] = log
            seen["synced"] = [p.grad.detach().cpu().clone() for p in params]
            seen["residual"] = None if opt.residual is None else \
                [r.cpu().clone() for r in opt.residual]

        opt.synchronize = sync_and_record      # step 0 only
        fa.reset_launches()
        losses, times = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            loss = step(tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            if i == 0:
                del opt.synchronize
        launches = dict(fa.launches)

        # (a) bit-equal to the CPU's two-pass schedule at world 1.
        for p_local, p_synced in zip(seen["local"], seen["synced"]):
            expected = two_pass_world1(torch, Q, p_local, wire)
            assert torch.equal(p_synced, expected), (
                wire, (p_synced - expected).abs().max().item())
        # (b) the bytes each pass moves: at world 1 each tensor is padded
        # to the block, so the serialized size (page_wire_bytes), which is
        # wire_bytes where the block divides the tensor, as at the flagship.
        if wire in ("int8", "int4"):
            spec = Q.QuantSpec(int(wire[3]), QUANT_BLOCK)
            expected_pass = sum(Q.page_wire_bytes(p.numel(), spec)
                                for p in params)
            scale_bytes = sum(4 * math.ceil(p.numel() / QUANT_BLOCK)
                              for p in params)
        else:
            expected_pass = sum(2 * p.numel() for p in params)
            scale_bytes = 0
        passes = {}
        for call, dtype, nbytes in seen["log"]:
            passes.setdefault(call, [0, 0])
            passes[call][0] += nbytes
            passes[call][1] += nbytes if dtype == torch.float32 else 0
        for call in ("all_to_all_single", "all_gather_into_tensor"):
            assert passes[call] == [expected_pass, scale_bytes], (
                wire, call, passes[call], expected_pass, scale_bytes)
        # (c) the error-feedback residual after step 0.
        if wire in ("int8", "int4"):
            assert any(r.abs().max() > 0 for r in seen["residual"]), wire
            # |r| <= scale/2, plus the roundings of x/scale and q*scale
            # (each at most 127 * 2^-24 of the scale): 2^-15 of it.  And r
            # is what the first pass' quantizer dropped: bit for bit the
            # CPU's g - qdq(g) (r starts at 0).
            for g, r in zip(seen["local"], seen["residual"]):
                _, scales = Q.quantize(g, spec)
                half = scales.repeat_interleave(QUANT_BLOCK)[:g.numel()] / 2
                assert (r.reshape(-1).abs() <= half * (1 + 2 ** -14)).all(), \
                    wire
                assert torch.equal(r, g.float() - Q.qdq(g.float(), spec)), \
                    wire
        else:
            assert seen["residual"] is None and opt.residual is None, wire
        # (d) losses; (e) launches.
        assert all(math.isfinite(x) for x in losses), (wire, losses)
        assert losses[-1] < losses[0], (wire, losses)
        assert abs(losses[0] - loss0) <= TOL_LOSS, (wire, losses[0], loss0)
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * n_steps, (wire, launches)
        step_s = statistics.median(times[1:])
        out[wire] = {"losses": losses, "step_times_s": times,
                     "step_s": step_s,
                     "tokens_per_s": batch * cfg.seq_len / step_s,
                     "launches": launches, "bytes_per_pass": expected_pass,
                     "scale_bytes_per_pass": scale_bytes}
        log(f"[compressed] {wire}: step {step_s * 1e3:.3f} ms (median of "
            f"steps 1-{n_steps - 1}), {out[wire]['tokens_per_s']:.0f} "
            f"tokens/s; {expected_pass:,} bytes a pass ({scale_bytes:,} of "
            f"them fp32 scales, no fp32 payload); losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"launches {launches}; step-0 gradients equal the CPU's two-pass "
            f"schedule bit for bit")
        del model, params, opt, step, seen
    fp32_pass = 4 * sum(p.numel() for p in tfm.Transformer(
        cfg, par, seed=0).parameters())
    log(f"[compressed] an fp32 pass would move {fp32_pass:,} bytes")
    out["fp32_bytes_per_pass"] = fp32_pass

    # The quantizer on w1's gradient: quantize + dequantize, device time,
    # against the bytes it must move at 3.35 TB/s.
    x = torch.randn(W1_GRAD_ELEMS, device="cuda")
    out["quantizer"] = {}
    for wire in ("int8", "int4"):
        spec = Q.QuantSpec(int(wire[3]), QUANT_BLOCK)
        q, sc = Q.quantize(x, spec)
        assert torch.equal(Q.dequantize(q, sc, spec, x.numel()).cpu(),
                           Q.qdq(x.cpu(), spec))
        ms = time_ms(torch, lambda: Q.dequantize(
            *Q.quantize(x, spec), spec, x.numel()), iters=20)
        payload = q.numel() * q.element_size()
        nbytes = 2 * (4 * x.numel() + payload + 4 * sc.numel())
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        out["quantizer"][wire] = {"elems": x.numel(), "ms": ms,
                                  "bound_ms": bound_ms, "bytes": nbytes}
        log(f"[compressed] quantize + dequantize {wire}, {x.numel():,} fp32: "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes:,} bytes), on "
            f"{card}")
    return out


def phase_collectives(torch, hvd, Q):
    """Phase 6: the rest of the collective API on CUDA tensors, world 1."""
    g = torch.Generator().manual_seed(6)
    x_cpu = torch.randn(6, 300, generator=g)
    x = x_cpu.cuda()
    checks = {}
    checks["allgather"] = torch.equal(hvd.allgather(x), x)
    recv, splits = hvd.alltoall(x, splits=[4])
    checks["alltoall"] = torch.equal(recv, x[:4]) and splits.tolist() == [4]
    checks["reducescatter"] = torch.equal(hvd.reducescatter(x), x)
    checks["reducescatter_int8"] = torch.equal(
        hvd.reducescatter(x, compression="int8").cpu(),
        Q.qdq(x_cpu, Q.QuantSpec(8, QUANT_BLOCK)))
    checks["reducescatter_bf16"] = torch.equal(
        hvd.reducescatter(x, op=hvd.Sum, compression="bf16").cpu(),
        x_cpu.to(torch.bfloat16).float())
    hvd.barrier()
    checks["join"] = hvd.join() == 0
    handles = [hvd.allreduce_async(x, op=hvd.Sum), hvd.allgather_async(x),
               hvd.broadcast_async(x), hvd.alltoall_async(x)]
    checks["poll"] = all(isinstance(hvd.poll(h), bool) for h in handles)
    results = [hvd.synchronize(h) for h in handles]
    checks["async"] = (all(torch.equal(r, x) for r in results[:3])
                       and torch.equal(results[3][0], x))
    obj = {"card": torch.cuda.get_device_name(0), "ints": [1, 2, 3]}
    checks["broadcast_object"] = hvd.broadcast_object(obj) == obj
    checks["allgather_object"] = hvd.allgather_object(obj) == [obj]
    torch.cuda.synchronize()
    log("[collectives] " + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                                     for k, v in checks.items()))
    assert all(checks.values()), checks
    return checks


def count_calls(dist, names):
    """Wrap the ``torch.distributed`` calls ``names``; each call adds one
    to its count (an all_reduce of one element, the dp-mean loss, is not
    counted).  Returns the counts and a function that restores the
    calls."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def call(*args, **kwargs):
            tensor = args[0] if args else kwargs.get("tensor")
            if not (name == "all_reduce" and tensor.numel() == 1):
                counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, wrap(n))

    def restore():
        for n, f in saved.items():
            setattr(dist, n, f)
    return counts, restore


def train_run(torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
              make_opt, on_step0=None):
    """``n_steps`` training steps of a fresh seed-0 flagship through
    ``make_train_step`` with the optimizer ``make_opt(model)`` gives:
    losses, host seconds a step, collective calls a step (steps 1..), the
    kernels' launches, the peak bytes allocated on the card above what was
    allocated when the run began, and what ``on_step0(model, opt)``
    returns after step 0."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = tfm.Transformer(cfg, par, seed=0)
    opt = make_opt(model)
    step = tfm.make_train_step(cfg, par, model, opt)
    names = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    fa.reset_launches()
    losses, times, seen, calls = [], [], None, None
    for i in range(n_steps):
        if i == 1:
            calls, restore = count_calls(dist, names)
        t0 = time.perf_counter()
        loss = step(tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if i == 0 and on_step0 is not None:
            seen = on_step0(model, opt)
    restore()
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(fa.launches)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * n_steps, launches
    # One more step under torch.profiler: the device kernels it launches.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(tokens, labels)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    return {"losses": losses, "step_times_s": times, "peak_bytes": peak,
            "step_s": statistics.median(times[1:]),
            "calls_per_step": {n: c / (n_steps - 1)
                               for n, c in calls.items()},
            "launches": launches, "device_kernels_per_step": kernels}, seen


def first_difference(a, b):
    """(step, |a - b|) of the first step whose losses differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, abs(x - y)
    return None


def phase_overlap_zero(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                       n_steps, per_leaf_losses, card):
    """Phase 7: the bucketed schedule, ZeRO stages 1-3 and Adasum on the
    flagship; returns the report."""
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import overlap as O

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    out = {}
    names, shapes = zip(*tfm.Transformer(cfg, par, seed=0)
                        .named_parameters())
    plan = O.plan_buckets(shapes)
    got = [[names[i] for i in b] for b in plan.buckets]
    assert got == FLAGSHIP_BUCKETS, got
    log(f"[overlap] buckets at {plan.bucket_bytes:,} bytes: {got}")

    # (a) The bucketed schedule beside the per-parameter one.
    for wire in ("none", "int8"):
        comp = None if wire == "none" else wire
        runs = {}
        for overlap in (False, True):
            captured = {}

            def make_opt(model, overlap=overlap, captured=captured):
                opt = hvd.DistributedOptimizer(
                    adamw(model.parameters()), compression=comp,
                    overlap=overlap)
                if overlap:
                    launch = opt._launch

                    def recording_launch(b):   # local gradients, step 0
                        if "local" not in captured:
                            captured["local"] = {}
                            captured["bucket_order"] = []
                        if len(captured["bucket_order"]) < plan.n_buckets:
                            captured["bucket_order"].append(b)
                            ps = opt._params()
                            for i in opt._hooks.plan.buckets[b]:
                                captured["local"][i] = \
                                    ps[i].grad.detach().clone()
                        launch(b)
                    opt._hooks._launch = recording_launch
                return opt

            def step0(model, opt):
                return {"synced": [p.grad.detach().clone()
                                   for p in model.parameters()],
                        "residual": None if opt.residual is None else
                        [r.clone() for r in opt.residual]}

            runs[overlap], seen = train_run(
                torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
                make_opt, step0)
            runs[overlap]["seen"], runs[overlap]["captured"] = seen, captured
        ov = runs[True]
        local = [ov["captured"]["local"][i] for i in range(len(names))]
        # The hooks launched in the plan's order, as backward completed
        # each bucket.
        assert ov["captured"]["bucket_order"] == list(range(plan.n_buckets))
        # The per-parameter schedule on the same local gradients.
        ps = [torch.nn.Parameter(torch.zeros_like(g)) for g in local]
        ref = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.0),
                                       compression=comp)
        for p, g in zip(ps, local):
            p.grad = g.clone()
        ref.synchronize()
        for n, p, g in zip(names, ps, ov["seen"]["synced"]):
            assert torch.equal(p.grad, g), (wire, n, (p.grad - g).abs().max())
        if comp is not None:
            for n, r, r_ov in zip(names, ref.residual,
                                  ov["seen"]["residual"]):
                assert torch.equal(r, r_ov), (wire, n)
        collectives = {
            o: (runs[o]["calls_per_step"]["all_reduce"] if wire == "none"
                else runs[o]["calls_per_step"]["all_to_all_single"] / 2)
            for o in (False, True)}
        assert collectives == {False: len(names), True: plan.n_buckets}, \
            (wire, collectives)
        per_leaf = runs[False]["losses"]
        diff = first_difference(ov["losses"], per_leaf)
        assert ov["losses"][0] == per_leaf[0], (wire, ov["losses"][0],
                                                per_leaf[0])
        assert all(abs(a - b) <= TOL_LOSS
                   for a, b in zip(ov["losses"], per_leaf)), wire
        out[f"overlap_{wire}"] = {
            "per_leaf": {k: v for k, v in runs[False].items()
                         if k not in ("seen", "captured")},
            "overlap": {k: v for k, v in ov.items()
                        if k not in ("seen", "captured")},
            "collectives_per_step": collectives,
            "first_loss_difference": diff,
            "earlier_phase_losses": per_leaf_losses[wire]}
        log(f"[overlap] {wire}: step-0 gradients"
            f"{' and residuals' if comp else ''} bit-equal to the "
            f"per-parameter schedule on the same local gradients; "
            f"{collectives[True]:g} bucket collectives a step against "
            f"{collectives[False]:g}; host step {ov['step_s'] * 1e3:.3f} ms "
            f"against {runs[False]['step_s'] * 1e3:.3f} ms (medians of "
            f"steps 1-{n_steps - 1}), {ov['device_kernels_per_step']} "
            f"device kernels a step against "
            f"{runs[False]['device_kernels_per_step']}, on {card}; losses "
            + ("equal the per-parameter run's" if diff is None else
               f"first differ at step {diff[0]} by {diff[1]:.3g}"))

    # (b) ZeRO: every stage's parameters after step 0 against the
    # replicated step on the same wire (on int8, the replicated step's
    # two-pass allreduce at world 1 takes the same qdq of the fed
    # gradient on the same block grid as ZeRO's reduce-scatter).
    def params_after(model, opt):
        if getattr(opt, "stage", 0) == 3:
            with torch.no_grad():
                return [t.detach().clone()
                        for t in opt.gather_params().values()]
        return [p.detach().clone() for p in model.parameters()]

    replicated = {}
    for wire in (None, "int8"):
        res, replicated[wire] = train_run(
            torch, hvd, tfm, fa, cfg, par, tokens, labels, 2,
            lambda m, wire=wire: hvd.DistributedOptimizer(
                adamw(m.parameters()), compression=wire), params_after)
        out["replicated" + ("" if wire is None else f"_{wire}")] = {
            "peak_bytes": res["peak_bytes"]}
    for stage, wire in ((1, None), (2, None), (3, None), (1, "int8")):
        res, after = train_run(
            torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
            lambda m, stage=stage, wire=wire: hvd.ZeroShardedOptimizer(
                m, adamw, stage=stage, compression=wire), params_after)
        worst = 0.0
        for n, got, want in zip(names, after, replicated[wire]):
            torch.testing.assert_close(got, want, **ZERO_TOL,
                                       msg=lambda m, n=n: f"{n}: {m}")
            worst = max(worst, (got - want).abs().max().item())
        suffix = "" if wire is None else f"_{wire}"
        rep_peak = out["replicated" + suffix]["peak_bytes"]
        out[f"zero{stage}{suffix}"] = dict(res, max_abs_diff_step0=worst)
        log(f"[zero] stage {stage}{'' if wire is None else ' ' + wire}: "
            f"parameters after step 0 max |diff| {worst:.3g} from the "
            f"replicated step{'' if wire is None else ' on ' + wire} "
            f"(within rtol 1e-5 atol 1e-6); losses "
            f"{res['losses'][0]:.6f} -> {res['losses'][-1]:.6f}; host step "
            f"{res['step_s'] * 1e3:.3f} ms; peak allocated "
            f"{res['peak_bytes'] / 2**20:.1f} MiB (replicated "
            f"{rep_peak / 2**20:.1f} MiB); "
            f"calls a step {res['calls_per_step']}; "
            f"{res['device_kernels_per_step']} device kernels a step; "
            f"launches {res['launches']}")

    # (c) Adasum: at world 1 the reduction is the identity, so each step
    # leaves p0 + (p' - p0) for the inner step's p'.  Its two roundings
    # are within half an ulp of p' - p0 and of the sum, so within
    # 1.5 eps max(|p0|, |p'|) of p' (eps = 2^-23): 1 ulp unless the step
    # crosses a power of two or zero.
    def adasum_opt(model):
        opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                       op=hvd.Adasum)
        inner = opt.optimizer.step
        seen = opt.seen = []

        def recording_step(*args, **kwargs):
            if not seen:
                seen.append([p.detach().clone() for p in model.parameters()])
            loss = inner(*args, **kwargs)
            if len(seen) == 1:
                seen.append([p.detach().clone() for p in model.parameters()])
            return loss
        opt.optimizer.step = recording_step
        return opt

    res, (before, inner_after, final) = train_run(
        torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps, adasum_opt,
        lambda m, o: o.seen + [[p.detach().clone() for p in m.parameters()]])
    worst, exact = 0.0, 0
    for n, p0, a, b in zip(names, before, inner_after, final):
        bound = torch.finfo(a.dtype).eps * torch.maximum(p0.abs(), a.abs())
        assert ((a - b).abs() <= 1.5 * bound).all(), n
        worst = max(worst, ((a - b).abs() / bound.clamp_min(
            torch.finfo(a.dtype).tiny)).max().item())
        exact += int(torch.equal(a, b))
    out["adasum"] = dict(res, worst_over_eps_max=worst,
                         params_bit_equal=exact)
    log(f"[adasum] {n_steps} steps, losses {res['losses'][0]:.6f} -> "
        f"{res['losses'][-1]:.6f}; step 0's p0 + (p' - p0) within "
        f"{worst:.3g} eps max(|p0|, |p'|) of the inner step's p' "
        f"({exact} of {len(names)} tensors bit-equal); host step "
        f"{res['step_s'] * 1e3:.3f} ms, "
        f"{res['device_kernels_per_step']} device kernels a step")

    # (d) The Adasum combine and sync batch norm, card against CPU.
    g = torch.Generator().manual_seed(12)
    stack = torch.randn(4, W1_GRAD_ELEMS, generator=g)
    stack[1] += 0.5 * stack[0]                 # a correlated pair
    want = A.adasum_tree(stack)
    on_card = stack.cuda()
    got = A.adasum_tree(on_card).cpu()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= TOL_ADASUM_REL, rel
    ms = time_ms(torch, lambda: A.adasum_tree(on_card), iters=5)
    out["adasum_tree"] = {"rel": rel, "ms": ms}
    log(f"[adasum] adasum_tree (4, {W1_GRAD_ELEMS:,}) fp32 on the card vs "
        f"the CPU: normwise {rel:.3g}; {ms:.4f} ms on the card, on {card}")
    x = torch.randn(16, 64, 256, generator=g) * 3 + 1
    scale, bias = torch.randn(256, generator=g), torch.randn(256, generator=g)
    ct = torch.randn(16, 64, 256, generator=g)
    rm, rv = torch.zeros(256), torch.ones(256)
    sbn = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, scale, bias)]
        y, m, v = hvd.sync_batch_norm(*leaves, rm.to(dev), rv.to(dev))
        y.backward(ct.to(dev))
        sbn[dev] = [t.detach().cpu() for t in (y, m, v)] + \
            [t.grad.cpu() for t in leaves]
    worst = max(((a - b).norm() / b.norm()).item()
                for a, b in zip(sbn["cuda"], sbn["cpu"]))
    assert worst <= TOL_SBN_REL, worst
    out["sync_batch_norm_rel"] = worst
    log(f"[sbn] sync_batch_norm forward + backward, card vs CPU: worst "
        f"normwise {worst:.3g}")
    return out


def snapshot(torch, model, opt):
    """The full parameters and every inner-optimizer tensor of a ZeRO
    run, cloned: (params by name, [per shard {state key: tensor}],
    residuals or None)."""
    with torch.no_grad():
        params = {n: t.detach().clone() for n, t in (
            opt.gather_params().items() if opt.stage == 3
            else model.named_parameters())}
    state = [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in opt.optimizer.state[s].items()}
             for s in opt.shards]
    residual = None if opt.residual is None else \
        [r.clone() for r in opt.residual]
    return params, state, residual


def max_difference(torch, a, b):
    """The largest |a - b| over two snapshots' tensors (0.0 when every
    tensor is bit-equal)."""
    worst = 0.0
    pa, sa, ra = a
    pb, sb, rb = b
    pairs = [(pa[n], pb[n]) for n in pa]
    pairs += [(x[k], y[k]) for x, y in zip(sa, sb) for k in x]
    pairs += list(zip(ra or [], rb or []))
    for x, y in pairs:
        if not torch.equal(x, y):
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return worst


def phase_checkpoint(torch, hvd, tfm, fa, cfg, par, card):
    """Phase 8: save, restore and resume of the flagship's ZeRO training
    fed by the port's DataLoader; returns the report."""
    import tempfile
    import numpy as np
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.data import (ArraySource, DataLoader,
                                        ShardedIndexSampler)
    from horovod_tpu_torch.utils import checkpoint as uckpt

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    batch, n_steps, resume_at, seqs = 8, 8, 4, 256
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (seqs, cfg.seq_len + 1), dtype=np.int32)
    source = ArraySource(tokens)

    def loader(seed):
        return DataLoader(source, batch, shuffle=True, seed=seed,
                          prefetch=True, queue_depth=2, device="cuda")

    def split(b):
        return b[:, :-1].long(), b[:, 1:].long()

    out = {}
    # (a) The loader's batches on the card against the host rows its
    # sampler selects.
    ld, sampler = loader(0), ShardedIndexSampler(seqs, batch, seed=0)
    it = iter(ld)
    for i in range(n_steps):
        got = next(it)
        assert got.is_cuda and got.dtype == torch.int32, (got.device,
                                                          got.dtype)
        want = torch.from_numpy(tokens[sampler.next_batch()])
        assert torch.equal(got.cpu(), want), f"batch {i} differs"
    ld.close()
    log(f"[ckpt] DataLoader(batch {batch}, shuffle, seed 0, prefetch, "
        f"depth 2, device='cuda'): the first {n_steps} batches on the card "
        "equal the sampler's host rows bit for bit")

    def run(stage, wire, steps, it, model=None, opt=None):
        """``steps`` steps fed by ``it``: the model, the optimizer, the
        losses, host seconds a step and the kernels' launches in those
        steps."""
        if model is None:
            model = tfm.Transformer(cfg, par, seed=0)
            opt = hvd.ZeroShardedOptimizer(model, adamw, stage=stage,
                                           compression=wire)
        step = tfm.make_train_step(cfg, par, model, opt)
        torch.cuda.synchronize()
        fa.reset_launches()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = step(*split(next(it)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
        launches = dict(fa.launches)
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * steps, launches
        assert all(math.isfinite(x) for x in losses), losses
        return model, opt, losses, times, launches

    for stage, wire in ((1, None), (3, None), (1, "int8")):
        label = f"zero{stage}" + ("" if wire is None else f"_{wire}")
        # (b) Run A, uninterrupted, twice: the run-to-run spread.
        runs = []
        for _ in range(2):
            ld = loader(0)
            model, opt, losses, times, _ = run(stage, wire, n_steps,
                                               iter(ld))
            ld.close()
            runs.append((losses, snapshot(torch, model, opt), times))
            del model, opt
        (a_losses, a_snap, a_times), (a2_losses, a2_snap, _) = runs
        spread_loss = max(abs(x - y) for x, y in zip(a_losses, a2_losses))
        spread = max_difference(torch, a_snap, a2_snap)
        if spread_loss or spread:
            log(f"[ckpt] {label}: two uninterrupted runs differ: losses by "
                f"up to {spread_loss:.6g}, parameters and moments by up to "
                f"{spread:.6g}; the resumed run is held to that spread")
        # (c) Run B: 4 steps, save, a fresh model, optimizer and loader
        # from another seed, restore all three, 4 more steps.
        with tempfile.TemporaryDirectory() as tmp:
            ld = loader(0)
            model, opt, b_first, _, _ = run(stage, wire, resume_at,
                                            iter(ld))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.state_dict(os.path.join(tmp, "opt"), step=resume_at,
                           extra={ckpt.DATA_ITERS_KEY:
                                  {"train": ld.state_dict()}})
            if stage < 3:
                uckpt.save_checkpoint(os.path.join(tmp, "params"),
                                      model.state_dict(), step=resume_at)
            save_s = time.perf_counter() - t0
            ld.close()
            written = sum(os.path.getsize(os.path.join(d, f))
                          for d, _, files in os.walk(tmp) for f in files)
            del model, opt
            model = tfm.Transformer(cfg, par, seed=1)
            opt = hvd.ZeroShardedOptimizer(model, adamw, stage=stage,
                                           compression=wire)
            ld = loader(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manifest = opt.load_state_dict(os.path.join(tmp, "opt"))
            if stage < 3:
                uckpt.restore_checkpoint(os.path.join(tmp, "params"),
                                         target=model.state_dict(),
                                         step=resume_at)
            ld.load_state_dict(manifest.extra[ckpt.DATA_ITERS_KEY]["train"])
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            model, opt, b_rest, _, b_launches = run(
                stage, wire, n_steps - resume_at, iter(ld), model, opt)
            ld.close()
            b_snap = snapshot(torch, model, opt)
            del model, opt
        b_losses = b_first + b_rest
        loss_diff = max(abs(x - y) for x, y in zip(b_losses, a_losses))
        diff = max_difference(torch, b_snap, a_snap)
        assert loss_diff <= spread_loss and diff <= spread, \
            (label, loss_diff, diff, spread_loss, spread)
        out[label] = {
            "losses_a": a_losses, "losses_a2": a2_losses,
            "losses_b": b_losses, "run_to_run_loss_spread": spread_loss,
            "run_to_run_state_spread": spread,
            "resumed_loss_diff": loss_diff, "resumed_state_diff": diff,
            "bytes_per_save": written, "save_s": save_s,
            "restore_s": restore_s, "launches_b": b_launches,
            "loader_step_s": statistics.median(a_times[1:]),
            "step_times_a_s": a_times}
        log(f"[ckpt] {label}: resumed at step {resume_at} into a model, "
            f"optimizer and loader of seed 1: losses "
            f"{b_losses[resume_at]:.6f} -> {b_losses[-1]:.6f} "
            + ("equal the uninterrupted run's bit for bit, and so do the "
               "final parameters, moments"
               + (" and residuals" if wire else "")
               if loss_diff == diff == 0 else
               f"within the run-to-run spread ({loss_diff:.3g}, {diff:.3g})")
            + f"; kernels once per layer per step ({b_launches}); "
            f"{written:,} bytes a save, save {save_s:.3f} s, restore "
            f"{restore_s:.3f} s, on {card}")

    # (d) Host step time, stage 1, one fixed batch on the card against the
    # loader's feed, in turns (fixed, loader, loader, fixed; medians of
    # steps 1-7 of each run).
    ld = loader(0)
    fixed = next(iter(ld))
    ld.close()
    feed = {"fixed": [], "loader": []}
    for kind in ("fixed", "loader", "loader", "fixed"):
        ld = loader(0)
        it = iter([fixed] * n_steps) if kind == "fixed" else iter(ld)
        _, _, _, times, _ = run(1, None, n_steps, it)
        ld.close()
        feed[kind].append(statistics.median(times[1:]))
    out["host_step_s"] = feed
    log(f"[ckpt] host step, ZeRO stage 1, in turns: one fixed batch "
        f"{feed['fixed'][0] * 1e3:.3f}, loader {feed['loader'][0] * 1e3:.3f}"
        f", loader {feed['loader'][1] * 1e3:.3f}, fixed "
        f"{feed['fixed'][1] * 1e3:.3f} ms (medians of steps "
        f"1-{n_steps - 1}), on {card}")

    # (e) Adasum with backward_passes_per_step 2 against Average at world 1:
    # both step on the same scaled sum of the two passes, so the
    # parameters after the communicating step are within 1.5 eps
    # max(|p0|, |p'|) (phase 7's bound for p0 + (p' - p0) against p').
    ld = loader(0)
    it = iter(ld)
    passes = [split(next(it)) for _ in range(2)]
    ld.close()
    after = {}
    for op in (hvd.Average, hvd.Adasum):
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(adamw(model.parameters()), op=op,
                                       backward_passes_per_step=2)
        step = tfm.make_train_step(cfg, par, model, opt)
        before = [p.detach().clone() for p in model.parameters()]
        step(*passes[0])
        assert all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                     before))
        step(*passes[1])
        after[op] = [p.detach().clone() for p in model.parameters()]
        del model, opt
    worst = 0.0
    for p0, a, b in zip(before, after[hvd.Average], after[hvd.Adasum]):
        bound = torch.finfo(a.dtype).eps * torch.maximum(p0.abs(), a.abs())
        assert ((a - b).abs() <= 1.5 * bound).all()
        assert not torch.equal(a, p0)
        worst = max(worst, ((a - b).abs() / bound.clamp_min(
            torch.finfo(a.dtype).tiny)).max().item())
    out["adasum_bpps2_worst_over_eps_max"] = worst
    log(f"[ckpt] Adasum, backward_passes_per_step 2, against Average at "
        f"world 1: parameters after the communicating step within "
        f"{worst:.3g} eps max(|p0|, |p'|)")
    return out


# Phase 9: the GSPMD plane's configurations (stage, wire), and the
# collectives counted at torch.distributed.
GSPMD_CONFIGS = ((1, None), (2, None), (3, None), (2, "int8"))
COUNTED = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
           "reduce_scatter_tensor")
# Phase 10: the ring of 4 through the one-process seam at long context.
RING_SHAPE, RING_MEMBERS = (1, 8192, 16, 64), 4


def zero_plane_run(torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
                   stage, wire, plane):
    """``n_steps`` AdamW(3e-4, wd 1e-4) steps of a fresh seed-0 flagship at
    ZeRO ``stage`` on ``wire``: through ``ZeroShardedOptimizer`` and
    ``make_train_step`` (plane "flat", phase 7's) or through
    ``gspmd.make_zero_train_step`` on ``hvd.mesh()`` (plane "gspmd", the
    module's parameters given up for the placed copies).  Losses, host
    seconds a step, collectives a step (steps 1..), the kernels' launches,
    peak bytes above the run's start and, for gspmd, the residency
    report."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import gspmd

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = tfm.Transformer(cfg, par, seed=0)
    if plane == "flat":
        train = tfm.make_train_step(
            cfg, par, model, hvd.ZeroShardedOptimizer(
                model, adamw, stage=stage, compression=wire))

        def step():
            return train(tokens, labels)
    else:
        fns = gspmd.make_zero_train_step(
            lambda p, batch: torch.func.functional_call(model, p, batch),
            adamw, hvd.mesh(), stage=stage, compression=wire)
        params, state = fns.init(dict(model.named_parameters()))
        for p in model.parameters():
            p.data = p.data.new_empty(0)

        def step():
            return fns.step(params, state, (tokens, labels))[2]
    fa.reset_launches()
    losses, times = [], []
    for i in range(n_steps):
        if i == 1:
            calls, restore = count_calls(dist, COUNTED)
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    restore()
    launches = dict(fa.launches)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * n_steps, (plane, launches)
    out = {"losses": losses, "step_times_s": times,
           "step_s": statistics.median(times[1:]),
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "calls_per_step": {n: c / (n_steps - 1)
                              for n, c in calls.items() if c},
           "launches": launches}
    if plane == "gspmd":
        out["residency"] = gspmd.residency_report((params, state),
                                                  hvd.mesh())
    return out


def phase_gspmd(torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
                zero_losses, int8_bytes_per_pass, card):
    """Phase 9: the GSPMD ZeRO plane on the flagship against the flat
    plane, in turns (flat, gspmd, gspmd, flat); returns the report."""
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.ops import xla_collectives as XC
    out = {}
    for stage, wire in GSPMD_CONFIGS:
        label = f"stage{stage}" + ("" if wire is None else f"_{wire}")
        runs = [zero_plane_run(torch, hvd, tfm, fa, cfg, par, tokens,
                               labels, n_steps, stage, wire, plane)
                for plane in ("flat", "gspmd", "gspmd", "flat")]
        flat, gspmd_run = runs[0], runs[1]
        for run in runs[1:]:    # every run: the same function, rtol 1e-5
            for a, b in zip(run["losses"], flat["losses"]):
                assert abs(a - b) <= 1e-5 * abs(b), (label, a, b)
        earlier = zero_losses.get(f"zero{stage}" if wire is None else None)
        if earlier is not None:
            for a, b in zip(gspmd_run["losses"], earlier):
                assert abs(a - b) <= 1e-5 * abs(b), (label, a, b)
        rep = gspmd_run["residency"]
        assert rep["ratio_to_ideal"] == 1.0 and rep["world"] == 1, rep
        diff = max(abs(a - b) for a, b in zip(gspmd_run["losses"],
                                              flat["losses"]))
        out[label] = {"runs": runs, "max_loss_diff": diff,
                      "phase7_losses": earlier}
        log(f"[gspmd] {label}: losses {gspmd_run['losses'][0]:.6f} -> "
            f"{gspmd_run['losses'][-1]:.6f}, max |diff| {diff:.3g} from the "
            f"flat ZeroShardedOptimizer"
            + ("" if earlier is None else " (and phase 7's run)")
            + "; host step gspmd "
            + " / ".join(f"{r['step_s'] * 1e3:.3f}" for r in runs[1:3])
            + " ms, flat " + " / ".join(f"{r['step_s'] * 1e3:.3f}"
                                        for r in (runs[0], runs[3]))
            + f" ms (medians of steps 1-{n_steps - 1}, in turns); peak "
            f"{gspmd_run['peak_bytes'] / 2**20:.1f} MiB against "
            f"{flat['peak_bytes'] / 2**20:.1f} MiB; collectives a step "
            f"{gspmd_run['calls_per_step']} against {flat['calls_per_step']};"
            f" residency {rep['total_bytes']:,} bytes, ratio "
            f"{rep['ratio_to_ideal']}; launches {gspmd_run['launches']}; "
            f"on {card}")
    sizes = [p.numel() for p in tfm.Transformer(cfg, par, seed=0,
                                                device="cpu").parameters()]
    plan = XC.plan_allreduce_step(sizes, spec=Q.QuantSpec(8, QUANT_BLOCK))
    out["int8_plan"] = {"raw": plan.raw, "sent": plan.sent,
                        "phase5_bytes_per_pass": int8_bytes_per_pass}
    assert plan.sent == 2 * int8_bytes_per_pass, (plan, int8_bytes_per_pass)
    log(f"[gspmd] int8 plan_allreduce_step: raw {plan.raw:,}, sent "
        f"{plan.sent:,} bytes a step = 2 passes x {plan.sent // 2:,} "
        f"(phase 5 measured {int8_bytes_per_pass:,} a pass)")
    return out


def phase_sequence_parallel(torch, fa, card):
    """Phase 10: ring and Ulysses at world 1 on NCCL against
    full_attention, bit for bit; the ring of 4 through the one-process
    seam at long context against one kernel call; returns the report."""
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    from horovod_tpu_torch.parallel import ring_attention as ra
    from horovod_tpu_torch.parallel import ulysses
    out = {}
    # (a) world 1 on NCCL, the flagship's attention shape.
    group = mesh_lib.create_mesh({mesh_lib.SEQUENCE: 1}).get_group(
        mesh_lib.SEQUENCE)
    q, k, v, do = rand_qkv(torch, 8, 512, 512, 8, 64, seed=21)
    fns = {"full": ra.full_attention,
           "ring": lambda a, b, c: ra.ring_attention(a, b, c, group),
           "ulysses": lambda a, b, c: ulysses.ulysses_attention(a, b, c,
                                                                group)}
    got = {}
    for name, fn in fns.items():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launches()
        o = fn(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        got[name] = [o.detach()] + [t.grad for t in leaves]
        out[f"world1_{name}_launches"] = dict(fa.launches)
        assert all(n == 1 for n in fa.launches.values()), (name,
                                                           fa.launches)
    for name in ("ring", "ulysses"):
        for what, a, b in zip(("out", "dq", "dk", "dv"), got[name],
                              got["full"]):
            assert torch.equal(a, b), (name, what)
    log("[seq] world 1 on NCCL, (8, 512, 8, 64) causal: ring_attention and "
        "ulysses_attention equal full_attention bit for bit (out, dq, dk, "
        "dv), one launch of each kernel each")

    # (b), (c) the ring of 4 through the seam, causal and not.
    b, s, h, d = RING_SHAPE
    n = RING_MEMBERS
    scale = 1.0 / math.sqrt(d)
    ring = ra._LocalRing(n)
    for causal in (True, False):
        label = "causal" if causal else "full"
        q, k, v, do = rand_qkv(torch, b, s, s, h, d, seed=22)
        parts = [list(t.split(s // n, dim=1)) for t in (q, k, v, do)]
        leaves = [[t.detach().clone().requires_grad_() for t in ts]
                  for ts in parts[:3]]
        fa.reset_launches()
        outs = ra._ring_attention_shards(*leaves, causal=causal)
        torch.autograd.backward(outs, parts[3])
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        assert launches == {k_: n * n for k_ in KERNELS}, launches
        masked = sum((i + t) % n > i for t in range(n) for i in range(n)) \
            if causal else 0
        whole = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o1 = fa.flash_attention(*whole, causal=causal)
        o1.backward(do)
        _, lse1 = fa.flash_fwd(q, k, v, causal, scale)
        _, lses = ra._ring_flash_forward(ring, *parts[:3], causal, scale)
        torch.cuda.synchronize()
        errs = {"out": compare(torch, torch.cat(outs, 1).detach(),
                               o1.detach(), TOL_OUT)}
        torch.testing.assert_close(torch.cat(lses, 2), lse1, **TOL_LSE)
        errs["lse"] = ((torch.cat(lses, 2) - lse1).abs().max().item(), 0.0)
        for what, ts, w in zip(("dq", "dk", "dv"), leaves, whole):
            errs[what] = compare(torch, torch.cat([t.grad for t in ts], 1),
                                 w.grad, TOL_GRAD)
        # Device time (CUDA-graph replays): the walk against one call.
        outs_p, lses_p = ra._ring_flash_forward(ring, *parts[:3], causal,
                                                scale)
        o_single, lse_single = fa.flash_fwd(q, k, v, causal, scale)

        def single_bwd():
            _, delta = fa.flash_bwd_dq(q, k, v, do, lse_single, o_single,
                                       causal, scale)
            fa.flash_bwd_dkv(q, k, v, do, lse_single, delta, causal, scale)

        shard = [t[0] for t in parts[:3]]
        ms = {
            "walk_fwd": time_ms(torch, lambda: ra._ring_flash_forward(
                ring, *parts[:3], causal, scale), 5),
            "single_fwd": time_ms(torch, lambda: fa.flash_fwd(
                q, k, v, causal, scale), 5),
            "walk_bwd": time_ms(torch, lambda: ra._ring_flash_backward(
                ring, *parts[:3], outs_p, lses_p, parts[3], causal, scale),
                5),
            "single_bwd": time_ms(torch, single_bwd, 5),
            "combine_blocks": time_ms(torch, lambda: fa.combine_blocks(
                outs_p[0].float(), lses_p[0], outs_p[1].float(), lses_p[1]),
                20),
            # A step whose keys all lie after its queries, and one that
            # sees all its keys.
            "masked_fwd_launch": time_ms(torch, lambda: fa.flash_fwd(
                *shard, True, scale, 0, s // n), 20),
            "unmasked_fwd_launch": time_ms(torch, lambda: fa.flash_fwd(
                *shard, True, scale, s // n, 0), 20),
        }
        bnd = bounds(b, s, h, d, causal)
        fwd_bound = bnd["flash_fwd"][0]
        bwd_bound = bnd["flash_bwd_dq"][0] + bnd["flash_bwd_dkv"][0]
        out[f"ring4_{label}"] = {"launches": launches,
                                 "masked_launches_per_direction": masked,
                                 "errs": errs, "ms": ms,
                                 "fwd_bound_ms": fwd_bound,
                                 "bwd_bound_ms": bwd_bound}
        log(f"[seq] ring of {n} through the seam, {RING_SHAPE} {label}: "
            f"launches {launches} ({masked} a direction on fully masked "
            f"blocks); {fmt_errs(errs)}; walk fwd {ms['walk_fwd']:.4f} ms "
            f"against one call {ms['single_fwd']:.4f} ms (bound "
            f"{fwd_bound:.4f}), walk bwd {ms['walk_bwd']:.4f} ms against "
            f"{ms['single_bwd']:.4f} ms (bound {bwd_bound:.4f}); "
            f"combine_blocks (1, {s // n}, {h}, {d}) fp32 "
            f"{ms['combine_blocks']:.4f} ms; one fully masked fwd launch "
            f"{ms['masked_fwd_launch']:.4f} ms against an unmasked one "
            f"{ms['unmasked_fwd_launch']:.4f} ms; on {card}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import quantization as Q

    report = {}
    # 1. card
    card = card_line()
    log(f"[card] {card}  ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build("flash_attention")
    fa._library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(lib_path, ROOT)} in "
        f"{report['build_s']:.1f} s")
    with open(lib_path + ".log") as f:  # ptxas -v: registers and spills
        for line in f:
            kernel = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                               r"ILi(\d+)ELi(\d+)", line)
            if kernel and "Compiling entry" in line:
                log("[build] %s<%s,%s>:" % kernel.groups())
            elif "registers" in line or "spill" in line:
                log("[build]   " + line.strip())
            elif kernel and "C7512" in line:  # wgmma serialised by ptxas
                log("[build] %s<%s,%s>: wgmma serialised (insufficient "
                    "registers)" % kernel.groups())

    # 3. kernels vs plain versions
    small = [  # (b, sq, sk, h, d, causal, q_offset, kv_offset)
        (2, 200, 200, 3, 64, True, 0, 0),
        (2, 200, 200, 3, 64, False, 0, 0),
        (1, 96, 160, 2, 32, True, 64, 0),
        (1, 130, 70, 2, 128, True, 0, 100),   # rows < 100 fully masked
        (2, 77, 77, 2, 128, False, 0, 0),
        (1, 64, 64, 2, 32, True, 0, 64),      # every row fully masked
        # Lengths off the 128-row tiles (TMA zero fill, the score mask).
        (1, 333, 333, 2, 64, True, 0, 0),
        (2, 129, 129, 2, 128, False, 0, 0),
        (1, 200, 333, 2, 64, True, 150, 20),  # Sq != Sk, both offsets
        (1, 333, 129, 3, 32, True, 40, 250),
        (5, 192, 192, 28, 64, True, 0, 0),    # B*H = 140 > 132 SMs
    ]
    for i, (b, sq, sk, h, d, causal, qo, ko) in enumerate(small):
        q, k, v, do = rand_qkv(torch, b, sq, sk, h, d, seed=i)
        errs = check_case(torch, fa, q, k, v, do, causal, qo, ko)
        log(f"[kernels] case {(b, sq, sk, h, d)} causal={causal} "
            f"offsets=({qo},{ko}): {fmt_errs(errs)}")
    # Every head_dim through strided q/k/v slices of a fused qkv, as the
    # model passes them (head_dim 128: two 64-column TMA boxes a row).
    for d in (32, 64, 128):
        q, k, v, do = fused_qkv(torch, 2, 200, 3, d, seed=d)
        errs = check_case(torch, fa, q, k, v, do, True, 0, 0)
        log(f"[kernels] fused qkv (2, 200, 3, {d}): {fmt_errs(errs)}")
    # The flagship shape, through strided q/k/v slices of a fused qkv.
    q, k, v, do = fused_qkv(torch, 8, 512, 8, 64, seed=11)
    main_errs = check_case(torch, fa, q, k, v, do, True, 0, 0)
    log(f"[kernels] flagship (8, 512, 8, 64) strided qkv: "
        f"{fmt_errs(main_errs)}")
    bad = torch.zeros((1, 64, 2, 96), device="cuda", dtype=torch.bfloat16)
    try:
        fa.flash_fwd(bad, bad, bad, True, 0.1)
    except ValueError:
        pass
    else:
        raise AssertionError("head_dim 96 must raise on a CUDA tensor")

    timing = {}
    for label, shape, iters, plain_iters in (
            ("flagship", (8, 512, 8, 64), 50, 10),
            ("long_context", (1, 8192, 16, 64), 10, 3)):
        res, fb = time_shape(torch, F, fa, *shape, iters, plain_iters)
        bnd = bounds(*shape)
        timing[label] = {"shape": shape, "fwd_bwd": fb, "kernels": {
            n: {"ms": r[0], "plain_ms": r[1], "library_ms": r[2],
                "bound_ms": bnd[n][0], "bound_by": bnd[n][1]}
            for n, r in res.items()}}
        for n, r in timing[label]["kernels"].items():
            log(f"[kernels] {label} {shape} {n}: {r['ms']:.4f} ms (bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms")
        log(f"[kernels] {label} fwd+bwd: port {fb['port_fwd_bwd_ms']:.4f} ms,"
            f" sdpa {fb['sdpa_fwd_bwd_ms']:.4f} ms; bwd (dQ + dK/dV): port "
            f"{fb['port_bwd_ms']:.4f} ms, library "
            f"{fb['library_bwd_ms']:.4f} ms")
    report["timing"] = timing
    torch.cuda.synchronize()

    # 4. the main path: 10 data-parallel training steps of the flagship
    hvd.init()
    cfg = tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                d_ff=2048, n_layers=8, seq_len=512,
                                dtype=torch.bfloat16)
    par = tfm.ParallelConfig()
    batch, n_steps = 8, 10
    model = tfm.Transformer(cfg, par, seed=0)
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    tokens, labels = tfm.synthetic_batch(cfg, batch, seed=1)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = tfm.forward_loss(cfg, par, model, tokens, labels)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    # Step 0's loss and gradients through the kernels (autograd Function,
    # δ from dQ, the strided dQ/dK/dV into the fused qkv gradient) vs the plain
    # attention path, on the same weights and batch.
    kernel_loss, kernel_grads = loss_and_grads()
    os.environ["HVD_TPU_FLASH"] = "0"
    plain_loss, plain_grads = loss_and_grads()
    del os.environ["HVD_TPU_FLASH"]
    grad_rel = {n: ((kernel_grads[n] - g).norm()
                    / g.norm().clamp_min(1e-30)).item()
                for n, g in plain_grads.items()}
    log(f"[train] step-0 loss: kernels {kernel_loss}, plain attention "
        f"{plain_loss}; gradients, normwise relative difference: "
        + ", ".join(f"{n} {r:.3g}" for n, r in grad_rel.items()))
    assert abs(kernel_loss - plain_loss) <= TOL_LOSS, (kernel_loss,
                                                       plain_loss)
    for n, r in grad_rel.items():
        assert r <= TOL_MODEL_GRAD_REL, (n, r)
    del kernel_grads, plain_grads
    step = tfm.make_train_step(cfg, par, model, opt)

    fa.reset_launches()
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        loss = step(tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = dict(fa.launches)
    log(f"[train] losses {losses}")
    log(f"[train] kernel launches over {n_steps} steps: {launches}")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert abs(losses[0] - kernel_loss) <= TOL_LOSS, (losses[0], kernel_loss)
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * n_steps, launches
    # The median of steps 1.. (step 0 carries warm-up): one host stall
    # would skew a mean.
    step_s = statistics.median(times[1:])
    tok_s = batch * cfg.seq_len / step_s
    mfu = tfm.train_flops_per_seq(cfg) * batch / step_s / PEAK_BF16_FLOPS
    log(f"[train] step {step_s * 1e3:.3f} ms (median of steps 1-{n_steps - 1}; "
        f"step 0 {times[0] * 1e3:.1f} ms), {tok_s:.0f} tokens/s, MFU "
        f"{mfu:.4f} of 989 TFLOP/s bf16, on {card}")
    report["train"] = {"losses": losses, "plain_step0_loss": plain_loss,
                       "step0_grad_rel": grad_rel,
                       "step_times_s": times, "step_s": step_s,
                       "tokens_per_s": tok_s, "mfu": mfu,
                       "launches": launches}

    # 5. the compressed wires; 6. the rest of the collective API
    report["compressed"] = phase_compressed(
        torch, hvd, tfm, fa, Q, cfg, par, batch, n_steps, tokens, labels,
        losses[0], card)
    report["collectives"] = phase_collectives(torch, hvd, Q)
    # 7. overlap, ZeRO, Adasum
    report["overlap_zero"] = phase_overlap_zero(
        torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
        {"none": losses, "int8": report["compressed"]["int8"]["losses"]},
        card)
    # 8. checkpoint, restore and resume fed by the DataLoader
    report["checkpoint"] = phase_checkpoint(torch, hvd, tfm, fa, cfg, par,
                                            card)
    # 9. the GSPMD ZeRO plane; 10. sequence-parallel attention
    report["gspmd"] = phase_gspmd(
        torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
        {k: v["losses"] for k, v in report["overlap_zero"].items()
         if k.startswith("zero")},
        report["compressed"]["int8"]["bytes_per_pass"], card)
    report["sequence_parallel"] = phase_sequence_parallel(torch, fa, card)
    hvd.shutdown()

    kernels = []
    flag = timing["flagship"]["kernels"]
    seq = report["sequence_parallel"]
    for name, replaces in KERNELS.items():
        # Launches on each path, counted from 0 just before it ran.
        by_path = {"train": launches[name]}
        by_path.update({f"gspmd_{label}": r["runs"][1]["launches"][name]
                        for label, r in report["gspmd"].items()
                        if label.startswith("stage")})
        by_path.update({f"{p}_world1": seq[f"world1_{p}_launches"][name]
                        for p in ("ring", "ulysses")})
        by_path.update({f"ring4_{c}": seq[f"ring4_{c}"]["launches"][name]
                        for c in ("causal", "full")})
        assert all(by_path.values()), (name, by_path)
        kernels.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, launches=launches[name],
                            launches_by_path=by_path,
                            max_abs_err=main_errs[name][0],
                            rel_err=main_errs[name][1], **flag[name]))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    report.update(card=card, device=device, kernels=kernels)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
