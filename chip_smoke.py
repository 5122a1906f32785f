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
             masked launch's against an unmasked one's;
11. negotiated — the flagship's training (world 1 on NCCL,
             DistributedOptimizer(AdamW(3e-4, wd 1e-4)), 10 steps) without
             the native controller, then with it attached
             (init(use_controller=True)): the gradients go as named,
             negotiated and fused responses through the device executor.
             Losses bit-equal to phase 4's and to each other; all_reduce
             calls a step (fused responses against one a parameter),
             names per response, response-cache hits a step (every
             gradient from step 1 on), host step, peak memory; a
             timeline written and parsed (every gradient's name,
             NEGOTIATE and DEVICE_COLLECTIVE events);
12. modes  — the flagship (AdamW(3e-4, wd 1e-4), world 1 on NCCL) with
             (a) remat=True against remat=False through the
             data-parallel step, 3 steps each: losses within rtol 1e-6,
             flash_fwd 16 launches a step against 8, dQ and dK/dV 8;
             on a (dp, pp, mp) = (1, 1, 1) mesh (a mesh Transformer
             through make_train_step, a plain AdamW over the shards):
             (b) GPipe and 1F1B
             at 4 microbatches, 3 steps each: step-0 losses bit-equal,
             step-0 gradients within atol 5e-5 + rtol 1e-4 of each other
             and within 2e-2 normwise of the unpipelined step's, launches
             a step (GPipe 32 of each kernel, 1F1B 64 forward launches:
             its backward replays every stage forward); (c) megatron,
             ring and ulysses attention, 10 steps each: losses equal to
             phase 4's bit for bit; (d) MoE with 8 experts, capacity
             factor 1.25, top_k 1 and 2, 5 steps each: losses finite and
             falling, every kernel once per layer per step, dropped
             routes a step, host step and peak memory;
13. serving — world 1 on NCCL, 8 slots, 16-token pages, 512 tokens a
             slot.  (a) tfm.prefill (bf16, phase 4's weights) of 16-, 200-
             and 512-token prompts: flash_fwd 8 launches a call, dQ and
             dK/dV none; the last row's logits within 1e-2 normwise of
             the same call on the plain attention (HVD_TPU_FLASH=0) and of
             serial_forward_logits' row, argmax equal where the top-2
             margin exceeds 1e-2; flash_fwd timed at (1, 512, 8, 64)
             against its bound, its plain version and SDPA.  (b) fp32
             weights at the same widths (TF32 off), 12 requests, the odd
             ones sampled: token for token co-batched = alone, continuous
             = static, prefix cache on = off (shared 64-token prefixes),
             prefill_chunk 64 = 0, speculative (2-layer self-draft, k 4) =
             plain greedy, a hot-swapped engine = a cold one; 3 greedy
             requests' tokens = serial_forward_logits' argmax over the
             growing sequence; one decode shape.  (c) bf16: train phase
             4's model 4 steps, commit step 4 (serving.save_params);
             ServingService cold-loads it and serves 32 streamed HMAC
             requests over HTTP (an unsigned one refused); commit step 8,
             the watcher hot-swaps it (weights bit-equal to a cold load)
             and 8 later requests equal a cold engine's alone, as 8 of the
             first equal step 4's alone; the engine alone on the same
             load: continuous occupancy above static's, decode tokens/s,
             iteration latency, decode MFU, TTFT, peak memory, the KV
             pool's bytes, one profiled full decode iteration's launches
             and device-busy share; chunked and speculative against plain
             in bf16 printed with the first differing token's margin;
14. telemetry — init() with HVD_TPU_METRICS_PORT set: (a) 10 flagship
             steps of phase 4 inside metrics.compute_span() with
             set_step_flops and step_end(step=i), /metrics scraped over
             loopback: hvd_steps_total 10, each step's wall components
             summing to its wall within 1e-6 s,
             hvd_collective_ops_total{allreduce} equal to the
             dist.all_reduce calls counted at torch.distributed, and the
             live MFU (peak detected from the card's name) within 5% of
             flops / (median step x 989.4e12); (d) the flight dump holds
             one collective.enqueue a named gradient allreduce and step;
             (e) utils.profiler.start_trace/stop_trace around 2 steps
             writes a Chrome trace holding the hvd.allreduce.* ranges and
             8 launches a step of each flash kernel; (b) a step that
             saves a checkpoint shows checkpoint > 0, a step fed by the
             prefetching DataLoader input > 0, and a 4-microbatch GPipe
             step on the (1, 1, 1) mesh the bubble note_bubble credits
             (0 s: one stage); (c) phase 13's engine load: the
             hvd_serving_* token and request counters equal the engine's
             counts; (f) the flagship step's and a full decode
             iteration's host time with the telemetry on and off
             (registry, attribution, flight recorder), in interleaved
             blocks: medians and spreads printed, not gated;
15. models — world 1 on NCCL, the reference's other model families.
             (a) ResNet-50 v1.5 (width 64, 1000 classes, 224x224, bf16,
             sync_bn_axis="data"): at batch 2 in float64, the card's
             logits, loss, gradients and new BN statistics against the
             port on the CPU on the same weights, and stem_s2d's logits
             against the default stem's, each within 1e-9 normwise;
             then 10 steps at batch 128
             through DistributedOptimizer(SGD(0.05, momentum 0.9)): losses
             finite and falling, images/s, MFU, host step, peak memory.
             (b) BERT-Base (vocab 30522, d 768, 12 heads, d_ff 3072, 12
             layers, seq 512, bf16) through make_train_step on a
             (dp, mp) = (1, 1) mesh, batch 16: the dense and gathered
             losses and every gradient through the kernels (non-causal)
             against the plain attention (HVD_TPU_FLASH=0), 12 launches of
             each kernel; then 10 AdamW(1e-4) steps with the gathered head
             in each remat mode (False, True, "dots"): step-0 losses
             agree, launches a step 12/12/12 without remat and with
             "dots" (which recomputes the layer norms only), 24/12/12 with
             full remat, sequences/s, MFU, host step, peak memory; the
             kernels timed at (16, 512, 12, 64) non-causal against their
             bounds, plain versions and SDPA.  (c) the default MoEConfig
             (vocab 32768, d 512, 8 heads, 8 experts of d_ff 2048, top_k 1,
             capacity 1.25, 8 layers, seq 512, bf16, remat) at (dp, ep) =
             (1, 1), batch 8, on the fp32, int8 and int4 dispatch wires:
             10 AdamW steps each, losses finite and falling, launches
             16/8/8 a step, dropped routes, the gspmd wire counters equal
             to 10 times the analytic plan and a forward's bytes at
             dist.all_to_all_single equal to it; the quantized exchange's
             gradient card against CPU (bit for bit with integer
             cotangents).  (d) the MLP of examples/jax_mnist.py, 3 steps.
16. recovery — world 1 on NCCL, the peer tier around the flagship's
             ZeRO stage 2 AdamW training (8 steps through the kernels on
             seeded batches; two uninterrupted runs give the run-to-run
             spread).  (a) Commit at step 4 of {"model":
             model.state_dict(), "opt": optimizer}: extract_zero_state ->
             replicate("opt_state") -> save_extracted -> seal_commit; the
             replicated bytes equal the disk shard's payload bytes;
             extract and replicate timed.  (b) peer_restore and
             restore_zero_state of step 4 into fresh models and
             optimizers of another seed, timed: the report's path is
             "peer", the parameters and moments are on the card and the
             two restores equal bit for bit; steps 5-8 resumed from the
             peer restore give the uninterrupted run's losses and state
             within phase 8's bar; 8 launches of each kernel a step.
             (c) The signed transport on loopback under seeded
             HVD_TPU_CHAOS_NET_RESET_PCT / _TRUNCATE: a RendezvousServer
             and the RecoveryServer with a secret, serve_and_publish,
             lookup_addr, the step-4 entry pushed under a key of its
             own (pending until the sealing push), then fetched back from
             the endpoint's store, verified and equal array for array;
             hvd_net_retries_total{plane="http"} > 0; the push's MB/s.

The last lines are the card line, a JSON line with one entry per kernel
(``launches`` on the main path of phase 4, ``launches_by_path`` on every
path, each counted from 0 just before it ran; every entry also holds
its timing at BERT-Base's shape, non-causal (``bert_noncausal``), and
flash_fwd's at the serving prefill shape), and
``{"ok": true, "device": {...}}``.  Detailed numbers also go to
chiprun_out/chip_smoke.json.  Without a CUDA device it exits non-zero and
prints no result.
"""

import collections
import gc
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


def time_shape(torch, F, fa, b, s, h, d, iters, plain_iters, causal=True):
    """Times (ms) of each kernel, its plain version, and the library call:
    SDPA for the forward; for both backward kernels PyTorch's flash-attention
    backward, which computes dQ, dK and dV in one call."""
    q, k, v, do = rand_qkv(torch, b, s, s, h, d, seed=7)
    scale = 1.0 / math.sqrt(d)
    args = (causal, scale, 0, 0)
    o, lse = fa.flash_fwd(q, k, v, *args)
    _, delta = fa.flash_bwd_dq(q, k, v, do, lse, o, *args)
    qargs = (do, lse, o) + args
    bargs = (do, lse, delta) + args
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    aten = torch.ops.aten
    lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lfwd = aten._scaled_dot_product_flash_attention(lq, lk, lv, 0.0, causal,
                                                    False, scale=scale)

    def library_bwd():
        aten._scaled_dot_product_flash_attention_backward(
            ldo, lq, lk, lv, lfwd[0], lfwd[1], lfwd[2], lfwd[3], lfwd[4],
            lfwd[5], 0.0, causal, lfwd[6], lfwd[7], scale=scale)

    library_bwd_ms = time_ms(torch, library_bwd, iters)
    res = {
        "flash_fwd": (
            time_ms(torch, lambda: fa.flash_fwd(q, k, v, *args), iters),
            time_ms(torch, lambda: fa.attention_with_lse_plain(q, k, v, *args),
                    plain_iters),
            time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters)),
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
        fa.flash_attention(qg, kg, vg, causal=causal).backward(do)

    def sdpa_fb():
        F.scaled_dot_product_attention(
            qg.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            is_causal=causal).backward(do.transpose(1, 2))

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
              make_opt, on_step0=None, on_step=None):
    """``n_steps`` training steps of a fresh seed-0 flagship through
    ``make_train_step`` with the optimizer ``make_opt(model)`` gives:
    losses, host seconds a step, collective calls a step (steps 1..), the
    kernels' launches, the peak bytes allocated on the card above what was
    allocated when the run began, and what ``on_step0(model, opt)``
    returns after step 0.  ``on_step(i)`` runs after each step."""
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
        if on_step is not None:
            on_step(i)
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


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def timeline_spans(events, n_steps):
    """From the controller's Chrome trace, in ms: each device response's
    wait from its first name's enqueue (``NEGOTIATE`` B) to the
    executor's start (``DEVICE_COLLECTIVE`` B), the executor's span (its
    B to E), each tensor's enqueue to finish (``OPERATION`` E), and a
    step's gradients from the first enqueue to the last finish."""
    import collections
    enq, fin = collections.defaultdict(list), collections.defaultdict(list)
    waits, execs, open_exec = [], [], {}
    for e in sorted((e for e in events if e.get("ph") in "BE"),
                    key=lambda e: e["ts"]):
        name, cat, ts = e["name"], e.get("cat"), e["ts"] / 1e3
        if cat == "NEGOTIATE" and e["ph"] == "B":
            enq[name].append(ts)
        elif cat == "OPERATION":
            fin[name].append(ts)
        elif cat == "DEVICE_COLLECTIVE" and e["ph"] == "B":
            open_exec[name] = ts
            waits.append(ts - enq[name][-1])
        elif cat == "DEVICE_COLLECTIVE":
            execs.append(ts - open_exec.pop(name))
    inflight = [f - b for n in enq for b, f in zip(enq[n], fin[n])]
    grads = [n for n in enq if n.startswith("DistributedOptimizer.grad.")]
    steps = [max(fin[n][i] for n in grads) - min(enq[n][i] for n in grads)
             for i in range(min(len(enq[n]) for n in grads))]
    med = statistics.median
    return {"negotiation_wait_ms": med(waits), "executor_ms": med(execs),
            "executor_ms_per_step": sum(execs) / n_steps,
            "tensor_inflight_ms": med(inflight),
            "gradients_first_enqueue_to_last_finish_ms": med(steps),
            "responses": len(execs)}


def phase_negotiated(torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
                     phase4_losses, card):
    """Phase 11: the flagship step with the native controller attached
    (world 1 on NCCL), beside the same step without it; returns the
    report."""
    import tempfile
    from horovod_tpu_torch.core.state import global_state

    def make_opt(model):
        return hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))

    hvd.init()
    flat, _ = train_run(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                        n_steps, make_opt)
    hvd.shutdown()

    os.environ["HVD_TPU_CONTROLLER_ADDR"] = f"127.0.0.1:{free_port()}"
    tmp = tempfile.mkdtemp()
    timeline = os.path.join(tmp, "timeline.json")
    try:
        hvd.init(use_controller=True)
        ctl = global_state.controller
        assert ctl is not None and hvd.nccl_built()
        hvd.start_timeline(timeline)
        snaps = [ctl.stats()]

        def on_step(i):
            snaps.append(ctl.stats())
            if i == n_steps - 1:   # not train_run's profiled step
                hvd.stop_timeline()

        ctl_run, _ = train_run(torch, hvd, tfm, fa, cfg, par, tokens,
                               labels, n_steps, make_opt, on_step=on_step)
        stats = snaps[-1]
        hvd.shutdown()
        with open(timeline) as f:
            events = json.load(f)
    finally:
        del os.environ["HVD_TPU_CONTROLLER_ADDR"]
        if os.path.exists(timeline):
            os.unlink(timeline)
        os.rmdir(tmp)
    hits = [b["cache_hits"] - a["cache_hits"]
            for a, b in zip(snaps, snaps[1:])]
    responses = [b["responses"] - a["responses"]
                 for a, b in zip(snaps, snaps[1:])]
    n_params = len(list(tfm.Transformer(cfg, par, seed=0).parameters()))
    # World 1: the sum over one rank is the identity and Average divides
    # by 1, so the fused responses change no bit.
    assert ctl_run["losses"] == flat["losses"] == phase4_losses, (
        ctl_run["losses"], flat["losses"], phase4_losses)
    assert flat["calls_per_step"]["all_reduce"] == n_params, flat
    # Every gradient of a step after the first announced as a cache bit.
    assert all(h == n_params for h in hits[1:]), hits
    assert 1 <= ctl_run["calls_per_step"]["all_reduce"] < n_params, ctl_run
    names = {e.get("name") for e in events}
    cats = {e.get("cat") for e in events}
    assert {f"DistributedOptimizer.grad.{i}" for i in range(n_params)} \
        <= names, sorted(n for n in names if n)[:20]
    assert {"NEGOTIATE", "DEVICE_COLLECTIVE"} <= cats, cats
    spans = timeline_spans(events, n_steps)
    out = {"flat": flat, "controller": ctl_run, "timeline_spans": spans,
           "cache_hits_per_step": hits, "responses_per_step": responses,
           "names_per_response": stats["names_per_response"],
           "bytes_raw": stats["bytes_raw"], "bytes_sent": stats["bytes_sent"],
           "timeline_events": len(events)}
    log(f"[negotiated] losses bit-equal to phase 4's and to the run "
        f"without the controller; all_reduce calls a step "
        f"{ctl_run['calls_per_step']['all_reduce']:g} (fused responses) "
        f"against {flat['calls_per_step']['all_reduce']:g}; names per "
        f"response {stats['names_per_response']}; response-cache hits a "
        f"step {hits}; host step {ctl_run['step_s'] * 1e3:.3f} ms against "
        f"{flat['step_s'] * 1e3:.3f} ms (medians of steps 1-{n_steps - 1});"
        f" peak allocated {ctl_run['peak_bytes'] / 2**20:.1f} MiB against "
        f"{flat['peak_bytes'] / 2**20:.1f} MiB; device kernels a step "
        f"{ctl_run['device_kernels_per_step']} against "
        f"{flat['device_kernels_per_step']}; timeline {len(events)} events;"
        f" on {card}")
    log(f"[negotiated] timeline, medians: a response waits "
        f"{spans['negotiation_wait_ms']:.3f} ms from its first name's "
        f"enqueue to the executor, which runs "
        f"{spans['executor_ms']:.3f} ms ({spans['executor_ms_per_step']:.3f}"
        f" ms a step); a tensor is in flight "
        f"{spans['tensor_inflight_ms']:.3f} ms; a step's gradients take "
        f"{spans['gradients_first_enqueue_to_last_finish_ms']:.3f} ms from "
        f"the first enqueue to the last finish")
    return out


# Phase 12: the parallel modes at world 1.  Step-0 gradients of GPipe and
# 1F1B against each other (the reference's 1F1B bar, summation order
# only), and each against the unpipelined step normwise (bf16, as phase
# 4's kernel-vs-plain bar); losses of remat against none.
TOL_PIPE = dict(atol=5e-5, rtol=1e-4)
TOL_REMAT_LOSS = 1e-6
MOE_EXPERTS, MOE_CAPACITY = 8, 1.25


def mode_run(torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps,
             mesh=None, keep_grads=False, on_step=None):
    """``n_steps`` of a fresh seed-0 flagship through ``make_train_step``
    with AdamW(3e-4, wd 1e-4): on ``mesh`` a plain optimizer over the
    shards, else ``DistributedOptimizer``.  Returns losses, host step
    (median of steps 1..), peak bytes allocated above the run's start,
    the kernels' launches a step and, with ``keep_grads``, step 0's
    gradients."""
    gc.collect()     # the last run's model and optimizer, held in cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = tfm.Transformer(cfg, par, seed=0, mesh=mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    if mesh is None:
        opt = hvd.DistributedOptimizer(opt)
    step = tfm.make_train_step(cfg, par, model, opt)
    fa.reset_launches()
    losses, times, grads = [], [], None
    for i in range(n_steps):
        t0 = time.perf_counter()
        loss = step(tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if i == 0 and keep_grads:     # on the host: out of the peak
            grads = {n: p.grad.to("cpu", copy=True)
                     for n, p in model.named_parameters()}
        if on_step is not None:
            on_step(i)
    launches = dict(fa.launches)
    out = {"losses": losses, "step_times_s": times,
           "step_s": statistics.median(times[1:]),
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           "launches": launches,
           "launches_per_step": {n: c / n_steps for n, c in launches.items()}}
    assert all(math.isfinite(x) for x in losses), losses
    return out, grads


def grad_diffs(a, b):
    """Per parameter: (the largest excess of |a - b| over atol + rtol |b|
    of ``TOL_PIPE``, ≤ 0 where allclose holds; ||a - b|| / ||b||)."""
    out = {}
    for n, g in b.items():
        d = (a[n] - g).abs()
        excess = (d - TOL_PIPE["atol"] - TOL_PIPE["rtol"] * g.abs()).max()
        out[n] = (excess.item(), ((a[n] - g).norm()
                                  / g.norm().clamp_min(1e-30)).item())
    return out


def phase_modes(torch, hvd, tfm, fa, cfg, tokens, labels, n_steps,
                phase4_losses, card):
    """Phase 12: remat, the pipeline schedules, the attention modes and
    MoE on a (1, 1, 1) mesh; returns the report."""
    from horovod_tpu_torch.parallel import moe as moe_lib
    report = {}
    hvd.init()
    mesh = hvd.parallel.create_mesh({"dp": 1, "pp": 1, "mp": 1})
    P = tfm.ParallelConfig

    # (a) remat against none, the data-parallel path.
    runs = {}
    for remat in (False, True):
        runs[remat], _ = mode_run(torch, hvd, tfm, fa,
                                  cfg._replace(remat=remat), P(), tokens,
                                  labels, 3)
    plain, remat = runs[False], runs[True]
    for a, b in zip(remat["losses"], plain["losses"]):
        assert abs(a - b) <= TOL_REMAT_LOSS * abs(b), (remat, plain)
    want = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for n, k in want.items():
        assert remat["launches_per_step"][n] == k * cfg.n_layers, remat
        assert plain["launches_per_step"][n] == cfg.n_layers, plain
    report["remat"] = {"remat": remat, "none": plain}
    log(f"[modes] (a) remat: losses {remat['losses']} against "
        f"{plain['losses']}; launches a step {remat['launches_per_step']} "
        f"against {plain['launches_per_step']}; host step "
        f"{remat['step_s'] * 1e3:.3f} ms against "
        f"{plain['step_s'] * 1e3:.3f} ms; peak allocated "
        f"{remat['peak_bytes'] / 2**20:.1f} MiB against "
        f"{plain['peak_bytes'] / 2**20:.1f} MiB; on {card}")

    # (b) GPipe and 1F1B at pp 1 and 4 microbatches, against each other
    # and the unpipelined step.
    pipe, grads = {}, {}
    for label, par in (("unpipelined", P()),
                       ("gpipe", P(n_microbatches=4)),
                       ("1f1b", P(n_microbatches=4, pp_schedule="1f1b"))):
        pipe[label], grads[label] = mode_run(
            torch, hvd, tfm, fa, cfg, par, tokens, labels, 3, mesh=mesh,
            keep_grads=True)
    assert pipe["gpipe"]["losses"][0] == pipe["1f1b"]["losses"][0], pipe
    assert abs(pipe["gpipe"]["losses"][0] - phase4_losses[0]) <= TOL_LOSS
    between = grad_diffs(grads["1f1b"], grads["gpipe"])
    against = {label: grad_diffs(grads[label], grads["unpipelined"])
               for label in ("gpipe", "1f1b")}
    assert all(e <= 0 for e, _ in between.values()), between
    assert all(r <= TOL_MODEL_GRAD_REL for d in against.values()
               for _, r in d.values()), against
    mb = 4 * cfg.n_layers
    assert pipe["gpipe"]["launches_per_step"] == {
        n: mb for n in KERNELS}, pipe["gpipe"]
    assert pipe["1f1b"]["launches_per_step"] == {
        "flash_fwd": 2 * mb, "flash_bwd_dq": mb, "flash_bwd_dkv": mb}, \
        pipe["1f1b"]
    del grads
    report["pipeline"] = dict(pipe, grads_1f1b_vs_gpipe=between,
                              grads_vs_unpipelined=against)
    log(f"[modes] (b) pp 1, 4 microbatches: step-0 loss gpipe "
        f"{pipe['gpipe']['losses'][0]} == 1f1b {pipe['1f1b']['losses'][0]}"
        f" (unpipelined {pipe['unpipelined']['losses'][0]}); step-0 "
        f"gradients 1f1b vs gpipe within atol 5e-5 + rtol 1e-4 (largest "
        f"normwise {max(r for _, r in between.values()):.3g}), vs the "
        f"unpipelined step normwise at most "
        f"{max(r for d in against.values() for _, r in d.values()):.3g}; "
        f"launches a step gpipe {pipe['gpipe']['launches_per_step']}, 1f1b "
        f"{pipe['1f1b']['launches_per_step']}; host step gpipe "
        f"{pipe['gpipe']['step_s'] * 1e3:.3f} ms, 1f1b "
        f"{pipe['1f1b']['step_s'] * 1e3:.3f} ms, unpipelined "
        f"{pipe['unpipelined']['step_s'] * 1e3:.3f} ms; peak "
        f"{pipe['gpipe']['peak_bytes'] / 2**20:.1f} / "
        f"{pipe['1f1b']['peak_bytes'] / 2**20:.1f} / "
        f"{pipe['unpipelined']['peak_bytes'] / 2**20:.1f} MiB")

    # (c) the attention modes at mp 1: phase 4's step, bit for bit.
    report["attention"] = {}
    for mode in ("megatron", "ring", "ulysses"):
        run, _ = mode_run(torch, hvd, tfm, fa, cfg._replace(attn_mode=mode),
                          P(), tokens, labels, n_steps, mesh=mesh)
        assert run["losses"] == phase4_losses, (mode, run["losses"],
                                                phase4_losses)
        assert run["launches_per_step"] == {
            n: cfg.n_layers for n in KERNELS}, run
        report["attention"][mode] = run
    log(f"[modes] (c) megatron, ring and ulysses at mp 1 on the mesh: "
        f"{n_steps} losses each equal to phase 4's bit for bit; host step "
        + ", ".join(f"{m} {r['step_s'] * 1e3:.3f} ms"
                    for m, r in report["attention"].items()))

    # (d) MoE: 8 experts, capacity factor 1.25, top_k 1 and 2.
    report["moe"] = {}
    tokens_per_step = tokens.numel()
    for top_k in (1, 2):
        dropped = []
        per_step = []
        orig = moe_lib.moe_layer

        def counting(*args, **kwargs):
            out, st = orig(*args, return_stats=True, **kwargs)
            dropped.append(st.dropped)
            return out

        def on_step(i):     # the step's MoE layers, each routed once
            assert len(dropped) == cfg.n_layers, (i, len(dropped))
            per_step.append(float(sum(d.item() for d in dropped)))
            dropped.clear()

        moe_cfg = cfg._replace(n_experts=MOE_EXPERTS,
                               capacity_factor=MOE_CAPACITY, top_k=top_k)
        moe_lib.moe_layer = counting
        try:
            run, _ = mode_run(torch, hvd, tfm, fa, moe_cfg, P(), tokens,
                              labels, 5, mesh=mesh, on_step=on_step)
        finally:
            moe_lib.moe_layer = orig
        assert run["losses"][-1] < run["losses"][0], run["losses"]
        assert run["launches_per_step"] == {
            n: cfg.n_layers for n in KERNELS}, run
        routed = tokens_per_step * top_k * cfg.n_layers
        run.update(dropped_per_step=per_step, routed_per_step=routed,
                   capacity=moe_lib.expert_capacity(
                       tokens_per_step, MOE_EXPERTS, MOE_CAPACITY, top_k))
        report["moe"][f"top{top_k}"] = run
        log(f"[modes] (d) MoE {MOE_EXPERTS} experts, capacity factor "
            f"{MOE_CAPACITY}, top_k {top_k} (capacity {run['capacity']} "
            f"slots an expert): losses {run['losses']}; dropped routes a "
            f"step {per_step} of {routed}; host step "
            f"{run['step_s'] * 1e3:.3f} ms (median of steps 1-4); peak "
            f"allocated {run['peak_bytes'] / 2**20:.1f} MiB; launches a "
            f"step {run['launches_per_step']}; on {card}")
    hvd.shutdown()
    return report


# Phase 13: serving on the flagship.  The geometry: 8 slots, 16-token
# pages, 512 tokens a slot (2 x 8 layers x 257 pages x 16 x 8 x 64 bf16:
# a 67,371,008-byte pool).  (a) prefill prompt lengths; (b) the fp32
# exactness drills' schedules; (c) the train→serve loop's load.
SERVE_GEOMETRY = dict(slots=8, page_tokens=16, max_len=512)
PREFILL_LENS = (16, 200, 512)
ARGMAX_MARGIN = 1e-2      # argmax must agree where the top-2 gap exceeds it
SERVE_SECRET = "chip-smoke-serving"
SERVE_LOAD = dict(seed=7, n=32, rate_rps=0.0, prompt_lens=(16, 256),
                  output_lens=(16, 64), vocab=8192)
AFTER_SWAP_LOAD = dict(SERVE_LOAD, seed=8, n=8)
DRILL_LOAD = dict(n=12, prompt_lens=(16, 160), output_lens=(8, 32))
DRILL_PREFIX = dict(prefix=64, suffix=(8, 64), outputs=(8, 24))
DRILL_CHUNK = 64
DRAFT = dict(layers=2, k=4)
PROFILE_REQUEST = dict(prompt=128, outputs=64)


def top2_margin(torch, row):
    top = row.float().topk(2).values
    return (top[0] - top[1]).item()


def stream_generate(addr, payload, secret):
    """POST one streamed /serve/generate with the HMAC signature; returns
    (tokens, seconds to the first token, seconds to the done record)."""
    import urllib.request
    from horovod_tpu_torch.runner.rendezvous import _signature
    body = json.dumps(dict(payload, stream=True)).encode()
    req = urllib.request.Request(f"http://{addr}/serve/generate", data=body)
    req.add_header("X-HVD-Signature",
                   _signature(secret, "POST", "serve", "generate", body))
    t0 = time.monotonic()
    toks, first, done = [], None, None
    with urllib.request.urlopen(req, timeout=300) as resp:
        for line in resp:
            rec = json.loads(line)
            if "token" in rec:
                toks.append(rec["token"])
                first = first if first is not None else time.monotonic() - t0
            elif rec.get("done"):
                assert rec["tokens"] == toks, rec
                done = time.monotonic() - t0
            else:
                raise AssertionError(f"serving error record {rec}")
    assert done is not None, toks
    return toks, first, done


def serve_over_http(addr, schedule, secret):
    """Fire every request of ``schedule`` at once, one streaming client
    thread each; returns ({id: (tokens, ttft, total)}, wall seconds)."""
    import threading
    out, errors = {}, []

    def one(req):
        try:
            out[req.id] = stream_generate(addr, {
                "id": req.id, "tokens": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "temperature": req.temperature, "seed": req.seed}, secret)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((req.id, repr(e)))

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(r,)) for _, r in schedule]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert len(out) == len(schedule), sorted(out)
    return out, time.monotonic() - t0


def drive_timed(S, engine, schedule, continuous=True):
    """``loadgen.drive`` with each ``engine.step`` (prefill_chunk 0: the
    decode iterations) and ``admit`` (the prefills) timed on the host."""
    step, admit, steps, admits = engine.step, engine.admit, [], []

    def timed(fn, log_):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log_.append(time.perf_counter() - t0)
            return out
        return call

    engine.step, engine.admit = timed(step, steps), timed(admit, admits)
    try:
        out = S.drive(engine, schedule, continuous=continuous)
    finally:
        del engine.step, engine.admit
    out.update(step_s=steps, admit_s=admits)
    return out


def tokens_of(result):
    return {rid: r["tokens"] for rid, r in result["results"].items()}


def first_difference_margin(torch, tfm, cfg, params, prompt, a, b):
    """Where two outputs of one prompt part: (index, a's token, b's token,
    the top-2 margin of the logits there over the common prefix, one
    decode_verify call on a fresh pool), or None."""
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return None
    seq = list(prompt) + list(a[:j])
    page = SERVE_GEOMETRY["page_tokens"]
    n = -(-len(seq) // page)
    dev = tfm._tree(params)["embed"].device
    kv = tfm.init_kv_pages(cfg, n + 1, page, device=dev)
    toks = torch.zeros((1, n * page), dtype=torch.long, device=dev)
    toks[0, :len(seq)] = torch.tensor(seq, device=dev)
    tables = torch.arange(1, n + 1, device=dev)[None]
    logits, _ = tfm.decode_verify(cfg, params, toks,
                                  torch.zeros(1, dtype=torch.long,
                                              device=dev), kv, tables)
    return j, a[j], b[j], top2_margin(torch, logits[0, len(seq) - 1])


def decode_flops(tfm, cfg, schedule, results):
    """Matmul-FLOPs of the decode iterations of a finished run: each
    token after the first attends the prompt and the tokens before it."""
    total = 0.0
    for _, req in schedule:
        n = len(results[req.id]["tokens"])
        plen = len(req.prompt)
        total += sum(tfm.decode_flops_per_token(cfg, plen + j + 1)
                     for j in range(n - 1))
    return total


def busy_share(torch, engine, n_steps):
    """Profile ``n_steps`` decode iterations of a full engine: kernel
    launches and device-busy time (union of kernel intervals) a step,
    over the host's wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted((e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy, (cur_s, cur_e) = 0.0, kernels[0]
    for s, e in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s                                   # microseconds
    return {"steps": n_steps, "wall_ms_per_step": wall / n_steps * 1e3,
            "busy_ms_per_step": busy / n_steps / 1e3,
            "busy_share": busy / 1e6 / wall,
            "launches_per_step": len(kernels) / n_steps}


def phase_serving(torch, hvd, tfm, fa, cfg, par, model, tokens, labels,
                  card):
    """Phase 13: the serving plane on the flagship; returns the report.
    ``model`` is phase 4's trained model (fp32 master weights)."""
    import shutil
    import tempfile
    from horovod_tpu_torch import serving as S
    report = {}
    hvd.init()
    dev = hvd.device()

    # (a) prefill through flash_fwd, bf16, against the plain attention
    # and the training forward's row.
    rng = __import__("numpy").random.default_rng(13)
    page = SERVE_GEOMETRY["page_tokens"]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PREFILL_LENS]

    def prefill_all():
        out = []
        for p in prompts:
            s = -(-len(p) // page) * page
            toks = torch.zeros(s, dtype=torch.long, device=dev)
            toks[:len(p)] = torch.from_numpy(p)
            kv = tfm.init_kv_pages(cfg, s // page + 1, page)
            rows = torch.arange(1, s // page + 1, device=dev)
            out.append(tfm.prefill(cfg, model, toks, len(p), kv, rows)[0])
        torch.cuda.synchronize()
        return out

    fa.reset_launches()
    t0 = time.perf_counter()
    kernel_rows = prefill_all()
    prefill_wall = time.perf_counter() - t0
    prefill_launches = dict(fa.launches)
    assert prefill_launches == {
        "flash_fwd": cfg.n_layers * len(PREFILL_LENS), "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0}, prefill_launches
    os.environ["HVD_TPU_FLASH"] = "0"
    plain_rows = prefill_all()
    del os.environ["HVD_TPU_FLASH"]
    prefill_report = []
    with torch.no_grad():
        for p, got, plain in zip(prompts, kernel_rows, plain_rows):
            serial = tfm.serial_forward_logits(
                cfg, model, torch.from_numpy(p).to(dev)[None])[0, -1]
            rel = {name: ((got - ref).norm() / ref.norm()).item()
                   for name, ref in (("plain", plain), ("serial", serial))}
            margin = top2_margin(torch, plain)
            assert all(r <= TOL_REL for r in rel.values()), (len(p), rel)
            if margin > ARGMAX_MARGIN:
                assert got.argmax() == plain.argmax() == serial.argmax(), \
                    (len(p), margin)
            prefill_report.append({"length": len(p), "rel": rel,
                                   "top2_margin": margin,
                                   "argmax": int(got.argmax())})
    shape = (1, PREFILL_LENS[-1], cfg.n_heads, cfg.head_dim)
    q, k, v, _ = rand_qkv(torch, shape[0], shape[1], shape[1], *shape[2:],
                          seed=13)
    fargs = (True, 1.0 / math.sqrt(cfg.head_dim), 0, 0)
    bnd = bounds(*shape)["flash_fwd"]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    F = torch.nn.functional
    kernel_timing = {
        "shape": shape,
        "ms": time_ms(torch, lambda: fa.flash_fwd(q, k, v, *fargs), 50),
        "plain_ms": time_ms(torch, lambda: fa.attention_with_lse_plain(
            q, k, v, *fargs), 10),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 50),
        "bound_ms": bnd[0], "bound_by": bnd[1]}
    report["prefill"] = {"rows": prefill_report,
                         "launches": prefill_launches,
                         "launches_per_call": {
                             n: c / len(PREFILL_LENS)
                             for n, c in prefill_launches.items()},
                         "wall_s_three_calls": prefill_wall,
                         "flash_fwd_timing": kernel_timing}
    log(f"[serving] (a) prefill of {PREFILL_LENS} tokens (bf16, phase 4's "
        f"weights): flash_fwd {prefill_launches['flash_fwd']} launches "
        f"({cfg.n_layers} a call), dQ/dKV 0; last-row logits normwise vs "
        f"plain attention / serial forward: "
        + ", ".join(f"{r['length']}: {r['rel']['plain']:.3g} / "
                    f"{r['rel']['serial']:.3g} (top-2 margin "
                    f"{r['top2_margin']:.3g})" for r in prefill_report)
        + f"; flash_fwd at {shape} {kernel_timing['ms']:.4f} ms "
        f"(bound {bnd[0]:.4f} ms by {bnd[1]}), plain "
        f"{kernel_timing['plain_ms']:.4f} ms, SDPA "
        f"{kernel_timing['library_ms']:.4f} ms; on {card}")

    # (b) exactness drills in fp32 at the flagship's widths.
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg32 = cfg._replace(dtype=torch.float32)
    log(f"[serving] (b) fp32 drills: torch.backends.cuda.matmul.allow_tf32"
        f" = {torch.backends.cuda.matmul.allow_tf32}; on {card}")

    def engine32(params=model, **kw):
        return S.DecodeEngine(cfg32, params, **{**SERVE_GEOMETRY, **kw})

    def drill_schedule(greedy_only=False, seed=11):
        sched = S.synthetic_workload(seed, DRILL_LOAD["n"], 0.0,
                                     prompt_lens=DRILL_LOAD["prompt_lens"],
                                     output_lens=DRILL_LOAD["output_lens"],
                                     vocab=cfg.vocab_size)
        if not greedy_only:        # odd requests sample, seeded
            for i, (_, r) in enumerate(sched):
                if i % 2:
                    r.temperature, r.seed = 1.0, 100 + i
        return sched

    def same(name, a, b):
        assert a == b, (name, {k: (a[k], b.get(k)) for k in a
                               if a[k] != b.get(k)})

    drills = {}
    base_engine = engine32()
    base = tokens_of(S.drive(base_engine, drill_schedule()))
    assert base_engine.decode_traces == 1, base_engine.stats()
    alone_engine = engine32()
    alone = {}
    for _, r in drill_schedule():
        alone.update(tokens_of(S.drive(alone_engine, [(0.0, r)])))
    same("co-batched vs alone", base, alone)
    static = S.drive(engine32(), drill_schedule(), continuous=False)
    same("continuous vs static", base, tokens_of(static))

    heads = [list(rng.integers(0, cfg.vocab_size, DRILL_PREFIX["prefix"]))
             for _ in range(4)]

    def prefix_schedule():
        r2 = __import__("numpy").random.default_rng(17)
        lo, hi = DRILL_PREFIX["suffix"]
        return [(0.0, S.Request(
            id=f"x{i}", prompt=[int(t) for t in heads[i % 4] + list(
                r2.integers(0, cfg.vocab_size, int(r2.integers(lo, hi))))],
            max_new_tokens=int(r2.integers(*DRILL_PREFIX["outputs"])),
            submit_seq=i)) for i in range(DRILL_LOAD["n"])]

    cached_engine = engine32(prefix_cache=True)
    on = tokens_of(S.drive(cached_engine, prefix_schedule()))
    off = tokens_of(S.drive(engine32(prefix_cache=False), prefix_schedule()))
    same("prefix cache on vs off", on, off)
    drills["prefix_cache"] = cached_engine.stats()["prefix_cache"]
    assert drills["prefix_cache"]["hits"] > 0, drills
    chunked = tokens_of(S.drive(engine32(prefill_chunk=DRILL_CHUNK),
                                drill_schedule()))
    same(f"prefill_chunk {DRILL_CHUNK} vs 0", base, chunked)
    draft = S.DraftSpec(cfg=tfm.draft_config(cfg32, DRAFT["layers"]),
                        params=tfm.draft_params_from(model, DRAFT["layers"]),
                        k=DRAFT["k"])
    spec_engine = engine32(draft=draft)
    greedy = tokens_of(S.drive(engine32(), drill_schedule(True)))
    speculative = tokens_of(S.drive(spec_engine, drill_schedule(True)))
    same("speculative vs plain greedy", greedy, speculative)
    drills["speculative"] = spec_engine.stats()["speculative"]
    other = tfm._tree(tfm.Transformer(cfg32, par, seed=5))
    sched, half = drill_schedule(), DRILL_LOAD["n"] // 2
    hot_engine = engine32()
    S.drive(hot_engine, sched[:half])
    hot_engine.swap_params(other, "seed5")
    hot = tokens_of(S.drive(hot_engine, sched[half:]))
    assert hot_engine.params_tag == "seed5" and hot_engine.swaps == 1
    cold = tokens_of(S.drive(engine32(other), drill_schedule()[half:]))
    same("hot swap vs cold", hot, cold)
    checked = 0
    with torch.no_grad():
        for _, r in [x for x in drill_schedule() if not x[1].temperature][:3]:
            seq = list(r.prompt)
            for tok in base[r.id]:
                row = tfm.serial_forward_logits(
                    cfg32, model, torch.tensor([seq], device=dev))[0, -1]
                assert int(row.argmax()) == tok, (r.id, len(seq))
                seq.append(tok)
                checked += 1
    repeats = sum(sum(1 for a, b in zip(t, t[1:]) if a == b)
                  for t in base.values())
    drills.update(checked_against_serial=checked,
                  tokens=sum(len(t) for t in base.values()),
                  repeated_previous_token=repeats)
    report["drills_fp32"] = drills
    sp = drills["speculative"]
    log(f"[serving] (b) token for token on {DRILL_LOAD['n']} requests (odd "
        f"ones sampled at temperature 1, seeded): co-batched = alone, "
        f"continuous = static, "
        f"prefix cache on = off ({drills['prefix_cache']['hits']} hits, "
        f"{drills['prefix_cache']['tokens_reused']} tokens reused), "
        f"prefill_chunk {DRILL_CHUNK} = 0, speculative ({DRAFT['layers']}-"
        f"layer self-draft, k {DRAFT['k']}) = plain greedy "
        f"(accepted/proposed {sp['accepted']}/{sp['proposed']}"
        f" = {sp['acceptance_rate']}), hot swap = cold; {checked} tokens "
        f"equal to serial_forward_logits' argmax; decode_traces 1; "
        f"{repeats} of {drills['tokens']} tokens repeat the one before; on "
        f"{card}")
    del base_engine, alone_engine, cached_engine, spec_engine, hot_engine
    gc.collect()

    # (c) the train→serve loop in bf16: train, commit, serve over HTTP,
    # commit again, hot swap, hold to a cold engine.
    ckpt_root = tempfile.mkdtemp(prefix="hvd_serving_")
    ckpt = os.path.join(ckpt_root, "ckpt")
    try:
        trainee = tfm.Transformer(cfg, par, seed=0)
        hvd.broadcast_parameters(trainee.state_dict())
        train = tfm.make_train_step(cfg, par, trainee, hvd.DistributedOptimizer(
            torch.optim.AdamW(trainee.parameters(), lr=3e-4,
                              weight_decay=1e-4)))
        losses = [train(tokens, labels).item() for _ in range(4)]
        S.save_params(ckpt, trainee, 4)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        svc = S.ServingService(cfg, checkpoint_dir=ckpt, secret=SERVE_SECRET,
                               port=0, swap_poll_s=0.1, **SERVE_GEOMETRY)
        assert svc.engine.params_tag == 4
        kv_bytes = sum(t.numel() * t.element_size()
                       for t in svc.engine._kv.values())
        addr = f"127.0.0.1:{svc.serve()}"
        try:
            import urllib.error
            import urllib.request
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://{addr}/serve/generate",
                    data=b'{"tokens": [1, 2, 3]}'), timeout=30)
            except urllib.error.HTTPError as e:
                assert e.code == 403, e.code
            else:
                raise AssertionError("an unsigned request was served")
            load = S.synthetic_workload(**SERVE_LOAD)
            served, wall = serve_over_http(addr, load, SERVE_SECRET)
            peak = torch.cuda.max_memory_allocated() - mem0
            ttft = sorted(t for _, (_, t, _) in served.items())
            engine_ttft = sorted(t for t, _ in svc.engine.ttft_samples)
            n_tok = sum(len(t) for t, _, _ in served.values())
            assert all(len(served[r.id][0]) == r.max_new_tokens
                       for _, r in load)
            # Commit step 8; the watcher parks it, the loop applies it.
            losses += [train(tokens, labels).item() for _ in range(4)]
            S.save_params(ckpt, trainee, 8)
            deadline = time.monotonic() + 60
            while svc.engine.params_tag != 8 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert svc.engine.params_tag == 8, svc.engine.params_tag
            after = S.synthetic_workload(**AFTER_SWAP_LOAD)
            served8, _ = serve_over_http(addr, after, SERVE_SECRET)
            hot_params = svc.engine._params
            stats = svc.status()
        finally:
            svc.close()
        p8, _ = S.load_params(ckpt, svc.like, step=8)
        for name, t in tfm._tree(p8).items():
            ref = hot_params[name]
            if isinstance(t, dict):
                assert all(torch.equal(t[k], ref[k]) for k in t), name
            else:
                assert torch.equal(t, ref), name
        cold8 = S.DecodeEngine(cfg, p8, **SERVE_GEOMETRY)
        for _, r in S.synthetic_workload(**AFTER_SWAP_LOAD):
            got = tokens_of(S.drive(cold8, [(0.0, r)]))[r.id]
            assert got == served8[r.id][0], ("hot swap vs cold", r.id)
        p4, _ = S.load_params(ckpt, svc.like, step=4)
        cold4 = S.DecodeEngine(cfg, p4, **SERVE_GEOMETRY)
        for _, r in S.synthetic_workload(**SERVE_LOAD)[:8]:
            got = tokens_of(S.drive(cold4, [(0.0, r)]))[r.id]
            assert got == served[r.id][0], ("co-batched vs alone", r.id)
        # The engine alone on the same schedule: continuous vs static,
        # decode time, MFU, then chunked and speculative (printed).
        runs = {}
        for label, kw, cont in (("continuous", {}, True),
                                ("static", {}, False),
                                ("chunked", {"prefill_chunk": DRILL_CHUNK},
                                 True)):
            e = S.DecodeEngine(cfg, p4, **SERVE_GEOMETRY, **kw)
            sched = S.synthetic_workload(**SERVE_LOAD)
            runs[label] = drive_timed(S, e, sched, continuous=cont)
            runs[label]["decode_traces"] = e.decode_traces
        cont, stat = runs["continuous"], runs["static"]
        assert cont["occupancy"] > stat["occupancy"], (cont["occupancy"],
                                                      stat["occupancy"])
        assert tokens_of(cont) == tokens_of(stat) == {
            k: v[0] for k, v in served.items()}
        flops = decode_flops(tfm, cfg, S.synthetic_workload(**SERVE_LOAD),
                             cont["results"])
        step_s = sum(cont["step_s"])
        dec_tokens = cont["tokens"] - len(cont["results"])
        mfu = flops / step_s / PEAK_BF16_FLOPS
        greedy_load = S.synthetic_workload(**SERVE_LOAD)
        spec_e = S.DecodeEngine(cfg, p4, **SERVE_GEOMETRY, draft=S.DraftSpec(
            cfg=tfm.draft_config(cfg, DRAFT["layers"]),
            params=tfm.draft_params_from(p4, DRAFT["layers"]), k=DRAFT["k"]))
        spec_out = tokens_of(S.drive(spec_e, greedy_load))
        divergence = {}
        for label, other_out in (("chunked", tokens_of(runs["chunked"])),
                                 ("speculative", spec_out)):
            diffs = [(r.id, first_difference_margin(
                torch, tfm, cfg, p4, r.prompt, tokens_of(cont)[r.id],
                other_out[r.id])) for _, r in greedy_load]
            diffs = [(rid, d) for rid, d in diffs if d is not None]
            divergence[label] = {"requests_differing": len(diffs),
                                 "first": diffs[0] if diffs else None}
        # One profiled decode: the engine full, every slot decoding.
        prof_e = S.DecodeEngine(cfg, p4, **SERVE_GEOMETRY)
        for i in range(SERVE_GEOMETRY["slots"]):
            prof_e.admit(S.Request(
                id=f"b{i}", prompt=[int(t) for t in rng.integers(
                    0, cfg.vocab_size, PROFILE_REQUEST["prompt"])],
                max_new_tokens=PROFILE_REQUEST["outputs"]))
        for _ in range(3):
            prof_e.step()
        profile = busy_share(torch, prof_e, 3)
        token_lat = sorted(cont["step_s"])
        http_tok_s = n_tok / wall
        report["train_serve"] = {
            "train_losses": losses, "kv_pool_bytes": kv_bytes,
            "peak_bytes_serving": peak,
            "http": {"requests": len(load), "tokens": n_tok, "wall_s": wall,
                     "tokens_per_s": http_tok_s,
                     "client_ttft_p50_s": S.loadgen.percentile(ttft, 0.5),
                     "client_ttft_p99_s": S.loadgen.percentile(ttft, 0.99),
                     "engine_ttft_p50_s": S.loadgen.percentile(engine_ttft,
                                                              0.5),
                     "engine_ttft_p99_s": S.loadgen.percentile(engine_ttft,
                                                              0.99)},
            "engine": {"decode_tokens": dec_tokens, "decode_s": step_s,
                       "decode_tokens_per_s": dec_tokens / step_s,
                       "iterations": len(cont["step_s"]),
                       "iteration_p50_s": statistics.median(token_lat),
                       "iteration_p99_s": S.loadgen.percentile(token_lat,
                                                               0.99),
                       "prefill_p50_s": statistics.median(cont["admit_s"]),
                       "decode_flops": flops, "decode_mfu": mfu,
                       "occupancy_continuous": cont["occupancy"],
                       "occupancy_static": stat["occupancy"],
                       "wall_continuous_s": cont["wall_s"],
                       "wall_static_s": stat["wall_s"],
                       "decode_traces": cont["decode_traces"]},
            "profiled_decode": profile, "divergence_bf16": divergence,
            "server_stats": {k: v for k, v in stats.items()
                             if isinstance(v, (int, float, str))}}
        ts = report["train_serve"]
        log(f"[serving] (c) trained 4 steps (losses {losses[:4]}), committed"
            f" step 4, ServingService cold-loaded it; an unsigned request "
            f"refused (403); {len(load)} streamed HMAC requests, {n_tok} "
            f"tokens in {wall:.3f} s over HTTP ({http_tok_s:.1f} tokens/s), "
            f"TTFT p50/p99 client {ts['http']['client_ttft_p50_s']} / "
            f"{ts['http']['client_ttft_p99_s']} s, at the engine "
            f"{ts['http']['engine_ttft_p50_s']} / "
            f"{ts['http']['engine_ttft_p99_s']} s; step 8 committed and "
            f"hot-swapped between iterations (weights bit-equal to a cold "
            f"load), {len(after)} later requests token for token equal to a "
            f"cold engine on step 8 alone, 8 of the first equal to step 4 "
            f"alone; on {card}")
        en = ts["engine"]
        log(f"[serving] (c) engine alone on the same {len(load)} requests: "
            f"decode "
            f"{en['decode_tokens_per_s']:.1f} tokens/s ({en['decode_tokens']}"
            f" tokens in {en['decode_s']:.3f} s of {en['iterations']} "
            f"iterations), iteration p50 {en['iteration_p50_s'] * 1e3:.3f} ms"
            f" p99 {en['iteration_p99_s'] * 1e3:.3f} ms, prefill p50 "
            f"{en['prefill_p50_s'] * 1e3:.3f} ms, decode MFU {mfu:.3g} of 989 "
            f"TFLOP/s; occupancy continuous {cont['occupancy']:.4f} vs static "
            f"{stat['occupancy']:.4f} (wall {cont['wall_s']:.3f} vs "
            f"{stat['wall_s']:.3f} s); KV pool {kv_bytes:,} bytes, peak "
            f"{peak / 2**20:.1f} MiB above the service's start; a profiled "
            f"full decode iteration: {profile['launches_per_step']:.0f} "
            f"kernel launches, device busy {profile['busy_ms_per_step']:.3f} "
            f"of {profile['wall_ms_per_step']:.3f} ms "
            f"({profile['busy_share']:.3f}); bf16 divergence (printed, not "
            f"gated): {divergence}; on {card}")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    hvd.shutdown()
    return report


# ---------------------------------------------------------------------------
# Phase 14: the step telemetry plane on the card
# ---------------------------------------------------------------------------

# The dense bf16 peak the live MFU is held to (NVIDIA's H100 SXM sheet;
# the attribution engine detects it from the card's name).
PEAK_H100_SXM = 989.4e12
TELEMETRY_STEPS = 10
TOL_WALL_S = 1e-6          # the wall components against the step's wall
# compute + comm_exposed against the compute span the phase times itself
# (the span holds the collectives' CUDA time): the median step's
# difference, which is the span's own enter/exit cost, a few microseconds.
TOL_SPAN_S = 5e-5
TOL_MFU = 0.05             # live MFU against the phase's own
OVERHEAD_BLOCKS = ("on", "off", "off", "on", "on", "off")
OVERHEAD_STEPS = 5         # steps (decode iterations) a block
TRACE_STEPS = 2
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def scrape(port):
    """``GET /metrics`` over loopback: {series: value} of the text."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return text, out


def count_every(dist, name):
    """Count every call of ``dist.<name>`` (one-element ones too); returns
    the count holder and a function that restores the call."""
    count = [0]
    saved = getattr(dist, name)

    def call(*args, **kwargs):
        count[0] += 1
        return saved(*args, **kwargs)

    setattr(dist, name, call)
    return count, lambda: setattr(dist, name, saved)


def spread(xs):
    return {"median_ms": statistics.median(xs) * 1e3,
            "min_ms": min(xs) * 1e3, "max_ms": max(xs) * 1e3}


def telemetry_switch(on):
    """Everything the telemetry records, on or off: the registry, the
    step attribution (``HVD_TPU_ATTRIBUTION``) and the flight recorder
    (``HVD_TPU_FLIGHT_DISABLE``)."""
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch.metrics import attribution as A
    metrics.set_enabled(on)
    A.set_enabled(on)
    debug.set_enabled(on)


def phase_telemetry(torch, hvd, tfm, fa, cfg, par, model, tokens, labels,
                    card):
    """Phase 14: the flagship step and a serving burst reporting through
    the telemetry plane; returns the report."""
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch import serving as S
    from horovod_tpu_torch.data import ArraySource, DataLoader
    from horovod_tpu_torch.metrics import attribution as A
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.utils import profiler as prof
    report = {}
    port = free_port()
    work = tempfile.mkdtemp(prefix="hvd_telemetry_")
    os.environ.update(HVD_TPU_METRICS_PORT=str(port),
                      HVD_TPU_FLIGHT_DIR=work)
    os.environ.pop("HVD_TPU_PEAK_TFLOPS", None)
    A.reset_peak_cache()
    hvd.init()
    try:
        batch = tokens.shape[0]
        flops = tfm.train_flops_per_seq(cfg) * batch
        trainee = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            trainee.parameters(), lr=3e-4, weight_decay=1e-4))
        step = tfm.make_train_step(cfg, par, trainee, opt)
        n_grads = len(list(trainee.parameters()))
        step(tokens, labels)                  # warm-up, outside the count
        torch.cuda.synchronize()

        # (a) ten steps under compute_span / step_end(step=i), scraped.
        # Each step's wall is the interval between two step_end calls: the
        # first has none, and the first close anchors the attribution's
        # window (as in the reference), so steps 3.. carry records.  The
        # phase times each compute span itself too: the span waits for
        # the stream, so it holds the collectives' CUDA time, which must
        # land in comm_exposed and not in compute as well.
        metrics.set_step_flops(flops)
        torch.cuda.synchronize()
        C.drain_device_latency()       # earlier phases' CUDA-event pairs
        _, before = scrape(port)
        seq0 = debug.snapshot(last=1)[-1]["seq"]
        calls, restore = count_every(dist, "all_reduce")
        fa.reset_launches()
        records, times, spans = [], [], []
        try:
            for i in range(1, TELEMETRY_STEPS + 1):
                t0 = time.perf_counter()
                with metrics.compute_span():
                    loss = step(tokens, labels)
                spans.append(time.perf_counter() - t0)
                metrics.step_end(step=i)
                times.append(time.perf_counter() - t0)
                records.append(metrics.last_attribution())
        finally:
            restore()
        seq1 = debug.snapshot(last=1)[-1]["seq"]
        assert records[0] is None and records[1] is None, records[:2]
        records, times, spans = records[2:], times[2:], spans[2:]
        assert math.isfinite(loss.item())
        launches = dict(fa.launches)
        text, after = scrape(port)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "metrics.txt"),
                  "w") as f:
            f.write(text)

        def delta(key):
            return after.get(key, 0.0) - before.get(key, 0.0)

        steps_total = delta("hvd_steps_total")
        ops = delta('hvd_collective_ops_total{kind="allreduce"}')
        lat_n = delta('hvd_collective_latency_seconds_count{kind="allreduce"}')
        assert steps_total == TELEMETRY_STEPS, steps_total
        assert ops == calls[0] == lat_n, (ops, calls[0], lat_n)
        assert [r["step"] for r in records] == \
            list(range(3, TELEMETRY_STEPS + 1)), records
        wall_err = []
        for rec in records:
            wall = sum(rec["components"][k] for k in A.WALL_COMPONENTS)
            wall_err.append(abs(wall - rec["dur_s"]))
        last = records[-1]
        scraped = {k: after[f'hvd_step_attribution_seconds{{component="{k}"}}']
                   for k in A.COMPONENTS}
        wall_err.append(abs(sum(scraped[k] for k in A.WALL_COMPONENTS)
                            - last["dur_s"]))
        assert max(wall_err) <= TOL_WALL_S, wall_err
        # No rescale onto the wall (which sets host to 0), and the span
        # counted once: compute + comm_exposed is the span.
        assert all(r["components"]["host"] > 0 for r in records), records
        span_err = [abs(r["components"]["compute"]
                        + r["components"]["comm_exposed"] - sp)
                    for r, sp in zip(records, spans)]
        assert statistics.median(span_err) <= TOL_SPAN_S, span_err
        peak = A.peak_flops()
        assert peak == PEAK_H100_SXM, (peak, torch.cuda.get_device_name(0))
        live = [r["mfu"] for r in records]
        own = flops / (statistics.median(times) * PEAK_H100_SXM)
        mfu_rel = abs(statistics.median(live) - own) / own
        assert mfu_rel <= TOL_MFU, (statistics.median(live), own)
        assert after["hvd_mfu_ratio"] == last["mfu"]
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * TELEMETRY_STEPS, launches
        comps = {k: statistics.median(r["components"][k] for r in records)
                 for k in A.COMPONENTS}
        report["train"] = {
            "steps_total": steps_total, "allreduce_ops": ops,
            "all_reduce_calls": calls[0], "wall_err_max_s": max(wall_err),
            "step_times_s": times, "records": records,
            "component_medians_s": comps, "live_mfu": live,
            "span_s": spans, "span_err_s": span_err,
            "live_mfu_median": statistics.median(live),
            "phase_mfu": own, "mfu_rel_diff": mfu_rel,
            "peak_flops": peak, "launches": launches,
            "latency_hist_count": lat_n,
            "latency_hist_sum_s": delta(
                'hvd_collective_latency_seconds_sum{kind="allreduce"}')}
        log(f"[telemetry] (a) {TELEMETRY_STEPS} flagship steps under "
            f"compute_span/step_end, /metrics scraped on 127.0.0.1:{port}: "
            f"hvd_steps_total +{steps_total:.0f}, "
            f"hvd_collective_ops_total{{allreduce}} +{ops:.0f} = "
            f"{calls[0]} dist.all_reduce calls; wall components sum to the "
            f"step within {max(wall_err):.3g} s; compute + comm_exposed "
            f"against the timed span: median {statistics.median(span_err):.3g}"
            f" s, max {max(span_err):.3g} s; component medians (ms) "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in comps.items())
            + f"; live MFU median {statistics.median(live):.4f} (peak "
            f"{peak / 1e12:.1f} TFLOP/s detected from the name) against the "
            f"phase's {own:.4f} (rel {mfu_rel:.3g}); flash launches "
            f"{launches}; on {card}")

        # (d) the flight dump: one collective.enqueue a named collective
        # and step, among the events (a)'s steps recorded.
        with open(debug.dump()) as f:
            dump = json.load(f)
        window = [e for e in dump["events"] if seq0 < e["seq"] <= seq1]
        enq = collections.Counter(
            e["name"] for e in window if e["kind"] == "collective.enqueue")
        want = {f"DistributedOptimizer.grad.{j}": TELEMETRY_STEPS
                for j in range(n_grads)}
        want[None] = TELEMETRY_STEPS                   # the loss's mean
        assert dict(enq) == want, (dict(enq), want)
        report["flight"] = {"events": len(dump["events"]),
                            "window_events": len(window),
                            "enqueue_per_name": {str(k): v
                                                 for k, v in enq.items()},
                            "window_kinds": dict(collections.Counter(
                                e["kind"] for e in window))}
        log(f"[telemetry] (d) flight dump: {len(dump['events'])} events, "
            f"{len(window)} from (a)'s steps: collective.enqueue of each of "
            f"the {n_grads} named gradient allreduces and of the loss's "
            f"mean once a step ({TELEMETRY_STEPS} steps); kinds "
            f"{report['flight']['window_kinds']}")

        # (e) a Chrome trace of two steps: the hvd.* ranges and the three
        # kernels' device launches.
        trace_dir = os.path.join(work, "trace")
        prof.start_trace(trace_dir)
        for _ in range(TRACE_STEPS):
            step(tokens, labels)
        torch.cuda.synchronize()
        path = prof.stop_trace()
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        ranges = sum(1 for e in trace
                     if str(e.get("name", "")).startswith("hvd.allreduce."))
        kern = {n: sum(1 for e in trace if e.get("cat") == "kernel"
                       and sym in str(e.get("name", "")))
                for n, sym in KERNEL_SYMBOLS.items()}
        # NCCL's own device work (kernels and copies), beside (a)'s
        # comm_exposed: at world 1 an in-place sum may launch none.
        nccl = [e for e in trace
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                and ("nccl" in str(e.get("name", "")).lower()
                     or "onerank" in str(e.get("name", "")).lower())]
        nccl_ms = sum(float(e.get("dur", 0.0)) for e in nccl) / 1e3
        assert ranges >= TRACE_STEPS * (n_grads + 1), ranges
        assert kern == {n: cfg.n_layers * TRACE_STEPS for n in KERNELS}, kern
        report["trace"] = {"bytes": os.path.getsize(path),
                           "hvd_allreduce_ranges": ranges,
                           "kernel_launches": kern,
                           "nccl_device_events": len(nccl),
                           "nccl_device_ms_a_step": nccl_ms / TRACE_STEPS}
        log(f"[telemetry] (e) Chrome trace of {TRACE_STEPS} steps "
            f"({os.path.getsize(path):,} bytes): {ranges} hvd.allreduce.* "
            f"ranges, device launches {kern}; NCCL device events "
            f"{len(nccl)}, {nccl_ms / TRACE_STEPS:.4f} ms a step (against "
            f"(a)'s comm_exposed median {comps['comm_exposed'] * 1e3:.4f} "
            f"ms, the compute stream's hold)")

        # (b) the other components: a checkpoint, the loader.  (The
        # pipeline bubble needs pp > 1: tools/multi_gpu_modes.py checks it
        # at pp 4.)
        comp = {}
        root = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        with metrics.compute_span():
            step(tokens, labels)
        ckpt.save_zero_state(root, {"model": trainee.state_dict()}, 1)
        metrics.step_end(time.perf_counter() - t0, step=100)
        comp["checkpoint"] = metrics.last_attribution()["components"]
        assert comp["checkpoint"]["checkpoint"] > 0, comp
        seqs = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (64, cfg.seq_len + 1), dtype=np.int32)
        loader = DataLoader(ArraySource(seqs), batch, shuffle=True, seed=0,
                            prefetch=True, queue_depth=2, device="cuda")
        it = iter(loader)
        for i in range(2):
            t0 = time.perf_counter()
            b = next(it)
            with metrics.compute_span():
                step(b[:, :-1].long(), b[:, 1:].long())
            metrics.step_end(time.perf_counter() - t0, step=101 + i)
        loader.close()
        comp["input"] = metrics.last_attribution()["components"]
        assert comp["input"]["input"] > 0, comp
        report["components"] = comp
        log(f"[telemetry] (b) a step that saves a checkpoint: checkpoint "
            f"{comp['checkpoint']['checkpoint'] * 1e3:.3f} ms; a step fed "
            f"by DataLoader(prefetch, device='cuda'): input "
            f"{comp['input']['input'] * 1e3:.4f} ms")

        # (c) a serving burst over HTTP: the request plane's handler
        # counts the requests, the engine the tokens; the families against
        # what the clients received.
        svc = S.ServingService(cfg, params=model, params_tag="telemetry",
                               port=0, secret=SERVE_SECRET, watch=False,
                               **SERVE_GEOMETRY)
        sched = S.synthetic_workload(**SERVE_LOAD)
        reg = metrics.registry()
        try:
            addr = f"127.0.0.1:{svc.serve()}"
            snap0 = reg.snapshot()
            seq0 = debug.snapshot(last=1)[-1]["seq"]
            tok0 = svc.engine.tokens_out
            served, _ = serve_over_http(addr, sched, SERVE_SECRET)
            engine_tokens = svc.engine.tokens_out - tok0
            snap1 = reg.snapshot()
        finally:
            svc.close()

        def family(snap, name):
            fam = snap.get(name)
            if fam is None:
                return 0.0
            return sum(s.get("value", s.get("count", 0.0))
                       for s in fam["series"])

        client_tokens = sum(len(t) for t, _, _ in served.values())
        fams = {n: family(snap1, n) - family(snap0, n)
                for n in ("hvd_serving_tokens_total",
                          "hvd_serving_requests_total",
                          "hvd_serving_ttft_seconds",
                          "hvd_serving_token_seconds")}
        kinds = collections.Counter(e["kind"] for e in debug.snapshot()
                                    if e["seq"] > seq0)
        assert fams["hvd_serving_tokens_total"] == engine_tokens == \
            client_tokens, (fams, engine_tokens, client_tokens)
        assert fams["hvd_serving_requests_total"] == len(served) == \
            len(sched), fams
        assert fams["hvd_serving_ttft_seconds"] == len(sched), fams
        assert kinds["serving.admit"] == kinds["serving.retire"] == \
            len(sched), kinds
        report["serving"] = {"families": fams, "served": len(served),
                             "engine_tokens": engine_tokens,
                             "client_tokens": client_tokens,
                             "flight_kinds": dict(kinds)}
        log(f"[telemetry] (c) serving burst of {len(sched)} requests over "
            f"HTTP: hvd_serving_requests_total "
            f"+{fams['hvd_serving_requests_total']:.0f} (the handler's count)"
            f" = {len(served)} streams served; hvd_serving_tokens_total "
            f"+{fams['hvd_serving_tokens_total']:.0f} = the engine's "
            f"{engine_tokens} = the clients' {client_tokens} tokens; TTFT "
            f"observations {fams['hvd_serving_ttft_seconds']:.0f}, per-token "
            f"{fams['hvd_serving_token_seconds']:.0f}; serving.admit / "
            f"retire events {kinds['serving.admit']} / "
            f"{kinds['serving.retire']}")
        del svc

        # (f) the host cost: the training step and a decode iteration
        # with the telemetry on and off, in interleaved blocks.
        host = {"on": [], "off": []}
        idx = 200
        for mode in OVERHEAD_BLOCKS:
            telemetry_switch(mode == "on")
            for _ in range(OVERHEAD_STEPS):
                t0 = time.perf_counter()
                if mode == "on":
                    with metrics.compute_span():
                        step(tokens, labels)
                    metrics.step_end(step=idx)
                else:
                    step(tokens, labels)
                    torch.cuda.synchronize()
                host[mode].append(time.perf_counter() - t0)
                idx += 1
        telemetry_switch(True)
        rng = np.random.default_rng(14)
        dec = S.DecodeEngine(cfg, model, **SERVE_GEOMETRY)
        for i in range(SERVE_GEOMETRY["slots"]):
            dec.admit(S.Request(
                id=f"o{i}", prompt=[int(t) for t in rng.integers(
                    0, cfg.vocab_size, PROFILE_REQUEST["prompt"])],
                max_new_tokens=PROFILE_REQUEST["outputs"]))
        decode = {"on": [], "off": []}
        for mode in OVERHEAD_BLOCKS:
            telemetry_switch(mode == "on")
            for _ in range(OVERHEAD_STEPS):
                t0 = time.perf_counter()
                dec.step()
                decode[mode].append(time.perf_counter() - t0)
        telemetry_switch(True)
        assert dec.active() == SERVE_GEOMETRY["slots"], dec.stats()
        del dec
        over = {"train_step": {m: spread(v) for m, v in host.items()},
                "decode_iteration": {m: spread(v)
                                     for m, v in decode.items()},
                "blocks": list(OVERHEAD_BLOCKS),
                "steps_a_block": OVERHEAD_STEPS, "card": card}
        for k in ("train_step", "decode_iteration"):
            on, off = over[k]["on"]["median_ms"], over[k]["off"]["median_ms"]
            over[k]["on_over_off"] = on / off
        report["overhead"] = over
        for k, label in (("train_step", "flagship step"),
                         ("decode_iteration", "decode iteration")):
            o = over[k]
            log(f"[telemetry] (f) {label} host time, telemetry on: median "
                f"{o['on']['median_ms']:.3f} ms (min {o['on']['min_ms']:.3f},"
                f" max {o['on']['max_ms']:.3f}); off: median "
                f"{o['off']['median_ms']:.3f} ms (min "
                f"{o['off']['min_ms']:.3f}, max {o['off']['max_ms']:.3f}); "
                f"on/off {o['on_over_off']:.4f}; blocks "
                f"{'/'.join(OVERHEAD_BLOCKS)} of {OVERHEAD_STEPS}; on {card}")
    finally:
        telemetry_switch(True)
        for k in ("HVD_TPU_METRICS_PORT", "HVD_TPU_FLIGHT_DIR"):
            os.environ.pop(k, None)
        hvd.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    return report


# Phase 15: the reference's other model families (ResNet-50 v1.5, BERT-Base,
# the MoE transformer, the MLP) at world 1 on NCCL.
MODEL_STEPS = 10
# (a) ResNet-50 v1.5: bench.py's per-card batch and optimizer (SGD with
# momentum 0.9) at the linear-scaling rate for 128 images (0.1 per 256).
RESNET_BATCH, RESNET_LR, RESNET_MOMENTUM = 128, 0.05, 0.9
RESNET_CHECK_BATCH = 2
# Card against CPU in float64 (cuDNN's and oneDNN's convs sum in other
# orders).  In fp32 batch norm over 2 images through 16 blocks amplifies
# that rounding to ~3% in a gradient; in float64 it stays far below these
# bars.  The logits, loss, gradients (normwise, each tensor) and new
# statistics, and stem_s2d's logits against the default stem's.
TOL_RESNET_F64_REL = 1e-9
# (b) BERT-Base: bench.py's optimizer (AdamW 1e-4) and head (gathered).
BERT_BATCH, BERT_LR = 16, 1e-4
REMAT_MODES = (False, True, "dots")
# (c) the MoE transformer, the default config; (d) the MLP of jax_mnist.
MOE_TFM_BATCH = 8
MLP_SIZES, MLP_BATCH, MLP_STEPS, MLP_LR = (784, 512, 512, 10), 128, 3, 0.1


def peak_start(torch):
    """gc, then the allocated bytes a run's peak is measured above."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_above(torch, base):
    return torch.cuda.max_memory_allocated() - base


def timed_steps(torch, step, n_steps):
    """``n_steps`` calls of ``step()`` (which returns the loss tensor),
    each timed to a synchronize: (losses, host seconds a step)."""
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    return losses, times


def normwise(torch, a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-300)).item()


def models_resnet(torch, hvd, resnet, card):
    """(a) ResNet-50 v1.5: card against CPU at batch 2 in float64, stem_s2d
    against the default stem, then 10 bf16 steps at batch 128 with sync
    BN over the data axis through DistributedOptimizer(SGD momentum)."""
    cfg = resnet.ResNetConfig(depth=50, num_classes=1000, width=64,
                              dtype=torch.bfloat16, sync_bn_axis="data")
    f64 = cfg._replace(dtype=torch.float64)
    params, stats = resnet.init_params(f64, torch.Generator().manual_seed(0),
                                       device="cpu")
    images, labels = resnet.synthetic_batch(RESNET_CHECK_BATCH, seed=3,
                                            device="cpu")

    def run(device, c):
        model = resnet.ResNet(c, device=device, params=params, stats=stats)
        logits = model(images.to(device))
        loss = resnet.cross_entropy_loss(logits, labels.to(device))
        loss.backward()
        out = {"loss": loss.detach().reshape(1), "logits": logits.detach()}
        out.update({f"grad.{n}": p.grad for n, p in model.named_parameters()})
        out.update({f"stats.{n}": b for n, b in model.named_buffers()})
        return {k: v.cpu() for k, v in out.items()}

    card_run, cpu_run = run("cuda", f64), run("cpu", f64)
    assert card_run["logits"].dtype == torch.float64
    rel = {k: normwise(torch, v, cpu_run[k]) for k, v in card_run.items()}
    rel["stem_s2d.logits"] = normwise(
        torch, run("cuda", f64._replace(stem_s2d=True))["logits"],
        card_run["logits"])
    worst = max(rel, key=rel.get)
    assert rel[worst] <= TOL_RESNET_F64_REL, (worst, rel[worst])
    grads = [r for k, r in rel.items() if k.startswith("grad.")]
    log(f"[models] (a) ResNet-50 at batch {RESNET_CHECK_BATCH}, float64, card "
        f"against CPU: loss {card_run['loss'].item()!r} / "
        f"{cpu_run['loss'].item()!r}; relative normwise: logits "
        f"{rel['logits']:.3g}, gradients at most {max(grads):.3g} over "
        f"{len(grads)} tensors, BN statistics at most "
        f"{max(r for k, r in rel.items() if k.startswith('stats.')):.3g}; "
        f"stem_s2d logits against the default stem {rel['stem_s2d.logits']:.3g}"
        f" (bar {TOL_RESNET_F64_REL:g}; worst {worst})")
    del card_run, cpu_run

    base = peak_start(torch)
    model = resnet.ResNet(cfg, seed=0, device="cuda")
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=RESNET_LR, momentum=RESNET_MOMENTUM))
    images, labels = resnet.synthetic_batch(RESNET_BATCH, seed=1,
                                            device="cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = resnet.cross_entropy_loss(model(images), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, times = timed_steps(torch, step, MODEL_STEPS)
    step_s = statistics.median(times[1:])
    out = {"check": {"batch": RESNET_CHECK_BATCH, "dtype": "float64",
                     "rel": rel},
           "losses": losses, "step_times_s": times, "step_s": step_s,
           "images_per_s": RESNET_BATCH / step_s,
           "mfu": resnet.train_flops_per_image(cfg) * RESNET_BATCH / step_s
           / PEAK_BF16_FLOPS,
           "peak_bytes": peak_above(torch, base)}
    log(f"[models] (a) ResNet-50 v1.5, bf16, batch {RESNET_BATCH}, sync BN "
        f"over data, SGD({RESNET_LR}, momentum {RESNET_MOMENTUM}): losses "
        f"{losses}; host step {step_s * 1e3:.3f} ms (median of steps 1-"
        f"{MODEL_STEPS - 1}), {out['images_per_s']:.1f} images/s, MFU "
        f"{out['mfu']:.4f}, peak allocated {out['peak_bytes'] / 2**20:.1f} "
        f"MiB; on {card}")
    del model, opt
    return out


def models_bert(torch, F, hvd, fa, bert, card, timing_iters=(20, 3)):
    """(b) BERT-Base through make_train_step on a (1, 1) mesh: the dense
    and gathered losses and gradients through the kernels against the
    plain attention; 10 AdamW steps in each remat mode; the kernels timed
    at BERT's shape, non-causal."""
    cfg = bert.BertConfig(remat=False)
    mesh = hvd.parallel.create_mesh(dict.fromkeys(bert.AXES, 1))
    model = bert.Bert(cfg, seed=0, device="cuda", mesh=mesh)
    batches = {"dense": bert.synthetic_batch(cfg, BERT_BATCH, seed=1,
                                             device="cuda"),
               "gathered": bert.synthetic_mlm_batch(cfg, BERT_BATCH, seed=2,
                                                    device="cuda")}
    n_layers = cfg.n_layers
    check = {}
    for head, batch in batches.items():
        fn = bert.make_loss_fn(cfg, mesh, gathered=head == "gathered")

        def loss_and_grads():
            model.zero_grad(set_to_none=True)
            loss = fn(model, *batch)
            loss.backward()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            return loss.item(), grads

        fa.reset_launches()
        k_loss, k_grads = loss_and_grads()
        launches = dict(fa.launches)
        os.environ["HVD_TPU_FLASH"] = "0"
        try:
            p_loss, p_grads = loss_and_grads()
        finally:
            del os.environ["HVD_TPU_FLASH"]
        rel = {n: normwise(torch, g, p_grads[n]) for n, g in k_grads.items()}
        assert abs(k_loss - p_loss) <= TOL_LOSS, (head, k_loss, p_loss)
        assert max(rel.values()) <= TOL_MODEL_GRAD_REL, (head, rel)
        assert launches == dict.fromkeys(KERNELS, n_layers), launches
        check[head] = {"kernel_loss": k_loss, "plain_loss": p_loss,
                       "grad_rel": rel, "launches": launches}
        del k_grads, p_grads
        log(f"[models] (b) BERT-Base {head} head, bf16, batch {BERT_BATCH}: "
            f"loss through the kernels {k_loss}, plain attention {p_loss}; "
            f"gradients normwise at most {max(rel.values()):.3g}; launches "
            f"{launches}")
    del model

    runs = {}
    for remat in REMAT_MODES:
        c = cfg._replace(remat=remat)
        base = peak_start(torch)
        model = bert.Bert(c, seed=0, device="cuda", mesh=mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=BERT_LR)
        train = bert.make_train_step(c, model, opt, gathered=True)
        batch = batches["gathered"]
        fa.reset_launches()
        losses, times = timed_steps(torch, lambda: train(*batch),
                                    MODEL_STEPS)
        per_step = {n: v / MODEL_STEPS for n, v in fa.launches.items()}
        step_s = statistics.median(times[1:])
        flops = bert.train_flops_per_seq(cfg, bert.max_predictions(cfg))
        runs[str(remat)] = {
            "losses": losses, "step_times_s": times, "step_s": step_s,
            "sequences_per_s": BERT_BATCH / step_s,
            "mfu": flops * BERT_BATCH / step_s / PEAK_BF16_FLOPS,
            "peak_bytes": peak_above(torch, base),
            "launches": dict(fa.launches), "launches_per_step": per_step}
        fwd = 2 * n_layers if remat is True else n_layers
        assert per_step == {"flash_fwd": fwd, "flash_bwd_dq": n_layers,
                            "flash_bwd_dkv": n_layers}, per_step
        del model, opt, train
        r = runs[str(remat)]
        log(f"[models] (b) BERT-Base remat={remat}, gathered head, AdamW("
            f"{BERT_LR}): losses {losses}; launches a step {per_step}; host "
            f"step {step_s * 1e3:.3f} ms, {r['sequences_per_s']:.1f} "
            f"sequences/s, MFU {r['mfu']:.4f}, peak allocated "
            f"{r['peak_bytes'] / 2**20:.1f} MiB; on {card}")
    first = runs["False"]["losses"][0]
    for r in runs.values():
        assert abs(r["losses"][0] - first) <= TOL_REMAT_LOSS * abs(first), \
            {k: v["losses"][0] for k, v in runs.items()}

    shape = (BERT_BATCH, cfg.seq_len, cfg.n_heads, cfg.head_dim)
    res, fb = time_shape(torch, F, fa, *shape, *timing_iters,
                         causal=False)
    bnd = bounds(*shape, causal=False)
    timing = {"shape": shape, "causal": False, "fwd_bwd": fb,
              "kernels": {n: {"ms": r[0], "plain_ms": r[1],
                              "library_ms": r[2],
                              "bound_ms": bnd[n][0],
                              "bound_by": bnd[n][1]}
                          for n, r in res.items()}}
    for n, r in timing["kernels"].items():
        log(f"[models] (b) {shape} non-causal {n}: {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms")
    return {"check": check, "runs": runs, "timing": timing}


def moe_wire_plan(cfg, moe_lib, Q, rows):
    """The analytic dispatch wire bytes of one forward at (1, 1): two
    exchanges a layer of the (E, capacity, d) buffer, fp32 or as sent."""
    cap = moe_lib.expert_capacity(rows * cfg.seq_len, cfg.n_experts,
                                  cfg.capacity_factor, cfg.top_k)
    chunk = cfg.n_experts * cap * cfg.d_model
    spec = cfg.quant_spec()
    raw = 2 * cfg.n_layers * 4 * chunk
    sent = raw if spec is None else 2 * cfg.n_layers * Q.wire_bytes(chunk,
                                                                    spec)
    return raw, sent, chunk


def models_moe(torch, hvd, fa, moet, moe_lib, XC, Q, card):
    """(c) the default MoEConfig at (dp, ep) = (1, 1) on the fp32, int8
    and int4 dispatch wires: 10 AdamW steps each, launches, the wire
    counters against the analytic plan and the bytes a forward hands
    dist.all_to_all_single, and the quantized exchange's gradient card
    against CPU."""
    import torch.distributed as dist
    cfg = moet.MoEConfig()
    par = moet.MoEParallelConfig(1, 1)
    mesh = hvd.parallel.create_mesh(dict.fromkeys(moet.AXES, 1))
    tokens, labels = moet.synthetic_batch(cfg, MOE_TFM_BATCH, seed=1,
                                          device="cuda")
    runs = {}
    for bits in (0, 8, 4):
        c = cfg._replace(dispatch_bits=bits)
        raw, sent, chunk = moe_wire_plan(c, moe_lib, Q, MOE_TFM_BATCH)
        base = peak_start(torch)
        model = moet.MoETransformer(c, par, seed=0, device="cuda", mesh=mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        train = moet.make_train_step(c, par, model, opt)
        dropped = []

        def step():
            loss, metrics = train(tokens, labels)
            dropped.append(metrics["dropped"])
            return loss

        fa.reset_launches()
        before = XC.wire_totals()
        losses, times = timed_steps(torch, step, MODEL_STEPS)
        after = XC.wire_totals()
        launches = dict(fa.launches)
        per_step = {n: v / MODEL_STEPS for n, v in launches.items()}
        counted = (after.raw - before.raw, after.sent - before.sent)
        # One forward's exchanges as dist.all_to_all_single sees them.
        wire_log, restore = record_wire(dist)
        try:
            with torch.no_grad():
                moet.make_loss_fn(c, par, mesh)(model, tokens, labels)
        finally:
            restore()
        handed = sum(b for call, _, b in wire_log
                     if call == "all_to_all_single")
        step_s = statistics.median(times[1:])
        name = "fp32" if bits == 0 else f"int{bits}"
        runs[name] = {
            "losses": losses, "step_times_s": times, "step_s": step_s,
            "tokens_per_s": MOE_TFM_BATCH * c.seq_len / step_s,
            "peak_bytes": peak_above(torch, base),
            "launches": launches, "launches_per_step": per_step,
            "dropped_per_step": [float(d) for d in dropped],
            "routed_per_step": MOE_TFM_BATCH * c.seq_len * c.n_layers,
            "wire_plan": {"raw": raw, "sent": sent},
            "wire_counted": counted, "forward_a2a_bytes": handed}
        assert per_step == {"flash_fwd": 2 * c.n_layers,
                            "flash_bwd_dq": c.n_layers,
                            "flash_bwd_dkv": c.n_layers}, per_step
        # At world 1 the fp32 wire's exchange is the identity (no call).
        assert handed == (sent if bits else 0), (name, handed, sent)
        if bits:
            assert counted == (MODEL_STEPS * raw, MODEL_STEPS * sent), \
                (name, counted, raw, sent)
        else:
            assert counted == (0, 0), counted
        del model, opt, train
        r = runs[name]
        log(f"[models] (c) MoE transformer, {name} dispatch wire: losses "
            f"{losses}; dropped routes a step {r['dropped_per_step']} of "
            f"{r['routed_per_step']}; launches a step {per_step}; wire "
            f"counters {counted} over {MODEL_STEPS} steps (plan a step raw "
            f"{raw}, sent {sent}; a forward hands all_to_all_single "
            f"{handed} bytes); host step {step_s * 1e3:.3f} ms, "
            f"{r['tokens_per_s']:.0f} tokens/s, peak allocated "
            f"{r['peak_bytes'] / 2**20:.1f} MiB; on {card}")

    # The quantized exchange's gradient, card against CPU: integer
    # cotangents make each block's sum of g * q exact, so the order of
    # summation cannot matter and the gradients are equal bit for bit.
    cpu_group = dist.new_group([0], backend="gloo")
    gen = torch.Generator().manual_seed(5)
    shape = (1, cfg.n_experts, chunk // (cfg.n_experts * cfg.d_model),
             cfg.d_model)
    v = torch.randn(shape, generator=gen)
    cotangents = {"integer": torch.randint(-3, 4, shape, generator=gen)
                  .float(), "normal": torch.randn(shape, generator=gen)}
    wire_grad = {}
    for bits in (8, 4):
        spec = Q.QuantSpec(bits, cfg.dispatch_block)
        for kind, ct in cotangents.items():
            got = {}
            for where, group in (("cuda", None), ("cpu", cpu_group)):
                t = v.to(where, copy=True).requires_grad_()
                out = XC.all_to_all_wire(t, group, spec)
                (out * ct.to(where)).sum().backward()
                got[where] = (out.detach().cpu(), t.grad.cpu())
            (o_d, g_d), (o_c, g_c) = got["cuda"], got["cpu"]
            assert torch.equal(o_d, o_c), (bits, kind)
            rel = normwise(torch, g_d, g_c)
            nonzero = int((g_c != 0).sum())
            if kind == "integer":
                assert torch.equal(g_d, g_c), (bits, rel)
            else:
                assert rel <= 1e-6, (bits, rel)
            wire_grad[f"int{bits}_{kind}"] = {"grad_rel": rel,
                                              "nonzero": nonzero,
                                              "elements": v.numel()}
    log(f"[models] (c) the quantized exchange of {tuple(shape)} fp32, card "
        f"against CPU: forward bit for bit; gradient (integer cotangent) "
        f"bit for bit, (normal cotangent) normwise "
        + ", ".join(f"{k} {r['grad_rel']:.3g}" for k, r in wire_grad.items()
                    if k.endswith("normal"))
        + f"; non-zero at {wire_grad['int8_integer']['nonzero']} of "
        f"{v.numel()} elements (the blocks' absmax)")
    return {"runs": runs, "wire_grad": wire_grad}


def models_mlp(torch, hvd, mlp, card):
    """(d) the MLP: 3 SGD steps through DistributedOptimizer."""
    params = mlp.init_params(MLP_SIZES, torch.Generator().manual_seed(0),
                             device="cuda")
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(leaves, lr=MLP_LR))
    import numpy as np
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(
        (MLP_BATCH, 28, 28), dtype=np.float32)).to("cuda")
    labels = torch.from_numpy(rng.integers(0, 10, MLP_BATCH)).to("cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = mlp.loss_fn(params, x, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, times = timed_steps(torch, step, MLP_STEPS)
    log(f"[models] (d) MLP {MLP_SIZES}, batch {MLP_BATCH}: losses {losses};"
        f" on {card}")
    return {"losses": losses, "step_times_s": times}


def phase_models(torch, hvd, fa, card):
    """Phase 15: ResNet-50, BERT-Base, the MoE transformer and the MLP at
    world 1 (NCCL on the card); returns the report."""
    import torch.nn.functional as F
    from horovod_tpu_torch.models import bert, mlp, resnet
    from horovod_tpu_torch.models import moe_transformer as moet
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.ops import xla_collectives as XC
    from horovod_tpu_torch.parallel import moe as moe_lib
    hvd.init()
    try:
        return {"resnet": models_resnet(torch, hvd, resnet, card),
                "bert": models_bert(torch, F, hvd, fa, bert, card),
                "moe_transformer": models_moe(torch, hvd, fa, moet, moe_lib,
                                              XC, Q, card),
                "mlp": models_mlp(torch, hvd, mlp, card)}
    finally:
        hvd.shutdown()


RECOVERY_SECRET = "chip-smoke-recovery"
# The wire chaos of phase 16 (c): a schedule under which the push of the
# step-4 entry fails once and lands on its one retry, and the fetch back
# retries once (a pure function of the seed and the requests' order; the
# CPU tests hold the schedule to the reference's).
RECOVERY_CHAOS = {"HVD_TPU_CHAOS_NET_SEED": "9",
                  "HVD_TPU_CHAOS_NET_RESET_PCT": "30",
                  "HVD_TPU_CHAOS_NET_TRUNCATE": "30"}


def state_of(model, opt):
    """The parameters and the optimizer's moments of a ZeRO run, as one
    tree for the checkpoint engine and the peer tier."""
    return {"model": model.state_dict(), "opt": opt}


def shard_payload_bytes(root, step):
    """The array bytes held by a committed step's shard files."""
    import numpy as np
    from horovod_tpu_torch import checkpoint as ckpt
    d = ckpt.step_dir(root, step)
    total = 0
    for name in ckpt.read_manifest(root, step).shard_filenames():
        with np.load(os.path.join(d, name)) as z:
            total += sum(int(z[k].nbytes) for k in z.files)
    return total


def phase_recovery(torch, hvd, tfm, fa, cfg, par, card):
    """Phase 16: the peer recovery tier around the flagship's ZeRO-2
    training on the card, and its signed transport on loopback under
    seeded wire chaos; returns the report."""
    import dataclasses
    import tempfile
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import net
    from horovod_tpu_torch import recovery as rec
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer

    batch, n_steps, commit_at, stage = 8, 8, 4, 2

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    def fresh(seed):
        model = tfm.Transformer(cfg, par, seed=seed)
        return model, hvd.ZeroShardedOptimizer(model, adamw, stage=stage)

    def run(model, opt, first, last):
        step = tfm.make_train_step(cfg, par, model, opt)
        losses = [step(*batches[i]).item() for i in range(first, last)]
        assert all(math.isfinite(x) for x in losses), losses
        return losses

    out = {}
    hvd.init()
    try:
        batches = [tfm.synthetic_batch(cfg, batch, seed=1600 + i)
                   for i in range(n_steps)]
        # Run A, uninterrupted, twice: the run-to-run spread.
        runs = []
        for _ in range(2):
            model, opt = fresh(0)
            runs.append((run(model, opt, 0, n_steps),
                         snapshot(torch, model, opt)))
            del model, opt
        (a_losses, a_snap), (a2_losses, a2_snap) = runs
        spread_loss = max(abs(x - y) for x, y in zip(a_losses, a2_losses))
        spread = max_difference(torch, a_snap, a2_snap)

        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "opt_state")
            # (a) Run B: 4 steps, then the commit.
            torch.cuda.synchronize()
            fa.reset_launches()
            model, opt = fresh(0)
            b_first = run(model, opt, 0, commit_at)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ext = ckpt.extract_zero_state(state_of(model, opt))
            extract_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            replicated = rec.replicate("opt_state", commit_at, ext)
            replicate_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt.save_extracted(root, ext, commit_at)
            save_s = time.perf_counter() - t0
            rec.seal_commit("opt_state", commit_at, ext)
            payload = shard_payload_bytes(root, commit_at)
            assert replicated == payload, (replicated, payload)
            entry = rec.store().get("opt_state", 0)
            assert entry is not None and entry.sealed and \
                rec.verify_entry(entry)
            del model, opt, ext
            log(f"[recovery] (a) commit at step {commit_at} of the "
                f"flagship's ZeRO-{stage} state (parameters and AdamW "
                f"moments): extract {extract_s:.3f} s, replicate "
                f"{replicated:,} bytes in {replicate_s:.4f} s (= the disk "
                f"shard's payload), disk save {save_s:.3f} s, on {card}")

            # (b) The peer restore and the disk restore of step 4.
            restored = {}
            for path in ("peer", "disk"):
                model, opt = fresh(1)
                like = state_of(model, opt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if path == "peer":
                    _, extra, report = rec.peer_restore("opt_state", like)
                else:
                    ckpt.restore_zero_state(root, like, step=commit_at)
                torch.cuda.synchronize()
                restored[path] = (model, opt, time.perf_counter() - t0)
            assert report.path == "peer" and report.step == commit_at, \
                report
            assert extra["run_fingerprint"]["world_size"] == 1, extra
            (p_model, p_opt, peer_s), (d_model, d_opt, disk_s) = \
                restored["peer"], restored["disk"]
            p_snap = snapshot(torch, p_model, p_opt)
            params, moments, _ = p_snap
            # Torch keeps AdamW's step count on the host, and so does the
            # restore; every parameter and moment is on the card.
            devices = {str(t.device) for t in params.values()} | {
                str(t.device) for st in moments for k, t in st.items()
                if k != "step"}
            assert devices == {str(hvd.device())}, devices
            peer_vs_disk = max_difference(
                torch, p_snap, snapshot(torch, d_model, d_opt))
            assert peer_vs_disk == 0.0, peer_vs_disk
            del d_model, d_opt, restored
            b_rest = run(p_model, p_opt, commit_at, n_steps)
            launches = dict(fa.launches)
            b_snap = snapshot(torch, p_model, p_opt)
            del p_model, p_opt
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * n_steps, launches
        b_losses = b_first + b_rest
        loss_diff = max(abs(x - y) for x, y in zip(b_losses, a_losses))
        diff = max_difference(torch, b_snap, a_snap)
        assert loss_diff <= spread_loss and diff <= spread, \
            (loss_diff, diff, spread_loss, spread)
        log(f"[recovery] (b) peer_restore of step {commit_at} into a model "
            f"and optimizer of seed 1: path {report.path!r}, "
            f"{report.bytes_moved:,} bytes in {peer_s:.4f} s (disk restore "
            f"{payload:,} bytes in {disk_s:.3f} s), every parameter and "
            f"moment on {sorted(devices)} and equal to the disk restore "
            "bit for bit; "
            f"steps {commit_at + 1}-{n_steps} resumed: losses "
            + ("equal the uninterrupted run's bit for bit, and so do the "
               "final parameters and moments" if loss_diff == diff == 0
               else f"within the run-to-run spread ({loss_diff:.3g}, "
               f"{diff:.3g})")
            + f"; kernel launches {launches}, on {card}")
        out.update(
            losses_a=a_losses, losses_a2=a2_losses, losses_b=b_losses,
            run_to_run_loss_spread=spread_loss,
            run_to_run_state_spread=spread, resumed_loss_diff=loss_diff,
            resumed_state_diff=diff, replicated_bytes=replicated,
            disk_payload_bytes=payload, extract_s=extract_s,
            replicate_s=replicate_s, save_s=save_s,
            peer_restore_bytes=report.bytes_moved, peer_restore_s=peer_s,
            peer_report=report.to_dict(), disk_restore_bytes=payload,
            disk_restore_s=disk_s, peer_vs_disk_max_diff=peer_vs_disk,
            restored_devices=sorted(devices), launches=launches)

        # (c) The signed transport on loopback under seeded wire chaos.
        saved = {k: os.environ.get(k) for k in (
            "HVD_TPU_RENDEZVOUS_SECRET", "HVD_TPU_FLIGHT_HOST",
            *RECOVERY_CHAOS)}
        os.environ.update(RECOVERY_CHAOS,
                          HVD_TPU_RENDEZVOUS_SECRET=RECOVERY_SECRET,
                          HVD_TPU_FLIGHT_HOST="127.0.0.1")
        net.reset_net_chaos()
        retries = registry().counter(
            "hvd_net_retries_total", "Wire-fabric recovery attempts by "
            "plane", plane="http")
        retries0 = retries.value
        kv = RendezvousServer(host="127.0.0.1", secret=RECOVERY_SECRET)
        kv.start()
        rdv_addr = f"127.0.0.1:{kv.port}"
        try:
            published = rec.transport.serve_and_publish(0, rdv_addr)
            addr = rec.transport.lookup_addr(0, rdv_addr)
            assert addr == published, (addr, published)
            # The step-4 entry under a key of its own, pending: the
            # endpoint's store then holds only the copy that crossed the
            # wire, and serves it once sealed.
            sent = dataclasses.replace(entry, key="loopback", sealed=False)
            wire = len(rec.entry_to_bytes(sent))
            t0 = time.perf_counter()
            pushed = rec.transport.push_replica(addr, sent, timeout=120)
            push_s = time.perf_counter() - t0
            assert pushed, "the step-4 entry did not land"
            assert rec.store().contribution("loopback") == []
            assert rec.transport.push_seal(addr, "loopback", commit_at)
            (held,) = rec.store().contribution("loopback", role="held")
            assert held.sealed and rec.verify_entry(held)
            t0 = time.perf_counter()
            got = rec.transport.fetch_replica(addr, "loopback", 0,
                                              timeout=120)
            fetch_s = time.perf_counter() - t0
            assert got is not None and rec.verify_entry(got)
            assert (got.step, got.world, got.fingerprint, got.checksum,
                    got.manifest_json) == (sent.step, sent.world,
                                           sent.fingerprint, sent.checksum,
                                           sent.manifest_json)
            assert sorted(got.arrays) == sorted(sent.arrays)
            for k, v in sent.arrays.items():
                assert got.arrays[k].dtype == v.dtype and \
                    got.arrays[k].tobytes() == v.tobytes(), k
            http_retries = retries.value - retries0
            assert http_retries > 0, "the seeded chaos never fired"
        finally:
            rec.transport.stop_serving()
            kv.stop()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            net.reset_net_chaos()
        push_mb_s = entry.nbytes() / push_s / 1e6
        log(f"[recovery] (c) loopback transport, signed, under "
            f"{RECOVERY_CHAOS}: published {published}, looked up; the "
            f"step-4 entry ({wire:,} wire bytes) pushed in {push_s:.3f} s "
            f"({push_mb_s:.1f} MB/s of payload), sealed, fetched back in "
            f"{fetch_s:.3f} s, verified and equal array for array; "
            f"hvd_net_retries_total{{plane=\"http\"}} +{http_retries:g}, "
            f"on {card}")
        out.update(push_wire_bytes=wire, push_s=push_s,
                   push_payload_mb_s=push_mb_s, fetch_s=fetch_s,
                   http_retries=http_retries,
                   net_status=net.status())
    finally:
        rec.reset_store()
        hvd.shutdown()
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
                                dtype=torch.bfloat16, remat=False)
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
    # 11. the negotiated eager plane: the native controller attached
    report["negotiated"] = phase_negotiated(
        torch, hvd, tfm, fa, cfg, par, tokens, labels, n_steps, losses, card)
    # 12. the parallel modes on a (1, 1, 1) mesh, and remat
    report["modes"] = phase_modes(torch, hvd, tfm, fa, cfg, tokens, labels,
                                  n_steps, losses, card)
    # 13. serving: prefill through the kernel, the fp32 drills, the
    # train→serve loop over HTTP
    report["serving"] = phase_serving(torch, hvd, tfm, fa, cfg, par, model,
                                      tokens, labels, card)
    # 14. the step telemetry plane: attribution, live MFU, the scrape, the
    # flight dump, a Chrome trace and the telemetry's host cost
    report["telemetry"] = phase_telemetry(torch, hvd, tfm, fa, cfg, par,
                                          model, tokens, labels, card)
    # 15. the other model families: ResNet-50, BERT-Base (the kernels
    # non-causal), the MoE transformer on the quantized wires, the MLP
    report["models"] = phase_models(torch, hvd, fa, card)
    # 16. the peer recovery tier: commit, peer restore and resume of the
    # flagship's ZeRO-2 state, the signed transport under wire chaos
    report["recovery"] = phase_recovery(torch, hvd, tfm, fa, cfg, par, card)

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
        by_path["negotiated"] = \
            report["negotiated"]["controller"]["launches"][name]
        modes = report["modes"]
        by_path["remat"] = modes["remat"]["remat"]["launches"][name]
        by_path.update({f"{s}_pp1_micro4": modes["pipeline"][s]["launches"]
                        [name] for s in ("gpipe", "1f1b")})
        by_path.update({f"{m}_mp1": r["launches"][name]
                        for m, r in modes["attention"].items()})
        by_path.update({f"moe_{k}": r["launches"][name]
                        for k, r in modes["moe"].items()})
        serving = report["serving"]["prefill"]
        by_path["serving.prefill"] = serving["launches"][name]
        by_path["telemetry"] = report["telemetry"]["train"]["launches"][name]
        models = report["models"]
        by_path.update({f"bert_remat_{m}": r["launches"][name]
                        for m, r in models["bert"]["runs"].items()})
        by_path.update({f"moe_transformer_{w}": r["launches"][name]
                        for w, r in models["moe_transformer"]["runs"]
                        .items()})
        by_path["recovery"] = report["recovery"]["launches"][name]
        # The serving prefill is a forward: no backward kernel runs there.
        assert all(v for p, v in by_path.items()
                   if name == "flash_fwd" or p != "serving.prefill"), \
            (name, by_path)
        extra = ({"serving_prefill": serving["flash_fwd_timing"]}
                 if name == "flash_fwd" else {})
        extra["bert_noncausal"] = models["bert"]["timing"]["kernels"][name]
        kernels.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, launches=launches[name],
                            launches_by_path=by_path,
                            max_abs_err=main_errs[name][0],
                            rel_err=main_errs[name][1], **flag[name],
                            **extra))
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
