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
17. elastic — the flagship's ZeRO stage 2 AdamW (8 steps through the
             kernels on seeded batches; two uninterrupted runs in this
             process give the losses and their spread) under the port's
             ElasticDriver, world 1 on NCCL, a worker (this script with
             --elastic-worker) training under @elastic.run with a
             TpuState committing {"model", "opt", "step"} after every
             step.  (a) Hosts localhost:1 and 127.0.0.1:1, min_np =
             max_np = 1, HVD_TPU_CHAOS_KILL_STEPS=0@4: the worker exits
             after its step-4 commit, the driver blacklists localhost
             and publishes round 1 on 127.0.0.1, the respawned worker's
             sync reports "disk" at step 4, and the 8 steps' losses
             equal the uninterrupted run's (within its spread); 64
             launches of each kernel over the two workers.  (b) One
             host, HVD_TPU_FLEET_JOB_ID set so rank 0 announces its
             commits: after two commits announce_resize(), then, once
             last_commit() is newer, request_resize(1); the worker takes
             HostsUpdatedInterrupt at its commit, runs shutdown() and
             init() in its process on the same card, its sync reports
             "peer" (its own replica), the losses equal the
             uninterrupted run's; the reset and the sync timed.
18. debug — the flagship's data-parallel step (world 1 on NCCL, the
             native controller attached, DistributedOptimizer(AdamW)) with
             the debug plane of a launched job: a signed rendezvous KV in
             this process, init() publishing the debug endpoint under
             debug/flight_addr_0 and starting the stall watchdog.  (a)
             10 steps while a thread fetches /debug/flight,
             /debug/stacks and /healthz, signed, from the published
             address (the stacks name this phase's frame: the main
             thread is in a step; an unsigned fetch is refused), every
             kernel once per layer per step; the native timeline of the
             10 steps (hvd.start_timeline) merged with the flight dump
             by debug.merge: every gradient's NEGOTIATE event of step i
             lies between the flight marks of steps i and i + 1 on the
             merged clock.  (b) The reference's input drift drill on the
             card: steps fed by DataLoader(prefetch=False) on the card,
             a fresh Aggregator's step_end, 20 steps, then 25 with
             HVD_TPU_CHAOS_INPUT_DELAY_MS=200: no drift before the
             injection, one after, its component input, and the
             regression report (on disk and at /debug/regression) names
             the data subsystem's data.chaos_delay as the suspect.
19. observe — the fleet-level observer: the flagship's data-parallel
             step (world 1 on NCCL) with a signed rendezvous KV in this
             process and HVD_TPU_METRICS_TREE=1, so that init() starts
             the host observer.  (a) 20 steps with a tree sync every 5
             (HVD_TPU_METRICS_SYNC_STEPS): every round fresh, ranks 1,
             hosts [127.0.0.1], every kernel once per layer per step.
             (c) /observe/digest, /observe/fleet, /observe/dumps on the
             observer's port and the metrics port, and
             /debug/fleet_scalars's merged section, signed (200) and
             unsigned (403).  (d) The same 20 steps under the flat sync:
             the sync's seconds a round and the step with its step_end,
             tree against flat.  (b) Verdict parity: 4 windows of 5
             steps fed by DataLoader on the card, the third under a 200
             ms input delay (HVD_TPU_CHAOS_INPUT_DELAY_MS), taken as the
             snapshots of 4 ranks on 2 hosts: the flat sync's straggler
             verdicts and MFU gauges equal those of the fleet digest two
             host observers exchange over a second signed KV (the
             straggler flagged, cause input; MFU within 1e-9).
20. disagg — disaggregated prefill/decode between DecodeEngines on the
             card at phase 13's geometry (8 slots, 16-token pages, 512
             tokens a slot) on phase 4's model.  (a) A full slot's
             pages (510 prompt tokens, 32 pages) through the bundle
             codec: fp32 byte-exact, int8 and int4 within half a grid
             step of each 256-element block's scale, a flipped byte and
             a torn tail raise; wire ratios.  (b) migrate() on the fp32
             wire after prefills of 16, 200 and 496 tokens (16 new
             tokens each; the decode engine already serves 2 requests,
             so the migrated one lands in another slot and batch):
             token for token with the unmigrated decode in fp32; in
             bf16 the agreement is reported.  The engines prefill
             through decode_verify (paged attention in torch ops, as the
             reference's engine does), so this path launches no flash
             kernel; its launches are counted and reported.  (c) send()/receive()
             through a RecoveryServer's mailbox on loopback, int8 wire:
             a push to a closed port raises and keeps the source slot,
             the mailbox is one-shot; bytes and seconds a migration.
             (d) The migration counters, the serving.migrate flight
             events, and a traced request's spans stitched across both
             engines by debug.merge.
21. launch — the port's launcher on the card.  (a) ``python -m
             horovod_tpu_torch.runner.launch -np 1 -v python
             chip_smoke.py --launched-worker '<json>'``: the worker
             (the launcher's plan: one slot inherits the card) trains
             the flagship with DistributedOptimizer(AdamW) for 10 steps
             on seeded batches, the native controller attached from the
             launcher's env, on cuda:0; 80 launches of each kernel; its
             losses equal two in-process runs of the same steps under
             the controller within their spread (bit-equality
             reported); the launched step against the in-process one,
             and the seconds from the launcher's start to the worker's
             start, init and first step.  (b) ``runner.run(fn, np=1)``
             and ``run(fn, np=1, hosts="localhost:1")``: each worker on
             "cuda", its step-0 loss equal to (a)'s.  (c)
             ``--worker-platform cpu -np 2``: two gloo workers pinned to
             the CPU (the launcher says so) give the reference test's
             allreduce, allgather and broadcast values;
             ``--check-build`` names CUDA and the built kernels and
             changes nothing under _build/.  (d) Phase 17 (a) through
             the CLI: ``--min-np 1 --max-np 1 --host-discovery-script``
             (localhost:1, 127.0.0.1:1) with HVD_TPU_CHAOS_KILL_STEPS=
             0@4, through main() and run_elastic: the worker respawns on
             127.0.0.1, its sync reports "disk", the 8 steps' losses
             equal phase 17 (a)'s within its spread, 64 launches of each
             kernel.  (b) and (c) run beside (d).
22. autotune, fleet — (a) the flagship's step under the native
             controller (world 1, NCCL) with HVD_TPU_AUTOTUNE=1 and
             HVD_TPU_COMPRESSION=none pinned: one warm-up window, 2
             steps a window, 6 scored windows.  The tuner applies at
             least two distinct (fusion, cycle) proposals and freezes;
             its log has the warm-up, the samples and one final line;
             GET /debug/autotune serves its loop status; the losses
             equal, bit for bit, the same steps under the controller
             without the tuner; each closed window's host seconds are
             at least the CUDA-event span of its responses, and every
             response it counted has completed at its close (recorded
             from outside the controller, ``record_windows``).  The
             model announced, the frozen config goes to a
             LocalTuningStore under the run's temp directory, and a
             second run warm starts from it with no exploration.  The
             untuned step, then with the frozen threshold or the frozen
             cycle pinned alone, then untuned again, each over the
             steps after the freeze, all with equal losses.  (b) The
             fleet on one
             card: a child process (torch.cuda never initialised there)
             runs a FleetGateway over one local slot; job A, priority 0,
             phase 17's worker for 12 steps committing each, is
             submitted through the signed client with its host observer
             pushing to the gateway; job B, priority 10, 4 steps,
             through ``hvdrun-torch --submit``.  B stops A through a
             commit-gated preemption (A shows PREEMPTED), runs to DONE
             on cuda:0; A is reseated, restores its committed step from
             the disk and ends DONE with losses bit-equal to an
             uninterrupted in-process run; GET /fleet/observe/<A>
             returns A's pushed digests.  Queue waits, decision to the
             victim stopped, resume to the first resumed step, and each
             job's kernel launches.

23. frontends — the horovod.torch API of the port
             (horovod_tpu_torch.torch): (a) the flagship trained 10 steps
             through its DistributedOptimizer(AdamW, named_parameters=)
             after broadcast_parameters and broadcast_optimizer_state,
             beside the port's DistributedOptimizer in the same process
             (in turns: port, front end, front end, port), without and
             with the native controller: losses bit-equal,
             80 launches a kernel, no more device-to-host copies in a
             profiled step than the port's path makes, both host steps;
             (b) sparse_allreduce of an nn.Embedding(sparse=True)
             gradient against the dense allreduce, SyncBatchNorm against
             nn.BatchNorm2d (and its cross-rank function at world 1),
             the fp16/bf16 compressions' round trips on CUDA gradients;
             (c) hvdrun-torch -np 1 of
             examples/torch_port/pytorch_synthetic_benchmark.py on
             cuda:0, its img/sec.

24. integrations — the cluster integrations on the card (the line
             ``[integrations] form: ...`` says which data form ran):
             (a) horovod_tpu_torch.spark.TorchEstimator with no device
             fits the flagship (next-token cross entropy on its fp32
             logits, AdamW) from a pandas DataFrame materialized to a
             LocalStore under a temporary directory: 10 steps at batch 8
             and one validation batch on cuda:0, 8 launches a step of
             each kernel (and 8 forward launches for the validation),
             a falling loss, a finite validation loss, the checkpoint
             reloaded into a fresh model bit for bit, each step's host
             time; (b) examples/torch_port/spark_estimator.py's
             Linear(4, 1) fitted and transformed on the card and on the
             CPU, within 1e-5; (c) horovod_tpu_torch.ray.RayExecutor
             (num_workers=1, use_gpu=True) over an in-process fake ray
             (the actor's CUDA_VISIBLE_DEVICES set as Ray sets it) runs 3
             flagship steps in its actor on cuda:0, the process's env
             restored after.

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

# Phase 18: the steps under the endpoint's fetches, the drift drill's
# steps before and after the injection, its delay and the detector's
# knobs (the reference's drill, but a drift must double the step: the
# 200 ms delay makes a ~50 ms step ~5x, while a card's host jitter
# between steps stays well under 2x), and the merge's slack beyond the
# timeline anchor's own uncertainty (half the start_timeline call).
DEBUG_STEPS = 10
DRIFT_BASELINE, DRIFT_SLOWED, DRIFT_DELAY_MS = 20, 25, 200
DRIFT_ENV = {"HVD_TPU_PERF_DRIFT_WARMUP": "10",
             "HVD_TPU_PERF_DRIFT_THRESHOLD": "6",
             "HVD_TPU_PERF_DRIFT_MIN_PCT": "100",
             "HVD_TPU_PERF_DRIFT_COOLDOWN": "100"}
MERGE_SLACK_US = 2000

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


# Phase 17: elastic training of the flagship's ZeRO-2 step under the
# port's ElasticDriver, world 1 on NCCL.  The worker is this script with
# --elastic-worker; the driver respawns it.
ELASTIC_STEPS = 8
ELASTIC_KILL = "0@4"            # HVD_TPU_CHAOS_KILL_STEPS: rank 0, step 4
ELASTIC_BATCH_SEED = 1700
ELASTIC_DEADLINE_S = 300.0
# How long (b) waits for the worker's commit after the announcement: a
# step with its commit takes 1.4-1.8 s on the card (PERF.md).
ELASTIC_ANSWER_S = 15.0


def elastic_batches(tfm, cfg, batch, n_steps=ELASTIC_STEPS):
    return [tfm.synthetic_batch(cfg, batch, seed=ELASTIC_BATCH_SEED + i)
            for i in range(n_steps)]


def elastic_worker(log_prefix, ckpt_dir, steps=ELASTIC_STEPS, observe=False):
    """One elastic worker of phase 17 (and a fleet job of phase 22): the
    flagship's ZeRO-2 AdamW under @elastic.run, its TpuState committing
    {"model", "opt", "step"} after every step, ``steps`` steps; one JSON
    line an event to <log_prefix>.<slot>.  ``observe`` closes each step
    with the metrics plane's step_end (its tree sync and host observer
    run on their knobs)."""
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic, metrics, recovery
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.metrics.registry import registry
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa

    def note(**fields):
        fields.update(slot=os.environ["HVD_TPU_ELASTIC_SLOT"],
                      pid=os.getpid(), t=time.time())
        with open(f"{log_prefix}.{fields['slot']}", "a") as f:
            f.write(json.dumps(fields) + "\n")

    hvd.init()
    cfg = tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                d_ff=2048, n_layers=8, seq_len=512,
                                dtype=torch.bfloat16, remat=False)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, seed=0)
    opt = hvd.ZeroShardedOptimizer(model, lambda ps: torch.optim.AdamW(
        ps, lr=3e-4, weight_decay=1e-4), stage=2)
    counter = torch.zeros((), dtype=torch.int64)
    state = elastic.TpuState(
        opt_state={"model": model.state_dict(), "opt": opt,
                   "step": counter}, checkpoint_dir=ckpt_dir)
    state.register_reset_callbacks([lambda: note(event="reset_done")])
    step = tfm.make_train_step(cfg, par, model, opt)
    batches = elastic_batches(tfm, cfg, 8, steps)
    sync_s = registry().gauge("hvd_elastic_sync_seconds",
                              "Duration of the last elastic state sync")

    @elastic.run
    def train(state):
        rep = recovery.last_report()
        note(event="sync", round=global_state.elastic_round,
             path=rep.path if rep else None, step=int(counter),
             sync_s=sync_s.value, device=str(hvd.device()))
        while int(counter) < steps:
            i = int(counter)
            loss = step(*batches[i]).item()
            if observe:
                metrics.step_end()
            counter.add_(1)
            try:
                state.commit()
            except hvd.HostsUpdatedInterrupt:
                note(event="interrupt", step=i + 1, loss=loss,
                     launches=dict(fa.launches))
                raise
            note(event="step", step=i + 1, loss=loss,
                 round=global_state.elastic_round,
                 launches=dict(fa.launches))
            recovery.chaos().maybe_kill(hvd.rank(), i + 1, hard=True)

    train(state)
    hvd.shutdown()


def drive_elastic(hosts, extra_env, log_prefix, ckpt_dir, during=None):
    """Run the port's ElasticDriver (min_np = max_np = 1) over ``hosts``
    with phase 17's worker; ``during(driver)`` runs beside it.  Returns
    (exit code, blacklist, events in time order)."""
    import glob
    import threading
    from horovod_tpu_torch.runner.elastic_driver import (ElasticDriver,
                                                         FixedHosts)
    cmd = [sys.executable, os.path.abspath(__file__), "--elastic-worker",
           json.dumps({"log_prefix": log_prefix, "ckpt_dir": ckpt_dir})]
    driver = ElasticDriver(FixedHosts(hosts), cmd, min_np=1, max_np=1,
                           extra_env=extra_env, verbose=True)
    result = {}
    th = threading.Thread(target=lambda: result.update(rc=driver.run()),
                          daemon=True)
    th.start()
    try:
        if during is not None:
            during(driver)
    finally:
        th.join(ELASTIC_DEADLINE_S)
        if th.is_alive():
            driver.preempt("chip_smoke phase 17 deadline")
            th.join(60)
    events = []
    for path in glob.glob(log_prefix + ".*"):
        with open(path) as f:
            events += [json.loads(line) for line in f]
    events.sort(key=lambda e: e["t"])
    return result.get("rc"), sorted(driver._blacklist), events


def elastic_losses(events, n_steps=ELASTIC_STEPS):
    """{step: loss} of the committed steps (a step logged twice, by a
    worker and its successor, must agree)."""
    out = {}
    for e in events:
        if e["event"] in ("step", "interrupt"):
            assert out.get(e["step"], e["loss"]) == e["loss"], e
            out[e["step"]] = e["loss"]
    return [out[i] for i in range(1, n_steps + 1)]


def elastic_launches(events):
    """Kernel launches of every worker process, summed (each process
    counts from 0)."""
    last = {}
    for e in events:
        if "launches" in e:
            last[e["pid"]] = e["launches"]
    return {n: sum(p[n] for p in last.values()) for n in KERNELS}


def phase_elastic(torch, hvd, tfm, fa, cfg, par, card):
    """Phase 17: elastic training on the card; returns the report."""
    import tempfile
    from horovod_tpu_torch.runner.hosts import HostInfo
    report = {}
    # The uninterrupted run, twice, in this process: the losses to match
    # and their run-to-run spread.
    hvd.init()
    try:
        batches = elastic_batches(tfm, cfg, 8)
        clean = []
        for _ in range(2):
            model = tfm.Transformer(cfg, par, seed=0)
            opt = hvd.ZeroShardedOptimizer(
                model, lambda ps: torch.optim.AdamW(
                    ps, lr=3e-4, weight_decay=1e-4), stage=2)
            step = tfm.make_train_step(cfg, par, model, opt)
            clean.append([step(*b).item() for b in batches])
            del model, opt, step
    finally:
        hvd.shutdown()
    spread = max(abs(x - y) for x, y in zip(*clean))
    report.update(clean_losses=clean, clean_spread=spread)
    torch.cuda.empty_cache()

    # (a) Kill and respawn.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, blacklist, ev = drive_elastic(
            [HostInfo("localhost", 1), HostInfo("127.0.0.1", 1)],
            {"HVD_TPU_CHAOS_KILL_STEPS": ELASTIC_KILL},
            os.path.join(tmp, "log"), os.path.join(tmp, "ckpt"))
        wall = time.perf_counter() - t0
    syncs = [(e["slot"], e["round"], e["path"], e["step"]) for e in ev
             if e["event"] == "sync"]
    losses = elastic_losses(ev)
    launches = elastic_launches(ev)
    diff = max(abs(x - y) for x, y in zip(losses, clean[0]))
    steps = [e for e in ev if e["event"] == "step"]
    resync = [e for e in ev if e["event"] == "sync"][-1]
    # The death follows the step-4 event at once; the successor's sync
    # event comes after its start, init and restore.
    respawn_s = resync["t"] - steps[3]["t"]
    step_s = statistics.median(b["t"] - a["t"] for a, b in
                               zip(steps, steps[1:]) if a["pid"] == b["pid"])
    log(f"[elastic] (a) kill and respawn: exit {rc}, blacklist {blacklist},"
        f" syncs (slot, round, path, step) {syncs}; losses {losses} "
        f"against the uninterrupted {clean[0]} (max |diff| {diff:.3g}, "
        f"run-to-run spread {spread:.3g}); kernel launches {launches}; "
        f"the death to the successor's synced state {respawn_s:.3f} s, of "
        f"which the disk sync {resync['sync_s']:.3f} s; a step with its "
        f"commit {step_s:.3f} s (median); {wall:.1f} s, on {card}")
    assert rc == 0, rc
    assert blacklist == ["localhost"], blacklist
    assert syncs == [("localhost:0", 0, "none", 0),
                     ("127.0.0.1:0", 1, "disk", 4)], syncs
    assert diff <= spread, (losses, clean)
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * ELASTIC_STEPS, launches
    report["kill"] = dict(exit=rc, blacklist=blacklist, syncs=syncs,
                          losses=losses, max_diff=diff, launches=launches,
                          respawn_s=respawn_s, sync_s=resync["sync_s"],
                          step_commit_s=step_s, seconds=wall)

    # (b) Reset in place, driven as a fleet scheduler drives it.
    def resize(driver):
        deadline = time.time() + ELASTIC_DEADLINE_S
        while time.time() < deadline:
            commit = driver.last_commit()
            if commit is not None and commit["generation"] >= 2:
                break
            time.sleep(0.05)
        announced = driver.announce_resize()
        # The next commit answers the announcement.  A commit whose
        # announcement landed just before it, and whose poll just after
        # it, took the interrupt already and waits for the round, so the
        # wait for a newer commit is bounded.
        answered = min(deadline, time.time() + ELASTIC_ANSWER_S)
        while time.time() < answered:
            commit = driver.last_commit()
            if commit is not None and commit["ts"] > announced:
                break
            time.sleep(0.05)
        timing["request"] = time.time()
        assert driver.request_resize(1, reason="chip_smoke phase 17 (b)")

    timing = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc, blacklist, ev = drive_elastic(
            [HostInfo("localhost", 1)],
            {"HVD_TPU_FLEET_JOB_ID": "chip-smoke"},
            os.path.join(tmp, "log"), os.path.join(tmp, "ckpt"), resize)
        wall = time.perf_counter() - t0
    syncs = [(e["round"], e["path"], e["step"]) for e in ev
             if e["event"] == "sync"]
    pids = {e["pid"] for e in ev}
    (interrupt,) = [e for e in ev if e["event"] == "interrupt"]
    (reset,) = [e for e in ev if e["event"] == "reset_done"]
    resync = [e for e in ev if e["event"] == "sync"][-1]
    losses = elastic_losses(ev)
    launches = elastic_launches(ev)
    diff = max(abs(x - y) for x, y in zip(losses, clean[0]))
    reset_s = reset["t"] - interrupt["t"]
    after_request_s = reset["t"] - timing["request"]
    log(f"[elastic] (b) reset in place: exit {rc}, one process "
        f"({len(pids)} pid), HostsUpdatedInterrupt at step "
        f"{interrupt['step']}, syncs (round, path, step) {syncs}; reset "
        f"(interrupt -> init done, waiting for the driver's round) "
        f"{reset_s:.3f} s, of which {after_request_s:.3f} s after "
        f"request_resize; sync {resync['sync_s']:.3f} s; losses {losses} "
        f"(max |diff| {diff:.3g} against the uninterrupted run); kernel "
        f"launches {launches}; {wall:.1f} s, on {card}")
    assert rc == 0 and blacklist == [], (rc, blacklist)
    assert len(pids) == 1, pids
    assert syncs == [(0, "none", 0), (1, "peer", interrupt["step"])], syncs
    assert diff <= spread, (losses, clean)
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * ELASTIC_STEPS, launches
    report["reset"] = dict(exit=rc, syncs=syncs, losses=losses,
                           max_diff=diff, launches=launches,
                           interrupt_step=interrupt["step"],
                           reset_s=reset_s,
                           reset_after_request_s=after_request_s,
                           sync_s=resync["sync_s"], seconds=wall)
    return report


def merged_step_windows(trace, n_steps):
    """From a merged trace: the flight marks of the steps (μs on the
    merged clock), and per gradient name its NEGOTIATE begin events of
    the native timeline, in order."""
    marks = {e["name"]: e["ts"] for e in trace["traceEvents"]
             if e.get("cat") == "smoke.step"}
    edges = [marks[f"step{i}"] for i in range(n_steps)] + [marks["end"]]
    negotiated = collections.defaultdict(list)
    for e in sorted(trace["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("cat") == "NEGOTIATE" and e.get("ph") == "B" and \
                str(e.get("name", "")).startswith(
                    "DistributedOptimizer.grad."):
            negotiated[e["name"]].append(e)
    return edges, negotiated


def phase_debug(torch, hvd, tfm, fa, cfg, par, tokens, labels, card):
    """Phase 18: the flagship's step with the debug plane of a launched
    job; returns the report."""
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch.data import ArraySource, DataLoader
    from horovod_tpu_torch.debug import hang, merge, regression
    from horovod_tpu_torch.metrics import attribution, baseline
    from horovod_tpu_torch.runner.rendezvous import (RendezvousServer,
                                                     http_get, sign_request)
    report = {}
    work = tempfile.mkdtemp(prefix="hvd_debug_")
    secret = "chip-smoke-debug"
    kv = RendezvousServer(host="127.0.0.1", port=0, secret=secret)
    kv.start()
    env = dict(DRIFT_ENV, HVD_TPU_RENDEZVOUS_ADDR=f"127.0.0.1:{kv.port}",
               HVD_TPU_RENDEZVOUS_SECRET=secret,
               HVD_TPU_CONTROLLER_ADDR=f"127.0.0.1:{free_port()}",
               HVD_TPU_FLIGHT_HOST="127.0.0.1", HVD_TPU_FLIGHT_DIR=work)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def get(addr, path, signed=True):
        req = urllib.request.Request(f"http://{addr}{path}")
        if signed:
            sign_request(req, "GET", "debug", path.rsplit("/", 1)[1])
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.read(), time.perf_counter() - t
        except urllib.error.HTTPError as e:
            return e.code, e.read(), time.perf_counter() - t

    try:
        hvd.init(use_controller=True)
        addr = http_get(env["HVD_TPU_RENDEZVOUS_ADDR"], "debug",
                        "flight_addr_0").decode()
        assert hang._watchdog is not None   # rank 0 under FLIGHT_ESCALATE
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        step = tfm.make_train_step(cfg, par, model, opt)
        step(tokens, labels)                  # warm-up, outside the count
        torch.cuda.synchronize()

        # (a) steps under the fetches, timeline on.
        timeline = os.path.join(work, "timeline.json")
        t0 = time.time()
        hvd.start_timeline(timeline)
        anchor_us = (time.time() - t0) / 2 * 1e6
        fetched = collections.defaultdict(list)
        errors, stop = [], threading.Event()

        def fetcher():
            try:
                while not stop.is_set():
                    for path in ("/debug/flight", "/debug/stacks",
                                 "/healthz"):
                        fetched[path].append(
                            get(addr, path, path != "/healthz"))
                    stop.wait(0.02)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        th = threading.Thread(target=fetcher, daemon=True)
        fa.reset_launches()
        th.start()
        losses, times = [], []
        for i in range(DEBUG_STEPS):
            debug.record("smoke.step", f"step{i}")
            t = time.perf_counter()
            loss = step(tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
        debug.record("smoke.step", "end")
        launches = dict(fa.launches)
        stop.set()
        th.join(30)
        hvd.stop_timeline()
        assert not errors and not th.is_alive(), errors
        assert all(math.isfinite(x) for x in losses), losses
        assert losses[-1] < losses[0], losses
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * DEBUG_STEPS, launches
        codes = {p: sorted({c for c, _, _ in r}) for p, r in fetched.items()}
        assert all(c == [200] for c in codes.values()), codes
        last = json.loads(fetched["/debug/flight"][-1][1])
        assert any(e["kind"] == "smoke.step" for e in last["events"])
        assert any(b"phase_debug" in body
                   for _, body, _ in fetched["/debug/stacks"]), \
            "no stacks fetched with the main thread in a step"
        assert all(body == b"ok" for _, body, _ in fetched["/healthz"])
        refused = get(addr, "/debug/flight", signed=False)[0]
        assert refused == 403, refused
        fetch_ms = {p: statistics.median(s for _, _, s in r) * 1e3
                    for p, r in fetched.items()}

        # The merge: the flight dump and the native timeline on one clock.
        dump = debug.flight.recorder().dump_obj()
        trace = merge.merge_dumps([dump], merge.load_timeline(timeline))
        edges, negotiated = merged_step_windows(trace, DEBUG_STEPS)
        n_grads = len(list(model.parameters()))
        assert len(negotiated) == n_grads, sorted(negotiated)
        slack = anchor_us + MERGE_SLACK_US
        outside = []
        for name, evs in negotiated.items():
            assert len(evs) == DEBUG_STEPS, (name, len(evs))
            assert not any("merge.unanchored" in (e.get("args") or {})
                           for e in evs)
            for i, e in enumerate(evs):
                if not edges[i] - slack <= e["ts"] <= edges[i + 1] + slack:
                    outside.append((name, i, e["ts"], edges[i],
                                    edges[i + 1]))
        assert not outside, outside[:5]
        # How far inside its step the first gradient's negotiation starts.
        lead_ms = [(min(evs[i]["ts"] for evs in negotiated.values())
                    - edges[i]) / 1e3 for i in range(DEBUG_STEPS)]
        report["endpoint"] = {
            "losses": losses, "step_s": statistics.median(times[1:]),
            "launches": launches,
            "fetches": {p: len(r) for p, r in fetched.items()},
            "fetch_ms": fetch_ms, "merged_events": len(trace["traceEvents"]),
            "timeline_anchor_uncertainty_us": anchor_us,
            "first_negotiate_after_step_mark_ms": lead_ms}
        log(f"[debug] (a) {DEBUG_STEPS} steps, median "
            f"{report['endpoint']['step_s'] * 1e3:.3f} ms, while a thread "
            f"fetched /debug/flight, /debug/stacks, /healthz "
            f"{dict(report['endpoint']['fetches'])} times (medians "
            + ", ".join(f"{p} {v:.2f} ms" for p, v in fetch_ms.items())
            + f"); launches {launches}; merged trace "
            f"{len(trace['traceEvents'])} events: every gradient's "
            f"NEGOTIATE inside its step's flight window (anchor "
            f"+/-{anchor_us:.0f} us); first negotiation "
            f"{statistics.median(lead_ms):.3f} ms after the step's mark; "
            f"on {card}")

        # (b) the input drift drill, fed on the card.  The attribution
        # starts afresh, as in the reference's drill process: the seconds
        # earlier phases left in its counters since their last step
        # (checkpoint saves, collectives) would make the drill's first
        # record, and with it the detector's baseline shares, theirs.
        baseline.reset_drift_detector()
        regression.reset()
        attribution.attribution().reset()
        seqs = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (256, cfg.seq_len + 1), dtype=np.int32)
        agg = metrics.Aggregator()
        drill_times, n = [], 0

        def drill(n_steps):
            nonlocal n
            loader = DataLoader(ArraySource(seqs), tokens.shape[0],
                                shuffle=True, seed=n, prefetch=False,
                                device=str(hvd.device()))
            it = iter(loader)
            for _ in range(n_steps):
                t = time.perf_counter()
                b = next(it)
                step(b[:, :-1].long(), b[:, 1:].long()).item()
                n += 1
                agg.step_end(step=n)
                drill_times.append(time.perf_counter() - t)
            loader.close()

        drill(DRIFT_BASELINE)
        before = baseline.drift_detector().events()
        assert before == [], [e.as_dict() for e in before]
        os.environ["HVD_TPU_CHAOS_INPUT_DELAY_MS"] = str(DRIFT_DELAY_MS)
        try:
            drill(DRIFT_SLOWED)
        finally:
            del os.environ["HVD_TPU_CHAOS_INPUT_DELAY_MS"]
        (ev,) = baseline.drift_detector().events()
        rep = regression.last_report()
        assert ev.component == "input" and ev.ratio > 1.5, ev.as_dict()
        assert ev.step <= DRIFT_BASELINE + DRIFT_SLOWED, ev.as_dict()
        assert rep["component"] == "input", rep["component"]
        assert (rep["suspect"]["subsystem"], rep["suspect"]["kind"]) == \
            ("data", "data.chaos_delay"), rep["suspect"]
        assert os.path.exists(rep["path"]) and ev.report_path == rep["path"]
        code, body, _ = get(addr, "/debug/regression")
        assert code == 200 and json.loads(body) == json.loads(
            json.dumps(rep, default=str)), code
        report["drift"] = {
            "event": ev.as_dict(), "verdict": rep["verdict"],
            "suspect": rep["suspect"]["kind"],
            "vs_onset_s": rep["suspect"]["vs_onset_s"],
            "step_ms_before": statistics.median(
                drill_times[1:DRIFT_BASELINE]) * 1e3,
            "step_ms_after": statistics.median(
                drill_times[DRIFT_BASELINE:]) * 1e3}
        log(f"[debug] (b) input drill: {DRIFT_BASELINE} steps fed on the "
            f"card at {report['drift']['step_ms_before']:.2f} ms, then "
            f"{DRIFT_SLOWED} with a {DRIFT_DELAY_MS} ms input delay at "
            f"{report['drift']['step_ms_after']:.2f} ms: one drift at step "
            f"{ev.step} (onset {ev.onset_step}), component {ev.component}, "
            f"ratio {ev.ratio:.2f}; report: {rep['verdict']}")
    finally:
        baseline.reset_drift_detector()
        regression.reset()
        hvd.shutdown()
        debug.stop_serving()
        kv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    return report


# Phase 19: the flagship's steps under the tree sync (a sync every
# OBSERVE_SYNC steps), the verdict-parity windows (PARITY_WINDOWS windows
# of PARITY_STEPS steps, the window PARITY_STRAGGLER fed with a
# PARITY_DELAY_MS input delay) and the KV's secret.
OBSERVE_STEPS, OBSERVE_SYNC = 20, 5
PARITY_WINDOWS, PARITY_STEPS, PARITY_DELAY_MS = 4, 5, 200
PARITY_STRAGGLER = 2
OBSERVE_SECRET = "chip-smoke-observe"
TOL_MFU_PARITY = 1e-9      # min and mean of the MFU: exact up to sum order


def phase_observe(torch, hvd, tfm, fa, cfg, par, tokens, labels, card):
    """Phase 19: the fleet-level observer on the card; returns the
    report."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    import numpy as np
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.data import ArraySource, DataLoader
    from horovod_tpu_torch.metrics import digest as D
    from horovod_tpu_torch.metrics import observer as OB
    from horovod_tpu_torch.metrics.health import StragglerDetector
    from horovod_tpu_torch.runner.rendezvous import (RendezvousServer,
                                                     sign_request)
    report = {}
    host = "127.0.0.1"
    kvs = [RendezvousServer(host=host, port=0, secret=OBSERVE_SECRET)
           for _ in range(2)]
    for kv in kvs:
        kv.start()
    # The straggler window's drift report goes to a temporary directory,
    # not the checkout.
    work = tempfile.mkdtemp(prefix="hvd_observe_")
    env = {"HVD_TPU_RENDEZVOUS_ADDR": f"{host}:{kvs[0].port}",
           "HVD_TPU_RENDEZVOUS_SECRET": OBSERVE_SECRET,
           "HVD_TPU_METRICS_TREE": "1",
           "HVD_TPU_METRICS_SYNC_STEPS": str(OBSERVE_SYNC),
           "HVD_TPU_FLIGHT_HOST": host, "HVD_TPU_FLIGHT_DIR": work}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def get(addr, path, signed=True):
        req = urllib.request.Request(f"http://{addr}{path}")
        if signed:
            scope, key = path.split("?")[0].split("/")[1:3]
            sign_request(req, "GET", scope, key)
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read(), time.perf_counter() - t
        except urllib.error.HTTPError as e:
            return e.code, e.read(), time.perf_counter() - t

    try:
        hvd.init()
        ob = OB.current_observer()
        assert ob is not None and ob.local_ranks == [0], ob
        server = metrics.serve(port=0, host=host)
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        step = tfm.make_train_step(cfg, par, model, opt)
        step(tokens, labels)                  # warm-up, outside the count
        torch.cuda.synchronize()
        reg = metrics.registry()
        agg = metrics.aggregator()
        syncs = reg.counter("hvd_metrics_syncs_total",
                            "Cross-rank metric aggregations")
        stale = reg.counter("hvd_metrics_tree_stale_rounds_total",
                            "Tree syncs that served a previous round's "
                            "digest (exchange deadline missed)")
        sync_s = reg.gauge("hvd_metrics_sync_seconds",
                           "Duration of the last metrics aggregation "
                           "(gather + health scoring)")

        def run():
            """OBSERVE_STEPS steps, each closed by step_end (whose
            cadence runs the sync); the losses, walls (the step and its
            step_end) and one record a sync."""
            agg.reset()
            losses, walls, rounds = [], [], []
            for _ in range(OBSERVE_STEPS):
                n = syncs.value
                t = time.perf_counter()
                loss = step(tokens, labels)
                torch.cuda.synchronize()
                agg.step_end()
                walls.append(time.perf_counter() - t)
                losses.append(loss.item())
                if syncs.value > n:
                    d = agg.fleet_digest() if global_state.metrics_tree \
                        else None
                    rounds.append({"seconds": sync_s.value, **(
                        {k: d[k] for k in ("round", "ranks", "hosts",
                                           "failed_hosts", "missing")}
                        if d else {})})
            assert all(math.isfinite(x) for x in losses), losses
            return losses, walls, rounds

        # (a) the tree sync through the observer, every OBSERVE_SYNC steps.
        stale0 = stale.value
        fa.reset_launches()
        tree_losses, tree_walls, tree_rounds = run()
        launches = dict(fa.launches)
        for n in KERNELS:
            assert launches[n] == cfg.n_layers * OBSERVE_STEPS, launches
        assert [r["round"] for r in tree_rounds] == list(range(
            1, OBSERVE_STEPS // OBSERVE_SYNC + 1)), tree_rounds
        assert all((r["ranks"], r["hosts"], r["failed_hosts"],
                    r["missing"]) == (1, [host], [], [])
                   for r in tree_rounds), tree_rounds
        assert stale.value == stale0, "a tree sync served a stale round"
        report["tree"] = {"losses": tree_losses, "launches": launches,
                          "rounds": tree_rounds,
                          "step_s": statistics.median(tree_walls[1:])}
        log(f"[observe] (a) {OBSERVE_STEPS} steps, a tree sync every "
            f"{OBSERVE_SYNC}: rounds "
            f"{[r['round'] for r in tree_rounds]} fresh, ranks 1, hosts "
            f"[{host}]; launches {launches}; on {card}")

        # (c) the routes, signed and unsigned, on the observer's own port
        # and on the metrics port.
        fetched = {}
        last = tree_rounds[-1]["round"]
        for where, addr in (("observer", ob.addr),
                            ("metrics", f"{host}:{server.port}")):
            routes = ["/observe/digest", f"/observe/fleet?round={last}",
                      "/observe/dumps"]
            if where == "metrics":
                routes.append("/debug/fleet_scalars")
            for path in routes:
                code, body, secs = get(addr, path)
                assert code == 200, (where, path, code, body[:200])
                refused = get(addr, path, signed=False)[0]
                assert refused == 403, (where, path, refused)
                payload = json.loads(body)
                if path.startswith("/observe/dumps"):
                    assert payload["host"] == host and \
                        payload["ranks"]["0"]["events"], payload.keys()
                elif path.startswith("/debug"):
                    merged = payload["merged"]
                    assert merged["ranks_merged"] == 1 and \
                        merged["hosts"] == [host], merged.keys()
                    assert merged["counters"]["hvd_steps_total"] > 0
                else:
                    assert (payload["round"], payload["hosts"]) == \
                        (last, [host]), path
                fetched[f"{where} {path.split('?')[0]}"] = {
                    "ms": secs * 1e3, "bytes": len(body)}
        report["routes"] = fetched
        log(f"[observe] (c) signed 200, unsigned 403: " + ", ".join(
            f"{k} {v['ms']:.2f} ms ({v['bytes']} B)"
            for k, v in fetched.items()))

        # (d) the same steps under the flat sync.
        global_state.metrics_tree = False
        try:
            flat_losses, flat_walls, flat_rounds = run()
        finally:
            global_state.metrics_tree = True
        report["flat"] = {"losses": flat_losses, "rounds": flat_rounds,
                          "step_s": statistics.median(flat_walls[1:])}
        tree_sync = [r["seconds"] for r in tree_rounds]
        flat_sync = [r["seconds"] for r in flat_rounds]
        report["sync_s"] = {"tree": tree_sync, "flat": flat_sync}
        log(f"[observe] (d) sync a round: tree "
            f"{statistics.median(tree_sync) * 1e3:.3f} ms (max "
            f"{max(tree_sync) * 1e3:.3f}), flat "
            f"{statistics.median(flat_sync) * 1e3:.3f} ms (max "
            f"{max(flat_sync) * 1e3:.3f}); step with its step_end: tree "
            f"{report['tree']['step_s'] * 1e3:.3f} ms, flat "
            f"{report['flat']['step_s'] * 1e3:.3f} ms (medians of steps "
            f"1-{OBSERVE_STEPS - 1}); on {card}")

        # (b) verdict parity: PARITY_WINDOWS windows of steps on the card
        # as the snapshots of as many ranks on two hosts; the flat
        # sync's scoring and MFU gauges against two observers' fleet
        # digest over the second signed KV.
        # Each window closes by its own sync, not step_end's cadence.
        global_state.metrics_tree = False
        global_state.metrics_sync_steps = 0
        seqs = np.random.default_rng(19).integers(
            0, cfg.vocab_size, (64, cfg.seq_len + 1), dtype=np.int32)
        metrics.set_step_flops(tfm.train_flops_per_seq(cfg)
                               * tokens.shape[0])
        window_agg = metrics.Aggregator()
        snaps, window_ms = [], []
        try:
            for w in range(PARITY_WINDOWS):
                if w == PARITY_STRAGGLER:
                    os.environ["HVD_TPU_CHAOS_INPUT_DELAY_MS"] = \
                        str(PARITY_DELAY_MS)
                loader = DataLoader(ArraySource(seqs), tokens.shape[0],
                                    shuffle=True, seed=w, prefetch=False,
                                    device=str(hvd.device()))
                it = iter(loader)
                walls = []
                for _ in range(PARITY_STEPS):
                    t = time.perf_counter()
                    b = next(it)
                    step(b[:, :-1].long(), b[:, 1:].long()).item()
                    walls.append(time.perf_counter() - t)
                    window_agg.step_end(step_time_s=walls[-1])
                loader.close()
                os.environ.pop("HVD_TPU_CHAOS_INPUT_DELAY_MS", None)
                (snap,) = window_agg.sync()
                snap["rank"] = w
                snaps.append(snap)
                window_ms.append(statistics.median(walls) * 1e3)
        finally:
            os.environ.pop("HVD_TPU_CHAOS_INPUT_DELAY_MS", None)
            metrics.set_step_flops(0.0)
            global_state.metrics_tree = True
            global_state.metrics_sync_steps = OBSERVE_SYNC
        flat = sorted((h.rank, h.flagged, h.cause)
                      for h in StragglerDetector().score_ranks(snaps))
        metrics.Aggregator._fleet_mfu_gauges(snaps, reg)
        mfu_flat = {k: reg.gauge(f"hvd_mfu_fleet_{k}", "").value
                    for k in ("min", "mean")}
        rdv = f"{host}:{kvs[1].port}"
        obs = [OB.HostObserver(name, ranks, cross_rank=c, cross_size=2,
                               rdv_addr=rdv).start()
               for c, (name, ranks) in enumerate(
                   ((host, [0, 1]), ("localhost", [2, 3])))]
        try:
            t = time.perf_counter()
            for snap in snaps:
                obs[snap["rank"] // 2].submit_snapshot(1, snap)
            fleet = obs[0].fleet_digest(min_round=1, wait_s=30)
            exchange_s = time.perf_counter() - t
        finally:
            for o in obs:
                o.stop()
        assert (fleet["round"], fleet["ranks"], fleet["hosts"],
                fleet["failed_hosts"]) == (1, PARITY_WINDOWS,
                                           [host, "localhost"], []), fleet
        tree = sorted((h.rank, h.flagged, h.cause)
                      for h in StragglerDetector().score_digest(fleet))
        mfu_tree = D.digest_mfu(fleet)
        assert tree == flat, (tree, flat)
        assert [(r, c) for r, f, c in tree if f] == \
            [(PARITY_STRAGGLER, "input")], tree
        for k in ("min", "mean"):
            assert abs(mfu_tree[k] - mfu_flat[k]) <= \
                TOL_MFU_PARITY * mfu_flat[k], (k, mfu_tree, mfu_flat)
        report["parity"] = {"verdicts": tree, "window_ms": window_ms,
                            "mfu_flat": mfu_flat, "mfu_tree": mfu_tree,
                            "exchange_s": exchange_s}
        log(f"[observe] (b) {PARITY_WINDOWS} windows of {PARITY_STEPS} "
            f"steps as ranks on two hosts (median step "
            + ", ".join(f"{x:.1f}" for x in window_ms)
            + f" ms; window {PARITY_STRAGGLER} under a {PARITY_DELAY_MS} "
            f"ms input delay): verdicts tree = flat = {tree}; MFU min / "
            f"mean tree {mfu_tree['min']:.6f} / {mfu_tree['mean']:.6f}, "
            f"flat {mfu_flat['min']:.6f} / {mfu_flat['mean']:.6f}; two "
            f"observers' exchange {exchange_s * 1e3:.2f} ms; on {card}")
    finally:
        hvd.shutdown()
        metrics.stop_serving()
        for kv in kvs:
            kv.stop()
        shutil.rmtree(work, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert OB.current_observer() is None
    return report


# Phase 20: the prompts migrated (PREFILL_LENS, the longest cut so that
# its DISAGG_NEW decode tokens fit a 512-token slot), the full slot of
# the codec check (32 pages), and the requests the decode replica already
# serves, so that a migrated request lands in another slot and batch.
DISAGG_LENS = PREFILL_LENS[:-1] + (PREFILL_LENS[-1] - 16,)
DISAGG_NEW = 16
DISAGG_FULL = SERVE_GEOMETRY["max_len"] - 2
DISAGG_RESIDENT = 2


def phase_disagg(torch, hvd, tfm, fa, cfg, par, model, card):
    """Phase 20: disaggregated prefill/decode between two engines on the
    card; returns the report."""
    import numpy as np
    from horovod_tpu_torch import debug, metrics
    from horovod_tpu_torch import serving as S
    from horovod_tpu_torch.debug import merge
    from horovod_tpu_torch.recovery import transport
    from horovod_tpu_torch.serving import disagg, tracing
    report = {}
    hvd.init()
    rng = np.random.default_rng(20)
    cfg32 = cfg._replace(dtype=torch.float32)

    def engine(c):
        return S.DecodeEngine(c, model, prefix_cache=False,
                              **SERVE_GEOMETRY)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def request(rid, p, **kw):
        return S.Request(id=rid, prompt=list(p),
                         max_new_tokens=DISAGG_NEW, **kw)

    def finish(e, rid, toks):
        """Decode iterations until ``rid`` finishes; its tokens."""
        while True:
            for ev in e.step():
                if ev.request.id != rid:
                    continue
                if ev.kind == "token":
                    toks.append(ev.token)
                elif ev.kind == "finish":
                    return toks

    def first(events, rid):
        return [ev.token for ev in events
                if ev.kind == "token" and ev.request.id == rid]

    # (a) the codec on a full slot's pages (fp32 pool).
    e = engine(cfg32)
    e.admit(S.Request(id="full", prompt=prompt(DISAGG_FULL),
                      max_new_tokens=2))
    state, k, v = e.export_request("full")
    assert k.shape == (cfg.n_layers, SERVE_GEOMETRY["max_len"]
                       // SERVE_GEOMETRY["page_tokens"],
                       SERVE_GEOMETRY["page_tokens"], cfg.n_heads,
                       cfg.head_dim), k.shape
    del e
    codec = {}
    for bits in (0, 8, 4):
        t = time.perf_counter()
        blob = disagg.encode_bundle(state, k, v, bits=bits)
        enc = time.perf_counter() - t
        t = time.perf_counter()
        state2, k2, v2 = disagg.decode_bundle(blob)
        dec = time.perf_counter() - t
        assert state2 == json.loads(json.dumps(state))
        if bits == 0:
            assert k2.tobytes() == k.tobytes() and \
                v2.tobytes() == v.tobytes()
            worst = 0.0
        else:
            # Half a grid step of the block's scale, plus the fp32
            # roundings of the scale and of the dequantized product (two
            # units in the last place of the block's absmax).
            worst = 0.0
            for got, want in ((k2, k), (v2, v)):
                blocks = want.reshape(-1, 256)
                absmax = np.abs(blocks).max(axis=1)
                step_ = absmax / (127.0 if bits == 8 else 7.0)
                err = np.abs(got.reshape(-1, 256) - blocks).max(axis=1)
                assert np.all(err <= 0.5 * step_ + 2 * np.finfo(
                    np.float32).eps * absmax), bits
                worst = max(worst, float((err / np.where(
                    step_ > 0, step_, 1.0)).max()))
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        for broken in (bytes(bad), blob[:-3]):
            try:
                disagg.decode_bundle(broken)
            except ValueError:
                pass
            else:
                raise AssertionError("a corrupted bundle decoded")
        codec[bits] = {"bytes": len(blob),
                       "wire_ratio": disagg.wire_ratio(bits, k.size),
                       "encode_s": enc, "decode_s": dec,
                       "worst_err_in_grid_steps": worst}
    report["codec"] = {"shape": list(k.shape), "wires": codec}
    log(f"[disagg] (a) a full slot's pages {tuple(k.shape)} fp32: "
        + "; ".join(f"bits {b}: {c['bytes']} B, wire ratio "
                    f"{c['wire_ratio']:.3f}, encode {c['encode_s']:.3f} s, "
                    f"decode {c['decode_s']:.3f} s, worst error "
                    f"{c['worst_err_in_grid_steps']:.3f} grid steps"
                    for b, c in codec.items())
        + "; a flipped byte and a torn tail raise")

    # (b) migrate on the fp32 wire after each prefill; the decode replica
    # already serves DISAGG_RESIDENT requests.
    def migrate_all(c, bits):
        ref = engine(c)
        want = {}
        for n in DISAGG_LENS:
            rid = f"u{n}"
            want[n] = finish(ref, rid, first(
                ref.admit(request(rid, prompts[n])), rid))
        del ref
        src, dst = engine(c), engine(c)
        for i in range(DISAGG_RESIDENT):
            dst.admit(S.Request(
                id=f"res{i}", prompt=prompt(32),
                max_new_tokens=SERVE_GEOMETRY["max_len"] - 32))
        got, walls, sizes = {}, [], []
        fa.reset_launches()
        for n in DISAGG_LENS:
            rid = f"m{n}"
            toks = first(src.admit(request(rid, prompts[n])), rid)
            t = time.perf_counter()
            sizes.append(disagg.migrate(src, rid, dst, bits=bits))
            walls.append(time.perf_counter() - t)
            got[n] = finish(dst, rid, toks)
        launches = dict(fa.launches)
        agree = {n: next((i for i, (a, b) in enumerate(
            zip(got[n], want[n])) if a != b), len(want[n]))
            for n in DISAGG_LENS}
        return got, want, agree, walls, sizes, launches

    prompts = {n: prompt(n) for n in DISAGG_LENS}
    got, want, agree, walls, sizes, _ = migrate_all(cfg32, 0)
    assert got == want, agree
    got16, want16, agree16, walls16, sizes16, launches = migrate_all(cfg, 0)
    report["migrate"] = {
        "lens": DISAGG_LENS, "fp32": {"equal": True, "seconds": walls,
                                      "bytes": sizes},
        "bf16": {"tokens_agreeing": agree16, "equal": got16 == want16,
                 "seconds": walls16, "bytes": sizes16},
        "launches": launches}
    log(f"[disagg] (b) migrate on the fp32 wire after prefills of "
        f"{DISAGG_LENS}, {DISAGG_NEW} tokens each, beside "
        f"{DISAGG_RESIDENT} resident requests: fp32 token for token "
        f"({', '.join(f'{s} B in {w * 1e3:.1f} ms' for s, w in zip(sizes, walls))}); "
        f"bf16 tokens agreeing before the first difference "
        f"{agree16} of {DISAGG_NEW}; launches {launches}; on {card}")

    # (c) send / receive through a recovery server's mailbox, int8 wire.
    server = transport.RecoveryServer(host="127.0.0.1")
    addr = f"127.0.0.1:{server.start()}"
    reg = metrics.registry()
    migrations = reg.counter("hvd_serving_migrations_total",
                             "Requests migrated prefill-pool -> decode-pool")
    wire = reg.counter("hvd_serving_migrate_bytes_total",
                       "KV-migration payload bytes put on the wire")
    m0, b0 = migrations.value, wire.value
    # The recorder is a ring that earlier phases filled: events are
    # told apart by their sequence numbers, not by the ring's length.
    seq0 = max((ev["seq"] for ev in debug.snapshot()), default=-1)
    src, dst = engine(cfg), engine(cfg)
    sent = []
    try:
        os.environ["HVD_TPU_NET_HTTP_RETRIES"] = "1"
        rid = "dead"
        src.admit(request(rid, prompts[DISAGG_LENS[0]]))
        try:
            disagg.send(src, rid, f"127.0.0.1:{free_port()}", bits=8,
                        timeout=2.0)
        except RuntimeError:
            pass
        else:
            raise AssertionError("a push to a closed port landed")
        assert src.active() == 1             # the source kept the slot
        del os.environ["HVD_TPU_NET_HTTP_RETRIES"]
        first_bytes = disagg.send(src, rid, addr, bits=8)
        assert src.active() == 0
        assert disagg.receive(dst, rid, addr)
        assert not disagg.receive(dst, rid, addr)   # one-shot mailbox
        finish(dst, rid, [])
        ctx = tracing.mint("traced", rate=1.0, seed=0)
        for n in DISAGG_LENS:
            rid = "traced" if n == DISAGG_LENS[-1] else f"s{n}"
            toks = first(src.admit(request(
                rid, prompts[n], trace=ctx if rid == "traced" else None)),
                rid)
            t = time.perf_counter()
            nbytes = disagg.send(src, rid, addr, bits=8)
            t_send = time.perf_counter() - t
            t = time.perf_counter()
            assert disagg.receive(dst, rid, addr)
            t_recv = time.perf_counter() - t
            toks = finish(dst, rid, toks)
            sent.append({"length": n, "bytes": nbytes, "send_s": t_send,
                         "receive_s": t_recv,
                         "tokens_agreeing": next(
                             (i for i, (a, b) in enumerate(zip(
                                 toks, want16[n])) if a != b),
                             DISAGG_NEW)})
    finally:
        os.environ.pop("HVD_TPU_NET_HTTP_RETRIES", None)
        server.stop()
    report["send"] = sent
    log(f"[disagg] (c) send/receive over the recovery mailbox, int8 wire: "
        + "; ".join(f"{s['length']} tokens: {s['bytes']} B, send "
                    f"{s['send_s'] * 1e3:.1f} ms, receive "
                    f"{s['receive_s'] * 1e3:.1f} ms, {s['tokens_agreeing']}"
                    f"/{DISAGG_NEW} tokens as bf16 unmigrated"
                    for s in sent)
        + "; a failed push kept the source slot, the mailbox is one-shot")

    # (d) the counters, the flight events and the stitched trace.
    events = [ev for ev in debug.snapshot() if ev["seq"] > seq0]
    n_sent = len(sent) + 1
    assert migrations.value - m0 == n_sent, migrations.value - m0
    assert wire.value - b0 == first_bytes + sum(s["bytes"] for s in sent)
    assert sum(1 for ev in events if ev["kind"] == "serving.migrate") \
        == n_sent
    kinds = [sp[0] for sp in tracing.spans(ctx.trace_id)]
    for stage in ("admit", "migrate_export", "migrate", "migrate_adopt",
                  "finish"):
        assert stage in kinds, (stage, kinds)
    assert kinds.index("migrate_export") < kinds.index("migrate_adopt")
    trace = merge.merge_dumps(merge.filter_trace(
        [debug.flight.recorder().dump_obj()], ctx.trace_id))
    cats = [ev.get("cat") for ev in trace["traceEvents"]]
    assert "trace.migrate_export" in cats and \
        "trace.migrate_adopt" in cats, cats
    report["events"] = {"migrations": migrations.value - m0,
                        "bytes": wire.value - b0, "trace_spans": kinds}
    log(f"[disagg] (d) hvd_serving_migrations_total +{n_sent}, "
        f"hvd_serving_migrate_bytes_total +{int(wire.value - b0)}, "
        f"{n_sent} serving.migrate events, the traced request's spans "
        f"{kinds} stitched into one trace")
    hvd.shutdown()
    return report


# Phase 21: the launcher.  The launched worker is this script with
# --launched-worker; (a) trains the flagship on seeded batches, (b) runs
# one step through runner.run, (c) checks the reference's collective
# values on two CPU slots, (d) reruns phase 17 (a) through the CLI.
LAUNCH_STEPS = 10
LAUNCH_BATCH_SEED = 2100
LAUNCH_DEADLINE_S = 300.0


def launch_batches(tfm, cfg, batch, n_steps=LAUNCH_STEPS):
    return [tfm.synthetic_batch(cfg, batch, seed=LAUNCH_BATCH_SEED + i)
            for i in range(n_steps)]


def launch_train(torch, hvd, tfm, fa, n_steps=LAUNCH_STEPS):
    """The flagship's data-parallel step, DistributedOptimizer(AdamW), on
    phase 21's seeded batches: losses, host seconds a step and the
    kernels' launches.  Both the launched worker and the in-process run
    of (a) take it, on the world init() formed."""
    cfg = tfm.TransformerConfig(vocab_size=8192, d_model=512, n_heads=8,
                                d_ff=2048, n_layers=8, seq_len=512,
                                dtype=torch.bfloat16, remat=False)
    par = tfm.ParallelConfig()
    model = tfm.Transformer(cfg, par, seed=0)
    hvd.broadcast_parameters(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    step = tfm.make_train_step(cfg, par, model, opt)
    batches = launch_batches(tfm, cfg, 8, n_steps)
    fa.reset_launches()
    losses, times, first = [], [], None
    for tokens, labels in batches:
        torch.cuda.synchronize()
        if first is None:
            first = time.time()
        t0 = time.perf_counter()
        loss = step(tokens, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    return {"losses": losses, "step_times_s": times,
            "step_s": statistics.median(times[1:]) if len(times) > 1
            else times[0], "launches": dict(fa.launches),
            "first_step_t": first}


def launched_worker(out, kind="train"):
    """A worker the port's launcher started: ``train`` runs (a)'s steps on
    the card the launcher's plan gave it, ``cpu`` the reference's
    collective values (tests/test_runner.py:90-125) on a slot it pinned
    to the CPU.  One JSON file a rank at ``<out>.<rank>``."""
    started = time.time()
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    inited = time.time()
    rank, size = hvd.rank(), hvd.size()
    rec = {"rank": rank, "size": size, "device": str(hvd.device()),
           "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "controller": global_state.controller is not None,
           "started_t": started, "init_t": inited}
    if kind == "train":
        rec.update(launch_train(torch, hvd, tfm, fa),
                   device_count=torch.cuda.device_count())
    else:
        x = hvd.allreduce(torch.full((8,), float(rank + 1)), op=hvd.Sum)
        g = hvd.allgather(torch.full((rank + 1, 2), float(rank)))
        b = hvd.broadcast(torch.full((3,), float(rank)), root_rank=0)
        rec.update(sum=x.tolist(), gathered_rows=g.shape[0],
                   broadcast=b.tolist(),
                   backend=torch.distributed.get_backend())
    hvd.shutdown()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(rec, f)


def launched_step():
    """(b): one flagship step through ``runner.run``, as its worker:
    (device type, step-0 loss)."""
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import flash_attention as fa
    hvd.init()
    try:
        r = launch_train(torch, hvd, tfm, fa, n_steps=1)
        return hvd.device().type, r["losses"][0], r["launches"]
    finally:
        hvd.shutdown()


def launcher(args, env=None, timeout=LAUNCH_DEADLINE_S):
    """``python -m horovod_tpu_torch.runner.launch <args>`` from the
    checkout's root: (exit code, output, wall seconds, start time)."""
    t0, wall = time.time(), time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        log(out[-6000:])
    return proc.returncode, out, time.perf_counter() - wall, t0


def build_listing():
    root = os.path.join(ROOT, "horovod_tpu_torch", "_build")
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.path.getmtime(os.path.join(d, f)))
                  for d, _, fs in os.walk(root) for f in fs)


def phase_launch(torch, hvd, tfm, fa, cfg, par, elastic_report, card):
    """Phase 21: the port's launcher on the card; returns the report."""
    import glob
    import tempfile
    import threading
    from horovod_tpu_torch import runner
    report = {}
    # (a)'s bar: one in-process run of the same steps under the
    # controller, held within the run-to-run spread that phase 17
    # measured on the flagship at world 1 (phase 11 holds the
    # controller-attached step bit-equal to the step without it).
    os.environ["HVD_TPU_CONTROLLER_ADDR"] = f"127.0.0.1:{free_port()}"
    try:
        hvd.init(use_controller=True)
        inproc = launch_train(torch, hvd, tfm, fa)
    finally:
        hvd.shutdown()
        del os.environ["HVD_TPU_CONTROLLER_ADDR"]
    spread = elastic_report["clean_spread"]
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()

    # (a) a static launch of one worker, (b) runner.run(fn) in process
    # (spawn) and through the launcher's machinery (hosts=), and (c) two
    # CPU slots: each in a thread beside (d), all sharing the card.
    static, runs, cpu, errors = {}, {}, {}, {}

    def static_launch():
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "launched")
            rc, static["text"], static["wall_s"], static["t0"] = launcher(
                ["-np", "1", "-v", "--controller-port", str(free_port()),
                 sys.executable, os.path.abspath(__file__),
                 "--launched-worker", json.dumps({"out": out})])
            assert rc == 0, rc
            with open(out + ".0") as f:
                static["worker"] = json.load(f)

    def run_fn(label, kw):
        t1 = time.perf_counter()
        (res,) = runner.run(launched_step, np=1,
                            controller_port=free_port(), **kw)
        runs[label] = dict(device=res[0], loss=res[1], launches=res[2],
                           seconds=time.perf_counter() - t1)

    def cpu_slots():
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "cpu")
            cpu["rc"], cpu["text"], cpu["wall_s"], _ = launcher(
                ["-np", "2", "--worker-platform", "cpu",
                 "--controller-port", str(free_port()), sys.executable,
                 os.path.abspath(__file__), "--launched-worker",
                 json.dumps({"out": out, "kind": "cpu"})])
            cpu["ranks"] = [json.load(open(f"{out}.{r}")) for r in range(2)
                            if os.path.exists(f"{out}.{r}")]

    def guarded(name, fn, *a):
        try:
            fn(*a)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    side = [threading.Thread(target=guarded, args=a, daemon=True)
            for a in (("static", static_launch),
                      ("run_spawn", run_fn, "spawn", {}),
                      ("run_hosts", run_fn, "hosts",
                       {"hosts": "localhost:1"}),
                      ("cpu_slots", cpu_slots))]
    for th in side:
        th.start()

    # (d) Phase 17 (a) through the CLI: --host-discovery-script offers
    # localhost:1 and 127.0.0.1:1, min = max = 1; rank 0 dies after its
    # step-4 commit and the driver respawns it on 127.0.0.1.
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
        os.chmod(script, 0o755)
        log_prefix = os.path.join(tmp, "log")
        rc, text, wall_d, _ = launcher(
            ["--min-np", "1", "--max-np", "1", "--host-discovery-script",
             script, "--slots", "1", "-v", sys.executable,
             os.path.abspath(__file__), "--elastic-worker",
             json.dumps({"log_prefix": log_prefix,
                         "ckpt_dir": os.path.join(tmp, "ckpt")})],
            env={"HVD_TPU_CHAOS_KILL_STEPS": ELASTIC_KILL})
        ev = []
        for path in glob.glob(log_prefix + ".*"):
            with open(path) as f:
                ev += [json.loads(line) for line in f]
        ev.sort(key=lambda e: e["t"])
    syncs = [(e["slot"], e["round"], e["path"], e["step"]) for e in ev
             if e["event"] == "sync"]
    losses = elastic_losses(ev)
    launches = elastic_launches(ev)
    ref = elastic_report["kill"]["losses"]
    diff_d = max(abs(x - y) for x, y in zip(losses, ref))
    log(f"[launch] (d) hvdrun --host-discovery-script (min = max = 1, "
        f"{ELASTIC_KILL} killed): exit {rc}, syncs (slot, round, path, "
        f"step) {syncs}; losses {losses} against phase 17 (a)'s (max "
        f"|diff| {diff_d:.3g}, spread {elastic_report['clean_spread']:.3g});"
        f" kernel launches {launches}; {wall_d:.1f} s, on {card}")
    assert rc == 0, rc
    assert syncs == [("localhost:0", 0, "none", 0),
                     ("127.0.0.1:0", 1, "disk", 4)], syncs
    assert diff_d <= elastic_report["clean_spread"], (losses, ref)
    for n in KERNELS:
        assert launches[n] == cfg.n_layers * ELASTIC_STEPS, launches
    report["elastic_cli"] = dict(exit=rc, syncs=syncs, losses=losses,
                                 max_diff=diff_d, launches=launches,
                                 seconds=wall_d)

    for th in side:
        th.join(LAUNCH_DEADLINE_S)
    for name, e in errors.items():
        raise AssertionError(f"phase 21 {name} failed") from e
    w, t0 = static["worker"], static["t0"]
    diff = max(abs(x - y) for x, y in zip(w["losses"], inproc["losses"]))
    bit_equal = w["losses"] == inproc["losses"]
    start = {"worker_start_s": w["started_t"] - t0,
             "init_done_s": w["init_t"] - t0,
             "first_step_s": w["first_step_t"] - t0}
    log(f"[launch] (a) hvdrun -np 1: worker on {w['device']} "
        f"(CUDA_VISIBLE_DEVICES {w['cuda_visible']}, {w['device_count']} "
        f"card(s) seen), controller attached {w['controller']}; losses "
        f"{w['losses']} against the in-process run's {inproc['losses']} "
        f"(max |diff| {diff:.3g}, phase 17's run-to-run spread "
        f"{spread:.3g}, bit-equal {bit_equal}); kernel launches "
        f"{w['launches']}; step {w['step_s'] * 1e3:.3f} ms launched, beside"
        f" (b)-(d) on the same card, against {inproc['step_s'] * 1e3:.3f} "
        f"ms in process alone (medians of steps 1-{LAUNCH_STEPS - 1}); "
        f"from the launcher's start: worker up "
        f"{start['worker_start_s']:.3f} s, init done "
        f"{start['init_done_s']:.3f} s, first step "
        f"{start['first_step_s']:.3f} s; launcher wall "
        f"{static['wall_s']:.3f} s; on {card}")
    assert w["device"] == "cuda:0" and w["controller"], w
    assert diff <= spread, (w["losses"], inproc["losses"])
    for n in KERNELS:
        assert w["launches"][n] == cfg.n_layers * LAUNCH_STEPS, w["launches"]
    report["static"] = dict(
        device=w["device"], cuda_visible=w["cuda_visible"],
        losses=w["losses"], inproc_losses=inproc["losses"], max_diff=diff,
        spread=spread, bit_equal=bit_equal, launches=w["launches"],
        step_s=w["step_s"], step_times_s=w["step_times_s"],
        inproc_step_s=inproc["step_s"], wall_s=static["wall_s"], **start)
    log(f"[launch] (b) run(fn, np=1): {runs['spawn']}; run(fn, np=1, "
        f"hosts='localhost:1'): {runs['hosts']}; (a)'s step-0 loss "
        f"{w['losses'][0]}")
    for r in runs.values():
        assert r["device"] == "cuda", r
        assert abs(r["loss"] - w["losses"][0]) <= spread, (r, w["losses"])
        assert all(v == cfg.n_layers for v in r["launches"].values()), r
    report["run"] = runs
    ranks = cpu.get("ranks", [])
    log(f"[launch] (c) --worker-platform cpu -np 2: exit {cpu.get('rc')}, "
        f"{[(r['device'], r['backend'], r['sum'][0], r['gathered_rows'], r['broadcast']) for r in ranks]}, "
        f"{cpu.get('wall_s', 0):.1f} s")
    assert cpu.get("rc") == 0, cpu.get("text", "")[-4000:]
    assert "rank(s) [0, 1] pinned to the CPU" in cpu["text"], cpu["text"]
    for r in ranks:
        assert (r["device"], r["backend"], r["cuda_visible"]) == \
            ("cpu", "gloo", ""), r
        assert r["sum"] == [3.0] * 8 and r["gathered_rows"] == 3, r
        assert r["broadcast"] == [0.0] * 3, r
    assert len(ranks) == 2, ranks
    before = build_listing()
    rc, text, _, _ = launcher(["--check-build"])
    after = build_listing()
    lines = text.splitlines()
    log("[launch] (c) --check-build: " + "; ".join(
        ln.strip() for ln in lines if ln.strip().startswith("[")))
    assert rc == 0 and before == after, (before, after)
    assert any(ln.strip().startswith("[X] CUDA") for ln in lines), text
    assert any(ln.strip().startswith("[X] flash-attention kernels built")
               for ln in lines), text
    report["cpu_slots"] = dict(ranks=ranks, seconds=cpu["wall_s"])
    report["check_build"] = [ln.strip() for ln in lines
                             if ln.strip().startswith("[")]
    report["wall_s"] = time.perf_counter() - phase_t0
    log(f"[launch] (a)-(d) and --check-build took {report['wall_s']:.1f} s "
        f"after the in-process run")
    return report


# Phase 22 (a): the tuner under the flagship's step.  2 steps a window
# (the step's gradient allreduces each tick it once), 1 warm-up window,
# 6 scored; 20 steps, so the tuner freezes at step 14 and 6 steps run
# at the frozen config.
TUNE_STEPS = 30
TUNE_STEPS_PER_WINDOW = 2
TUNE_SAMPLES = 6
TUNE_WARMUP = 1
# (b): the fleet's two jobs (phase 17's worker), their priorities, the
# scheduler's cadence and the commit wait before a stop is forced (a
# step with its commit takes 1.4-1.8 s; a worker's start-up ~35 s is
# paid before its first commit, never inside the wait).
FLEET_A_STEPS, FLEET_B_STEPS = 12, 4
FLEET_SECRET = "chip-smoke-fleet"
FLEET_TICK_S = 0.25
FLEET_GRACE_S = 60.0
FLEET_DEADLINE_S = 240.0


def record_windows(torch, hvd, ctl):
    """Record the tuner's closed windows from outside the controller: a
    CUDA-event pair on the executor's stream around each response (a start
    before it, an end after its completion event) with the host clock of
    its enqueue, and at each close the responses completed since the last
    one and whether all of them had completed once the close's wait ended.
    A paused probe first shows the executor's stream.  Returns a function
    that gives, per closed window, its host seconds, the CUDA-event span
    of the responses enqueued after it opened (first start to last end),
    their count, and that completeness."""
    pm = ctl._autotune
    real_exec, real_note = ctl._device_exec_impl, ctl.note_done
    real_sync = pm._window_sync
    stream, cur, noted, closes = [], [None, None], [], []

    def execute(*args):
        start = None
        if stream:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream[0])
        cur[:] = [time.perf_counter(), start]
        return real_exec(*args)

    def note_done(done):
        real_note(done)
        if not stream:
            stream.append(torch.cuda.current_stream())
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        noted.append((cur[0], cur[1], end))

    def window_sync():
        closing = noted[:]
        del noted[:len(closing)]
        real_sync()
        closes.append((pm._window_start, closing,
                       all(e.query() for _, _, e in closing)))

    execute.validate = real_exec.validate
    ctl._device_exec_impl, ctl.note_done = execute, note_done
    pm._window_sync = window_sync
    with ctl.autotune_paused():
        hvd.allreduce(torch.zeros(1, device="cuda"), name="windows.probe")
    assert stream, "the probe ran no response on the card"
    del noted[:]

    def windows():
        ends = [c[0] for c in closes[1:]] + [pm._window_start]
        out = []
        for (opened, closing, complete), closed in zip(closes, ends):
            ev = [(s, e) for t, s, e in closing if t >= opened]
            span = ev[0][0].elapsed_time(ev[-1][1]) / 1e3 if ev else 0.0
            out.append((closed - opened, span, len(ev), complete))
        return out
    return windows


def tuned_run(torch, hvd, tfm, fa, cfg, par, tokens, labels, tune,
              tmp, tag, store=None, n_steps=TUNE_STEPS, pin=None):
    """``n_steps`` of the flagship's step under the native controller
    (``pin``: knobs to set, such as a fixed fusion threshold or cycle),
    the tuner on when ``tune``: losses, host seconds a step, launches,
    and (tuned) the tuner's applied configs by step, its closed windows
    (host seconds, CUDA-event span), /debug/autotune's body, the log's
    lines and the journal.  ``store`` is announced the model's memory."""
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.core.state import global_state
    from horovod_tpu_torch.debug import http as dh
    env = {"HVD_TPU_CONTROLLER_ADDR": f"127.0.0.1:{free_port()}",
           "HVD_TPU_COMPRESSION": "none", **(pin or {})}
    log_file = os.path.join(tmp, f"autotune_{tag}.csv")
    if tune:
        # Each step's gradient allreduces tick the tuner once each.
        n_params = len(list(tfm.Transformer(cfg, par, seed=0, device="cpu")
                            .parameters()))
        env.update({"HVD_TPU_AUTOTUNE": "1",
                    "HVD_TPU_AUTOTUNE_LOG": log_file,
                    "HVD_TPU_AUTOTUNE_WARMUP_SAMPLES": str(TUNE_WARMUP),
                    "HVD_TPU_AUTOTUNE_STEPS_PER_SAMPLE":
                        str(TUNE_STEPS_PER_WINDOW * n_params),
                    "HVD_TPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES":
                        str(TUNE_SAMPLES)})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        hvd.init(use_controller=True)
        ctl = global_state.controller
        pm = ctl._autotune
        assert (pm is not None) == tune, pm
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        step = tfm.make_train_step(cfg, par, model, opt)
        if tune:
            windows = record_windows(torch, hvd, ctl)
            if store is not None:
                from horovod_tpu_torch.fleet.tuning import LocalTuningStore
                out["key"] = autotune.announce_model(
                    {"params": model}, store=LocalTuningStore(store))
                out["warm_started"] = pm.loop_status()["warm_started"]
        fa.reset_launches()
        losses, times, configs = [], [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
            if tune:
                configs.append((pm.current[0], round(pm.current[1], 4),
                                pm.frozen))
        out.update(losses=losses, step_times_s=times,
                   launches=dict(fa.launches))
        if tune:
            srv = dh.DebugServer(host="127.0.0.1", port=0)
            srv.start()
            try:
                import urllib.request
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/debug/autotune",
                        timeout=10) as r:
                    out["debug_autotune"] = json.loads(r.read())
            finally:
                srv.stop()
            out["windows"] = windows()
            out.update(configs=configs, journal=pm.journal(),
                       status=autotune.loop_status(),
                       final=pm.config_dict())
    finally:
        hvd.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if tune:
        with open(log_file) as f:
            out["log"] = [ln.split(",") for ln in f.read().splitlines()]
        assert autotune.active_manager() is None
    return out


def phase_autotune(torch, hvd, tfm, fa, cfg, par, tokens, labels, card):
    """Phase 22 (a): the tuner on cuda:0; returns the report."""
    import tempfile
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "memory")
        plain = tuned_run(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                          False, tmp, "plain")
        tuned = tuned_run(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                          True, tmp, "tuned", store=store)
        warm = tuned_run(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                         True, tmp, "warm", store=store,
                         n_steps=TUNE_STEPS_PER_WINDOW * 3)
        # The untuned controller with one of the frozen numerics pinned:
        # which of them moves the step.
        final = tuned["final"]
        pinned = {name: tuned_run(torch, hvd, tfm, fa, cfg, par, tokens,
                                  labels, False, tmp, name, pin={knob: val})
                  for name, knob, val in (
                      ("fusion", "HVD_TPU_FUSION_THRESHOLD",
                       str(final["fusion_bytes"])),
                      ("cycle", "HVD_TPU_CYCLE_TIME",
                       str(final["cycle_ms"])))}
        # The untuned run again, last: the drift over the phase's runs.
        again = tuned_run(torch, hvd, tfm, fa, cfg, par, tokens, labels,
                          False, tmp, "again")
        from horovod_tpu_torch.fleet.tuning import LocalTuningStore
        stored = LocalTuningStore(store).get(tuned["key"])
    proposals = {(c[0], c[1]) for c in tuned["configs"]}
    frozen_at = next(i for i, c in enumerate(tuned["configs"]) if c[2])
    tags = [ln[0] for ln in tuned["log"]]
    # Every run's step time over the same steps: those after the freeze.
    after = tuned["step_times_s"][frozen_at + 1:]
    med = statistics.median
    tuned_step_s = med(after)
    plain_step_s = med(plain["step_times_s"][frozen_at + 1:])
    pinned_step_s = {name: med(r["step_times_s"][frozen_at + 1:])
                     for name, r in pinned.items()}
    again_step_s = med(again["step_times_s"][frozen_at + 1:])
    # A window counts the responses that completed before its tick; its
    # span runs from the first of them enqueued after it opened to its
    # last, and every one of them has completed when it closes.
    short = [w for w in tuned["windows"] if not (w[0] >= w[1] > 0 and w[3])]
    log(f"[autotune] (a) {len(proposals)} distinct (fusion, cycle) "
        f"proposals applied, frozen after step {frozen_at + 1} at "
        f"{tuned['final']}; log tags {tags}; losses bit-equal to the "
        f"untuned run {tuned['losses'] == plain['losses']}; windows (host "
        f"s, CUDA-event span s of the responses enqueued in the window, "
        f"those responses, all counted responses complete at the close): "
        + ", ".join(f"({a:.4f}, {b:.4f}, {n}, {d})"
                    for a, b, n, d in tuned["windows"])
        + f"; step {tuned_step_s * 1e3:.3f} ms at the frozen config "
        f"against {plain_step_s * 1e3:.3f} ms untuned, "
        + ", ".join(f"{v * 1e3:.3f} ms untuned with only the {k} pinned"
                    for k, v in pinned_step_s.items())
        + f", {again_step_s * 1e3:.3f} ms untuned again, run last"
        + f" (medians of steps {frozen_at + 2}-{TUNE_STEPS}, those after "
        f"the freeze, in each run); kernel launches {tuned['launches']}; "
        f"on {card}")
    assert len(proposals) >= 2, proposals
    assert tuned["status"]["frozen"] and frozen_at < TUNE_STEPS - 1
    assert tags.count("warmup") == TUNE_WARMUP, tags
    assert tags.count("sample") == TUNE_SAMPLES and tags[-1] == "final", tags
    assert tags.count("final") == 1, tags
    assert tuned["debug_autotune"]["frozen"] is True, tuned["debug_autotune"]
    assert tuned["debug_autotune"]["current"] == tuned["final"]
    assert tuned["losses"] == plain["losses"], (tuned["losses"],
                                                plain["losses"])
    assert len(tuned["windows"]) == TUNE_WARMUP + TUNE_SAMPLES, \
        tuned["windows"]
    assert not short, short
    for r in (plain, tuned, *pinned.values(), again):
        assert r["losses"] == plain["losses"], r["losses"]
        for n in KERNELS:
            assert r["launches"][n] == cfg.n_layers * TUNE_STEPS, r
    # The warm start: the stored config applied before any window, its
    # first windows scored on it (no bootstrap sweep).
    journal = warm["journal"]
    log(f"[autotune] (a) warm start from the LocalTuningStore record "
        f"{stored['config']} (score {stored['score']:.1f}): warm_started "
        f"{warm['warm_started']}, first windows "
        f"{[(e['tag'], e['reason'], e['config']) for e in journal[:2]]}")
    assert warm["warm_started"] and warm["key"] == tuned["key"]
    assert stored["config"] == tuned["final"], (stored, tuned["final"])
    assert [e["config"] for e in journal[:2]] == [stored["config"]] * 2, \
        journal
    assert [e["reason"] for e in journal[:2]] == ["warm_start"] * 2, journal
    assert warm["losses"] == plain["losses"][:len(warm["losses"])]
    report.update(
        proposals=sorted(proposals), frozen_after_step=frozen_at + 1,
        final=tuned["final"], log_tags=tags, losses=tuned["losses"],
        bit_equal=True, windows=tuned["windows"],
        debug_autotune=tuned["debug_autotune"],
        tuned_step_s=tuned_step_s, plain_step_s=plain_step_s,
        pinned_step_s=pinned_step_s, again_step_s=again_step_s,
        pinned_step_times_s={k: r["step_times_s"]
                             for k, r in pinned.items()},
        again_step_times_s=again["step_times_s"],
        plain_step_times_s=plain["step_times_s"],
        tuned_step_times_s=tuned["step_times_s"],
        launches=tuned["launches"], stored=stored,
        warm_start=dict(first_windows=journal[:2],
                        launches=warm["launches"]))
    return report


def fleet_phase(out, a_cmd, b_cmd, a_log_prefix):
    """Phase 22 (b), in a process of its own whose torch.cuda is never
    initialised: a FleetGateway over one local slot, job A through the
    signed client, job B through ``hvdrun-torch --submit`` once A logged
    2 steps to ``<a_log_prefix>.<slot>``; the gateway's records, flight
    events and A's observations to ``out``."""
    import glob
    import urllib.request
    sys.path.insert(0, ROOT)
    import torch
    from horovod_tpu_torch import fleet
    from horovod_tpu_torch.debug import flight
    from horovod_tpu_torch.runner.hosts import HostInfo
    t0 = time.time()
    state_dir = os.path.dirname(out)
    gw = fleet.FleetGateway(
        [HostInfo("localhost", 1)], port=0, host="127.0.0.1",
        fleet_dir=os.path.join(state_dir, "fleet_state"),
        secret=FLEET_SECRET, tick_s=FLEET_TICK_S,
        preempt_grace_s=FLEET_GRACE_S)
    gw.serve()
    addr = f"127.0.0.1:{gw.port}"
    rep = {"gateway_up_s": time.time() - t0}
    try:
        a_env = {"HVD_TPU_METRICS_TREE": "1",
                 "HVD_TPU_METRICS_SYNC_STEPS": "1",
                 "HVD_TPU_FLEET_ADDR": addr,
                 "HVD_TPU_FLEET_SECRET": FLEET_SECRET,
                 "HVD_TPU_FLEET_OBSERVE_PUSH_S": "1"}
        a = fleet.submit_job(fleet.JobSpec(
            command=a_cmd, min_np=1, max_np=1, priority=0, tenant="train",
            name="A", env=a_env), addr=addr, secret=FLEET_SECRET)
        deadline = time.time() + FLEET_DEADLINE_S

        def a_steps():
            n = 0
            for path in glob.glob(a_log_prefix + ".*"):
                with open(path) as f:
                    n += sum('"event": "step"' in ln for ln in f)
            return n

        while a_steps() < 2:
            assert time.time() < deadline, "job A never committed 2 steps"
            time.sleep(0.2)
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
             "--submit", "--gateway", addr, "--priority", "10",
             "--tenant", "serve", "-np", "1", *b_cmd],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, HVD_TPU_FLEET_SECRET=FLEET_SECRET))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        b_id = re.search(r"job (\w+): queued", proc.stdout).group(1)
        states = {}
        while True:
            recs = {r.id: r for r in fleet.list_jobs(
                addr=addr, secret=FLEET_SECRET)}
            for jid, r in recs.items():
                seen = states.setdefault(jid, [])
                if not seen or seen[-1][0] != r.state:
                    seen.append((r.state, time.time()))
            if all(r.state in fleet.TERMINAL_STATES
                   for r in recs.values()) and len(recs) == 2:
                break
            assert time.time() < deadline, states
            time.sleep(0.2)
        rep["records"] = {k: r.to_dict() for k, r in recs.items()}
        rep["a_id"], rep["b_id"] = a.id, b_id
        rep["states"] = states
        obs = fleet.get_observation(a.id, addr=addr, secret=FLEET_SECRET)
        rep["observation"] = obs
        with urllib.request.urlopen(f"http://{addr}/fleet/metrics",
                                    timeout=10) as r:
            rep["fleet_metrics"] = r.read().decode()
        rep["events"] = [e for e in flight.snapshot()
                         if str(e["kind"]).startswith("fleet.")]
    finally:
        gw.close(cancel_jobs=True)
    rep["cuda_initialized"] = torch.cuda.is_initialized()
    with open(out, "w") as f:
        json.dump(rep, f)


def phase_fleet(torch, hvd, tfm, fa, cfg, par, card):
    """Phase 22 (b): the fleet on one card; returns the report."""
    import glob
    import tempfile
    # The uninterrupted run of job A's steps, in this process.
    hvd.init()
    try:
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.ZeroShardedOptimizer(model, lambda ps: torch.optim.AdamW(
            ps, lr=3e-4, weight_decay=1e-4), stage=2)
        step = tfm.make_train_step(cfg, par, model, opt)
        clean = [step(*b).item()
                 for b in elastic_batches(tfm, cfg, 8, FLEET_A_STEPS)]
        del model, opt, step
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        def cmd(tag, steps, observe):
            return [sys.executable, os.path.abspath(__file__),
                    "--elastic-worker", json.dumps({
                        "log_prefix": os.path.join(tmp, f"log_{tag}"),
                        "ckpt_dir": os.path.join(tmp, f"ckpt_{tag}"),
                        "steps": steps, "observe": observe})]

        out = os.path.join(tmp, "fleet.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--fleet-phase",
             json.dumps({"out": out, "a_cmd": cmd("a", FLEET_A_STEPS, True),
                         "b_cmd": cmd("b", FLEET_B_STEPS, False),
                         "a_log_prefix": os.path.join(tmp, "log_a")})],
            cwd=ROOT, capture_output=True, text=True,
            timeout=FLEET_DEADLINE_S + 60)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log((proc.stdout + proc.stderr)[-8000:])
        assert proc.returncode == 0, proc.returncode
        with open(out) as f:
            rep = json.load(f)
        ev = {}
        for tag in ("a", "b"):
            ev[tag] = []
            for path in glob.glob(os.path.join(tmp, f"log_{tag}.*")):
                with open(path) as f:
                    ev[tag] += [json.loads(line) for line in f]
            ev[tag].sort(key=lambda e: e["t"])
        left = sorted(os.listdir(tmp))
    a, b = rep["records"][rep["a_id"]], rep["records"][rep["b_id"]]
    losses = elastic_losses(ev["a"], FLEET_A_STEPS)
    b_losses = elastic_losses(ev["b"], FLEET_B_STEPS)
    launches = {t: elastic_launches(ev[t]) for t in ("a", "b")}
    a_syncs = [e for e in ev["a"] if e["event"] == "sync"]
    a_pids = sorted({e["pid"] for e in a_syncs}, key=lambda p: [
        e["t"] for e in a_syncs if e["pid"] == p][0])
    fe = rep["events"]

    def first(kind, name, **kw):
        return next(e for e in fe if e["kind"] == kind and e["name"] == name
                    and all(e.get(k) == v for k, v in kw.items()))

    decision = first("fleet.preempt", rep["a_id"], phase="commit_wait")
    stopped = first("fleet.job_end", rep["a_id"], state="preempted")
    resumed = first("fleet.resume", rep["a_id"])
    a_after = [e for e in ev["a"] if e["event"] in ("step", "interrupt")
               and e["pid"] == a_pids[-1]]
    b_steps = [e for e in ev["b"] if e["event"] == "step"]
    timing = {
        "queue_wait_a_s": a["queue_wait_s"],
        "queue_wait_b_s": b["queue_wait_s"],
        "decision_to_victim_stopped_s": stopped["t_wall"]
        - decision["t_wall"],
        "victim_stopped_to_b_first_step_s": b_steps[0]["t"]
        - stopped["t_wall"],
        "resume_to_first_resumed_step_s": a_after[0]["t"]
        - resumed["t_wall"],
        "phase_wall_s": wall}
    series = (rep["observation"] or {}).get("series") or []
    a_states = [s for s, _ in rep["states"][rep["a_id"]]]
    log(f"[fleet] (b) gateway in a child process (CUDA initialised there "
        f"{rep['cuda_initialized']}); A states {a_states}, B states "
        f"{[s for s, _ in rep['states'][rep['b_id']]]}; A preemptions "
        f"{a['preemptions']} at commit generation "
        f"{a['preempt_generation']}, resumes {a['resumes']}, its processes "
        f"synced at steps {[(e['step'], e['path']) for e in a_syncs]}; A "
        f"losses {losses} against the uninterrupted {clean} (bit-equal "
        f"{losses == clean}); B losses {b_losses}; launches A "
        f"{launches['a']}, B {launches['b']}; /fleet/observe/A "
        f"{len(series)} samples (rounds "
        f"{[x['round'] for x in series]}); timing "
        + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
        + f"; on {card}")
    assert rep["cuda_initialized"] is False
    assert (a["state"], b["state"]) == ("done", "done"), (a, b)
    assert "preempted" in a_states, a_states
    assert a["preemptions"] == 1 and a["resumes"] == 1, a
    assert len(a_pids) == 2, a_syncs
    assert a_syncs[-1]["path"] == "disk" and \
        a_syncs[-1]["step"] >= a["preempt_generation"] >= 2, a_syncs
    assert all(e["device"] == "cuda:0" for e in a_syncs
               + [e for e in ev["b"] if e["event"] == "sync"])
    assert b_steps[0]["t"] > stopped["t_wall"] and \
        b_steps[-1]["t"] < a_after[0]["t"]
    assert losses == clean, (losses, clean)
    for n in KERNELS:
        assert launches["b"][n] == cfg.n_layers * FLEET_B_STEPS, launches
        assert launches["a"][n] >= cfg.n_layers * FLEET_A_STEPS, launches
    assert series and all(x["ranks"] == 1 for x in series), series
    assert f'hvd_fleet_job_ranks{{job="{rep["a_id"]}"}}' in \
        rep["fleet_metrics"]
    assert "fleet_state" in left
    return dict(records=rep["records"], states=rep["states"],
                losses=losses, clean_losses=clean, b_losses=b_losses,
                launches=launches, observe_samples=len(series),
                timing=timing, syncs=[(e["step"], e["path"])
                                      for e in a_syncs])


# Phase 23: the framework front ends.  The sparse gradient's sum order
# differs from the dense embedding backward's (coalesce against an
# index-add), so it is held within fp32 rounding of the largest row.
FRONTEND_STEPS = 10
TOL_SPARSE = dict(rtol=1e-6, atol=1e-6)
TOL_SBN = dict(rtol=1e-5, atol=1e-5)
FRONTEND_BENCH_ARGS = ("--num-iters", "3", "--num-batches-per-iter", "10",
                       "--batch-size", "64", "--image-size", "64")


def dtoh_copies(torch, step):
    """Device-to-host copies in one profiled call of ``step()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "DtoH" in e.name
               and e.device_type == torch.autograd.DeviceType.CUDA)


def frontend_run(torch, hvd, fe, tfm, fa, cfg, par, tokens, labels,
                 n_steps, through_frontend, op=None):
    """``n_steps`` flagship steps from seed 0 through the front end's
    DistributedOptimizer (after its two broadcasts; ``op`` its reduction,
    Average by default) or the port's: losses, host step, launches, the
    hooks' gradient allreduces and the NCCL ``all_reduce`` calls on card
    tensors in those steps, device-to-host copies of a profiled step
    after them."""
    import torch.distributed as dist
    from horovod_tpu_torch.ops import collective as C
    torch.cuda.synchronize()
    model = tfm.Transformer(cfg, par, seed=0)
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4)
    if through_frontend:
        fe.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = fe.DistributedOptimizer(
            adamw, named_parameters=model.named_parameters(),
            op=fe.Average if op is None else op)
        fe.broadcast_optimizer_state(opt, root_rank=0)
    else:
        hvd.broadcast_parameters(model.state_dict())
        opt = hvd.DistributedOptimizer(adamw)
    step = tfm.make_train_step(cfg, par, model, opt)
    fa.reset_launches()
    grad_calls, nccl_calls = [], []
    real_submit, real_all_reduce = C.allreduce_async, dist.all_reduce

    def submit(tensor, *a, name=None, **k):
        if name is not None and name.startswith("grad."):
            grad_calls.append(tensor.is_cuda)
        return real_submit(tensor, *a, name=name, **k)

    def all_reduce(tensor, *a, **k):
        nccl_calls.append(tensor.is_cuda)
        return real_all_reduce(tensor, *a, **k)

    C.allreduce_async, dist.all_reduce = submit, all_reduce
    losses, times = [], []
    try:
        for _ in range(n_steps):
            t0 = time.perf_counter()
            loss = step(tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
    finally:
        C.allreduce_async, dist.all_reduce = real_submit, real_all_reduce
    launches = dict(fa.launches)
    dtoh = dtoh_copies(torch, lambda: step(tokens, labels))
    n_grads = sum(1 for p in model.parameters() if p.requires_grad)
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_times_s": times,
            "step_s": statistics.median(times[1:]), "launches": launches,
            "dtoh_copies": dtoh, "grads": n_grads,
            "grad_allreduces": len(grad_calls),
            "grad_allreduces_on_card": sum(grad_calls),
            "nccl_all_reduces_on_card": sum(nccl_calls)}


def phase_frontends(torch, hvd, tfm, fa, cfg, par, tokens, labels, card):
    """Phase 23: the horovod.torch API of the port on the card; returns
    the report."""
    import horovod_tpu_torch.torch as fe
    from horovod_tpu_torch.torch.sync_batch_norm import _SyncBatchNormFn
    t_phase = time.perf_counter()
    report = {}
    # (a) the flagship through the front end, without and with the
    # native controller, beside the port's optimizer in the same world.
    for label, controller in (("flat", False), ("controller", True)):
        if controller:
            os.environ["HVD_TPU_CONTROLLER_ADDR"] = \
                f"127.0.0.1:{free_port()}"
        try:
            fe.init(use_controller=controller)
            # In turns (port, front end, front end, port): the host's
            # noise moves a run by tens of percent from one to the next.
            port, front, front2, port2 = (
                frontend_run(torch, hvd, fe, tfm, fa, cfg, par, tokens,
                             labels, FRONTEND_STEPS, through)
                for through in (False, True, True, False))
            # Without a controller a world-1 average is the identity and
            # the hooks skip it, as the reference's do; a sum is not
            # skipped, so this run takes every hook's NCCL allreduce.
            summed = None if controller else frontend_run(
                torch, hvd, fe, tfm, fa, cfg, par, tokens, labels,
                FRONTEND_STEPS, True, op=fe.Sum)
        finally:
            fe.shutdown()
            os.environ.pop("HVD_TPU_CONTROLLER_ADDR", None)
        # World 1: the sums over one rank are identities, so the hooks'
        # allreduces (or, without a controller, their skip) change no bit.
        runs = [r for r in (front, front2, summed) if r is not None]
        for run in runs + [port2]:
            assert run["losses"] == port["losses"], (run["losses"],
                                                     port["losses"])
        assert all(math.isfinite(x) for x in front["losses"])
        assert front["losses"][-1] < front["losses"][0]
        for run in runs + [port, port2]:
            assert run["dtoh_copies"] == 0, run
        for run in runs:
            for n in KERNELS:
                assert run["launches"][n] == cfg.n_layers * FRONTEND_STEPS, \
                    run["launches"]
        fired = [r for r in runs if controller or r is summed]
        for run in fired:
            assert run["grad_allreduces"] == run["grad_allreduces_on_card"] \
                == run["grads"] * FRONTEND_STEPS, run
        if summed is not None:
            assert summed["nccl_all_reduces_on_card"] >= \
                summed["grad_allreduces"], summed
            assert front["grad_allreduces"] == 0, front
        report[label] = {"frontend": front, "port": port,
                         "frontend_again": front2, "port_again": port2}
        if summed is not None:
            report[label]["frontend_sum"] = summed
        log(f"[frontends] (a) {label}: losses bit-equal to the port's "
            f"optimizer ({front['losses'][0]:.6f} -> "
            f"{front['losses'][-1]:.6f}); launches {front['launches']}; "
            f"device-to-host copies in a profiled step "
            f"{front['dtoh_copies']} (port {port['dtoh_copies']}); host "
            f"step, in turns, port {port['step_s'] * 1e3:.3f} / front end "
            f"{front['step_s'] * 1e3:.3f} / front end "
            f"{front2['step_s'] * 1e3:.3f} / port "
            f"{port2['step_s'] * 1e3:.3f} ms (medians of steps "
            f"1-{FRONTEND_STEPS - 1}); gradient allreduces from the hooks "
            f"{[r['grad_allreduces'] for r in runs]} (of "
            f"{front['grads']} gradients x {FRONTEND_STEPS} steps), NCCL "
            f"all_reduce calls on card tensors "
            f"{[r['nccl_all_reduces_on_card'] for r in runs]}"
            + (f"; op=Sum run host step {summed['step_s'] * 1e3:.3f} ms"
               if summed else "") + f"; on {card}")

    # (b) the card-side pieces at world 1 on NCCL.
    fe.init()
    try:
        dev = fe.device()
        gen = torch.Generator(device="cpu").manual_seed(23)
        emb = torch.nn.Embedding(cfg.vocab_size, cfg.d_model,
                                 sparse=True).to(dev)
        idx = torch.randint(0, cfg.vocab_size, (8, 512),
                            generator=gen).to(dev)
        (emb(idx).float() ** 2).sum().backward()
        sparse = emb.weight.grad
        assert sparse.is_sparse and sparse.device == dev
        got = fe.sparse_allreduce(sparse, name="emb.sparse").to_dense()
        want = fe.allreduce(sparse.to_dense(), name="emb.dense")
        assert got.device == dev
        torch.testing.assert_close(got, want, **TOL_SPARSE)
        sparse_err = (got - want).abs().max().item()
        # ... and through the optimizer, sparse against sparse_as_dense.
        params = []
        for dense in (False, True):
            e = torch.nn.Embedding(cfg.vocab_size, cfg.d_model,
                                   sparse=True).to(dev)
            with torch.no_grad():
                e.weight.copy_(emb.weight)
            opt = fe.DistributedOptimizer(
                torch.optim.SGD(e.parameters(), lr=0.1),
                named_parameters=e.named_parameters(),
                sparse_as_dense=dense)
            (e(idx).float() ** 2).sum().backward()
            opt.step()
            params.append(e.weight.detach())
        torch.testing.assert_close(params[0], params[1], **TOL_SPARSE)
        report["sparse"] = {"rows": int(sparse.coalesce().indices()
                                        .shape[1]),
                            "max_abs_err": sparse_err}

        x = torch.randn(8, 64, 32, 32, generator=gen).to(dev)
        ct = torch.randn(8, 64, 32, 32, generator=gen).to(dev)
        outs = {}
        for name, make in (("bn", torch.nn.BatchNorm2d),
                           ("sync", fe.SyncBatchNorm)):
            torch.manual_seed(5)
            bn = make(64).to(dev)
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.uniform_(-0.5, 0.5)
            xi = x.clone().requires_grad_()
            y = bn(xi)
            (y * ct).sum().backward()
            outs[name] = (y.detach(), xi.grad, bn.weight.grad,
                          bn.bias.grad, bn.running_mean.clone(),
                          bn.running_var.clone())
        for a, b in zip(outs["sync"], outs["bn"]):
            assert torch.equal(a, b)
        # The cross-rank function itself (fp64 statistics through NCCL).
        bn = torch.nn.BatchNorm2d(64).to(dev)
        xi = x.clone().requires_grad_()
        w = torch.ones(64, device=dev, requires_grad=True)
        b = torch.zeros(64, device=dev, requires_grad=True)
        y = _SyncBatchNormFn.apply(xi, w, b, bn.running_mean.clone(),
                                   bn.running_var.clone(), bn.eps, 0.1,
                                   True, "syncbn.card")
        (y * ct).sum().backward()
        ref_x = x.clone().requires_grad_()
        ref = torch.nn.functional.batch_norm(
            ref_x, None, None, torch.ones(64, device=dev, requires_grad=True),
            torch.zeros(64, device=dev), training=True, eps=bn.eps)
        (ref * ct).sum().backward()
        torch.testing.assert_close(y, ref, **TOL_SBN)
        torch.testing.assert_close(xi.grad, ref_x.grad, **TOL_SBN)
        report["sync_batch_norm"] = {
            "module_bit_equal": True,
            "fn_out_max_abs_err": (y - ref).abs().max().item(),
            "fn_grad_max_abs_err": (xi.grad - ref_x.grad).abs().max()
            .item()}

        trips = {}
        for wire, dtype in (("fp16", torch.float16),
                            ("bf16", torch.bfloat16)):
            torch.manual_seed(7)
            lin = torch.nn.Linear(512, 512).to(dev)
            opt = fe.DistributedOptimizer(
                torch.optim.SGD(lin.parameters(), lr=0.1),
                named_parameters=lin.named_parameters(),
                compression=getattr(fe.Compression, wire))
            (lin(torch.randn(64, 512, generator=gen).to(dev)) ** 2) \
                .sum().backward()
            local = [p.grad.clone() for p in lin.parameters()]
            opt.synchronize()
            for p, g in zip(lin.parameters(), local):
                assert p.grad.device == dev and \
                    p.grad.dtype == torch.float32
                assert torch.equal(p.grad, g.to(dtype).float()), wire
            trips[wire] = "bit-equal"
            with opt.skip_synchronize():
                opt.step()
        report["compression"] = trips
    finally:
        fe.shutdown()
    log(f"[frontends] (b) sparse_allreduce of a {cfg.vocab_size} x "
        f"{cfg.d_model} embedding gradient ({report['sparse']['rows']} "
        f"rows) against the dense allreduce: max |diff| "
        f"{report['sparse']['max_abs_err']:.3g}; SyncBatchNorm = "
        f"BatchNorm2d bit for bit, its cross-rank function within "
        f"{report['sync_batch_norm']['fn_out_max_abs_err']:.3g} (out) / "
        f"{report['sync_batch_norm']['fn_grad_max_abs_err']:.3g} (grad); "
        f"fp16/bf16 round trips {trips}")

    # (c) a launched example on the card.
    torch.cuda.empty_cache()
    rc, out, wall, _ = launcher(
        ["-np", "1", sys.executable,
         os.path.join("examples", "torch_port",
                      "pytorch_synthetic_benchmark.py"),
         *FRONTEND_BENCH_ARGS])
    assert rc == 0, out[-3000:]
    m = re.search(r"img/sec per worker: ([0-9.]+) on (\S+)", out)
    assert m and m.group(2) == "cuda:0", out[-2000:]
    report["launched"] = {"img_per_s": float(m.group(1)), "wall_s": wall}
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[frontends] (c) hvdrun-torch -np 1 "
        f"examples/torch_port/pytorch_synthetic_benchmark.py "
        f"{' '.join(FRONTEND_BENCH_ARGS)}: {float(m.group(1)):.1f} img/sec "
        f"on {m.group(2)} ({wall:.1f} s of launch); phase 23 "
        f"{report['phase_s']:.1f} s; on {card}")
    return report


# Phase 24: the estimator's flagship fit (steps at batch 8, one
# validation batch) and the Ray actor's steps.
ESTIMATOR_STEPS, ESTIMATOR_BATCH, RAY_STEPS = 10, 8, 3


def fake_ray():
    """The fake ``ray`` the port's Ray tests use
    (tests/torch_port/_torch_port_fake_ray.py), whose actors run in this
    process; an actor that asked for ``num_gpus`` gets the card as Ray
    gives it one, through ``CUDA_VISIBLE_DEVICES`` (here the card is
    already this process's).  Returns (modules, record)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_torch_port_fake_ray",
        os.path.join(ROOT, "tests", "torch_port", "_torch_port_fake_ray.py"))
    helper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helper)
    record = {}
    return helper.fake_ray_modules(record), record


def ray_actor_steps(cfg, n_steps):
    """A RayExecutor actor's function: the flagship's steps on the device
    ``init()`` gives the actor, through the port's optimizer."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.basics import device_index
    from horovod_tpu_torch.models import transformer as tfm
    hvd.init()
    try:
        par = tfm.ParallelConfig()
        model = tfm.Transformer(cfg, par, seed=0)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        step = tfm.make_train_step(cfg, par, model, opt)
        tokens, labels = tfm.synthetic_batch(cfg, ESTIMATOR_BATCH, seed=1)
        losses = [step(tokens, labels).item() for _ in range(n_steps)]
        return {"device": str(hvd.device()),
                "device_index": device_index(hvd.local_rank()),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "partition": os.environ.get("HVD_TPU_DEVICE_PARTITION"),
                "world": [os.environ.get("MASTER_ADDR"),
                          os.environ.get("MASTER_PORT")],
                "losses": losses}
    finally:
        hvd.shutdown()


def phase_integrations(torch, tfm, fa, cfg, par, card):
    """Phase 24: the estimators and the Ray executor on the card; returns
    the report."""
    import importlib.util
    import io
    import tempfile
    import numpy as np
    import horovod_tpu_torch.spark as spark
    from horovod_tpu_torch.core import basics
    # The fit reads in this process: choose arrow's pool before pyarrow
    # loads, as the estimator's workers do, so the feed prefetches.
    spark.store.prefer_system_arrow_pool()
    import pandas as pd
    import pyarrow
    t_phase = time.perf_counter()
    report = {"form": f"pandas {pd.__version__} DataFrame through a "
              f"LocalStore (pyarrow {pyarrow.__version__})"}
    log(f"[integrations] form: {report['form']}")

    class LM(torch.nn.Module):
        """The flagship as an estimator's model: float token columns in,
        fp32 logits out."""

        def __init__(self, seed):
            super().__init__()
            self.lm = tfm.Transformer(cfg, par, seed=seed, device="cpu")

        def forward(self, x):
            return tfm.serial_forward_logits(cfg, self.lm, x.long())

    calls = []

    def lm_loss(logits, y):
        """Next-token cross entropy; each call's loss and host time."""
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.long().reshape(-1))
        calls.append((time.perf_counter(), loss.item()))
        return loss

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=1e-4)

    # (a) the flagship through TorchEstimator on cuda:0, its rows phase
    # 4's 8 sequences over and over (a loss that falls within 10 steps).
    n_train = ESTIMATOR_STEPS * ESTIMATOR_BATCH
    tokens, labels = tfm.synthetic_batch(cfg, ESTIMATOR_BATCH, seed=1,
                                         device="cpu")
    df = pd.DataFrame({
        "tokens": [tokens[i % ESTIMATOR_BATCH].float().tolist()
                   for i in range(n_train + ESTIMATOR_BATCH)],
        "next": [labels[i % ESTIMATOR_BATCH].float().tolist()
                 for i in range(n_train + ESTIMATOR_BATCH)]})
    with tempfile.TemporaryDirectory(prefix="hvd_estimator_") as root:
        store = spark.LocalStore(root)
        model = LM(seed=0)
        est = spark.TorchEstimator(
            model=model, optimizer=adamw, loss=lm_loss, epochs=1,
            batch_size=ESTIMATOR_BATCH,
            validation=ESTIMATOR_BATCH / (n_train + ESTIMATOR_BATCH),
            store=store, feature_cols=["tokens"], label_cols=["next"],
            verbose=0)
        fa.reset_launches()
        t0 = time.perf_counter()
        try:
            fitted = est.fit(df)
            fit_s = time.perf_counter() - t0
            launches = dict(fa.launches)
            dev = basics.device()
        finally:
            basics.shutdown()
        assert dev == torch.device("cuda", 0), dev
        assert all(p.device == dev for p in model.parameters())
        losses = [loss for _, loss in calls[:-1]]
        assert len(losses) == ESTIMATOR_STEPS, len(calls)
        assert all(math.isfinite(x) for x in losses), losses
        assert losses[-1] < losses[0], losses
        val_loss = fitted.validation_loss
        assert math.isfinite(val_loss) and val_loss == calls[-1][1]
        for n in KERNELS:
            want = cfg.n_layers * (ESTIMATOR_STEPS
                                   + (n == "flash_fwd"))
            assert launches[n] == want, launches
        step_times = [b[0] - a[0] for a, b in zip(calls[:-2], calls[1:-1])]
        state = torch.load(io.BytesIO(store.load_checkpoint(est.run_id)),
                           weights_only=True)
        fresh = LM(seed=1)
        fresh.load_state_dict(state)
        for (name, got), want in zip(fresh.state_dict().items(),
                                     model.state_dict().values()):
            assert torch.equal(got, want.cpu()), name
    step_s = statistics.median(step_times)
    report["estimator_fit"] = {
        "losses": losses, "validation_loss": val_loss,
        "launches": launches, "fit_s": fit_s, "step_times_s": step_times,
        "step_s": step_s, "rows": len(df)}
    log(f"[integrations] (a) TorchEstimator fit of the flagship on {dev}: "
        f"{ESTIMATOR_STEPS} steps at batch {ESTIMATOR_BATCH}, losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}, validation loss "
        f"{val_loss:.6f}; launches {launches} ({cfg.n_layers} a step of "
        f"each, and {cfg.n_layers} forwards for the validation); host "
        f"step {step_s * 1e3:.3f} ms (median of steps 2-{ESTIMATOR_STEPS},"
        f" the loss read each step); fit {fit_s:.2f} s with the store's "
        f"Parquet; checkpoint reloaded bit for bit; on {card}")

    # (b) the example's Linear(4, 1), card against CPU.
    spec = importlib.util.spec_from_file_location(
        "spark_estimator_example",
        os.path.join(ROOT, "examples", "torch_port", "spark_estimator.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    frame = example.synthetic_frame(512)
    fits = {}
    with tempfile.TemporaryDirectory(prefix="hvd_example_") as root:
        for device in (None, "cpu"):
            est = example.estimator(
                spark.LocalStore(os.path.join(root, str(device))),
                device=device)
            est.verbose = 0
            try:
                fitted = est.fit(frame)
            finally:
                basics.shutdown()
            fits[device] = (
                {k: v.detach().cpu() for k, v in
                 fitted.model.state_dict().items()},
                fitted.transform(frame)["label__output"].values,
                next(fitted.model.parameters()).device)
    assert fits[None][2].type == "cuda" and fits["cpu"][2].type == "cpu"
    w_err = max((fits[None][0][k] - fits["cpu"][0][k]).abs().max().item()
                for k in fits["cpu"][0])
    out_err = float(np.abs(fits[None][1] - fits["cpu"][1]).max())
    assert w_err <= 1e-5 and out_err <= 1e-5, (w_err, out_err)
    report["example_linear"] = {"weight_max_abs_err": w_err,
                                "transform_max_abs_err": out_err}
    log(f"[integrations] (b) examples/torch_port/spark_estimator.py's "
        f"Linear(4, 1) on the card against the CPU: weights within "
        f"{w_err:.3g}, transform within {out_err:.3g}")

    # (c) RayExecutor with use_gpu over the in-process fake ray.
    modules, record = fake_ray()
    saved_env, saved_mods = dict(os.environ), {
        k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        from horovod_tpu_torch.ray import RayExecutor
        ex = RayExecutor(num_workers=1, use_gpu=True,
                         controller_port=free_port())
        ex.start()
        fa.reset_launches()
        (actor,) = ex.run(ray_actor_steps, args=(cfg, RAY_STEPS))
        ray_launches = dict(fa.launches)
        ex.shutdown()
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        for k, m in saved_mods.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m
    assert record["pg"].bundles == [{"CPU": 1.0, "GPU": 1.0}], record
    assert record["actor_opts"][0]["num_gpus"] == 1.0, record
    assert (actor["device"], actor["device_index"], actor["visible"],
            actor["partition"]) == ("cuda:0", 0, "0", "0/1"), actor
    assert actor["world"][0] == "127.0.0.1" and actor["world"][1], actor
    assert all(math.isfinite(x) for x in actor["losses"])
    assert actor["losses"][-1] < actor["losses"][0], actor["losses"]
    for n in KERNELS:
        assert ray_launches[n] == cfg.n_layers * RAY_STEPS, ray_launches
    report["ray_actor"] = dict(actor, launches=ray_launches)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[integrations] (c) RayExecutor(num_workers=1, use_gpu=True) over "
        f"a fake ray: the actor on {actor['device']} "
        f"(CUDA_VISIBLE_DEVICES={actor['visible']}, partition "
        f"{actor['partition']}), {RAY_STEPS} flagship steps, losses "
        f"{actor['losses'][0]:.6f} -> {actor['losses'][-1]:.6f}, launches "
        f"{ray_launches}; phase 24 {report['phase_s']:.1f} s; on {card}")
    return report


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
    # Nothing the phases write may land in the checkout's root.
    in_root = set(os.listdir(ROOT))
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
    # 17. elastic training: a worker killed and respawned from the disk,
    # and a reset in place restored from its own replica
    report["elastic"] = phase_elastic(torch, hvd, tfm, fa, cfg, par, card)
    # 18. the debug plane: the endpoint fetched during training, the merge
    # of the flight dump and the native timeline, the input drift drill
    report["debug"] = phase_debug(torch, hvd, tfm, fa, cfg, par, tokens,
                                  labels, card)
    # 19. the fleet-level observer: the tree sync on the card, verdict
    # parity with the flat sync, the /observe routes
    report["observe"] = phase_observe(torch, hvd, tfm, fa, cfg, par, tokens,
                                      labels, card)
    # 20. disaggregated prefill/decode: the bundle codec, migration on
    # the fp32 wire, send/receive through the recovery mailbox
    report["disagg"] = phase_disagg(torch, hvd, tfm, fa, cfg, par, model,
                                    card)
    # 21. the launcher: a static launch of the flagship, run(fn), CPU
    # slots, --check-build, and phase 17 (a) through the CLI
    report["launch"] = phase_launch(torch, hvd, tfm, fa, cfg, par,
                                    report["elastic"], card)
    # 22. the tuner under the flagship's step, and the fleet on one card
    report["autotune"] = phase_autotune(torch, hvd, tfm, fa, cfg, par,
                                        tokens, labels, card)
    report["fleet"] = phase_fleet(torch, hvd, tfm, fa, cfg, par, card)
    # 23. the framework front ends: the flagship through the horovod.torch
    # API without and with the controller, its card-side pieces, a
    # launched example
    report["frontends"] = phase_frontends(torch, hvd, tfm, fa, cfg, par,
                                          tokens, labels, card)
    # 24. the cluster integrations: the flagship through TorchEstimator,
    # the example's estimator card against CPU, a Ray actor's steps
    report["integrations"] = phase_integrations(torch, tfm, fa, cfg, par,
                                                card)

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
        by_path["elastic"] = report["elastic"]["kill"]["launches"][name]
        by_path["elastic_reset"] = \
            report["elastic"]["reset"]["launches"][name]
        by_path["debug"] = report["debug"]["endpoint"]["launches"][name]
        by_path["observe"] = report["observe"]["tree"]["launches"][name]
        by_path["launched"] = report["launch"]["static"]["launches"][name]
        by_path["launched_elastic_cli"] = \
            report["launch"]["elastic_cli"]["launches"][name]
        by_path["autotune"] = report["autotune"]["launches"][name]
        by_path.update({f"fleet_job_{t}": n[name] for t, n in
                        report["fleet"]["launches"].items()})
        by_path["frontend_torch"] = \
            report["frontends"]["flat"]["frontend"]["launches"][name]
        by_path["frontend_torch_controller"] = \
            report["frontends"]["controller"]["frontend"]["launches"][name]
        by_path["frontend_torch_sum"] = \
            report["frontends"]["flat"]["frontend_sum"]["launches"][name]
        by_path["estimator_fit"] = \
            report["integrations"]["estimator_fit"]["launches"][name]
        by_path["ray_actor"] = \
            report["integrations"]["ray_actor"]["launches"][name]
        # The serving prefills are forwards: no backward kernel runs there.
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
    left = set(os.listdir(ROOT)) - in_root - {"chiprun_out", "__pycache__"}
    assert not left, f"left in the checkout's root: {sorted(left)}"
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
    if sys.argv[1:2] == ["--elastic-worker"]:
        sys.exit(elastic_worker(**json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--launched-worker"]:
        sys.exit(launched_worker(**json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--fleet-phase"]:
        sys.exit(fleet_phase(**json.loads(sys.argv[2])))
    sys.exit(main())
