#!/usr/bin/env python3
"""Drive the port's serving, training and measurement paths on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device and build — the card's name and power limit, the torch/CUDA
   versions, and an ``nvcc`` build of every ``src/repro_torch/csrc/*.cu``,
   with ``-Xptxas -v``'s registers, spills and shared memory for each
   kernel of ``flash_attention.cu``, ``prefill_attention.cu``,
   ``blocked_matmul.cu``, ``decode_attention.cu``, ``ssd_scan.cu`` and
   ``ssd_scan_bwd.cu``;
2. each CUDA kernel against its plain PyTorch version on the card, in
   bfloat16 and float32.  Serving kernels at the serving path's shapes
   (yi-6b: 8 slots, 32/4 heads, head dim 128, 2048 cache slots, 256-token
   chunks), at G = 1 (olmo-1b: 16/16 heads) and at the smoke head dim,
   with ragged lengths, tails off the tile, cache holes and rows that
   write nothing; decode also at lengths around its 64-key tile, at G = 16
   and with two calls in a row bit-identical.  The training attention
   kernel, forward and backward (against ``torch.autograd.grad`` through
   the plain version), at the olmo-1b training shape (4, 16, 2048, 128), a
   yi-6b GQA shape, the sliding / chunked / bidirectional masks with
   ``q_offset > 0`` and ``Sq != Sk``, the smoke head dim and a length off
   the tile; and in bfloat16 at MLA's head dims (q/k 192, v 128: phase
   6c's shape, 4 x 128 heads x 2048, and a ragged one), float32 refused
   there; and bidirectional at head dim 64 with Sq != Sk, seamless-m4t's
   cross-attention against 1024 frames at its decode (8, 16, 1, 1024),
   prefill-chunk (8, 16, 256, 1024) and training (4, 16, 2048, 1024)
   shapes, its encoder (4, 16, 1024, 1024) and a ragged Sq 37 x Sk 1000;
   phase 6f's gemma3-27b shapes in bfloat16 (2 x 32/16 heads x 2048, head
   dim 128: sliding window 1024, and causal) and phase 6e's repro-100m
   shape in float32 (16 x 12/4 heads x 256, head dim 64);
3. smoke parity on the card and on the CPU from the same weights:
   yi-6b-smoke, granite-8b-smoke, llama4-maverick-smoke (GShard MoE) and
   deepseek-v2-smoke (MLA + MoE) in float32 through ``Server`` (the
   card's through its CUDA graphs; greedy tokens identical per request),
   then olmo-1b-smoke, yi-6b-smoke, llama4-maverick-smoke,
   deepseek-v2-smoke and gemma3-27b-smoke in float32 for 3 AdamW steps of
   the same batches (losses, grad norms and the MoE aux loss within
   tolerance; the MoE models' card steps each start from the CPU's state,
   since routing is not continuous in the weights; deepseek-v2-smoke's
   attention runs the kernels at (24, 16) padded to (32, 32); gemma3's
   7 ``L`` layers launch the sliding mask and its ``G`` layer the causal
   one, counted by shape); (3c) the same for mamba2-smoke
   and zamba2-smoke (the SSD scan's forward and backward kernels,
   launches counted); (3d) seamless-m4t-smoke (encoder-decoder; its
   attention projections at 1/sqrt(fan-in), see ``scale_attention``) and
   internvl2-smoke (patch embeddings) the same way: ``Server`` tokens
   (per replay one cross-attention ``flash_attention`` a decoder layer),
   ``bundle.prefill`` over nonzero frame / patch embeddings then 6 decode
   steps, 3 AdamW steps, and seamless-smoke admitted by decode-step replay
   on the card (no prefill graph; ``decode_replay_prefills`` counted;
   tokens those of chunked admission);
4. serving: full-width, full-depth yi-6b in bfloat16, weights drawn on the
   card from a seeded generator: 16 requests (prompts of 128-1536 tokens,
   64 new tokens each) through 8 slots, the server's decode step and
   prefill dispatch captured as CUDA graphs and replayed, each kernel's
   launches (launches per replay, counted at capture, x replays) checked
   against 32 x the decode steps or prefill dispatches; then the same
   requests through an eager server on the same weights, greedy tokens
   identical for every request, both runs' tok/s printed;
   (4h, right after phase 4) the same yi-6b serving the same requests
   through the graphs on a one-rank NCCL (data, model) = (1, 1) mesh with ``one_rank=True``: every
   serving collective (each layer's attention and MLP all-reduce, the
   embedding's, the logits' gather over ``model``, the packed result's
   gather over ``data``) runs over a one-rank group inside the graphs;
   greedy tokens identical to phase 4's (or the phase fails), the
   collectives a replay against 2 a layer + 3 (decode) and + 2 (prefill),
   the NCCL kernels in a decode replay's trace, the decode EWMA beside
   phase 4's, peak memory, whether the decode ran as a graph (several
   cards' ranks are held to the reference on the CPU through gloo);
   (4b) granite-8b at full width and depth (36 layers, 8.05 B params) the
   same way, its first 4 requests also through an eager server;
   (4c) the ring-cache layers: a C layer's decode through the prefill
   kernel with one query at llama4's widths (40/8 heads, D 128, chunk
   8192, ring 16384) against its plain version, and the two serving
   kernels over gemma3-27b's wrapped L ring (1024 slots, sliding window
   1024) against theirs and timed beside SDPA and their bounds; then
   gemma3-27b at full width and depth (62 layers: 52 L, 10 G; 27.01 B
   params) in bfloat16, 8 slots x 2048: (a) phase 4's 16 requests through
   the graphs (62 launches a replay of each serving kernel, finite
   logits), (b) the first 4 eagerly, (c) 8 under ``kv_host`` (the bytes a
   decode replay copies against the cache windows', 62 write-backs a
   replay), (d) the 16 arriving one every 2 ticks with preemption, ring
   slots spilled and promoted; greedy tokens identical across (a)-(d);
   (4d) llama4-maverick at full width and depth 4 (one ``CCCG`` period,
   MoE on layers 1 and 3: 128 experts top-1 + 1 shared; 34.25 B params,
   68.5 GB in bf16 — the full 48 layers, 399.7 B params, fit no card)
   in bfloat16, 8 slots x 2048: (a) phase 4's 16 requests through the
   graphs (per replay 1 decode_attention for the ``G`` layer and 3
   prefill_attention for the ``C`` layers' decode, 4 prefill_attention a
   prefill dispatch; finite logits; a slot's bytes; the peak memory and
   the decode EWMA beside the planner's price), (d) profiler windows over
   decode steps and a prefill dispatch, the MoE FFN and its expert
   products timed alone against the bytes they read, (e) the two serving
   kernels at its decode shapes against their plain versions and timed,
   (b) the first 4 requests eagerly, (c) two requests past the ``C``
   chunk of 8192 positions through the graphs and eagerly; greedy tokens
   identical graphs / eager;
   (4e) deepseek-v2 at full width and depth 8 (layer 0 dense, 1-7 MoE:
   160 experts top-6 + 2 shared; MLA with a 512-wide latent; 28.67 B
   params, 53.4 GiB) in bfloat16, 8 slots x 2048: (a) phase 4's 16
   requests through the graphs (no hand-written kernel: MLA's absorbed
   products are cuBLAS's; a slot's 18,874,368 bytes; finite logits; the
   decode EWMA beside the planner's price), (d) no copy of a full-size
   MLA weight in an eager decode step, profiler windows over decode
   steps and a prefill dispatch, MLA's attention and the MoE FFN timed
   alone, (b) the first 4 requests eagerly and (c) under ``kv_host``,
   tokens those of a graph run of the same 4;
   (4f) seamless-m4t-medium at full width and depth (12 encoder + 12
   decoder layers, 1024 frames, 0.715 B params) in bfloat16, 8 slots x
   2048: (a) phase 4's 16 requests through the graphs (per decode replay
   12 decode_attention and 12 flash_attention, the cross-attention with
   one query; per prefill dispatch 12 prefill_attention and 12
   flash_attention; a slot's 150,994,944 bytes; finite logits; the decode
   EWMA beside the planner's price), (d) profiler windows over decode
   steps and a prefill dispatch, (c) ``bundle.prefill`` of 8 rows of 1024
   frame embeddings and 256 tokens into the graphed server's caches (12
   encoder, 12 self and 12 cross flash_attention launches), 32 decode
   replays, and again with a preemption round trip of a slot whose cross
   KV is nonzero: tokens unchanged; (b) the 16 requests eagerly, tokens
   identical; (4g) internvl2-1b at full width and depth (24 layers, 14/2
   heads, 0.494 B) the same way, graphs and eager, then ``bundle.prefill``
   over 256 patch embeddings and 8 decode steps;
5. times at the phase 4 shapes: each kernel, its plain version, the
   PyTorch library call for the same function (a yardstick the port never
   calls), and the least time the card could take, with the prefill
   kernel's TFLOP/s, its fraction of the operation bound and its ratio to
   SDPA; then ``torch.profiler`` windows over a few full-batch decode
   steps and one prefill dispatch, graph replays and then eager (wall
   time, device-busy share, the kernels that take the device time; a
   replay's kernel launches confirmed from the trace);
6. training: full-width, full-depth olmo-1b in bfloat16 through
   ``repro_torch.launch.train`` (weights from a seeded generator on the
   card, ``remat="full"``, batch 4 x 2048 tokens of ``SyntheticLM`` seed
   0, AdamW steps under ``Supervisor.run``): finite losses and grad norms,
   no restart, and 2 x 16 forward and 16 backward attention launches per
   step; step time, training tokens/s, peak memory, and a
   ``torch.profiler`` window over one more step; (6b) the same for
   full-depth mamba2-780m (4 steps) and zamba2-1.2b (2 steps), 4 x 2048
   tokens each: 2 forward and 1 backward scan launches per ``M`` layer
   per step (and zamba2's shared block through the attention kernels),
   and the scan backward's share of the profiled step's device time;
   (6c) deepseek-v2's dense lead layer at full width (depth 1, 0.862 B
   params), 4 AdamW steps of 4 x 2048 tokens through ``make_train_step``:
   2 forward and 1 backward attention launches a step at (192, 128);
   (6d) seamless-m4t-medium (over 1024 frame embeddings a row; no remat,
   as the reference's encoder-decoder loss: 12 encoder + 12 self + 12
   cross forward and backward launches a step) and internvl2-1b (256
   patch embeddings + 1792 tokens a row) at full width and depth, 4 AdamW
   steps of 4 x 2048 each through ``make_train_step``: finite losses,
   tokens/s, peak memory, a profiled step; (6e, after 6b) the end-to-end
   trainer ``repro_torch.examples.train_e2e`` at full size: repro-100m
   (100.07 M params, f32) for 300 steps of 16 x 256 tokens, remat full,
   async checkpoints and the resume (the loss falls; the restored state
   is the final one bit for bit); 2 forward and 1 backward attention
   launches a layer a step; tokens/s, peak memory; then over the model's
   gradients from one more batch ``quantize``/``dequantize`` (within half
   a step, times beside the bytes they must move), and on a one-rank NCCL
   group's ``pod`` mesh ``compressed_grad_sync`` (its inputs back), 20
   steps with ``compress_pod_grads`` against 20 without (bit for bit) and
   ``pipelined_forward`` against the sequential stage loop (a ``pod`` of
   several cards cannot run on one H100; the multi-rank paths are held to
   the reference on the CPU through gloo); (6f) gemma3-27b at full width,
   depth 2 with pattern ``LG`` (2.235 B params), bf16, 4 AdamW steps of 2
   x 2048, remat full: finite losses and grad norms, 2 forward and 1
   backward attention launches a layer a step for each mask kind;
   tokens/s, peak memory; (6g) olmo-1b at phase 6's width, depth, batch,
   seed and learning rate, 4 steps on a one-rank NCCL (pod, data, model)
   = (1, 1, 1) mesh with ``one_rank=True`` (a step shards over no
   one-rank axis unless asked) under ZeRO-3 (every window of params
   gathered over the one-rank ``data`` group into two device slots,
   forward and again in the backward, its gradients reduce-scattered
   back) and under ZeRO-1 (the gradients reduce-scattered into the
   optimizer's shards, the new params all-gathered): each step's loss and
   ``grad_norm`` beside phase 6's ``mesh=None`` run (bit-identical, or
   the phase fails), tokens/s, peak
   memory, the ``flash_attention`` forward and backward launches a step
   against the windows' count (several ranks on ``data`` and ``model``
   run on the CPU through gloo: ``tests/test_torch_mesh_train.py``);
7. times of the training attention kernels at the phase 6 shape, beside
   their plain versions, SDPA and their bounds, with each one's TFLOP/s,
   its fraction of the operation bound and its ratio to SDPA; (7c) the
   same at phase 6c's shape (q/k 192, v 128), naming SDPA's backend;
   (7d) ``flash_attention`` at seamless-m4t's cross-attention shapes
   (decode, prefill chunk) and its encoder's (forward and backward),
   beside the plain version, SDPA and the bound; (7e, after 6f)
   ``flash_attention`` forward and backward at 6f's gemma3 shapes (the
   sliding window 1024, its bound over the window's work only; the causal
   mask) in bf16 and at 6e's repro-100m shape in f32 (bound at the f32
   CUDA-core peak), beside the plain version, SDPA (backend named) and
   the bound; (7f, right after 4h) ``flash_decode`` and ``flash_prefill`` at
   the local shapes of a ``model`` axis one card cannot reach through a
   mesh (yi-6b at ``model`` 2, 4 and 8 — at 8 a rank's 4 query heads on
   one of the 4 replicated kv heads of a B = 8 cache, through
   ``kv_head``, one kernel and no copy in the trace — and granite-8b at
   8), bf16, each held to its plain version at ``TOL`` (prefill on the
   live rows) and timed beside it, SDPA and its bound;
8. Mamba-2 serving.  (a) the SSD scan kernel against its plain versions
   (the chunked oracle and the literal recurrence) in bfloat16 and float32
   at the mamba2-780m serving shape (B 8, T 256, H 48, P 64, N 128) with a
   nonzero initial state, at zamba2-1.2b's (H 64, P 64, N 64), at ragged T
   (1, 100, 257), with rows whose dt is 0 past a per-row length and a row
   whose dt is 0 throughout (its state must come back bit for bit);
   (b) mamba2-smoke and zamba2-smoke in float32 through ``Server``, card
   against CPU, with a slot reused by a 1-token prompt; (c) full-width,
   full-depth mamba2-780m in bfloat16 serving phase 4's 16 requests
   through the graphs and then eagerly, tokens identical
   (``ssd_scan`` launches = 48 x prefill dispatches); (d) full-depth
   zamba2-1.2b with 8 requests the same way (per prefill dispatch 32
   scans and 6 prefill-attention launches, 6 decode-attention launches
   per step); (e) the scan's times at (c)'s shape and ``torch.profiler``
   windows over one mamba2 prefill dispatch and a few decode steps,
   graph replays and then eager; (f) the scan's backward kernels against
   autograd through the plain scan (``ref.ssd_scan_bwd``) in float32 and
   bfloat16: the smoke widths, several chunks, T off the chunk (one short
   of and one past the bf16 chunk of 64 too), with and without an initial
   state and a final-state gradient, and mamba2-780m's and zamba2-1.2b's
   training shapes (B 4, T 2048; H 48, P 64, N 128 and H 64, P 64, N 64),
   two calls bit-identical, and its time at mamba2's beside its bound and
   the plain version's, each pass's own device time, the scratch bytes a
   call and the design's byte floor;
9. the paper's single-GPU study.  (a) ``blocked_matmul`` against its plain
   version in bfloat16 and float32 at the reference test's three shapes,
   4096^3 in both output dtypes and a non-square shape, and a tiling with
   no instantiation refused; (b) the GEMM study through
   ``repro_torch.benchmarks.bench_gemm`` (N = 16384 bf16, N = 8192 f32,
   every tiling, ``torch.matmul`` beside it) with the kernel's launches
   counted and each tiling's TFLOP/s at N = 16384 bf16 beside
   ``torch.matmul``'s, then every call it timed (each tiling at N = 16384 bf16 and
   N = 8192 f32, on the study's own inputs) against its plain version, and
   the kernel's times at N = 16384; (c) ``bench_membw``, ``bench_copy``, ``bench_latency`` and
   ``bench_managed_vs_system`` on device memory and pinned host memory
   read in place, with sizes past the 50 MB L2, the membench kernels'
   launches counted, each held against its plain version and timed;
   (d) ``repro_torch.launch.calibrate`` on the card: ``build/
   calibration.json``, the spec-vs-measured summary and the replay error
   per term, a measured HBM bandwidth at most 1.05 x the spec, NVLink and
   InfiniBand terms left at ``spec``, each regime's spec-sheet and
   calibrated planner picks; (e) ``bench_llm_inference`` (the analytic leg
   and the serve leg at smoke scale through the graphs, written to
   ``build/BENCH_serve.json``) and ``bench_datapath_bounds``; then the
   planner's yi-6b decode step at phase 4's shape, on the spec sheet and
   the calibration, beside phase 4's measured step (information only);
   (f) ``bench_pingpong``, ``bench_internode`` and ``bench_collectives``
   (Figs. 13, 14, 18, 19: measured over 8 gloo ranks on the host's CPU,
   one skip row each for the cards, the analytic NVLink/InfiniBand rows)
   and ``repro_torch.tools.whatif_scale --arch gemma3-27b``;
10. placement on one card.  (a) ``kv_stream``, the KV write-back into
   pinned host memory, against its plain version in bf16 and f32 at the
   yi-6b serving shape (decode and prefill row sets, ragged, ring wrap,
   rows that write nothing), into pinned host and device memory, pageable
   memory refused; its time at the decode shape beside its bound and the
   launch floor (an empty kernel on the same grid, one ``cudaMemcpyAsync``
   of the same 16 KB into pinned memory), its time and GB/s at the
   prefill shape;
   (b) the paper's Fig. 17: full-width, full-depth yi-6b in bf16 serving
   phase 4's first 8 prompts (16 new tokens each) through the CUDA graphs
   under ``hbm_resident``, ``kv_host``, ``weights_stream``,
   ``kv=host:stream,params=host:stream`` and the RESIDENT ``kv=host``,
   ``params=host`` and ``kv=host,params=host`` on the same weights (tokens
   identical across them; a RESIDENT ``params`` row serves prompts 6-8
   only, against the same requests' tokens; ``kv_host`` also eagerly for
   2 requests), with per policy the tok/s, the runtime's step EWMA, the
   H2D and D2H bytes of one decode and one prefill replay from the
   profiler's memcpy records against the bytes the streamed windows hold
   (none for a RESIDENT role, which the kernels read in place: those
   bytes and their time at 9d's calibrated mapped-read rate are printed),
   the write-back's bytes, its kernels (one a layer), their device time
   and stream against the compute stream's (also for one eager
   ``kv_host`` decode step), a SHA-256 of the tokens, the kernels a replay
   launches, and the planner's step on the spec sheet and on 9d's
   calibration; (c) full-depth olmo-1b in bf16, 3 AdamW steps and a
   traced fourth from the same weights and batches under ``hbm_resident``,
   ``opt_host``, ``opt=host`` (RESIDENT: the update reads and writes the
   master and moments in place), ``weights_stream`` and all three roles
   ``host:stream`` at 4 x 2048, and ``params=host`` (RESIDENT: the steps
   read the params in place and the update writes them back there) beside
   an ``hbm_resident`` twin at 1 x 2048 (losses and grad norms against the
   twin's, the step time beside the planner's train price, the traced
   step's H2D and D2H bytes against the streamed windows', peak device
   memory, attention launches, the params arena kept); (f) full-width,
   full-depth yi-6b in bf16 under ``opt_host``, 2 AdamW steps at 1 x
   2048 (the f32 master and moments pinned in host memory, 67.7 GiB; the
   phase fails, naming the numbers, when MemAvailable cannot hold them);
   (g) full-width, full-depth seamless-m4t-medium in bf16 serving 8
   requests through the graphs under ``hbm_resident``, ``kv_host``,
   ``weights_stream`` and both over the same random cross KV: tokens
   identical, a replay's H2D bytes those of the decoder's windows, one
   write-back a layer (the self rows), the audits ``ok``, the host cross
   KV unchanged; (d) full-width, full-depth mamba2-780m in bf16, 8 slots x 2048,
   8 requests through the graphs under ``hbm_resident``, ``kv_host``,
   ``kv=host`` and ``weights_stream``, and zamba2-1.2b under
   ``hbm_resident`` and ``kv_host``: tokens identical within each model,
   launches counted, the H2D and D2H bytes of one decode and one prefill
   replay against the state windows (an ``M`` layer's state goes back by
   copy, an ``S`` layer's rows by the write-back kernel), step EWMA
   beside the planner; (e) ``Runtime.migrate`` of the yi-6b cache to
   pinned host memory and back, value for value, timed beside
   ``price_copy``;
11. preemption, faults and recovery through the graphs, full width and
   depth, bf16, 8 slots x 2048, prefill chunk 256.  (a) yi-6b serving
   phase 4's 16 requests arriving one every 2 ticks, 64 new tokens each,
   ``preempt=True``, ``preempt_wait=4``, ``verify_spills=True``: at least
   one preemption, every one promoted back, greedy tokens per rid those of
   phase 4, no capture after construction, spilled rows in pinned host
   memory (checked every tick), each spill's and restore's bytes and time
   beside the planner's round trip, latency and TTFT p50/p99; (b) the same
   on mamba2-780m with phase 8c's requests and tokens; (c) yi-6b and
   mamba2-780m replanned ``hbm_resident`` -> ``kv_host`` ->
   ``hbm_resident`` with 8 live requests: tokens those of phases 4 / 8c,
   both graphs captured once a replan, each replan's migrate and rebuild
   times; (d) chaos on yi-6b under ``kv_host`` (12 of phase 4's requests,
   32 new tokens): a seeded plan with a ``host`` tier loss at a decode
   pass (evacuation to the card, graphs captured again), a transient
   migration failure, a 1 s stall past the watchdog's deadline and a
   corrupted spill (replayed): every request ends, tokens those of phase
   4, the firing record printed; (e) (a)'s workload through the asyncio
   ``Scheduler``, tokens identical; (f) ``bench_llm_inference``'s queued
   leg at smoke scale, its p50/p99.  Every serving phase's step watchdog
   runs at its default and must take no action but ``ok``;
12. the data-movement audit (ROADMAP A12).  (a) ``Runtime.audit`` with the
   profiler over one decode replay and one prefill replay of phase 4's
   yi-6b server (``hbm_resident``, 8 slots x 2048) and of phase 10b's
   ``kv_host`` and ``weights_stream`` servers, run where those servers are
   alive (after 4's profiles, inside 10b's loop): each report's in-place
   leaves, H2D and D2H bytes from the card's copy records against the
   allowance, and violations, every report ``ok``; ``kv_host``'s H2D
   bytes those of its windows, as 10b checks them; the build's own
   audits (decode and prefill, on its last warm-ups) ``ok``; (b) the
   gate, ``python -m repro_torch.tools.audit --lint --selftest
   --transfer-audit --out build/audit_report.json``, exit 0, its decode
   and prefill replays and its restore profiled and ``ok``; (c) the
   roofline of yi-6b's decode step at full width and depth counted on
   ``meta`` at phase 4's shape (8 x 2048): FLOPs, counted bytes (a
   diagnostic), ``model_bytes``, the bound (its memory term priced on
   ``model_bytes``, the must-move floor) beside phase 4's measured step
   EWMA (information only); (d) the dry run, host only on ``meta``, of
   yi-6b's cells (the whole ``--all`` sweep takes minutes of host time),
   its wall time and its ok / skipped / failed counts.

The last three lines are the ``kernels`` JSON record, ``nvidia-smi``'s
name and power limit, and the device JSON.
Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def peaks():
    """(device-memory bytes/s, bf16 tensor-core flops/s, f32 CUDA-core
    flops/s): the H100 data sheet's dense peaks, read from the port's
    hardware model so the kernel bounds and the model have one source."""
    from repro_torch.core.hardware import SPEC_SYSTEM

    c = SPEC_SYSTEM.chip
    return (c.hbm_bandwidth, c.peak_flops_by_dtype["bfloat16"],
            c.peak_flops_by_dtype["float32"])


#: elementwise limit |got - want| <= atol + rtol |want|, and a limit on each
#: output row's max error relative to that row's RMS in the plain version.
#: Random q/k/v give rows with RMS ~ 1/sqrt(live keys) (0.03 at 2048 keys),
#: so the row limit is what keeps a bf16 check meaningful on long rows; a
#: one-ulp bf16 rounding difference is under 0.01 x |element| <= 0.04 x RMS.
TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2, row=0.1),
       "float32": dict(atol=3e-5, rtol=1e-5, row=1e-3)}

#: gradients of the training attention kernel: f32 sums over up to 2048
#: terms in another order (f32); bf16 products take P and dS rounded to
#: bf16, as FlashAttention-2 does (bf16).  Same elementwise and row-RMS
#: form as TOL, but a row's RMS is floored at the median row RMS: some
#: gradient rows are 0 in exact arithmetic (causal query 0 sees only key 0,
#: so its dS is 0) and keep a rounding-level error that does not shrink
#: with them.  In bf16 a row's error may also exceed the limit by one ulp
#: of its largest element (<= 2^-7 of it): both sides round f32 gradients
#: that differ in the last bits, and a rounding flip on a row's largest
#: element is one ulp there.
GRAD_TOL = {"bfloat16": dict(atol=3e-2, rtol=3e-2, row=0.1, floor="median",
                             ulp=2.0 ** -7),
            "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3, floor="median")}

#: main-path shapes (yi-6b serving: ServeConfig(8, 2048, 256))
YI = dict(B=8, Hq=32, Hkv=4, D=128, Smax=2048, chunk=256)

#: training path (olmo-1b, batch 4 x 2048 tokens, 16/16 heads, head dim 128)
OLMO_TRAIN = dict(B=4, Hq=16, Hkv=16, S=2048, D=128, steps=4)

#: deepseek-v2 training at full width, depth 1 (the dense lead layer: MLA
#: + a 12288-wide MLP), batch 4 x 2048 tokens: the attention kernels at
#: 128 heads, q/k head dim 192 (128 no-rope + 64 rope), v head dim 128
MLA_TRAIN = dict(B=4, H=128, S=2048, D=192, Dv=128, depth=1, steps=4)

#: the end-to-end trainer (phase 6e): repro-100m in float32, 300 steps of
#: batch 16 x 256 tokens, 12/4 heads of 64, remat full
E2E_TRAIN = dict(B=16, S=256, Hq=12, Hkv=4, D=64, steps=300, layers=12)

#: gemma3-27b training at full width (phase 6f): depth 2, one sliding L
#: layer (window 1024) and one global G layer, bf16, 4 AdamW steps of 2 x
#: 2048 tokens, remat full; 32/16 heads of 128
GEMMA_TRAIN = dict(B=2, S=2048, Hq=32, Hkv=16, D=128, window=1024, steps=4,
                   pattern="LG")

#: seamless-m4t-medium (ROADMAP A7): 16/16 heads of 64, 1024 frame
#: positions; serving 8 slots x 2048, prefill chunk 256; training batch 4 x
#: 2048 decoder tokens over 1024 frames a row.  internvl2-1b: 256 patch
#: embeddings ahead of the text (1792 tokens a row in training)
SEAMLESS = dict(B=8, H=16, D=64, frames=1024, Smax=2048, chunk=256, train_B=4,
                train_S=2048, steps=4)
INTERNVL = dict(B=8, Smax=2048, chunk=256, patches=256, train_B=4, train_S=2048,
                steps=4)

#: Mamba-2 serving path (mamba2-780m: ServeConfig(8, 2048, 256), 48 SSD
#: heads of P 64, state N 128) and zamba2-1.2b's SSD widths
MAMBA = dict(B=8, T=256, H=48, P=64, N=128)
ZAMBA = dict(H=64, P=64, N=64)

#: the SSD scan's y: bf16 as TOL (the kernel and the plain version round
#: the same f32 sums, taken in other orders, once to bf16); f32 sums over
#: up to 256 positions and 128 state entries of O(10) terms in other
#: orders, and chunked at 32 against the plain version's 64-256, so its
#: f32 limit is 1e-4 (row 1e-3 x RMS).  The f32 state is held to 1e-4 x the
#: leaf's max |value| (the scale-aware bound of the reference's
#: tests/test_serve_fastpath.py).
SSD_TOL = {"bfloat16": TOL["bfloat16"],
           "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3)}

#: blocked_matmul against ref.matmul.  9a draws a ~ N(0, 1) and b ~ N(0, 1)
#: / sqrt(K), so outputs have RMS ~1: an f32 output is the same products
#: (a bf16 product is exact in f32) summed over K in another order, held to
#: 1e-4 elementwise and a row's max error to 1e-3 x its RMS; a bf16 output
#: is one rounding of those sums, TOL's bf16 limits (one ulp is under
#: 2^-7 |element|).  9b's study inputs (bench_gemm.inputs) are scaled the
#: same way.
GEMM_TOL = {"bfloat16": TOL["bfloat16"],
            "float32": dict(atol=1e-4, rtol=1e-4, row=1e-3)}

#: the GEMM study's size on the card (bench_gemm: N = 16384, bf16)
GEMM_N = 16384


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_close(name, got, want, dtype_name, rows=None, tols=TOL):
    """Max abs error of ``got`` vs ``want`` over output rows (the last dim;
    optionally only the rows a mask selects); raises if any element is
    outside the elementwise tolerance or any row's max error exceeds the
    row limit times that row's RMS in ``want``."""
    import torch

    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    tol = tols[dtype_name]
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    rms = w.square().mean(-1).sqrt()
    if tol.get("floor") == "median":
        rms = rms.clamp(min=float(rms.median()))
    row_err = err.amax(-1) - tol.get("ulp", 0.0) * w.abs().amax(-1)
    rel = row_err.clamp(min=0) / rms.clamp(min=1e-30)
    worst = int(rel.argmax())
    max_err = float(err.max())
    log(f"  {name}: max_abs_err {max_err:.3e} (atol {tol['atol']}, rtol "
        f"{tol['rtol']}); want's row RMS{' (floored at the median)' if 'floor' in tol else ''}"
        f" min {float(rms.min()):.3e} median "
        f"{float(rms.median()):.3e}; worst row err/RMS {float(rel.max()):.3e} "
        f"(limit {tol['row']}; row {worst}: max err {float(err[worst].max()):.3e}, "
        f"max |want| {float(w[worst].abs().max()):.3e}, RMS {float(rms[worst]):.3e}"
        f"{', less one ulp of its largest element' if 'ulp' in tol else ''})")
    if not torch.isfinite(g).all() or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance")
    if bool((rel > tol["row"]).any()):
        raise AssertionError(f"{name}: {int((rel > tol['row']).sum())} rows with "
                             f"max error over {tol['row']} x their RMS")
    return max_err


# ---------------------------------------------------------------------------
# inputs at a given shape
# ---------------------------------------------------------------------------

def decode_inputs(B, Hq, Hkv, D, Smax, lengths, dtype, gen, copies=1):
    import torch

    dev = "cuda"
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(dtype)
    kv = [
        (torch.randn(B, Hkv, Smax, D, generator=gen, device=dev).to(dtype),
         torch.randn(B, Hkv, Smax, D, generator=gen, device=dev).to(dtype))
        for _ in range(copies)
    ]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kv, lens


def prefill_positions(offsets, new_lens, Sc, Sn, holes=()):
    """q_pos (B, Sn) and k_pos (B, Sc + Sn) as the model builds them for
    a non-ring cache: slot r holds position r below the row's offset, the
    chunk's entries past new_lens are holes; ``holes`` punches extra
    (row, slot) holes into the cache part."""
    import torch

    dev = "cuda"
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)[:, None]
    nl = torch.tensor(new_lens, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(Sn, dtype=torch.int32, device=dev)[None, :]
    r = torch.arange(Sc, dtype=torch.int32, device=dev)[None, :]
    q_pos = off + j
    kpos_cache = torch.where(r < off, r, -1)
    for b, slot in holes:
        kpos_cache[b, slot] = -1
    kpos_new = torch.where(j < nl, q_pos, -1)
    return q_pos.contiguous(), torch.cat([kpos_cache, kpos_new], 1).contiguous()


def live_mask(q_pos, k_pos, kind="causal", window=0, chunk=0):
    qp, kp = q_pos[:, :, None], k_pos[:, None, :]
    m = (qp >= kp) & (kp >= 0)
    if kind == "sliding":
        m &= (qp - kp) < window
    elif kind == "chunked":
        m &= (qp // chunk) == (kp // chunk)
    return m                                            # (B, Sq, Sk)


def prefill_inputs(B, Hq, Hkv, D, Sc, Sn, dtype, gen, copies=1):
    import torch

    dev = "cuda"
    q = torch.randn(B, Hq, Sn, D, generator=gen, device=dev).to(dtype)
    srcs = []
    for _ in range(copies):
        srcs.append(tuple(
            torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(dtype)
            for S in (Sc, Sc, Sn, Sn)
        ))
    return q, srcs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels import _build

    log("== phase 1: device and build")
    log(f"  nvidia-smi: {nvidia_smi()}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, out) in sorted(_build.BUILD_LOG.items()):
        if name in PTXAS_NAMED:
            log_ptxas(name, out)
            continue
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


#: the libraries whose kernels phase 1 logs by name and template arguments
PTXAS_NAMED = ("flash_attention", "prefill_attention", "blocked_matmul",
               "decode_attention", "ssd_scan", "ssd_scan_bwd")
#: the SSD backward's kernels in the order of ``ssd_scan.smem_bytes_bwd``'s
#: index: the f32 state and chunk passes, then the bf16 ones
BWD_KERNELS = ("ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel",
               "ssd_bwd_state_mma_kernel", "ssd_bwd_chunk_mma_kernel")


def log_ptxas(lib, out):
    """Each kernel of ``csrc/<lib>.cu`` as ``nvcc -Xptxas -v`` saw it:
    registers, spill stores and loads, static shared memory, and for the
    kernels that take dynamic shared memory what they launch with (the
    prefill kernel at the main path's Sc + Sn = 2304 keys, the scan at the
    serving shape's heads per block)."""
    import re

    from repro_torch.kernels import decode_attention, ssd_scan
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.blocked_matmul import traffic_model
    from repro_torch.kernels.flash_attention import prefill_smem_bytes, smem_footprint_bytes

    fa_dynamic = {"fa_fwd_mma_kernel": "fwd", "fa_bwd_dq_mma_kernel": "bwd_dq",
                  "fa_bwd_dkdv_mma_kernel": "bwd_dkdv"}

    def dynamic(kernel, args):
        if kernel in fa_dynamic:         # <D, DV>
            return smem_footprint_bytes(int(args[-2]), int(args[-1]))[fa_dynamic[kernel]]
        if kernel == "prefill_mma_kernel":
            return prefill_smem_bytes(int(args[0]), YI["Smax"] + YI["chunk"])
        if kernel in ("mm_wgmma_kernel", "mm_fma_kernel"):
            t = tuple(int(a) for a in args[:3])
            return traffic_model(*t, *t, itemsize=2 if kernel == "mm_wgmma_kernel" else 4)[
                "smem_bytes"]
        if kernel == "decode_mma_kernel":
            return decode_attention.smem_bytes(int(args[0]))
        if kernel == "ssd_mma_kernel":
            P, N = int(args[0]), int(args[1])
            m = MAMBA
            return ssd_scan.smem_bytes(P, N, ssd_scan.heads_per_block(
                m["B"], m["H"], P, sm_count(0)))
        if kernel in BWD_KERNELS:   # <E, P, N> (f32 route) or <P, N> (bf16 route)
            P, N = int(args[-2]), int(args[-1])
            return ssd_scan.smem_bytes_bwd(P, N, BWD_KERNELS.index(kernel))
        return None

    name, spill = None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # mangled kernel<T, D...>: "...fa_fwd_mma_kernelILi128EEEvPK..."
            k = re.search(r"(prefill_mma_kernel|prefill_kernel|mm_wgmma_kernel|mm_fma_kernel"
                          r"|decode_mma_kernel|decode_fma_kernel|ssd_mma_kernel|ssd_fma_kernel"
                          r"|ssd_bwd_state_mma_kernel|ssd_bwd_chunk_mma_kernel"
                          r"|ssd_bwd_state_kernel|ssd_bwd_chunk_kernel"
                          r"|fa_\w+?_kernel)I(.*?)EEv",
                          m.group(1))
            args = ["bf16" if t.startswith("13") else "f32" if t == "f" else t[2:-1]
                    for t in re.findall(r"13__nv_bfloat16|Li\d+E|f", k.group(2))] if k else []
            name = (k.group(1), args) if k else None
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            dyn = dynamic(*name)
            extra = "" if dyn is None else f", {int(dyn)} B dynamic smem"
            log(f"  ptxas {lib} {name[0]}<{','.join(name[1])}>: {regs} registers; {spill}; "
                f"{smem.group(1) if smem else 0} B static smem{extra}")
            name = None


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_prefill

    log("== phase 2: kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        # -- decode: main path, G=1, smoke head dim -----------------------
        y = YI
        cases = [
            ("yi", y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"],
             [1, 2048, 1000, 37, 64, 65, 1999, 513]),
            ("olmo", 4, 16, 16, 128, 1000, [1, 999, 1000, 333]),
            ("smoke", 3, 8, 1, 16, 64, [1, 17, 64]),
            # lengths around the 64-key tile and its splits; G = 16
            ("yi-edges", y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"],
             [1, 63, 64, 65, 2048, 129, 1, 640]),
            ("g16", 4, 32, 2, 128, 1500, [1500, 777, 129, 5]),
        ]
        for tag, B, Hq, Hkv, D, Smax, lens in cases:
            q, kv, L = decode_inputs(B, Hq, Hkv, D, Smax, lens, dtype, gen)
            k, v = kv[0]
            got = flash_decode(q, k, v, L)
            torch.cuda.synchronize()
            want = ref.decode_attention(q, k, v, L)
            e = check_close(f"decode {tag} {dn} B{B} Hq{Hq} Hkv{Hkv} D{D} Smax{Smax}",
                            got, want, dn)
            if tag == "yi":
                errs[("decode", dn)] = e
                if not torch.equal(got, flash_decode(q, k, v, L)):
                    raise AssertionError("decode: two calls in a row differ")
                log(f"  decode {tag} {dn}: two calls in a row bit-identical")
        # -- prefill: main path (two sources), G=1, smoke, mask kinds ------
        Sc, Sn = y["Smax"], y["chunk"]
        pcases = [
            ("yi", y["B"], y["Hq"], y["Hkv"], y["D"], Sc, Sn,
             [0, 256, 1792, 777, 1, 0, 1500, 1024],
             [256, 256, 256, 100, 0, 1, 256, 0], "causal", {}),
            ("olmo", 2, 16, 16, 128, 600, 40, [0, 561], [40, 23], "causal", {}),
            ("smoke", 3, 8, 1, 16, 64, 4, [5, 0, 60], [4, 0, 3], "causal", {}),
            ("sliding", 2, 8, 2, 64, 300, 48, [100, 200], [48, 30],
             "sliding", {"window": 64}),
            ("chunked", 2, 8, 2, 64, 300, 48, [100, 200], [48, 30],
             "chunked", {"chunk": 96}),
        ]
        for tag, B, Hq, Hkv, D, Sc_, Sn_, offs, nls, kind, kw in pcases:
            q, srcs = prefill_inputs(B, Hq, Hkv, D, Sc_, Sn_, dtype, gen)
            kc, vc, kn, vn = srcs[0]
            holes = [(0, 3), (B - 1, max(offs[-1] - 2, 0))]
            q_pos, k_pos = prefill_positions(offs, nls, Sc_, Sn_, holes)
            got = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn,
                                kind=kind, **kw)
            torch.cuda.synchronize()
            want = ref.prefill_attention(
                q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2), q_pos, k_pos,
                kind=kind, **kw,
            )
            # rows with no live key are padding: the kernel gives 0, the
            # plain version mean(V); both sides discard them
            rows = live_mask(q_pos, k_pos, kind, **kw).any(-1)      # (B, Sq)
            rows = rows[:, None, :].expand(B, Hq, Sn_)
            e = check_close(f"prefill {tag} {dn} B{B} Hq{Hq} Hkv{Hkv} D{D} "
                            f"Sc{Sc_} Sn{Sn_} {kind}", got, want, dn, rows)
            if tag == "yi":
                errs[("prefill", dn)] = e
        # one-source signature (the reference's): same numbers
        q, srcs = prefill_inputs(2, 8, 2, 32, 50, 10, dtype, gen)
        kc, vc, kn, vn = srcs[0]
        q_pos, k_pos = prefill_positions([20, 45], [10, 5], 50, 10)
        one = flash_prefill(q, torch.cat([kc, kn], 2).contiguous(),
                            torch.cat([vc, vn], 2).contiguous(), q_pos, k_pos)
        two = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn)
        torch.cuda.synchronize()
        if not torch.equal(one, two):
            raise AssertionError("one-source and two-source prefill disagree")
        log(f"  prefill one-source == two-source ({dn})")
    return errs


def phase_smoke_parity():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.serve import Request, ServeConfig, Server

    log("== phase 3: yi-6b-smoke, granite-8b-smoke, llama4-maverick-smoke and "
        "deepseek-v2-smoke float32, card (CUDA graphs) against CPU")
    for arch in ("yi-6b", "granite-8b", "llama4-maverick-400b-a17b", "deepseek-v2-236b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
                   for n in (9, 14, 3, 6, 11)]
        tokens = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            server = Server(bundle, ServeConfig(batch_slots=2, max_len=64,
                                                prefill_chunk=4), params, device=dev)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            server.add_requests(reqs)
            server.run_until_done(max_steps=300)
            assert all(r.done and len(r.out_tokens) == 6 for r in reqs), dev
            tokens[dev] = {r.rid: r.out_tokens for r in reqs}
            if dev == "cuda" and not server.engine.counters["decode_replays"]:
                raise AssertionError("the card's server replayed no decode graph")
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{arch}: card/CPU greedy tokens differ: {tokens}")
        log(f"  {cfg.name}: greedy tokens identical for {len(prompts)} requests: "
            f"{tokens['cuda']}")


def serve_requests(bundle, params, scfg, prompts, new_tokens, *, eager=False,
                   before=None, **server_kw):
    """Serve greedy requests through ``Server`` on the card.  The kernels'
    counts are reset just before the server is built, so its warm-up and
    capture belong to the run; ``before(server)`` runs once it is built,
    before the requests arrive.  Returns (server, requests, wall seconds,
    launches): for a graphed server each kernel's launches per replay x
    the replays of its graph, for an eager one the wrappers' counts; the
    build's audits of its decode and prefill steps must be ``ok``.
    ``server_kw`` (``mesh``, ``one_rank``) go to the ``Server``."""
    import torch
    from repro_torch.serve import Request, Server
    from repro_torch.serve.engine import KERNELS

    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    server = Server(bundle, scfg, params, device="cuda", eager=eager, **server_kw)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    if before is not None:
        before(server)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng, c = server.engine, server.engine.counters
    bad = {k: [str(v) for v in r.violations] for k, r in eng.audit_reports.items()
           if not r.ok}
    steps = {"decode", "prefill"} if eng.supports_chunked_prefill else {"decode"}
    if bad or not steps <= set(eng.audit_reports):
        raise AssertionError(f"the build's movement audit: {bad or eng.audit_reports}")
    vocab = bundle.cfg.vocab
    for r in reqs:
        if not r.done or len(r.out_tokens) != new_tokens:
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    if eager:
        launches = {name: fn.launches for name, fn in KERNELS.items()}
        if c["decode_replays"] or c["prefill_replays"]:
            raise AssertionError(f"an eager server replayed graphs: {c}")
    else:
        if (c["decode_replays"], c["prefill_replays"]) != (
                c["decode_steps"], c["prefill_dispatches"]):
            raise AssertionError(f"replays differ from steps and dispatches: {c}")
        launches = dict.fromkeys(KERNELS, 0)
        for phase in ("decode", "prefill"):
            for name, n in eng.graph_launches[phase].items():
                launches[name] += n * c[f"{phase}_replays"]
    actions = server.watchdog.actions
    if any(n for a, n in actions.items() if a != "ok"):
        raise AssertionError(f"the step watchdog acted: {actions}")
    tp = server.throughput()
    log(f"  {'eager' if eager else 'graphs'}: served {len(reqs)} requests in {wall:.2f} s "
        f"(server built in {built:.2f} s): {c['decode_steps']} decode steps, "
        f"{c['prefill_dispatches']} prefill dispatches, {c['decode_replays']} + "
        f"{c['prefill_replays']} graph replays; kernel launches {launches}"
        + ("" if eager else f" ({eng.graph_launches} per replay)"))
    log(f"  {'eager' if eager else 'graphs'}: prefill {tp['prefill_tokens']} tokens at "
        f"{tp['prefill_tps']:.1f} tok/s, decode {tp['decode_tokens']} tokens at "
        f"{tp['decode_tps']:.1f} tok/s; decode step EWMA "
        f"{eng.measured_step_s * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; watchdog {actions} "
        f"(deadline {server.watchdog.deadline_s() * 1e3:.1f} ms)")
    return server, reqs, wall, launches


def same_tokens(label, a, b):
    """Greedy tokens per request identical between two runs."""
    diff = [r.rid for r, q in zip(a, b) if r.out_tokens != q.out_tokens]
    if diff:
        raise AssertionError(f"{label}: graph and eager tokens differ for requests {diff}")
    log(f"  {label}: greedy tokens identical, graphs against eager, for all "
        f"{len(b)} requests compared")


def check_logits(bundle, params, server, rows, length=1600):
    """The logits behind the served tokens are finite (one more step on the
    served caches at position ``length``, eager and uncounted)."""
    import torch

    logits, _ = bundle.decode_step(
        params,
        {"tokens": torch.zeros(rows, 1, dtype=torch.int32, device="cuda"),
         "lengths": torch.full((rows,), length, dtype=torch.int32, device="cuda")},
        server.engine.caches,
    )
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")


def dense_prompts(vocab, n=16):
    """Phase 4's requests: ``n`` prompts of 128-1536 tokens, numpy seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(128, 1537, size=n)
    return [rng.integers(0, vocab, k).astype(np.int32) for k in plens], plens


def phase_full():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config("yi-6b")
    log(f"== phase 4: {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        "through the CUDA graphs, then eager")
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    scfg = ServeConfig(batch_slots=YI["B"], max_len=YI["Smax"],
                       prefill_chunk=YI["chunk"])
    prompts, plens = dense_prompts(cfg.vocab)
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st = server.stats()
    L = cfg.n_layers
    if launches["decode_attention"] != L * st["decode_steps"]:
        raise AssertionError(f"decode launches {launches} != {L} x {st['decode_steps']}")
    if launches["prefill_attention"] != L * st["prefill_dispatches"]:
        raise AssertionError(
            f"prefill launches {launches} != {L} x {st['prefill_dispatches']}")
    check_logits(bundle, params, server, YI["B"])
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts, 64,
                                                eager=True)
    est = eager.stats()
    if elaunches["decode_attention"] != L * est["decode_steps"]:
        raise AssertionError(f"eager decode launches {elaunches}")
    same_tokens(cfg.name, reqs, ereqs)
    return launches, st, [int(n) for n in plens], server, eager, [r.out_tokens for r in reqs]


def phase_mesh_serve(yi_tokens, phase4_ewma_s):
    """4h: phase 4's yi-6b (full width and depth, bf16, weights of seed 0)
    serving phase 4's 16 requests through the CUDA graphs on a one-rank
    NCCL (data, model) = (1, 1) mesh with ``one_rank=True``: every
    serving collective runs over a one-rank group (the all-reduces of each
    layer's attention and MLP outputs and of the embedding, the logits'
    gather over ``model``, the packed result's gather over ``data``),
    captured in the graphs.  Over one rank they compute the identity, so
    the greedy tokens must be phase 4's (``yi_tokens``) for every request;
    anything else raises.  Prints the decode EWMA beside phase 4's
    (``phase4_ewma_s``), the peak memory, the collectives a replay runs
    against the count expected (2 a layer + 3 a decode replay, 2 a layer
    + 2 a prefill replay) and the NCCL kernels in one decode replay's
    trace, and whether the decode ran as a graph.  Returns the serving
    kernels' launches (several cards' data and model ranks run on the CPU
    through gloo: ``tests/test_torch_mesh_serve.py``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config("yi-6b")
    bundle, L = ModelBundle(cfg), cfg.n_layers
    log(f"== phase 4h: {cfg.name} bfloat16 ({L} layers) serving phase 4's requests on a "
        "one-rank NCCL (data, model) = (1, 1) mesh, one_rank=True, through the CUDA graphs")
    t_phase = time.perf_counter()
    store = ROOT / "build" / "mesh-serve-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = make_mesh_for((1, 1), ("data", "model"))
        params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
        scfg = ServeConfig(batch_slots=YI["B"], max_len=YI["Smax"], prefill_chunk=YI["chunk"])
        prompts, _ = dense_prompts(cfg.vocab)
        server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64,
                                                   mesh=mesh, one_rank=True)
        eng, st = server.engine, server.stats()
        diff = [r.rid for r, want in zip(reqs, yi_tokens) if r.out_tokens != want]
        if diff:
            raise AssertionError(f"4h: tokens differ from phase 4's for requests {diff}")
        log(f"  greedy tokens identical to phase 4's (mesh=None) for all {len(reqs)} requests")
        want = {"decode": 2 * L + 3, "prefill": 2 * L + 2}
        got = {g: sum(eng.graph_collectives[g].values()) for g in want}
        log(f"  collectives a replay: {eng.graph_collectives} -> {got}, expected {want} "
            f"(2 a layer, the embedding's all-reduce, the logits' gather, and the decode's "
            f"gather over data)")
        if got != want:
            raise AssertionError(f"4h: collectives a replay {got}, expected {want}")
        if launches["decode_attention"] != L * st["decode_steps"] or (
                launches["prefill_attention"] != L * st["prefill_dispatches"]):
            raise AssertionError(f"4h: launches {launches} for {st['decode_steps']} steps, "
                                 f"{st['prefill_dispatches']} dispatches")
        ewma = eng.measured_step_s        # before the traced replay feeds it
        inside, _ = traced_window("4h decode replay", server.engine.decode)
        nccl = [e["name"] for e in inside if e.get("cat") == "kernel"
                and "nccl" in e.get("name", "").lower()]
        log(f"  one decode replay's trace: {len(nccl)} NCCL kernels "
            f"({sorted(set(nccl))[:4]}): NCCL runs a collective of one rank "
            "as a copy or nothing, so the count above is the port's, at capture")
        log(f"  decode ran as a CUDA graph: {eng.graphed and 'decode' in eng._graphs} "
            f"({st['decode_replays']} replays of {st['decode_steps']} steps); decode step "
            f"EWMA {ewma * 1e3:.3f} ms against phase 4's "
            f"{phase4_ewma_s * 1e3:.3f} ms ({ewma / phase4_ewma_s:.3f}x); "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del server, reqs, params, eng
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"== phase 4h took {time.perf_counter() - t_phase:.1f} s")
    return launches


def one_launch(label, fn):
    """The card's records of one call of ``fn`` hold one kernel and no
    copy: a head read in place, never a copy of the cache's head slice."""
    inside, _ = traced_window(label, fn)
    recs = [e.get("name", "?") for e in inside if e.get("cat") in ("kernel", "gpu_memcpy")]
    kernels = [e for e in inside if e.get("cat") == "kernel"]
    if len(recs) != 1 or len(kernels) != 1:
        raise AssertionError(f"7f {label}: one kernel and no copy expected, the trace "
                             f"holds {recs}")
    log(f"  {label} through kv_head: one kernel, no copy ({recs[0][:60]})")


#: 7f: the serving kernels at the local shapes of a model axis one card
#: cannot reach through a mesh: (label, query heads, KV heads in the
#: cache, the one KV head attended or None) a rank, 8 slots x 2048, D 128
TP_SHAPES = (("yi-6b model 2", 16, 2, None), ("yi-6b model 4", 8, 1, None),
             ("yi-6b model 8", 4, 4, 3), ("granite-8b model 8", 4, 1, None))


def phase_tp_kernels():
    """7f: ``flash_decode`` and ``flash_prefill`` at :data:`TP_SHAPES` in
    bfloat16, each held to its plain version with ``check_close`` at
    ``TOL`` (prefill on the live rows, as phase 2) and timed beside its
    plain version, SDPA and its bound.  yi-6b at ``model`` 8 replicates
    its 4 kv heads (8 does not divide them): a rank's 4 query heads attend
    one of them, read in place through ``kv_head`` on the B = 8 cache of
    all 4 (checked for heads 0 and 3, timed for 3).  These launches
    compare and time the kernels: none is the main path's."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.decode_attention import KEY_TILE, flash_decode, num_splits
    from repro_torch.kernels.flash_attention import flash_prefill

    log("== phase 7f: the serving kernels at tensor-parallel local shapes (bfloat16)")
    t_phase = time.perf_counter()
    y, dt, dn = YI, torch.bfloat16, "bfloat16"
    B, D, Smax, Sn = y["B"], y["D"], y["Smax"], y["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    lens = [1, 2048, 1000, 37, 64, 65, 1999, 513]
    offs, nls = [0, 256, 1792, 777, 1, 0, 1500, 1024], [256, 256, 256, 100, 0, 1, 256, 0]
    hbm, bf16, _ = peaks()
    out = {}
    for label, Hq, Hc, head in TP_SHAPES:
        q, kv, L = decode_inputs(B, Hq, Hc, D, Smax, lens, dt, gen, copies=4)
        k, v = kv[0]
        for j in ([0, head] if head is not None else [None]):
            got = flash_decode(q, k, v, L, kv_head=j)
            torch.cuda.synchronize()
            e_dec = check_close(f"decode {label} B{B} Hq{Hq} cache heads {Hc} kv_head {j}",
                                got, ref.decode_attention(q, k, v, L, kv_head=j), dn)
        qp, srcs = prefill_inputs(B, Hq, Hc, D, Smax, Sn, dt, gen, copies=4)
        q_pos, k_pos = prefill_positions(offs, nls, Smax, Sn, [(0, 3), (B - 1, 1022)])
        rows = live_mask(q_pos, k_pos).any(-1)[:, None, :].expand(B, Hq, Sn)
        kc, vc, kn, vn = srcs[0]
        for j in ([0, head] if head is not None else [None]):
            h = slice(None) if j is None else slice(j, j + 1)
            got = flash_prefill(qp, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn, kv_head=j)
            torch.cuda.synchronize()
            want = ref.prefill_attention(qp, torch.cat([kc[:, h], kn[:, h]], 2),
                                         torch.cat([vc[:, h], vn[:, h]], 2), q_pos, k_pos)
            e_pre = check_close(f"prefill {label} B{B} Hq{Hq} cache heads {Hc} kv_head {j}",
                                got, want, dn, rows)
        if head is not None:
            one_launch(f"decode {label}", lambda: flash_decode(q, k, v, L, kv_head=head))
            one_launch(f"prefill {label}", lambda: flash_prefill(
                qp, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn, kv_head=head))
        dec = decode_record(q, kv, L, kv_head=head)
        pre = prefill_record(qp, srcs, *prefill_positions(offs, [Sn] * B, Smax, Sn),
                             kv_head=head)
        Hkv = 1 if head is not None else Hc
        for what, rec, err in (("decode", dec, e_dec), ("prefill", pre, e_pre)):
            bound = max(rec["bytes"] / hbm, rec["flops"] / bf16) * 1e3
            out[(label, what)] = dict(rec, bound_ms=bound, max_abs_err=err)
            log(f"  {what} {label}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                f"SDPA {rec['library_ms']:.4f} ms, bound {bound:.4f} ms "
                f"({rec['bytes']} bytes, {rec['flops']} flops): {bound / rec['ms']:.3f} of "
                f"the bound, {rec['ms'] / rec['library_ms']:.2f}x SDPA; max_abs_err {err:.3e}")
        log(f"  decode {label}: {num_splits(B, Hkv, Smax, KEY_TILE[dt], sm_count(0))} "
            f"blocks a (row, KV head) x {B * Hkv} rows on {sm_count(0)} SMs")
    log(f"== phase 7f took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_granite_full():
    """4b: granite-8b at full width and depth through the graphs: phase
    4's 16 requests, launch counts checked; its first 4 requests also
    through an eager server, greedy tokens identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config("granite-8b")
    log(f"== phase 4b: {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"{cfg.num_params() / 1e9:.2f} B params, through the CUDA graphs")
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    scfg = ServeConfig(batch_slots=YI["B"], max_len=YI["Smax"], prefill_chunk=YI["chunk"])
    prompts, _ = dense_prompts(cfg.vocab)
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, L = server.stats(), cfg.n_layers
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0,
            "flash_attention": 0, "kv_stream": 0}
    if launches != want:
        raise AssertionError(f"granite-8b launches {launches} != {want}")
    check_logits(bundle, params, server, YI["B"])
    del server
    torch.cuda.empty_cache()
    eager, ereqs, _, _ = serve_requests(bundle, params, scfg, prompts[:4], 64, eager=True)
    same_tokens(cfg.name, reqs[:4], ereqs)
    del eager, params
    torch.cuda.empty_cache()


#: gemma3-27b serving (phase 4c): 8 slots x 2048, prefill chunk 256; its
#: attention widths (32/16 heads, head dim 128) and its L layers' ring of
#: 1024 slots, which is their window
GEMMA = dict(B=8, Hq=32, Hkv=16, D=128, ring=1024, Smax=2048, chunk=256, window=1024)

#: 4c's C decode check at llama4's attention widths (:func:`llama4_attention`)
#: on a ring of 2 chunks: lengths in the first chunk, at and past its end,
#: in the second, at and past the ring's end (chunk 8192)
LLAMA4_C = dict(B=8, lengths=[100, 8191, 8192, 8300, 12000, 16383, 16384, 20000])


def llama4_attention():
    """llama4-maverick's attention widths from its config: {"Hq", "Hkv",
    "D", "chunk"} (40/8 heads, head dim 128, chunk 8192)."""
    from repro_torch.configs import get_config

    a = get_config("llama4-maverick-400b-a17b").attention
    return dict(Hq=a.n_heads, Hkv=a.n_kv_heads, D=a.d_head, chunk=a.chunk)


def ring_prefill_positions(offsets, new_lens, size, Sn):
    """q_pos (B, Sn) and k_pos (B, size + Sn) as the model builds them for a
    ring cache of ``size`` slots (``_ring_positions``: slot r holds the
    largest position = r mod size below the row's offset; -1 a hole), the
    chunk's entries past new_lens holes."""
    import torch
    from repro_torch.models.attention import _ring_positions

    dev = "cuda"
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    nl = torch.tensor(new_lens, dtype=torch.int32, device=dev)[:, None]
    j = torch.arange(Sn, dtype=torch.int32, device=dev)[None, :]
    q_pos = off[:, None] + j
    kpos_new = torch.where(j < nl, q_pos, -1)
    return (q_pos.contiguous(),
            torch.cat([_ring_positions(off, size), kpos_new], 1).contiguous())


def phase_ring_kernels():
    """4c (e) and the ring shapes' times: the C decode route (the prefill
    kernel with one query, masked by the positions a ring of 2 chunks
    holds) at llama4's widths against the plain version; the prefill
    kernel over a wrapped gemma3 ring (sliding window 1024) and the decode
    kernel over gemma3's L ring against theirs; the two serving kernels'
    times at gemma3's shapes beside their plain versions, SDPA and their
    bounds.  Returns ({kernel: record}, {kernel: max abs error})."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_prefill
    from repro_torch.models.attention import _ring_positions

    c = {**LLAMA4_C, **llama4_attention()}
    c["ring"] = 2 * c["chunk"]
    log(f"== phase 4c (e): C decode through the prefill kernel (one query), llama4's "
        f"widths {c['Hq']}/{c['Hkv']} heads, D {c['D']}, chunk {c['chunk']}, ring "
        f"{c['ring']}, bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(25)
    dt = torch.bfloat16
    B, Hq, Hkv, D, size = c["B"], c["Hq"], c["Hkv"], c["D"], c["ring"]
    lens = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
    q = torch.randn(B, Hq, 1, D, generator=gen, device="cuda").to(dt)
    k, v = (torch.randn(B, Hkv, size, D, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    q_pos = lens[:, None].contiguous()
    k_pos = _ring_positions(lens + 1, size)         # the new key is written first
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, q_pos, k_pos, kind="chunked", chunk=c["chunk"])
    torch.cuda.synchronize()
    want = ref.prefill_attention(q, k, v, q_pos, k_pos, kind="chunked", chunk=c["chunk"])
    errs = {"c_decode": check_close(f"C decode B{B} Hq{Hq} Hkv{Hkv} D{D} ring {size} "
                                    f"lengths {c['lengths']}", got, want, "bfloat16")}
    live = live_mask(q_pos, k_pos, "chunked", chunk=c["chunk"]).sum(-1)[:, 0]
    # the reference's rule (C1): the first lengths % chunk + 1 slots
    prefix = ref.decode_attention(q[:, :, 0], k, v, lens % c["chunk"] + 1)
    off = (prefix.float() - want[:, :, 0].float()).abs().amax((1, 2))
    log(f"  live keys a row (its own chunk): {live.tolist()}; the reference's prefix rule "
        f"would differ from the position mask by max |diff| a row {[round(float(x), 4) for x in off]}")
    if flash_prefill.launches - before != 1:
        raise AssertionError("C decode: one prefill launch expected")

    g = GEMMA
    log(f"== phase 4c: the serving kernels over gemma3-27b's L ring ({g['ring']} slots = "
        f"window) against their plain versions, and their times (bfloat16)")
    B, Hq, Hkv, D, size, Sn = g["B"], g["Hq"], g["Hkv"], g["D"], g["ring"], g["chunk"]
    copies = 4     # 4 x 67 MB of K/V > 50 MB L2
    # decode: phase 4c's first 8 prompts + 32 tokens, clamped to the ring
    lens = [min(int(n) + 32, size) for n in dense_prompts(8)[1][:B]]
    q, kv, L = decode_inputs(B, Hq, Hkv, D, size, lens, dt, gen, copies)
    got = flash_decode(q, *kv[0], L)
    torch.cuda.synchronize()
    errs["decode"] = check_close(f"decode gemma3 ring B{B} Hq{Hq} Hkv{Hkv} D{D} Smax{size} "
                                 f"lengths {lens}", got, ref.decode_attention(q, *kv[0], L),
                                 "bfloat16")
    recs = {"decode_attention": decode_record(q, kv, L)}
    del q, kv
    # prefill: one 256-token chunk a row at fills 0..1792 over the ring: rows
    # past 1024 hand the kernel a wrapped ring (out-of-order key positions)
    offs = [0, 256, 512, 768, 1024, 1280, 1536, 1792]
    q, srcs = prefill_inputs(B, Hq, Hkv, D, size, Sn, dt, gen, copies)
    q_pos, k_pos = ring_prefill_positions(offs, [Sn] * B, size, Sn)
    kw = dict(kind="sliding", window=g["window"])
    kc, vc, kn, vn = srcs[0]
    got = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn, **kw)
    torch.cuda.synchronize()
    want = ref.prefill_attention(q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2),
                                 q_pos, k_pos, **kw)
    errs["prefill"] = check_close(
        f"prefill gemma3 wrapped ring B{B} Hq{Hq} Hkv{Hkv} D{D} ring {size} Sn{Sn} fills "
        f"{offs} sliding {g['window']}", got, want, "bfloat16")
    recs["prefill_attention"] = prefill_record(q, srcs, q_pos, k_pos, **kw)
    for name, r in recs.items():
        log(f"  {name} at gemma3's shape: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, SDPA {r['library_ms']:.4f} ms ({r['bytes']} bytes, {r['flops']} flops)")
    del q, srcs, kc, vc, kn, vn, got, want
    torch.cuda.empty_cache()
    return recs, errs


def phase_gemma_full():
    """4c (a)-(d): gemma3-27b at full width and depth in bf16 (62 layers: 52
    sliding-window L layers on rings of 1024, 10 global G layers), weights
    from a seeded generator on the card, 8 slots x 2048, chunk 256.  (a)
    phase 4's 16 requests, 64 new tokens each, through the CUDA graphs: 62
    decode_attention launches a decode replay and 62 prefill_attention a
    prefill replay, finite logits; (b) the first 4 eagerly, tokens those of
    (a); (c) 8 of them under kv_host, 16 new tokens, tokens those of (a),
    the bytes a replay copies against the windows', the write-back's
    launches; (d) (a)'s requests arriving one every 2 ticks with
    preemption: ring slots spill and return, tokens those of (a), no
    capture.  Returns ((a)'s launches, (c)'s kv_stream launches)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import parse_policy
    from repro_torch.core.planner import predict
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig, Server

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    g = GEMMA
    cfg = get_config("gemma3-27b")
    codes = cfg.layer_codes()
    log(f"== phase 4c: {cfg.name} bfloat16, {cfg.n_layers} layers ({codes.count('L')} L on "
        f"rings of {g['ring']}, {codes.count('G')} G; stages {cfg.stages()}), d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"{cfg.num_params() / 1e9:.2f} B params, through the CUDA graphs")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, S, L = g["B"], g["Smax"], cfg.n_layers
    scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=g["chunk"])
    slot = int(bundle.cache_bytes_for(1, S))
    full = int(ModelBundle(dataclasses.replace(cfg, layer_pattern="G")).cache_bytes_for(1, S))
    shape = ShapeSpec("serve", S, B, "decode")
    spec = {pol: predict(bundle.decode_workload(shape), parse_policy(pol), SPEC_SYSTEM).step_s
            for pol in ("hbm_resident", "kv_host")}
    log(f"  cache: {slot} bytes a slot ({B * slot} for {B}), against {full} if every layer "
        f"kept {S} positions; the planner's decode step (spec sheet) "
        f"{spec['hbm_resident'] * 1e3:.3f} ms hbm_resident, {spec['kv_host'] * 1e3:.3f} ms "
        "kv_host")
    prompts, plens = dense_prompts(cfg.vocab)
    ring = g["ring"]
    log(f"  prompts of {min(plens)}-{max(plens)} tokens: {sum(int(n) - 1 > ring for n in plens)} "
        f"of {len(plens)} wrap the L rings in prefill, "
        f"{sum(int(n) - 1 + 64 > ring for n in plens)} by the end of decode")

    # (a) through the graphs
    t0 = time.perf_counter()
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, eng = server.stats(), server.engine
    per = copy.deepcopy(eng.graph_launches)
    if per != {"decode": {"decode_attention": L}, "prefill": {"prefill_attention": L}}:
        raise AssertionError(f"4c: launches per replay {per}")
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0,
            "flash_attention": 0, "kv_stream": 0}
    if launches != want:
        raise AssertionError(f"4c: launches {launches} != {want}")
    if eng.slot_bytes() != slot:
        raise AssertionError(f"4c: a slot is {eng.slot_bytes()} bytes, the sizing says {slot}")
    check_logits(bundle, params, server, B)
    tokens = [r.out_tokens for r in reqs]
    ewma = eng.measured_step_s
    log(f"  (a) graphs: decode step EWMA {ewma * 1e3:.2f} ms against the planner's "
        f"{spec['hbm_resident'] * 1e3:.3f} ms; finite logits; took "
        f"{time.perf_counter() - t0:.1f} s")
    del server, reqs, eng
    free()

    # (b) eagerly, the first 4 requests
    t0 = time.perf_counter()
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts[:4], 64,
                                                eager=True)
    est = eager.stats()
    if elaunches["decode_attention"] != L * est["decode_steps"]:
        raise AssertionError(f"4c eager: launches {elaunches}")
    if [r.out_tokens for r in ereqs] != tokens[:4]:
        raise AssertionError("4c (b): eager tokens differ from the graphs'")
    log(f"  (b) eager: greedy tokens identical to (a)'s for {len(ereqs)} requests; took "
        f"{time.perf_counter() - t0:.1f} s")
    del eager, ereqs
    free()

    # (c) kv_host, 8 requests, 16 new tokens
    t0 = time.perf_counter()
    hcfg = dataclasses.replace(scfg, policy="kv_host")
    server, reqs, _, hl = serve_requests(bundle, params, hcfg, prompts[:8], 16)
    st, eng = server.stats(), server.engine
    hper = eng.graph_launches
    if hper != {"decode": {"decode_attention": L, "kv_stream": L},
                "prefill": {"prefill_attention": L, "kv_stream": L}}:
        raise AssertionError(f"4c kv_host: launches per replay {hper}")
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0,
            "flash_attention": 0,
            "kv_stream": L * (st["decode_steps"] + st["prefill_dispatches"])}
    if hl != want:
        raise AssertionError(f"4c kv_host: launches {hl} != {want}")
    diff = [r.rid for r in reqs if r.out_tokens != tokens[r.rid][:16]]
    if diff:
        raise AssertionError(f"4c (c): kv_host tokens differ from (a)'s for {diff}")
    windows = eng.feed.kv.window_bytes
    dec = replay_traffic("4c kv_host decode", eng.decode)
    expect = sum(windows)
    if abs(dec["h2d"] - expect) > 0.02 * expect or dec["d2h"] != 2 * B * 4:
        raise AssertionError(f"4c kv_host decode replay: H2D {dec['h2d']} bytes (windows "
                             f"{expect}), D2H {dec['d2h']}")
    if dec["write_backs"] != L:
        raise AssertionError(f"4c kv_host decode replay: {dec['write_backs']} write-backs")
    log(f"  (c) kv_host: greedy tokens identical to (a)'s for {len(reqs)} requests; "
        f"{len(windows)} cache windows of {sorted(set(windows))} bytes ({expect} a step; "
        f"one 6-layer period a window of stage 0); a decode replay copied {dec['h2d']} "
        f"bytes H2D and {dec['d2h']} D2H in {dec['copies']} copies, {dec['wall_ms']:.2f} ms "
        f"wall; {dec['write_backs']} write-backs, {dec['write_back_ms']:.4f} ms; launches "
        f"{hl} = {hper} per replay; step EWMA {eng.measured_step_s * 1e3:.2f} ms against "
        f"the planner's {spec['kv_host'] * 1e3:.3f} ms; took {time.perf_counter() - t0:.1f} s")
    kv_launches = hl["kv_stream"]
    del server, reqs, eng
    free()

    # (d) preemption: arrivals one every 2 ticks
    t0 = time.perf_counter()
    pre = dataclasses.replace(scfg, preempt=True, preempt_wait=PREEMPT["wait"],
                              verify_spills=True)
    server = Server(bundle, pre, params, device="cuda")
    reqs = serve_arrivals(server, prompts, 64, hook=pinned_spills)
    check_preempted(f"4c (d) {cfg.name}", server, reqs, tokens, per)
    log(f"  (d) took {time.perf_counter() - t0:.1f} s")
    del server, reqs, params, bundle
    free()
    log(f"== phase 4c (a)-(d) took {time.perf_counter() - t_phase:.1f} s")
    return launches, kv_launches


#: llama4-maverick serving (phase 4d): full width (its config's) at depth
#: 4, one CCCG period (C layers 0-2 on rings of min(max_len, 2 x 8192)
#: slots, G layer 3; GShard MoE on layers 1 and 3: 128 experts top-1 + 1
#: shared), 8 slots x 2048, prefill chunk 256; (c) 2 slots x 8448 serving
#: two requests that pass the C chunk of 8192 positions (one in prefill,
#: one in decode)
LLAMA4 = dict(depth=4, B=8, Smax=2048, prefill_chunk=256,
              long_slots=2, long_max_len=8448, long_prompts=(8160, 8300), long_new=64)


def expert_bytes(cfg):
    """Bytes of one MoE layer's routed experts (w_gate, w_up, w_down), bf16."""
    m = cfg.moe
    return 3 * m.n_experts * cfg.d_model * m.d_ff_expert * 2


def phase_llama4_kernels(lens):
    """4d (e): the two serving kernels at llama4's served shapes, bf16,
    against their plain versions and timed beside SDPA and their bounds:
    the ``G`` layer's decode through ``decode_attention`` (8 rows, 40/8
    heads, a 2048-slot cache) and a ``C`` layer's decode through
    ``prefill_attention`` with one query over its ring of 2048 slots,
    masked by position (chunk 8192).  ``lens``: each row's cache fill.
    Returns ({kernel: record}, {kernel: max abs error})."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_prefill
    from repro_torch.models.attention import _ring_positions

    c = {**LLAMA4, **llama4_attention()}
    B, Hq, Hkv, D, size = c["B"], c["Hq"], c["Hkv"], c["D"], c["Smax"]
    log(f"== phase 4d (e): the serving kernels at llama4-maverick's decode shapes "
        f"(B {B}, {Hq}/{Hkv} heads, D {D}, {size} slots, fills {lens}), bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(26)
    dt = torch.bfloat16
    copies = 8     # 8 x 21 MB of live K/V > 50 MB L2
    q, kv, L = decode_inputs(B, Hq, Hkv, D, size, lens, dt, gen, copies)
    got = flash_decode(q, *kv[0], L)
    torch.cuda.synchronize()
    errs = {"decode": check_close(f"decode llama4 G B{B} Hq{Hq} Hkv{Hkv} D{D} Smax{size} "
                                  f"lengths {lens}", got, ref.decode_attention(q, *kv[0], L),
                                  "bfloat16")}
    recs = {"decode_attention": decode_record(q, kv, L)}
    # the C decode: the new key written at slot lens % size first, then one
    # query at position lens over the ring's positions
    q4 = q[:, :, None].contiguous()
    q_pos = L[:, None].contiguous()
    k_pos = _ring_positions(L + 1, size)
    kw = dict(kind="chunked", chunk=c["chunk"])
    got = flash_prefill(q4, *kv[0], q_pos, k_pos, **kw)
    torch.cuda.synchronize()
    want = ref.prefill_attention(q4, *kv[0], q_pos, k_pos, **kw)
    errs["prefill"] = check_close(f"C decode llama4 B{B} Hq{Hq} Hkv{Hkv} D{D} ring {size}",
                                  got, want, "bfloat16")
    recs["prefill_attention"] = prefill_record(
        q4, [(k, v, None, None) for k, v in kv], q_pos, k_pos, **kw)
    for name, r in recs.items():
        log(f"  {name} at llama4's decode shape: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms ({r['bytes']} bytes, "
            f"{r['flops']} flops)")
    del q, q4, kv, got, want
    torch.cuda.empty_cache()
    return recs, errs


def profile_moe(bundle, params):
    """The MoE FFN alone on layer 1's weights, bf16, device ms a call (the
    profiler's kernel records): at the decode shape (8 tokens: every
    expert gets capacity(8) = 4 rows) and at the prefill dispatch's (8 x
    256 tokens), and the three expert products alone at the decode shape
    against the bytes they read (one MoE layer's experts, once)."""
    import torch
    from repro_torch.models import moe as moe_mod

    cfg = bundle.cfg
    lp = {k: v[0] for k, v in params["stages"][0]["1C"]["moe"].items() if k != "shared"}
    lp["shared"] = {k: v[0] for k, v in params["stages"][0]["1C"]["moe"]["shared"].items()}
    gen = torch.Generator(device="cuda").manual_seed(27)
    c = LLAMA4
    out = {}
    for label, S in (("decode", 1), ("prefill", c["prefill_chunk"])):
        x = torch.randn(c["B"], S, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
        by = {}
        out[label] = time_ms(lambda xx: moe_mod.apply_moe(lp, xx, cfg.moe, cfg.act), [(x,)],
                             reps=3, iters=4, by_kernel=by)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        log(f"  apply_moe at the {label} shape ({c['B']} x {S} tokens, capacity "
            f"{moe_mod.capacity(c['B'] * S, cfg.moe)}): {out[label]:.3f} ms of device time a "
            f"call; its largest kernels " + "; ".join(f"{v:.3f} ms {k[:60]}" for k, v in top))
    C = moe_mod.capacity(c["B"], cfg.moe)
    xin = torch.randn(cfg.moe.n_experts, C, cfg.d_model, generator=gen,
                      device="cuda").to(torch.bfloat16)
    h = torch.randn(cfg.moe.n_experts, C, cfg.moe.d_ff_expert, generator=gen,
                    device="cuda").to(torch.bfloat16)

    def experts(a, b):
        torch.bmm(a, lp["w_gate"])
        torch.bmm(a, lp["w_up"])
        torch.bmm(b, lp["w_down"])

    out["experts"] = time_ms(experts, [(xin, h)], reps=3, iters=4)
    nbytes = expert_bytes(cfg)
    out["expert_bound"] = nbytes / peaks()[0] * 1e3
    log(f"  the expert products at the decode shape ({cfg.moe.n_experts} x {C} rows): "
        f"{out['experts']:.3f} ms, {nbytes / out['experts'] / 1e6:.1f} GB/s on the "
        f"{nbytes} bytes of one MoE layer's experts (bound {out['expert_bound']:.3f} ms at "
        f"{peaks()[0] / 1e12:.2f} TB/s)")
    return out


def phase_llama4_full(plens):
    """4d: llama4-maverick at full width and depth 4 (one CCCG period; 34.25
    B params, 68.5 GB in bf16 — depth 8 would be 135 GB, the full 48
    layers 399.7 B params, neither fits one card), weights drawn on the
    card from seed 0, 8 slots x 2048, chunk 256.  (a) phase 4's 16
    requests, 64 new tokens each, through the CUDA graphs: per replay 1
    decode_attention (the G layer) and 3 prefill_attention (the C layers'
    decode, one query) a decode step, 4 prefill_attention a prefill
    dispatch; finite logits; a slot's bytes against
    ``Executor.slot_bytes()``; the peak memory and the decode EWMA beside
    the planner's hbm_resident price; (d) a profiler window over decode
    steps and one over a prefill dispatch, the MoE FFN and its expert
    products timed alone; (b) the first 4 requests eagerly, tokens those
    of (a); (c) two requests past the C chunk of 8192 positions (2 slots
    x 8448) through the graphs and eagerly, tokens identical, finite
    logits.  Returns ((a)'s launches, its launches per replay, (e)'s
    kernel records and errors)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import parse_policy
    from repro_torch.core.planner import predict
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    c = LLAMA4
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"), n_layers=c["depth"])
    full = get_config("llama4-maverick-400b-a17b")
    moe = [i for i in range(cfg.n_layers) if cfg.moe.is_moe_layer(i)]
    log(f"== phase 4d: {cfg.name} bfloat16 at full width, depth {cfg.n_layers} of "
        f"{full.n_layers} (stages {cfg.stages()}; MoE on layers {moe}: "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + {cfg.moe.n_shared} shared, "
        f"d_ff {cfg.moe.d_ff_expert}; dense d_ff {cfg.moe.dense_d_ff}), d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"{cfg.num_params() / 1e9:.2f} B params ({cfg.num_params() * 2 / 1e9:.1f} GB bf16; "
        f"depth 8 {dataclasses.replace(cfg, n_layers=8).num_params() * 2 / 1e9:.1f} GB, "
        f"all {full.n_layers} layers {full.num_params() / 1e9:.1f} B params), through the "
        "CUDA graphs")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{weights / 2**30:.2f} GiB (peak while drawing "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    B, S = c["B"], c["Smax"]
    scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=c["prefill_chunk"])
    slot = int(bundle.cache_bytes_for(1, S))
    shape = ShapeSpec("serve", S, B, "decode")
    price = predict(bundle.decode_workload(shape), parse_policy("hbm_resident"),
                    SPEC_SYSTEM).step_s
    prompts, _ = dense_prompts(cfg.vocab)

    # (a) through the graphs
    t0 = time.perf_counter()
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, eng = server.stats(), server.engine
    peak = torch.cuda.max_memory_allocated()
    per = copy.deepcopy(eng.graph_launches)
    want_per = {"decode": {"decode_attention": 1, "prefill_attention": 3},
                "prefill": {"prefill_attention": 4}}
    if per != want_per or server.policy.name != "hbm_resident":
        raise AssertionError(f"4d: launches per replay {per} under {server.policy.name}")
    want = {"decode_attention": st["decode_steps"],
            "prefill_attention": 3 * st["decode_steps"] + 4 * st["prefill_dispatches"],
            "ssd_scan": 0, "flash_attention": 0, "kv_stream": 0}
    if launches != want:
        raise AssertionError(f"4d: launches {launches} != {want}")
    if eng.slot_bytes() != slot:
        raise AssertionError(f"4d: a slot is {eng.slot_bytes()} bytes, the sizing says {slot}")
    # a permuted copy of one expert leaf (10.7 GB) would show here
    if peak - weights > 4 * 2**30:
        raise AssertionError(f"4d: serving took {(peak - weights) / 2**30:.2f} GiB past the "
                             "weights")
    check_logits(bundle, params, server, B)
    tokens = [r.out_tokens for r in reqs]
    ewma = eng.measured_step_s
    tp = server.throughput()
    log(f"  (a) graphs: {slot} bytes a slot ({B * slot} for {B}); decode {tp['decode_tps']:.1f} "
        f"tok/s, prefill {tp['prefill_tps']:.1f} tok/s; decode step EWMA {ewma * 1e3:.2f} ms "
        f"against the planner's hbm_resident price {price * 1e3:.3f} ms "
        f"({ewma / price:.2f}x; it prices every expert, which the dense dispatch reads); "
        f"peak memory {peak / 2**30:.2f} GiB ({(peak - weights) / 2**30:.2f} past the "
        f"weights); finite logits; took {time.perf_counter() - t0:.1f} s")

    # (d) where the time goes
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    for i in range(B):
        # room for every retake of the profiler window (4 steps each)
        server.submit(rng.integers(0, cfg.vocab, 1024),
                      max_new_tokens=4 * trace_attempts() + 5, rid=100 + i)
    server.step()
    server.step()
    dec = profile_window("4d (d) graphs: decode step at 8 x ~1030 cached tokens",
                         server.step, 4, expected_trace(server, "decode"))
    server.run_until_done()
    toks = rng.integers(0, cfg.vocab, (B, c["prefill_chunk"])).astype(np.int32)
    offs = np.arange(0, B * c["prefill_chunk"], c["prefill_chunk"], dtype=np.int32)
    pre = profile_window("4d (d) graphs: prefill dispatch (8 x 256 tokens at fills "
                         "0..1792)", lambda: eng.dispatch_prefill(
                             toks, np.full(B, c["prefill_chunk"], np.int32), offs),
                         steps=2, expect=expected_trace(server, "prefill"))
    per_launch = {}
    for name, trace in (("prefill_attention", "prefill_mma_kernel"),
                        ("decode_attention", "decode_mma_kernel")):
        ms = sum(v[0] for k, v in dec["kernels"].items() if trace in k)
        n = sum(v[1] for k, v in dec["kernels"].items() if trace in k)
        per_launch[name] = ms / max(n, 1)
    moe_ms = profile_moe(bundle, params)
    share = len(moe) * moe_ms["decode"] / dec["busy_ms"]
    log(f"  (d) a decode step: {dec['busy_ms']:.2f} ms of device time, {dec['wall_ms']:.2f} "
        f"ms wall; the {len(moe)} MoE layers ~{len(moe) * moe_ms['decode']:.2f} ms of it "
        f"({100 * share:.1f} %, an estimate: the FFN timed alone, not read from the step's "
        f"trace); the expert products of a layer "
        f"{moe_ms['experts']:.3f} ms against their {moe_ms['expert_bound']:.3f} ms bound; "
        f"per launch: prefill_attention on a C decode (one query) "
        f"{per_launch['prefill_attention']:.4f} ms, decode_attention on the G decode "
        f"{per_launch['decode_attention']:.4f} ms; a prefill dispatch {pre['busy_ms']:.2f} ms "
        f"of device time, the MoE FFN alone {moe_ms['prefill']:.3f} ms a layer; took "
        f"{time.perf_counter() - t0:.1f} s")
    del server, reqs, eng
    free()

    # (e) the kernels at the served decode shape (phase 4's first 8 prompts
    # + 32 tokens)
    recs, errs = phase_llama4_kernels([min(int(n) + 32, S) for n in plens[:B]])

    # (b) eagerly, the first 4 requests: rows 0-3 take the capacity first
    # in every group, so their routing is (a)'s
    t0 = time.perf_counter()
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts[:4], 64,
                                                eager=True)
    est = eager.stats()
    if elaunches["decode_attention"] != est["decode_steps"]:
        raise AssertionError(f"4d eager: launches {elaunches}")
    if [r.out_tokens for r in ereqs] != tokens[:4]:
        raise AssertionError("4d (b): eager tokens differ from the graphs'")
    log(f"  (b) eager: greedy tokens identical to (a)'s for {len(ereqs)} requests; took "
        f"{time.perf_counter() - t0:.1f} s")
    del eager, ereqs
    free()

    # (c) past the C chunk: prompts of 8160 (decode crosses 8192) and 8300
    # (prefill crosses it), 64 new tokens each
    t0 = time.perf_counter()
    lcfg = ServeConfig(batch_slots=c["long_slots"], max_len=c["long_max_len"],
                       prefill_chunk=c["prefill_chunk"])
    rng = np.random.default_rng(4)
    long = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in c["long_prompts"]]
    chunk = cfg.attention.chunk
    if not all(len(p) + c["long_new"] > chunk for p in long):
        raise AssertionError("4d (c): a request stays inside the first chunk")
    runs = {}
    for eager in (False, True):
        srv, lreqs, _, _ = serve_requests(bundle, params, lcfg, long, c["long_new"],
                                          eager=eager)
        check_logits(bundle, params, srv, c["long_slots"], length=c["long_max_len"] - 40)
        runs[eager] = [r.out_tokens for r in lreqs]
        del srv, lreqs
        free()
    if runs[False] != runs[True]:
        raise AssertionError("4d (c): graph and eager tokens differ past the chunk")
    log(f"  (c) {len(long)} requests of {[len(p) for p in long]} prompt tokens + "
        f"{c['long_new']} new (past the chunk of {chunk}) on {c['long_slots']} slots x "
        f"{c['long_max_len']}: greedy tokens identical, graphs against eager; finite logits; "
        f"took {time.perf_counter() - t0:.1f} s")
    del params, bundle
    free()
    log(f"== phase 4d took {time.perf_counter() - t_phase:.1f} s")
    return launches, per, recs, errs


#: deepseek-v2 serving (phase 4e): full width (its config's: MLA with a
#: 512-wide latent and a 64-wide rope key, 128 heads) at depth 8 (layer 0
#: dense with d_ff 12288, layers 1-7 MoE: 160 experts top-6 + 2 shared),
#: 8 slots x 2048, prefill chunk 256; (b) and (c) serve the first
#: ``compare`` requests, held to a graph run of the same requests
DEEPSEEK = dict(depth=8, B=8, Smax=2048, prefill_chunk=256, compare=4)


def mla_weight_copies(bundle, params, caches, rows):
    """The copies an eager decode step makes of a full-size MLA weight
    (``w_k_b``, ``w_v_b``, ``w_q_b``, ``w_o`` of a layer, or any
    permutation of one): ``torch.profiler``'s CPU ops with their input
    shapes, the copy and clone ops whose input holds as many elements as
    one of those weights.  The products read the weights as they lie, so
    the list must be empty; and the trace must show ``w_k_b`` going into a
    ``bmm`` as it lies (else it recorded no shapes, and an empty list
    proves nothing)."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    lp = params["stages"][1]
    sizes = {name: math.prod(lp["0F"]["attn"][name].shape[1:])
             for name in ("w_k_b", "w_v_b", "w_q_b", "w_o")}
    batch = {"tokens": torch.zeros(rows, 1, dtype=torch.int32, device="cuda"),
             "lengths": torch.full((rows,), 1000, dtype=torch.int32, device="cuda")}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        bundle.decode_step(params, batch, caches)
        torch.cuda.synchronize()
    copies, read = [], False
    for e in prof.events():
        shapes = [tuple(sh) for sh in e.input_shapes or () if sh]
        if e.name == "aten::bmm":
            read |= any(math.prod(sh) == sizes["w_k_b"] for sh in shapes)
        if e.name not in ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy"):
            continue
        for shape in shapes:
            hit = [k for k, v in sizes.items() if math.prod(shape) == v]
            if hit:
                copies.append((e.name, shape, hit))
    if not read:
        raise AssertionError("4e (d): the CPU trace shows no bmm reading w_k_b: no shapes "
                             "recorded")
    return copies, sizes


def time_mla_parts(bundle, params, caches):
    """Device ms a call of layer 1's MLA attention, on a copy of its
    latent cache (8 rows x 2048 slots): a decode step's (8 queries) and a
    prefill dispatch's (8 x 256 queries at fills 0..1792), and of its MoE
    FFN at the same two shapes, each alone (``time_ms``)."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod

    cfg, c = bundle.cfg, DEEPSEEK
    lp = {k: v[0] for k, v in params["stages"][1]["0F"]["attn"].items()}
    moe = {k: v[0] for k, v in params["stages"][1]["0F"]["moe"].items() if k != "shared"}
    moe["shared"] = {k: v[0] for k, v in params["stages"][1]["0F"]["moe"]["shared"].items()}
    cache = {k: v[0].clone() for k, v in caches["stages"][1]["0F"].items()}
    gen = torch.Generator(device="cuda").manual_seed(28)
    x1 = torch.randn(c["B"], 1, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    xp = torch.randn(c["B"], c["prefill_chunk"], cfg.d_model, generator=gen,
                     device="cuda").to(torch.bfloat16)
    lengths = torch.full((c["B"],), 1500, dtype=torch.int32, device="cuda")
    chunk = c["prefill_chunk"]
    offs = torch.arange(0, c["B"] * chunk, chunk, dtype=torch.int32, device="cuda")
    new = torch.full((c["B"],), chunk, dtype=torch.int32, device="cuda")
    return {
        "mla_decode": time_ms(lambda xx: attn_mod.mla_decode(
            lp, xx, cache, lengths, cfg.attention), [(x1,)], reps=3, iters=8),
        "mla_prefill": time_ms(lambda xx: attn_mod.mla_prefill_at(
            lp, xx, cache, offs, new, cfg.attention), [(xp,)], reps=2, iters=2),
        "moe_decode": time_ms(lambda xx: moe_mod.apply_moe(moe, xx, cfg.moe, cfg.act),
                              [(x1,)], reps=3, iters=4),
        "moe_prefill": time_ms(lambda xx: moe_mod.apply_moe(moe, xx, cfg.moe, cfg.act),
                               [(xp,)], reps=3, iters=2),
    }


def phase_deepseek_full():
    """4e: deepseek-v2 at full width and depth 8 (layer 0 dense, 1-7 MoE:
    28.67 B params, 53.4 GiB in bf16; all 60 layers are 236 B), weights
    drawn on the card from seed 0, 8 slots x 2048, chunk 256.  (a) phase
    4's 16 requests, 64 new tokens each, through the CUDA graphs: MLA's
    absorbed decode and chunk prefill are cuBLAS products (no Pallas
    original, so no hand-written kernel: none launched), finite logits, a
    slot's bytes (8 layers x 2048 x 576 x 2) against
    ``Executor.slot_bytes()``, the peak memory and the decode EWMA beside
    the planner's ``hbm_resident`` price; (d) profiler windows over decode
    steps and a prefill dispatch, the MLA decode attention and the MoE FFN
    timed alone, and no copy of a full-size MLA weight in an eager decode
    step; (b) the first 4 requests eagerly and (c) under ``kv_host``, each
    held to a graph run of the same 4 requests under ``hbm_resident``."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import parse_policy
    from repro_torch.core.planner import predict
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    c = DEEPSEEK
    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, n_layers=c["depth"])
    a, m = cfg.attention, cfg.moe
    log(f"== phase 4e: {cfg.name} bfloat16 at full width, depth {cfg.n_layers} of "
        f"{full.n_layers} (stages {cfg.stages()}: layer 0 dense, d_ff {m.dense_d_ff}; MoE "
        f"on the rest: {m.n_experts} experts top-{m.top_k} + {m.n_shared} shared, d_ff "
        f"{m.d_ff_expert}), MLA: {a.n_heads} heads, latent {a.kv_lora} + rope key "
        f"{a.rope_head_dim}, q_lora {a.q_lora}; d_model {cfg.d_model}, "
        f"{cfg.num_params() / 1e9:.2f} B params ({cfg.num_params() * 2 / 2**30:.1f} GiB "
        f"bf16; all {full.n_layers} layers {full.num_params() / 1e9:.1f} B), through the "
        "CUDA graphs")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{weights / 2**30:.2f} GiB (peak while drawing "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    B, S = c["B"], c["Smax"]
    scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=c["prefill_chunk"])
    slot = cfg.n_layers * S * (a.kv_lora + a.rope_head_dim) * 2
    shape = ShapeSpec("serve", S, B, "decode")
    price = predict(bundle.decode_workload(shape), parse_policy("hbm_resident"),
                    SPEC_SYSTEM).step_s
    prompts, _ = dense_prompts(cfg.vocab)
    none = {"decode": {}, "prefill": {}}

    # (a) through the graphs
    t0 = time.perf_counter()
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, eng = server.stats(), server.engine
    peak = torch.cuda.max_memory_allocated()
    if eng.graph_launches != none or any(launches.values()):
        raise AssertionError(f"4e: MLA serving launched {launches} ({eng.graph_launches} "
                             "per replay); its products are cuBLAS's")
    if server.policy.name != "hbm_resident":
        raise AssertionError(f"4e: the planner picked {server.policy.name}")
    if eng.slot_bytes() != slot or bundle.cache_bytes_for(1, S) != slot:
        raise AssertionError(f"4e: a slot is {eng.slot_bytes()} bytes, want {slot}")
    check_logits(bundle, params, server, B)
    ewma = eng.measured_step_s
    tp = server.throughput()
    log(f"  (a) graphs: {slot} bytes a slot ({B * slot} for {B}); decode "
        f"{tp['decode_tps']:.1f} tok/s, prefill {tp['prefill_tps']:.1f} tok/s "
        f"({st['prefill_dispatches']} dispatches); decode step EWMA {ewma * 1e3:.2f} ms "
        f"against the planner's hbm_resident price {price * 1e3:.3f} ms "
        f"({ewma / price:.2f}x); peak memory {peak / 2**30:.2f} GiB "
        f"({(peak - weights) / 2**30:.2f} past the weights); no hand-written kernel "
        f"launched; finite logits; took {time.perf_counter() - t0:.1f} s")

    # (d) where the time goes
    t0 = time.perf_counter()
    copies, sizes = mla_weight_copies(bundle, params, eng.caches, B)
    if copies:
        raise AssertionError(f"4e (d): an eager decode step copies MLA weights: {copies}")
    log(f"  (d) an eager decode step copies no MLA weight (none of the copy / clone ops "
        f"in its CPU trace takes {sizes} elements)")
    rng = np.random.default_rng(1)
    for i in range(B):
        server.submit(rng.integers(0, cfg.vocab, 1024),
                      max_new_tokens=4 * trace_attempts() + 5, rid=100 + i)
    server.step()
    server.step()
    dec = profile_window("4e (d) graphs: decode step at 8 x ~1030 cached tokens",
                         server.step, 4, expected_trace(server, "decode"))
    server.run_until_done()
    toks = rng.integers(0, cfg.vocab, (B, c["prefill_chunk"])).astype(np.int32)
    offs = np.arange(0, B * c["prefill_chunk"], c["prefill_chunk"], dtype=np.int32)
    pre = profile_window("4e (d) graphs: prefill dispatch (8 x 256 tokens at fills "
                         "0..1792)", lambda: eng.dispatch_prefill(
                             toks, np.full(B, c["prefill_chunk"], np.int32), offs),
                         steps=2, expect=expected_trace(server, "prefill"))
    parts = time_mla_parts(bundle, params, eng.caches)
    n_moe = sum(cfg.moe.is_moe_layer(i) for i in range(cfg.n_layers))
    log(f"  (d) a decode step: {dec['busy_ms']:.2f} ms of device time, {dec['wall_ms']:.2f} "
        f"ms wall, {dec['launches']} launches; alone, per layer: the MLA decode "
        f"attention {parts['mla_decode']:.3f} ms (x {cfg.n_layers}: "
        f"{100 * cfg.n_layers * parts['mla_decode'] / dec['busy_ms']:.1f} % of the step), "
        f"the MoE FFN {parts['moe_decode']:.3f} ms (x {n_moe}: "
        f"{100 * n_moe * parts['moe_decode'] / dec['busy_ms']:.1f} %); estimates from the "
        f"parts timed alone.  A prefill dispatch: {pre['busy_ms']:.2f} ms of device time, "
        f"{pre['launches']} launches; alone, per layer: the MLA chunk attention "
        f"{parts['mla_prefill']:.3f} ms (x {cfg.n_layers}: "
        f"{100 * cfg.n_layers * parts['mla_prefill'] / pre['busy_ms']:.1f} %), the MoE FFN "
        f"{parts['moe_prefill']:.3f} ms (x {n_moe}: "
        f"{100 * n_moe * parts['moe_prefill'] / pre['busy_ms']:.1f} %); "
        f"took {time.perf_counter() - t0:.1f} s")
    del server, reqs, eng
    free()

    # (b) eagerly and (c) under kv_host: the first requests, each held to a
    # graph run of the same requests in the same order (routing couples a
    # step's rows through the capacity, idle rows included)
    t0 = time.perf_counter()
    sub = prompts[:c["compare"]]
    runs, ewmas = {}, {}
    for label, cfg_, eager in (
            ("graphs", scfg, False), ("eager", scfg, True),
            ("kv_host", dataclasses.replace(scfg, policy="kv_host"), False)):
        srv, sreqs, _, _ = serve_requests(bundle, params, cfg_, sub, 64, eager=eager)
        if label == "kv_host" and srv.policy.name != "kv_host":
            raise AssertionError(f"4e (c): served under {srv.policy.name}")
        runs[label] = [r.out_tokens for r in sreqs]
        ewmas[label] = srv.engine.measured_step_s
        del srv, sreqs
        free()
    for label in ("eager", "kv_host"):
        if runs[label] != runs["graphs"]:
            raise AssertionError(f"4e: {label} tokens differ from a graph run of the same "
                                 "requests")
    log(f"  (b) eager and (c) kv_host: greedy tokens identical to a graph run of the same "
        f"{len(sub)} requests; decode step EWMA graphs {ewmas['graphs'] * 1e3:.2f} ms, "
        f"eager {ewmas['eager'] * 1e3:.2f} ms, kv_host {ewmas['kv_host'] * 1e3:.2f} ms "
        f"(each MLA entry's {B * S * (a.kv_lora + a.rope_head_dim) * 2} bytes a layer "
        f"copied in and back whole each step); took {time.perf_counter() - t0:.1f} s")
    del params, bundle
    free()
    log(f"== phase 4e took {time.perf_counter() - t_phase:.1f} s")


def phase_mla_train_full():
    """6c: deepseek-v2 training at full width and depth 1 (the dense lead
    layer: MLA + a 12288-wide MLP, 0.862 B params; a MoE layer's AdamW
    state, ~63 GB, fits beside nothing else) in bf16, 4 AdamW steps of 4
    x 2048 tokens of ``SyntheticLM`` through ``make_train_step`` with remat
    ``full``: finite losses and grad norms, 2 forward and 1 backward
    attention launches a step at (192, 128), tokens/s and peak memory.
    Returns the launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    mt = MLA_TRAIN
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=mt["depth"])
    log(f"== phase 6c: training {cfg.name} bfloat16 at full width, depth {cfg.n_layers} "
        f"(stages {cfg.stages()}), {cfg.num_params() / 1e9:.3f} B params, batch {mt['B']} x "
        f"{mt['S']}, remat full, {mt['steps']} AdamW steps")
    bundle = ModelBundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(bundle, TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=3e-4, warmup_steps=2)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=mt["S"], global_batch=mt["B"]))
    flash_attention.launches = flash_attention_bwd.launches = 0
    losses, norms, times = [], [], []
    for _ in range(mt["steps"]):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, metrics = step(params, opt, None, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
    launches = {"attention_fwd_mla": flash_attention.launches,
                "attention_bwd_mla": flash_attention_bwd.launches}
    bad = [x for x in losses + norms if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"6c: non-finite losses / grad norms {bad}")
    want = {"attention_fwd_mla": 2 * cfg.n_layers * mt["steps"],
            "attention_bwd_mla": cfg.n_layers * mt["steps"]}
    if launches != want:
        raise AssertionError(f"6c: attention launches {launches} != {want}")
    steady = statistics.median(times[1:])
    log(f"  losses {losses}; grad norms {norms}; step times {[round(t, 4) for t in times]} s;"
        f" steady step {steady:.4f} s -> {mt['B'] * mt['S'] / steady:.1f} training tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; attention "
        f"launches {launches} at (192, 128), no padding")
    del params, opt, step
    torch.cuda.empty_cache()
    return launches


def sdpa_backend(fn, inputs):
    """The backend ``scaled_dot_product_attention`` picked for ``fn`` on
    ``inputs``: read from its kernels' names in the trace."""
    names = {}
    time_ms(fn, inputs, reps=1, iters=1, by_kernel=names)
    top = max(names, key=names.get)
    log(f"  SDPA's largest kernel: {top[:120]}")
    top = top.lower()
    # cuDNN's fused attention kernels carry "flash" in their names too
    for frag, backend in (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha", "efficient"),
                          ("cutlass", "efficient")):
        if frag in top:
            return backend
    return f"math (largest kernel {top[:60]})"


def phase_mla_train_times(launches, errs):
    """7c: the attention kernels at MLA's head dims (phase 6c's shape: 4 x
    128 heads x 2048, q/k 192, v 128, causal, bf16) beside their plain
    versions and SDPA, past L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    mt = MLA_TRAIN
    B, H, S, D, Dv = mt["B"], mt["H"], mt["S"], mt["D"], mt["Dv"]
    log(f"== phase 7c: training attention times at MLA's head dims ({B}, {H}, {S}, q/k {D},"
        f" v {Dv}) causal bfloat16")
    dt, isz = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(9)
    sets = [fa_inputs(B, H, H, S, S, D, dt, gen, Dv=Dv) for _ in range(2)]
    fwd_in = [(q, k, v) for q, k, v, _ in sets]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    backend = sdpa_backend(sdpa, fwd_in)
    fwd = dict(
        ms=time_ms(lambda q, k, v: flash_attention(q, k, v), fwd_in),
        plain_ms=time_ms(lambda q, k, v: ref.attention(q, k, v), fwd_in, reps=2, iters=1),
        library_ms=time_ms(sdpa, fwd_in, reps=2, iters=2),
    )
    bwd_in = []
    for q, k, v, dout in sets:
        out, lse = flash_attention(q, k, v)
        bwd_in.append((q, k, v, out, lse, dout))
    bwd_ms = time_ms(lambda *a: flash_attention_bwd(*a), bwd_in)
    q, k, v, dout = sets[0]
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    graph = ref.attention(*qkv)
    plain_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                        [()], reps=2, iters=1)
    del graph
    graph = sdpa(*qkv)
    lib_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                      [()], reps=2, iters=1)
    del graph, bwd_in, sets, fwd_in, qkv
    torch.cuda.empty_cache()
    pairs = B * H * S * (S + 1) // 2
    rows_ = B * H * S
    fwd.update(bytes=rows_ * (2 * D + 2 * Dv) * isz + rows_ * 4,
               flops=pairs * (2 * D + 2 * Dv))
    bwd = dict(ms=bwd_ms, plain_ms=plain_bwd, library_ms=lib_bwd,
               bytes=rows_ * (4 * D + 4 * Dv) * isz + rows_ * 4,
               flops=pairs * (6 * D + 4 * Dv))
    _, bf16_flops_per_s, _ = peaks()
    for name, rec in (("forward", fwd), ("backward", bwd)):
        log(f"  {name}: {rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s "
            f"({rec['flops']} flops in {rec['ms']:.4f} ms), "
            f"{rec['flops'] / bf16_flops_per_s * 1e3 / rec['ms']:.3f} of the operation bound, "
            f"{rec['ms'] / rec['library_ms']:.3f} x SDPA's {rec['library_ms']:.4f} ms "
            f"(backend {backend}); plain {rec['plain_ms']:.4f} ms")
    return [
        kernel_row(f"{name} (deepseek-v2 q/k 192, v 128)",
                   "src/repro_torch/csrc/flash_attention.cu", replaces, rec,
                   launches[name + "_mla"], errs[(name + "_mla", "bfloat16")])
        for name, rec, replaces in (
            ("attention_fwd", fwd, "src/repro/kernels/flash_attention.py:115"),
            ("attention_bwd", bwd, "src/repro/kernels/ops.py:66"),
        )
    ]


#: the serving kernels' names in a profiler trace, by wrapper name
TRACE_NAMES = {"decode_attention": "decode_mma_kernel",
               "prefill_attention": "prefill_mma_kernel", "ssd_scan": "ssd_mma_kernel",
               "flash_attention": "fa_fwd_mma_kernel"}


def expected_trace(server, graph):
    """The kernel launches one call of ``graph``'s step makes, by trace
    name: what the Executor counted at capture (None for an eager server)."""
    eng = server.engine
    if not eng.graphed:
        return None
    return {TRACE_NAMES[k]: n for k, n in eng.graph_launches[graph].items()}


def profile_decode(servers, steps=4):
    """Where a full-batch decode step's time goes: ``torch.profiler`` over
    a few steady steps of 8 fresh requests (after their admission), for
    each server (graph replays, then eager)."""
    import numpy as np

    for label, server in servers.items():
        rng = np.random.default_rng(1)
        for i in range(server.cfg.batch_slots):
            server.submit(rng.integers(0, server.bundle.cfg.vocab, 1024),
                          max_new_tokens=steps * trace_attempts() + 5, rid=100 + i)
        server.step()                       # admission + first decode
        server.step()
        profile_window(f"{label}: decode step at 8 x ~1030 cached tokens", server.step,
                       steps, expected_trace(server, "decode"))
        server.run_until_done()


def profile_prefill(servers):
    """Where a prefill dispatch's time goes: ``torch.profiler`` over one
    dispatch of 8 rows x 256 new tokens at phase 5's cache fills (0..1792),
    on each phase 4 server's caches (their requests are done): a replay of
    the prefill graph, then the eager dispatch."""
    import numpy as np

    y = YI
    rng = np.random.default_rng(6)
    for label, server in servers.items():
        toks = rng.integers(0, server.bundle.cfg.vocab, (y["B"], y["chunk"])).astype(np.int32)
        new = np.full(y["B"], y["chunk"], np.int32)
        offs = np.arange(0, y["B"] * 256, 256, dtype=np.int32)
        profile_window(f"{label}: prefill dispatch (8 x 256 tokens at fills 0..1792, "
                       "32 layers)",
                       lambda: server.engine.dispatch_prefill(toks, new, offs), steps=2,
                       expect=expected_trace(server, "prefill"))


def time_ms(fn, inputs, reps=3, iters=10, by_kernel=None):
    """Device milliseconds per call: the card's own kernel records
    (``torch.profiler``, CUPTI, through :func:`traced_window`, which keeps
    every record of the calls) summed over ``iters`` calls, median of
    ``reps``.  Host launch overhead is left out — a CUDA-event window
    around these calls would time the Python wrapper, not the card.  The
    calls cycle through ``inputs``, copies big enough that the 50 MB L2
    does not hold them, so each call finds its operands cold.  Given a dict
    ``by_kernel``, fills it with each kernel's own device ms per call, by
    the trace's name, median over the repetitions."""
    import torch

    def run():
        for i in range(iters):
            fn(*inputs[i % len(inputs)])

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    per, parts = [], {}
    for _ in range(reps):
        inside, _ = traced_window("time_ms", run)
        kernels = [e for e in inside if e.get("cat") == "kernel"]
        per.append(sum(e.get("dur", 0) for e in kernels) / 1e3 / iters)
        names = {}
        for e in kernels:
            names[e["name"]] = names.get(e["name"], 0) + e.get("dur", 0) / 1e3 / iters
        for k, v in names.items():
            parts.setdefault(k, []).append(v)
    if by_kernel is not None:
        by_kernel.update({k: statistics.median(v) for k, v in parts.items()})
    return statistics.median(per)


def decode_record(q, kv, L, kv_head=None):
    """The decode kernel at one shape: its device ms, its plain version's
    and SDPA's over the copies ``kv`` of the cache (cycled, past L2), and
    what the call must move and compute for the live keys ``L`` a row
    (``live``: their count).  ``kv_head``: every query head attends that
    one head of the cache (a replicated cache's head slice; SDPA reads
    the slice as a view)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode

    B, Hq, D = q.shape
    Hkv, Smax = kv[0][0].shape[1:3]
    dec_in = [(q, k, v, L) for k, v in kv]
    mask = (torch.arange(Smax, device="cuda")[None, :] < L[:, None])[:, None, None, :]
    heads = slice(None) if kv_head is None else slice(kv_head, kv_head + 1)
    Hkv = Hkv if kv_head is None else 1
    sd_in = [(q[:, :, None], k[:, heads], v[:, heads], mask) for k, v in kv]
    keys = int(L.clamp(0, Smax).sum())
    isz = q.element_size()
    return dict(
        ms=time_ms(lambda *a: flash_decode(*a, kv_head=kv_head), dec_in),
        plain_ms=time_ms(lambda *a: ref.decode_attention(*a, kv_head=kv_head), dec_in,
                         iters=4),
        library_ms=time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm, enable_gqa=True), sd_in),
        bytes=2 * keys * Hkv * D * isz + 2 * q.numel() * isz + L.numel() * 4,
        flops=4 * keys * Hq * D, live=keys)


def prefill_record(q, srcs, q_pos, k_pos, kv_head=None, **kw):
    """The prefill kernel at one shape (mask ``kw``): its device ms over the
    copies ``srcs`` of (cache k, v, chunk k, v), its plain version's and
    SDPA's over cache ++ chunk, and what the call must move (each live key
    once) and compute (``live``: the live (query, key) pairs).  Chunk k, v
    None: one key source (a ``C`` layer's decode, the new key already in
    its ring).  ``kv_head``: every query head attends that one head of
    both sources (the plain version and SDPA over the head's slice)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_prefill

    Hq, D = q.shape[1], q.shape[3]
    Hkv = srcs[0][0].shape[1]
    pre_in = [(q, kc, vc, q_pos, k_pos, kn, vn) for kc, vc, kn, vn in srcs]
    if kv_head is not None:
        h, Hkv = slice(kv_head, kv_head + 1), 1
        srcs = [(kc[:, h], vc[:, h], None if kn is None else kn[:, h],
                 None if vn is None else vn[:, h]) for kc, vc, kn, vn in srcs]
    cat_in = [(q, kc, vc, q_pos, k_pos) if kn is None else
              (q, torch.cat([kc, kn], 2), torch.cat([vc, vn], 2), q_pos, k_pos)
              for kc, vc, kn, vn in srcs[:2]]
    live = live_mask(q_pos, k_pos, **kw)                           # (B, Sq, Sk)
    sd_in = [(a[0], a[1], a[2], live[:, None]) for a in cat_in]
    pairs = int(live.sum())
    isz = q.element_size()
    return dict(
        ms=time_ms(lambda *a: flash_prefill(*a[:5], k_new=a[5], v_new=a[6], kv_head=kv_head,
                                            **kw), pre_in),
        plain_ms=time_ms(lambda *a: ref.prefill_attention(*a, **kw), cat_in, reps=3,
                         iters=2),
        library_ms=time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm, enable_gqa=True), sd_in),
        bytes=(2 * int(live.any(1).sum()) * Hkv * D * isz + 2 * q.numel() * isz
               + (q_pos.numel() + k_pos.numel()) * 4),
        flops=4 * pairs * Hq * D, live=pairs)


def phase_times(launches, stats, plens, errs):
    import torch
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.decode_attention import num_splits

    log("== phase 5: times at the main path's shapes (bfloat16)")
    sms = sm_count(0)
    y = YI
    B, Hq, Hkv, D, Smax, Sn = y["B"], y["Hq"], y["Hkv"], y["D"], y["Smax"], y["chunk"]
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    copies = 4   # 4 x 16.8 MB of K/V > 50 MB L2

    # decode: a mid-decode snapshot of phase 4 (first 8 prompts + 32 tokens)
    lens = [min(n + 32, Smax) for n in plens[:B]]
    dec = decode_record(*decode_inputs(B, Hq, Hkv, D, Smax, lens, dt, gen, copies))

    # prefill: one 256-token chunk per row at cache fills spread 0..1792
    offs = [0, 256, 512, 768, 1024, 1280, 1536, 1792]
    q, srcs = prefill_inputs(B, Hq, Hkv, D, Smax, Sn, dt, gen, copies)
    pre = prefill_record(q, srcs, *prefill_positions(offs, [Sn] * B, Smax, Sn))

    steps = max(stats["decode_steps"], 1)
    rows = [
        kernel_row(name, src, replaces, rec, launches[name], errs[(n, "bfloat16")])
        for name, src, replaces, rec, n in (
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:71", dec, "decode"),
            ("prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
             "src/repro/kernels/flash_attention.py:237", pre, "prefill"),
        )
    ]
    log(f"  decode_attention launches per decode step: "
        f"{launches['decode_attention'] / steps:g}")
    log(f"  decode_attention: {dec['bytes'] / dec['ms'] / 1e6:.1f} GB/s on its "
        f"{dec['live']} live keys "
        f"x {Hkv} KV heads, {rows[0]['bound_ms'] / dec['ms']:.3f} of the byte bound, "
        f"{dec['ms'] / dec['library_ms']:.2f}x SDPA; {num_splits(B, Hkv, Smax, 64, sms)} "
        f"blocks a (row, KV head) on {sms} SMs")
    log(f"  prefill_attention: {pre['flops'] / pre['ms'] / 1e9:.1f} TFLOP/s on its "
        f"{pre['live']} live (query, key) pairs x {Hq} heads, "
        f"{rows[1]['bound_ms'] / pre['ms']:.3f} of the operation bound, "
        f"{pre['ms'] / pre['library_ms']:.2f}x SDPA "
        f"({pre['flops'] / pre['library_ms'] / 1e9:.1f} TFLOP/s)")
    return rows


# ---------------------------------------------------------------------------
# training attention: checks, smoke training parity, the full run, times
# ---------------------------------------------------------------------------

def fa_live_rows(kind, kw, Sq, Sk, q_offset):
    """(Sq,) bool: query rows with at least one live key under the mask."""
    import torch

    if kind == "bidirectional":
        return torch.ones(Sq, dtype=torch.bool, device="cuda")
    qp = q_offset + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    live = qp >= kp
    if kind == "sliding":
        live &= (qp - kp) < kw["window"]
    elif kind == "chunked":
        live &= (qp // kw["chunk"]) == (kp // kw["chunk"])
    return live.any(-1)


def fa_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen, rows=None, Dv=None):
    """q, k (head dim D), v (Dv, default D) and a cotangent dout; dout is 0
    on rows without a live key (padding: the kernel gives 0 there, the
    plain version mean(V))."""
    import torch

    Dv = Dv or D
    q = torch.randn(B, Hq, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, Dv, generator=gen, device="cuda").to(dtype)
    dout = torch.randn(B, Hq, Sq, Dv, generator=gen, device="cuda").to(dtype)
    if rows is not None:
        dout = dout * rows[:, None].to(dtype)
    return q, k, v, dout


def phase_train_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    log("== phase 2b: training attention kernel, forward and backward, against "
        "the plain version and autograd through it")
    o, m = OLMO_TRAIN, MLA_TRAIN
    cases = [
        ("olmo-train", o["B"], o["Hq"], o["Hkv"], o["S"], o["S"], o["D"], 0, "causal", {}),
        ("yi-gqa", 2, 32, 4, 1024, 1024, 128, 0, "causal", {}),
        ("sliding", 2, 8, 2, 192, 320, 64, 128, "sliding", {"window": 64}),
        ("chunked", 2, 8, 2, 192, 320, 64, 128, "chunked", {"chunk": 128}),
        ("bidirectional", 2, 8, 2, 192, 320, 64, 128, "bidirectional", {}),
        ("smoke", 2, 8, 1, 64, 64, 16, 0, "causal", {}),
        ("ragged", 2, 16, 16, 1000, 1000, 128, 0, "causal", {}),
    ]
    # seamless-m4t's cross-attention (bidirectional, Sq != Sk, head dim 64)
    # at its decode (one query), prefill-chunk and training shapes against
    # 1024 frames, its encoder (Sq = Sk = 1024), and a ragged pair
    sm = SEAMLESS
    B2, H2, F2 = sm["B"], sm["H"], sm["frames"]
    cases += [
        ("cross-decode", B2, H2, H2, 1, F2, sm["D"], 0, "bidirectional", {}),
        ("cross-chunk", B2, H2, H2, sm["chunk"], F2, sm["D"], 0, "bidirectional", {}),
        ("cross-train", sm["train_B"], H2, H2, sm["train_S"], F2, sm["D"], 0,
         "bidirectional", {}),
        ("encoder", sm["train_B"], H2, H2, F2, F2, sm["D"], 0, "bidirectional", {}),
        ("cross-ragged", 2, H2, H2, 37, 1000, sm["D"], 0, "bidirectional", {}),
    ]
    # MLA's head dims (q/k 192, v 128: bf16 kernels only): phase 6c's shape
    # and a ragged one, off every tile
    mla = [("mla-train", m["B"], m["H"], m["H"], m["S"], m["S"], m["D"], 0, "causal", {}),
           ("mla-ragged", 2, 16, 16, 1000, 1000, m["D"], 0, "causal", {})]
    # phase 6f's gemma3-27b shapes (bf16: its L layers' sliding window and
    # its G layer's causal mask) and phase 6e's repro-100m shape (f32)
    g3, e2e = GEMMA_TRAIN, E2E_TRAIN
    gemma = [(f"gemma3-{kind}", g3["B"], g3["Hq"], g3["Hkv"], g3["S"], g3["S"], g3["D"], 0,
              kind, kw) for kind, kw in (("sliding", {"window": g3["window"]}),
                                         ("causal", {}))]
    by_dtype = {torch.float32: [("e2e-train", e2e["B"], e2e["Hq"], e2e["Hkv"], e2e["S"],
                                 e2e["S"], e2e["D"], 0, "causal", {})],
                torch.bfloat16: mla + gemma}
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for tag, B, Hq, Hkv, Sq, Sk, D, q_off, kind, kw in cases + by_dtype[dtype]:
            Dv = m["Dv"] if tag.startswith("mla") else D
            rows = fa_live_rows(kind, kw, Sq, Sk, q_off)
            q, k, v, dout = fa_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen, rows, Dv)
            mask = dict(kind=kind, q_offset=q_off, **kw)
            out, lse = flash_attention(q, k, v, **mask)
            grads = flash_attention_bwd(q, k, v, out, lse, dout, **mask)
            torch.cuda.synchronize()
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            want = ref.attention(*qkv, **mask)
            want_g = torch.autograd.grad(want, qkv, dout)
            shape = f"B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Sk{Sk} D{D} Dv{Dv} q_offset{q_off} {kind}"
            e_out = check_close(f"attention fwd {tag} {dn} {shape}", out,
                                want.detach(), dn, rows[None, None].expand(B, Hq, Sq))
            e_grad = max(
                check_close(f"attention bwd {name} {tag} {dn}", g, w, dn,
                            tols=GRAD_TOL)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want_g)
            )
            if tag in ("olmo-train", "mla-train"):
                suffix = "_mla" if tag == "mla-train" else ""
                errs[("attention_fwd" + suffix, dn)] = e_out
                errs[("attention_bwd" + suffix, dn)] = e_grad
            if tag in ("cross-decode", "cross-chunk", "encoder", "gemma3-sliding",
                       "gemma3-causal", "e2e-train"):
                errs[("attention_fwd_" + tag, dn)] = e_out
                errs[("attention_bwd_" + tag, dn)] = e_grad
            del q, k, v, dout, out, lse, grads, qkv, want, want_g
        torch.cuda.empty_cache()
    x = torch.zeros(1, 2, 64, m["D"], device="cuda")
    try:
        flash_attention(x, x, x[..., :m["Dv"]].contiguous())
    except ValueError as e:
        log(f"  float32 at (192, 128) refused: {e}")
    else:
        raise AssertionError("the float32 kernel took head dims (192, 128)")
    return errs


#: 3b: the card's AdamW update of llama4-smoke against the CPU's from the
#: same state.  AdamW's first step is lr x g / (|g| + eps), so an element
#: whose gradient is near its rounding noise moves by a different amount,
#: or the other way, on the other device: at most UPDATE_FLIPS of the
#: elements may differ by more than lr / 2 (1 of 427,072 did on the H100),
#: and over the others the norm of the difference is at most UPDATE_TOL of
#: the norm of the CPU's update (2.06e-3, 3.69e-4, 1.99e-4 in steps 1-3 on
#: the H100; with the moments from step 1 on, less noise is amplified)
UPDATE_FLIPS = 1e-4
UPDATE_TOL = 1e-2


def moe_routes(bundle, params, batch):
    """Each MoE layer's routing of ``batch`` in one forward pass, in layer
    order: (expert, capacity slot) per (group, token, choice), slot -1 for
    a choice the capacity drops (``moe.apply_moe``'s rule)."""
    import torch
    from repro_torch.models import moe as moe_mod

    spec, picks, plain = bundle.cfg.moe, [], moe_mod.top_k

    def recording(probs, k):
        vals, idx = plain(probs, k)
        picks.append(idx)
        return vals, idx

    moe_mod.top_k = recording
    try:
        with torch.no_grad():
            bundle.train_loss(params, batch, remat="none")
    finally:
        moe_mod.top_k = plain
    routes = []
    for idx in picks:
        g, G, K = idx.shape
        onehot = (idx[..., None] == torch.arange(spec.n_experts, device=idx.device)).long()
        pos = torch.cumsum(onehot.reshape(g, G * K, -1), 1).reshape(onehot.shape)
        slot = (pos * onehot).sum(-1) - 1
        slot = torch.where(slot < moe_mod.capacity(G, spec), slot, -1)
        routes.append((idx.cpu(), slot.cpu()))
    return routes


def update_gap(start, card, cpu, lr):
    """The card's update (``card - start``) against the CPU's (``cpu -
    start``): (elements that differ by more than lr / 2, elements, norm of
    the other elements' difference / norm of the CPU's update, largest
    difference of one element / lr)."""
    import torch
    from repro_torch.models.sharding import tree_leaves

    d2 = u2 = worst = 0.0
    big = total = 0
    for s0, a, c in zip(tree_leaves(start), tree_leaves(card), tree_leaves(cpu)):
        diff = (a.cpu() - c).double().abs()
        flip = diff > lr / 2
        d2 += float(torch.where(flip, 0.0, diff).square().sum())
        u2 += float((c - s0).double().square().sum())
        worst = max(worst, float(diff.max()))
        big += int(flip.sum())
        total += diff.numel()
    return big, total, d2 ** 0.5 / u2 ** 0.5, worst / lr


def phase_train_parity():
    import dataclasses

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    log("== phase 3b: smoke training, float32, card against CPU (llama4-maverick-smoke and "
        "deepseek-v2-smoke: MoE, its aux loss and its AdamW updates compared too; "
        "deepseek-v2-smoke's MLA through the attention kernels at (24, 16) padded to "
        "(32, 32); gemma3-27b-smoke: its L layers through the sliding mask, its G layer "
        "the causal one, launches counted by mask)")
    # step 1 starts from the same weights: the losses differ only by the
    # order of f32 sums.  Steps 2-3 start from weights that AdamW moved by
    # up to lr per element, and m / sqrt(v) turns a near-zero gradient's
    # rounding difference into a full-lr step, so their limit is looser.
    lr = 1e-3
    tcfg = TrainConfig(remat="full", optimizer=AdamWConfig(lr=lr, warmup_steps=1))

    def to(dev, tree):
        return tree_map(lambda t: t.to(dev, copy=True), tree)

    def fresh(params_cpu):
        out = {}
        for dev in ("cuda", "cpu"):
            params = to(dev, params_cpu)
            out[dev] = [params, init_opt_state(params), make_train_step(bundle, tcfg)]
        return out

    def run_step(state, dev, b):
        params, opt, step = state[dev]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt, _, m = step(params, opt, None, batch)
        state[dev][:2] = [params, opt]
        return {k: float(m[k]) for k in ("loss", "grad_norm", "aux")}

    for arch in ("olmo-1b", "yi-6b", "llama4-maverick-400b-a17b", "deepseek-v2-236b",
                 "gemma3-27b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
        batches = [next(data) for _ in range(3)]
        # MoE routing is not continuous in the weights: once AdamW has moved
        # the two devices' weights apart by rounding, a token whose expert or
        # capacity slot flips changes the gradient by a finite amount (the
        # unsynced run below counts such routings).  So a MoE model's card
        # step starts each time from the CPU's state (copied over), is held
        # at step 1's limit, and its update is held to the CPU's
        resync = cfg.moe is not None
        res = {dev: [] for dev in ("cuda", "cpu")}
        state, gaps = fresh(params_cpu), []
        before = (flash_attention.launches, flash_attention_bwd.launches)
        flash_attention.by_shape.clear()
        flash_attention_bwd.by_shape.clear()
        for b in batches:
            if resync:
                state["cuda"][:2] = [to("cuda", x) for x in state["cpu"][:2]]
                start = state["cpu"][0]
            for dev in ("cuda", "cpu"):
                res[dev].append(run_step(state, dev, b))
            if resync:
                gaps.append(update_gap(start, state["cuda"][0], state["cpu"][0], lr))
        n = (flash_attention.launches - before[0], flash_attention_bwd.launches - before[1])
        want = (2 * cfg.n_layers * 3, cfg.n_layers * 3)
        if n != want:
            raise AssertionError(f"{arch}: attention launches {n} != {want}")
        codes = cfg.layer_codes()
        if "L" in codes:            # the sliding (L) and causal (G) launches apart
            by_kind = {kind: (flash_attention.by_shape[kind, 64, 64],
                              flash_attention_bwd.by_shape[kind, 64, 64])
                       for kind in ("sliding", "causal")}
            want_kind = {kind: (2 * codes.count(c) * 3, codes.count(c) * 3)
                         for kind, c in (("sliding", "L"), ("causal", "G"))}
            if by_kind != want_kind:
                raise AssertionError(f"{arch}: launches by mask (forward, backward) "
                                     f"{by_kind} != {want_kind}")
            log(f"  {arch}-smoke: attention launches by mask (forward, backward) {by_kind}"
                f" (window {cfg.attention.window} over 64 positions)")
        lc, gc, ac = ([r[k] for r in res["cuda"]] for k in ("loss", "grad_norm", "aux"))
        lp, gp, ap = ([r[k] for r in res["cpu"]] for k in ("loss", "grad_norm", "aux"))
        for i in range(3):
            lim = 1e-5 if i == 0 or resync else 1e-3
            if (abs(lc[i] - lp[i]) > lim * abs(lp[i]) or abs(gc[i] - gp[i]) > 1e-2 * abs(gp[i])
                    or abs(ac[i] - ap[i]) > lim * max(abs(ap[i]), 1.0)):
                raise AssertionError(f"{arch} step {i + 1}: card loss {lc[i]} grad norm "
                                     f"{gc[i]} aux {ac[i]} vs CPU {lp[i]} {gp[i]} {ap[i]}")
        log(f"  {arch}-smoke: losses card {lc} cpu {lp}; grad norms card {gc} cpu {gp}"
            + (f"; aux card {ac} cpu {ap} (each card step from the CPU's state)"
               if resync else ""))
        if not resync:
            continue
        if not all(a > 0 for a in ac):
            raise AssertionError(f"{arch}: no aux loss from its MoE layers: {ac}")
        for i, (big, total, rel, worst) in enumerate(gaps):
            log(f"  {arch}-smoke step {i + 1}: card update against the CPU's from the same "
                f"state: {big} of {total} elements off by more than lr / 2 (limit "
                f"{int(UPDATE_FLIPS * total)}), the others' |difference| / |update| "
                f"{rel:.3e} (limit {UPDATE_TOL:g}); largest element {worst:.3e} lr")
        for i, (big, total, rel, _) in enumerate(gaps):
            if big > UPDATE_FLIPS * total or not rel <= UPDATE_TOL:
                raise AssertionError(f"{arch} step {i + 1}: the card's AdamW update differs "
                                     f"from the CPU's: {big} of {total} elements by more "
                                     f"than lr / 2, the others by {rel:.3e} of its norm")
        # the same 3 steps with each device on its own state: the routings
        # that differ at the start of each step, beside the grad norms
        state = fresh(params_cpu)
        for i, b in enumerate(batches):
            routes, m = {}, {}
            for dev in ("cuda", "cpu"):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                routes[dev] = moe_routes(bundle, state[dev][0], batch)
                m[dev] = run_step(state, dev, b)
            diff = [int(((ea != eb) | (sa != sb)).sum()) for (ea, sa), (eb, sb)
                    in zip(routes["cuda"], routes["cpu"])]
            gn = (m["cuda"]["grad_norm"], m["cpu"]["grad_norm"])
            log(f"  {arch}-smoke unsynced step {i + 1}: (token, choice) routings that differ "
                f"(expert or capacity slot), by MoE layer: {diff} of "
                f"{routes['cpu'][0][0].numel()} each; grad norm card {gn[0]} cpu {gn[1]} "
                f"({abs(gn[0] - gn[1]) / gn[1]:.2e} apart)")


def phase_ssm_train_parity():
    """3c: mamba2-smoke and zamba2-smoke training in float32, card against
    CPU, at phase 3b's limits; the scan's launches counted."""
    import dataclasses

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    log("== phase 3c: mamba2-smoke and zamba2-smoke training, float32, card against CPU")
    tcfg = TrainConfig(remat="full", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))
        batches = [next(data) for _ in range(3)]
        n_m = cfg.layer_codes().count("M")
        res = {}
        for dev in ("cuda", "cpu"):
            params = tree_map(lambda t: t.to(dev, copy=True), params_cpu)
            opt = init_opt_state(params)
            step = make_train_step(bundle, tcfg)
            before = (ssd_scan.launches, ssd_scan_bwd.launches)
            losses, gnorms = [], []
            for b in batches:
                batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                params, opt, _, m = step(params, opt, None, batch)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
            res[dev] = (losses, gnorms)
            if dev == "cuda":
                n = (ssd_scan.launches - before[0], ssd_scan_bwd.launches - before[1])
                if n != (2 * n_m * 3, n_m * 3):
                    raise AssertionError(f"{arch}: scan launches {n} != "
                                         f"{(2 * n_m * 3, n_m * 3)}")
        (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
        for i in range(3):
            lim = 1e-5 if i == 0 else 1e-3
            if abs(lc[i] - lp[i]) > lim * abs(lp[i]) or abs(gc[i] - gp[i]) > 1e-2 * abs(gp[i]):
                raise AssertionError(f"{arch} step {i + 1}: card loss {lc[i]} grad norm "
                                     f"{gc[i]} vs CPU {lp[i]} {gp[i]}")
        log(f"  {cfg.name}: losses card {lc} cpu {lp}; grad norms card {gc} cpu {gp}")


def phase_train_full():
    import logging

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch.train import parse_args, train

    o = OLMO_TRAIN
    cfg = get_config("olmo-1b")
    log(f"== phase 6: training {cfg.name} bfloat16, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.attention.n_heads}/{cfg.attention.n_kv_heads} heads, "
        f"batch {o['B']} x {o['S']}, remat full, {o['steps']} AdamW steps")
    logging.basicConfig(level=logging.INFO, format="  %(message)s")
    args = parse_args([
        "--arch", "olmo-1b", "--steps", str(o["steps"]), "--batch", str(o["B"]),
        "--seq", str(o["S"]), "--remat", "full", "--lr", "3e-4",
        "--ckpt-dir", str(ROOT / "build" / "ckpt-chip-smoke"),
        "--ckpt-every", "1000000", "--log-every", "1",
    ])
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": flash_attention.launches,
                "attention_bwd": flash_attention_bwd.launches}
    steps = o["steps"]
    if out["steps"] != steps or len(out["losses"]) != steps:
        raise AssertionError(f"ran {out['steps']} steps, {len(out['losses'])} losses")
    bad = [x for x in out["losses"] + out["grad_norms"] if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite losses / grad norms {bad}")
    if out["restarts"] != 0:
        raise AssertionError(f"supervisor restarted {out['restarts']} times")
    L = cfg.n_layers
    if launches != {"attention_fwd": 2 * L * steps, "attention_bwd": L * steps}:
        raise AssertionError(f"attention launches {launches}: want forward 2 x {L} x "
                             f"{steps}, backward {L} x {steps}")
    tokens = o["B"] * o["S"]
    steady = statistics.median(out["step_s"][1:])
    log(f"  {steps} steps in {wall:.2f} s (set-up included); losses {out['losses']}; "
        f"grad norms {out['grad_norms']}")
    log(f"  step times {[round(t, 4) for t in out['step_s']]} s; steady step "
        f"{steady:.4f} s -> {tokens / steady:.1f} training tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {launches}")
    return out, launches


def profile_train(out, arch="olmo-1b", B=OLMO_TRAIN["B"], S=OLMO_TRAIN["S"],
                  steps=OLMO_TRAIN["steps"], shares=()):
    """Where a training step's time goes: ``torch.profiler`` over one more
    step of a phase 6 run (its state, the next SyntheticLM batch).
    ``shares``: (label, name fragment) pairs whose kernels' summed device
    time is printed with its share of the step's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step

    cfg = get_config(arch)
    step = make_train_step(ModelBundle(cfg), TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=3e-4, warmup_steps=2)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    data.restore({"step": steps, "seed": 0})
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
    st = out["state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, m = step(st["params"], st["opt"], st["ef"], batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled step: loss {loss:.4f}, {wall * 1e3:.1f} ms wall, {busy:.1f} ms of "
        f"device time ({100 * busy / (wall * 1e3):.1f} % busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} calls  {e.key[:90]}")
    for label, frag in shares:
        part = [e for e in kernels if frag in e.key]
        ms = sum(e.self_device_time_total for e in part) / 1e3
        log(f"  {label}: {ms:.1f} ms of {busy:.1f} ms device time ({100 * ms / busy:.1f} %), "
            f"{sum(e.count for e in part)} calls of {len(part)} kernels")
    return dict(wall_ms=wall * 1e3, busy_ms=busy)


def phase_ssm_train_full():
    """6b: full-depth mamba2-780m and zamba2-1.2b training in bf16 through
    ``launch/train.py``; returns mamba2's scan launches."""
    import logging

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    from repro_torch.launch.train import parse_args, train

    logging.basicConfig(level=logging.INFO, format="  %(message)s")
    t = MAMBA_TRAIN
    B, S = t["B"], t["T"]
    result = None
    for arch, steps in (("mamba2-780m", t["steps"]), ("zamba2-1.2b", 2)):
        cfg = get_config(arch)
        codes = cfg.layer_codes()
        n_m, n_s = codes.count("M"), codes.count("S")
        log(f"== phase 6b: training {cfg.name} bfloat16, {n_m} M layers"
            f"{f' and {n_s} shared-block applications' if n_s else ''}, d_model "
            f"{cfg.d_model}, batch {B} x {S}, remat full, {steps} AdamW steps")
        args = parse_args([
            "--arch", arch, "--steps", str(steps), "--batch", str(B), "--seq", str(S),
            "--remat", "full", "--lr", "3e-4",
            "--ckpt-dir", str(ROOT / "build" / "ckpt-chip-smoke"),
            "--ckpt-every", "1000000", "--log-every", "1",
        ])
        torch.cuda.reset_peak_memory_stats()
        for fn in (ssd_scan, ssd_scan_bwd, flash_attention, flash_attention_bwd):
            fn.launches = 0
        t0 = time.perf_counter()
        out = train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ssd_scan": ssd_scan.launches, "ssd_scan_bwd": ssd_scan_bwd.launches,
                    "attention_fwd": flash_attention.launches,
                    "attention_bwd": flash_attention_bwd.launches}
        if out["steps"] != steps or len(out["losses"]) != steps:
            raise AssertionError(f"ran {out['steps']} steps, {len(out['losses'])} losses")
        bad = [v for v in out["losses"] + out["grad_norms"]
               if not v == v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"non-finite losses / grad norms {bad}")
        if out["restarts"] != 0:
            raise AssertionError(f"supervisor restarted {out['restarts']} times")
        want = {"ssd_scan": 2 * n_m * steps, "ssd_scan_bwd": n_m * steps,
                "attention_fwd": 2 * n_s * steps, "attention_bwd": n_s * steps}
        if launches != want:
            raise AssertionError(f"{arch} launches {launches} != {want}")
        steady = statistics.median(out["step_s"][1:])
        log(f"  {steps} steps in {wall:.2f} s (set-up included); losses {out['losses']}; "
            f"grad norms {out['grad_norms']}")
        log(f"  step times {[round(v, 4) for v in out['step_s']]} s; steady step "
            f"{steady:.4f} s -> {B * S / steady:.1f} training tokens/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {launches}")
        profile_train(out, arch, B, S, steps, shares=(("the scan's backward", "ssd_bwd"),))
        if result is None:
            result = launches
        del out
        torch.cuda.empty_cache()
    return result


def phase_train_times(launches, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    o = OLMO_TRAIN
    B, H, S, D = o["B"], o["Hq"], o["S"], o["D"]
    log(f"== phase 7: training attention times at ({B}, {H}, {S}, {D}) causal bfloat16")
    dt, isz = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(7)
    sets = [fa_inputs(B, H, H, S, S, D, dt, gen) for _ in range(2)]   # 2 x 128 MB > L2
    fwd_in = [(q, k, v) for q, k, v, _ in sets]
    fwd = dict(
        ms=time_ms(lambda q, k, v: flash_attention(q, k, v), fwd_in),
        plain_ms=time_ms(lambda q, k, v: ref.attention(q, k, v), fwd_in, iters=2),
        library_ms=time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), fwd_in),
    )
    bwd_in = []
    for q, k, v, dout in sets:
        out, lse = flash_attention(q, k, v)
        bwd_in.append((q, k, v, out, lse, dout))
    bwd_ms = time_ms(lambda *a: flash_attention_bwd(*a), bwd_in)
    # the plain version's and SDPA's backward alone: autograd.grad over a
    # forward taken once outside the timed window
    q, k, v, dout = sets[0]
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    graph = ref.attention(*qkv)
    plain_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                        [()], iters=2)
    del graph
    graph = F.scaled_dot_product_attention(*qkv, is_causal=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                      [()])
    del graph
    pairs = B * H * S * (S + 1) // 2
    qbytes = B * H * S * D * isz
    bwd = dict(ms=bwd_ms, plain_ms=plain_bwd, library_ms=lib_bwd,
               bytes=8 * qbytes + B * H * S * 4, flops=10 * D * pairs)
    fwd.update(bytes=4 * qbytes + B * H * S * 4, flops=4 * D * pairs)
    _, bf16_flops_per_s, _ = peaks()
    for name, rec in (("forward", fwd), ("backward", bwd)):
        log(f"  {name}: {rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s "
            f"({rec['flops']} flops in {rec['ms']:.4f} ms), "
            f"{rec['flops'] / bf16_flops_per_s * 1e3 / rec['ms']:.3f} of the operation bound, "
            f"{rec['ms'] / rec['library_ms']:.2f} x SDPA's {rec['library_ms']:.4f} ms")
    rows = []
    for name, rec, replaces in (
        ("attention_fwd", fwd, "src/repro/kernels/flash_attention.py:115"),
        ("attention_bwd", bwd, "src/repro/kernels/ops.py:66"),
    ):
        rows.append(kernel_row(name, "src/repro_torch/csrc/flash_attention.cu",
                               replaces, rec, launches[name], errs[(name, "bfloat16")]))
    return rows


# ---------------------------------------------------------------------------
# training over a pod axis (ROADMAP A8): the end-to-end trainer, compression
# and pipelining on a one-rank mesh, ring-layer training at full width
# ---------------------------------------------------------------------------

def phase_train_e2e():
    """6e: ``repro_torch.examples.train_e2e`` at full size on the card:
    repro-100m (100.07 M params, f32), 300 steps of 16 x 256 tokens, remat
    ``full``, the Supervisor's async checkpoints and the resume from the
    last one (its state bit for bit the final one).  Then, over the
    model's device gradients from one more batch: ``quantize`` /
    ``dequantize`` round-trip every leaf to within half a step, timed
    beside the bytes they must move; a one-rank NCCL group's ``pod`` mesh,
    on which ``compressed_grad_sync`` returns its inputs, 20 steps with
    ``compress_pod_grads=True`` give the losses of 20 without it bit for
    bit, and ``pipelined_forward`` equals the sequential stage loop.
    Returns the attention launches of the 300 steps."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.examples import train_e2e
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.optim import (
        compressed_grad_sync,
        dequantize,
        init_error_feedback,
        quantize,
    )
    from repro_torch.train import init_train_state, make_train_step, pipelined_forward
    from repro_torch.train.train_step import loss_and_grads

    e = E2E_TRAIN
    log(f"== phase 6e: repro_torch.examples.train_e2e on the card: repro-100m float32, "
        f"{e['steps']} steps of {e['B']} x {e['S']} tokens, remat full, async checkpoints "
        "and a resume")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches = 0
        fn.by_shape.clear()
    out = train_e2e.train(train_e2e.parse_args(["--ckpt-dir", str(ROOT / "build" / "ckpt-e2e")]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    launches = {"attention_fwd": flash_attention.launches,
                "attention_bwd": flash_attention_bwd.launches}
    ran = out["steps"] + len(out["replayed"])
    L, S = e["layers"], e["S"]
    if out["steps"] != e["steps"] or (out["cfg"].n_layers, out["batch"], out["seq"]) != (
            L, e["B"], S):
        raise AssertionError(f"6e ran {out['steps']} steps of {out['cfg'].name} at "
                             f"{out['batch']} x {out['seq']}")
    bad = [x for x in out["losses"] if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"6e: non-finite losses {bad[:5]}")
    want = {"attention_fwd": 2 * L * ran, "attention_bwd": L * ran}
    by_shape = (dict(flash_attention.by_shape), dict(flash_attention_bwd.by_shape))
    if launches != want or by_shape != ({("causal", S, S): want["attention_fwd"]},
                                        {("causal", S, S): want["attention_bwd"]}):
        raise AssertionError(f"6e: attention launches {launches} {by_shape} != {want} "
                             f"(2 forward and 1 backward a layer a step, causal {S} x {S})")
    steady = statistics.median(out["step_s"][1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = out["losses"]
    log(f"  {out['steps']} steps in {wall:.2f} s (set-up, checkpoints and the resume "
        f"included); loss {losses[0]:.4f} -> {losses[-1]:.4f} (every 50th: "
        f"{[round(x, 4) for x in losses[::50]]}); straggler stats {out['stragglers']}")
    log(f"  steady step {steady:.4f} s (median after the first; first {out['step_s'][0]:.3f}"
        f" s) -> {e['B'] * S / steady:.1f} training tokens/s; peak memory {peak:.2f} GiB; "
        f"attention launches {launches} ({ran} steps run: {len(out['replayed'])} replayed)")
    log(f"  resumed from the checkpoint of step {out['resumed']} ({out['ckpt_dir']}): "
        + (f"{len(out['replayed'])} steps replayed, losses identical" if out["replayed"]
           else "the restored state equals the final one bit for bit"))

    # compression over the model's device gradients from one more batch
    bundle, state = out["bundle"], out["state"]
    data_cfg = DataConfig(vocab=out["cfg"].vocab, seq_len=S, global_batch=e["B"],
                          structure=0.9)
    data = SyntheticLM(data_cfg)
    data.restore({"step": out["steps"], "seed": 0})
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
    _, _, grads = loss_and_grads(bundle, state["p"], batch, "full")
    leaves = tree_leaves(grads)
    worst = 0.0
    for g in leaves:
        q, s = quantize(g)
        err = float((dequantize(q, s) - g.float()).abs().max())
        if q.dtype != torch.int8 or not err <= 0.5 * float(s) * (1 + 2.0 ** -20):
            raise AssertionError(f"6e: quantize round trip off by {err} at step {float(s)}")
        worst = max(worst, err / float(s))
    n = sum(g.numel() for g in leaves)
    hbm, _, _ = peaks()
    q_ms = time_ms(lambda: [quantize(g) for g in leaves], [()], reps=3, iters=3)
    qs = [quantize(g) for g in leaves]
    dq_ms = time_ms(lambda: [dequantize(q, s) for q, s in qs], [()], reps=3, iters=3)
    log(f"  quantize/dequantize over {len(leaves)} gradient leaves ({n} f32 elements): "
        f"round trip within {worst:.6f} of a step (limit 0.5); quantize {q_ms:.4f} ms "
        f"(must move {5 * n} bytes: {5 * n / hbm * 1e3:.4f} ms at the card's memory rate), "
        f"dequantize {dq_ms:.4f} ms (the same bytes: {5 * n / hbm * 1e3:.4f} ms)")
    del qs

    store = ROOT / "build" / "pod-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        mesh = make_mesh_for((1,), ("pod",))
        ef = init_error_feedback(grads)
        synced, new_ef = compressed_grad_sync(grads, ef, mesh)
        if synced is not grads or new_ef is not ef:
            raise AssertionError("6e: compressed_grad_sync on a one-rank pod changed its inputs")
        del ef, grads, leaves
        runs = {}
        for compress in (False, True):
            tcfg = dataclasses.replace(out["tcfg"], compress_pod_grads=compress)
            params, opt, ef = init_train_state(
                bundle, torch.Generator(device="cuda").manual_seed(0), tcfg, mesh)
            step = make_train_step(bundle, tcfg, mesh)
            data = SyntheticLM(data_cfg)
            runs[compress] = []
            for _ in range(20):
                b = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
                params, opt, ef, m = step(params, opt, ef, b)
                runs[compress].append(float(m["loss"]))
            del params, opt, ef, step
        if runs[True] != runs[False]:
            raise AssertionError(f"6e: 20 steps with compress_pod_grads on a one-rank pod "
                                 f"{runs[True]} != without {runs[False]}")
        log(f"  one-rank NCCL pod mesh: compressed_grad_sync returns its inputs; 20 steps "
            f"with compress_pod_grads=True give the losses of 20 without it bit for bit "
            f"({runs[True][0]:.6f} -> {runs[True][-1]:.6f})")
        g = torch.Generator(device="cuda").manual_seed(5)
        d = out["cfg"].d_model
        ws = torch.randn(1, d, d, generator=g, device="cuda") * d ** -0.5
        xs = torch.randn(4, e["B"], d, generator=g, device="cuda")
        stage = lambda w, x: torch.tanh(x @ w)  # noqa: E731
        y = pipelined_forward(mesh, stage, ws, xs)
        seq = torch.stack([stage(ws[0], x) for x in xs])
        perr = float((y - seq).abs().max())
        if y.shape != seq.shape or perr > 1e-6:
            raise AssertionError(f"6e: pipelined_forward off the stage loop by {perr}")
        log(f"  pipelined_forward on the one-rank mesh (4 microbatches of {e['B']} x {d}): "
            f"max |difference| from the sequential stage loop {perr:.3e}"
            f"{' (bit for bit)' if torch.equal(y, seq) else ''}")
    finally:
        dist.destroy_process_group()
    del out, state, bundle
    torch.cuda.empty_cache()
    log(f"== phase 6e took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_mesh_train(phase6):
    """6g: olmo-1b as phase 6 trains it (full width and depth, 4 x 2048,
    bf16, seed 0, lr 3e-4 with a one-step warm-up, remat full), on a
    one-rank NCCL (pod, data, model) = (1, 1, 1) mesh under ZeRO-3 and
    ZeRO-1, beside phase 6's ``mesh=None`` losses and grad norms
    (``phase6``).  A step shards over no one-rank axis unless asked, so
    both run with ``one_rank=True``: the windows' gathers, the gradients'
    reduce-scatters and ZeRO-1's all-gather over the one-rank ``data``
    group, which measures their cost on one card.  Over one rank they
    compute the identity, so the losses and grad norms must equal phase
    6's bit for bit; anything else raises.  Returns the attention
    launches of both runs."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    o = OLMO_TRAIN
    cfg = get_config("olmo-1b")
    bundle, L, steps = ModelBundle(cfg), cfg.n_layers, o["steps"]
    log(f"== phase 6g: training {cfg.name} bfloat16 ({L} layers) on a one-rank NCCL "
        f"(pod, data, model) = (1, 1, 1) mesh, ZeRO-3 and ZeRO-1, batch {o['B']} x "
        f"{o['S']}, remat full, {steps} AdamW steps, beside phase 6's mesh=None run")
    t_phase = time.perf_counter()
    store = ROOT / "build" / "mesh-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    total = {"attention_fwd": 0, "attention_bwd": 0}
    try:
        mesh = make_mesh_for((1, 1, 1), ("pod", "data", "model"))
        for zero in (3, 1):
            tcfg = TrainConfig(remat="full", zero_stage=zero, policy="hbm_resident",
                               optimizer=AdamWConfig(lr=3e-4, warmup_steps=1))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params, opt, ef = init_train_state(
                bundle, torch.Generator(device="cuda").manual_seed(0), tcfg, mesh)
            step = make_train_step(bundle, tcfg, mesh, one_rank=True)
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=o["S"], global_batch=o["B"]))
            flash_attention.launches = 0
            flash_attention_bwd.launches = 0
            losses, norms, times = [], [], []
            for _ in range(steps):
                batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
                t0 = time.perf_counter()
                params, opt, ef, m = step(params, opt, ef, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                times.append(time.perf_counter() - t0)
            launches = {"attention_fwd": flash_attention.launches,
                        "attention_bwd": flash_attention_bwd.launches}
            peak = torch.cuda.max_memory_allocated() / 2**30
            if launches != {"attention_fwd": 2 * L * steps, "attention_bwd": L * steps}:
                raise AssertionError(f"6g ZeRO-{zero}: attention launches {launches}: want "
                                     f"forward 2 x {L} x {steps}, backward {L} x {steps}")
            bad = [x for x in losses + norms if not x == x or abs(x) == float("inf")]
            if bad:
                raise AssertionError(f"6g ZeRO-{zero}: non-finite losses / grad norms {bad}")
            for t in tree_leaves(params):
                if t.device.type != "cuda":
                    raise AssertionError(f"6g ZeRO-{zero}: a param on {t.device}")
            for k, n in launches.items():
                total[k] += n
            src = step.placed.get("source")
            gathered = (f"; {src.gathers} window gathers a step over {src.n_windows} "
                        f"windows ({2 * src.n_windows - 1} = forward + backward re-fetch), "
                        f"peak gathered {src.peak_bytes} bytes (largest window "
                        f"{max(src.window_bytes)})" if src is not None else "")
            same = losses == phase6["losses"] and norms == phase6["grad_norms"]
            dl = max(abs(a - b) for a, b in zip(losses, phase6["losses"]))
            dn = max(abs(a - b) / b for a, b in zip(norms, phase6["grad_norms"]))
            steady = statistics.median(times[1:])
            log(f"  ZeRO-{zero}: losses {losses}; grad norms {norms}")
            log(f"  phase 6 (mesh=None): losses {phase6['losses']}; grad norms "
                f"{phase6['grad_norms']}")
            log(f"  ZeRO-{zero} against phase 6: "
                + ("bit-identical" if same else
                   f"max |loss difference| {dl:.3e}, max relative grad-norm difference "
                   f"{dn:.3e}"))
            log(f"  ZeRO-{zero}: step times {[round(t, 4) for t in times]} s; steady step "
                f"{steady:.4f} s -> {o['B'] * o['S'] / steady:.1f} training tokens/s (phase 6: "
                f"{o['B'] * o['S'] / statistics.median(phase6['step_s'][1:]):.1f}); peak "
                f"memory {peak:.2f} GiB; attention launches {launches} "
                f"({launches['attention_fwd'] // steps} forward, "
                f"{launches['attention_bwd'] // steps} backward a step over {L} layers)"
                + gathered)
            if not same:
                raise AssertionError(
                    f"6g ZeRO-{zero}: over one rank the collectives compute the identity, "
                    f"yet the run differs from phase 6's mesh=None run: max |loss "
                    f"difference| {dl:.3e}, max relative grad-norm difference {dn:.3e}")
            if (src is None) != (zero == 1):
                raise AssertionError(f"6g ZeRO-{zero}: window source {src!r}")
            del params, opt, ef, step, m
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"== phase 6g took {time.perf_counter() - t_phase:.1f} s")
    return total


def phase_gemma_train_full():
    """6f: gemma3-27b training at full width, depth 2 with pattern ``LG``
    (one sliding-window ``L`` layer, window 1024, and one global ``G``
    layer), bf16, 4 AdamW steps of 2 x 2048 tokens of ``SyntheticLM``
    through ``make_train_step`` with remat ``full``.  Reductions: depth 2
    of 62; the pattern ``LG`` in place of the first period ``LLLLLG``,
    whose 3.887 B params need ~62 GB of params, grads and AdamW state
    before activations.  2.235 B params (~36 GB of that state, logits
    over a 262,144 vocabulary).  Finite losses and grad norms, exactly 2
    forward and 1 backward attention launches a layer a step for each mask
    kind; tokens/s and peak memory.  Returns the launches by kind."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    gt = GEMMA_TRAIN
    B, S, steps = gt["B"], gt["S"], gt["steps"]
    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=len(gt["pattern"]),
                              layer_pattern=gt["pattern"])
    if cfg.layer_codes() != gt["pattern"] or cfg.attention.window != gt["window"]:
        raise AssertionError(f"6f: layers {cfg.layer_codes()}, window {cfg.attention.window}")
    log(f"== phase 6f: training {cfg.name} bfloat16 at full width, depth {cfg.n_layers} "
        f"({cfg.layer_codes()}: sliding window {cfg.attention.window}, then global), "
        f"{cfg.num_params() / 1e9:.3f} B params, batch {B} x {S}, remat full, {steps} AdamW "
        "steps")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    opt = init_opt_state(params)
    step = make_train_step(bundle, TrainConfig(
        remat="full", optimizer=AdamWConfig(lr=3e-4, warmup_steps=2)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches = 0
        fn.by_shape.clear()
    losses, norms, times = [], [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, metrics = step(params, opt, None, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
    bad = [x for x in losses + norms if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"6f: non-finite losses / grad norms {bad}")
    launches = {kind: (flash_attention.by_shape[kind, S, S],
                       flash_attention_bwd.by_shape[kind, S, S])
                for kind in ("sliding", "causal")}
    if launches != {"sliding": (2 * steps, steps), "causal": (2 * steps, steps)} or (
            flash_attention.launches, flash_attention_bwd.launches) != (4 * steps, 2 * steps):
        raise AssertionError(f"6f: attention launches by mask (forward, backward) {launches}; "
                             "want 2 forward and 1 backward a layer a step for each")
    steady = statistics.median(times[1:])
    log(f"  losses {losses}; grad norms {norms}; step times {[round(t, 4) for t in times]} s;"
        f" steady step {steady:.4f} s -> {B * S / steady:.1f} training tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; attention launches by mask "
        f"(forward, backward) {launches}")
    del params, opt, step
    torch.cuda.empty_cache()
    log(f"== phase 6f took {time.perf_counter() - t_phase:.1f} s")
    return launches


def sdpa_call(kind, window, gqa):
    """One ``scaled_dot_product_attention`` call computing ``flash_attention``'s
    function: ``is_causal`` for the causal mask, a boolean mask for the
    sliding one (query i sees keys i - window < j <= i), the KV heads shared
    by ``enable_gqa``."""
    import torch
    import torch.nn.functional as F

    masks = {}

    def call(q, k, v):
        kw = {"enable_gqa": True} if gqa else {}
        if kind == "causal":
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)
        S = q.shape[2]
        if S not in masks:
            i = torch.arange(S, device=q.device)
            masks[S] = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=masks[S], **kw)

    return call


def phase_pod_train_times(e2e_launches, gemma_launches, errs):
    """7e: ``flash_attention`` forward and backward at phase 6f's gemma3
    shapes (2 x 32 heads x 2048, 16 KV heads, head dim 128, bf16: the
    ``L`` layer's sliding window 1024 and the ``G`` layer's causal mask)
    and phase 6e's repro-100m shape (16 x 12 heads x 256, 4 KV heads,
    head dim 64, f32), beside the plain version, SDPA (its backend named)
    and the bound: the sliding row's work is the window's only, and the
    f32 row's operation bound is at the f32 CUDA-core peak."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    g3, e2e = GEMMA_TRAIN, E2E_TRAIN
    cases = [
        ("gemma3-27b L, sliding window 1024", "gemma3-sliding", torch.bfloat16, g3,
         "sliding", g3["window"], gemma_launches["sliding"]),
        ("gemma3-27b G, causal", "gemma3-causal", torch.bfloat16, g3, "causal", 0,
         gemma_launches["causal"]),
        ("repro-100m, float32", "e2e-train", torch.float32, e2e, "causal", 0,
         (e2e_launches["attention_fwd"], e2e_launches["attention_bwd"])),
    ]
    rows = []
    for label, tag, dt, c, kind, window, (n_fwd, n_bwd) in cases:
        B, Hq, Hkv, S, D = c["B"], c["Hq"], c["Hkv"], c["S"], c["D"]
        dn = str(dt).split(".")[-1]
        log(f"== phase 7e: training attention times, {label} ({B}, {Hq}/{Hkv}, {S}, {D}) {dn}")
        isz = dt.itemsize
        gen = torch.Generator(device="cuda").manual_seed(11)
        per_set = (3 * Hq + 2 * Hkv) * B * S * D * isz
        sets = [fa_inputs(B, Hq, Hkv, S, S, D, dt, gen)
                for _ in range(max(2, -(-150 * 2**20 // per_set)))]       # past the L2
        mask = dict(kind=kind, window=window) if kind == "sliding" else dict(kind=kind)
        fwd_in = [(q, k, v) for q, k, v, _ in sets]
        sdpa = sdpa_call(kind, window, Hq != Hkv)
        backend = sdpa_backend(sdpa, fwd_in)
        fwd = dict(
            ms=time_ms(lambda q, k, v: flash_attention(q, k, v, **mask), fwd_in),
            plain_ms=time_ms(lambda q, k, v: ref.attention(q, k, v, **mask), fwd_in,
                             reps=2, iters=2),
            library_ms=time_ms(sdpa, fwd_in, reps=2, iters=4),
        )
        bwd_in = []
        for q, k, v, dout in sets:
            out, lse = flash_attention(q, k, v, **mask)
            bwd_in.append((q, k, v, out, lse, dout))
        bwd_ms = time_ms(lambda *a: flash_attention_bwd(*a, **mask), bwd_in)
        q, k, v, dout = sets[0]
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        graph = ref.attention(*qkv, **mask)
        plain_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                            [()], reps=2, iters=1)
        del graph
        graph = sdpa(*qkv)
        lib_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout, retain_graph=True),
                          [()], reps=2, iters=1)
        del graph, bwd_in, sets, fwd_in, qkv, q, k, v, dout
        torch.cuda.empty_cache()
        live = torch.arange(S, dtype=torch.float64) + 1                  # keys a query row sees
        if kind == "sliding":
            live = live.clamp(max=window)
        pairs = int(B * Hq * live.sum())
        qb, kvb = B * Hq * S * D * isz, B * Hkv * S * D * isz
        fwd.update(bytes=2 * qb + 2 * kvb + B * Hq * S * 4, flops=4 * D * pairs, dtype=dn)
        bwd = dict(ms=bwd_ms, plain_ms=plain_bwd, library_ms=lib_bwd, dtype=dn,
                   bytes=4 * qb + 4 * kvb + B * Hq * S * 4, flops=10 * D * pairs)
        hbm, bf16_peak, f32_peak = peaks()
        peak = bf16_peak if dt == torch.bfloat16 else f32_peak
        for name, rec in (("forward", fwd), ("backward", bwd)):
            log(f"  {name}: {rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s ({rec['flops']} flops "
                f"over the {'window' if kind == 'sliding' else 'causal triangle'} in "
                f"{rec['ms']:.4f} ms), {rec['flops'] / peak * 1e3 / rec['ms']:.3f} of the "
                f"{dn} operation bound, {rec['ms'] / rec['library_ms']:.3f} x SDPA's "
                f"{rec['library_ms']:.4f} ms (backend {backend}); plain {rec['plain_ms']:.4f} ms")
        rows += [
            kernel_row(f"{name} ({label})", "src/repro_torch/csrc/flash_attention.cu",
                       replaces, rec, n, errs[(f"{name}_{tag}", dn)])
            for name, rec, replaces, n in (
                ("attention_fwd", fwd, "src/repro/kernels/flash_attention.py:115", n_fwd),
                ("attention_bwd", bwd, "src/repro/kernels/ops.py:66", n_bwd),
            )
        ]
    return rows


# ---------------------------------------------------------------------------
# Mamba-2 serving: the SSD scan kernel, smoke parity, the full runs, times
# ---------------------------------------------------------------------------

def ssd_inputs(B, T, H, P, N, dtype, gen, state=True):
    """x, dt (softplus, scaled), A (negative), B, C and an initial state
    whose entries are O(1), as a serving cache's are."""
    import torch
    import torch.nn.functional as F

    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x = (r(B, T, H, P) * 0.5).to(dtype)
    dt = F.softplus(r(B, T, H) - 1.0) * 0.5
    A = -torch.exp(r(H) * 0.5)
    Bm, Cm = (r(B, T, N) * 0.5).to(dtype), (r(B, T, N) * 0.5).to(dtype)
    h0 = r(B, H, P, N) if state else None
    return x, dt, A, Bm, Cm, h0


def check_state(name, got, want):
    """The f32 state within 1e-4 x the leaf's max |value|."""
    import torch

    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max())
    log(f"  {name}: max_abs_err {err:.3e} (limit {lim:.3e} = 1e-4 x max |want|)")
    if not bool(torch.isfinite(got).all()) or err > lim:
        raise AssertionError(f"{name}: state error {err} over {lim}")
    return err


def phase_ssd_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    log("== phase 8a: the SSD scan kernel against its plain versions on the card")
    m, z = MAMBA, ZAMBA
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases = [
            ("mamba2", m["B"], m["T"], m["H"], m["P"], m["N"]),
            ("zamba2", 4, m["T"], z["H"], z["P"], z["N"]),
            ("T1", 3, 1, m["H"], m["P"], m["N"]),
            ("T100", 2, 100, m["H"], m["P"], m["N"]),
            ("T257", 2, 257, z["H"], z["P"], z["N"]),
        ]
        for tag, B, T, H, P, N in cases:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(B, T, H, P, N, dtype, gen)
            if tag == "mamba2":
                # rows 1..: dt is 0 past a per-row length (a prefill chunk's
                # dead tail); row 0: dt is 0 throughout (an idle slot)
                lens = torch.tensor([0, 256, 255, 1, 100, 37, 200, 129],
                                    device="cuda")[:, None, None]
                dt = torch.where(torch.arange(T, device="cuda")[None, :, None] < lens,
                                 dt, 0.0)
            shape = f"B{B} T{T} H{H} P{P} N{N}"
            y, h = ssd_scan(x, dt, A, Bm, Cm, init_state=h0, return_state=True)
            torch.cuda.synchronize()
            chunk = 64 if T % 64 == 0 else T
            want_y, want_h = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                          init_state=h0, return_state=True)
            e = check_close(f"ssd_scan y {tag} {dn} {shape}", y, want_y, dn,
                            tols=SSD_TOL)
            check_state(f"ssd_scan state {tag} {dn}", h, want_h)
            if tag == "mamba2":
                errs[("ssd_scan", dn)] = e
                if not torch.equal(h[0], h0[0]):
                    raise AssertionError("the dt == 0 row's state is not its "
                                         "initial state bit for bit")
                log("  dt == 0 row: final state == initial state, bit for bit")
                seq = ref.ssd_scan_sequential(x, dt, A, Bm, Cm, init_state=h0)
                check_close(f"ssd_scan y {tag} {dn} vs the literal recurrence",
                            y, seq, dn, tols=SSD_TOL)
                # the state written in place into the initial-state buffer
                buf = h0.clone()
                y2, _ = ssd_scan(x, dt, A, Bm, Cm, init_state=buf,
                                 return_state=True, state_out=buf)
                torch.cuda.synchronize()
                if not (torch.equal(buf, h) and torch.equal(y2, y)):
                    raise AssertionError("in-place state differs from a fresh buffer")
                log("  state written in place == state in a fresh buffer")
            del x, dt, A, Bm, Cm, h0, y, h, want_y, want_h
    return errs


#: the SSD scan's gradients against ref.ssd_scan_bwd, each leaf at rel x
#: its largest |value| (tests/test_kernels.py:96's f32 and bf16 limits)
SSD_GRAD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}

#: Mamba-2 training path (mamba2-780m: batch 4 x 2048 tokens)
MAMBA_TRAIN = dict(B=4, T=2048, steps=4)


def check_scaled(name, got, want, rel):
    """|got - want| <= rel x max |want| + rel |want|, elementwise."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = float(w.abs().max())
    bad = err > rel * scale + rel * w.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"  {name}: max_abs_err {max_err:.3e} (limit {rel} x max |want| "
        f"{scale:.3e} + {rel} |want|)")
    if not bool(torch.isfinite(g).all()) or bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance")
    return max_err


def phase_ssd_bwd_kernels():
    """8f: the backward kernel against ref.ssd_scan_bwd; its time at the
    mamba2-780m training shape.  Returns (timing record, max abs error of
    the bf16 training-shape check)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import BWD_CHUNK, bwd_scratch_bytes, ssd_scan_bwd

    m, z, t = MAMBA, ZAMBA, MAMBA_TRAIN
    log("== phase 8f: the SSD scan's backward kernel against autograd through the "
        "plain scan on the card")
    gen = torch.Generator(device="cuda").manual_seed(17)
    names = ("dx", "ddt", "dA", "dB", "dC", "d_init")
    cases = [   # tag, B, T, H, P, N, initial state, final-state gradient
        ("smoke", 2, 64, 4, 32, 16, False, False),
        ("chunks", 2, 256, 6, m["P"], m["N"], True, True),
        ("T100", 2, 100, m["H"], m["P"], m["N"], True, False),
        ("T257", 2, 257, 8, z["P"], z["N"], False, True),
        ("chunk-1", 2, BWD_CHUNK - 1, 8, m["P"], m["N"], True, True),
        ("chunk+1", 2, BWD_CHUNK + 1, 8, m["P"], m["N"], False, False),
        ("mamba2-train", t["B"], t["T"], m["H"], m["P"], m["N"], False, False),
        ("zamba2-train", t["B"], t["T"], z["H"], z["P"], z["N"], False, False),
    ]
    err = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for tag, B, T, H, P, N, state, dstate in cases:
            x, dt, A, Bm, Cm, h0 = ssd_inputs(B, T, H, P, N, dtype, gen, state=state)
            dy = torch.randn(B, T, H, P, generator=gen, device="cuda").to(dtype)
            dh = torch.randn(B, H, P, N, generator=gen, device="cuda") if dstate else None
            got = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, init_state=h0, d_state_out=dh)
            torch.cuda.synchronize()
            want = ref.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=64 if T % 64 == 0 else T,
                                    init_state=h0, d_state_out=dh)
            shape = (f"B{B} T{T} H{H} P{P} N{N}{' init_state' if state else ''}"
                     f"{' d_state_out' if dstate else ''}")
            errs = [check_scaled(f"ssd_scan_bwd {n} {tag} {dn} {shape}", g, w,
                                 SSD_GRAD_TOL[dn])
                    for n, g, w in zip(names, got, want) if w is not None]
            if tag == "mamba2-train" and dn == "bfloat16":
                err = max(errs)
                again = ssd_scan_bwd(x, dt, A, Bm, Cm, dy)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])):
                    raise AssertionError("ssd_scan_bwd: a rerun is not bit-identical")
                log("  two calls: every gradient bit-identical")
            del x, dt, A, Bm, Cm, h0, dy, dh, got, want
        torch.cuda.empty_cache()

    B, T, H, P, N = t["B"], t["T"], m["H"], m["P"], m["N"]
    sets = []
    for _ in range(2):   # 2 x (x, dy: 100 MB) > L2
        x, dt, A, Bm, Cm, _ = ssd_inputs(B, T, H, P, N, torch.bfloat16, gen, state=False)
        sets.append((x, dt, A, Bm, Cm,
                     torch.randn(B, T, H, P, generator=gen, device="cuda").bfloat16()))
    passes = {}
    kern = time_ms(lambda *a: ssd_scan_bwd(*a), sets, by_kernel=passes)
    plain = time_ms(lambda *a: ref.ssd_scan_bwd(*a, chunk=64), sets, iters=2)
    nbytes = (3 * B * T * H * P * 2          # x, dy read, dx written (bf16)
              + 2 * B * T * H * 4 + 2 * H * 4  # dt, ddt, A, dA (f32)
              + 4 * B * T * N * 2)           # B, C read, dB, dC written (bf16)
    # the least work, the chunked algorithm at 32 positions (a longer chunk
    # only adds products): the state pass's two updates (2 P N a position),
    # the chunk pass's g·B, dy·h_s and x·G_e (3 P N) and its four 32-wide
    # products (dy·xᵀ, Mᵀ·dy, W·B, Wᵀ·C); the bytes bound the call
    flops = 2 * B * H * T * (5 * P * N + 2 * 32 * (P + N))
    scratch = bwd_scratch_bytes(B, T, H, P, N, torch.bfloat16)
    floor = nbytes + 2 * scratch       # the design's own: its scratch written and read once
    hbm = peaks()[0]
    log(f"  ssd_scan_bwd at B{B} T{T} H{H} P{P} N{N} bf16: kernel {kern:.4f} ms, plain "
        f"{plain:.4f} ms; {nbytes} bytes, {flops} flops "
        f"({flops / kern / 1e9:.1f} TFLOP/s)")
    for name in sorted(passes, key=lambda k: -passes[k]):
        log(f"    {passes[name]:.4f} ms a call  {name[:90]}")
    log(f"  scratch {scratch} bytes a call (chunk states and end-state gradients, bf16, "
        f"chunks of {BWD_CHUNK}); the design's byte floor {floor} bytes = "
        f"{floor / hbm * 1e3:.4f} ms at {hbm / 1e12:.2f} TB/s, beside the function's "
        f"{nbytes / hbm * 1e3:.4f} ms")
    del sets
    torch.cuda.empty_cache()
    return dict(ms=kern, plain_ms=plain, library_ms=None, bytes=nbytes, flops=flops), err


def phase_ssm_parity():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.serve import Request, ServeConfig, Server

    log("== phase 8b: mamba2-smoke and zamba2-smoke float32, card against CPU")
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        rng = np.random.default_rng(2)
        # 2 slots, 5 requests: the 1-token prompt lands in a reused slot
        prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
                   for n in (9, 14, 1, 6, 11)]
        tokens = {}
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            server = Server(bundle, ServeConfig(batch_slots=2, max_len=64,
                                                prefill_chunk=4), params, device=dev)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            server.add_requests(reqs)
            server.run_until_done(max_steps=300)
            assert all(r.done and len(r.out_tokens) == 6 for r in reqs), dev
            tokens[dev] = {r.rid: r.out_tokens for r in reqs}
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{arch}: card/CPU greedy tokens differ: {tokens}")
        log(f"  {cfg.name}: greedy tokens identical for {len(prompts)} requests: "
            f"{tokens['cuda']}")


def serve_full(arch, n_requests, max_prompt, new_tokens):
    """Serve ``n_requests`` greedy requests (prompts of 128..max_prompt
    tokens, numpy seed 0) through full-width, full-depth ``arch`` in bf16 on
    ServeConfig(8, 2048, 256), through the CUDA graphs and then eagerly on
    the same weights: greedy tokens identical for every request."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    cfg = get_config(arch)
    bundle = ModelBundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  weights drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    m = MAMBA
    scfg = ServeConfig(batch_slots=m["B"], max_len=2048, prefill_chunk=m["T"])
    prompts = ssm_prompts(cfg.vocab, n_requests, max_prompt)
    plens = [len(p) for p in prompts]
    log(f"  prompts {min(plens)}-{max(plens)} tokens, {new_tokens} new each")
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, new_tokens)
    check_logits(bundle, params, server, m["B"])
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts, new_tokens,
                                                eager=True)
    same_tokens(cfg.name, reqs, ereqs)
    return server, eager, params, launches, elaunches, [r.out_tokens for r in reqs]


def ssm_prompts(vocab, n_requests, max_prompt):
    """Phases 8c/8d's requests: prompts of 128..max_prompt tokens, numpy
    seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(128, max_prompt + 1, size=n_requests)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in plens]


def phase_mamba_full():
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-780m")
    s = cfg.ssm
    log(f"== phase 8c: {cfg.name} bfloat16, {cfg.n_layers} M layers, d_model "
        f"{cfg.d_model}, {s.n_heads(cfg.d_model)} SSD heads x P {s.head_dim}, "
        f"N {s.d_state}, vocab {cfg.vocab}, through the CUDA graphs, then eager")
    server, eager, params, launches, elaunches, tokens = serve_full("mamba2-780m", 16,
                                                                   1536, 64)
    L = cfg.n_layers
    for label, srv, ln in (("graphs", server, launches), ("eager", eager, elaunches)):
        want = {"ssd_scan": L * srv.stats()["prefill_dispatches"],
                "decode_attention": 0, "prefill_attention": 0, "flash_attention": 0,
                "kv_stream": 0}
        if ln != want:
            raise AssertionError(f"{label}: launches {ln} != {want}")
    return server, eager, params, launches, tokens


def phase_zamba_full():
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-1.2b")
    codes = cfg.layer_codes()
    log(f"== phase 8d: {cfg.name} bfloat16, {codes.count('M')} M layers and "
        f"{codes.count('S')} applications of one shared attention block "
        f"({cfg.attention.n_heads} x {cfg.attention.d_head} heads over width "
        f"{2 * cfg.d_model}), d_model {cfg.d_model}, through the CUDA graphs, then eager")
    server, eager, params, launches, elaunches, _ = serve_full("zamba2-1.2b", 8, 1024, 32)
    n_m, n_s = codes.count("M"), codes.count("S")
    for label, srv, ln in (("graphs", server, launches), ("eager", eager, elaunches)):
        st = srv.stats()
        want = {"ssd_scan": n_m * st["prefill_dispatches"],
                "prefill_attention": n_s * st["prefill_dispatches"],
                "decode_attention": n_s * st["decode_steps"], "flash_attention": 0,
                "kv_stream": 0}
        if ln != want:
            raise AssertionError(f"zamba2 {label} launches {ln} != {want}")
    del server, eager, params
    torch.cuda.empty_cache()


def profile_window(label, fn, steps, expect=None):
    """The card's own records of ``steps`` calls of ``fn``
    (:func:`traced_window`, which keeps every record of the calls): wall
    and device time per call, the busy share, the kernels and copies that
    take the device time.  ``expect`` maps a kernel's trace name to its
    launches per call: the trace must show exactly that many (a graph's
    launches confirmed from the card's own records).  A retake calls
    ``fn`` ``steps`` more times."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(steps):
            fn()

    inside, wall = traced_window(label, run)
    wall /= steps
    kernels = {}
    for e in inside:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms, count = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (ms + e.get("dur", 0) / 1e3, count + 1)
    busy = sum(ms for ms, _ in kernels.values()) / steps
    n = sum(count for _, count in kernels.values()) // steps
    log(f"  {label}: {wall * 1e3:.2f} ms wall, {busy:.2f} ms of device time "
        f"({100 * busy / (wall * 1e3):.1f} % busy), {n} kernel launches per call")
    for name, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {ms / steps:8.3f} ms/call {count // steps:5d} launches/call  {name[:90]}")
    for name, per_call in (expect or {}).items():
        seen = sum(count for key, (_, count) in kernels.items() if name in key)
        if seen != per_call * steps:
            raise AssertionError(f"{label}: the trace shows {seen} {name} launches, "
                                 f"the graph counted {per_call} x {steps} calls")
        log(f"    trace confirms {name}: {seen} launches = {per_call} per replay x {steps}")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, launches=n,
                kernels={key: (ms / steps, count // steps)
                         for key, (ms, count) in kernels.items()})


def phase_ssd_times(servers, launches, errs):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.ssd_scan import heads_per_block, ssd_scan

    m = MAMBA
    B, T, H, P, N = m["B"], m["T"], m["H"], m["P"], m["N"]
    log(f"== phase 8e: ssd_scan times at (B {B}, T {T}, H {H}, P {P}, N {N}) bfloat16, "
        "and mamba2-780m profile windows")
    gen = torch.Generator(device="cuda").manual_seed(13)
    sets = [ssd_inputs(B, T, H, P, N, torch.bfloat16, gen) for _ in range(4)]  # > L2
    kern = time_ms(lambda x, dt, A, Bm, Cm, h0: ssd_scan(
        x, dt, A, Bm, Cm, init_state=h0, return_state=True, state_out=h0), sets)
    plain = time_ms(lambda x, dt, A, Bm, Cm, h0: ref.ssd_scan(
        x, dt, A, Bm, Cm, chunk=T, init_state=h0, return_state=True), sets, iters=2)
    nbytes = (2 * B * T * H * P * 2          # x read, y written (bf16)
              + 2 * B * H * P * N * 4        # state in and out (f32)
              + B * T * H * 4 + H * 4        # dt, A (f32)
              + 2 * B * T * N * 2)           # B, C (bf16)
    Q = 32   # the kernel's chunk: C·Bᵀ and the masked product, h·C, the state update
    flops = 2 * B * H * T * (Q * (N + P) + 2 * P * N)
    rec = dict(ms=kern, plain_ms=plain, library_ms=None, bytes=nbytes, flops=flops)
    row = kernel_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:90", rec, launches["ssd_scan"],
                     errs[("ssd_scan", "bfloat16")])
    hb = heads_per_block(B, H, P, sm_count(0))
    log(f"  ssd_scan: {nbytes / kern / 1e6:.1f} GB/s, {row['bound_ms'] / kern:.3f} of the "
        f"byte bound, {flops / kern / 1e9:.1f} TFLOP/s; {hb} heads a block, "
        f"{B * -(-H // hb)} blocks on {sm_count(0)} SMs")
    del sets

    # profile windows: one prefill dispatch (8 rows x 256 new tokens at
    # offset 0) and decode steps (8 rows), on the phase 8c servers' caches:
    # graph replays, then eager
    rng = np.random.default_rng(13)
    for label, server in servers.items():
        eng = server.engine
        toks = rng.integers(0, server.bundle.cfg.vocab, (B, T)).astype(np.int32)
        full, zeros = np.full(B, T, np.int32), np.zeros(B, np.int32)
        profile_window(f"{label}: prefill dispatch (8 x 256 tokens, 48 layers)",
                       lambda: eng.dispatch_prefill(toks, full, zeros), steps=2,
                       expect=expected_trace(server, "prefill"))
        profile_window(f"{label}: decode step (8 rows, 48 layers)", eng.decode, steps=4,
                       expect=expected_trace(server, "decode"))
    return row


# ---------------------------------------------------------------------------
# the paper's single-GPU study: the GEMM kernel, the memory benchmarks,
# calibration
# ---------------------------------------------------------------------------

def gemm_inputs(M, N, K, dtype, gen):
    import torch

    a = torch.randn(M, K, generator=gen, device="cuda")
    b = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    return a.to(dtype), b.to(dtype)


def study_ms(fn, repeats=10):
    """Milliseconds per call of ``fn`` on the card by the study's own method
    (``repro_torch.core.membench.measure``: CUDA events around each call
    after warm-up, the calls queued behind a spin kernel so each event pair
    spans the card's time), mean of ``repeats``.  Phase 9 times its rows
    this way: on an H100 80GB HBM3 at 700 W, ``torch.profiler`` put a 1 GiB
    read at 0.2824 ms, 3.80 TB/s, faster than its HBM can deliver."""
    from repro_torch.core.membench import measure

    return measure(fn, warmup=2, repeats=repeats, device="cuda").mean_s * 1e3


def phase_gemm_kernel():
    """9a: blocked_matmul against ref.matmul at the reference test's three
    shapes and tilings (the best supported tiling where the reference's
    has no f32 instantiation), 4096^3 in both output dtypes and a
    non-square shape, in bf16 and f32; a missing tiling must raise."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.blocked_matmul import best_tiling, blocked_matmul, supported

    log("== phase 9a: blocked_matmul against its plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(17)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        isz = dtype.itemsize
        cases = [
            (256, 128, 512, (128, 128, 128), torch.float32),
            (128, 128, 128, (128, 128, 128), torch.float32),
            (512, 256, 256, (256, 128, 256), torch.float32),
            (4096, 4096, 4096, None, torch.float32),
            (4096, 4096, 4096, None, torch.bfloat16),
            (1536, 640, 2304, None, dtype),
        ]
        for M, N, K, tiling, out in cases:
            if tiling is None or not supported(*tiling, isz):
                tiling = best_tiling(M, N, K, itemsize=isz)
            a, b = gemm_inputs(M, N, K, dtype, gen)
            got = ops.matmul(a, b, out_dtype=out, bm=tiling[0], bn=tiling[1],
                             bk=tiling[2])
            torch.cuda.synchronize()
            on = str(out).split(".")[-1]
            check_close(f"blocked_matmul {dn}->{on} ({M}, {N}, {K}) tiling {tiling}",
                        got, ref.matmul(a, b, out_dtype=out), on, tols=GEMM_TOL)
        a, b = gemm_inputs(512, 256, 512, dtype, gen)
        for bad in ((64, 64, 64), (256, 128, 256) if isz == 4 else (128, 256, 32)):
            before = blocked_matmul.launches
            try:
                blocked_matmul(a, b, bm=bad[0], bn=bad[1], bk=bad[2])
            except ValueError as e:
                if blocked_matmul.launches != before:
                    raise AssertionError("a refused tiling launched") from e
                log(f"  {dn} tiling {bad} refused: {str(e)[:60]}...")
            else:
                raise AssertionError(f"tiling {bad} has no instantiation but ran")


def phase_gemm_study():
    """9b: the GEMM study through bench_gemm (N = 16384 bf16, N = 8192 f32),
    launches counted; then every call it timed (each tiling, on its own
    inputs) against the plain version, and the kernel's times at N = 16384
    bf16 beside the plain version's, torch.matmul's and the bound."""
    import torch
    from repro_torch.benchmarks import bench_gemm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.blocked_matmul import best_tiling, blocked_matmul

    log("== phase 9b: the GEMM study (bench_gemm) on the card")
    blocked_matmul.launches = 0
    t0 = time.perf_counter()
    study = bench_gemm.main("cuda")
    torch.cuda.synchronize()
    launches = blocked_matmul.launches
    log(f"  bench_gemm took {time.perf_counter() - t0:.1f} s; blocked_matmul "
        f"launches {launches}")
    if launches == 0:
        raise AssertionError("bench_gemm ran no blocked_matmul kernel")
    for r in study:
        if r["N"] == GEMM_N and r["dtype"] == "bfloat16":
            who = "torch.matmul" if r["tiling"] is None else f"blocked_matmul {r['tiling']}"
            log(f"  N = {GEMM_N} bf16 {who}: {r['us_per_call'] / 1e3:.4f} ms, "
                f"{r['tflops']:.1f} TFLOP/s")

    dev = torch.device("cuda")
    err = 0.0
    for N, dtype in bench_gemm.SIZES["cuda"]:
        dn = str(dtype).split(".")[-1]
        a, b = bench_gemm.inputs(N, dtype, dev)
        want = ref.matmul(a, b)
        for bm, bn, bk in bench_gemm.tilings(N, dtype.itemsize):
            got = ops.matmul(a, b, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            err = max(err, check_close(f"bench_gemm's blocked_matmul {dn} ({N}, {N}, {N}) "
                                       f"tiling {(bm, bn, bk)}", got, want, dn,
                                       tols=GEMM_TOL))
            del got
        del want
        if N == GEMM_N and dtype == torch.bfloat16:
            log(f"  blocked_matmul at the study's shape, default tiling "
                f"{best_tiling(N, N, N)}")
            kern = study_ms(lambda: ops.matmul(a, b), repeats=5)
            plain = study_ms(lambda: ref.matmul(a, b), repeats=3)
            lib = study_ms(lambda: torch.matmul(a, b), repeats=5)
        del a, b
        torch.cuda.empty_cache()
    N = GEMM_N
    rec = dict(ms=kern, plain_ms=plain, library_ms=lib, bytes=3 * N * N * 2,
               flops=2 * N ** 3)
    row = kernel_row("blocked_matmul", "src/repro_torch/csrc/blocked_matmul.cu",
                     "src/repro/kernels/blocked_matmul.py:48", rec, launches, err)
    log(f"  blocked_matmul {2 * N ** 3 / kern / 1e9:.1f} TFLOP/s, torch.matmul "
        f"{2 * N ** 3 / lib / 1e9:.1f} TFLOP/s")
    return row


def phase_membench():
    """9c: bench_membw, bench_copy, bench_latency and
    bench_managed_vs_system on device memory and pinned host memory, sizes
    past L2, with the membench kernels' launches counted; then each kernel
    against its plain version at the largest shapes those runs give it,
    and its times."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import (
        bench_copy,
        bench_latency,
        bench_managed_vs_system,
        bench_membw,
    )
    from repro_torch.kernels import membench, ref

    log("== phase 9c: memory benchmarks on device and pinned host memory")
    fns = (membench.stream_read, membench.stream_fill, membench.chase)
    for fn in fns:
        fn.launches = 0
    for mod in (bench_membw, bench_copy, bench_latency, bench_managed_vs_system):
        t0 = time.perf_counter()
        log(f"  # ==== {mod.__name__.rsplit('.', 1)[-1]} ====")
        mod.main("cuda")
        torch.cuda.synchronize()
        log(f"  # done in {time.perf_counter() - t0:.1f} s")
    launches = {fn.__name__: fn.launches for fn in fns}
    log(f"  membench launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a membench kernel never ran: {launches}")

    gen = torch.Generator(device="cuda").manual_seed(19)
    n = max(bench_membw.CUDA_SIZES) // 4
    x = torch.randn(n, generator=gen, device="cuda")
    host = x.cpu().pin_memory()
    errs = {}
    for where, t in (("device", x), ("pinned_host", host)):
        got, want = float(membench.stream_read(t)), float(ref.stream_read(t.cuda()))
        lim = 1e-6 * float(t.abs().sum())     # f32 partial sums of ~1000 terms
        log(f"  stream_read {where} {n} floats: {got:.6f} vs plain {want:.6f} "
            f"(|err| {abs(got - want):.3e}, limit {lim:.3e})")
        if not abs(got - want) <= lim:
            raise AssertionError(f"stream_read on {where} disagrees")
        errs.setdefault("stream_read", abs(got - want))
    for where, t in (("device", x), ("pinned_host", host)):
        membench.stream_fill(t, 3.0)
        torch.cuda.synchronize()
        if not bool((t == 3.0).all()):
            raise AssertionError(f"stream_fill on {where} missed elements")
    log("  stream_fill: every element written on device and pinned host memory")
    errs["stream_fill"] = 0.0
    m = max(bench_latency.CUDA_SIZES)
    perm = torch.from_numpy(bench_latency.cyclic_permutation(m, np.random.default_rng(1)))

    def start():
        return torch.full((), 3, dtype=torch.int32, device="cuda")

    for where, t in (("device", perm.cuda()), ("pinned_host", perm.pin_memory())):
        got = int(membench.chase(t, bench_latency.CHAIN, start()))
        want = int(ref.chase(t.cuda(), bench_latency.CHAIN, start()))
        log(f"  chase {where} over {m * 4} B: ends at {got}, plain {want}")
        if got != want:
            raise AssertionError(f"chase on {where} disagrees")
    errs["chase"] = 0.0

    # times at those shapes, in device memory (1 GiB read and fill, the
    # 256 MiB chase): kernel, plain version, one library call, bound
    pd, pos = perm.cuda(), start()
    rows = []
    for name, kern_fn, plain_fn, lib_fn, nbytes, src_line in (
        ("stream_read", lambda: membench.stream_read(x), lambda: ref.stream_read(x),
         lambda: torch.sum(x), 4 * n + 8, "benchmarks/bench_membw.py:30"),
        ("stream_fill", lambda: membench.stream_fill(x, 2.0),
         lambda: ref.stream_fill(x, 2.0), lambda: x.fill_(2.0), 4 * n,
         "benchmarks/bench_membw.py:31"),
        ("chase", lambda: membench.chase(pd, bench_latency.CHAIN, pos),
         lambda: ref.chase(pd, bench_latency.CHAIN, pos), None,
         4 * bench_latency.CHAIN + 8, "benchmarks/bench_latency.py:22"),
    ):
        rec = dict(ms=study_ms(kern_fn), bytes=nbytes, flops=0,
                   plain_ms=study_ms(plain_fn, repeats=3),
                   library_ms=None if lib_fn is None else study_ms(lib_fn))
        rows.append(kernel_row(name, "src/repro_torch/csrc/membench.cu", src_line,
                               rec, launches[name], errs[name]))
    log(f"  chase: {rows[-1]['ms'] / bench_latency.CHAIN * 1e6:.1f} ns per dependent "
        f"load over {m * 4} B of device memory")
    return rows


def phase_calibrate():
    """9d: calibration on the card through repro_torch.launch.calibrate:
    the measured HBM read bandwidth may not exceed the spec by more than 5 %
    (an L2-resident sweep would), PCIe is measured, NVLink and InfiniBand
    keep spec provenance."""
    from repro_torch.core.calibration import Calibration
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.launch import calibrate as launch_calibrate

    log("== phase 9d: calibration on the card")
    out = ROOT / "build" / "calibration.json"
    t0 = time.perf_counter()
    rc = launch_calibrate.main(["--out", str(out), "--report",
                                str(ROOT / "build" / "replay_report.json")])
    if rc != 0:
        raise AssertionError(f"repro_torch.launch.calibrate exited {rc}")
    cal = Calibration.load(out)
    log(f"  calibration took {time.perf_counter() - t0:.1f} s; written to {out}")
    spec = SPEC_SYSTEM.term_value("hbm_bandwidth")
    hbm = cal.terms["hbm_bandwidth"].measured
    log(f"  hbm_bandwidth measured {hbm / 1e9:.1f} GB/s = {hbm / spec:.3f} x spec; "
        f"pcie_bandwidth measured {cal.terms['pcie_bandwidth'].measured / 1e9:.2f} GB/s")
    if not hbm <= 1.05 * spec:
        raise AssertionError(f"measured HBM bandwidth {hbm:.4g} B/s is over 1.05 x "
                             f"the spec {spec:.4g} B/s: the sweep read L2")
    system = cal.apply(SPEC_SYSTEM)
    for term in ("ici_link_bandwidth", "ici_hop_latency", "dcn_bandwidth", "dcn_latency"):
        if system.provenance_of(term) != "spec":
            raise AssertionError(f"{term} is {system.provenance_of(term)} on one card")
    for term, e in cal.replay.per_term_error().items():
        log(f"  replay {term}: mean rel error {e.mean_rel_error:.4f}, max "
            f"{e.max_rel_error:.4f} over {e.count} sweep points ({e.limiting_link})")


def phase_planner_benches():
    """9e: the planner-driven benchmarks on the card: bench_llm_inference's
    analytic leg and its serve leg at smoke scale (through the graphs,
    build/BENCH_serve.json), and bench_datapath_bounds."""
    from repro_torch.benchmarks import bench_datapath_bounds, bench_llm_inference

    log("== phase 9e: bench_llm_inference (analytic, serve at smoke scale) and "
        "bench_datapath_bounds on the card")
    rows = bench_llm_inference.analytic()
    if len(rows) != 3 * 8:
        raise AssertionError(f"{len(rows)} analytic rows")
    t0 = time.perf_counter()
    res = bench_llm_inference.serve("cuda")
    saved = json.loads(bench_llm_inference.OUT.read_text())
    if saved != json.loads(json.dumps(res)):
        raise AssertionError("BENCH_serve.json differs from the serve leg's result")
    for key, e in res.items():
        if (e["policy"]["name"] != "hbm_resident" or e["mesh_axes"] is not None
                or set(e["phases"]) != {"decode", "prefill"}
                or e["decode_tokens"] != e["requests"] * e["max_new"]
                or not e["decode_tps"] > 0 or not e["prefill_tps"] > 0):
            raise AssertionError(f"serve leg entry {key}: {e}")
    log(f"  serve leg took {time.perf_counter() - t0:.1f} s; wrote {bench_llm_inference.OUT}")
    bench_datapath_bounds.main("cuda")


def phase_collective_benches():
    """9f: the collective microbenchmarks (Figs. 13, 14, 18, 19) and the
    scale what-if.  Their measured rows are gloo ranks on the host's CPU
    (NCCL between cards needs several cards: one skip row each)."""
    import contextlib
    import io

    from repro_torch.benchmarks import bench_collectives, bench_internode, bench_pingpong
    from repro_torch.tools import whatif_scale

    log("== phase 9f: bench_pingpong, bench_internode, bench_collectives (gloo ranks on "
        "the host's CPU) and whatif_scale --arch gemma3-27b")
    t0 = time.perf_counter()
    for mod, n_rows in ((bench_pingpong, 3 + 1 + 6), (bench_internode, 3 + 1 + 15),
                        (bench_collectives, 8 + 1 + 18)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main("cuda")
        rows = buf.getvalue().splitlines()
        if len(rows) != n_rows or not any("skipped" in r for r in rows):
            raise AssertionError(f"9f: {mod.__name__} printed {len(rows)} rows: {rows}")
        for r in rows:
            log(f"  {r}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        whatif_scale.main(["--arch", "gemma3-27b"])
    for r in buf.getvalue().splitlines():
        log(f"  {r}")
    log(f"== phase 9f took {time.perf_counter() - t0:.1f} s")


def planner_against_measured(measured):
    """The planner's yi-6b ``hbm_resident`` decode step at phase 4's shape
    (8 slots, 2048 positions), on the spec sheet and on phase 9d's
    calibration, beside phase 4's measured step EWMAs.  Information, not a
    gate."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.calibration import Calibration
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import get_policy
    from repro_torch.core.planner import predict
    from repro_torch.models.model_zoo import ModelSizing

    log("== the planner's yi-6b decode step against phase 4's measured steps")
    sizing = ModelSizing(get_config("yi-6b"))
    shape = ShapeSpec("serve", YI["Smax"], YI["B"], "decode")
    prof = sizing.decode_workload(shape)
    cal = Calibration.load(ROOT / "build" / "calibration.json").apply(SPEC_SYSTEM)
    for name, system in (("spec", SPEC_SYSTEM), ("calibrated", cal)):
        p = predict(prof, get_policy("hbm_resident"), system)
        log(f"  planner[{name}]: {p.step_s * 1e3:.3f} ms a step, limited by {p.limiting} "
            f"(params {sizing.cfg.num_params() * 2 / 1e9:.2f} GB + KV "
            f"{sizing.cache_bytes(shape) / 1e9:.2f} GB at full cache)")
    log("  measured_step_s (decode-step wall EWMA): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in measured.items()))


# ---------------------------------------------------------------------------
# placement on one card: the KV write-back kernel, Fig. 17 on the card,
# opt_host training, live migration
# ---------------------------------------------------------------------------

#: the placements phase 10b serves yi-6b under (the paper's Fig. 17 rows,
#: then the RESIDENT host placements, computed on in place over PCIe)
PLACED_POLICIES = ("hbm_resident", "kv_host", "weights_stream",
                   "kv=host:stream,params=host:stream", "kv=host", "params=host",
                   "kv=host,params=host")
#: the prompts (of phase 4's first 8) a policy whose steps read the
#: weights in place serves: its prefill GEMMs read each weight tile once an
#: M-tile over PCIe, seconds a dispatch, so the three short prompts (one
#: dispatch), compared with the same requests under hbm_resident
PARAMS_HOST_PROMPTS = slice(5, 8)
#: decode and prefill row sets of the write-back checks at the yi-6b
#: serving shape (8 rows, 2048 slots): ragged positions, ring wrap, rows
#: that write nothing, a row longer than it can keep
KV_CASES = (
    ("decode", [0, 7, 100, 2047, 1500, 64, 9, 2046], [1] * 8),
    ("prefill", [0, 256, 1800, 1900, 5, 0, 2047, 30], [256, 0, 256, 200, 13, 0, 256, 1]),
    ("prefill, ragged", [3, 1000, 2040, 17, 0, 0, 500, 1024],
     [100, 256, 9, 0, 2048, 0, 256, 2100]),
)


def host_memory(label):
    """Log /proc/meminfo's MemAvailable beside ``label``."""
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    log(f"  {label}: host MemAvailable {avail / 2**30:.2f} GiB")
    return avail


def wall_ms(fn, repeats=5):
    """Median host milliseconds of ``fn`` followed by a synchronise (for a
    plain version that itself waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_kv_stream_kernel():
    """10a: the write-back kernel against its plain version on the card,
    bf16 and f32, from a device staging window into a slab in pinned host
    memory (and into device memory); its time, plain time and bound at the
    decode shape.  Returns (the timing record, the max error)."""
    import torch
    from repro_torch.core.placement import to_host
    from repro_torch.kernels import kv_stream, ref

    y = YI
    B, H, S, D = y["B"], y["Hkv"], y["Smax"], y["D"]
    log(f"== phase 10a: kv_stream (KV write-back) against its plain version on the card, "
        f"({B}, {H}, {S}, {D}) slabs in pinned host memory")
    gen = torch.Generator(device="cuda").manual_seed(10)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        src = {k: torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype) for k in "kv"}
        dst = to_host({k: torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
                       for k in "kv"}, "cuda")
        if not all(t.is_pinned() for t in dst.values()):
            raise AssertionError("the host slab is not pinned")
        dev = {k: t.cuda() for k, t in dst.items()}
        for label, pos, n in KV_CASES:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            c = torch.tensor(n, dtype=torch.int32, device="cuda")
            want = {k: t.clone() for k, t in dst.items()}
            ref.kv_write_back(src["k"], src["v"], want["k"], want["v"], p, c)
            kv_stream.kv_write_back(src["k"], src["v"], dst["k"], dst["v"], p, c)
            kv_stream.kv_write_back(src["k"], src["v"], dev["k"], dev["v"], p, c)
            torch.cuda.synchronize()
            for k in "kv":
                e = max((dst[k].float() - want[k].float()).abs().max().item(),
                        (dev[k].cpu().float() - want[k].float()).abs().max().item())
                err = max(err, e)
                if not (torch.equal(dst[k], want[k]) and torch.equal(dev[k].cpu(), want[k])):
                    raise AssertionError(f"kv_stream {label} {dtype}: max error {e}")
            rows = sum(min(x, S) for x in n)
            log(f"  {str(dtype)[6:]} {label}: {rows} rows x {H} heads written, into pinned "
                f"host and device memory, bit for bit")
        pageable = torch.zeros(B, H, S, D, dtype=dtype)
        try:
            kv_stream.kv_write_back(src["k"], src["v"], pageable, pageable, p, c)
        except RuntimeError as e:
            log(f"  {str(dtype)[6:]}: pageable host memory refused ({str(e)[:70]}...)")
        else:
            raise AssertionError("kv_stream wrote into pageable host memory")
    # times at the decode shape, bf16 (the main path's most frequent call)
    src = {k: torch.randn(B, H, S, D, generator=gen, device="cuda").to(torch.bfloat16)
           for k in "kv"}
    dst = to_host({k: torch.zeros(B, H, S, D, dtype=torch.bfloat16) for k in "kv"}, "cuda")
    _, pos, n = KV_CASES[0]
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    c = torch.tensor(n, dtype=torch.int32, device="cuda")
    row_bytes = 2 * B * H * D * 2                 # keys and values, one position a row
    rec = dict(
        ms=study_ms(lambda: kv_stream.kv_write_back(src["k"], src["v"], dst["k"], dst["v"],
                                                    p, c), repeats=20),
        plain_ms=wall_ms(lambda: ref.kv_write_back(src["k"], src["v"], dst["k"], dst["v"],
                                                   p, c)),
        library_ms=None, bytes=2 * row_bytes, pcie_bytes=row_bytes, flops=0)
    # the launch floor beside it: a kernel that does nothing on the same
    # grid, and one cudaMemcpyAsync of the same bytes from the card into
    # pinned host memory
    blocks = kv_stream.write_back_blocks(S * row_bytes // kv_stream.CHUNK_BYTES,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
    staged = torch.zeros(row_bytes, dtype=torch.uint8, device="cuda")
    pinned = torch.zeros(row_bytes, dtype=torch.uint8).pin_memory()
    rec["empty_ms"] = study_ms(lambda: kv_stream.empty_launch(blocks), repeats=20)
    rec["memcpy_ms"] = study_ms(
        lambda: kv_stream.copy_async(pinned, staged, torch.cuda.current_stream()), repeats=20)
    # the prefill shape: 8 x 256 positions at most a row
    _, pos, n = KV_CASES[1]
    pp = torch.tensor(pos, dtype=torch.int32, device="cuda")
    pc = torch.tensor(n, dtype=torch.int32, device="cuda")
    rec["prefill_ms"] = study_ms(lambda: kv_stream.kv_write_back(
        src["k"], src["v"], dst["k"], dst["v"], pp, pc), repeats=5)
    rec["prefill_bytes"] = 2 * sum(min(x, S) for x in n) * H * D * 2
    rec["prefill_gbps"] = rec["prefill_bytes"] / rec["prefill_ms"] / 1e6
    log(f"  decode shape: {rec['ms']:.4f} ms a launch for {row_bytes} bytes, {blocks} "
        f"blocks (plain version {rec['plain_ms']:.4f} ms wall: gather, copy to the host, "
        f"scatter there); launch floor: an empty kernel {rec['empty_ms']:.4f} ms, one "
        f"cudaMemcpyAsync of the {row_bytes} bytes into pinned memory "
        f"{rec['memcpy_ms']:.4f} ms")
    log(f"  prefill shape: {rec['prefill_ms']:.4f} ms for {rec['prefill_bytes']} bytes = "
        f"{rec['prefill_gbps']:.2f} GB/s written over PCIe")
    return rec, err


def trace_attempts():
    """Profiler windows a traced window takes before it gives up."""
    from repro_torch.analysis import transfer_audit

    return transfer_audit.TRACE_ATTEMPTS


def traced_window(label, fn):
    """The card's own records of one call of ``fn`` and its wall seconds:
    :func:`repro_torch.analysis.transfer_audit.traced_window`, the one
    implementation the package's transfer audit reads too (spin kernels
    lead the window and only what follows the last of them counts; a
    window that lost them, or the call's kernels, is taken again with 8x
    the spins, up to ``trace_attempts()`` times), its retakes logged
    here."""
    from repro_torch.analysis.transfer_audit import traced_window as window

    return window(label, fn, log=log)


def replay_traffic(label, fn):
    """Host<->device bytes and kernel launches of one call of ``fn``, from
    the card's own records of it (:func:`traced_window`; CUPTI lists a
    graph's kernels and copies one by one): memcpy bytes by direction, the
    kernels and their device time."""
    inside, wall = traced_window(label, fn)
    kernels = [e for e in inside if e.get("cat") == "kernel"]
    copies = [e for e in inside if e.get("cat") == "gpu_memcpy"]

    def nbytes(direction):
        return sum(int(e.get("args", {}).get("bytes", 0)) for e in copies
                   if direction in e.get("name", ""))

    sizes = {}
    for e in copies:
        key = (e.get("name", "?")[:22], int(e.get("args", {}).get("bytes", 0)))
        sizes[key] = sizes.get(key, 0) + 1
    wb = [e for e in kernels if "write_back_kernel" in e.get("name", "")]
    rest = [e for e in kernels if "write_back_kernel" not in e.get("name", "")]

    def stream(e):
        return e.get("args", {}).get("stream", e.get("tid"))

    busy = []                 # the other kernels' union of intervals
    for e in sorted(rest, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e.get("dur", 0)
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])

    def beside(a):            # microseconds of a that other kernels ran through
        lo, hi = a["ts"], a["ts"] + a.get("dur", 0)
        return sum(max(0, min(hi, b) - max(lo, a_)) for a_, b in busy)

    return dict(h2d=nbytes("HtoD"), d2h=nbytes("DtoH"), kernels=len(kernels), sizes=sizes,
                write_backs=len(wb), write_back_ms=sum(e.get("dur", 0) for e in wb) / 1e3,
                write_back_streams=sorted({stream(e) for e in wb}, key=str),
                compute_stream=statistics.mode(stream(e) for e in rest) if rest else None,
                write_back_beside_ms=sum(beside(e) for e in wb) / 1e3,
                copies=len(copies), device_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
                copy_ms=sum(e.get("dur", 0) for e in copies) / 1e3, wall_ms=wall * 1e3)


def log_write_backs(label, tr):
    """Log the write-back kernels of one traced call: count, summed device
    time, their stream against the compute stream (the stream most of
    the other kernels ran on), and how much of their time other kernels
    ran through."""
    log(f"  {label}: write-back {tr['write_backs']} kernels, {tr['write_back_ms']:.4f} ms "
        f"of device time, on stream(s) {tr['write_back_streams']} (compute stream "
        f"{tr['compute_stream']}); {tr['write_back_beside_ms']:.4f} ms of it beside "
        "other kernels")


def planner_steps(sizing, policy, shape):
    """The planner's decode step for ``policy`` at ``shape``, on the spec
    sheet and on phase 9d's calibration: {label: prediction}."""
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.planner import predict

    prof = sizing.decode_workload(shape)
    return {name: predict(prof, policy, system)
            for name, system in (("spec", SPEC_SYSTEM), ("calibrated", cal_system()))}


def cal_system():
    """The spec sheet with phase 9d's calibration applied."""
    from repro_torch.core.calibration import Calibration
    from repro_torch.core.hardware import SPEC_SYSTEM

    return Calibration.load(ROOT / "build" / "calibration.json").apply(SPEC_SYSTEM)


def mapped_read_rate():
    """Bytes a second the planner's calibrated system reads pinned host
    memory in place at (its RESIDENT host price; phase 9d's mapped reads)."""
    from repro_torch.core.datapath import read_bound
    from repro_torch.core.hardware import MemoryTier

    return read_bound(MemoryTier.HOST, cal_system()).bandwidth


def audit_replays(label, server):
    """12a: ``Runtime.audit`` with the profiler over one decode replay (the
    packed fetch included) and one prefill replay (8 rows x 256 new tokens
    at fills 0..1792, staged before the window) of a graphed server: the
    card's copy records held to the placement's allowance.  Logs each
    report, with the build's own audits; every report must be ``ok`` and
    read from the card's trace.  Returns the replays' reports."""
    import numpy as np
    import torch

    eng = server.engine
    B, C = eng.cfg.batch_slots, eng.cfg.prefill_chunk
    reports = {"decode": eng.audit_dispatch("decode")}
    eng.stage_prefill(np.ones((B, C), np.int32), np.full(B, C, np.int32),
                      np.arange(0, B * 256, 256, dtype=np.int32))
    torch.cuda.synchronize()
    reports["prefill"] = eng.audit_dispatch("prefill")
    build = ", ".join(f"{k} {r.donation_materialized}/{r.donation_expected} in place "
                      f"{'ok' if r.ok else 'FAILED'}" for k, r in eng.audit_reports.items())
    log(f"  12a {label}: the build's audits: {build}")
    failed = []
    for name, rep in reports.items():
        allow = eng.audit_allowance(name)
        by_dir = rep.bytes_by_direction()
        log(f"  12a {label} {name} replay: in place {rep.donation_materialized}/"
            f"{rep.donation_expected} cache leaves; H2D {by_dir.get('HtoD', 0):.0f} + D2H "
            f"{by_dir.get('DtoH', 0):.0f} bytes in {len(rep.transfers)} copy records, "
            f"allowance {allow:.0f}; violations "
            f"{[f'{v.kind} {v.op} {v.nbytes:.0f}' for v in rep.violations] or 'none'}")
        if not rep.ok or not rep.profiled:
            failed.append(f"{name}: {json.dumps(rep.to_json())[:2000]}")
    if failed:
        raise AssertionError(f"12a {label}:\n" + "\n".join(failed))
    return reports


def in_place_bytes(eng):
    """Bytes one decode step's kernels read in place from a RESIDENT host
    role, from the serve state at the step: the live KV (each row's keys
    up to its length; an M layer's state, read and written whole) and the
    weights but the embedding table (a step gathers B of its rows)."""
    from repro_torch.core.placement import Role
    from repro_torch.models.sharding import tree_leaves

    out = {}
    pol, rt = eng.policy, eng.runtime
    if pol.placement(Role.KV_CACHE).on_host and not rt.streamed(Role.KV_CACHE):
        S = eng.cfg.max_len
        live = (eng.state["lengths"].clamp(max=S - 1) + 1).sum().item()
        n = 0
        for st in eng.caches["stages"]:
            for key, entry in st.items():
                if key.endswith("M"):
                    n += 2 * sum(t.numel() * t.element_size() for t in tree_leaves(entry))
                else:
                    k = entry["k"]                     # (layers, B, H, S, D)
                    per_pos = k.shape[0] * k.shape[2] * k.shape[4] * k.element_size()
                    n += 2 * live * per_pos
        out["kv"] = n
    if pol.placement(Role.PARAMS).on_host and not rt.streamed(Role.PARAMS):
        emb = eng.params["embed"]["embedding"]
        tied = eng.bundle.cfg.tie_embeddings
        out["params"] = sum(t.numel() * t.element_size() for t in tree_leaves(eng.params)) - (
            0 if tied else emb.numel() * emb.element_size())
    return out


def phase_placed_serving():
    """10b: the paper's Fig. 17 on the card — full-width, full-depth yi-6b
    in bf16 serving phase 4's first 8 prompts (16 new tokens each) through
    the CUDA graphs under each of PLACED_POLICIES on the same weights;
    tokens identical across them; kv_host also eagerly for 2 requests.
    Returns the write-back kernel's launches on this path and the table."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.placement import Role
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.serve import ServeConfig

    cfg = get_config("yi-6b")
    y = YI
    B, H, S, D, L = y["B"], y["Hkv"], y["Smax"], y["D"], cfg.n_layers
    log(f"== phase 10b: {cfg.name} bfloat16 at full width and depth under "
        f"{', '.join(PLACED_POLICIES)}, through the CUDA graphs (Fig. 17 on the card)")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    prompts = dense_prompts(cfg.vocab)[0][:8]
    new = 16
    shape = ShapeSpec("serve", S, B, "decode")
    rate = mapped_read_rate()
    log(f"  calibrated mapped-read rate (phase 9d, the planner's RESIDENT host price): "
        f"{rate / 1e9:.2f} GB/s")
    host_memory("before placement")
    table, tokens, kv_launches, failed = [], {}, 0, []
    for pol in PLACED_POLICIES:
        scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=y["chunk"], policy=pol)
        t0 = time.perf_counter()
        subset = (PARAMS_HOST_PROMPTS if "params=host" in pol.split(",")
                  else slice(0, len(prompts)))
        server, reqs, wall, launches = serve_requests(bundle, params, scfg, prompts[subset],
                                                      new)
        eng, st = server.engine, server.stats()
        name = eng.policy.name
        stream_kv = eng.runtime.streamed(Role.KV_CACHE)
        if eng.feed is not None:
            pinned = sum(t.numel() * t.element_size() for t in eng.feed.buffers()
                         if t.device.type == "cpu")
            staged = sum(b.numel() for s_ in eng.feed.streams().values() for b in s_.buffers())
            log(f"  {name}: {pinned / 2**30:.2f} GiB in pinned host memory, "
                f"{staged / 2**30:.2f} GiB of device staging slots; windows a step "
                f"{ {k: v.n_windows for k, v in eng.feed.streams().items()} } "
                f"(planner stream_chunks {L})")
            held = {"capture": eng._stream} | {
                f"{k} {kind}": getattr(v, attr) for k, v in eng.feed.streams().items()
                for kind, attr in (("copy", "_copy_stream"), ("write-back", "_wb_stream"))}
            log(f"  {name}: streams { {k: hex(v.cuda_stream) for k, v in held.items()} }; "
                "torch.cuda.graph's default capture stream "
                f"{hex(getattr(torch.cuda.graph.default_capture_stream, 'cuda_stream', 0))}")
        mapped = sum(t.numel() * t.element_size()
                     for t in tree_leaves(eng.params) + tree_leaves(eng.caches)
                     if t.is_cuda and getattr(t, "_host_arena", None) is not None)
        if mapped:
            log(f"  {name}: {mapped / 2**30:.2f} GiB in pinned host memory that the steps "
                "read and write in place (mapped)")
        want = {"decode_attention": L * st["decode_steps"],
                "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0,
                "flash_attention": 0,
                "kv_stream": L * (st["decode_steps"] + st["prefill_dispatches"])
                if stream_kv else 0}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches} != {want}")
        kv_launches += launches["kv_stream"]
        tokens[name] = (subset, [r.out_tokens for r in reqs])
        tp, ewma = server.throughput(), eng.measured_step_s
        # one decode step (replay + the (2, B) fetch) at the lengths the
        # served requests ended at (a RESIDENT cache is read up to them),
        # and one prefill replay of 8 x 256 new tokens at fills 0..1792, on
        # the served caches
        ends = [len(p) - 1 + new for p in prompts[subset]]
        eng.state["lengths"].zero_()[:len(ends)].copy_(torch.tensor(ends))
        reads = in_place_bytes(eng)
        dec = replay_traffic(f"{name} decode", eng.decode)
        eng.stage_prefill(np.ones((B, y["chunk"]), np.int32), np.full(B, y["chunk"], np.int32),
                          np.arange(0, B * 256, 256, dtype=np.int32))
        torch.cuda.synchronize()
        pre = replay_traffic(f"{name} prefill", eng._graphs["prefill"].replay)
        expect = eng.feed.h2d_bytes() if eng.feed is not None else 0
        n_copies = 0 if eng.feed is None else sum(
            len(tree_leaves(w)) for st_ in eng.feed.streams().values() for w in st_.windows)
        for label, tr in (("decode", dec), ("prefill", pre)):
            if abs(tr["h2d"] - expect) > 0.02 * max(expect, 1):
                failed.append(f"{name} {label}: H2D {tr['h2d']} bytes, expected {expect} in "
                              f"{n_copies} copies; copies seen {sorted(tr['sizes'].items())}")
        if dec["d2h"] != 2 * B * 4 or pre["d2h"] != 0:
            failed.append(f"{name}: D2H memcpy {dec['d2h']} / {pre['d2h']} bytes, "
                          f"expected the (2, {B}) fetch only")
        wb_dec = L * 2 * B * H * D * 2 if stream_kv else 0
        wb_pre = L * 2 * B * y["chunk"] * H * D * 2 if stream_kv else 0
        for label, tr in (("decode", dec), ("prefill", pre)):
            if tr["write_backs"] != (L if stream_kv else 0):
                failed.append(f"{name} {label}: {tr['write_backs']} write-back kernels in "
                              f"the trace, expected {L if stream_kv else 0}")
            if stream_kv:
                log_write_backs(f"{name} {label} replay", tr)
        # with the weights resident, a prefill dispatch's write-backs run
        # beside the layers, on a stream of their own
        if (stream_kv and eng.feed.weights is None
                and pre["compute_stream"] in pre["write_back_streams"]):
            failed.append(f"{name} prefill: write-back kernels on the compute stream "
                          f"{pre['compute_stream']}, expected a stream of their own")
        preds = planner_steps(bundle, eng.policy, shape)
        in_place = sum(reads.values())
        row = dict(policy=name, decode_tps=tp["decode_tps"], prefill_tps=tp["prefill_tps"],
                   step_ms=ewma * 1e3, replay_ms=dec["wall_ms"],
                   spec_ms=preds["spec"].step_s * 1e3, cal_ms=preds["calibrated"].step_s * 1e3,
                   limiting=preds["calibrated"].limiting, h2d=dec["h2d"], d2h=dec["d2h"],
                   writeback=wb_dec, pre_h2d=pre["h2d"], pre_writeback=wb_pre,
                   kernels=dec["kernels"], pre_kernels=pre["kernels"],
                   wb_ms=dec["write_back_ms"], pre_wb_ms=pre["write_back_ms"],
                   pre_replay_ms=pre["wall_ms"], in_place=in_place,
                   in_place_ms=in_place / rate * 1e3, requests=len(reqs))
        table.append(row)
        log(f"  {name}: decode {tp['decode_tps']:.1f} tok/s, prefill {tp['prefill_tps']:.1f} "
            f"tok/s, step EWMA {ewma * 1e3:.2f} ms (Runtime.measured_step_s); planner "
            f"{row['spec_ms']:.3f} ms spec, {row['cal_ms']:.3f} ms calibrated (limited by "
            f"{row['limiting']}, pcie {preds['calibrated'].pcie_s * 1e3:.3f} ms)")
        log(f"  {name}: decode replay {dec['wall_ms']:.2f} ms wall, {dec['device_ms']:.2f} ms "
            f"of kernels, {dec['copy_ms']:.2f} ms of copies; H2D {dec['h2d']} bytes "
            f"(expected {expect}), D2H memcpy {dec['d2h']} bytes (the (2, {B}) fetch), "
            f"write-back {wb_dec} bytes through mapped stores; {dec['kernels']} kernels, "
            f"{dec['copies']} copies a replay")
        if reads:
            log(f"  {name}: read in place over PCIe by the decode replay's kernels: "
                + ", ".join(f"{k} {v} bytes" for k, v in reads.items())
                + f" = {in_place / rate * 1e3:.2f} ms at the calibrated "
                f"{rate / 1e9:.2f} GB/s (replay {dec['wall_ms']:.2f} ms: "
                f"{in_place / dec['wall_ms'] / 1e6:.2f} GB/s achieved)")
        log(f"  {name}: prefill replay {pre['wall_ms']:.2f} ms wall; H2D {pre['h2d']} bytes, "
            f"D2H memcpy {pre['d2h']}, write-back {wb_pre} bytes; {pre['kernels']} kernels, "
            f"{pre['copies']} copies; launches per replay {eng.graph_launches}")
        if pol in ("kv_host", "weights_stream"):
            # 12a, where this server is alive: the audit's own windows
            for label, rep in audit_replays(f"yi-6b {name} (phase 10b)", server).items():
                h2d = rep.bytes_by_direction().get("HtoD", 0.0)
                tr = dec if label == "decode" else pre
                log(f"  12a {name} {label}: H2D {h2d:.0f} bytes, the windows hold {expect}, "
                    f"10b's window read {tr['h2d']}")
                if pol == "kv_host" and abs(h2d - expect) > 0.02 * max(expect, 1):
                    failed.append(f"12a {name} {label}: H2D {h2d} bytes, expected the "
                                  f"windows' {expect}")
        if pol == "kv_host":
            eager, ereqs, _, _ = serve_requests(bundle, params, scfg, prompts[:2], new,
                                                eager=True)
            if [r.out_tokens for r in ereqs] != tokens[name][1][:2]:
                raise AssertionError("kv_host eager tokens differ from its graphs'")
            log("  kv_host eager (2 requests): greedy tokens identical to its graphs'")
            log_write_backs("kv_host eager decode step",
                            replay_traffic("kv_host eager decode", eager.engine.decode))
            del eager, ereqs
        del server, reqs, eng
        gc.collect()
        torch.cuda.empty_cache()
        host_memory(f"{name} freed ({time.perf_counter() - t0:.1f} s)")
    first = tokens["hbm_resident"][1]
    diff = {k: [i for i, (a, b) in enumerate(zip(v, first[sub])) if a != b]
            for k, (sub, v) in tokens.items() if v != first[sub]}
    if diff:
        failed.append(f"greedy tokens differ from hbm_resident's: {diff}")
    if failed:
        raise AssertionError("phase 10b:\n" + "\n".join(failed))
    digest = hashlib.sha256(json.dumps(first).encode()).hexdigest()
    log(f"  greedy tokens identical across the {len(tokens)} placements for all "
        f"{len(first)} requests (prompts 6-8 only where the weights are read in place; "
        f"SHA-256 of every request's tokens {digest})")
    log("  Fig. 17 on the card (yi-6b, 8 slots x 2048, bf16): policy | decode step EWMA "
        "ms | planner spec / calibrated ms (limit) | decode H2D / D2H bytes a step | "
        "write-back bytes | read in place bytes (ms at the calibrated rate) | decode tok/s "
        "| prefill tok/s | requests")
    for r in table:
        log(f"    {r['policy']} | {r['step_ms']:.2f} | {r['spec_ms']:.3f} / {r['cal_ms']:.3f} "
            f"({r['limiting']}) | {r['h2d']} / {r['d2h']} | {r['writeback']} | "
            f"{r['in_place']} ({r['in_place_ms']:.2f}) | {r['decode_tps']:.1f} | "
            f"{r['prefill_tps']:.1f} | {r['requests']}")
    log("  write-back device ms in one decode / one prefill replay, prefill replay wall "
        "ms: " + "; ".join(f"{r['policy']} {r['wb_ms']:.4f} / {r['pre_wb_ms']:.4f}, "
                           f"{r['pre_replay_ms']:.2f}" for r in table))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 10b took {time.perf_counter() - t_phase:.1f} s")
    return kv_launches, table


#: phase 10c's rows: (policy, batch rows of 2048 tokens).  A policy whose
#: steps read the params in place runs at batch 1 beside an hbm_resident
#: twin at batch 1: cuBLAS reads a mapped operand once per row block of a
#: product, so its steps cost seconds at batch 4
TRAIN_PLACED = (("hbm_resident", 4), ("opt_host", 4), ("opt=host", 4),
                ("weights_stream", 4),
                ("params=host:stream,master=host:stream,opt_state=host:stream", 4),
                ("hbm_resident", 1), ("params=host", 1))


def planner_train(bundle, policy, B, S):
    """The planner's train step for ``policy`` at B x S, remat full, on the
    spec sheet and on phase 9d's calibration: {label: prediction}."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import parse_policy
    from repro_torch.core.planner import predict

    prof = bundle.train_workload(ShapeSpec("train", S, B, "train"), remat=True)
    return {name: predict(prof, parse_policy(policy), system)
            for name, system in (("spec", SPEC_SYSTEM), ("calibrated", cal_system()))}


def streamed_train_bytes(step):
    """(H2D, D2H) bytes one training step's HostStreams copy: a streamed
    params tree's windows forward and again backward (all but the tail),
    and the new params back; a streamed master's and moments' windows
    each way."""
    streams = step.placed.get("streams") or {}

    def total(key):
        return sum(streams[key].window_bytes) if key in streams else 0

    h2d = total("source") + total("master") + total("opt")
    if "source" in streams:
        h2d += total("source") - streams["source"].window_bytes[-1]
    return h2d, total("params") + total("master") + total("opt")


def train_rows(bundle, rows, batches, steps, label):
    """Train ``bundle`` from the same weights (seed 0) and batches under
    each (policy, B) of ``rows``: ``steps`` AdamW steps timed, then one
    more inside a profiler window (:func:`replay_traffic`) for its H2D and
    D2H bytes against the streams' windows.  Each row's attention launches
    are counted from 0 at its start; a params tree in host memory must
    keep its storage.  Returns {(policy, B): record}."""
    import gc

    import torch
    from repro_torch.core.placement import host_bytes
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    S, L, out, failed = 2048, bundle.cfg.n_layers, {}, []
    for pol, B in rows:
        tcfg = TrainConfig(remat="full", policy=pol,
                           optimizer=AdamWConfig(lr=3e-4, warmup_steps=1))
        flash_attention.launches = flash_attention_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, ef = init_train_state(
            bundle, torch.Generator(device="cuda").manual_seed(0), tcfg)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trees = {"params": params, "master": opt["master"], "mu": opt["mu"], "nu": opt["nu"]}
        on_host = {k: "mapped" if tree_leaves(t)[0].is_cuda else "pinned"
                   for k, t in trees.items()
                   if getattr(tree_leaves(t)[0], "_host_arena", None) is not None}
        pinned = sum(host_bytes(trees[k]) for k in on_host)
        ptrs = [t.data_ptr() for t in tree_leaves(params)]
        step = make_train_step(bundle, tcfg)
        losses, gnorms, times = [], [], []
        for b in batches[B][:steps]:
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
            params, opt, ef, m = step(params, opt, ef, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
        last = {k: torch.from_numpy(v).to("cuda") for k, v in batches[B][steps].items()}
        cur, runs = [params, opt, ef], []

        def one():
            cur[:] = step(*cur, last)[:3]
            runs.append(1)

        tr = replay_traffic(f"10c {pol} {B} x {S} step", one)
        params = cur[0]
        want_h2d, want_d2h = streamed_train_bytes(step)
        name = f"{pol} at {B} x {S}"
        for what, got, want in (("H2D", tr["h2d"], want_h2d), ("D2H", tr["d2h"], want_d2h)):
            if abs(got - want) > 2**20:
                failed.append(f"{name}: {what} {got} bytes a step, the windows' {want}; "
                              f"copies {sorted(tr['sizes'].items())[:12]}")
        n = steps + len(runs)
        launches = (flash_attention.launches, flash_attention_bwd.launches)
        if launches != (2 * L * n, L * n):
            failed.append(f"{name}: attention launches {launches}, want forward 2 x {L} x "
                          f"{n}, backward {L} x {n}")
        if on_host.get("params") and [t.data_ptr() for t in tree_leaves(params)] != ptrs:
            failed.append(f"{name}: the params left their host arena")
        preds = planner_train(bundle, pol, B, S)
        steady = statistics.median(times[1:])
        rec = dict(losses=losses, gnorms=gnorms, times=times, steady=steady,
                   peak=torch.cuda.max_memory_allocated(), init_peak=init_peak,
                   pinned=pinned, on_host=on_host,
                   h2d=tr["h2d"], d2h=tr["d2h"], want_h2d=want_h2d, want_d2h=want_d2h,
                   traced_ms=tr["wall_ms"], launches=launches, init_s=t_init,
                   spec_s=preds["spec"].step_s, cal_s=preds["calibrated"].step_s,
                   limiting=preds["calibrated"].limiting, ptr=ptrs[0])
        out[(pol, B)] = rec
        where = ", ".join(f"{k} {v}" for k, v in on_host.items()) or "nothing"
        log(f"  {name}: losses {losses}, grad norms {gnorms}; step times "
            f"{[round(t, 4) for t in times]} s, steady {steady:.4f} s against the planner's "
            f"train price {rec['spec_s']:.4f} s spec, {rec['cal_s']:.4f} s calibrated "
            f"(limited by {rec['limiting']}); in host memory: {where} "
            f"({pinned / 2**30:.2f} GiB); peak device memory {rec['peak'] / 2**30:.2f} GiB in "
            f"the steps, {init_peak / 2**30:.2f} GiB in the set-up ({t_init:.1f} s)")
        log(f"  {name}: a traced step ({tr['wall_ms']:.1f} ms wall) copied H2D {tr['h2d']} "
            f"bytes (the windows {want_h2d}) and D2H {tr['d2h']} (the windows {want_d2h}) in "
            f"{tr['copies']} copies, {tr['kernels']} kernels; attention launches {launches}"
            + (f"; params arena at {ptrs[0]:#x} before and after the steps"
               if on_host.get("params") else ""))
        del params, opt, ef, step, cur, trees, last, batch
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{label}:\n" + "\n".join(failed))
    return out


def same_losses(label, got, want):
    """Losses and grad norms of a row against its hbm_resident twin's: bit
    for bit, or within phase 3b's card-vs-CPU limits (a difference can
    only come from run-to-run rounding on the card)."""
    if got["losses"] == want["losses"] and got["gnorms"] == want["gnorms"]:
        log(f"  {label}: losses and grad norms equal hbm_resident's bit for bit")
        return
    for i, (lo, go, lr_, gr) in enumerate(zip(got["losses"], got["gnorms"], want["losses"],
                                              want["gnorms"])):
        lim = 1e-5 if i == 0 else 1e-3
        if abs(lr_ - lo) > lim * abs(lr_) or abs(gr - go) > 1e-2 * abs(gr):
            raise AssertionError(f"{label} step {i + 1}: {lo} / {go} against hbm_resident "
                                 f"{lr_} / {gr}")
    log(f"  {label} against hbm_resident: not bit for bit, within phase 3b's limits")


def phase_opt_host_training():
    """10c: full-depth olmo-1b in bf16, 3 AdamW steps from the same weights
    and batches under each of TRAIN_PLACED: the optimizer state streamed
    (opt_host) or updated in place in host memory (opt=host), the params
    streamed (weights_stream; with the optimizer state too) or read and
    updated in place there (params=host, at batch 1 beside its twin).
    Losses and grad norms against the hbm_resident twin's; each row's
    step time against the planner's train price, a traced step's copies
    against the windows', its peak device memory, the params arena kept.
    Returns each kernel's launches across the rows."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import ModelBundle

    cfg = get_config("olmo-1b")
    log(f"== phase 10c: training {cfg.name} bfloat16 at full depth, 3 AdamW steps and a "
        f"traced one under {', '.join(f'{p} (batch {b})' for p, b in TRAIN_PLACED)}")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    batches = {}
    for B in {b for _, b in TRAIN_PLACED}:
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=B))
        batches[B] = [next(data) for _ in range(4)]
    host_memory("before phase 10c")
    res = train_rows(bundle, TRAIN_PLACED, batches, 3, "phase 10c")
    for (pol, B), rec in res.items():
        if pol != "hbm_resident":
            same_losses(f"{pol} at batch {B}", rec, res[("hbm_resident", B)])
    log("  10c table (olmo-1b, 3 steps, bf16): policy | batch | steady step s | planner "
        "spec / calibrated s (limit) | H2D / D2H bytes a step (windows) | peak device "
        "GiB | host GiB")
    for (pol, B), r in res.items():
        log(f"    {pol} | {B} | {r['steady']:.4f} | {r['spec_s']:.4f} / {r['cal_s']:.4f} "
            f"({r['limiting']}) | {r['h2d']} / {r['d2h']} ({r['want_h2d']} / "
            f"{r['want_d2h']}) | {r['peak'] / 2**30:.2f} | {r['pinned'] / 2**30:.2f}")
    log(f"  phase 10c took {time.perf_counter() - t_phase:.1f} s")
    return {"attention_fwd": sum(r["launches"][0] for r in res.values()),
            "attention_bwd": sum(r["launches"][1] for r in res.values())}


def phase_yi_opt_host_training():
    """10f: full-width, full-depth yi-6b in bf16 under opt_host, 2 AdamW
    steps at 1 x 2048, remat full: 6.06 B params x 16 bytes do not fit one
    80 GB card, and the f32 master and moments (12 bytes a parameter) go
    to pinned host memory.  Fails, naming the numbers, when the host's
    MemAvailable cannot hold them.  Returns the attention launches."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves

    cfg = get_config("yi-6b")
    bundle = ModelBundle(cfg)
    n = sum(int(torch.Size(p.shape).numel()) for p in tree_leaves(bundle.param_defs()))
    need = 12 * n
    log(f"== phase 10f: training {cfg.name} bfloat16 at full width and depth ({cfg.n_layers} "
        f"layers, {n / 1e9:.3f} B params) under opt_host, 2 AdamW steps at 1 x 2048, remat full")
    t_phase = time.perf_counter()
    hbm = planner_train(bundle, "hbm_resident", 1, 2048)["spec"]
    log(f"  hbm_resident would hold {n * 16 / 1e9:.1f} GB of params, grads and f32 optimizer "
        f"state (the planner: fits {hbm.fits}, {hbm.hbm_bytes / 2**30:.1f} GiB of HBM)")
    avail = host_memory("before phase 10f")
    if avail is None or avail < need + 4 * 2**30:
        raise AssertionError(
            f"10f: host MemAvailable {(avail or 0) / 2**30:.2f} GiB cannot hold the "
            f"{need / 2**30:.2f} GiB of pinned optimizer state and 4 GiB of headroom")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=1))
    res = train_rows(bundle, (("opt_host", 1),), {1: [next(data) for _ in range(3)]}, 2,
                     "phase 10f")[("opt_host", 1)]
    if res["pinned"] != need:
        raise AssertionError(f"10f: {res['pinned']} bytes pinned, want {need}")
    bad = [x for x in res["losses"] + res["gnorms"] if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"10f: non-finite losses / grad norms {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    host_memory(f"phase 10f freed ({time.perf_counter() - t_phase:.1f} s)")
    return {"attention_fwd": res["launches"][0], "attention_bwd": res["launches"][1]}


#: the placements phase 10d serves each Mamba-2 / Zamba-2 model under
SSM_PLACED = {"mamba2-780m": ("hbm_resident", "kv_host", "kv=host", "weights_stream"),
              "zamba2-1.2b": ("hbm_resident", "kv_host")}


def streamed_state_bytes(eng):
    """Bytes of the ``M`` layers' state in a streamed cache's windows: what
    a step copies back to host memory (whole, one copy a leaf)."""
    from repro_torch.models.sharding import tree_leaves

    if eng.feed is None or eng.feed.kv is None:
        return 0
    return sum(t.numel() * t.element_size() for w in eng.feed.kv.windows
               for key, entry in w.items() if key.endswith("M") for t in tree_leaves(entry))


def resident_state_bytes(eng):
    """Bytes of the ``M`` layers' ``ssm`` and ``conv`` leaves of a cache
    placed RESIDENT in host memory (0 for another placement)."""
    from repro_torch.core.placement import Role
    from repro_torch.models.sharding import tree_leaves

    out = {"ssm": 0, "conv": 0}
    if eng.policy.placement(Role.KV_CACHE).on_host and not eng.runtime.streamed(Role.KV_CACHE):
        for st in eng.caches["stages"]:
            for key, entry in st.items():
                if key.endswith("M"):
                    for leaf in out:
                        out[leaf] += sum(t.numel() * t.element_size()
                                         for t in tree_leaves(entry[leaf]))
    return out


def phase_ssm_placed_serving():
    """10d: full-width, full-depth mamba2-780m and zamba2-1.2b in bf16 (8
    slots x 2048, prefill chunk 256) serving 8 greedy requests (prompts of
    128-1024 tokens, numpy seed 0, 16 new tokens each) through the CUDA
    graphs under each of SSM_PLACED's policies on the same weights: tokens
    identical within each model, launches counted, and for each host
    placement the H2D and D2H bytes of one decode and one prefill replay
    against the windows.  Returns the write-back kernel's launches
    (zamba2's S layers under kv_host)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.placement import Role
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    B, S, C, new = MAMBA["B"], 2048, MAMBA["T"], 16
    t_phase = time.perf_counter()
    rate = mapped_read_rate()
    kv_launches, failed = 0, []
    for arch, policies in SSM_PLACED.items():
        cfg = get_config(arch)
        codes = cfg.layer_codes()
        n_m, n_s = codes.count("M"), codes.count("S")
        log(f"== phase 10d: {cfg.name} bfloat16 at full width and depth ({n_m} M layers, "
            f"{n_s} S), {B} slots x {S}, under {', '.join(policies)}, through the CUDA graphs")
        bundle = ModelBundle(cfg)
        params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in rng.integers(128, 1025, size=B)]
        shape = ShapeSpec("serve", S, B, "decode")
        tokens, table = {}, []
        for pol in policies:
            t0 = time.perf_counter()
            scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=C, policy=pol)
            server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, new)
            eng, st = server.engine, server.stats()
            name = eng.policy.name
            stream_kv = eng.runtime.streamed(Role.KV_CACHE)
            want = {"ssd_scan": n_m * st["prefill_dispatches"],
                    "prefill_attention": n_s * st["prefill_dispatches"],
                    "decode_attention": n_s * st["decode_steps"], "flash_attention": 0,
                    "kv_stream": n_s * (st["decode_steps"] + st["prefill_dispatches"])
                    if stream_kv else 0}
            if launches != want:
                raise AssertionError(f"{cfg.name} {name}: launches {launches} != {want}")
            kv_launches += launches["kv_stream"]
            tokens[name] = [r.out_tokens for r in reqs]
            tp, ewma = server.throughput(), eng.measured_step_s
            reads = in_place_bytes(eng)
            dec = None        # hbm_resident has no host role and no window: not traced
            if pol != "hbm_resident":
                dec = replay_traffic(f"{cfg.name} {name} decode", eng.decode)
                eng.stage_prefill(np.ones((B, C), np.int32), np.full(B, C, np.int32),
                                  np.arange(0, B * C, C, dtype=np.int32))
                torch.cuda.synchronize()
                pre = replay_traffic(f"{cfg.name} {name} prefill",
                                     eng._graphs["prefill"].replay)
                h2d = eng.feed.h2d_bytes() if eng.feed is not None else 0
                back = streamed_state_bytes(eng)
                # a RESIDENT state's new ssm state (decode) and conv window
                # (prefill) land in host memory through PyTorch's copy_ of a
                # contiguous tensor of the same type: a cudaMemcpyAsync into
                # the mapped address, which the trace shows as D2H
                resident = resident_state_bytes(eng)
                for label, tr, d2h in (("decode", dec, back + resident["ssm"] + 2 * B * 4),
                                       ("prefill", pre, back + resident["conv"])):
                    if (abs(tr["h2d"] - h2d) > 0.02 * max(h2d, 1)
                            or abs(tr["d2h"] - d2h) > 0.02 * max(d2h, 1)):
                        failed.append(f"{cfg.name} {name} {label}: H2D / D2H {tr['h2d']} / "
                                      f"{tr['d2h']} bytes, expected {h2d} / {d2h}; copies seen "
                                      f"{sorted(tr['sizes'].items())}")
                    if tr["write_backs"] != (n_s if stream_kv else 0):
                        failed.append(f"{cfg.name} {name} {label}: {tr['write_backs']} "
                                      f"write-back kernels, expected {n_s if stream_kv else 0}")
                log(f"  {name}: decode replay {dec['wall_ms']:.2f} ms wall, "
                    f"{dec['device_ms']:.2f} ms of kernels, {dec['copy_ms']:.2f} ms of copies; "
                    f"H2D {dec['h2d']} bytes (expected {h2d}), D2H {dec['d2h']} bytes "
                    f"(expected {back} of streamed and {resident['ssm']} of RESIDENT M state "
                    f"+ the (2, {B}) fetch); {dec['write_backs']} write-back kernels; prefill "
                    f"replay {pre['wall_ms']:.2f} ms, H2D {pre['h2d']}, D2H {pre['d2h']}")
            preds = planner_steps(bundle, eng.policy, shape)
            in_place = sum(reads.values())
            table.append((name, ewma * 1e3, preds, dec, in_place, tp))
            log(f"  {name}: decode {tp['decode_tps']:.1f} tok/s, prefill "
                f"{tp['prefill_tps']:.1f} tok/s, step EWMA {ewma * 1e3:.2f} ms; planner "
                f"{preds['spec'].step_s * 1e3:.3f} ms spec, "
                f"{preds['calibrated'].step_s * 1e3:.3f} ms calibrated (limited by "
                f"{preds['calibrated'].limiting})")
            if reads:
                log(f"  {name}: read and written in place over PCIe by the decode replay's "
                    f"kernels: {in_place} bytes = {in_place / rate * 1e3:.2f} ms at the "
                    f"calibrated {rate / 1e9:.2f} GB/s")
            del server, reqs, eng
            gc.collect()
            torch.cuda.empty_cache()
            host_memory(f"{cfg.name} {name} freed ({time.perf_counter() - t0:.1f} s)")
        if cfg.name == "mamba2-780m":
            s_ = cfg.ssm
            di, n = s_.d_inner(cfg.d_model), s_.d_state
            formula = n_m * B * (s_.n_heads(cfg.d_model) * s_.head_dim * n * 4
                                 + (s_.d_conv - 1) * (di + 2 * n) * 2)
            kv_host = next(r for r in table if r[0] == "kv_host")
            if kv_host[3]["d2h"] != formula + 2 * B * 4:
                failed.append(f"mamba2 kv_host D2H {kv_host[3]['d2h']} != {formula} + the fetch")
            log(f"  mamba2-780m state a step: {formula} bytes each way = {n_m} layers x {B} "
                f"rows x ({s_.n_heads(cfg.d_model)}*{s_.head_dim}*{n}*4 + "
                f"{s_.d_conv - 1}*{di + 2 * n}*2)")
        first = tokens["hbm_resident"]
        diff = {k: [i for i, (a, b) in enumerate(zip(v, first)) if a != b]
                for k, v in tokens.items() if v != first}
        if diff:
            failed.append(f"{cfg.name}: greedy tokens differ from hbm_resident's: {diff}")
        else:
            digest = hashlib.sha256(json.dumps(first).encode()).hexdigest()
            log(f"  {cfg.name}: greedy tokens identical across {', '.join(tokens)} for all "
                f"{len(first)} requests (SHA-256 {digest})")
        log(f"  {cfg.name} (8 slots x 2048, bf16): policy | decode step EWMA ms | planner "
            "spec / calibrated ms (limit) | decode H2D / D2H bytes a step | read in place "
            "bytes (ms at the calibrated rate) | decode tok/s | prefill tok/s")
        for name, ms, preds, dec, in_place, tp in table:
            moved = "- / -" if dec is None else f"{dec['h2d']} / {dec['d2h']}"
            log(f"    {name} | {ms:.2f} | {preds['spec'].step_s * 1e3:.3f} / "
                f"{preds['calibrated'].step_s * 1e3:.3f} ({preds['calibrated'].limiting}) | "
                f"{moved} | {in_place} ({in_place / rate * 1e3:.2f}) | "
                f"{tp['decode_tps']:.1f} | {tp['prefill_tps']:.1f}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("phase 10d:\n" + "\n".join(failed))
    log(f"  phase 10d took {time.perf_counter() - t_phase:.1f} s")
    return kv_launches


#: the placements phase 10g serves seamless-m4t-medium under
SEAMLESS_PLACED = ("hbm_resident", "kv_host", "weights_stream",
                   "kv=host:stream,params=host:stream")


def phase_seamless_placed_serving():
    """10g: seamless-m4t-medium at full width and depth in bf16 (8 slots x
    2048, chunk 256), serving phase 4's first 8 prompts (16 new tokens
    each) through the CUDA graphs under each of SEAMLESS_PLACED, over the
    same N(0, 1) cross KV (a frontend's projection) in every slot: greedy
    tokens equal hbm_resident's; one decode and one prefill replay's H2D
    bytes equal the streamed windows' (the decoder's weights, each layer's
    self and cross KV) and their D2H the (2, B) fetch; a streamed cache's
    replays launch one write-back a layer (self only); the build's and the
    replays' audits ``ok``; the host cross KV unchanged, bit for bit.
    Returns the served requests' write-back launches and cross-attention
    launches in decode and prefill replays."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.placement import Role
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.serve import ServeConfig

    c = SEAMLESS
    cfg = get_config("seamless-m4t-medium")
    B, S, L, H, D = c["B"], c["Smax"], cfg.n_layers, c["H"], c["D"]
    log(f"== phase 10g: {cfg.name} bfloat16 at full width and depth under "
        f"{', '.join(SEAMLESS_PLACED)}, through the CUDA graphs")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    cross_fill = torch.randn((L, B, H, cfg.frontend_tokens, D), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5)
                             ).to(torch.bfloat16)
    prompts = dense_prompts(cfg.vocab)[0][:8]
    new, shape = 16, ShapeSpec("serve", S, B, "decode")
    host_memory("before phase 10g")
    tokens, failed = {}, []
    counts = {"kv_stream": 0, "cross_decode": 0, "cross_prefill": 0}
    for pol in SEAMLESS_PLACED:
        t0 = time.perf_counter()
        scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=c["chunk"], policy=pol)

        def fill(server):
            for t in tree_leaves(server.engine.caches["decoder"]["cross"]):
                t.copy_(cross_fill)
            torch.cuda.synchronize()

        server, reqs, wall, launches = serve_requests(bundle, params, scfg, prompts, new,
                                                      before=fill)
        eng, st = server.engine, server.stats()
        name = eng.policy.name
        stream_kv = eng.runtime.streamed(Role.KV_CACHE)
        cross = tree_leaves(eng.caches["decoder"]["cross"])
        want = {"decode_attention": L * st["decode_steps"],
                "prefill_attention": L * st["prefill_dispatches"], "ssd_scan": 0,
                "flash_attention": L * (st["decode_steps"] + st["prefill_dispatches"]),
                "kv_stream": L * (st["decode_steps"] + st["prefill_dispatches"])
                if stream_kv else 0}
        if launches != want:
            failed.append(f"{name}: launches {launches} != {want}")
        counts["kv_stream"] += launches["kv_stream"]
        counts["cross_decode"] += L * st["decode_steps"]
        counts["cross_prefill"] += L * st["prefill_dispatches"]
        if stream_kv and eng.graph_launches["decode"].get("kv_stream") != L:
            failed.append(f"{name}: {eng.graph_launches['decode']} a decode replay, want "
                          f"{L} kv_stream (the self rows only)")
        tokens[name] = [r.out_tokens for r in reqs]
        feed = eng.feed
        expect = feed.h2d_bytes() if feed is not None else 0
        if feed is not None:
            log(f"  {name}: windows a step "
                f"{ {k: v.n_windows for k, v in feed.streams().items()} }, "
                f"{ {k: sum(v.window_bytes) for k, v in feed.streams().items()} } bytes; "
                f"{sum(b.numel() for s_ in feed.streams().values() for b in s_.buffers()) / 2**30:.2f}"
                " GiB of device staging slots")
        before = [t.cpu() for t in cross]
        dec = replay_traffic(f"10g {name} decode", eng.decode)
        eng.stage_prefill(np.ones((B, c["chunk"]), np.int32),
                          np.full(B, c["chunk"], np.int32),
                          np.arange(0, B * c["chunk"], c["chunk"], dtype=np.int32))
        torch.cuda.synchronize()
        pre = replay_traffic(f"10g {name} prefill", eng._graphs["prefill"].replay)
        torch.cuda.synchronize()
        for label, tr in (("decode", dec), ("prefill", pre)):
            if abs(tr["h2d"] - expect) > 0.02 * max(expect, 1):
                failed.append(f"{name} {label}: H2D {tr['h2d']} bytes, the windows "
                              f"{expect}; copies {sorted(tr['sizes'].items())[:12]}")
            if tr["write_backs"] != (L if stream_kv else 0):
                failed.append(f"{name} {label}: {tr['write_backs']} write-back kernels, "
                              f"expected {L if stream_kv else 0}")
        if dec["d2h"] != 2 * B * 4 or pre["d2h"] != 0:
            failed.append(f"{name}: D2H memcpy {dec['d2h']} / {pre['d2h']} bytes, expected "
                          f"the (2, {B}) fetch only")
        audit_replays(f"seamless-m4t {name} (phase 10g)", server)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b.cpu()) for a, b in zip(before, cross)):
            failed.append(f"{name}: the cross KV changed")
        preds = planner_steps(bundle, eng.policy, shape)
        log(f"  {name}: decode step EWMA {eng.measured_step_s * 1e3:.2f} ms against the "
            f"planner's {preds['spec'].step_s * 1e3:.3f} ms spec, "
            f"{preds['calibrated'].step_s * 1e3:.3f} ms calibrated (limited by "
            f"{preds['calibrated'].limiting}); decode replay {dec['wall_ms']:.2f} ms wall, H2D "
            f"{dec['h2d']} bytes (windows {expect}), D2H {dec['d2h']}, {dec['write_backs']} "
            f"write-backs; prefill replay {pre['wall_ms']:.2f} ms, H2D {pre['h2d']}, "
            f"{pre['write_backs']} write-backs; cross KV "
            f"{'in pinned host memory' if cross[0].device.type == 'cpu' else 'on the card'}, "
            f"unchanged; launches per replay {eng.graph_launches}")
        del server, reqs, eng, feed, cross, before
        gc.collect()
        torch.cuda.empty_cache()
        host_memory(f"{name} freed ({time.perf_counter() - t0:.1f} s)")
    first = tokens["hbm_resident"]
    diff = {k: [i for i, (a, b) in enumerate(zip(v, first)) if a != b]
            for k, v in tokens.items() if v != first}
    if diff:
        failed.append(f"greedy tokens differ from hbm_resident's: {diff}")
    if failed:
        raise AssertionError("phase 10g:\n" + "\n".join(failed))
    digest = hashlib.sha256(json.dumps(first).encode()).hexdigest()
    log(f"  greedy tokens identical across the {len(tokens)} placements for all "
        f"{len(first)} requests (SHA-256 {digest})")
    del params, cross_fill
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 10g took {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_migrate():
    """10e: Runtime.migrate of the yi-6b serving cache (8 x 2048, bf16) from
    device memory to pinned host memory and back, value for value, timed
    beside the planner's price_copy on phase 9d's calibration."""
    import gc

    import torch
    from repro_torch.api import Runtime
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import MemoryTier
    from repro_torch.core.placement import Placement, host_bytes
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves

    log("== phase 10e: Runtime.migrate of the yi-6b cache, device -> pinned host -> device")
    bundle = ModelBundle(get_config("yi-6b"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    cache = bundle.init_cache(YI["B"], YI["Smax"], device="cuda")
    for t in tree_leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
    nbytes = host_bytes(cache)
    rt = Runtime(bundle, "cuda")
    rt.calibrate(ROOT / "build" / "calibration.json", activate=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = rt.migrate(cache, "kv", "kv_host")
    torch.cuda.synchronize()
    to_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rt.migrate(host, "kv", Placement(MemoryTier.HBM))
    torch.cuda.synchronize()
    to_dev_s = time.perf_counter() - t0
    if not all(h.is_pinned() for h in tree_leaves(host)):
        raise AssertionError("the migrated cache is not in pinned host memory")
    for a, b, c in zip(tree_leaves(cache), tree_leaves(host), tree_leaves(back)):
        if not (torch.equal(a.cpu(), b) and torch.equal(a, c)):
            raise AssertionError("migration changed a value")
    log(f"  {nbytes / 2**30:.3f} GiB: to pinned host {to_host_s * 1e3:.1f} ms (pinning "
        f"included; priced {rt.price_copy(nbytes, 'host', src='hbm') * 1e3:.1f} ms), back "
        f"{to_dev_s * 1e3:.1f} ms (priced {rt.price_copy(nbytes, 'hbm', src='host') * 1e3:.1f}"
        f" ms) on the calibration; value for value; policy now {rt.policy.name}")
    del cache, host, back
    gc.collect()
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# preemption, replan, faults and recovery, the asyncio Scheduler
# ---------------------------------------------------------------------------

#: phase 11's serving shape: phase 4's, with preemption on
PREEMPT = dict(every=2, wait=4)


def percentiles(reqs):
    """p50/p99 of completion latency and time to first token, ms."""
    import numpy as np

    lat = np.asarray([r.finished_s - r.submitted_s for r in reqs]) * 1e3
    ttft = np.asarray([r.first_token_s - r.submitted_s for r in reqs]) * 1e3
    return {"latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99))}


def serve_arrivals(server, prompts, new_tokens, every=PREEMPT["every"], hook=None):
    """Requests arriving one every ``every`` ticks (``prompts[i]`` at tick
    ``every * i``), ``new_tokens`` greedy tokens each, stepped until
    drained; ``hook(server)`` after each tick.  Returns the requests."""
    from repro_torch.serve import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    pending, tick = list(reqs), 0
    while pending or server.has_work():
        while pending and tick >= every * (len(reqs) - len(pending)):
            server.add_request(pending.pop(0))
        server.step()
        tick += 1
        if hook is not None:
            hook(server)
        if tick > 20_000:
            raise AssertionError("the serve loop did not drain")
    for r in reqs:
        if not r.done or len(r.out_tokens) != new_tokens:
            raise AssertionError(f"request {r.rid}: done={r.done}, {len(r.out_tokens)} tokens")
    return reqs


def pinned_spills(server):
    """Every spilled sequence parked on the host tier lies in pinned host
    memory (checked after each tick)."""
    from repro_torch.core.hardware import MemoryTier
    from repro_torch.models.sharding import tree_leaves

    for sp in server._spilled.values():
        if sp.tier is MemoryTier.HOST and not all(
                t.device.type == "cpu" and t.is_pinned() for t in tree_leaves(sp.rows)):
            raise AssertionError(f"rid {sp.rid}: spilled rows not in pinned host memory")


def log_moves(label, server, price_policy=None):
    """Wall ms of each spill and restore, by where the parked rows lay,
    against the planner's round-trip price of one slot's bytes under the
    cache placement the moves ran under (``price_policy``, default the
    server's policy now)."""
    from repro_torch.api import Runtime

    eng = server.engine
    nbytes = eng.slot_bytes()
    rt = server.runtime if price_policy is None else Runtime(
        server.bundle, server.device, price_policy)
    spill_to, price = rt.preemption_price(nbytes)
    parts = []
    for kind, where in sorted({(k, w) for k, w, _, _ in eng.moves}, reverse=True):
        v = [dt * 1e3 for k, w, _, dt in eng.moves if (k, w) == (kind, where)]
        parts.append(f"{kind} ({where}) {len(v)} x, {min(v):.2f} / "
                     f"{statistics.median(v):.2f} / {max(v):.2f} ms min / median / max")
    log(f"  {label}: a slot is {nbytes} bytes; " + "; ".join(parts or ["no moves"])
        + f"; the planner's round trip to {spill_to.to_str()} and back "
        f"{price * 1e3:.3f} ms ({rt.policy.name})")


def fresh_counts(bundle, params, scfg, policy):
    """The kernels one replay of each graph launches on a server built
    fresh under ``policy``: what a rebuild under it must capture again."""
    import copy
    import dataclasses
    import gc

    import torch
    from repro_torch.serve import Server

    server = Server(bundle, dataclasses.replace(scfg, policy=policy), params, device="cuda")
    counts = copy.deepcopy(server.engine.graph_launches)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_counts(label, server, want):
    """The graphs in force launch, per replay, what a fresh server's do
    under the same policy (``want``: graph -> kernel -> launches)."""
    got = server.engine.graph_launches
    if got != want:
        raise AssertionError(f"{label}: launches per replay {got} under "
                             f"{server.policy.name}, a fresh server's {want}")


def check_launches(label, server, builds):
    """Every decode step and prefill dispatch was a graph replay, and the
    replays launched, of each kernel whose per-replay count is the same in
    every build the run went through (``builds``: their ``graph_launches``),
    that count times the replays; one build: every kernel exactly.  Logs
    the launches."""
    eng = server.engine
    c = eng.counters
    if (c["decode_replays"], c["prefill_replays"]) != (
            c["decode_steps"], c["prefill_dispatches"]):
        raise AssertionError(f"{label}: replays differ from steps and dispatches: {c}")
    got = eng.replay_launches
    for k in {k for b in builds for g in b.values() for k in g}:
        per = {tuple(b.get(g, {}).get(k, 0) for g in ("decode", "prefill")) for b in builds}
        if len(per) == 1:
            nd, npf = per.pop()
            want = nd * c["decode_replays"] + npf * c["prefill_replays"]
            if got[k] != want:
                raise AssertionError(f"{label}: {got[k]} {k} launches, {nd} x "
                                     f"{c['decode_replays']} + {npf} x "
                                     f"{c['prefill_replays']} expected")
    log(f"  {label}: {c['decode_replays']} decode + {c['prefill_replays']} prefill "
        f"replays launched {dict(sorted(got.items()))} "
        f"({eng.graph_launches} per replay now)")


def check_preempted(label, server, reqs, want_tokens, counts):
    """At least one preemption, every one promoted back, no capture after
    construction, the launches per replay of a fresh server (``counts``)
    times the replays, greedy tokens per rid as in ``want_tokens``."""
    st = server.stats()
    if st["preemptions"] < 1 or st["promotions"] != st["preemptions"]:
        raise AssertionError(f"{label}: preemptions {st['preemptions']}, "
                             f"promotions {st['promotions']}")
    if st["captures"] != 2:
        raise AssertionError(f"{label}: {st['captures']} captures, expected the 2 of "
                             "construction (a slot move must not capture)")
    check_counts(label, server, counts)
    check_launches(label, server, [counts])
    diff = [r.rid for r in reqs if r.out_tokens != want_tokens[r.rid][:len(r.out_tokens)]]
    if diff:
        raise AssertionError(f"{label}: greedy tokens differ for requests {diff}")
    p = percentiles(reqs)
    log(f"  {label}: {len(reqs)} requests, {st['preemptions']} preemptions = "
        f"{st['promotions']} promotions, captures {st['captures']}, tokens identical; "
        f"latency p50 {p['latency_p50_ms']:.1f} / p99 {p['latency_p99_ms']:.1f} ms, TTFT "
        f"p50 {p['ttft_p50_ms']:.1f} / p99 {p['ttft_p99_ms']:.1f} ms; spill "
        f"{st['spill_s'] * 1e3:.1f} ms, restore {st['restore_s'] * 1e3:.1f} ms in all; "
        f"watchdog {server.watchdog.actions}")
    log_moves(label, server)


def replan_run(label, bundle, params, scfg, prompts, want_tokens, counts, new=16):
    """Serve ``prompts`` (all at once, ``new`` tokens each) and replan
    hbm_resident -> kv_host after the 3rd tick, back after the 9th: each
    replan captures both graphs exactly once, and they launch per replay
    what a fresh server's do under the new policy (``counts``: policy ->
    graph_launches); the tokens are the unreplanned run's."""
    import dataclasses

    from repro_torch.serve import Request, Server

    server = Server(bundle, dataclasses.replace(scfg, policy="hbm_resident"), params,
                    device="cuda")
    check_counts(label, server, counts["hbm_resident"])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    n, caps = 0, []
    while server.has_work():
        server.step()
        n += 1
        if n in (3, 9):
            target = "kv_host" if n == 3 else "hbm_resident"
            before = server.stats()["captures"]
            if not server.replan(target):
                raise AssertionError(f"{label}: replan at tick {n} did not migrate")
            caps.append(server.stats()["captures"] - before)
            check_counts(f"{label} after the replan to {target}", server, counts[target])
    if caps != [2, 2]:
        raise AssertionError(f"{label}: captures per replan {caps}, expected [2, 2]")
    check_launches(label, server, [counts["hbm_resident"], counts["kv_host"]])
    diff = [r.rid for r in reqs if r.out_tokens != want_tokens[r.rid][:new]]
    if diff or not all(r.done for r in reqs):
        raise AssertionError(f"{label}: tokens across the replans differ for {diff}")
    for what, pol, mig, build in server.engine.migration_log:
        log(f"  {label}: {what} -> {pol}: migrate {mig * 1e3:.1f} ms, rebuild (feed, "
            f"snapshot, warm-ups, restore, 2 captures) {build * 1e3:.1f} ms")
    log(f"  {label}: hbm_resident -> kv_host -> hbm_resident with {len(prompts)} live "
        f"requests: tokens identical to the unreplanned run, 2 captures a replan, "
        f"watchdog {server.watchdog.actions}")


def chaos_plan(seed=0):
    """Phase 11d's seeded schedule: a stall past the deadline early, the
    first spill corrupted, the host tier lost at a later decode pass (the
    corrupted spill has been promoted by then), the evacuation's first
    migration failing once."""
    import numpy as np
    from repro_torch.core.faults import FaultEvent, FaultKind, FaultPlan

    rng = np.random.default_rng(seed)
    return FaultPlan([
        FaultEvent("decode", at=int(rng.integers(8, 16)), kind=FaultKind.STALL,
                   seconds=1.0),
        FaultEvent("spill", at=0, kind=FaultKind.SPILL_CORRUPT),
        FaultEvent("decode", at=int(rng.integers(36, 48)), kind=FaultKind.TIER_LOSS,
                   tier="host"),
        FaultEvent("migrate", at=0, kind=FaultKind.MIGRATE_FAIL, error="transient"),
    ], seed=seed)


def async_run(server, prompts, new_tokens, every_s=0.02):
    """Phase 11e: the asyncio Scheduler over ``server``; client ``i``
    submits its prompt ``every_s * i`` seconds in and streams its tokens.
    Returns the requests."""
    import asyncio

    from repro_torch.serve import Scheduler

    sched = Scheduler(server)

    async def client(i):
        await asyncio.sleep(every_s * i)
        req = await sched.submit(prompts[i], max_new_tokens=new_tokens, rid=i)
        streamed = [tok async for tok in sched.stream(req)]
        if streamed != req.out_tokens:
            raise AssertionError(f"request {i}: streamed tokens differ from out_tokens")
        return req

    async def main():
        async def clients():
            reqs = await asyncio.gather(*(client(i) for i in range(len(prompts))))
            sched.close()
            return reqs
        _, reqs = await asyncio.gather(sched.run(), clients())
        return reqs

    return asyncio.run(main())


def phase_preemption(yi_tokens, mamba_tokens, counts):
    """11: preemption and promotion (a) on yi-6b and (b) mamba2-780m at full
    width and depth, phase 4's / 8c's requests arriving one every 2 ticks,
    tokens identical to those phases', no capture; (c) replans with live
    rows; (d) chaos under kv_host; (e) the asyncio Scheduler; (f) the
    port's bench_llm_inference queued leg on (a)'s model and requests.
    ``counts``: per arch, phase 4's / 8c's launches per replay (a fresh
    ``hbm_resident`` server's), which every server here and every rebuild
    under that policy must reproduce."""
    import dataclasses
    import gc

    import torch
    from repro_torch.benchmarks import bench_llm_inference
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import MemoryTier
    from repro_torch.core.placement import Role
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig, Server

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = get_config("yi-6b")
    log(f"== phase 11: preemption, replan, faults and recovery, the asyncio Scheduler "
        f"({cfg.name} and mamba2-780m bfloat16, full width and depth, through the graphs)")
    bundle = ModelBundle(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    prompts, _ = dense_prompts(cfg.vocab)
    y = YI
    base = ServeConfig(batch_slots=y["B"], max_len=y["Smax"], prefill_chunk=y["chunk"])
    pre = dataclasses.replace(base, preempt=True, preempt_wait=PREEMPT["wait"],
                              verify_spills=True)
    yi_counts = {"hbm_resident": counts[cfg.name],
                 "kv_host": fresh_counts(bundle, params, base, "kv_host")}
    log(f"  launches per replay, fresh {cfg.name} servers: {yi_counts}")

    t0 = time.perf_counter()
    server = Server(bundle, pre, params, device="cuda")
    reqs = serve_arrivals(server, prompts, 64, hook=pinned_spills)
    check_preempted(f"11a {cfg.name}", server, reqs, yi_tokens, yi_counts["hbm_resident"])
    log(f"  11a took {time.perf_counter() - t0:.1f} s")
    del server, reqs
    free()

    t0 = time.perf_counter()
    replan_run(f"11c {cfg.name}", bundle, params, base, prompts[:8], yi_tokens, yi_counts)
    log(f"  11c ({cfg.name}) took {time.perf_counter() - t0:.1f} s")
    free()

    t0 = time.perf_counter()
    plan = chaos_plan()
    server = Server(bundle, dataclasses.replace(pre, policy="kv_host", faults=plan),
                    params, device="cuda")
    check_counts("11d at construction", server, yi_counts["kv_host"])
    reqs = serve_arrivals(server, prompts[:12], 32, hook=pinned_spills)
    st = server.stats()
    want = {"tier_losses": 1, "evacuations": 1, "spill_corruptions": 1}
    got = {k: st[k] for k in want}
    if (got != want or st["migration_retries"] < 1 or st["watchdog_stalls"] < 1
            or st["requeued_fresh"] < 1 or MemoryTier.HOST not in server.runtime.lost_tiers
            or server.policy.placement(Role.KV_CACHE).tier is not MemoryTier.HBM
            or st["captures"] != 4):
        raise AssertionError(f"11d: recovery counters {st}, policy {server.policy.name}")
    check_counts("11d after the evacuation", server, yi_counts["hbm_resident"])
    check_launches("11d", server, [yi_counts["kv_host"], yi_counts["hbm_resident"]])
    diff = [r.rid for r in reqs if r.out_tokens != yi_tokens[r.rid][:32]]
    if diff:
        raise AssertionError(f"11d: greedy tokens differ from the no-fault run for {diff}")
    log(f"  11d chaos under kv_host: {len(reqs)} requests all ended, greedy tokens identical "
        f"to phase 4's (no faults); tier_losses {st['tier_losses']}, evacuations "
        f"{st['evacuations']} (policy now {server.policy.name}), migration_retries "
        f"{st['migration_retries']}, watchdog_stalls {st['watchdog_stalls']} (actions "
        f"{server.watchdog.actions}), spill_corruptions {st['spill_corruptions']}, "
        f"requeued_fresh {st['requeued_fresh']}, preemptions {st['preemptions']}, "
        f"promotions {st['promotions']}, captures {st['captures']}")
    for what, pol, mig, build in server.engine.migration_log:
        log(f"  11d: {what} -> {pol}: migrate {mig * 1e3:.1f} ms, rebuild {build * 1e3:.1f} ms")
    log("  11d firing record: " + json.dumps(plan.to_json()["fired"]))
    log_moves("11d", server, price_policy="kv_host")
    log(f"  11d took {time.perf_counter() - t0:.1f} s")
    del server, reqs
    free()

    t0 = time.perf_counter()
    server = Server(bundle, pre, params, device="cuda")
    reqs = async_run(server, prompts, 64)
    st = server.stats()
    diff = [r.rid for r in reqs if r.out_tokens != yi_tokens[r.rid]]
    if diff or st["captures"] != 2 or st["promotions"] != st["preemptions"]:
        raise AssertionError(f"11e: tokens differ for {diff}; {st}")
    check_counts("11e", server, yi_counts["hbm_resident"])
    check_launches("11e", server, [yi_counts["hbm_resident"]])
    p = percentiles(reqs)
    log(f"  11e asyncio Scheduler: {len(reqs)} clients streamed their tokens, identical to "
        f"phase 4's; {st['preemptions']} preemptions; latency p50 "
        f"{p['latency_p50_ms']:.1f} / p99 {p['latency_p99_ms']:.1f} ms; took "
        f"{time.perf_counter() - t0:.1f} s")
    del server, reqs
    free()

    # 11f: the benchmark's leg at (a)'s shape; its odd rids sample
    t0 = time.perf_counter()
    row = bench_llm_inference.queued("cuda", bundle=bundle, params=params, config=base,
                                     prompts=prompts, max_new=64)
    if row["preemptions"] < 1 or row["promotions"] != row["preemptions"]:
        raise AssertionError(f"11f: queued leg {row['preemptions']} preemptions, "
                             f"{row['promotions']} promotions")
    if row["graph_launches"] != yi_counts["hbm_resident"]:
        raise AssertionError(f"11f: launches per replay {row['graph_launches']}")
    n_decode = yi_counts["hbm_resident"]["decode"]["decode_attention"]
    if row["replay_launches"].get("decode_attention") != n_decode * row["decode_replays"]:
        raise AssertionError(f"11f: launches {row['replay_launches']}, "
                             f"{row['decode_replays']} decode replays")
    diff = [i for i, t in enumerate(row["tokens"]) if i % 2 == 0 and t != yi_tokens[i]]
    sampled = row["tokens"][1::2]
    if diff or not all(len(t) == 64 and all(0 <= x < cfg.vocab for x in t) for t in sampled):
        raise AssertionError(f"11f: greedy tokens differ from phase 4's for {diff}, or a "
                             "sampled request came back short or out of range")
    log(f"  11f bench_llm_inference queued leg ({row['arch']}, {row['requests']} requests of "
        f"{min(row['prompt_lens'])}-{max(row['prompt_lens'])} tokens, 64 new, into "
        f"{row['batch_slots']} x {row['max_len']} slots, chunk {row['prefill_chunk']}, "
        f"even rids greedy and identical to phase 4's, odd ones sampled; spill tier "
        f"{row['spill_tier']}): latency p50 {row['latency_p50_s'] * 1e3:.2f} / p99 "
        f"{row['latency_p99_s'] * 1e3:.2f} ms, TTFT p50 {row['ttft_p50_s'] * 1e3:.2f} / "
        f"p99 {row['ttft_p99_s'] * 1e3:.2f} ms, {row['preemptions']} preemptions, "
        f"{row['decode_replays']} decode + {row['prefill_replays']} prefill replays "
        f"launched {row['replay_launches']}; took {time.perf_counter() - t0:.1f} s")
    del params, bundle
    free()

    mcfg = get_config("mamba2-780m")
    mbundle = ModelBundle(mcfg)
    mparams = mbundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    mprompts = ssm_prompts(mcfg.vocab, 16, 1536)
    mbase = ServeConfig(batch_slots=MAMBA["B"], max_len=2048, prefill_chunk=MAMBA["T"])
    m_counts = {"hbm_resident": counts[mcfg.name],
                "kv_host": fresh_counts(mbundle, mparams, mbase, "kv_host")}
    log(f"  launches per replay, fresh {mcfg.name} servers: {m_counts}")
    t0 = time.perf_counter()
    server = Server(mbundle, dataclasses.replace(
        mbase, preempt=True, preempt_wait=PREEMPT["wait"], verify_spills=True),
        mparams, device="cuda")
    reqs = serve_arrivals(server, mprompts, 64, hook=pinned_spills)
    check_preempted(f"11b {mcfg.name}", server, reqs, mamba_tokens, m_counts["hbm_resident"])
    log(f"  11b took {time.perf_counter() - t0:.1f} s")
    del server, reqs
    free()
    t0 = time.perf_counter()
    replan_run(f"11c {mcfg.name}", mbundle, mparams, mbase, mprompts[:8], mamba_tokens,
               m_counts)
    log(f"  11c ({mcfg.name}) took {time.perf_counter() - t0:.1f} s")
    del mparams, mbundle
    free()


# ---------------------------------------------------------------------------
# encoder-decoder and VLM (ROADMAP A7): seamless-m4t-medium, internvl2-1b
# ---------------------------------------------------------------------------

class NoChunkBundle:
    """A bundle whose ``prefill_at`` raises ``NotImplementedError``: the
    ``Executor`` admits its requests by decode-step replay."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def prefill_at(self, *args, **kwargs):
        raise NotImplementedError


def scale_attention(params):
    """An encoder-decoder's attention projections (encoder, decoder self
    and cross) scaled by 1/sqrt(their fan-in), in place.  seamless-smoke's
    init draws them at 1/sqrt(2), so its scores reach ~140 and every
    softmax is nearly one-hot: f32 rounding is amplified so far that the
    model's own float32 and float64 runs of 3 AdamW steps part by 3 % in
    grad norm at step 2 and 46 % at step 3 (on the CPU); scaled, by 1e-6.
    The CPU parity tests condition it the same way."""
    for stack in ("encoder", "decoder"):
        for block in params[stack].values():
            if "w_o" in block:
                for w in ("w_q", "w_k", "w_v", "w_o"):
                    t = block[w]
                    fan_in = t.shape[1] * t.shape[2] if w == "w_o" else t.shape[1]
                    t.mul_(fan_in ** -0.5)
    return params


def frontend_key(bundle):
    """The batch key of a frontend model's stub embeddings."""
    from repro_torch.models.multimodal import FRONTEND_KEYS

    return FRONTEND_KEYS[bundle.cfg.frontend]


def a7_serve_smoke(bundle, params, dev, prompts):
    """Greedy tokens of ``prompts`` (6 new each) through ``Server`` (2
    slots x 64, chunk 4) on ``dev``; returns (server, tokens per rid)."""
    from repro_torch.serve import Request, ServeConfig, Server

    server = Server(bundle, ServeConfig(batch_slots=2, max_len=64, prefill_chunk=4),
                    params, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    server.add_requests(reqs)
    server.run_until_done(max_steps=1000)
    if not all(r.done and len(r.out_tokens) == 6 for r in reqs):
        raise AssertionError(f"{bundle.cfg.name} on {dev}: requests unfinished")
    return server, {r.rid: r.out_tokens for r in reqs}


def phase_a7_parity():
    """3d: seamless-smoke and internvl2-smoke in float32, card against CPU
    from the same weights (seamless-smoke's attention projections at
    1/sqrt(fan-in): :func:`scale_attention`): ``Server`` tokens (the
    card's through its graphs), ``bundle.prefill`` over nonzero frame /
    patch embeddings then 6 ``decode_step``s, 3 AdamW steps at phase 3b's
    limits; and seamless-smoke admitted by decode-step replay on the
    card."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    log("== phase 3d: seamless-m4t-smoke (encoder-decoder) and internvl2-smoke (patch "
        "embeddings) float32, card against CPU")
    t_phase = time.perf_counter()
    tcfg = TrainConfig(remat="full", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    for arch in ("seamless-m4t-medium", "internvl2-1b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        bundle = ModelBundle(cfg)
        key = frontend_key(bundle)
        params_cpu = bundle.init_params(torch.Generator().manual_seed(0))
        if bundle.encdec:
            scale_attention(params_cpu)
        params = {"cpu": params_cpu,
                  "cuda": tree_map(lambda t: t.to("cuda", copy=True), params_cpu)}
        L, F = cfg.n_layers, cfg.frontend_tokens

        # served greedy tokens, the card's through its graphs
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (9, 14, 3, 6, 11)]
        tokens = {}
        for dev in ("cuda", "cpu"):
            server, tokens[dev] = a7_serve_smoke(bundle, params[dev], dev, prompts)
            if dev == "cuda":
                cross = {"flash_attention": L} if bundle.encdec else {}
                want = {"decode": {"decode_attention": L, **cross},
                        "prefill": {"prefill_attention": L, **cross}}
                if server.engine.graph_launches != want:
                    raise AssertionError(f"{arch}: launches per replay "
                                         f"{server.engine.graph_launches} != {want}")
                if not server.engine.counters["decode_replays"]:
                    raise AssertionError("the card's server replayed no decode graph")
        if tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{arch}: card/CPU served tokens differ: {tokens}")
        log(f"  {cfg.name}: served greedy tokens identical for {len(prompts)} requests "
            f"(per replay {server.engine.graph_launches})")

        # prefill over nonzero embeddings, then greedy decode steps
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (3, 10), generator=g,
                                         dtype=torch.int32),
                 key: torch.randn(3, F, cfg.d_model, generator=g)}
        start = 10 if bundle.encdec else 10 + F
        seqs, logits_of = {}, {}
        for dev in ("cuda", "cpu"):
            cache = bundle.init_cache(3, 64, device=dev)
            with torch.no_grad():
                logits, _ = bundle.prefill(params[dev], {k: v.to(dev) for k, v in
                                                         batch.items()}, cache)
                toks, seq, lg = torch.argmax(logits, -1), [], [logits.cpu()]
                for i in range(6):
                    seq.append(toks.cpu())
                    lengths = torch.full((3,), start + i, dtype=torch.int32, device=dev)
                    logits, _ = bundle.decode_step(
                        params[dev], {"tokens": toks[:, None].to(torch.int32),
                                      "lengths": lengths}, cache)
                    toks = torch.argmax(logits, -1)
                    lg.append(logits.cpu())
            if bundle.encdec and not cache["decoder"]["cross"]["k"].abs().amax() > 0:
                raise AssertionError(f"{arch}: prefill left the cross cache zero")
            seqs[dev], logits_of[dev] = torch.stack(seq), torch.stack(lg)
        if not torch.equal(seqs["cuda"], seqs["cpu"]):
            raise AssertionError(f"{arch}: card/CPU prefill + decode tokens differ: {seqs}")
        gap = float((logits_of["cuda"] - logits_of["cpu"]).abs().max())
        log(f"  {cfg.name}: prefill over {F} nonzero {key} + 6 decode steps: greedy tokens "
            f"identical {seqs['cuda'].T.tolist()}; logits at most {gap:.3e} apart "
            f"(largest |logit| {float(logits_of['cpu'].abs().max()):.3e})")

        # 3 AdamW steps
        text = 64 if bundle.encdec else 64 - F
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=text, global_batch=4))
        frng = np.random.default_rng(3)
        batches = [dict(next(data), **{key: frng.normal(size=(4, F, cfg.d_model)).astype(
            np.float32)}) for _ in range(3)]
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev, copy=True), params_cpu)
            opt, step = init_opt_state(p), make_train_step(bundle, tcfg)
            before = (flash_attention.launches, flash_attention_bwd.launches)
            out = []
            for b in batches:
                p, opt, _, m = step(p, opt, None, {k: torch.from_numpy(v).to(dev)
                                                   for k, v in b.items()})
                out.append((float(m["loss"]), float(m["grad_norm"])))
            res[dev] = out
            if dev == "cuda":
                n = (flash_attention.launches - before[0],
                     flash_attention_bwd.launches - before[1])
                # no remat in the encoder-decoder (as in the reference):
                # encoder, self and cross once each; the LM under "full" twice
                per = cfg.n_encoder_layers + 2 * L if bundle.encdec else 2 * L
                want = (3 * per, 3 * (per if bundle.encdec else L))
                if n != want:
                    raise AssertionError(f"{arch}: attention launches {n} != {want}")
        for i, ((lc, gc), (lp, gp)) in enumerate(zip(res["cuda"], res["cpu"])):
            lim = 1e-5 if i == 0 else 1e-3
            if abs(lc - lp) > lim * abs(lp) or abs(gc - gp) > 1e-2 * abs(gp):
                raise AssertionError(f"{arch} step {i + 1}: card loss {lc} grad norm {gc} "
                                     f"vs CPU {lp} {gp}")
        log(f"  {cfg.name}: 3 AdamW steps, (loss, grad norm) card {res['cuda']} cpu "
            f"{res['cpu']}")

    # decode-step replay admission on the card: no prefill graph
    cfg = dataclasses.replace(smoke_config("seamless-m4t-medium"), dtype="float32")
    bundle = ModelBundle(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (9, 14, 3, 6, 11)]
    _, want = a7_serve_smoke(bundle, params, "cuda", prompts)
    server, got = a7_serve_smoke(NoChunkBundle(bundle), params, "cuda", prompts)
    st = server.stats()
    if got != want:
        raise AssertionError(f"replay admission tokens {got} != chunked admission's {want}")
    if (server.engine.supports_chunked_prefill or set(server.engine.graph_launches) != {"decode"}
            or st["decode_replay_prefills"] != len(prompts) or st["prefill_replays"]):
        raise AssertionError(f"replay admission: {st}, graphs "
                             f"{server.engine.graph_launches}")
    log(f"  {cfg.name} admitted by decode-step replay: tokens those of chunked admission, "
        f"decode_replay_prefills {st['decode_replay_prefills']}, "
        f"{st['decode_replays'] - st['decode_steps']} admission replays of the decode "
        f"graph, no prefill graph")
    log(f"== phase 3d took {time.perf_counter() - t_phase:.1f} s")


def seamless_slot_bytes(cfg, S):
    """One slot's cache bytes in bf16: each decoder layer's self KV over
    ``S`` positions and its cross KV over the frames."""
    a = cfg.attention
    return cfg.n_layers * 2 * a.n_kv_heads * a.d_head * (S + cfg.frontend_tokens) * 2


def phase_seamless_full():
    """4f: seamless-m4t-medium at full width and depth (12 + 12 layers) in
    bf16, weights drawn on the card from seed 0, 8 slots x 2048, chunk
    256.  (a) phase 4's 16 requests through the graphs: per decode replay
    12 decode_attention (self) and 12 flash_attention (cross, one query
    against 1024 frames), per prefill dispatch 12 prefill_attention and 12
    flash_attention; a slot's bytes; finite logits; the decode EWMA
    beside the planner's price; (c) ``bundle.prefill`` of 8 rows with 1024
    frame embeddings and 256-token prompts into the graphed server's
    caches, then 32 decode steps through its decode graph, and again with a
    preemption round trip of slot 3 (nonzero cross KV) at step 16: tokens
    unchanged; (b) the 16 requests eagerly, tokens identical to (a).
    Returns the flash_attention launches of (a) by use, and the decode and
    prefill kernels' (the self-attention's)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.placement import parse_policy
    from repro_torch.core.planner import predict
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import tree_leaves
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.state import SlotTable

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    c = SEAMLESS
    cfg = get_config("seamless-m4t-medium")
    a = cfg.attention
    log(f"== phase 4f: {cfg.name} bfloat16 at full width and depth ({cfg.n_encoder_layers} "
        f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, {a.n_heads}/"
        f"{a.n_kv_heads} heads of {a.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.frontend_tokens} frames; {cfg.num_params() / 1e9:.3f} B params), through "
        "the CUDA graphs")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    B, S, L = c["B"], c["Smax"], cfg.n_layers
    scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=c["chunk"])
    slot = seamless_slot_bytes(cfg, S)
    price = predict(bundle.decode_workload(ShapeSpec("serve", S, B, "decode")),
                    parse_policy("hbm_resident"), SPEC_SYSTEM).step_s
    prompts, _ = dense_prompts(cfg.vocab)

    # (a) through the graphs
    t0 = time.perf_counter()
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st, eng = server.stats(), server.engine
    per = {"decode": {"decode_attention": L, "flash_attention": L},
           "prefill": {"prefill_attention": L, "flash_attention": L}}
    if eng.graph_launches != per:
        raise AssertionError(f"4f: launches per replay {eng.graph_launches} != {per}")
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"],
            "flash_attention": L * (st["decode_steps"] + st["prefill_dispatches"]),
            "ssd_scan": 0, "kv_stream": 0}
    if launches != want:
        raise AssertionError(f"4f: launches {launches} != {want}")
    if server.policy.name != "hbm_resident":
        raise AssertionError(f"4f: the planner picked {server.policy.name}")
    if eng.slot_bytes() != slot or bundle.cache_bytes_for(1, S) != slot:
        raise AssertionError(f"4f: a slot is {eng.slot_bytes()} bytes, want {slot}")
    check_logits(bundle, params, server, B)
    ewma = eng.measured_step_s
    tp = server.throughput()
    self_b = 2 * a.n_kv_heads * S * a.d_head * 2
    cross_b = 2 * a.n_kv_heads * cfg.frontend_tokens * a.d_head * 2
    log(f"  (a) graphs: a slot is {slot} bytes ({L} x {self_b} self KV + {L} x {cross_b} "
        f"cross KV); decode {tp['decode_tps']:.1f} tok/s, prefill {tp['prefill_tps']:.1f} "
        f"tok/s; decode step EWMA {ewma * 1e3:.2f} ms against the planner's hbm_resident "
        f"price {price * 1e3:.3f} ms ({ewma / price:.2f}x); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights "
        f"{weights / 2**30:.2f}); finite logits; took {time.perf_counter() - t0:.1f} s")
    # the cross-attention's launches: per replay (counted at capture) x replays
    cross_launches = {ph: eng.graph_launches[ph]["flash_attention"] * st[f"{ph}_replays"]
                      for ph in ("decode", "prefill")}
    # and the self-attention's
    self_launches = {k: eng.graph_launches[ph][k] * st[f"{ph}_replays"] for ph, k in
                     (("decode", "decode_attention"), ("prefill", "prefill_attention"))}

    # (d) where a decode step's and a prefill dispatch's device time goes
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    for i in range(B):
        server.submit(rng.integers(0, cfg.vocab, 1024),
                      max_new_tokens=4 * trace_attempts() + 5, rid=100 + i)
    server.step()
    server.step()
    dec = profile_window("4f (d) graphs: decode step at 8 x ~1030 cached tokens",
                         server.step, 4, expected_trace(server, "decode"))
    server.run_until_done()
    ptoks = rng.integers(0, cfg.vocab, (B, c["chunk"])).astype(np.int32)
    offs = np.arange(0, B * c["chunk"], c["chunk"], dtype=np.int32)
    pre = profile_window("4f (d) graphs: prefill dispatch (8 x 256 tokens at fills "
                         "0..1792)", lambda: eng.dispatch_prefill(
                             ptoks, np.full(B, c["chunk"], np.int32), offs),
                         steps=2, expect=expected_trace(server, "prefill"))
    log(f"  (d) a decode step {dec['busy_ms']:.2f} ms of device time, a prefill dispatch "
        f"{pre['busy_ms']:.2f} ms; took {time.perf_counter() - t0:.1f} s")

    # (c) frames encoded into the graphed server's caches, decoded through
    # its decode graph, with and without a preemption round trip
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, c["chunk"])).astype(np.int32))
    frames = torch.randn(B, cfg.frontend_tokens, cfg.d_model, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4)
                         ).to(torch.bfloat16)
    spill = eng.runtime.spill_placement()

    def decode_from_frames(round_trip):
        flash_attention.launches = 0
        with torch.no_grad():
            logits, _ = bundle.prefill(params, {"tokens": toks.cuda(), "frame_embeds": frames},
                                       eng.caches)
        if not torch.isfinite(logits).all():
            raise AssertionError("4f (c): non-finite prefill logits")
        n_pre = flash_attention.launches
        cross = eng.caches["decoder"]["cross"]["k"]
        if not cross[:, 3].abs().amax() > 0:
            raise AssertionError("4f (c): slot 3's cross KV is zero after prefill")
        first = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        state = SlotTable(B).mirrors()
        state.update(tokens=first[:, None], lengths=np.full(B, c["chunk"], np.int32),
                     active=np.ones(B, bool))
        eng.state.put(state)
        out, moved = [first], None
        for i in range(32):
            if round_trip and i == 16:
                rows = eng.extract_slot(3, spill)
                for leaf in tree_leaves(eng.caches):
                    leaf[:, 3].zero_()
                eng.insert_slot(3, rows)
                moved = (spill.to_str(), eng.moves[-2], eng.moves[-1])
            out.append(eng.decode()[0])
        return np.stack(out), n_pre, moved

    plain, n_pre, _ = decode_from_frames(False)
    moved_tokens, _, moved = decode_from_frames(True)
    if n_pre != cfg.n_encoder_layers + 2 * L:
        raise AssertionError(f"4f (c): prefill launched {n_pre} flash_attention, want "
                             f"{cfg.n_encoder_layers} encoder + {L} self + {L} cross")
    if not np.array_equal(plain, moved_tokens):
        raise AssertionError("4f (c): tokens changed across the round trip of slot 3")
    log(f"  (c) bundle.prefill of {B} rows x {cfg.frontend_tokens} frames + {c['chunk']} "
        f"tokens into the server's caches ({n_pre} flash_attention launches: "
        f"{cfg.n_encoder_layers} encoder, {L} decoder self, {L} cross; finite logits), then "
        f"32 decode replays; slot 3 (nonzero cross KV) spilled to {moved[0]} and back at "
        f"step 16 ({moved[1][2]} bytes, {moved[1][3] * 1e3:.2f} + {moved[2][3] * 1e3:.2f} ms):"
        f" all {B} rows' tokens unchanged; took {time.perf_counter() - t0:.1f} s")
    del server, eng
    free()

    # (b) eagerly
    eager, ereqs, _, elaunches = serve_requests(bundle, params, scfg, prompts, 64,
                                                eager=True)
    est = eager.stats()
    if elaunches["flash_attention"] != L * (est["decode_steps"] + est["prefill_dispatches"]):
        raise AssertionError(f"4f (b): eager launches {elaunches}")
    same_tokens(cfg.name, reqs, ereqs)
    del eager, params, bundle
    free()
    log(f"== phase 4f took {time.perf_counter() - t_phase:.1f} s")
    return cross_launches, self_launches


def phase_internvl_full():
    """4g: internvl2-1b at full width and depth (24 layers, 14/2 heads) in
    bf16, 8 slots x 2048, chunk 256: phase 4's 16 requests through the
    graphs (24 decode_attention a decode replay, 24 prefill_attention a
    dispatch; finite logits) and eagerly, tokens identical; then
    ``bundle.prefill`` of 8 rows of 256 patch embeddings + 256 tokens
    (finite logits, one flash_attention a layer) and 8 decode steps."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import ServeConfig

    c = INTERNVL
    cfg = get_config("internvl2-1b")
    a = cfg.attention
    log(f"== phase 4g: {cfg.name} bfloat16 at full width and depth ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {a.n_heads}/{a.n_kv_heads} heads, "
        f"{cfg.num_params() / 1e9:.3f} B params), through the CUDA graphs, then eager")
    t_phase = time.perf_counter()
    bundle = ModelBundle(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    B, S, L = c["B"], c["Smax"], cfg.n_layers
    scfg = ServeConfig(batch_slots=B, max_len=S, prefill_chunk=c["chunk"])
    prompts, _ = dense_prompts(cfg.vocab)
    server, reqs, _, launches = serve_requests(bundle, params, scfg, prompts, 64)
    st = server.stats()
    want = {"decode_attention": L * st["decode_steps"],
            "prefill_attention": L * st["prefill_dispatches"], "flash_attention": 0,
            "ssd_scan": 0, "kv_stream": 0}
    if launches != want:
        raise AssertionError(f"4g: launches {launches} != {want}")
    check_logits(bundle, params, server, B)
    ewma = server.engine.measured_step_s
    del server
    gc.collect()
    torch.cuda.empty_cache()
    eager, ereqs, _, _ = serve_requests(bundle, params, scfg, prompts, 64, eager=True)
    same_tokens(cfg.name, reqs, ereqs)
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    n_text = c["chunk"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32)).cuda()
    patches = torch.randn(B, c["patches"], cfg.d_model, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(4)
                          ).to(torch.bfloat16)
    cache = bundle.init_cache(B, S, device="cuda")
    flash_attention.launches = 0
    with torch.no_grad():
        logits, _ = bundle.prefill(params, {"tokens": toks, "patch_embeds": patches}, cache)
        n_pre = flash_attention.launches
        seq = []
        for i in range(8):
            tok = torch.argmax(logits, -1).to(torch.int32)
            seq.append(tok)
            lengths = torch.full((B,), c["patches"] + n_text + i, dtype=torch.int32,
                                 device="cuda")
            logits, _ = bundle.decode_step(params, {"tokens": tok[:, None],
                                                    "lengths": lengths}, cache)
            if not torch.isfinite(logits).all():
                raise AssertionError("4g: non-finite logits after the patch prefill")
    if n_pre != L:
        raise AssertionError(f"4g: the patch prefill launched {n_pre} flash_attention, want {L}")
    log(f"  prefill of {B} rows x ({c['patches']} patch embeddings + {n_text} tokens): "
        f"{n_pre} flash_attention launches, finite logits; 8 decode steps after it, tokens "
        f"of row 0 {[int(t[0]) for t in seq]}; graphs' decode step EWMA {ewma * 1e3:.2f} ms; "
        f"took {time.perf_counter() - t0:.1f} s")
    del cache, params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== phase 4g took {time.perf_counter() - t_phase:.1f} s")


def phase_a7_train_full():
    """6d: training at full width and depth in bf16 through
    ``make_train_step``, 4 AdamW steps of 4 x 2048 tokens each:
    seamless-m4t-medium over 1024 frame embeddings a row (no remat, as the
    reference's encoder-decoder loss: a step launches 12 encoder + 12
    decoder self + 12 cross attention forwards and as many backwards) and
    internvl2-1b with 256 patch embeddings and 1792 text tokens a row
    (remat ``full``: 2 x 24 forwards, 24 backwards); finite losses, tokens/s,
    peak memory.  Returns, by model, the attention launches (forward,
    backward) by use, read from the wrappers' counts by shape."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.models.sharding import torch_dtype
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    out = {}
    for arch, c in (("seamless-m4t-medium", SEAMLESS), ("internvl2-1b", INTERNVL)):
        cfg = get_config(arch)
        bundle = ModelBundle(cfg)
        key, F = frontend_key(bundle), cfg.frontend_tokens
        B, S, steps = c["train_B"], c["train_S"], c["steps"]
        text = S if bundle.encdec else S - F
        log(f"== phase 6d: training {cfg.name} bfloat16 at full width and depth, "
            f"{cfg.num_params() / 1e9:.3f} B params, batch {B} x ({F} {key} + {text} tokens), "
            f"{steps} AdamW steps")
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
        opt = init_opt_state(params)
        step = make_train_step(bundle, TrainConfig(
            remat="full", optimizer=AdamWConfig(lr=3e-4, warmup_steps=2)))
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=text, global_batch=B))
        gen = torch.Generator(device="cuda").manual_seed(1)
        flash_attention.launches = flash_attention_bwd.launches = 0
        flash_attention.by_shape.clear()
        flash_attention_bwd.by_shape.clear()
        losses, norms, times = [], [], []
        for _ in range(steps):
            batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(data).items()}
            batch[key] = torch.randn(B, F, cfg.d_model, generator=gen, device="cuda").to(
                torch_dtype(cfg.dtype))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, _, metrics = step(params, opt, None, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            times.append(time.perf_counter() - t0)
        launches = (flash_attention.launches, flash_attention_bwd.launches)
        L = cfg.n_layers
        if bundle.encdec:
            want = (steps * (cfg.n_encoder_layers + 2 * L),) * 2
        else:
            want = (steps * 2 * L, steps * L)
        if launches != want:
            raise AssertionError(f"6d {arch}: attention launches {launches} != {want}")
        # each use by its (mask, Sq, Sk): the decoder's (or the LM's) own
        # causal attention, the encoder's and the cross-attention
        uses = {"self": ("causal", S, S)}
        if bundle.encdec:
            uses.update(encoder=("bidirectional", F, F), cross=("bidirectional", S, F))
        by_use = {u: (flash_attention.by_shape[k], flash_attention_bwd.by_shape[k])
                  for u, k in uses.items()}
        if bundle.encdec:
            want_use = {u: (steps * n,) * 2 for u, n in (
                ("self", L), ("encoder", cfg.n_encoder_layers), ("cross", L))}
        else:
            want_use = {"self": want}
        if by_use != want_use:
            raise AssertionError(f"6d {arch}: attention launches by use {by_use} != "
                                 f"{want_use}")
        bad = [x for x in losses + norms if not x == x or abs(x) == float("inf")]
        if bad:
            raise AssertionError(f"6d {arch}: non-finite losses / grad norms {bad}")
        steady = statistics.median(times[1:])
        log(f"  losses {losses}; grad norms {norms}; step times "
            f"{[round(t, 4) for t in times]} s; steady step {steady:.4f} s -> "
            f"{B * text / steady:.1f} text tokens/s ({B * F / steady:.1f} {key} "
            f"positions/s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; attention launches "
            f"forward {launches[0]}, backward {launches[1]}, by use (forward, backward) "
            f"{by_use}; took {time.perf_counter() - t_phase:.1f} s")
        out[arch] = by_use
        state = [params, opt]

        def one_step():
            state[:2] = step(state[0], state[1], None, batch)[:2]

        profile_window(f"6d {arch}: a training step", one_step, 1)
        del params, opt, step, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_a7_times(serve_launches, train_launches, errs, self_launches):
    """7d: ``flash_attention`` at seamless-m4t's cross-attention shapes —
    decode (8 x 16 heads, one query against 1024 frames) and a prefill
    chunk (256 queries) — and its encoder's (4 x 16 x 1024 x 1024,
    forward and backward), bidirectional, bf16, past L2, beside the plain
    version, SDPA and the bound; then the decoder's self-attention kernels
    at 4f (d)'s shapes (decode: 8 rows of 1030 cached keys; prefill: 8 x
    256 queries at fills 0..1792), held against their plain versions,
    beside SDPA and the bound, with 4f (a)'s launches (``self_launches``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    c = SEAMLESS
    log("== phase 7d: flash_attention at seamless-m4t's cross-attention and encoder "
        "shapes (bidirectional, head dim 64, bfloat16)")
    dt, isz = torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(11)
    H, D, Fr = c["H"], c["D"], c["frames"]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    bidir = dict(kind="bidirectional")
    recs = {}
    for tag, B, Sq in (("cross-decode", c["B"], 1), ("cross-chunk", c["B"], c["chunk"]),
                       ("encoder", c["train_B"], Fr)):
        sets = [fa_inputs(B, H, H, Sq, Fr, D, dt, gen) for _ in range(4)]
        fwd_in = [(q, k, v) for q, k, v, _ in sets]
        rows_, pairs = B * H * Sq, B * H * Sq * Fr
        rec = dict(
            ms=time_ms(lambda q, k, v: flash_attention(q, k, v, **bidir), fwd_in),
            plain_ms=time_ms(lambda q, k, v: ref.attention(q, k, v, **bidir), fwd_in,
                             reps=2, iters=2),
            library_ms=time_ms(sdpa, fwd_in),
            bytes=rows_ * 2 * D * isz + 2 * B * H * Fr * D * isz + rows_ * 4,
            flops=4 * pairs * D)
        recs[("attention_fwd", tag)] = rec
        if tag == "encoder":
            bwd_in = []
            for q, k, v, dout in sets[:2]:
                o, lse = flash_attention(q, k, v, **bidir)
                bwd_in.append((q, k, v, o, lse, dout))
            q, k, v, dout = sets[0]
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            graph = ref.attention(*qkv, **bidir)
            plain_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout,
                                                            retain_graph=True),
                                [()], reps=2, iters=1)
            graph = sdpa(*qkv)
            lib_bwd = time_ms(lambda: torch.autograd.grad(graph, qkv, dout,
                                                          retain_graph=True), [()])
            del graph, qkv
            recs[("attention_bwd", tag)] = dict(
                ms=time_ms(lambda *a: flash_attention_bwd(*a, **bidir), bwd_in),
                plain_ms=plain_bwd, library_ms=lib_bwd,
                bytes=rows_ * 4 * D * isz + 4 * B * H * Fr * D * isz + rows_ * 4,
                flops=10 * pairs * D)
            del bwd_in
        del sets, fwd_in
        torch.cuda.empty_cache()
    _, bf16_flops_per_s, _ = peaks()
    for (name, tag), rec in recs.items():
        log(f"  {name} {tag}: {rec['flops'] / rec['ms'] / 1e9:.1f} TFLOP/s, "
            f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s, {rec['ms'] / rec['library_ms']:.3f} x "
            f"SDPA's {rec['library_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms")
    enc = train_launches["seamless-m4t-medium"]["encoder"]    # measured in 6d
    launches = {("attention_fwd", "cross-decode"): serve_launches["decode"],
                ("attention_fwd", "cross-chunk"): serve_launches["prefill"],
                ("attention_fwd", "encoder"): enc[0], ("attention_bwd", "encoder"): enc[1]}
    what = {"cross-decode": "cross, decode", "cross-chunk": "cross, prefill chunk",
            "encoder": "encoder"}
    rows = [
        kernel_row(f"{name} (seamless-m4t {what[tag]})",
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:115" if name == "attention_fwd"
                   else "src/repro/kernels/ops.py:66", rec, launches[(name, tag)],
                   errs[(f"{name}_{tag}", "bfloat16")])
        for (name, tag), rec in recs.items()
    ]
    rows += seamless_self_times(self_launches)
    return rows


def seamless_self_times(self_launches):
    """7d (self): the decode and prefill kernels at seamless-m4t's
    self-attention shapes in 4f (d)'s trace, bf16, past L2: each held to
    its plain version by ``check_close`` at ``TOL`` (the prefill's live
    rows), timed beside it, SDPA and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_prefill

    c = SEAMLESS
    B, H, D, Smax, Sn = c["B"], c["H"], c["D"], c["Smax"], c["chunk"]
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, kv, L = decode_inputs(B, H, H, D, Smax, [1030] * B, dt, gen, 2)
    dec = decode_record(q, kv, L)
    got = flash_decode(q, *kv[0], L)
    torch.cuda.synchronize()
    dec_err = check_close(f"decode_attention seamless self B{B} H{H} D{D} Smax{Smax}",
                          got, ref.decode_attention(q, *kv[0], L), "bfloat16")
    del kv, got
    offs = [0, 256, 512, 768, 1024, 1280, 1536, 1792]
    q, srcs = prefill_inputs(B, H, H, D, Smax, Sn, dt, gen, 2)
    q_pos, k_pos = prefill_positions(offs, [Sn] * B, Smax, Sn)
    pre = prefill_record(q, srcs, q_pos, k_pos)
    kc, vc, kn, vn = srcs[0]
    got = flash_prefill(q, kc, vc, q_pos, k_pos, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    # rows with no live key are padding (the kernel gives 0, the plain
    # version mean(V)): both sides discard them, as phase 2 does
    rows = live_mask(q_pos, k_pos, "causal").any(-1)[:, None, :].expand(B, H, Sn)
    pre_err = check_close(f"prefill_attention seamless self B{B} H{H} D{D} Smax{Smax} Sn{Sn}",
                          got, ref.prefill_attention(q, torch.cat([kc, kn], 2),
                                                     torch.cat([vc, vn], 2), q_pos, k_pos),
                          "bfloat16", rows)
    del srcs, got
    torch.cuda.empty_cache()
    for name, rec, err in (("decode_attention", dec, dec_err),
                           ("prefill_attention", pre, pre_err)):
        log(f"  {name} seamless self: max |error| {err:.3e} against the plain version "
            f"(check_close, TOL bfloat16); "
            f"{rec['bytes'] / rec['ms'] / 1e6:.1f} GB/s, {rec['flops'] / rec['ms'] / 1e9:.1f} "
            f"TFLOP/s, {rec['ms'] / rec['library_ms']:.3f} x SDPA's {rec['library_ms']:.4f} ms")
    return [
        kernel_row("decode_attention (seamless-m4t self, decode)",
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:71", dec,
                   self_launches["decode_attention"], dec_err),
        kernel_row("prefill_attention (seamless-m4t self, prefill chunk)",
                   "src/repro_torch/csrc/prefill_attention.cu",
                   "src/repro/kernels/flash_attention.py:237", pre,
                   self_launches["prefill_attention"], pre_err),
    ]


def phase_audit(yi_ewma_s):
    """12 (b)-(d): the gate in a process of its own (exit 0), the roofline
    of yi-6b's served decode step counted on ``meta`` beside phase 4's
    measured step EWMA, and the dry run of yi-6b's cells (host only)."""
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.hardware import SPEC_SYSTEM
    from repro_torch.core.roofline import report_from_step
    from repro_torch.launch.dryrun import input_specs

    log("== phase 12: the audit gate, the served step's roofline, the dry run")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = ROOT / "build" / "audit_report.json"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.audit", "--lint", "--selftest",
         "--transfer-audit", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    for line in res.stdout.splitlines():
        log(f"  12b | {line}")
    if res.returncode != 0:
        raise AssertionError(f"12b: the gate exited {res.returncode}:\n{res.stderr[-4000:]}")
    report = json.loads(out.read_text())
    execs = report["transfer_audit"]["executables"]
    if not report["transfer_audit"]["device"].startswith("cuda"):
        raise AssertionError(f"12b: the gate audited on {report['transfer_audit']['device']}")
    for name in ("replay:decode", "replay:prefill", "restore:insert"):
        if not (execs[name]["ok"] and execs[name]["profiled"]):
            raise AssertionError(f"12b: {name} {execs[name]}")
    checks = report["selftest"]["checks"]
    log(f"  12b: the gate exited 0 in {time.perf_counter() - t0:.1f} s: lint "
        f"{report['lint']['files']} files, {len(report['lint']['violations'])} violations; "
        f"selftest {sum(checks.values())}/{len(checks)} injected cases caught; "
        f"{len(execs)} transfer reports ok (D2H of the decode replay "
        f"{execs['replay:decode']['bytes_by_direction'].get('DtoH', 0):.0f} bytes)")

    shape = ShapeSpec("serve", YI["Smax"], YI["B"], "decode")
    t0 = time.perf_counter()
    bundle, specs = input_specs("yi-6b", shape)

    def step(params, batch, caches):
        with torch.no_grad():
            return bundle.decode_step(params, batch, caches)

    rep, cost = report_from_step(step, specs["params"], specs["batch"], specs["caches"],
                                 arch="yi-6b", shape="decode 8 x 2048",
                                 model_flops=bundle.model_flops(shape),
                                 model_bytes=bundle.model_bytes(shape), system=SPEC_SYSTEM)
    log(f"  12c yi-6b decode step at full width and depth, 8 x 2048, counted on meta in "
        f"{time.perf_counter() - t0:.1f} s ({cost.instruction_count:.0f} ops): "
        f"{cost.flops:.6g} FLOPs, {cost.hbm_bytes:.6g} bytes counted (per aten op, unfused: "
        f"a diagnostic), model_bytes {rep.model_bytes:.6g} (the must-move floor); "
        f"bound_step_s {rep.bound_step_s * 1e3:.4f} ms ({rep.dominant}: memory "
        f"{rep.memory_s * 1e3:.4f} ms at the spec sheet's "
        f"{SPEC_SYSTEM.chip.hbm_bandwidth / 1e12:.2f} TB/s, compute "
        f"{rep.compute_s * 1e3:.4f} ms), bw_fraction {rep.bw_fraction:.4f}; phase 4's "
        f"measured step EWMA {yi_ewma_s * 1e3:.4f} ms = {yi_ewma_s / rep.bound_step_s:.3f} "
        f"x the bound")

    out = ROOT / "build" / "dryrun.json"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--out",
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"  12d | {line}")
    recs = json.loads(out.read_text()) if out.exists() else []
    counts = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "failed")}
    log(f"  12d dry run of yi-6b's cells (the whole --all sweep takes minutes of host "
        f"time, so only yi-6b's here): {wall:.1f} s wall, {counts['ok']} ok, "
        f"{counts['skipped']} skipped, {counts['failed']} failed")
    if res.returncode != 0 or counts["failed"] or not counts["ok"]:
        raise AssertionError(f"12d: the dry run exited {res.returncode}, {counts}:\n"
                             f"{res.stderr[-4000:]}")


def kernel_row(name, source, replaces, rec, launches, max_abs_err):
    """One entry of the ``kernels`` JSON line; logs it."""
    from repro_torch.core.hardware import SPEC_SYSTEM

    hbm_bytes_per_s, bf16_flops_per_s, f32_flops_per_s = peaks()
    t_bytes = rec["bytes"] / hbm_bytes_per_s * 1e3
    if rec.get("pcie_bytes"):       # bytes that must cross PCIe to the host
        t_bytes = max(t_bytes, rec["pcie_bytes"] / SPEC_SYSTEM.chip.pcie_bandwidth * 1e3)
    # the operation bound at the peak of the row's type: the bf16 tensor
    # cores unless the record is a float32 kernel's (its FMAs run on the
    # CUDA cores)
    t_ops = rec["flops"] / (f32_flops_per_s if rec.get("dtype") == "float32"
                            else bf16_flops_per_s) * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": rec["library_ms"],
    }
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"
    log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {lib}, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {rec['bytes']} bytes, {rec['flops']} flops; "
        f"f32 CUDA-core floor {rec['flops'] / f32_flops_per_s * 1e3:.4f} ms), "
        f"{launches} launches on the main path")
    return row


def add_launches(rows, name, n):
    """Add ``n`` launches from a later phase's run to the ``kernels`` line's
    row ``name``."""
    row = next(r for r in rows if r["name"] == name)
    row["launches"] += n
    log(f"  {name}: {row['launches']} launches on the main path with the later phases' {n}")


def main() -> int:
    # the script drives one card: show torch only the first visible one, so
    # the device count it reports is the count it used
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = visible or "0"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_ssd_kernels())
    bwd_rec, bwd_err = phase_ssd_bwd_kernels()
    phase_smoke_parity()
    phase_train_parity()
    phase_ssm_train_parity()
    phase_ssm_parity()
    phase_a7_parity()
    launches, stats, plens, server, eager, yi_tokens = phase_full()
    per_replay = {"yi-6b": copy.deepcopy(server.engine.graph_launches)}
    measured = {"graphs": server.engine.measured_step_s,
                "eager": eager.engine.measured_step_s}
    rows = phase_times(launches, stats, plens, errs)
    servers = {"graphs": server, "eager": eager}
    profile_decode(servers)
    profile_prefill(servers)
    audit_replays("yi-6b hbm_resident (phase 4)", server)
    del server, eager, servers
    torch.cuda.empty_cache()
    for name, n in phase_mesh_serve(yi_tokens, measured["graphs"]).items():
        if name in ("decode_attention", "prefill_attention"):
            add_launches(rows, name, n)
    phase_tp_kernels()
    phase_granite_full()
    t4c = time.perf_counter()
    ring_recs, ring_errs = phase_ring_kernels()
    gemma_launches, gemma_kv_launches = phase_gemma_full()
    rows += [
        kernel_row(f"{name} (gemma3-27b)", src, replaces, ring_recs[name],
                   gemma_launches[name], ring_errs[n])
        for name, src, replaces, n in (
            ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:71", "decode"),
            ("prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
             "src/repro/kernels/flash_attention.py:237", "prefill"),
        )
    ]
    log(f"== phase 4c took {time.perf_counter() - t4c:.1f} s")
    llama_launches, llama_per, llama_recs, llama_errs = phase_llama4_full(plens)
    rows += [
        kernel_row(f"{name} (llama4-maverick {what})", src, replaces, llama_recs[name],
                   llama_per["decode"][name] * llama_launches["decode_attention"],
                   llama_errs[n])
        for name, what, src, replaces, n in (
            ("decode_attention", "G decode", "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:71", "decode"),
            ("prefill_attention", "C decode", "src/repro_torch/csrc/prefill_attention.cu",
             "src/repro/kernels/flash_attention.py:237", "prefill"),
        )
    ]
    phase_deepseek_full()
    cross_launches, seamless_self = phase_seamless_full()
    phase_internvl_full()
    server, eager, params, ssm_launches, mamba_tokens = phase_mamba_full()
    per_replay["mamba2-780m"] = copy.deepcopy(server.engine.graph_launches)
    rows.append(phase_ssd_times({"graphs": server, "eager": eager}, ssm_launches, errs))
    del server, eager, params
    torch.cuda.empty_cache()
    phase_zamba_full()
    out, train_launches = phase_train_full()
    profile_train(out)
    olmo_run = {k: out[k] for k in ("losses", "grad_norms", "step_s")}
    del out
    torch.cuda.empty_cache()
    rows += phase_train_times(train_launches, errs)
    rows += phase_mla_train_times(phase_mla_train_full(), errs)
    rows += phase_a7_times(cross_launches, phase_a7_train_full(), errs, seamless_self)
    ssm_train_launches = phase_ssm_train_full()
    rows.append(kernel_row("ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
                           "src/repro/kernels/ops.py:162", bwd_rec,
                           ssm_train_launches["ssd_scan_bwd"], bwd_err))
    e2e_launches = phase_train_e2e()
    rows += phase_pod_train_times(e2e_launches, phase_gemma_train_full(), errs)
    for name, n in phase_mesh_train(olmo_run).items():
        add_launches(rows, name, n)
    phase_gemm_kernel()
    rows.append(phase_gemm_study())
    torch.cuda.empty_cache()
    rows += phase_membench()
    torch.cuda.empty_cache()
    phase_calibrate()
    phase_planner_benches()
    planner_against_measured(measured)
    phase_collective_benches()
    t10 = time.perf_counter()
    kv_rec, kv_err = phase_kv_stream_kernel()
    kv_launches, _ = phase_placed_serving()
    placed_train = [phase_opt_host_training(), phase_yi_opt_host_training()]
    kv_launches += phase_ssm_placed_serving() + gemma_kv_launches
    seamless_placed = phase_seamless_placed_serving()
    kv_launches += seamless_placed["kv_stream"]
    for name, n in (("attention_fwd", sum(t["attention_fwd"] for t in placed_train)),
                    ("attention_bwd", sum(t["attention_bwd"] for t in placed_train)),
                    ("attention_fwd (seamless-m4t cross, decode)",
                     seamless_placed["cross_decode"]),
                    ("attention_fwd (seamless-m4t cross, prefill chunk)",
                     seamless_placed["cross_prefill"])):
        add_launches(rows, name, n)
    rows.append(kernel_row(
        "kv_stream", "src/repro_torch/csrc/kv_stream.cu",
        "none: no Pallas original (the reference's host transfers are XLA's, "
        "src/repro/core/placement.py:875 to_host)", kv_rec, kv_launches, kv_err))
    phase_migrate()
    log(f"== phase 10 took {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    phase_preemption(yi_tokens, mamba_tokens, per_replay)
    log(f"== phase 11 took {time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    phase_audit(measured["graphs"])
    log(f"== phase 12 (b)-(d) took {time.perf_counter() - t12:.1f} s")
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
