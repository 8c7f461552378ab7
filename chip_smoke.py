#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json PATH] [--ptxas] [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the GPU's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 off for every plain and library call;
2. build: compile the kernels of ``src/repro_torch/csrc`` with nvcc
   (timed; ``--ptxas`` prints each kernel's registers and shared memory);
3. kernels: every step that reaches a kernel in the plans of the rungs of
   phase 4 for AlexNet, LeNet-5 and the CIFAR-10 net, at batch 1 and 16 —
   K1 (fused conv+pool[+LRN] and the per-layer advanced SIMD conv), K2
   (conv chain+pool), K3 (fc matmul), K7 (fused and per-layer basic SIMD
   conv), K8 (basic parallel conv), K9 (standalone pool) — each kernel
   against its plain PyTorch version on the card (max abs <= 1e-4 *
   max(1, max|plain|)), a repeat bit for bit and, for K1-K8 but K9 at
   batch 16, frame 0 bit for bit against the kernel on frame 0 alone (the
   stage-major kernels K1, K2, K4, K5 and K6 sum each output in an
   order fixed by the stage's shape, so this holds though their schedule
   follows the batch; K3's weight stream slices K by K, N and the SM count
   alone), then timed
   with CUDA events (median of 25 after warm-up) beside its plain version,
   one PyTorch library call as a yardstick and its bound (each case line
   also prints ``bound_share``, bound / kernel time, and ``host_ms``, the
   wrapper's host time a call: the mean of ``HOST_REPS`` calls enqueued
   back to back, which the card's queue absorbs; K3's and K9's also
   ``device_ms``, the device time a call without the host gap, as in 7a;
   K9's also its grid, ``pool_plan``'s); and the
   second-generation cells at batch 1
   and 16 — K4 (oc-blocked LRN cell) on AlexNet's conv1+pool1+norm1 and
   conv2+pool2+norm2, K5 (pool carry) on AlexNet's conv1+pool1 and
   conv2+pool2 (norms unfused) and the CIFAR-10 net's three groups, K6
   (oc-blocked chain) on AlexNet's conv3-5+pool5 with ``oc_block_final``
   8 and 64 — held, repeated and timed the same way, K4 and K5 also bit
   for bit against K1 on the same group (one plan).  Each K1/K2/K4-K6
   case line carries its cooperative launch's geometry (``chain``: grid,
   blocks an SM holds, grid barriers, scratch MB, each stage's unit,
   items and whether an item takes the whole reduction); a batch-16 grid
   under 128 blocks or past the co-residency limit fails;
4. engine: ``CNNEngine(net, method=..., fuse_pool=...).forward`` on the
   card at batch 16 (paper §6.2) on six rungs — ``advanced_simd_8`` fused
   and unfused, ``basic_simd`` fused and unfused, ``basic_parallel``,
   ``seq_ref`` — for AlexNet at full width, LeNet-5 and CIFAR-10, with
   seeded random weights carried in by ``params_from_numpy``: each
   forward is run with the launch counters set to 0 just before it and
   read just after, and they must equal ``EXPECTED_LAUNCHES``; the output
   must match the CPU engine at the same rung on the same weights (max
   abs <= 1e-4, same argmax) and two more runs must agree bit for bit; the
   forward is timed; no default plan may launch K4, K5 or K6; the
   repeated forwards of the default fused rung must reuse the weights'
   padded HWIO copies (``chain_weights``) made by the first;
5. tuned deploy: ``repro_torch.core.deploy.save_model(tuned=TUNED)``
   writes full-width AlexNet with the seeded weights, ``load_engine``
   builds it on the card and on the CPU, and its forward at batch 16 and
   at batch 1 must launch exactly K3 ×3, K4, K5 and K6 once each and
   nothing else, match the CPU engine (max abs <= 1e-4, same argmax),
   repeat bit for bit, and is timed beside the default fused engine on the
   same weights and frames;
5b. the cost model on the card, on phase 4's seeded weights: the
   network ladder (every net × method × fused and unfused where the
   method fuses, 24 rows) measured at batch 16 by
   ``repro_torch.tools.cost_fit.measure_ladder`` (the mean of
   ``COST_ITERS`` readings of ``CNNEngine.time_forward`` a row,
   round-robin over the rows, as the committed fit); the committed
   ``cuda`` model (``src/repro_torch/core/COST_MODEL.json``) validated on
   those fresh rows by ``repro_torch.tools.cost_validate.validate`` — its
   Spearman rank correlation over all rows must reach ``COST_RHO`` — and
   refitted on them as the committed model was fitted and with the JAX
   package's holdout of every 3rd point (every fit's coefficients and
   Spearman values printed); ``repro_torch.tools.autotune.tune`` with the committed model
   for LeNet-5, CIFAR-10 and AlexNet at batch 16, each written with the
   seeded weights by ``write_and_check`` (which must return 0) and
   rebuilt by ``load_engine`` on the card and on the CPU; the cost gate
   (``compile_plan(cost_gate=fusion_cost_gate(model, batch=16))``) for
   every net × fusable method, its groups printed beside the ungated
   ones.  Each tuned deployment and AlexNet's gated plan run at batch 16
   with the counters set to 0 just before and read just after, and must
   launch exactly what the plan's steps name (``plan_launches``), match
   the CPU (max abs <= 1e-4 · max(1, max|CPU|), same argmax), repeat bit
   for bit, and are timed with CUDA events beside the default fused
   forward on the same weights and frames;
6. serving: ``CNNServer`` over full-width AlexNet on the card
   (``max_batch=16``, a fake clock, the default degradation ladder with
   ``queue_high=0, degrade_after=1, cooldown=0``) takes ragged waves of
   16, 5, 1, 3 and 16 seeded frames.  A wave below ``max_batch`` waits one
   step in the queue, which is pressure, so the ladder moves one rung down
   before the wave is served: the waves are served on
   ``advanced_simd_8/fused``, ``advanced_simd_4/fused``,
   ``basic_simd/fused`` and twice ``basic_simd/unfused``, in buckets 16,
   8, 1, 4 and 16.  Every result's top-5 must equal the CPU engine's at
   that rung (probabilities within 1e-4), the bucket cache must stay
   within ``log2(16)+1`` compiles, the counters must show every kernel of
   the ladder ran, and a ``FaultScript`` poisoning one request of a batch
   of 16 must leave the 15 survivors' whole probability rows
   byte-identical to the fault-free run (on the top and the bottom rung);
7. the language model, gemma2-2b at full width (``repro_torch.serving.
   engine.ServingEngine`` over ``repro_torch.models``):
   a. kernel cases at its shapes, held, repeated and timed as in phase 3:
      K10 (flash attention; b 1, 8 heads over 4 kv heads, head_dim 256,
      causal, cap 50) in bf16 at 512 and 4500 tokens with window 4096 and
      0, with cap 0 at window 0 (where SDPA, the yardstick, computes the
      same function), at the other served lengths (16, 300, 1500) with
      window 4096, in bf16 at 1500 tokens with head_dim 128 (16 heads over
      8), head_dim 64 (32 over 8) and without causal masking, and in fp32
      at 512 and at 4500 with window 4096.  Each K10 launch must step the
      counter of the path ``k10_path`` names (TMA + wgmma for bf16, the
      CUDA-core kernel for fp32); on the wgmma path the CUDA-core kernel
      is held and timed beside it (simt, wgmma, wgmma, simt) and must be
      at least ``K10_WGMMA_GAIN`` times slower at 4500 tokens, and SDPA
      with ``is_causal`` is timed where the window does not bite.  K3 in
      bf16 at the seven projections' five shapes for M = 4 (a decode
      step), M = 16, 300, 1500 and 4500 (the prefills) and M = 64, and at
      the gate's shape for M = 48; every element within ``rtol * |plain| +
      atol`` (``LM_KERNEL_TOL``), each case with its ``host_ms``.  Each
      K3 launch must step the counter of the path ``k3_path`` names: the
      weight stream below 64 rows, TMA + wgmma from 64 on, where the
      CUDA-core tile is held and timed beside it (tile, wgmma, wgmma,
      tile) and must be at least ``K3_WGMMA_GAIN`` times slower at 4500.
      On the stream, row 0 must equal the same row called alone bit for
      bit, ``STREAM_GRAPH_LAUNCHES`` calls are captured into a CUDA graph
      whose replay gives the device time a call (``device_ms``, no host
      gap), and the M = 48 case, which reads w once as M = 4 does, must
      take under ``STREAM_ROWS_READ_ONCE`` times the M = 4 gate's device
      time;
   b. CPU parity: the model with its depth cut to one local/global pair,
      float32, random weights from ``--seed`` on the card and the same on
      the CPU, the CPU's calls in one fixed order (one intra-op thread,
      and MKL's conditional numerical reproducibility ``MKL_CBWR`` set
      before torch loads); a 64-token prompt prefilled (K10 once a layer
      on the card, on the CUDA-core kernel)
      and 8 greedy tokens decoded on
      both must agree (``LM_TOL``) and give the same tokens, and the
      final bf16 KV caches must agree within one rounding
      (``LM_CACHE_TOL``);
   c. the full model: 26 layers in bf16 with a bf16 KV cache, weights
      drawn on the card from ``--seed``, ``ServingEngine(max_batch=4,
      max_len=8192)`` serving four greedy requests of ``LM_PROMPTS``
      tokens, 16 new tokens each.  With the counters set to 0 before the
      run and read after, every prefill must launch K10 26 times and K3
      182 times (7 per layer), every decode step K3 182 times and no K10;
      all of a prefill's K3 launches must take the wgmma path from 64
      tokens on and the weight stream below, as must every decode step's;
      all of a prefill's K10 launches must take the wgmma path;
      a second run must give the same tokens.  Each prefill, each decode
      step and the run are timed;
   d. ``torch.profiler`` over one prefill of 1500 tokens and three decode
      steps of the full model: device time by kernel (K3's also by path)
      and the device's busy share;
8. rwkv6-1.6b at full width (the same engine over ``RWKV6LM``), its wall
   time printed:
   a. kernel cases at its shapes, held, repeated and timed as in 7a: K11
      (the WKV6 chunked scan; b 1, 32 heads of 64, chunks of 64) in bf16 at
      16, 37 (a 5-row last sub-chunk), 300, 1500 and 4500 tokens, with
      strong decays at 4500 (finite), in fp32 at 4500, o and the final
      state each element within ``LM_KERNEL_TOL``, each case with its
      ``host_ms``, its ``device_ms`` (graph replay) and its design's
      three launches (``wkv6_plan``: grids, exps, operations, bytes moved,
      scratch bytes and their bound) beside ``wkv6_cost``'s bound; a state
      hand-off (two calls over the halves of 1500 tokens against one over
      the whole); K3 in bf16 at the three
      projection shapes for the M of 7a (4, 16, 64, 300, 1500 and 4500),
      its paths, rows and device times checked and timed as in 7a;
   b. CPU parity as 7b: two layers in float32, the leaves the init rules
      leave at zero redrawn (``repro_torch.nn.rwkv.RWKV_REDRAW``), a
      100-token prompt (two
      chunks) prefilled with K11 once a layer and 8 greedy tokens decoded;
      logits (``LM_TOL``), tokens and final states (``LM_CACHE_TOL``) must
      agree with the CPU;
   c. the full model: 24 layers in bf16, an fp32 state cache, the same
      redraw, served as in 7c; every prefill must launch K11 24 times and
      K3 192 times (8 per layer), every decode step K3 192 times and no
      K11, nothing may launch K10, K3's paths as in 7c, a second run must
      repeat the tokens;
      then the profile of 7d (device ms of K3, K11 and the rest);
   d. the launcher ``repro_torch.launch.serve.main(["--arch",
      "rwkv6-1.6b"])`` on the card: a token list for every request, K11
      once a layer in every prefill;
9. qwen3-moe-30b-a3b at full width (the same engine over the MoE
   ``TransformerLM``, ``nn/moe.py``), phases 7 and 8's models freed
   first, its wall time and peak device memory printed:
   a. kernel cases at its attention's shapes, held, repeated and timed as
      in 7a: K10 in bf16 (32 heads over 4, head_dim 128, causal, no cap,
      no window) at 1500 and 4500 tokens, SDPA ``is_causal`` its
      yardstick; K3 in bf16 at q (2048 -> 4096), k and v (2048 -> 512)
      and o (4096 -> 2048) for the M of 7a; none feeds the kernels line;
   b. CPU parity as 7b: two layers in float32, a 64-token prompt
      prefilled (capacity 8 an expert: pairs may drop) and 8 greedy
      tokens decoded; logits (``LM_TOL``), tokens and caches
      (``LM_CACHE_TOL``) must agree, and every MoE call on the card must
      choose the CPU's experts and keep its pairs (``record_routing``
      wraps ``moe_apply``; the smallest margin between a token's k-th and
      (k+1)-th router probability is printed); no decode step may drop;
   c. the full model: 48 layers in bf16 (61.09 GB of weights, drawn on
      the card from ``--seed``, large leaves slice by slice) with a bf16
      KV cache, served as in 7c: every prefill must launch K3 192 times (4
      a layer: the experts are batched ``torch.matmul``) and K10 48 times
      on the wgmma path, every decode step K3 192 times and no K10,
      nothing K11, K3's paths as in 7c, a second run must repeat the
      tokens; the peak device memory must stay under 80 GB;
   d. the profile of 7d, with ranges (``profile_windows``: device time,
      the port's launches and host time of each) on the MoE block and on
      its routing and expert products;
   e. the launcher ``repro_torch.launch.serve.main(["--arch",
      "qwen3-moe-30b-a3b"])`` (reduced) on the card: a token list for
      every request, K10 once a layer in every prefill;
10. zamba2-1.2b at full width (the same engine over ``Zamba2LM``: 38
   Mamba2 (SSD) blocks, ``nn/ssm.py``, and one shared attention block at
   width 4096 after every 6), phase 9's model freed first, its wall time
   and peak device memory printed (28–40 s and 13.85 GB on an NVIDIA
   H100 80GB HBM3 at 700 W, PERF.md: 2.56 GB of weights, 3.39 GB of
   cache, 0.58 GB of fp32 logits at 4500 tokens, the 4500-token
   prefill's temporaries, and before them the fp32 parity model):
   a. kernel cases at its shapes, held, repeated and timed as in 7a: K10
      in bf16 (32 heads over 32, head_dim 128, causal, no cap, no window)
      at 1500 and 4500 tokens, SDPA ``is_causal`` its yardstick; K3 in
      bf16 at its seven projections (``K3_ZAMBA_SHAPES``: in_proj 2048 ->
      8384, whose last 128-wide tile of the wgmma path is half past the
      end of w and y and is held on its own, every row; out_proj, the
      shared q/k/v/o, gate (silu), up, down and shared_out) for the M of
      7a, each launch stepping the counter of the path ``k3_path`` names;
      none feeds the kernels line;
   b. CPU parity as 7b: float32, the depth cut to three layers (one group
      of two Mamba blocks, one shared invocation, a tail of one), the
      leaves the init rules leave at zeros or ones redrawn
      (``repro_torch.nn.ssm.SSM_REDRAW``), a 200-token prompt (two chunks
      of 128, the second padded) prefilled with K10 once (the CUDA-core
      kernel) and 8 greedy tokens decoded; logits (``LM_TOL``), tokens,
      the bf16 KV cache and the fp32 conv rows and SSD states
      (``LM_CACHE_TOL``) must agree with the CPU;
   c. the full model: 38 layers in bf16, the same redraw, served as in
      7c: every prefill must launch K3 124 times (2 a Mamba block, 8 a
      shared invocation: q, k, v, o, gate, up, down, shared_out) and K10
      6 times on the wgmma path, every decode step K3 124 times and no
      K10, nothing K11, K3's paths as in 7c, a second run must repeat the
      tokens;
   d. the profile of 7d, with ranges (as 9d) on the Mamba block, its
      conv, its SSD scan and the shared block;
   e. the launcher ``repro_torch.launch.serve.main(["--arch",
      "zamba2-1.2b"])`` (reduced) on the card: a token list for every
      request, K10 once a shared invocation in every prefill;
11. the cross-attention families at full width, zamba2-1.2b freed first,
   the phase's wall time and peak device memory printed (about 76 s and
   27.68 GB on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md: llama's 19.6
   GB of weights, its cache at 4 slots and the 4500-token prefill's fp32
   logits):
   llama-3.2-vision-11b (``VisionLM``: 8 groups of 4 self layers and one
   gated cross layer, 6400 media tokens of width 4096; 9.79 B parameters,
   19.6 GB in bf16) and seamless-m4t-large-v2 (``EncDecLM``: 24
   bidirectional encoder layers over 4096 frames, 24 decoder layers of
   self-attention, cross-attention and a plain gelu MLP with biases;
   3.27 GB):
   a. kernel cases, held, repeated and timed as in 7a, each with its
      ``host_ms``: K10 in bf16, non-causal, 32 heads over 8 at head_dim
      128 with 16, 1500 and 4500 queries against 6400 keys, 16 over 16 at
      head_dim 64 at 4096 x 4096 (SDPA without a mask the yardstick), and
      seamless's causal decoder self-attention at 1500; K3 in bf16 with a
      bias at 1024 -> 8192 (gelu) and 8192 -> 1024 and without at
      seamless's q/k/v/o 1024 -> 1024 (on the stream 8 K slices of 2 ring
      stages each) and llama's q/o, k/v, gate (silu) and down, for the M
      of 7a and the media's 6400 (the frames' 4096), and the projector and frontend with their
      biases at 6400 and 4096 rows (``K3_CROSS_SHAPES``); none feeds the
      kernels line's times;
   b. CPU parity as 7b, float32, on weights through ``vision_redraw``
      (llama's gates drawn away from 0, its doubly stacked self matrices
      at std 1/sqrt(d_in)): llama cut to one self and one cross layer,
      seamless to one encoder and one decoder layer, both with their media
      (frames) cut to ``CROSS_PARITY_MEDIA``; a 64-token prefill (K10 on
      the CUDA-core kernel, 2 and 3 launches) and 8 greedy tokens: logits
      (``LM_TOL``), tokens and the self and bf16 cross caches
      (``LM_CACHE_TOL``);
   c. both full models in bf16, weights drawn on the card from ``--seed``
      (llama's through ``vision_redraw``), seeded bf16 media (frames):
      for each prompt of ``LM_PROMPTS`` one ``forward(batch, "prefill",
      cache)`` into a cache of ``LM_MAX_LEN`` rows and 16 greedy
      ``decode_step``s, then 4 prompts of 300 tokens and 16 steps at 4
      slots, twice (the same tokens).  With the counters set to 0 before
      each call: llama's prefill K3 281 (the projector, 7 a layer), K10 40
      (32 causal, 8 non-causal), a step K3 264 (7 a self layer, 5 a cross
      layer), no K10; seamless's prefill K3 385 (the frontend, 6 an
      encoder layer, 10 a decoder layer), K10 72 (24 encoder, 24 cross,
      24 causal), a step K3 192; K3 on wgmma for the media's and frames'
      rows and for a prompt's from 64 rows on, the weight stream below;
      every K10 launch on wgmma; finite logits; zeroing llama's gates must
      change the greedy tokens of the 300-token prompt;
   d. the profile of 7d, one prefill of 1500 tokens and three decode
      steps at 4 slots, with ranges as 9d (llama: ``self block``,
      ``cross block``, ``cross decode attention``; seamless: ``encoder``,
      ``decoder layer``, ``cross decode attention``);
   e. the launcher refuses both archs with ``SystemExit`` ("text-only");
12. gemma2-2b on the int8 KV cache (``dataclasses.replace(cfg,
   kv_quant=True)``: int8 k/v and fp16 scales, ``nn/attention.py``),
   plain PyTorch on every device as in the JAX package: ``quantize_kv``
   on the card bit for bit against the CPU (all-zero rows included) and
   ``decode_attention_quant`` against the CPU within ``KVQ_ATTN_TOL`` on
   a full 8192-slot cache and a 4096-slot ring (timed beside the bf16
   cache's ``decode_attention``); then the full model with the same
   weights served on the int8 cache and on the bf16 cache
   (``lm_serving_phase``: 4 slots of 8192 rows, prompts of
   ``KVQ_PROMPTS``, ``KVQ_NEW_TOKENS`` greedy tokens, twice, the launch
   counts of 7c), printing each cache's bytes, the decode step ms, the
   peak memory and where each request's greedy tokens first part from
   the bf16 cache's (recorded, not gated: near-ties part by design);
13. training (``repro_torch.train``): a. kernel gradient cases at
   M = ``TRAIN_BATCH`` x ``TRAIN_SEQ`` = 4096: K3's Function
   (``K3_TRAIN_SHAPES``: gemma2-2b's and rwkv6-1.6b's projections, each
   act, with and without a bias) against autograd through
   ``matmul_fused_ref`` on the card within ``LM_KERNEL_TOL`` (plus the
   bf16 rounding of z and dz for silu and gelu), every launch of the
   forward, z, dx and dw on the wgmma path, the products timed beside
   ``torch.matmul`` and the transposes' copies alone; K10 with m and l
   (``K10_TRAIN_CASES``: gemma2's batch and a 4500-token row where its
   window bites; out bit for bit the launch without them, m and l within
   fp32's ``LM_KERNEL_TOL``) and its Function's plain backward against
   autograd through its plain version (``K10_GRAD_TOL``); K11's Function
   at rwkv6's shape with strong decays against autograd through
   ``wkv6_chunked_ref``; b. CPU parity: one fp32 train step of each
   model cut to one unit (gemma2's local/global pair, two rwkv6 layers)
   at full width, the CPU on one intra-op thread: loss, metrics, every
   gradient leaf, moment and updated parameter (``TRAIN_PARITY_TOL``);
   c. ``TRAIN_STEPS`` AdamW steps of gemma2-2b, then of rwkv6-1.6b (each
   freed before the next), bf16, through ``make_train_step`` on
   ``MarkovLM(TRAIN_VOCAB)`` batches: the first step taken twice from the
   same state (loss, grad norm and parameters bit for bit, or the
   differing leaves named), its launches held to the structure (K3 7 or 8
   a layer in the forward, again in the remat recompute, dx and dw, z for
   gemma2's gelu gate; K10 and K11 once a layer in each of the forward and
   the recompute, every K10 launch writing m and l), CE finite and
   falling, step ms, tokens/s, peak memory against
   ``TRAIN_RECKONED_GB``, and the profile of one more step (device ms by
   kernel, busy share, the plain backwards' and AdamW's ranges);
14. stream capture: K2 on AlexNet's chain and K1 on its conv2+pool2+norm2
   group at batch 16, each captured into a ``torch.cuda.CUDAGraph`` and
   replayed (``capture`` line: per kernel, whether the cooperative launch
   was accepted and the replay gave the bits of the launch; a refusal is
   reported, not failed);
15. prints one JSON line ``{"kernels": [...]}``: per kernel, ``launches``
   is its count summed over the AlexNet forwards of phase 4 (K1-K3,
   K7-K9) or phase 5 (K4-K6), or over the first LM serving run of phase
   7c and the first runs of phase 11c (K10's wgmma path as
   ``flash_attention``, and K3's bf16 launches as ``matmul_fused_bf16``)
   or of phase 8c (K11, as ``wkv6``), each counted from 0; the times and
   bound are summed over its distinct AlexNet batch-16 shapes on that
   path (K10: the bf16 4500-token cases at gemma2-2b's shape with cap 50;
   K3 bf16: its phase-7a cases at M = 4 and 4500; K11: its bf16
   4500-token case, which no library call computes); K10's CUDA-core
   kernel has an entry of its own (``flash_attention_simt``), its
   launches those of the fp32 prefills of 7b and 11b, its times the fp32
   4500-token case; K3's wgmma path has an entry of its own, its
   launches those of the wgmma path in the first runs of 7c and 11c, its
   times its phase-7a cases at M = 4500; the error is the largest over
   every case.  Phase 13c's first steps add, apart:
   ``train_backward_launches`` (K3's z, dx and dw) on the K3 entries,
   ``train_ml_launches`` on ``flash_attention`` and ``train_launches``
   on ``wkv6``;
16. prints ``{"ok": true, "device": {...}}`` as its last line.

Run it from the repository root; it needs one CUDA device and the CUDA
toolkit, and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published fp32 (CUDA cores, FMA = 2 operations), memory and dense bf16
#: tensor-core peaks, NVIDIA data sheets; matched against
#: torch.cuda.get_device_name.  A kernel's bound takes the peak of its
#: inputs' type.
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12, 756e12),
    ("H100 NVL", 60.0e12, 3.9e12, 835e12),
    ("H100", 66.9e12, 3.35e12, 989e12),   # SXM5 80 GB
    ("H200", 66.9e12, 4.8e12, 989e12),
)
SEED = 0
BATCHES = (1, 16)
ENGINE_BATCH = 16
KERNELS = ("K1", "K2", "K3", "K7", "K8", "K9")
#: the second-generation cells, which only a tuned plan reaches
CELLS = ("K4", "K5", "K6")
#: kernels whose batch-16 cases must give frame 0 the bits of frame 0
#: launched alone (phase 3)
FRAME_CHECKED = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")
#: the cells that launch the one stage-major kernel (csrc/conv_chain.cu on
#: csrc/conv_stage_major.cuh); K4 and K5 on K1's plan, with K1's bits
STAGE_MAJOR = ("K1", "K2", "K4", "K5", "K6")
#: the tuned deployment of phase 5: norm1 unfused so that conv1+pool1
#: runs the pool carry (K5), conv2+pool2+norm2 the oc-blocked LRN cell
#: (K4), conv3-5+pool5 the oc-blocked chain (K6)
TUNED = {"per_layer_fuse": {"norm1": False},
         "per_layer_pool_carry": {"conv1": True},
         "per_layer_lrn_oc_block": {"conv2": True},
         "per_layer_oc_block_final": {"conv5": 8}}
#: launches of each kernel per tuned forward
TUNED_LAUNCHES = {"K1": 0, "K2": 0, "K3": 3, "K4": 1, "K5": 1, "K6": 1,
                  "K7": 0, "K8": 0, "K9": 0}
TUNED_BATCHES = (16, 1)
TUNED_REPS = 10
#: the rungs of phase 4: (method, fuse_pool); seq_ref and basic_parallel
#: never fuse, so they run once, at the engine's default fuse_pool
RUNGS = (("advanced_simd_8", True), ("advanced_simd_8", False),
         ("basic_simd", True), ("basic_simd", False),
         ("basic_parallel", True), ("seq_ref", True))
#: launches of K1, K2, K3, K7, K8, K9 per forward, per rung
EXPECTED_LAUNCHES = {
    "alexnet": dict(zip(RUNGS, (
        (2, 1, 3, 0, 0, 0), (5, 0, 3, 0, 0, 3), (0, 1, 3, 2, 0, 0),
        (0, 0, 3, 5, 0, 3), (0, 0, 3, 0, 5, 3), (0, 0, 0, 0, 0, 3)))),
    "lenet5": dict(zip(RUNGS, (
        (2, 0, 2, 0, 0, 0), (2, 0, 2, 0, 0, 2), (0, 0, 2, 2, 0, 0),
        (0, 0, 2, 2, 0, 2), (0, 0, 2, 0, 2, 2), (0, 0, 0, 0, 0, 2)))),
    "cifar10": dict(zip(RUNGS, (
        (3, 0, 2, 0, 0, 0), (3, 0, 2, 0, 0, 3), (0, 0, 2, 3, 0, 0),
        (0, 0, 2, 3, 0, 3), (0, 0, 2, 0, 3, 3), (0, 0, 0, 0, 0, 3)))),
}
#: serving phase: wave sizes, and the rung each wave is served on
WAVES = (16, 5, 1, 3, 16)
WAVE_RUNGS = ("advanced_simd_8/fused", "advanced_simd_4/fused",
              "basic_simd/fused", "basic_simd/unfused", "basic_simd/unfused")
MAX_BATCH = 16
REPS = 25
HOST_REPS = 20
#: phase 5b: the readings a ladder row is the mean of, taken round-robin
#: over the rows as the committed model's fit took them
#: (``cost_fit.measure_ladder``), and the least Spearman rank correlation
#: the committed model must reach on the run's fresh rows (the JAX
#: package's CI threshold)
COST_ITERS = 40
COST_RHO = 0.8
COST_NETS = ("alexnet", "cifar10", "lenet5")
#: the kernel a per-layer conv of each method launches (seq_ref: none)
CONV_KERNEL = {"advanced_simd_4": "K1", "advanced_simd_8": "K1",
               "basic_simd": "K7", "basic_parallel": "K8"}
#: MKL's conditional numerical reproducibility mode, set before torch
#: loads: the CPU reference's MKL sums then do not depend on how its
#: buffers are aligned (ROADMAP F3)
MKL_CBWR = "AUTO"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str):
    """(fp32 FLOP/s, bytes/s, bf16 FLOP/s) of the card."""
    for key, flops, bw, bf16 in PEAKS:
        if key in name:
            return flops, bw, bf16
    fail(f"no published peaks known for {name!r}")


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def one_thread(torch):
    """The CPU reference's calls on one intra-op thread, the thread count
    restored after (ROADMAP F3): one fixed summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def plan_launches(plan, kernels):
    """Launches of each kernel in ``kernels`` one forward of ``plan`` makes:
    a fused or chain step its cell's (``fusion_report``), a per-layer conv
    its method's (``CONV_KERNEL``), an fc K3 unless the method is
    ``seq_ref``, a standalone pool K9."""
    want = dict.fromkeys(kernels, 0)
    cells = iter(plan.fusion_report())
    for step in plan.steps:
        kid = None
        if step.kind in ("fused", "chain"):
            kid = next(cells)["cell"]
        elif step.kind == "conv":
            kid = CONV_KERNEL.get(step.method.value)
        elif step.kind == "fc" and step.method.value != "seq_ref":
            kid = "K3"
        elif step.kind == "pool":
            kid = "K9"
        if kid is not None:
            want[kid] += 1
    return want


def he_params(shapes, rng):
    """Seeded He-normal weights and small random biases (numpy)."""
    import numpy as np

    params = {}
    for name, shp in shapes.items():
        conv = len(shp) == 4
        fan = int(np.prod(shp[1:])) if conv else shp[0]
        params[name] = {
            "w": (rng.standard_normal(shp) * np.sqrt(2.0 / fan)
                  ).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shp[0] if conv else shp[1])
                  ).astype(np.float32)}
    return params


def kernel_cases(net, compile_plan, Method):
    """One case per distinct step of the phase-4 rungs' plans that reaches
    a kernel, at each batch: (kernel id, step, batch)."""
    kinds = {  # (method, fuse) -> {step kind: kernel id}
        ("advanced_simd_8", True): {"fused": "K1", "chain": "K2",
                                    "fc": "K3"},
        ("advanced_simd_8", False): {"conv": "K1", "pool": "K9"},
        ("basic_simd", True): {"fused": "K7", "chain": "K2"},
        ("basic_simd", False): {"conv": "K7", "pool": "K9"},
        ("basic_parallel", True): {"conv": "K8", "pool": "K9"},
    }
    cases, seen = [], set()
    for (method, fuse), kid_of in kinds.items():
        for step in compile_plan(net, method=Method(method),
                                 fuse=fuse).steps:
            kid = kid_of.get(step.kind)
            key = (kid, step.kind, step.names)
            if kid is None or key in seen:
                continue
            seen.add(key)
            cases.extend((kid, step, n) for n in BATCHES)
    return cases


def cell_cases(nets, compile_plan, Method):
    """The phase-3 cases of K4, K5 and K6: (net, kernel id, step, batch,
    oc_block_final, main), ``main`` marking the shape and block the tuned
    deployment of phase 5 runs."""
    adv = Method("advanced_simd_8")
    alex = nets["alexnet"]
    fused = compile_plan(alex, method=adv).steps
    unfused_norms = compile_plan(alex, method=adv, per_layer_fuse={
        "norm1": False, "norm2": False}).steps
    cifar = compile_plan(nets["cifar10"], method=adv).steps
    picks = [("alexnet", "K4", s, None, "norm2" in s.names) for s in fused
             if s.kind == "fused"]
    picks += [("alexnet", "K5", s, None, s.names[0] == "conv1")
              for s in unfused_norms if s.kind == "fused"]
    picks += [("cifar10", "K5", s, None, False) for s in cifar
              if s.kind == "fused"]
    chain = next(s for s in fused if s.kind == "chain")
    picks += [("alexnet", "K6", chain, obf,
               obf == TUNED["per_layer_oc_block_final"]["conv5"])
              for obf in (8, 64)]
    return [(net, kid, step, n, obf, main)
            for net, kid, step, obf, main in picks for n in BATCHES]


def _conv_flops(n, in_shape, convs):
    flops = 0.0
    c, h, w = in_shape
    for cv in convs:
        kh, kw = cv.kernel
        oh = (h + 2 * cv.padding[0] - kh) // cv.stride[0] + 1
        ow = (w + 2 * cv.padding[1] - kw) // cv.stride[1] + 1
        flops += 2.0 * n * cv.out_channels * oh * ow * c * kh * kw
        c, h, w = cv.out_channels, oh, ow
    return flops


def run_case(torch, F, kid, step, n, params, dev, peaks, obf=None):
    """Kernel vs plain version on the card, then times; returns a dict.
    ``obf`` is K6's ``oc_block_final``."""
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import (
        conv2d_basic_parallel_ref,
        conv2d_basic_simd_ref,
        lrn_ref,
    )
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref
    from repro_torch.kernels.pool2d.ops import pool2d, pool_plan
    from repro_torch.kernels.pool2d.ref import pool2d_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    flops_peak, bw_peak = peaks[:2]
    if kid == "K3":
        p = params[step.spec.name]
        w, b = p["w"], p["b"]
        x = torch.randn((n, step.d_in), generator=gen, device=dev)
        act = "relu" if step.relu else "none"
        kernel_at = lambda xx: mm_ops.matmul_fused(xx, w, b, act)  # noqa
        kernel = lambda: kernel_at(x)  # noqa: E731
        plain = lambda: matmul_fused_ref(x, w, b, act)  # noqa: E731

        def library():
            y = torch.addmm(b, x, w)
            return y.relu_() if step.relu else y

        m, k = x.shape
        nn_ = w.shape[1]
        flops = 2.0 * m * k * nn_
        nbytes = 4.0 * (m * k + k * nn_ + nn_ + m * nn_)
    elif kid == "K9":
        spec = step.spec
        x = torch.randn((n, *step.in_shape), generator=gen, device=dev)
        args = (x, spec.kernel, spec.stride, spec.pool_kind,
                spec.relu or step.relu)
        kernel = lambda: pool2d(*args)  # noqa: E731
        plain = lambda: pool2d_ref(*args)  # noqa: E731

        def library():
            pool = F.max_pool2d if spec.pool_kind == "max" else F.avg_pool2d
            y = pool(x, spec.kernel, spec.stride)
            return y.relu_() if args[-1] else y

        c, oh, ow = step.out_shape
        flops = float(n * c * oh * ow * spec.kernel[0] * spec.kernel[1])
        nbytes = 4.0 * (x.numel() + n * c * oh * ow)
    else:
        if step.kind == "conv":    # per-layer conv: K1, K7 or K8
            convs, relus, pool, g = (step.spec,), (step.relu,), None, None
        else:                      # fused group or chain: K1, K2 or K7
            g = step.group
            convs, relus, pool = g.convs, g.relus, g.pool
        ws = [params[cv.name]["w"] for cv in convs]
        bs = [params[cv.name]["b"] for cv in convs]
        x = torch.randn((n, *step.in_shape), generator=gen, device=dev)
        strides = [cv.stride for cv in convs]
        pads = [cv.padding for cv in convs]
        tail = {}
        if pool is not None:
            tail = dict(pool_kernel=pool.kernel, pool_stride=pool.stride,
                        pool_kind=pool.pool_kind, pool_relu=g.pool_relu)
            if g.lrn is not None:
                tail.update(lrn_n=g.lrn.lrn_n, lrn_alpha=g.lrn.lrn_alpha,
                            lrn_beta=g.lrn.lrn_beta, lrn_k=g.lrn.lrn_k)
        one = (x, ws[0], bs[0], strides[0], pads[0], relus[0])
        if kid == "K4":
            kernel_at = lambda xx: conv_ops.conv2d_pool_lrn_halo(  # noqa
                xx, *one[1:], **tail)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv_ops.conv2d_pool_fused_ref(*one, **tail)  # noqa
        elif kid == "K5":
            kernel_at = lambda xx: conv_ops.conv2d_pool_carry(  # noqa: E731
                xx, *one[1:], **tail)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv_ops.conv2d_pool_fused_ref(*one, **tail)  # noqa
        elif kid == "K6":
            args = (x, ws, bs, strides, pads, relus)
            kernel_at = lambda xx: conv_ops.conv2d_chain_ocb(  # noqa: E731
                xx, *args[1:], **tail, oc_block_final=obf)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv_ops.conv2d_chain_ref(*args, **tail)  # noqa
        elif kid == "K1":
            kernel_at = lambda xx: conv_ops.conv2d_pool_fused(  # noqa: E731
                xx, *one[1:], **tail)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv_ops.conv2d_pool_fused_ref(*one, **tail)  # noqa
        elif kid == "K7":
            kernel_at = lambda xx: conv_ops.conv2d_basic_simd(  # noqa: E731
                xx, *one[1:], **tail)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv2d_basic_simd_ref(*one, **tail)  # noqa
        elif kid == "K8":
            kernel_at = lambda xx: conv_ops.conv2d_basic_parallel(  # noqa
                xx, *one[1:])
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv2d_basic_parallel_ref(*one)  # noqa
        else:
            args = (x, ws, bs, strides, pads, relus)
            kernel_at = lambda xx: conv_ops.conv2d_chain(  # noqa: E731
                xx, *args[1:], **tail)
            kernel = lambda: kernel_at(x)  # noqa: E731
            plain = lambda: conv_ops.conv2d_chain_ref(*args, **tail)  # noqa

        def library():
            y = x
            for w, b, s, p_, r in zip(ws, bs, strides, pads, relus):
                y = F.conv2d(y, w, b, stride=s, padding=p_)
                if r:
                    y = y.relu_()
            if pool is None:
                return y
            if pool.pool_kind == "max":
                y = F.max_pool2d(y, pool.kernel, pool.stride)
            else:
                y = F.avg_pool2d(y, pool.kernel, pool.stride)
            if g.pool_relu:
                y = y.relu_()
            if g.lrn is not None:
                y = lrn_ref(y, g.lrn.lrn_n, g.lrn.lrn_alpha, g.lrn.lrn_beta,
                            g.lrn.lrn_k)
            return y

        flops = _conv_flops(n, step.in_shape, convs)
        oc, ph, pw = step.out_shape
        nbytes = 4.0 * (x.numel() + sum(t.numel() for t in ws)
                        + sum(t.numel() for t in bs) + n * oc * ph * pw)
    ref = plain()
    out = kernel()
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        fail(f"{kid} {step.names} n={n}: shape {tuple(out.shape)} != "
             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{kid} {step.names} n={n}: non-finite output")
    err = (out - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    if not err <= tol:
        fail(f"{kid} {step.names} n={n}: max abs err {err} > {tol}")
    if not torch.equal(kernel(), out):
        fail(f"{kid} {step.names} n={n}: a repeated launch differs")
    if kid in FRAME_CHECKED and n > 1:
        # frame independence: frame 0 alone gives frame 0's bits
        if not torch.equal(kernel_at(x[:1].contiguous()), out[:1]):
            fail(f"{kid} {step.names} n={n}: frame 0 differs from the same "
                 f"frame launched alone")
    if kid in ("K4", "K5"):
        # K4 and K5 launch the stage-major kernel on K1's plan: K1's bits
        if not torch.equal(conv_ops.conv2d_pool_fused(*one, **tail), out):
            fail(f"{kid} {step.names} n={n}: differs from K1 on the same "
                 f"group")
    lib_err = (library() - ref).abs().max().item()
    ms = time_ms(torch, kernel)
    host_ms = host_call_ms(torch, kernel)
    bound_ms = 1e3 * max(flops / flops_peak, nbytes / bw_peak)
    row = {
        "kernel": kid, "kind": step.kind, "batch": n, "max_abs_err": err,
        "tol": tol, "library_max_abs_err": lib_err,
        "ms": ms, "host_ms": host_ms, "plain_ms": time_ms(torch, plain),
        "library_ms": time_ms(torch, library),
        "bound_ms": bound_ms, "bound_share": bound_ms / ms,
        "bound_by": "operations" if flops / flops_peak > nbytes / bw_peak
        else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    if kid in STAGE_MAJOR:
        row["chain"] = chain_geometry(torch, conv_ops, kid, n, step, ws,
                                      strides, pads, relus, pool, obf)
    if kid in ("K3", "K9"):  # the device time a call, no host gap
        row["device_ms"] = stream_device_ms(torch, kernel)
    if kid == "K9":
        row["grid"] = pool_plan(n * x.shape[1], *step.out_shape[1:])._asdict()
    return row


def chain_geometry(torch, conv_ops, kid, n, step, ws, strides, pads, relus,
                   pool, obf):
    """The cooperative launch of a stage-major case, K1, K2, K5 or K6
    (``ops.chain_plan``): grid, blocks an SM holds (the CUDA occupancy
    query of the stage-major kernel), barriers, scratch MB, each stage's
    unit (chunks an item), items and whether an item takes the whole
    reduction.  At batch 16 the grid must hold at least 128 blocks; it may
    never pass the resident limit."""
    from repro_torch.kernels import _build

    stages = conv_ops.make_stages(tuple(step.in_shape),
                                  [tuple(w.shape) for w in ws], strides,
                                  pads, relus)
    p = None if pool is None else conv_ops.Pool(*pool.kernel, *pool.stride,
                                                pool.pool_kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = conv_ops.chain_plan(stages, p, n, sms,
                               None if obf is None else conv_ops.k6_ocb(obf))
    per_sm = _build.library().stage_major_blocks_per_sm()
    if not 0 < plan.grid <= per_sm * sms:
        fail(f"chain grid {plan.grid} past {per_sm} blocks x {sms} SMs")
    if n == ENGINE_BATCH and plan.grid < 128:
        fail(f"chain grid {plan.grid} under 128 blocks at batch {n}")
    return {"grid": plan.grid, "blocks_per_sm": per_sm,
            "barriers": plan.barriers, "scratch_mb": 4e-6 * plan.scratch,
            "units": [sp.unit for sp in plan.stages],
            "items": [sp.items for sp in plan.stages],
            "whole": [sp.whole for sp in plan.stages],
            "tail_items": plan.tail_items}


def capture_phase(torch, net, params, dev):
    """K2 on AlexNet's chain and K1 on its conv2+pool2+norm2 group at
    batch 16, each captured into a CUDA graph and replayed: whether stream
    capture takes the cooperative launch, and whether the replay gives the
    launch's bits.  A refusal is reported (``captured`` false, the
    error), not failed: no path captures yet."""
    from repro_torch.core.methods import Method
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels.conv2d import ops as conv_ops

    steps = compile_plan(net, method=Method("advanced_simd_8")).steps
    chain = next(s for s in steps if s.kind == "chain")
    group = next(s for s in steps if s.kind == "fused"
                 and s.group.convs[0].name == "conv2")
    out = {}
    for kid, step in (("K2", chain), ("K1", group)):
        g = step.group
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((ENGINE_BATCH, *step.in_shape), generator=gen,
                        device=dev)
        ws = [params[cv.name]["w"] for cv in g.convs]
        bs = [params[cv.name]["b"] for cv in g.convs]
        tail = dict(pool_kernel=g.pool.kernel, pool_stride=g.pool.stride,
                    pool_kind=g.pool.pool_kind, pool_relu=g.pool_relu)
        if kid == "K2":
            call = lambda: conv_ops.conv2d_chain(  # noqa: E731
                x, ws, bs, [cv.stride for cv in g.convs],
                [cv.padding for cv in g.convs], g.relus, **tail)
        else:
            cv, lrn = g.convs[0], g.lrn
            call = lambda: conv_ops.conv2d_pool_fused(  # noqa: E731
                x, ws[0], bs[0], cv.stride, cv.padding, g.relus[0], **tail,
                lrn_n=lrn.lrn_n, lrn_alpha=lrn.lrn_alpha,
                lrn_beta=lrn.lrn_beta, lrn_k=lrn.lrn_k)
        ref = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                y = call()
            graph.replay()
            torch.cuda.synchronize()
        except RuntimeError as e:  # reported only: no path captures yet
            out[kid] = {"captured": False, "error": str(e)[:300]}
            continue
        out[kid] = {"captured": True, "replay_equal": torch.equal(y, ref)}
    return out


class FakeClock:
    """The serving phase's clock: time moves only when told to, so the
    server's event trail is deterministic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def tuned_phase(torch, np, net, np_params, rng, dev, counters, card):
    """Phase 5 (see the module docstring); returns its record.  The
    default engine (fused ``advanced_simd_8``) is timed beside the tuned
    one on the same weights and frames."""
    import tempfile

    from repro_torch.core.deploy import load_engine, save_model
    from repro_torch.core.engine import CNNEngine

    rows = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        save_model(tmp, net, np_params, extra={"seed": SEED}, tuned=TUNED)
        eng, params, knobs = load_engine(tmp)
        cpu, cpu_params, _ = load_engine(tmp, device="cpu")
    if eng.device.type != "cuda":
        fail(f"tuned deploy: engine on {eng.device}")
    default = CNNEngine(net)
    report = eng.fusion_report()
    cells = [r["cell"] for r in report]
    if cells != ["K5", "K4", "K6"]:
        fail(f"tuned deploy: groups resolved to {cells}")
    for n in TUNED_BATCHES:
        x_np = rng.standard_normal((n, *net.input_shape)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        for fn in counters.values():
            fn.launches = 0
        y = eng.forward(params, x)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        if launches != TUNED_LAUNCHES:
            fail(f"tuned deploy batch {n}: launches {launches}, expected "
                 f"{TUNED_LAUNCHES}")
        if tuple(y.shape) != (n, net.num_classes):
            fail(f"tuned deploy batch {n}: output shape {tuple(y.shape)}")
        if not torch.isfinite(y).all():
            fail(f"tuned deploy batch {n}: non-finite output")
        y_cpu = cpu.forward(cpu_params, x_np)
        err = (y.cpu() - y_cpu).abs().max().item()
        if not err <= 1e-4:
            fail(f"tuned deploy batch {n}: max abs err vs CPU {err} > 1e-4")
        if not torch.equal(y.argmax(-1).cpu(), y_cpu.argmax(-1)):
            fail(f"tuned deploy batch {n}: argmax differs from the CPU")
        y2 = eng.forward(params, x)
        y3 = eng.forward(params, x)
        if not (torch.equal(y, y2) and torch.equal(y2, y3)):
            fail(f"tuned deploy batch {n}: repeated forwards differ")
        ms = time_ms(torch, lambda: eng.forward(params, x), TUNED_REPS)
        default_ms = time_ms(torch, lambda: default.forward(params, x),
                             TUNED_REPS)
        rows.append({"batch": n, "forward_ms": ms, "launches": launches,
                     "max_abs_err_vs_cpu": err,
                     "default_fused_forward_ms": default_ms})
        print(f"tuned deploy batch {n}: forward {ms:.3f} ms, default fused "
              f"forward {default_ms:.3f} ms (event medians of {TUNED_REPS}),"
              f" launches {launches}, max abs err vs CPU {err:.3g} [{card}]",
              flush=True)
    return {"knobs": knobs, "fusion_report": report, "forwards": rows}


def check_forward(torch, label, run, run_cpu, plan, x, counters, card,
                  default):
    """Phase 5b's checks of one forward on the card: ``run(x)`` with the
    counters set to 0 just before and read just after must launch what
    ``plan`` names, match ``run_cpu`` (the same plan on the CPU; max abs
    <= 1e-4 · max(1, max|CPU|), same argmax) and repeat bit for bit; then
    it is timed beside ``default`` (the default fused forward).  Returns
    its record."""
    want = plan_launches(plan, counters)
    for fn in counters.values():
        fn.launches = 0
    y = run(x)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != want:
        fail(f"{label}: launches {launches}, its plan names {want}")
    if not torch.isfinite(y).all():
        fail(f"{label}: non-finite output")
    y_cpu = run_cpu(x.cpu())
    if tuple(y.shape) != tuple(y_cpu.shape):
        fail(f"{label}: output shape {tuple(y.shape)}, the CPU's "
             f"{tuple(y_cpu.shape)}")
    err = (y.cpu() - y_cpu).abs().max().item()
    tol = 1e-4 * max(1.0, y_cpu.abs().max().item())
    if not err <= tol:
        fail(f"{label}: max abs err vs CPU {err} > {tol}")
    if not torch.equal(y.argmax(-1).cpu(), y_cpu.argmax(-1)):
        fail(f"{label}: argmax differs from the CPU")
    if not (torch.equal(y, run(x)) and torch.equal(y, run(x))):
        fail(f"{label}: repeated forwards differ")
    ms = time_ms(torch, lambda: run(x), TUNED_REPS)
    default_ms = time_ms(torch, lambda: default(x), TUNED_REPS)
    print(f"{label}: forward {ms:.3f} ms, default fused forward "
          f"{default_ms:.3f} ms (event medians of {TUNED_REPS}), launches "
          f"{ {k: v for k, v in launches.items() if v} }, max abs err vs "
          f"CPU {err:.3g} [{card}]", flush=True)
    return {"forward_ms": ms, "default_fused_forward_ms": default_ms,
            "launches": launches, "max_abs_err_vs_cpu": err}


def cost_phase(torch, np, nets, np_params, dev, counters, card):
    """Phase 5b (see the module docstring); returns its record.  Its
    frames come from a generator of its own, so the later phases see the
    frames they saw before it was added."""
    import tempfile

    from repro_torch.core.cost import (DEFAULT_MODEL_PATH, CostModel,
                                       fusion_cost_gate)
    from repro_torch.core.deploy import (knobs_to_manifest, load_engine,
                                         params_from_numpy)
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.fusion import FUSABLE_METHODS, fusion_summary
    from repro_torch.core.plan import compile_plan
    from repro_torch.tools.autotune import decision_table, tune, write_and_check
    from repro_torch.tools.cost_fit import fit_model, measure_ladder
    from repro_torch.tools.cost_validate import validate

    rng = np.random.default_rng([SEED, 5])
    params = {n: params_from_numpy(np_params[n], dev) for n in COST_NETS}
    cpu_params = {n: params_from_numpy(np_params[n], "cpu")
                  for n in COST_NETS}
    # 1. the ladder, measured on the card
    t0 = time.perf_counter()
    bench = measure_ladder(COST_NETS, ENGINE_BATCH, COST_ITERS, dev,
                           params=params, seed=SEED)
    rows = {f"{net}/{r['method']}/{v}": r[v]["us_per_call"]
            for net, rec in bench["networks"].items() for r in rec["rows"]
            for v in ("unfused", "fused") if v in r}
    print(f"cost ladder ({len(rows)} rows, batch {ENGINE_BATCH}, mean of "
          f"{COST_ITERS} round-robin readings, "
          f"{time.perf_counter() - t0:.1f} s) [{card}] "
          + json.dumps(rows), flush=True)
    # 2. the committed model against the fresh rows; a fresh fit beside it
    model = CostModel.load()
    if model.backend != "cuda" or model.fallback_from is not None:
        fail(f"cost model: the committed file has no cuda entry "
             f"(loaded {model.backend}, fallback from {model.fallback_from})")
    committed = json.loads(DEFAULT_MODEL_PATH.read_text())["backends"]["cuda"]
    report = validate(bench, model)
    # the fresh rows refitted as the committed model was (all 24 points),
    # and with the JAX package's holdout of every 3rd point, whose fits
    # fall into a degenerate solution on the card (PERF.md, PR 23)
    fits = {}
    for every in sorted({committed["validation"]["holdout_every"], 3}):
        fresh, fresh_val = fit_model(bench, every)
        fits[f"holdout_every_{every}"] = {**fresh.to_dict(),
                                          "validation": fresh_val}
    rec = {"rows_us": rows, "spearman_all": report["spearman"],
           "per_network": report["per_network"],
           "committed": {**model.to_dict(),
                         "validation": committed["validation"]},
           "fresh_fits": fits}
    print("cost validate " + json.dumps(
        {k: rec[k] for k in ("spearman_all", "per_network")}), flush=True)
    print("cost fits " + json.dumps(
        {"committed": rec["committed"], "fresh": fits}), flush=True)
    if not report["spearman"] >= COST_RHO:
        fail(f"cost model: Spearman {report['spearman']:.4f} of the "
             f"committed cuda model on this run's rows < {COST_RHO}")
    # 3-4. tune each net, write and reload it, run it
    rec["tuned"] = {}
    for name in COST_NETS:
        net = nets[name]
        x = torch.from_numpy(rng.standard_normal(
            (ENGINE_BATCH, *net.input_shape)).astype(np.float32)).to(dev)
        default = CNNEngine(net)
        result = tune(net, model, batch=ENGINE_BATCH)
        print(decision_table(result, model), flush=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            code = write_and_check(result, model, tmp, np_params[name])
            if code != 0:
                fail(f"autotune {name}: write_and_check returned {code}")
            eng, p, _ = load_engine(tmp)
            cpu, p_cpu, _ = load_engine(tmp, device="cpu")
        if eng.device.type != "cuda":
            fail(f"autotune {name}: engine on {eng.device}")
        r = check_forward(
            torch, f"tuned {name} batch {ENGINE_BATCH}",
            lambda x: eng.forward(p, x), lambda x: cpu.forward(p_cpu, x),
            eng.plan(), x, counters, card,
            lambda x: default.forward(params[name], x))
        r.update(knobs=knobs_to_manifest(result["knobs"]),
                 decisions=result["decisions"],
                 modelled_us=result["cost"].us,
                 default_modelled_us=result["default_cost"].us,
                 groups=[g["group"] + ":" + g["cell"]
                         for g in eng.fusion_report()])
        rec["tuned"][name] = r
    # 5. the cost gate, every net × fusable method; AlexNet's run
    rec["gate"] = {}
    for name in COST_NETS:
        for m in sorted(FUSABLE_METHODS, key=lambda m: m.value):
            gate = fusion_cost_gate(model, batch=ENGINE_BATCH)
            gated = compile_plan(nets[name], method=m, cost_gate=gate)
            plain = compile_plan(nets[name], method=m)
            rec["gate"][f"{name}/{m.value}"] = {
                "gated": ["+".join(g) for g in fusion_summary(gated)],
                "ungated": ["+".join(g) for g in fusion_summary(plain)],
                "cells": [g["cell"] for g in gated.fusion_report()]}
    print("cost gate " + json.dumps(rec["gate"]), flush=True)
    alex = nets["alexnet"]
    gated = compile_plan(alex, cost_gate=fusion_cost_gate(
        model, batch=ENGINE_BATCH))
    default = CNNEngine(alex)
    x = torch.from_numpy(rng.standard_normal(
        (ENGINE_BATCH, *alex.input_shape)).astype(np.float32)).to(dev)
    rec["gated_alexnet"] = check_forward(
        torch, f"gated alexnet batch {ENGINE_BATCH}",
        lambda x: gated.execute(params["alexnet"], x),
        lambda x: gated.execute(cpu_params["alexnet"], x), gated, x,
        counters, card, lambda x: default.forward(params["alexnet"], x))
    return rec


def serving_phase(torch, np, net, np_params, rng, dev, counters):
    """Phase 5 (see the module docstring); returns its record."""
    from repro_torch.core.deploy import params_from_numpy
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.serving import (CNNServer, DegradeController,
                                     FailedResult, FaultInjector, FaultScript,
                                     ImageRequest, ImageResult, default_ladder)

    params = params_from_numpy(np_params, dev)
    cpu_params = params_from_numpy(np_params, "cpu")
    frames = rng.standard_normal((sum(WAVES), *net.input_shape)
                                 ).astype(np.float32)
    eng = CNNEngine(net)
    srv = CNNServer(eng, params, max_batch=MAX_BATCH, max_delay_s=1.0,
                    clock=FakeClock(), sleep=lambda s: None,
                    degrade=DegradeController(default_ladder(), queue_high=0,
                                              degrade_after=1, cooldown=0))
    for fn in counters.values():
        fn.launches = 0
    waves, rid = [], 0
    for size in WAVES:
        for r in range(rid, rid + size):
            srv.submit(ImageRequest(rid=r, image=frames[r], top_k=5))
        if size < MAX_BATCH and srv.step() != []:
            fail(f"serving: a wave of {size} was served before it waited")
        rung = (eng.method, eng.fuse_pool)
        label = srv.health()["degrade"]["label"]
        t0 = time.perf_counter()
        served = srv.step(force=True)
        host_ms = (time.perf_counter() - t0) * 1e3
        if (len(served) != size
                or not all(isinstance(r, ImageResult) for r in served)):
            fail(f"serving: wave of {size} on {label} served {served!r}")
        stats = eng.bucket_stats()
        per_fuse = max(sum(1 for f, _ in stats["buckets"] if f == fuse)
                       for fuse in (True, False))
        if stats["compiles"] > MAX_BATCH.bit_length() or per_fuse > 5:
            fail(f"serving: bucket cache {stats}")
        waves.append({"size": size, "rung": label, "rung_key": rung,
                      "bucket": served[0].bucket, "host_ms": host_ms,
                      "rids": list(range(rid, rid + size))})
        rid += size
    launches = {k: counters[k].launches for k in KERNELS}
    if [w["rung"] for w in waves] != list(WAVE_RUNGS):
        fail(f"serving: rungs {[w['rung'] for w in waves]}, expected "
             f"{list(WAVE_RUNGS)}")
    for k in ("K1", "K2", "K3", "K7", "K9"):
        if launches[k] < 1:
            fail(f"serving: {k} never launched ({launches})")
    worst = 0.0
    for w in waves:
        method, fuse = w.pop("rung_key")
        cpu = CNNEngine(net, method=method, fuse_pool=fuse, device="cpu")
        probs = cpu.forward(cpu_params, frames[w["rids"]]).numpy()
        for r, p in zip(w["rids"], probs):
            res = srv.done[r]
            top = [int(j) for j in np.argsort(-p, kind="stable")[:5]]
            if res.top_indices != top:
                fail(f"serving: rid {r} top-5 {res.top_indices} != CPU {top}")
            err = float(np.abs(np.asarray(res.top_probs) - p[top]).max())
            worst = max(worst, err)
            if not err <= 1e-4:
                fail(f"serving: rid {r} probabilities differ by {err}")
    # bisection on the card: survivors keep the parent's bucket and bits
    poison_rid = 6
    bisect = {}
    for method, fuse in ((Method.ADVANCED_SIMD_8, True),
                         (Method.BASIC_SIMD, False)):
        e2 = CNNEngine(net, method=method, fuse_pool=fuse)
        runs = []
        for script in (FaultScript(), FaultScript(poison_rids={poison_rid})):
            s2 = CNNServer(e2, params, max_batch=MAX_BATCH, max_delay_s=0.0,
                           clock=FakeClock(), sleep=lambda s: None,
                           fault_injector=FaultInjector(script))
            for r in range(MAX_BATCH):
                s2.submit(ImageRequest(rid=r, image=frames[r],
                                       top_k=net.num_classes))
            s2.run_until_drained()
            runs.append(s2)
        clean, faulty = runs
        failed = [r for r, v in faulty.done.items()
                  if isinstance(v, FailedResult)]
        if failed != [poison_rid]:
            fail(f"serving: bisection failed {failed}, expected "
                 f"[{poison_rid}]")
        for r in range(MAX_BATCH):
            if r == poison_rid:
                continue
            a, b = faulty.done[r], clean.done[r]
            if (a.bucket != MAX_BATCH or a.top_probs != b.top_probs
                    or a.top_indices != b.top_indices):
                fail(f"serving: survivor {r} on {method.value} differs from "
                     f"the fault-free run")
        bisect[f"{method.value}/{'fused' if fuse else 'unfused'}"] = {
            "bisections": faulty.stats()["bisections"],
            "engine_calls": faulty.fault_injector.calls}
    return {"waves": [{k: v for k, v in w.items() if k != "rids"}
                      for w in waves],
            "launches": launches, "stats": srv.stats(),
            "events": [e["kind"] for e in srv.events],
            "max_prob_err_vs_cpu": worst, "bisection": bisect}


#: phase 7: the language model and its kernels' cases
LM_ARCH = "gemma2-2b"
LM_PROMPTS = (16, 300, 1500, 4500)
LM_NEW_TOKENS = 16
LM_MAX_BATCH = 4
LM_MAX_LEN = 8192
LM_PARITY_PROMPT = 64
LM_PROFILE_PROMPT = 1500
LM_PARITY_DECODE = 8
#: CPU parity of phase 7b, relative to max(1, max|CPU logits|): both sides
#: are fp32 (the card's K3 and K10 against the CPU's plain versions, the
#: same fp32 arithmetic in another order, about 1e-6 of the logits); the
#: decode steps read the bf16 KV cache, where a k or v that differs in its
#: last fp32 bits may round to the neighbouring bf16 value (2^-8 of that
#: element), hence 2e-3 there — the tolerances of tests/test_torch_lm.py
LM_TOL = {"prefill": 1e-4, "decode": 2e-3}
#: K10 cases: (tokens, window, cap, dtype, heads, kv heads, head_dim,
#: causal).  gemma2-2b's shape (8 heads over 4, head_dim 256, causal):
#: the window and the tile skip bite only past 4096 tokens, hence the
#: 4500-token cases in both dtypes; 16, 300 and 1500 are the other prompt
#: lengths phase 7c serves.  Then the tensor-core path's other head_dims
#: (128: 16 heads over 8; 64: 32 over 8) and a non-causal case.
K10_CASES = ((512, 4096, 50.0, "bfloat16", 8, 4, 256, True),
             (512, 0, 50.0, "bfloat16", 8, 4, 256, True),
             (512, 0, 0.0, "bfloat16", 8, 4, 256, True),
             (4500, 4096, 50.0, "bfloat16", 8, 4, 256, True),
             (4500, 0, 50.0, "bfloat16", 8, 4, 256, True),
             (4500, 0, 0.0, "bfloat16", 8, 4, 256, True),
             (16, 4096, 50.0, "bfloat16", 8, 4, 256, True),
             (300, 4096, 50.0, "bfloat16", 8, 4, 256, True),
             (1500, 4096, 50.0, "bfloat16", 8, 4, 256, True),
             (1500, 0, 50.0, "bfloat16", 16, 8, 128, True),
             (1500, 0, 0.0, "bfloat16", 32, 8, 64, True),
             (1500, 0, 50.0, "bfloat16", 8, 4, 256, False),
             (512, 4096, 50.0, "float32", 8, 4, 256, True),
             (4500, 4096, 50.0, "float32", 8, 4, 256, True))
#: K10 and K3-bf16 against their plain versions, element by element:
#: |kernel - plain| <= rtol * |plain| + atol.  Both sides sum in fp32 in
#: another order (about 1e-6 of an output) and round once to the output
#: type.  bf16: one rounding apart is at most 2^-7 of |plain|; atol 2^-10
#: covers outputs near 0.  A row of K10 at 4500 tokens is about 0.03, and
#: a kernel that skips one visible tile at the window's edge moves it by
#: about 0.014, so a limit of max|plain| * 2^-7 (about 0.03 there, one
#: bf16 rounding of the largest output) could not see it; this one is
#: 0.0012 at such an element.  fp32: 1e-4 of |plain| plus 1e-5.
LM_KERNEL_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -10),
                 "float32": (1e-4, 1e-5)}
#: K3's five distinct projection shapes (K, N, activation) in a gemma2-2b
#: block: q, k and v, o, gate and up (gate with gelu), down
K3_LM_SHAPES = ((2304, 2048, "none"), (2304, 1024, "none"),
                (2048, 2304, "none"), (2304, 9216, "gelu"),
                (9216, 2304, "none"))
#: M of K3's cases: a decode step at 4 slots, the four prefills, and the
#: smallest M of the wgmma path; the kernels line sums the cases at
#: ``K3_LM_MAIN_ROWS`` (and its wgmma entry those at 4500)
K3_LM_ROWS = (4, 16, 64, 300, 1500, 4500)
K3_LM_MAIN_ROWS = (4, 4500)
#: phase 7a's extra stream case: M = 48 at the gate's shape (three 16-row
#: tiles, which the stream reads w once for, as for M = 4)
K3_READ_ONCE_CASE = (48, 2304, 9216, "gelu")
#: the M = 48 case's device time must stay under this many times the M = 4
#: gate's (reading w three times, as 16-row tiles over M did, takes about
#: three)
STREAM_ROWS_READ_ONCE = 2.0
#: stream calls captured into one CUDA graph, whose replay times the
#: device alone (no host gap between launches)
STREAM_GRAPH_LAUNCHES = 20
#: the wgmma path's tile width in output columns (``WG_BN`` in
#: csrc/matmul_fused.cu)
K3_WGMMA_BN = 128
#: at this M every projection shape must run on the wgmma path at least
#: this many times faster than on the CUDA-core tile, timed in one call
K3_WGMMA_GAIN = (4500, 5.0)
#: at this many tokens K10's bf16 cases at gemma2-2b's shape must run on
#: the wgmma path at least this many times faster than on the CUDA-core
#: kernel, timed in one call
K10_WGMMA_GAIN = (4500, 5.0)


def _visible_pairs(sq, window, causal=True, skv=None):
    """(query, key) pairs an attention over ``sq`` tokens with ``window``
    computes (non-causal: every query against each of ``skv`` keys, ``sq``
    by default)."""
    if not causal:
        return sq * (sq if skv is None else skv)
    if window <= 0:
        return sq * (sq + 1) // 2
    w = min(window, sq)
    return w * (w + 1) // 2 + (sq - w) * w


def _check_close(label, out, ref, tol, rtol=0.0):
    """Fails unless every element is within ``tol + rtol * |ref|``;
    returns the largest absolute error."""
    if out.shape != ref.shape:
        fail(f"{label}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(out.float().isfinite().all()):
        fail(f"{label}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    over = diff - (tol + rtol * ref.float().abs())
    if not over.max().item() <= 0.0:
        i = int(over.argmax())
        fail(f"{label}: error {diff.flatten()[i].item()} at element {i} "
             f"(plain {ref.flatten()[i].item()}) > {tol} + {rtol} * |plain|"
             f"; max abs err {err}")
    return err


def host_call_ms(torch, fn):
    """The wrapper's host time a call: the mean of ``HOST_REPS`` calls
    enqueued back to back, which the card's queue absorbs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / HOST_REPS
    torch.cuda.synchronize()
    return ms


def stream_device_ms(torch, call):
    """Device time of one call of a kernel wrapper (K3's weight stream,
    K9, K11): ``STREAM_GRAPH_LAUNCHES`` calls captured into a CUDA graph
    (a launch allocates only its outputs and scratch and never
    synchronises, so it captures), the replay timed with CUDA events, the
    median of 5 over the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(STREAM_GRAPH_LAUNCHES):
            call()
    ms = time_ms(torch, graph.replay, 5) / STREAM_GRAPH_LAUNCHES
    del graph
    return ms


def k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks, main, bias=False,
                 **extra):
    """K3 on bf16 operands at one projection shape, held against its plain
    version element by element, repeated bit for bit and timed beside
    ``torch.matmul`` (+ the activation), with its host time a call
    (``host_ms``); the launch must take the path ``k3_path`` names (the
    weight stream below 64 rows, else wgmma).  On the stream, row 0 must
    give the bits of the same row called alone, and the device time a call
    comes from a captured graph (``stream_device_ms``); from 64 rows on
    the CUDA-core tile is timed beside it, in the order tile, wgmma,
    wgmma, tile.  ``bias``: with a seeded fp32 bias, added in the
    epilogue before the activation (the library: ``torch.addmm`` with the
    bias in bf16).  ``extra`` joins the record.  Returns the record."""
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ops import k3_path, matmul_fused
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    _, bw_peak, bf16_peak = peaks
    x = torch.randn((m, kk), generator=gen, device=dev).bfloat16()
    w = (torch.randn((kk, n), generator=gen, device=dev) / kk ** 0.5
         ).bfloat16()
    b = torch.randn((n,), generator=gen, device=dev) if bias else None
    kernel = lambda: matmul_fused(x, w, b, act)  # noqa: E731
    plain = lambda: matmul_fused_ref(x, w, b, act)  # noqa: E731
    tile = lambda: mm_ops._launch(x, w, b, act, path="tiles")  # noqa: E731
    b16 = None if b is None else b.bfloat16()

    def library():
        y = torch.matmul(x, w) if b16 is None else torch.addmm(b16, x, w)
        if act == "gelu":
            return F.gelu(y, approximate="tanh")
        if act == "silu":
            return F.silu(y)
        return F.relu(y) if act == "relu" else y

    label = f"K3 bf16 M={m} {kk}->{n} {act}" + (" +bias" if bias else "")
    path = k3_path(x.dtype, m, kk, n, x.data_ptr(), w.data_ptr())
    if path != ("stream" if m < 64 else "wgmma"):
        fail(f"{label}: path {path}")
    ref = plain()
    paths = matmul_fused.path_launches
    before = dict(paths)
    out = kernel()
    torch.cuda.synchronize()
    stepped = {k: paths[k] - before[k] for k in paths}
    if stepped != {**dict.fromkeys(paths, 0), path: 1}:
        fail(f"{label}: path counters moved by {stepped}, expected one "
             f"{path} launch")
    rtol, atol = LM_KERNEL_TOL["bfloat16"]
    # a partial last tile of the wgmma path (N not a multiple of its 128
    # columns): every row of its columns first, so that a store clipped
    # short names the tile; one that ran past column N - 1 lands in the
    # next row's first columns, which the whole output's check holds
    last = n - n % K3_WGMMA_BN if path == "wgmma" and n % K3_WGMMA_BN \
        else None
    if last is not None:
        last_err = _check_close(f"{label} last tile (columns {last}..)",
                                out[:, last:], ref[:, last:], atol, rtol)
    err = _check_close(label, out, ref, atol, rtol)
    if out.dtype != torch.bfloat16:
        fail(f"{label}: output {out.dtype}")
    if not torch.equal(kernel(), out):
        fail(f"{label}: a repeated launch differs")
    if path == "stream" and m > 1 and not torch.equal(
            matmul_fused(x[:1], w, b, act), out[:1]):
        fail(f"{label}: row 0 differs from the same row called alone")
    lib_err = (library().float() - ref.float()).abs().max().item()
    flops = 2.0 * m * kk * n
    nbytes = 2.0 * (m * kk + kk * n + m * n) + 4.0 * n * bias
    r = {"kernel": "K3-bf16", "rows": m, "k": kk, "n": n, "act": act,
         "bias": bias, "path": path, "max_abs_err": err,
         **({"last_tile_from": last, "last_tile_max_abs_err": last_err}
            if last is not None else {}),
         "tol": {"rtol": rtol, "atol": atol},
         "library_max_abs_err": lib_err,
         "library_note": ("torch.addmm, bf16 bias" if bias
                          else "torch.matmul") + f" in bf16 (+ {act})"}
    if path == "wgmma":
        _check_close(f"{label} CUDA-core tile", tile(), ref, atol, rtol)
        runs = [time_ms(torch, f) for f in (tile, kernel, kernel, tile)]
        r.update(ms=(runs[1] + runs[2]) / 2, tile_ms=(runs[0] + runs[3]) / 2,
                 runs_tile_wgmma_wgmma_tile_ms=runs)
        r["gain_vs_tile"] = r["tile_ms"] / r["ms"]
        gain_m, gain = K3_WGMMA_GAIN
        if m == gain_m and not r["gain_vs_tile"] >= gain:
            fail(f"{label}: wgmma {r['ms']:.4f} ms against the CUDA-core "
                 f"tile's {r['tile_ms']:.4f}, under {gain}x")
    else:
        r["ms"] = time_ms(torch, kernel)
        r["device_ms"] = stream_device_ms(torch, kernel)
    r["host_ms"] = host_call_ms(torch, kernel)
    r.update(plain_ms=time_ms(torch, plain),
             library_ms=time_ms(torch, library),
             bound_ms=1e3 * max(flops / bf16_peak, nbytes / bw_peak),
             bound_by="operations"
             if flops / bf16_peak > nbytes / bw_peak else "bytes",
             flops=flops, bytes=nbytes, peak=bf16_peak, main=main, **extra)
    print("case " + json.dumps(r), flush=True)
    return r


def k10_case(torch, F, gen, dev, case, peaks, skv=None):
    """K10 at one case of ``K10_CASES``, held against its plain version
    element by element, repeated bit for bit and timed beside SDPA (the
    same boolean mask, and with ``is_causal`` where the window does not
    bite); the launch must take the path ``k10_path`` names, and on the
    wgmma path the CUDA-core kernel is held and timed beside it (simt,
    wgmma, wgmma, simt) and must be at least ``K10_WGMMA_GAIN`` times
    slower at gemma2-2b's shape at 4500 tokens.  ``skv``: that many keys
    (a cross-attention, non-causal, no window), SDPA then without a mask.
    Returns the record."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    fp32_peak, bw_peak, bf16_peak = peaks
    sq, window, cap, dname, h, kvh, hd, causal = case
    cross = skv is not None
    if cross and (causal or window):
        fail(f"K10 case {case}: skv {skv} needs a non-causal case without "
             f"a window")
    skv = sq if skv is None else skv
    dt = getattr(torch, dname)
    q = torch.randn((1, sq, h, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((1, skv, kvh, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((1, skv, kvh, hd), generator=gen, device=dev).to(dt)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    scale = 1.0 / hd ** 0.5
    kernel = lambda: attn_ops.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, **kw)  # noqa: E731
    simt = lambda: attn_ops._launch(  # noqa: E731
        q, k, v, causal, window, cap, scale, path="simt")
    pos = torch.arange(sq, device=dev)
    mask = None
    if not cross:
        mask = torch.ones((sq, sq), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos[:, None] >= pos[None, :]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():  # SDPA has no softcap: the cap-0 function
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)

    def library_causal():  # its flash backend, where the window does not bite
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)

    label = (f"K10 {dname} s={sq}" + (f" skv={skv}" if cross else "")
             + f" window={window} cap={cap} h={h}/{kvh} hd={hd} "
             f"causal={causal}")
    path = attn_ops.k10_path(dt, sq, skv, hd)
    if path != ("wgmma" if dt == torch.bfloat16 else "simt"):
        fail(f"{label}: path {path}")
    ref = plain()
    paths = attn_ops.flash_attention.path_launches
    before = dict(paths)
    out = kernel()
    torch.cuda.synchronize()
    stepped = {p: paths[p] - before[p] for p in paths}
    if stepped != {**dict.fromkeys(paths, 0), path: 1}:
        fail(f"{label}: path counters moved by {stepped}, expected one "
             f"{path} launch")
    rtol, atol = LM_KERNEL_TOL[dname]
    err = _check_close(label, out, ref, atol, rtol)
    if not torch.equal(kernel(), out):
        fail(f"{label}: a repeated launch differs")
    lib_err = (library().float() - ref.float()).abs().max().item()
    flops = 4.0 * _visible_pairs(sq, window, causal, skv) * h * hd
    nbytes = float(out.element_size() * (2 * q.numel() + 2 * k.numel()))
    peak = bf16_peak if dt == torch.bfloat16 else fp32_peak
    gemma2 = (h, kvh, hd, causal) == (8, 4, 256, True) and dname == "bfloat16"
    r = {"kernel": "K10", "tokens": sq, "keys": skv, "window": window,
         "cap": cap,
         "dtype": dname, "heads": h, "kv_heads": kvh, "head_dim": hd,
         "causal": causal, "path": path, "max_abs_err": err,
         "tol": {"rtol": rtol, "atol": atol},
         "rms_plain": ref.float().square().mean().sqrt().item(),
         "max_abs_plain": ref.float().abs().max().item(),
         "library_max_abs_err": lib_err,
         "library_note": "SDPA, no mask" if cross
         else "SDPA, same boolean mask, no softcap"}
    if path == "wgmma":
        r["simt_max_abs_err"] = _check_close(f"{label} CUDA-core kernel",
                                             simt(), ref, atol, rtol)
        runs = [time_ms(torch, f) for f in (simt, kernel, kernel, simt)]
        r.update(ms=(runs[1] + runs[2]) / 2, simt_ms=(runs[0] + runs[3]) / 2,
                 runs_simt_wgmma_wgmma_simt_ms=runs)
        r["gain_vs_simt"] = r["simt_ms"] / r["ms"]
        gain_sq, gain = K10_WGMMA_GAIN
        if gemma2 and sq == gain_sq and not r["gain_vs_simt"] >= gain:
            fail(f"{label}: wgmma {r['ms']:.4f} ms against the CUDA-core "
                 f"kernel's {r['simt_ms']:.4f}, under {gain}x")
    else:
        r["ms"] = time_ms(torch, kernel)
    r["host_ms"] = host_call_ms(torch, kernel)
    if causal and (window <= 0 or window >= sq):
        r["library_causal_ms"] = time_ms(torch, library_causal)
    r.update(plain_ms=time_ms(torch, plain),
             library_ms=time_ms(torch, library),
             bound_ms=1e3 * max(flops / peak, nbytes / bw_peak),
             bound_by="operations" if flops / peak > nbytes / bw_peak
             else "bytes", flops=flops, bytes=nbytes, peak=peak,
             main=gemma2 and sq == max(LM_PROMPTS) and cap > 0)
    print("case " + json.dumps(r), flush=True)
    return r


def lm_kernel_cases(torch, F, dev, peaks):
    """Phase 7a: K10 and K3 (bf16) at gemma2-2b's shapes against their
    plain versions, repeated bit for bit, timed; returns the records."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = [k10_case(torch, F, gen, dev, case, peaks) for case in K10_CASES]
    for m in K3_LM_ROWS:
        for kk, n, act in K3_LM_SHAPES:
            rows.append(k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks,
                                     m in K3_LM_MAIN_ROWS))
    m, kk, n, act = K3_READ_ONCE_CASE
    once = k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks, False)
    m4 = next(r for r in rows if r["kernel"] == "K3-bf16" and r["rows"] == 4
              and (r["k"], r["n"]) == (kk, n))
    once["device_vs_m4"] = once["device_ms"] / m4["device_ms"]
    print(f"K3 stream M={m} {kk}->{n}: device {once['device_ms']:.4f} ms, "
          f"{once['device_vs_m4']:.2f}x M=4's {m4['device_ms']:.4f}",
          flush=True)
    if not once["device_vs_m4"] < STREAM_ROWS_READ_ONCE:
        fail(f"K3 stream M={m} {kk}->{n}: {once['device_vs_m4']:.2f}x the "
             f"device time of M=4, not under {STREAM_ROWS_READ_ONCE}x: w "
             f"read more than once?")
    rows.append(once)
    return rows


def lm_parity_phase(torch, np, dev, counter, arch=LM_ARCH,
                    prompt_len=LM_PARITY_PROMPT, redraw=None, cut=None,
                    per_prefill=None, media_key=None):
    """Phase 7b (gemma2-2b, one local/global pair), 8b (rwkv6-1.6b, two
    layers), 9b (qwen3-moe-30b-a3b, two layers), 10b (zamba2-1.2b,
    ``cut`` to three layers in one group of two and a tail of one) and
    11b (the cross-attention families, their media cut too):
    ``arch`` at full width with its depth cut (``cut``: the config's
    changes, default 2 layers), float32, on the card and on the CPU with
    the same weights (``redraw``: a function that then redraws leaves of
    the tree from the same generator, ``rwkv_redraw``, ``ssm_redraw`` or
    ``vision_redraw``); a ``prompt_len``-token prefill and
    ``LM_PARITY_DECODE`` greedy tokens must agree (``LM_TOL``), as must
    the final caches (``LM_CACHE_TOL`` by the leaf's dtype).
    ``media_key``: the prefill's batch also carries seeded fp32 media
    under that key (``media_embeds`` or ``frames``, [1,
    ``num_media_tokens``, ``media_dim``]).  ``counter``, a kernel
    wrapper, must launch ``per_prefill`` times (default once a layer) in
    the card's prefill."""
    import dataclasses

    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree, tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch(arch), **(cut or {"num_layers": 2}),
                              dtype="float32", param_dtype="float32")
    per_prefill = cfg.num_layers if per_prefill is None else per_prefill
    gpu = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(gpu.param_spec(), gen, cfg.param_dtype)
    if redraw is not None:
        redraw(tree, gen)
    gpu.load_tree(tree)
    cpu = get_model(cfg).load_tree(tree_map(lambda t: t.cpu(), tree))
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len))
    media = None if media_key is None else rng.standard_normal(
        (1, cfg.cross_attn.num_media_tokens, cfg.cross_attn.media_dim)
    ).astype(np.float32)
    cache_len = prompt_len + LM_PARITY_DECODE + 8
    caches = {"gpu": gpu.init_cache(1, cache_len),
              "cpu": cpu.init_cache(1, cache_len)}
    models = {"gpu": gpu, "cpu": cpu}
    logits, tokens, worst = {}, {"gpu": [], "cpu": []}, {}
    label = f"{arch} parity"
    table, paths = getattr(counter, "path_launches", None), None
    # the CPU reference in one fixed order (ROADMAP F3): one intra-op
    # thread here, MKL_CBWR set before torch loaded
    with torch.no_grad(), one_thread(torch):
        for side, m in models.items():
            batch = {"tokens": torch.from_numpy(prompt).to(m.device)}
            if media is not None:
                batch[media_key] = torch.from_numpy(media).to(m.device)
            counter.launches = 0
            for k in table or ():
                table[k] = 0
            logits[side], _, _ = m(batch, mode="prefill",
                                   cache=caches[side])
            if side == "gpu":
                torch.cuda.synchronize()
                if counter.launches != per_prefill:
                    fail(f"{label}: the card's prefill launched its kernel "
                         f"{counter.launches} times, not {per_prefill}")
                paths = table and dict(table)
        ref = logits["cpu"]
        worst["prefill"] = _check_close(
            f"{label} prefill", logits["gpu"].cpu(), ref,
            LM_TOL["prefill"] * max(1.0, ref.abs().max().item()))
        worst["decode"] = 0.0
        for side in models:
            tokens[side].append(int(torch.argmax(logits[side][0, -1])))
        for i in range(LM_PARITY_DECODE - 1):
            pos = prompt_len + i
            for side, m in models.items():
                lg, _ = m.decode_step(
                    torch.tensor([[tokens[side][-1]]], device=m.device),
                    torch.tensor([pos], device=m.device), caches[side])
                logits[side] = lg
                tokens[side].append(int(torch.argmax(lg[0, 0])))
            ref = logits["cpu"]
            worst["decode"] = max(worst["decode"], _check_close(
                f"{label} decode step {i}", logits["gpu"].cpu(), ref,
                LM_TOL["decode"] * max(1.0, ref.abs().max().item())))
            if tokens["gpu"] != tokens["cpu"]:
                fail(f"{label}: greedy tokens {tokens['gpu']} on the card, "
                     f"{tokens['cpu']} on the CPU")
        worst["cache"] = 0.0
        for a, b in zip(tree_leaves(caches["gpu"]),
                        tree_leaves(caches["cpu"])):
            tol = LM_CACHE_TOL[str(b.dtype).replace("torch.", "")]
            worst["cache"] = max(worst["cache"], _check_close(
                f"{label} final cache", a.cpu(), b,
                tol * max(1.0, b.float().abs().max().item())))
    rec = {"arch": arch, "layers": cfg.num_layers, "prompt": prompt_len,
           **({"media": cfg.cross_attn.num_media_tokens}
              if media is not None else {}),
           "cpu_threads": 1, "mkl": torch.backends.mkl.is_available(),
           "mkl_cbwr": os.environ.get("MKL_CBWR"),
           "tokens": tokens["gpu"], "max_abs_err": worst,
           "tol": {**LM_TOL, "cache": LM_CACHE_TOL}}
    if paths:
        rec["paths"] = paths
    print(f"{label} " + json.dumps(rec), flush=True)
    return rec


def build_model(torch, arch, dev, redraw=None):
    """``arch`` at full width and depth with weights drawn on ``dev`` from
    ``SEED`` (``redraw``: then that function's leaves, ``rwkv_redraw``'s
    or ``ssm_redraw``'s, from the same generator); returns (model,
    seconds)."""
    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree

    t0 = time.perf_counter()
    model = get_model(get_arch(arch))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(model.param_spec(), gen, model.cfg.param_dtype)
    if redraw is not None:
        redraw(tree, gen)
    model.load_tree(tree)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def lm_serving_phase(torch, np, dev, counters, card, model, init_s, expect,
                     prompt_lens=None, new_tokens=None):
    """Phase 7c (gemma2-2b), 8c (rwkv6-1.6b), 9c (qwen3-moe-30b-a3b) and
    12 (gemma2-2b with the int8 cache): ``model`` served by
    ``ServingEngine`` on the card, twice, a request of ``new_tokens`` for
    each of ``prompt_lens``.  ``expect`` gives the launches of each kernel
    that ``counters`` names in every prefill and every decode step; every
    other counter must stay at 0.  ``prompt_lens`` and ``new_tokens``
    default to ``LM_PROMPTS`` and ``LM_NEW_TOKENS``.  Returns the record
    of both runs."""
    from repro_torch.kernels.attention.ops import k10_path
    from repro_torch.serving.engine import Request, ServingEngine

    prompt_lens = LM_PROMPTS if prompt_lens is None else prompt_lens
    new_tokens = LM_NEW_TOKENS if new_tokens is None else new_tokens
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    watched = {k: counters[k] for k in expect["prefill"]}
    k3_paths = counters["K3"].path_launches
    k10_paths = counters["K10"].path_launches

    def timed(fn, log, kind):
        def run(*args):
            torch.cuda.synchronize()
            before = {k: c.launches for k, c in watched.items()}
            paths, paths10 = dict(k3_paths), dict(k10_paths)
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            log.append({"kind": kind, "ms": (time.perf_counter() - t) * 1e3,
                        **{k: c.launches - before[k]
                           for k, c in watched.items()},
                        "k3_paths": {k: k3_paths[k] - paths[k]
                                     for k in paths},
                        "k10_paths": {k: k10_paths[k] - paths10[k]
                                      for k in paths10}})
            if kind == "prefill":
                log[-1]["tokens"] = len(args[1].prompt)
        return run

    runs = []
    for _ in range(2):
        eng = ServingEngine(model, max_batch=LM_MAX_BATCH,
                            max_len=LM_MAX_LEN, seed=SEED)
        if eng.device.type != "cuda":
            fail(f"{cfg.name} serving: engine on {eng.device}")
        log = []
        eng._prefill_into_slot = timed(eng._prefill_into_slot, log, "prefill")
        eng._decode_step = timed(eng._decode_step, log, "decode")
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=new_tokens))
        for fn in counters.values():
            fn.launches = 0
        for table in (k3_paths, k10_paths):
            for k in table:
                table[k] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: c.launches for k, c in watched.items()}
        others = {k: fn.launches for k, fn in counters.items()
                  if k not in launches and fn.launches}
        runs.append({"done": done, "log": log, "wall_s": wall,
                     "launches": launches, "other_launches": others,
                     "k3_paths": dict(k3_paths),
                     "k10_paths": dict(k10_paths)})
        del eng
    first, second = runs
    label = f"{cfg.name} serving"
    if sorted(first["done"]) != list(range(len(prompts))):
        fail(f"{label}: finished {sorted(first['done'])}")
    for rid, toks in first["done"].items():
        if len(toks) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"{label}: request {rid} gave {toks}")
    if second["done"] != first["done"]:
        fail(f"{label}: a second run gave other tokens")
    for run in runs:
        if run["other_launches"]:
            fail(f"{label}: other kernels launched {run['other_launches']}")
        steps = {kind: [r for r in run["log"] if r["kind"] == kind]
                 for kind in ("prefill", "decode")}
        if (len(steps["prefill"]) != len(prompts)
                or len(steps["decode"]) != new_tokens - 1):
            fail(f"{label}: {len(steps['prefill'])} prefills, "
                 f"{len(steps['decode'])} decode steps")
        for kind, rows in steps.items():
            for r in rows:
                got = {k: r[k] for k in watched}
                what = (f"a prefill of {r['tokens']} tokens"
                        if kind == "prefill" else "a decode step")
                if got != expect[kind]:
                    fail(f"{label}: {what} launched {got}, expected "
                         f"{expect[kind]}")
                # every projection of a prefill of 64 tokens or more on
                # the wgmma path; shorter prompts and decode steps stream
                tiled = kind == "prefill" and r["tokens"] >= 64
                want = {**dict.fromkeys(k3_paths, 0),
                        "wgmma" if tiled else "stream": expect[kind]["K3"]}
                if r["k3_paths"] != want:
                    fail(f"{label}: {what} took K3's paths {r['k3_paths']}, "
                         f"expected {want}")
                # every K10 launch of a prefill on the path k10_path names
                # for the model's type (bf16: wgmma)
                n10 = expect[kind].get("K10", 0)
                want = dict.fromkeys(k10_paths, 0)
                if n10:
                    want[k10_path(getattr(torch, cfg.dtype), r["tokens"],
                                  r["tokens"], cfg.head_dim)] = n10
                if r["k10_paths"] != want:
                    fail(f"{label}: {what} took K10's paths "
                         f"{r['k10_paths']}, expected {want}")
        want = {k: sum(expect[kind][k] * len(rows)
                       for kind, rows in steps.items()) for k in watched}
        if run["launches"] != want:
            fail(f"{label}: launches {run['launches']}, expected {want}")
    tokens = sum(len(t) for t in first["done"].values())
    rec = {"arch": cfg.name, "params": n_params, "init_s": init_s,
           "max_batch": LM_MAX_BATCH, "max_len": LM_MAX_LEN,
           "prompts": list(prompt_lens), "new_tokens": new_tokens,
           "tokens": {str(k): v for k, v in first["done"].items()},
           "launches": first["launches"], "k3_paths": first["k3_paths"],
           "k10_paths": first["k10_paths"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "runs": [{"wall_s": r["wall_s"], "tokens_per_s":
                     tokens / r["wall_s"], "log": r["log"]} for r in runs]}
    for i, r in enumerate(rec["runs"]):
        pre = ", ".join(f"{x['tokens']}: {x['ms']:.1f}" for x in r["log"]
                        if x["kind"] == "prefill")
        dec = [x["ms"] for x in r["log"] if x["kind"] == "decode"]
        print(f"{label} run {i + 1}: prefill ms by prompt length {{{pre}}}"
              f", decode step at {LM_MAX_BATCH} slots median "
              f"{statistics.median(dec):.2f} ms, {r['tokens_per_s']:.1f} "
              f"tokens/s over {r['wall_s']:.2f} s, peak memory "
              f"{rec['peak_memory_gb']:.2f} GB [{card}]", flush=True)
    return rec


#: device-kernel names of the port's kernels, for the profile's breakdown
PROFILE_GROUPS = (("K3", ("mm_wgmma", "mm_tiled", "mm_stream")),
                  ("K10", ("flash_wgmma", "flash_fwd")),
                  ("K11", ("wkv6_chunk", "wkv6_walk")))
#: K3's device kernels by path
K3_PROFILE_PATHS = (("stream", "mm_stream"), ("tiles", "mm_tiled"),
                    ("wgmma", "mm_wgmma"))


def lm_profile(torch, model, card, ranges=()):
    """Phase 7d, 8c, 9d and 10d: ``torch.profiler`` over one prefill of
    ``LM_PROFILE_PROMPT`` tokens and three decode steps at
    ``LM_MAX_BATCH`` active slots of the full model; returns, per window,
    the wall time, the device time summed over kernels and copies, their
    ratio (the device's busy share), their count, the device time of each
    kernel of the port and of the rest, and the largest device-time
    names.  ``ranges`` names functions (label, module, attribute) to run
    inside a ``record_function`` of their label while profiling; each
    label's device time, launches and host time join the window's record
    (see ``profile_windows``)."""
    import numpy as np

    from repro_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(SEED)
    eng = ServingEngine(model, max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN,
                        seed=SEED)
    prompt = rng.integers(0, model.cfg.vocab_size,
                          LM_PROFILE_PROMPT).tolist()
    for rid in range(LM_MAX_BATCH):
        eng.submit(Request(rid, prompt, max_new_tokens=LM_NEW_TOKENS))
    eng.step()  # warm: prefills and one decode step
    windows = {
        "prefill": lambda: eng._prefill_into_slot(
            0, Request(9, prompt, max_new_tokens=LM_NEW_TOKENS)),
        "decode_x3": lambda: [eng._decode_step() for _ in range(3)],
    }
    return profile_windows(torch, model.cfg.name, windows, card, ranges)


def profile_windows(torch, title, windows, card, ranges=()):
    """``torch.profiler`` over each of ``windows`` (name -> a function to
    run), as ``lm_profile`` describes; ``title`` labels the printed
    lines.  Each range of ``ranges`` gives, summed over its calls:
    ``device_ms_by_range``, the device time of every kernel and copy
    launched inside it, and ``port_device_ms_by_range``, that of K3's,
    K10's and K11's kernels among them: a kernel belongs to the ranges
    that enclose the host call which launched it (the runtime's launch
    event, which shares the kernel's correlation id).  The profiler's own
    device time of a range (``device_time_total``) would miss the port's
    kernels: their launch events carry no kernel, as the launch comes
    through ctypes and no ATen operator.  Also ``port_launches_by_range``
    (the wrappers' counters) and ``host_ms_by_range``.  Returns the
    record of each window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.matmul_fused.ops import matmul_fused
    from repro_torch.kernels.wkv6.ops import wkv6

    port = (matmul_fused, flash_attention, wkv6)
    labels = list(dict.fromkeys(label for label, _, _ in ranges))

    def counts():
        return [w.launches for w in port]

    def labelled(label, fn, calls):
        def call(*args, **kw):
            before = counts()
            with record_function(label):
                out = fn(*args, **kw)
            calls.append((label, before, counts()))
            return out
        return call

    out = {}
    for name, fn in windows.items():
        calls = []
        saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in ranges]
        for (label, _, _), (mod, attr, real) in zip(ranges, saved):
            setattr(mod, attr, labelled(label, real, calls))
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        finally:
            for mod, attr, real in saved:
                setattr(mod, attr, real)
        # device-side events only (kernels, copies): an operator's own
        # entry would count its kernels' time a second time, and a
        # range's device-side entry the time of the kernels inside it
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and e.key not in labels]
        dev = sum(r[1] for r in rows)
        by_kernel = {kid: sum(ms for key, ms, _ in rows
                              if any(nm in key for nm in names))
                     for kid, names in PROFILE_GROUPS}
        by_kernel["rest"] = dev - sum(by_kernel.values())
        k3_by_path = {path: sum(ms for key, ms, _ in rows if nm in key)
                      for path, nm in K3_PROFILE_PATHS}
        events = prof.events()
        cpu, cuda = (torch.autograd.DeviceType.CPU,
                     torch.autograd.DeviceType.CUDA)
        # the runtime's launch and copy calls by correlation id (an
        # operator's id is from another count, so only ``cu*`` calls)
        launch_calls = {e.id: e for e in events
                        if e.device_type == cpu and e.name.startswith("cu")}
        port_names = [nm for _, names in PROFILE_GROUPS for nm in names]
        dev_by_range = dict.fromkeys(labels, 0.0)
        port_by_range = dict.fromkeys(labels, 0.0)
        for e in events:
            call = launch_calls.get(e.id)
            if e.device_type != cuda or e.name in labels or call is None:
                continue
            ms = e.self_device_time_total / 1e3
            ours = any(nm in e.name for nm in port_names)
            within = set()
            while call is not None:
                if call.name in labels:
                    within.add(call.name)
                call = call.cpu_parent
            for label in within:
                dev_by_range[label] += ms
                port_by_range[label] += ms if ours else 0.0
        launches = dict.fromkeys(labels, 0)
        for label, before, after in calls:
            launches[label] += sum(after) - sum(before)
        # the range's wall time on the host, callees in
        host_by_range = {label: sum(e.cpu_time_total for e in events
                                    if e.name == label
                                    and e.device_type == cpu) / 1e3
                         for label in labels}
        rows.sort(key=lambda r: -r[1])
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "busy_share": dev / wall if dev else None,
                     "device_calls": sum(n for _, _, n in rows),
                     "device_ms_by_kernel": by_kernel,
                     "k3_device_ms_by_path": k3_by_path,
                     "top": [{"name": k[:80], "ms": ms, "calls": n}
                             for k, ms, n in rows[:10]]}
        if labels:
            out[name].update(device_ms_by_range=dev_by_range,
                             port_device_ms_by_range=port_by_range,
                             port_launches_by_range=launches,
                             host_ms_by_range=host_by_range)
        rnd = lambda d: {k: round(v, 3) for k, v in d.items()}  # noqa: E731
        print(f"{title} profile {name}: wall {wall:.2f} ms, device "
              f"{dev:.2f} ms in {out[name]['device_calls']} kernels and "
              f"copies, by kernel {rnd(by_kernel)}, K3 by path "
              f"{rnd(k3_by_path)}"
              + (f", by range: device {rnd(dev_by_range)} (the port's "
                 f"{rnd(port_by_range)} in {launches} launches), host "
                 f"{rnd(host_by_range)}"
                 if labels else "") + f" [{card}]", flush=True)
    return out


#: phase 8: rwkv6-1.6b and K11's cases
RWKV_ARCH = "rwkv6-1.6b"
RWKV_PARITY_PROMPT = 100  # two chunks of 64, the second padded
#: K11 cases: (tokens, dtype, decays).  b 1 and rwkv6-1.6b's 32 heads of
#: 64; decays "normal" logw = -exp(N(0, 0.5)), "strong" -exp(N(2, 1)),
#: whose sums within a chunk go far below the -88 where exp overflows a
#: product of two factors.  37 tokens: one chunk whose last sub-chunk has
#: 5 rows.  The kernels line takes the 4500-token bf16 case with normal
#: decays.
K11_CASES = ((16, "bfloat16", "normal"), (37, "bfloat16", "normal"),
             (300, "bfloat16", "normal"),
             (1500, "bfloat16", "normal"), (4500, "bfloat16", "normal"),
             (4500, "bfloat16", "strong"), (4500, "float32", "normal"))
K11_DECAYS = {"normal": (0.0, 0.5), "strong": (2.0, 1.0)}
K11_HEADS = 32
K11_HANDOFF = 1500
#: K3's three distinct projection shapes (K, N, activation) in an
#: rwkv6-1.6b layer: r, k, v, g, o and the channel mix's receptance; the
#: channel mix's key (with relu); its value
K3_RWKV_SHAPES = ((2048, 2048, "none"), (2048, 7168, "relu"),
                  (7168, 2048, "none"))
#: the final caches of the parity phases, relative to max(1, max|CPU|):
#: bf16 KV rows one rounding apart (2^-7), fp32 RWKV states as the logits
LM_CACHE_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}


def wkv6_cost(b, s, h, e, chunk, dtype_bytes):
    """(operations, bytes) the chunked WKV needs, from K11's arithmetic:
    per chunk of n rows and n (n - 1) / 2 pairs j < i, the cumulative
    decays and cw_prev (2 n e), each pair's decay and product (5 e: a
    difference, an exp, two products, a sum), A v (2 e a pair), the bonus
    (5 n e), r ⊙ exp(cw_prev) (2 n e) and its product with S (2 n e^2),
    k ⊙ exp(cw_L - cw) (3 n e), the state update (2 n e^2 + 3 e^2).
    Bytes: r, k, v and o once in their type, logw and u in fp32, the final
    state in fp32."""
    L = min(chunk, s)
    ops = 0.0
    for t0 in range(0, s, L):
        n = min(L, s - t0)
        pairs = n * (n - 1) / 2
        ops += (2 * n * e + 7 * pairs * e + 5 * n * e + 2 * n * e
                + 2 * n * e * e + 3 * n * e + 2 * n * e * e + 3 * e * e)
    elems = b * s * h * e
    nbytes = (4 * dtype_bytes * elems + 4 * elems + 4 * h * e
              + 4 * b * h * e * e)
    return b * h * ops, float(nbytes)


def wkv6_design_bytes(plan, s, h, dtype_bytes, b=1):
    """Bytes K11's three passes move (``wkv6_plan``'s geometry): pass 1
    reads k, v and logw and writes U and the decays; pass 2 reads and
    writes U, reads the decays and writes the final state; pass 3 reads
    r, k, v, logw, u and S_prev and writes o once."""
    elems = b * s * h * 64
    u_bytes = 4 * plan.items * 64 * 64
    d_bytes = 4 * plan.items * 64
    pass1 = 2 * dtype_bytes * elems + 4 * elems + u_bytes + d_bytes
    pass2 = 2 * u_bytes + d_bytes + 4 * plan.walkers
    pass3 = 4 * dtype_bytes * elems + 4 * elems + 4 * h * 64 + u_bytes
    return float(pass1 + pass2 + pass3)


def rwkv_kernel_cases(torch, F, dev, peaks):
    """Phase 8a: K11 at rwkv6-1.6b's shapes (``K11_CASES``, then a state
    hand-off) and K3 (bf16) at its projections against their plain
    versions, repeated bit for bit, timed; returns the records."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_plan
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

    fp32_peak, bw_peak, _ = peaks
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(s, dt, decay):
        mean, std = K11_DECAYS[decay]
        shape = (1, s, K11_HEADS, 64)
        r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        logw = -torch.exp(mean + std * torch.randn(shape, generator=gen,
                                                   device=dev))
        u = 0.5 * torch.randn((K11_HEADS, 64), generator=gen, device=dev)
        return r, k, v, logw, u

    rows = []
    for s, dname, decay in K11_CASES:
        r, k, v, logw, u = inputs(s, getattr(torch, dname), decay)
        kernel = lambda: wkv6(r, k, v, logw, u, chunk=64)  # noqa: E731
        plain = lambda: wkv6_chunked_ref(r, k, v, logw, u, 64)  # noqa: E731
        ref_o, ref_s = plain()
        out_o, out_s = kernel()
        torch.cuda.synchronize()
        rtol, atol = LM_KERNEL_TOL[dname]
        label = f"K11 {dname} s={s} decays {decay}"
        err = _check_close(label, out_o, ref_o, atol, rtol)
        s_rtol, s_atol = LM_KERNEL_TOL["float32"]
        s_err = _check_close(f"{label} state", out_s, ref_s, s_atol, s_rtol)
        again = kernel()
        if not (torch.equal(again[0], out_o) and torch.equal(again[1], out_s)):
            fail(f"{label}: a repeated launch differs")
        flops, nbytes = wkv6_cost(1, s, K11_HEADS, 64, 64,
                                  out_o.element_size())
        plan = wkv6_plan(1, s, K11_HEADS, min(64, s), sm_count(dev))
        design_bytes = wkv6_design_bytes(plan, s, K11_HEADS,
                                         out_o.element_size())
        rec = {"kernel": "K11", "tokens": s, "heads": K11_HEADS,
               "dtype": dname, "decays": decay, "max_abs_err": err,
               "state_max_abs_err": s_err,
               "tol": {"rtol": rtol, "atol": atol,
                       "state_rtol": s_rtol, "state_atol": s_atol},
               "rms_plain": ref_o.float().square().mean().sqrt().item(),
               "max_abs_plain": ref_o.float().abs().max().item(),
               "ms": time_ms(torch, kernel),
               "host_ms": host_call_ms(torch, kernel),
               "device_ms": stream_device_ms(torch, kernel),
               "plain_ms": time_ms(torch, plain, reps=5),
               "library_ms": None,
               "library_note": "no single PyTorch call computes WKV6",
               "design": {
                   "launches": 3, "grids": plan.grids,
                   "items": plan.items, "walkers": plan.walkers,
                   "waves": plan.waves, "exps": plan.exps,
                   "operations": plan.operations, "bytes": design_bytes,
                   "scratch_bytes": 4 * plan.scratch_elems,
                   "bound_ms": 1e3 * max(plan.operations / fp32_peak,
                                         design_bytes / bw_peak)},
               "bound_ms": 1e3 * max(flops / fp32_peak, nbytes / bw_peak),
               "bound_by": "operations" if flops / fp32_peak > nbytes / bw_peak
               else "bytes", "flops": flops, "bytes": nbytes,
               "peak": fp32_peak,
               "main": (s, dname, decay) == (4500, "bfloat16", "normal")}
        rows.append(rec)
        print("case " + json.dumps(rec), flush=True)
    # the state hand-off: two calls over the halves (the second one from
    # the first one's final state) against one call over the whole.  The
    # halves' chunks start at 750, not at a multiple of 64, so the state is
    # the same sum in other groupings: its elements are held at fp32's
    # rtol plus 1e-5 of the largest state (each element's rounding follows
    # the size of its terms, not its own)
    r, k, v, logw, u = inputs(K11_HANDOFF, torch.bfloat16, "normal")
    whole_o, whole_s = wkv6(r, k, v, logw, u, chunk=64)
    h = K11_HANDOFF // 2
    first_o, first_s = wkv6(*(t[:, :h].contiguous() for t in (r, k, v, logw)),
                            u, chunk=64)
    second_o, second_s = wkv6(*(t[:, h:].contiguous()
                                for t in (r, k, v, logw)),
                              u, chunk=64, state=first_s)
    torch.cuda.synchronize()
    rtol, atol = LM_KERNEL_TOL["bfloat16"]
    o_err = _check_close("K11 hand-off o", torch.cat([first_o, second_o], 1),
                         whole_o, atol, rtol)
    s_atol = 1e-5 * max(1.0, whole_s.abs().max().item())
    s_err = _check_close("K11 hand-off state", second_s, whole_s, s_atol,
                         LM_KERNEL_TOL["float32"][0])
    rows.append({"kernel": "K11-handoff", "tokens": K11_HANDOFF, "split": h,
                 "max_abs_err": o_err, "state_max_abs_err": s_err,
                 "state_atol": s_atol, "main": False})
    print("case " + json.dumps(rows[-1]), flush=True)
    for m in K3_LM_ROWS:
        for kk, n, act in K3_RWKV_SHAPES:
            rows.append(k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks,
                                     m in K3_LM_MAIN_ROWS))
    return rows


def launcher_phase(torch, counters, arch, kid, per_prefill=None):
    """Phase 8d, 9e and 10e: ``repro_torch.launch.serve.main(["--arch",
    arch])`` on the card (its default device, the reduced model): a token
    list for every request, and ``kid`` (K11 for rwkv6, K10 for a
    transformer or zamba2's shared block) ``per_prefill`` times (default
    once a layer) in every prefill."""
    from repro_torch.core.config import get_arch
    from repro_torch.launch.serve import main as serve_main

    for fn in counters.values():
        fn.launches = 0
    out = serve_main(["--arch", arch])
    torch.cuda.synchronize()
    n_req = 6  # the launcher's default --requests
    if per_prefill is None:
        per_prefill = get_arch(arch).reduced().num_layers
    want = per_prefill * n_req
    done = out["done"]
    if sorted(done) != list(range(n_req)) or not all(done.values()):
        fail(f"{arch} launcher: finished {sorted(done)}")
    if counters[kid].launches != want:
        fail(f"{arch} launcher: {kid} launched {counters[kid].launches} "
             f"times, expected {want}")
    rec = {"arch": arch, "requests": n_req, "tokens": out["tokens"],
           "seconds": out["seconds"], f"{kid.lower()}_launches": want,
           "k3_launches": counters["K3"].launches}
    print("launcher " + json.dumps(rec), flush=True)
    return rec


#: phase 9: qwen3-moe-30b-a3b and K3/K10 at its attention's shapes
MOE_ARCH = "qwen3-moe-30b-a3b"
#: K3's three distinct projection shapes (K, N, activation) in a qwen3
#: attention: q; k and v; o (the MoE experts are batched torch.matmul)
K3_MOE_SHAPES = ((2048, 4096, "none"), (2048, 512, "none"),
                 (4096, 2048, "none"))
#: K10 at qwen3's attention (32 heads over 4, head_dim 128, causal, no cap,
#: no window) at its two longest prompts, as K10_CASES
K10_MOE_CASES = ((1500, 0, 0.0, "bfloat16", 32, 4, 128, True),
                 (4500, 0, 0.0, "bfloat16", 32, 4, 128, True))


def memory_budget(model):
    """GB the served model needs on the card: its weights, the cache of
    ``LM_MAX_BATCH`` slots of ``LM_MAX_LEN`` rows (the bf16 k/v leaves
    and the fp32 recurrent ones: zamba2's conv rows and SSD states), and
    the fp32 logits of the longest prompt."""
    import math

    from repro_torch.nn.param import tree_leaves

    cfg = model.cfg
    leaves = tree_leaves(model.cache_spec(LM_MAX_BATCH, LM_MAX_LEN))
    return {"weights": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
            "kv_cache": sum(2 * math.prod(p.shape) for p in leaves
                            if p.dtype != "float32") / 1e9,
            "state_cache": sum(4 * math.prod(p.shape) for p in leaves
                               if p.dtype == "float32") / 1e9,
            "logits": 4 * max(LM_PROMPTS) * cfg.padded_vocab / 1e9}


def moe_kernel_cases(torch, F, dev, peaks):
    """Phase 9a: K10 and K3 (bf16) at qwen3-moe-30b-a3b's attention shapes
    against their plain versions, repeated bit for bit, timed as in 7a;
    returns the records (none of them feeds the kernels line)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = [k10_case(torch, F, gen, dev, case, peaks)
            for case in K10_MOE_CASES]
    for m in K3_LM_ROWS:
        for kk, n, act in K3_MOE_SHAPES:
            rows.append(k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks,
                                     False))
    for r in rows:
        r["arch"] = MOE_ARCH
    return rows


@contextlib.contextmanager
def record_routing(torch, log):
    """Every MoE block's routing while inside: ``repro_torch.models.
    common.moe_apply`` wrapped so that each call appends, from
    ``repro_torch.nn.moe.route`` on the same inputs, its device, mode and
    capacity, the chosen experts, the kept pairs in flat (token, k) order,
    the dropped count, and the smallest margin between a token's k-th and
    (k+1)-th router probability."""
    from repro_torch.models import common
    from repro_torch.nn import moe

    real = common.moe_apply

    def wrapped(params, x, cfg, *, dp_size=1, mode="train"):
        r = moe.route(params, x, cfg, dp_size=dp_size, mode=mode)
        k = cfg.moe.num_experts_per_token
        top = torch.topk(r.probs, k + 1, dim=-1).values
        kept = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
        log.append({"device": x.device.type, "mode": mode, "cap": r.cap,
                    "experts": r.e_k.cpu(), "kept": kept.cpu(),
                    "dropped": int((~r.keep).sum()),
                    "margin": (top[..., k - 1] - top[..., k]).min().item()})
        return real(params, x, cfg, dp_size=dp_size, mode=mode)

    common.moe_apply = wrapped
    try:
        yield
    finally:
        common.moe_apply = real


def check_routing(log):
    """Phase 9b: the card's blocks chose the CPU's experts and kept its
    pairs, call by call; returns the summary."""
    sides = {d: [r for r in log if r["device"] == d] for d in ("cuda", "cpu")}
    gpu, cpu = sides["cuda"], sides["cpu"]
    if not gpu or len(gpu) != len(cpu):
        fail(f"{MOE_ARCH} parity: {len(gpu)} MoE calls on the card, "
             f"{len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if (a["mode"], a["cap"]) != (b["mode"], b["cap"]):
            fail(f"{MOE_ARCH} parity: MoE call {i} ran {a['mode']} cap "
                 f"{a['cap']} on the card, {b['mode']} cap {b['cap']} on "
                 f"the CPU")
        if not a["experts"].equal(b["experts"]):
            fail(f"{MOE_ARCH} parity: MoE call {i} ({a['mode']}) chose other "
                 f"experts on the card than on the CPU (smallest margin "
                 f"{min(a['margin'], b['margin'])})")
        if not a["kept"].equal(b["kept"]):
            fail(f"{MOE_ARCH} parity: MoE call {i} ({a['mode']}) kept other "
                 f"pairs on the card than on the CPU")
    prefill = [r for r in gpu if r["mode"] == "prefill"]
    if any(r["dropped"] for r in gpu if r["mode"] == "decode"):
        fail(f"{MOE_ARCH} parity: a decode step dropped pairs")
    rec = {"calls": len(gpu), "prefill_cap": prefill[0]["cap"],
           "prefill_dropped": [r["dropped"] for r in prefill],
           "decode_dropped": sum(r["dropped"] for r in gpu
                                 if r["mode"] == "decode"),
           "min_margin": min(r["margin"] for r in gpu + cpu),
           "min_margin_prefill": min(r["margin"] for r in prefill)}
    print(f"{MOE_ARCH} routing " + json.dumps(rec), flush=True)
    return rec


#: phase 10: zamba2-1.2b, its Mamba2 (SSD) blocks and the shared block
ZAMBA_ARCH = "zamba2-1.2b"
#: the parity phase's depth cut: one group of two Mamba blocks, one
#: shared-block invocation and a tail of one; its prompt is two chunks of
#: 128, the second padded by 56 zero rows
ZAMBA_CUT = {"num_layers": 3, "shared_attn_every": 2}
ZAMBA_PARITY_PROMPT = 200
#: K3's seven projections (name, K, N, activation) in zamba2-1.2b: a Mamba
#: block's in_proj (N = 8384 = 65 * 128 + 64: the wgmma path's last tile
#: is half past the end of w and y) and out_proj; the shared block's q, k,
#: v and o, its gate (silu) and up, its down; shared_out
K3_ZAMBA_SHAPES = (("in_proj", 2048, 8384, "none"),
                   ("out_proj", 4096, 2048, "none"),
                   ("shared_qkvo", 4096, 4096, "none"),
                   ("shared_gate", 4096, 8192, "silu"),
                   ("shared_up", 4096, 8192, "none"),
                   ("shared_down", 8192, 4096, "none"),
                   ("shared_out", 4096, 2048, "none"))
#: K10 at the shared block's attention (32 heads over 32, head_dim 128,
#: causal, no cap, no window) at the two longest prompts, as K10_CASES
K10_ZAMBA_CASES = ((1500, 0, 0.0, "bfloat16", 32, 32, 128, True),
                   (4500, 0, 0.0, "bfloat16", 32, 32, 128, True))


def zamba_kernel_cases(torch, F, dev, peaks):
    """Phase 10a: K10 and K3 (bf16) at zamba2-1.2b's shapes against their
    plain versions, repeated bit for bit, timed as in 7a (the K3 case at
    N = 8384 also every row of its last tile on its own); returns the
    records (none of them feeds the kernels line)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = [k10_case(torch, F, gen, dev, case, peaks)
            for case in K10_ZAMBA_CASES]
    for m in K3_LM_ROWS:
        for name, kk, n, act in K3_ZAMBA_SHAPES:
            rows.append(k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks,
                                     False, projection=name))
    for r in rows:
        r["arch"] = ZAMBA_ARCH
    return rows


def zamba_phase(torch, F, np, dev, peaks, counters, card):
    """Phase 10 (see the module docstring): zamba2-1.2b's kernel cases,
    its CPU parity, the served model, its profile and the launcher;
    returns (cases, parity record, serving record)."""
    from repro_torch.core.config import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models import zamba2 as zamba_mod
    from repro_torch.nn import ssm as ssm_mod

    t10 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cases = zamba_kernel_cases(torch, F, dev, peaks)
    parity = lm_parity_phase(
        torch, np, dev, attn_ops.flash_attention, ZAMBA_ARCH,
        ZAMBA_PARITY_PROMPT, redraw=ssm_mod.ssm_redraw, cut=ZAMBA_CUT,
        per_prefill=ZAMBA_CUT["num_layers"] // ZAMBA_CUT["shared_attn_every"])
    if parity["paths"] != {"simt": 1, "wgmma": 0}:
        fail(f"{ZAMBA_ARCH} parity: the fp32 prefill took K10's paths "
             f"{parity['paths']}, not the CUDA-core kernel alone")
    gc.collect()
    torch.cuda.empty_cache()
    model, init_s = build_model(torch, ZAMBA_ARCH, dev,
                                redraw=ssm_mod.ssm_redraw)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    # two projections a Mamba block, eight a shared-block invocation (q, k,
    # v, o, gate, up, down, shared_out); K10 once an invocation
    n_k3 = 2 * model.cfg.num_layers + 8 * model.n_groups
    rec = lm_serving_phase(
        torch, np, dev, counters, card, model, init_s,
        {"prefill": {"K3": n_k3, "K10": model.n_groups, "K11": 0},
         "decode": {"K3": n_k3, "K10": 0, "K11": 0}})
    if rec["k10_paths"] != {"simt": 0, "wgmma": rec["launches"]["K10"]}:
        fail(f"{ZAMBA_ARCH} serving: K10's prefill launches took the paths "
             f"{rec['k10_paths']}, not the wgmma path alone")
    rec["init_peak_memory_gb"] = init_peak
    rec["budget_gb"] = memory_budget(model)
    rec["profile"] = lm_profile(
        torch, model, card,
        (("mamba block", zamba_mod.Zamba2LM, "_mamba_block"),
         ("ssm conv", ssm_mod, "_causal_conv"),
         ("ssd scan", ssm_mod, "_ssd_chunked"),
         ("shared block", zamba_mod.Zamba2LM, "_shared_apply")))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    reduced = get_arch(ZAMBA_ARCH).reduced()
    rec["launcher"] = launcher_phase(
        torch, counters, ZAMBA_ARCH, "K10",
        reduced.num_layers // reduced.shared_attn_every)
    rec["phase_s"] = time.perf_counter() - t10
    rec["phase_peak_memory_gb"] = max(
        init_peak, torch.cuda.max_memory_allocated() / 1e9)
    print("zamba " + json.dumps({k: v for k, v in rec.items()
                                 if k != "runs"}), flush=True)
    print(f"phase 10 wall time {rec['phase_s']:.1f} s, peak memory "
          f"{rec['phase_peak_memory_gb']:.2f} GB (init "
          f"{init_peak:.2f}, serving {rec['peak_memory_gb']:.2f}; budget "
          f"{ {k: round(v, 2) for k, v in rec['budget_gb'].items()} }) "
          f"[{card}]", flush=True)
    return cases, parity, rec


#: phase 11: the cross-attention families
VLM_ARCH = "llama-3.2-vision-11b"
AUDIO_ARCH = "seamless-m4t-large-v2"
#: the parity phase cuts both families' media (frames) to this many, so
#: that the CPU side stays small; the served runs keep 6400 and 4096
CROSS_PARITY_MEDIA = 512
#: the prompt length of the batch whose decode step phase 11c times at
#: ``LM_MAX_BATCH`` slots, and of the prompt whose greedy tokens must move
#: when llama's gates are zeroed
CROSS_BATCH_PROMPT = 300
#: K10 at the cross families' shapes, (case as ``K10_CASES``, keys; a
#: non-causal case names its keys, so that SDPA without a mask is its
#: yardstick): the cross-attention of a llama prefill (32 heads over 8,
#: head_dim 128) against its 6400 media tokens at 16, 1500 and 4500
#: prompt tokens; seamless's encoder (16 over 16, head_dim 64, 4096 x
#: 4096) and its decoder's causal self-attention at 1500
K10_CROSS_CASES = (((16, 0, 0.0, "bfloat16", 32, 8, 128, False), 6400),
                   ((1500, 0, 0.0, "bfloat16", 32, 8, 128, False), 6400),
                   ((4500, 0, 0.0, "bfloat16", 32, 8, 128, False), 6400),
                   ((4096, 0, 0.0, "bfloat16", 16, 16, 64, False), 4096),
                   ((1500, 0, 0.0, "bfloat16", 16, 16, 64, True), None))
#: K3 at the cross families' projections: (arch, name, K, N, activation,
#: bias, rows).  seamless's MLP carries fp32 biases (up with gelu) and its
#: attention's q/k/v/o none (1024 -> 1024: on the weight stream 8 K slices
#: of 2 ring stages, fewer than ``SW_STAGES``), at a decoder's rows and the
#: encoder's 4096; llama's q/o, k/v, gate (silu) and down at a prompt's
#: rows and the media's 6400; the projector and the frontend (with biases)
#: at the media's and the frames' rows
K3_CROSS_SHAPES = (
    (AUDIO_ARCH, "w_up", 1024, 8192, "gelu", True, K3_LM_ROWS + (4096,)),
    (AUDIO_ARCH, "w_down", 8192, 1024, "none", True, K3_LM_ROWS + (4096,)),
    (AUDIO_ARCH, "qkvo", 1024, 1024, "none", False, K3_LM_ROWS + (4096,)),
    (AUDIO_ARCH, "frontend", 1024, 1024, "none", True, (4096,)),
    (VLM_ARCH, "qo", 4096, 4096, "none", False, K3_LM_ROWS + (6400,)),
    (VLM_ARCH, "kv", 4096, 1024, "none", False, K3_LM_ROWS + (6400,)),
    (VLM_ARCH, "gate", 4096, 14336, "silu", False, K3_LM_ROWS + (6400,)),
    (VLM_ARCH, "down", 14336, 4096, "none", False, K3_LM_ROWS + (6400,)),
    (VLM_ARCH, "projector", 4096, 4096, "none", True, (6400,)))


def cross_kernel_cases(torch, F, dev, peaks):
    """Phase 11a: K10 non-causal at sq != skv (head_dim 128) and at
    head_dim 64, and K3 in bf16 with and without a bias, at the cross
    families' shapes, against their plain versions, repeated bit for bit,
    timed as in 7a; returns the records (each with its ``arch``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for case, skv in K10_CROSS_CASES:
        r = k10_case(torch, F, gen, dev, case, peaks, skv=skv)
        r["arch"] = VLM_ARCH if case[6] == 128 else AUDIO_ARCH
        rows.append(r)
    for arch, name, kk, n, act, bias, ms in K3_CROSS_SHAPES:
        for m in ms:
            r = k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks, False,
                             bias=bias, projection=name)
            r["arch"] = arch
            rows.append(r)
    return rows


def cross_serving_phase(torch, np, dev, counters, card, model, init_s,
                        expect, media_key):
    """Phase 11c: ``model`` (llama-3.2-vision-11b or seamless-m4t-large-v2,
    full width and depth, bf16) driven through ``forward(batch,
    "prefill", cache)`` and ``decode_step`` on the card, twice: for each
    prompt of ``LM_PROMPTS`` one prefill into a ``LM_MAX_LEN`` cache and
    ``LM_NEW_TOKENS`` greedy steps, then a batch of ``LM_MAX_BATCH``
    prompts of ``CROSS_BATCH_PROMPT`` tokens and its steps at that many
    slots.  Seeded bf16 media under ``media_key``.  With the counters set
    to 0 before each call and read after, every prefill and step must
    launch ``expect[kind]`` (every other counter 0), K3 on the wgmma path
    for the media's ``expect["media_k3"]`` projections and for the
    prompt's from 64 rows on (the weight stream below), K10 on the wgmma
    path; the logits must be finite and the second run must repeat the
    tokens.  Returns the record and the function that generates a
    prompt's tokens (``generate(prompt, log)``)."""
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in LM_PROMPTS]
    prompts.append(rng.integers(0, cfg.vocab_size,
                                (LM_MAX_BATCH, CROSS_BATCH_PROMPT)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    media = torch.randn((LM_MAX_BATCH, cfg.cross_attn.num_media_tokens,
                         cfg.cross_attn.media_dim), generator=gen,
                        device=dev).bfloat16()
    k3_paths = counters["K3"].path_launches
    k10_paths = counters["K10"].path_launches
    label = f"{cfg.name} serving"

    def timed(kind, fn, rows, log):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        for table in (k3_paths, k10_paths):
            for k in table:
                table[k] = 0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = {k: c.launches for k, c in counters.items() if c.launches}
        want = {k: n for k, n in expect[kind].items() if n}
        what = (f"a prefill of {rows} rows" if kind == "prefill"
                else f"a decode step at {rows} slots")
        if got != want:
            fail(f"{label}: {what} launched {got}, expected {want}")
        n3 = expect[kind]["K3"]
        wg = n3 if rows >= 64 else expect["media_k3"] * (kind == "prefill")
        want3 = {**dict.fromkeys(k3_paths, 0), "wgmma": wg}
        want3["stream"] = n3 - wg
        if dict(k3_paths) != want3:
            fail(f"{label}: {what} took K3's paths {dict(k3_paths)}, "
                 f"expected {want3}")
        want10 = {**dict.fromkeys(k10_paths, 0),
                  "wgmma": expect[kind].get("K10", 0)}
        if dict(k10_paths) != want10:
            fail(f"{label}: {what} took K10's paths {dict(k10_paths)}, "
                 f"expected {want10}")
        log.append({"kind": kind, "rows": rows, "ms": ms, **got,
                    "k3_paths": dict(k3_paths),
                    "k10_paths": dict(k10_paths)})
        return out

    def generate(prompt, log):
        b, s = prompt.shape
        cache = model.init_cache(b, LM_MAX_LEN)
        batch = {"tokens": torch.from_numpy(prompt).to(dev),
                 media_key: media[:b]}
        logits, _, _ = timed("prefill", lambda: model(
            batch, mode="prefill", cache=cache), b * s, log)
        if tuple(logits.shape) != (b, s, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            fail(f"{label}: prefill logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        toks = [logits[:, -1].argmax(-1)]
        del logits
        for i in range(LM_NEW_TOKENS):
            pos = torch.full((b,), s + i, dtype=torch.long, device=dev)
            lg, _ = timed("decode", lambda: model.decode_step(
                toks[-1][:, None], pos, cache), b, log)
            if not bool(torch.isfinite(lg).all()):
                fail(f"{label}: non-finite decode logits")
            toks.append(lg[:, 0].argmax(-1))
        del cache
        out = torch.stack(toks, 1).cpu().tolist()
        if not all(0 <= t < cfg.vocab_size for row in out for t in row):
            fail(f"{label}: tokens outside the vocabulary: {out}")
        return out

    runs = []
    with torch.no_grad():
        for _ in range(2):
            log = []
            t = time.perf_counter()
            tokens = [generate(p, log) for p in prompts]
            runs.append({"tokens": tokens, "log": log,
                         "wall_s": time.perf_counter() - t})
    if runs[1]["tokens"] != runs[0]["tokens"]:
        fail(f"{label}: a second run gave other tokens")
    first = runs[0]["log"]
    rec = {"arch": cfg.name, "params": n_params, "init_s": init_s,
           "max_len": LM_MAX_LEN, "prompts": list(LM_PROMPTS),
           "batch": [LM_MAX_BATCH, CROSS_BATCH_PROMPT],
           "media": list(media.shape[1:]),
           "decode_steps": LM_NEW_TOKENS,
           "tokens": runs[0]["tokens"],
           "launches": {k: sum(r.get(k, 0) for r in first)
                        for k in expect["prefill"]},
           "k3_paths": {k: sum(r["k3_paths"][k] for r in first)
                        for k in k3_paths},
           "k10_paths": {k: sum(r["k10_paths"][k] for r in first)
                         for k in k10_paths},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "runs": [{"wall_s": r["wall_s"], "log": r["log"]} for r in runs]}
    for i, r in enumerate(runs):
        pre = [x for x in r["log"] if x["kind"] == "prefill"]
        one = ", ".join(f"{x['rows']}: {x['ms']:.1f}" for x in pre[:-1])
        dec1 = [x["ms"] for x in r["log"]
                if x["kind"] == "decode" and x["rows"] == 1]
        dec4 = [x["ms"] for x in r["log"]
                if x["kind"] == "decode" and x["rows"] == LM_MAX_BATCH]
        print(f"{label} run {i + 1}: prefill ms by prompt length {{{one}}}, "
              f"{LM_MAX_BATCH} x {CROSS_BATCH_PROMPT}: {pre[-1]['ms']:.1f}; "
              f"decode step median {statistics.median(dec1):.2f} ms at 1 "
              f"slot, {statistics.median(dec4):.2f} at {LM_MAX_BATCH}; "
              f"wall {r['wall_s']:.2f} s, peak memory "
              f"{rec['peak_memory_gb']:.2f} GB [{card}]", flush=True)
    return rec, generate


def cross_profile(torch, np, dev, model, card, media_key, ranges):
    """Phase 11d: ``profile_windows`` over one prefill of
    ``LM_PROFILE_PROMPT`` tokens and three decode steps at ``LM_MAX_BATCH``
    slots (after a prefill of that many ``CROSS_BATCH_PROMPT``-token
    prompts), with ``ranges``."""
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    media = torch.randn((LM_MAX_BATCH, cfg.cross_attn.num_media_tokens,
                         cfg.cross_attn.media_dim), generator=gen,
                        device=dev).bfloat16()
    one = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, LM_PROFILE_PROMPT))).to(dev)
    four = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_MAX_BATCH, CROSS_BATCH_PROMPT))).to(dev)
    cache1 = model.init_cache(1, LM_MAX_LEN)
    cache4 = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
    with torch.no_grad():
        lg, _, _ = model({"tokens": four, media_key: media}, mode="prefill",
                         cache=cache4)
        state = {"tok": lg[:, -1].argmax(-1)[:, None], "pos": four.shape[1]}
        del lg
        model({"tokens": one, media_key: media[:1]}, mode="prefill",
              cache=cache1)  # warm

        def decode_x3():
            for _ in range(3):
                pos = torch.full((LM_MAX_BATCH,), state["pos"],
                                 dtype=torch.long, device=dev)
                lg, _ = model.decode_step(state["tok"], pos, cache4)
                state["tok"] = lg[:, 0].argmax(-1)[:, None]
                state["pos"] += 1

        windows = {"prefill": lambda: model(
            {"tokens": one, media_key: media[:1]}, mode="prefill",
            cache=cache1), "decode_x3": decode_x3}
        return profile_windows(torch, cfg.name, windows, card, ranges)


def cross_phase(torch, F, np, dev, peaks, counters, card):
    """Phase 11 (see the module docstring): the cross families' kernel
    cases, their CPU parity, both models served, their profiles, the
    llama gates' check and the launcher's refusal; returns (cases, parity
    records, serving records)."""
    import dataclasses

    from repro_torch.core.config import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import vision_lm as vlm_mod

    t11 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cases = cross_kernel_cases(torch, F, dev, peaks)
    keys = {VLM_ARCH: "media_embeds", AUDIO_ARCH: "frames"}
    redraws = {VLM_ARCH: vlm_mod.vision_redraw, AUDIO_ARCH: None}
    parity = {}
    for arch, cut, n10 in (
            (VLM_ARCH, {"num_layers": 2}, 2),
            (AUDIO_ARCH, {"num_layers": 1, "num_encoder_layers": 1}, 3)):
        base = get_arch(arch).cross_attn
        cut["cross_attn"] = dataclasses.replace(
            base, num_media_tokens=CROSS_PARITY_MEDIA,
            interval=min(base.interval, 2))
        parity[arch] = lm_parity_phase(
            torch, np, dev, attn_ops.flash_attention, arch,
            redraw=redraws[arch], cut=cut, per_prefill=n10,
            media_key=keys[arch])
        if parity[arch]["paths"] != {"simt": n10, "wgmma": 0}:
            fail(f"{arch} parity: the fp32 prefill took K10's paths "
                 f"{parity[arch]['paths']}, not the CUDA-core kernel alone")
        gc.collect()
        torch.cuda.empty_cache()
    served = {}
    ranges = {
        VLM_ARCH: (("self block", vlm_mod.VisionLM, "_self_layers"),
                   ("cross block", vlm_mod.VisionLM, "_cross_prefill"),
                   ("cross block", vlm_mod.VisionLM, "_cross_decode"),
                   ("cross decode attention", vlm_mod,
                    "cross_attention_cached")),
        AUDIO_ARCH: (("encoder", encdec_mod.EncDecLM, "encode"),
                     ("decoder layer", encdec_mod.EncDecLM, "_dec_layer"),
                     ("cross decode attention", encdec_mod,
                      "cross_attention_cached"))}
    for arch in (AUDIO_ARCH, VLM_ARCH):
        torch.cuda.reset_peak_memory_stats()
        model, init_s = build_model(torch, arch, dev, redraw=redraws[arch])
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        cfg = model.cfg
        if arch == VLM_ARCH:
            # the projector; q, k, v, o, gate, up, down of every layer; K10
            # once a layer (the cross layers non-causal); a decode step's
            # cross layers: q, o, gate, up, down
            n_self, n_cross = model.n_groups * model.n_self, model.n_groups
            expect = {"prefill": {"K3": 1 + 7 * (n_self + n_cross),
                                  "K10": n_self + n_cross, "K11": 0},
                      "decode": {"K3": 7 * n_self + 5 * n_cross, "K10": 0,
                                 "K11": 0},
                      "media_k3": 1 + 2 * n_cross}
        else:
            # the frontend; an encoder block's q, k, v, o, up, down; a
            # decoder layer's self q, k, v, o, cross q, k, v, o, up, down;
            # K10 once an encoder block and twice a decoder layer; a
            # decode step's self q, k, v, o, cross q, o, up, down
            ne, nd = cfg.num_encoder_layers, cfg.num_layers
            expect = {"prefill": {"K3": 1 + 6 * ne + 10 * nd,
                                  "K10": ne + 2 * nd, "K11": 0},
                      "decode": {"K3": 8 * nd, "K10": 0, "K11": 0},
                      "media_k3": 1 + 6 * ne + 2 * nd}
        rec, generate = cross_serving_phase(torch, np, dev, counters, card,
                                            model, init_s, expect,
                                            keys[arch])
        rec["init_peak_memory_gb"] = init_peak
        rec["expect"] = expect
        if arch == VLM_ARCH:
            # the cross path matters: with every gate at 0 the greedy
            # tokens of the same prompt must change
            i = LM_PROMPTS.index(CROSS_BATCH_PROMPT)
            rng = np.random.default_rng(SEED)
            prompts = [rng.integers(0, cfg.vocab_size, (1, n))
                       for n in LM_PROMPTS]
            saved = [(u["gate_attn"].clone(), u["gate_mlp"].clone())
                     for u in model.cross_layers]
            for u in model.cross_layers:
                u["gate_attn"].zero_()
                u["gate_mlp"].zero_()
            with torch.no_grad():
                gated_off = generate(prompts[i], [])
            for u, (ga, gm) in zip(model.cross_layers, saved):
                u["gate_attn"].copy_(ga)
                u["gate_mlp"].copy_(gm)
            rec["gates_zeroed"] = {"prompt": CROSS_BATCH_PROMPT,
                                   "tokens": gated_off,
                                   "served": rec["tokens"][i]}
            if gated_off == rec["tokens"][i]:
                fail(f"{arch}: zeroing the gates left the greedy tokens of "
                     f"the {CROSS_BATCH_PROMPT}-token prompt as they were")
        rec["profile"] = cross_profile(torch, np, dev, model, card,
                                       keys[arch], ranges[arch])
        rec["phase_peak_memory_gb"] = max(
            init_peak, torch.cuda.max_memory_allocated() / 1e9)
        print("cross " + json.dumps({k: v for k, v in rec.items()
                                     if k != "runs"}), flush=True)
        print(f"{arch}: peak memory {rec['phase_peak_memory_gb']:.2f} GB "
              f"(init {init_peak:.2f}, serving {rec['peak_memory_gb']:.2f}) "
              f"[{card}]", flush=True)
        served[arch] = rec
        del model, generate
        gc.collect()
        torch.cuda.empty_cache()
    # 11e: the launcher serves tokens only and refuses both families
    for arch in (VLM_ARCH, AUDIO_ARCH):
        try:
            serve_main(["--arch", arch])
        except SystemExit as e:
            if "text-only" not in str(e):
                fail(f"{arch} launcher: refused with {e}")
        else:
            fail(f"{arch} launcher: served a cross-attention arch")
    wall = time.perf_counter() - t11
    peak = max(r["phase_peak_memory_gb"] for r in served.values())
    for r in served.values():
        r["phase_s"] = wall
    print(f"phase 11 wall time {wall:.1f} s, peak memory {peak:.2f} GB "
          f"[{card}]", flush=True)
    return cases, parity, served


#: phase 12: gemma2-2b served with the int8 KV cache (``kv_quant``), the
#: same weights served with the bf16 cache beside it
KVQ_PROMPTS = (16, 300, 1500)
KVQ_NEW_TOKENS = 8
#: ``decode_attention_quant`` on the card against the CPU on the same int8
#: cache, fp32 q: the same fp32 arithmetic in another order, relative to
#: max(1, max|CPU|)
KVQ_ATTN_TOL = 1e-5


def kvq_phase(torch, np, dev, counters, card):
    """Phase 12 (see the module docstring); returns its record."""
    import dataclasses
    import math

    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn import attention as attn
    from repro_torch.nn.param import DTYPES, init_tree, tree_leaves

    t12 = time.perf_counter()
    base = get_arch(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, kvh, hd, h = LM_MAX_BATCH, base.num_kv_heads, base.head_dim, \
        base.num_heads
    rec = {"arch": LM_ARCH}
    # a. quantize_kv bit for bit, decode_attention_quant within its limit
    x = torch.randn((b, LM_PROFILE_PROMPT, kvh, hd), generator=gen,
                    device=dev)
    x = (x * torch.exp(torch.randn((b, LM_PROFILE_PROMPT, kvh, 1),
                                   generator=gen, device=dev))).bfloat16()
    x[0, :3] = 0  # all-zero rows: the 1e-8 floor, 0 in fp16
    vals, scales = attn.quantize_kv(x)
    cvals, cscales = attn.quantize_kv(x.cpu())
    if not (torch.equal(vals.cpu(), cvals) and torch.equal(
            scales.cpu().view(torch.int16), cscales.view(torch.int16))):
        fail("quantize_kv: the card's int8 values or fp16 scales differ "
             "from the CPU's")
    rec["quantize_bitwise"] = True
    cases = []
    for window, S, pos in ((0, LM_MAX_LEN, (15, 299, 1499, 8191)),
                           (base.sliding_window, base.sliding_window,
                            (15, 4100, 6000, 8191))):
        k = torch.randn((b, S, kvh, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, S, kvh, hd), generator=gen, device=dev).bfloat16()
        q = torch.randn((b, 1, h, hd), generator=gen, device=dev)
        kq, ks = attn.quantize_kv(k)
        vq, vs = attn.quantize_kv(v)
        p_t = torch.tensor(pos, device=dev)
        kw = dict(window=window, attn_softcap=base.attn_softcap)
        quant = lambda: attn.decode_attention_quant(  # noqa: E731
            q, kq, ks, vq, vs, p_t, **kw)
        bf16 = lambda: attn.decode_attention(  # noqa: E731
            q.bfloat16(), k, v, p_t, **kw)
        out = quant()
        ref = attn.decode_attention_quant(
            q.cpu(), kq.cpu(), ks.cpu(), vq.cpu(), vs.cpu(), p_t.cpu(), **kw)
        top = max(1.0, ref.abs().max().item())
        err = _check_close(f"decode_attention_quant window={window}",
                           out.cpu(), ref, KVQ_ATTN_TOL * top)
        cases.append({"window": window, "slots": S, "positions": list(pos),
                      "max_abs_err": err, "tol": KVQ_ATTN_TOL * top,
                      "ms": time_ms(torch, quant),
                      "bf16_cache_ms": time_ms(torch, bf16)})
        print("kvq case " + json.dumps(cases[-1]), flush=True)
    rec["attention_cases"] = cases
    del x, vals, scales, k, v, kq, vq
    # b. the full model served on each cache, the same weights
    quant_cfg = dataclasses.replace(base, kv_quant=True)
    models = {"int8": get_model(quant_cfg), "bf16": get_model(base)}
    t0 = time.perf_counter()
    tree = init_tree(models["int8"].param_spec(),
                     torch.Generator(device=dev).manual_seed(SEED),
                     base.param_dtype)
    for m in models.values():
        m.load_tree(tree)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_step = 7 * base.num_layers
    expect = {"prefill": {"K3": per_step, "K10": base.num_layers},
              "decode": {"K3": per_step, "K10": 0}}
    served = {}
    for name, m in models.items():
        served[name] = lm_serving_phase(
            torch, np, dev, counters, card, m, init_s, expect,
            prompt_lens=KVQ_PROMPTS, new_tokens=KVQ_NEW_TOKENS)
        leaves = tree_leaves(m.cache_spec(LM_MAX_BATCH, LM_MAX_LEN))
        served[name]["cache_gb"] = sum(
            math.prod(p.shape) * DTYPES[p.dtype].itemsize
            for p in leaves) / 1e9
    parted = {}
    for rid, toks in served["int8"]["tokens"].items():
        ref = served["bf16"]["tokens"][rid]
        parted[rid] = next((i for i, (a, c) in enumerate(zip(toks, ref))
                            if a != c), None)
    del models, tree
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in served.items():
        dec = [x["ms"] for x in r["runs"][0]["log"] if x["kind"] == "decode"]
        rec[name] = {"cache_gb": r["cache_gb"],
                     "peak_memory_gb": r["peak_memory_gb"],
                     "decode_step_ms": statistics.median(dec),
                     "prefill_ms": {str(x["tokens"]): x["ms"]
                                    for x in r["runs"][0]["log"]
                                    if x["kind"] == "prefill"},
                     "launches": r["launches"], "tokens": r["tokens"]}
    rec["first_parting_index"] = parted
    rec["phase_s"] = time.perf_counter() - t12
    print("kvq " + json.dumps(rec), flush=True)
    print(f"phase 12 wall time {rec['phase_s']:.1f} s: int8 cache "
          f"{rec['int8']['cache_gb']:.3f} GB against bf16 "
          f"{rec['bf16']['cache_gb']:.3f} GB, decode step "
          f"{rec['int8']['decode_step_ms']:.2f} ms against "
          f"{rec['bf16']['decode_step_ms']:.2f}, peak "
          f"{rec['int8']['peak_memory_gb']:.2f} GB against "
          f"{rec['bf16']['peak_memory_gb']:.2f}, greedy tokens first part "
          f"at {parted} [{card}]", flush=True)
    return rec


#: phase 13: training.  The two models, the batch (b * s = 4096 rows, a
#: multiple of 64, so that every K3 product of the step is TMA-describable
#: and takes the wgmma path), the steps, and the corpus: a Markov chain
#: over ``TRAIN_VOCAB`` symbols, ids that lie inside every vocab
TRAIN_ARCHS = (LM_ARCH, "rwkv6-1.6b")
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 8
TRAIN_VOCAB = 1024
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
#: the peak device memory reckoned before the run (GB): bf16 weights and
#: grads, fp32 moments, about three fp32 logits tensors of 4096 x vocab
TRAIN_RECKONED_GB = {LM_ARCH: 45.0, "rwkv6-1.6b": 25.0}
#: K3's training shapes (K, N, activation, bias): gemma2-2b's five
#: projections, rwkv6-1.6b's three, and the silu and gelu epilogues with a
#: bias; M = TRAIN_BATCH * TRAIN_SEQ
K3_TRAIN_SHAPES = ((2304, 2048, "none", False), (2304, 1024, "none", False),
                   (2048, 2304, "none", False), (2304, 9216, "gelu", False),
                   (9216, 2304, "none", False), (2048, 2048, "none", False),
                   (2048, 7168, "relu", False), (7168, 2048, "none", False),
                   (2304, 9216, "gelu", True), (2048, 2048, "silu", True))
#: K10's: (batch, tokens, heads, kv heads, head_dim, window, cap):
#: gemma2-2b's training batch, and a 4500-token row where its window bites
K10_TRAIN_CASES = ((TRAIN_BATCH, TRAIN_SEQ, 8, 4, 256, 4096, 50.0),
                   (1, 4500, 8, 4, 256, 4096, 50.0))
#: the gradients of K10's Function (its plain backward on the kernel's
#: out, m and l) against autograd through the plain version on the card,
#: element by element: |err| <= rtol * |plain| + atol * max|plain|.  The
#: backward's D = rowsum(do * out) reads the bf16 out, as the JAX
#: package's does, where autograd through the plain version keeps it fp32
#: (2^-8 of each out), and both round once to bf16.  A backward that
#: skipped a visible pair would be off by about all of a gradient there.
K10_GRAD_TOL = (2.0 ** -6, 2.0 ** -7)
#: one fp32 train step of each model cut to one unit on the card against
#: the CPU: every gradient leaf, moment and the loss within this of
#: max(1, max|CPU|) (fp32 sums in another order, as LM_TOL's prefill);
#: a parameter whose gradient is not tiny against its leaf's within
#: 1e-6 |p| + 1e-3 lr, the others within 2 lr (Adam's first step is
#: about lr sign(g): a gradient within rounding of 0 may flip it)
TRAIN_PARITY_TOL = 1e-4
TRAIN_PARITY_SEQ = 64


def k3_grad_case(torch, gen, dev, kk, n, act, bias, peaks):
    """K3's Function at M = TRAIN_BATCH * TRAIN_SEQ: forward and backward
    on the card (dx and dw on K3 over transposed copies, z recomputed by
    K3 for silu and gelu) against autograd through ``matmul_fused_ref``
    on the card, within ``LM_KERNEL_TOL``, the bf16 rounding of z and dz
    that the kernel's backward takes added to the limit for silu and gelu
    (JAX's dense differentiates at its bf16 z too); for relu the plain
    version takes the kernel's mask, and the entries where its own mask
    parts from it are counted (``relu_mask_flips``); every launch on the
    wgmma path; the products timed beside ``torch.matmul`` and the copies
    of the transposes timed alone.  Returns the record."""
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    _, bw_peak, bf16_peak = peaks
    m = TRAIN_BATCH * TRAIN_SEQ
    x = torch.randn((m, kk), generator=gen, device=dev).bfloat16()
    w = (torch.randn((kk, n), generator=gen, device=dev) / kk ** 0.5
         ).bfloat16()
    b = torch.randn((n,), generator=gen, device=dev) if bias else None
    dy = torch.randn((m, n), generator=gen, device=dev).bfloat16()
    label = f"K3 grad M={m} {kk}->{n} {act}" + (" +bias" if bias else "")

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, w, b) if t is not None]
        fn(*leaves, *([None] if b is None else []), act).backward(dy)
        return [t.grad for t in leaves]

    roles, paths = mm_ops.matmul_fused.role_launches, \
        mm_ops.matmul_fused.path_launches
    before_r, before_p = dict(roles), dict(paths)
    got = grads(mm_ops.matmul_fused)
    torch.cuda.synchronize()
    stepped = {k: roles[k] - before_r[k] for k in roles}
    want = {"forward": 1, "z": int(act in ("silu", "gelu")), "dx": 1,
            "dw": 1}
    if stepped != want:
        fail(f"{label}: launches by role {stepped}, expected {want}")
    on = {k: paths[k] - before_p[k] for k in paths}
    if on != {**dict.fromkeys(paths, 0), "wgmma": sum(want.values())}:
        fail(f"{label}: paths {on}, not the wgmma path alone")
    plain, flips = matmul_fused_ref, None
    if act == "relu":
        # relu's kink: where the kernel's fp32 z and the plain version's
        # lie on either side of 0 (their sums part in the last bits) the
        # masks part, and a gradient there moves by dy (x or w) whole.
        # The gradients are held against the plain version on the
        # kernel's mask; the parted mask entries are counted
        mask = mm_ops.matmul_fused(x, w, b, "relu") > 0
        z = x.float() @ w.float() + (0.0 if b is None else b)
        flips = int((mask != (z >= 0)).sum())
        del z

        def plain(xx, ww, bb, _):
            return (matmul_fused_ref(xx, ww, bb, "none").float()
                    * mask).to(xx.dtype)
    ref = grads(plain)
    rtol, atol = LM_KERNEL_TOL["bfloat16"]
    extra = [0.0, 0.0, 0.0]
    if act in ("silu", "gelu"):
        # what dz may differ by, element by element, before the products:
        # the bf16 rounding of z and of dz (at most 2^-9 of each, act''
        # at most 1)
        z = x.float() @ w.float() + (0.0 if b is None else b)
        dz = dy.float() * mm_ops.act_grad(act, z)
        slack = 2.0 ** -8 * (dz.abs() + dy.float().abs() * z.abs())
        extra = [slack @ w.float().abs().t(), x.float().abs().t() @ slack,
                 slack.sum(0)]
        del z, dz, slack
    errs = {}
    for name, a, r, e in zip(("dx", "dw", "db"), got, ref, extra):
        if name == "db":
            rtol, atol = LM_KERNEL_TOL["float32"]
        errs[name] = _check_close(f"{label} {name}", a, r, atol + e, rtol)
    # the backward's pieces timed alone: the copies of the transposes, the
    # two products on K3 (the wgmma path) and in the library, on dy as dz
    dz = dy
    wt, xt = w.t().contiguous(), x.t().contiguous()
    flops = 2.0 * m * kk * n
    rec = {"kernel": "K3-bf16-grad", "rows": m, "k": kk, "n": n, "act": act,
           "bias": bias, "max_abs_err": errs, "tol": {
               "rtol": LM_KERNEL_TOL["bfloat16"][0],
               "atol": LM_KERNEL_TOL["bfloat16"][1],
               "db": LM_KERNEL_TOL["float32"],
               "z_dz_rounding": act in ("silu", "gelu")},
           "relu_mask_flips": flips,
           "k3_path": {
               "dx": mm_ops.k3_path(x.dtype, m, n, kk, dz.data_ptr(),
                                    wt.data_ptr()),
               "dw": mm_ops.k3_path(x.dtype, kk, m, n, xt.data_ptr(),
                                    dz.data_ptr())},
           "copies_ms": time_ms(torch, lambda: (w.t().contiguous(),
                                                x.t().contiguous())),
           "dx_ms": time_ms(torch, lambda: mm_ops._launch(
               dz, wt, None, "none", role="dx")),
           "dw_ms": time_ms(torch, lambda: mm_ops._launch(
               xt, dz, None, "none", role="dw")),
           "library_dx_ms": time_ms(torch, lambda: torch.matmul(dz, w.t())),
           "library_dw_ms": time_ms(torch, lambda: torch.matmul(x.t(), dz)),
           "fwd_bwd_ms": time_ms(torch, lambda: grads(mm_ops.matmul_fused),
                                 reps=10),
           "plain_ms": time_ms(torch, lambda: grads(matmul_fused_ref),
                               reps=5),
           "bound_product_ms": 1e3 * max(
               flops / bf16_peak, 2.0 * (m * n + kk * n + m * kk) / bw_peak),
           "flops": 3 * flops}
    rec["library_ms"] = rec["library_dx_ms"] + rec["library_dw_ms"]
    rec["ms"] = rec["dx_ms"] + rec["dw_ms"]
    rec["bound_ms"] = 2 * rec["bound_product_ms"]
    print("train case " + json.dumps(rec), flush=True)
    return rec


def k10_grad_case(torch, gen, dev, case, peaks):
    """K10 with m and l at a training shape: the launch's out equal bit for
    bit to the launch without them, m and l against the plain version's
    within fp32's ``LM_KERNEL_TOL``; the Function's gradients (the plain
    backward over ``attn_chunk`` pairs) against autograd through the plain
    version on the card (``K10_GRAD_TOL``); timed: the launch with and
    without m and l, forward + backward, and the plain backward alone.
    Returns the record."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    bsz, s, h, kvh, hd, window, cap = case
    q = torch.randn((bsz, s, h, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).bfloat16()
    do = torch.randn((bsz, s, h, hd), generator=gen, device=dev).bfloat16()
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=True, window=window, attn_softcap=cap)
    label = f"K10 grad b={bsz} s={s} window={window} cap={cap} h={h}/{kvh}"
    ml_before = attn_ops.flash_attention.ml_launches
    out_ml, m, l = attn_ops._launch(q, k, v, True, window, cap, scale,
                                    ml=True)
    out = attn_ops._launch(q, k, v, True, window, cap, scale)
    torch.cuda.synchronize()
    if attn_ops.flash_attention.ml_launches != ml_before + 1:
        fail(f"{label}: the m/l launch was not counted")
    if not torch.equal(out, out_ml):
        fail(f"{label}: writing m and l changed the output")
    _, m_ref, l_ref = flash_attention_ref(q, k, v, scale=scale,
                                          return_ml=True, **kw)
    rtol, atol = LM_KERNEL_TOL["float32"]
    m_err = _check_close(f"{label} m", m, m_ref, atol, rtol)
    l_err = _check_close(f"{label} l", l, l_ref, atol, rtol)
    del out_ml, m, l, m_ref, l_ref

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        return [t.grad for t in leaves]

    kernel = lambda *a: attn_ops.flash_attention(*a, chunk=512, **kw)  # noqa
    plain = lambda *a: flash_attention_ref(*a, **kw)  # noqa: E731
    got = grads(kernel)
    ref = grads(plain)
    g_rtol, g_atol = K10_GRAD_TOL
    errs = {name: _check_close(
        f"{label} {name}", a, r, g_atol * r.float().abs().max().item(),
        g_rtol) for name, a, r in zip(("dq", "dk", "dv"), got, ref)}
    del got, ref
    out_ml, m, l = attn_ops._launch(q, k, v, True, window, cap, scale,
                                    ml=True)
    bwd = lambda: attn_ops.flash_attention_bwd(  # noqa: E731
        q, k, v, out_ml, m, l, do, scale=scale, chunk=512, **kw)
    rec = {"kernel": "K10-grad", "batch": bsz, "tokens": s, "heads": h,
           "kv_heads": kvh, "head_dim": hd, "window": window, "cap": cap,
           "m_max_abs_err": m_err, "l_max_abs_err": l_err,
           "max_abs_err": errs, "tol": {"m_l": LM_KERNEL_TOL["float32"],
                                        "grad": K10_GRAD_TOL},
           "ms": time_ms(torch, lambda: attn_ops._launch(
               q, k, v, True, window, cap, scale)),
           "ml_ms": time_ms(torch, lambda: attn_ops._launch(
               q, k, v, True, window, cap, scale, ml=True)),
           "plain_backward_ms": time_ms(torch, bwd, reps=5),
           "fwd_bwd_ms": time_ms(torch, lambda: grads(kernel), reps=5),
           "plain_fwd_bwd_ms": time_ms(torch, lambda: grads(plain), reps=3)}
    print("train case " + json.dumps(rec), flush=True)
    return rec


def k11_grad_case(torch, gen, dev):
    """K11's Function at rwkv6-1.6b's training shape (32 heads of 64,
    chunks of 64) with strong decays: the kernel's forward, the plain
    backward (autodiff of ``wkv6_chunked_ref``), against autograd through
    the plain version on the card within ``LM_KERNEL_TOL``, and whether
    the two agree bit for bit (they run the same backward); timed.
    Returns the record."""
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

    mean, std = K11_DECAYS["strong"]
    shape = (TRAIN_BATCH, TRAIN_SEQ, K11_HEADS, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    logw = -torch.exp(mean + std * torch.randn(shape, generator=gen,
                                               device=dev))
    u = 0.5 * torch.randn((K11_HEADS, 64), generator=gen, device=dev)
    do = torch.randn(shape, generator=gen, device=dev).bfloat16()
    label = f"K11 grad b={TRAIN_BATCH} s={TRAIN_SEQ} strong decays"

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (r, k, v, logw, u)]
        fn(*leaves)[0].backward(do)
        return [t.grad for t in leaves]

    kernel = lambda *a: wkv6_ops.wkv6(*a, chunk=64)  # noqa: E731
    plain = lambda *a: wkv6_chunked_ref(*a, 64)  # noqa: E731
    before = wkv6_ops.wkv6.launches
    got = grads(kernel)
    torch.cuda.synchronize()
    if wkv6_ops.wkv6.launches != before + 1:
        fail(f"{label}: the forward did not launch K11 once")
    ref = grads(plain)
    errs, bitwise = {}, True
    for name, a, b in zip(("dr", "dk", "dv", "dlogw", "du"), got, ref):
        rtol, atol = LM_KERNEL_TOL[str(b.dtype).replace("torch.", "")]
        errs[name] = _check_close(f"{label} {name}", a, b, atol, rtol)
        bitwise = bitwise and torch.equal(a, b)
    rec = {"kernel": "K11-grad", "batch": TRAIN_BATCH, "tokens": TRAIN_SEQ,
           "heads": K11_HEADS, "max_abs_err": errs, "bitwise": bitwise,
           "tol": LM_KERNEL_TOL,
           "ms": time_ms(torch, lambda: kernel(r, k, v, logw, u)),
           "fwd_bwd_ms": time_ms(torch, lambda: grads(kernel), reps=3),
           "plain_fwd_bwd_ms": time_ms(torch, lambda: grads(plain), reps=3)}
    rec["plain_backward_ms"] = rec["fwd_bwd_ms"] - rec["ms"]
    print("train case " + json.dumps(rec), flush=True)
    return rec


def _train_batch(torch, lm, rng, dev, b, s):
    tokens = torch.from_numpy(lm.sample(rng, b, s)).long().to(dev)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()}


def train_parity(torch, np, dev, arch, redraw=None):
    """One fp32 train step of ``arch`` cut to one layer unit (two layers:
    gemma2-2b's local/global pair) at full width, on the card and on the
    CPU (one intra-op thread) from the same weights and batch: the loss,
    the metrics, every gradient leaf, every moment and every updated
    parameter (``TRAIN_PARITY_TOL``).  Returns the record."""
    import dataclasses

    from repro_torch.core.config import TrainConfig, get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree, tree_leaves, tree_map
    from repro_torch.train.data import MarkovLM
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_arch(arch), num_layers=2, dtype="float32",
                              param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trees = {"gpu": init_tree(get_model(cfg).param_spec(), gen, "float32")}
    if redraw is not None:
        redraw(trees["gpu"], gen)
    trees["cpu"] = tree_map(lambda t: t.detach().cpu().clone(), trees["gpu"])
    batch = _train_batch(torch, MarkovLM(TRAIN_VOCAB, seed=SEED),
                         np.random.default_rng(SEED), "cpu", TRAIN_BATCH,
                         TRAIN_PARITY_SEQ)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    out, grads = {}, {}
    for side in ("gpu", "cpu"):
        model = get_model(cfg).load_tree(trees[side])
        step = make_train_step(model, tcfg)
        with one_thread(torch):
            out[side] = step(trees[side], adamw_init(trees[side]),
                             {k: t.to(model.device) for k, t in
                              batch.items()})
        grads[side] = step.grads
        torch.cuda.synchronize()
    (gp, gs, gm), (cp, cs, cm) = out["gpu"], out["cpu"]
    label = f"{arch} train parity"
    worst = {}
    for k in cm:
        ref = cm[k].item()
        err = abs(gm[k].item() - ref)
        if not err <= TRAIN_PARITY_TOL * max(1.0, abs(ref)):
            fail(f"{label}: {k} {gm[k].item()} on the card, {ref} on the "
                 f"CPU")
        worst[k] = err
    for name, a_tree, b_tree in (("grad", grads["gpu"], grads["cpu"]),
                                 ("m", gs["m"], cs["m"]),
                                 ("v", gs["v"], cs["v"])):
        worst[name] = 0.0
        for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
            worst[name] = max(worst[name], _check_close(
                f"{label} {name}", a.cpu(), b,
                TRAIN_PARITY_TOL * max(1.0, b.abs().max().item())))
    lr = cm["lr"].item()
    worst["param"], flips = 0.0, 0
    for a, b, mom in zip(tree_leaves(gp), tree_leaves(cp),
                         tree_leaves(cs["m"])):
        err = (a.cpu() - b).abs()
        tiny = mom.abs() <= 1e-3 * max(mom.abs().max().item(), 1e-30)
        lim = torch.where(tiny, torch.full_like(b, 2.02 * lr + 1e-6),
                          1e-6 * b.abs().clamp_min(1.0) + 1e-3 * lr)
        if not bool((err <= lim).all()):
            fail(f"{label}: an updated parameter off by "
                 f"{(err - lim).max().item()} past its limit")
        worst["param"] = max(worst["param"], err.max().item())
        flips += int((tiny & (err > 1e-3 * lr)).sum())
    rec = {"arch": arch, "layers": cfg.num_layers, "batch": TRAIN_BATCH,
           "tokens": TRAIN_PARITY_SEQ, "cpu_threads": 1,
           "loss": cm["loss"].item(), "max_abs_err": worst,
           "tiny_gradient_flips": flips, "tol": TRAIN_PARITY_TOL}
    print(f"{label} " + json.dumps(rec), flush=True)
    return rec


def train_full(torch, np, dev, counters, card, arch, expect, redraw=None):
    """``TRAIN_STEPS`` AdamW steps of ``arch`` at full width and depth in
    bf16 through ``make_train_step``, on ``MarkovLM(TRAIN_VOCAB)`` batches
    of ``TRAIN_BATCH`` x ``TRAIN_SEQ``.  The first step is taken twice
    from the same state (the determinism check: the same loss, grad norm
    and parameters bit for bit, or the leaves that differ named), with
    the launches counted: ``expect`` gives K3's by role (the forward, the
    remat recompute, the backward's z, dx, dw: all on the wgmma path) and
    K10's and K11's a step, the forward's and the backward's.  The CE must
    be finite and fall from the first step to the last, which is
    profiled.  Returns the record."""
    import math

    from repro_torch.core.config import TrainConfig, get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree, tree_leaves
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import MarkovLM
    from repro_torch.train.optimizer import adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_arch(arch)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(model.param_spec(), gen, cfg.param_dtype)
    if redraw is not None:
        redraw(tree, gen)
    model.load_tree(tree)
    opt = adamw_init(tree)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tree))
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    step_fn = step_mod.make_train_step(model, tcfg)
    lm, rng = MarkovLM(TRAIN_VOCAB, seed=SEED), np.random.default_rng(SEED)
    batches = [_train_batch(torch, lm, rng, dev, TRAIN_BATCH, TRAIN_SEQ)
               for _ in range(TRAIN_STEPS)]
    label = f"{arch} train"
    k3 = counters["K3"]

    def zero():
        for fn in counters.values():
            fn.launches = 0
        for table in (k3.path_launches, k3.role_launches):
            for key in table:
                table[key] = 0
        attn_ops.flash_attention.ml_launches = 0

    def counts():
        return {"K3": dict(k3.role_launches), "K3_paths": dict(
            k3.path_launches), "K10": counters["K10"].launches,
            "K10_ml": attn_ops.flash_attention.ml_launches,
            "K11": counters["K11"].launches}

    def timed_step(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(tree, opt, batch)
        torch.cuda.synchronize()
        return out[2], (time.perf_counter() - t) * 1e3

    # the first step, twice from the same state, counted
    start = [t.clone() for t in tree_leaves(tree)]
    at_forward_end = {}
    hook = model.register_forward_hook(
        lambda *_: at_forward_end.update(counts()))
    zero()
    first, first_ms = timed_step(batches[0])
    hook.remove()
    total = counts()
    after_first = [t.clone() for t in tree_leaves(tree)]
    for t, s in zip(tree_leaves(tree), start):
        t.copy_(s)
    for t in tree_leaves(opt):
        t.zero_()
    del start
    again, _ = timed_step(batches[0])
    differ = [i for i, (a, b) in enumerate(zip(tree_leaves(tree),
                                               after_first))
              if not torch.equal(a, b)]
    same = {k: bool(torch.equal(first[k], again[k]))
            for k in ("loss", "ce", "grad_norm")}
    del after_first
    keys = []

    def walk(t, path):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], path + (key,))
        else:
            keys.append("/".join(path))

    walk(tree, ())
    determinism = {"deterministic": not differ and all(same.values()),
                   "metrics_equal": same,
                   "differing_leaves": [keys[i] for i in differ]}
    # the launches a step: the forward's by the hook, the backward's after
    fwd = at_forward_end
    got = {"K3_forward": fwd["K3"]["forward"],
           "K3_recompute": total["K3"]["forward"] - fwd["K3"]["forward"],
           "K3_z": total["K3"]["z"], "K3_dx": total["K3"]["dx"],
           "K3_dw": total["K3"]["dw"], "K10_forward": fwd["K10"],
           "K10_backward": total["K10"] - fwd["K10"],
           "K10_ml": total["K10_ml"], "K11_forward": fwd["K11"],
           "K11_backward": total["K11"] - fwd["K11"]}
    if got != expect:
        fail(f"{label}: launches a step {got}, expected {expect}")
    n3 = sum(total["K3"].values())
    if total["K3_paths"] != {**dict.fromkeys(k3.path_launches, 0),
                             "wgmma": n3}:
        fail(f"{label}: K3's paths {total['K3_paths']}, not the wgmma "
             f"path alone for its {n3} launches")
    steps = [{"step": 1, "ce": again["ce"].item(),
              "grad_norm": again["grad_norm"].item(), "ms": first_ms}]
    for i in range(1, TRAIN_STEPS - 1):
        m, ms = timed_step(batches[i])
        steps.append({"step": i + 1, "ce": m["ce"].item(),
                      "grad_norm": m["grad_norm"].item(), "ms": ms})
        print(f"{label} step {i + 1}: ce {steps[-1]['ce']:.4f}, grad norm "
              f"{steps[-1]['grad_norm']:.4f}, {ms:.1f} ms", flush=True)
    med = statistics.median(s["ms"] for s in steps[1:])
    # the last step under the profiler (its wall time carries the
    # profiler's cost, so the median above leaves it out)
    ranges = (("k10 plain backward", attn_ops, "flash_attention_bwd"),
              ("k11 plain backward", wkv6_ops, "wkv6_bwd"),
              ("adamw", step_mod, "adamw_update"))
    last = {}
    profile = profile_windows(
        torch, label, {"step": lambda: last.update(
            m=step_fn(tree, opt, batches[TRAIN_STEPS - 1])[2])},
        card, ranges)
    steps.append({"step": TRAIN_STEPS, "ce": last["m"]["ce"].item(),
                  "grad_norm": last["m"]["grad_norm"].item(),
                  "ms": profile["step"]["wall_ms"], "profiled": True})
    ces = [s["ce"] for s in steps]
    if not all(math.isfinite(c) for c in ces) or not ces[-1] < ces[0]:
        fail(f"{label}: CE {ces} is not finite and falling")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"arch": arch, "params": n_params, "init_s": init_s,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "corpus_vocab": TRAIN_VOCAB,
           "corpus_entropy": lm.entropy(), "steps": steps,
           "step_ms_median": med,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med * 1e3,
           "launches": got, "k3_paths": total["K3_paths"],
           "determinism": determinism, "peak_memory_gb": peak,
           "reckoned_gb": TRAIN_RECKONED_GB.get(arch), "profile": profile}
    print(f"{label}: " + json.dumps({k: v for k, v in rec.items()
                                     if k != "profile"}), flush=True)
    print(f"{label}: {n_params / 1e9:.3f} G parameters, CE "
          f"{ces[0]:.4f} -> {ces[-1]:.4f}, step {med:.1f} ms median "
          f"({rec['tokens_per_s']:.0f} tokens/s), peak memory {peak:.2f} GB "
          f"(reckoned {rec['reckoned_gb']}), deterministic "
          f"{determinism['deterministic']} [{card}]", flush=True)
    del model, tree, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_phase(torch, np, dev, peaks, counters, card):
    """Phase 13 (see the module docstring); returns (cases, parity
    records, full-width records)."""
    from repro_torch.core.config import get_arch
    from repro_torch.nn.rwkv import rwkv_redraw

    t13 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [k3_grad_case(torch, gen, dev, kk, n, act, bias, peaks)
             for kk, n, act, bias in K3_TRAIN_SHAPES]
    cases += [k10_grad_case(torch, gen, dev, c, peaks)
              for c in K10_TRAIN_CASES]
    cases.append(k11_grad_case(torch, gen, dev))
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    redraws = {LM_ARCH: None, "rwkv6-1.6b": rwkv_redraw}
    parity = {a: train_parity(torch, np, dev, a, redraws[a])
              for a in TRAIN_ARCHS}
    t_c = time.perf_counter()
    full = {}
    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch)
        n = cfg.num_layers
        if cfg.family == "ssm":  # 8 projections a layer, K11 once
            k3, z, k10, k11 = 8 * n, 0, 0, n
        else:  # 7 projections a layer, the gate's gelu, K10 once
            k3, z, k10, k11 = 7 * n, n, n, 0
        expect = {"K3_forward": k3, "K3_recompute": k3, "K3_z": z,
                  "K3_dx": k3, "K3_dw": k3, "K10_forward": k10,
                  "K10_backward": k10, "K10_ml": 2 * k10,
                  "K11_forward": k11, "K11_backward": k11}
        full[arch] = train_full(torch, np, dev, counters, card, arch, expect,
                                redraws[arch])
    t_end = time.perf_counter()
    print(f"phase 13 wall time {t_end - t13:.1f} s (cases "
          f"{t_b - t13:.1f}, CPU parity {t_c - t_b:.1f}, full width "
          f"{t_end - t_c:.1f})", flush=True)
    return cases, parity, full


def main() -> int:
    global SEED
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every case's numbers here")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register/shared-memory report")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of every weight and input (default 0)")
    args = ap.parse_args()
    SEED = args.seed

    # before torch loads: MKL reads its reproducibility mode once (F3)
    os.environ["MKL_CBWR"] = MKL_CBWR
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository root")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core.deploy import params_from_numpy
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan, infer_param_shapes
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.pool2d import ops as pool_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.nn.rwkv import rwkv_redraw

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} sms "
          f"{torch.cuda.get_device_properties(0).multi_processor_count}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = card_peaks(kind)
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    if args.ptxas:
        print(_build.build_log, flush=True)

    counters = {"K1": conv_ops.conv2d_pool_fused, "K2": conv_ops.conv2d_chain,
                "K3": mm_ops.matmul_fused,
                "K4": conv_ops.conv2d_pool_lrn_halo,
                "K5": conv_ops.conv2d_pool_carry,
                "K6": conv_ops.conv2d_chain_ocb,
                "K7": conv_ops.conv2d_basic_simd,
                "K8": conv_ops.conv2d_basic_parallel, "K9": pool_ops.pool2d}
    sources = {
        "K1": ("conv_pool_lrn", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:649"),
        "K2": ("conv_chain", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:1103"),
        "K3": ("matmul_fused", "src/repro_torch/csrc/matmul_fused.cu",
               "src/repro/kernels/matmul_fused/kernel.py:37"),
        "K4": ("conv_pool_lrn_halo", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:681"),
        "K5": ("conv_pool_carry", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:708"),
        "K6": ("conv_chain_ocb", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:1260"),
        "K7": ("conv_basic_simd", "src/repro_torch/csrc/conv_basic_simd.cu",
               "src/repro/kernels/conv2d/kernels.py:555"),
        "K8": ("conv_basic_parallel",
               "src/repro_torch/csrc/conv_basic_parallel.cu",
               "src/repro/kernels/conv2d/kernels.py:376"),
        "K9": ("pool2d", "src/repro_torch/csrc/pool2d.cu",
               "src/repro/kernels/pool2d/kernels.py:84"),
    }
    nets = {name: NETWORKS[name]() for name in ("alexnet", "lenet5",
                                                "cifar10")}
    rng = np.random.default_rng(SEED)
    np_params = {name: he_params(infer_param_shapes(net), rng)
                 for name, net in nets.items()}

    # -- 3. kernels against their plain versions, timed ---------------------
    cases = []
    for name, net in nets.items():
        params = params_from_numpy(np_params[name], dev)
        for kid, step, n in kernel_cases(net, compile_plan, Method):
            r = run_case(torch, F, kid, step, n, params, dev, peaks)
            r.update(net=name, step="+".join(step.names),
                     main=name == "alexnet")
            cases.append(r)
            print("case " + json.dumps(r), flush=True)
    for name, kid, step, n, obf, main in cell_cases(nets, compile_plan,
                                                     Method):
        params = params_from_numpy(np_params[name], dev)
        r = run_case(torch, F, kid, step, n, params, dev, peaks, obf)
        r.update(net=name, step="+".join(step.names), main=main,
                 oc_block_final=obf)
        cases.append(r)
        print("case " + json.dumps(r), flush=True)

    # -- 4. the engine on the card, every rung -------------------------------
    engine_rows = []
    for name, net in nets.items():
        params = params_from_numpy(np_params[name], dev)
        cpu_params = params_from_numpy(np_params[name], "cpu")
        x_np = rng.standard_normal((ENGINE_BATCH, *net.input_shape)
                                   ).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        for method, fuse in RUNGS:
            label = f"{name} {method}/{'fused' if fuse else 'unfused'}"
            eng = CNNEngine(net, method=Method(method), fuse_pool=fuse)
            for fn in counters.values():
                fn.launches = 0
            y = eng.forward(params, x)
            torch.cuda.synchronize()
            launches = tuple(counters[k].launches for k in KERNELS)
            want = EXPECTED_LAUNCHES[name][(method, fuse)]
            if any(counters[k].launches for k in CELLS):
                fail(f"{label}: a default plan launched "
                     f"{ {k: counters[k].launches for k in CELLS} }")
            if launches != want:
                fail(f"{label}: launches {dict(zip(KERNELS, launches))}, "
                     f"expected {dict(zip(KERNELS, want))}")
            if tuple(y.shape) != (ENGINE_BATCH, net.num_classes):
                fail(f"{label}: output shape {tuple(y.shape)}")
            if not torch.isfinite(y).all():
                fail(f"{label}: non-finite output")
            y_cpu = CNNEngine(net, method=Method(method), fuse_pool=fuse,
                              device="cpu").forward(cpu_params, x_np)
            err = (y.cpu() - y_cpu).abs().max().item()
            if not err <= 1e-4:
                fail(f"{label}: engine max abs err vs CPU {err} > 1e-4")
            if not torch.equal(y.argmax(-1).cpu(), y_cpu.argmax(-1)):
                fail(f"{label}: argmax differs from the CPU engine")
            copies = {k: v[2] for k, v in conv_ops._CHAIN_WEIGHTS.items()}
            y2 = eng.forward(params, x)
            y3 = eng.forward(params, x)
            if not (torch.equal(y, y2) and torch.equal(y2, y3)):
                fail(f"{label}: repeated forwards differ")
            # the stage-major kernels' weights were converted once, by the
            # first forward, and the later ones reuse the copies
            again = {k: v[2] for k, v in conv_ops._CHAIN_WEIGHTS.items()}
            if (again.keys() != copies.keys()
                    or any(again[k] is not c for k, c in copies.items())):
                fail(f"{label}: a repeated forward converted its weights "
                     f"again")
            ms = time_ms(torch, lambda: eng.forward(params, x))
            t0 = time.perf_counter()
            for _ in range(10):
                eng.forward(params, x)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 100.0
            engine_rows.append({
                "net": name, "method": method, "fuse": fuse,
                "batch": ENGINE_BATCH, "forward_ms": ms,
                "host_forward_ms": host_ms,
                "launches": dict(zip(KERNELS, launches)),
                "max_abs_err_vs_cpu": err})
            print(f"engine {label} batch {ENGINE_BATCH}: forward {ms:.3f} ms "
                  f"(event median), {host_ms:.3f} ms (host clock), launches "
                  f"{dict(zip(KERNELS, launches))}, max abs err vs CPU "
                  f"{err:.3g}", flush=True)

    # -- 5. tuned deploy: save_model(tuned) -> load_engine -> forward -----
    tuned = tuned_phase(torch, np, nets["alexnet"], np_params["alexnet"],
                        rng, dev, counters, card_line)
    print("tuned " + json.dumps(tuned), flush=True)

    # -- 5b. the cost model on the card: fit check, autotune, gate ------------
    cost = cost_phase(torch, np, nets, np_params, dev, counters, card_line)
    print("cost " + json.dumps({k: v for k, v in cost.items()
                                if k not in ("rows_us",)}), flush=True)

    # -- 6. serving: CNNServer walks the degradation ladder -----------------
    serving = serving_phase(torch, np, nets["alexnet"], np_params["alexnet"],
                            rng, dev, counters)
    print("serving " + json.dumps(serving), flush=True)

    # -- 7. the language model: gemma2-2b ------------------------------------
    counters.update(K10=attn_ops.flash_attention, K11=wkv6_ops.wkv6)
    lm_cases = lm_kernel_cases(torch, F, dev, peaks)
    lm_parity = lm_parity_phase(torch, np, dev, attn_ops.flash_attention)
    if lm_parity["paths"] != {"simt": lm_parity["layers"], "wgmma": 0}:
        fail(f"{LM_ARCH} parity: the fp32 prefill took K10's paths "
             f"{lm_parity['paths']}, not the CUDA-core kernel alone")
    model, init_s = build_model(torch, LM_ARCH, dev)
    per_step = 7 * model.cfg.num_layers
    lm = lm_serving_phase(
        torch, np, dev, counters, card_line, model, init_s,
        {"prefill": {"K3": per_step, "K10": model.cfg.num_layers},
         "decode": {"K3": per_step, "K10": 0}})
    if lm["k10_paths"] != {"simt": 0, "wgmma": lm["launches"]["K10"]}:
        fail(f"{LM_ARCH} serving: K10's prefill launches took the paths "
             f"{lm['k10_paths']}, not the wgmma path alone")
    lm["profile"] = lm_profile(torch, model, card_line)
    print("lm " + json.dumps({k: v for k, v in lm.items() if k != "runs"}),
          flush=True)
    del model
    torch.cuda.empty_cache()

    # -- 8. rwkv6-1.6b: K11, the served model, the launcher ------------------
    t8 = time.perf_counter()
    rwkv_cases = rwkv_kernel_cases(torch, F, dev, peaks)
    rwkv_parity = lm_parity_phase(torch, np, dev, wkv6_ops.wkv6, RWKV_ARCH,
                                  RWKV_PARITY_PROMPT, redraw=rwkv_redraw)
    model, init_s = build_model(torch, RWKV_ARCH, dev, redraw=rwkv_redraw)
    n_layers = model.cfg.num_layers
    rwkv = lm_serving_phase(
        torch, np, dev, counters, card_line, model, init_s,
        {"prefill": {"K3": 8 * n_layers, "K11": n_layers, "K10": 0},
         "decode": {"K3": 8 * n_layers, "K11": 0, "K10": 0}})
    rwkv["profile"] = lm_profile(torch, model, card_line)
    del model
    torch.cuda.empty_cache()
    rwkv["launcher"] = launcher_phase(torch, counters, RWKV_ARCH, "K11")
    rwkv["phase_s"] = time.perf_counter() - t8
    print("rwkv " + json.dumps({k: v for k, v in rwkv.items()
                                if k != "runs"}), flush=True)
    print(f"phase 8 wall time {rwkv['phase_s']:.1f} s", flush=True)

    # -- 9. qwen3-moe-30b-a3b: K3/K10 at its shapes, the served MoE model ----
    from repro_torch.models import common as lm_common
    from repro_torch.nn import moe as moe_mod

    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"phase 9 start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated", flush=True)
    moe_cases = moe_kernel_cases(torch, F, dev, peaks)
    routing = []
    with record_routing(torch, routing):
        moe_parity = lm_parity_phase(torch, np, dev, attn_ops.flash_attention,
                                     MOE_ARCH)
    moe_parity["routing"] = check_routing(routing)
    if moe_parity["paths"] != {"simt": moe_parity["layers"], "wgmma": 0}:
        fail(f"{MOE_ARCH} parity: the fp32 prefill took K10's paths "
             f"{moe_parity['paths']}, not the CUDA-core kernel alone")
    gc.collect()
    torch.cuda.empty_cache()
    model, init_s = build_model(torch, MOE_ARCH, dev)
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_layers = model.cfg.num_layers
    moe = lm_serving_phase(
        torch, np, dev, counters, card_line, model, init_s,
        {"prefill": {"K3": 4 * n_layers, "K10": n_layers, "K11": 0},
         "decode": {"K3": 4 * n_layers, "K10": 0, "K11": 0}})
    if moe["k10_paths"] != {"simt": 0, "wgmma": moe["launches"]["K10"]}:
        fail(f"{MOE_ARCH} serving: K10's prefill launches took the paths "
             f"{moe['k10_paths']}, not the wgmma path alone")
    moe["init_peak_memory_gb"] = init_peak
    moe["budget_gb"] = memory_budget(model)
    moe["profile"] = lm_profile(
        torch, model, card_line,
        (("moe block", lm_common, "moe_apply"),
         ("moe routing", moe_mod, "route"),
         ("moe experts", moe_mod, "experts")))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe["launcher"] = launcher_phase(torch, counters, MOE_ARCH, "K10")
    moe["phase_s"] = time.perf_counter() - t9
    # the peak since the serving phase's reset, or the init's before it
    moe["phase_peak_memory_gb"] = max(
        init_peak, torch.cuda.max_memory_allocated() / 1e9)
    print("moe " + json.dumps({k: v for k, v in moe.items() if k != "runs"}),
          flush=True)
    print(f"phase 9 wall time {moe['phase_s']:.1f} s, peak memory "
          f"{moe['phase_peak_memory_gb']:.2f} GB (init "
          f"{init_peak:.2f}, serving {moe['peak_memory_gb']:.2f}; budget "
          f"{ {k: round(v, 2) for k, v in moe['budget_gb'].items()} }) "
          f"[{card_line}]", flush=True)
    if not moe["phase_peak_memory_gb"] < 80.0:
        fail(f"{MOE_ARCH}: peak memory {moe['phase_peak_memory_gb']:.2f} GB")

    # -- 10. zamba2-1.2b: the Mamba2 blocks and the shared block ------------
    gc.collect()
    torch.cuda.empty_cache()
    zamba_cases, zamba_parity, zamba = zamba_phase(
        torch, F, np, dev, peaks, counters, card_line)

    # -- 11. the cross-attention families: llama-3.2-vision, seamless -------
    gc.collect()
    torch.cuda.empty_cache()
    cross_cases, cross_parity, cross = cross_phase(
        torch, F, np, dev, peaks, counters, card_line)

    # -- 12. gemma2-2b on the int8 KV cache -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    kvq = kvq_phase(torch, np, dev, counters, card_line)

    # -- 13. training: gemma2-2b and rwkv6-1.6b ---------------------------------
    train_cases, train_parity_recs, train = train_phase(
        torch, np, dev, peaks, counters, card_line)

    # -- 15. the kernels line -----------------------------------------------
    kernels = []
    for kid, (name, src, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == kid]
        main = [c for c in mine if c["main"] and c["batch"] == ENGINE_BATCH]
        fl = sum(c["flops"] for c in main)
        by = sum(c["bytes"] for c in main)
        if kid in CELLS:
            launches = sum(r["launches"][kid] for r in tuned["forwards"])
        else:
            launches = sum(r["launches"][kid] for r in engine_rows
                           if r["net"] == "alexnet")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sum(c["ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": 1e3 * max(fl / peaks[0], by / peaks[1]),
            "bound_by": "operations" if fl / peaks[0] > by / peaks[1]
            else "bytes",
            "library_ms": sum(c["library_ms"] for c in main),
        })
    def lm_entry(name, src, replaces, main, launches, err, **extra):
        fl = sum(c["flops"] for c in main)
        by = sum(c["bytes"] for c in main)
        peak = main[0]["peak"]
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": sum(c["ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": 1e3 * max(fl / peak, by / peaks[1]),
            "bound_by": "operations" if fl / peak > by / peaks[1]
            else "bytes",
            "library_ms": sum(c["library_ms"] for c in main), **extra}

    # K10: the wgmma path (every bf16 prefill of 7c and 11c) and the
    # CUDA-core kernel (the fp32 prefills of 7b and 11b; its time the fp32
    # 4500-token case)
    k10 = [c for c in lm_cases + cross_cases if c["kernel"] == "K10"]
    k10_src = "src/repro_torch/csrc/flash_attention.cu"
    k10_pallas = "src/repro/kernels/attention/kernel.py:116"
    k10_wgmma = {p: lm["k10_paths"][p] + sum(r["k10_paths"][p]
                                             for r in cross.values())
                 for p in lm["k10_paths"]}
    k10_simt = {p: lm_parity["paths"][p] + sum(r["paths"][p]
                                               for r in cross_parity.values())
                for p in lm_parity["paths"]}
    # the training steps of phase 13 (counted apart, each row's launches
    # keeping their meaning): K3's backward launches by role, K10's
    # launches that also wrote m and l
    trained = list(train.values())
    k3_backward = {role: sum(t["launches"][f"K3_{role}"] for t in trained)
                   for role in ("z", "dx", "dw")}
    kernels.append(lm_entry(
        "flash_attention", k10_src, k10_pallas,
        [c for c in k10 if c["main"]], k10_wgmma["wgmma"],
        max(c["max_abs_err"] for c in k10 if c["path"] == "wgmma"),
        path="wgmma", paths=k10_wgmma,
        train_ml_launches=sum(t["launches"]["K10_ml"] for t in trained)))
    kernels.append(lm_entry(
        "flash_attention_simt", k10_src, k10_pallas,
        [c for c in k10 if c["dtype"] == "float32"
         and c["tokens"] == max(LM_PROMPTS)], k10_simt["simt"],
        max([c["max_abs_err"] for c in k10 if c["path"] == "simt"]
            + [c["simt_max_abs_err"] for c in k10 if c["path"] == "wgmma"]),
        path="simt", paths=k10_simt))
    # K3 bf16: its times at gemma2-2b's shapes (7a), its launches those of
    # 7c's first run and 11c's, its error the largest of every case
    k3 = [c for c in lm_cases if c["kernel"] == "K3-bf16"]
    k3_all = [c for c in k3 + rwkv_cases + cross_cases
              if c["kernel"] == "K3-bf16"]
    kernels.append(lm_entry(
        "matmul_fused_bf16", "src/repro_torch/csrc/matmul_fused.cu",
        "src/repro/kernels/matmul_fused/kernel.py:37",
        [c for c in k3 if c["main"]],
        lm["launches"]["K3"] + sum(r["launches"]["K3"]
                                   for r in cross.values()),
        max(c["max_abs_err"] for c in k3_all),
        train_backward_launches=k3_backward))
    kernels.append(lm_entry(
        "matmul_fused_bf16_wgmma", "src/repro_torch/csrc/matmul_fused.cu",
        "src/repro/kernels/matmul_fused/kernel.py:37",
        [c for c in k3 if c["path"] == "wgmma"
         and c["rows"] == K3_WGMMA_GAIN[0]],
        lm["k3_paths"]["wgmma"] + sum(r["k3_paths"]["wgmma"]
                                      for r in cross.values()),
        max(c["max_abs_err"] for c in k3_all if c["path"] == "wgmma"),
        train_backward_launches=k3_backward))
    k11 = next(c for c in rwkv_cases if c["kernel"] == "K11" and c["main"])
    kernels.append({
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:30",
        "launches": rwkv["launches"]["K11"],
        "max_abs_err": max(c["max_abs_err"] for c in rwkv_cases
                           if c["kernel"] == "K11"),
        "ms": k11["ms"], "plain_ms": k11["plain_ms"],
        "bound_ms": k11["bound_ms"], "bound_by": k11["bound_by"],
        "library_ms": None,  # no single PyTorch call computes WKV6
        "train_launches": sum(t["launches"]["K11_forward"]
                              + t["launches"]["K11_backward"]
                              for t in trained),
    })
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} never launched on the main path")

    # -- 14. stream capture of the cooperative K2 and K1 launches ------------
    capture = capture_phase(torch, nets["alexnet"],
                            params_from_numpy(np_params["alexnet"], dev), dev)
    print("capture " + json.dumps(capture), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card_line, "kind": kind, "torch": torch.__version__,
             "cuda": torch.version.cuda, "build_log": _build.build_log,
             "cases": cases, "engine": engine_rows, "tuned": tuned,
             "cost": cost,
             "serving": serving, "lm_cases": lm_cases,
             "lm_parity": lm_parity, "lm": lm, "rwkv_cases": rwkv_cases,
             "rwkv_parity": rwkv_parity, "rwkv": rwkv,
             "moe_cases": moe_cases, "moe_parity": moe_parity, "moe": moe,
             "zamba_cases": zamba_cases, "zamba_parity": zamba_parity,
             "zamba": zamba, "cross_cases": cross_cases,
             "cross_parity": cross_parity, "cross": cross, "kvq": kvq,
             "train_cases": train_cases, "train_parity": train_parity_recs,
             "train": train, "capture": capture, "kernels": kernels},
            indent=1))
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
