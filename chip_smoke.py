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
5c. static analysis on the card: every plan phases 4 and 5 launched (the
   rungs of the three nets and the tuned deployment) verified by
   ``repro_torch.analysis.verifier.verify_plan`` at batch 1 and 16 on the
   card's SMs, which must find nothing; each plan run again at batch 1
   and 16 with the wrappers' launch-geometry functions recorded, and the
   geometry each launch computed must be the one the verifier read
   (``step_launch_geometry``: the same call and the same memo entry);
   the stage-major kernel's resident blocks an SM (the occupancy query)
   at least ``CH_MIN_BLOCKS``, which the verifier's V304 assumes; the
   largest dynamic shared memory the verifier admitted, per kernel,
   within the card's opt-in limit.  It prints one ``static_analysis``
   line and its wall time;
5d. the guard pass on the card (``repro_torch.analysis.guard``, through
   ``repro_torch.tools.sanitize.guard_pass``): every case of
   ``sanitize.cases`` — the CNN forwards on six rungs at batch 1 and 3,
   AlexNet at 16, the tuned deployment with ``oc_block_final`` 8 and 64,
   K3 in bf16 from 1 to 1500 rows at gemma2's gate and zamba2's in_proj,
   with a bias, relu, silu and its backward, in fp32 on the CUDA-core
   tiles and the stream, K10 from 16 to 4096 tokens (head_dim 64, 128,
   256; windowed, soft-capped, grouped, non-causal, with m and l, fp32),
   K11 from 16 to 1500 tokens in bf16 and fp32 — run four times in guard
   mode (each operand inside guard bands, fresh outputs prefilled) and
   once unguarded, in this process; every one of the 14 units of
   ``sanitize.GLOBALS`` must run and no rule may find anything: K101 (a
   band written or read), K102 (an output element never written, or
   read before it was written), K109 (an input written), K110 (a launch
   not repeatable bit for bit) and K111 (a pointer the pass did not
   stage).  It prints one row per unit and one column per rule, headed
   by the card's name and power limit, and its wall time; the wrappers'
   launch counters are left as they were;
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
      tile) and must be at least ``K3_WGMMA_GAIN`` times slower at 4500
      in device time (each path's graph replay).
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
13. training (``repro_torch.train``), every family the JAX trainer
   takes (``TRAIN_ARCHS``): a. kernel gradient cases: K3's Function
   (``K3_TRAIN_SHAPES``: gemma2-2b's and rwkv6-1.6b's projections, each
   act, with and without a bias; zamba2's in_proj at N = 8384, seamless's
   w_up with gelu and its bias, starcoder2's q, k/v, up and down with
   biases, llama's k/v on the media's 12800 rows) against autograd
   through ``matmul_fused_ref`` on the card within ``LM_KERNEL_TOL``
   (plus the bf16 rounding of z and dz for silu and gelu), every launch
   of the forward, z, dx and dw on the wgmma path, the products timed
   beside ``torch.matmul`` and the transposes' copies alone; K10 with m
   and l (``K10_TRAIN_CASES``: gemma2's batch and a 4500-token row where
   its window bites, zamba2's 32 heads over 32, seamless's non-causal
   encoder at 4096 x 4096 and cross-attention at 2048 x 4096 (hd 64),
   starcoder2's 48 over 4 with its window, llama's non-causal 2048 x
   6400; out bit for bit the launch without them, m and l within fp32's
   ``LM_KERNEL_TOL``) and its Function's plain backward against autograd
   through its plain version (``K10_GRAD_TOL``), the library's flash
   attention with its logsumexp timed beside it; K11's Function at
   rwkv6's shape with strong decays against autograd through
   ``wkv6_chunked_ref``; b. CPU parity: one fp32 train step of each
   model of ``TRAIN_PARITY_ARCHS`` cut to one unit
   (``TRAIN_PARITY_CUTS``: gemma2's local/global pair; the others' steps
   tests/test_torch_train.py holds against JAX's) at full width, the CPU's forward and backward
   on one intra-op thread and its AdamW on the machine's: loss, metrics,
   every gradient leaf, moment and updated parameter
   (``TRAIN_PARITY_TOL``); c. for each model, freed before the next,
   ``TRAIN_STEPS`` AdamW steps in bf16 through ``make_train_step`` on
   ``MarkovLM(TRAIN_VOCAB)`` batches (the cross families with seeded
   media or frames, qwen3-moe at ``TRAIN_MICROBATCHES``), at full width
   and the depth ``train_cut`` chooses from ``train_memory_budget``
   (zamba2, seamless, gemma2, rwkv6 whole; qwen3-moe, starcoder2 and
   llama cut, printed as ``reduced``): the first step taken twice from
   the same state (loss, CE and grad norm bit for bit, every parameter's
   and moment's bits by ``bits_fingerprint``), its launches by role
   equal to ``train_expect``'s (K3 in the forward, again in the remat
   recompute, dx, dw and z for each silu or gelu projection, on the wgmma
   path alone; K10 and K11 in each of the forward and the recompute,
   every K10 launch writing m and l), CE finite and falling, step ms
   (the median of steps 2 to ``TRAIN_STEPS``), tokens/s, the peak memory
   within the reckoning printed beside it, the profile of one more step
   (device ms by kernel, busy share, the plain backwards', the SSD
   scan's, the experts' and AdamW's ranges), each model's wall time; d.
   ``repro_torch.launch.train`` on the card for reduced qwen3-moe, 3
   steps at ``microbatches=2``: CE finite and falling, K3 and K10
   launched;
14. stream capture: K2 on AlexNet's chain and K1 on its conv2+pool2+norm2
   group at batch 16, each captured into a ``torch.cuda.CUDAGraph`` and
   replayed (``capture`` line: per kernel, whether the cooperative launch
   was accepted and the replay gave the bits of the launch; a refusal is
   reported, not failed);
15. the last four registered language models at full width, one after
   another, each freed before the next (``dense_phase``):
   starcoder2-15b (LayerNorm, q/k/v biases, a plain gelu MLP with
   biases, a 4096-row window), internlm2-20b, qwen1.5-32b (40 heads
   over 40, q/k/v biases) and grok-1-314b (8 gelu experts of d_ff 32768,
   top 2, softcaps 30): a. K3 bf16 at each arch's distinct projections
   (``K3_DENSE_SHAPES``, a shape an earlier arch ran not again) over
   ``K3_LM_ROWS``, as 7a — the weight stream's ``split_k`` on every
   stream case's line, one K slice at starcoder2's up and qwen1.5's
   gate/up — and K10 at each arch's attention (``K10_DENSE_CASES``:
   starcoder2's window at head_dim 128 at every prompt length, the
   others at 1500 and 4500 tokens, grok's with its softcap); b. CPU
   parity as 7b on two fp32 layers (grok on one and 3 greedy tokens,
   ``DENSE_PARITY_CUTS``;
   its routing recorded and checked as 9b), the fp32 prefill on K10's CUDA-core kernel alone; c. the
   model served as 7c, twice, weights drawn on the card, cut only as
   ``DENSE_CUTS`` says (qwen1.5 to 32 of 64 layers, grok to 4 of 64;
   printed as ``reduced`` with the reason): K3 ``K3_DENSE_PER_LAYER`` a
   layer in every prefill and decode step, K10 once a layer in a prefill,
   on wgmma alone, the peak under 80 GB, ``memory_budget`` and the
   bounds (``dense_bounds``: a decode step's weight read, a 4500-token
   prefill's projections) printed beside the times; d. the profile of
   7d (grok's with 9d's MoE ranges); each arch's wall time;
16. qwen1.5-32b tensor parallel over a process group (``tp_phase``): a.
   K3 bf16 at every shard shape of its projections for 2-, 4- and 8-way
   tensor parallelism (``tp_k3_shapes``: q/k/v with biases and gate/up
   column-parallel, o and down row-parallel on K3's fp32 store, held to
   ``K3_F32_STORE_TOL``) at M = 4 and 4500, and K10 at 20, 10 and 5
   heads over as many kv heads (head_dim 128, causal) at 1500 and 4500
   tokens, as 15a; b. a 1 x 1 NCCL mesh: qwen1.5-32b at full width cut to
   8 layers, prefilled with ``LM_PROMPTS`` into 4 slots of 8192 rows and
   8 decode steps through the dry run's ``_build_step``, the logits and
   tokens the unsharded port's bits, K3 7 and K10 1 launches a layer in a
   prefill, K3 7 a layer in a step; c. two ranks on the one card over
   gloo (mesh 1 x 2; this script started twice with ``--tp-rank``), the
   model cut to 4 layers, the unsharded reference run first here and
   freed: the ranks' logits within ``TP_BF16_TOL``-relative of it (on
   the reference's tokens; an argmax apart only at a near tie), both
   ranks' the same bits, a repeated first step the same bits, the
   launches a call as 16b, a one-layer fp32 parity with the reference's
   greedy tokens; each rank's prefill and step times, peak memory and
   collectives a step (gloo through host memory on one card: nothing of
   NCCL or NVLink); d. the dry run (``repro_torch.launch.dryrun``) for
   qwen1.5-32b, starcoder2-15b and grok-1-314b at 1 x 4 and 1 x 8 with 4
   slots of 8192 rows: bytes a card against 80 GB, and whether it fits
   (qwen1.5-32b's 64 layers at 1 x 4 must);
17. gemma2-2b training on a mesh (``mesh_phase``), at full width in
   bf16, its rules ``rules_for``'s of the uncut arch on each mesh (FSDP's
   "embed" on at dp 2), cut in depth only (``mesh_train_cut``, printed as
   ``reduced``; ``MESH_TRAIN_DEPTH``'s 2 layers, one local/global
   pair): a. K3's fp32-store backward (dx, dw on dz = the fp32
   cotangent cast to bf16) at the 2-way o and down shards, M = 4096,
   against the plain products within ``LM_KERNEL_TOL``, timed beside
   ``torch.matmul`` and the bound; b. a 1 x 1 NCCL mesh, 8 layers, two
   steps: the loss, CE, grad norm and every new leaf and moment the
   unsharded port's bits (``bits_fingerprint``); c. 1 x 2 and 2 x 2
   (FSDP; 2 x 1 left out since phase 20: ``MESH_TRAIN_MESHES``) as gloo
   ranks on the one card (this script started
   once a rank with ``--mt-rank``), 2 x 2048 tokens a data rank,
   ``MESH_TRAIN_MICROBATCHES`` on the dp meshes, two steps against the
   unsharded reference run first (``make_train_step`` on the global
   batch): CE, loss and grad norm within ``TP_BF16_TOL``, the same bits
   on every rank; every new leaf within 2.02 lr plus one bf16 ulp of the
   reference's; a one-pair fp32 parity within ``_check_step``'s limits;
   the leaves no model axis cuts the same bits on the model ranks of a
   data group; the first step repeated from the same state the same
   bits; K3 and K10 launches a step ``train_expect``'s, on wgmma; each
   rank's step ms, tokens/s, peak beside the dry run's bytes, collectives
   a step (forward and backward apart); d. the dry run's ``train_4k``
   rows for gemma2-2b, starcoder2-15b, internlm2-20b and qwen1.5-32b at 1
   x 4, 1 x 8 and 2 x 4 (two processes beside 17a-c; gemma2-2b and
   qwen1.5-32b at 1 x 4 must be traced);
18. kv-sequence sharding (``kv_phase``): the cache cut by sequence and q
   heads cut over whole kv heads, as ``rules_for`` lays them out: a. K3 at
   starcoder2-15b's 8-way shards (``KV_K3_SHAPES``: q cut, k/v whole, up;
   o and down on the fp32 store) at M = 4 and 4500, and K10 at the rank
   views (``KV_K10_CASES``: starcoder2's 6 q heads over one kv head with
   its window, gemma2-2b's 1 over 1 with softcap 50, local and global) at
   1500 and 4500 tokens, as 16a, while the ranks of b-d (this script
   started once a rank with ``--kv-rank``) start up; then the unsharded
   references of b-d run on the card and are freed; then c runs, and b
   and d once c's ranks are done (the card does not hold c's prefill
   logits beside b's prefill); b. starcoder2-15b at full width cut to
   ``KV_CUTS``' depth on a 1 x 8 gloo mesh: 6 q heads a rank, every kv
   head whole, the 4096-row ring cut into 512 rows a rank; ``LM_PROMPTS``
   into 4 slots and ``TP_DECODE`` steps on the reference's tokens, the
   logits within ``TP_BF16_TOL`` (an argmax apart only at a near tie),
   every rank's the same bits, a repeat of the first step on the cache as
   it stood the same bits, each rank's cache rows the matching rows of the
   reference's cache, K3 ``K3_DENSE_PER_LAYER`` and K10 1 launches a layer
   in a prefill, K3 as many in a step, the collectives a step (a max and
   two sums over "model" a layer for the softmax, q gathered); the int8
   cache on ``KV_INT8_PROMPT`` (its ring wrapped across the ranks) and
   ``KV_INT8_STEPS`` steps, its values and scales within
   ``KV_INT8_CACHE_TOL`` of the reference's; a one-layer
   fp32 parity, greedy, within ``LM_TOL``; c. gemma2-2b under
   ``long_500k``'s rules on a 2 x 1 mesh (batch 1 replicated, the cache
   cut over "data", FSDP's "embed" gathered over it): a
   ``KV_LONG_PROMPT``-token prompt wrapping its 4096-row rings
   (long_500k's window) across the ranks and ``KV_LONG_DECODE`` steps,
   held as b, softcap 50 across the shards, and its fp32 parity at the
   same prompt; d. gemma2-2b's train step on the 1 x 8 ranks after b (one
   q head a rank over 4 whole kv heads), ``KV_TRAIN_ROWS`` x 2048 tokens,
   two steps, the first twice: each step's CE within ``KV_TRAIN_CE_TOL``
   of the reference's, the first step's grad norm within
   ``KV_TRAIN_NORM_TOL`` and its ``wk``/``wv`` gradients within
   ``KV_TRAIN_GRAD_TOL`` of the reference's, the metrics the same bits on
   every rank, the ``wk``/``wv`` gradients the same bits on every rank
   (``bits_fingerprint``), the repeat the same bits, the launches
   ``train_expect``'s; e. the dry run's rows of every shape of the four
   dense archs at 16 x 16 and 2 x 16 x 16 (two processes beside a-d), all
   32 traced;
19. the MoE block on a mesh (``moe_mesh_phase``): a. K3 at the slice's
   rank shapes (``MOE_K3_SHAPES``: qwen3-moe's and grok-1's q, k/v and o
   on the fp32 store at 1 x 4, M = 4 and 4500; grok's expert down on the
   fp32 store at its 8192 ff columns a rank, M = 8 and 2250) and K10 at
   the rank views (``MOE_K10_CASES``), as 16a, while the ranks of b-d
   (``--kv-rank``) start up; then the unsharded references run on the
   card and are freed; b. qwen3-moe-30b-a3b at full width cut to
   ``MOE_CUTS``' depth on a 1 x 4 gloo mesh (32 experts a rank, 8 q heads
   over 1 kv head), ``LM_PROMPTS`` into 4 slots and ``MOE_DECODE`` steps
   on the reference's tokens, held as 18b (logits within
   ``TP_BF16_TOL``, every rank's the same bits, the repeat's bits, each
   rank's cache rows, K3 4 and K10 1 launches a layer in a prefill, the
   prefills on K3's and K10's wgmma paths; the cache rows of tokens
   routed apart left out, every layer's but the first held to
   ``TP_BF16_TOL``), every MoE call's capacity the reference's and, in a
   prefill's or step's first MoE layer, its set of experts the
   reference's but at a near tie (``MOE_NEAR_TIE``), at most
   ``MOE_MOST_PARTED`` of the run's tokens routed apart in any layer, the
   collectives a step (o's partials and the picked rows summed over
   "model" a layer); c. grok-1-314b on the same ranks (each expert's
   8192 ff columns, 12 q heads over 2 kv heads), held as b with K3 12 a
   layer (the experts' fp32 partials), on ``MOE_PROMPTS``' three
   prompts; d. qwen3-moe's bf16 train step
   (``moe_redraw``'s experts) on 2 x 2 under ``rules_for``'s rules
   (FSDP's "embed" over "data"), ``MOE_TRAIN_ROWS`` x 2048 tokens a data
   rank, two steps, the first twice: CE and both aux losses within
   ``MOE_TRAIN_TOL`` of the unsharded step on the global batch grouped by
   dp 2, the metrics the same bits on every rank, the repeat the same
   bits, the router's gradient the same bits on both model ranks of a
   data group; e. the dry run's 16 MoE rows at 16 x 16 and 2 x 16 x 16
   (two processes beside a-d), all traced and fitting;
20. "ssm_inner" on a mesh (``ssm_mesh_phase``): a. K11 at a rank's 16
   heads from a state (``SSM_K11_CASES``: 1500 and 4500 tokens), K3 at
   rwkv6's and zamba2's 1 x 2 rank shapes (``SSM_K3_SHAPES``: the
   row-parallel wo, wv, out_proj, o, down and shared_out on the fp32
   store) at M = 4 and 4500, and K10 at the shared block's 16 heads over
   16 (``SSM_K10_CASES``), as 16a, while the ranks of b-d (``--kv-rank``)
   start up; then the unsharded references run on the card and are freed;
   b. rwkv6-1.6b at full width cut to ``SSM_CUTS``' depth on a 1 x 2 gloo
   mesh (16 WKV heads a rank, wr/wk/wv/wg column-parallel, wo and the
   channel mix's wv row-parallel), ``LM_PROMPTS`` into 4 slots and
   ``SSM_DECODE`` steps on the reference's tokens: the logits within
   ``TP_BF16_TOL`` (an argmax apart only at a near tie), both ranks' the
   same bits, the repeat's bits, K3 8 a layer and K11 1 a layer in a
   prefill, each kernel given the rank's heads alone, each cache leaf
   (the WKV state's heads, the token-shift rows) the rank's slice of the
   reference's (the first layer within ``LM_CACHE_TOL``, later ones
   within ``TP_BF16_TOL``), the collectives a step; c. zamba2-1.2b on
   the same ranks, one group (6 Mamba blocks, one shared invocation): 32
   SSD heads a rank, in_proj's columns gathered over "model", the shared
   block's 16 heads, held as b with K3 2 a block and 8 an invocation and
   K10 1 an invocation; d. a bf16 train step of rwkv6 (2 layers) and of
   zamba2 (one group) on the same ranks, ``SSM_TRAIN_ROWS`` x 2048
   tokens, two steps, the first twice: each step's CE within
   ``SSM_TRAIN_TOL`` of the unsharded step's, zamba2's gathered in_proj
   gradient within ``SSM_GRAD_TOL``, the metrics the same bits on both
   ranks, the repeat the same bits; the dry run's 16 ssm and hybrid rows
   are traced in tier-1 (tests/test_torch_ssm_mesh.py), not here;
21. prints one JSON line ``{"kernels": [...]}``: per kernel, ``launches``
   is its count summed over the AlexNet forwards of phase 4 (K1-K3,
   K7-K9) or phase 5 (K4-K6), or over the first LM serving run of phase
   7c and the first runs of phases 11c and 15c (K10's wgmma path as
   ``flash_attention``, and K3's bf16 launches as ``matmul_fused_bf16``)
   or of phase 8c (K11, as ``wkv6``), each counted from 0; the times and
   bound are summed over its distinct AlexNet batch-16 shapes on that
   path (K10: the bf16 4500-token cases at gemma2-2b's shape with cap 50;
   K3 bf16: its phase-7a cases at M = 4 and 4500; K11: its bf16
   4500-token case, which no library call computes); K10's CUDA-core
   kernel has an entry of its own (``flash_attention_simt``), its
   launches those of the fp32 prefills of 7b, 11b and 15b, its times the
   fp32 4500-token case; K3's wgmma path has an entry of its own, its
   launches those of the wgmma path in the first runs of 7c, 11c and 15c,
   its times its phase-7a cases at M = 4500; the error is the largest over
   every case, phase 15a's among them.  Phase 16's sharded runs (16b and
   both ranks of 16c) add their K3 and K10 launches to those entries, and
   K3's fp32 store has an entry of its own (``matmul_fused_bf16_f32``:
   the launches of 16c's ranks, the times of 16a's 2-way o and down at
   M = 4 and 4500).  Phase 13c's first steps (every
   trained model's, summed) add, apart:
   ``train_backward_launches`` (K3's z, dx and dw) on the K3 entries,
   ``train_ml_launches`` on ``flash_attention`` and ``train_launches``
   on ``wkv6``; phase 17c's ranks' first steps add
   ``mesh_train_launches`` on the K3 bf16 entry (by role) and on
   ``flash_attention``, and their fp32 stores to the
   ``matmul_fused_bf16_f32`` entry's launches, which carries 17a's times
   under ``backward``; the bf16 serving runs of 18b's, 18c's, 19b's and
   19c's ranks add their K3, K10 and fp32-store launches as 16c's do, and
   18a's and 19a's cases join the largest errors; so do 20b's and 20c's
   ranks and 20a's cases, and their K11 launches are ``wkv6``'s
   ``mesh_launches``;
22. prints ``{"ok": true, "device": {...}}`` as its last line.

Run it from the repository root; it needs one CUDA device and the CUDA
toolkit, and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import bisect
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
#: phase 5c: the batches the verifier and the recorded forwards run at
STATIC_BATCHES = (1, 16)
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


def static_phase(torch, np, nets, np_params, dev, card):
    """Phase 5c (see the module docstring); returns its record."""
    from repro_torch.analysis.verifier import (launch_smem,
                                               step_launch_geometry,
                                               verify_plan)
    from repro_torch.core.deploy import params_from_numpy
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.pool2d import ops as pool_ops

    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    optin = props.shared_memory_per_block_optin
    plans = [(name, f"{m}/{'fused' if f else 'unfused'}",
              CNNEngine(net, method=Method(m), fuse_pool=f).plan())
             for name, net in nets.items() for m, f in RUNGS]
    plans.append(("alexnet", "tuned", compile_plan(nets["alexnet"], **TUNED)))
    # what the verifier reads, before the launch functions are recorded
    want, findings, steps, max_smem = {}, [], 0, {}
    for name, label, plan in plans:
        findings += [f"{name} {label}: {f}" for f in verify_plan(
            plan, batches=STATIC_BATCHES, sms=sms)]
        for n in STATIC_BATCHES:
            got = [step_launch_geometry(plan, s, n, sms) for s in plan.steps]
            want[name, label, n] = [g for g in got if g is not None]
            steps += len(want[name, label, n])
            for kid, launch in want[name, label, n]:
                max_smem[kid] = max(max_smem.get(kid, 0),
                                    launch_smem(kid, launch))
    if findings:
        fail(f"static analysis: {len(findings)} finding(s): {findings[:5]}")
    # what the forwards launch: every launch-geometry call recorded
    calls = []
    mods = ((conv_ops, "chain_launch"), (conv_ops, "k7_launch"),
            (conv_ops, "k8_launch"), (pool_ops, "pool_launch"))
    real = {fn: getattr(mod, fn) for mod, fn in mods}

    def recorder(fn):
        def call(*args):
            out = real[fn](*args)
            calls.append((fn, args, out))
            return out
        return call

    rng = np.random.default_rng(SEED)
    try:
        for mod, fn in mods:
            setattr(mod, fn, recorder(fn))
        for name, label, plan in plans:
            params = params_from_numpy(np_params[name], dev)
            for n in STATIC_BATCHES:
                x = torch.from_numpy(rng.standard_normal(
                    (n, *nets[name].input_shape)).astype(np.float32)).to(dev)
                calls.clear()
                plan.execute(params, x)
                torch.cuda.synchronize()
                exp = want[name, label, n]
                same = len(calls) == len(exp) and all(
                    (fn, args) == (launch.fn, launch.args)
                    and (out is launch.geometry if fn != "pool_launch"
                         else out == launch.geometry)
                    for (fn, args, out), (_, launch) in zip(calls, exp))
                if not same:
                    fail(f"static analysis: {name} {label} batch {n} "
                         f"launched the geometry of {[c[:2] for c in calls]}"
                         f", the verifier read "
                         f"{[(g.fn, g.args) for _, g in exp]}")
    finally:
        for mod, fn in mods:
            setattr(mod, fn, real[fn])
    per_sm = _build.library().stage_major_blocks_per_sm()
    if per_sm < conv_ops.CH_MIN_BLOCKS:
        fail(f"static analysis: the stage-major kernel holds {per_sm} "
             f"blocks an SM, V304 assumes {conv_ops.CH_MIN_BLOCKS}")
    if max(max_smem.values()) > optin:
        fail(f"static analysis: admitted shared memory {max_smem} past the "
             f"card's opt-in {optin} B")
    wall = time.perf_counter() - t0
    rec = {"plans": len(plans), "steps": steps,
           "batches": list(STATIC_BATCHES), "findings": len(findings),
           "sms": sms, "blocks_per_sm": per_sm,
           "ch_min_blocks": conv_ops.CH_MIN_BLOCKS,
           "smem_optin": optin, "max_smem": max_smem, "wall_s": wall}
    print(f"phase 5c wall time {wall:.1f} s [{card}]", flush=True)
    return rec


def guard_phase(torch, card):
    """Phase 5d (see the module docstring); returns its record."""
    from repro_torch.analysis import guard
    from repro_torch.tools import sanitize

    t0 = time.perf_counter()
    findings, ran = sanitize.guard_pass()
    wall = time.perf_counter() - t0
    launched = {u for _, units in ran for u in units}
    table = guard.guard_table(findings, launched, sanitize.COVERED)
    print(f"phase 5d guard pass, {len(ran)} cases [{card}]", flush=True)
    print(guard.table_markdown(table), flush=True)
    for f in findings:
        print(f, flush=True)
    print(f"phase 5d wall time {wall:.1f} s [{card}]", flush=True)
    missing = [u for u in sanitize.COVERED if u not in launched]
    if missing:
        fail(f"guard pass: no case launched {missing}")
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        fail(f"guard pass: {len(errors)} error finding(s): "
             f"{[str(f) for f in errors[:5]]}")
    return {"cases": len(ran), "units": sorted(launched),
            "cases_by_unit": {u: sum(u in us for _, us in ran)
                              for u in sanitize.COVERED},
            "findings": [str(f) for f in findings], "table": table,
            "wall_s": wall}


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
#: this many times faster than on the CUDA-core tile, timed in one call:
#: their device times, each from a captured graph's replay
#: (``stream_device_ms``)
K3_WGMMA_GAIN = (4500, 5.0)
#: the gate's graphs: (launches, timed replays) of the wgmma path and of
#: the CUDA-core tile
K3_GAIN_GRAPH = (5, 3)
K3_GAIN_TILE_GRAPH = (2, 3)
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


def stream_device_ms(torch, call, launches=STREAM_GRAPH_LAUNCHES, reps=5):
    """Device time of one call of a kernel wrapper (K3's weight stream,
    K9, K11): ``launches`` calls captured into a CUDA graph (a launch
    allocates only its outputs and scratch and never synchronises, so it
    captures), the replay timed with CUDA events, the median of ``reps``
    over the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            call()
    ms = time_ms(torch, graph.replay, reps) / launches
    del graph
    return ms


def k3_bf16_case(torch, F, gen, dev, m, kk, n, act, peaks, main, bias=False,
                 out_dtype=None, **extra):
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
    bias in bf16).  ``out_dtype=torch.float32``: y stored in fp32 (a
    row-parallel shard's partial), held to ``K3_F32_STORE_TOL``; the
    library still stores bf16.  ``extra`` joins the record.  Returns the
    record."""
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ops import k3_path, matmul_fused
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    _, bw_peak, bf16_peak = peaks
    x = torch.randn((m, kk), generator=gen, device=dev).bfloat16()
    w = (torch.randn((kk, n), generator=gen, device=dev) / kk ** 0.5
         ).bfloat16()
    b = torch.randn((n,), generator=gen, device=dev) if bias else None
    kernel = lambda: matmul_fused(x, w, b, act, out_dtype)  # noqa: E731
    plain = lambda: matmul_fused_ref(x, w, b, act,  # noqa: E731
                                     out_dtype=out_dtype)
    tile = lambda: mm_ops._launch(x, w, b, act, path="tiles",  # noqa: E731
                                  out_dtype=out_dtype)
    b16 = None if b is None else b.bfloat16()
    f32 = out_dtype == torch.float32

    def library():
        y = torch.matmul(x, w) if b16 is None else torch.addmm(b16, x, w)
        if act == "gelu":
            return F.gelu(y, approximate="tanh")
        if act == "silu":
            return F.silu(y)
        return F.relu(y) if act == "relu" else y

    label = (f"K3 bf16 M={m} {kk}->{n} {act}" + (" +bias" if bias else "")
             + (" fp32 store" if f32 else ""))
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
    rtol, atol = K3_F32_STORE_TOL if f32 else LM_KERNEL_TOL["bfloat16"]
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
    if out.dtype != (torch.float32 if f32 else torch.bfloat16):
        fail(f"{label}: output {out.dtype}")
    if not torch.equal(kernel(), out):
        fail(f"{label}: a repeated launch differs")
    if path == "stream" and m > 1 and not torch.equal(
            matmul_fused(x[:1], w, b, act, out_dtype), out[:1]):
        fail(f"{label}: row 0 differs from the same row called alone")
    lib_err = (library().float() - ref.float()).abs().max().item()
    flops = 2.0 * m * kk * n
    nbytes = (2.0 * (m * kk + kk * n) + (4.0 if f32 else 2.0) * m * n
              + 4.0 * n * bias)
    r = {"kernel": "K3-bf16", "rows": m, "k": kk, "n": n, "act": act,
         "bias": bias, "path": path, "max_abs_err": err, "store":
         "float32" if f32 else "bfloat16",
         **({"last_tile_from": last, "last_tile_max_abs_err": last_err}
            if last is not None else {}),
         "tol": {"rtol": rtol, "atol": atol},
         "library_max_abs_err": lib_err,
         "library_note": ("torch.addmm, bf16 bias" if bias
                          else "torch.matmul") + f" in bf16 (+ {act})"
         + (", a bf16 store" if f32 else "")}
    if path == "wgmma":
        _check_close(f"{label} CUDA-core tile", tile(), ref, atol, rtol)
        runs = [time_ms(torch, f) for f in (tile, kernel, kernel, tile)]
        r.update(ms=(runs[1] + runs[2]) / 2, tile_ms=(runs[0] + runs[3]) / 2,
                 runs_tile_wgmma_wgmma_tile_ms=runs)
        r["gain_vs_tile"] = r["tile_ms"] / r["ms"]
        gain_m, gain = K3_WGMMA_GAIN
        if m == gain_m:
            # the paths' device times, each from a captured graph's
            # replay: the events above take in the wrapper's host work
            # before each launch (about 35 us), which a 30-us kernel at a
            # small N does not hide.  Few launches a graph: the tile takes
            # up to 20 ms a call at these shapes, and a graph holds every
            # launch's output
            r["device_ms"] = stream_device_ms(torch, kernel, *K3_GAIN_GRAPH)
            r["tile_device_ms"] = stream_device_ms(torch, tile,
                                                   *K3_GAIN_TILE_GRAPH)
            r["gain_vs_tile_device"] = r["tile_device_ms"] / r["device_ms"]
            if not r["gain_vs_tile_device"] >= gain:
                fail(f"{label}: wgmma {r['device_ms']:.4f} ms of device "
                     f"time against the CUDA-core tile's "
                     f"{r['tile_device_ms']:.4f}, under {gain}x")
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
                    per_prefill=None, media_key=None,
                    decode=LM_PARITY_DECODE):
    """Phase 7b (gemma2-2b, one local/global pair), 8b (rwkv6-1.6b, two
    layers), 9b (qwen3-moe-30b-a3b, two layers), 10b (zamba2-1.2b,
    ``cut`` to three layers in one group of two and a tail of one) and
    11b (the cross-attention families, their media cut too):
    ``arch`` at full width with its depth cut (``cut``: the config's
    changes, default 2 layers), float32, on the card and on the CPU with
    the same weights (``redraw``: a function that then redraws leaves of
    the tree from the same generator, ``rwkv_redraw``, ``ssm_redraw`` or
    ``vision_redraw``); a ``prompt_len``-token prefill and
    ``decode`` greedy tokens (default ``LM_PARITY_DECODE``) must agree
    (``LM_TOL``), as must the final caches (``LM_CACHE_TOL`` by the leaf's dtype).
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
    cache_len = prompt_len + decode + 8
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
        for i in range(decode - 1):
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


def build_model(torch, arch, dev, redraw=None, layers=None):
    """``arch`` at full width and depth (``layers``: that many layers
    instead) with weights drawn on ``dev`` from ``SEED`` (``redraw``: then
    that function's leaves, ``rwkv_redraw``'s or ``ssm_redraw``'s, from
    the same generator); returns (model, seconds)."""
    import dataclasses

    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree

    t0 = time.perf_counter()
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(cfg)
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
        # the timed wrappers hold the engine in a reference cycle: collect
        # it now, or its cache stays on the card beside the next run's
        del eng
        gc.collect()
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
        # the profiler's raw events (reading them through ``events()`` or
        # ``key_averages()`` builds a Python object an event first, about
        # 80 us each: minutes for a train step's million host events).
        # Device events: kernels and copies, not the ranges' device-side
        # annotations; the runtime's launch and copy calls (``cu*``) by
        # correlation id, which their kernels share (an operator's id is
        # from another count); each range's spans by thread
        cpu, cuda = (torch.autograd.DeviceType.CPU,
                     torch.autograd.DeviceType.CUDA)
        kernels, launch_calls = [], {}
        spans = {label: [] for label in labels}
        for e in prof.profiler.kineto_results.events():
            key, kind = e.name(), e.device_type()
            if kind == cuda:
                if not e.is_user_annotation() and key not in labels:
                    kernels.append((key, e.duration_ns() / 1e6,
                                    e.correlation_id()))
            elif kind == cpu:
                if key in spans:
                    spans[key].append((e.start_thread_id(), e.start_ns(),
                                       e.end_ns()))
                elif key.startswith("cu"):
                    launch_calls[e.correlation_id()] = (e.start_thread_id(),
                                                        e.start_ns())
        by_key = {}
        for key, ms, _ in kernels:
            total, n = by_key.get(key, (0.0, 0))
            by_key[key] = (total + ms, n + 1)
        rows = [(k, ms, n) for k, (ms, n) in by_key.items() if ms > 0]
        dev = sum(r[1] for r in rows)
        by_kernel = {kid: sum(ms for key, ms, _ in rows
                              if any(nm in key for nm in names))
                     for kid, names in PROFILE_GROUPS}
        by_kernel["rest"] = dev - sum(by_kernel.values())
        k3_by_path = {path: sum(ms for key, ms, _ in rows if nm in key)
                      for path, nm in K3_PROFILE_PATHS}
        port_names = [nm for _, names in PROFILE_GROUPS for nm in names]
        dev_by_range = dict.fromkeys(labels, 0.0)
        port_by_range = dict.fromkeys(labels, 0.0)
        # a kernel belongs to every range whose span, on the launching
        # thread, holds its launch call (the nesting of host calls); a
        # range's spans on one thread do not overlap, so the last to start
        # before the call is the only one that can hold it
        starts = {label: {} for label in labels}
        for label, items in spans.items():
            for th, t0, t1 in sorted(items):
                starts[label].setdefault(th, ([], []))
                starts[label][th][0].append(t0)
                starts[label][th][1].append(t1)
        for key, ms, corr in kernels:
            call = launch_calls.get(corr)
            if call is None:
                continue
            ours = any(nm in key for nm in port_names)
            for label in labels:
                t0s, t1s = starts[label].get(call[0], ((), ()))
                i = bisect.bisect_right(t0s, call[1]) - 1
                if i >= 0 and call[1] <= t1s[i]:
                    dev_by_range[label] += ms
                    port_by_range[label] += ms if ours else 0.0
        launches = dict.fromkeys(labels, 0)
        for label, before, after in calls:
            launches[label] += sum(after) - sum(before)
        # the range's wall time on the host, callees in
        host_by_range = {label: sum(t1 - t0 for _, t0, t1 in spans[label])
                         / 1e6 for label in labels}
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


def wkv6_cost(b, s, h, e, chunk, dtype_bytes, state=False):
    """(operations, bytes) the chunked WKV needs, from K11's arithmetic:
    per chunk of n rows and n (n - 1) / 2 pairs j < i, the cumulative
    decays and cw_prev (2 n e), each pair's decay and product (5 e: a
    difference, an exp, two products, a sum), A v (2 e a pair), the bonus
    (5 n e), r ⊙ exp(cw_prev) (2 n e) and its product with S (2 n e^2),
    k ⊙ exp(cw_L - cw) (3 n e), the state update (2 n e^2 + 3 e^2).
    Bytes: r, k, v and o once in their type, logw and u in fp32, the final
    state in fp32, and with ``state`` the initial one read in fp32."""
    L = min(chunk, s)
    ops = 0.0
    for t0 in range(0, s, L):
        n = min(L, s - t0)
        pairs = n * (n - 1) / 2
        ops += (2 * n * e + 7 * pairs * e + 5 * n * e + 2 * n * e
                + 2 * n * e * e + 3 * n * e + 2 * n * e * e + 3 * e * e)
    elems = b * s * h * e
    nbytes = (4 * dtype_bytes * elems + 4 * elems + 4 * h * e
              + 4 * b * h * e * e * (2 if state else 1))
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


def k11_case(torch, gen, dev, peaks, s, dname, decay, heads=K11_HEADS,
             with_state=False):
    """K11 at ``s`` tokens of ``heads`` heads in ``dname`` (decays
    ``K11_DECAYS[decay]``; ``with_state``: from a seeded fp32 state, as a
    prompt's later chunk or a rank's state shard takes it) against its
    plain version, repeated bit for bit, timed with its bound; returns
    the record."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_plan
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

    fp32_peak, bw_peak, _ = peaks
    r, k, v, logw, u = k11_inputs(torch, gen, dev, s, getattr(torch, dname),
                                  decay, heads)
    st = (0.1 * torch.randn((1, heads, 64, 64), generator=gen, device=dev)
          if with_state else None)
    kernel = lambda: wkv6(r, k, v, logw, u, chunk=64,  # noqa: E731
                          state=st)
    plain = lambda: wkv6_chunked_ref(r, k, v, logw, u, 64,  # noqa: E731
                                     st)
    ref_o, ref_s = plain()
    out_o, out_s = kernel()
    torch.cuda.synchronize()
    rtol, atol = LM_KERNEL_TOL[dname]
    label = f"K11 {dname} s={s} h={heads} decays {decay}" + (
        " from a state" if with_state else "")
    err = _check_close(label, out_o, ref_o, atol, rtol)
    s_rtol, s_atol = LM_KERNEL_TOL["float32"]
    s_err = _check_close(f"{label} state", out_s, ref_s, s_atol, s_rtol)
    again = kernel()
    if not (torch.equal(again[0], out_o) and torch.equal(again[1], out_s)):
        fail(f"{label}: a repeated launch differs")
    flops, nbytes = wkv6_cost(1, s, heads, 64, 64, out_o.element_size(),
                              with_state)
    plan = wkv6_plan(1, s, heads, min(64, s), sm_count(dev))
    design_bytes = wkv6_design_bytes(plan, s, heads, out_o.element_size())
    rec = {"kernel": "K11", "tokens": s, "heads": heads,
           "dtype": dname, "decays": decay, "state": with_state,
           "max_abs_err": err, "state_max_abs_err": s_err,
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
           "main": (s, dname, decay, heads, with_state)
           == (4500, "bfloat16", "normal", K11_HEADS, False)}
    print("case " + json.dumps(rec), flush=True)
    return rec


def k11_inputs(torch, gen, dev, s, dt, decay, heads=K11_HEADS):
    """r, k, v in ``dt``, fp32 logw with ``K11_DECAYS[decay]``'s decays
    and u, seeded: [1, s, heads, 64] and [heads, 64]."""
    mean, std = K11_DECAYS[decay]
    shape = (1, s, heads, 64)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    logw = -torch.exp(mean + std * torch.randn(shape, generator=gen,
                                               device=dev))
    u = 0.5 * torch.randn((heads, 64), generator=gen, device=dev)
    return r, k, v, logw, u


def rwkv_kernel_cases(torch, F, dev, peaks):
    """Phase 8a: K11 at rwkv6-1.6b's shapes (``K11_CASES``, then a state
    hand-off) and K3 (bf16) at its projections against their plain
    versions, repeated bit for bit, timed; returns the records."""
    from repro_torch.kernels.wkv6.ops import wkv6

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = [k11_case(torch, gen, dev, peaks, s, dname, decay)
            for s, dname, decay in K11_CASES]
    # the state hand-off: two calls over the halves (the second one from
    # the first one's final state) against one call over the whole.  The
    # halves' chunks start at 750, not at a multiple of 64, so the state is
    # the same sum in other groupings: its elements are held at fp32's
    # rtol plus 1e-5 of the largest state (each element's rounding follows
    # the size of its terms, not its own)
    r, k, v, logw, u = k11_inputs(torch, gen, dev, K11_HANDOFF,
                                  torch.bfloat16, "normal")
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

    def wrapped(params, x, cfg, *, dp_size=1, mode="train", **kw):
        r = moe.route(params, x, cfg, dp_size=dp_size, mode=mode)
        k = cfg.moe.num_experts_per_token
        top = torch.topk(r.probs, k + 1, dim=-1).values
        kept = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
        log.append({"device": x.device.type, "mode": mode, "cap": r.cap,
                    "experts": r.e_k.cpu(), "kept": kept.cpu(),
                    "dropped": int((~r.keep).sum()),
                    "margin": (top[..., k - 1] - top[..., k]).min().item()})
        return real(params, x, cfg, dp_size=dp_size, mode=mode, **kw)

    common.moe_apply = wrapped
    try:
        yield
    finally:
        common.moe_apply = real


def check_routing(log, arch=MOE_ARCH):
    """Phase 9b (and 15b for grok-1-314b, ``arch``): the card's blocks
    chose the CPU's experts and kept its pairs, call by call; returns the
    summary."""
    sides = {d: [r for r in log if r["device"] == d] for d in ("cuda", "cpu")}
    gpu, cpu = sides["cuda"], sides["cpu"]
    if not gpu or len(gpu) != len(cpu):
        fail(f"{arch} parity: {len(gpu)} MoE calls on the card, "
             f"{len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if (a["mode"], a["cap"]) != (b["mode"], b["cap"]):
            fail(f"{arch} parity: MoE call {i} ran {a['mode']} cap "
                 f"{a['cap']} on the card, {b['mode']} cap {b['cap']} on "
                 f"the CPU")
        if not a["experts"].equal(b["experts"]):
            fail(f"{arch} parity: MoE call {i} ({a['mode']}) chose other "
                 f"experts on the card than on the CPU (smallest margin "
                 f"{min(a['margin'], b['margin'])})")
        if not a["kept"].equal(b["kept"]):
            fail(f"{arch} parity: MoE call {i} ({a['mode']}) kept other "
                 f"pairs on the card than on the CPU")
    prefill = [r for r in gpu if r["mode"] == "prefill"]
    if any(r["dropped"] for r in gpu if r["mode"] == "decode"):
        fail(f"{arch} parity: a decode step dropped pairs")
    rec = {"calls": len(gpu), "prefill_cap": prefill[0]["cap"],
           "prefill_dropped": [r["dropped"] for r in prefill],
           "decode_dropped": sum(r["dropped"] for r in gpu
                                 if r["mode"] == "decode"),
           "min_margin": min(r["margin"] for r in gpu + cpu),
           "min_margin_prefill": min(r["margin"] for r in prefill)}
    print(f"{arch} routing " + json.dumps(rec), flush=True)
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


#: phase 13: training.  The batch (b * s = 4096 rows, a multiple of 64, so
#: that every K3 product of the step is TMA-describable and takes the
#: wgmma path), the steps, and the corpus: a Markov chain over
#: ``TRAIN_VOCAB`` symbols, ids that lie inside every vocab.  The models,
#: in the order they are brought up: gemma2-2b and rwkv6-1.6b, then
#: zamba2-1.2b and seamless-m4t-large-v2 at full width, qwen3-moe-30b-a3b,
#: starcoder2-15b and llama-3.2-vision-11b cut in depth by
#: ``train_cut``.  grok-1-314b does not fit one card at one layer (4.9 G
#: parameters a layer, about 59 GB at 12 bytes a parameter before its
#: embedding), and internlm2-20b and qwen1.5-32b run starcoder2's dense
#: path: the three are held in the CPU tests only
TRAIN_ARCHS = (LM_ARCH, "rwkv6-1.6b", "zamba2-1.2b", "seamless-m4t-large-v2",
               "qwen3-moe-30b-a3b", "starcoder2-15b", "llama-3.2-vision-11b")
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
#: the timed steps (the first taken twice, the median of the others the
#: step time); one more step runs under the profiler
TRAIN_STEPS = 4
TRAIN_VOCAB = 1024
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
#: JAX's strided split with fp32 accumulation, on the card for qwen3-moe
TRAIN_MICROBATCHES = {"qwen3-moe-30b-a3b": 2}
#: the archs whose trees are redrawn after the init (``rwkv_redraw``,
#: ``ssm_redraw``, ``vision_redraw`` as the serving phases redraw them;
#: ``moe_redraw``: at a few layers JAX's fan-in rule draws the stacked
#: experts at std 1/sqrt(layers), and silu's gradient turns NaN)
TRAIN_REDRAWS = {"rwkv6-1.6b": "rwkv", "zamba2-1.2b": "ssm",
                 "llama-3.2-vision-11b": "vision",
                 "qwen3-moe-30b-a3b": "moe"}
#: a cut model is given the most whole units (a layer; gemma2's
#: local/global pair; llama's group of 4 self and 1 cross layer) whose
#: reckoned peak (``train_memory_budget``, a sum of parts that never all
#: meet: 5-13 GB above the peaks measured) stays within this many GB of
#: the card's 80 GiB (85.9 GB)
TRAIN_MEMORY_LIMIT_GB = 76.0
#: the one-unit fp32 step of each model held against the CPU (the
#: config's changes): gemma2's local/global pair, two rwkv6 layers, one
#: Mamba2 block and one shared-block invocation, one MoE layer, one
#: starcoder2 layer, one self and one cross layer, one encoder and one
#: decoder layer; the cross families' media cut to ``CROSS_PARITY_MEDIA``
TRAIN_PARITY_CUTS = {
    LM_ARCH: {"num_layers": 2}, "rwkv6-1.6b": {"num_layers": 2},
    "zamba2-1.2b": {"num_layers": 1, "shared_attn_every": 1},
    "seamless-m4t-large-v2": {"num_layers": 1, "num_encoder_layers": 1},
    "qwen3-moe-30b-a3b": {"num_layers": 1},
    "starcoder2-15b": {"num_layers": 1},
    "llama-3.2-vision-11b": {"num_layers": 2}}
#: K3's training shapes (K, N, activation, bias, rows): gemma2-2b's five
#: projections, rwkv6-1.6b's three, the silu and gelu epilogues with a
#: bias; zamba2's in_proj (N = 8384: dw's last wgmma tile half empty,
#: dx's K = 8384), seamless's w_up (gelu, the bias's db), starcoder2's q,
#: k/v, up (gelu) and down with biases, and llama's k/v on the media's
#: 2 x 6400 rows
K3_TRAIN_SHAPES = (
    (2304, 2048, "none", False, TRAIN_ROWS),
    (2304, 1024, "none", False, TRAIN_ROWS),
    (2048, 2304, "none", False, TRAIN_ROWS),
    (2304, 9216, "gelu", False, TRAIN_ROWS),
    (9216, 2304, "none", False, TRAIN_ROWS),
    (2048, 2048, "none", False, TRAIN_ROWS),
    (2048, 7168, "relu", False, TRAIN_ROWS),
    (7168, 2048, "none", False, TRAIN_ROWS),
    (2304, 9216, "gelu", True, TRAIN_ROWS),
    (2048, 2048, "silu", True, TRAIN_ROWS),
    (2048, 8384, "none", False, TRAIN_ROWS),
    (1024, 8192, "gelu", True, TRAIN_ROWS),
    (6144, 6144, "none", True, TRAIN_ROWS),
    (6144, 512, "none", True, TRAIN_ROWS),
    (6144, 24576, "gelu", True, TRAIN_ROWS),
    (24576, 6144, "none", True, TRAIN_ROWS),
    (4096, 1024, "none", False, TRAIN_BATCH * 6400))
#: K10's: (batch, query tokens, keys (None: the queries'), heads, kv
#: heads, head_dim, causal, window, cap): gemma2-2b's training batch and
#: a 4500-token row where its window bites; zamba2's shared block (32
#: over 32, hd 128); seamless's encoder (non-causal 4096 x 4096, hd 64)
#: and cross-attention (2048 x 4096); starcoder2's (48 over 4, its
#: window); llama's cross-attention (non-causal 2048 x 6400, 32 over 8)
K10_TRAIN_CASES = (
    (TRAIN_BATCH, TRAIN_SEQ, None, 8, 4, 256, True, 4096, 50.0),
    (1, 4500, None, 8, 4, 256, True, 4096, 50.0),
    (TRAIN_BATCH, TRAIN_SEQ, None, 32, 32, 128, True, 0, 0.0),
    (TRAIN_BATCH, 4096, None, 16, 16, 64, False, 0, 0.0),
    (TRAIN_BATCH, TRAIN_SEQ, 4096, 16, 16, 64, False, 0, 0.0),
    (TRAIN_BATCH, TRAIN_SEQ, None, 48, 4, 128, True, 4096, 0.0),
    (TRAIN_BATCH, TRAIN_SEQ, 6400, 32, 8, 128, False, 0, 0.0))
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
#: the models whose one-unit step 13b holds against the CPU: gemma2-2b
#: alone.  Each model's CPU side runs on one thread (about 24 s each on an
#: H100 at 700 W's host, 272-306 s for all seven) and the smoke, with
#: phase 17, ran past its 1200 s; the others' steps stay held against
#: JAX's in tests/test_torch_train.py, their kernels' gradients in 13a
#: and their bf16 steps, with the first taken twice, in 13c
TRAIN_PARITY_ARCHS = (LM_ARCH,)


def train_memory_budget(model, batch, seq, microbatches=1):
    """GB a train step of ``model`` on ``batch`` x ``seq`` tokens reckons
    on the card, by part, and their ``total``, reckoned before the run
    and printed beside its peak: the weights and the gradient buffers
    (each leaf's dtype: bf16, the fp32 leaves at 4 bytes), JAX's fp32
    accumulation of the microbatches' gradients, the fp32 moments,
    AdamW's fp32 temporaries (about five of its largest leaf at once:
    ``train/optimizer.py`` updates a stacked leaf whole), five fp32
    tensors of a microbatch's rows x the padded vocab (the logits the
    log-sum-exp keeps, its backward's exp, the gold logit's gradient,
    their sum, the mask's; a softcap keeps its tanh and adds a product in
    its backward: two more), the bf16 media or frames,
    and the activations (the bf16 input each rematted unit keeps, and
    eight fp32 tensors of the widest projection's output over the most
    rows a product takes: the working set of one unit's recompute and
    backward).  The parts are summed, though the optimizer's temporaries
    never meet the logits, so the total bounds the peak from above."""
    import math

    from repro_torch.nn.param import tree_leaves

    cfg = model.cfg
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    largest = max(math.prod(p.shape) for p in tree_leaves(model.param_spec()))
    tokens = batch * seq // microbatches
    xa = cfg.cross_attn if cfg.family in ("vlm", "audio") else None
    media_rows = batch // microbatches * xa.num_media_tokens if xa else 0
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    unit_rows = (cfg.num_layers * tokens
                 + cfg.num_encoder_layers * media_rows)
    parts = {
        "weights": weight_bytes / 1e9,
        "grads": weight_bytes / 1e9,
        "grad_accumulation": (4 * n if microbatches > 1 else 0) / 1e9,
        "moments": 8 * n / 1e9,
        "optimizer": 5 * 4 * largest / 1e9,
        "logits": ((5 + 2 * bool(cfg.logit_softcap)) * 4 * tokens
                   * cfg.padded_vocab / 1e9),
        "media": (2 * batch * xa.num_media_tokens * xa.media_dim / 1e9
                  if xa else 0.0),
        "activations": (unit_rows * cfg.d_model * act_bytes
                        + 8 * 4 * max(tokens, media_rows)
                        * max(cfg.d_ff, 4 * cfg.d_model)) / 1e9,
    }
    parts["total"] = sum(parts.values())
    return parts


def train_cut(arch):
    """The config phase 13c trains ``arch`` at: the full model if its
    reckoned peak (``train_memory_budget`` at ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` and the arch's microbatches) stays within
    ``TRAIN_MEMORY_LIMIT_GB``, else the most whole units (a layer,
    gemma2's local/global pair, a VLM group of interval layers) that do;
    widths, heads, experts and vocab as published.  Returns (config, the
    cut as ``reduced`` prints it or None, the budget)."""
    import dataclasses

    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model

    full = get_arch(arch)
    unit = (full.cross_attn.interval if full.family == "vlm"
            else max(1, full.local_global_interval))
    mb = TRAIN_MICROBATCHES.get(arch, 1)
    layers = full.num_layers
    while True:
        cfg = dataclasses.replace(full, num_layers=layers)
        budget = train_memory_budget(get_model(cfg), TRAIN_BATCH, TRAIN_SEQ,
                                     mb)
        if budget["total"] <= TRAIN_MEMORY_LIMIT_GB or layers <= unit:
            break
        layers -= unit
    if layers == full.num_layers:
        return full, None, budget
    whole = train_memory_budget(get_model(full), TRAIN_BATCH, TRAIN_SEQ, mb)
    return cfg, {"num_layers": [full.num_layers, layers], "why": (
        f"{full.num_layers} layers reckon {whole['total']:.1f} GB to train; "
        f"{layers} reckon {budget['total']:.1f}, the most whole "
        f"{'groups' if unit > 1 else 'layers'} within "
        f"{TRAIN_MEMORY_LIMIT_GB:.0f}")}, budget


def train_expect(cfg, microbatches=1):
    """The launches one train step of ``cfg`` makes, by role, from its
    structure: K3 ``p`` times in the forward over the layers (``+ m``
    over the media or frames: llama's projector, seamless's frontend),
    ``p`` again in the remat recompute (the media's product lies outside
    the rematted units), ``p`` dx (no gradient flows to the media) and
    ``p + m`` dw, ``z`` recomputed z (one a silu or gelu projection); K10
    ``a`` times in each of the forward and the recompute, every launch
    writing m and l; K11 ``k`` times in each; all of it once a
    microbatch.  A block's projections: q, k, v, o and the MLP's two or
    three; qwen3-moe's and grok's experts are batched ``torch.matmul``;
    a zamba2 Mamba2 block has in_proj and out_proj, a shared-block
    invocation its block at width 2 x d_model and shared_out; a seamless
    decoder layer has a cross block's q, k, v and o too."""
    L = cfg.num_layers
    block = 4 + (3 if cfg.mlp_gated else 2)
    zb = int(cfg.act in ("silu", "gelu"))
    media, k11 = 0, 0
    if cfg.family == "ssm":  # rwkv6: 8 projections a layer, K11 once
        p, z, a, k11 = 8 * L, 0, 0, L
    elif cfg.family == "hybrid":
        g = L // cfg.shared_attn_every
        p, z, a = 2 * L + (block + 1) * g, zb * g, g
    elif cfg.family == "audio":
        e = cfg.num_encoder_layers
        p, z, a = block * e + (block + 4) * L, zb * (e + L), e + 2 * L
        media = 1
    elif cfg.family == "vlm":
        p, z, a = block * L, zb * L, L
        media = 1
    elif cfg.moe is not None:
        p, z, a = 4 * L, 0, L
    else:
        p, z, a = block * L, zb * L, L
    mb = microbatches
    return {"K3_forward": (p + media) * mb, "K3_recompute": p * mb,
            "K3_z": z * mb, "K3_dx": p * mb, "K3_dw": (p + media) * mb,
            "K10_forward": a * mb, "K10_backward": a * mb,
            "K10_ml": 2 * a * mb, "K11_forward": k11 * mb,
            "K11_backward": k11 * mb}


def _train_redraw(arch):
    """``TRAIN_REDRAWS``' function for ``arch``, or None."""
    name = TRAIN_REDRAWS.get(arch)
    if name == "rwkv":
        from repro_torch.nn.rwkv import rwkv_redraw
        return rwkv_redraw
    if name == "ssm":
        from repro_torch.nn.ssm import ssm_redraw
        return ssm_redraw
    if name == "vision":
        from repro_torch.models.vision_lm import vision_redraw
        return vision_redraw
    if name == "moe":
        from repro_torch.nn.moe import moe_redraw
        return moe_redraw
    return None


def _train_media(torch, cfg, batch, gen, dev, dtype):
    """Seeded media (frames) of ``batch`` rows for a cross family, as the
    batch entry its forward reads ({} for another family)."""
    if cfg.family not in ("vlm", "audio"):
        return {}
    xa = cfg.cross_attn
    key = "media_embeds" if cfg.family == "vlm" else "frames"
    return {key: torch.randn((batch, xa.num_media_tokens, xa.media_dim),
                             generator=gen, device=dev).to(dtype)}


@contextlib.contextmanager
def optimizer_threads(torch, n):
    """``make_train_step``'s AdamW on ``n`` intra-op threads while inside,
    whatever count the step's forward and backward run on: its updates
    are elementwise (the same bits on any count), its one sum, the grad
    norm's, in the fixed order of ``n`` threads."""
    from repro_torch.train import step as step_mod

    real = step_mod.adamw_update

    def update(*args, **kw):
        inner = torch.get_num_threads()
        torch.set_num_threads(n)
        try:
            return real(*args, **kw)
        finally:
            torch.set_num_threads(inner)

    step_mod.adamw_update = update
    try:
        yield
    finally:
        step_mod.adamw_update = real


def k3_grad_case(torch, gen, dev, kk, n, act, bias, m, peaks):
    """K3's Function at M = ``m`` rows: forward and backward
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
    """K10 with m and l at a training shape (``K10_TRAIN_CASES``: causal or
    not, keys other than the queries): the launch's out equal bit for
    bit to the launch without them, m and l against the plain version's
    within fp32's ``LM_KERNEL_TOL``; the Function's gradients (the plain
    backward over ``attn_chunk`` pairs) against autograd through the plain
    version on the card (``K10_GRAD_TOL``); timed: the launch with and
    without m and l, forward + backward, the plain backward alone, and
    the library's flash attention with its logsumexp (the same function
    where no softcap is set and the window does not bite).  Returns the
    record."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    bsz, s, skv, h, kvh, hd, causal, window, cap = case
    skv = s if skv is None else skv
    q = torch.randn((bsz, s, h, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((bsz, skv, kvh, hd), generator=gen, device=dev
                    ).bfloat16()
    v = torch.randn((bsz, skv, kvh, hd), generator=gen, device=dev
                    ).bfloat16()
    do = torch.randn((bsz, s, h, hd), generator=gen, device=dev).bfloat16()
    scale = 1.0 / hd ** 0.5
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    label = (f"K10 grad b={bsz} s={s} keys={skv} causal={causal} "
             f"window={window} cap={cap} h={h}/{kvh} hd={hd}")
    ml_before = attn_ops.flash_attention.ml_launches
    out_ml, m, l = attn_ops._launch(q, k, v, causal, window, cap, scale,
                                    ml=True)
    out = attn_ops._launch(q, k, v, causal, window, cap, scale)
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
    out_ml, m, l = attn_ops._launch(q, k, v, causal, window, cap, scale,
                                    ml=True)
    bwd = lambda: attn_ops.flash_attention_bwd(  # noqa: E731
        q, k, v, out_ml, m, l, do, scale=scale, chunk=512, **kw)
    # the library's flash attention with its logsumexp, with the causal
    # mask or none, no softcap or window: a yardstick only (the kv heads
    # repeated outside the timed call, as its kernel takes one kv head a
    # query head); the same function where no cap is set and the window
    # does not bite
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(h // kvh, dim=2).transpose(1, 2)
              for t in (k, v))
    library = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
        qt, kt, vt, 0.0, causal, False, scale=scale)
    same = not cap and (window <= 0 or window >= s)
    try:
        library_ms, library_note = time_ms(torch, library), (
            "aten._scaled_dot_product_flash_attention, "
            + ("causal" if causal else "no mask") + ", with its logsumexp"
            + (": the same function" if same
               else ", no softcap or window: not the same function"))
    except RuntimeError as e:  # a backend that refuses the shape
        library_ms, library_note = None, f"refused: {e}"
    del qt, kt, vt
    flops = 4.0 * _visible_pairs(s, window, causal, skv) * h * hd * bsz
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 8.0 * bsz * h * s
    bf16_peak, bw_peak = peaks[2], peaks[1]
    rec = {"kernel": "K10-grad", "batch": bsz, "tokens": s, "keys": skv,
           "causal": causal, "heads": h, "kv_heads": kvh, "head_dim": hd,
           "window": window, "cap": cap,
           "m_max_abs_err": m_err, "l_max_abs_err": l_err,
           "max_abs_err": errs, "tol": {"m_l": LM_KERNEL_TOL["float32"],
                                        "grad": K10_GRAD_TOL},
           "ms": time_ms(torch, lambda: attn_ops._launch(
               q, k, v, causal, window, cap, scale)),
           "ml_ms": time_ms(torch, lambda: attn_ops._launch(
               q, k, v, causal, window, cap, scale, ml=True)),
           "plain_backward_ms": time_ms(torch, bwd, reps=5),
           "fwd_bwd_ms": time_ms(torch, lambda: grads(kernel), reps=5),
           "plain_fwd_bwd_ms": time_ms(torch, lambda: grads(plain), reps=3),
           "library_ms": library_ms, "library_note": library_note,
           "bound_ms": 1e3 * max(flops / bf16_peak, nbytes / bw_peak),
           "bound_by": "operations" if flops / bf16_peak > nbytes / bw_peak
           else "bytes", "flops": flops, "bytes": nbytes}
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


#: the prime of ``bits_fingerprint``'s forms, and the seed of their
#: multipliers
FINGERPRINT_PRIME = 2 ** 31 - 1
FINGERPRINT_SEED = 1234


def bits_fingerprint(torch, t, chunk=1 << 26):
    """Two fingerprints of ``t``'s bits, computed on its device: each
    element's bit pattern as an integer b_i, and the forms sum_i r_i b_i
    mod p (p = ``FINGERPRINT_PRIME``), two of them, with multipliers r_i
    drawn uniformly from [1, p) from ``FINGERPRINT_SEED`` chunk by chunk.
    Two tensors of different bits share both with probability about
    p^-2, 2^-62 (the forms are exact integer arithmetic: no product or
    chunk sum passes 2^62).  The phase compares a train step's state
    taken twice by them, where a copy of every parameter and moment would
    cost 12 bytes a parameter of memory or minutes of copies."""
    ints = t.detach().reshape(-1).view(
        {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])
    gen = torch.Generator(device=t.device)
    out = []
    for form in range(2):
        total = 0
        for i, start in enumerate(range(0, ints.numel(), chunk)):
            part = ints[start:start + chunk].long().remainder(
                FINGERPRINT_PRIME)
            gen.manual_seed(FINGERPRINT_SEED + 1_000_003 * form + i)
            r = torch.randint(1, FINGERPRINT_PRIME, part.shape,
                              generator=gen, device=t.device)
            total += int((part * r).remainder(FINGERPRINT_PRIME).sum())
        out.append(total % FINGERPRINT_PRIME)
    return tuple(out)


def _train_batch(torch, lm, rng, dev, b, s):
    tokens = torch.from_numpy(lm.sample(rng, b, s)).long().to(dev)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous()}


def train_parity(torch, np, dev, arch):
    """One fp32 train step of ``arch`` cut to one unit
    (``TRAIN_PARITY_CUTS``; the cross families' media cut to
    ``CROSS_PARITY_MEDIA``) at full width, with its microbatches, on the
    card and on the CPU from the same weights (``TRAIN_REDRAWS``' redraw
    applied), batch and media: the loss, the metrics, every gradient
    leaf, every moment and every updated parameter
    (``TRAIN_PARITY_TOL``).  The CPU side's forward and backward run on
    one intra-op thread (one fixed summation order, ROADMAP F3), its
    AdamW on the machine's threads (``optimizer_threads``: on one thread
    the updates of the full vocab's embeddings took most of the phase).
    Returns the record, with each side's seconds."""
    import dataclasses

    from repro_torch.core.config import TrainConfig, get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree, tree_leaves, tree_map
    from repro_torch.train.data import MarkovLM
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    full = get_arch(arch)
    cut = dict(TRAIN_PARITY_CUTS[arch])
    if full.family in ("vlm", "audio"):
        cut["cross_attn"] = dataclasses.replace(
            full.cross_attn, num_media_tokens=CROSS_PARITY_MEDIA,
            interval=min(full.cross_attn.interval, 2))
    cfg = dataclasses.replace(full, **cut, dtype="float32",
                              param_dtype="float32")
    mb = TRAIN_MICROBATCHES.get(arch, 1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trees = {"gpu": init_tree(get_model(cfg).param_spec(), gen, "float32")}
    redraw = _train_redraw(arch)
    if redraw is not None:
        redraw(trees["gpu"], gen)
    trees["cpu"] = tree_map(lambda t: t.detach().cpu().clone(), trees["gpu"])
    batch = _train_batch(torch, MarkovLM(TRAIN_VOCAB, seed=SEED),
                         np.random.default_rng(SEED), "cpu", TRAIN_BATCH,
                         TRAIN_PARITY_SEQ)
    batch.update(_train_media(torch, cfg, TRAIN_BATCH,
                              torch.Generator().manual_seed(SEED), "cpu",
                              torch.float32))
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    out, grads, seconds = {}, {}, {}
    threads = torch.get_num_threads()
    for side in ("gpu", "cpu"):
        t = time.perf_counter()
        model = get_model(cfg).load_tree(trees[side])
        step = make_train_step(model, tcfg, microbatches=mb)
        with one_thread(torch), optimizer_threads(torch, threads):
            out[side] = step(trees[side], adamw_init(trees[side]),
                             {k: t.to(model.device) for k, t in
                              batch.items()})
        grads[side] = step.grads
        torch.cuda.synchronize()
        seconds[side] = time.perf_counter() - t
    # the comparisons on the card, the CPU's leaves brought over one at a
    # time (on the CPU their passes over the embeddings took longer than
    # the step)
    t_check = time.perf_counter()
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
            b = b.to(a.device)
            worst[name] = max(worst[name], _check_close(
                f"{label} {name}", a, b,
                TRAIN_PARITY_TOL * max(1.0, b.abs().max().item())))
    lr = cm["lr"].item()
    worst["param"], flips = 0.0, 0
    for a, b, mom in zip(tree_leaves(gp), tree_leaves(cp),
                         tree_leaves(cs["m"])):
        b, mom = b.to(a.device), mom.to(a.device)
        err = (a - b).abs()
        tiny = mom.abs() <= 1e-3 * max(mom.abs().max().item(), 1e-30)
        lim = torch.where(tiny, torch.full_like(b, 2.02 * lr + 1e-6),
                          1e-6 * b.abs().clamp_min(1.0) + 1e-3 * lr)
        if not bool((err <= lim).all()):
            fail(f"{label}: an updated parameter off by "
                 f"{(err - lim).max().item()} past its limit")
        worst["param"] = max(worst["param"], err.max().item())
        flips += int((tiny & (err > 1e-3 * lr)).sum())
    seconds["check"] = time.perf_counter() - t_check
    rec = {"arch": arch, "cut": {k: v for k, v in cut.items()
                                 if k != "cross_attn"},
           "layers": cfg.num_layers, "batch": TRAIN_BATCH,
           "tokens": TRAIN_PARITY_SEQ, "microbatches": mb,
           "media": (cfg.cross_attn.num_media_tokens
                     if cfg.family in ("vlm", "audio") else None),
           "params": sum(t.numel() for t in tree_leaves(cp)),
           "cpu_threads": {"step": 1, "optimizer": threads},
           "loss": cm["loss"].item(), "max_abs_err": worst,
           "tiny_gradient_flips": flips, "tol": TRAIN_PARITY_TOL,
           "seconds": seconds}
    print(f"{label} " + json.dumps(rec), flush=True)
    return rec


def train_full(torch, np, dev, counters, card, arch):
    """``TRAIN_STEPS`` AdamW steps of ``arch`` at full width in bf16
    through ``make_train_step``, its depth cut only as ``train_cut``
    says (printed as ``reduced``), with its microbatches, on
    ``MarkovLM(TRAIN_VOCAB)`` batches of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    (the cross families with seeded bf16 media or frames), weights drawn
    on the card from ``SEED`` (``TRAIN_REDRAWS``' redraw applied).  The
    first step is taken twice from the same state (the determinism check:
    the same loss, CE and grad norm bit for bit, and every parameter's
    and moment's bits the same by ``bits_fingerprint``, or the leaves that
    differ named; the state drawn again from the seed for the second
    run), with the launches counted by role against
    ``train_expect``: K3's (the forward, the remat recompute, the
    backward's z, dx, dw: all on the wgmma path) and K10's and K11's, the
    forward's and the backward's.  The CE must be finite and fall from
    the first step to the last, one more step is profiled, and the peak
    memory must stay within ``train_memory_budget``'s total.  Returns the
    record."""
    import math

    from repro_torch.core.config import TrainConfig
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.models.registry import get_model
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn import ssm as ssm_mod
    from repro_torch.nn.param import DTYPES, init_tree, tree_leaves
    from repro_torch.train import step as step_mod
    from repro_torch.train.data import MarkovLM
    from repro_torch.train.optimizer import adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, reduced, budget = train_cut(arch)
    mb = TRAIN_MICROBATCHES.get(arch, 1)
    expect = train_expect(cfg, mb)
    label = f"{arch} train"
    print(f"{label}: {cfg.num_layers} layers, reduced "
          f"{json.dumps(reduced)}, microbatches {mb}, reckoned peak "
          f"{ {k: round(v, 2) for k, v in budget.items()} } GB", flush=True)
    model = get_model(cfg)
    redraw = _train_redraw(arch)

    def draw(gen):
        tree = init_tree(model.param_spec(), gen, cfg.param_dtype)
        if redraw is not None:
            redraw(tree, gen)
        return tree

    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = draw(gen)
    model.load_tree(tree)
    opt = adamw_init(tree)
    media = _train_media(torch, cfg, TRAIN_BATCH, gen, dev,
                         DTYPES[cfg.param_dtype])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(tree))
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS + 1)
    step_fn = step_mod.make_train_step(model, tcfg, microbatches=mb)
    lm, rng = MarkovLM(TRAIN_VOCAB, seed=SEED), np.random.default_rng(SEED)
    batches = [{**_train_batch(torch, lm, rng, dev, TRAIN_BATCH, TRAIN_SEQ),
                **media} for _ in range(TRAIN_STEPS + 1)]
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

    def fingerprints():
        return {part: [bits_fingerprint(torch, t) for t in tree_leaves(v)]
                for part, v in (("params", tree), ("m", opt["m"]),
                                ("v", opt["v"]))}

    # the first step, twice from the same state, counted: the launches
    # inside the model's forward calls (one a microbatch) by hooks, the
    # rest in the backward (the remat recompute among them)
    t_det = time.perf_counter()
    in_forward = {"K3": dict.fromkeys(k3.role_launches, 0), "K10": 0,
                  "K11": 0}
    entered = {}

    def pre_hook(*_):
        entered.update(counts())

    def post_hook(*_):
        now = counts()
        for role in in_forward["K3"]:
            in_forward["K3"][role] += now["K3"][role] - entered["K3"][role]
        for kid in ("K10", "K11"):
            in_forward[kid] += now[kid] - entered[kid]

    hooks = [model.register_forward_pre_hook(pre_hook),
             model.register_forward_hook(post_hook)]
    zero()
    first, first_ms = timed_step(batches[0])
    for h in hooks:
        h.remove()
    total = counts()
    after_first = fingerprints()
    # the same state again: the same draws from a fresh generator
    start = draw(torch.Generator(device=dev).manual_seed(SEED))
    for t, s in zip(tree_leaves(tree), tree_leaves(start)):
        t.copy_(s)
    del start
    for t in tree_leaves(opt):
        t.zero_()
    again, _ = timed_step(batches[0])
    keys = []

    def walk(t, path):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], path + (key,))
        else:
            keys.append("/".join(path))

    walk(tree, ())
    after_again = fingerprints()
    differ = [f"{part}:{keys[i]}" for part, fps in after_again.items()
              for i, (a, b) in enumerate(zip(fps, after_first[part]))
              if a != b]
    same = {k: bool(torch.equal(first[k], again[k]))
            for k in ("loss", "ce", "grad_norm")}
    determinism = {"deterministic": not differ and all(same.values()),
                   "metrics_equal": same, "differing_leaves": differ,
                   "compared": {k: len(v) for k, v in after_first.items()},
                   "by": "bits_fingerprint",
                   "seconds": time.perf_counter() - t_det}
    if not determinism["deterministic"]:
        fail(f"{label}: the first step taken twice differs: {same}, "
             f"leaves {differ[:20]}")
    # the launches a step: the forward's by the hooks, the backward's after
    fwd = in_forward
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
    for i in range(1, TRAIN_STEPS):
        m, ms = timed_step(batches[i])
        steps.append({"step": i + 1, "ce": m["ce"].item(),
                      "grad_norm": m["grad_norm"].item(), "ms": ms})
        print(f"{label} step {i + 1}: ce {steps[-1]['ce']:.4f}, grad norm "
              f"{steps[-1]['grad_norm']:.4f}, {ms:.1f} ms", flush=True)
    med = statistics.median(s["ms"] for s in steps[1:])
    # one more step under the profiler (its wall time carries the
    # profiler's cost, so the median above leaves it out)
    t_prof = time.perf_counter()
    ranges = (("k10 plain backward", attn_ops, "flash_attention_bwd"),
              ("k11 plain backward", wkv6_ops, "wkv6_bwd"),
              ("ssd scan", ssm_mod, "_ssd_chunked"),
              ("moe experts", moe_mod, "experts"),
              ("adamw", step_mod, "adamw_update"))
    last = {}
    profile = profile_windows(
        torch, label, {"step": lambda: last.update(
            m=step_fn(tree, opt, batches[TRAIN_STEPS])[2])},
        card, ranges)
    steps.append({"step": TRAIN_STEPS + 1, "ce": last["m"]["ce"].item(),
                  "grad_norm": last["m"]["grad_norm"].item(),
                  "ms": profile["step"]["wall_ms"], "profiled": True})
    profile_s = time.perf_counter() - t_prof
    ces = [s["ce"] for s in steps]
    if not all(math.isfinite(c) for c in ces) or not ces[-1] < ces[0]:
        fail(f"{label}: CE {ces} is not finite and falling")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"arch": arch, "layers": cfg.num_layers, "reduced": reduced,
           "params": n_params, "init_s": init_s, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": mb, "lr": TRAIN_LR,
           "warmup": TRAIN_WARMUP, "corpus_vocab": TRAIN_VOCAB,
           "corpus_entropy": lm.entropy(), "media": {
               k: list(v.shape) for k, v in media.items()},
           "steps": steps, "step_ms_median": med,
           "tokens_per_s": TRAIN_ROWS / med * 1e3,
           "launches": got, "k3_paths": total["K3_paths"],
           "determinism": determinism, "peak_memory_gb": peak,
           "reckoned_gb": budget, "profile_s": profile_s,
           "profile": profile, "card": card}
    rec["phase_s"] = time.perf_counter() - t0
    print(f"{label}: " + json.dumps({k: v for k, v in rec.items()
                                     if k != "profile"}), flush=True)
    print(f"{label}: {n_params / 1e9:.3f} G parameters, {cfg.num_layers} "
          f"layers (reduced {json.dumps(reduced)}), CE {ces[0]:.4f} -> "
          f"{ces[-1]:.4f}, step {med:.1f} ms median of steps 2-"
          f"{TRAIN_STEPS} ({rec['tokens_per_s']:.0f} tokens/s), peak "
          f"memory {peak:.2f} GB (reckoned {budget['total']:.2f}), "
          f"deterministic {determinism['deterministic']}, wall time "
          f"{rec['phase_s']:.1f} s (determinism "
          f"{determinism['seconds']:.1f}, profile {profile_s:.1f}) "
          f"[{card}]", flush=True)
    if not peak <= budget["total"]:
        fail(f"{label}: peak memory {peak:.2f} GB past its reckoning "
             f"{budget['total']:.2f}")
    del model, tree, opt, step_fn, batches, media
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_launcher_phase(torch, counters):
    """Phase 13d: ``repro_torch.launch.train.main`` on the card (its
    default device) for the reduced qwen3-moe-30b-a3b, 3 steps at
    ``microbatches=2``, the JAX launcher's counterpart: its CE history,
    finite and falling, and the launches of the run (K3 and K10 every
    step).  Returns the record."""
    import math

    from repro_torch.launch.train import main as train_main

    arch = "qwen3-moe-30b-a3b"
    for fn in counters.values():
        fn.launches = 0
    t = time.perf_counter()
    out = train_main(["--arch", arch, "--reduced", "--steps", "3",
                      "--microbatches", "2", "--log-every", "1"])
    torch.cuda.synchronize()
    ces = [ce for _, ce in out["history"]]
    rec = {"arch": arch, "reduced": True, "steps": 3, "microbatches": 2,
           "history": out["history"], "seconds": time.perf_counter() - t,
           "launches": {k: counters[k].launches for k in ("K3", "K10")}}
    print("train launcher " + json.dumps(rec), flush=True)
    if ([s for s, _ in out["history"]] != [1, 2, 3]
            or not all(math.isfinite(c) for c in ces) or not ces[-1] < ces[0]):
        fail(f"{arch} train launcher: CE history {out['history']} is not "
             f"finite and falling")
    if not (counters["K3"].launches and counters["K10"].launches):
        fail(f"{arch} train launcher: launches {rec['launches']}")
    return rec


def train_phase(torch, np, dev, peaks, counters, card):
    """Phase 13 (see the module docstring); returns (cases, parity
    records, full-width records, the launcher's record)."""
    t13 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [k3_grad_case(torch, gen, dev, kk, n, act, bias, m, peaks)
             for kk, n, act, bias, m in K3_TRAIN_SHAPES]
    gc.collect()
    torch.cuda.empty_cache()
    cases += [k10_grad_case(torch, gen, dev, c, peaks)
              for c in K10_TRAIN_CASES]
    cases.append(k11_grad_case(torch, gen, dev))
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    parity = {}
    for arch in TRAIN_PARITY_ARCHS:
        parity[arch] = train_parity(torch, np, dev, arch)
        gc.collect()
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    full = {arch: train_full(torch, np, dev, counters, card, arch)
            for arch in TRAIN_ARCHS}
    t_d = time.perf_counter()
    launcher = train_launcher_phase(torch, counters)
    t_end = time.perf_counter()
    print(f"phase 13 wall time {t_end - t13:.1f} s (cases "
          f"{t_b - t13:.1f}, CPU parity {t_c - t_b:.1f}, full width "
          f"{t_d - t_c:.1f}: "
          + ", ".join(f"{a} {r['phase_s']:.1f}" for a, r in full.items())
          + f"; launcher {t_end - t_d:.1f})", flush=True)
    return cases, parity, full, launcher



#: phase 15: the last four registered language models at full width
DENSE_ARCHS = ("starcoder2-15b", "internlm2-20b", "qwen1.5-32b",
               "grok-1-314b")
#: the served models' depth cuts, the only cuts of the phase (layers, why);
#: width, heads, experts and vocab stay as published
DENSE_CUTS = {
    "qwen1.5-32b": (32, "64 layers: 70.4 GB of bf16 weights, no room for "
                        "the 42.9-GB cache of 4 x 8192 rows; 32 layers: "
                        "36.7 GB of weights, 21.5 GB of cache"),
    "grok-1-314b": (4, "64 layers: 633 GB; a layer is 9.84 GB (8 experts "
                       "of d_ff 32768): 4 layers, 39.4 GB, and 3.2 GB of "
                       "embeddings fit one card"),
}
#: 15b's cuts below 7b's two layers and ``LM_PARITY_DECODE`` greedy
#: tokens (layers, tokens, why): grok's CPU side reads 19.3 GB of fp32
#: experts a layer in the prefill and in every decode step, on one thread:
#: two layers took 109-158 s, one layer's 8 tokens 46-63 s on an H100 at
#: 700 W's host, and the whole smoke ran past its 1200 s once
DENSE_PARITY_CUTS = {
    "grok-1-314b": (1, 3, "the CPU side reads 19.3 GB of fp32 experts a "
                          "layer a pass on one thread: two layers took "
                          "109-158 s, one layer's 8 tokens 46-63 s"),
}
#: K3's distinct projections (K, N, activation, bias) in each arch's block;
#: a shape an earlier arch of the phase ran is not run again
K3_DENSE_SHAPES = {
    "starcoder2-15b": ((6144, 6144, "none", True),     # q
                       (6144, 512, "none", True),      # k, v
                       (6144, 6144, "none", False),    # o
                       (6144, 24576, "gelu", True),    # up: one K slice
                       (24576, 6144, "none", True)),   # down
    "internlm2-20b": ((6144, 6144, "none", False),     # q, o
                      (6144, 1024, "none", False),     # k, v
                      (6144, 16384, "silu", False),    # gate, up
                      (16384, 6144, "none", False)),   # down
    "qwen1.5-32b": ((5120, 5120, "none", True),        # q, k, v
                    (5120, 5120, "none", False),       # o
                    (5120, 27392, "silu", False),      # gate, up: one slice
                    (27392, 5120, "none", False)),     # down
    "grok-1-314b": ((6144, 6144, "none", False),       # q, o
                    (6144, 1024, "none", False)),      # k, v
}
#: K10 at each arch's attention (``K10_CASES``' order) at the two longest
#: prompts; starcoder2's window, new at head_dim 128, at all four
K10_DENSE_CASES = {
    "starcoder2-15b": tuple((s, 4096, 0.0, "bfloat16", 48, 4, 128, True)
                            for s in LM_PROMPTS),
    "internlm2-20b": tuple((s, 0, 0.0, "bfloat16", 48, 8, 128, True)
                           for s in (1500, 4500)),
    "qwen1.5-32b": tuple((s, 0, 0.0, "bfloat16", 40, 40, 128, True)
                         for s in (1500, 4500)),
    "grok-1-314b": tuple((s, 0, 30.0, "bfloat16", 48, 8, 128, True)
                         for s in (1500, 4500)),
}
#: K3 launches a layer in a prefill and in a decode step: q, k, v, o and
#: the MLP's (starcoder2: up and down; grok: none, its experts are
#: batched torch.matmul)
K3_DENSE_PER_LAYER = {"starcoder2-15b": 6, "internlm2-20b": 7,
                      "qwen1.5-32b": 7, "grok-1-314b": 4}


def dense_kernel_cases(torch, F, dev, peaks, arch, done):
    """Phase 15a: K3 (bf16) at ``arch``'s projection shapes over
    ``K3_LM_ROWS`` (those not in ``done``, which it extends) and K10 at
    its attention, as 9a; a stream case's line carries its ``split_k``.
    Returns the records."""
    from repro_torch.kernels.matmul_fused.ops import TILED_MIN_M, split_k

    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [k10_case(torch, F, gen, dev, case, peaks)
            for case in K10_DENSE_CASES[arch]]
    for kk, n, act, bias in K3_DENSE_SHAPES[arch]:
        if (kk, n, act, bias) in done:
            continue
        done.add((kk, n, act, bias))
        splits = split_k(torch.bfloat16, kk, n, sms)
        for m in K3_LM_ROWS:
            extra = {"split_k": list(splits)} if m < TILED_MIN_M else {}
            rows.append(k3_bf16_case(torch, F, gen, dev, m, kk, n, act,
                                     peaks, False, bias=bias, **extra))
    for r in rows:
        r["arch"] = arch
    one = sorted({(r["k"], r["n"]) for r in rows
                  if r.get("split_k", [0])[0] == 1})
    print(f"{arch} K3 stream with one K slice (split_k (1, K), no cluster "
          f"reduction) at {one}", flush=True)
    return rows


def dense_bounds(model, peaks, tokens=max(LM_PROMPTS)):
    """The served model's bounds in ms: a decode step reads every weight
    once (``decode_weight_read``); a ``tokens``-token prefill's
    projections, every weight but the embedding and head once a token
    (an MoE model's experts at k of E: ``prefill_projections``; at the
    prefill's capacity, ``cap`` rows an expert: ``prefill_at_capacity``),
    at the bf16 peak."""
    import math

    cfg = model.cfg
    _, bw_peak, bf16_peak = peaks
    params = dict(model.named_parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.values())
    embed = sum(p.numel() for n, p in params.items()
                if n.startswith("embed"))
    expert = sum(p.numel() for n, p in params.items()
                 if n.split(".")[-1].startswith("we_"))
    dense = sum(p.numel() for p in params.values()) - embed - expert
    rec = {"decode_weight_read": 1e3 * weight_bytes / bw_peak}
    active = expert
    if cfg.moe is not None:
        k, E = cfg.moe.num_experts_per_token, cfg.moe.num_experts
        active = expert * k / E
        cap = min(math.ceil(tokens * k * cfg.moe.eval_capacity_factor / E),
                  tokens * k)
        rec["prefill_at_capacity"] = 1e3 * 2.0 * (
            tokens * dense + cap * expert) / bf16_peak
    rec["prefill_projections"] = 1e3 * 2.0 * tokens * (dense + active) \
        / bf16_peak
    return rec


def dense_phase(torch, F, np, dev, peaks, counters, card):
    """Phase 15 (see the module docstring): for each of ``DENSE_ARCHS``,
    one after another, its kernel cases, its CPU parity (grok's routing
    recorded), the served model (``DENSE_CUTS`` its only cuts) and its
    profile, each model freed before the next; returns (cases, parity
    records, serving records)."""
    from repro_torch.core.config import get_arch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models import common as lm_common
    from repro_torch.nn import moe as moe_mod

    t15 = time.perf_counter()
    cases, parity, served, done = [], {}, {}, set()
    for arch in DENSE_ARCHS:
        t = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cases += dense_kernel_cases(torch, F, dev, peaks, arch, done)
        t_b = time.perf_counter()
        moe = get_arch(arch).moe is not None
        routing = []
        with (record_routing(torch, routing) if moe
              else contextlib.nullcontext()):
            cut, tokens, why = DENSE_PARITY_CUTS.get(
                arch, (2, LM_PARITY_DECODE, None))
            par = lm_parity_phase(torch, np, dev, attn_ops.flash_attention,
                                  arch, cut={"num_layers": cut},
                                  decode=tokens)
        par["reduced"] = ({"num_layers": cut, "tokens": tokens, "why": why}
                          if why else None)
        if moe:
            par["routing"] = check_routing(routing, arch)
        if par["paths"] != {"simt": par["layers"], "wgmma": 0}:
            fail(f"{arch} parity: the fp32 prefill took K10's paths "
                 f"{par['paths']}, not the CUDA-core kernel alone")
        parity[arch] = par
        gc.collect()
        torch.cuda.empty_cache()
        t_c = time.perf_counter()
        layers, why = DENSE_CUTS.get(arch, (None, None))
        model, init_s = build_model(torch, arch, dev, layers=layers)
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        n = model.cfg.num_layers
        k3 = K3_DENSE_PER_LAYER[arch] * n
        rec = lm_serving_phase(
            torch, np, dev, counters, card, model, init_s,
            {"prefill": {"K3": k3, "K10": n, "K11": 0},
             "decode": {"K3": k3, "K10": 0, "K11": 0}})
        if rec["k10_paths"] != {"simt": 0, "wgmma": rec["launches"]["K10"]}:
            fail(f"{arch} serving: K10's prefill launches took the paths "
                 f"{rec['k10_paths']}, not the wgmma path alone")
        rec["layers"] = n
        rec["reduced"] = ({"num_layers": [get_arch(arch).num_layers, n],
                           "why": why} if layers else None)
        rec["init_peak_memory_gb"] = init_peak
        rec["budget_gb"] = memory_budget(model)
        rec["bounds_ms"] = dense_bounds(model, peaks)
        rec["profile"] = lm_profile(
            torch, model, card,
            (("moe block", lm_common, "moe_apply"),
             ("moe routing", moe_mod, "route"),
             ("moe experts", moe_mod, "experts")) if moe else ())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t_end = time.perf_counter()
        rec["phase_s"] = t_end - t
        rec["phase_split_s"] = {"cases": t_b - t, "parity": t_c - t_b,
                                "served": t_end - t_c}
        rec["phase_peak_memory_gb"] = max(
            init_peak, torch.cuda.max_memory_allocated() / 1e9)
        served[arch] = rec
        print("dense " + json.dumps({k: v for k, v in rec.items()
                                     if k != "runs"}), flush=True)
        bounds = {k: round(v, 2) for k, v in rec["bounds_ms"].items()}
        print(f"phase 15 {arch}: wall time {rec['phase_s']:.1f} s (cases "
              f"{t_b - t:.1f}, parity {t_c - t_b:.1f}, served "
              f"{t_end - t_c:.1f}), {n} layers, reduced "
              f"{json.dumps(rec['reduced'])}, peak memory "
              f"{rec['phase_peak_memory_gb']:.2f} GB (init "
              f"{init_peak:.2f}, serving {rec['peak_memory_gb']:.2f}; "
              f"budget { {k: round(v, 2) for k, v in rec['budget_gb'].items()} }"
              f"), bounds ms {bounds} [{card}]", flush=True)
        if not rec["phase_peak_memory_gb"] < 80.0:
            fail(f"{arch}: peak memory {rec['phase_peak_memory_gb']:.2f} GB")
    print(f"phase 15 wall time {time.perf_counter() - t15:.1f} s",
          flush=True)
    return cases, parity, served


#: phase 16: qwen1.5-32b tensor parallel over a process group
TP_ARCH = "qwen1.5-32b"
#: the tensor-parallel ways whose shard shapes 16a runs
TP_WAYS = (2, 4, 8)
#: 16a's rows: a decode step at 4 slots and the longest prompt
TP_K3_ROWS = (4, 4500)
TP_K10_TOKENS = (1500, 4500)
#: 16b's depth on the 1 x 1 NCCL mesh and 16c's on two ranks (layers);
#: the width, heads and vocab stay as published
TP_CUTS = {"1x1": (8, "the 1 x 1 mesh is the unsharded model's bits: 8 "
                      "layers show it"),
           "1x2": (4, "two ranks share one 80-GB card, the unsharded "
                      "reference run first; 4 layers (16 before phase 18 "
                      "joined the smoke, 8 before phase 20: its time)")}
#: 16c's fp32 parity: one layer, a prompt of LM_PARITY_PROMPT tokens and
#: LM_PARITY_DECODE greedy tokens
TP_PARITY_LAYERS = 1
TP_DECODE = 8
#: the ranks' processes may take this long (s) before the phase fails
TP_RANK_TIMEOUT = 600
#: 16c's bf16 logits against the unsharded reference, relative to
#: max(1, max|reference|): the model-level bf16 limit of the CPU tests
#: (tests/test_torch_lm.py's TOL).  The ranks' products sum in other
#: orders (the row-parallel partials, the weight stream's K slices, a
#: function of N), so other elements round apart in bf16 in every layer;
#: at 16 layers the first run on the card measured 0.078 on logits of
#: largest magnitude 5.1 (1.5 %), past ``LM_KERNEL_TOL``'s 2^-7, a
#: single kernel's limit.  The fp32 parity holds the algorithm to
#: ``LM_TOL``.
TP_BF16_TOL = 2.0 ** -4
#: K3's fp32 store against its plain version, element by element:
#: |kernel - plain| <= rtol * |plain| + atol.  Both sides sum fp32 in
#: another order (the tensor cores' own additions truncate, F7); the
#: partial is rounded to bf16 once after the ranks' sum, so it must stay
#: well inside one bf16 rounding (2^-9 of |y|)
K3_F32_STORE_TOL = (2.0 ** -12, 2.0 ** -14)
#: 16d: the dry run's rows, at 4 slots x 8192 rows
TP_DRYRUN_ARCHS = ("qwen1.5-32b", "starcoder2-15b", "grok-1-314b")
TP_DRYRUN_MESHES = ("1x4", "1x8")


def tp_k3_shapes(ways):
    """qwen1.5-32b's projections on a ``ways``-way shard (role, K, N,
    activation, bias, fp32 store): q/k/v with their biases and gate/up
    column-parallel, o and down row-parallel, stored in fp32."""
    d, f = 5120, 27392
    return (("qkv", d, d // ways, "none", True, False),
            ("gate_up", d, f // ways, "silu", False, False),
            ("o", d // ways, d, "none", False, True),
            ("down", f // ways, d, "none", False, True))


def tp_kernel_cases(torch, F, dev, peaks):
    """Phase 16a: K3 at every shard shape of ``tp_k3_shapes`` for
    ``TP_WAYS`` at ``TP_K3_ROWS`` (o and down on the fp32 store) and K10
    at 40 / ways heads over as many kv heads, head_dim 128, causal, at
    ``TP_K10_TOKENS``; returns the records (``main``: the 2-way shapes of
    the executed 1 x 2 mesh)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for ways in TP_WAYS:
        for role, kk, n, act, bias, f32 in tp_k3_shapes(ways):
            for m in TP_K3_ROWS:
                rows.append(k3_bf16_case(
                    torch, F, gen, dev, m, kk, n, act, peaks, ways == 2,
                    bias=bias, out_dtype=torch.float32 if f32 else None,
                    ways=ways, role=role))
        h = 40 // ways
        for s in TP_K10_TOKENS:
            r = k10_case(torch, F, gen, dev,
                         (s, 0, 0.0, "bfloat16", h, h, 128, True), peaks)
            r.update(ways=ways, main=ways == 2 and s == max(TP_K10_TOKENS))
            rows.append(r)
    return rows


def tp_prompts(np, vocab):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, (1, s)) for s in LM_PROMPTS]


def tp_serve(torch, prefill, decode, cache, prompts, steps, counters=None,
             forced=None, snapshot=False):
    """Each prompt prefilled into its slot of ``cache`` (one request a
    call, the slot's views), then ``steps`` decode steps of every slot:
    the greedy tokens, or ``forced`` ([slots, steps + 1], the reference's
    tokens).  ``counters`` (K3, K10 wrappers): set to 0 before each call
    and read after.  Returns the prefills' last-position logits [slots,
    V], each step's [steps, slots, V], the tokens [slots, steps + 1], the
    first step's inputs, each call's launches and times (ms); with
    ``snapshot`` also a copy of the cache before the first step (a ring
    buffer's later writes fall inside the first step's window)."""
    from repro_torch.models.common import cache_slot
    from repro_torch.nn.param import tree_leaves, tree_map

    dev = tree_leaves(cache)[0].device
    last, launches, ms = [], {"prefill": [], "decode": []}, \
        {"prefill": [], "decode": []}

    k3_paths, k10_paths = {}, {}

    def timed(kind, fn):
        for c in (counters or {}).values():
            c.launches = 0
            for p in getattr(c, "path_launches", {}):
                c.path_launches[p] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[kind].append(1e3 * (time.perf_counter() - t))
        launches[kind].append({k: c.launches
                               for k, c in (counters or {}).items()})
        for kid, paths in (("K3", k3_paths), ("K10", k10_paths)):
            if counters and kid in counters:
                for p, n in counters[kid].path_launches.items():
                    paths[p] = paths.get(p, 0) + n
        return out

    with torch.no_grad():
        for i, p in enumerate(prompts):
            tok = torch.from_numpy(p).to(dev)
            lg = timed("prefill", lambda: prefill({"tokens": tok},
                                                  cache_slot(cache, i))[0])
            last.append(lg[0, -1].float())
            del lg
        last = torch.stack(last)
        nxt = last.argmax(-1) if forced is None else forced[:, 0].to(dev)
        pos = torch.tensor([p.shape[1] for p in prompts], device=dev)
        toks, outs, first = [nxt], [], None
        snap = tree_map(lambda t: t.clone(), cache) if snapshot else None
        for t in range(steps):
            inputs = (nxt[:, None].clone(), pos.clone())
            first = first or inputs
            lg = timed("decode", lambda: decode(*inputs, cache)[0])
            outs.append(lg[:, 0].float())
            nxt = (lg[:, 0].argmax(-1) if forced is None
                   else forced[:, t + 1].to(dev))
            toks.append(nxt)
            pos = pos + 1
    return {"prefill_last": last, "steps": torch.stack(outs),
            "tokens": torch.stack(toks, 1), "first": first,
            "launches": launches, "ms": ms, "k3_paths": k3_paths,
            "k10_paths": k10_paths, "snapshot": snap}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tp_cfg(layers, dtype="bfloat16"):
    import dataclasses

    from repro_torch.core.config import get_arch

    return dataclasses.replace(get_arch(TP_ARCH), num_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def tp_steps(cfg, mesh_cfg, mesh, params, slots=LM_MAX_BATCH,
             rows=LM_MAX_LEN):
    """The dry run's prefill (one slot) and decode (``slots`` slots of
    ``rows`` rows) steps over ``params``, the rank's shards; returns
    (prefill, decode, model)."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import _build_step

    pre = ShapeConfig("prefill", max(LM_PROMPTS), 1, "prefill")
    dec = ShapeConfig("decode", rows, slots, "decode")
    rules = tp_rules(cfg, mesh_cfg, slots, rows)
    prefill, model = _build_step(cfg, pre, mesh_cfg, rules)(mesh, params)
    decode, _ = _build_step(cfg, dec, mesh_cfg, rules)(mesh, params)
    return prefill, decode, model


def tp_one_phase(torch, np, dev, counters, card):
    """Phase 16b: a 1 x 1 NCCL mesh.  ``TP_ARCH`` at full width cut to
    ``TP_CUTS["1x1"]`` layers, its weights drawn from ``SEED``: the
    unsharded port, then the dry run's ``_build_step`` on the mesh, each
    prefilling ``LM_PROMPTS`` into ``LM_MAX_BATCH`` slots of
    ``LM_MAX_LEN`` rows and taking ``TP_DECODE`` steps; the logits and
    tokens must be the same bits, and the sharded run must launch K3 7
    times and K10 once a layer in a prefill, K3 7 times a layer in a step.
    Returns the record."""
    import torch.distributed as dist

    from repro_torch.core.config import TINY_MESH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import shard_init

    t0 = time.perf_counter()
    layers, why = TP_CUTS["1x1"]
    cfg = tp_cfg(layers)
    prompts = tp_prompts(np, cfg.vocab_size)
    model, _ = build_model(torch, TP_ARCH, dev, layers=layers)
    cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
    whole = tp_serve(torch, lambda b, c: model.forward(b, "prefill", cache=c),
                     lambda t, p, c: model.decode_step(t, p, c), cache,
                     prompts, TP_DECODE)
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(TINY_MESH, "cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        prefill, decode, model = tp_steps(
            cfg, TINY_MESH, mesh, shard_init(cfg, gen, mesh, tp_rules(
                cfg, TINY_MESH)))
        cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
        k3 = {"K3": counters["K3"], "K10": counters["K10"]}
        sharded = tp_serve(torch, prefill, decode, cache, prompts, TP_DECODE,
                           k3)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    label = f"{TP_ARCH} 1x1 mesh"
    for key in ("prefill_last", "steps", "tokens"):
        if not torch.equal(sharded[key], whole[key]):
            fail(f"{label}: {key} differ from the unsharded port's bits")
    tp_check_launches(label, sharded["launches"], layers)
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"mesh": "1x1", "backend": backend, "layers": layers,
           "reduced": {"num_layers": [64, layers], "why": why},
           "prompts": list(LM_PROMPTS), "steps": TP_DECODE,
           "bits_equal": True,
           "tokens": sharded["tokens"].tolist(),
           "launches": tp_sum_launches(sharded["launches"]),
           "k3_paths": sharded["k3_paths"],
           "prefill_ms": sharded["ms"]["prefill"],
           "step_ms": statistics.median(sharded["ms"]["decode"]),
           "unsharded_prefill_ms": whole["ms"]["prefill"],
           "unsharded_step_ms": statistics.median(whole["ms"]["decode"]),
           "phase_s": time.perf_counter() - t0}
    print("tp16b " + json.dumps(rec), flush=True)
    return rec


def tp_rules(cfg, mesh_cfg, slots=LM_MAX_BATCH, rows=LM_MAX_LEN):
    """``rules_for`` at a decode of ``slots`` slots of ``rows`` rows."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.sharding.auto import rules_for

    return rules_for(cfg, mesh_cfg, ShapeConfig("decode", rows, slots,
                                                "decode"))[0]


def tp_check_launches(label, launches, layers):
    """7 K3 launches and 1 K10 a layer in each prefill, 7 K3 a layer in
    each decode step, and nothing else."""
    for kind, want in (("prefill", {"K3": 7 * layers, "K10": layers}),
                       ("decode", {"K3": 7 * layers, "K10": 0})):
        for i, got in enumerate(launches[kind]):
            if got != want:
                fail(f"{label}: {kind} {i} launched {got}, not {want}")


def tp_sum_launches(launches):
    return {k: sum(c[k] for kind in launches for c in launches[kind])
            for k in ("K3", "K10")}


def tp_two_phase(torch, np, dev, card):
    """Phase 16c: two ranks on the one card over gloo, mesh 1 x 2.  The
    unsharded reference (``TP_CUTS["1x2"]`` layers of ``TP_ARCH`` at full
    width, bf16, and ``TP_PARITY_LAYERS`` in fp32) runs here and is freed
    while two processes of this script (``--tp-rank``) start up; then they
    join a gloo group, each draws its shards (``shard_init``, the reference's draws),
    prefills ``LM_PROMPTS`` into ``LM_MAX_BATCH`` slots of ``LM_MAX_LEN``
    rows and takes ``TP_DECODE`` steps on the reference's tokens, repeats
    the first step, and runs the fp32 parity greedily.  Held: bf16 logits
    within ``TP_BF16_TOL``-relative of the reference (a rank's argmax
    apart from the reference's only at a near tie: within that limit of
    the reference's top logit), both ranks' logits the same bits, the
    repeated step the same bits, the launches a call; the fp32 parity's
    tokens equal the reference's and its logits within ``LM_TOL``.
    Returns the record."""
    import tempfile

    t0 = time.perf_counter()
    layers, why = TP_CUTS["1x2"]
    cfg = tp_cfg(layers)
    prompts = tp_prompts(np, cfg.vocab_size)
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        env = dict(os.environ, MKL_CBWR=MKL_CBWR)
        logs = [open(work / f"rank{r}.log", "w") for r in range(2)]
        # the ranks start up while the reference runs, and wait for its
        # tokens before they touch the card's memory
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
             str(SEED), "--tp-rank", str(r), "--tp-world", "2",
             "--tp-work", str(work)], stdout=logs[r],
            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
            for r in range(2)]
        try:
            model, _ = build_model(torch, TP_ARCH, dev, layers=layers)
            cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
            ref = tp_serve(torch, lambda b, c: model.forward(
                b, "prefill", cache=c), lambda t, p, c: model.decode_step(
                    t, p, c), cache, prompts, TP_DECODE)
            del model, cache
            gc.collect()
            torch.cuda.empty_cache()
            par_ref = tp_parity_run(torch, np, dev, None, None)
            gc.collect()
            torch.cuda.empty_cache()
            t_ref = time.perf_counter() - t0
            kv_publish(torch, work, "reference",
                       {"tokens": ref["tokens"].cpu()})
            deadline = time.perf_counter() + TP_RANK_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                tail = (work / f"rank{r}.log").read_text()[-4000:]
                fail(f"{TP_ARCH} 1x2 rank {r} exited {p.returncode}:\n{tail}")
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
    label = f"{TP_ARCH} 1x2 mesh"
    worst, rms = {}, {}
    parted = []
    for name, got_key, want in (("prefill", "prefill_last",
                                 ref["prefill_last"]),
                                ("decode", "steps", ref["steps"])):
        want = want.cpu()
        got = ranks[0][got_key]
        lim = TP_BF16_TOL * max(1.0, want.abs().max().item())
        worst[name] = _check_close(f"{label} {name} logits", got, want, lim)
        rms[name] = ((got - want).square().mean().sqrt()
                     / want.square().mean().sqrt()).item()
        # the argmax may part from the reference's only at a near tie
        g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
        top = w.max(-1).values
        pick = g.argmax(-1)
        apart = pick != w.argmax(-1)
        if bool((w.gather(1, pick[:, None])[:, 0] < top - lim)[apart].any()):
            fail(f"{label}: a {name} argmax parts from the reference's "
                 f"past a near tie")
        parted.append(int(apart.sum()))
    for key in ("prefill_last", "steps"):
        if not torch.equal(ranks[0][key], ranks[1][key]):
            fail(f"{label}: the ranks' {key} logits differ")
    for r, rec in enumerate(ranks):
        if not rec["repeat_equal"]:
            fail(f"{label} rank {r}: a repeat of the first step differs")
        tp_check_launches(f"{label} rank {r}", rec["launches"], layers)
        if rec["parity"]["tokens"] != par_ref["tokens"]:
            fail(f"{label} rank {r} fp32 parity: tokens "
                 f"{rec['parity']['tokens']}, the reference's "
                 f"{par_ref['tokens']}")
        for name in ("prefill", "decode"):
            want = par_ref["logits"][name]
            _check_close(f"{label} rank {r} fp32 parity {name}",
                         rec["parity"]["logits"][name], want,
                         LM_TOL[name] * max(1.0, want.abs().max().item()))
    out = {"mesh": "1x2", "backend": "gloo", "ranks": 2, "layers": layers,
           "reduced": {"num_layers": [64, layers], "why": why},
           "prompts": list(LM_PROMPTS), "slots": LM_MAX_BATCH,
           "rows": LM_MAX_LEN, "steps": TP_DECODE,
           "max_abs_err": worst, "relative_rms_err": rms,
           "tol": TP_BF16_TOL,
           "argmax_apart_at_near_ties": parted,
           "parity": {"layers": TP_PARITY_LAYERS,
                      "tokens": par_ref["tokens"]},
           "reference_prefill_ms": ref["ms"]["prefill"],
           "reference_step_ms": statistics.median(ref["ms"]["decode"]),
           "reference_s": t_ref,
           "per_rank": [{
               "prefill_ms": rec["ms"]["prefill"],
               "step_ms": statistics.median(rec["ms"]["decode"]),
               "peak_memory_gb": rec["peak_gb"],
               "collectives_a_step": rec["collectives_step"],
               "collectives_prefills": rec["collectives_prefills"],
               "launches": tp_sum_launches(rec["launches"]),
               "k3_paths": rec["k3_paths"],
               "store_launches": rec["store_launches"],
               "init_s": rec["init_s"]} for rec in ranks],
           "note": "gloo through host memory, two ranks on one card: the "
                   "times measure nothing of NCCL or NVLink",
           "card": card, "phase_s": time.perf_counter() - t0}
    print("tp16c " + json.dumps(out), flush=True)
    return out


def tp_parity_run(torch, np, dev, mesh, mesh_cfg):
    """The fp32 parity: ``TP_PARITY_LAYERS`` layers of ``TP_ARCH`` in fp32
    at full width, weights from ``SEED``, a prompt of
    ``LM_PARITY_PROMPT`` tokens into one slot and ``LM_PARITY_DECODE``
    greedy tokens; unsharded without ``mesh``, else the rank's shards.
    Returns the tokens and the logits (prefill's last position, the
    steps')."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import shard_init
    from repro_torch.nn.param import init_tree

    cfg = tp_cfg(TP_PARITY_LAYERS, "float32")
    rows = LM_PARITY_PROMPT + LM_PARITY_DECODE + 8
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if mesh is None:
        model = get_model(cfg)
        model.load_tree(init_tree(model.param_spec(), gen, "float32"))
        prefill = lambda b, c: model.forward(b, "prefill", cache=c)  # noqa
        decode = lambda t, p, c: model.decode_step(t, p, c)  # noqa: E731
    else:
        prefill, decode, model = tp_steps(
            cfg, mesh_cfg, mesh, shard_init(cfg, gen, mesh, tp_rules(
                cfg, mesh_cfg, 1, rows)), 1, rows)
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, LM_PARITY_PROMPT))
    cache = model.init_cache(1, rows)
    run = tp_serve(torch, prefill, decode, cache, [prompt],
                   LM_PARITY_DECODE - 1)
    return {"tokens": run["tokens"][0].tolist(),
            "logits": {"prefill": run["prefill_last"].cpu(),
                       "decode": run["steps"].cpu()}}


def rank_device(torch):
    """The device a rank of phase 16c runs on: the one card."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def tp_rank_main(args) -> int:
    """One rank of phase 16c (``--tp-rank``): see ``tp_two_phase``."""
    os.environ["MKL_CBWR"] = MKL_CBWR
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.core.config import MeshConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import shard_init
    from repro_torch.sharding import collectives

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: a rank needs the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(torch)
    _build.library()
    work, rank = Path(args.tp_work), args.tp_rank
    forced = kv_inputs(torch, work, "reference")["tokens"]
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=args.tp_world)
    try:
        mesh_cfg = MeshConfig((1, args.tp_world), ("data", "model"))
        mesh = make_mesh(mesh_cfg, "cuda", backend="gloo")
        layers, _ = TP_CUTS["1x2"]
        cfg = tp_cfg(layers)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        local = shard_init(cfg, gen, mesh, tp_rules(cfg, mesh_cfg))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        prefill, decode, model = tp_steps(cfg, mesh_cfg, mesh, local)
        cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
        counters = {"K3": mm_ops.matmul_fused,
                    "K10": attn_ops.flash_attention}
        stores = mm_ops.matmul_fused.entry_launches
        for k in stores:
            stores[k] = 0
        collectives.reset_counts()
        run = tp_serve(torch, prefill, decode, cache,
                       tp_prompts(np, cfg.vocab_size), TP_DECODE, counters,
                       forced=forced)
        store_launches = dict(stores)
        prefill_counts = collectives.counts_by_name()
        with torch.no_grad():
            collectives.reset_counts()
            again = decode(*run["first"], cache)[0][:, 0].float()
            step_counts = collectives.counts_by_name()
        peak = torch.cuda.max_memory_allocated() / 1e9
        rec = {"prefill_last": run["prefill_last"].cpu(),
               "steps": run["steps"].cpu(),
               "repeat_equal": torch.equal(again, run["steps"][0]),
               "launches": run["launches"], "ms": run["ms"],
               "k3_paths": run["k3_paths"],
               "store_launches": store_launches,
               "collectives_run": prefill_counts,
               "collectives_step": step_counts,
               "peak_gb": peak, "init_s": init_s}
        rec["collectives_prefills"] = {
            k: {"calls": v["calls"] - step_counts.get(k, {}).get("calls", 0)
                * TP_DECODE} for k, v in prefill_counts.items()}
        del model, cache, local, prefill, decode, run
        gc.collect()
        torch.cuda.empty_cache()
        rec["parity"] = tp_parity_run(torch, np, dev, mesh, mesh_cfg)
        torch.save(rec, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def tp_dryrun_phase(card):
    """Phase 16d: the dry run's rows for ``TP_DRYRUN_ARCHS`` on
    ``TP_DRYRUN_MESHES`` at ``LM_MAX_BATCH`` slots of ``LM_MAX_LEN``
    rows: bytes a card against its 80 GB, and whether it fits; the dense
    archs' decode step traced (fake process group, meta tensors)."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh

    shape = ShapeConfig(f"serve_{LM_MAX_BATCH}x{LM_MAX_LEN}", LM_MAX_LEN,
                        LM_MAX_BATCH, "decode")
    rows = []
    for arch in TP_DRYRUN_ARCHS:
        for mesh in TP_DRYRUN_MESHES:
            rec = dryrun.run_one(arch, shape, parse_mesh(mesh))
            rows.append(rec)
            print("tp16d " + dryrun.summary(rec) + f" [{card}]", flush=True)
    return rows


def tp_phase(torch, F, np, dev, peaks, counters, card):
    """Phase 16: 16a-16d; returns (cases, 1x1 record, 1x2 record, dry-run
    rows)."""
    t16 = time.perf_counter()
    cases = tp_kernel_cases(torch, F, dev, peaks)
    gc.collect()
    torch.cuda.empty_cache()
    one = tp_one_phase(torch, np, dev, counters, card)
    two = tp_two_phase(torch, np, dev, card)
    rows = tp_dryrun_phase(card)
    qwen = next(r for r in rows if r["arch"] == TP_ARCH
                and r["mesh"] == "1x4")
    if not (qwen["fits"] and qwen["layers"] == 64):
        fail(f"{TP_ARCH} at 1x4: {qwen['per_device_bytes']} does not fit")
    print(f"phase 16 wall time {time.perf_counter() - t16:.1f} s "
          f"(1x1 {one['phase_s']:.1f}, 1x2 {two['phase_s']:.1f}) [{card}]",
          flush=True)
    return cases, one, two, rows


# ---------------------------------------------------------------------------
#: phase 17: training on a mesh.  gemma2-2b at full width in bf16 (d_model
#: 2304, 8 heads over 4 kv heads of 256, d_ff 9216, vocab 256000), its
#: rules ``rules_for``'s of the uncut arch on each mesh (FSDP's "embed"
#: on at dp 2), cut in depth only
MESH_TRAIN_ARCH = LM_ARCH
#: 17c's meshes (data x model), gloo ranks sharing the one card (NCCL
#: refuses two ranks on one device), and the mesh that takes microbatches.
#: 2 x 1 ran here until phase 20 joined the smoke (57.7-80.4 s of phase
#: 17 on an H100 at 700 W, its FSDP gathers and fp32 parity through
#: gloo): 2 x 2 runs each of its checks (FSDP's "embed" over "data", 2
#: microbatches, the parity) with "model" cut too, and
#: tests/test_torch_train_mesh.py runs 2 x 1 on the CPU
#: (``tools/mesh_train_probe.py --meshes 2x1`` still runs it on the card)
MESH_TRAIN_MESHES = ("1x2", "2x2")
MESH_TRAIN_MICROBATCHES = {"2x1": 2, "2x2": 2}
#: rows of TRAIN_SEQ tokens a data rank takes a step
MESH_TRAIN_ROWS = 2
#: the most layers a mesh trains (the phase's time: gloo moves about 0.36
#: GB/s through host memory); ``mesh_train_cut`` cuts further, by whole
#: local/global pairs, where the ranks sharing the card reckon past
#: ``TRAIN_MEMORY_LIMIT_GB``
MESH_TRAIN_LAYERS = 8
#: the meshes with a data axis take fewer: each FSDP'd layer is gathered
#: through gloo in the forward, again in the recompute, and summed back in
#: the backward, once a microbatch (2 x 1 at 8 layers: 6.1 GB a rank and
#: 13.3 s a step on an H100 at 700 W; at 4, 4.2 GB and 6.8 s once
#: gathers went by broadcast; the smoke ran past its 1200 s once); since
#: phase 18 joined the smoke, 2 on those and 4 at 1 x 2, and since phase
#: 20 joined it 2 at 1 x 2 too (one local/global pair everywhere)
MESH_TRAIN_DEPTH = {"2x1": 2, "2x2": 2, "1x2": 2}
#: 17c's steps (the first taken twice from the same state)
MESH_TRAIN_STEPS = 2
#: the fp32 parity: one local/global pair at full width, this many rows of
#: TRAIN_PARITY_SEQ tokens, its limits tests/test_torch_train.py's
#: _check_step's
MESH_PARITY_LAYERS = 2
MESH_PARITY_ROWS = 4
#: the ranks' processes may take this long (s) before the phase fails
MESH_RANK_TIMEOUT = 900
#: 17a: K3's fp32-store backward (dx, dw) at gemma2's 2-way o and down
#: shards (role, K, N) over a data rank's rows
K3_STORE_GRAD_SHAPES = (("o", 1024, 2304), ("down", 4608, 2304))
#: 17d: the dry run's train_4k rows
MESH_DRYRUN_ARCHS = ("gemma2-2b", "starcoder2-15b", "internlm2-20b",
                     "qwen1.5-32b")
MESH_DRYRUN_MESHES = ("1x4", "1x8", "2x4")
#: 17d runs in this many processes beside 17a-17c (it needs no card)
MESH_DRYRUN_PROCS = 2


def k3_store_grad_case(torch, gen, dev, role, kk, n, m, peaks):
    """Phase 17a: K3's fp32 store of bf16 operands under autograd at M =
    ``m`` rows, ``[m, kk] x [kk, n]`` (a row-parallel o or down shard): the
    forward on the fp32 store, dy an fp32 cotangent of bf16 values (the
    ranks' sum's, whose adjoint over "model" is the identity, of the one
    cast to bf16), and the backward's dx and dw on K3 against the plain
    products on dz = dy cast to bf16, within ``LM_KERNEL_TOL``; every
    launch on the wgmma path; dx and dw timed beside the plain version,
    ``torch.matmul`` and their bound.  Returns the record."""
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    _, bw_peak, bf16_peak = peaks
    x = torch.randn((m, kk), generator=gen, device=dev).bfloat16()
    w = (torch.randn((kk, n), generator=gen, device=dev) / kk ** 0.5
         ).bfloat16()
    dy = torch.randn((m, n), generator=gen, device=dev).bfloat16().float()
    label = f"K3 fp32-store grad {role} M={m} {kk}->{n}"
    fn = mm_ops.matmul_fused
    before = (dict(fn.role_launches), dict(fn.path_launches),
              dict(fn.entry_launches))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(xg, wg, out_dtype=torch.float32)
    if y.dtype != torch.float32:
        fail(f"{label}: the forward stored {y.dtype}")
    y.backward(dy)
    torch.cuda.synchronize()
    roles = {k: fn.role_launches[k] - before[0][k] for k in fn.role_launches}
    paths = {k: fn.path_launches[k] - before[1][k] for k in fn.path_launches}
    stores = fn.entry_launches["matmul_fused_bf16_f32"] - before[2][
        "matmul_fused_bf16_f32"]
    if roles != {"forward": 1, "z": 0, "dx": 1, "dw": 1} or stores != 1:
        fail(f"{label}: launches by role {roles}, fp32 stores {stores}")
    if paths != {**dict.fromkeys(paths, 0), "wgmma": 3}:
        fail(f"{label}: paths {paths}, not the wgmma path alone")
    dz = dy.bfloat16()
    wt, xt = w.t().contiguous(), x.t().contiguous()
    rtol, atol = LM_KERNEL_TOL["bfloat16"]
    errs = {
        "dx": _check_close(f"{label} dx", xg.grad,
                           matmul_fused_ref(dz, wt), atol, rtol),
        "dw": _check_close(f"{label} dw", wg.grad,
                           matmul_fused_ref(xt, dz), atol, rtol)}
    flops = 2.0 * m * kk * n
    product_bound = 1e3 * max(flops / bf16_peak,
                              2.0 * (m * n + kk * n + m * kk) / bw_peak)
    rec = {"kernel": "K3-bf16-f32-grad", "role": role, "rows": m, "k": kk,
           "n": n, "max_abs_err": errs,
           "tol": {"rtol": rtol, "atol": atol},
           "dx_ms": time_ms(torch, lambda: mm_ops._launch(
               dz, wt, None, "none", role="dx")),
           "dw_ms": time_ms(torch, lambda: mm_ops._launch(
               xt, dz, None, "none", role="dw")),
           "plain_ms": time_ms(torch, lambda: (
               matmul_fused_ref(dz, wt), matmul_fused_ref(xt, dz)), reps=5),
           "library_ms": time_ms(torch, lambda: (
               torch.matmul(dz, w.t()), torch.matmul(x.t(), dz))),
           "bound_ms": 2 * product_bound, "bound_by": (
               "operations" if flops / bf16_peak > 2.0 * (
                   m * n + kk * n + m * kk) / bw_peak else "bytes"),
           "flops": 2 * flops}
    rec["ms"] = rec["dx_ms"] + rec["dw_ms"]
    print("mesh train case " + json.dumps(rec), flush=True)
    return rec


def mesh_cfg_at(layers, dtype="bfloat16"):
    """``MESH_TRAIN_ARCH`` at full width, ``layers`` deep, in ``dtype``."""
    import dataclasses

    from repro_torch.core.config import get_arch

    return dataclasses.replace(get_arch(MESH_TRAIN_ARCH), num_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def mesh_rules(mesh_cfg, rows):
    """``rules_for`` of the uncut arch on ``mesh_cfg`` at a train shape of
    ``rows`` global rows of ``TRAIN_SEQ`` tokens."""
    from repro_torch.core.config import ShapeConfig, get_arch
    from repro_torch.sharding.auto import rules_for

    return rules_for(get_arch(MESH_TRAIN_ARCH), mesh_cfg, ShapeConfig(
        "train", TRAIN_SEQ, rows, "train"))[0]


def mesh_state_bytes(cfg, mesh_cfg, rules, microbatches):
    """The dry run's bytes a card of a train step's arguments for ``cfg``
    on ``mesh_cfg`` (``launch.dryrun``'s reckoning at the cut depth):
    parameters, fp32 moments, gradients and, past one microbatch, their
    fp32 accumulator."""
    from repro_torch.launch.dryrun import spec_bytes
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import tree_map
    from repro_torch.train.optimizer import adamw_init_spec

    spec = get_model(cfg).param_spec()
    fsdp = dict(rules.table).get("embed") is not None
    out = {"params": spec_bytes(spec, mesh_cfg, rules, cfg.param_dtype)}
    out["optimizer"] = spec_bytes(adamw_init_spec(
        spec, zero1=True, dp_size=mesh_cfg.dp_size, fsdp=fsdp),
        mesh_cfg, rules, "float32")
    out["grads"] = out["params"]
    if microbatches > 1:
        out["grad_acc"] = spec_bytes(tree_map(
            lambda p: p._replace(dtype="float32"), spec), mesh_cfg, rules,
            "float32")
    out["total"] = sum(out.values())
    return out


def mesh_memory_budget(cfg, mesh_cfg, rules, microbatches):
    """GB the ranks of ``mesh_cfg`` reckon on the one card, by part of one
    rank, and ``total`` (all ranks): ``mesh_state_bytes``, the logits (as
    ``train_memory_budget``'s, over the rank's vocab shard and a
    microbatch's rows), the activations (the rematted units' bf16 inputs
    and eight fp32 tensors of the widest local projection), the whole
    weights of one unit and of the embedding gathered over "data" (FSDP)
    and a card context of 0.6 GB a process."""
    from repro_torch.launch.dryrun import spec_bytes
    from repro_torch.models.common import block_spec
    from repro_torch.nn.embedding import embedding_spec
    from repro_torch.sharding.rules import logical_to_spec, shards

    dp, mp = mesh_cfg.dp_size, mesh_cfg.model_size
    cut = lambda logical: shards(logical_to_spec(  # noqa: E731
        (logical,), mesh_cfg.axes, rules)[0], mesh_cfg)
    state = mesh_state_bytes(cfg, mesh_cfg, rules, microbatches)
    tokens = MESH_TRAIN_ROWS * TRAIN_SEQ // microbatches
    fsdp = cut("embed") > 1
    unit = 2 * spec_bytes(block_spec(cfg), mesh_cfg, rules,
                          cfg.param_dtype)
    embed = spec_bytes(embedding_spec(cfg), mesh_cfg, rules,
                       cfg.param_dtype)
    parts = {k: v / 1e9 for k, v in state.items() if k != "total"}
    parts.update({
        "logits": ((5 + 2 * bool(cfg.logit_softcap)) * 4 * tokens
                   * cfg.padded_vocab / cut("vocab") / 1e9),
        "activations": (cfg.num_layers * tokens * cfg.d_model * 2
                        + 8 * 4 * tokens * max(cfg.d_ff // cut("ff"),
                                               4 * cfg.d_model)) / 1e9,
        "gathered": (dp * (unit + embed) if fsdp else 0) / 1e9,
        "context": 0.6})
    per_rank = sum(parts.values())
    return dict(parts, per_rank=per_rank, ranks=dp * mp,
                total=per_rank * dp * mp)


def mesh_train_cut(mesh_cfg, microbatches, most=MESH_TRAIN_LAYERS):
    """(config, the cut as ``reduced`` prints it, the ranks' budget, the
    reference's): the most whole local/global pairs, at most ``most``
    layers, whose ranks' reckoning
    (``mesh_memory_budget``) and whose unsharded reference's
    (``train_memory_budget`` on the global batch at its microbatches)
    stay within ``TRAIN_MEMORY_LIMIT_GB``."""
    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model

    rows = mesh_cfg.dp_size * MESH_TRAIN_ROWS
    rules = mesh_rules(mesh_cfg, rows)
    layers = most
    while True:
        cfg = mesh_cfg_at(layers)
        budget = mesh_memory_budget(cfg, mesh_cfg, rules, microbatches)
        ref = train_memory_budget(get_model(cfg), rows, TRAIN_SEQ,
                                  mesh_reference_microbatches(
                                      mesh_cfg, microbatches))
        if (max(budget["total"], ref["total"]) <= TRAIN_MEMORY_LIMIT_GB
                or layers <= 2):
            break
        layers -= 2
    full = get_arch(MESH_TRAIN_ARCH).num_layers
    return cfg, {"num_layers": [full, layers], "why": (
        f"{mesh_cfg.dp_size * mesh_cfg.model_size} ranks share one card: "
        f"{layers} layers reckon {budget['total']:.1f} GB for the ranks "
        f"and {ref['total']:.1f} GB for the unsharded reference, within "
        f"{TRAIN_MEMORY_LIMIT_GB:.0f}; at most {most} for the phase's "
        f"time (gloo through host memory)")}, budget, ref


def mesh_reference_microbatches(mesh_cfg, microbatches):
    """The unsharded reference's microbatches: the mesh's, or as many as
    keep a microbatch to ``MESH_TRAIN_ROWS`` rows (its logits' memory)."""
    return max(microbatches, mesh_cfg.dp_size)


def mesh_batches(torch, np, rows, seq, steps, seed_offset=0):
    """``steps`` batches of ``rows`` x ``seq`` tokens of the corpus
    (``MarkovLM(TRAIN_VOCAB)``), on the CPU."""
    from repro_torch.train.data import MarkovLM

    lm = MarkovLM(TRAIN_VOCAB, seed=SEED)
    rng = np.random.default_rng(SEED + seed_offset)
    return [_train_batch(torch, lm, rng, "cpu", rows, seq)
            for _ in range(steps)]


def mesh_tcfg():
    from repro_torch.core.config import TrainConfig

    return TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=MESH_TRAIN_STEPS + 1)


def mesh_fingerprints(torch, tree):
    """``bits_fingerprint`` of every leaf of ``tree``, keyed by path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out["/".join(path)] = bits_fingerprint(torch, t)

    walk(tree, ())
    return out


def mesh_one_phase(torch, np, dev, counters, card):
    """Phase 17b: a 1 x 1 NCCL mesh.  ``MESH_TRAIN_ARCH`` at full width
    cut to ``MESH_TRAIN_LAYERS``, two steps on ``MESH_TRAIN_ROWS`` rows:
    the unsharded port, then the dry run's ``_build_step`` on the mesh
    from the same draws (``shard_init``): the loss, CE and grad norm bit
    for bit, and every new leaf and moment the same bits
    (``bits_fingerprint``) after each step.  Returns the record."""
    import torch.distributed as dist

    from repro_torch.core.config import TINY_MESH, ShapeConfig
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import shard_init
    from repro_torch.nn.param import init_tree
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = mesh_cfg_at(MESH_TRAIN_LAYERS)
    batches = [{k: v.to(dev) for k, v in b.items()} for b in mesh_batches(
        torch, np, MESH_TRAIN_ROWS, TRAIN_SEQ, MESH_TRAIN_STEPS)]
    tcfg = mesh_tcfg()

    def run(step, params, opt):
        out = []
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = step(params, opt, b)
            torch.cuda.synchronize()
            out.append({"metrics": {k: v.item() for k, v in m.items()},
                        "ms": 1e3 * (time.perf_counter() - t),
                        "params": mesh_fingerprints(torch, params),
                        "m": mesh_fingerprints(torch, opt["m"]),
                        "v": mesh_fingerprints(torch, opt["v"])})
        return out

    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(model.param_spec(), gen, cfg.param_dtype)
    model.load_tree(tree)
    whole = run(make_train_step(model, tcfg), tree, adamw_init(tree))
    del model, tree
    gc.collect()
    torch.cuda.empty_cache()
    rows = MESH_TRAIN_ROWS
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(TINY_MESH, "cuda")
        rules = mesh_rules(TINY_MESH, rows)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        local = shard_init(cfg, gen, mesh, rules)
        step, _ = _build_step(cfg, ShapeConfig("train", TRAIN_SEQ, rows,
                                               "train"), TINY_MESH, rules,
                              tcfg=tcfg, microbatches=1)(mesh, local)
        counters["K3"].launches = 0
        sharded = run(step, local, adamw_init(local, step.plan()))
        launches = counters["K3"].launches
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    label = f"{MESH_TRAIN_ARCH} train 1x1 mesh"
    for i, (a, b) in enumerate(zip(sharded, whole)):
        for key in ("metrics", "params", "m", "v"):
            if a[key] != b[key]:
                differ = (sorted(k for k in a[key] if a[key][k] != b[key][k])
                          if key != "metrics" else a[key])
                fail(f"{label}: step {i + 1}'s {key} differ from the "
                     f"unsharded port's bits: {differ[:10]}")
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"mesh": "1x1", "backend": backend, "layers": cfg.num_layers,
           "reduced": {"num_layers": [26, cfg.num_layers],
                       "why": f"the 1 x 1 mesh is the unsharded port's "
                              f"bits: {cfg.num_layers} layers show it"},
           "rows": rows, "seq": TRAIN_SEQ, "steps": MESH_TRAIN_STEPS,
           "bits_equal": True, "k3_launches": launches,
           "metrics": [s["metrics"] for s in sharded],
           "step_ms": [s["ms"] for s in sharded],
           "unsharded_step_ms": [s["ms"] for s in whole],
           "leaves_compared": len(whole[0]["params"]), "card": card,
           "phase_s": time.perf_counter() - t0}
    print("mesh17b " + json.dumps(rec), flush=True)
    return rec


def mesh_reference(torch, np, dev, cfg, mesh_cfg, microbatches, work,
                   rows=None, first=None):
    """The unsharded reference of 17c on ``mesh_cfg``'s global batch
    (``MESH_TRAIN_ROWS`` rows a data rank, or ``rows`` in all): ``cfg``
    from ``SEED``'s draws, ``MESH_TRAIN_STEPS`` steps of
    ``make_train_step`` (at ``mesh_reference_microbatches``); its metrics
    a step, and ``first(tree, step)`` called after the first step (17c
    writes the parameters for the ranks, 18d keeps the gradients).  The
    batches go to ``work/batches.pt``.  Returns (metrics, seconds, step
    ms)."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    rows = rows or mesh_cfg.dp_size * MESH_TRAIN_ROWS
    batches = mesh_batches(torch, np, rows, TRAIN_SEQ, MESH_TRAIN_STEPS)
    torch.save(batches, work / "batches.pt")
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(model.param_spec(), gen, cfg.param_dtype)
    model.load_tree(tree)
    opt = adamw_init(tree)
    step = make_train_step(model, mesh_tcfg(), microbatches=(
        mesh_reference_microbatches(mesh_cfg, microbatches)))
    metrics, ms = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(tree, opt, {k: v.to(dev) for k, v in b.items()})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        metrics.append({k: v.item() for k, v in m.items()})
        if i == 0 and first is not None:
            first(tree, step)
    del model, tree, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, time.perf_counter() - t0, ms


def mesh_split(counts):
    """A collectives record split into the forward's exchanges and the
    backward's (``".bwd"``)."""
    out = {"forward": {}, "backward": {}}
    for name, v in counts.items():
        side = ("backward" if name.split("/")[0].endswith(".bwd")
                else "forward")
        out[side][name] = v
    return out


def mesh_two_start(work, name):
    """Start 17c's ranks of mesh ``name`` (data x model): this script once
    a rank (``--mt-rank``) in ``work``, at ``mesh_train_cut``'s depth
    (``case.json``); they start up (the interpreter, the library, dynamo)
    while the phase's earlier parts run, and wait for the reference's
    files (``mesh_two_phase``) before they touch the card's memory.
    Returns what ``mesh_two_phase`` takes."""
    from repro_torch.launch.mesh import parse_mesh

    mesh_cfg = parse_mesh(name)
    mb = MESH_TRAIN_MICROBATCHES.get(name, 1)
    cfg, reduced, budget, ref_budget = mesh_train_cut(
        mesh_cfg, mb, MESH_TRAIN_DEPTH.get(name, MESH_TRAIN_LAYERS))
    world = mesh_cfg.num_devices
    work.mkdir()
    (work / "case.json").write_text(json.dumps(
        {"mesh": name, "layers": cfg.num_layers, "microbatches": mb}))
    env = dict(os.environ, MKL_CBWR=MKL_CBWR)
    logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
         str(SEED), "--mt-rank", str(r), "--mt-world", str(world),
         "--mt-work", str(work)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        for r in range(world)]
    return {"name": name, "mesh_cfg": mesh_cfg, "mb": mb, "cfg": cfg,
            "reduced": reduced, "budget": budget, "ref_budget": ref_budget,
            "work": work, "procs": procs, "logs": logs}


def mesh_two_phase(torch, np, dev, card, started):
    """Phase 17c on the mesh ``mesh_two_start`` started (data x model)
    over gloo: the depth ``mesh_train_cut``'s; the unsharded reference
    (``mesh_reference``) run here and freed; then the ranks, each taking
    ``MESH_TRAIN_STEPS`` steps on its rows through the dry run's
    ``_build_step``, the first twice from the same state, and the fp32
    parity (``mesh_parity``).  Held: the first step's
    CE, loss and grad norm within ``TP_BF16_TOL`` (relative to max(1,
    |reference|)) of the reference's, the second's too, the same bits on
    every rank; every new leaf within the Adam allowance of the
    reference's (2.02 lr plus one bf16 ulp of the leaf); the parity's
    metrics, moments and leaves within ``_check_step``'s limits; the
    leaves that no model axis cuts the same bits on the model ranks of a
    data group; the repeated step the same bits; the launches a step
    ``train_expect``'s, on the wgmma path.  Returns the record."""
    t0 = time.perf_counter()
    name, mesh_cfg, mb, cfg = (started[k] for k in ("name", "mesh_cfg",
                                                     "mb", "cfg"))
    reduced, budget, ref_budget = (started[k] for k in (
        "reduced", "budget", "ref_budget"))
    work, procs, logs = started["work"], started["procs"], started["logs"]
    world = mesh_cfg.num_devices
    label = f"{MESH_TRAIN_ARCH} train {name} mesh"
    print(f"{label}: {cfg.num_layers} layers, reduced "
          f"{json.dumps(reduced)}, microbatches {mb}, reckoned "
          f"{ {k: round(v, 2) for k, v in budget.items()} } GB", flush=True)
    try:
        ref, ref_s, ref_ms = mesh_reference(
            torch, np, dev, cfg, mesh_cfg, mb, work,
            first=lambda tree, _: torch.save(_cpu_tree(tree),
                                             work / "reference.pt"))
        kv_publish(torch, work, "reference", {})
        t_ranks = time.perf_counter()  # the ranks' time after it
        deadline = time.perf_counter() + MESH_RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (work / f"rank{r}.log").read_text()[-4000:]
            fail(f"{label} rank {r} exited {p.returncode}:\n{tail}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    ranks_s = time.perf_counter() - t_ranks
    worst = {}
    for i, want in enumerate(ref):
        for k in ("ce", "loss", "grad_norm"):
            got = [rec["steps"][i]["metrics"][k] for rec in ranks]
            if len(set(got)) != 1:
                fail(f"{label}: step {i + 1}'s {k} differs between the "
                     f"ranks: {got}")
            err = abs(got[0] - want[k])
            if not err <= TP_BF16_TOL * max(1.0, abs(want[k])):
                fail(f"{label}: step {i + 1}'s {k} {got[0]}, the "
                     f"reference's {want[k]}")
            worst[f"{k}{i + 1}"] = err
    expect = train_expect(cfg, mb)
    want_launches = {
        "K3": {"forward": expect["K3_forward"] + expect["K3_recompute"],
               "z": expect["K3_z"], "dx": expect["K3_dx"],
               "dw": expect["K3_dw"]},
        "K10": expect["K10_forward"] + expect["K10_backward"],
        "K10_ml": expect["K10_ml"],
        "K3_f32_store": (2 * 2 * cfg.num_layers * mb
                         if mesh_cfg.model_size > 1 else 0)}
    for r, rec in enumerate(ranks):
        if not rec["repeat_equal"]:
            fail(f"{label} rank {r}: the first step taken twice differs: "
                 f"{rec['repeat_differ'][:10]}")
        if rec["leaves"]["violations"]:
            fail(f"{label} rank {r}: new leaves past the Adam allowance of "
                 f"the reference's: {rec['leaves']['violations'][:10]}")
        if rec["parity"]["violations"]:
            fail(f"{label} rank {r} fp32 parity: "
                 f"{rec['parity']['violations'][:10]}")
        for i, got in enumerate(rec["launches"]):
            if {k: got[k] for k in want_launches} != want_launches:
                fail(f"{label} rank {r} step {i + 1}: launches {got}, "
                     f"expected {want_launches}")
            n3 = sum(got["K3"].values())
            if got["K3_paths"] != {**dict.fromkeys(got["K3_paths"], 0),
                                   "wgmma": n3}:
                fail(f"{label} rank {r}: K3's paths {got['K3_paths']}, not "
                     f"the wgmma path alone")
    # the leaves and moments no model axis cuts: the same bits on the
    # model ranks of one data group
    replicated = 0
    for a in ranks:
        for b in ranks:
            if a is b or a["coords"]["data"] != b["coords"]["data"]:
                continue
            for key in a["replicated"]:
                replicated += 1
                if a["fingerprints"][key] != b["fingerprints"][key]:
                    fail(f"{label}: {key} differs between the model ranks "
                         f"of data rank {a['coords']['data']}")
    tokens = mesh_cfg.dp_size * MESH_TRAIN_ROWS * TRAIN_SEQ
    out = {"mesh": name, "backend": "gloo", "ranks": world,
           "layers": cfg.num_layers, "reduced": reduced,
           "microbatches": mb, "rows_a_data_rank": MESH_TRAIN_ROWS,
           "seq": TRAIN_SEQ, "fsdp": ranks[0]["fsdp"],
           "reckoned_gb": budget, "reference_reckoned_gb": ref_budget,
           "max_abs_err": worst, "tol": TP_BF16_TOL,
           "reference": {"metrics": ref, "step_ms": ref_ms,
                         "microbatches": mesh_reference_microbatches(
                             mesh_cfg, mb), "seconds": ref_s},
           "replicated_compared": replicated,
           "per_rank": [{
               "coords": rec["coords"],
               "step_ms": statistics.median(rec["step_ms"]),
               "step_ms_all": rec["step_ms"],
               "tokens_per_s": tokens / statistics.median(rec["step_ms"])
               * 1e3,
               "peak_memory_gb": rec["peak_gb"],
               "dryrun_gb": {k: v / 1e9 for k, v in rec["dryrun"].items()},
               "collectives_a_step": mesh_split(rec["collectives"]),
               "launches_a_step": rec["launches"][0],
               "new_leaves_worst": rec["leaves"]["worst"],
               "parity": {k: v for k, v in rec["parity"].items()
                          if k != "violations"},
               "init_s": rec["init_s"]} for rec in ranks],
           "note": "gloo through host memory, the ranks sharing one card: "
                   "the times measure nothing of NCCL or NVLink",
           "ranks_s": ranks_s, "card": card,
           "phase_s": time.perf_counter() - t0}
    print("mesh17c " + json.dumps(out), flush=True)
    r0 = out["per_rank"][0]
    print(f"{label}: step {r0['step_ms']:.1f} ms ({r0['tokens_per_s']:.0f} "
          f"tokens/s), peak {r0['peak_memory_gb']:.2f} GB a rank (dry run "
          f"{r0['dryrun_gb']['total']:.2f} GB of state), wall "
          f"{out['phase_s']:.1f} s [{card}]", flush=True)
    return out


def _adam_violations(torch, got, want, lr, label, tiny=None):
    """(the largest error, a description or None): where ``got`` lies
    past the Adam allowance of ``want``: with ``tiny`` (where the
    reference's first moment is tiny against its leaf's)
    ``_check_step``'s limits, else 2.02 lr plus one bf16 ulp of
    ``want``."""
    err = (got.float() - want.float()).abs()
    if tiny is None:
        ulp = torch.where(want.float() == 0, torch.zeros_like(err),
                          2.0 ** (torch.floor(torch.log2(
                              want.float().abs())) - 7))
        lim = 2.02 * lr + ulp
    else:
        lim = torch.where(tiny, torch.full_like(err, 2.02 * lr + 1e-6),
                          1e-6 * want.float().abs().clamp_min(1.0)
                          + 1e-3 * lr)
    over = (err - lim).max().item()
    return err.max().item(), (f"{label} by {over}" if over > 0 else None)


def mesh_parity(torch, np, dev, mesh, mesh_cfg, rules, mb):
    """The fp32 parity of a rank: ``MESH_PARITY_LAYERS`` layers at full
    width in fp32 from ``SEED``, one step on ``MESH_PARITY_ROWS`` x
    ``TRAIN_PARITY_SEQ`` tokens at the mesh's microbatches, first through
    ``_build_step`` on the rank's shards and rows, every rank at once,
    then unsharded, one rank at a time (each keeps its slices of the new
    leaves and moments): the metrics within 1e-5, the moments within 1e-4 and the leaves within
    ``_check_step``'s limits of the unsharded step's.  Returns the
    record."""
    import torch.distributed as dist

    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import shard_init
    from repro_torch.nn.param import init_tree, tree_leaves
    from repro_torch.sharding.rules import local_slice, logical_to_spec
    from repro_torch.train.optimizer import adamw_init, adamw_init_spec
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = mesh_cfg_at(MESH_PARITY_LAYERS, "float32")
    coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                       mesh.get_coordinate())))
    batch, = mesh_batches(torch, np, MESH_PARITY_ROWS, TRAIN_PARITY_SEQ, 1,
                          seed_offset=1)
    spec = get_model(cfg).param_spec()
    fsdp = dict(rules.table).get("embed") is not None
    mspec = adamw_init_spec(spec, zero1=True, dp_size=mesh_cfg.dp_size,
                            fsdp=fsdp)["m"]
    pspecs = [logical_to_spec(p.axes, mesh_cfg.axes, rules)
              for p in tree_leaves(spec)]
    mspecs = [logical_to_spec(p.axes, mesh_cfg.axes, rules)
              for p in tree_leaves(mspec)]
    parts = {}

    def reference():
        t = time.perf_counter()
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        tree = init_tree(spec, gen, "float32")
        model.load_tree(tree)
        opt = adamw_init(tree)
        torch.cuda.synchronize()
        parts["init"] = time.perf_counter() - t
        _, _, ref_m = make_train_step(model, mesh_tcfg(), microbatches=mb)(
            tree, opt, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        parts["step"] = time.perf_counter() - t - parts["init"]

        def mine(leaves, specs):
            return [local_slice(t, s, mesh_cfg, coords).clone()
                    for t, s in zip(leaves, specs)]

        return {"params": mine(tree_leaves(tree), pspecs),
                "m": mine(tree_leaves(opt["m"]), mspecs),
                "v": mine(tree_leaves(opt["v"]), mspecs),
                # where the moment is tiny against its whole leaf's
                "tiny": mine([t.abs() <= 1e-3 * max(t.abs().max().item(),
                                                    1e-30)
                              for t in tree_leaves(opt["m"])], pspecs)
                }, {k: v.item() for k, v in ref_m.items()}

    # the sharded step first, on every rank at once: a new process's first
    # train step costs about 10 s more than the next on an H100's host
    # (its first torch.utils.checkpoint call imports torch._dynamo), which
    # the ranks then pay side by side rather than turn by turn
    gen = torch.Generator(device=dev).manual_seed(SEED)
    local = shard_init(cfg, gen, mesh, rules)
    step, _ = _build_step(cfg, ShapeConfig(
        "train", TRAIN_PARITY_SEQ, MESH_PARITY_ROWS, "train"), mesh_cfg,
        rules, tcfg=mesh_tcfg(), microbatches=mb)(mesh, local)
    opt = adamw_init(local, step.plan())
    bspec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
    rows = {k: local_slice(v, bspec, mesh_cfg, coords).to(dev)
            for k, v in batch.items()}
    _, _, got_m = step(local, opt, rows)
    got_m = {k: v.item() for k, v in got_m.items()}
    parts["sharded_step"] = time.perf_counter() - t0
    # then the unsharded step, one rank at a time: the ranks share one
    # card, and each whole fp32 step holds about 16 GB
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            ref, ref_m = reference()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    reference_s = time.perf_counter() - t0 - parts["sharded_step"]
    parts["turns"] = reference_s
    violations, worst = [], {}
    for k, want in ref_m.items():
        err = abs(got_m[k] - want)
        worst[k] = err
        if not err <= 1e-5 * max(1.0, abs(want)):
            violations.append(f"{k} {got_m[k]} against {want}")
    lr = ref_m["lr"]
    for part in ("m", "v"):
        worst[part] = 0.0
        for i, (a, b) in enumerate(zip(tree_leaves(opt[part]), ref[part])):
            e = (a - b).abs().max().item()
            worst[part] = max(worst[part], e)
            if not e <= 1e-4 * max(1.0, b.abs().max().item()):
                violations.append(f"{part} leaf {i} by {e}")
    worst["param"] = 0.0
    for i, (a, b, t) in enumerate(zip(tree_leaves(local), ref["params"],
                                      ref["tiny"])):
        e, bad = _adam_violations(torch, a, b, lr, f"leaf {i}", t)
        worst["param"] = max(worst["param"], e)
        if bad:
            violations.append(bad)
    del local, opt, step, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "rows": MESH_PARITY_ROWS,
            "seq": TRAIN_PARITY_SEQ, "microbatches": mb,
            "loss": got_m["loss"], "max_abs_err": worst,
            "violations": violations, "seconds": time.perf_counter() - t0,
            "reference_s": reference_s, "parts_s": parts}


def mesh_rank_main(args) -> int:
    """One rank of phase 17c (``--mt-rank``): see ``mesh_two_phase``."""
    os.environ["MKL_CBWR"] = MKL_CBWR
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.core.config import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    from repro_torch.models.transformer import shard_init
    from repro_torch.nn.param import tree_leaves
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import local_slice, logical_to_spec
    from repro_torch.train.optimizer import adamw_init

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: a rank needs the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(torch)
    _build.library()
    # the first torch.utils.checkpoint call imports it (about 10 s): here,
    # while the reference runs
    import torch._dynamo  # noqa: F401
    work, rank = Path(args.mt_work), args.mt_rank
    case = json.loads((work / "case.json").read_text())
    kv_inputs(torch, work, "reference")  # the reference's files are written
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=args.mt_world)
    try:
        mesh_cfg = parse_mesh(case["mesh"])
        mesh = make_mesh(mesh_cfg, "cuda", backend="gloo")
        coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                           mesh.get_coordinate())))
        mb = case["microbatches"]
        rows = mesh_cfg.dp_size * MESH_TRAIN_ROWS
        rules = mesh_rules(mesh_cfg, rows)
        parity = mesh_parity(torch, np, dev, mesh, mesh_cfg, rules, mb)
        cfg = mesh_cfg_at(case["layers"])
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()

        def draw():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return shard_init(cfg, gen, mesh, rules)

        local = draw()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        step, model = _build_step(cfg, ShapeConfig(
            "train", TRAIN_SEQ, rows, "train"), mesh_cfg, rules,
            tcfg=mesh_tcfg(), microbatches=mb)(mesh, local)
        opt = adamw_init(local, step.plan())
        bspec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
        batches = [{k: local_slice(v, bspec, mesh_cfg, coords).to(dev)
                    for k, v in b.items()}
                   for b in torch.load(work / "batches.pt")]
        k3, k10 = mm_ops.matmul_fused, attn_ops.flash_attention

        def zero():
            for fn in (k3, k10):
                fn.launches = 0
                for p in fn.path_launches:
                    fn.path_launches[p] = 0
            for table in (k3.role_launches, k3.entry_launches):
                for key in table:
                    table[key] = 0
            k10.ml_launches = 0
            collectives.reset_counts()

        def counted(batch):
            zero()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = step(local, opt, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            launches = {"K3": dict(k3.role_launches),
                        "K3_paths": dict(k3.path_launches),
                        "K3_f32_store": k3.entry_launches[
                            "matmul_fused_bf16_f32"],
                        "K10": k10.launches, "K10_ml": k10.ml_launches}
            return ({k: v.item() for k, v in m.items()}, ms, launches,
                    collectives.counts_by_name())

        m1, ms1, l1, coll = counted(batches[0])
        # the new leaves against the reference's, each the rank's slice
        ref = torch.load(work / "reference.pt", mmap=True)
        spec = model.param_spec()
        keys, pspecs = [], []

        def walk(s, path):
            if isinstance(s, dict):
                for k in sorted(s):
                    walk(s[k], path + (k,))
            else:
                keys.append("/".join(path))
                pspecs.append(logical_to_spec(s.axes, mesh_cfg.axes, rules))

        walk(spec, ())
        violations, worst = [], 0.0
        for key, sp, got, want in zip(keys, pspecs, tree_leaves(local),
                                      tree_leaves(ref)):
            e, bad = _adam_violations(
                torch, got, local_slice(want, sp, mesh_cfg, coords).to(dev),
                m1["lr"], key)
            worst = max(worst, e)
            if bad:
                violations.append(bad)
        del ref
        first = {"params": mesh_fingerprints(torch, local),
                 "m": mesh_fingerprints(torch, opt["m"]),
                 "v": mesh_fingerprints(torch, opt["v"])}
        # the first step again from the same state: the same draws, zero
        # moments
        for t_, s_ in zip(tree_leaves(local), tree_leaves(draw())):
            t_.copy_(s_)
        for t_ in tree_leaves(opt):
            t_.zero_()
        m1b, ms1b, l1b, _ = counted(batches[0])
        again = {"params": mesh_fingerprints(torch, local),
                 "m": mesh_fingerprints(torch, opt["m"]),
                 "v": mesh_fingerprints(torch, opt["v"])}
        differ = [f"{part}:{k}" for part in first for k in first[part]
                  if first[part][k] != again[part][k]]
        differ += [k for k in m1 if m1[k] != m1b[k]]
        m2, ms2, l2, _ = counted(batches[1])
        peak = torch.cuda.max_memory_allocated() / 1e9
        prints = {f"params:{k}": v for k, v in
                  mesh_fingerprints(torch, local).items()}
        prints.update({f"m:{k}": v for k, v in
                       mesh_fingerprints(torch, opt["m"]).items()})
        replicated = [f"{part}:{k}" for part in ("params", "m")
                      for k, sp in zip(keys, pspecs)
                      if "model" not in str(sp)]
        rec = {"coords": coords, "fsdp": rules.lookup("embed"),
               "steps": [{"metrics": m1}, {"metrics": m2}],
               "step_ms": [ms1, ms1b, ms2], "launches": [l1, l1b, l2],
               "collectives": coll, "repeat_equal": not differ,
               "repeat_differ": differ,
               "leaves": {"worst": worst, "violations": violations},
               "parity": parity, "fingerprints": prints,
               "replicated": replicated, "peak_gb": peak,
               "dryrun": mesh_state_bytes(cfg, mesh_cfg, rules, mb),
               "init_s": init_s}
        torch.save(rec, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def dryrun_combos(which):
    """The (arch, shape, mesh) rows of 17d (``"mesh"``: ``train_4k`` of
    ``MESH_DRYRUN_ARCHS`` on ``MESH_DRYRUN_MESHES``), 18e (``"kv"``:
    every shape of ``KV_DRYRUN_ARCHS`` on ``KV_DRYRUN_MESHES``) or 19e
    (``"moe"``: every shape of ``MOE_DRYRUN_ARCHS`` on the same)."""
    if which == "mesh":
        return [(a, "train_4k", m) for a in MESH_DRYRUN_ARCHS
                for m in MESH_DRYRUN_MESHES]
    from repro_torch.core.config import SHAPES

    archs = MOE_DRYRUN_ARCHS if which == "moe" else KV_DRYRUN_ARCHS
    return [(a, s, m) for m in KV_DRYRUN_MESHES for a in archs
            for s in SHAPES]


def mesh_dryrun_main(args) -> int:
    """Part ``--mesh-dryrun-part i/n`` of the dry run's records of
    ``dryrun_combos(--dryrun-set)`` (every n-th from the i-th), written as
    JSON to ``--mesh-dryrun``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh

    i, n = (int(v) for v in args.mesh_dryrun_part.split("/"))
    recs = [dryrun.run_one(a, s, parse_mesh(m))
            for a, s, m in dryrun_combos(args.dryrun_set)[i::n]]
    Path(args.mesh_dryrun).write_text(json.dumps(recs))
    return 0


def mesh_dryrun_start(work, which="mesh", procs=MESH_DRYRUN_PROCS):
    """Start ``procs`` processes of the dry run's rows ``which``
    (``dryrun_combos``); returns them with the files they write."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = []
    for i in range(procs):
        path = work / f"dryrun_{which}{i}.json"
        log = open(work / f"dryrun_{which}{i}.log", "w")
        p = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-dryrun",
             str(path), "--mesh-dryrun-part", f"{i}/{procs}",
             "--dryrun-set", which],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        out.append((p, path, log))
    return out


def dryrun_collect(started, label):
    """The records of ``mesh_dryrun_start``'s processes."""
    rows = []
    for p, path, log in started:
        try:
            p.wait(timeout=MESH_RANK_TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        if p.returncode != 0:
            fail(f"{label} dry run exited {p.returncode}:\n"
                 f"{Path(log.name).read_text()[-4000:]}")
        rows += json.loads(path.read_text())
    return rows


def mesh_dryrun_rows(started, card):
    """Phase 17d: the records of ``mesh_dryrun_start``'s processes, each
    printed; gemma2-2b and qwen1.5-32b must be traced at 1 x 4."""
    from repro_torch.launch import dryrun

    rows = dryrun_collect(started, "17d")
    for rec in rows:
        print("mesh17d " + dryrun.summary(rec) + f" [{card}]", flush=True)
    for arch in ("gemma2-2b", "qwen1.5-32b"):
        rec = next(r for r in rows if r["arch"] == arch
                   and r["mesh"] == "1x4")
        if not rec["traced"]:
            fail(f"17d: {arch} train_4k at 1x4 not traced: "
                 f"{rec['why_not_traced']}")
    return rows


def mesh_phase(torch, np, dev, peaks, counters, card):
    """Phase 17: 17a-17d; returns (cases, 1x1 record, the meshes'
    records, dry-run rows)."""
    import tempfile

    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        started = mesh_dryrun_start(Path(work))
        # every mesh's ranks start up beside 17a, 17b and the meshes
        # before theirs
        ranks = [mesh_two_start(Path(work) / name, name)
                 for name in MESH_TRAIN_MESHES]
        try:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            cases = [k3_store_grad_case(torch, gen, dev, role, kk, n,
                                        MESH_TRAIN_ROWS * TRAIN_SEQ, peaks)
                     for role, kk, n in K3_STORE_GRAD_SHAPES]
            gc.collect()
            torch.cuda.empty_cache()
            one = mesh_one_phase(torch, np, dev, counters, card)
            meshes = {r["name"]: mesh_two_phase(torch, np, dev, card, r)
                      for r in ranks}
        finally:  # a failed phase leaves no process of its own behind
            for r in ranks:
                for p in r["procs"]:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in r["logs"]:
                    f.close()
        rows = mesh_dryrun_rows(started, card)
    print(f"phase 17 wall time {time.perf_counter() - t17:.1f} s (1x1 "
          f"{one['phase_s']:.1f}, "
          + ", ".join(f"{k} {v['phase_s']:.1f}" for k, v in meshes.items())
          + f") [{card}]", flush=True)
    return cases, one, meshes, rows


# ---------------------------------------------------------------------------
#: phase 18: kv-sequence sharding.  The cache cut by sequence ("kv_seq")
#: and q heads cut over whole kv heads, as ``rules_for`` lays them out
#: wherever the kv heads do not divide "model" (every dense arch at the
#: JAX package's 16-way "model") or the batch does not divide dp
#: (``long_500k``); ranks of this script over gloo on the one card.
#: 18b serves starcoder2-15b (48 q heads over 4 kv heads) 8 ways: 6 q heads
#: a rank, every kv head whole, its 4096-row ring cut into 512 rows a rank
KV_ARCH = "starcoder2-15b"
KV_MESH = "1x8"
#: 18a: starcoder2-15b's projections on an 8-way shard (role, K, N,
#: activation, bias, fp32 store): q cut, k and v whole, up cut; o and down
#: row-parallel on the fp32 store, as the path launches them (down's bias
#: is added after the ranks' sum)
KV_K3_SHAPES = (("q", 6144, 768, "none", True, False),
                ("kv", 6144, 512, "none", True, False),
                ("o", 768, 6144, "none", False, True),
                ("up", 6144, 3072, "gelu", True, False),
                ("down", 3072, 6144, "none", False, True))
#: 18a's K10 cases (``K10_CASES``' order) at the rank views, at 1500 and
#: 4500 tokens: starcoder2's 6 q heads over their one kv head with its
#: window; gemma2-2b's 1 q head over its one kv head (8 over 4 whole at 8
#: ways), softcap 50, its local (window 4096) and global layers
KV_K10_CASES = tuple(c for s in TP_K10_TOKENS for c in (
    (s, 4096, 0.0, "bfloat16", 6, 1, 128, True),
    (s, 4096, 50.0, "bfloat16", 1, 1, 256, True),
    (s, 0, 50.0, "bfloat16", 1, 1, 256, True)))
#: the depth of each run (layers, why); width, heads and vocab as published
KV_CUTS = {
    "serve": (1, "eight gloo ranks on one card sum o's and down's fp32 "
                 "partials of a 4500-token prefill through host memory, "
                 "about 0.8 GB received a rank a sum: 1 layer (2 before "
                 "phase 20 joined the smoke: its time)"),
    "long": (2, "one local/global pair: long_500k's rules turn FSDP on at "
                "dp 2, and a step gathers each unit's weights through gloo "
                "(1.19 s a step at 4 layers)"),
    "train": (2, "one local/global pair: eight gloo ranks exchange the "
                 "fp32 partials and the cotangents of 2048 tokens a step"),
}
#: 18b's int8 cache: one prompt of ``LM_PROMPTS`` (4500 wraps the ring
#: across the ranks), then this many steps
KV_INT8_PROMPT = 4500
KV_INT8_STEPS = 4
#: each rank's int8 cache against the reference's.  Its k and v rows are
#: bf16 sums taken in another order, a few bf16 steps apart near a row's
#: max (a bf16 step there is half an int8 step), so a value may quantize
#: ``steps`` away and a share ``apart`` of them at most differ (on the
#: 4500 prompt: 2 steps, 0.27-0.48 %); the fp16 scales, max|row| / 127,
#: within ``scale`` of the reference's, relative: two bf16 steps (at
#: most 0.0097 there)
KV_INT8_CACHE_TOL = {"steps": 2, "apart": 0.01, "scale": 2.0 ** -6}
#: 18c: gemma2-2b under ``long_500k``'s rules on a 2 x 1 mesh (batch 1,
#: replicated; the cache cut over "data"): its prompt and steps, 4 and not
#: 8: 18c runs alone (its prefill logits beside 18b's prefill ran the card
#: out of memory), and each step of its two runs costs 1.34 s (FSDP's
#: gathers through gloo) of the smoke's time
KV_LONG_MESH = "2x1"
KV_LONG_PROMPT = 4500
KV_LONG_DECODE = 4
#: 18d: gemma2-2b's train step on the 1 x 8 mesh (8 q heads over 4 whole
#: kv heads), a batch of this many rows of ``TRAIN_SEQ`` tokens
KV_TRAIN_ROWS = 1
#: each step's CE within this of the reference's (absolute; the second
#: step follows bf16 gradients summed in another order through Adam's
#: first step)
KV_TRAIN_CE_TOL = (1e-3, 1e-2)
#: the first step's grad norm within this of the reference's (relative),
#: and each ``wk``/``wv`` gradient within this of max|g| of the
#: reference's: bf16 gradients of activations that the shards' fp32 sums
#: round at other points (3.3e-4 and 0.0075-0.0119 apart on an H100; a
#: cotangent sum over "model" that drops or doubles a rank's part is off
#: by about max|g|)
KV_TRAIN_NORM_TOL = 1e-3
KV_TRAIN_GRAD_TOL = 2.0 ** -5
#: the ranks start while the references run, and wait this long (s) for
#: their inputs
KV_INPUTS_TIMEOUT = 300
#: 18e: the dry run's rows, every shape at the JAX package's two meshes
KV_DRYRUN_ARCHS = ("gemma2-2b", "starcoder2-15b", "internlm2-20b",
                   "qwen1.5-32b")
KV_DRYRUN_MESHES = ("16x16", "2x16x16")
KV_DRYRUN_PROCS = 2
#: the ranks' processes may take this long (s) before the phase fails
KV_RANK_TIMEOUT = 600


def kv_cfg(arch, layers, dtype="bfloat16", **over):
    """``arch`` at full width, ``layers`` deep, in ``dtype``."""
    import dataclasses

    from repro_torch.core.config import get_arch

    return dataclasses.replace(get_arch(arch), num_layers=layers,
                               dtype=dtype, param_dtype=dtype, **over)


def kv_kernel_cases(torch, F, dev, peaks):
    """Phase 18a: K3 at ``KV_K3_SHAPES`` at ``TP_K3_ROWS`` (o and down on
    the fp32 store) and K10 at ``KV_K10_CASES``, each held against its
    plain version, repeated, timed beside the library and printed by its
    case's function; returns the records."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for role, kk, n, act, bias, f32 in KV_K3_SHAPES:
        for m in TP_K3_ROWS:
            rows.append(k3_bf16_case(
                torch, F, gen, dev, m, kk, n, act, peaks, False, bias=bias,
                out_dtype=torch.float32 if f32 else None, ways=8, role=role,
                arch=KV_ARCH))
    for case in KV_K10_CASES:
        r = k10_case(torch, F, gen, dev, case, peaks)
        r.update(main=False, view=KV_ARCH if case[4] == 6 else LM_ARCH)
        rows.append(r)
    return rows


def kv_long_steps(cfg, mesh_cfg, mesh, params, rules):
    """18c's prefill (one request of ``KV_LONG_PROMPT`` tokens) and decode
    step (``long_500k``'s batch of 1 and window) on the rank's shards
    ``params``: (prefill, decode, model, window)."""
    from repro_torch.core.config import ShapeConfig, get_shape
    from repro_torch.launch.dryrun import _build_step

    shape = get_shape("long_500k")
    pre = ShapeConfig("prefill", KV_LONG_PROMPT, 1, "prefill")
    prefill, model = _build_step(cfg, pre, mesh_cfg, rules)(mesh, params)
    decode, _ = _build_step(cfg, shape, mesh_cfg, rules)(mesh, params)
    return prefill, decode, model, model.effective_window(shape)


def kv_long_rules(mesh_cfg):
    """``rules_for`` of the uncut gemma2-2b at ``long_500k``."""
    from repro_torch.core.config import get_arch, get_shape
    from repro_torch.sharding.auto import rules_for

    return rules_for(get_arch(LM_ARCH), mesh_cfg, get_shape("long_500k"))[0]


def kv_int8_prompt(prompts):
    """18b's int8 run's prompt, of ``tp_prompts``' ``prompts``."""
    return prompts[LM_PROMPTS.index(KV_INT8_PROMPT):][:1]


def kv_long_prompt(np, vocab):
    return [np.random.default_rng(SEED + 18).integers(
        0, vocab, (1, KV_LONG_PROMPT))]


def kv_unsharded(torch, dev, cfg, tree=None):
    """The unsharded port of ``cfg`` on ``SEED``'s draws (or ``tree``):
    (model, tree, prefill, decode at the window ``w``)."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree

    model = get_model(cfg)
    if tree is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        tree = init_tree(model.param_spec(), gen, cfg.param_dtype)
    model.load_tree(tree)

    def steps(w):
        return (lambda b, c: model.forward(b, "prefill", window_override=w,
                                           cache=c),
                lambda t, p, c: model.decode_step(t, p, c, window=w))
    return model, tree, steps


def kv_grads(grads):
    """18d's ``wk`` and ``wv`` gradients of ``grads``, on the host."""
    return {f"{u}/{n}": grads["layers"][u]["attn"][n]["w"].cpu()
            for u in ("local", "global") for n in ("wk", "wv")}


def _cpu_tree(tree):
    from repro_torch.nn.param import tree_map

    return tree_map(lambda t: t.cpu(), tree)


def _host_run(run, cache):
    return {"prefill_last": run["prefill_last"].cpu(),
            "steps": run["steps"].cpu(), "tokens": run["tokens"].cpu(),
            "ms": run["ms"], "cache": _cpu_tree(cache)}


#: the fp32 parities' cache rows: the prompt, the steps and a margin
KV_PARITY_ROWS = LM_PARITY_PROMPT + LM_PARITY_DECODE + 8


def kv_parity_prompt(np, vocab):
    return [np.random.default_rng(SEED).integers(0, vocab,
                                                 (1, LM_PARITY_PROMPT))]


def kv_publish(torch, work, part, inputs):
    """Give the ranks of ``part`` their inputs: ``work/<part>.inputs``,
    written whole, then renamed into place."""
    torch.save(inputs, work / f"{part}.tmp")
    (work / f"{part}.tmp").rename(work / f"{part}.inputs")


def kv_inputs(torch, work, part):
    """On a rank: ``part``'s inputs, once ``kv_publish`` has written
    them."""
    path = work / f"{part}.inputs"
    deadline = time.perf_counter() + KV_INPUTS_TIMEOUT
    while not path.exists():
        if time.perf_counter() > deadline:
            fail(f"no {path} after {KV_INPUTS_TIMEOUT} s")
        time.sleep(0.2)
    return torch.load(path)


def kv_references(torch, np, dev, work):
    """The unsharded references on the card, each freed before the next,
    while the ranks start up: 18d's two train steps (``mesh_reference``:
    the batches go to ``work``); 18b's bf16 run (``LM_PROMPTS`` into
    ``LM_MAX_BATCH`` slots, ``TP_DECODE`` steps) and int8 run (their
    tokens, which the ranks are forced to); 18c's bf16 run (its tokens)
    and fp32 parity; 18b's fp32 parity (one layer, greedy).  Returns the
    records, on the host."""
    from repro_torch.core.config import get_shape
    from repro_torch.launch.mesh import parse_mesh

    out = {}
    long_shape = get_shape("long_500k")
    grads = {}
    out["train"], _, out["train_ms"] = mesh_reference(
        torch, np, dev, mesh_cfg_at(KV_CUTS["train"][0]),
        parse_mesh(KV_MESH), 1, work, rows=KV_TRAIN_ROWS,
        first=lambda _, step: grads.update(kv_grads(step.grads)))
    out["train_grads"] = grads
    gc.collect()
    torch.cuda.empty_cache()
    # 18b: bf16 and int8 on the same draws
    cfg = kv_cfg(KV_ARCH, KV_CUTS["serve"][0])
    prompts = tp_prompts(np, cfg.vocab_size)
    model, tree, steps = kv_unsharded(torch, dev, cfg)
    cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
    out["serve"] = _host_run(tp_serve(torch, *steps(0), cache, prompts,
                                      TP_DECODE), cache)
    model, _, steps = kv_unsharded(torch, dev, kv_cfg(
        KV_ARCH, KV_CUTS["serve"][0], kv_quant=True), tree)
    cache = model.init_cache(1, LM_MAX_LEN)
    out["int8"] = _host_run(tp_serve(torch, *steps(0), cache,
                                     kv_int8_prompt(prompts), KV_INT8_STEPS),
                            cache)
    del model, tree, cache
    # 18c at long_500k's window, then 18b's fp32 parity (no window at its
    # rows)
    runs = (("long", kv_cfg(LM_ARCH, KV_CUTS["long"][0]), long_shape.seq_len,
             kv_long_prompt, KV_LONG_DECODE, True),
            ("long_parity", kv_cfg(LM_ARCH, KV_CUTS["long"][0], "float32"),
             long_shape.seq_len, kv_long_prompt, KV_LONG_DECODE, True),
            ("serve_parity", kv_cfg(KV_ARCH, TP_PARITY_LAYERS, "float32"),
             KV_PARITY_ROWS, kv_parity_prompt, LM_PARITY_DECODE - 1, False))
    for key, cfg, rows, prompt, n, long in runs:
        gc.collect()
        torch.cuda.empty_cache()
        model, _, steps = kv_unsharded(torch, dev, cfg)
        window = model.effective_window(long_shape) if long else 0
        cache = model.init_cache(1, rows, window)
        out[key] = _host_run(tp_serve(torch, *steps(window), cache,
                                      prompt(np, cfg.vocab_size), n), cache)
        del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kv_spawn(work, mesh, parts, label):
    """Start this script once a rank of ``mesh`` (``--kv-rank``) over a
    gloo group in ``work``, each rank running ``parts``."""
    from repro_torch.launch.mesh import parse_mesh

    work.mkdir(exist_ok=True)
    world = parse_mesh(mesh).num_devices
    (work / "case.json").write_text(json.dumps({"mesh": mesh,
                                                "parts": parts}))
    env = dict(os.environ, MKL_CBWR=MKL_CBWR, OMP_NUM_THREADS="1")
    logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seed", str(SEED),
         "--kv-rank", str(r), "--kv-world", str(world), "--kv-work",
         str(work)], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=str(ROOT)) for r in range(world)]
    return work, procs, logs, label


def kv_wait(torch, started):
    """The records of ``kv_spawn``'s ranks, once each has exited 0."""
    work, procs, logs, label = started
    try:
        deadline = time.perf_counter() + KV_RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    # every failed rank's tail: the first to fail may not be the first
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        fail(f"{label}: ranks {failed} failed\n" + "\n".join(
            f"-- rank {r} exited {procs[r].returncode}:\n"
            + (work / f"rank{r}.log").read_text()[-3000:] for r in failed))
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def kv_rank_main(args) -> int:
    """One rank of phases 18b-18d, 19b-19d and 20b-20d (``--kv-rank``):
    the mesh and the parts of ``case.json``; see ``kv_phase``,
    ``moe_mesh_phase`` and ``ssm_mesh_phase``."""
    os.environ["MKL_CBWR"] = MKL_CBWR
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh, parse_mesh

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: a rank needs the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(torch)
    _build.library()
    work, rank = Path(args.kv_work), args.kv_rank
    case = json.loads((work / "case.json").read_text())
    if {"train", "moe_train", "ssm_train"} & set(case["parts"]):
        # the first torch.utils.checkpoint call imports it (about 10 s):
        # here, while 18a and the references run
        import torch._dynamo  # noqa: F401
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=args.kv_world)
    try:
        mesh_cfg = parse_mesh(case["mesh"])
        mesh = make_mesh(mesh_cfg, "cuda", backend="gloo")
        coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                           mesh.get_coordinate())))
        rec = {"coords": coords}
        for part in case["parts"]:
            fn = {"serve": kv_rank_serve, "int8": kv_rank_int8,
                  "long": kv_rank_long, "train": kv_rank_train,
                  "qwen": moe_rank_serve("qwen"),
                  "grok": moe_rank_serve("grok"),
                  "moe_train": moe_rank_train,
                  "rwkv": ssm_rank_serve("rwkv"),
                  "zamba": ssm_rank_serve("zamba"),
                  "ssm_train": ssm_rank_train}[part]
            inputs = kv_inputs(torch, work.parent, part)
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            rec[part] = fn(torch, np, dev, mesh, mesh_cfg, work.parent,
                           inputs)
            rec[part]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec[part]["part_s"] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
        torch.save(rec, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def _kv_counters():
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops

    return {"K3": mm_ops.matmul_fused, "K10": attn_ops.flash_attention}


def kv_rank_run(torch, prefill, decode, cache, prompts, steps, forced=None,
                counters=None):
    """One sharded serving run of a rank: ``tp_serve`` with the counters
    (``_kv_counters``' by default; ``forced``: the reference's tokens,
    else greedy), then its first step again on the cache as it stood
    before it.  Returns the logits, tokens, launches, times, collectives
    (a step's, the prefills'), the fp32 stores, the repeat's verdict and
    the cache, on the host."""
    from repro_torch.sharding import collectives

    counters = counters or _kv_counters()
    stores = counters["K3"].entry_launches
    for k in stores:
        stores[k] = 0
    collectives.reset_counts()
    run = tp_serve(torch, prefill, decode, cache, prompts, steps, counters,
                   forced=forced, snapshot=True)
    store_launches = dict(stores)
    run_counts = collectives.counts_by_name()
    with torch.no_grad():
        collectives.reset_counts()
        again = decode(*run["first"], run["snapshot"])[0][:, 0].float()
        step_counts = collectives.counts_by_name()
    rec = _host_run(run, cache)
    rec.update(repeat_equal=torch.equal(again, run["steps"][0]),
               launches=run["launches"], k3_paths=run["k3_paths"],
               k10_paths=run["k10_paths"], store_launches=store_launches,
               collectives_step=step_counts,
               collectives_prefills={
                   k: v["calls"] - step_counts.get(k, {}).get("calls", 0)
                   * steps for k, v in run_counts.items()},
               collectives_prefill_bytes={
                   k: v["bytes"] - step_counts.get(k, {}).get("bytes", 0)
                   * steps for k, v in run_counts.items()})
    return rec


def kv_rank_serve(torch, np, dev, mesh, mesh_cfg, work, forced):
    """18b on a rank: starcoder2-15b's shards (``shard_init``: the
    reference's draws) under ``tp_rules``; the bf16 run on the reference's
    tokens and the fp32 parity, greedy."""
    from repro_torch.models.transformer import shard_init

    cfg = kv_cfg(KV_ARCH, KV_CUTS["serve"][0])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    local = shard_init(cfg, gen, mesh, tp_rules(cfg, mesh_cfg))
    prompts = tp_prompts(np, cfg.vocab_size)
    prefill, decode, model = tp_steps(cfg, mesh_cfg, mesh, local)
    rec = kv_rank_run(torch, prefill, decode,
                      model.init_cache(LM_MAX_BATCH, LM_MAX_LEN), prompts,
                      TP_DECODE, forced["serve"])
    del local, prefill, decode, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = kv_cfg(KV_ARCH, TP_PARITY_LAYERS, "float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    local = shard_init(cfg, gen, mesh, tp_rules(cfg, mesh_cfg, 1,
                                                KV_PARITY_ROWS))
    prefill, decode, model = tp_steps(cfg, mesh_cfg, mesh, local, 1,
                                      KV_PARITY_ROWS)
    rec["parity"] = kv_rank_run(torch, prefill, decode,
                                model.init_cache(1, KV_PARITY_ROWS),
                                kv_parity_prompt(np, cfg.vocab_size),
                                LM_PARITY_DECODE - 1)
    return rec


def kv_rank_int8(torch, np, dev, mesh, mesh_cfg, work, forced):
    """18b's int8 cache on a rank: ``kv_rank_serve``'s shards, one prompt
    (``kv_int8_prompt``) and ``KV_INT8_STEPS`` steps on the reference's
    tokens."""
    import dataclasses

    from repro_torch.models.transformer import shard_init

    cfg = kv_cfg(KV_ARCH, KV_CUTS["serve"][0])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    local = shard_init(cfg, gen, mesh, tp_rules(cfg, mesh_cfg))
    prefill, decode, model = tp_steps(
        dataclasses.replace(cfg, kv_quant=True), mesh_cfg, mesh, local, 1)
    return kv_rank_run(torch, prefill, decode,
                       model.init_cache(1, LM_MAX_LEN),
                       kv_int8_prompt(tp_prompts(np, cfg.vocab_size)),
                       KV_INT8_STEPS, forced["int8"])


def kv_rank_long(torch, np, dev, mesh, mesh_cfg, work, forced):
    """18c on a rank: gemma2-2b's shards under ``long_500k``'s rules
    (``kv_long_rules``); the bf16 run on the reference's tokens and the
    fp32 parity, greedy, each a ``KV_LONG_PROMPT``-token prompt and
    ``KV_LONG_DECODE`` steps."""
    from repro_torch.core.config import get_shape
    from repro_torch.models.transformer import shard_init

    rules = kv_long_rules(mesh_cfg)
    rows = get_shape("long_500k").seq_len
    out = {}
    for key, dtype, tokens in (("bf16", "bfloat16", forced["long"]),
                               ("parity", "float32", None)):
        cfg = kv_cfg(LM_ARCH, KV_CUTS["long"][0], dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        local = shard_init(cfg, gen, mesh, rules)
        prefill, decode, model, window = kv_long_steps(cfg, mesh_cfg, mesh,
                                                       local, rules)
        out[key] = kv_rank_run(torch, prefill, decode,
                               model.init_cache(1, rows, window),
                               kv_long_prompt(np, cfg.vocab_size),
                               KV_LONG_DECODE, tokens)
        del local, prefill, decode, model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def kv_rank_train(torch, np, dev, mesh, mesh_cfg, work, forced):
    """18d on a rank: gemma2-2b's train step through the dry run's
    ``_build_step`` on ``mesh_rules``' shards, ``MESH_TRAIN_STEPS`` steps
    on the reference's batches, the first twice from the same state:
    each step's metrics, launches, collectives and the fingerprints of
    its ``wk``/``wv`` gradients (rank 0: the first step's values too);
    the repeat's verdict."""
    import torch.distributed as dist

    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.models.transformer import shard_init
    from repro_torch.nn.param import tree_leaves
    from repro_torch.sharding import collectives
    from repro_torch.train.optimizer import adamw_init

    cfg = mesh_cfg_at(KV_CUTS["train"][0])
    rows = KV_TRAIN_ROWS
    rules = mesh_rules(mesh_cfg, rows)

    def draw():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return shard_init(cfg, gen, mesh, rules)

    local = draw()
    step, _ = _build_step(cfg, ShapeConfig("train", TRAIN_SEQ, rows,
                                           "train"), mesh_cfg, rules,
                          tcfg=mesh_tcfg(), microbatches=1)(mesh, local)
    opt = adamw_init(local, step.plan())
    batches = [{k: v.to(dev) for k, v in b.items()}
               for b in torch.load(work / "batches.pt")]
    k3, k10 = _kv_counters().values()

    def one(batch, keep=False):
        for fn in (k3, k10):
            fn.launches = 0
        for key in k3.role_launches:
            k3.role_launches[key] = 0
        collectives.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        grads, m = step.accumulate(local, batch)
        kv = {f"{u}/{n}": bits_fingerprint(
            torch, grads["layers"][u]["attn"][n]["w"])
            for u in ("local", "global") for n in ("wk", "wv")}
        # rank 0's, held against the reference's (the ranks' bits agree)
        kept = kv_grads(grads) if keep and dist.get_rank() == 0 else None
        _, _, m = step.finish(local, opt, grads, m)
        torch.cuda.synchronize()
        return {"metrics": {k: v.item() for k, v in m.items()},
                "ms": 1e3 * (time.perf_counter() - t),
                "launches": {"K3": dict(k3.role_launches),
                             "K10": k10.launches},
                "collectives": collectives.counts_by_name(),
                "kv_grads": kv, "kv_grad_values": kept}

    first = one(batches[0], keep=True)
    prints = mesh_fingerprints(torch, local)
    for t_, s_ in zip(tree_leaves(local), tree_leaves(draw())):
        t_.copy_(s_)
    for t_ in tree_leaves(opt):
        t_.zero_()
    again = one(batches[0])
    repeat = (prints == mesh_fingerprints(torch, local)
              and again["metrics"] == first["metrics"]
              and again["kv_grads"] == first["kv_grads"])
    return {"steps": [first, one(batches[1])], "repeat_ms": again["ms"],
            "repeat_equal": repeat,
            "heads": [rules.lookup("heads"), rules.lookup("kv_heads")]}


def _tree_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _tree_get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def kv_check_run(torch, label, ranks, recs, ref, layers, per_layer,
                 mesh_cfg, rules, tol, greedy=False, skip=None,
                 deep_tol=None):
    """The holds of 18b and 18c on the ranks' runs ``recs`` (one a rank)
    against the unsharded ``ref``: the logits within ``tol[kind]`` x
    max(1, |ref|) (``greedy``: the tokens the reference's; else an argmax
    apart only at a near tie), the same bits on every rank, the repeat's
    bits, each rank's cache rows the matching rows of the reference's
    cache (within ``LM_CACHE_TOL["bfloat16"]`` of max(1, |ref|); an int8
    cache's values as ``KV_INT8_CACHE_TOL`` says; ``skip`` [slots, S]:
    rows of the global cache left out, those of tokens an MoE block routed
    apart; ``deep_tol``: the limit of every layer's rows but the first,
    in place of ``LM_CACHE_TOL``'s); the launches a call
    (K3 ``per_layer`` a layer, K10 one a layer in a prefill).  Returns
    (worst errors, with the int8 values' steps and share apart, and the
    argmaxes apart at near ties)."""
    from repro_torch.sharding.rules import local_slice, logical_to_spec

    worst, parted = {}, []
    for name, key in (("prefill", "prefill_last"), ("decode", "steps")):
        want, got = ref[key], recs[0][key]
        lim = tol[name] * max(1.0, want.abs().max().item())
        worst[name] = _check_close(f"{label} {name} logits", got, want, lim)
        g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                            want.shape[-1])
        pick = g.argmax(-1)
        apart = pick != w.argmax(-1)
        if bool((w.gather(1, pick[:, None])[:, 0] < w.max(-1).values - lim)
                [apart].any()):
            fail(f"{label}: a {name} argmax parts from the reference's "
                 f"past a near tie")
        parted.append(int(apart.sum()))
    if greedy and not torch.equal(recs[0]["tokens"], ref["tokens"]):
        fail(f"{label}: tokens {recs[0]['tokens'].tolist()}, the "
             f"reference's {ref['tokens'].tolist()}")
    for r, (rank, rec) in enumerate(zip(ranks, recs)):
        for key in ("prefill_last", "steps", "tokens"):
            if not torch.equal(rec[key], recs[0][key]):
                fail(f"{label}: rank {r}'s {key} differ from rank 0's")
        if not rec["repeat_equal"]:
            fail(f"{label} rank {r}: a repeat of the first step differs")
        for kind, want in (("prefill", {"K3": per_layer * layers,
                                        "K10": layers}),
                           ("decode", {"K3": per_layer * layers, "K10": 0})):
            for i, got in enumerate(rec["launches"][kind]):
                if got != want:
                    fail(f"{label} rank {r}: {kind} {i} launched {got}, "
                         f"not {want}")
        err, apart = 0.0, {}

        def mine(tree, path, t):
            spec = logical_to_spec(
                ("layers", "batch", "kv_seq", "kv_heads", None)[:t.dim()],
                mesh_cfg.axes, rules)
            return local_slice(_tree_get(tree, path), spec, mesh_cfg,
                               rank["coords"])

        for path, t in _tree_items(rec["cache"]):
            want = mine(ref["cache"], path, t)
            name = f"{label} rank {r} cache {path}"
            if t.dtype == torch.int8:
                d = (t.int() - want.int()).abs()
                apart[path] = [d.max().item(), d.ne(0).float().mean().item()]
                if (apart[path][0] > KV_INT8_CACHE_TOL["steps"] or
                        apart[path][1] > KV_INT8_CACHE_TOL["apart"]):
                    fail(f"{name}: int8 values {apart[path][0]} steps and "
                         f"{apart[path][1]:.4%} apart")
            elif path.endswith("_scale"):  # relative; 0 where both are 0
                w = want.float()
                apart[path] = ((t.float() - w).abs()
                               / w.abs().clamp_min(1e-30)).max().item()
                if not apart[path] <= KV_INT8_CACHE_TOL["scale"]:
                    fail(f"{name}: scales {apart[path]:.3e} apart")
            else:
                got, want = t.float(), want.float()
                if skip is not None:
                    whole = _tree_get(ref["cache"], path)
                    left = local_slice(skip.reshape(1, *skip.shape, *(
                        [1] * (whole.dim() - 3))).expand(whole.shape),
                        logical_to_spec(("layers", "batch", "kv_seq",
                                         "kv_heads", None)[:t.dim()],
                                        mesh_cfg.axes, rules), mesh_cfg,
                        rank["coords"])
                    got, want = (torch.where(left, 0.0, v)
                                 for v in (got, want))
                top = max(1.0, want.abs().max().item())
                if deep_tol is None:
                    err = max(err, _check_close(
                        name, got, want, LM_CACHE_TOL["bfloat16"] * top))
                else:
                    err = max(err, _check_close(
                        f"{name} layer 0", got[0], want[0],
                        LM_CACHE_TOL["bfloat16"] * top))
                    deep = _check_close(f"{name} layers 1-", got[1:],
                                        want[1:], deep_tol * top)
                    worst[f"cache_deep_rank{r}"] = max(
                        deep, worst.get(f"cache_deep_rank{r}", 0.0))
        worst[f"cache_rank{r}"] = err
        if apart:
            worst[f"int8_rank{r}"] = apart
    return worst, parted


def kv_check_collectives(label, recs, want):
    """Each rank's collectives a decode step: the calls ``want``, and
    besides them only FSDP's gathers over the data axes (the rules cut
    "embed" over "data" where a model's weights pass 1.5 GiB a card)."""
    for r, rec in enumerate(recs):
        got = {k: v["calls"] for k, v in rec["collectives_step"].items()}
        other = [k for k in got if k not in want and not (
            k.startswith("gather_over/") and "model" not in k)]
        if other or any(got.get(k) != v for k, v in want.items()):
            fail(f"{label} rank {r}: a step's collectives {got}, not "
                 f"{want} and FSDP's gathers")


def kv_summary(recs, ref):
    """A run's numbers for the record: the ranks' times and the
    reference's."""
    return {"prefill_ms": [r["ms"]["prefill"] for r in recs],
            "step_ms": [statistics.median(r["ms"]["decode"]) for r in recs],
            "reference_prefill_ms": ref["ms"]["prefill"],
            "reference_step_ms": statistics.median(ref["ms"]["decode"]),
            "collectives_a_step": recs[0]["collectives_step"],
            "collectives_prefills": recs[0]["collectives_prefills"],
            "per_rank": [{"launches": tp_sum_launches(r["launches"]),
                          "k3_paths": r["k3_paths"],
                          "store_launches": r["store_launches"]}
                         for r in recs]}


def kv_phase(torch, F, np, dev, peaks, card):
    """Phase 18: 18a the kernels at the new shard shapes; 18b starcoder2
    served on a 1 x 8 gloo mesh (the cache cut over "model", 6 q heads a
    rank over every kv head), bf16, int8 and an fp32 parity; 18c
    gemma2-2b under ``long_500k``'s rules on 2 x 1 (batch 1, the cache
    cut over "data"); 18d gemma2-2b's train step on 1 x 8 (one q head a
    rank over 4 whole kv heads); 18e the dry run's dense rows at the JAX
    package's meshes, all traced (two processes beside the rest).  The
    ranks of both meshes start first (the 1 x 8 ranks run 18b's bf16 run
    and parity, 18d, then 18b's int8 run; the 2 x 1 ranks 18c) and wait
    while 18a and the unsharded references run here on the card; then 18c
    runs, and once its ranks are done, the 1 x 8 ranks' parts (the card
    does not hold 18c's prefill logits beside 18b's prefill).  Returns the
    record."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh

    t18 = time.perf_counter()
    out = {"card": card, "reduced": {k: {"num_layers": v[0], "why": v[1]}
                                     for k, v in KV_CUTS.items()}}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        started = mesh_dryrun_start(work, "kv", KV_DRYRUN_PROCS)
        ranks = []
        try:
            # both meshes' ranks start up beside 18a and the references,
            # and run side by side as the references publish their inputs
            ranks += [kv_spawn(work / "b", KV_MESH,
                               ["serve", "train", "int8"], "18b/18d"),
                      kv_spawn(work / "c", KV_LONG_MESH, ["long"], "18c")]
            out["cases"] = kv_kernel_cases(torch, F, dev, peaks)
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = kv_references(torch, np, dev, work)
            gc.collect()
            torch.cuda.empty_cache()
            out["references_s"] = time.perf_counter() - t
            # 18c's ranks first, then the 1 x 8 ranks' parts: 18c's
            # prefill logits (4500 x 256000 in fp32 and their softcap,
            # 15 GB a rank) beside 18b's 4500-token prefill ran the card
            # out of memory
            kv_publish(torch, work, "long", {"long": ref["long"]["tokens"]})
            two = kv_wait(torch, ranks[1])
            kv_publish(torch, work, "serve", {"serve": ref["serve"]["tokens"]})
            kv_publish(torch, work, "train", {})
            kv_publish(torch, work, "int8", {"int8": ref["int8"]["tokens"]})
            eight = kv_wait(torch, ranks[0])
            out["ranks_s"] = time.perf_counter() - t - out["references_s"]
            rows = dryrun_collect(started, "18e")
        finally:  # a failed phase leaves no process of its own behind
            procs = [p for p, _, _ in started] + [
                p for _, group, _, _ in ranks for p in group]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in [log for _, _, log in started] + [
                    f for _, _, logs, _ in ranks for f in logs]:
                log.close()
    # 18b
    layers = KV_CUTS["serve"][0]
    per_layer = K3_DENSE_PER_LAYER[KV_ARCH]
    m8 = parse_mesh(KV_MESH)
    label = f"{KV_ARCH} {KV_MESH} kv_seq"
    cfg = kv_cfg(KV_ARCH, layers)
    rules = tp_rules(cfg, m8)
    if rules.lookup("kv_seq") != ("model",) or rules.lookup("kv_heads"):
        fail(f"{label}: the rules cut {rules.lookup('kv_seq')} and "
             f"{rules.lookup('kv_heads')}, not the sequence over 'model'")
    serve = [r["serve"] for r in eight]
    b = {}
    b["worst"], b["parted"] = kv_check_run(
        torch, label, eight, serve, ref["serve"], layers, per_layer, m8,
        rules, {"prefill": TP_BF16_TOL, "decode": TP_BF16_TOL})
    kv_check_collectives(label, serve, {
        "max_over/model": layers, "sum_over/model": 4 * layers + 1,
        "gather_over/model": layers + 1})
    q = [r["int8"] for r in eight]
    b["int8_worst"], b["int8_parted"] = kv_check_run(
        torch, f"{label} int8", eight, q, ref["int8"], layers, per_layer,
        m8, rules, {"prefill": TP_BF16_TOL, "decode": TP_BF16_TOL})
    par = [r["parity"] for r in serve]
    b["parity_worst"], _ = kv_check_run(
        torch, f"{label} fp32 parity", eight, par, ref["serve_parity"],
        TP_PARITY_LAYERS, per_layer, m8,
        tp_rules(cfg, m8, 1, KV_PARITY_ROWS), LM_TOL, greedy=True)
    b.update(kv_summary(serve, ref["serve"]),
             int8=kv_summary(q, ref["int8"]),
             peak_memory_gb=[r["peak_gb"] for r in serve],
             part_s=[r["part_s"] for r in serve],
             int8_part_s=[r["part_s"] for r in q],
             tokens=serve[0]["tokens"].tolist())
    out["serve"] = b
    print("kv18b " + json.dumps(b), flush=True)
    # 18c
    layers = KV_CUTS["long"][0]
    m2 = parse_mesh(KV_LONG_MESH)
    label = f"{LM_ARCH} {KV_LONG_MESH} long_500k kv_seq"
    rules = kv_long_rules(m2)
    if rules.lookup("kv_seq") != ("data",) or rules.lookup("batch"):
        fail(f"{label}: the rules cut the sequence over "
             f"{rules.lookup('kv_seq')} and the batch over "
             f"{rules.lookup('batch')}")
    c = {}
    runs = [r["long"]["bf16"] for r in two]
    c["worst"], c["parted"] = kv_check_run(
        torch, label, two, runs, ref["long"], layers, 7, m2, rules,
        {"prefill": TP_BF16_TOL, "decode": TP_BF16_TOL})
    kv_check_collectives(label, runs, {"max_over/data": layers,
                                       "sum_over/data": 2 * layers})
    c["parity_worst"], _ = kv_check_run(
        torch, f"{label} fp32 parity", two, [r["long"]["parity"]
                                              for r in two],
        ref["long_parity"], layers, 7, m2, rules, LM_TOL, greedy=True)
    c.update(kv_summary(runs, ref["long"]),
             part_s=[r["long"]["part_s"] for r in two],
             tokens=runs[0]["tokens"].tolist())
    out["long"] = c
    print("kv18c " + json.dumps(c), flush=True)
    # 18d
    label = f"{LM_ARCH} train {KV_MESH}"
    train = [r["train"] for r in eight]
    if train[0]["heads"] != ["model", None]:
        fail(f"{label}: q and kv heads cut as {train[0]['heads']}")
    d = {"ce": [], "ce_err": []}
    for i, want in enumerate(ref["train"]):
        got = [t["steps"][i]["metrics"] for t in train]
        if any(g != got[0] for g in got):
            fail(f"{label}: step {i + 1}'s metrics differ between ranks")
        err = abs(got[0]["ce"] - want["ce"])
        d["ce"].append([got[0]["ce"], want["ce"]])
        d["ce_err"].append(err)
        if not err <= KV_TRAIN_CE_TOL[i]:
            fail(f"{label}: step {i + 1}'s CE {got[0]['ce']}, the "
                 f"reference's {want['ce']}, {err} apart")
        kv = [t["steps"][i]["kv_grads"] for t in train]
        if any(k != kv[0] for k in kv):
            fail(f"{label}: step {i + 1}'s wk/wv gradients differ between "
                 f"ranks")
    # the backward of the kv heads' selection (copy_to's sum over
    # "model"): the first step's gradients against the reference's
    got, want = train[0]["steps"][0]["metrics"], ref["train"][0]
    d["grad_norm"] = [got["grad_norm"], want["grad_norm"]]
    d["grad_norm_err"] = abs(got["grad_norm"] - want["grad_norm"]) / abs(
        want["grad_norm"])
    d["kv_grad_err"] = {}
    for path, g in train[0]["steps"][0]["kv_grad_values"].items():
        w = ref["train_grads"][path].float()
        d["kv_grad_err"][path] = (g.float() - w).abs().max().item() / (
            w.abs().max().item())
    print(f"{label}: step 1's grad norm {d['grad_norm_err']:.3e} apart "
          f"(relative), wk/wv gradients {d['kv_grad_err']} (of max|g|)",
          flush=True)
    if not d["grad_norm_err"] <= KV_TRAIN_NORM_TOL:
        fail(f"{label}: step 1's grad norm {d['grad_norm']} (sharded, "
             f"reference)")
    if not max(d["kv_grad_err"].values()) <= KV_TRAIN_GRAD_TOL:
        fail(f"{label}: step 1's wk/wv gradients {d['kv_grad_err']} of "
             f"max|g| from the reference's")
    expect = train_expect(mesh_cfg_at(KV_CUTS["train"][0]))
    want = {"K3": {"forward": expect["K3_forward"] + expect["K3_recompute"],
                   "z": expect["K3_z"], "dx": expect["K3_dx"],
                   "dw": expect["K3_dw"]},
            "K10": expect["K10_forward"] + expect["K10_backward"]}
    for r, t in enumerate(train):
        if not t["repeat_equal"]:
            fail(f"{label} rank {r}: the first step again differs")
        for s in t["steps"]:
            if s["launches"] != want:
                fail(f"{label} rank {r}: launches {s['launches']}, not "
                     f"{want}")
    d.update(step_ms=[[s["ms"] for s in t["steps"]] for t in train],
             reference_step_ms=ref["train_ms"],
             collectives_a_step=mesh_split(train[0]["steps"][0][
                 "collectives"]),
             launches=train[0]["steps"][0]["launches"],
             peak_memory_gb=[t["peak_gb"] for t in train])
    out["train"] = d
    print("kv18d " + json.dumps(d), flush=True)
    # 18e
    for rec in rows:
        print("kv18e " + dryrun.summary(rec) + f" [{card}]", flush=True)
    missed = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in rows
              if not r["traced"]]
    if missed or len(rows) != len(dryrun_combos("kv")):
        fail(f"18e: {len(rows)} rows, not traced: {missed}")
    out["dryrun"] = [{k: r[k] for k in ("arch", "shape", "mesh", "fits",
                                        "traced", "per_device_bytes",
                                        "collectives")} for r in rows]
    out["phase_s"] = time.perf_counter() - t18
    print(f"phase 18 wall time {out['phase_s']:.1f} s (references "
          f"{out['references_s']:.1f}, then the ranks {out['ranks_s']:.1f}; "
          f"1x8 parts {b['part_s'][0]:.1f} + "
          f"{eight[0]['train']['part_s']:.1f} + {b['int8_part_s'][0]:.1f}, "
          f"2x1 "
          f"{c['part_s'][0]:.1f}) [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
#: phase 19: the MoE block on a mesh, ranks of this script over gloo on the
#: one card.  19b serves qwen3-moe-30b-a3b with its 128 experts cut over
#: "model" (32 a rank), 19c grok-1-314b with each expert's d_ff of 32768
#: cut (8192 a rank), both on 1 x 4 and ``rules_for``'s rules; 19d trains
#: qwen3-moe on 2 x 2 (one token group a data rank, FSDP's "embed")
MOE_MESH = "1x4"
MOE_TRAIN_MESH = "2x2"
MOE_GROK_ARCH = "grok-1-314b"
#: the depth of each run (layers, why); width, heads, experts and vocab as
#: published
MOE_CUTS = {
    "qwen": (2, "four gloo ranks on one card exchange the picked expert "
                "rows of a 4500-token prefill through host memory (147 MB "
                "a layer in bf16) and gather its 2.7-GB fp32 logits: 2 "
                "layers (4 before phase 20 joined the smoke: its time)"),
    "grok": (2, "9.84 GB a layer: the four ranks' shards and the unsharded "
                "reference, run first and freed, each hold a whole model "
                "on the one card"),
    "train": (1, "a train step of 2 x 2048 tokens on four gloo ranks, "
                 "FSDP's gathers and the picked rows' exchange through host "
                 "memory: 1 layer (2 before phase 20 joined the smoke: its "
                 "time)"),
}
#: 19b's and 19c's prompts (of ``tp_prompts``) and decode steps on the
#: reference's tokens; grok without the 4500-token prompt, whose experts'
#: fp32 partials (442 MB a layer a rank) took 11.6 s of the smoke's time
MOE_PROMPTS = {"qwen": LM_PROMPTS, "grok": LM_PROMPTS[:3]}
MOE_DECODE = {"qwen": 8, "grok": 4}
#: a token's chosen experts may part from the reference's only where its
#: k-th and (k+1)-th router probabilities lie within this (a near tie),
#: and at most this share of a run's tokens (prompts and decode steps)
#: may part in any layer, as ``tests/test_torch_dense_archs.py``'s
#: ``MOST_PARTED`` rules a prompt's (on the card qwen3's 16-token prompt
#: parted 2 tokens at near ties in its fourth layer: a prompt's share is
#: too coarse below 16 tokens)
MOE_NEAR_TIE = 2.0 ** -8
MOE_MOST_PARTED = 1.0 / 16
#: 19d: bf16, a data rank's rows of ``TRAIN_SEQ`` tokens, each step's
#: metrics (CE and both aux losses) within this of the unsharded step's on
#: the global batch grouped by the mesh's dp (relative to max(1, |ref|);
#: the second step follows bf16 gradients summed in another order through
#: Adam's first step).  In fp32 the steps gave 1.1e-6 at most, but FSDP
#: gathered twice the bytes through gloo: 12.3-13.3 s a step
MOE_TRAIN_DTYPE = "bfloat16"
MOE_TRAIN_ROWS = 1
MOE_TRAIN_TOL = (1e-4, 1e-3)
#: 19a: K3 at the slice's rank shapes (arch, role, K, N, rows, fp32
#: store): qwen3's q (8 heads), k/v (1 kv head) and o at 1 x 4, grok's q
#: (12 heads), k/v (2 kv heads), o, and an expert's down product on the
#: fp32 store (each expert's 8192 ff columns; 2250 rows: the capacity of
#: a 4500-token prefill, 8: a decode step's at 4 slots)
MOE_K3_SHAPES = (
    (MOE_ARCH, "q", 2048, 1024, TP_K3_ROWS, False),
    (MOE_ARCH, "kv", 2048, 128, TP_K3_ROWS, False),
    (MOE_ARCH, "o", 1024, 2048, TP_K3_ROWS, True),
    (MOE_GROK_ARCH, "q", 6144, 1536, TP_K3_ROWS, False),
    (MOE_GROK_ARCH, "kv", 6144, 256, TP_K3_ROWS, False),
    (MOE_GROK_ARCH, "o", 1536, 6144, TP_K3_ROWS, True),
    (MOE_GROK_ARCH, "expert_down", 8192, 6144, (8, 2250), True))
#: 19a's K10 cases at the rank views: qwen3's 8 q heads over its 1 kv
#: head, grok's 12 over 2 with softcap 30, at 1500 and 4500 tokens
MOE_K10_CASES = tuple(c for s in TP_K10_TOKENS for c in (
    (s, 0, 0.0, "bfloat16", 8, 1, 128, True),
    (s, 0, 30.0, "bfloat16", 12, 2, 128, True)))
#: 19e: the dry run's rows, every shape of both MoE archs at the JAX
#: package's two meshes
MOE_DRYRUN_ARCHS = (MOE_ARCH, MOE_GROK_ARCH)
MOE_DRYRUN_PROCS = 2


def moe_arch(key):
    return MOE_GROK_ARCH if key == "grok" else MOE_ARCH


def moe_k3_per_layer(cfg):
    """K3 launches a layer of a sharded prefill or decode step: q, k, v,
    o, and where each expert's ff axis is cut, every expert's down partial
    on the fp32 store (grok: 8)."""
    return 4 + (cfg.moe.num_experts if cfg.moe.shard_mode == "tensor"
                else 0)


def moe_kernel_mesh_cases(torch, F, dev, peaks):
    """Phase 19a: K3 at ``MOE_K3_SHAPES`` (o and the experts' down on the
    fp32 store) and K10 at ``MOE_K10_CASES``, each held against its plain
    version, repeated, timed beside the library and printed by its case's
    function; returns the records."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for arch, role, kk, n, ms, f32 in MOE_K3_SHAPES:
        for m in ms:
            rows.append(k3_bf16_case(
                torch, F, gen, dev, m, kk, n, "none", peaks, False,
                out_dtype=torch.float32 if f32 else None, ways=4, role=role,
                arch=arch))
    for case in MOE_K10_CASES:
        r = k10_case(torch, F, gen, dev, case, peaks)
        r.update(main=False, ways=4,
                 view=MOE_ARCH if case[4] == 8 else MOE_GROK_ARCH)
        rows.append(r)
    return rows


@contextlib.contextmanager
def route_log(torch, log):
    """Every MoE call's routing while inside (``repro_torch.nn.moe.route``
    wrapped): its mode, capacity, chosen experts [D, T_l, k] and each
    token's margin between its k-th and (k+1)-th router probability, on
    the host."""
    from repro_torch.nn import moe

    real = moe.route

    def wrapped(params, x, cfg, **kw):
        r = real(params, x, cfg, **kw)
        k = cfg.moe.num_experts_per_token
        top = torch.topk(r.probs, k + 1, dim=-1).values
        log.append({"mode": kw.get("mode", "train"), "cap": r.cap,
                    "experts": r.e_k.cpu(),
                    "margin": (top[..., k - 1] - top[..., k]).cpu()})
        return r

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = real


def moe_check_routing(label, ref, got, layers):
    """The ranks' MoE calls against the reference's, call by call (the
    reference's count; a rank's repeat of the first step comes after),
    ``layers`` calls a prefill or a decode step: the same mode and
    capacity; in each prefill's or step's first MoE layer, whose input
    parts from the reference's by the attention's rounding alone, the
    same set of experts but at a near tie (``MOE_NEAR_TIE``).  In a later
    layer a token may part too: a token routed apart before moves every
    hidden state after it through attention, and the pairs it adds to or
    takes from an expert move others past or within the capacity
    (``moe_parted_rows`` bounds their share).  Returns the summary and
    each call's tokens routed apart."""
    if len(got) < len(ref):
        fail(f"{label}: {len(got)} MoE calls, the reference made {len(ref)}")
    rows = []
    by_layer, margins = [0] * layers, [0.0] * layers
    for i, (a, b) in enumerate(zip(got, ref)):
        if (a["mode"], a["cap"]) != (b["mode"], b["cap"]):
            fail(f"{label}: MoE call {i} ran {a['mode']} cap {a['cap']}, "
                 f"the reference {b['mode']} cap {b['cap']}")
        # the sets of experts: two picks of nearly equal probability may
        # come in either order, which changes only the combine's order
        apart = (a["experts"].sort(-1).values != b["experts"].sort(
            -1).values).any(-1).reshape(-1)
        margin = b["margin"].reshape(-1)[apart]
        layer = i % layers
        if layer == 0 and not bool((margin < MOE_NEAR_TIE).all()):
            fail(f"{label}: MoE call {i} ({a['mode']}, a first layer) chose "
                 f"other experts for {int(apart.sum())} tokens, the "
                 f"reference's margins {margin.tolist()[:8]}, past a near "
                 f"tie")
        by_layer[layer] += int(apart.sum())
        if margin.numel():
            margins[layer] = max(margins[layer], margin.max().item())
        rows.append(apart)
    return {"calls": len(ref), "token_calls_parted_by_layer": by_layer,
            "largest_margin_parted_by_layer": margins,
            "prefill_cap": [r["cap"] for r in ref if r["mode"] == "prefill"],
            "decode_cap": ref[-1]["cap"]}, rows


def moe_parted_rows(torch, parted, prompts, layers, rows):
    """[slots, rows]: the cache rows of the tokens some MoE call routed
    apart (``moe_check_routing``'s flags, call by call: each prompt's
    ``layers`` prefill calls, then each decode step's), their k and v in
    the later layers computed from another expert's output."""
    slots = len(prompts)
    out = torch.zeros((slots, rows), dtype=torch.bool)
    for c, flags in enumerate(parted):
        if c < slots * layers:
            out[c // layers, :flags.numel()] |= flags
        else:
            step = (c - slots * layers) // layers
            for j in range(slots):
                out[j, prompts[j] + step] |= bool(flags[j])
    return out


def moe_slots(key):
    return len(MOE_PROMPTS[key])


def moe_train_rules(mesh_cfg):
    """``rules_for`` of the uncut qwen3-moe at 19d's train shape: FSDP's
    "embed" over "data" at dp 2."""
    from repro_torch.core.config import ShapeConfig, get_arch
    from repro_torch.sharding.auto import rules_for

    return rules_for(get_arch(MOE_ARCH), mesh_cfg, ShapeConfig(
        "train", TRAIN_SEQ, mesh_cfg.dp_size * MOE_TRAIN_ROWS, "train"))[0]


def moe_train_reference(torch, np, dev, work):
    """19d's unsharded reference: qwen3-moe in ``MOE_TRAIN_DTYPE`` cut to
    ``MOE_CUTS["train"]``, ``SEED``'s draws with ``moe_redraw``'s experts,
    ``MESH_TRAIN_STEPS`` steps of ``make_train_step(dp_size=2)`` on the
    global batch (the batches go to ``work/batches.pt``).  Returns each
    step's metrics and ms."""
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    mesh_cfg = parse_mesh(MOE_TRAIN_MESH)
    cfg = kv_cfg(MOE_ARCH, MOE_CUTS["train"][0], MOE_TRAIN_DTYPE)
    batches = mesh_batches(torch, np, mesh_cfg.dp_size * MOE_TRAIN_ROWS,
                           TRAIN_SEQ, MESH_TRAIN_STEPS, seed_offset=19)
    torch.save(batches, work / "batches.pt")
    model = get_model(cfg)
    tree = moe_tree(torch, dev, cfg)
    model.load_tree(tree)
    opt = adamw_init(tree)
    step = make_train_step(model, mesh_tcfg(), dp_size=mesh_cfg.dp_size)
    metrics, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(tree, opt, {k: v.to(dev) for k, v in b.items()})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        metrics.append({k: v.item() for k, v in m.items()})
    del model, tree, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, ms


def moe_references(torch, np, dev, work):
    """The unsharded references on the card, each freed before the next,
    while the ranks start up: 19b's and 19c's bf16 runs (``MOE_PROMPTS``
    into as many slots of ``LM_MAX_LEN`` rows, ``MOE_DECODE`` greedy
    steps), their routing logged, and 19d's train steps.  Returns the
    records, on the host."""
    out = {}
    for key in ("qwen", "grok"):
        cfg = kv_cfg(moe_arch(key), MOE_CUTS[key][0])
        model, _, steps = kv_unsharded(torch, dev, cfg)
        cache = model.init_cache(moe_slots(key), LM_MAX_LEN)
        routes = []
        with route_log(torch, routes):
            run = tp_serve(torch, *steps(0), cache, tp_prompts(
                np, cfg.vocab_size)[:moe_slots(key)], MOE_DECODE[key])
        out[key] = _host_run(run, cache)
        out[key]["routes"] = routes
        del model, cache, run
        gc.collect()
        torch.cuda.empty_cache()
    out["train"], out["train_ms"] = moe_train_reference(torch, np, dev, work)
    return out


def moe_tree(torch, dev, cfg):
    """The whole tree of ``SEED``'s draws with ``moe_redraw``'s experts
    (``moe_shard_init``'s shards are its slices)."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.moe import moe_redraw
    from repro_torch.nn.param import init_tree

    tree = init_tree(get_model(cfg).param_spec(), torch.Generator(
        device=dev).manual_seed(SEED), cfg.param_dtype)
    moe_redraw(tree, torch.Generator(device=dev).manual_seed(SEED + 19))
    return tree


def moe_shard_init(torch, dev, cfg, mesh, mesh_cfg, rules, redraw=True):
    """The rank's shards of ``SEED``'s draws (``shard_init``; with
    ``redraw`` then ``moe_redraw_shards``: ``moe_tree``'s), one rank
    drawing at a time: each draws every leaf whole on the card before it
    cuts it (a grok expert leaf of 2 layers is 6.4 GB in bf16)."""
    import torch.distributed as dist

    from repro_torch.models.transformer import shard_init

    coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                       mesh.get_coordinate())))
    local = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            local = shard_init(cfg, gen, mesh, rules)
            if redraw:
                moe_redraw_shards(torch, dev, local, cfg, mesh_cfg, rules,
                                  coords)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return local


def moe_redraw_shards(torch, dev, local, cfg, mesh_cfg, rules, coords):
    """``moe_redraw``'s experts on the rank's shards: each layer's expert
    leaf drawn whole from the same generator in the same order, and the
    rank's slice kept."""
    import math

    from repro_torch.nn.moe import moe_spec
    from repro_torch.sharding.rules import local_slice, logical_to_spec

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    spec = moe_spec(cfg)
    for name in ("we_gate", "we_up", "we_down"):
        p = spec[name]
        sp = logical_to_spec(p.axes, mesh_cfg.axes, rules)
        for t in local["layers"]["mlp"][name]:
            whole = torch.randn(p.shape, generator=gen, device=dev,
                                dtype=torch.float32) / math.sqrt(p.shape[-2])
            t.copy_(local_slice(whole, sp, mesh_cfg, coords))
            del whole


def moe_rank_serve(key):
    """19b (``"qwen"``) or 19c (``"grok"``) on a rank: the shards of the
    reference's draws under ``tp_rules``; the bf16 run on the reference's
    tokens, its routing logged."""
    def part(torch, np, dev, mesh, mesh_cfg, work, forced):
        cfg = kv_cfg(moe_arch(key), MOE_CUTS[key][0])
        slots = moe_slots(key)
        rules = tp_rules(cfg, mesh_cfg, slots)
        local = moe_shard_init(torch, dev, cfg, mesh, mesh_cfg, rules,
                               redraw=False)
        prefill, decode, model = tp_steps(cfg, mesh_cfg, mesh, local, slots)
        routes = []
        with route_log(torch, routes):
            rec = kv_rank_run(torch, prefill, decode,
                              model.init_cache(slots, LM_MAX_LEN),
                              tp_prompts(np, cfg.vocab_size)[:slots],
                              MOE_DECODE[key], forced[key])
        rec["routes"] = routes
        rec["rules"] = {a: rules.lookup(a) for a in (
            "experts", "expert_ff", "heads", "kv_heads", "kv_seq")}
        return rec
    return part


def moe_rank_train(torch, np, dev, mesh, mesh_cfg, work, forced):
    """19d on a rank: qwen3-moe's train step through the dry run's
    ``_build_step`` on ``moe_train_rules``' shards (the reference's draws
    and ``moe_redraw``'s experts), ``MESH_TRAIN_STEPS`` steps on the
    reference's batches, the first twice from the same state: each step's
    metrics, launches, collectives and the fingerprint of its router
    gradient; the repeat's verdict."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.nn.param import tree_leaves
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import local_slice, logical_to_spec
    from repro_torch.train.optimizer import adamw_init

    cfg = kv_cfg(MOE_ARCH, MOE_CUTS["train"][0], MOE_TRAIN_DTYPE)
    rules = moe_train_rules(mesh_cfg)
    coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                       mesh.get_coordinate())))

    def draw():
        return moe_shard_init(torch, dev, cfg, mesh, mesh_cfg, rules)

    local = draw()
    rows = mesh_cfg.dp_size * MOE_TRAIN_ROWS
    step, _ = _build_step(cfg, ShapeConfig("train", TRAIN_SEQ, rows,
                                           "train"), mesh_cfg, rules,
                          tcfg=mesh_tcfg(), microbatches=1)(mesh, local)
    opt = adamw_init(local, step.plan())
    spec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
    batches = [{k: local_slice(v, spec, mesh_cfg, coords).to(dev)
                for k, v in b.items()}
               for b in torch.load(work / "batches.pt")]
    k3, k10 = _kv_counters().values()

    def one(batch):
        for fn in (k3, k10):
            fn.launches = 0
        for key in k3.role_launches:
            k3.role_launches[key] = 0
        collectives.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        grads, m = step.accumulate(local, batch)
        router = bits_fingerprint(torch, grads["layers"]["mlp"]["router"])
        _, _, m = step.finish(local, opt, grads, m)
        torch.cuda.synchronize()
        return {"metrics": {k: v.item() for k, v in m.items()},
                "ms": 1e3 * (time.perf_counter() - t),
                "launches": {"K3": dict(k3.role_launches),
                             "K10": k10.launches},
                "collectives": collectives.counts_by_name(),
                "router_grad": router}

    first = one(batches[0])
    prints = mesh_fingerprints(torch, local)
    for t_, s_ in zip(tree_leaves(local), tree_leaves(draw())):
        t_.copy_(s_)
    for t_ in tree_leaves(opt):
        t_.zero_()
    again = one(batches[0])
    repeat = (prints == mesh_fingerprints(torch, local)
              and again["metrics"] == first["metrics"]
              and again["router_grad"] == first["router_grad"])
    return {"steps": [first, one(batches[1])], "repeat_ms": again["ms"],
            "repeat_equal": repeat, "coords": coords,
            "embed": rules.lookup("embed"),
            "experts": rules.lookup("experts")}


def moe_mesh_phase(torch, F, np, dev, peaks, card):
    """Phase 19: 19a K3 and K10 at the slice's rank shapes; 19b qwen3-moe
    served on a 1 x 4 gloo mesh (32 experts a rank, the picked rows summed
    over "model"), 19c grok-1 on the same ranks (each expert's 8192 ff
    columns a rank, the fp32 partials summed), both against the unsharded
    port; 19d qwen3-moe's bf16 train step on 2 x 2 against the unsharded
    step on the global batch grouped by dp 2; 19e the dry run's 16 MoE
    rows at the JAX package's meshes, all traced (two processes beside
    the rest).  The ranks of both meshes start first and wait while 19a
    and the references run here; then the 1 x 4 ranks run 19b and 19c,
    and once they are done, the 2 x 2 ranks run 19d.  Returns the
    record."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh

    t19 = time.perf_counter()
    out = {"card": card, "reduced": {k: {"num_layers": v[0], "why": v[1]}
                                     for k, v in MOE_CUTS.items()}}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        started = mesh_dryrun_start(work, "moe", MOE_DRYRUN_PROCS)
        ranks = []
        try:
            ranks += [kv_spawn(work / "b", MOE_MESH, ["qwen", "grok"],
                               "19b/19c"),
                      kv_spawn(work / "d", MOE_TRAIN_MESH, ["moe_train"],
                               "19d")]
            out["cases"] = moe_kernel_mesh_cases(torch, F, dev, peaks)
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = moe_references(torch, np, dev, work)
            gc.collect()
            torch.cuda.empty_cache()
            out["references_s"] = time.perf_counter() - t
            for key in ("qwen", "grok"):
                kv_publish(torch, work, key, {key: ref[key]["tokens"]})
            four = kv_wait(torch, ranks[0])
            kv_publish(torch, work, "moe_train", {})
            train = [r["moe_train"] for r in kv_wait(torch, ranks[1])]
            out["ranks_s"] = time.perf_counter() - t - out["references_s"]
            rows = dryrun_collect(started, "19e")
        finally:  # a failed phase leaves no process of its own behind
            procs = [p for p, _, _ in started] + [
                p for _, group, _, _ in ranks for p in group]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in [log for _, _, log in started] + [
                    f for _, _, logs, _ in ranks for f in logs]:
                log.close()
    m4 = parse_mesh(MOE_MESH)
    # 19b and 19c
    for key, want_rules in (("qwen", ("model", None)),
                            ("grok", (None, "model"))):
        layers = MOE_CUTS[key][0]
        cfg = kv_cfg(moe_arch(key), layers)
        label = f"{moe_arch(key)} {MOE_MESH} moe"
        rules = tp_rules(cfg, m4, moe_slots(key))
        runs = [r[key] for r in four]
        got = (runs[0]["rules"]["experts"], runs[0]["rules"]["expert_ff"])
        if got != want_rules:
            fail(f"{label}: experts and expert_ff cut as {got}")
        rec = {"routing": []}
        skip = torch.zeros((moe_slots(key), LM_MAX_LEN), dtype=torch.bool)
        for r, run in enumerate(runs):
            if (run["k10_paths"].get("wgmma") != layers * moe_slots(key)
                    or run["k3_paths"].get("wgmma", 0) < 1):
                fail(f"{label} rank {r}: the prefills took K3's paths "
                     f"{run['k3_paths']} and K10's {run['k10_paths']}")
            summary, parted = moe_check_routing(
                f"{label} rank {r}", ref[key]["routes"], run["routes"],
                layers)
            rec["routing"].append(summary)
            skip |= moe_parted_rows(torch, parted, MOE_PROMPTS[key], layers,
                                    LM_MAX_LEN)
        rec["cache_rows_left_out"] = int(skip.sum())
        tokens = sum(MOE_PROMPTS[key]) + moe_slots(key) * MOE_DECODE[key]
        rec["tokens_parted_share"] = int(skip.sum()) / tokens
        if rec["tokens_parted_share"] > MOE_MOST_PARTED:
            fail(f"{label}: {int(skip.sum())} of {tokens} tokens routed "
                 f"apart at near ties")
        rec["worst"], rec["parted"] = kv_check_run(
            torch, label, four, runs, ref[key], layers,
            moe_k3_per_layer(cfg), m4, rules,
            {"prefill": TP_BF16_TOL, "decode": TP_BF16_TOL}, skip=skip,
            deep_tol=TP_BF16_TOL)
        kv_check_collectives(label, runs, {"sum_over/model": 2 * layers + 1,
                                           "gather_over/model": 1})
        exchange = runs[0]["collectives_prefill_bytes"]["sum_over/model"]
        rec.update(kv_summary(runs, ref[key]),
                   peak_memory_gb=[r["peak_gb"] for r in runs],
                   part_s=[r["part_s"] for r in runs],
                   prompts=list(MOE_PROMPTS[key]), steps=MOE_DECODE[key],
                   prefill_sum_over_bytes=exchange,
                   tokens=runs[0]["tokens"].tolist())
        out[key] = rec
        print(f"moe19{'b' if key == 'qwen' else 'c'} " + json.dumps(
            {k: v for k, v in rec.items() if k != "routing"}), flush=True)
        print(f"{label}: routing " + json.dumps(rec["routing"][0]),
              flush=True)
    # 19d
    label = f"{MOE_ARCH} train {MOE_TRAIN_MESH}"
    if train[0]["experts"] != "model" or train[0]["embed"] != ("data",):
        fail(f"{label}: experts cut over {train[0]['experts']}, embed over "
             f"{train[0]['embed']}")
    d = {"metrics": [], "err": []}
    for i, want in enumerate(ref["train"]):
        got = [t["steps"][i]["metrics"] for t in train]
        if any(g != got[0] for g in got):
            fail(f"{label}: step {i + 1}'s metrics differ between ranks")
        err = {k: abs(got[0][k] - want[k]) / max(1.0, abs(want[k]))
               for k in ("ce", "load_balance_loss", "router_z_loss")}
        d["metrics"].append([got[0], want])
        d["err"].append(err)
        if not max(err.values()) <= MOE_TRAIN_TOL[i]:
            fail(f"{label}: step {i + 1}'s metrics {err} apart from the "
                 f"reference's")
    for t in train:
        if not t["repeat_equal"]:
            fail(f"{label} rank {t['coords']}: the first step again "
                 f"differs")
        for u in train:
            if (u["coords"]["data"] == t["coords"]["data"] and any(
                    a["router_grad"] != b["router_grad"]
                    for a, b in zip(t["steps"], u["steps"]))):
                fail(f"{label}: the router's gradient differs between the "
                     f"model ranks of data rank {t['coords']['data']}")
    d.update(step_ms=[[s["ms"] for s in t["steps"]] for t in train],
             reference_step_ms=ref["train_ms"],
             collectives_a_step=mesh_split(train[0]["steps"][0][
                 "collectives"]),
             launches=train[0]["steps"][0]["launches"],
             peak_memory_gb=[t["peak_gb"] for t in train])
    out["train"] = d
    print("moe19d " + json.dumps(d), flush=True)
    # 19e
    for rec in rows:
        print("moe19e " + dryrun.summary(rec) + f" [{card}]", flush=True)
    missed = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in rows
              if not r["traced"] or not r["fits"]]
    if missed or len(rows) != len(dryrun_combos("moe")):
        fail(f"19e: {len(rows)} rows, not traced or not fitting: {missed}")
    out["dryrun"] = [{k: r[k] for k in ("arch", "shape", "mesh", "fits",
                                        "traced", "per_device_bytes",
                                        "collectives")} for r in rows]
    out["phase_s"] = time.perf_counter() - t19
    print(f"phase 19 wall time {out['phase_s']:.1f} s (references "
          f"{out['references_s']:.1f}, then the ranks {out['ranks_s']:.1f}; "
          f"1x4 parts {out['qwen']['part_s'][0]:.1f} + "
          f"{out['grok']['part_s'][0]:.1f}, 2x2 "
          f"{train[0]['part_s']:.1f}) [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
#: phase 20: "ssm_inner" on a mesh, ranks of this script over gloo on the
#: one card.  20b serves rwkv6-1.6b with its 32 WKV heads and their
#: projections cut over "model" (16 a rank), 20c zamba2-1.2b with its 64
#: SSD heads and in_proj's 8384 columns (4192 a rank) cut and its shared
#: block's 32 heads (16 a rank), both on 1 x 2 and ``rules_for``'s rules;
#: 20d one bf16 train step of each on the same ranks
SSM_MESH = "1x2"
#: the depth of each run (layers, why); width, heads and vocab as
#: published
SSM_CUTS = {
    "rwkv": (4, "two gloo ranks on one card exchange wo's and wv's fp32 "
                "partials of a 4500-token prefill through host memory (37 "
                "MB each a layer) and gather its 1.2-GB fp32 logits: 4 of 24 "
                "layers keep phase 20 near a minute"),
    "zamba": (6, "one group: 6 of 38 Mamba blocks and 1 of 6 shared-block "
                 "invocations (the proj gathered, 75 MB a block at 4500 "
                 "tokens)"),
    "rwkv_train": (2, "a bf16 train step of 2048 tokens, the first taken "
                      "twice; K11's plain backward 122 ms a layer"),
    "zamba_train": (6, "one group, as 20c"),
}
#: 20b's and 20c's decode steps (on the reference's tokens); the prompts
#: are ``LM_PROMPTS`` into ``LM_MAX_BATCH`` slots of ``LM_MAX_LEN`` rows
SSM_DECODE = 8
#: 20d: one row of ``TRAIN_SEQ`` tokens (``MarkovLM(TRAIN_VOCAB)``), each
#: step's CE within this of the unsharded step's (relative to max(1,
#: |ref|); the second follows bf16 gradients summed in another order
#: through Adam's first step), as 19d's; zamba2's gathered in_proj
#: gradient of the first step within ``SSM_GRAD_TOL`` of max|g| of the
#: reference's (18d's limit of a gradient summed over the ranks)
SSM_TRAIN_ROWS = 1
SSM_TRAIN_TOL = (1e-4, 1e-3)
SSM_GRAD_TOL = KV_TRAIN_GRAD_TOL
#: 20a: K11 at a rank's 16 heads of 64 from a state (the cache's shard),
#: bf16, at 1500 and 4500 tokens
SSM_K11_CASES = ((1500, "bfloat16", "normal"), (4500, "bfloat16", "normal"))
SSM_K11_HEADS = 16
#: 20a: K3 at the slice's rank shapes on 1 x 2 (arch, role, K, N,
#: activation, fp32 store): rwkv6's r/k/v/g and wo, its channel mix's key
#: (relu) and value; zamba2's in_proj (4192 of 8384 columns) and
#: out_proj, the shared block's q/k/v, o, gate (silu), up and down, and
#: shared_out
SSM_K3_SHAPES = (
    (RWKV_ARCH, "rkvg", 2048, 1024, "none", False),
    (RWKV_ARCH, "o", 1024, 2048, "none", True),
    (RWKV_ARCH, "chan_k", 2048, 3584, "relu", False),
    (RWKV_ARCH, "chan_v", 3584, 2048, "none", True),
    (ZAMBA_ARCH, "in_proj", 2048, 4192, "none", False),
    (ZAMBA_ARCH, "out_proj", 2048, 2048, "none", True),
    (ZAMBA_ARCH, "shared_qkv", 4096, 2048, "none", False),
    (ZAMBA_ARCH, "shared_o", 2048, 4096, "none", True),
    (ZAMBA_ARCH, "shared_gate", 4096, 4096, "silu", False),
    (ZAMBA_ARCH, "shared_up", 4096, 4096, "none", False),
    (ZAMBA_ARCH, "shared_down", 4096, 4096, "none", True),
    (ZAMBA_ARCH, "shared_out", 2048, 2048, "none", True))
#: 20a: K10 at the shared block's rank view, 16 heads over 16, hd 128,
#: causal
SSM_K10_CASES = tuple((s, 0, 0.0, "bfloat16", 16, 16, 128, True)
                      for s in TP_K10_TOKENS)


def ssm_arch(key):
    return ZAMBA_ARCH if key.startswith("zamba") else RWKV_ARCH


def ssm_cfg(key):
    """20b's, 20c's or 20d's config: the arch cut to ``SSM_CUTS[key]``
    layers in bf16 (zamba2's 6 blocks: one group, no tail)."""
    return kv_cfg(ssm_arch(key), SSM_CUTS[key][0])


def ssm_tree(torch, dev, key, cfg):
    """The whole tree of ``SEED``'s draws with ``rwkv_redraw``'s or
    ``ssm_redraw``'s leaves, on the card (the ranks' shards are its
    slices)."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree
    from repro_torch.nn.rwkv import rwkv_redraw
    from repro_torch.nn.ssm import ssm_redraw

    tree = init_tree(get_model(cfg).param_spec(), torch.Generator(
        device=dev).manual_seed(SEED), cfg.param_dtype)
    redraw = ssm_redraw if ssm_arch(key) == ZAMBA_ARCH else rwkv_redraw
    redraw(tree, torch.Generator(device=dev).manual_seed(SEED + 20))
    return tree


def ssm_counters():
    from repro_torch.kernels.wkv6 import ops as wkv6_ops

    return dict(_kv_counters(), K11=wkv6_ops.wkv6)


def ssm_per_layer(key, cfg):
    """K3, K10 and K11 launches of a prefill and of a decode step: rwkv6's
    8 projections a layer and K11 once a layer in a prefill; zamba2's 2 a
    Mamba block, 8 a shared-block invocation and K10 once an invocation
    in a prefill."""
    if ssm_arch(key) == RWKV_ARCH:
        n = cfg.num_layers
        return ({"K3": 8 * n, "K10": 0, "K11": n},
                {"K3": 8 * n, "K10": 0, "K11": 0})
    groups = cfg.num_layers // cfg.shared_attn_every
    k3 = 2 * cfg.num_layers + 8 * groups
    return ({"K3": k3, "K10": groups, "K11": 0},
            {"K3": k3, "K10": 0, "K11": 0})


def ssm_kernel_cases(torch, F, dev, peaks):
    """Phase 20a: K11 at ``SSM_K11_CASES`` (16 heads from a state), K3 at
    ``SSM_K3_SHAPES`` at ``TP_K3_ROWS`` (the row-parallel products on the
    fp32 store) and K10 at ``SSM_K10_CASES``, each held against its plain
    version, repeated, timed beside the library (K11: none) and printed by
    its case's function; returns the records."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = [k11_case(torch, gen, dev, peaks, s, dname, decay,
                     heads=SSM_K11_HEADS, with_state=True)
            for s, dname, decay in SSM_K11_CASES]
    for r in rows:
        r.update(ways=2, view=RWKV_ARCH)
    for arch, role, kk, n, act, f32 in SSM_K3_SHAPES:
        for m in TP_K3_ROWS:
            rows.append(k3_bf16_case(
                torch, F, gen, dev, m, kk, n, act, peaks, False,
                out_dtype=torch.float32 if f32 else None, ways=2, role=role,
                arch=arch))
    for case in SSM_K10_CASES:
        r = k10_case(torch, F, gen, dev, case, peaks)
        r.update(main=False, ways=2, view=ZAMBA_ARCH)
        rows.append(r)
    return rows


@contextlib.contextmanager
def heads_log(log):
    """The heads each of K11 (its wrapper and the per-step WKV), the SSD
    scan and K10 is given while inside (``log``: a set a kernel), where
    the model code calls them."""
    from repro_torch.nn import attention, rwkv, ssm

    places = ((rwkv, "wkv6", "K11"), (rwkv, "wkv6_reference", "K11"),
              (ssm, "_ssd_chunked", "ssd"),
              (attention, "flash_attention", "K10"))
    real = [getattr(mod, name) for mod, name, _ in places]

    def wrap(fn, key):
        def wrapped(*a, **kw):
            log.setdefault(key, set()).add(int(a[0].shape[2]))
            return fn(*a, **kw)
        return wrapped

    for (mod, name, key), fn in zip(places, real):
        setattr(mod, name, wrap(fn, key))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(places, real):
            setattr(mod, name, fn)


def ssm_train_rules(key, mesh_cfg):
    """``rules_for`` of the uncut arch at 20d's train shape."""
    from repro_torch.core.config import ShapeConfig, get_arch
    from repro_torch.sharding.auto import rules_for

    return rules_for(get_arch(ssm_arch(key)), mesh_cfg, ShapeConfig(
        "train", TRAIN_SEQ, mesh_cfg.dp_size * SSM_TRAIN_ROWS, "train"))[0]


def ssm_in_proj_grad(grads):
    return grads["mamba"]["ssm"]["in_proj"]["w"]


def ssm_references(torch, np, dev, work):
    """The unsharded references on the card, each freed before the next,
    while the ranks start up: 20b's and 20c's bf16 runs (``LM_PROMPTS``
    into ``LM_MAX_BATCH`` slots, ``SSM_DECODE`` greedy steps) and 20d's
    two train steps of each (the batches go to ``work/ssm_batches.pt``;
    zamba2's first in_proj gradient kept).  Returns the records, on the
    host."""
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import make_train_step

    out = {}
    for key in ("rwkv", "zamba"):
        cfg = ssm_cfg(key)
        model, _, steps = kv_unsharded(torch, dev, cfg,
                                       ssm_tree(torch, dev, key, cfg))
        cache = model.init_cache(LM_MAX_BATCH, LM_MAX_LEN)
        out[key] = _host_run(tp_serve(
            torch, *steps(0), cache, tp_prompts(np, cfg.vocab_size),
            SSM_DECODE), cache)
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()
    batches = mesh_batches(torch, np, SSM_TRAIN_ROWS, TRAIN_SEQ,
                           MESH_TRAIN_STEPS, seed_offset=20)
    torch.save(batches, work / "ssm_batches.pt")
    for key in ("rwkv_train", "zamba_train"):
        cfg = ssm_cfg(key)
        model, tree, _ = kv_unsharded(torch, dev, cfg,
                                      ssm_tree(torch, dev, key, cfg))
        opt = adamw_init(tree)
        step = make_train_step(model, mesh_tcfg())
        rec = {"metrics": [], "ms": []}
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, m = step(tree, opt, {k: v.to(dev) for k, v in b.items()})
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t))
            rec["metrics"].append({k: v.item() for k, v in m.items()})
            if i == 0 and key == "zamba_train":
                rec["in_proj_grad"] = ssm_in_proj_grad(step.grads).cpu()
        out[key] = rec
        del model, tree, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ssm_rank_serve(key):
    """20b (``"rwkv"``) or 20c (``"zamba"``) on a rank: the shards of the
    reference's draws under ``tp_rules``; the bf16 run on the reference's
    tokens with K3, K10 and K11 counted and the heads each was given."""
    def part(torch, np, dev, mesh, mesh_cfg, work, forced):
        from repro_torch.models.transformer import shard_params

        cfg = ssm_cfg(key)
        rules = tp_rules(cfg, mesh_cfg)
        local = shard_params(cfg, ssm_tree(torch, dev, key, cfg), mesh,
                             rules)
        gc.collect()
        torch.cuda.empty_cache()
        prefill, decode, model = tp_steps(cfg, mesh_cfg, mesh, local)
        heads = {}
        with heads_log(heads):
            rec = kv_rank_run(torch, prefill, decode,
                              model.init_cache(LM_MAX_BATCH, LM_MAX_LEN),
                              tp_prompts(np, cfg.vocab_size), SSM_DECODE,
                              forced[key], counters=ssm_counters())
        rec["heads"] = {k: sorted(v) for k, v in heads.items()}
        rec["rules"] = {a: rules.lookup(a) for a in (
            "heads", "kv_heads", "ssm_inner", "ff", "embed")}
        return rec
    return part


def ssm_rank_train(torch, np, dev, mesh, mesh_cfg, work, forced):
    """20d on a rank: rwkv6's and zamba2's train steps through the dry
    run's ``_build_step`` on ``ssm_train_rules``' shards of the
    reference's draws, ``MESH_TRAIN_STEPS`` steps on the reference's
    batches, the first twice from the same state: each step's metrics,
    launches and collectives, zamba2's first in_proj gradient shard (the
    parent gathers it), the heads each kernel was given; the repeat's
    verdict."""
    from repro_torch.core.config import ShapeConfig
    from repro_torch.launch.dryrun import _build_step
    from repro_torch.models.transformer import shard_params
    from repro_torch.nn.param import tree_leaves
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import local_slice, logical_to_spec
    from repro_torch.train.optimizer import adamw_init

    coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                       mesh.get_coordinate())))
    out = {"coords": coords}
    for key in ("rwkv_train", "zamba_train"):
        cfg = ssm_cfg(key)
        rules = ssm_train_rules(key, mesh_cfg)

        def draw():
            local = shard_params(cfg, ssm_tree(torch, dev, key, cfg), mesh,
                                 rules)
            gc.collect()
            torch.cuda.empty_cache()
            return local

        local = draw()
        rows = mesh_cfg.dp_size * SSM_TRAIN_ROWS
        step, _ = _build_step(cfg, ShapeConfig("train", TRAIN_SEQ, rows,
                                               "train"), mesh_cfg, rules,
                              tcfg=mesh_tcfg(), microbatches=1)(mesh, local)
        opt = adamw_init(local, step.plan())
        spec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
        batches = [{k: local_slice(v, spec, mesh_cfg, coords).to(dev)
                    for k, v in b.items()}
                   for b in torch.load(work / "ssm_batches.pt")]
        counters = ssm_counters()
        heads = {}

        def one(batch, keep=False):
            for fn in counters.values():
                fn.launches = 0
            for k in counters["K3"].role_launches:
                counters["K3"].role_launches[k] = 0
            collectives.reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with heads_log(heads):
                grads, m = step.accumulate(local, batch)
            kept = None
            if keep and key == "zamba_train":
                kept = ssm_in_proj_grad(grads).cpu()
            _, _, m = step.finish(local, opt, grads, m)
            torch.cuda.synchronize()
            return {"metrics": {k: v.item() for k, v in m.items()},
                    "ms": 1e3 * (time.perf_counter() - t),
                    "launches": {"K3": dict(counters["K3"].role_launches),
                                 "K10": counters["K10"].launches,
                                 "K11": counters["K11"].launches},
                    "collectives": collectives.counts_by_name(),
                    "in_proj_grad": kept}

        first = one(batches[0], keep=True)
        prints = mesh_fingerprints(torch, local)
        for t_, s_ in zip(tree_leaves(local), tree_leaves(draw())):
            t_.copy_(s_)
        for t_ in tree_leaves(opt):
            t_.zero_()
        again = one(batches[0])
        repeat = (prints == mesh_fingerprints(torch, local)
                  and again["metrics"] == first["metrics"])
        out[key] = {"steps": [first, one(batches[1])],
                    "repeat_ms": again["ms"], "repeat_equal": repeat,
                    "heads": {k: sorted(v) for k, v in heads.items()},
                    "ssm_inner": rules.lookup("ssm_inner"),
                    "embed": rules.lookup("embed")}
        del local, step, opt, batches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ssm_check_cache(torch, label, rank, got, want, cfg, model_spec,
                    mesh_cfg, rules):
    """Each of a rank's cache leaves against ``local_slice`` of the
    reference's, cut by the leaf's logical axes: the first layer's within
    ``LM_CACHE_TOL["bfloat16"]`` of max(1, |ref|), every later one (and
    zamba2's shared KV, after its group's Mamba blocks) within
    ``TP_BF16_TOL``, as 19b's deep rows.  Returns the worst errors."""
    from repro_torch.nn.param import is_param
    from repro_torch.sharding.rules import local_slice, logical_to_spec

    worst = {}
    for path, t in _tree_items(got):
        p = _tree_get(model_spec, path)
        assert is_param(p)
        ref = local_slice(_tree_get(want, path), logical_to_spec(
            p.axes, mesh_cfg.axes, rules), mesh_cfg, rank["coords"])
        got_f, ref_f = t.float(), ref.float()
        top = max(1.0, ref_f.abs().max().item())
        name = f"{label} cache {path}"
        deep = _check_close(f"{name} deep", got_f, ref_f,
                            TP_BF16_TOL * top)
        if not path.startswith("shared_kv"):
            _check_close(f"{name} layer 0", got_f[0], ref_f[0],
                         LM_CACHE_TOL["bfloat16"] * top)
        worst[path] = deep
    return worst


def ssm_check_serve(torch, key, ranks, ref, mesh_cfg):
    """20b's or 20c's holds: the logits within ``TP_BF16_TOL`` x max(1,
    |ref|), an argmax apart only at a near tie, the same bits on both
    ranks, the repeat's bits, each call's launches ``ssm_per_layer``'s,
    each rank's kernels given its own heads, the cache leaves
    (``ssm_check_cache``), a decode step's collectives.  Returns the
    record."""
    from repro_torch.models.registry import get_model

    cfg = ssm_cfg(key)
    label = f"{ssm_arch(key)} {SSM_MESH} ssm_inner"
    rules = tp_rules(cfg, mesh_cfg)
    runs = [r[key] for r in ranks]
    ways = mesh_cfg.model_size
    got = runs[0]["rules"]
    if (got["ssm_inner"], got["heads"], got["embed"]) != ("model", "model",
                                                          None):
        fail(f"{label}: the rules cut {got}")
    rec = {"worst": {}, "parted": []}
    for name, k in (("prefill", "prefill_last"), ("decode", "steps")):
        want, g = ref[k], runs[0][k]
        lim = TP_BF16_TOL * max(1.0, want.abs().max().item())
        rec["worst"][name] = _check_close(f"{label} {name} logits", g, want,
                                          lim)
        g2, w2 = g.reshape(-1, g.shape[-1]), want.reshape(-1, want.shape[-1])
        pick = g2.argmax(-1)
        apart = pick != w2.argmax(-1)
        if bool((w2.gather(1, pick[:, None])[:, 0] < w2.max(-1).values - lim)
                [apart].any()):
            fail(f"{label}: a {name} argmax parts from the reference's past "
                 f"a near tie")
        rec["parted"].append(int(apart.sum()))
    pre, dec = ssm_per_layer(key, cfg)
    arch = ssm_arch(key)
    want_heads = ({"K11": [cfg.d_model // cfg.rwkv.head_dim // ways]}
                  if arch == RWKV_ARCH else
                  {"ssd": [2 * cfg.d_model // cfg.ssm.head_dim // ways],
                   "K10": [cfg.num_heads // ways]})
    spec = get_model(cfg).cache_spec(LM_MAX_BATCH, LM_MAX_LEN)
    for r, (rank, run) in enumerate(zip(ranks, runs)):
        for k in ("prefill_last", "steps", "tokens"):
            if not torch.equal(run[k], runs[0][k]):
                fail(f"{label}: rank {r}'s {k} differ from rank 0's")
        if not run["repeat_equal"]:
            fail(f"{label} rank {r}: a repeat of the first step differs")
        for kind, want in (("prefill", pre), ("decode", dec)):
            for i, g in enumerate(run["launches"][kind]):
                if g != want:
                    fail(f"{label} rank {r}: {kind} {i} launched {g}, not "
                         f"{want}")
        if run["heads"] != want_heads:
            fail(f"{label} rank {r}: the kernels were given the heads "
                 f"{run['heads']}, not {want_heads}")
        rec[f"cache_rank{r}"] = ssm_check_cache(
            torch, f"{label} rank {r}", rank, run["cache"], ref["cache"],
            cfg, spec, mesh_cfg, rules)
    if arch == RWKV_ARCH:  # wo and wv a layer, the embedding; the logits
        coll = {"sum_over/model": 2 * cfg.num_layers + 1,
                "gather_over/model": 1}
    else:  # a block: proj, conv_w, conv_b, conv state; out_proj, the norm;
        #    the shared block's o and down, shared_out; the embedding
        groups = cfg.num_layers // cfg.shared_attn_every
        coll = {"gather_over/model": 4 * cfg.num_layers + 1,
                "sum_over/model": 2 * cfg.num_layers + 3 * groups + 1}
    kv_check_collectives(label, runs, coll)
    rec.update(kv_summary(runs, ref),
               per_rank=[{"launches": {k: sum(c[k] for kind in r["launches"]
                                              for c in r["launches"][kind])
                                       for k in ("K3", "K10", "K11")},
                          "k3_paths": r["k3_paths"],
                          "k10_paths": r["k10_paths"],
                          "store_launches": r["store_launches"]}
                         for r in runs],
               heads=runs[0]["heads"],
               peak_memory_gb=[r["peak_gb"] for r in runs],
               part_s=[r["part_s"] for r in runs],
               prompts=list(LM_PROMPTS), steps=SSM_DECODE,
               prefill_collective_bytes=runs[0]["collectives_prefill_bytes"],
               tokens=runs[0]["tokens"].tolist())
    return rec


def ssm_check_train(torch, train, ref):
    """20d's holds for each arch: the metrics the same bits on both ranks
    and each step's CE within ``SSM_TRAIN_TOL`` of the reference's, the
    repeat's bits, K3 and K11 (rwkv6) or K10 (zamba2) launched, each kernel
    given the rank's heads, zamba2's first in_proj gradient gathered
    within ``SSM_GRAD_TOL`` of max|g| of the reference's.  Returns the
    record."""
    out = {}
    for key in ("rwkv_train", "zamba_train"):
        label = f"{ssm_arch(key)} train {SSM_MESH}"
        runs = [t[key] for t in train]
        if runs[0]["ssm_inner"] != "model" or runs[0]["embed"] is not None:
            fail(f"{label}: ssm_inner cut over {runs[0]['ssm_inner']}, "
                 f"embed over {runs[0]['embed']}")
        d = {"ce": [], "ce_err": []}
        for i, want in enumerate(ref[key]["metrics"]):
            got = [t["steps"][i]["metrics"] for t in runs]
            if any(g != got[0] for g in got):
                fail(f"{label}: step {i + 1}'s metrics differ between ranks")
            err = abs(got[0]["ce"] - want["ce"]) / max(1.0, abs(want["ce"]))
            d["ce"].append([got[0]["ce"], want["ce"]])
            d["ce_err"].append(err)
            if not err <= SSM_TRAIN_TOL[i]:
                fail(f"{label}: step {i + 1}'s CE {got[0]['ce']}, the "
                     f"reference's {want['ce']}, {err} apart")
        kernel = "K11" if ssm_arch(key) == RWKV_ARCH else "K10"
        for r, t in enumerate(runs):
            if not t["repeat_equal"]:
                fail(f"{label} rank {r}: the first step again differs")
            for s in t["steps"]:
                if sum(s["launches"]["K3"].values()) < 1 or \
                        s["launches"][kernel] < 1:
                    fail(f"{label} rank {r}: launches {s['launches']}")
        if key == "zamba_train":
            g = torch.cat([t["steps"][0]["in_proj_grad"] for t in runs],
                          dim=-1).float()
            w = ref[key]["in_proj_grad"].float()
            d["in_proj_grad_err"] = (g - w).abs().max().item() / \
                w.abs().max().item()
            if not d["in_proj_grad_err"] <= SSM_GRAD_TOL:
                fail(f"{label}: step 1's gathered in_proj gradient "
                     f"{d['in_proj_grad_err']:.3e} of max|g| from the "
                     f"reference's")
        d.update(step_ms=[[s["ms"] for s in t["steps"]] for t in runs],
                 reference_step_ms=ref[key]["ms"],
                 collectives_a_step=mesh_split(runs[0]["steps"][0][
                     "collectives"]),
                 launches=runs[0]["steps"][0]["launches"],
                 heads=runs[0]["heads"])
        out[key] = d
    return out


def ssm_mesh_phase(torch, F, np, dev, peaks, card):
    """Phase 20: 20a K11, K3 and K10 at the slice's rank shapes; 20b
    rwkv6-1.6b served on a 1 x 2 gloo mesh (16 WKV heads a rank), 20c
    zamba2-1.2b on the same ranks (32 SSD heads and 4192 in_proj columns a
    rank, the shared block's 16 heads), both against the unsharded port;
    20d a bf16 train step of each on the same ranks against the unsharded
    step.  The dry run's 16 ssm and hybrid rows are traced in tier-1
    (tests/test_torch_ssm_mesh.py), not here: two processes of them take
    about 20 s.  The ranks start first and wait while 20a and the
    references run here.  Returns the record."""
    import tempfile

    from repro_torch.launch.mesh import parse_mesh

    t20 = time.perf_counter()
    out = {"card": card, "reduced": {k: {"num_layers": v[0], "why": v[1]}
                                     for k, v in SSM_CUTS.items()}}
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        started = None
        try:
            started = kv_spawn(work / "r", SSM_MESH,
                               ["rwkv", "zamba", "ssm_train"], "20b-20d")
            out["cases"] = ssm_kernel_cases(torch, F, dev, peaks)
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = ssm_references(torch, np, dev, work)
            gc.collect()
            torch.cuda.empty_cache()
            out["references_s"] = time.perf_counter() - t
            for key in ("rwkv", "zamba"):
                kv_publish(torch, work, key, {key: ref[key]["tokens"]})
            kv_publish(torch, work, "ssm_train", {})
            ranks = kv_wait(torch, started)
            out["ranks_s"] = time.perf_counter() - t - out["references_s"]
        finally:  # a failed phase leaves no process of its own behind
            if started is not None:
                for p in started[1]:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in started[2]:
                    f.close()
    m2 = parse_mesh(SSM_MESH)
    for key, tag in (("rwkv", "20b"), ("zamba", "20c")):
        out[key] = ssm_check_serve(torch, key, ranks, ref[key], m2)
        print(f"ssm{tag} " + json.dumps(out[key]), flush=True)
    out["train"] = ssm_check_train(torch, [r["ssm_train"] for r in ranks],
                                   ref)
    out["train"]["part_s"] = ranks[0]["ssm_train"]["part_s"]
    print("ssm20d " + json.dumps(out["train"]), flush=True)
    out["phase_s"] = time.perf_counter() - t20
    print(f"phase 20 wall time {out['phase_s']:.1f} s (references "
          f"{out['references_s']:.1f}, then the ranks {out['ranks_s']:.1f}; "
          f"parts {out['rwkv']['part_s'][0]:.1f} + "
          f"{out['zamba']['part_s'][0]:.1f} + "
          f"{out['train']['part_s']:.1f}) [{card}]", flush=True)
    return out


def main() -> int:
    global SEED
    t_smoke = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every case's numbers here")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register/shared-memory report")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of every weight and input (default 0)")
    # one rank of phase 16c, started by the smoke itself
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-work", help=argparse.SUPPRESS)
    # one rank of phase 17c, and a part of 17d, started by the smoke itself
    ap.add_argument("--mt-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mt-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mt-work", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dryrun", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dryrun-part", help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-set", default="mesh", help=argparse.SUPPRESS)
    # one rank of phase 18b-18d, started by the smoke itself
    ap.add_argument("--kv-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--kv-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--kv-work", help=argparse.SUPPRESS)
    args = ap.parse_args()
    SEED = args.seed
    if args.tp_rank is not None:
        return tp_rank_main(args)
    if args.mt_rank is not None:
        return mesh_rank_main(args)
    if args.kv_rank is not None:
        return kv_rank_main(args)
    if args.mesh_dryrun is not None:
        return mesh_dryrun_main(args)

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

    # -- 5c. static analysis on the card ------------------------------------
    static = static_phase(torch, np, nets, np_params, dev, card_line)
    print(json.dumps({"static_analysis": static}), flush=True)

    # -- 5d. the guard pass on the card ---------------------------------------
    guarded = guard_phase(torch, card_line)
    print(json.dumps({"guard": guarded}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()

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

    # -- 13. training: every family the JAX trainer takes ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    train_cases, train_parity_recs, train, train_launcher = train_phase(
        torch, np, dev, peaks, counters, card_line)

    # -- 15. starcoder2-15b, internlm2-20b, qwen1.5-32b, grok-1-314b ----------
    gc.collect()
    torch.cuda.empty_cache()
    dense_cases, dense_parity, dense = dense_phase(
        torch, F, np, dev, peaks, counters, card_line)

    # -- 16. qwen1.5-32b tensor parallel over a process group ----------------
    gc.collect()
    torch.cuda.empty_cache()
    tp_cases, tp_one, tp_two, tp_dry = tp_phase(
        torch, F, np, dev, peaks, counters, card_line)
    tp_runs = [tp_one] + tp_two["per_rank"]

    # -- 17. training on a mesh: gemma2-2b data and tensor parallel ----------
    gc.collect()
    torch.cuda.empty_cache()
    mesh_cases, mesh_one, mesh_runs, mesh_dry = mesh_phase(
        torch, np, dev, peaks, counters, card_line)
    # each 17c rank's first step, summed: K3 by role and its fp32 stores,
    # K10 and its launches with m and l
    mesh_ranks = [r["launches_a_step"] for m in mesh_runs.values()
                  for r in m["per_rank"]]
    mesh_k3 = {role: sum(r["K3"][role] for r in mesh_ranks)
               for role in ("forward", "z", "dx", "dw")}

    # -- 18. kv-sequence sharding: the cache cut by sequence ----------------
    gc.collect()
    torch.cuda.empty_cache()
    kv = kv_phase(torch, F, np, dev, peaks, card_line)
    # the bf16 serving runs of 18b's and 18c's ranks, each rank's launches
    kv_runs = kv["serve"]["per_rank"] + kv["long"]["per_rank"]
    kv_cases = kv["cases"]

    # -- 19. the MoE block on a mesh: qwen3-moe, grok-1 -------------------
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh = moe_mesh_phase(torch, F, np, dev, peaks, card_line)
    # the bf16 serving runs of 19b's and 19c's ranks, each rank's launches
    kv_runs = kv_runs + moe_mesh["qwen"]["per_rank"] + \
        moe_mesh["grok"]["per_rank"]
    kv_cases = kv_cases + moe_mesh["cases"]

    # -- 20. "ssm_inner" on a mesh: rwkv6, zamba2 --------------------------
    gc.collect()
    torch.cuda.empty_cache()
    ssm_mesh = ssm_mesh_phase(torch, F, np, dev, peaks, card_line)
    # the bf16 serving runs of 20b's and 20c's ranks, each rank's launches
    ssm_runs = ssm_mesh["rwkv"]["per_rank"] + ssm_mesh["zamba"]["per_rank"]
    kv_runs = kv_runs + ssm_runs
    kv_cases = kv_cases + [c for c in ssm_mesh["cases"]
                           if c["kernel"] != "K11"]

    # -- 21. the kernels line -----------------------------------------------
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

    # K10: the wgmma path (every bf16 prefill of 7c, 11c and 15c) and the
    # CUDA-core kernel (the fp32 prefills of 7b, 11b and 15b; its time the
    # fp32 4500-token case)
    k10 = [c for c in lm_cases + cross_cases + dense_cases + kv_cases
           if c["kernel"] == "K10"]
    k10_src = "src/repro_torch/csrc/flash_attention.cu"
    k10_pallas = "src/repro/kernels/attention/kernel.py:116"
    k10_wgmma = {p: lm["k10_paths"][p] + sum(
        r["k10_paths"][p] for r in (*cross.values(), *dense.values()))
                 for p in lm["k10_paths"]}
    # phase 16's bf16 prefills (16b and both ranks of 16c) and 18b's and
    # 18c's ranks' on wgmma alone
    k10_wgmma["wgmma"] += sum(r["launches"]["K10"] for r in tp_runs
                              + kv_runs)
    k10_simt = {p: lm_parity["paths"][p] + sum(
        r["paths"][p] for r in (*cross_parity.values(),
                                *dense_parity.values()))
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
        train_ml_launches=sum(t["launches"]["K10_ml"] for t in trained),
        mesh_train_launches=sum(r["K10"] for r in mesh_ranks)))
    kernels.append(lm_entry(
        "flash_attention_simt", k10_src, k10_pallas,
        [c for c in k10 if c["dtype"] == "float32"
         and c["tokens"] == max(LM_PROMPTS)], k10_simt["simt"],
        max([c["max_abs_err"] for c in k10 if c["path"] == "simt"]
            + [c["simt_max_abs_err"] for c in k10 if c["path"] == "wgmma"]),
        path="simt", paths=k10_simt))
    # K3 bf16: its times at gemma2-2b's shapes (7a), its launches those of
    # the first runs of 7c, 11c and 15c, its error the largest of every
    # case
    k3 = [c for c in lm_cases if c["kernel"] == "K3-bf16"]
    k3_all = [c for c in k3 + rwkv_cases + cross_cases + dense_cases
              + tp_cases + kv_cases if c["kernel"] == "K3-bf16"
              and c.get("store", "bfloat16") == "bfloat16"]
    served_k3 = (*cross.values(), *dense.values())
    kernels.append(lm_entry(
        "matmul_fused_bf16", "src/repro_torch/csrc/matmul_fused.cu",
        "src/repro/kernels/matmul_fused/kernel.py:37",
        [c for c in k3 if c["main"]],
        lm["launches"]["K3"] + sum(r["launches"]["K3"] for r in served_k3)
        + sum(r["launches"]["K3"] for r in tp_runs + kv_runs),
        max(c["max_abs_err"] for c in k3_all),
        train_backward_launches=k3_backward,
        mesh_train_launches=mesh_k3))
    kernels.append(lm_entry(
        "matmul_fused_bf16_wgmma", "src/repro_torch/csrc/matmul_fused.cu",
        "src/repro/kernels/matmul_fused/kernel.py:37",
        [c for c in k3 if c["path"] == "wgmma"
         and c["rows"] == K3_WGMMA_GAIN[0]],
        lm["k3_paths"]["wgmma"] + sum(r["k3_paths"]["wgmma"]
                                      for r in served_k3)
        + sum(r["k3_paths"].get("wgmma", 0) for r in tp_runs + kv_runs),
        max(c["max_abs_err"] for c in k3_all if c["path"] == "wgmma"),
        train_backward_launches=k3_backward))
    # K3's fp32 store of bf16 operands (the row-parallel o and down of
    # 16c's ranks; 16b's 1 x 1 mesh cuts nothing): its times the 2-way
    # shapes of 16a at M = 4 and 4500
    k3_f32 = [c for c in tp_cases + kv_cases if c["kernel"] == "K3-bf16"
              and c.get("store") == "float32"]
    # 17a's backward cases beside them: dx and dw on the fp32 store's dz,
    # and 17c's ranks' fp32 stores (the row-parallel o and down)
    kernels.append(lm_entry(
        "matmul_fused_bf16_f32", "src/repro_torch/csrc/matmul_fused.cu",
        "src/repro/kernels/matmul_fused/kernel.py:37",
        [c for c in k3_f32 if c["main"]],
        sum(r["store_launches"]["matmul_fused_bf16_f32"]
            for r in tp_two["per_rank"] + kv_runs)
        + sum(r["K3_f32_store"] for r in mesh_ranks),
        max(c["max_abs_err"] for c in k3_f32),
        mesh_train_store_launches=sum(r["K3_f32_store"]
                                      for r in mesh_ranks),
        backward={k: sum(c[k] for c in mesh_cases) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
        backward_max_abs_err=max(max(c["max_abs_err"].values())
                                 for c in mesh_cases)))
    k11 = next(c for c in rwkv_cases if c["kernel"] == "K11" and c["main"])
    kernels.append({
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:30",
        "launches": rwkv["launches"]["K11"],
        "max_abs_err": max(c["max_abs_err"] for c in rwkv_cases
                           + ssm_mesh["cases"] if c["kernel"] == "K11"),
        "ms": k11["ms"], "plain_ms": k11["plain_ms"],
        "bound_ms": k11["bound_ms"], "bound_by": k11["bound_by"],
        "library_ms": None,  # no single PyTorch call computes WKV6
        "train_launches": sum(t["launches"]["K11_forward"]
                              + t["launches"]["K11_backward"]
                              for t in trained),
        "mesh_launches": sum(r["launches"]["K11"] for r in ssm_runs),
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
             "cost": cost, "static_analysis": static, "guard": guarded,
             "serving": serving, "lm_cases": lm_cases,
             "lm_parity": lm_parity, "lm": lm, "rwkv_cases": rwkv_cases,
             "rwkv_parity": rwkv_parity, "rwkv": rwkv,
             "moe_cases": moe_cases, "moe_parity": moe_parity, "moe": moe,
             "zamba_cases": zamba_cases, "zamba_parity": zamba_parity,
             "zamba": zamba, "cross_cases": cross_cases,
             "cross_parity": cross_parity, "cross": cross, "kvq": kvq,
             "train_cases": train_cases, "train_parity": train_parity_recs,
             "train": train, "train_launcher": train_launcher,
             "dense_cases": dense_cases,
             "dense_parity": dense_parity, "dense": dense,
             "tp_cases": tp_cases, "tp_one": tp_one, "tp_two": tp_two,
             "tp_dryrun": tp_dry, "mesh_cases": mesh_cases,
             "mesh_one": mesh_one, "mesh_runs": mesh_runs,
             "mesh_dryrun": mesh_dry, "kv": kv, "moe_mesh": moe_mesh,
             "ssm_mesh": ssm_mesh,
             "capture": capture, "kernels": kernels},
            indent=1))
    print(f"smoke wall time {time.perf_counter() - t_smoke:.1f} s",
          flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
