#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py             # the whole check, 48 layers
    python3 chip_smoke.py --layers 8  # the same with yi-9b's depth cut
    python3 chip_smoke.py --ssd-against DIR   # only ssd_scan: DIR's kernel
                                              # and this checkout's in turns
    python3 chip_smoke.py --ssd-bwd-against DIR   # the same for
                                                  # ssd_scan_bwd
    python3 chip_smoke.py --phases 4,15   # after the build only these
                                          # phase groups (``PHASES``); no
                                          # kernels line, no last line

Phases, each fatal on failure (the script exits nonzero and prints no
result line):

1. the card's name and power limit (``nvidia-smi``); no CUDA -> fail;
2. build every CUDA source of the port with nvcc for sm_90a, one nvcc per
   source, all started together (seconds); the SASS instructions a code of
   the LUT kernels' streaming loops (``cuobjdump -sass``), ptxas' registers
   and spills of the LUT and SSD tensor-core libraries;
3. each kernel against its plain PyTorch version on the card, times by
   CUDA events, each beside its bound:
   a. the D&C LUT GEMMs (``lut_gemm_dc``, ``lut_gemm_dc_res``) on both
      their kernels at every yi-9b and mamba2-1.3b decode projection shape
      (mamba2's w_in 2048 x 8512 leaves a ragged 64-column tile), codes
      cold in L2, at the tolerance stated in ``kernels/lut_gemm/lut_gemm.py``:
      the tensor-core kernel (``lut_gemm_tc.cu``, bf16 x at M <= 32) at M
      in {1, 8, 16, 32}, the f32-FMA kernel (``lut_gemm.cu``) at M in {1,
      8} on bf16 x and on f32 x; the kernel each public call ran read from
      ``launches_tc``; x = I bitwise, at once on the f32 kernel and 8 rows
      a call on the tensor-core one; ragged shapes; each checked call
      synchronised and named on a fault; both kernels timed at M = 8 by
      events and device-only (``graph_ms``: CUDA-graph replays), at the
      other M device-only (the route's edge); and at speculation's verify
      M = 40 (8 rows x 5 columns, past the tensor-core route: the public
      call on ``lut_gemm.cu``, checked and timed device-only beside its
      bound); deepseek-v2-lite-16b's seven frozen projection shapes,
      minitron-4b's four and zamba2-1.2b's five at M = 8 on both kernels
      and at M = 40, each device-only beside its bound, summed by layer
      and, for zamba2, by decode tick (``dc_layers``);
   b. the LUNA GEMM (``luna_mm``) in all five modes, int32 bitwise, both
      its kernels (the int8 tensor-core ``luna_mm_tc.cu`` and the __dp4a
      ``luna_mm.cu``) and the public call on a row-major and a K-major W,
      the kernel each call ran read from ``launches_tc``: a ragged shape,
      the tensor-core kernel's tile edges, M in {8, 16, 32, 64, 128}
      (device-only times of both kernels: the route's threshold) and
      {8, 512, 2048} at yi-9b's four projection shapes (times by events
      and device-only; ``torch._int_mm`` on a row-major and on a K-major
      W as the library yardstick for the exact modes, M > 16);
   c. the full-table LUT GEMM (``lut_gemm``), NF4 codes, on each of its
      kernels (the tensor-core decode kernel ``lut_gemm_tc.cu``'s
      full-table mode, bf16 x at M <= 32; the tensor-core prefill kernel
      ``lut_gemm_wgmma.cu``, bf16 x at larger M; ``lut_gemm.cu``), 1e-4,
      the kernel each public call ran held to ``route``; x = I bitwise on
      each; ragged shapes on each route and shapes TMA cannot take; at
      yi-9b's projection shapes and M in {8, 16, 32, 48, 64, 160, 176,
      272, 336, 448, 512} (decode, the prefill calls' M and 512) every
      kernel that takes that M, device-only and by events, beside the
      bound at the bf16 peak and the three-piece floor;
   d. the SSD chunk scan (``ssd_scan``, the four kernels of
      ``ssd_scan_tc.cu``) at mamba2's widths (H = 64, P = 64, N = 128, G
      = 1, chunk min(256, S)) for (B, S) in {(1, 48), (1, 272) with a
      carried initial state, (8, 512)}, the engine's eight prefill
      calls (B = 1, S the 16-token buckets 448 ... 32, masked at the
      prompt lengths 438 ... 24, the zero state read), phase 9b's resumed
      and warm-seeded pieces (S in {16, 32, 48, 64, 128} from a random,
      non-zero initial state, four of them masked), speculation's windows
      (B = 8, S = 5 from a random state, each row masked at its own valid
      length in {0, 1, 2, 3, 5}: a fully masked row's final state must
      equal its initial state bitwise) and a small G = 2 case, within the
      tolerance stated in ``kernels/ssd_scan/ssd_scan.py``; at zamba2-
      1.2b's widths (N = 64) its S = 448 prefill call (masked, zero
      state), a resumed 128-token piece and an (8, 5) masked window; the
      S = 448 calls, every resumed piece and the windows also within
      ``ref.EMULATE_TOL`` of the CPU emulation (run on the card); each
      timed device-only (``graph_ms``) and by events beside its bound
      (bytes, or three TF32
      products at 494.7 TFLOP/s) and the f32 SIMT bound, and the sum over
      a layer's eight calls;
   e. flash attention (``flash_attention``): bf16 at D in {64, 128} on
      the tensor-core kernel (``flash_attention_wgmma.cu``), f32 and bf16
      at D in {16, 32} on the SIMT kernel (``flash_attention.cu``), each
      against its plain version (``flash_attention.reference``) at JAX's
      test shapes (causal and not, f32 and bf16), S = 1000 off both
      tiles (bf16, causal and not) and yi-9b's heads (H 32, Hkv 4, D 128)
      at (B, S) in {(1, 512), (2, 4096)}, causal, f32 and bf16; bf16 also
      within JAX's 2e-2 of the f32 reference on the unrounded inputs;
      which kernel ran, from the launch counters; times at (2, 4096) of
      both kernels (the SIMT one also on the bf16 inputs) beside the
      bounds, the plain versions and ``F.scaled_dot_product_attention``
      (timed only);
   f. the SSD scan's backward (``ssd_scan_bwd``, the eight kernels of
      ``ssd_scan_bwd.cu``, TF32 ``mma.sync`` with the 3xTF32 split,
      reading the forward's workspace) against torch autograd of the
      plain scan (true f32), every gradient within ``KERNEL_TOL`` of its
      scale, and against its emulation (``ref.ssd_scan_bwd_tc_emulate``)
      within ``ref.EMULATE_TOL``, two calls bitwise equal: at the
      training shape B 2 x S 4096 at mamba2's widths (N 128) and zamba2's
      (N 64), and a ragged (1, 300) call masked at 211 from a random
      initial state; each timed device-only and by events beside its
      bound (bytes, or three TF32 products at 494.7 TFLOP/s; the f32
      SIMT bound and the bound with per-head dB and dC products beside
      it), its workspace's bytes, the forward on the same inputs, the
      plain backward and each kernel's device time;
4. reduced f32 models, card against CPU: yi-9b (quantization on the card
   equals the CPU's bitwise; decode logits through the kernels under
   lut4, nf4p; lut_nf4 prefill) and mamba2 (right-padded prefill with
   ``last_pos`` through ``ssd_scan``; w_in/w_out codes bitwise; one
   decode step under lut4 and nf4p), logits at 1e-4; the cache
   substrate (yi-9b paged, paged + chunked, paged + prefix cache with
   and without chunks; mamba2 chunked and prefix + chunked, on a
   shared-head mix on 3 slots): greedy tokens on the card equal the
   CPU's and the dense, whole-prompt, cold engine's; speculation (yi-9b
   dense and paged, mamba2; ngram and self_lut; quant None, lut4, nf4p):
   tokens on the card == the CPU's == plain greedy's; the rest of the
   dense family and the moe family (starcoder2-15b, minitron-4b,
   deepseek-67b, deepseek-v2-lite-16b, deepseek-v2-236b with
   q_lora_rank 16): prefill and decode logits at 1e-4 (frozen codes
   bitwise), and deepseek-v2-lite's engines under lut4 and nf4p (10
   mixed-length requests on 8 slots, where capacity drops routed tokens,
   on the slab and the pool; self_lut on 3 slots): tokens card == CPU ==
   pool, self_lut == plain; zamba2 (hybrid): prefill and decode logits
   at 1e-4 under None, lut4, nf4p (codes bitwise), engines under the
   three on the slab and the split substrate and self_lut on both:
   tokens card == CPU == slab, self_lut == plain; yi-9b training:
   the cacheless forward under attn_impl="flash", the loss and every
   gradient under chunked attention and under luna_approx (the STE on
   luna_mm), one train step; mamba2 and zamba2 training (the scan's
   forward and backward on the kernels, 2 and 1 launches a layer): the
   loss, every gradient and one train step; one Mamba2 layer's w_in,
   A_log and dt_bias gradients; whisper-base and llava-next-mistral-7b
   (B 2, S 96): the loss, every gradient, one train step, prefill and
   teacher-forced decode logits;
5. ``quant_matmul`` on the card against the CPU's on identical f32 inputs
   under every model-level mode: codes and LUNA int32 accumulators
   bitwise, outputs 1e-5;
6. the main path at yi-9b's full width in bf16 (random weights, seed 0):
   the engine serves 8 requests (prompts 16-512, 32 new tokens)
   a. under the engine-level quant="lut4", then "nf4p" (frozen 4-bit
      decode projections on the D&C kernels, every launch on the
      tensor-core kernel);
   b. on the first ``MODEL_LEVEL_LAYERS`` (3) of those layers, under the
      model-level modes
      luna_approx2, luna_dc (every projection
      of prefill and decode on luna_mm: prefill calls at M >= 32 on its
      tensor-core kernel, decode's M = 8 on the __dp4a kernel, each count
      checked) and lut_nf4 (on lut_gemm: decode and the M = 32 prefill
      call on the tensor-core decode kernel, the larger prefill calls on
      the prefill kernel, each count checked against ``route``);
7. the main path at mamba2-1.3b's full width (always all 48 layers, bf16,
   random weights from seed 0): the same 8 request lengths under
   full precision, lut4 and nf4p; every prefill runs the SSD scan on
   ``ssd_scan`` (once per layer per call), decode the O(1) recurrence
   with w_in/w_out on the D&C kernels (every launch on the tensor-core
   kernel); the first (prefill) tokens agree across the three runs;
8. training at yi-9b's full width, depth cut 48 -> 8 (bf16, random
   weights from seed 0, SyntheticLM seed 0): the trainer's step
   (``make_train_step``, AdamW + cosine, remat) for 6 steps of B = 2, S =
   4096 under chunked attention (per-step wall, tokens/s, loss,
   grad_norm, peak memory, a torch.profiler window over the last step),
   2 QAT steps under luna_approx at S = 1024 (luna_mm: 7 x 8 x 2 launches
   a step, all on its tensor-core kernel; the last step profiled, with
   luna_mm's device time), then the eval loss and final hidden states of
   a held-out batch under attn_impl="flash" (one launch per layer per
   call, each on the tensor-core kernel) against the chunked ones, every
   attention call held to its plain version, and a check that two wrong
   attentions put in the kernel's place (output zeroed; the last 64 keys
   dropped for the last 64 queries) must fail;
   8b. the Trainer on luna-mlp: 12 steps with checkpoints every 5, then
   a rerun to 20 resumes from step 12;
9. the cache substrate at full width (bf16, random weights from seed 0),
   run after phase 6 on its model (9a) and after phase 7 on its (9b):
   a. yi-9b under lut4 on the paged pool (block 16) serves phase 6's 8
      requests: tokens bitwise equal to phase 6a's dense lut4 run; then
      with ``prefix_cache`` and ``prefill_chunk=128`` the shared-prefix
      mix (a 384-token prefix alone, then 7 requests of it plus 8-64
      token tails together): 7 hits reusing 2,688 tokens, every pool
      block free or held by the cache alone after the run;
   b. mamba2-1.3b under nf4p with ``prefill_chunk=64`` and
      ``prefix_cache`` on the same mix in the same order: 7 hits, every
      prefill piece on ``ssd_scan`` (resumed from a carried state, warm
      ones from a seeded snapshot);
   each warm request's first-token logits bitwise equal to a replay of its
   prefill pieces on a fresh cache, and from the same prompt prefilled
   whole at most ``WARM_FACTOR`` times the bf16 model's own distance from
   an f32 copy of its weights;
10. the rest of the serving stack at full width (bf16, random weights
   from seed 0), on phase 6's and phase 7's models:
   a. yi-9b on the first ``SPEC_LAYERS`` (12) of its layers, under
      lut4: a plain run of phase 6's 8 requests (32 new
      tokens), then the same under ``spec="self_lut", spec_k=4`` (drafts
      on ``lut_gemm_dc_res``'s tensor-core kernel at M = 8, verify
      windows at M = 40 on ``lut_gemm.cu``) and ``spec="ngram"``;
   b. mamba2-1.3b under nf4p with self_lut (verify and commit windows on
      ``ssd_scan``, masked per row);
   c. yi-9b lut4 on the paged pool with ``prefill_chunk=128`` and
      ``trace=True``, served through ``start()``: 8 client threads submit
      and consume ``tokens()``, one request cancelled during its chunked
      admission and one preempted while decoding (both from a callback
      inside the tick), then ``stop(drain=True)``; against a synchronous
      run of the same mix: streams == outs, untouched tokens bitwise, pool
      free, the Perfetto trace complete, registry == EngineMetrics;
   each spec run's tokens equal the plain run's (10a's, 7's nf4p) or
   pass the ``WINDOW_FACTOR`` rule at their first divergence;
11. the moe family at full width: deepseek-v2-lite-16b (27 layers, 64
   routed experts top-6 + 2 shared, MLA; bf16, random weights from seed
   0), after phase 10 has freed the other models, serves phase 6's 8
   requests (32 new tokens):
   a. quant None, lut4 and nf4p on the dense slab: each frozen run 6 LUT
      launches a layer a tick (wq, w_dkv, wo and the shared experts'
      three, or the dense first layer's MLP), 162 a tick, all on the
      tensor-core kernel; the first tokens equal across the three runs;
      a profile of 4 lut4 ticks by kernel and by labelled stage (MLA's
      absorbed attention, the router, the capacity gather, the routed
      experts' einsums, the combine, the shared experts);
   b. lut4 on the paged pool (block 16): tokens bitwise 11a's lut4
      run's; then phase 9's shared-prefix mix with ``prefix_cache`` and
      ``prefill_chunk=128``: 7 hits, the pool free after, each warm
      request's first-token logits bitwise a replay of its pieces;
   c. lut4 under ``spec="self_lut", spec_k=4``: tokens 11a's lut4 run's,
      or the ``WINDOW_FACTOR`` rule at the first divergence;
   d. minitron-4b (32 layers, GELU, 256k vocab) under lut4: 6 LUT
      launches a layer a tick, all on the tensor-core kernel;
   the phase prints its seconds;
12. the hybrid family at full width: zamba2-1.2b (38 Mamba2 layers,
   d_model 2048, state 64; 7 applications of one shared 32-head
   attention + SwiGLU block; bf16, random weights from seed 0), after
   phase 11, serves phase 6's 8 requests (32 new tokens):
   a. quant None, lut4 and nf4p on the slab: 125 LUT launches a frozen
      tick (the shared block's 7, 7 times; w_in and w_out, 38 times),
      all on the tensor-core kernel; ``ssd_scan`` once a layer a prefill
      call; the first tokens equal across the three runs; a profile of 4
      lut4 ticks by kernel and by labelled stage (the shared block, the
      Mamba2 layers, the LM head) and of the 8-prompt prefill;
   b. lut4 on the split substrate (block 16: the shared block's KV in
      the pool, the SSM state dense): tokens bitwise 12a's lut4 run's;
      then phase 9's shared-prefix mix with ``prefix_cache`` and
      ``prefill_chunk=128``: at least 7 hits, the pool free after, each
      warm request's first-token logits bitwise a replay of its pieces
      and within ``WARM_FACTOR`` of cold's distance from an f32 copy;
   c. lut4 under ``spec="self_lut", spec_k=4`` on the slab and on the
      split substrate: tokens 12a's lut4 run's, or the ``WINDOW_FACTOR``
      rule at the first divergence;
   the phase prints its seconds;
13. training the ssm, hybrid and moe families at their published widths
   (bf16, random weights from seed 0, SyntheticLM seed 0, phase 8's B 2
   x S 4096, AdamW + cosine, remat on), after phase 8b: mamba2-1.3b (48
   layers: first one layer's w_in, A_log and dt_bias gradients through
   the scan's backward kernel against autograd of the plain scan,
   ``SCAN_GRAD_REL``; 4 steps; 2 QAT steps under luna_approx at S =
   1024, luna_mm 192 launches a step, all tensor-core), zamba2-1.2b (38
   layers, 4 steps) and deepseek-v2-lite-16b with its depth cut 27 -> 3
   (4 steps; 27 layers need 188 GB with f32 moments): per step wall,
   tok/s, loss, grad norm, peak memory, the last step profiled (device
   time by kernel, the scan's share, the idle share); ``ssd_scan`` 2
   launches a Mamba2 layer a step (forward and recompute), ``ssd_scan_bwd``
   1, none for deepseek-v2-lite; the watched leaves moved; the phase
   prints its seconds;
14. the encdec and vlm families at their published widths (bf16, random
   weights from seed 0; frames, patches and prompts from seeded
   ``torch.Generator``s in ``input_specs``' shapes), after phase 13:
   a. whisper-base (6 + 6 layers, d 512, vocab 51,865): ``lut_gemm`` at
      every (M, K, N) its lut_nf4 run gives it and ``luna_mm`` at every
      shape of its QAT step, against their plain versions; B 8, a
      64-token prompt over (8, 1500, 512) frames and 32 greedy
      ``decode_step``s in bf16 and under lut_nf4 (96 ``lut_gemm``
      launches the prefill, 60 a step, each on the kernel ``route``
      names: the encoder and the cross K/V at M = 12,000 on
      ``lut_gemm_wgmma.cu``, the decode projections at M = 8 on
      ``lut_gemm_tc.cu``), each twice, tokens bitwise equal, the decode
      logits within ``TF_TOL`` of one forward of the whole sequence;
      4 bf16 train steps at frames (2, 1500, 512) and tokens (2, 4096),
      then 2 QAT steps under luna_approx at S 1024 (156 ``luna_mm``
      launches a step, each on the kernel ``takes_tc`` names);
   b. llava-next-mistral-7b (32 layers, 14.5 GB in bf16): B 4, 576
      patches and a 64-token prompt, 32 greedy decode steps (the same
      checks); the eval loss at (2, 4096) (576 patches, 3,520 tokens)
      under ``attn_impl="flash"``, 32 launches on the tensor-core
      kernel, within ``LLAVA_FLASH_LOSS_TOL`` of the chunked loss, every
      call held to its plain version; 4 train steps at B 2 x S 4096
      with the depth cut to ``LLAVA_TRAIN_LAYERS`` (8);
   each serving run reports prefill and decode tok/s, step wall, peak
   memory and a profile of one prefill and one decode step, each
   training run phase 13's lines; the watched leaves moved; the phase
   prints its seconds;
15. the last training options and the paper's entry points, after phase
   14 (their reduced f32 card == CPU checks are phase 4's: yi-9b trained
   under int8, int4_dequant, lut_nf4 and ``remat_policy="dots"``;
   ``NF4MatmulFn`` against its plain version):
   a. ``remat_policy`` "nothing" against "dots" (selective checkpointing:
      the un-batched matmuls' outputs saved) at yi-9b's full width with
      depth 8 and mamba2-1.3b's 48 layers, B 2 x S 4096: one loss and
      backward each on the same batch, the largest gradient difference
      (``card_vs_cpu.GRAD_REL`` of its leaf's scale; bitwise leaves
      counted) and that pass's peak memory; then 4 timed train steps (a
      warm-up and 3 steady ones) and a profiled one under each (step
      wall, peak GB, the idle share);
   b. yi-9b at depth 8, B 2 x S 1024, 2 train steps each under int8,
      int4_dequant and lut_nf4 (step wall, peak GB); under lut_nf4 168
      ``lut_gemm`` launches a step, 56 of them the backward's dx over the
      transposed codes (``NF4MatmulFn``), every one on the kernel
      ``route`` names (``lut_gemm_wgmma.cu``); before them, at each
      yi-9b forward shape the Function's forward bitwise the
      one-launch forward and at each transposed (M, N, K) the backward's
      call against ``lut_gemm_ref`` (1e-4), timed device-only beside its
      bound;
   c. ``examples/fig13_nn_accuracy_torch.py`` (QAT on ``luna_mm``, the
      PTQ columns on ``lut_gemm_dc``/``lut_gemm_dc_res``; JAX's bounds),
      ``tools/paper_tables_torch.py``'s ``ALL`` and
      ``examples/quickstart_torch.py`` on the card, their MAEs and
      bounds, and their launches by kernel and route; before each, its
      kernels at every (M, K, N) it gives them against their plain
      versions (``luna_mm`` bitwise, the D&C LUT GEMMs at 1e-4);
   the phase prints its seconds;
16. the mesh's serving half on a one-rank NCCL group (joined through a
   file store in a temporary directory, destroyed at the phase's end)
   and ``make_host_mesh(model=1)``, after phase 15:
   first the grouped partials (``torch.bmm`` with f32 output) at a
   yi-9b tick's shapes, card against CPU within ``GROUPED_REL``;
   a. yi-9b at phase 6's depth (bf16, random weights from seed 0) under
      lut4, phase 6's 8 requests through ``Engine.serve()`` inside
      ``activation_sharding(mesh)`` with ``decode_attn="sharded"``: f32
      and ``bf16_grouped`` on the slab, ``bf16_grouped`` on the pool
      (block 16); ``sharded_gqa_decode`` once a layer a decode tick and 3
      all-reduces a call (a run that took the dense path fails); each
      request's tokens equal the dense lut4 run's (phase 6a's, or one
      served here when phase 6 did not run) or pass ``window_rule`` at
      their first divergence; the bf16_grouped slab run profiled over 4
      ticks: the sharded decode's device ms against the dense run's SDPA
      range, the NCCL kernels, the tick's wall and idle share;
   b. deepseek-v2-lite-16b (27 layers) under lut4, sharded (MLA has no
      grouped form) on the slab and the pool: the same counts
      (``sharded_mla_decode``) and token rule against phase 11a's lut4
      run (or one served here);
   c. ``quantized_psum`` on the one-rank group bitwise ``_q8``'s round
      trip, and the host's time of one all-reduce call; 2 of phase 8's
      steps (yi-9b depth 8, B 2 x S 4096) through the mesh step
      (``make_train_step(cfg, opt, mesh, grad_compression=True)`` on the
      sharded model): step 1's loss bitwise the uncompressed no-mesh
      loss on the same params and batch, and the gradients it hands
      AdamW bitwise ``compress_grads_int8`` of the uncompressed ones;
   d. training on the mesh: the mesh step (``parallel.fsdp.shard_model``,
      leaves gathered at use, gradients reduced over the rows' axes)
      against the no-mesh step on the same weights and batch, yi-9b at
      phase 8's depth and shape and mamba2-1.3b at phase 13's (48 layers,
      ``ssd_scan`` and ``ssd_scan_bwd`` launching under the mesh): step
      1's loss, every gradient AdamW gets and every updated parameter
      bitwise (one rank: every gather and reduction is the identity);
      each step's wall, peak GB, launches by kernel and the mesh's
      collectives; then the elastic round trip on reduced yi-9b: the mesh
      ``Trainer`` preempted after step 1 and a no-mesh ``Trainer``
      resuming its checkpoint, and the reverse, each bitwise a straight
      4-step run (losses and final params);
   the phase prints its seconds;
17. the dry run against the card (``launch.dryrun``, ``launch.cost``),
   after phase 16: each cell of ``DRYRUN_CELLS`` counted by the dry run
   (meta tensors, a one-rank fake world, in a child process started
   first) and run on the card on one one-rank NCCL mesh under the same
   cost mode: (a) yi-9b at phase 8's depth and shape, (b) mamba2-1.3b's
   48 layers at that shape (``ssd_scan``, ``ssd_scan_bwd``), (c) one lut4
   ``decode_step`` of yi-9b at that depth, 8 rows on a 1,024-token
   cache, ``decode_attn="sharded"``.  Checks: the FLOPs, every
   collective's count and every kernel's launches, FLOPs and bytes equal
   on meta and on the card, the kernels' launches equal the wrappers'
   counters, the argument bytes from the specs within ``ARG_REL`` of
   ``memory_allocated()``.  Prints each step's median wall of 3 after the
   counted one, ``step_time_lb_s``, the roofline fraction of the wall,
   ``mfu_bf16_dense`` (model FLOPs over wall × 989 TFLOP/s) and the peak
   estimate beside ``max_memory_allocated()``, with the card's name and
   power limit; the phase prints its seconds;
18. tensor-parallel compute over ``model`` (``parallel.tensor_parallel``:
   heads, FFN hidden and vocabulary split), on a one-rank NCCL group (a
   one-card machine runs the model axis at one rank; the multi-rank
   values are held on the CPU by the gloo tests):
   a. yi-9b at phase 8's depth and shape through the mesh step, bf16 and
      ``lut_nf4``, against the no-mesh step on the same weights and
      batch: loss, every gradient AdamW gets and every updated parameter
      bitwise; the TP collectives (``act_sharding.counts``) at
      ``TP_REDUCES`` a layer plus 2 (the embedding's reduce, the head's
      copy), no TP gather; ``lut_gemm`` launches (forward, recompute, dx)
      and ``NF4MatmulFn``'s backward launches counted;
   b. every yi-9b decode projection cut as the split cuts it (wq, wk, wv,
      w_gate, w_up by columns, wo, w_down by rows) for model axes 4 and
      16, each rank's shard after the other in this process, through
      ``lut_gemm_dc`` and ``lut_gemm_dc_res`` at M = 8 and ``lut_gemm`` at
      M = 8,192 (forward and dx): column shards concatenated equal the
      whole call within ``TP_SHARD_REL`` of its scale (bitwise where they
      are), row partials summed likewise, every shard on the tensor-core
      route (``launches_tc`` / ``launches_wgmma``); rank 0's 7 decode
      shards timed device-only beside the whole layer and the shards'
      byte bound;
   c. lut4 and nf4 ``decode_step`` of yi-9b at that depth under
      ``serve_param_sharding="tp"`` and ``decode_attn="sharded"`` (a
      full-precision split prefill of 8 prompts, then ``TP_TICKS``
      greedy ticks): logits bitwise the whole-weight layout's on the same
      mesh, tokens the no-mesh decode's (or within the window rule at a
      near-tie), the frozen leaves the specs' blocks, ``lut_gemm_dc`` /
      ``_res`` launches 7 a layer a tick, the TP collectives counted;
   the phase prints its seconds;
19. the moe family split over ``model`` (expert parallelism for the
   routed experts, the shared experts' and MLA's splits), on a one-rank
   NCCL group, deepseek-v2-lite-16b at its widths, ``MOE_TP_LAYERS`` deep
   (its dense first block and 3 MoE blocks):
   a. as 18a: the mesh step in bf16 and ``lut_nf4`` against the no-mesh
      step, bitwise; the TP all-reduces at ``MOE_TP_REDUCES`` a layer
      plus 2; ``lut_gemm`` launches (forward, recompute, dx);
   b. as 18b on an MoE layer's decode projections (``DSV2_TP_SHAPES``:
      MLA's wq by columns and wo by rows, w_dkv whole on every rank, the
      shared experts' w_gate/w_up by columns and w_down by rows) for
      model axes 4 and 16; rank 0's projections device-only beside the
      whole layer and their byte bound; and the routed experts' decode
      products (``experts_timing``): all 64 and each rank's E/m, the
      ranks' outputs against the whole call, device-only beside the
      experts' byte bound;
   c. as 18c: lut4 and nf4 ``decode_step`` at that depth under
      ``serve_param_sharding="tp"`` and ``decode_attn="sharded"``:
      logits bitwise the whole-weight layout's, tokens the no-mesh
      decode's (or the window rule), ``lut_gemm_dc`` / ``_res`` launches
      6 a layer a tick, the TP collectives counted;
   the phase prints its seconds;
each run of 6, 7, 9, 10, 11, 12, 14, 15 and 16 asserting every request finished,
every logit is finite and each kernel's launch counter (all set to 0
just before the run, read just after) equals the launches the run made
through it; then (after the counts are read) a torch.profiler window
over 4 decode ticks (and for mamba2 one prefill call, for zamba2 the
8-prompt prefill): device time by kernel and the idle
share (for the prefill call, device time as the union of the kernels'
intervals: ``ssd_scan``'s side stream overlaps its other kernels).
``--layers N`` cuts yi-9b's depth in phases 6, 9a, 10c and 16a (and
10a's to at most ``SPEC_LAYERS``).

Every line is one JSON object (``t_s``: seconds since the start); the
``{"kernels": [...]}`` line comes just before the last, which is
``{"ok": true, "device": ...}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
from collections import Counter
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import cost as kcost  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet; ``repro_torch.launch.roofline``)
HBM_BYTES_S = roofline.HBM_BW
BF16_FLOP_S = roofline.PEAK_FLOPS
INT8_OP_S = roofline.INT8_OPS
F32_FLOP_S = roofline.F32_FLOPS   # outside the tensor cores
TF32_FLOP_S = roofline.TF32_FLOPS
#: (K, N) of yi-9b's decode projections, in layer order wq wk wv wo
#: w_gate w_up w_down
LAYER_SHAPES = [(4096, 4096), (4096, 512), (4096, 512), (4096, 4096),
                (4096, 11008), (4096, 11008), (11008, 4096)]
#: (K, N) of mamba2-1.3b's decode projections: w_in, w_out
MAMBA2_SHAPES = [(2048, 8512), (4096, 2048)]
#: (K, N) of deepseek-v2-lite-16b's frozen decode projections: wq, w_dkv,
#: wo; the shared experts' w_gate / w_up and w_down; the dense block's MLP
#: w_gate / w_up and w_down (the routed experts are never frozen)
DSV2_LITE_SHAPES = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 2816),
                    (2816, 2048), (2048, 10944), (10944, 2048)]
#: a deepseek-v2-lite MoE layer's 6 frozen projections, and its dense
#: (first) layer's 6, in layer order
DSV2_MOE_LAYER = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 2816),
                  (2048, 2816), (2816, 2048)]
DSV2_DENSE_LAYER = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 10944),
                    (2048, 10944), (10944, 2048)]
#: minitron-4b's decode projections, in layer order wq wk wv wo w_up w_down
MINITRON_SHAPES = [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072),
                   (3072, 9216), (9216, 3072)]
#: zamba2-1.2b's frozen decode projections: the shared block's wq wk wv wo
#: (32 heads and 32 KV heads of 64) and its SwiGLU MLP's w_gate w_up
#: w_down, once a group (7 groups a tick); a Mamba2 layer's w_in (2 x 4096
#: + 2 x 64 + 64 = 8384 columns) and w_out (38 layers a tick)
ZAMBA2_SHARED = [(2048, 2048)] * 4 + [(2048, 8192), (2048, 8192),
                                      (8192, 2048)]
ZAMBA2_MAMBA = [(2048, 8384), (4096, 2048)]


def projections(cfg) -> int:
    """Frozen decode projections a layer (LUT GEMM launches a layer of a
    decode tick): attention's 4 (MLA's wq or w_dq + w_uq, w_dkv, wo), and
    the MLP's (the moe family's shared experts and dense blocks: SwiGLU's
    3, GELU's 2); mamba2's w_in and w_out."""
    if cfg.family == "ssm":
        return 2
    attn = 4 if cfg.mla is None or cfg.mla.q_lora_rank else 3
    return attn + (3 if cfg.mlp_type == "swiglu" else 2)


def tick_launches(cfg) -> int:
    """LUT GEMM launches of one decode step of the frozen tree:
    :func:`projections` a layer; the hybrid's shared block 7 a group
    (SwiGLU) and w_in / w_out a Mamba2 layer (zamba2-1.2b: 7 x 7 + 38 x 2
    = 125)."""
    if cfg.family == "hybrid":
        groups = -(-cfg.num_layers // cfg.hybrid.period)
        return groups * 7 + cfg.num_layers * 2
    return cfg.num_layers * projections(cfg)


def scan_calls(cfg) -> int:
    """``ssd_scan`` launches of one multi-token forward (a prefill call, a
    piece, a verify or commit window): one a Mamba2 layer (ssm, hybrid)."""
    return cfg.num_layers if cfg.ssm is not None else 0
COLD_BYTES = 256 << 20       # rotate code copies past the 50 MB L2
#: the wrappers that count their tensor-core route's launches
#: (``launches_tc``; lut_gemm's prefill kernel's in ``launches_wgmma``)
TC_ROUTED = ("luna_mm", "lut_gemm_dc", "lut_gemm_dc_res", "lut_gemm")


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn(i)`` by CUDA events, after warm-up."""
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Device-only ms per call of ``fn(i)``: ``calls`` calls (i = 0 ..
    calls - 1) captured in one CUDA graph, their workspaces from the
    graph's pool, the graph replayed ``replays`` times between CUDA
    events.  No host time is between the launches, unlike
    :func:`cuda_ms`, which at decode sizes times the host wrapper."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def synced(what: str, fn):
    """``fn()``, then ``torch.cuda.synchronize()``: a fault during the
    launch surfaces here, named by ``what``."""
    import torch
    try:
        out = fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise RuntimeError(f"chip_smoke: {what} failed: {e}") from e
    return out


def bound_ms(m: int, k: int, n: int, x_bytes: int, table_bytes: int,
             vec_bytes: int = 8, ops: float | None = None,
             peak: float = BF16_FLOP_S) -> tuple[float, str]:
    """Least time for one call: each input read once (x, codes, tables,
    ``vec_bytes`` per output channel), the 4-byte output written once,
    against ``ops`` (default 2MKN) at ``peak``; the larger of the two
    (``kcost.lut_gemm_cost``, the package's formula, which the dry run
    reads too)."""
    return roofline.bound_ms(*kcost.lut_gemm_cost(
        m, k, n, x_bytes, table_bytes, vec_bytes, ops), peak)


def layer_summary(name: str, rows: list, m: int, shapes=LAYER_SHAPES,
                  **kw) -> dict:
    """The kernels-line entry: one layer's projections (default yi-9b's
    7) at ``m`` rows, summed from the per-shape ``rows`` of one kernel
    (and mode): every time (``ms`` and each ``*_ms`` key), None where a
    shape has none."""
    at = {(s["k"], s["n"]): s for s in rows if s["m"] == m}
    layer = [at[kn] for kn in shapes]
    times = {"library_ms": None}
    for key in layer[0]:
        if key == "ms" or key.endswith("_ms"):
            vals = [s.get(key) for s in layer]
            times[key] = None if None in vals else sum(vals)
    return {
        "name": name, "route": "cuda", "launches": None, **times,
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in layer) else "operations", **kw}


def cold_copies(t, nbytes: int) -> list:
    """``t`` and enough clones of it to exceed the 50 MB L2 together."""
    return [t] + [t.clone() for _ in range(max(1, COLD_BYTES // nbytes) - 1)]


def sass_loops(lib, match, stream: str = "LDG") -> list:
    """The loops of every kernel in ``lib`` whose (mangled) name holds all
    of ``match``, from ``cuobjdump -sass``: per loop (a branch back to an
    earlier address) that holds a ``stream`` instruction, its SASS
    instructions and, by opcode, the code loads (``LDG``: 4 codes a 32-bit
    load in lut_gemm.cu, 16 a 128-bit load in lut_gemm_tc.cu), the
    tensor-core products (``HMMA``; ``HGMMA``, wgmma), the shared loads
    and the byte permutes, so that instructions per code are read off the
    loop that streams the codes (lut_gemm_wgmma.cu's codes arrive by TMA:
    ``stream="HGMMA"`` finds its loops)."""
    import re
    import shutil
    cuobjdump = os.path.join(os.path.dirname(
        shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return ["not measured: no cuobjdump"]
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    found = []
    for func in out.split("Function : ")[1:]:
        name = func.split("\n", 1)[0].strip()
        if not all(m in name for m in match):
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        for end, (addr, text) in enumerate(ins):
            tgt = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
            if not tgt or int(tgt.group(1), 16) >= addr:
                continue
            loop = [t.split()[1 if t.startswith("@") else 0]
                    for _, t in ins[at[int(tgt.group(1), 16)]:end + 1]]

            def ops(name):
                return sum(1 for op in loop if op.split(".")[0] == name)
            ldg_128 = sum(1 for op in loop if op.split(".")[0] == "LDG"
                          and ".128" in op)
            ldg_32 = ops("LDG") - ldg_128 - sum(
                1 for op in loop if op.split(".")[0] == "LDG" and ".64" in op)
            if (ldg_32 + ldg_128 if stream == "LDG" else ops(stream)) == 0:
                continue            # not a loop over the codes
            found.append({"kernel": name[-60:], "instructions": len(loop),
                          "ldg_32": ldg_32, "ldg_128": ldg_128,
                          "hmma": ops("HMMA"), "hgmma": ops("HGMMA"),
                          "lds": ops("LDS"),
                          "prmt": ops("PRMT"), "ffma": ops("FFMA")})
    return found


#: M of phase 3a's tensor-core checks (decode sizes up to the kernel's 32)
DC_TC_M = (1, 8, 16, 32)
#: the verify window's M: max_batch 8 x (spec_k 4 + 1), past TC_MAX_M
VERIFY_M = 40


def kernel_phase(dev, device_times: bool = True):
    """Phase 3a: both D&C wrappers on both their kernels against the plain
    versions, each checked call synchronised and named (spec, shape, call)
    on a fault, the kernel each public call ran read from ``launches_tc``
    and held to ``takes_tc``.  At every yi-9b and mamba2 shape: the
    tensor-core kernel (``lut_gemm_tc.cu``, the route of bf16 x at M <=
    32) at ``DC_TC_M``, the f32-FMA kernel (``lut_gemm.cu``) at M in {1, 8}
    on bf16 x and at M = 8 on f32 x; x = I bitwise, the whole (256, 4096)
    at once on the f32 kernel and 8 rows a call on the tensor-core one;
    ragged shapes on each.  Times, codes cold in L2: at M = 8 both kernels
    by CUDA events and device-only (``graph_ms``), at the other M
    device-only (the route's edge).  ``device_times=False`` leaves out the
    CUDA-graph timings (for a run under ``CUDA_LAUNCH_BLOCKING=1``, which
    graph capture does not take)."""
    from dataclasses import replace

    import torch

    from repro_torch.core.quant import NF4P_PRUNE_THRESHOLD, quantize_weight
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def simt(x, q):
        return lg._launch(x, q.codes, q.scale, q.hi_tab, q.lo_tab,
                          q.residual, q.zero_point)

    def tc(x, q):
        return lg._launch_tc(x, q.codes, q.scale, q.hi_tab, q.lo_tab,
                             q.residual, q.zero_point)

    specs = {
        "lut_gemm_dc": dict(
            fn=lg.lut_gemm_dc,
            args=lambda q: (q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                            q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.zero_point, q.scale),
            quant=("lut_dc", None), table_bytes=32,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:214"),
        "lut_gemm_dc_res": dict(
            fn=lg.lut_gemm_dc_res,
            args=lambda q: (q.codes, q.hi_tab, q.lo_tab, q.residual,
                            q.zero_point, q.scale),
            plain=lambda x, q: ref.lut_gemm_dc_res_ref(
                x, q.codes, q.hi_tab, q.lo_tab, q.residual, q.zero_point,
                q.scale),
            quant=("nf4_dc", NF4P_PRUNE_THRESHOLD), table_bytes=96,
            replaces="src/repro/kernels/lut_gemm/lut_gemm.py:168"),
    }
    results = {}
    for name, sp in specs.items():
        wrap = sp["fn"]

        def qweight(k, n):
            w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
            return synced(f"phase 3a {name}: quantize_weight ({k}, {n})",
                          lambda: quantize_weight(w, *sp["quant"]))

        def public(x, q, what):
            """The public call, its kernel held to ``takes_tc``."""
            m, k = x.shape
            n = q.codes.shape[1]
            tc0 = wrap.launches_tc
            out = synced(f"phase 3a {name} ({m}, {k}, {n}): {what}",
                         lambda: wrap(x, *sp["args"](q)))
            want_tc = lg.takes_tc(m, k, n, x.dtype, True)
            check(wrap.launches_tc - tc0 == want_tc,
                  f"{name} ({m}, {k}, {n}) {x.dtype}: "
                  f"{wrap.launches_tc - tc0} tensor-core launches, "
                  f"takes_tc says {want_tc}")
            return out

        def hold(x, q, what, out=None):
            m, k = x.shape
            n = q.codes.shape[1]
            out = public(x, q, what) if out is None else out
            plain = synced(f"phase 3a {name} ({m}, {k}, {n}): plain "
                           "version", lambda: sp["plain"](x, q))
            torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                       atol=lg.KERNEL_ATOL)
            return (out - plain).abs().max().item()

        # exact: x = I reads the dequantized weight back, bitwise: the
        # f32-FMA kernel at M = 256, the tensor-core kernel 8 rows a call
        q = qweight(256, 4096)
        eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
        want = synced(f"phase 3a {name}: dc_dequant (256, 4096), the plain "
                      "x = I reference", lambda: ref.dc_dequant(
                          q.codes, q.hi_tab, q.lo_tab, q.zero_point,
                          q.residual) * q.scale[None, :])
        got = public(eye, q, "f32 kernel, x = I")
        check(torch.equal(got, want), f"{name}: x = I output of the f32 "
              "kernel is not bitwise the dequantized weight")
        for r in range(0, 256, 8):
            got = public(eye[r:r + 8], q, f"tensor-core kernel, x = I rows "
                         f"{r}..{r + 7}")
            check(torch.equal(got, want[r:r + 8]),
                  f"{name}: x = I rows {r}..{r + 7} on the tensor-core "
                  "kernel are not bitwise the dequantized weight")
        # ragged M, K, N: the f32 kernel's unvectorised path; the tensor-
        # core kernel's zero-filled steps, columns and n-tiles
        max_err = 0.0
        for m, k, n, dt in ((3, 72, 40, torch.float32),
                            (3, 72, 48, torch.bfloat16),
                            (29, 1000, 208, torch.bfloat16)):
            q = qweight(k, n)
            x = torch.randn((m, k), generator=gen, device=dev, dtype=dt)
            max_err = max(max_err, hold(x, q, "ragged"))

        per_shape = []
        # yi-9b's and mamba2's shapes at every M of the route; the moe
        # family's, minitron-4b's and zamba2-1.2b's at decode's M = 8 (and
        # verify's 40)
        base = set(LAYER_SHAPES) | set(MAMBA2_SHAPES)
        for k, n in sorted(base | set(DSV2_LITE_SHAPES)
                           | set(MINITRON_SHAPES) | set(ZAMBA2_SHARED)
                           | set(ZAMBA2_MAMBA)):
            q = qweight(k, n)
            copies = [q] + [replace(q, codes=q.codes.clone()) for _ in
                            range(max(1, COLD_BYTES // (k * n)) - 1)]
            calls = max(20, len(copies))
            for m in DC_TC_M if (k, n) in base else (8,):
                x = torch.randn((m, k), generator=gen, device=dev,
                                dtype=torch.bfloat16)
                max_err = max(max_err, hold(x, q, "public call"))
                row = {"m": m, "k": k, "n": n}
                if m in (1, 8):
                    max_err = max(max_err, hold(x, q, "f32-FMA kernel", synced(
                        f"phase 3a {name} ({m}, {k}, {n}): f32-FMA kernel",
                        lambda: simt(x, q))))
                if m == 8:
                    xf = x.float()
                    max_err = max(max_err, hold(xf, q, "public call, f32 x"))
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        m, k, n, 2, sp["table_bytes"])
                if m == 8 and (k, n) in base:
                    row["ms"] = cuda_ms(lambda i: wrap(
                        x, *sp["args"](copies[i % len(copies)])), 100)
                    row["simt_ms"] = cuda_ms(
                        lambda i: simt(x, copies[i % len(copies)]), 100)
                    row["plain_ms"] = cuda_ms(
                        lambda i: sp["plain"](x, copies[i % len(copies)]),
                        10)
                if device_times:
                    row["device_ms"] = graph_ms(
                        lambda i: tc(x, copies[i % len(copies)]), calls)
                    row["simt_device_ms"] = graph_ms(
                        lambda i: simt(x, copies[i % len(copies)]), calls)
                per_shape.append(row)
            # speculation's verify window: the public call at M = 40 runs
            # the f32-FMA kernel (takes_tc is false past TC_MAX_M)
            x = torch.randn((VERIFY_M, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            max_err = max(max_err, hold(x, q, "public call, verify M"))
            row = {"m": VERIFY_M, "k": k, "n": n}
            row["bound_ms"], row["bound_by"] = bound_ms(
                VERIFY_M, k, n, 2, sp["table_bytes"])
            if device_times:
                row["simt_device_ms"] = graph_ms(
                    lambda i: simt(x, copies[i % len(copies)]), calls)
            per_shape.append(row)
            del copies
        emit({"kernel_check": name, "passed": True, "max_abs_err": max_err,
              "rtol": lg.KERNEL_RTOL, "atol": lg.KERNEL_ATOL,
              "x_identity_tc_calls": 32, "per_shape": per_shape})

        # the route's edge: one yi-9b layer's 7 projections, device-only
        route = []
        for m in DC_TC_M:
            at = {(r["k"], r["n"]): r for r in per_shape if r["m"] == m}
            if device_times:
                route.append({"m": m, **{
                    key: sum(at[kn][key] for kn in LAYER_SHAPES)
                    for key in ("device_ms", "simt_device_ms")}})
        emit({"dc_route": name, "tc_max_m": lg.TC_MAX_M,
              "layer_device_ms": route})

        # deepseek-v2-lite's, minitron-4b's and zamba2-1.2b's layers,
        # device-only at decode's M = 8 on each kernel and at verify's M =
        # 40 on lut_gemm.cu, beside the byte bound
        others = {}
        for label, shapes in (("dsv2_lite_moe_layer", DSV2_MOE_LAYER),
                              ("dsv2_lite_dense_layer", DSV2_DENSE_LAYER),
                              ("minitron_layer", MINITRON_SHAPES),
                              ("zamba2_shared_block", ZAMBA2_SHARED),
                              ("zamba2_mamba_layer", ZAMBA2_MAMBA)):
            others[label] = {f"m{m}_{k}": v for m in (8, VERIFY_M)
                             for k, v in layer_summary(
                                 name, per_shape, m, shapes).items()
                             if k in ("device_ms", "simt_device_ms",
                                      "bound_ms")}
        # a zamba2 decode tick's 125: the shared block 7 times, 38 layers
        others["zamba2_tick"] = {
            key: 7 * others["zamba2_shared_block"][key]
            + 38 * others["zamba2_mamba_layer"][key]
            for key in others["zamba2_shared_block"]
            if others["zamba2_shared_block"][key] is not None}
        emit({"dc_layers": name, **others,
              "timed_as": "a layer's frozen decode projections, bf16 x, "
                          "codes cold in L2, device-only (graph_ms): "
                          "device_ms the tensor-core kernel, "
                          "simt_device_ms lut_gemm.cu; M = 40 runs "
                          "lut_gemm.cu (past TC_MAX_M); zamba2_tick: 7 "
                          "shared blocks + 38 Mamba2 layers (125 calls)"})

        # one decoder layer's 7 projections at the main path's M = 8
        results[name] = layer_summary(
            name, [r for r in per_shape if r["m"] == 8], 8,
            source="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm_tc.cu",
            source_simt="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
            replaces=sp["replaces"], max_abs_err=max_err, launches_tc=None,
            timed_as="one yi-9b layer's 7 decode projections, M=8, bf16 x, "
                     "codes cold in L2; ms the public call (the tensor-core "
                     "kernel) and simt_ms the f32-FMA kernel by CUDA events "
                     "around eager calls (the host wrapper included), "
                     "device_ms and simt_device_ms the same kernels by "
                     "CUDA-graph replays (graph_ms)",
            mamba2_layer={
                k: v for k, v in layer_summary(
                    name, [r for r in per_shape if r["m"] == 8], 8,
                    MAMBA2_SHAPES).items()
                if k in ("ms", "simt_ms", "device_ms", "simt_device_ms",
                         "plain_ms", "bound_ms", "bound_by")} | {
                "timed_as": "one mamba2-1.3b layer's w_in (2048 x 8512) "
                            "and w_out (4096 x 2048), M=8"},
            verify_m40={
                f"{model}_{k}": v for model, shapes in (
                    ("yi9b", LAYER_SHAPES), ("mamba2", MAMBA2_SHAPES))
                for k, v in layer_summary(
                    name, [r for r in per_shape if r["m"] == VERIFY_M],
                    VERIFY_M, shapes).items()
                if k in ("simt_device_ms", "bound_ms")} | {
                "timed_as": "one layer's decode projections at verify's "
                            "M=40 (8 rows x 5 window columns), bf16 x, on "
                            "the f32-FMA kernel the route takes there, "
                            "device-only (graph_ms), codes cold in L2"},
            **others)
        gc.collect()
        torch.cuda.empty_cache()
    return results


LUNA_MODES = ("conventional", "opt_dc", "dc", "approx_dc", "approx_dc2")
#: digit-plane contractions each mode runs (approx_dc2 adds colsum(W))
LUNA_PLANES = kcost.LUNA_PLANES


#: phase 3b's tile edges of the tensor-core kernel (M, K, N): M at and
#: past its 64-row warpgroups and 128-row blocks, K inside one 128-byte K
#: tile, at it and past it (K % 16 == 0, TMA's rule), N at 16, at the
#: 128-column tile and past it; one-tile outputs split K the most
LUNA_EDGE_SHAPES = [(64, 128, 16), (65, 144, 128), (127, 4112, 144),
                    (128, 256, 256), (129, 4096, 520), (200, 11008, 48)]
#: M of phase 3b's device-only route timings (the threshold's readings)
LUNA_ROUTE_M = (8, 16, 32, 64, 128)
#: M of phase 3b's timed shapes: decode, prefill, phase 8's QAT (B * S)
LUNA_M = (8, 512, 2048)


def luna_bound_ms(m: int, k: int, n: int, mode: str) -> tuple[float, str]:
    """Least time of one luna_mm call: y and w read once and the int32
    output written once, against 2MKN int8 operations per digit plane the
    mode runs (plus K N adds of approx_dc2's colsum) at 1,979 TOP/s
    (``kcost.luna_mm_cost``)."""
    return roofline.bound_ms(*kcost.luna_mm_cost(m, k, n, mode), INT8_OP_S)


def luna_kernel_phase(dev):
    """Phase 3b: both luna_mm kernels against the plain version, every
    mode, bitwise, each checked call synchronised: the public call on a
    row-major and on a K-major W (which kernel ran read from
    ``launches_tc`` and held to ``takes_tc``), the __dp4a kernel and,
    where it takes the shape, the tensor-core kernel on both layouts, at
    the ragged 3 x 72 x 40, the tensor-core kernel's tile edges, the route
    timings' shapes and yi-9b's four projection shapes at M in
    ``LUNA_M``.  Times, codes cold in L2: device-only (CUDA graphs) of
    both kernels at ``LUNA_ROUTE_M``; at ``LUNA_M`` by CUDA events the
    public call on each layout, each kernel alone, the plain version and
    ``torch._int_mm`` on a row-major and on a K-major W (the exact modes,
    M > 16), and device-only the public call and the __dp4a kernel; and
    the main path's cast of int32 weight codes to int8."""
    import torch

    from repro_torch.core.luna import LunaMode
    from repro_torch.kernels.luna_mm import luna_mm as lm
    from repro_torch.kernels.luna_mm.ref import luna_mm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    wrap = lm.luna_mm

    def codes(*shape):
        return torch.randint(0, 16, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def kmajor(w):
        return w.t().contiguous().t()

    def hold(y, w, wk, mode):
        """Every route of one call against the plain version, bitwise."""
        (m, k), n = y.shape, w.shape[1]
        what = f"phase 3b luna_mm {mode} ({m}, {k}, {n})"
        want = synced(f"{what}: plain version",
                      lambda: luna_mm_ref(y, w, mode))
        runs = {}
        for layout, ww in (("row", w), ("k", wk)):
            tc0 = wrap.launches_tc
            runs[f"luna_mm on a {layout}-major W"] = synced(
                f"{what}: luna_mm on a {layout}-major W",
                lambda: wrap(y, ww, mode))
            tc = wrap.launches_tc - tc0
            check(tc == lm.takes_tc(m, k, n, layout, True),
                  f"{what}, {layout}-major W: {tc} tensor-core launches, "
                  f"takes_tc says {lm.takes_tc(m, k, n, layout, True)}")
        runs["the dp4a kernel"] = synced(
            f"{what}: the dp4a kernel",
            lambda: lm._launch(y, w, LunaMode(mode)))
        if k % lm.TC_ALIGN == 0 and n % lm.TC_ALIGN == 0:
            for layout, ww in (("row", w), ("k", wk)):
                runs[f"the tensor-core kernel, {layout}-major W"] = synced(
                    f"{what}: the tensor-core kernel, {layout}-major W",
                    lambda: lm._launch_tc(y, ww, layout, LunaMode(mode)))
        for name, got in runs.items():
            check(torch.equal(got, want),
                  f"{what}: {name} is not bitwise equal to the plain "
                  "version")
        return len(runs)

    checked = 0
    for m, k, n in [(3, 72, 40)] + LUNA_EDGE_SHAPES:
        y, w = codes(m, k), codes(k, n)
        wk = kmajor(w)
        for mode in LUNA_MODES:
            checked += hold(y, w, wk, mode)

    # device-only times of both kernels around the route's threshold
    route = []
    for k, n in sorted(set(LAYER_SHAPES)):
        rows = cold_copies(codes(k, n), k * n)
        ks = [kmajor(w) for w in rows]
        calls = max(20, len(rows))
        for m in LUNA_ROUTE_M:
            y = codes(m, k)
            for mode in ("approx_dc2", "dc"):
                checked += hold(y, rows[0], ks[0], mode)
                lmode = LunaMode(mode)
                route.append({
                    "mode": mode, "m": m, "k": k, "n": n,
                    "dp4a_ms": graph_ms(lambda i: lm._launch(
                        y, rows[i % len(rows)], lmode), calls),
                    "tc_row_ms": graph_ms(lambda i: lm._launch_tc(
                        y, rows[i % len(rows)], "row", lmode), calls),
                    "tc_k_ms": graph_ms(lambda i: lm._launch_tc(
                        y, ks[i % len(ks)], "k", lmode), calls)})
        del rows, ks
    layer = {}
    for r in route:
        key = (r["mode"], r["m"])
        acc = layer.setdefault(key, {"mode": r["mode"], "m": r["m"],
                                     "dp4a_ms": 0.0, "tc_row_ms": 0.0,
                                     "tc_k_ms": 0.0})
        for t in ("dp4a_ms", "tc_row_ms", "tc_k_ms"):
            acc[t] += r[t] * LAYER_SHAPES.count((r["k"], r["n"]))
    faster_from = {}
    for layout in ("row", "k"):
        wins = [m for m in LUNA_ROUTE_M
                if all(layer[(mode, mm)][f"tc_{layout}_ms"]
                       < layer[(mode, mm)]["dp4a_ms"]
                       for mode in ("approx_dc2", "dc")
                       for mm in LUNA_ROUTE_M if mm >= m)]
        faster_from[layout] = min(wins) if wins else None
    emit({"luna_route": "device-only ms (CUDA-graph replays), codes cold "
                        "in L2; layer = yi-9b's 7 projections",
          "tc_min_m": lm.TC_MIN_M, "tc_faster_from_m": faster_from,
          "layer": list(layer.values()), "per_shape": route})

    per_shape = []
    iters = {8: 50, 512: 30, 2048: 10}
    for k, n in sorted(set(LAYER_SHAPES)):
        rows = cold_copies(codes(k, n), k * n)
        ks = [kmajor(w) for w in rows]
        for m in LUNA_M:
            y = codes(m, k)
            it = iters[m]
            lib = {}
            if m > 16:
                lib = {"library_ms": cuda_ms(lambda i: torch._int_mm(
                           y, rows[i % len(rows)]), it),
                       "library_kmajor_ms": cuda_ms(lambda i: torch._int_mm(
                           y, ks[i % len(ks)]), it)}
            for mode in LUNA_MODES:
                checked += hold(y, rows[0], ks[0], mode)
                lmode = LunaMode(mode)
                row = {"mode": mode, "m": m, "k": k, "n": n,
                       "tc": lm.takes_tc(m, k, n, "row", True),
                       "ms": cuda_ms(lambda i: wrap(
                           y, rows[i % len(rows)], mode), it),
                       "kmajor_ms": cuda_ms(lambda i: wrap(
                           y, ks[i % len(ks)], mode), it),
                       "dp4a_ms": cuda_ms(lambda i: lm._launch(
                           y, rows[i % len(rows)], lmode), it),
                       "tc_ms": cuda_ms(lambda i: lm._launch_tc(
                           y, ks[i % len(ks)], "k", lmode), it),
                       "plain_ms": cuda_ms(lambda i: luna_mm_ref(
                           y, rows[i % len(rows)], mode), 3)}
                row["device_ms"] = graph_ms(
                    lambda i: wrap(y, rows[i % len(rows)], mode),
                    max(5 if m > 8 else 20, len(rows)), 3)
                row["dp4a_device_ms"] = (row["device_ms"] if m == 8 else
                                         graph_ms(lambda i: lm._launch(
                                             y, rows[i % len(rows)], lmode),
                                             max(5, len(rows)), 3))
                row["bound_ms"], row["bound_by"] = luna_bound_ms(m, k, n,
                                                                 mode)
                exact = mode in ("conventional", "dc", "opt_dc")
                row["library_ms"] = lib.get("library_ms") if exact else None
                row["library_kmajor_ms"] = (lib.get("library_kmajor_ms")
                                            if exact else None)
                row["top_s"] = (2 * m * k * n * LUNA_PLANES[mode]
                                / row["ms"] / 1e9)
                per_shape.append(row)
        del rows, ks
    emit({"kernel_check": "luna_mm", "passed": True, "max_abs_err": 0,
          "bitwise": True, "modes": list(LUNA_MODES),
          "calls_held": checked, "edge_shapes": LUNA_EDGE_SHAPES,
          "per_shape": per_shape})

    # the main path's cast of the weight codes (int32 from quantize) to
    # int8, row-major (for the wrapper's transpose) or K-major directly
    k, n = 4096, 11008
    qw = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                       dtype=torch.int32)
    w8 = qw.to(torch.int8)
    casts = {
        "row_major_cast_ms": cuda_ms(lambda i: qw.to(torch.int8), 20),
        "kmajor_cast_ms": cuda_ms(lambda i: torch.empty(
            (n, k), dtype=torch.int8, device=dev).copy_(qw.t()), 20),
        "transpose_ms": cuda_ms(lambda i: lm._tc_lib().luna_mm_tc_transpose(
            w8.data_ptr(), torch.empty((n, k), dtype=torch.int8,
                                       device=dev).data_ptr(), k, n,
            torch.cuda.current_stream().cuda_stream), 20)}
    check(torch.equal(torch.empty((n, k), dtype=torch.int8, device=dev)
                      .copy_(qw.t()), w8.t().contiguous()),
          "the K-major cast differs from the row-major one transposed")
    emit({"luna_ops_cast": f"int32 codes ({k}, {n}) -> int8", **casts})
    del qw, w8

    def summary(m, mode, timed_as):
        return {k: v for k, v in layer_summary(
            "luna_mm", [r for r in per_shape if r["mode"] == mode], m
        ).items() if k not in ("name", "route", "launches")} | {
            "timed_as": timed_as}

    entry = layer_summary(
        "luna_mm", [r for r in per_shape if r["mode"] == "opt_dc"], 512,
        source="src/repro_torch/kernels/luna_mm/csrc/luna_mm_tc.cu",
        source_dp4a="src/repro_torch/kernels/luna_mm/csrc/luna_mm.cu",
        replaces="src/repro/kernels/luna_mm/luna_mm.py:77", max_abs_err=0,
        launches_tc=None,
        timed_as="one yi-9b layer's 7 projections at M=512 (prefill), "
                 "mode opt_dc, codes cold in L2, by CUDA events around "
                 "eager calls: ms the public call on a row-major W (the "
                 "tensor-core kernel, its transpose included), kmajor_ms "
                 "on a K-major W, dp4a_ms the __dp4a kernel, tc_ms the "
                 "tensor-core kernel alone on a K-major W; device_ms and "
                 "dp4a_device_ms the public call and the __dp4a kernel "
                 "by CUDA-graph replays; library: torch._int_mm on a "
                 "row-major W, library_kmajor_ms on a K-major W",
        decode=summary(8, "approx_dc2",
                       "one layer, M=8 (decode), approx_dc2: the __dp4a "
                       "kernel"),
        qat=summary(2048, "approx_dc",
                    "one layer, M=2048 (phase 8's QAT), approx_dc"))
    gc.collect()
    torch.cuda.empty_cache()
    return {"luna_mm": entry}


#: M of phase 3c: decode's 8, the tensor-core decode kernel's edge (16,
#: 32), the engine's prefill calls (rows x bucket length: 448, 336, 272,
#: 176, 160, 64, 48 and 32) and 512
LUT_FULL_M = (8, 16, 32, 48, 64, 160, 176, 272, 336, 448, 512)
#: lut_gemm's kernels by route, as timed in phase 3c
LUT_FULL_KERNELS = {"tc": "lut_gemm_tc.cu", "wgmma": "lut_gemm_wgmma.cu",
                    "fma": "lut_gemm.cu"}


def lut_full_kernel_phase(dev):
    """Phase 3c: the full-table lut_gemm on each of its kernels against its
    plain version (1e-4), each checked call synchronised and named, the
    kernel each public call ran read from ``launches_tc`` /
    ``launches_wgmma`` and held to ``route``.  x = I bitwise on every
    kernel (``lut_gemm.cu`` and the prefill kernel at once, the tensor-core
    decode kernel 32 rows a call); ragged shapes on each route and on the
    shapes TMA cannot take; then at yi-9b's projection shapes and every M
    of ``LUT_FULL_M`` (codes cold in L2) the public call and every kernel
    that can take that M (the decode kernel up to its 32, the prefill
    kernel and ``lut_gemm.cu`` at all), each held to the plain version and
    timed device-only (``graph_ms``) and by CUDA events; the bound at the
    bf16 peak and the three-piece floor (three bf16 products) beside."""
    import torch

    from repro_torch.core.lut import NF4_CODEBOOK
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref
    from repro_torch.kernels.lut_gemm.ops import codebook_quantize

    gen = torch.Generator(device=dev).manual_seed(2)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    wrap = lg.lut_gemm

    def qweight(k, n):
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        return codebook_quantize(w.bfloat16(), cb)

    def kernel(x, codes, scale, name):
        if name == "fma":
            return lg._launch(x, codes, scale, codebook=cb)
        return lg._launch_full(x, codes, cb, scale, name)

    def public(x, codes, scale, what):
        """The public call, its kernel held to ``route``."""
        m, k = x.shape
        n = codes.shape[1]
        before = (wrap.launches_tc, wrap.launches_wgmma)
        out = synced(f"phase 3c lut_gemm ({m}, {k}, {n}) {x.dtype}: {what}",
                     lambda: wrap(x, codes, cb, scale))
        ran = {(1, 0): "tc", (0, 1): "wgmma", (0, 0): "fma"}[
            (wrap.launches_tc - before[0], wrap.launches_wgmma - before[1])]
        want = lg.route(m, k, n, x.dtype, True)
        check(ran == want, f"lut_gemm ({m}, {k}, {n}) {x.dtype}: ran on "
              f"{ran}, route says {want}")
        return out

    def hold(x, codes, scale, out):
        plain = ref.lut_gemm_ref(x, codes, cb, scale)
        torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                   atol=lg.KERNEL_ATOL)
        return (out - plain).abs().max().item()

    # exact: x = I reads CB[q] * scale back bitwise on every kernel
    codes, scale = qweight(256, 4096)
    want = cb[codes.long()] * scale[None, :]
    eye = torch.eye(256, device=dev, dtype=torch.bfloat16)
    got = synced("phase 3c lut_gemm: lut_gemm.cu, x = I",
                 lambda: kernel(eye, codes, scale, "fma"))
    check(torch.equal(got, want), "lut_gemm: x = I output of lut_gemm.cu is "
          "not bitwise CB[q] * scale")
    check(torch.equal(public(eye, codes, scale, "x = I (prefill kernel)"),
                      want), "lut_gemm: x = I output of the prefill kernel "
          "is not bitwise CB[q] * scale")
    for r in range(0, 256, lg.TC_MAX_M):
        rows = slice(r, r + lg.TC_MAX_M)
        check(torch.equal(public(eye[rows], codes, scale,
                                 f"x = I rows {r}.. (decode kernel)"),
                          want[rows]),
              f"lut_gemm: x = I rows {r}.. on the decode kernel are not "
              "bitwise CB[q] * scale")
    # ragged M, K, N on each route; f32 x and shapes TMA cannot take on
    # lut_gemm.cu
    max_err = 0.0
    for m, k, n, dt in ((3, 72, 40, torch.float32),
                        (29, 1000, 208, torch.bfloat16),
                        (100, 528, 4112, torch.bfloat16),
                        (300, 4112, 528, torch.bfloat16),
                        (40, 520, 4104, torch.bfloat16),
                        (64, 4104, 520, torch.bfloat16)):
        codes, scale = qweight(k, n)
        x = torch.randn((m, k), generator=gen, device=dev, dtype=dt)
        max_err = max(max_err, hold(x, codes, scale,
                                    public(x, codes, scale, "ragged")))

    per_shape = []
    for k, n in sorted(set(LAYER_SHAPES)):
        codes, scale = qweight(k, n)
        copies = cold_copies(codes, k * n)
        calls = max(10, len(copies))
        for m in LUT_FULL_M:
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            route = lg.route(m, k, n, x.dtype, True)
            max_err = max(max_err, hold(x, codes, scale, public(
                x, codes, scale, "public call")))
            row = {"m": m, "k": k, "n": n, "route": route}
            for name in ("tc", "wgmma", "fma"):
                if name == "tc" and m > lg.TC_MAX_M:
                    continue
                out = synced(f"phase 3c lut_gemm ({m}, {k}, {n}): "
                             f"{LUT_FULL_KERNELS[name]}",
                             lambda: kernel(x, codes, scale, name))
                max_err = max(max_err, hold(x, codes, scale, out))
                row[f"{name}_device_ms"] = graph_ms(
                    lambda i: kernel(x, copies[i % len(copies)], scale, name),
                    calls, 3)
                row[f"{name}_ms"] = cuda_ms(
                    lambda i: kernel(x, copies[i % len(copies)], scale, name),
                    calls)
            row["ms"] = cuda_ms(lambda i: wrap(x, copies[i % len(copies)],
                                               cb, scale), calls)
            row["device_ms"] = row[f"{route}_device_ms"]
            row["plain_ms"] = cuda_ms(lambda i: ref.lut_gemm_ref(
                x, copies[i % len(copies)], cb, scale), 5)
            row["bound_ms"], row["bound_by"] = bound_ms(m, k, n, 2, 64, 4)
            row["floor_ms"] = bound_ms(m, k, n, 2, 64, 4,
                                       ops=3 * 2 * m * k * n)[0]
            row["library_ms"] = None
            per_shape.append(row)
        del copies
    emit({"kernel_check": "lut_gemm", "passed": True, "max_abs_err": max_err,
          "rtol": lg.KERNEL_RTOL, "atol": lg.KERNEL_ATOL,
          "x_identity_tc_calls": 256 // lg.TC_MAX_M, "per_shape": per_shape})

    # the routes' edges: one yi-9b layer's 7 projections at each M,
    # device-only and by events, on every kernel that takes that M
    by_m = []
    for m in LUT_FULL_M:
        at = {(r["k"], r["n"]): r for r in per_shape if r["m"] == m}
        layer = [at[kn] for kn in LAYER_SHAPES]
        entry = {"m": m, "route": sorted({r["route"] for r in layer})}
        for key in layer[0]:
            if key.endswith("_ms") and layer[0][key] is not None:
                entry[key] = sum(r[key] for r in layer)
        entry["route_faster_than_fma"] = (entry["device_ms"]
                                          <= entry["fma_device_ms"])
        by_m.append(entry)
    emit({"lut_route": "lut_gemm", "tc_max_m": lg.TC_MAX_M,
          "wgmma_min_m": lg.WGMMA_MIN_M, "layer": by_m})

    def summary(m, timed_as):
        return {k: v for k, v in layer_summary("lut_gemm", per_shape,
                                               m).items()
                if k.endswith("_ms") or k in ("ms", "bound_by")} | {
                    "timed_as": timed_as}

    entry = layer_summary(
        "lut_gemm", per_shape, 8,
        source="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm_tc.cu",
        source_wgmma="src/repro_torch/kernels/lut_gemm/csrc/"
                     "lut_gemm_wgmma.cu",
        source_simt="src/repro_torch/kernels/lut_gemm/csrc/lut_gemm.cu",
        replaces="src/repro/kernels/lut_gemm/lut_gemm.py:78",
        max_abs_err=max_err, launches_tc=None, launches_wgmma=None,
        timed_as="one yi-9b layer's 7 projections, M=8 (decode: the "
                 "tensor-core decode kernel, lut_gemm_tc.cu's full-table "
                 "mode), bf16 x, NF4 codes cold in L2; ms the public call "
                 "by CUDA events around eager calls (the host wrapper "
                 "included), device_ms by CUDA-graph replays (graph_ms); "
                 "tc_*, wgmma_* and fma_* each kernel; bound at the bf16 "
                 "peak (989 TFLOP/s) or bytes, floor_ms the three-piece "
                 "floor (three bf16 products); no single PyTorch call "
                 "computes it",
        prefill=summary(512, "one layer at M=512 (the prefill kernel)"),
        by_m=by_m)
    gc.collect()
    torch.cuda.empty_cache()
    return {"lut_gemm": entry}


#: the engine's prefill calls of phase 7's request mix at mamba2-1.3b's
#: widths: (B, S the 16-token bucket, the prompt length it is masked at,
#: the zero state the engine carries in)
SSD_BUCKETS = [(1, 448, 438, "zero"), (1, 336, 332, "zero"),
               (1, 272, 270, "zero"), (1, 176, 168, "zero"),
               (1, 160, 150, "zero"), (1, 64, 53, "zero"),
               (1, 48, 36, "zero"), (1, 32, 24, "zero")]
#: the scans of phase 9b's resumed and warm-seeded prefill pieces
#: (prefill_chunk 64, capture grid 16, the shared-prefix mix): a 64-token
#: piece continuing a carried state, the 384-token prefix's last piece
#: (masked), a warm tail's pieces up to its capture boundary (32, 48) and
#: its masked last pieces (16 padded, 2, 9 and 16 real); and a 128-token
#: piece (yi-9b's chunk).  Every one starts from a non-zero state.
SSD_PIECES = [(1, 64, None, "random"), (1, 64, 64, "random"),
              (1, 32, None, "random"), (1, 48, None, "random"),
              (1, 16, 2, "random"), (1, 16, 9, "random"),
              (1, 16, 16, "random"), (1, 128, None, "random")]
#: phase 3d at mamba2-1.3b's widths: (B, S, valid length or None for no
#: mask, initial state: None, "zero" as the main path carries it into a
#: prefill, or "random"): the engine's buckets (B = 1), its resumed
#: pieces and three more
SSD_CASES = [(1, 48, None, None), (1, 272, None, "random"),
             (8, 512, None, None)] + SSD_BUCKETS + SSD_PIECES
SSD_WIDTHS = dict(h=64, p=64, g=1, n=128)
#: phase 3d's speculation windows (phase 10b's verify and commit scans):
#: B = 8 rows of S = spec_k + 1 = 5 from a random non-zero state, each
#: row masked at its own valid length (0: a fully masked row, whose state
#: must pass through bitwise)
SSD_WINDOW_VALID = (0, 1, 2, 3, 5, 0, 5, 3)
#: phase 3d at zamba2-1.2b's widths (state dim 64): (label, B, S, valid)
#: of its largest prefill call (masked, from the zero state), a resumed
#: 128-token piece (phase 12b's chunk, from a non-zero state) and a
#: speculation window (each row masked at SSD_WINDOW_VALID)
SSD_ZAMBA2_WIDTHS = dict(h=64, p=64, g=1, n=64)
SSD_ZAMBA2_CASES = [("prefill", 1, 448, 438), ("resumed", 1, 128, None),
                    ("window", len(SSD_WINDOW_VALID), 5, SSD_WINDOW_VALID)]


ssd_flops = kcost.ssd_flops


def ssd_bound_ms(b, s, h, p, g, n, chunk, masked, init) -> dict:
    """Least time of one scan: x, dt, a, B, C, the mask and the initial
    state (where one is passed, zero or not) read once, y and the final
    state written once, against :func:`ssd_flops` at three TF32 products
    each (the 3xTF32 split, 494.7 TFLOP/s); the larger of the two, and
    beside it the f32 SIMT bound (the same bytes, one product each at
    f32's 67 TFLOP/s)."""
    flops, nbytes = kcost.ssd_scan_cost(b, s, h, p, g, n, chunk,
                                        bool(masked), init is not None,
                                        init == "random")
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 3 * flops / TF32_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_simt_bound_ms": max(t_bytes, flops / F32_FLOP_S * 1e3)}


def ssd_inputs(dev, gen, b, s, h, p, g, n, valid, init):
    """One scan's f32 inputs at phase 3d's distributions: ``(args, kw)``
    for ``ssd_scan(*args, chunk=..., **kw)``."""
    import torch
    args = (torch.randn((b, s, h, p), generator=gen, device=dev),
            0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev),
            -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev)),
            torch.randn((b, s, g, n), generator=gen, device=dev),
            torch.randn((b, s, g, n), generator=gen, device=dev))
    state = None
    if init == "random":
        state = torch.randn((b, h, p, n), generator=gen, device=dev)
    elif init == "zero":
        state = torch.zeros((b, h, p, n), device=dev)
    kw = {"initial_state": state,
          "mask": (None if valid is None else
                   (torch.arange(s, device=dev) < valid)[None]
                   .expand(b, s).contiguous())}
    return args, kw


def ssd_kernel_phase(dev):
    """Phase 3d: ssd_scan against its plain version (``_ssd_chunked`` on
    the card, true f32) at mamba2's widths, each case's error within
    ``KERNEL_TOL`` of the output's scale; each case timed device-only
    (``graph_ms``, 20 calls a graph) and by events (20 eager calls, the
    host wrapper included), inputs hot in L2, beside its bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(4)
    emulate_err = None

    def compare(args, kw, chunk):
        y, fs = synced("phase 3d ssd_scan",
                       lambda: sk.ssd_scan(*args, chunk=chunk, **kw))
        y0, fs0 = _ssd_chunked(*args, chunk, **kw)
        err = max(sk.scaled_err(y, y0), sk.scaled_err(fs, fs0))
        abs_err = max((y - y0).abs().max().item(),
                      (fs - fs0).abs().max().item())
        return err, abs_err

    # small: G = 2, ragged S, Q = 48, P off the 32-column tiles, masked
    args, kw = ssd_inputs(dev, gen, 2, 77, 4, 40, 2, 16, 70, "random")
    err, _ = compare(args, kw, 48)
    check(err <= sk.KERNEL_TOL, f"ssd_scan G=2 small case: error {err}")
    per_shape, max_err, max_abs = [], err, 0.0
    w = SSD_WIDTHS
    for b, s, valid, init in SSD_CASES:
        chunk = min(256, s)
        args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"],
                              w["n"], valid, init)
        err, abs_err = compare(args, kw, chunk)
        check(err <= sk.KERNEL_TOL,
              f"ssd_scan ({b}, {s}) valid={valid} init={init}: scaled "
              f"error {err} > {sk.KERNEL_TOL}")
        max_err, max_abs = max(max_err, err), max(max_abs, abs_err)
        emulated = None
        if (b, s, valid, init) == SSD_BUCKETS[0] or \
                (b, s, valid, init) in SSD_PIECES:
            # the kernels against their arithmetic emulated (on the card)
            y, fs = sk.ssd_scan(*args, chunk=chunk, **kw)
            ye, fse = sref.ssd_scan_tc_emulate(*args, chunk=chunk, **kw)
            emulated = max(sk.scaled_err(y, ye), sk.scaled_err(fs, fse))
            check(emulated <= sref.EMULATE_TOL,
                  f"ssd_scan ({b}, {s}) valid={valid} init={init} against "
                  f"ssd_scan_tc_emulate: {emulated} > {sref.EMULATE_TOL}")
            emulate_err = max(emulate_err or 0.0, emulated)
            del y, fs, ye, fse

        def call(i):
            return sk.ssd_scan(*args, chunk=chunk, **kw)
        device_ms = graph_ms(call, 20)
        ms = cuda_ms(call, 20)
        plain_ms = cuda_ms(lambda i: _ssd_chunked(*args, chunk, **kw), 5)
        bound = ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"], chunk,
                             valid is not None, init)
        per_shape.append({"b": b, "s": s, "chunk": chunk, "valid": valid,
                          "initial_state": init, "scaled_err": err,
                          "emulate_scaled_err": emulated,
                          "max_abs_err": abs_err, "device_ms": device_ms,
                          "ms": ms, "plain_ms": plain_ms, **bound,
                          "gflop": ssd_flops(b, s, w["h"], w["p"], w["g"],
                                             w["n"], chunk,
                                             init == "random") / 1e9})
        del args, kw
    # speculation's windows: per-row valid lengths, fully masked rows
    b, s = len(SSD_WINDOW_VALID), 5
    args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"], w["n"],
                          None, "random")
    kw["mask"] = (torch.arange(s, device=dev)[None] < torch.as_tensor(
        SSD_WINDOW_VALID, device=dev)[:, None]).contiguous()
    err, abs_err = compare(args, kw, s)
    check(err <= sk.KERNEL_TOL,
          f"ssd_scan window (8, 5) valid={SSD_WINDOW_VALID}: scaled error "
          f"{err} > {sk.KERNEL_TOL}")
    y, fs = sk.ssd_scan(*args, chunk=s, **kw)
    ye, fse = sref.ssd_scan_tc_emulate(*args, chunk=s, **kw)
    emulated = max(sk.scaled_err(y, ye), sk.scaled_err(fs, fse))
    check(emulated <= sref.EMULATE_TOL,
          f"ssd_scan window against ssd_scan_tc_emulate: {emulated}")
    masked_rows = [i for i, v in enumerate(SSD_WINDOW_VALID) if v == 0]
    check(all(torch.equal(fs[i], kw["initial_state"][i])
              for i in masked_rows),
          "ssd_scan window: a fully masked row's final state is not its "
          "initial state bitwise")
    max_err, max_abs = max(max_err, err), max(max_abs, abs_err)
    emulate_err = max(emulate_err or 0.0, emulated)

    def call(i):
        return sk.ssd_scan(*args, chunk=s, **kw)
    window = {"b": b, "s": s, "chunk": s, "valid": list(SSD_WINDOW_VALID),
              "initial_state": "random", "scaled_err": err,
              "emulate_scaled_err": emulated, "max_abs_err": abs_err,
              "masked_rows_bitwise": True, "device_ms": graph_ms(call, 20),
              "ms": cuda_ms(call, 20),
              "plain_ms": cuda_ms(lambda i: _ssd_chunked(*args, s, **kw), 5),
              **ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"], s, True,
                             "random")}
    del args, kw, y, fs, ye, fse
    zamba2 = ssd_zamba2_cases(dev, gen, compare)
    max_err = max([max_err] + [r["scaled_err"] for r in zamba2])
    max_abs = max([max_abs] + [r["max_abs_err"] for r in zamba2])
    emulate_err = max([emulate_err] + [r["emulate_scaled_err"]
                                       for r in zamba2])
    buckets = [r for r in per_shape
               if (r["b"], r["s"], r["valid"], r["initial_state"])
               in SSD_BUCKETS]
    keys = ("device_ms", "ms", "plain_ms", "bound_ms", "f32_simt_bound_ms",
            "gflop")
    layer = {k: sum(r[k] for r in buckets) for k in keys}
    pieces = [r for r in per_shape
              if (r["b"], r["s"], r["valid"], r["initial_state"])
              in SSD_PIECES]
    piece_sums = {k: sum(r[k] for r in pieces) for k in keys}
    emit({"kernel_check": "ssd_scan", "passed": True,
          "max_scaled_err": max_err, "max_abs_err": max_abs,
          "tol": sk.KERNEL_TOL, "emulate_scaled_err": emulate_err,
          "emulate_tol": sref.EMULATE_TOL,
          "tol_rule": "max|kernel - plain| <= tol * max(1, max|plain|)",
          "per_shape": per_shape,
          "layer_prefill_calls": {"calls": len(buckets), **layer},
          "resumed_pieces": {"calls": len(pieces), **piece_sums},
          "spec_window": window, "zamba2": zamba2})
    head = next(r for r in per_shape if r["s"] == 448)
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssd_scan": {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:81",
        "launches": None, "max_abs_err": max_abs, "max_scaled_err": max_err,
        "emulate_scaled_err": emulate_err,
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "f32_simt_bound_ms": head["f32_simt_bound_ms"],
        "library_ms": None,
        "timed_as": "one mamba2-1.3b layer's scan of the main path's "
                    "largest prefill call: B=1, S=448 (valid 438, masked), "
                    "the carried zero initial state read, H=64, P=64, "
                    "N=128, G=1, chunk 256, f32; ms by CUDA events around "
                    "20 eager calls, device_ms by CUDA-graph replays "
                    "(graph_ms), inputs hot in L2; bound: bytes or three "
                    "TF32 products each at 494.7 TFLOP/s; no single "
                    "PyTorch call computes it",
        "layer_prefill_calls": {"calls": len(buckets), **layer},
        "spec_window": window, "zamba2": zamba2, "per_shape": per_shape}}


def ssd_zamba2_cases(dev, gen, compare) -> list:
    """Phase 3d at zamba2-1.2b's widths (H 64, P 64, G 1, N 64, chunk
    min(256, S)): :data:`SSD_ZAMBA2_CASES`, each within ``KERNEL_TOL`` of
    the plain version and ``ref.EMULATE_TOL`` of the emulation, a window's
    fully masked rows' final state bitwise its initial state; each timed
    device-only (``graph_ms``) and by events beside its bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    w = SSD_ZAMBA2_WIDTHS
    rows = []
    for label, b, s, valid in SSD_ZAMBA2_CASES:
        init = "zero" if label == "prefill" else "random"
        window = label == "window"
        args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"],
                              w["n"], None if window else valid, init)
        if window:
            kw["mask"] = (torch.arange(s, device=dev)[None] < torch.as_tensor(
                valid, device=dev)[:, None]).contiguous()
        chunk = min(256, s)
        err, abs_err = compare(args, kw, chunk)
        what = f"ssd_scan zamba2 {label} ({b}, {s}) valid={valid}"
        check(err <= sk.KERNEL_TOL,
              f"{what}: scaled error {err} > {sk.KERNEL_TOL}")
        y, fs = sk.ssd_scan(*args, chunk=chunk, **kw)
        ye, fse = sref.ssd_scan_tc_emulate(*args, chunk=chunk, **kw)
        emulated = max(sk.scaled_err(y, ye), sk.scaled_err(fs, fse))
        check(emulated <= sref.EMULATE_TOL,
              f"{what} against ssd_scan_tc_emulate: {emulated} > "
              f"{sref.EMULATE_TOL}")
        if window:
            check(all(torch.equal(fs[i], kw["initial_state"][i])
                      for i, v in enumerate(valid) if v == 0),
                  f"{what}: a fully masked row's final state is not its "
                  "initial state bitwise")
        del y, fs, ye, fse

        def call(i):
            return sk.ssd_scan(*args, chunk=chunk, **kw)
        rows.append({
            "case": label, "b": b, "s": s, "chunk": chunk,
            "valid": list(valid) if window else valid,
            "initial_state": init, "scaled_err": err,
            "emulate_scaled_err": emulated, "max_abs_err": abs_err,
            "masked_rows_bitwise": True if window else None,
            "device_ms": graph_ms(call, 20), "ms": cuda_ms(call, 20),
            "plain_ms": cuda_ms(lambda i: _ssd_chunked(*args, chunk, **kw),
                                5),
            **ssd_bound_ms(b, s, w["h"], w["p"], w["g"], w["n"], chunk,
                           valid is not None, init),
            "gflop": ssd_flops(b, s, w["h"], w["p"], w["g"], w["n"], chunk,
                               init == "random") / 1e9})
        del args, kw
    emit({"ssd_zamba2": "ssd_scan at zamba2-1.2b's widths", **w,
          "per_shape": rows})
    return rows


#: phase 3f's backward cases: (label, B, S, widths, valid length or None,
#: initial state): the training shape (TRAIN_4K's S = 4096, B cut to 2) at
#: mamba2-1.3b's and zamba2-1.2b's widths, and a ragged, masked call from a
#: carried state over two chunks
SSD_BWD_CASES = [("mamba2", 2, 4096, SSD_WIDTHS, None, None),
                 ("mamba2 ragged", 1, 300, SSD_WIDTHS, 211, "random"),
                 ("zamba2", 2, 4096, SSD_ZAMBA2_WIDTHS, None, None)]


ssd_bwd_flops = kcost.ssd_bwd_flops


def ssd_bwd_bound_ms(b, s, h, p, g, n, chunk, masked, init) -> dict:
    """Least time of one backward call: x, dt, a, B, C, dy, the final
    state's cotangent, the mask and the initial state read once, the
    forward's C·Bᵀ (its causal tiles) and chunk states read once, dx, ddt,
    da, dB, dC and the initial state's gradient written once; against
    :func:`ssd_bwd_flops` at three TF32 products each (494.7 TFLOP/s: the
    f32-accurate tensor-core rate); beside it the f32 SIMT bound (one
    product each at 67 TFLOP/s) and the bound with dB's and dC's products
    per head (``bound_ms_per_head``, the f32-FMA kernels' count)."""
    flops, nbytes = kcost.ssd_scan_bwd_cost(b, s, h, p, g, n, chunk,
                                            bool(masked), init is not None,
                                            init == "random")
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    per_head = ssd_bwd_flops(b, s, h, p, g, n, chunk, init == "random",
                             per_head=True)
    t_ops = 3 * flops / TF32_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_simt_bound_ms": max(t_bytes, flops / F32_FLOP_S * 1e3),
            "gflop": flops / 1e9,
            "bound_ms_per_head": max(t_bytes,
                                     3 * per_head / TF32_FLOP_S * 1e3),
            "gflop_per_head": per_head / 1e9}


def ssd_bwd_workspace_bytes(sk, b, s, h, p, g, n, chunk) -> int:
    """``ssd_scan_bwd_workspace``'s bytes for one call of these sizes."""
    import ctypes
    nbytes = ctypes.c_longlong()
    err = sk._bwd_lib().ssd_scan_bwd_workspace(b, s, h, p, g, n, chunk,
                                               ctypes.byref(nbytes))
    check(err == 0, f"ssd_scan_bwd_workspace failed: cudaError_t {err}")
    return nbytes.value


def ssd_bwd_kernel_phase(dev):
    """Phase 3f: ``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``) against torch
    autograd of the plain scan (``_ssd_chunked`` on the card, true f32:
    ``allow_tf32`` is off) on the same inputs and cotangents, every
    gradient within ``KERNEL_TOL`` of its scale (``scaled_err``), and
    against its CPU emulation (``ref.ssd_scan_bwd_tc_emulate``, run on the
    card) within ``ref.EMULATE_TOL``; two calls bitwise equal; each case
    timed device-only (``graph_ms``, 5 calls a graph) and by events (5
    eager calls), beside its bound, its workspace's bytes, the forward's
    device-only time on the same inputs, the plain backward (autograd's
    backward through the retained graph, by events) and each kernel's
    device time (torch.profiler)."""
    import torch

    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 3f's plain version must run in true f32")
    gen = torch.Generator(device=dev).manual_seed(5)
    names = ("dx", "ddt", "da", "db", "dc", "d_initial_state")
    rows = []
    for label, b, s, w, valid, init in SSD_BWD_CASES:
        chunk = min(256, s)
        h, p, g, n = w["h"], w["p"], w["g"], w["n"]
        args, kw = ssd_inputs(dev, gen, b, s, h, p, g, n, valid, init)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev)
        df = torch.randn((b, h, p, n), generator=gen, device=dev)
        what = f"phase 3f ssd_scan_bwd {label} ({b}, {s})"
        _, _, ws = synced(f"{what}: forward", lambda: sk.ssd_scan(
            *args, chunk=chunk, keep_workspace=True, **kw))

        def call(i):
            return sk.ssd_scan_bwd(*args, dy, df, chunk=chunk, workspace=ws,
                                   **kw)
        got = synced(what, lambda: call(0))
        again = synced(what, lambda: call(1))
        check(all(torch.equal(x, y) for x, y in zip(got, again)
                  if x is not None), f"{what}: two calls differ")
        emu = sref.ssd_scan_bwd_tc_emulate(*args, dy, df, chunk=chunk, **kw)
        emu_errs = {}
        for name, gg, ee in zip(names, got, emu):
            if gg is None:
                continue
            emu_errs[name] = sk.scaled_err(gg, ee)
            check(emu_errs[name] <= sref.EMULATE_TOL,
                  f"{what}: {name} against its emulation "
                  f"{emu_errs[name]} > {sref.EMULATE_TOL}")
        del emu
        leaves = [t.clone().requires_grad_() for t in args]
        s0 = kw["initial_state"]
        if s0 is not None:
            leaves.append(s0.clone().requires_grad_())
        y0, f0 = _ssd_chunked(*leaves[:5], chunk, initial_state=(
            leaves[5] if s0 is not None else None), mask=kw["mask"])

        def plain(i):
            return torch.autograd.grad((y0, f0), leaves, (dy, df),
                                       retain_graph=True)
        want = plain(0)
        errs, abs_err = {}, 0.0
        for name, gg, ww in zip(names, got, want):
            errs[name] = sk.scaled_err(gg, ww)
            abs_err = max(abs_err, (gg - ww).abs().max().item())
            check(errs[name] <= sk.KERNEL_TOL,
                  f"{what}: {name} scaled error {errs[name]} > "
                  f"{sk.KERNEL_TOL}")
        del got, again, want
        rows.append({
            "case": label, "b": b, "s": s, "chunk": chunk, **w,
            "valid": valid, "initial_state": init, "scaled_err": errs,
            "emulate_err": emu_errs, "max_abs_err": abs_err,
            "bitwise_repeat": True,
            "workspace_bytes": ssd_bwd_workspace_bytes(sk, b, s, h, p, g, n,
                                                       chunk),
            "device_ms": graph_ms(call, 5), "ms": cuda_ms(call, 5),
            "fwd_device_ms": graph_ms(lambda i: sk.ssd_scan(
                *args, chunk=chunk, **kw), 5),
            "plain_ms": cuda_ms(plain, 3),
            "kernels_us": ssd_kernel_us(call, 3),
            **ssd_bwd_bound_ms(b, s, h, p, g, n, chunk, valid is not None,
                               init)})
        del args, kw, dy, df, ws, leaves, y0, f0
        gc.collect()
        torch.cuda.empty_cache()
    emit({"kernel_check": "ssd_scan_bwd", "passed": True,
          "tol": sk.KERNEL_TOL, "emulate_tol": sref.EMULATE_TOL,
          "tol_rule": "max|kernel - autograd of plain| <= tol * max(1, "
                      "max|plain|), each gradient; against "
                      "ssd_scan_bwd_tc_emulate at emulate_tol",
          "per_shape": rows})
    head = rows[0]
    return {"ssd_scan_bwd": {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "replaces": "none: JAX differentiates its jnp scan, "
                    "src/repro/models/ssm.py:90 _ssd_chunked (no Pallas "
                    "backward)",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_scaled_err": max(max(r["scaled_err"].values()) for r in rows),
        "max_emulate_err": max(max(r["emulate_err"].values())
                               for r in rows),
        "workspace_bytes": head["workspace_bytes"],
        "ms": head["ms"], "device_ms": head["device_ms"],
        "fwd_device_ms": head["fwd_device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "f32_simt_bound_ms": head["f32_simt_bound_ms"],
        "bound_ms_per_head": head["bound_ms_per_head"],
        "library_ms": None,
        "timed_as": "one mamba2-1.3b layer's scan backward at the "
                    "training shape: B=2, S=4096, H=64, P=64, N=128, G=1, "
                    "chunk 256, no mask, no initial state, f32; ms by CUDA "
                    "events around 5 eager calls, device_ms by CUDA-graph "
                    "replays (graph_ms); plain: autograd's backward of "
                    "_ssd_chunked through its retained graph; bound: bytes "
                    "or three TF32 products each at 494.7 TFLOP/s, dB's "
                    "and dC's products per group (bound_ms_per_head: per "
                    "head); no single PyTorch call computes it",
        "per_shape": rows}}


def ssd_kernel_us(call, calls: int = 10) -> dict:
    """Device microseconds a call of each ``ssd_*`` kernel of ``call``
    (torch.profiler over ``calls`` eager calls; kernels on the side stream
    overlap the others), or "not measured" where the trace shows none."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i)
        torch.cuda.synchronize()
    out = {}
    for name, ms, _ in kernel_rows(prof):
        m = re.search(r"ssd_\w+", name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms * 1e3 / calls
    return out or {"ssd_": "not measured"}


def ssd_bench(root: str) -> dict:
    """``--ssd-bench ROOT``: ROOT's ``ssd_scan`` (the checkout's
    ``src/repro_torch``) at the engine's 8 prefill calls and (8, 512),
    mamba2's widths: checked against that tree's ``_ssd_chunked`` at
    ``KERNEL_TOL``, timed device-only (``graph_ms``, 20 calls) and by events
    (20 eager calls), each kernel by torch.profiler; inputs from
    :func:`ssd_inputs`, seed 4, hot in L2."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4)
    w = SSD_WIDTHS
    rows = []
    for b, s, valid, init in SSD_BUCKETS + [(8, 512, None, None)]:
        chunk = min(256, s)
        args, kw = ssd_inputs(dev, gen, b, s, w["h"], w["p"], w["g"],
                              w["n"], valid, init)

        def call(i):
            return sk.ssd_scan(*args, chunk=chunk, **kw)
        y, fs = call(0)
        y0, fs0 = _ssd_chunked(*args, chunk, **kw)
        err = max(sk.scaled_err(y, y0), sk.scaled_err(fs, fs0))
        check(err <= sk.KERNEL_TOL,
              f"{root}: ssd_scan ({b}, {s}) scaled error {err}")
        rows.append({"b": b, "s": s, "valid": valid, "scaled_err": err,
                     "device_ms": graph_ms(call, 20), "ms": cuda_ms(call, 20),
                     "kernels_us": ssd_kernel_us(call)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"root": root, "kernel": sk.__file__, "nvidia_smi": smi,
            "shapes": rows}


def ssd_against(other: str) -> dict:
    """``--ssd-against DIR``: DIR's ``ssd_scan`` and this checkout's in
    turns (DIR, this, this, DIR; a process each, the two packages share a
    name), each run printed; per shape the faster of each tree's two
    times, their ratio, and the sums over a layer's 8 prefill calls."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ssd-bench", root], capture_output=True,
                             text=True)
        check(out.returncode == 0,
              f"--ssd-bench {root} failed:\n{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    per_shape = []
    for i, row in enumerate(runs[1]["shapes"]):
        best = {side: {k: min(r["shapes"][i][k] for r in pair)
                       for k in ("device_ms", "ms")}
                for side, pair in (("other", (runs[0], runs[3])),
                                   ("this", (runs[1], runs[2])))}
        per_shape.append({"b": row["b"], "s": row["s"],
                          "other_device_ms": best["other"]["device_ms"],
                          "this_device_ms": best["this"]["device_ms"],
                          "other_ms": best["other"]["ms"],
                          "this_ms": best["this"]["ms"],
                          "speedup_device": best["other"]["device_ms"]
                          / best["this"]["device_ms"]})
    layer = [r for r in per_shape if r["b"] == 1]
    return {"against": other, "nvidia_smi": runs[1]["nvidia_smi"],
            "per_shape": per_shape,
            "layer_prefill_calls": {
                k: sum(r[k] for r in layer)
                for k in ("other_device_ms", "this_device_ms", "other_ms",
                          "this_ms")},
            "faster_everywhere": all(r["this_device_ms"]
                                     < r["other_device_ms"]
                                     for r in per_shape)}


def ssd_bwd_bench(root: str) -> dict:
    """``--ssd-bwd-bench ROOT``: ROOT's ``ssd_scan_bwd`` (the checkout's
    ``src/repro_torch``) at phase 3f's cases (:data:`SSD_BWD_CASES`, seed
    5, the forward's workspace from ROOT's ``ssd_scan``): checked against
    autograd of that tree's ``_ssd_chunked`` at ``KERNEL_TOL``, timed
    device-only (``graph_ms``, 5 calls) and by events (5 eager calls), each
    kernel by torch.profiler, with its workspace's bytes."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    from repro_torch.models.ssm import _ssd_chunked

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, b, s, w, valid, init in SSD_BWD_CASES:
        chunk = min(256, s)
        h, p, g, n = w["h"], w["p"], w["g"], w["n"]
        args, kw = ssd_inputs(dev, gen, b, s, h, p, g, n, valid, init)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev)
        df = torch.randn((b, h, p, n), generator=gen, device=dev)
        _, _, ws = sk.ssd_scan(*args, chunk=chunk, keep_workspace=True, **kw)

        def call(i):
            return sk.ssd_scan_bwd(*args, dy, df, chunk=chunk, workspace=ws,
                                   **kw)
        got = call(0)
        leaves = [t.clone().requires_grad_() for t in args]
        s0 = kw["initial_state"]
        if s0 is not None:
            leaves.append(s0.clone().requires_grad_())
        y0, f0 = _ssd_chunked(*leaves[:5], chunk, initial_state=(
            leaves[5] if s0 is not None else None), mask=kw["mask"])
        want = torch.autograd.grad((y0, f0), leaves, (dy, df))
        err = max(sk.scaled_err(gg, ww) for gg, ww in zip(got, want))
        check(err <= sk.KERNEL_TOL,
              f"{root}: ssd_scan_bwd {label} scaled error {err}")
        rows.append({"case": label, "b": b, "s": s, "scaled_err": err,
                     "workspace_bytes": ssd_bwd_workspace_bytes(
                         sk, b, s, h, p, g, n, chunk),
                     "device_ms": graph_ms(call, 5), "ms": cuda_ms(call, 5),
                     "kernels_us": ssd_kernel_us(call, 3)})
        del args, kw, dy, df, ws, got, want, leaves, y0, f0
        gc.collect()
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"root": root, "kernel": sk.__file__, "nvidia_smi": smi,
            "shapes": rows}


def ssd_bwd_against(other: str) -> dict:
    """``--ssd-bwd-against DIR``: DIR's ``ssd_scan_bwd`` and this
    checkout's in turns (DIR, this, this, DIR; a process each, the two
    packages share a name), each run printed; per case the faster of each
    tree's two times, their ratio and both workspaces' bytes."""
    runs = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ssd-bwd-bench", root], capture_output=True,
                             text=True)
        check(out.returncode == 0,
              f"--ssd-bwd-bench {root} failed:\n{out.stderr[-4000:]}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    per_shape = []
    for i, row in enumerate(runs[1]["shapes"]):
        best = {side: {k: min(r["shapes"][i][k] for r in pair)
                       for k in ("device_ms", "ms")}
                for side, pair in (("other", (runs[0], runs[3])),
                                   ("this", (runs[1], runs[2])))}
        per_shape.append({"case": row["case"], "b": row["b"], "s": row["s"],
                          "other_device_ms": best["other"]["device_ms"],
                          "this_device_ms": best["this"]["device_ms"],
                          "other_ms": best["other"]["ms"],
                          "this_ms": best["this"]["ms"],
                          "speedup_device": best["other"]["device_ms"]
                          / best["this"]["device_ms"],
                          "other_workspace_bytes":
                              runs[0]["shapes"][i]["workspace_bytes"],
                          "this_workspace_bytes": row["workspace_bytes"]})
    return {"against": other, "nvidia_smi": runs[1]["nvidia_smi"],
            "per_shape": per_shape}


#: phase 3e: JAX's test_flash_vs_ref shapes (B, S, H, Hkv, D), causal and
#: not, f32 and bf16 (bf16 at D = 64 on the tensor-core kernel, at 16 and
#: 32 on the SIMT one); S = 1000, off both kernels' tiles (called on
#: flash_attention directly: ops.mha keeps JAX's tiling), bf16, causal and
#: not; then yi-9b's heads at the main path's (B, S), causal, f32 and bf16
FLASH_JAX_CASES = [(1, 128, 2, 2, 16), (2, 256, 4, 2, 32),
                   (1, 512, 8, 1, 64)]
FLASH_RAGGED_CASES = [(1, 1000, 8, 2, 128)]
FLASH_YI_CASES = [(1, 512, 32, 4, 128), (2, 4096, 32, 4, 128)]


def flash_bound_ms(b, s, h, hkv, d, itemsize, causal,
                   peak) -> tuple[float, str]:
    """Least time of one call: q, k, v read once and o written once, against
    the operations the mask leaves (4 B H S^2 D, halved when causal) at the
    input type's peak; the larger of the two."""
    return roofline.bound_ms(*kcost.flash_cost(b, s, h, hkv, d, itemsize,
                                               causal), peak)


def bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want (2^(e - 7) for 2^e <= |want|
    < 2^(e + 1)) over the elements with |want| >= 1/64, where f32's own
    error (~1e-6 absolute) is far below half an ulp; rounding to nearest
    stays within 0.5, a truncating store reaches 1."""
    import torch
    big = want.abs() >= 2.0 ** -6
    e = torch.floor(torch.log2(want[big].abs()))
    return ((got.float()[big] - want[big]).abs()
            / torch.exp2(e - 7)).max().item()


def simt_bf16(q, k, v, *, sm_scale, causal, num_q_heads, num_kv_heads):
    """The SIMT kernel on bf16 operands at any D, the wrapper bypassed (no
    launch is counted): the pre-redesign kernel of bf16 at D = 128, timed
    beside the tensor-core kernel on the same inputs."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk
    o = torch.empty_like(q)
    bh, s, d = q.shape
    err = fk._lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
        num_q_heads, num_kv_heads, float(sm_scale), int(causal), 1,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"SIMT flash kernel launch: cudaError_t {err}")
    return o


def flash_kernel_phase(dev):
    """Phase 3e: each flash kernel against its plain version on the same
    input values in f32 (``flash_attention.reference``), at the tolerance
    stated in ``kernels/flash_attention/flash_attention.py`` (SIMT: 2e-5
    f32, bf16 half an output ulp past that; tensor-core: that plus its p
    flips, against ``attention_ref_tiled``), bf16 also within JAX's 2e-2 of
    the f32 reference on the unrounded inputs; each call's kernel read from
    the launch counters.  Times at (2, 4096): bf16 on the tensor-core
    kernel, f32 on the SIMT kernel, the SIMT kernel on the same bf16 inputs
    (the pre-redesign path), the plain versions and SDPA (timed only: the
    port never calls it), beside the bounds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    both = (torch.float32, torch.bfloat16)
    cases = ([(c, causal, dt) for c in FLASH_JAX_CASES
              for causal in (True, False) for dt in both]
             + [(c, causal, torch.bfloat16) for c in FLASH_RAGGED_CASES
                for causal in (True, False)]
             + [(c, True, dt) for c in FLASH_YI_CASES for dt in both])
    per_shape, max_err, max_share = [], {}, {}
    for (b, s, h, hkv, d), causal, dt in cases:
        q = torch.randn((b * h, s, d), generator=gen, device=dev)
        k = torch.randn((b * hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b * hkv, s, d), generator=gen, device=dev)
        kw = dict(sm_scale=d ** -0.5, causal=causal, num_q_heads=h,
                  num_kv_heads=hkv)
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        tc0 = fk.flash_attention.launches_tc
        got = fk.flash_attention(qd, kd, vd, **kw)
        torch.cuda.synchronize()
        tc = fk.flash_attention.launches_tc - tc0
        check(tc == fk.takes_wgmma(dt, d),
              f"flash ({b}, {s}, {h}, {hkv}, {d}) {dt}: tensor-core "
              f"launches {tc}")
        kernel = "wgmma" if tc else "simt"
        plain, bound = fk.reference(qd, kd, vd, **kw)
        share = fk.tolerance_share(got, plain, bound)
        err = (got.float() - plain).abs().max().item()
        name = str(dt).split(".")[1]
        row = {"b": b, "s": s, "h": h, "hkv": hkv, "d": d,
               "causal": causal, "dtype": name, "kernel": kernel,
               "max_abs_err": err, "tol_share": share}
        check(share <= 1.0, f"flash {row}: past its tolerance")
        key = f"{name}_{kernel}"
        max_err[key] = max(max_err.get(key, 0.0), err)
        max_share[key] = max(max_share.get(key, 0.0), share)
        if dt == torch.bfloat16:
            row["max_err_bf16_ulps"] = bf16_ulps(got, plain)
            del plain, bound
            want = attention_ref(q, k, v, **kw)
            torch.testing.assert_close(got.float(), want, rtol=fk.BF16_TOL,
                                       atol=fk.BF16_TOL)
            row["max_abs_err_vs_f32_inputs"] = (
                got.float() - want).abs().max().item()
            del want
        else:
            del plain, bound
        if s == 4096:
            itemsize = 2 if dt == torch.bfloat16 else 4
            peak = BF16_FLOP_S if dt == torch.bfloat16 else F32_FLOP_S
            rounded = (dict(p_dtype=torch.bfloat16, block_k=fk.BLOCK_K)
                       if tc else {})
            row["ms"] = cuda_ms(lambda i: fk.flash_attention(qd, kd, vd,
                                                             **kw), 20)
            row["plain_ms"] = cuda_ms(lambda i: attention_ref(
                qd, kd, vd, **kw, **rounded), 3)
            if tc:
                row["simt_ms"] = cuda_ms(lambda i: simt_bf16(qd, kd, vd,
                                                             **kw), 5)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, s, h, hkv, d, itemsize, causal, peak)
            q4 = qd.reshape(b, h, s, d)
            k4, v4 = kd.reshape(b, hkv, s, d), vd.reshape(b, hkv, s, d)
            row["library_ms"] = cuda_ms(
                lambda i: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True), 20)
            row["gflop"] = 4 * b * h * s * s * d * 0.5 / 1e9
            row["tflop_s"] = row["gflop"] / row["ms"]
        per_shape.append(row)
        del q, k, v, got, qd, kd, vd
    tols = {"float32": fk.tolerance(torch.float32),
            "bfloat16_simt": fk.tolerance(torch.bfloat16),
            "bfloat16_wgmma": "atol + rtol |plain| + p flips, against "
                              "attention_ref_tiled (block_k "
                              f"{fk.BLOCK_K}, flip_eta {fk.FLIP_ETA})",
            "bfloat16_vs_f32_inputs": fk.BF16_TOL}
    emit({"kernel_check": "flash_attention", "passed": True,
          "max_abs_err": max_err, "max_tol_share": max_share, "tol": tols,
          "per_shape": per_shape})
    at = {(r["dtype"], r["kernel"]): r for r in per_shape if r["s"] == 4096}
    head, f32 = at[("bfloat16", "wgmma")], at[("float32", "simt")]
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "source_f32": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:70",
        "launches": None, "launches_tc": None,
        "max_abs_err": max_err["bfloat16_wgmma"],
        "max_abs_err_f32": max_err["float32_simt"],
        "max_tol_share": max_share, "tolerance": tols,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "ms_simt_bf16": head["simt_ms"], "ms_f32": f32["ms"],
        "plain_ms_f32": f32["plain_ms"], "bound_ms_f32": f32["bound_ms"],
        "library_ms_f32": f32["library_ms"],
        "timed_as": "one yi-9b layer's causal attention of the training "
                    "phase's eval loss: B=2, S=4096, H=32, Hkv=4, D=128; ms: "
                    "bf16 on the tensor-core kernel; ms_simt_bf16: the "
                    "SIMT kernel on the same bf16 inputs (the pre-redesign "
                    "path); ms_f32: f32 on the SIMT kernel; library: "
                    "F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True) on the same inputs",
        "per_shape": per_shape}}


def quant_matmul_phase(dev):
    """Phase 5: the card's quant_matmul against the CPU's, every mode."""
    import torch

    from repro_torch.core import luna, quant
    from repro_torch.core.layers import QUANT_MODES, QuantConfig, quant_matmul
    from repro_torch.kernels.luna_mm.ops import luna_mm_codes

    gen = torch.Generator().manual_seed(3)
    errs = {}
    for m in (8, 40):          # int8: the f64 (M <= 16) and _int_mm routes
        x = torch.randn((m, 4096), generator=gen)
        w = torch.randn((4096, 1024), generator=gen) / 64
        xq, wq = quant.calibrate(x, 4), quant.calibrate(w, 4, axis=-1)
        qx, qw = quant.quantize(x, xq), quant.quantize(w, wq)
        xg, wg = x.to(dev), w.to(dev)
        qxg = quant.quantize(xg, quant.calibrate(xg, 4))
        qwg = quant.quantize(wg, quant.calibrate(wg, 4, axis=-1))
        check(torch.equal(qxg.cpu(), qx) and torch.equal(qwg.cpu(), qw),
              f"M={m}: 4-bit codes on the card differ from the CPU's")
        for mode in LUNA_MODES:
            check(torch.equal(luna_mm_codes(qxg, qwg, mode=mode).cpu(),
                              luna.luna_matmul(qx, qw, mode=mode)),
                  f"M={m} {mode}: int32 accumulators differ from the CPU's")
        for mode in QUANT_MODES:
            cfg = QuantConfig(mode=mode)
            got = quant_matmul(xg, wg, cfg).cpu()
            want = quant_matmul(x, w, cfg)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs[f"{mode} M={m}"] = (got - want).abs().max().item()
    emit({"quant_matmul_card_vs_cpu": "f32 x (M, 4096) @ w (4096, 1024)",
          "codes_bitwise": True, "int32_accumulators_bitwise": True,
          "max_abs_err": errs, "rtol": 1e-5, "atol": 1e-5})


def tree_to(node, device):
    """A parameter tree (dicts, lists, tensors) copied to ``device``."""
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node.to(device)


def small_reference_phase(dev):
    """Phase 4: reduced f32 yi-9b, card against CPU."""
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import TransformerLM

    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    cpu = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    gpu = TransformerLM.from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
    toks = torch.randint(1, cfg.vocab_size, (4, 12),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    with torch.inference_mode():
        for quant in ("lut4", "nf4p"):
            qc = quantize_decode_params(cpu.params_tree(), quant)
            qg = quantize_decode_params(gpu.params_tree(), quant)
            for a, b in zip(qc["blocks"], qg["blocks"]):
                for grp in ("attn", "mlp"):
                    for name, qa in a[grp].items():
                        qb = b[grp][name]
                        check(all(torch.equal(getattr(qa, f).cpu(),
                                              getattr(qb, f).cpu())
                                  for f in ("codes", "scale", "zero_point")),
                              f"{quant} {name}: card quantization differs "
                              "from the CPU's")
            logits = []
            for model, tree, device in ((cpu, qc, "cpu"), (gpu, qg, dev)):
                m = TransformerLM.from_params(cfg, tree, device=device)
                caches = model.init_cache(4, 32)
                _, caches = model.prefill(toks.to(device), caches)
                lg_, _ = m.decode_step(toks[:, -1:].to(device), caches,
                                       torch.full((4,), 12, device=device))
                logits.append(lg_.float().cpu())
            torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                       atol=1e-4)
            out[quant] = (logits[1] - logits[0]).abs().max().item()
        # model-level lut_nf4: codes depend on the weights only, so the
        # card (full-table kernel) and the CPU (JAX's library order) agree
        # up to f32 summation order
        from dataclasses import replace

        from repro_torch.core.layers import QuantConfig
        qcfg = replace(cfg, quant=QuantConfig(mode="lut_nf4"))
        logits = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            m = TransformerLM.from_params(qcfg, model.params_tree(),
                                          device=device)
            lg_, _ = m.prefill(toks.to(device), m.init_cache(4, 32))
            logits.append(lg_.float().cpu())
        torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                   atol=1e-4)
        out["lut_nf4 prefill"] = (logits[1] - logits[0]).abs().max().item()
    emit({"small_reference": "reduced yi-9b f32, logits card vs cpu",
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


def small_ssm_reference_phase(dev):
    """Phase 4, mamba2: a reduced f32 mamba2, card against CPU.  Prefill
    of right-padded rows with ``last_pos`` (the card's SSD scan on the
    kernel), then one decode step under lut4 and nf4p (w_in/w_out on the
    D&C kernels); the frozen codes of w_in/w_out bitwise equal."""
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.ssm_lm import SSMLM

    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    gpu = SSMLM.from_params(cfg, tree_to(cpu.params_tree(), dev), device=dev)
    lens = torch.tensor([48, 30, 17, 5])
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (4, 48), generator=gen)
    toks[torch.arange(48)[None, :] >= lens[:, None]] = 0
    nxt = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen)
    out = {}
    with torch.inference_mode():
        runs = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            lg, caches = model.prefill(toks.to(device),
                                       model.init_cache(4, 48),
                                       last_pos=(lens - 1).to(device))
            runs.append((lg.float().cpu(), caches))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4,
                                   atol=1e-4)
        out["prefill"] = (runs[1][0] - runs[0][0]).abs().max().item()
        for quant in ("lut4", "nf4p"):
            qc = quantize_decode_params(cpu.params_tree(), quant)
            qg = quantize_decode_params(gpu.params_tree(), quant)
            for a, b in zip(qc["blocks"], qg["blocks"]):
                for name in ("w_in", "w_out"):
                    qa, qb = a["m"][name], b["m"][name]
                    check(all(torch.equal(getattr(qa, f).cpu(),
                                          getattr(qb, f).cpu())
                              for f in ("codes", "scale", "zero_point")),
                          f"mamba2 {quant} {name}: card quantization "
                          "differs from the CPU's")
            logits = []
            for (_, caches), tree, device in ((runs[0], qc, "cpu"),
                                              (runs[1], qg, dev)):
                m = SSMLM.from_params(cfg, tree, device=device)
                lg, _ = m.decode_step(nxt.to(device), caches,
                                      lens.to(device))
                logits.append(lg.float().cpu())
            torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                       atol=1e-4)
            out[f"{quant} decode"] = (logits[1] - logits[0]).abs().max().item()
    emit({"small_reference": "reduced mamba2 f32, logits card vs cpu "
                             "(right-padded prefill through ssd_scan, one "
                             "decode step)", "codes_bitwise": True,
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


#: phase 4's engines on the cache substrate, each against the dense,
#: whole-prompt, cold engine: (family, label, EngineConfig knobs)
SMALL_SUBSTRATES = [
    ("dense", "paged", dict(paged=True, block_size=8)),
    ("dense", "paged chunked", dict(paged=True, block_size=8,
                                    prefill_chunk=8)),
    ("dense", "paged prefix chunked", dict(paged=True, block_size=8,
                                           prefill_chunk=8,
                                           prefix_cache=True)),
    ("dense", "paged prefix", dict(paged=True, block_size=8,
                                   prefix_cache=True)),
    ("ssm", "chunked", dict(prefill_chunk=8)),
    ("ssm", "prefix chunked", dict(prefill_chunk=8, prefix_cache=True)),
]


def small_substrate_phase(dev):
    """Phase 4, the cache substrate: reduced f32 yi-9b and mamba2 (seed 1
    weights, the same on both devices) serve a shared-head mix on 3 slots
    (warm, cold, strict-extension and chunked admissions; 5 new tokens
    each) on the paged, chunked and warm-prefix engines: greedy tokens on
    the card equal the CPU's, and both equal the dense, whole-prompt, cold
    engine's on the CPU; the prefix engines hit."""
    import numpy as np
    import torch

    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for arch in ("yi-9b", "mamba2-1.3b"):
        cfg = get_config(arch).reduced(dtype="float32", attn_impl="full")
        cpu = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
        rng = np.random.default_rng(2)
        head = rng.integers(1, cfg.vocab_size, 24).tolist()
        mix = [head + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (6, 13, 2, 9, 20)]
        mix.insert(3, rng.integers(1, cfg.vocab_size, 11).tolist())

        def serve(model, device, **knobs):
            eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=64,
                                                  **knobs), device=device)
            reqs = [Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(mix)]
            stats = eng.serve(reqs)
            check(stats["done"], f"phase 4 {arch} {knobs}: not done")
            return [r.out for r in reqs], stats

        cold, _ = serve(cpu, "cpu")
        for family, label, knobs in SMALL_SUBSTRATES:
            if family != cfg.family:
                continue
            on_cpu, _ = serve(cpu, "cpu", **knobs)
            on_card, stats = serve(gpu, dev, **knobs)
            check(on_cpu == cold,
                  f"phase 4 {arch} {label}: CPU tokens differ from the "
                  "dense, whole-prompt, cold engine's")
            check(on_card == on_cpu,
                  f"phase 4 {arch} {label}: card tokens differ from the "
                  "CPU's")
            if knobs.get("prefix_cache"):
                check(stats["prefix_hits"] >= 2,
                      f"phase 4 {arch} {label}: {stats['prefix_hits']} hits")
            out[f"{arch} {label}"] = {
                k: stats[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                      "prefill_chunks", "prefill_calls")}
    emit({"small_substrate": "reduced f32 yi-9b and mamba2, greedy tokens "
                             "card == cpu == dense whole-prompt cold",
          "runs": out})


def small_training_phase(dev):
    """Phase 4, training: reduced f32 yi-9b, card against CPU, through
    ``repro_torch.train.card_vs_cpu`` (the checks and tolerances the card
    tests use): the cacheless forward under attn_impl="flash", the STE on
    identical inputs, the loss and every gradient under chunked attention
    and under luna_approx through the STE on luna_mm, one train step's
    params; the same for reduced f32 mamba2 and zamba2 (the scan on
    ``ssd_scan`` and ``ssd_scan_bwd``) and one Mamba2 layer's w_in, A_log
    and dt_bias gradients; the quantized modes and remat "dots"
    (:func:`small_options_phase`).  Beside them, the reason luna_approx's gradients have a
    tolerance of their own: the same effect on the CPU alone under 1e-7
    relative weight noise."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.train import card_vs_cpu as cc
    from repro_torch.tree import tree_map

    out = cc.training_card_vs_cpu(dev)
    out["ste on identical inputs (scaled)"] = cc.ste_card_vs_cpu(dev)
    cfg, cpu, batch = cc.reduced_setup()
    noise = torch.Generator().manual_seed(9)
    for name, c in (("chunked", cfg), ("luna_approx", replace(
            cfg, quant=QuantConfig(mode="luna_approx")))):
        a = type(cpu).from_params(c, cpu.params_tree(), device="cpu")
        b = type(cpu).from_params(c, tree_map(
            lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=noise)),
            cpu.params_tree()), device="cpu")
        for m in (a.requires_grad_(True), b.requires_grad_(True)):
            m.loss(batch)[0].backward()
        out[f"{name} grads, cpu vs cpu with 1e-7 weight noise (scaled)"] = \
            cc.scaled_grad_err(a, b)
    for arch in cc.SCAN_FAMILIES:
        out[f"{arch} training (B=2, S=96)"] = \
            cc.family_training_card_vs_cpu(dev, arch)
    for arch in cc.MODALITY_ARCHS:
        out[f"{arch} training and serving (B=2, S=96)"] = \
            cc.modality_card_vs_cpu(dev, arch)
    out["one mamba2 layer's w_in, A_log, dt_bias grads (scaled)"] = \
        cc.mamba2_layer_card_vs_cpu(dev)
    small_options_phase(dev)
    emit({"small_reference": "reduced f32 training, card vs cpu: yi-9b "
                             "(B=2, S=256), mamba2 and zamba2 (B=2, S=96), "
                             "one Mamba2 layer, whisper-base and llava "
                             "(B=2, S=96, with prefill and decode logits)",
          "max_err": out,
          "rtol": cc.TOL, "atol": cc.TOL, "ste_rel": cc.STE_REL,
          "grad_tol": {"chunked": cc.GRAD_REL,
                       "luna_approx": cc.LUNA_GRAD_REL,
                       "of": "each leaf's max |cpu grad|"}})


def kernel_rows(prof) -> list:
    """(name, device ms, calls) of every CUDA kernel in a profile, by
    device time (an ATen op's row would repeat its kernels' time)."""
    import torch
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]
    return sorted(rows, key=lambda r: -r[1])


def busy_ms(prof, match: str = "") -> float | None:
    """Device ms in the CUDA kernels whose name holds ``match``, the union
    of their intervals (kernels on two streams that overlap count once);
    None where the trace holds no device interval."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA and match in e.name)
    if not spans:
        return None
    total, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


#: phase 11's profile ranges: label -> (module, function), each call
#: wrapped in a ``torch.profiler.record_function`` of that label for the
#: window only; a range's device time is its kernels'
MOE_RANGES = {
    "moe.route": ("repro_torch.models.moe", "route"),
    "moe.dispatch": ("repro_torch.models.moe", "dispatch"),
    "moe.experts": ("repro_torch.models.moe", "experts"),
    "moe.combine": ("repro_torch.models.moe", "combine"),
    "moe.shared": ("repro_torch.models.moe", "shared_experts"),
    "mla.absorbed": ("repro_torch.models.attention", "mla_absorbed"),
}


#: phase 12's profile ranges (:data:`MOE_RANGES`' form; a dotted name is
#: a method, wrapped on its class)
HYBRID_RANGES = {
    "hybrid.shared_block": ("repro_torch.models.hybrid",
                            "SharedBlock.forward"),
    "hybrid.mamba2_layer": ("repro_torch.models.ssm_lm", "SSMBlock.forward"),
    "hybrid.lm_head": ("repro_torch.models.hybrid", "HybridLM.logits"),
}


def ranged(ranges: dict):
    """Wrap each ``ranges`` function (:data:`MOE_RANGES`' form) in a
    ``record_function`` of its label; returns a function that restores
    them."""
    import importlib

    import torch
    saved = []
    for label, (mod, fn) in ranges.items():
        owner = importlib.import_module(mod)
        *path, name = fn.split(".")
        for part in path:
            owner = getattr(owner, part)
        base = getattr(owner, name)

        def wrapped(*a, _base=base, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _base(*a, **kw)
        setattr(owner, name, wrapped)
        saved.append((owner, name, base))

    def restore():
        for owner, name, base in saved:
            setattr(owner, name, base)
    return restore


def range_ms(prof, labels) -> dict:
    """Device ms of each ``record_function`` range in ``labels``: the
    summed durations of the kernels launched inside it (the host-side
    range's device time; the trace's device-side copy of a range spans
    the gaps between its kernels too), "not measured" where the trace has
    none."""
    import torch
    out = dict.fromkeys(labels, 0.0)
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e3
    return {k: v if v > 0 else "not measured" for k, v in out.items()}


def profile_decode(eng, prompts, ticks: int = 4,
                   ranges: dict | None = None) -> dict:
    """Device time by kernel over ``ticks`` steady decode ticks of a fresh
    batch (torch.profiler; admission and drain run outside the window);
    with ``ranges`` (:data:`MOE_RANGES`' form) also the device time of
    each labelled range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    # a chunked engine admits one piece a tick: the window opens once
    # every admission has landed, and each request outlives it
    staged = 2 * len(prompts) if eng.prefill_chunk is not None else 0
    reqs = [Request(rid=100 + i, prompt=p, max_new=ticks + 4 + staged)
            for i, p in enumerate(prompts)]
    eng.serve(reqs, max_ticks=1)           # admit + first decode tick
    while eng._chunked or eng.scheduler.pending:
        eng.step()
    torch.cuda.synchronize()
    restore = ranged(ranges or {})
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    eng.serve([])                          # drain
    # the ranges' device-side copies are no kernels
    rows = [r for r in kernel_rows(prof) if r[0] not in (ranges or {})]
    device_ms = sum(r[1] for r in rows)
    ours_ms = sum(r[1] for r in rows
                  if any(t in r[0] for t in ("lut_gemm", "luna_mm",
                                             "splitk_reduce", "ssd_")))
    nccl = [r for r in rows if "nccl" in r[0].lower()]
    out = {"profile": "decode ticks", "ticks": ticks, "wall_ms": wall_ms,
           "device_ms": device_ms if rows else "not measured",
           "nccl_ms": sum(r[1] for r in nccl) if rows else "not measured",
           "nccl_kernels": sum(r[2] for r in nccl),
           "port_kernels_ms": ours_ms if rows else "not measured",
           "device_idle_share": (1 - device_ms / wall_ms) if rows
           else "not measured",
           "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                   for k, ms, n in rows[:12]]}
    if ranges:
        out["ranges_ms"] = range_ms(prof, ranges)
    return out


def watch_logits(eng) -> tuple[list, list]:
    """Wrap ``logits`` of the engine's prefill and decode models (on the
    instances; the caller deletes the attribute after the run) so every
    call records whether all its logits are finite.  Returns (the
    records, the models watched)."""
    import torch
    finite = []

    def watch(m):
        base = m.logits

        def logits(hidden):
            out = base(hidden)
            finite.append(torch.isfinite(out).all())
            return out
        m.logits = logits

    watched = list({id(eng.params): eng.params,
                    id(eng.decode_params): eng.decode_params}.values())
    for m in watched:
        watch(m)
    return finite, watched


def reset_counters(wrappers: dict) -> None:
    """Every kernel wrapper's launch counters to 0."""
    for f in wrappers.values():
        f.launches = 0
    for name in TC_ROUTED:
        wrappers[name].launches_tc = 0
    wrappers["lut_gemm"].launches_wgmma = 0


def read_counters(wrappers: dict) -> tuple[dict, dict]:
    """(launches by kernel, launches by tensor-core route: ``launches_tc``
    of each ``TC_ROUTED`` wrapper, lut_gemm's prefill kernel under
    ``"lut_gemm_wgmma"``)."""
    counts = {name: f.launches for name, f in wrappers.items()}
    tc = {name: wrappers[name].launches_tc for name in TC_ROUTED}
    tc["lut_gemm_wgmma"] = wrappers["lut_gemm"].launches_wgmma
    return counts, tc


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention)
    from repro_torch.kernels.luna_mm.luna_mm import luna_mm
    from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm, lut_gemm_dc,
                                                       lut_gemm_dc_res)
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd
    return {f.__name__: f for f in (lut_gemm_dc, lut_gemm_dc_res, luna_mm,
                                    lut_gemm, ssd_scan, ssd_scan_bwd,
                                    flash_attention)}


def request_mix(vocab: int) -> list:
    """8 prompts of 16-512 tokens from seed 0 (lengths 438, 332, 270, 150,
    168, 36, 53, 24), ids in [1, vocab)."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 513, size=8)
    return [rng.integers(1, vocab, int(n)).tolist() for n in lens]


def build_model(dev, layers: int):
    """yi-9b at its published widths, ``layers`` deep, bf16, random weights
    from seed 0; and the request mix (8 prompts of 16-512 tokens)."""
    from dataclasses import replace

    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = replace(get_config("yi-9b"), num_layers=layers)
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": layers, "d_model": cfg.d_model,
          "heads": [cfg.num_heads, cfg.num_kv_heads], "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def build_ssm_model(dev):
    """mamba2-1.3b at its published widths, all 48 layers, bf16, random
    weights from seed 0; the same request-length mix as yi-9b's."""
    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "ssm": vars(cfg.ssm),
          "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def profile_prefill(eng, prompts: list) -> dict:
    """Device time by kernel over the admission of ``prompts`` together
    (one prefill call per length bucket; torch.profiler; each request is
    done at admission)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    reqs = [Request(rid=200 + i, prompt=p, max_new=1)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    # ssd_scan runs ssd_cb and chunk 0's ssd_chunk_out on a side stream
    # beside its other kernels: device time is the union of the kernels'
    # intervals; the summed durations are kept beside it
    busy, ssd_busy = busy_ms(prof), busy_ms(prof, "ssd_")
    return {"profile": f"prefill of {len(prompts)} prompts, "
                       f"{sum(map(len, prompts))} tokens",
            "wall_ms": wall_ms,
            "device_ms": busy if busy is not None else "not measured",
            "kernel_ms_summed": sum(r[1] for r in rows) if rows
            else "not measured",
            "ssd_scan_ms": ssd_busy if ssd_busy is not None
            else "not measured",
            "ssd_scan_kernel_ms_summed": (
                sum(r[1] for r in rows if "ssd_" in r[0]) if rows
                else "not measured"),
            "device_idle_share": (1 - busy / wall_ms) if busy is not None
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def serve_once(dev, cfg, model, prompts, quant: str | None,
               kern: str | None, record: bool = False, profile: bool = True,
               ranges: dict | None = None, knobs: dict | None = None,
               counted: dict | None = None, label: str | None = None
               ) -> tuple[dict, list, dict, dict]:
    """One main-path run: the engine serves the request mix; every kernel
    counter is set to 0 just before and read just after.  Returns the
    launches by kernel, each request's tokens and the launches of each
    kernel's tensor-core route (``launches_tc``; lut_gemm's prefill kernel
    under ``"lut_gemm_wgmma"``): luna_mm's checked against its ``takes_tc``
    and lut_gemm's against its ``route`` at each call's M (max_batch rows a
    decode tick, rows x bucket length a prefill call), every
    ``lut_gemm_dc`` / ``_res`` launch (decode's M = max_batch, bf16)
    required on it.  ``quant``: None
    (full precision), an engine-level mode (EngineConfig.quant: frozen
    decode projections, prefill full precision) or a model-level one
    (cfg.quant, every projection of prefill and decode; the model shares
    ``model``'s tensors).  ``kern`` must have launched once per projection
    (7 a layer for yi-9b, 2 for mamba2) of each decode tick, and of each
    prefill call under a model-level mode; for mamba2 ``ssd_scan`` once
    per layer of each prefill call; no other kernel at all.  Profiles 4
    decode ticks after (and, for mamba2, one prefill call).  The fourth
    value: the run's decode tok/s and, with ``record``, each decode step's
    logits by (rid, step) (:func:`record_logits`; phase 10's reference).
    ``profile=False`` leaves the profiles out; ``ranges`` labels stages
    of the decode profile (:func:`profile_decode`).  ``knobs``: more
    ``EngineConfig`` fields (``paged``, ``block_size``); ``counted``: name
    -> an object whose ``calls`` counter is set to 0 just before the run
    and read just after (the fourth value's ``"calls"``); ``label`` names
    the run in its line."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.serve.config import ENGINE_QUANT_MODES, EngineConfig
    from repro_torch.serve.engine import Engine, Request

    t0 = time.perf_counter()
    model_level = quant is not None and quant not in ENGINE_QUANT_MODES
    if model_level:
        qcfg = replace(cfg, quant=QuantConfig(mode=quant))
        eng = Engine(qcfg, type(model).from_params(
            qcfg, model.params_tree(), device=dev),
            EngineConfig(max_batch=8, max_seq=1024), device=dev)
    else:
        eng = Engine(cfg, model, EngineConfig(quant=quant, max_batch=8,
                                              max_seq=1024, **(knobs or {})),
                     device=dev)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    finite, watched = watch_logits(eng)
    rec, unhook = record_logits(eng) if record else (None, None)
    reqs = [Request(rid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    for c in (counted or {}).values():
        c.calls = 0
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    calls = {k: c.calls for k, c in (counted or {}).items()}
    luna_tc = tc["luna_mm"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in watched:
        del m.logits
    if unhook is not None:
        unhook()
    layers = cfg.num_layers
    ticks = eng.metrics.ticks
    want = dict.fromkeys(wrappers, 0)
    if kern is not None:
        want[kern] = ((ticks + model_level * stats["prefill_calls"])
                      * tick_launches(cfg))
    want["ssd_scan"] = stats["prefill_calls"] * scan_calls(cfg)
    check(stats["done"] and all(len(r.out) == 32 for r in reqs),
          f"{cfg.name} {quant}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"{cfg.name} {quant}: non-finite logits")
    check(counts == want,
          f"{cfg.name} {quant}: launches {counts}, want {want}")
    # luna_mm's route: M = max_batch rows at each decode tick, M = rows x
    # bucket length at each prefill call (one call per length bucket)
    buckets = Counter(eng._bucket_len(len(p)) for p in prompts)
    prefill_m = sorted(c * blen for blen, c in buckets.items())
    per_layer = [(ticks, eng.max_batch)] + [(1, mm) for mm in prefill_m]
    want_tc = 0
    if kern in ("luna_mm", "lut_gemm"):
        check(len(prefill_m) == stats["prefill_calls"],
              f"{cfg.name} {quant}: {stats['prefill_calls']} prefill calls, "
              f"{len(prefill_m)} length buckets")
    if kern == "luna_mm":
        from repro_torch.kernels.luna_mm.luna_mm import takes_tc
        want_tc = layers * sum(c * takes_tc(mm, k, n, "row", True)
                               for c, mm in per_layer
                               for k, n in LAYER_SHAPES)
    check(luna_tc == want_tc,
          f"{cfg.name} {quant}: {luna_tc} luna_mm launches on the "
          f"tensor-core kernel, want {want_tc}")
    # lut_gemm: every bf16 launch on the kernel its route names (x and the
    # fresh codes are 16-byte aligned)
    routes = Counter()
    if kern == "lut_gemm":
        from repro_torch.kernels.lut_gemm.lut_gemm import route
        for c, mm in per_layer:
            for k, n in LAYER_SHAPES:
                routes[route(mm, k, n, torch.bfloat16, True)] += c * layers
    got = {"tc": tc["lut_gemm"], "wgmma": tc["lut_gemm_wgmma"],
           "fma": counts["lut_gemm"] - tc["lut_gemm"] - tc["lut_gemm_wgmma"]}
    check(got == {r: routes[r] for r in got},
          f"{cfg.name} {quant}: lut_gemm launches by kernel {got}, its "
          f"route says {dict(routes)}")
    for n in ("lut_gemm_dc", "lut_gemm_dc_res"):
        check(tc[n] == counts[n],
              f"{cfg.name} {quant}: {tc[n]} of {counts[n]} {n} launches on "
              "the tensor-core kernel")
    prof = {}
    if profile:                            # after the counts are read
        prof = profile_decode(eng, prompts, ranges=ranges)
        if cfg.family == "ssm":
            prof["prefill"] = profile_prefill(eng, [max(prompts, key=len)])
        if cfg.family == "hybrid":
            prof["prefill"] = profile_prefill(eng, prompts)
    emit({"main_path": quant or "bf16", "model": cfg.name,
          **({"label": label, "calls": calls} if label else {}),
          "requests": len(reqs),
          "prompt_lens": [len(p) for p in prompts], "max_new": 32,
          "layers": layers, "decode_ticks": ticks,
          "lut_launches_per_tick": tick_launches(cfg) if kern else None,
          "prefill_calls": stats["prefill_calls"], "launches": counts,
          "launches_tc": tc, "prefill_m": prefill_m,
          "prefill_tok_s": stats["prefill_tok_s"],
          "decode_tok_s": stats["decode_tok_s"],
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          "wall_s": wall, "quantize_s": quant_s, "peak_mem_gb": peak_gb,
          "first_tokens": [r.out[0] for r in reqs], **{
              f"profile_{k}": v for k, v in prof.items()}})
    out = [r.out for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out, tc, {"decode_tok_s": stats["decode_tok_s"],
                             "logits": rec, "calls": calls, "ticks": ticks,
                             "profile": prof}


def add_launches(total: dict, counts: dict) -> None:
    """Sum a run's counts into ``total``, for the kernels it launched."""
    for name, n in counts.items():
        if n:
            total[name] = total.get(name, 0) + n


#: phase 6b's model-level runs repeat phase 6a's serving path, host-bound
#: (re-quantizing every weight each call): on the first 3 of the model's
#: layers (the same weights), which keeps the whole script in its time
#: limit (24 when phase 9 came, 12 with phase 12, 6 with phase 13, 3
#: with phase 16)
MODEL_LEVEL_LAYERS = 3
#: phase 10a's depth (yi-9b's first 12 layers, the same weights; 24
#: before phase 16)
SPEC_LAYERS = 12


def main_path_phase(dev, cfg, model, prompts
                    ) -> tuple[dict, dict, dict, dict]:
    """Phase 6: the engine at yi-9b's full width; returns launches by
    kernel and by tensor-core route (``launches_tc``), each run's tokens
    by quant mode, and the lut4 run's (its tokens, each decode step's
    logits, its profile with the dense attention's range: phase 16a's
    reference).  6a:
    engine-level lut4 / nf4p (decode projections on the D&C kernels,
    prefill full precision).  6b: model-level luna_approx2 / luna_dc
    (every projection on luna_mm) and lut_nf4 (on lut_gemm), on the
    first ``MODEL_LEVEL_LAYERS`` layers."""
    from dataclasses import replace

    cut = replace(cfg, num_layers=min(MODEL_LEVEL_LAYERS, cfg.num_layers))
    tree = model.params_tree()
    cut_model = type(model).from_params(
        cut, {**tree, "blocks": tree["blocks"][:cut.num_layers]}, device=dev)
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in (("lut4", "lut_gemm_dc"), ("nf4p", "lut_gemm_dc_res"),
                        ("luna_approx2", "luna_mm"), ("luna_dc", "luna_mm"),
                        ("lut_nf4", "lut_gemm")):
        full = quant in ("lut4", "nf4p")
        counts, outs[quant], tc, extra = serve_once(
            dev, cfg if full else cut, model if full else cut_model, prompts,
            quant, kern, record=quant == "lut4",
            ranges=ATTN_RANGES if quant == "lut4" else None)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
        if quant == "lut4":
            ref = dict(extra, tokens=outs["lut4"])
    # prefill runs the same full-precision model under lut4 and nf4p
    check([o[0] for o in outs["lut4"]] == [o[0] for o in outs["nf4p"]],
          "first (prefill) tokens differ between the lut4 and nf4p runs")
    return launches, tc_total, outs, ref


def ssm_main_path_phase(dev, cfg, model, prompts
                        ) -> tuple[dict, dict, list, dict]:
    """Phase 7: the engine at mamba2-1.3b's full width (48 layers, bf16);
    returns launches by kernel and by tensor-core route, and the nf4p
    run's tokens, decode tok/s and logits (phase 10b's reference).
    Prefill (full precision in every run) on ssd_scan, decode full
    precision, then w_in/w_out frozen to lut4 (on lut_gemm_dc) and nf4p
    (on lut_gemm_dc_res)."""
    launches, outs, tc_total = {}, {}, {}
    for quant, kern in ((None, None), ("lut4", "lut_gemm_dc"),
                        ("nf4p", "lut_gemm_dc_res")):
        counts, outs[quant], tc, extra = serve_once(
            dev, cfg, model, prompts, quant, kern, record=quant == "nf4p")
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    firsts = {q: [o[0] for o in out] for q, out in outs.items()}
    check(firsts[None] == firsts["lut4"] == firsts["nf4p"],
          f"mamba2 first (prefill) tokens differ between runs: {firsts}")
    return launches, tc_total, outs["nf4p"], extra


#: phase 9's shared-prefix mix: a 384-token prefix (24 blocks of 16, a
#: multiple of mamba2's 16-token capture grid) and 7 tails of 8-64 tokens
SHARED_PREFIX = 384
#: phase 9's warm-vs-cold bound on the first-token logits (bf16 models):
#: max |warm - cold| <= WARM_FACTOR * max |cold - exact|, ``exact`` the
#: same prompt prefilled whole on an f32 copy of the weights.  The warm
#: prefix was computed in chunked pieces, the cold prompt in one call:
#: two bf16 roundings of one function, each about as far from exact
#: arithmetic as the other, so by the triangle inequality about twice
#: that distance apart at most.  Beside it the warm logits must equal,
#: bitwise, a replay of the same pieces from a fresh cache
#: (:func:`replay_staged`): any error of the shared blocks or the
#: snapshot shows there exactly.
WARM_FACTOR = 2.0


def shared_prefix_mix(vocab: int) -> list:
    """Phase 9's prompts from seed 1: the 384-token prefix alone, then the
    prefix with 7 distinct tails (lengths 34, 37, 51, 62, 9, 16, 54), ids
    in [1, vocab)."""
    import numpy as np
    rng = np.random.default_rng(1)
    tails = rng.integers(8, 65, size=7)
    prefix = rng.integers(1, vocab, SHARED_PREFIX).tolist()
    return [prefix] + [prefix + rng.integers(1, vocab, int(n)).tolist()
                       for n in tails]


def substrate_run(dev, cfg, model, quant: str, kern: str, knobs: dict,
                  batches: list, label: str, warm_check: bool = False,
                  exact: bool = True, profile: bool = True
                  ) -> tuple[dict, list, dict, dict]:
    """One phase-9 run: the engine under ``EngineConfig(quant, max_batch=8,
    max_seq=1024, **knobs)`` serves ``batches`` (lists of prompts, one
    ``serve()`` each, in order; 32 new tokens a request), every kernel
    counter set to 0 just before the first and read just after the last.
    Checks: every request finished, every logit finite, ``kern`` launched
    once per decode projection of each tick (``ssd_scan`` once per layer
    of each prefill call for mamba2) and no other kernel, every ``kern``
    launch on the tensor-core kernel; on a pool, every block free or held
    by the prefix cache alone.  ``warm_check``: each warm request's
    first-token logits (the engine's own, from its final prefill piece)
    bitwise equal to :func:`replay_staged`'s and within ``WARM_FACTOR``
    times the bf16 model's own distance from f32 of the same prompt
    prefilled whole on a fresh cache (``exact=False``: no f32 copy, for a
    model whose f32 weights would not fit beside it; the distance from
    cold is reported, unchecked: a moe model's warm and cold prefills
    route in different groups).  Emits wall, prefill/decode tok/s, the
    engine's chunk and prefix counts and (``profile``) a 4-tick decode
    profile; returns (launches, tokens, launches by tensor-core route,
    the emitted line)."""
    import torch

    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    eng = Engine(cfg, model, EngineConfig(quant=quant, max_batch=8,
                                          max_seq=1024, **knobs),
                 device=dev)
    finite, watched = watch_logits(eng)
    firsts = []
    if warm_check:
        # the first-token logits of each staged admission's final piece
        # (the only prefill calls given last_pos in these runs), in
        # admission order
        base_prefill = model.prefill

        def prefill(tokens, caches, *, last_pos=None, cache_index=0):
            logits, caches = base_prefill(tokens, caches, last_pos=last_pos,
                                          cache_index=cache_index)
            if last_pos is not None:
                firsts.append(logits[:, 0].float().clone())
            return logits, caches
        model.prefill = prefill
    reqs, rid = [], 0
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    start = eng.metrics.snapshot()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    for batch in batches:
        served = [Request(rid=rid + i, prompt=p, max_new=32)
                  for i, p in enumerate(batch)]
        rid += len(batch)
        reqs += served
        eng.serve(served)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    for m in watched:
        del m.logits
    if warm_check:
        del model.prefill
    stats = eng.metrics.since(start).summary(eng.max_batch)
    layers = cfg.num_layers
    want = dict.fromkeys(wrappers, 0)
    want[kern] = stats["ticks"] * tick_launches(cfg)
    want["ssd_scan"] = stats["prefill_calls"] * scan_calls(cfg)
    check(all(r.done and len(r.out) == 32 for r in reqs),
          f"phase 9 {label}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"phase 9 {label}: non-finite logits")
    check(counts == want,
          f"phase 9 {label}: launches {counts}, want {want}")
    check(tc[kern] == counts[kern],
          f"phase 9 {label}: {tc[kern]} of {counts[kern]} {kern} launches "
          "on the tensor-core kernel")
    out = {"substrate": label, "model": cfg.name, "quant": quant,
           "knobs": knobs, "layers": layers,
           "batches": [[len(p) for p in b] for b in batches],
           "max_new": 32, "launches": counts, "launches_tc": tc,
           "wall_s": wall, **{k: stats[k] for k in (
               "prefill_tok_s", "decode_tok_s", "prefill_s", "decode_s",
               "prefill_calls", "prefill_chunks", "ticks", "prefix_hits",
               "prefix_tokens_reused", "cache_evictions")}}
    if eng.paged:
        pool = eng.backend.num_blocks - 1
        owners = {} if eng.prefix_cache is None else \
            eng.prefix_cache._block_owners
        check(eng.allocator.free_blocks + len(owners) == pool
              and all(eng.allocator.refcount(b) == n
                      for b, n in owners.items()),
              f"phase 9 {label}: {eng.allocator.free_blocks} free + "
              f"{len(owners)} cached blocks of {pool}")
        out["pool"] = {"blocks": pool, "free": eng.allocator.free_blocks,
                       "cached": len(owners)}
    if warm_check:
        check(len(firsts) == len(reqs),
              f"phase 9 {label}: {len(firsts)} final prefill pieces for "
              f"{len(reqs)} requests")
        rows = []
        f32 = f32_copy(model) if exact else None
        with torch.inference_mode():
            for req, warm in zip(reqs[1:], firsts[1:]):
                check(int(warm.argmax()) == req.out[0],
                      f"phase 9 {label}: rid {req.rid}'s recorded logits "
                      "are not the ones it sampled from")
                warm = warm[0]
                replay = replay_staged(eng, model, reqs[0].prompt,
                                       req.prompt)
                toks = torch.as_tensor([req.prompt], device=dev)
                cold, _ = model.prefill(toks, model.init_cache(1, 1024))
                cold = cold[0, 0].float()
                scale = cold.abs().max()
                row = {"replay_bitwise": bool(torch.equal(warm, replay)),
                       "warm_vs_cold": ((warm - cold).abs().max()
                                        / scale).item(),
                       "argmax_equal": int(cold.argmax()) == req.out[0]}
                if f32 is not None:
                    ref, _ = f32.prefill(toks, f32.init_cache(1, 1024))
                    row["cold_vs_f32"] = ((cold - ref[0, 0]).abs().max()
                                          / scale).item()
                rows.append(row)
        del f32
        out["warm"] = {"factor": WARM_FACTOR if exact else None,
                       "per_request": rows,
                       "max_warm_vs_cold": max(r["warm_vs_cold"]
                                               for r in rows)}
        for r, req in zip(rows, reqs[1:]):
            check(r["replay_bitwise"],
                  f"phase 9 {label}: rid {req.rid}'s warm logits differ "
                  "from a replay of its pieces on a fresh cache")
            if exact:
                check(r["warm_vs_cold"] <= WARM_FACTOR * r["cold_vs_f32"],
                      f"phase 9 {label}: rid {req.rid}'s warm logits "
                      f"{r['warm_vs_cold']} of the scale from cold, above "
                      f"{WARM_FACTOR} x the cold ones' {r['cold_vs_f32']} "
                      "from f32")
    if profile:                               # after the counts are read
        prof = profile_decode(eng, batches[-1])
        out.update({f"profile_{k}": v for k, v in prof.items()})
    emit(out)
    tokens = [r.out for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tokens, tc, out


def f32_copy(model):
    """``model`` over f32 copies of its weights (norm weights, already
    f32, shared)."""
    from dataclasses import replace

    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        return node.float()
    cfg = replace(model.cfg, dtype="float32")
    return type(model).from_params(cfg, cast(model.params_tree()),
                                   device=model.device)


def replay_staged(eng, model, prefix: list, prompt: list):
    """The first-token logits (V,) of ``prompt`` computed as the engine's
    warm admission computed them, but from a fresh cache with no prefix
    cache between: ``prefix`` fed in the pieces its own cold staged
    admission ran (``eng.prefill_chunk`` tokens each, the last padded to
    its bucket with ``last_pos``), then ``prompt``'s tail in the warm
    admission's pieces (cut at the state-capture boundary where the
    substrate carries state).  Same calls and shapes, so the engine's
    logits equal these bitwise unless its shared blocks or snapshot
    differ from what that prefix computed."""
    import torch
    dev = eng.device
    chunk = eng.prefill_chunk
    caches = model.init_cache(1, eng.backend.stage_len)

    def pieces(tokens, consumed, cap):
        nonlocal caches
        while True:
            remaining = len(tokens) - consumed
            c = chunk
            if cap is not None and consumed < cap:
                c = min(c, cap - consumed)
            if remaining > c:
                _, caches = model.prefill(
                    torch.as_tensor([tokens[consumed:consumed + c]],
                                    device=dev), caches,
                    cache_index=consumed)
                consumed += c
                continue
            pl = min(eng._bucket_len(remaining),
                     eng.backend.stage_len - consumed)
            toks = torch.zeros((1, pl), dtype=torch.long, device=dev)
            toks[0, :remaining] = torch.as_tensor(tokens[consumed:])
            logits, caches = model.prefill(
                toks, caches, cache_index=consumed,
                last_pos=torch.as_tensor([remaining - 1], device=dev))
            return logits[0, 0].float()

    pieces(prefix, 0, None)
    cap = None
    if eng.backend.needs_state:
        c = eng._capture_boundary(len(prompt))
        cap = c if len(prefix) < c < len(prompt) else None
    return pieces(prompt, len(prefix), cap)


def substrate_phase(dev, cfg, model, prompts, dense_lut4
                    ) -> tuple[dict, dict]:
    """Phase 9a (after phase 6, on its model): yi-9b under lut4 on the
    paged pool (block 16) serves phase 6's requests, tokens bitwise equal
    to phase 6a's dense lut4 run; then with ``prefix_cache`` and
    ``prefill_chunk=128`` the shared-prefix mix (the prefix alone, then 7
    warm requests together): 7 hits reusing 7 x 384 tokens."""
    launches, tc = {}, {}
    counts, outs, route, _ = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16), [prompts], "yi-9b paged")
    check(outs == dense_lut4,
          "phase 9a: paged lut4 tokens differ from phase 6a's dense run")
    add_launches(launches, counts)
    add_launches(tc, route)
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, route, out = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16, prefix_cache=True,
             prefill_chunk=128), [mix[:1], mix[1:]],
        "yi-9b paged prefix chunked", warm_check=True)
    check(out["prefix_hits"] == 7
          and out["prefix_tokens_reused"] == 7 * SHARED_PREFIX,
          f"phase 9a: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens, want 7 and "
          f"{7 * SHARED_PREFIX}")
    add_launches(launches, counts)
    add_launches(tc, route)
    return launches, tc


def ssm_substrate_phase(dev, cfg, model) -> tuple[dict, dict]:
    """Phase 9b (after phase 7, on its model): mamba2-1.3b under nf4p with
    ``prefill_chunk=64`` and ``prefix_cache`` serves the shared-prefix mix
    in phase 9a's order: 7 hits on the 384-token snapshot; every prefill
    piece (a carried, non-zero initial state for all but the first, a
    masked last piece) on ``ssd_scan``."""
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, route, out = substrate_run(
        dev, cfg, model, "nf4p", "lut_gemm_dc_res",
        dict(prefill_chunk=64, prefix_cache=True), [mix[:1], mix[1:]],
        "mamba2 prefix chunked", warm_check=True)
    check(out["prefix_hits"] == 7
          and out["prefix_tokens_reused"] == 7 * SHARED_PREFIX,
          f"phase 9b: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens, want 7 and "
          f"{7 * SHARED_PREFIX}")
    return counts, route


#: phase 10's token rule (bf16 models at full width).  A speculative run
#: computes the same greedy function as the plain run in another order:
#: the verify window scores 5 columns in one (40-row) GEMM where the plain
#: tick scores one, and its cache was written by earlier windows.  Two
#: such orders move argmax at near-ties (phase 9's warm-vs-cold runs show
#: it for chunked against whole prefill).  So a request's
#: tokens must equal the plain run's, or, at their FIRST divergence (token
#: t) only, the plain run's top-two logit margin at t must be at most
#: WINDOW_FACTOR times the distance between the two orders' logits on the
#: same token state: the spec run's logits at the window's column 0 (step
#: t0 <= t, the latest step either run scored one token at a time or as
#: column 0) against the plain run's decode logits at t0.  Two roundings
#: of one function, each about as far from exact as the other: by the
#: triangle inequality about twice that distance apart at most (as
#: WARM_FACTOR).  Anything else fails.
WINDOW_FACTOR = 2.0


def record_logits(eng) -> tuple[dict, object]:
    """Record, under (rid, step), the logits row each active request is
    scored by when a token is chosen one at a time (``decode_step``) or as
    a verify window's column 0 (``decode_window``), on the instance of
    ``eng.decode_params``; the first record of a step stays.  Draft steps
    (self_lut's, which may run on the same model) are not recorded.
    Returns (the records, a function that removes the hooks)."""
    rec = {}
    m = eng.decode_params
    drafting = [False]

    def keep(logits):
        if drafting[0]:
            return
        for s, req in enumerate(eng.slots):
            if req is not None and req.rid in eng.active:
                rec.setdefault((req.rid, len(req.out)),
                               logits[s, 0].float().clone())

    step, window = m.decode_step, m.decode_window

    def decode_step(*a, **kw):
        logits, caches = step(*a, **kw)
        keep(logits)
        return logits, caches

    def decode_window(*a, **kw):
        logits, caches = window(*a, **kw)
        keep(logits)
        return logits, caches

    m.decode_step, m.decode_window = decode_step, decode_window
    spec = eng._spec
    if spec is not None:
        propose = spec.propose

        def drafted(*a, **kw):
            drafting[0] = True
            try:
                return propose(*a, **kw)
            finally:
                drafting[0] = False
        spec.propose = drafted

    def unhook():
        del m.decode_step, m.decode_window
        if spec is not None:
            del spec.propose
    return rec, unhook


def margin(logits) -> float:
    top = logits.topk(2).values
    return (top[0] - top[1]).item()


def window_rule(rid: int, got: list, plain: list, rec: dict,
                plain_rec: dict, dist_at=None) -> dict:
    """The WINDOW_FACTOR rule for one request: equal tokens, or at the
    first divergence t the plain run's top-two margin at t within
    WINDOW_FACTOR times the distance of the two runs' logits at t0 (the
    latest step <= t that ``rec`` holds; ``dist_at``: (t0, the logits row)
    to use instead, for a re-prefill).  Returns the verdict's numbers."""
    n = min(len(got), len(plain))
    t = next((i for i in range(n) if got[i] != plain[i]), None)
    if t is None:
        return {"rid": rid, "equal": len(got) == len(plain)}
    if dist_at is None:
        t0 = max((k for r, k in rec if r == rid and k <= t), default=None)
        if t0 is None or (rid, t0) not in plain_rec:
            return {"rid": rid, "equal": False, "first_divergence": t,
                    "passed": False, "why": "no logits recorded at or "
                                            "before the divergence"}
        row = rec[(rid, t0)]
    else:
        t0, row = dist_at
    dist = (row - plain_rec[(rid, t0)]).abs().max().item()
    m = margin(plain_rec[(rid, t)]) if (rid, t) in plain_rec else math.inf
    return {"rid": rid, "equal": False, "first_divergence": t, "t0": t0,
            "plain_margin": m, "logit_distance": dist,
            "passed": m <= WINDOW_FACTOR * dist}


#: the verify kernel of each engine-level quant mode (the plain tick's too)
DC_KERNEL = {"lut4": "lut_gemm_dc", "nf4p": "lut_gemm_dc_res"}


def spec_run(dev, cfg, model, prompts, quant: str, mode: str, plain: list,
             plain_extra: dict, label: str, profile: bool = True,
             knobs: dict | None = None) -> tuple[dict, dict]:
    """One phase-10 run: the engine under ``EngineConfig(quant, spec=mode,
    spec_k=4, max_batch=8, max_seq=1024)`` serves the request mix (32 new
    tokens each), every kernel counter set to 0 just before and read just
    after.  Checks: every request finished, every logit finite,
    ``spec_accepted + spec_rejected == spec_drafted``; each kernel's
    launches equal the run's: the verify windows (M = 40, past
    ``TC_MAX_M``: the f32-FMA kernel), mamba2's commit passes (the same)
    and the plain ticks (M = 8, the tensor-core kernel) on
    ``DC_KERNEL[quant]``, self_lut's draft steps
    (M = 8) on ``lut_gemm_dc_res``'s tensor-core kernel, mamba2's
    ``ssd_scan`` once per layer of each verify, commit and prefill call;
    tokens against ``plain`` by the WINDOW_FACTOR rule.  Reports
    acceptance per window, tokens per tick, decode tok/s against the plain
    run's and (``profile``) a profile of 4 ticks.  ``knobs``: more
    EngineConfig fields (the substrate).  Returns (launches, by route)."""
    import torch

    from repro_torch.kernels.lut_gemm.lut_gemm import takes_tc
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    t_build = time.perf_counter()
    eng = Engine(cfg, model, EngineConfig(quant=quant, spec=mode, spec_k=4,
                                          max_batch=8, max_seq=1024,
                                          **(knobs or {})),
                 device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    finite, watched = watch_logits(eng)
    rec, unhook = record_logits(eng)
    calls = Counter()
    for name in ("_draft", "_spec_commit"):
        base = getattr(eng, name)

        def counted(*a, _base=base, _name=name, **kw):
            calls[_name] += 1
            return _base(*a, **kw)
        setattr(eng, name, counted)
    reqs = [Request(rid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    for m in watched:
        del m.logits
    unhook()
    for name in ("_draft", "_spec_commit"):
        delattr(eng, name)
    layers, tick = cfg.num_layers, tick_launches(cfg)
    m = eng.metrics.snapshot()             # before the profile's ticks
    verify_ticks, plain_ticks = m.spec_ticks, m.ticks - m.spec_ticks
    kern = DC_KERNEL[quant]
    want = dict.fromkeys(wrappers, 0)
    want_tc = dict.fromkeys(("lut_gemm_dc", "lut_gemm_dc_res"), 0)
    k, n = {"dense": LAYER_SHAPES, "ssm": MAMBA2_SHAPES,
            "moe": DSV2_LITE_SHAPES, "hybrid": ZAMBA2_SHARED}[cfg.family][0]
    verify_tc = takes_tc(eng.max_batch * 5, k, n, torch.bfloat16, True)
    want[kern] += (verify_ticks + calls["_spec_commit"]
                   + plain_ticks) * tick
    want_tc[kern] += (plain_ticks + verify_tc * verify_ticks) * tick
    want["lut_gemm_dc_res"] += calls["_draft"] * tick
    want_tc["lut_gemm_dc_res"] += calls["_draft"] * tick
    want["ssd_scan"] = (verify_ticks + calls["_spec_commit"]
                        + stats["prefill_calls"]) * scan_calls(cfg)
    check(stats["done"] and all(len(r.out) == 32 for r in reqs),
          f"phase 10 {label}: not every request finished")
    check(finite and bool(torch.stack(finite).all()),
          f"phase 10 {label}: non-finite logits")
    check(m.spec_accepted + m.spec_rejected == m.spec_drafted,
          f"phase 10 {label}: accepted {m.spec_accepted} + rejected "
          f"{m.spec_rejected} != drafted {m.spec_drafted}")
    check(counts == want, f"phase 10 {label}: launches {counts}, want {want}")
    got_tc = {name: tc[name] for name in want_tc}
    check(got_tc == want_tc, f"phase 10 {label}: tensor-core launches "
          f"{got_tc}, want {want_tc}")
    rules = [window_rule(r.rid, r.out, plain[r.rid], rec,
                         plain_extra["logits"]) for r in reqs]
    check(all(v.get("equal") or v.get("passed") for v in rules),
          f"phase 10 {label}: tokens fail the WINDOW_FACTOR rule: {rules}")
    window = eng.registry.dump()["engine_spec_accepted_per_window"]
    prof = {}
    if profile:                            # after the counts are read
        t_prof = time.perf_counter()
        prof = profile_decode(eng, prompts)
        prof["s"] = time.perf_counter() - t_prof
    out = {"phase10": label, "model": cfg.name, "quant": quant,
           "spec": mode, "spec_k": 4, "knobs": knobs or {},
           "layers": layers, "wall_s": wall,
           "engine_build_s": build_s,
           "ticks": m.ticks, "spec_ticks": verify_ticks,
           "plain_ticks": plain_ticks, "draft_steps": calls["_draft"],
           "commit_passes": calls["_spec_commit"],
           "spec_drafted": m.spec_drafted, "spec_accepted": m.spec_accepted,
           "spec_rejected": m.spec_rejected,
           "acceptance": stats["spec_acceptance"],
           "accepted_per_window": window["series"],
           "tokens_per_tick": (m.decode_tokens / m.ticks if m.ticks
                               else 0.0),
           "decode_tok_s": stats["decode_tok_s"],
           "plain_decode_tok_s": plain_extra["decode_tok_s"],
           "launches": counts, "launches_tc": tc, "verify_m": 40,
           "verify_route": "tc" if verify_tc else "fma",
           "window_factor": WINDOW_FACTOR, "tokens": rules,
           "tokens_equal_plain": sum(bool(v.get("equal")) for v in rules),
           **{f"profile_{k}": v for k, v in prof.items()}}
    emit(out)
    del eng, reqs, rec
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tc


def spec_phase(dev, cfg, model, prompts) -> tuple[dict, dict]:
    """Phase 10a (after phase 9a, on phase 6's model cut to its first
    ``SPEC_LAYERS`` layers, to keep the script near half its time limit):
    the plain lut4 run on that depth (logits recorded, no profile), then
    self_lut and ngram held to it."""
    from dataclasses import replace

    cut = replace(cfg, num_layers=min(SPEC_LAYERS, cfg.num_layers))
    tree = model.params_tree()
    cut_model = type(model).from_params(
        cut, {**tree, "blocks": tree["blocks"][:cut.num_layers]}, device=dev)
    launches, plain, tc, extra = serve_once(
        dev, cut, cut_model, prompts, "lut4", "lut_gemm_dc", record=True,
        profile=False)
    for mode in ("self_lut", "ngram"):
        counts, route = spec_run(dev, cut, cut_model, prompts, "lut4", mode,
                                 plain, extra, f"10a yi-9b {mode}")
        add_launches(launches, counts)
        add_launches(tc, route)
    return launches, tc


def ssm_spec_phase(dev, cfg, model, prompts, plain, plain_extra
                   ) -> tuple[dict, dict]:
    """Phase 10b (after phase 9b, on phase 7's model): mamba2-1.3b nf4p
    under self_lut (drafts and verify on the same nf4p model), held to
    phase 7's nf4p run."""
    return spec_run(dev, cfg, model, prompts, "nf4p", "self_lut", plain,
                    plain_extra, "10b mamba2 self_lut")


#: phase 10c, by index in the request mix: the request cancelled during
#: its chunked admission (438 tokens: 4 pieces of 128), the one preempted
#: once it has LOOP_PREEMPT_AT tokens (53 tokens: re-admitted unchunked),
#: and the one whose ``on_token`` callback does both (24 tokens: decoding
#: while the others admit).  The callback runs inside the tick, under the
#: engine lock, so neither act races the loop.
LOOP_CANCEL, LOOP_PREEMPT, LOOP_ACTOR, LOOP_PREEMPT_AT = 0, 6, 7, 4


def loop_phase(dev, cfg, model, prompts, plain) -> tuple[dict, dict]:
    """Phase 10c (after 10a, on phase 6's model): yi-9b lut4 on the paged
    pool with ``prefill_chunk=128`` and ``trace=True``, served through
    ``start()``: 8 client threads each ``submit`` one request and consume
    its ``tokens()``; LOOP_ACTOR's callback cancels LOOP_CANCEL during its
    chunked admission and preempts LOOP_PREEMPT after LOOP_PREEMPT_AT
    tokens (requeued, re-admitted by a re-prefill); then
    ``stop(drain=True)``.
    The reference is a synchronous ``serve()`` of the same mix on the same
    config (its prefill pieces and buckets are the loop's: each request's
    tokens depend on its own admission only).  Checks: the consumers
    joined (within 600 s) while the loop ran; every stream equals its
    request's ``out``; the untouched requests' tokens equal the
    reference's bitwise, and those admitted unchunked equal phase 6a's
    (== 9a's paged) run too; the preempted request's first tokens equal
    the reference's and the rest obey the WINDOW_FACTOR rule (the
    distance: its re-prefill's logits against the reference's decode
    logits at the preemption step); ``lut_gemm_dc`` launched 7 x 48 a
    tick, all on the tensor-core kernel, and nothing else; every pool
    block free after the run; the Perfetto JSON parses and every rid has
    its submit, first-token (where it emitted one) and finish events; the
    registry's counters equal ``EngineMetrics``; the TTFT histogram's
    count equals the requests that emitted a token."""
    import threading

    import torch

    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import _ENGINE_COUNTERS, Engine, Request

    conf = EngineConfig(quant="lut4", max_batch=8, max_seq=1024, paged=True,
                        block_size=16, prefill_chunk=128, trace=True)
    ref = Engine(cfg, model, conf, device=dev)
    ref_rec, unhook = record_logits(ref)
    ref_reqs = [Request(rid=i, prompt=list(p), max_new=32)
                for i, p in enumerate(prompts)]
    check(ref.serve(ref_reqs)["done"], "phase 10c: reference not done")
    unhook()
    del ref
    gc.collect()

    eng = Engine(cfg, model, conf, device=dev)
    finite, watched = watch_logits(eng)
    reqs = [Request(rid=i, prompt=list(p), max_new=32)
            for i, p in enumerate(prompts)]
    victim, kicked = reqs[LOOP_CANCEL], reqs[LOOP_PREEMPT]
    preempted = {}
    base_prefill = model.prefill

    def prefill(tokens, caches, **kw):
        logits, caches = base_prefill(tokens, caches, **kw)
        ext = preempted.get("prompt")
        if ext is not None and "logits" not in preempted \
                and tokens.shape[0] == 1 and tokens.shape[1] >= len(ext) \
                and tokens[0, :len(ext)].tolist() == ext:
            preempted["logits"] = logits[0, 0].float().clone()
        return logits, caches
    model.prefill = prefill
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    streams = [None] * len(reqs)

    def act(tok):
        """``reqs[LOOP_ACTOR]``'s callback: cancel the victim while it is
        staged mid-prompt, preempt ``kicked`` once it has decoded."""
        if not victim.done and any(cp.req is victim and cp.consumed > 0
                                   for cp in eng._chunked):
            check(eng.cancel(victim), "phase 10c: cancel refused")
        if "at" not in preempted and kicked.rid in eng.active \
                and len(kicked.out) >= LOOP_PREEMPT_AT:
            preempted["at"] = len(kicked.out)
            check(eng.preempt(kicked), "phase 10c: preempt refused")
            preempted["prompt"] = list(kicked.prompt)
    eng.start()

    def client(i):
        handle = eng.submit(reqs[i],
                            on_token=act if i == LOOP_ACTOR else None)
        streams[i] = list(handle.tokens())

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(all(not t.is_alive() for t in threads),
          "phase 10c: a tokens() consumer hung")
    check(eng.running, "phase 10c: the serve loop died before stop()")
    check(eng.stop(drain=True, timeout=300), "phase 10c: stop() timed out")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tc = read_counters(wrappers)
    del model.prefill
    for m in watched:
        del m.logits
    m = eng.metrics
    layers = cfg.num_layers
    want = dict.fromkeys(wrappers, 0)
    want["lut_gemm_dc"] = m.ticks * layers * projections(cfg)
    check(counts == want, f"phase 10c: launches {counts}, want {want}")
    check(tc["lut_gemm_dc"] == counts["lut_gemm_dc"],
          f"phase 10c: {tc['lut_gemm_dc']} of {counts['lut_gemm_dc']} "
          "lut_gemm_dc launches on the tensor-core kernel")
    check(finite and bool(torch.stack(finite).all()),
          "phase 10c: non-finite logits")
    check(all(s == r.out for s, r in zip(streams, reqs)),
          "phase 10c: a stream differs from its request's out")
    check(victim.cancelled and victim.out == [] and m.cancelled == 1,
          "phase 10c: the cancel missed the victim's chunked admission")
    check("prompt" in preempted, "phase 10c: the preempt never fired")
    check(m.preemptions == 1 and kicked.done and len(kicked.out) == 32,
          "phase 10c: the preempted request did not finish")
    untouched = [i for i in range(len(reqs))
                 if i not in (LOOP_CANCEL, LOOP_PREEMPT)]
    check(all(reqs[i].out == ref_reqs[i].out for i in untouched),
          "phase 10c: untouched tokens differ from the synchronous run")
    unchunked = [i for i in untouched
                 if len(prompts[i]) <= conf.prefill_chunk]
    check(all(reqs[i].out == plain[i] for i in unchunked),
          "phase 10c: unchunked requests' tokens differ from phase 6a's")
    at = preempted["at"]
    check(kicked.out[:at] == ref_reqs[LOOP_PREEMPT].out[:at],
          "phase 10c: the preempted request's first tokens differ")
    rule = window_rule(kicked.rid, kicked.out, ref_reqs[LOOP_PREEMPT].out,
                       {}, ref_rec, dist_at=(at, preempted["logits"]))
    check(rule.get("equal") or rule.get("passed"),
          f"phase 10c: the preempted request fails the rule: {rule}")
    pool = eng.backend.num_blocks - 1
    check(eng.allocator.free_blocks == pool,
          f"phase 10c: {eng.allocator.free_blocks} of {pool} blocks free")
    doc = json.loads(eng.tracer.perfetto())
    from repro_torch.obs.trace import request_events
    per_req = request_events(eng.tracer.events())
    for r in reqs:
        names = [e.name for e in per_req.get(r.rid, [])]
        need = {"submit", "finish"} | ({"first_token"} if r.out else set())
        check(need <= set(names) and names.count("submit") == 1
              and names.count("finish") == 1,
              f"phase 10c: rid {r.rid}'s trace events {names}")
    dump = eng.registry.dump()
    snap = m.snapshot()
    check(all(dump[name]["series"].get("", 0) == getattr(snap, f)
              for f, (name, _) in _ENGINE_COUNTERS.items()),
          "phase 10c: registry counters differ from EngineMetrics")
    ttft = sum(v["count"] for v in dump["engine_ttft_seconds"]["series"]
               .values())
    check(ttft == sum(1 for r in reqs if r.out),
          f"phase 10c: TTFT count {ttft}")
    emit({"phase10": "10c yi-9b loop", "model": cfg.name, "quant": "lut4",
          "knobs": {"paged": True, "block_size": 16, "prefill_chunk": 128,
                    "trace": True}, "layers": layers, "wall_s": wall,
          "ticks": m.ticks, "prefill_chunks": m.prefill_chunks,
          "cancelled_rid": victim.rid, "preempted_rid": kicked.rid,
          "preempted_at": at, "preempted_rule": rule,
          "untouched_equal_sync": len(untouched),
          "unchunked_equal_6a": len(unchunked),
          "trace_events": len(eng.tracer.events()),
          "trace_dropped": eng.tracer.dropped,
          "perfetto_bytes": len(json.dumps(doc)), "ttft_count": ttft,
          "decode_tok_s": snap.summary(8)["decode_tok_s"],
          "launches": counts, "launches_tc": tc})
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, tc


#: phase 4's speculative engines: (family, label, EngineConfig knobs)
SMALL_SPEC = [("dense", "dense", {}),
              ("dense", "paged", dict(paged=True, block_size=8)),
              ("ssm", "state", {})]


def small_spec_phase(dev):
    """Phase 4, speculation: reduced f32 yi-9b (dense slab and paged pool)
    and mamba2 (seed 1 weights, the same on both devices) serve 3 prompts
    (8 new tokens each) under ``spec`` ngram and self_lut with quant None,
    lut4 and nf4p: greedy tokens on the card equal the CPU's, and both
    equal the plain greedy engine's on the CPU."""
    import numpy as np
    import torch

    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for arch in ("yi-9b", "mamba2-1.3b"):
        cfg = get_config(arch).reduced(dtype="float32", attn_impl="full")
        cpu = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in (5, 11, 3)]

        def serve(model, device, **knobs):
            eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=48,
                                                  **knobs), device=device)
            reqs = [Request(rid=i, prompt=list(p), max_new=8)
                    for i, p in enumerate(prompts)]
            check(eng.serve(reqs)["done"],
                  f"phase 4 spec {arch} {knobs}: not done")
            return [r.out for r in reqs], eng.metrics.snapshot()

        for family, label, knobs in SMALL_SPEC:
            if family != cfg.family:
                continue
            for quant in (None, "lut4", "nf4p"):
                plain, _ = serve(cpu, "cpu", quant=quant, **knobs)
                for mode in ("ngram", "self_lut"):
                    kw = dict(quant=quant, spec=mode, **knobs)
                    on_cpu, _ = serve(cpu, "cpu", **kw)
                    on_card, m = serve(gpu, dev, **kw)
                    what = f"phase 4 spec {arch} {label} {quant} {mode}"
                    check(on_cpu == plain,
                          f"{what}: CPU tokens differ from plain greedy")
                    check(on_card == on_cpu,
                          f"{what}: card tokens differ from the CPU's")
                    out[f"{arch} {label} {quant or 'f32'} {mode}"] = {
                        k: getattr(m, k) for k in (
                            "spec_ticks", "spec_drafted", "spec_accepted")}
    emit({"small_spec": "reduced f32 yi-9b (dense, paged) and mamba2, "
                        "spec ngram/self_lut x quant None/lut4/nf4p: "
                        "greedy tokens card == cpu == plain greedy",
          "runs": out})


def profile_train_step(step_fn, model, opt_state, batch) -> tuple:
    """One train step under torch.profiler: (its metrics, device time by
    kernel and the idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    device_ms = sum(r[1] for r in rows)

    def share(*keys):
        return sum(r[1] for r in rows if any(k in r[0].lower() for k in keys))

    return metrics, {
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else "not measured",
        "device_idle_share": (1 - device_ms / wall_ms) if rows
        else "not measured",
        "gemm_ms": share("gemm", "cutlass", "sm90_xmma", "nvjet")
        if rows else "not measured",
        "luna_mm_ms": share("luna_mm") if rows else "not measured",
        "ssd_scan_ms": (share("ssd_") - share("ssd_bwd")) if rows
        else "not measured",
        "ssd_scan_bwd_ms": share("ssd_bwd") if rows else "not measured",
        "kernels": len(rows),
        "launches": sum(r[2] for r in rows),
        "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                for k, ms, n in rows[:14]]}


def train_steps(dev, what, n, step_fn, model, state, data, wrappers, want,
                want_tc=0, profile_last=False, extra=None) -> tuple:
    """``n`` train steps (phases 8 and 13) on ``data``'s batches 0 .. n-1,
    every launch count set to 0 just before and read after: the counts
    must equal ``want`` and luna_mm's tensor-core launches ``want_tc``.
    Each step's wall (synchronised), tok/s, loss and grad norm (finite),
    the peak memory, and with ``profile_last`` the last step under
    torch.profiler; one line, with ``extra`` in it.  Returns (the counts,
    luna_mm's tensor-core launches)."""
    import torch

    batches = [data.batch(i, dev) for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    steps, prof = [], None
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        if profile_last and i == n - 1:
            metrics, prof = profile_train_step(step_fn, model, state, batch)
        else:
            metrics = step_fn(model, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gn),
              f"{what} step {i}: loss {loss}, grad_norm {gn}")
        tokens = batch["labels"].numel()
        steps.append({"step": int(state.step), "wall_s": wall,
                      "tok_s": tokens / wall, "loss": loss,
                      "grad_norm": gn, "profiled": prof is not None
                      and i == n - 1})
    counts, tc = read_counters(wrappers)
    check(counts == want, f"{what}: launches {counts}, want {want}")
    check(tc["luna_mm"] == want_tc, f"{what}: {tc['luna_mm']} luna_mm "
          f"launches on the tensor-core kernel, want {want_tc}")
    steady = [r["wall_s"] for r in steps[1:] if not r["profiled"]]
    emit({"train": what, "batch": list(batches[0]["labels"].shape),
          "steps": steps, "launches": counts,
          "luna_mm_launches_tc": tc["luna_mm"],
          "steady_step_s": min(steady) if steady else None,
          "steady_step_s_max": max(steady) if steady else None,
          "steady_tok_s": (batches[0]["labels"].numel() / min(steady)
                           if steady else None),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          **(extra or {}), **({"profile": prof} if prof else {})})
    return counts, tc["luna_mm"]


#: phase 8: yi-9b at its published widths, depth cut 48 -> 8 (the f32
#: moments of 48 layers alone are ~33 GB beside ~16 GB of bf16 weights
#: and grads, ~105 GB in all); TRAIN_4K's sequence length with its
#: 256-sequence batch cut to 2
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2, 4096, 6
QAT_S, QAT_STEPS = 1024, 2
#: |flash eval loss - chunked eval loss| on the same params, set from
#: readings: 1.25e-4 sound, 7.7e-2 with the output zeroed
FLASH_LOSS_TOL = 1e-3


def train_phase(dev) -> tuple[dict, int, int]:
    """Phase 8: the trainer's step (``make_train_step``) at yi-9b's full
    width, returns launches by kernel, the flash eval's launches of the
    tensor-core flash kernel and luna_mm's of its tensor-core kernel.  6 steps under chunked attention
    (no kernel of the port runs: the counts must stay 0), bf16, remat on,
    AdamW + cosine; 2 QAT steps under luna_approx (every projection
    through the STE on luna_mm: 7 x layers x 2 launches a step, forward
    and remat recompute); then ``flash_eval`` on the trained params."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step

    cfg = replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS,
                  attn_impl="chunked")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(2, TRAIN_STEPS + QAT_STEPS))
    state = opt.init(model.params_tree())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit({"train_model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params_b": n_params / 1e9, "remat": cfg.remat,
          "init_s": time.perf_counter() - t0})
    watch = {"embed": model.embed, "wq0": model.blocks[0].attn.wq,
             "w_down_last": model.blocks[-1].mlp.w_down}
    before = {k: v.detach()[:8, :8].float().clone() for k, v in watch.items()}
    wrappers = kernel_wrappers()
    launches = {}
    luna_tc = []

    def run(what, n, step_fn, m, data, want, want_tc=0, profile_last=False):
        counts, tc = train_steps(dev, what, n, step_fn, m, state, data,
                                 wrappers, want, want_tc, profile_last)
        luna_tc.append(tc)
        add_launches(launches, counts)

    zero = dict.fromkeys(wrappers, 0)
    run("bf16, chunked attention", TRAIN_STEPS, make_train_step(cfg, opt),
        model, SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0), zero,
        profile_last=True)
    qcfg = replace(cfg, quant=QuantConfig(mode="luna_approx"))
    qmodel = type(model).from_params(qcfg, model.params_tree(),
                                     device=dev).requires_grad_(True)
    qat = QAT_STEPS * projections(cfg) * cfg.num_layers * 2
    run("QAT luna_approx (STE on luna_mm)", QAT_STEPS,
        make_train_step(qcfg, opt), qmodel,
        SyntheticLM(cfg.vocab_size, QAT_S, TRAIN_B, seed=0),
        zero | {"luna_mm": qat}, want_tc=qat, profile_last=True)
    del qmodel
    changed = {k: not torch.equal(before[k], v.detach()[:8, :8].float())
               for k, v in watch.items()}
    check(all(changed.values()), f"params did not change: {changed}")

    launches_eval, launches_tc = flash_eval(dev, cfg, model, wrappers)
    add_launches(launches, launches_eval)
    emit({"train_params_changed": changed})
    del model, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, launches_tc, sum(luna_tc)


def flash_controls(kernel) -> dict:
    """Wrong attention put in the flash kernel's place, to show what
    ``flash_eval``'s check can tell: the output zeroed, and the kernel's
    output with its last 64 query rows recomputed without the last 64 keys
    (a fault only late rows see)."""
    import torch

    def zeros(q, k, v, **kw):
        return torch.zeros_like(q)

    def drop_last_kv_tile(q, k, v, *, sm_scale, causal, num_q_heads,
                          num_kv_heads):
        out = kernel(q, k, v, sm_scale=sm_scale, causal=causal,
                     num_q_heads=num_q_heads, num_kv_heads=num_kv_heads)
        t = q.shape[1] - 64
        g = num_q_heads // num_kv_heads
        kk = k[:, :t].repeat_interleave(g, 0).float()
        vv = v[:, :t].repeat_interleave(g, 0).float()
        p = torch.softmax(q[:, t:].float() @ kk.transpose(1, 2) * sm_scale,
                          dim=-1)
        out[:, t:] = (p @ vv).to(out.dtype)
        return out

    return {"zeros": zeros, "last KV tile dropped": drop_last_kv_tile}


def flash_eval(dev, cfg, model, wrappers) -> dict:
    """The eval loss of a held-out batch under attn_impl="flash" (one
    flash launch per layer per call, counted) against the chunked loss of
    the same params (FLASH_LOSS_TOL); then every attention call of the
    same eval (loss and forward, each layer) on its own inputs against the
    kernel's plain version on them (``flash_attention.reference``: bf16 at
    D = 128 takes the tensor-core kernel, held to ``attention_ref_tiled``),
    at its stated tolerance.  Each of ``flash_controls`` in the kernel's
    place must fail one of the two.  Returns the flash run's launches and
    its tensor-core launches."""
    from dataclasses import replace

    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops

    held = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=1).batch(0, dev)
    fmodel = type(model).from_params(replace(cfg, attn_impl="flash"),
                                     model.params_tree(), device=dev)

    def evaluate(m):
        with torch.no_grad():
            loss, _ = m.loss(held)
            hidden, _ = m.forward(held["tokens"])
        return float(loss), hidden.float()

    runs, evals = {}, {}
    for name, m in (("chunked", model), ("flash", fmodel)):
        evaluate(m)                                    # warm-up
        torch.cuda.synchronize()
        for f in wrappers.values():
            f.launches = 0
        fk.flash_attention.launches_tc = 0
        t0 = time.perf_counter()
        runs[name] = evaluate(m)
        torch.cuda.synchronize()
        evals[name] = {"loss": runs[name][0],
                       "wall_s": time.perf_counter() - t0,
                       "launches": {k: f.launches
                                    for k, f in wrappers.items()},
                       "launches_tc": fk.flash_attention.launches_tc}
    zero = dict.fromkeys(wrappers, 0)
    want = zero | {"flash_attention": 2 * cfg.num_layers}
    check(evals["flash"]["launches"] == want,
          f"flash eval launches {evals['flash']['launches']}, want {want}")
    check(evals["chunked"]["launches"] == zero,
          f"chunked eval launched {evals['chunked']['launches']}")
    check(evals["flash"]["launches_tc"] == 2 * cfg.num_layers,
          f"flash eval: {evals['flash']['launches_tc']} launches of the "
          f"tensor-core kernel, want every one")

    def held_to_plain(fn, shares):
        """``fn`` in the kernel's place; each call's worst |out - plain| as
        a share of the kernel's stated tolerance into ``shares`` (above 1
        fails it)."""
        def call(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            plain, bound = fk.reference(q, k, v, **kw)
            shares.append(fk.tolerance_share(out, plain, bound))
            return out
        return call

    kernel = fops.flash_attention
    controls = flash_controls(kernel)
    loss_c, h_c = runs.pop("chunked")
    readings = {}
    for name, fn in {"flash": kernel, **controls}.items():
        shares = []
        fops.flash_attention = held_to_plain(fn, shares)
        try:
            loss, h = evaluate(fmodel)
        finally:
            fops.flash_attention = kernel
        readings[name] = {
            "loss": loss, "loss_vs_chunked": abs(loss - loss_c),
            "calls": len(shares), "worst_call_tol_share": max(shares),
            "hidden_vs_chunked": ((h - h_c).abs().max()
                                  / h_c.abs().max()).item()}
    check(readings["flash"]["loss"] == evals["flash"]["loss"],
          "the flash eval's loss differs between two runs")
    emit({"train_eval": "held-out batch (seed 1), no grad; each attention "
                        "call against its plain version on its inputs, as a "
                        "share of the kernel's tolerance; hidden errors as "
                        "a share of max |chunked hidden|", "evals": evals,
          "readings": readings, "loss_tol": FLASH_LOSS_TOL})

    def passes(r):
        return (math.isfinite(r["loss"])
                and r["loss_vs_chunked"] <= FLASH_LOSS_TOL
                and r["worst_call_tol_share"] <= 1.0)
    check(passes(readings["flash"]), f"flash eval: {readings['flash']}")
    for name in controls:
        check(not passes(readings[name]),
              f"control {name!r} in the kernel's place passes the eval "
              f"check: {readings[name]}")
    del fmodel
    return evals["flash"]["launches"], evals["flash"]["launches_tc"]


def trainer_phase(dev) -> None:
    """Phase 8b: the Trainer on luna-mlp (bf16, its config as is) on the
    card: 12 steps with checkpoints every 5 into a temporary directory,
    then a rerun to 20 resumes from step 12 and trains 8 more."""
    import contextlib
    import io
    import tempfile

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("luna-mlp")
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as ckpt:
        for total in (12, 20):
            tcfg = TrainerConfig(total_steps=total, ckpt_every=5,
                                 log_every=5, ckpt_dir=ckpt, lr=3e-3,
                                 warmup=2)
            trainer = Trainer(cfg, tcfg, device=dev)
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                _, hist = trainer.run(SyntheticLM(cfg.vocab_size, 32, 8,
                                                  seed=0))
            out[total] = {"steps": len(hist), "loss": hist,
                          "wall_s": time.perf_counter() - t0,
                          "checkpoints": trainer.ckpt.steps(),
                          "resumed": "resumed from step 12" in log.getvalue()}
    check(out[12]["steps"] == 12 and not out[12]["resumed"]
          and out[12]["checkpoints"] == [5, 10, 12],
          f"first trainer run: {out[12]}")
    check(out[20]["steps"] == 8 and out[20]["resumed"]
          and out[20]["checkpoints"] == [12, 15, 20],
          f"resumed trainer run: {out[20]}")
    check(all(math.isfinite(x) for r in out.values() for x in r["loss"]),
          "non-finite trainer loss")
    emit({"trainer": cfg.name, "dtype": cfg.dtype, "runs": out})


#: phase 13: the ssm, hybrid and moe families trained at their published
#: widths, at phase 8's shape (TRAIN_4K's S = 4096, its batch cut to 2):
#: (arch, depth or None for all layers).  deepseek-v2-lite-16b keeps 3 of
#: its 27 layers (the dense first one and 2 MoE layers): its 15.7B
#: parameters take 31 GB in bf16, as many again for the gradients and 126
#: GB for AdamW's two f32 moments, 188 GB in all against the card's 80
FAMILY_TRAIN = [("mamba2-1.3b", None), ("zamba2-1.2b", None),
                ("deepseek-v2-lite-16b", 3)]
FAMILY_STEPS = 4
#: the leaves phase 13 requires to move (every layer's): bf16 norm
#: weights at 1.0 take steps below their ulp and may not
FAMILY_WATCH = ("embed", "lm_head", "w_in", "w_out", "A_log", "dt_bias",
                "router", "wq", "w_gate")
#: phase 13's gradient check: one mamba2 layer's w_in, A_log and dt_bias
#: gradients on the first batch through the trainer's route (the scan's
#: backward on ssd_scan_bwd.cu) against the same with autograd of the
#: plain scan as the backward (:class:`KernelFwdPlainBwd`, reachable from
#: this script alone), as a share of each leaf's max |grad|.  The two
#: routes share every forward bit; the layer is the last, so its upstream
#: gradient is the same bits too, and the two backwards differ by f32
#: rounding (~1e-6 of the scale).  w_in's gradient is bf16: that rounding
#: flips a bf16 rounding here and there, and one flip of the leaf's
#: largest element moves it by 2^-8 of the scale, ~4e-3
SCAN_GRAD_LAYER = -1
SCAN_GRAD_REL = 1e-2


def kernel_fwd_plain_bwd(x, dt, a, b, c, *, chunk, initial_state=None,
                         mask=None):
    """Phase 13's check-only stand-in for ``ssd_chunked_kernel`` (training
    passes no state and no mask): the scan's forward on the kernels, its
    backward torch autograd of the plain ``_ssd_chunked`` recomputed on the
    saved inputs."""
    import torch

    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
    from repro_torch.models.ssm import _ssd_chunked

    check(initial_state is None and mask is None,
          "the check-only scan takes no state and no mask")

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *ops):
            ctx.save_for_backward(*ops)
            return ssd_scan(*ops, chunk=chunk)

        @staticmethod
        def backward(ctx, dy, dfinal):
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                y, fs = _ssd_chunked(*leaves, chunk)
                return torch.autograd.grad((y, fs), leaves, (dy, dfinal))

    return KernelFwdPlainBwd.apply(*(t.float().contiguous()
                                     for t in (x, dt, a, b, c)))


def scan_grad_check(model, batch) -> dict:
    """:data:`SCAN_GRAD_LAYER`'s gradients through the trainer's route and
    through :func:`kernel_fwd_plain_bwd`, each within
    :data:`SCAN_GRAD_REL` of its leaf's scale; the grads are cleared
    after."""
    import repro_torch.models.ssm as ssm_mod

    leaves = ("w_in", "A_log", "dt_bias")
    layer = model.blocks[SCAN_GRAD_LAYER].m
    grads, losses = [], []
    for route in (ssm_mod.ssd_chunked_kernel, kernel_fwd_plain_bwd):
        saved, ssm_mod.ssd_chunked_kernel = ssm_mod.ssd_chunked_kernel, route
        try:
            loss, _ = model.loss(batch)
            loss.backward()
        finally:
            ssm_mod.ssd_chunked_kernel = saved
        losses.append(loss.item())
        grads.append({k: getattr(layer, k).grad.float().clone()
                      for k in leaves})
        model.zero_grad(set_to_none=True)
    errs = {k: ((grads[0][k] - grads[1][k]).abs().max()
                / grads[1][k].abs().max().clamp_min(1e-30)).item()
            for k in leaves}
    check(all(e <= SCAN_GRAD_REL for e in errs.values()),
          f"phase 13 gradient check: {errs} of the scale > {SCAN_GRAD_REL}")
    return {"layer": SCAN_GRAD_LAYER, "scaled_err": errs,
            "tol": SCAN_GRAD_REL, "loss_kernel_route": losses[0],
            "loss_check_route": losses[1]}


def family_train_phase(dev) -> tuple[dict, int]:
    """Phase 13: the trainer's step (``make_train_step``: AdamW + cosine,
    remat on, bf16, random weights from seed 0, SyntheticLM seed 0) at the
    published widths of :data:`FAMILY_TRAIN`, ``FAMILY_STEPS`` steps of B
    2 x S 4096 each, the last one profiled: every Mamba2 layer's scan 2
    ``ssd_scan`` launches a step (the forward and remat's recompute) and 1
    ``ssd_scan_bwd``, none for deepseek-v2-lite; parameters changed.
    mamba2 first runs :func:`scan_grad_check` on its first batch, then
    ``QAT_STEPS`` steps under luna_approx at S = ``QAT_S`` (w_in and w_out
    through the STE on luna_mm: 2 launches a layer, forward and recompute,
    all on its tensor-core kernel).  Returns the launches by kernel and
    luna_mm's tensor-core launches."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()
    zero = dict.fromkeys(wrappers, 0)
    launches, luna_tc = {}, 0
    for arch, depth in FAMILY_TRAIN:
        cfg = get_config(arch)
        if depth is not None:
            cfg = replace(cfg, num_layers=depth)
        t0 = time.perf_counter()
        model = get_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
        qat = arch == "mamba2-1.3b"
        opt = AdamW(lr=3e-4, schedule=cosine_schedule(
            1, FAMILY_STEPS + QAT_STEPS * qat))
        state = opt.init(model.params_tree())
        torch.cuda.synchronize()
        watch = {n: p for n, p in model.named_parameters()
                 if n.split(".")[-1] in FAMILY_WATCH}
        before = {n: p.detach().clone() for n, p in watch.items()}
        emit({"train_model": cfg.name, "family": cfg.family,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "ssm": vars(cfg.ssm) if cfg.ssm else None,
              "moe": vars(cfg.moe) if cfg.moe else None,
              "vocab": cfg.vocab_size, "dtype": cfg.dtype,
              "remat": cfg.remat,
              "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
              "init_s": time.perf_counter() - t0})
        data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
        extra = {}
        if qat:
            extra["grad_check"] = scan_grad_check(model,
                                                  data.batch(0, dev))
        scans = cfg.num_layers if cfg.ssm is not None else 0
        want = zero | {"ssd_scan": 2 * scans * FAMILY_STEPS,
                       "ssd_scan_bwd": scans * FAMILY_STEPS}
        counts, _ = train_steps(dev, f"{cfg.name} bf16", FAMILY_STEPS,
                                make_train_step(cfg, opt), model, state,
                                data, wrappers, want, profile_last=True,
                                extra=extra)
        add_launches(launches, counts)
        if qat:
            qcfg = replace(cfg, quant=QuantConfig(mode="luna_approx"))
            qmodel = type(model).from_params(
                qcfg, model.params_tree(), device=dev).requires_grad_(True)
            n_luna = QAT_STEPS * 2 * cfg.num_layers * 2
            want = zero | {"ssd_scan": 2 * scans * QAT_STEPS,
                           "ssd_scan_bwd": scans * QAT_STEPS,
                           "luna_mm": n_luna}
            counts, tc = train_steps(
                dev, f"{cfg.name} QAT luna_approx (STE on luna_mm)",
                QAT_STEPS, make_train_step(qcfg, opt), qmodel, state,
                SyntheticLM(cfg.vocab_size, QAT_S, TRAIN_B, seed=0),
                wrappers, want, want_tc=n_luna, profile_last=True)
            add_launches(launches, counts)
            luna_tc += tc
            del qmodel
        same = [n for n, p in watch.items()
                if torch.equal(before[n], p.detach())]
        check(not same, f"{cfg.name}: parameters did not change: {same}")
        emit({"train_params_changed": cfg.name, "changed": len(watch),
              "of": len(watch)})
        del model, state, opt, before, watch
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase13_s": time.perf_counter() - t_phase})
    return launches, luna_tc


#: phase 14: the encdec and vlm families at their published widths.
#: whisper-base serves WHISPER_B rows of a WHISPER_PROMPT-token prompt
#: over (B, 1500, 512) frames for WHISPER_STEPS greedy decode steps;
#: llava-next-mistral-7b (all 32 layers) LLAVA_B rows of 576 patches and
#: a LLAVA_PROMPT-token prompt
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 8, 64, 32
LLAVA_B, LLAVA_PROMPT, LLAVA_STEPS = 4, 64, 32
#: llava trained with its depth cut 32 -> 8: 32 layers are 7.24B
#: parameters, ~87 GB as bf16 weights and grads with f32 moments, before
#: activations; 8 layers ~2.0B, ~24 GB (phase 8's cut of yi-9b)
LLAVA_TRAIN_LAYERS = 8
MODALITY_STEPS = 4
#: each decode step's logits against the same positions of one forward of
#: the whole sequence (no cache), max |diff| over max |logit|: the two
#: round bf16 activations at other shapes (M = B rows against B x S)
TF_TOL = 5e-2
#: |llava's flash eval loss - its chunked eval loss| at (2, 4096)
LLAVA_FLASH_LOSS_TOL = 1e-3


class ModalityData:
    """A train stream of an encdec or vlm config on the card:
    ``batch(step, dev)`` is ``card_vs_cpu.modality_batch`` for (B, S),
    seeded ``seed * 1000 + step`` (``SyntheticLM`` carries no frames or
    patches)."""

    def __init__(self, cfg, s: int, b: int, seed: int = 0):
        self.cfg, self.s, self.b, self.seed = cfg, s, b, seed

    def batch(self, step: int, dev) -> dict:
        from repro_torch.train.card_vs_cpu import modality_batch
        return modality_batch(self.cfg, self.s, self.seed * 1000 + step,
                              self.b, dev)


def modality_of(cfg) -> tuple[str, int]:
    """(the name of the family's extra input, decode positions before the
    first text token: llava's patches, none for whisper)."""
    if cfg.family == "encdec":
        return "frames", 0
    return "patches", cfg.vlm.num_patches


def whisper_lut_calls(cfg, b: int, s: int, encode: bool) -> list:
    """(M, K, N) of every projection of one whisper call (``prefill`` with
    ``encode``, else a ``decode_step``): the encoder's 6 a layer at M = B
    x enc_seq, and a decoder layer's 10 at M = B x S but the cross K/V's,
    projected from the encoder's output at B x enc_seq every call.  The
    LM head is not quantized."""
    from repro_torch.models.attention import gqa_shapes
    from repro_torch.models.mlp import mlp_shapes

    t = b * cfg.encdec.enc_seq
    attn = [gqa_shapes(cfg)[n] for n in ("wq", "wk", "wv", "wo")]
    mlp = list(mlp_shapes(cfg, mlp_type="gelu").values())
    calls = []
    if encode:
        calls += [(t, k, n) for k, n in attn + mlp] * cfg.encdec.enc_layers
    m = b * s
    layer = ([(m, k, n) for k, n in attn]
             + [(m, *attn[0]), (t, *attn[1]), (t, *attn[2]), (m, *attn[3])]
             + [(m, k, n) for k, n in mlp])
    return calls + layer * cfg.num_layers


def lut_routes(calls: list) -> Counter:
    """lut_gemm launches by kernel (``route``) of bf16 calls at ``calls``'
    (M, K, N), 16-byte aligned."""
    import torch

    from repro_torch.kernels.lut_gemm.lut_gemm import route
    return Counter(route(m, k, n, torch.bfloat16, True) for m, k, n in calls)


def modality_kernel_checks(dev) -> dict:
    """Phase 14's kernels at the shapes its path gives them, against their
    plain versions (these launches are before the counted runs): lut_gemm
    (NF4 codes) at every (M, K, N) of whisper's prefill and decode step
    under lut_nf4, the public call on the kernel ``route`` names, at the
    tolerance of ``kernels/lut_gemm/lut_gemm.py``; luna_mm (approx_dc) at
    every (M, K, N) of a whisper QAT step, on the kernel ``takes_tc``
    names, bitwise.  flash_attention is held call by call in llava's
    eval (:func:`llava_flash_eval`)."""
    import torch

    from repro_torch.core.lut import NF4_CODEBOOK
    from repro_torch.kernels.luna_mm import luna_mm as lm
    from repro_torch.kernels.luna_mm.ref import luna_mm_ref
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref
    from repro_torch.kernels.lut_gemm.ops import codebook_quantize
    from repro_torch.models.registry import get_config

    cfg = get_config("whisper-base")
    gen = torch.Generator(device=dev).manual_seed(14)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    shapes = sorted(set(whisper_lut_calls(cfg, WHISPER_B, WHISPER_PROMPT,
                                          True)
                        + whisper_lut_calls(cfg, WHISPER_B, 1, False)))
    lut_err, lut_ran = 0.0, Counter()
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        codes, scale = codebook_quantize(w.bfloat16(), cb)
        x = torch.randn((m, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        before = (lg.lut_gemm.launches_tc, lg.lut_gemm.launches_wgmma)
        out = synced(f"phase 14 lut_gemm ({m}, {k}, {n})",
                     lambda: lg.lut_gemm(x, codes, cb, scale))
        ran = {(1, 0): "tc", (0, 1): "wgmma", (0, 0): "fma"}[
            (lg.lut_gemm.launches_tc - before[0],
             lg.lut_gemm.launches_wgmma - before[1])]
        check(ran == lg.route(m, k, n, x.dtype, True),
              f"phase 14 lut_gemm ({m}, {k}, {n}) ran on {ran}")
        lut_ran[ran] += 1
        plain = ref.lut_gemm_ref(x, codes, cb, scale)
        torch.testing.assert_close(out, plain, rtol=lg.KERNEL_RTOL,
                                   atol=lg.KERNEL_ATOL)
        lut_err = max(lut_err, (out - plain).abs().max().item())
    qat = sorted(set(whisper_lut_calls(cfg, 2, QAT_S, True)))
    for m, k, n in qat:
        y = torch.randint(0, 16, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        tc0 = lm.luna_mm.launches_tc
        got = synced(f"phase 14 luna_mm approx_dc ({m}, {k}, {n})",
                     lambda: lm.luna_mm(y, w, "approx_dc"))
        check(lm.luna_mm.launches_tc - tc0 == lm.takes_tc(m, k, n, "row",
                                                          True),
              f"phase 14 luna_mm ({m}, {k}, {n}): not on the kernel "
              "takes_tc names")
        check(torch.equal(got, luna_mm_ref(y, w, "approx_dc")),
              f"phase 14 luna_mm ({m}, {k}, {n}) is not bitwise its plain "
              "version")
    out = {"lut_gemm_shapes": [list(s) for s in shapes],
           "lut_gemm_routes": dict(lut_ran), "lut_gemm_max_abs_err": lut_err,
           "luna_mm_shapes": [list(s) for s in qat],
           "luna_mm": "bitwise"}
    emit({"kernel_check": "phase 14 shapes", **out})
    return out


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: wall, device time, the
    idle share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_idle_share": (1 - device_ms / wall_ms) if rows
            else "not measured",
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, ms, n in rows[:10]]}


def generate(model, prompt, extra, steps: int) -> dict:
    """Greedy: ``prefill`` of ``prompt`` over ``extra`` (frames or
    patches), then ``steps`` ``decode_step``s.  Returns the tokens (B,
    steps), every call's last logits (steps + 1 of (B, V)), the prefill's
    seconds and each step's."""
    import torch

    key, off = modality_of(model.cfg)
    b, s = prompt.shape
    state = model.init_cache(b, off + s + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(prompt, state, **{key: extra})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, toks, step_s = [logits[:, -1]], [], []
    for i in range(steps):
        tok = out[-1].argmax(-1, keepdim=True)
        toks.append(tok)
        t0 = time.perf_counter()
        logits, state = model.decode_step(tok, state, off + s + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out.append(logits[:, -1])
    return {"tokens": torch.cat(toks, dim=1), "logits": out,
            "prefill_s": prefill_s, "step_s": step_s, "state": state}


def teacher_forced_err(model, prompt, extra, run) -> float:
    """Each call's logits of ``run`` (:func:`generate`) against the same
    positions of one forward of prompt + tokens with no cache (the
    prefill's computation over the whole sequence), max |diff| over max
    |logit|."""
    import torch

    seq = torch.cat([prompt, run["tokens"]], dim=1)
    s = prompt.shape[1]
    if model.cfg.family == "encdec":
        hidden, _ = model.decode(seq, model.encode(extra))
        logits = model.logits(hidden)
    else:
        hidden, _ = model.backbone.forward(
            embeds=model._merge(extra, seq))
        logits = model.backbone.logits(hidden)[:, extra.shape[1]:]
    whole = logits[:, s - 1:].float()
    steps = torch.stack(run["logits"], dim=1).float()
    return ((steps - whole).abs().max() / whole.abs().max()).item()


def serve_modality(dev, model, prompt, extra, steps: int, label: str,
                   wrappers, want_calls: list | None = None,
                   repeat: int = 1) -> tuple[dict, dict]:
    """``repeat`` greedy runs (:func:`generate`), every launch counter set
    to 0 just before each and read just after: lut_gemm's launches must
    be ``want_calls``' (on the kernels their route names), nothing else
    launched; the tokens of every run bitwise equal; every logit finite;
    the decode logits within ``TF_TOL`` of one forward of the whole
    sequence.  Reports the last run's prefill and decode tok/s, step wall
    and peak GB (the first run meets each shape first), and a profile of
    one prefill and one decode step (after the counts).  Returns the
    launches of the counted runs and lut_gemm's by route."""
    import torch

    zero = dict.fromkeys(wrappers, 0)
    want = zero | ({"lut_gemm": len(want_calls)} if want_calls else {})
    routes = lut_routes(want_calls or [])
    total, by_route, runs = {}, Counter(), []
    b, s = prompt.shape
    with torch.inference_mode():
        for _ in range(repeat):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters(wrappers)
            run = generate(model, prompt, extra, steps)
            counts, tc = read_counters(wrappers)
            check(counts == want, f"{label}: launches {counts}, want {want}")
            got = {"tc": tc["lut_gemm"], "wgmma": tc["lut_gemm_wgmma"],
                   "fma": counts["lut_gemm"] - tc["lut_gemm"]
                   - tc["lut_gemm_wgmma"]}
            check(got == {r: routes[r] for r in got},
                  f"{label}: lut_gemm launches by kernel {got}, the route "
                  f"says {dict(routes)}")
            check(all(bool(torch.isfinite(lg).all()) for lg in run["logits"]),
                  f"{label}: non-finite logits")
            run["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            add_launches(total, counts)
            by_route.update(got)
            runs.append(run)
        check(all(torch.equal(r["tokens"], runs[0]["tokens"]) for r in runs),
              f"{label}: the tokens of two runs differ")
        tf = teacher_forced_err(model, prompt, extra, runs[0])
        check(tf <= TF_TOL, f"{label}: decode logits differ from the whole "
              f"sequence's forward by {tf} of max |logit| (> {TF_TOL})")
        key, off = modality_of(model.cfg)
        state = runs[-1]["state"]
        for run in runs:
            del run["state"]
        tok = runs[-1]["tokens"][:, -1:]
        prof = {"prefill": profile_call(lambda: model.prefill(
                    prompt, model.init_cache(b, off + s + steps),
                    **{key: extra})),
                "decode_step": profile_call(lambda: model.decode_step(
                    tok, state, off + s + steps - 1))}
    r = runs[-1]
    decode_s = sum(r["step_s"])
    emit({"phase14_serve": label, "model": model.cfg.name,
          "layers": model.cfg.num_layers, "batch": b, "prompt": s,
          key: list(extra.shape), "decode_steps": steps, "runs": repeat,
          "launches": total, "lut_gemm_by_route": dict(by_route),
          "prefill_s": r["prefill_s"],
          "prefill_tok_s": b * (off + s) / r["prefill_s"],
          "decode_step_ms": [1e3 * t for t in r["step_s"][:4]],
          "steady_step_ms": 1e3 * min(r["step_s"][1:]),
          "decode_tok_s": b * steps / decode_s,
          "peak_mem_gb": r["peak_mem_gb"], "teacher_forced_err": tf,
          "teacher_forced_tol": TF_TOL,
          "tokens_equal_across_runs": repeat > 1 or None,
          "first_tokens": r["tokens"][:, 0].tolist(), "profile": prof})
    return total, dict(by_route)


def llava_flash_eval(dev, model, wrappers) -> tuple[dict, int]:
    """llava's eval loss at (2, 4096) (576 patches, 3,520 text tokens)
    under attn_impl="flash" (one launch a layer, each on the tensor-core
    kernel) against the chunked loss of the same weights
    (``LLAVA_FLASH_LOSS_TOL``); then every attention call of the same
    eval on its own inputs against the kernel's plain version
    (``flash_attention.reference``) at its stated tolerance.  Returns the
    flash run's launches and its tensor-core launches."""
    from dataclasses import replace

    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops as fops

    cfg = model.cfg
    held = ModalityData(cfg, TRAIN_S, TRAIN_B, seed=1).batch(0, dev)
    fmodel = type(model).from_params(replace(cfg, attn_impl="flash"),
                                     model.params_tree(), device=dev)
    zero = dict.fromkeys(wrappers, 0)
    evals = {}
    for name, m in (("chunked", model), ("flash", fmodel)):
        with torch.no_grad():
            m.loss(held)                                    # warm-up
            torch.cuda.synchronize()
            reset_counters(wrappers)
            fk.flash_attention.launches_tc = 0
            t0 = time.perf_counter()
            loss, _ = m.loss(held)
            loss = float(loss)
            wall = time.perf_counter() - t0
        evals[name] = {"loss": loss, "wall_s": wall,
                       "launches": read_counters(wrappers)[0],
                       "launches_tc": fk.flash_attention.launches_tc}
    want = zero | {"flash_attention": cfg.num_layers}
    check(evals["flash"]["launches"] == want,
          f"llava flash eval launches {evals['flash']['launches']}, "
          f"want {want}")
    check(evals["chunked"]["launches"] == zero,
          f"llava chunked eval launched {evals['chunked']['launches']}")
    check(evals["flash"]["launches_tc"] == cfg.num_layers,
          f"llava flash eval: {evals['flash']['launches_tc']} launches of "
          "the tensor-core kernel, want every one")
    kernel, shares = fops.flash_attention, []

    def call(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        plain, bound = fk.reference(q, k, v, **kw)
        shares.append(fk.tolerance_share(out, plain, bound))
        return out
    fops.flash_attention = call
    try:
        with torch.no_grad():
            held_loss = float(fmodel.loss(held)[0])
    finally:
        fops.flash_attention = kernel
    diff = abs(evals["flash"]["loss"] - evals["chunked"]["loss"])
    emit({"phase14_eval": cfg.name, "batch": list(held["labels"].shape),
          "patches": list(held["patches"].shape), "evals": evals,
          "loss_vs_chunked": diff, "loss_tol": LLAVA_FLASH_LOSS_TOL,
          "calls_held": len(shares), "worst_call_tol_share": max(shares)})
    check(math.isfinite(evals["flash"]["loss"]) and diff
          <= LLAVA_FLASH_LOSS_TOL, f"llava flash eval loss {evals['flash']} "
          f"vs chunked {evals['chunked']['loss']}")
    check(held_loss == evals["flash"]["loss"],
          "llava's flash eval loss differs between two runs")
    check(len(shares) == cfg.num_layers and max(shares) <= 1.0,
          f"llava flash calls against the plain version: {len(shares)} "
          f"calls, worst share of the tolerance {max(shares)}")
    del fmodel
    return evals["flash"]["launches"], evals["flash"]["launches_tc"]


#: the leaves phase 14 requires to move (every layer's)
MODALITY_WATCH = ("embed", "lm_head", "wq", "wk", "w_up")


def modality_train(dev, cfg, wrappers, qat: bool) -> tuple[dict, int]:
    """``MODALITY_STEPS`` bf16 train steps of ``cfg`` at (B 2, S 4096)
    (``make_train_step``: AdamW + cosine, remat on the decoder blocks),
    the last profiled, no kernel of the port launched; with ``qat``,
    ``QAT_STEPS`` more under luna_approx at S = ``QAT_S`` (every
    projection through the STE on luna_mm: the encoder's once, the
    decoder's twice, forward and remat's recompute, each call on the
    kernel ``takes_tc`` names).  The watched leaves must move.  Returns
    the launches and luna_mm's tensor-core launches."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.kernels.luna_mm.luna_mm import takes_tc
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(
        1, MODALITY_STEPS + QAT_STEPS * qat))
    state = opt.init(model.params_tree())
    torch.cuda.synchronize()
    watch = {n: p for n, p in model.named_parameters()
             if n.split(".")[-1] in MODALITY_WATCH}
    before = {n: p.detach().clone() for n, p in watch.items()}
    emit({"train_model": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "encdec": vars(cfg.encdec) if cfg.encdec else None,
          "vlm": vars(cfg.vlm) if cfg.vlm else None,
          "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "init_s": time.perf_counter() - t0})
    zero = dict.fromkeys(wrappers, 0)
    launches, luna_tc = {}, 0
    counts, _ = train_steps(dev, f"{cfg.name} bf16", MODALITY_STEPS,
                            make_train_step(cfg, opt), model, state,
                            ModalityData(cfg, TRAIN_S, TRAIN_B), wrappers,
                            zero, profile_last=True)
    add_launches(launches, counts)
    if qat:
        qcfg = replace(cfg, quant=QuantConfig(mode="luna_approx"))
        qmodel = type(model).from_params(qcfg, model.params_tree(),
                                         device=dev).requires_grad_(True)
        # the decoder's calls run twice (remat's recompute), the encoder's
        # once
        calls = (whisper_lut_calls(cfg, TRAIN_B, QAT_S, True)
                 + whisper_lut_calls(cfg, TRAIN_B, QAT_S, False))
        n_luna = QAT_STEPS * len(calls)
        want_tc = QAT_STEPS * sum(takes_tc(m, k, n, "row", True)
                                  for m, k, n in calls)
        counts, luna_tc = train_steps(
            dev, f"{cfg.name} QAT luna_approx (STE on luna_mm)", QAT_STEPS,
            make_train_step(qcfg, opt), qmodel, state,
            ModalityData(cfg, QAT_S, TRAIN_B), wrappers,
            zero | {"luna_mm": n_luna}, want_tc=want_tc, profile_last=True,
            extra={"luna_mm_per_step": len(calls),
                   "luna_mm_tc_per_step": want_tc // QAT_STEPS})
        add_launches(launches, counts)
        del qmodel
    same = [n for n, p in watch.items() if torch.equal(before[n], p.detach())]
    check(not same, f"{cfg.name}: parameters did not change: {same}")
    emit({"train_params_changed": cfg.name, "changed": len(watch),
          "of": len(watch)})
    del model, state, opt, before, watch
    gc.collect()
    torch.cuda.empty_cache()
    return launches, luna_tc


def modality_phase(dev) -> tuple[dict, dict]:
    """Phase 14: the encdec and vlm families at their published widths
    (bf16, random weights from seed 0; frames, patches and prompts from
    seeded ``torch.Generator``s on the card in ``input_specs``' shapes).
    a. whisper-base: the kernels at the path's shapes
    (:func:`modality_kernel_checks`); B 8, a 64-token prompt over (8,
    1500, 512) frames, 32 greedy decode steps, in bf16 and under lut_nf4
    (96 lut_gemm launches the prefill, 60 a step, each on the kernel its
    route names), each twice; then training (:func:`modality_train`, with
    QAT on luna_mm).  b. llava-next-mistral-7b, all 32 layers: B 4, 576
    patches and a 64-token prompt, 32 greedy decode steps; the flash eval
    (:func:`llava_flash_eval`); then training with the depth cut to
    ``LLAVA_TRAIN_LAYERS``.  Returns the launches by kernel and by
    tensor-core route (lut_gemm's under ``lut_gemm`` / ``lut_gemm_wgmma``,
    luna_mm's and flash_attention's)."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.models.registry import get_config, get_model

    t_phase = time.perf_counter()
    wrappers = kernel_wrappers()
    launches, tc = {}, Counter()
    modality_kernel_checks(dev)

    cfg = get_config("whisper-base")
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((WHISPER_B, cfg.encdec.enc_seq, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)
    prompt = torch.randint(1, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT),
                           generator=gen, device=dev)
    counts, _ = serve_modality(dev, model, prompt, frames, WHISPER_STEPS,
                               "whisper-base bf16", wrappers, repeat=2)
    add_launches(launches, counts)
    qcfg = replace(cfg, quant=QuantConfig(mode="lut_nf4"))
    qmodel = type(model).from_params(qcfg, model.params_tree(), device=dev)
    calls = (whisper_lut_calls(cfg, WHISPER_B, WHISPER_PROMPT, True)
             + whisper_lut_calls(cfg, WHISPER_B, 1, False) * WHISPER_STEPS)
    check(len(whisper_lut_calls(cfg, WHISPER_B, WHISPER_PROMPT, True)) == 96
          and len(whisper_lut_calls(cfg, WHISPER_B, 1, False)) == 60,
          "whisper-base: 96 + 60 projections a prefill and a step")
    counts, by_route = serve_modality(dev, qmodel, prompt, frames,
                                      WHISPER_STEPS, "whisper-base lut_nf4",
                                      wrappers, calls, repeat=2)
    add_launches(launches, counts)
    tc["lut_gemm"] += by_route["tc"]
    tc["lut_gemm_wgmma"] += by_route["wgmma"]
    del model, qmodel, frames
    gc.collect()
    torch.cuda.empty_cache()
    counts, luna_tc = modality_train(dev, cfg, wrappers, qat=True)
    add_launches(launches, counts)
    tc["luna_mm"] += luna_tc
    t_whisper = time.perf_counter() - t_phase

    cfg = get_config("llava-next-mistral-7b")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"serve_model": cfg.name, "layers": cfg.num_layers,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "weights_gb": torch.cuda.memory_allocated() / 1e9,
          "init_s": time.perf_counter() - t0})
    gen = torch.Generator(device=dev).manual_seed(0)
    patches = torch.randn((LLAVA_B, cfg.vlm.num_patches, cfg.d_model),
                          generator=gen, device=dev).to(torch.bfloat16)
    prompt = torch.randint(1, cfg.vocab_size, (LLAVA_B, LLAVA_PROMPT),
                           generator=gen, device=dev)
    counts, _ = serve_modality(dev, model, prompt, patches, LLAVA_STEPS,
                               "llava-next-mistral-7b bf16", wrappers,
                               repeat=2)
    add_launches(launches, counts)
    del patches
    counts, flash_tc = llava_flash_eval(dev, model, wrappers)
    add_launches(launches, counts)
    tc["flash_attention"] += flash_tc
    del model
    gc.collect()
    torch.cuda.empty_cache()
    counts, _ = modality_train(
        dev, replace(cfg, num_layers=LLAVA_TRAIN_LAYERS), wrappers,
        qat=False)
    add_launches(launches, counts)
    emit({"phase14_s": time.perf_counter() - t_phase,
          "whisper_s": t_whisper, "launches": launches, "launches_tc":
          dict(tc)})
    return launches, dict(tc)


def frozen_pairs(a, b, path=()):
    """(path, a's QuantizedWeight, b's) of every frozen leaf of two trees
    of the same structure."""
    from repro_torch.core.quant import QuantizedWeight
    if isinstance(a, QuantizedWeight):
        return [(path, a, b)]
    if isinstance(a, dict):
        return [p for k in a for p in frozen_pairs(a[k], b[k], path + (k,))]
    if isinstance(a, list):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in frozen_pairs(x, y, path + (i,))]
    return []


#: phase 4's reduced models of the moe family and the rest of the dense
#: family: (arch, config overrides, quant modes of the decode step)
SMALL_FAMILY = [
    ("starcoder2-15b", {}, (None, "lut4")),
    ("minitron-4b", {}, (None, "lut4")),
    ("deepseek-67b", {}, (None, "lut4")),
    ("deepseek-v2-lite-16b", {}, (None, "lut4", "nf4p")),
    ("deepseek-v2-236b", {"q_lora_rank": 16}, (None, "lut4")),
]


def small_moe_phase(dev):
    """Phase 4, the moe family and the rest of the dense family: reduced
    f32 models (seed 1 weights, the same on both devices), card against
    CPU.  Logits of a 12-token prefill and one per-row decode step at 1e-4
    for starcoder2-15b, minitron-4b, deepseek-67b, deepseek-v2-lite-16b and
    deepseek-v2-236b with ``q_lora_rank=16`` (the decode step also on the
    frozen trees, whose codes are bitwise the CPU's); deepseek-v2-lite's
    engines under lut4 and nf4p: 10 mixed-length requests on 8 slots
    (capacity 4 of a decode tick's 8 rows) on the dense slab and the paged
    pool (block 8), and 3 prompts on 3 slots under ``spec="self_lut"``:
    greedy tokens on the card equal the CPU's, the pool's the slab's, and
    self_lut's plain greedy's."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    out = {}
    for arch, over, quants in SMALL_FAMILY:
        cfg = get_config(arch).reduced(dtype="float32", attn_impl="full")
        if over:
            cfg = replace(cfg, mla=replace(cfg.mla, **over))
        cpu = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                    device=dev)
        toks = torch.randint(1, cfg.vocab_size, (4, 12),
                             generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            for quant in quants:
                logits = []
                trees = [m.params_tree() for m in (cpu, gpu)]
                if quant is not None:
                    trees = [quantize_decode_params(t, quant) for t in trees]
                    pairs = frozen_pairs(*trees)
                    check(pairs and all(
                        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
                        for _, a, b in pairs
                        for f in ("codes", "scale", "zero_point")),
                        f"phase 4 {arch} {quant}: card quantization differs "
                        "from the CPU's")
                for model, tree, device in ((cpu, trees[0], "cpu"),
                                            (gpu, trees[1], dev)):
                    caches = model.init_cache(4, 32)
                    pre, caches = model.prefill(toks.to(device), caches)
                    m = type(model).from_params(cfg, tree, device=device)
                    dec, _ = m.decode_step(
                        toks[:, -1:].to(device), caches,
                        torch.full((4,), 12, device=device))
                    logits.append(torch.cat([pre, dec], 1).float().cpu())
                torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                           atol=1e-4)
                out[f"{arch} {quant or 'f32'}"] = (
                    logits[1] - logits[0]).abs().max().item()
        if cfg.family != "moe" or over:
            continue
        rng = np.random.default_rng(4)
        mixed = [(rng.integers(1, cfg.vocab_size, n).tolist(), m) for n, m in
                 zip((3, 9, 5, 17, 2, 12, 7, 4, 6, 10),
                     (4, 9, 6, 3, 8, 5, 7, 2, 6, 5))]
        rng = np.random.default_rng(0)
        three = [(rng.integers(1, cfg.vocab_size, n).tolist(), 8)
                 for n in (5, 11, 3)]

        def serve(model, device, reqs, **knobs):
            eng = Engine(cfg, model, EngineConfig(max_seq=48, **knobs),
                         device=device)
            rs = [Request(rid=i, prompt=list(p), max_new=n)
                  for i, (p, n) in enumerate(reqs)]
            check(eng.serve(rs)["done"], f"phase 4 {arch} {knobs}: not done")
            return [r.out for r in rs]

        for quant in ("lut4", "nf4p"):
            what = f"phase 4 {arch} {quant}"
            slab = serve(cpu, "cpu", mixed, max_batch=8, quant=quant)
            for knobs in ({}, dict(paged=True, block_size=8)):
                got = serve(gpu, dev, mixed, max_batch=8, quant=quant,
                            **knobs)
                check(got == slab, f"{what} {knobs}: card tokens on 8 "
                      "slots differ from the CPU's slab")
            plain = serve(cpu, "cpu", three, max_batch=3, quant=quant)
            for device, model in (("cpu", cpu), (dev, gpu)):
                got = serve(model, device, three, max_batch=3, quant=quant,
                            spec="self_lut")
                check(got == plain, f"{what} self_lut on {device}: tokens "
                      "differ from plain greedy")
            out[f"{arch} {quant} engines"] = "equal"
    emit({"small_family": "reduced f32 starcoder2-15b, minitron-4b, "
                          "deepseek-67b, deepseek-v2-lite-16b, "
                          "deepseek-v2-236b (q_lora_rank 16): prefill + "
                          "decode logits card vs cpu; deepseek-v2-lite "
                          "engines (slab and pool on 8 slots, self_lut on "
                          "3) card == cpu == plain", "max_abs_err": out,
          "rtol": 1e-4, "atol": 1e-4})


def build_moe_model(dev, arch: str = "deepseek-v2-lite-16b"):
    """``arch`` at its published widths, all its layers, bf16, random
    weights from seed 0; the request mix (8 prompts of 16-512 tokens)."""
    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                            cfg.num_kv_heads],
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "moe": vars(cfg.moe) if cfg.moe else None,
          "mla": vars(cfg.mla) if cfg.mla else None,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def moe_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 11: deepseek-v2-lite-16b at its published widths (27 layers,
    bf16, random weights from seed 0) serves phase 6's 8 requests (32 new
    tokens each).  11a: quant None, lut4 and nf4p on the dense slab (each
    frozen run 6 LUT launches a layer a decode tick, 162 a tick, all on
    the tensor-core kernel; the first tokens equal across the three runs;
    a profile of 4 lut4 ticks by kernel and by labelled stage).  11b: lut4
    on the paged pool (block 16): tokens bitwise 11a's lut4 run's; then
    the shared-prefix mix with ``prefix_cache`` and ``prefill_chunk=128``:
    7 hits, the pool free after, each warm request's first-token logits
    bitwise a replay of its pieces.  11c: lut4 under ``spec="self_lut",
    spec_k=4``: tokens 11a's lut4 run's, or the WINDOW_FACTOR rule at the
    first divergence.  11d: minitron-4b at its published widths (32
    layers, GELU, 256k vocab) under lut4: 6 LUT launches a layer a tick.
    Returns (launches, by route, the lut4 run's tokens and logits: phase
    16b's reference)."""
    import torch

    t11 = time.perf_counter()
    launches, tc_total = {}, {}
    cfg, model, prompts = build_moe_model(dev)
    outs, extra = {}, {}
    for quant, kern in ((None, None), ("lut4", "lut_gemm_dc"),
                        ("nf4p", "lut_gemm_dc_res")):
        counts, outs[quant], tc, extra[quant] = serve_once(
            dev, cfg, model, prompts, quant, kern, record=quant == "lut4",
            profile=quant == "lut4", ranges=MOE_RANGES)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    firsts = {q or "bf16": [o[0] for o in out] for q, out in outs.items()}
    check(len({tuple(f) for f in firsts.values()}) == 1,
          f"phase 11a: first (prefill) tokens differ between runs: {firsts}")
    counts, paged, tc, _ = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16), [prompts], "phase 11b paged",
        profile=False)
    check(paged == outs["lut4"],
          "phase 11b: paged lut4 tokens differ from 11a's dense run")
    add_launches(launches, counts)
    add_launches(tc_total, tc)
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, tc, out = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(paged=True, block_size=16, prefix_cache=True,
             prefill_chunk=128), [mix[:1], mix[1:]],
        "phase 11b paged prefix chunked", warm_check=True, exact=False,
        profile=False)
    check(out["prefix_hits"] == 7
          and out["prefix_tokens_reused"] == 7 * SHARED_PREFIX,
          f"phase 11b: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens")
    add_launches(launches, counts)
    add_launches(tc_total, tc)
    for total, part in zip((launches, tc_total), spec_run(
            dev, cfg, model, prompts, "lut4", "self_lut", outs["lut4"],
            extra["lut4"], "phase 11c deepseek-v2-lite self_lut",
            profile=False)):
        add_launches(total, part)
    ref = dict(extra["lut4"], tokens=outs["lut4"])
    del model, extra
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, prompts = build_moe_model(dev, "minitron-4b")
    counts, _, tc, _ = serve_once(dev, cfg, model, prompts, "lut4",
                                  "lut_gemm_dc", profile=False)
    add_launches(launches, counts)
    add_launches(tc_total, tc)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase11_s": time.perf_counter() - t11})
    return launches, tc_total, ref


def small_hybrid_phase(dev):
    """Phase 4, the hybrid family: reduced f32 zamba2 (seed 1 weights, the
    same on both devices), card against CPU.  Logits of a right-padded
    prefill (the card's scans on ``ssd_scan``) and one per-row decode step
    at 1e-4 under quant None, lut4 and nf4p (the frozen codes bitwise the
    CPU's); engines under None, lut4 and nf4p: 5 mixed-length requests on
    3 slots on the slab and on the split substrate (block 8), and 3
    prompts on 3 slots under ``spec="self_lut"`` on both: greedy tokens on
    the card equal the CPU's, the split substrate's the slab's, and
    self_lut's plain greedy's."""
    import numpy as np
    import torch

    from repro_torch.core.quant import quantize_decode_params
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("zamba2-1.2b").reduced(dtype="float32",
                                            attn_impl="full")
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    gpu = type(cpu).from_params(cfg, tree_to(cpu.params_tree(), dev),
                                device=dev)
    lens = torch.tensor([48, 30, 17, 5])
    gen = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (4, 48), generator=gen)
    toks[torch.arange(48)[None, :] >= lens[:, None]] = 0
    nxt = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen)
    out = {}
    with torch.inference_mode():
        runs = []
        for model, device in ((cpu, "cpu"), (gpu, dev)):
            lg, caches = model.prefill(toks.to(device),
                                       model.init_cache(4, 64),
                                       last_pos=(lens - 1).to(device))
            runs.append((lg.float().cpu(), caches))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4,
                                   atol=1e-4)
        out["prefill"] = (runs[1][0] - runs[0][0]).abs().max().item()
        for quant in (None, "lut4", "nf4p"):
            trees = [m.params_tree() for m in (cpu, gpu)]
            if quant is not None:
                trees = [quantize_decode_params(t, quant) for t in trees]
                pairs = frozen_pairs(*trees)
                check(len(pairs) == 7 + 2 * cfg.num_layers and all(
                    torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
                    for _, a, b in pairs
                    for f in ("codes", "scale", "zero_point")),
                    f"phase 4 zamba2 {quant}: card quantization differs "
                    "from the CPU's")
            logits = []
            for (_, caches), tree, device in ((runs[0], trees[0], "cpu"),
                                              (runs[1], trees[1], dev)):
                m = type(cpu).from_params(cfg, tree, device=device)
                lg, _ = m.decode_step(nxt.to(device), list(caches),
                                      lens.to(device))
                logits.append(lg.float().cpu())
            torch.testing.assert_close(logits[1], logits[0], rtol=1e-4,
                                       atol=1e-4)
            out[f"{quant or 'f32'} decode"] = (
                logits[1] - logits[0]).abs().max().item()
    rng = np.random.default_rng(0)
    mixed = [rng.integers(1, cfg.vocab_size, n).tolist()
             for n in (3, 9, 5, 17, 2)]
    three = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 11, 3)]

    def serve(model, device, prompts, max_new, **knobs):
        eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=48,
                                              **knobs), device=device)
        reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
                for i, p in enumerate(prompts)]
        check(eng.serve(reqs)["done"], f"phase 4 zamba2 {knobs}: not done")
        return [r.out for r in reqs]

    split = dict(paged=True, block_size=8)
    for quant in (None, "lut4", "nf4p"):
        what = f"phase 4 zamba2 {quant}"
        slab = serve(cpu, "cpu", mixed, 6, quant=quant)
        for knobs in ({}, split):
            check(serve(gpu, dev, mixed, 6, quant=quant, **knobs) == slab,
                  f"{what} {knobs}: card tokens differ from the CPU's slab")
        plain = serve(cpu, "cpu", three, 8, quant=quant)
        for knobs in ({}, split):
            got = serve(gpu, dev, three, 8, quant=quant, spec="self_lut",
                        **knobs)
            check(got == plain, f"{what} self_lut {knobs} on the card: "
                  "tokens differ from plain greedy")
        out[f"{quant or 'f32'} engines"] = "equal"
    emit({"small_hybrid": "reduced f32 zamba2: prefill + decode logits card "
                          "vs cpu (None, lut4, nf4p; codes bitwise); "
                          "engines (slab and split on 3 slots, self_lut on "
                          "both) card == cpu == slab == plain",
          "max_abs_err": out, "rtol": 1e-4, "atol": 1e-4})


def build_hybrid_model(dev):
    """zamba2-1.2b at its published widths, all 38 layers, bf16, random
    weights from seed 0; the request mix (8 prompts of 16-512 tokens)."""
    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config("zamba2-1.2b")
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit({"model": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "hybrid": vars(cfg.hybrid),
          "ssm": vars(cfg.ssm), "vocab": cfg.vocab_size, "dtype": cfg.dtype,
          "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
          "init_s": time.perf_counter() - t0})
    return cfg, model, request_mix(cfg.vocab_size)


def hybrid_phase(dev) -> tuple[dict, dict]:
    """Phase 12: zamba2-1.2b at its published widths (38 Mamba2 layers, 7
    applications of one shared attention + MLP block, bf16, random weights
    from seed 0) serves phase 6's 8 requests (32 new tokens each).  12a:
    quant None, lut4 and nf4p on the slab (each frozen run 125 LUT
    launches a tick, 7 x 7 shared + 38 x 2 Mamba2, all on the tensor-core
    kernel; ``ssd_scan`` once a layer a prefill call; the first tokens
    equal across the three runs; a profile of 4 lut4 ticks by kernel and
    by labelled stage, and of the 8-prompt prefill).  12b: lut4 on the
    split substrate (block 16): tokens bitwise 12a's lut4 run's; then the
    shared-prefix mix with ``prefix_cache`` and ``prefill_chunk=128``:
    at least 7 hits, the pool free after, each warm request's first-token
    logits bitwise a replay of its pieces and within ``WARM_FACTOR`` of
    cold's distance from an f32 copy.  12c: lut4 under ``spec="self_lut",
    spec_k=4`` on the slab and on the split substrate: tokens 12a's lut4
    run's, or the WINDOW_FACTOR rule at the first divergence.  Returns
    (launches, by route)."""
    import torch

    t12 = time.perf_counter()
    launches, tc_total = {}, {}
    cfg, model, prompts = build_hybrid_model(dev)
    check(tick_launches(cfg) == 125,
          f"zamba2: {tick_launches(cfg)} LUT launches a tick, want 125")
    outs, extra = {}, {}
    for quant, kern in ((None, None), ("lut4", "lut_gemm_dc"),
                        ("nf4p", "lut_gemm_dc_res")):
        counts, outs[quant], tc, extra[quant] = serve_once(
            dev, cfg, model, prompts, quant, kern, record=quant == "lut4",
            profile=quant == "lut4", ranges=HYBRID_RANGES)
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    firsts = {q or "bf16": [o[0] for o in out] for q, out in outs.items()}
    check(len({tuple(f) for f in firsts.values()}) == 1,
          f"phase 12a: first (prefill) tokens differ between runs: {firsts}")
    split = dict(paged=True, block_size=16)
    counts, paged, tc, _ = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc", split, [prompts],
        "phase 12b split", profile=False)
    check(paged == outs["lut4"],
          "phase 12b: split-substrate lut4 tokens differ from 12a's slab run")
    add_launches(launches, counts)
    add_launches(tc_total, tc)
    mix = shared_prefix_mix(cfg.vocab_size)
    counts, _, tc, out = substrate_run(
        dev, cfg, model, "lut4", "lut_gemm_dc",
        dict(split, prefix_cache=True, prefill_chunk=128),
        [mix[:1], mix[1:]], "phase 12b split prefix chunked",
        warm_check=True, profile=False)
    check(out["prefix_hits"] >= 7
          and out["prefix_tokens_reused"] >= 7 * SHARED_PREFIX,
          f"phase 12b: {out['prefix_hits']} hits reusing "
          f"{out['prefix_tokens_reused']} tokens")
    add_launches(launches, counts)
    add_launches(tc_total, tc)
    for knobs in ({}, split):
        for total, part in zip((launches, tc_total), spec_run(
                dev, cfg, model, prompts, "lut4", "self_lut", outs["lut4"],
                extra["lut4"],
                f"phase 12c zamba2 self_lut {'split' if knobs else 'slab'}",
                profile=False, knobs=knobs)):
            add_launches(total, part)
    del model, extra
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase12_s": time.perf_counter() - t12})
    return launches, tc_total


#: phase 15: the last training options and the paper's entry points.
#: 15a's models: yi-9b at phase 8's depth and shape, mamba2-1.3b (all 48
#: layers) at phase 13's
OPTION_ARCHS = (("yi-9b", TRAIN_LAYERS), ("mamba2-1.3b", None))
#: 15b's train steps a mode
OPTION_STEPS = 2
#: 15a's timed train steps a policy (the first a warm-up, so 1 steady
#: one), then a profiled one
REMAT_STEPS = 2
#: 15b's modes (yi-9b at depth 8, B 2 x S ``QAT_S``)
QUANT_TRAIN_MODES = ("int8", "int4_dequant", "lut_nf4")


def option_model(dev, arch: str, layers):
    """``arch`` at its published widths (depth cut to ``layers``), bf16,
    random weights from seed 0, trainable; phase 8's chunked attention."""
    from dataclasses import replace

    import torch

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config(arch)
    if layers is not None:
        cfg = replace(cfg, num_layers=layers, attn_impl="chunked")
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
    return cfg, model


def scan_want(cfg, steps: int, wrappers) -> dict:
    """Launches of ``steps`` bf16 train steps: the scan's 2 forward (the
    forward and remat's recompute) and 1 backward a Mamba2 layer a step,
    nothing else of the port's kernels."""
    n = scan_calls(cfg) * steps
    return dict.fromkeys(wrappers, 0) | (
        {"ssd_scan": 2 * n, "ssd_scan_bwd": n} if n else {})


def remat_policy_phase(dev, wrappers) -> dict:
    """Phase 15a: ``remat_policy`` "nothing" against "dots" (selective
    checkpointing: ``mm``/``addmm``/``_int_mm`` outputs saved) at yi-9b's
    full width with depth 8 and mamba2-1.3b's 48 layers, B 2 x S 4096:
    one loss and backward on the same batch under each, the largest
    gradient difference as a share of its leaf's scale (held to
    ``card_vs_cpu.GRAD_REL``; the bitwise-equal leaves counted), and the
    peak memory of that pass; then ``REMAT_STEPS`` timed train steps and
    a profiled one under each (:func:`train_steps`: step wall, tok/s,
    peak GB, device time and the idle share), each policy from a fresh
    AdamW state.  The port's kernels are ctypes calls, not aten ops, so
    "dots" recomputes them too: the scan's launch counts are equal.
    Returns the launches by kernel."""
    from dataclasses import replace

    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.card_vs_cpu import GRAD_REL
    from repro_torch.train.train_step import make_train_step

    launches = {}
    for arch, layers in OPTION_ARCHS:
        cfg, model = option_model(dev, arch, layers)
        data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
        batch = data.batch(REMAT_STEPS + 1, dev)
        runs, grads = {}, {}
        for policy in ("nothing", "dots"):
            pcfg = replace(cfg, remat_policy=policy)
            m = type(model).from_params(pcfg, model.params_tree(),
                                        device=dev).requires_grad_(True)
            # the other policy's gradients off the card while this one runs
            for held in grads.values():
                for i, g in enumerate(held):
                    held[i] = g.cpu()
            for r in runs.values():
                for p in r["model"].parameters():
                    p.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = synced(f"phase 15a {arch} {policy} backward",
                          lambda: m.loss(batch)[0].backward())
            grads[policy] = [p.grad for p in m.parameters()]
            runs[policy] = {"loss_backward_s": time.perf_counter() - t0,
                            "loss_backward_peak_gb":
                            torch.cuda.max_memory_allocated() / 1e9}
            runs[policy]["model"] = m
        worst, bitwise = 0.0, 0
        grads["nothing"] = [g.to(dev) for g in grads["nothing"]]
        for a, b in zip(grads["nothing"], grads["dots"]):
            bitwise += torch.equal(a, b)
            worst = max(worst, ((b.float() - a.float()).abs().max()
                                / a.float().abs().max().clamp_min(1e-30))
                        .item())
        check(worst <= GRAD_REL, f"phase 15a {arch}: dots gradients differ "
              f"from nothing's by {worst} of their scale (> {GRAD_REL})")
        del grads
        models = {p: runs[p].pop("model") for p in runs}
        for m in models.values():           # no gradient held across runs
            for p in m.parameters():
                p.grad = None
        for policy in ("nothing", "dots"):
            m = models.pop(policy)
            opt = AdamW(lr=3e-4)
            state = opt.init(m.params_tree())
            counts, _ = train_steps(
                dev, f"phase 15a {arch} remat {policy}", REMAT_STEPS + 1,
                make_train_step(m.cfg, opt), m, state, data, wrappers,
                scan_want(cfg, REMAT_STEPS + 1, wrappers),
                profile_last=True, extra={"remat_policy": policy,
                                          "layers": cfg.num_layers,
                                          **runs[policy]})
            add_launches(launches, counts)
            del m, state, opt
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase15a": arch, "layers": cfg.num_layers,
              "dots_vs_nothing_grad_err_scaled": worst,
              "bitwise_leaves": bitwise,
              "leaves": sum(1 for _ in model.parameters()), **{
                  f"{p}_{k}": v for p, r in runs.items()
                  for k, v in r.items()}})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def nf4_backward_calls(m: int) -> tuple[list, list]:
    """(M, K, N) of the ``lut_gemm`` calls of one yi-9b layer under
    lut_nf4 in a train step at M rows: (the 7 forward projections, their
    backward's dx over the transposed codes, (M, N, K))."""
    fwd = [(m, k, n) for k, n in LAYER_SHAPES]
    return fwd, [(m, n, k) for _, k, n in fwd]


def nf4_backward_checks(dev) -> dict:
    """Phase 15b's kernel checks at a yi-9b training step's shapes (M = B
    x S = 2048, bf16): at each distinct forward (M, K, N) ``NF4MatmulFn``'s
    forward (a scale-of-ones launch times absmax) bitwise the one-launch
    ``lut_gemm(x, q, CB, absmax)``; at each transposed (M, N, K) the
    backward's dx call ``lut_gemm(g ⊙ absmax, qᵀ, CB, 1)`` on the kernel
    ``route`` names, against ``lut_gemm_ref`` at the kernel's tolerance
    at unit output scale (1e-4 of max(1, max |plain|)), timed device-only (:func:`graph_ms`) and by events beside its bound
    (the bf16 operations or the bytes) and the plain version's time.
    These launches are outside the counted runs."""
    import torch

    from repro_torch.core.lut import NF4_CODEBOOK
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref
    from repro_torch.kernels.lut_gemm.ops import (NF4MatmulFn,
                                                  codebook_quantize)

    m = TRAIN_B * QAT_S
    gen = torch.Generator(device=dev).manual_seed(15)
    cb = torch.as_tensor(NF4_CODEBOOK, device=dev)
    fwd, bwd = nf4_backward_calls(m)
    rows, routes = [], Counter()
    for (_, k, n) in sorted(set(fwd)):
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).bfloat16()
        codes, absmax = codebook_quantize(w, cb)
        x = torch.randn((m, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        with torch.no_grad():
            one = synced(f"phase 15b lut_gemm ({m}, {k}, {n})",
                         lambda: lg.lut_gemm(x, codes, cb, absmax))
            got = synced(f"phase 15b NF4MatmulFn ({m}, {k}, {n})",
                         lambda: NF4MatmulFn.apply(x, codes, absmax))
        check(torch.equal(one, got), f"phase 15b ({m}, {k}, {n}): "
              "NF4MatmulFn's forward is not lut_gemm's bitwise")
        g = torch.randn((m, n), generator=gen, device=dev)
        gs = (g * absmax).bfloat16().contiguous()
        qt = codes.t().contiguous()
        ones = torch.ones(k, device=dev)
        before = (lg.lut_gemm.launches_tc, lg.lut_gemm.launches_wgmma)
        dx = synced(f"phase 15b backward lut_gemm ({m}, {n}, {k})",
                    lambda: lg.lut_gemm(gs, qt, cb, ones))
        ran = {(1, 0): "tc", (0, 1): "wgmma", (0, 0): "fma"}[
            (lg.lut_gemm.launches_tc - before[0],
             lg.lut_gemm.launches_wgmma - before[1])]
        check(ran == lg.route(m, n, k, gs.dtype, True),
              f"phase 15b backward ({m}, {n}, {k}) ran on {ran}")
        routes[ran] += 1
        plain = ref.lut_gemm_ref(gs, qt, cb, ones)
        # the kernel's 1e-4 holds at unit output scale: these sums of up
        # to 11,008 products reach ~15, and the tensor cores' f32
        # accumulation drifts with the sum's size
        scale = max(1.0, plain.abs().max().item())
        err = (dx - plain).abs().max().item()
        check(err <= lg.KERNEL_ATOL * scale, f"phase 15b backward ({m}, "
              f"{n}, {k}): {err} off lut_gemm_ref at output scale {scale}")
        bound, by = bound_ms(m, n, k, 2, 64, vec_bytes=4)
        rows.append({"m": m, "k": n, "n": k, "route": ran,
                     "max_abs_err": err, "output_scale": scale,
                     "device_ms": graph_ms(
                         lambda i: lg.lut_gemm(gs, qt, cb, ones), 5),
                     "ms": cuda_ms(lambda i: lg.lut_gemm(gs, qt, cb, ones),
                                   10),
                     "plain_ms": cuda_ms(
                         lambda i: ref.lut_gemm_ref(gs, qt, cb, ones), 5),
                     "bound_ms": bound, "bound_by": by})
    layer = Counter((mm, kk, nn) for mm, kk, nn in bwd)
    by_shape = {(r["m"], r["k"], r["n"]): r for r in rows}
    summary = {"layer_backward_device_ms": sum(
        by_shape[s]["device_ms"] * c for s, c in layer.items()),
        "layer_backward_bound_ms": sum(
        by_shape[s]["bound_ms"] * c for s, c in layer.items())}
    emit({"kernel_check": "phase 15b lut_nf4 backward shapes",
          "calls": rows, "routes": dict(routes), **summary,
          "tolerance": [lg.KERNEL_RTOL, lg.KERNEL_ATOL]})
    return {"calls": rows, **summary}


def quant_train_phase(dev, wrappers) -> tuple[dict, dict]:
    """Phase 15b: yi-9b at its full width with depth 8, B 2 x S
    ``QAT_S``, ``OPTION_STEPS`` train steps each under int8, int4_dequant
    and lut_nf4 (:func:`train_steps`: step wall, tok/s, peak GB); under
    lut_nf4 every projection launches ``lut_gemm`` three times a step
    (the forward and remat's recompute, 2 x 56; the backward's dx over
    the transposed codes, 56: ``NF4MatmulFn.backward_launches``), all on
    the kernel ``route`` names (M = 2048: ``lut_gemm_wgmma.cu``); int8
    and int4_dequant launch no kernel of the port (``torch._int_mm`` and
    cuBLAS, as JAX's products run outside any Pallas kernel).  Before
    them, :func:`nf4_backward_checks` (the reduced f32 card == CPU checks
    of each mode are phase 4's, :func:`small_options_phase`).  Returns
    (launches by kernel, lut_gemm's by route and direction)."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.lut_gemm.lut_gemm import route
    from repro_torch.kernels.lut_gemm.ops import NF4MatmulFn
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step

    checks = nf4_backward_checks(dev)
    cfg, model = option_model(dev, "yi-9b", TRAIN_LAYERS)
    data = SyntheticLM(cfg.vocab_size, QAT_S, TRAIN_B, seed=0)
    m_rows = TRAIN_B * QAT_S
    launches, by_route = {}, Counter()
    for mode in QUANT_TRAIN_MODES:
        qcfg = replace(cfg, quant=QuantConfig(mode=mode))
        m = type(model).from_params(qcfg, model.params_tree(),
                                    device=dev).requires_grad_(True)
        opt = AdamW(lr=3e-4)
        state = opt.init(m.params_tree())
        per = OPTION_STEPS * projections(cfg) * cfg.num_layers * (
            mode == "lut_nf4")
        want = dict.fromkeys(wrappers, 0) | {"lut_gemm": 3 * per}
        fwd, bwd = nf4_backward_calls(m_rows)
        routes = Counter(route(*s, torch.bfloat16, True) for s in fwd + fwd
                         + bwd)
        NF4MatmulFn.backward_launches = 0
        counts, _ = train_steps(
            dev, f"phase 15b yi-9b {mode}", OPTION_STEPS,
            make_train_step(qcfg, opt), m, state, data, wrappers, want,
            extra={"quant": mode, "layers": cfg.num_layers})
        got_bwd = NF4MatmulFn.backward_launches
        got_wgmma = wrappers["lut_gemm"].launches_wgmma
        got_tc = wrappers["lut_gemm"].launches_tc
        check(got_bwd == per, f"phase 15b {mode}: {got_bwd} backward "
              f"lut_gemm launches, want {per}")
        want_wgmma = routes["wgmma"] * OPTION_STEPS * cfg.num_layers * (
            mode == "lut_nf4")
        check(got_wgmma == want_wgmma and got_tc == 0,
              f"phase 15b {mode}: lut_gemm on wgmma {got_wgmma}, tc "
              f"{got_tc}; route says {dict(routes)} a layer a step")
        add_launches(launches, counts)
        if mode == "lut_nf4":
            by_route.update({"forward": counts["lut_gemm"] - got_bwd,
                             "backward": got_bwd, "wgmma": got_wgmma,
                             "tc": got_tc,
                             "fma": counts["lut_gemm"] - got_wgmma - got_tc})
            emit({"phase15b_lut_nf4_launches": dict(by_route),
                  "backward_calls_a_layer": [list(s) for s in bwd]})
        del m, state, opt
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    by_route["checks"] = checks
    return launches, dict(by_route)


def paper_calls(label: str) -> dict:
    """(M, K, N) of every kernel call of one phase-15c entry point, by
    wrapper: fig13's MLP (512 rows, 8 -> 16 -> 1; QAT on ``luna_mm``, the
    PTQ columns on ``lut_gemm_dc`` and ``lut_gemm_dc_res``), the paper
    tables' Fig 13 net (8 rows, 16 -> 32 -> 4) and the quickstart's §3
    (8 x 64 x 16), §4 (reduced yi-9b's projections at B 2 x S 32 on
    ``luna_mm``) and §5 (its lut4 engine's decode ticks, M = max_batch 2,
    on ``lut_gemm_dc``)."""
    from repro_torch.models.attention import gqa_shapes
    from repro_torch.models.mlp import mlp_shapes
    from repro_torch.models.registry import get_config

    if label == "fig13":
        mlp = [(512, 8, 16), (512, 16, 1)]
        return {"luna_mm": mlp, "lut_gemm_dc": mlp, "lut_gemm_dc_res": mlp}
    if label == "paper_tables":
        return {"luna_mm": [(8, 16, 32), (8, 32, 4)]}
    cfg = get_config("yi-9b").reduced()
    proj = sorted(set(gqa_shapes(cfg).values()) | set(
        mlp_shapes(cfg).values()))
    return {"luna_mm": [(8, 64, 16)] + [(64, k, n) for k, n in proj],
            "lut_gemm_dc": [(2, k, n) for k, n in proj]}


def paper_kernel_checks(dev, label: str) -> dict:
    """Phase 15c's kernels at every (M, K, N) :func:`paper_calls` gives
    ``label``, against their plain versions on the same inputs (these
    launches are outside the counted runs): ``luna_mm`` in the three LUNA
    modes bitwise, on the kernel ``takes_tc`` names; ``lut_gemm_dc`` (a
    ``quantize_weight`` "lut_dc" weight) and ``lut_gemm_dc_res`` ("nf4_dc",
    unpruned and pruned at ``NF4P_PRUNE_THRESHOLD``) with f32 x, as the
    entry points give it, at the tolerance of
    ``kernels/lut_gemm/lut_gemm.py``, on the kernel ``takes_tc`` names.
    Returns the shapes and the largest errors."""
    import torch

    from repro_torch.core.quant import NF4P_PRUNE_THRESHOLD, quantize_weight
    from repro_torch.kernels.luna_mm import luna_mm as lm
    from repro_torch.kernels.luna_mm.ref import luna_mm_ref
    from repro_torch.kernels.lut_gemm import lut_gemm as lg
    from repro_torch.kernels.lut_gemm import ref

    gen = torch.Generator(device=dev).manual_seed(153)
    calls = paper_calls(label)
    out = {"shapes": {k: [list(s) for s in v] for k, v in calls.items()}}
    for m, k, n in calls.get("luna_mm", []):
        for mode in ("opt_dc", "approx_dc2", "approx_dc"):
            y = torch.randint(0, 16, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(0, 16, (k, n), generator=gen, device=dev,
                              dtype=torch.int8)
            tc0 = lm.luna_mm.launches_tc
            got = synced(f"phase 15c luna_mm {mode} ({m}, {k}, {n})",
                         lambda: lm.luna_mm(y, w, mode))
            check(lm.luna_mm.launches_tc - tc0
                  == lm.takes_tc(m, k, n, "row", True),
                  f"phase 15c luna_mm ({m}, {k}, {n}): not on the kernel "
                  "takes_tc names")
            check(torch.equal(got, luna_mm_ref(y, w, mode)),
                  f"phase 15c luna_mm {mode} ({m}, {k}, {n}) is not "
                  "bitwise its plain version")
    if "luna_mm" in calls:
        out["luna_mm"] = "bitwise"
    dc = [("lut_gemm_dc", "lut_dc", None)] + [
        ("lut_gemm_dc_res", "nf4_dc", p) for p in (None,
                                                   NF4P_PRUNE_THRESHOLD)]
    for name, kernel, prune in dc:
        for m, k, n in calls.get(name, []):
            x = torch.randn((m, k), generator=gen, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev) * 0.3
            qw = quantize_weight(w, kernel, prune)
            tabs = ((qw.hi_tab, qw.lo_tab) if kernel == "lut_dc"
                    else (qw.hi_tab, qw.lo_tab, qw.residual))
            wrap = getattr(lg, name)
            plain = getattr(ref, f"{name}_ref")
            tc0 = wrap.launches_tc
            got = synced(f"phase 15c {name} ({m}, {k}, {n})",
                         lambda: wrap(x, qw.codes, *tabs, qw.zero_point,
                                      qw.scale))
            check(wrap.launches_tc - tc0 == lg.takes_tc(m, k, n, x.dtype,
                                                        True),
                  f"phase 15c {name} ({m}, {k}, {n}): not on the kernel "
                  "takes_tc names")
            want = plain(x, qw.codes, *tabs, qw.zero_point, qw.scale)
            torch.testing.assert_close(got, want, rtol=lg.KERNEL_RTOL,
                                       atol=lg.KERNEL_ATOL)
            err = (got - want).abs().max().item()
            out[f"{name}_max_abs_err"] = max(
                out.get(f"{name}_max_abs_err", 0.0), err)
    out["tolerance"] = [lg.KERNEL_RTOL, lg.KERNEL_ATOL]
    return out


def paper_phase(dev, wrappers) -> tuple[dict, dict]:
    """Phase 15c: the paper's entry points on the card, each run with the
    launch counts set to 0 just before and read just after; before each,
    :func:`paper_kernel_checks` holds its kernels at its shapes:
    ``examples/fig13_nn_accuracy_torch.main()`` (QAT on ``luna_mm``, 3
    modes x (300 steps x 2 + 2) launches, K = 8 and N = 1 on the dp4a
    kernel; the PTQ columns on ``lut_gemm_dc`` (2) and ``lut_gemm_dc_res``
    (4), f32 x on ``lut_gemm.cu``; JAX's three bounds and ptq_lut4 ==
    ptq_int4 asserted inside), ``tools/paper_tables_torch``'s
    ``ALL`` (Fig 13 on ``luna_mm``: 3 modes x (100 x 2 + 6 x 2)) and
    ``examples/quickstart_torch.main()`` (``luna_mm`` at M = 8 and under
    reduced yi-9b's model-level modes; the lut4 engine on
    ``lut_gemm_dc``).  Returns (launches by kernel, by tensor-core
    route)."""
    import importlib.util

    def load(rel, name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    launches, tc_total = {}, {}
    runs = (("fig13", "examples/fig13_nn_accuracy_torch.py",
             {"luna_mm": 3 * (300 * 2 + 2), "lut_gemm_dc": 2,
              "lut_gemm_dc_res": 4}),
            ("paper_tables", "tools/paper_tables_torch.py",
             {"luna_mm": 3 * (100 * 2 + 6 * 2)}),
            ("quickstart", "examples/quickstart_torch.py", None))
    for label, rel, want in runs:
        mod = load(rel, f"{label}_phase15")
        kernel_check = paper_kernel_checks(dev, label)
        reset_counters(wrappers)
        t0 = time.perf_counter()
        out = synced(f"phase 15c {label}",
                     lambda: mod.main(["--device", str(dev)]))
        wall = time.perf_counter() - t0
        counts, tc = read_counters(wrappers)
        if want is None:          # the quickstart: its engine's ticks vary
            check(counts["luna_mm"] > 3 and counts["lut_gemm_dc"] > 0
                  and all(v == 0 for k, v in counts.items()
                          if k not in ("luna_mm", "lut_gemm_dc")),
                  f"phase 15c quickstart: launches {counts}")
        else:
            full = dict.fromkeys(wrappers, 0) | want
            check(counts == full, f"phase 15c {label}: launches {counts}, "
                  f"want {full}")
            check(tc["luna_mm"] == tc["lut_gemm_dc"] == tc[
                "lut_gemm_dc_res"] == 0, f"phase 15c {label}: tensor-core "
                  f"launches {tc} (K = 8 / 16, N = 1 / 4 and f32 x take "
                  "the other kernels)")
        report = {}
        if label == "fig13":
            report = {k: v for k, v in out.items() if k != "nf4p_table"}
            report["bounds"] = {
                "PTQ_MAE_BOUND": mod.PTQ_MAE_BOUND,
                "NF4_DC_VS_DIRECT_TOL": mod.NF4_DC_VS_DIRECT_TOL,
                "NF4P_MAE_DELTA_BOUND": mod.NF4P_MAE_DELTA_BOUND}
            report["ptq_lut4_minus_int4"] = out["ptq_lut4"] - out["ptq_int4"]
            report["ptq_lut4_equals_int4"] = out["ptq_lut4"] == out["ptq_int4"]
        elif label == "paper_tables":
            report = {"fig13": out["fig13"],
                      "fig16_opt_dc": out["fig16"]["opt_dc"][
                          "area_vs_conventional"],
                      "fig15_share": out["fig15"]["multiplier_share"]}
        else:
            report = {"rel_err": out["rel_err"], "loss": out["loss"]}
        emit({"phase15c": label, "wall_s": wall, "launches": counts,
              "launches_tc": tc, "kernel_check": kernel_check, **report})
        add_launches(launches, counts)
        add_launches(tc_total, tc)
    return launches, tc_total


def small_options_phase(dev) -> dict:
    """Phase 4, the last training options: reduced f32 yi-9b trained on
    the card against the CPU under int8, int4_dequant and lut_nf4 (loss,
    every gradient at ``card_vs_cpu.QUANT_TRAIN_REL``, one step; lut_nf4's
    42 ``lut_gemm`` launches, 14 of them the backward's), ``NF4MatmulFn``
    on the card against its plain version in bf16 and f32, and
    ``remat_policy="dots"`` card == CPU and == "nothing" on the card."""
    import torch

    from repro_torch.train import card_vs_cpu as cc

    out = {mode: cc.quant_training_card_vs_cpu(dev, mode)
           for mode in cc.QUANT_TRAIN_REL}
    out["NF4MatmulFn bf16"] = cc.nf4_backward_card_vs_plain(dev)
    out["NF4MatmulFn f32"] = cc.nf4_backward_card_vs_plain(
        dev, dtype=torch.float32)
    out["remat dots"] = cc.remat_dots_card_vs_cpu(dev)
    emit({"small_reference": "reduced f32 yi-9b trained under int8, "
                             "int4_dequant, lut_nf4 and remat "
                             "dots: card vs cpu; NF4MatmulFn card vs plain",
          "max_err": out, "grad_rel": cc.QUANT_TRAIN_REL, "tol": cc.TOL})
    return out


def options_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 15 (15a :func:`remat_policy_phase`, 15b
    :func:`quant_train_phase`, 15c :func:`paper_phase`); prints its
    seconds.  Returns (launches by kernel, by tensor-core route, lut_gemm's
    15b launches by direction and route with its backward's checks)."""
    import torch

    t15 = time.perf_counter()
    wrappers = kernel_wrappers()
    launches = remat_policy_phase(dev, wrappers)
    t15a = time.perf_counter() - t15
    counts, nf4 = quant_train_phase(dev, wrappers)
    add_launches(launches, counts)
    t15b = time.perf_counter() - t15 - t15a
    counts, tc = paper_phase(dev, wrappers)
    add_launches(launches, counts)
    tc["lut_gemm_wgmma"] = tc.get("lut_gemm_wgmma", 0) + nf4["wgmma"]
    tc["lut_gemm"] = tc.get("lut_gemm", 0) + nf4["tc"]
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase15_s": time.perf_counter() - t15, "15a_s": t15a,
          "15b_s": t15b, "15c_s": time.perf_counter() - t15 - t15a - t15b,
          "launches": launches})
    return launches, tc, nf4


#: phase 16: the serving runs on a one-rank mesh of each model: (label,
#: decode_attn_precision, EngineConfig knobs, profiled).  MLA has no
#: grouped form.
MESH_RUNS = {
    "yi-9b": [("sharded f32", "f32", {}, False),
              ("sharded bf16_grouped", "bf16_grouped", {}, True),
              ("paged bf16_grouped", "bf16_grouped",
               dict(paged=True, block_size=16), False)],
    "deepseek-v2-lite-16b": [("sharded", "f32", {}, False),
                             ("paged sharded", "f32",
                              dict(paged=True, block_size=16), False)]}
#: the decode attention's profile ranges (:data:`MOE_RANGES`' form): the
#: dense SDPA and the sharded decode, each call's kernels
ATTN_RANGES = {
    "attn.sdpa": ("repro_torch.models.attention", "sdpa"),
    "attn.sharded_gqa_decode": ("repro_torch.serve.decode_attention",
                                "sharded_gqa_decode")}
#: phase 16c: the grad-compressed steps of phase 8's model and shape
MESH_TRAIN_STEPS = 2
#: phase 16d: the mesh step against the no-mesh step: phase 15a's models
#: (yi-9b at phase 8's depth, mamba2-1.3b's 48 layers) at B 2 x S 4096;
#: then the elastic round trip's reduced run, ELASTIC_STEPS steps of
#: (ELASTIC_B, ELASTIC_S), preempted after its first
MESH_STEP_ARCHS = OPTION_ARCHS
ELASTIC_STEPS, ELASTIC_B, ELASTIC_S = 4, 4, 64


def one_rank_mesh():
    """A context: a one-rank NCCL group joined through a file store in a
    temporary directory (no TCP port), with a timeout, and
    ``make_host_mesh(model=1)`` over it; the group destroyed on exit."""
    import contextlib
    import datetime
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    @contextlib.contextmanager
    def ctx():
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group(
                "nccl", init_method=f"file://{d}/rdv", world_size=1, rank=0,
                timeout=datetime.timedelta(seconds=120))
            try:
                yield make_host_mesh(model=1)
            finally:
                dist.destroy_process_group()
    return ctx()


def mesh_counters() -> dict:
    """The sharded decode's counters (``calls`` attributes)."""
    from repro_torch.serve import decode_attention as da
    return {"sharded_gqa_decode": da.sharded_gqa_decode,
            "sharded_mla_decode": da.sharded_mla_decode,
            "all_reduce": da.all_reduce}


def mesh_serve(dev, cfg, model, prompts, mesh, ref, sub: str
               ) -> tuple[dict, dict]:
    """Phase 16a/16b on one model: each run of :data:`MESH_RUNS` serves
    phase 6's 8 requests (lut4, max_batch 8, max_seq 1024) through
    ``Engine.serve()`` under ``activation_sharding(mesh)``.  Checks: the
    sharded decode called once a layer a decode tick, 3 all-reduces a
    call, the other sharded function never (a run that took the dense
    path fails); each request's tokens equal ``ref``'s (the dense lut4
    run's) or pass :func:`window_rule` at their first divergence (the
    dense run's top-two margin there within ``WINDOW_FACTOR`` times the
    two runs' logit distance).  Returns (launches, by tensor-core
    route)."""
    from dataclasses import replace

    from repro_torch.parallel.act_sharding import activation_sharding

    fn = "sharded_mla_decode" if cfg.mla else "sharded_gqa_decode"
    launches, tc_total, attn = {}, {}, {}
    for label, precision, knobs, profiled in MESH_RUNS[cfg.name]:
        scfg = replace(cfg, decode_attn="sharded",
                       decode_attn_precision=precision)
        smodel = type(model).from_params(scfg, model.params_tree(),
                                         device=dev)
        with activation_sharding(mesh):
            counts, out, tc, extra = serve_once(
                dev, scfg, smodel, prompts, "lut4", "lut_gemm_dc",
                record=True, profile=profiled, ranges=ATTN_RANGES,
                knobs=knobs, counted=mesh_counters(),
                label=f"phase {sub} {label}")
        add_launches(launches, counts)
        add_launches(tc_total, tc)
        calls = cfg.num_layers * extra["ticks"]
        want = {"sharded_gqa_decode": 0, "sharded_mla_decode": 0,
                fn: calls, "all_reduce": 3 * calls}
        check(extra["calls"] == want,
              f"phase {sub} {label}: sharded calls {extra['calls']}, want "
              f"{want}")
        rules = [window_rule(i, out[i], ref["tokens"][i], extra["logits"],
                             ref["logits"]) for i in range(len(prompts))]
        check(all(r["equal"] or r.get("passed") for r in rules),
              f"phase {sub} {label}: tokens outside the window rule: "
              f"{[r for r in rules if not r['equal']]}")
        if profiled:
            p = extra["profile"]
            attn[label] = dict(tick_profile(p), attention_ms=p[
                "ranges_ms"]["attn.sharded_gqa_decode"], nccl_ms=p[
                "nccl_ms"], nccl_kernels=p["nccl_kernels"])
        emit({"phase16": sub, "run": label, "model": cfg.name,
              "calls": extra["calls"], "decode_ticks": extra["ticks"],
              "equal_requests": sum(r["equal"] for r in rules),
              "first_divergences": [r for r in rules if not r["equal"]],
              "decode_tok_s": extra["decode_tok_s"]})
        del smodel, extra
        gc.collect()
    if attn:
        p = ref["profile"]
        emit({"phase16": sub, "attention_per_4_ticks": dict(attn, dense=dict(
            tick_profile(p), attention_ms=p["ranges_ms"]["attn.sdpa"]))})
    return launches, tc_total


def tick_profile(p: dict) -> dict:
    """A decode profile's (:func:`profile_decode`) tick wall, device ms a
    tick and idle share."""
    dev_ms = p["device_ms"]
    return {"tick_wall_ms": p["wall_ms"] / p["ticks"],
            "device_ms_tick": dev_ms / p["ticks"]
            if not isinstance(dev_ms, str) else dev_ms,
            "device_idle_share": p["device_idle_share"]}


#: phase 16a's check of the grouped partials, card against CPU: max
#: |diff| over max |CPU value| of m, l and o (f32 accumulation both: the
#: card's bmm with f32 output on the tensor cores, whose f32 accumulation
#: truncates, summing up to 1,024 columns; the CPU's on operands cast to
#: f32).  A first reading put o at 1.1e-5; P's bf16 rounding, the grouped
#: form's one difference from the f32 form, moves o by ~1e-3
GROUPED_REL = 1e-4


def grouped_partials_check(dev) -> dict:
    """The bf16_grouped partials (``_gqa_partials``: ``torch.bmm`` with
    ``out_dtype=torch.float32`` on the card) at a yi-9b decode tick's
    shapes (B 8, H 32 on 4 KV heads of 128, 1,024 columns, each row valid
    up to its own depth), bf16 operands, against the same function on the
    CPU (both operands cast to f32) within ``GROUPED_REL``; and the f32
    form on the card beside it (its distance from the grouped form: P's
    rounding)."""
    import torch

    from repro_torch.serve.decode_attention import _gqa_partials

    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v = (torch.randn(s, device=dev, generator=gen).to(torch.bfloat16)
               for s in ((8, 1, 32, 128), (8, 1024, 4, 128),
                         (8, 1024, 4, 128)))
    depth = torch.tensor([437, 331, 269, 149, 167, 35, 52, 23],
                         device=dev) + 16
    ok = (torch.arange(1024, device=dev)[None, None, :]
          <= depth[:, None, None])
    kw = dict(g=8, sm_scale=1.0 / 128 ** 0.5)
    card = _gqa_partials(q, k, v, ok, grouped_bf16=True, **kw)
    cpu = _gqa_partials(q.cpu(), k.cpu(), v.cpu(), ok.cpu(),
                        grouped_bf16=True, **kw)
    f32 = _gqa_partials(q, k, v, ok, grouped_bf16=False, **kw)
    rel = [((a.cpu() - b).abs().max() / b.abs().max()).item()
           for a, b in zip(card, cpu)]
    form = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(f32, card)]
    check(max(rel) <= GROUPED_REL,
          f"phase 16a: grouped partials card vs CPU {rel} > {GROUPED_REL}")
    out = {"phase16": "16a", "grouped_partials_card_vs_cpu": rel,
           "f32_form_vs_grouped": form, "tol": GROUPED_REL}
    emit(out)
    return out


def mesh_collectives(dev, mesh) -> None:
    """Phase 16c: ``quantized_psum`` on the one-rank group against
    ``_q8``'s round trip (bitwise); then ``MESH_TRAIN_STEPS`` of phase 8's
    step (yi-9b at depth ``TRAIN_LAYERS``, B 2 x S 4096) through the mesh
    step (the model sharded on ``mesh``) with ``grad_compression=True``:
    step 1's loss bitwise the uncompressed no-mesh loss and backward's on
    the same params and batch, and the gradients it hands AdamW bitwise
    ``compress_grads_int8`` of that backward's."""
    from dataclasses import replace

    import torch

    import repro_torch.train.train_step as ts
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.parallel.collectives import (_roundtrip_q8,
                                                  compress_grads_int8,
                                                  quantized_psum)
    from repro_torch.parallel.fsdp import local_tree, shard_model
    from repro_torch.tree import leaves

    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(4096, 4096, device=dev, generator=gen)
    got = quantized_psum(x, mesh.groups["model"])
    check(torch.equal(got, _roundtrip_q8(x)),
          "phase 16c: quantized_psum on one rank is not _q8's round trip")
    psum_ms = cuda_ms(lambda i: quantized_psum(x, mesh.groups["model"]),
                      10)
    # the host's cost of one all-reduce call on the one-rank group (the
    # sharded decode makes 3 a layer), at a combine's (B, H, dh) size
    from repro_torch.serve.decode_attention import all_reduce
    o = torch.zeros(8, 32, 128, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        all_reduce(o, torch.distributed.ReduceOp.SUM, mesh.groups["model"])
    torch.cuda.synchronize()
    all_reduce_us = (time.perf_counter() - t0) * 1e3

    cfg = replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS,
                  attn_impl="chunked")
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_(True)
    batch = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0).batch(
        0, dev)
    loss0, _ = model.loss(batch)
    loss0.backward()
    flat = leaves(model.params_tree())
    plain = [p.grad for p in flat]
    for p in flat:
        p.grad = None
    shard_model(model, mesh)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(1, MESH_TRAIN_STEPS))
    state = opt.init(local_tree(model))
    calls = []
    compress = ts.compress_grads_int8

    def recorded(grads, *mesh_arg):
        calls.append((grads, compress(grads, *mesh_arg)))
        return calls[-1][1]
    ts.compress_grads_int8 = recorded
    try:
        step = ts.make_train_step(cfg, opt, mesh, grad_compression=True)
        walls, losses = [], []
        for i in range(MESH_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(model, state, batch if i == 0 else
                               SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                           seed=0).batch(i, dev))["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        ts.compress_grads_int8 = compress
    raw, out = calls[0]
    check(len(calls) == MESH_TRAIN_STEPS, f"phase 16c: {len(calls)} "
          f"compressions in {MESH_TRAIN_STEPS} steps")
    check(torch.equal(losses[0], loss0.detach()),
          f"phase 16c: step 1's loss {losses[0].item()} is not the "
          f"uncompressed step's {loss0.item()}")
    same_raw = all(torch.equal(a, b) for a, b in zip(leaves(raw), plain))
    want = compress_grads_int8(plain)
    check(all(torch.equal(a, b) for a, b in zip(leaves(out), want)),
          "phase 16c: step 1's gradients are not compress_grads_int8 of "
          "the uncompressed step's")
    moved = sum(not torch.equal(a, b) for a, b in zip(leaves(raw),
                                                      leaves(out)))
    emit({"phase16": "16c", "mesh_step": True,
          "quantized_psum_bitwise_roundtrip": True,
          "quantized_psum_ms_4096x4096": psum_ms,
          "all_reduce_host_us_8x32x128": all_reduce_us,
          "steps": MESH_TRAIN_STEPS, "loss": [v.item() for v in losses],
          "step_s": walls, "step1_loss_bitwise_uncompressed": True,
          "step1_raw_grads_bitwise_uncompressed": same_raw,
          "step1_grads_bitwise_compressed_uncompressed": True,
          "leaves": len(plain), "leaves_changed_by_compression": moved})
    check(moved > 0, "phase 16c: the compression changed no gradient")
    del model, state, opt, plain, calls, raw, out, want
    gc.collect()
    torch.cuda.empty_cache()


def recording_adamw(**kw):
    """An AdamW whose ``update`` keeps a copy of the gradients it gets
    (``.seen``; phase 16d's comparison)."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves

    class Recording(AdamW):
        def update(self, grads, state, params, **kwargs):
            self.seen = [g.detach().clone() for g in leaves(grads)]
            return super().update(grads, state, params, **kwargs)
    return Recording(**kw)


def mesh_step_run(dev, cfg, model, batch, mesh, wrappers) -> dict:
    """One step of ``model`` through ``make_train_step`` (on ``mesh``:
    the model sharded first), every launch count and the mesh's
    collectives set to 0 just before it and read just after.  Returns the
    loss, the gradients AdamW got, the step's wall, peak GB and the GB
    already held when it started (the model, its AdamW state, and in the
    mesh run the no-mesh run's params and gradients kept for the
    comparison), launches and collectives."""
    import torch

    from repro_torch.parallel import fsdp
    from repro_torch.train.train_step import make_train_step

    if mesh is not None:
        fsdp.shard_model(model, mesh)
    opt = recording_adamw(lr=3e-4)
    state = opt.init(fsdp.local_tree(model))
    step = make_train_step(cfg, opt, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters(wrappers)
    fsdp.counts.clear()
    t0 = time.perf_counter()
    metrics = step(model, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, _ = read_counters(wrappers)
    out = {"loss": metrics["loss"], "grads": opt.seen, "wall_s": wall,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_before_gb": held / 1e9,
           "launches": counts, "collectives": dict(fsdp.counts)}
    del state, opt
    return out


def elastic_round_trip(dev, mesh) -> dict:
    """Phase 16d's elastic round trip on reduced yi-9b (bf16): a straight
    ``ELASTIC_STEPS``-step no-mesh ``Trainer`` run; the mesh ``Trainer``
    preempted after step 1 (its checkpoint written through the mesh's
    gathers) and a no-mesh ``Trainer`` resuming it; and the reverse.
    Each round trip's losses and final params bitwise the straight
    run's."""
    import tempfile

    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = get_config("yi-9b").reduced()
    data = SyntheticLM(cfg.vocab_size, ELASTIC_S, ELASTIC_B, seed=0)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        def run(name, where, stop_first=False):
            tcfg = TrainerConfig(total_steps=ELASTIC_STEPS, ckpt_every=2,
                                 log_every=ELASTIC_STEPS,
                                 ckpt_dir=os.path.join(d, name))
            t = (Trainer(cfg, tcfg, mesh) if where == "mesh"
                 else Trainer(cfg, tcfg, device=dev))
            t._stop = stop_first
            model, hist = t.run(data, install_signals=False)
            with torch.no_grad():
                params = [p.detach().clone()
                          for p in leaves(model.params_tree())]
            return hist, params

        straight, final = run("straight", "none")
        for first, then in (("mesh", "none"), ("none", "mesh")):
            name = f"{first}_then_{then}"
            h1, _ = run(name, first, stop_first=True)
            h2, params = run(name, then)
            same = (h1 + h2 == straight and len(params) == len(final)
                    and all(torch.equal(a, b)
                            for a, b in zip(params, final)))
            check(same, f"phase 16d: {name}'s losses {h1 + h2} or params "
                  f"are not the straight run's {straight}")
            out[name] = {"losses": h1 + h2, "resumed_at": len(h1),
                         "bitwise": same}
    out["straight_losses"] = straight
    return out


def mesh_train_phase(dev, mesh) -> dict:
    """Phase 16d: for each of :data:`MESH_STEP_ARCHS`, the no-mesh step
    and the mesh step (:func:`mesh_step_run`) from the same weights
    (seed 0) on the same batch: loss, every gradient AdamW gets and every
    updated parameter bitwise; the launches by kernel equal (mamba2: 2
    ``ssd_scan`` and 1 ``ssd_scan_bwd`` a layer) and the mesh step's
    gathers and gradient reductions issued.  Then
    :func:`elastic_round_trip`.  Returns the mesh steps' launches."""
    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.parallel.fsdp import local_tree
    from repro_torch.tree import leaves

    t16d = time.perf_counter()
    wrappers = kernel_wrappers()
    launches = {}
    for arch, layers in MESH_STEP_ARCHS:
        cfg, plain = option_model(dev, arch, layers)
        batch = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B,
                            seed=0).batch(0, dev)
        ref = mesh_step_run(dev, cfg, plain, batch, None, wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        _, model = option_model(dev, arch, layers)
        got = mesh_step_run(dev, cfg, model, batch, mesh, wrappers)
        want = scan_want(cfg, 1, wrappers)
        check(ref["launches"] == want and got["launches"] == want,
              f"phase 16d {arch}: launches {got['launches']} (no mesh "
              f"{ref['launches']}), want {want}")
        check(got["collectives"].get("gather", 0) > 0
              and got["collectives"].get("grad", 0) > 0,
              f"phase 16d {arch}: the mesh step issued "
              f"{got['collectives']}")
        loss_same = torch.equal(got["loss"], ref["loss"])
        grads_same = sum(torch.equal(a, b)
                         for a, b in zip(got["grads"], ref["grads"]))
        with torch.no_grad():
            params_same = sum(torch.equal(a, b) for a, b in zip(
                leaves(local_tree(model)), leaves(plain.params_tree())))
        n = len(ref["grads"])
        check(loss_same and grads_same == n and params_same == n,
              f"phase 16d {arch}: the mesh step is not the no-mesh step "
              f"bitwise (loss {loss_same}, gradients {grads_same} of {n}, "
              f"params {params_same} of {n})")
        add_launches(launches, got["launches"])
        emit({"phase16": "16d", "model": cfg.name,
              "layers": cfg.num_layers, "batch": [TRAIN_B, TRAIN_S],
              "loss": got["loss"].item(), "bitwise_loss": loss_same,
              "bitwise_grads": grads_same, "bitwise_params": params_same,
              "leaves": n, **{f"{k}{sfx}": r[k] for r, sfx in
                              ((got, ""), (ref, "_no_mesh"))
                              for k in ("wall_s", "peak_gb",
                                        "held_before_gb", "launches")},
              "collectives": got["collectives"]})
        del plain, model, ref, got, batch
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase16": "16d elastic", **elastic_round_trip(dev, mesh),
          "16d_s": time.perf_counter() - t16d})
    return launches


def mesh_phase(dev, refs: dict, layers: int) -> tuple[dict, dict]:
    """Phase 16: the mesh's serving half on a one-rank NCCL group
    (:func:`one_rank_mesh`).  16a: yi-9b (``layers`` deep: 48 unless
    ``--layers`` cuts it, as phase 6; bf16, random weights
    from seed 0, lut4) through :func:`mesh_serve`, sharded f32 and
    bf16_grouped on the slab (bf16_grouped profiled over 4 ticks: the
    sharded decode's range, the NCCL kernels, the tick's wall and idle
    share, beside the dense run's SDPA range) and bf16_grouped on the
    pool;
    16b: deepseek-v2-lite-16b (27 layers) sharded on the slab and the
    pool; first :func:`grouped_partials_check`; 16c:
    :func:`mesh_collectives`; 16d: :func:`mesh_train_phase`.  ``refs``:
    the dense lut4 runs of phases 6a and 11a by model name (tokens,
    logits, profile); a model whose phase did not run in this process is
    served dense here first.
    Returns (launches, by tensor-core route)."""
    import torch

    t16 = time.perf_counter()
    launches, tc_total = {}, {}
    with one_rank_mesh() as mesh:
        emit({"phase16": "mesh", "shape": mesh.shape,
              "backend": "nccl", "world": mesh.size})
        grouped_partials_check(dev)
        for sub, build in (("16a", lambda: build_model(dev, layers)),
                           ("16b", lambda: build_moe_model(dev))):
            cfg, model, prompts = build()
            ref = refs.get(cfg.name)
            if ref is None:
                counts, out, tc, extra = serve_once(
                    dev, cfg, model, prompts, "lut4", "lut_gemm_dc",
                    record=True, profile=not cfg.mla, ranges=ATTN_RANGES,
                    label=f"phase {sub} dense")
                add_launches(launches, counts)
                add_launches(tc_total, tc)
                ref = dict(extra, tokens=out)
            for total, part in zip((launches, tc_total), mesh_serve(
                    dev, cfg, model, prompts, mesh, ref, sub)):
                add_launches(total, part)
            del model, ref
            gc.collect()
            torch.cuda.empty_cache()
        mesh_collectives(dev, mesh)
        add_launches(launches, mesh_train_phase(dev, mesh))
    emit({"phase16_s": time.perf_counter() - t16})
    return launches, tc_total


#: phase 17: the dry run's record of a cell (``launch.dryrun`` on meta
#: tensors and a one-rank fake world) against the same cell on the card
#: under the same cost mode: (sub, arch, depth (None: all its layers),
#: kind, batch, sequence, quant, overrides).  (a) phase 8's training shape
#: and depth; (b) mamba2-1.3b's 48 layers at the same shape (the scan and
#: its backward); (c) one lut4 decode step of phase 6's batch of 8 on a
#: 1024-token cache through the sharded decode
DRYRUN_CELLS = [
    ("17a", "yi-9b", TRAIN_LAYERS, "train", TRAIN_B, TRAIN_S, "bf16", {}),
    ("17b", "mamba2-1.3b", None, "train", TRAIN_B, TRAIN_S, "bf16", {}),
    ("17c", "yi-9b", TRAIN_LAYERS, "decode", 8, 1024, "lut4",
     {"decode_attn": "sharded"})]
#: the step's argument bytes from the specs against the card's
#: ``memory_allocated()`` once the model, its state and the inputs are built
ARG_REL = 5e-3
#: steps timed after the counted one (which is the warm-up)
DRYRUN_TIMED = 3


def dryrun_config(arch, layers, kind, b, s, quant, over):
    """(cfg, shape) of a :data:`DRYRUN_CELLS` cell."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as dr

    o = dict(over)
    if layers is not None:
        o.update(num_layers=layers, attn_impl="chunked")
    return (dr.cell_config(arch, quant, o),
            ShapeConfig(f"{kind}_{s}", s, b, kind))


def dryrun_meta(sub, arch, layers, kind, b, s, quant, over) -> dict:
    """The dry run's side of a cell: rank 0's count on meta tensors in a
    one-rank fake world (``launch.dryrun.count_cell``), the step's
    argument bytes from the specs and the parameter count."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.registry import get_model

    t0 = time.perf_counter()
    cfg, shape = dryrun_config(arch, layers, kind, b, s, quant, over)
    meta_model = get_model(cfg, device="meta")
    rec = dr.count_cell(cfg, shape, (1, 1), quant=quant)
    rec["argument_bytes"] = dr.argument_bytes(
        cfg, shape, AbstractMesh((1, 1), ("data", "model")), meta_model,
        quant)
    rec["n_params"] = roofline.count_params(meta_model)
    rec["meta_s"] = time.perf_counter() - t0
    return rec


def dryrun_meta_main(path: str) -> None:
    """Every cell's :func:`dryrun_meta`, as JSON to ``path``: phase 17's
    meta side, run in a process of its own beside the card's runs."""
    recs = [dryrun_meta(*cell) for cell in DRYRUN_CELLS]
    with open(path, "w") as f:
        json.dump(recs, f)


def dryrun_card(dev, mesh, sub, arch, layers, kind, b, s, quant, over,
                wrappers) -> dict:
    """The card's side of a cell on ``mesh`` (one rank): the model at
    random weights from seed 0 (``launch.dryrun.prepare_step``), its step
    counted under ``launch.cost.CostMode`` once (the warm-up) and timed
    :data:`DRYRUN_TIMED` times; the wrappers' launches in the counted
    step, and the bytes the card holds once the step's arguments are
    built."""
    import torch

    from repro_torch.launch import dryrun as dr
    from repro_torch.models.registry import get_model

    t0 = time.perf_counter()
    cfg, shape = dryrun_config(arch, layers, kind, b, s, quant, over)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    run, model = dr.prepare_step(
        cfg, shape, mesh, quant=quant, device=dev,
        model=get_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    prep_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counters(wrappers)
    got = dr.count_step(run, kind == "train")
    torch.cuda.synchronize()
    launches, _ = read_counters(wrappers)
    peak = torch.cuda.max_memory_allocated() - base
    count_s = time.perf_counter() - t0 - prep_s
    walls = []
    for _ in range(DRYRUN_TIMED):
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    del run, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(got, launches={k: n for k, n in launches.items() if n},
                held=held, peak=peak, walls=walls, cfg=cfg, shape=shape,
                prep_s=prep_s, count_s=count_s,
                card_s=time.perf_counter() - t0)


def dryrun_check(sub, arch, kind, quant, want: dict, got: dict,
                 smi: str) -> None:
    """Phase 17's checks of one cell, the dry run's count ``want`` against
    the card's ``got``: FLOPs, every collective's count and every kernel's
    launches, FLOPs and bytes equal; the kernels' launches equal the
    wrappers' counters; the argument bytes within :data:`ARG_REL` of
    what the card holds.  Emits the cell's line: the roofline of the
    card's count against the median wall, and the MFU."""
    import statistics

    what = f"phase {sub} {arch} {kind}"
    check(got["flops"] == want["flops"],
          f"{what}: the card counted {got['flops']} FLOPs, the dry run "
          f"{want['flops']}")
    counts = {k: v["count"] for k, v in got["collectives"].items()}
    check(counts == {k: v["count"] for k, v in want["collectives"].items()},
          f"{what}: collectives {got['collectives']} on the card, "
          f"{want['collectives']} on meta")
    check(got["kernels"] == want["kernels"],
          f"{what}: kernels {got['kernels']} on the card, {want['kernels']} "
          "on meta")
    check({k: v["launches"] for k, v in got["kernels"].items()}
          == got["launches"],
          f"{what}: the cost mode saw {got['kernels']}, the wrappers "
          f"counted {got['launches']}")
    args = want["argument_bytes"]
    check(abs(got["held"] - args["total"]) <= ARG_REL * args["total"],
          f"{what}: the card holds {got['held']} bytes of arguments, the "
          f"specs say {args['total']}")
    cfg, shape = got["cfg"], got["shape"]
    wall = statistics.median(got["walls"])
    terms = roofline.roofline_terms(got["flops"], got["bytes"],
                                    got["collective_bytes"], 1)
    n = want["n_params"]
    mf = roofline.model_flops(cfg, shape, n, roofline.active_params(cfg, n))
    emit({"phase17": sub, "model": cfg.name, "layers": cfg.num_layers,
          "kind": kind, "batch": [shape.global_batch, shape.seq_len],
          "quant": quant, "decode_attn": cfg.decode_attn, "nvidia_smi": smi,
          "flops": got["flops"], "flops_meta": want["flops"],
          "bytes": got["bytes"], "bytes_meta": want["bytes"],
          "collectives": counts,
          "collective_bytes": got["collective_bytes"],
          "collective_bytes_meta": want["collective_bytes"],
          "kernels": got["kernels"], "argument_bytes": args,
          "held_bytes": got["held"], "saved_bytes_meta": want["saved_bytes"],
          "peak_estimate_bytes": args["total"] + want["saved_bytes"],
          "max_memory_allocated": got["peak"], "walls_s": got["walls"],
          "wall_s": wall, "model_flops": mf, "n_params": n,
          "step_time_lb_s": terms["step_time_lb_s"],
          "dominant": terms["dominant"],
          "roofline_fraction_of_wall": terms["step_time_lb_s"] / wall,
          "mfu_bf16_dense": mf / (wall * roofline.PEAK_FLOPS),
          "counted_flops_per_s": got["flops"] / wall,
          "meta_s": want["meta_s"], "card_s": got["card_s"],
          "card_prep_s": got["prep_s"], "card_count_s": got["count_s"]})


def dryrun_phase(dev) -> dict:
    """Phase 17: each of :data:`DRYRUN_CELLS` counted by the dry run
    (:func:`dryrun_meta`, in a child process started first, so its
    counting overlaps the card's runs) and run on the card
    (:func:`dryrun_card`), then held to each other (:func:`dryrun_check`).
    Returns the card's launches."""
    import tempfile

    t17 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wrappers = kernel_wrappers()
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "meta.json")
        child = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.dryrun_meta_main({path!r})"],
            cwd=ROOT)
        try:
            with one_rank_mesh() as mesh:
                cards = [dryrun_card(dev, mesh, *cell, wrappers)
                         for cell in DRYRUN_CELLS]
            rc = child.wait(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        check(rc == 0, f"phase 17: the dry run's process exited with {rc}")
        with open(path) as f:
            metas = json.load(f)
    for cell, want, got in zip(DRYRUN_CELLS, metas, cards):
        sub, arch, _, kind, _, _, quant, _ = cell
        dryrun_check(sub, arch, kind, quant, want, got, smi)
        add_launches(launches, got["launches"])
    emit({"phase17_s": time.perf_counter() - t17})
    return launches


#: phase 18a: the TP all-reduces a layer of a mesh step at one rank
#: (forward: attention's and the MLP's reduce; the recompute: attention's
#: again (non-reentrant checkpointing stops before the MLP's); backward:
#: the two copies' all-reduces; lut_nf4 adds wo's and w_down's absmax
#: maxima in the forward and the recompute and their gradients' sums),
#: plus 2 a step: the embedding's reduce, the head's copy
TP_REDUCES = {"bf16": 5, "lut_nf4": 11}
#: phase 18b: the model axes and their bound: shards against the whole
#: call, as a share of its max |value| (the kernels' own tolerance
#: against their plain versions)
TP_AXES = (4, 16)
TP_SHARD_REL = 1e-4
#: phase 18b: yi-9b's decode projections, split by columns or rows
TP_SPLIT = ("col", "col", "col", "row", "col", "col", "row")
#: phase 18c: greedy ticks after the prefill, 8 prompts of TP_PROMPT
TP_TICKS, TP_PROMPT = 16, 64


def tp_train_phase(dev, mesh, wrappers, arch: str = "yi-9b",
                   layers: int = TRAIN_LAYERS, reduces=None,
                   label: str = "18a") -> dict:
    """Phase 18a (and 19a): ``arch`` at ``layers`` (yi-9b at
    ``TRAIN_LAYERS``) through the mesh step on the one-rank ``mesh``
    against the no-mesh step, bf16 and lut_nf4 (:func:`mesh_step_run`
    each, counters set to 0 just before), at phase 8's batch.
    ``reduces``: {mode: (TP all-reduces of a dense layer, of an MoE
    layer)} (default ``TP_REDUCES``).  Returns the mesh steps' launches."""
    from dataclasses import replace

    import torch

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.lut_gemm.ops import NF4MatmulFn
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.fsdp import local_tree
    from repro_torch.tree import leaves

    reduces = reduces or {k: (v, v) for k, v in TP_REDUCES.items()}
    cfg0 = replace(get_config(arch), num_layers=layers, attn_impl="chunked")
    n_moe = layers - cfg0.moe.first_dense if cfg0.moe else 0
    # a layer's quant_matmul projections (MLA: wq, w_dkv, wo; GQA's 4;
    # an MoE layer's shared experts or an MLP's 3)
    per_layer = (3 if cfg0.mla else 4) + 3
    batch = SyntheticLM(cfg0.vocab_size, TRAIN_S, TRAIN_B, seed=0).batch(
        0, dev)
    want_split = {"attention": "split", "mlp": "split", "vocab": "split"}
    if n_moe:
        want_split["experts"] = "split"
    launches = {}
    for mode in reduces:
        cfg = replace(cfg0, quant=QuantConfig(mode=mode))

        def build():
            return get_model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(0)).requires_grad_(
                    True)
        plain = build()
        ref = mesh_step_run(dev, cfg, plain, batch, None, wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        model = build()
        back0 = NF4MatmulFn.backward_launches
        got = mesh_step_run(dev, cfg, model, batch, mesh, wrappers)
        back = NF4MatmulFn.backward_launches - back0
        split = tp.describe(model)
        loss_same = torch.equal(got["loss"], ref["loss"])
        grads_same = sum(torch.equal(a, b)
                         for a, b in zip(got["grads"], ref["grads"]))
        with torch.no_grad():
            params_same = sum(torch.equal(a, b) for a, b in zip(
                leaves(local_tree(model)), leaves(plain.params_tree())))
        n = len(ref["grads"])
        coll = got["collectives"]
        dense_r, moe_r = reduces[mode]
        want_tp = dense_r * (layers - n_moe) + moe_r * n_moe + 2
        want_lut = 3 * per_layer * layers if mode == "lut_nf4" else 0
        emit({f"phase{label[:2]}": label,
              "arch": arch, "mode": mode, "layers": layers,
              "batch": [TRAIN_B, TRAIN_S], "split": split,
              "loss": got["loss"].item(), "bitwise_loss": loss_same,
              "bitwise_grads": grads_same, "bitwise_params": params_same,
              "leaves": n, "tp_reduce": coll.get("tp_reduce", 0),
              "tp_reduce_want": want_tp,
              "tp_reduce_bytes": coll.get("tp_reduce_bytes", 0),
              "tp_gather": coll.get("tp_gather", 0),
              "collectives": coll, "nf4_backward_launches": back,
              **{f"{k}{sfx}": r[k] for r, sfx in ((got, ""),
                                                  (ref, "_no_mesh"))
                 for k in ("wall_s", "peak_gb", "launches")}})
        check(split == want_split,
              f"phase {label} {mode}: the model computes {split}")
        check(loss_same and grads_same == n and params_same == n,
              f"phase {label} {mode}: the split mesh step is not the "
              f"no-mesh step bitwise (loss {loss_same}, gradients "
              f"{grads_same} of {n}, params {params_same} of {n})")
        check(coll.get("tp_reduce", 0) == want_tp
              and coll.get("tp_gather", 0) == 0,
              f"phase {label} {mode}: TP collectives {coll}, want "
              f"{want_tp} all-reduces and no gather")
        check(got["launches"] == ref["launches"]
              and got["launches"]["lut_gemm"] == want_lut
              and back == (per_layer * layers if want_lut else 0),
              f"phase {label} {mode}: launches {got['launches']} (no mesh "
              f"{ref['launches']}), backward {back}; want {want_lut} "
              "lut_gemm")
        add_launches(launches, got["launches"])
        del plain, model, ref, got
        gc.collect()
        torch.cuda.empty_cache()
    return launches


class RankOf:
    """Rank ``r`` of a model axis of ``m`` for the sharding helpers
    (``fsdp.shard_leaf``, ``QuantizedWeight.shard``): its shape, order
    and coordinate, no process group."""

    def __init__(self, m: int, r: int):
        self.shape, self.axis_names, self.r = {"model": m}, ("model",), r

    def canonical(self, axes):
        return tuple(axes) if isinstance(axes, tuple) else (axes,)

    def index(self, axes) -> int:
        return self.r


def tp_shard_phase(dev, shapes=None, splits=TP_SPLIT, label: str = "18b",
                   seed: int = 18) -> dict:
    """Phase 18b (and 19b): each decode projection of ``shapes`` (yi-9b's
    ``LAYER_SHAPES``; random bf16 weights from ``seed``) frozen whole
    (lut4's ``lut_dc``, nf4's ``nf4_dc``; ``lut_nf4``'s codes and
    absmax), cut into each rank's shard by its split (``splits``: "col",
    "row", or "whole", a leaf every rank runs whole) for each of
    ``TP_AXES``, and every shard run in turn: the D&C kernels at M = 8,
    ``lut_gemm`` at M = 8,192 forward and dx (the backward's call over the
    transposed codes).  Column shards concatenated and row partials summed
    against the whole call; routes; rank 0's layer of decode shards
    device-only beside the whole layer and the shards' byte bound."""
    import torch

    from repro_torch.core.lut import NF4_CODEBOOK
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels.lut_gemm.lut_gemm import (lut_gemm, lut_gemm_dc,
                                                       lut_gemm_dc_res)
    from repro_torch.kernels.lut_gemm.ops import codebook_quantize

    shapes = shapes or LAYER_SHAPES
    gen = torch.Generator(device=dev).manual_seed(seed)
    cb = torch.tensor(NF4_CODEBOOK, device=dev)
    out = {"worst": {}, "routes": {}, "bitwise_col": {}}

    def dc(kind, x, q):
        if kind == "lut4":
            return lut_gemm_dc(x, q.codes, q.hi_tab, q.lo_tab,
                               q.zero_point, q.scale)
        return lut_gemm_dc_res(x, q.codes, q.hi_tab, q.lo_tab, q.residual,
                               q.zero_point, q.scale)

    def hold(what, parts, whole, how):
        got = torch.cat(parts, -1) if how == "col" else sum(parts)
        scale = whole.abs().max().item()
        err = (got - whole).abs().max().item() / scale
        out["worst"][what] = max(out["worst"].get(what, 0.0), err)
        if how == "col":
            out["bitwise_col"][what] = (out["bitwise_col"].get(what, True)
                                        and torch.equal(got, whole))
        check(err <= TP_SHARD_REL, f"phase {label} {what}: shards {how} off "
              f"the whole call by {err} of its scale > {TP_SHARD_REL}")

    layer_ms = {}
    x8 = {}
    for (k, n), how in zip(shapes, splits):
        w = (torch.randn(k, n, device=dev, generator=gen)
             / k ** 0.5).to(torch.bfloat16)
        frozen = {q: quantize_weight(w, kern) for q, kern in
                  (("lut4", "lut_dc"), ("nf4", "nf4_dc"))}
        x = x8.setdefault(k, torch.randn(8, k, device=dev, generator=gen)
                          .to(torch.bfloat16))
        layer_ms.setdefault(1, []).append((frozen, x))
        if how == "whole":
            for m in TP_AXES:
                layer_ms.setdefault(m, []).append((frozen, x))
            continue
        codes, absmax = codebook_quantize(w, NF4_CODEBOOK)
        xl = torch.randn(8192, k, device=dev, generator=gen).to(
            torch.bfloat16)
        g = (torch.randn(8192, n, device=dev, generator=gen)
             * absmax).to(torch.bfloat16)
        ones_k = torch.ones(k, device=dev)
        whole = {q: synced(f"{label} whole {q}", lambda q=q: dc(q, x, fq))
                 for q, fq in frozen.items()}
        whole["fwd"] = synced(f"{label} whole lut_gemm", lambda: lut_gemm(
            xl, codes, cb, absmax))
        whole["dx"] = synced(f"{label} whole dx", lambda: lut_gemm(
            g, codes.t().contiguous(), cb, ones_k))
        for m in TP_AXES:
            spec = (None, "model") if how == "col" else ("model", None)
            parts = {key: [] for key in whole}
            for r in range(m):
                rank = RankOf(m, r)
                lut_gemm_dc.launches_tc = lut_gemm_dc_res.launches_tc = 0
                lut_gemm.launches_wgmma = 0
                sh = {q: fq.shard(spec, rank) for q, fq in frozen.items()}
                cols = slice(r * n // m, (r + 1) * n // m)
                rows = slice(r * k // m, (r + 1) * k // m)
                if how == "col":
                    xs, xls, gs = x, xl, g[:, cols].contiguous()
                    c = codes[:, cols].contiguous()
                    a = absmax[cols].contiguous()
                    ok = ones_k
                else:
                    xs = x[:, rows].contiguous()
                    xls = xl[:, rows].contiguous()
                    gs, c, a = g, codes[rows].contiguous(), absmax
                    ok = ones_k[rows].contiguous()
                for q in frozen:
                    parts[q].append(synced(f"{label} {q} shard",
                                           lambda q=q: dc(q, xs, sh[q])))
                parts["fwd"].append(synced(f"{label} lut_gemm shard",
                                           lambda: lut_gemm(xls, c, cb, a)))
                parts["dx"].append(synced(f"{label} dx shard", lambda: (
                    lut_gemm(gs, c.t().contiguous(), cb, ok))))
                routes = (lut_gemm_dc.launches_tc,
                          lut_gemm_dc_res.launches_tc,
                          lut_gemm.launches_wgmma)
                check(routes == (1, 1, 2), f"phase {label} ({k}, {n}) m {m} "
                      f"rank {r}: tensor-core launches {routes}, want "
                      "(1, 1, 2)")
                if r == 0:
                    layer_ms.setdefault(m, []).append((sh, xs))
            dx_how = "row" if how == "col" else "col"
            for key in ("lut4", "nf4", "fwd"):
                hold(f"{key} {how}", parts[key], whole[key], how)
            hold(f"dx {dx_how}", parts["dx"], whole["dx"], dx_how)
            out["routes"][f"{k}x{n} m{m}"] = "tc, tc, wgmma x2"
        del xl, g, parts, whole
    timed = {}
    for m, calls in layer_ms.items():
        for q in ("lut4", "nf4"):
            row = [(sh[q], xs) for sh, xs in calls]
            timed[f"{q} m{m}"] = len(row) * graph_ms(
                lambda i: dc(q, row[i % len(row)][1], row[i % len(row)][0]),
                len(row) * 4)
        bound = sum(bound_ms(8, sh["lut4"].codes.shape[0],
                             sh["lut4"].codes.shape[1], 2,
                             kcost.DC_TABLE_BYTES)[0] for sh, _ in calls)
        timed[f"bound m{m}"] = bound
    out["layer_device_ms"] = timed
    emit({f"phase{label[:2]}": label, **out})
    return out


def greedy_ticks(model, prefill_model, prompts, ticks, mesh=None):
    """The prompts' prefill (``prefill_model``), then ``ticks`` greedy
    ``decode_step`` s of ``model``, under ``activation_sharding(mesh)`` on
    the cache's one-rank shard when ``mesh`` is given.  Returns (tokens
    (B, ticks), logits (ticks, B, V) f32)."""
    import contextlib

    import torch

    from repro_torch.parallel.act_sharding import activation_sharding
    from repro_torch.serve import decode_attention as da

    b, p = prompts.shape
    ctx = (activation_sharding(mesh) if mesh is not None
           else contextlib.nullcontext())
    toks, logits = [], []
    with torch.no_grad(), ctx:
        cache = prefill_model.init_cache(b, p + ticks)
        lg, cache = prefill_model.prefill(prompts, cache)
        if mesh is not None:
            cache = da.shard_cache(cache, mesh)
        for i in range(ticks):
            tok = lg[:, -1].argmax(-1, keepdim=True)
            toks.append(tok[:, 0])
            lg, cache = model.decode_step(tok, cache, p + i)
            logits.append(lg[:, 0].float())
    return torch.stack(toks, 1), torch.stack(logits)


def tp_decode_phase(dev, mesh, wrappers, arch: str = "yi-9b",
                    layers: int = TRAIN_LAYERS, label: str = "18c") -> dict:
    """Phase 18c (and 19c): ``arch`` at ``layers`` (yi-9b at
    ``TRAIN_LAYERS``), ``decode_attn="sharded"``: for lut4 and nf4, the
    no-mesh decode, the whole-weight layout (``serve_param_sharding=
    "fsdp"``) on ``mesh`` and the split one (``"tp"``; counters set to 0
    just before it).  Returns the split runs' launches."""
    from dataclasses import replace

    import torch

    from repro_torch.models.registry import get_config, get_model
    from repro_torch.parallel import act_sharding
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.tree import leaves

    cfg = replace(get_config(arch), num_layers=layers,
                  decode_attn="sharded", serve_param_sharding="tp")
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    whole = type(model).from_params(replace(
        cfg, serve_param_sharding="fsdp"), model.params_tree(), device=dev)
    prompts = torch.randint(1, cfg.vocab_size, (8, TP_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(18))
    # a layer's frozen projections and the TP gathers of a decode tick
    # (GQA: q, k, v; MLA: q_abs, q_rope) and of the prefill (GQA: q, k,
    # v; MLA: none), each step's logits gathered once
    per_layer = 6 if cfg.mla else 7
    tick_gathers = (2 if cfg.mla else 3) * layers + 1
    prefill_gathers = (0 if cfg.mla else 3) * layers + 1
    kern = {"lut4": "lut_gemm_dc", "nf4": "lut_gemm_dc_res"}
    launches = {}
    for quant, name in kern.items():
        plain_toks, plain_lg = greedy_ticks(
            tp.serving_model(model, None, quant), model, prompts, TP_TICKS)
        _, whole_lg = greedy_ticks(tp.serving_model(whole, mesh, quant),
                                   tp.serving_model(whole, mesh), prompts,
                                   TP_TICKS, mesh)
        frozen = tp.serving_model(model, mesh, quant)
        full = tp.serving_model(model, mesh)
        # one rank: every leaf's block is the whole leaf
        shapes_ok = all(
            tuple((q.codes if hasattr(q, "codes") else q).shape)
            == tuple(w.shape)
            for q, w in zip(leaves(frozen.params_tree()),
                            leaves(model.params_tree())))
        reset_counters(wrappers)
        act_sharding.counts.clear()
        t0 = time.perf_counter()
        toks, lg = greedy_ticks(frozen, full, prompts, TP_TICKS, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, tc = read_counters(wrappers)
        coll = dict(act_sharding.counts)
        same_lg = torch.equal(lg, whole_lg)
        rows = []
        for i in range(prompts.shape[0]):
            t = next((j for j in range(TP_TICKS)
                      if toks[i, j] != plain_toks[i, j]), None)
            if t is None:
                rows.append({"row": i, "equal": True})
                continue
            if t == 0:          # chosen from the prefill's logits
                rows.append({"row": i, "equal": False,
                             "first_divergence": 0, "passed": False})
                continue
            # token t is chosen from tick t - 1's logits (window_rule's
            # "at t")
            marg = margin(plain_lg[t - 1, i])
            dist = (lg[t - 1, i] - plain_lg[t - 1, i]).abs().max().item()
            rows.append({"row": i, "equal": False, "first_divergence": t,
                         "plain_margin": marg, "logit_distance": dist,
                         "passed": marg <= WINDOW_FACTOR * dist})
        want = {name: per_layer * layers * TP_TICKS}
        want_reduce = (2 * layers + 1) * (TP_TICKS + 1)
        want_gather = tick_gathers * TP_TICKS + prefill_gathers
        split = tp.describe(frozen)
        emit({f"phase{label[:2]}": label,
              "arch": arch, "quant": quant, "layers": layers,
              "ticks": TP_TICKS, "split": split,
              "bitwise_whole_layout": same_lg,
              "equal_rows": sum(r["equal"] for r in rows),
              "divergences": [r for r in rows if not r["equal"]],
              "launches": counts, "launches_tc": tc, "collectives": coll,
              "tp_want": [want_reduce, want_gather],
              "wall_s": wall, "frozen_shapes_held": shapes_ok})
        check(set(split.values()) == {"split"},
              f"phase {label} {quant}: the model computes {split}")
        check(same_lg, f"phase {label} {quant}: the split decode's logits "
              "are not the whole-weight layout's bitwise")
        check(all(r["equal"] or r["passed"] for r in rows),
              f"phase {label} {quant}: tokens outside the window rule: "
              f"{rows}")
        check(shapes_ok, f"phase {label} {quant}: a frozen leaf is not its "
              "spec's block")
        check(counts[name] == want[name] == tc[name]
              and all(v == 0 for k, v in counts.items() if k != name),
              f"phase {label} {quant}: launches {counts} (tc {tc}), want "
              f"{want}")
        check(coll.get("tp_reduce", 0) == want_reduce
              and coll.get("tp_gather", 0) == want_gather,
              f"phase {label} {quant}: TP collectives {coll}, want "
              f"{want_reduce} all-reduces and {want_gather} gathers")
        add_launches(launches, counts)
        del frozen, full
        gc.collect()
    del model, whole
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def tp_phase(dev) -> dict:
    """Phase 18 (the module docstring): 18a and 18c on a one-rank NCCL
    group, 18b on the kernels alone.  Returns the main-path launches of
    18a and 18c."""
    t18 = time.perf_counter()
    wrappers = kernel_wrappers()
    launches = {}
    with one_rank_mesh() as mesh:
        add_launches(launches, tp_train_phase(dev, mesh, wrappers))
        tp_shard_phase(dev)
        add_launches(launches, tp_decode_phase(dev, mesh, wrappers))
    emit({"phase18_s": time.perf_counter() - t18})
    return launches


#: phase 19: deepseek-v2-lite-16b at its published widths, its first
#: (dense) block and 3 MoE blocks
MOE_TP_LAYERS = 4
#: phase 19a: the TP all-reduces a step at one rank, (a dense layer, an
#: MoE layer): the dense layer's as ``TP_REDUCES`` (MLA's reduce and copy
#: where GQA's were); an MoE layer's one more, the gates' copy backward
#: (its tokens' copy is the MLP's; the recompute stops before its reduce);
#: lut_nf4's wo and shared w_down absmax maxima as the dense layer's
MOE_TP_REDUCES = {"bf16": (5, 6), "lut_nf4": (11, 12)}
#: phase 19b: an MoE layer's decode projections as the split cuts them:
#: MLA's wq (columns: 16 heads of 192), w_dkv (whole on every rank), wo
#: (rows); the shared experts' w_gate, w_up (columns), w_down (rows)
DSV2_TP_SHAPES = [(2048, 3072), (2048, 576), (2048, 2048), (2048, 2816),
                  (2048, 2816), (2816, 2048)]
DSV2_TP_SPLIT = ("col", "whole", "row", "col", "col", "row")


def experts_timing(dev) -> dict:
    """Phase 19b's routed experts: a decode tick's three batched products
    (``models.moe.experts``) of deepseek-v2-lite-16b (64 experts of 2048
    x 1408, bf16, seed 19) on 8 rows' dispatch buffer (capacity 4), all
    64 experts against rank 0's E/m at each of ``TP_AXES``: the ranks'
    outputs concatenated over E against the whole call (within
    ``TP_SHARD_REL`` of its scale), device-only ms beside the expert
    weights' byte bound."""
    import torch

    from repro_torch.models.moe import experts

    gen = torch.Generator(device=dev).manual_seed(19)
    e, d, f, cap = 64, 2048, 1408, 4

    def rand(*shape, scale):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(torch.bfloat16)
    params = {"w_gate": rand(e, d, f, scale=d ** -0.5),
              "w_up": rand(e, d, f, scale=d ** -0.5),
              "w_down": rand(e, f, d, scale=f ** -0.5)}
    xg = rand(1, e, cap, d, scale=1.0)
    whole = synced("19b experts", lambda: experts(params, xg))
    out = {"worst": 0.0}
    for m in (1,) + TP_AXES:
        n = e // m
        if m > 1:
            parts = [synced("19b expert shard", lambda r=r: experts(
                {k: v[r * n:(r + 1) * n] for k, v in params.items()},
                xg[:, r * n:(r + 1) * n])) for r in range(m)]
            err = ((torch.cat(parts, 1) - whole).abs().max()
                   / whole.abs().max()).item()
            out["worst"] = max(out["worst"], err)
            check(err <= TP_SHARD_REL, f"phase 19b experts m {m}: the "
                  f"ranks' outputs off the whole call by {err}")
        local = {k: v[:n].contiguous() for k, v in params.items()}
        x0 = xg[:, :n].contiguous()
        out[f"device_ms m{m}"] = graph_ms(lambda i: experts(local, x0), 8)
        out[f"bound_ms m{m}"] = 1e3 * 3 * n * d * f * 2 / HBM_BYTES_S
    emit({"phase19": "19b experts", **out})
    return out


def moe_tp_phase(dev) -> dict:
    """Phase 19 (the module docstring): the moe family split over
    ``model``: 19a and 19c on a one-rank NCCL group, 19b on the kernels
    alone.  Returns the main-path launches of 19a and 19c."""
    t19 = time.perf_counter()
    wrappers = kernel_wrappers()
    launches = {}
    arch = "deepseek-v2-lite-16b"
    with one_rank_mesh() as mesh:
        add_launches(launches, tp_train_phase(
            dev, mesh, wrappers, arch, MOE_TP_LAYERS, MOE_TP_REDUCES, "19a"))
        tp_shard_phase(dev, DSV2_TP_SHAPES, DSV2_TP_SPLIT, "19b", seed=19)
        experts_timing(dev)
        add_launches(launches, tp_decode_phase(dev, mesh, wrappers, arch,
                                               MOE_TP_LAYERS, "19c"))
    emit({"phase19_s": time.perf_counter() - t19})
    return launches


#: the phases ``--phases`` selects, in the order they run: "6" is yi-9b's
#: serving (6, 9a, 10a, 10c), "7" mamba2-1.3b's (7, 9b, 10b), "8" the
#: trainer's (8, 8b); 1 and 2 always run
PHASES = ("3", "4", "5", "6", "7", "11", "12", "8", "13", "14", "15", "16",
          "17", "18", "19")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="depth of the full-width yi-9b in phases 6, 9a, "
                         "10a, 10c and 16a (it has 48); mamba2-1.3b always "
                         "runs all 48 of its layers")
    bench = ap.add_mutually_exclusive_group()
    bench.add_argument("--ssd-bench", metavar="ROOT",
                       help="only time ROOT's ssd_scan (ssd_bench)")
    bench.add_argument("--ssd-against", metavar="DIR",
                       help="only time DIR's ssd_scan and this checkout's "
                            "in turns (ssd_against)")
    bench.add_argument("--ssd-bwd-bench", metavar="ROOT",
                       help="only time ROOT's ssd_scan_bwd (ssd_bwd_bench)")
    bench.add_argument("--ssd-bwd-against", metavar="DIR",
                       help="only time DIR's ssd_scan_bwd and this "
                            "checkout's in turns (ssd_bwd_against)")
    ap.add_argument("--phases", metavar="LIST",
                    help="after the build, run only these phases "
                         f"(comma-separated, of {', '.join(PHASES)}) and "
                         "print neither the kernels line nor the last "
                         "line")
    args = ap.parse_args()
    only = set(args.phases.split(",")) if args.phases else set(PHASES)
    if not only <= set(PHASES):
        ap.error(f"--phases: {sorted(only - set(PHASES))} not in {PHASES}")
    if args.ssd_bench or args.ssd_against:
        print(json.dumps(ssd_bench(args.ssd_bench) if args.ssd_bench
                         else ssd_against(args.ssd_against)))
        return 0
    if args.ssd_bwd_bench or args.ssd_bwd_against:
        print(json.dumps(ssd_bwd_bench(args.ssd_bwd_bench)
                         if args.ssd_bwd_bench
                         else ssd_bwd_against(args.ssd_bwd_against)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    emit({"nvidia_smi": smi.stdout.strip().splitlines()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas, by_lib = [], {}
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log")
        if log.exists():
            lines = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Performance Loss" in ln]
            ptxas += lines
            by_lib[name] = lines
    # SASS instructions a code of the D&C kernels' streaming loops (M <= 8
    # instantiations, bf16 x: the main path's)
    loops = {"lut_gemm.cu": sass_loops(libs["lut_gemm"], (
                 "lut_gemm_dc_split_kernel", "ILi8E", "Lb1E", "bfloat16")),
             "lut_gemm_tc.cu": sass_loops(libs["lut_gemm_tc"],
                                          ("lut_gemm_tc_kernelILi1ELb0E",)),
             "lut_gemm_tc.cu full": sass_loops(
                 libs["lut_gemm_tc"], ("lut_gemm_tc_kernelILi1ELb1E",))}
    for lps in loops.values():
        for lp in lps:
            if isinstance(lp, str):
                continue
            codes = 4 * lp["ldg_32"] + 16 * lp["ldg_128"]
            lp["per_code"] = lp["instructions"] / codes if codes else None
    # the prefill kernel's loops over a stage (its 128-row tile): a consumer
    # looks up 32 codes a stage (2 columns x 16 k rows); its wgmma per stage
    # say the piece count (8 a piece: 4 steps x 2 chains)
    loops["lut_gemm_wgmma.cu"] = sass_loops(
        libs["lut_gemm_wgmma"], ("lut_gemm_wgmma_kernelILi128E",),
        stream="HGMMA")
    for lp in loops["lut_gemm_wgmma.cu"]:
        if not isinstance(lp, str):
            lp["per_code"] = lp["instructions"] / 32
    emit({"sass_loops": loops})
    emit({"build_s": build_s, "libs": [p.name for p in libs.values()],
          "ptxas_max_registers": max(
              (int(ln.split("Used ")[1].split()[0]) for ln in ptxas
               if "Used " in ln), default=None),
          "ptxas_spills": sorted({
              ln for ln in ptxas if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln}),
          "ptxas_lut_gemm": {n: by_lib.get(n) for n in (
              "lut_gemm_tc", "lut_gemm_wgmma")},
          "ptxas_ssd_scan_tc": by_lib.get("ssd_scan_tc"),
          "ptxas_ssd_scan_bwd": by_lib.get("ssd_scan_bwd")})

    kernels, launches, tc = {}, {}, {}
    refs = {}                 # phase 16's dense references (phases 6, 11)
    flash_tc = luna_tc_train = 0
    if "3" in only:
        kernels = kernel_phase(dev)
        kernels.update(luna_kernel_phase(dev))
        kernels.update(lut_full_kernel_phase(dev))
        kernels.update(ssd_kernel_phase(dev))
        kernels.update(ssd_bwd_kernel_phase(dev))
        kernels.update(flash_kernel_phase(dev))
    if "4" in only:
        small_reference_phase(dev)
        small_ssm_reference_phase(dev)
        small_substrate_phase(dev)
        small_spec_phase(dev)
        small_moe_phase(dev)
        small_hybrid_phase(dev)
        small_training_phase(dev)
    if "5" in only:
        quant_matmul_phase(dev)
    if "6" in only:
        cfg, model, prompts = build_model(dev, args.layers)
        launches, tc, outs, refs[cfg.name] = main_path_phase(
            dev, cfg, model, prompts)
        for total, part in zip((launches, tc), substrate_phase(
                dev, cfg, model, prompts, outs["lut4"])):
            add_launches(total, part)
        t10 = time.perf_counter()
        for run in (spec_phase(dev, cfg, model, prompts),
                    loop_phase(dev, cfg, model, prompts, outs["lut4"])):
            for total, part in zip((launches, tc), run):
                add_launches(total, part)
        phase10_s = {"10a+10c": time.perf_counter() - t10}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    if "7" in only:
        cfg, model, prompts = build_ssm_model(dev)
        *ssm_run, ssm_plain, ssm_extra = ssm_main_path_phase(dev, cfg, model,
                                                             prompts)
        for run in (ssm_run, ssm_substrate_phase(dev, cfg, model)):
            for total, part in zip((launches, tc), run):
                add_launches(total, part)
        t10 = time.perf_counter()
        for total, part in zip((launches, tc), ssm_spec_phase(
                dev, cfg, model, prompts, ssm_plain, ssm_extra)):
            add_launches(total, part)
        if "6" in only:
            phase10_s["10b"] = time.perf_counter() - t10
            emit({"phase10_s": sum(phase10_s.values()), "parts": phase10_s})
        del model, ssm_extra
        gc.collect()
        torch.cuda.empty_cache()
    if "11" in only:
        *run, refs["deepseek-v2-lite-16b"] = moe_phase(dev)
        for total, part in zip((launches, tc), run):
            add_launches(total, part)
    if "12" in only:
        for total, part in zip((launches, tc), hybrid_phase(dev)):
            add_launches(total, part)
    if "8" in only:
        launches_train, flash_tc, luna_tc_train = train_phase(dev)
        add_launches(launches, launches_train)
        trainer_phase(dev)
    if "13" in only:
        launches_family, luna_tc_family = family_train_phase(dev)
        add_launches(launches, launches_family)
        luna_tc_train += luna_tc_family
    if "14" in only:
        launches_modality, tc_modality = modality_phase(dev)
        add_launches(launches, launches_modality)
        flash_tc += tc_modality.pop("flash_attention", 0)
        luna_tc_train += tc_modality.pop("luna_mm", 0)
        add_launches(tc, tc_modality)
    if "15" in only:
        launches_options, tc_options, nf4 = options_phase(dev)
        add_launches(launches, launches_options)
        add_launches(tc, tc_options)
    if "16" in only:
        for total, part in zip((launches, tc),
                               mesh_phase(dev, refs, args.layers)):
            add_launches(total, part)
        refs.clear()
    if "17" in only:
        add_launches(launches, dryrun_phase(dev))
    if "18" in only:
        add_launches(launches, tp_phase(dev))
    if "19" in only:
        add_launches(launches, moe_tp_phase(dev))
    if only != set(PHASES):
        emit({"phases_passed": sorted(only, key=PHASES.index),
              "launches": launches, "script_s": time.perf_counter() - T0})
        return 0
    emit({"script_s": time.perf_counter() - T0})
    check(set(launches) == set(kernels),
          f"kernels launched on the main path {sorted(launches)} are not "
          f"the kernels checked {sorted(kernels)}")
    for name, n in launches.items():
        kernels[name]["launches"] = n
    kernels["flash_attention"]["launches_tc"] = flash_tc
    kernels["luna_mm"]["launches_tc"] = tc.get("luna_mm", 0) + luna_tc_train
    for name in ("lut_gemm_dc", "lut_gemm_dc_res", "lut_gemm"):
        kernels[name]["launches_tc"] = tc.get(name, 0)
    kernels["lut_gemm"]["launches_wgmma"] = tc.get("lut_gemm_wgmma", 0)
    # lut_nf4's backward (phase 15b): dx over the transposed codes
    kernels["lut_gemm"]["launches_backward"] = nf4["backward"]
    kernels["lut_gemm"]["backward_calls"] = nf4["checks"]["calls"]
    kernels["lut_gemm"]["backward_layer_device_ms"] = nf4["checks"][
        "layer_backward_device_ms"]
    kernels["lut_gemm"]["backward_layer_bound_ms"] = nf4["checks"][
        "layer_backward_bound_ms"]
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
