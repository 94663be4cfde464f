#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before the result lines):
  1. the card's name and power limit; build the CUDA kernels from csrc/;
     count the wgmma (SASS HGMMA) instructions of each 16-bit flash kernel
     and the TMA (UTMALDG, or UBLKCP for a plain bulk copy) instructions of
     each decode kernel in the built library (cuobjdump; fails if one has
     none), and the HGMMA, UTMALDG and HMMA instructions of each 16-bit
     sparse kernel, forward and backward (fails without the first two or
     with an HMMA); the registers a thread of each LayerNorm forward and dx
     and softmax forward kernel and of each 16-bit sparse kernel (cuobjdump
     --dump-resource-usage; fails on a sparse kernel with local memory or a
     stack frame), and of the decode kernel's 300 instances by query bucket
     and head dim (fails on a kSQ 16 instance with local memory);
  2. decode attention kernel vs its plain version at GPT-2 125M decode
     geometry (b=8, S=1024, h=12, d=64, bf16, mixed per-row fills plus a
     retired-lane sentinel row), s_q = 1 and 4, max abs err <= 2e-2; then
     B2, B3 and their int8 branches at the speculative verify width s_q =
     k + 1 = 5 over the arenas the speculative engine builds (dense S 1028,
     paged tables of 65 entries), a verify from position 1023 among the
     fills, vs their plain versions (phase 18's tolerances), and whether
     B2's query i at s_q 5 is bitwise an s_q 1 call (printed, not gated);
     the same four at the fused step's width s_q 16 over the fused arenas
     (dense S 1039, paged T 65: SQ16_CASE), at GPT 2.7B's head dim
     (h 32 x d 80, s_q 1, S 1024: D80_CASE) and at s_q 24 (SQ24_CASE:
     two launches a call, the pieces 16 + 8, which the phase counts);
  3. sampling kernel vs its plain version at b=8, V=50304: greedy tokens
     equal, top-k=50 filtered logits bitwise equal, top-p=0.9 kept sets
     equal up to f32 rounding of the probability mass, temperature draws
     inside the filter;
  4. the main path: ServingEngine(megakernel=True) serving GPT-2 125M at
     full width (random weights from --seed) to 16 greedy requests, with the
     kernels' launch counts reset just before and read just after; then the
     same requests on the plain versions (megakernel=False) for the share of
     greedy tokens that agree, one decode step's logits through the kernels
     vs through the plain versions, and a rerun with every served logits
     tensor checked finite;
  6. two steady decode chunks: one timed unprofiled, one under
     torch.profiler (device time by kernel; idle share = 1 - device busy /
     unprofiled chunk wall);
  5. per-kernel device times (torch.profiler) beside the plain version, the
     PyTorch library call for the same function and the card's lower bound;
     B2 also at phase 2's fills with s_q = 4 and with every row full; B4
     also filtering (top_k 50 + top_p 0.9, top-p 0.9 alone, top-k 50
     alone) and drawing (temperature 0.8, top_k 50, top_p 0.9, gumbel
     row) at b 8, V 50304, filtering at b 64, V 131072, and its launch
     floor (b 1, V 128, greedy), each beside its byte bound and its
     yardstick (torch.argmax; torch.topk(x, 50); the sort-based
     serving.sampling.filter_logits, several calls; the same then the
     argmax of the filtered row + gumbel for the draw); B2/B3 (and int8)
     at s_q 5 beside their plain versions, scaled_dot_product_attention
     with the kernel's window and their bounds, and so at phase 2's s_q 16
     and d 80 cases (the rows *_sq16, *_d80); B4's filter at the sampled
     verify's [40, 50304] rows (T 0.8, top-k 50, top-p 0.9);
  7. flash attention kernels (forward, dq, dk/dv) vs their plain versions at
     the training shape (B=8, S=1024, H=12, D=64, bf16, causal), at phase
     32's (B=4, S=1024, H=32; the kernels line's errors are the worse of
     the two), at a non-causal shape whose S (1000) is not a multiple of
     the 128-row block and at the capacity tier's GPT 2.7B shape (B=1,
     S=1024, H=32, D=80, causal: the d 80 rows' errors): out, lse, and
     dq/dk/dv from one random dO; then over bf16 and fp16 x D
     32/64/80/96/128 x causal or not x S 1024/1000/77 (B=2, H=3); a second
     backward at the training shape must give bitwise the same grads;
  8. the training path: initialize() + DeepSpeedEngine.train_batch on
     GPT-2 125M at full width and depth (12 layers, d_model 768, 12 x 64
     heads, vocab 50304, seq 1024, bf16 over fp32 masters, remat with the
     default policy, random weights from --seed) with bench.py's
     gpt2_125m_zero1 config (micro 8 x gas 16, AdamW lr 1e-4, ZeRO-1):
     2 warm-up + 3 timed steps on one repeated batch, counts reset just
     before and read just after; fails on a non-finite or non-falling loss,
     a non-finite grad norm, or flash launch counts other than 12 layers x
     16 micro-batches per step (x2 for the forward: remat recomputes it);
  9. one micro-batch of the trained model forward+backward through the
     kernels (attention_impl="auto") vs the masked einsum ("xla"): loss and
     global grad norm;
 10. one training micro-step after a warm-up one, unprofiled (host issue
     time and wall), then under torch.profiler (device time by kernel,
     kernel count; idle share = 1 - device busy / unprofiled wall);
 11. the flash kernels' device times at the training shape beside their
     plain versions, scaled_dot_product_attention forward / its autograd
     backward (a yardstick, never called by the port) and their bounds;
     the same at the transformer layer's unmasked shape (B=8, S=512, H=16,
     D=64, not causal), at the training shape in fp16 and at D=96 (H=8),
     and at phase 7's capacity shape (D=80: the d 80 rows); the host time
     to issue one forward and one backward call;
 12. block-sparse kernels (forward, dq, dk/dv) vs their plain versions:
     bf16, fp16 and f32 x layout blocks 16/32/64/128 x causal or not x with
     or without a key-padding mask (BigBird, per-head layouts, B=2, H=4,
     D=64, S=480 or 512, q/k/v views of a fused qkv), D=96 and D=80 (block
     32, S=480, causal or not; D=80 also key-padded), a layout with dead
     query rows and key tiles no
     query reaches (zeros checked; a dead row's lse exactly -1e30), and
     the training shape B=1, S=32768, H=12, D=64 with bench.py's BigBird
     layout, causal, where a second forward must give bitwise the same out
     and lse and a second backward bitwise the same grads; then (after
     phase 16) d 80 at B=1, S=8192, H=32 with the bench layout: the
     kernels vs their plain versions, their device times (rows
     sparse_*_d80) and one training step of a sparse GPT at GPT 2.7B's
     width cut to 2 layers (seq 8192; launches 4 / 2 / 2, the rows'
     launches);
 13. the long-context training path: bench.py's long_context_sparse case
     (bench.py:344-399): GPT-2 125M at seq 32768 (full width and depth,
     bf16 over fp32 masters, remat with the default policy) through
     attention_impl="sparse" (BigBird block 64, 3 random, 3 window,
     1 global), micro 1 x gas 1, ZeRO-1, AdamW lr 1e-4: 1 warm-up + 3 timed
     steps, counts reset just before and read after each step; fails on a
     non-finite or non-falling loss, a non-finite grad norm, sparse launch
     counts other than 24 / 12 / 12 per step or any flash launch; prints
     step time, tokens/s and peak device memory;
 14. one step of the trained long-context model (seq 32768) through the
     kernels vs through the plain versions: loss and global grad norm;
 15. one warmed long-context step unprofiled (wall), then under
     torch.profiler (device time by kernel; idle share);
 16. the sparse kernels' device times at the training shape beside their
     plain versions, scaled_dot_product_attention with the expanded boolean
     mask (dense work; at the largest S that fits, stated) and their
     bounds (live (q, k) pairs of the layout, causal), each time also as a
     multiple of its bound; the host time to issue one forward and one
     backward call;
 17. sparse BERT: BertForMaskedLM at bert_base width, max_seq_len 4096,
     bf16, BigBird block 64 (bidirectional), batch 4 of real lengths 4096,
     3000, 1500, 40 padded by pad_to_block_size with a batch-wide
     key-padding mask: MLM loss and grads through the kernels vs the plain
     versions (finite, within bounds, 12 launches of each kernel), and the
     kernels at that shape vs their plain versions with dk/dv exactly zero
     at padded keys. This one comparison scales the bf16 rtol by each
     row's largest |ref| (the 40-token row's 4056 padded queries pour their
     attention into 40 keys: sums of thousands of bf16-rounded terms that
     cancel); it prints the elementwise reading beside it. Every other
     sparse comparison is elementwise;
 18. paged decode attention (B3) and the int8 branches of B2 and B3 vs their
     plain versions at GPT-2 125M decode geometry (b=8, h=12, d=64,
     S=1024, block 16, so T=64), bf16, fp16 and f32, s_q 1 and 4, fills 0,
     1, 17, 512, 1024, 300, 777 and the retired-lane sentinel, over a random
     permutation of the pool blocks with sentinel table entries past each
     row's fill: max abs err <= 2e-2, the fill-0 row exactly zero, and B3
     over the permuted table, the in-order table and the sentinel table
     bitwise B2 (int8: B3-int8 bitwise B2-int8);
 19. the paged main path: ServingEngine(paged=True, megakernel=True,
     kv_block_size=16) serving GPT-2 125M (full width and depth, random
     weights from --seed) to 16 greedy requests of 64 new tokens, four of
     them exact repeats of earlier prompts, with the counts reset just
     before and read just after: fails on no B3 or sampling launch or any
     B2 launch, on prefix-cache hits/misses other than 4/12, on prefill
     prompt tokens other than the 12 distinct prompts' sum, on a hit whose
     tokens differ from its twin's, or on tokens that differ from the dense
     megakernel engine's on the same requests; prints tokens/s, the mean
     chunk time and a steady chunk's idle share;
 20. int8 serving: the same 16 requests through kv_dtype="int8", dense and
     paged, counts reset before and read after each run: fails on no int8
     launch (or any other decode kernel's), on dense and paged int8 tokens
     that differ, on a non-finite served logits tensor, or on an int8
     payload above half the compute dtype's bytes (arena_report); prints
     the share of tokens equal to the bf16 engine's;
 21. device times of B3, B2-int8 and B3-int8 at phase 2's inputs (B2's
     fills, bf16, s_q 1) beside B2's, their plain versions', a gather +
     scaled_dot_product_attention yardstick (a dequantize between them for
     int8) and their byte bounds; the three also at s_q = 4 and with every
     row full;
 22. the row-wise kernels vs their plain versions, bf16 and f32: LayerNorm
     (B6) forward and dx at [8*512, 1024] (gamma/beta in the element type
     and in f32), [37, 1000], the path edges [37, 1016 / 1032 / 2048 /
     16384 / 16392 / 20000] and [37, 1024] one element off a 16-byte
     boundary; bias-GELU
     (B7) forward and backward at [8*512, 4096] and [37, 1001]; softmax
     (B8) forward and backward at [8, 16, 512, 512], [2, 3, 77, 4099] (a
     block per row), the path edges [1, 2, 5, 1023 / 1024 / 1025 / 2048]
     and [2, 3, 77, 1024] one element off a 16-byte boundary, causal and
     not, and masked_softmax with a scale and an additive key mask; then
     B7's op entry (ops.transformer.bias_gelu + gelu, forward and backward
     at [8, 512, 4096] bf16, counts reset just before and read just after:
     two launches of each kernel);
 23. the layer path: 24 DeepSpeedTransformerLayers at bert_large width
     (hidden 1024, 16 heads, intermediate 4096, pre-LN, eps 1e-12, no
     dropout, random weights from --seed) with a fixed key-padding mask
     (lengths 512 .. 64) trained through initialize() + train_batch (bf16
     over fp32 masters, AdamW lr 1e-4, ZeRO-1, micro 8 x seq 512 x gas 1,
     the mean squared output as the loss): 1 warm-up + 3 timed steps,
     counts reset just before and read after each step; fails on a
     non-finite or non-falling loss or on launches per step other than
     48 / 48 LayerNorm, 24 / 24 softmax and no flash; prints step s,
     tokens/s, peak memory and a warmed step's idle share; then one
     forward+backward without the mask (flash 24 / 24 / 24, no softmax),
     and the trained weights through the kernels vs the plain versions
     (loss and grad norm);
 24. the six row-wise kernels' device times at phase 22's shapes (bf16;
     softmax also f32, the layer's logits) beside their plain versions,
     F.layer_norm / F.gelu(x + b, approximate="tanh") / torch.softmax and
     their autograd backwards (yardsticks) and their bounds; warm (the same
     inputs each call: the kernels line) and cold (input copies of at least
     64 MiB read in turn, past L2), the kernel and its yardstick each;
     LayerNorm dx also at its path edges (rows of 1032, 16384 and 16392,
     bf16, as many rows as the layer's 4096 x 1024 elements), warm and
     cold;
 25. sampled serving: phase 4's model and 16 prompts through
     ServingEngine(megakernel=True, temperature=0.8, top_k=50, top_p=0.9,
     seed=--seed), CUT_NEW new tokens each, counts reset just before and
     read just after (fails without a sampling launch); tokens/s; a rerun with
     the same seed must give identical tokens; one steady chunk profiled:
     B4's device ms per decode step beside the step's device busy ms;
 26. speculative serving: phase 4's 16 requests (CUT_NEW new tokens
     each) through ServingEngine(megakernel=True, speculative=True, spec_k=4,
     spec_ngram=2) over the dense bf16, paged, int8 and paged int8 arenas,
     each beside the non-speculative kernel engine on the same arena:
     fails unless every request is done, every logits tensor finite,
     each spec step launches the arena's decode kernel (s_q 5) once a
     layer and nothing else of B2/B3, and the greedy tokens equal the
     non-spec engine's or part first at a near-tie of the non-spec run
     (top-2 gap within SPEC_TIE_ULPS bf16 ulps); prints tokens/s of both,
     the acceptance rate, chunk ms, tokens a chunk, launches a step and a
     steady spec chunk's idle share;
 27. sampled speculative serving (temperature 0.8, top-k 50, top-p 0.9):
     one B4 filter launch a spec step, a rerun with the seed bitwise equal;
 28. the serve loop: run() (double-buffered) against a step() loop, spec,
     not and fused prefill (equal greedy tokens, both timed), with every
     launch under
     torch.cuda.set_sync_debug_mode("error"); a cancel of a running and a
     queued request in mid-run;
 29. resume: phase 8's gpt2_125m_zero1 engine at full width (gas cut to
     RESUME_GAS, printed; phase 8's batch) trains 2
     steps, saves to a temporary directory (npz), trains 2 more; a fresh
     engine (other random weights) loads and trains the same 2: its losses
     must be bitwise the uninterrupted ones and the flash kernels must run
     in the resumed steps (counts reset just before, read just after);
     prints save and load seconds and the checkpoint's bytes;
 30. ZeRO-1 over two data-parallel ranks: this script started twice more
     (--dp-rank 0 / 1), each rank micro 4 of phase 29's micro-batches of 8
     rows for its first DP_STEPS (2) steps, over NCCL with one card a rank when the
     host has two cards, else over gloo with both ranks on one card; fails
     if a rank fails, if a loss leaves phase 29's by more than LOSS_ATOL,
     if the ranks' losses differ, if a rank's launches of B1/B1b are not
     its 12 layers x gas x steps (x2 for the forward) or if a rank's
     optimizer state (fp32 master slices and Adam moments) is not half of
     dp 1's, up to the padding; prints per rank the backend, launches,
     step seconds, bytes all-reduced and all-gathered a step and its
     optimizer-state bytes beside dp 1's;
 31. LAMB, Adagrad and SGD (momentum 0.9): 3 steps each of the same model
     (micro 8, gas 1, one repeated batch): losses finite and falling; the
     third step's masters against the same optimizer step on CPU copies of
     its state and grads (OPT_CPU_TOL);
 32. ZeRO-3 + CPU offload at full width: bench.py's ladder_zero3_offload
     (GPT-2 1.3B from zero.abstract_init, seq 1024, bf16, micro 4 x gas
     2, AdamW lr 1e-4), dp 1, 1 warm-up step and 2 timed. Fails when
     MemAvailable is below the reckoned host bytes (18 B a parameter), a
     loss is not finite or the third is not below the first (one repeated
     batch), B1/B1b's launches are not 24 layers x gas x 3 steps (x2 for
     the remat forward), the engine's device state exceeds 6 B a parameter
     or the card memory the phase leaves live after a step exceeds it by
     1 GiB (no fp32 master or moment on the card), or one leaf's master
     after the last step leaves a plain torch AdamW step of its pre-step
     state and grad by more than OPT_CPU_TOL. Prints the parameter count, init seconds, host
     and device bytes, max_memory_allocated, each step's split (device
     forward+backward, D2H, CPU Adam, H2D, with bytes and GB/s), tokens/s,
     TFLOP/s and MFU (mfu_report), the CPU Adam's bytes a step over its
     seconds, and the OpenMP runtime and threads;
 33. ZeRO-2 and ZeRO-3 over two ranks, as phase 30 runs ZeRO-1 (the same
     rank processes, DP_STEPS each): fails if a loss leaves phase 29's by
     more than LOSS_ATOL, if the ranks' losses differ, if B1/B1b's counts
     are wrong, if a stage-2 rank's grad accumulator or a stage-3 rank's
     partitioned parameters are not half of dp 1's, up to the padding, if
     the stage-3 engine's bytes on the card are not below stage 2's by at
     least half of the partitioned bf16 leaves' other half, or
     if the card grows more a block in stage 3's first forward than in
     stage 2's by half a block's gathered bf16 weights (they would outlive
     the block); prints per rank the bytes reduce-scattered and
     all-gathered a step, the step seconds, max_memory_allocated, the
     bytes live after the engine's build and after the first forward's
     blocks, that forward's peak and the growth a block, beside stage 1's;
 34. the NVMe tiers and offload resume: phase 29's model with
     offload_optimizer and offload_param on nvme in a temporary directory
     against the cpu tier (2 steps: bitwise losses), then saved at step 2
     and loaded into a fresh engine (the next 2 losses bitwise); prints the
     bytes read and written and their GB/s over the host step, whether
     O_DIRECT ran, and the save and load seconds;
 35. the layer-streamed tier (offload_param.layer_streaming) against the
     plain offload engine (stage 1, offload_optimizer cpu) at GPT 2.7B's
     width (d_model 2560, 32 heads of 80, d_ff 10240) cut to 4 layers, bf16,
     micro 1 x gas 2 x seq 1024, 3 steps from one counter fill: fails unless
     the losses are bitwise equal, B1/B1b launch 2 / 1 / 1 times a layer
     and micro-batch in the streamed run (counts reset just before it: the
     d 80 rows' launches), and it fetched 2 L and emitted L blocks a
     micro-batch through two device buffer sets;
 36. cpu_checkpointing: GPT-2 125M (micro 8 x seq 1024, bf16, remat policy
     "nothing") trained 2 steps through initialize() with
     activation_checkpointing.cpu_checkpointing against remat: fails unless
     the losses are bitwise equal, the card's memory_allocated after each
     block's first forward grows by less than one block input (B S D x 2
     bytes) under cpu_checkpointing and by about one under remat (median
     growth a block);
 37. bench.py's capacity_streamed (bench.py:402-480): its menu and pick
     rule (the largest of gpt_neox_6.7b, gpt_2.7b, gpt2_1.3b whose
     _cfg_params x 16 bytes is below 0.45 x MemAvailable; fails with the
     numbers where none fits) at full width and depth from
     zero.abstract_init, seq 1024, micro 1 x gas 1, bf16, AdamW lr 1e-4,
     layer-streamed: 1 warm-up and 2 timed steps, then one eval_batch.
     Fails unless the losses and the eval loss are finite, the streamer
     held at most two device block buffer sets, memory_allocated after a
     timed step equals its value before (within 1 MiB), B1/B1b launched
     L x (2, 1, 1) a step and the eval fetched L blocks. Prints
     MemAvailable, the pick, its exact parameter count, init seconds, step
     seconds, tokens/s, MFU (mfu_report), max_memory_allocated and each
     step's split (device forward+backward, H2D and D2H bytes and GB/s, the
     host's block-norm pass, CPU Adam seconds and GB/s);
 38. fused chunked prefill (run after phase 28): phase 4's model and 16
     requests (CUT_NEW new tokens each) through
     ServingEngine(megakernel=True, fused_prefill=True,
     prefill_chunk=16) over the dense, paged, int8 and paged int8 arenas
     and speculative (k 4) on the dense one, each beside the unfused
     engine on the same arena, and prefill_chunk 24 on the dense arena:
     fails unless every request is done, every logits tensor finite, no
     bucketed prefill ran, each fused step called the arena's decode
     wrapper once a layer at the step's width (16; 24 as two launches) and
     nothing else of B2/B3, and the greedy tokens equal the unfused
     engine's or part first at a near-tie of its run (printed: where they
     part and how many tokens that compared); then, teacher-forced, each
     prompt and the unfused tokens up to where they part as one prompt:
     the completing step's logits of the fused kernel engine within
     LOGITS_ATOL of the fused einsum engine's and of the cacheless
     prefill's; prints tokens/s,
     time to first token (mean, p50, p99), chunk ms, prompt tokens
     consumed inline and launches a step of both, and a steady fused
     chunk's idle share (the *_sq16 rows' launches);
 39. decode at head dim 80 (after phase 38): ServingEngine(megakernel=True)
     at GPT 2.7B's width (d_model 2560, 32 heads of 80, d_ff 10240, bf16)
     cut to D80_LAYERS layers (printed), phase 4's requests over the four
     arenas, each beside the megakernel=False engine (the einsum) on the
     same arena: every request done, logits finite, the arena's kernel L
     times a step and no other, greedy tokens equal or parting at a
     near-tie (the *_d80 decode rows' launches);
 40. GPT-Neo 1.3B (after phase 39): EleutherAI's config.json (24 layers
     alternating global and local attention of window 256, 16 heads of
     128, d_model 2048, vocab 50257, unscaled scores; cut to NEO_LAYERS
     12 to fit the time limit), an HF-named state dict from
     --seed converted on the card by HFGPTNeoPolicy; the forward on [2,
     1024] through B1 at the 6 global layers (scale 1.0;
     the local ones take the windowed einsum) against attention_impl="xla"
     within LOGITS_ATOL; greedy generate of 32 tokens; phase 4's requests
     (CUT_NEW new tokens each) through the dense, fused (prefill_chunk
     16) and speculative (k 4)
     megakernel engines beside megakernel=False: B2 6 times a step at the
     step's width, B4 never (vocab not lane-aligned), tokens equal or
     parting at a near-tie; paged=True must raise; then B1 at [2, 1024,
     16, 128] scale 1.0 and B2 at h 16, d 128, S 2048, s_q 1 and 16
     against their plain versions and timed (the *_neo rows);
 41. int8 weights (after phase 40): the same GPT-Neo through
     InferenceEngine(quantize_bits=8), symmetric and asymmetric: weights
     at rest and the build's max_memory_allocated against bf16's, every
     int8 Linear bitwise the plain quantize / dequantize of its bf16
     weight, the forward (B1 6 times) against a bf16 model over the
     dequantized weights within LOGITS_ATOL, max |logit - bf16 engine| and
     top-1 agreement printed, and ServingEngine(engine=ie, megakernel=True)
     serving phase 4's requests (B2 6 times a step; tokens/s beside
     bf16's);
 42. GPT-MoE (after phase 41): gpt_moe_1_3b at full width (24 layers
     cut to MOE_LAYERS 4 to fit the time limit, d_model
     2048, 16 heads of 128, d_ff 8192, top-1, eval
     capacity 2.0, min 4) with its 128 experts cut to 16 (128 would need
     206 GB in bf16), bf16 weights made on the card from --seed; the
     forward on [2, 1024] through B1 (a launch a layer, each held to its
     plain version) against attention_impl="xla" within LOSS_ATOL; layer 0's
     MoE on a prefill's inputs against the same function in f32
     (MOE_OUT_RTOL); phase 4's requests (CUT_NEW new tokens each) through
     the dense and fused (C 16) megakernel engines: a run with every B2 call and B4 draw held to
     its plain version and every logits tensor checked finite, printing
     the routing's capacity and dropped tokens, then a timed run (B2 once
     a layer a step at the step's width, B4 once a step, the checked run's
     tokens); tokens/s, chunk ms, weight bytes, max_memory_allocated, a
     decode step's device ms split into B2, the expert GEMMs, the
     dispatch / combine einsums and the rest; B1 at [2, 1024, 16, 128],
     B2 at s_q 1 and 16 (S 1024) and B4 at [8, 50304] against their plain
     versions, timed (the *_moe rows);
 43. its width cut to 2 layers, trained (seq 1024, micro 4 x gas 2, bf16
     over fp32 masters, AdamW, ZeRO-1, remat): losses finite and falling
     over 4 steps, l_aux finite, B1 / B1b 2 x 2 x (2, 1, 1) a step; B1 /
     B1b at [4, 1024, 16, 128] against their plain versions, timed;
 44. ep 2 on two gloo ranks sharing the card (the script re-runs itself
     with the hidden --ep-rank): a small GPT-MoE (EP_CFG, f32) trained 3
     steps at mesh {"ep": 2} against ep 1 in this process (EP_LOSS_RTOL),
     each rank holding half the expert bytes; InferenceEngine(ep_size=2)
     greedy tokens equal ep 1's or parting at a near-tie, half the expert
     bytes, a ServingEngine over it refused (ROADMAP A9);
 45. tensor parallelism (after 44): GPT-NeoX 20B (d_model 6144, 64 heads
     of 96, d_ff 24576, parallel residual, untied head) at full width, its
     44 layers cut to NEOX_LAYERS, bf16, split at tp 2 over two gloo ranks
     sharing the card (the script re-runs itself with the hidden
     --tp-rank), each rank making only its shards on the card from --seed:
     weights half the whole model's a rank, the forward on [2, 1024]
     through B1 (once a layer a rank), layer 0 and the width cut to 2
     layers against tp 1 here, phase 4's requests through
     ServingEngine(tp=2, megakernel=True) dense and paged (every B2 / B3
     call and B4 draw held to its plain version; tokens equal on both
     ranks), under tp_overlap and fused (C 16), int8 weights at the cut
     depth, tokens/s and chunk ms; then B1 / B1b at [2,
     1024, 32, 96], B2 / B3 at h 32, d 96 and B4 timed (the *_neox rows);
 46. its width cut to 2 layers, trained at tp 1 here and at mesh tp 2 on
     two ranks, without and with partition_activations: losses within
     LOSS_ATOL, falling, B1 / B1b launches a step;
 47. sequence parallelism (after 46): bench.py's long_context (GPT-2 125M
     at seq 16384, micro 1 x gas 2, bf16 over fp32 masters, remat, AdamW,
     ZeRO-1, dense flash) trained CTX_STEPS (2) steps at sp 1: losses
     finite and falling, B1 / B1b 48 / 24 / 24 a step, step seconds, peak
     memory, a
     profiled micro-step's idle share; then B1 / B1b at the four shapes
     of phases 47-48 (SP_FLASH: [1, 16384, 12, 64] causal, a Ulysses
     rank's [1, 16384, 6, 64], a ring rank's [1, 8192, 12, 64] causal and
     full blocks) against their plain versions (over head slices: the
     f32 scores of the whole sequence take 12.9e9 B) within SP_ROW_RTOL
     of each row's largest |plain| plus SP_HEAD_ATOL of the head's rms,
     and lse within LSE_ATOL, timed beside
     scaled_dot_product_attention and their bounds (the *_ctx16k,
     *_ulysses_sp2, *_ring_diag_sp2, *_ring_full_sp2 rows);
 48. the same at mesh {"sp": 2} over two gloo ranks sharing the card (the
     script re-runs itself with the hidden --sp-rank), cp_impl "ulysses"
     and "ring": all_to_all_single of a CUDA tensor over gloo checked, the
     ring's merged output and grads against the plain ring at 2 heads
     (the same bound), CTX_STEPS steps each with losses equal on both
     ranks and within LOSS_ATOL of phase 47's, B1 / B1b launches a step
     (Ulysses 48 / 24 / 24 a rank; ring 48 / 24 / 24 on rank 0, which
     runs only its diagonal blocks, and 96 / 48 / 48 on rank 1), the
     exchanges a step and their bytes, step seconds and peak memory a
     rank;
 49. (after phase 38) the sp prefill route: phase 38's dense fused engine
     with sp_prefill_threshold=SP_ROUTE_THRESHOLD beside the same engine
     without it: greedy tokens equal or parting at a near-tie, the long
     prompts' tokens through the sp leg and the short ones inline, B2 at
     the fused width and B4 in every decode step after the route.
 50. the pipeline (after 48): bench.py's ladder_zero1 (GPT-2 1.3B at full
     width and depth, seq 1024, bf16 over fp32 masters, AdamW, micro 4 x
     M 4, ZeRO-1, weights from --seed) trained PIPE_STEPS steps by the
     dense engine here, then by the 1F1B PipelineEngine at mesh {"pp": 2}
     (parts [0, 13, 27]) over two gloo ranks sharing the card (the script
     re-runs itself with the hidden --pipe-rank) from the same state dict
     and batches: losses equal on both ranks, within PIPE_LOSS_ATOL of the
     dense engine's, the first step's grad norm within PIPE_NORM_RTOL of
     its, B1 / B1b launches a step a rank (pipe_want: stage 0 96 / 48 /
     48, stage 1 48 / 48 / 48); step s, tokens/s, hop and tied-reduce
     bytes, peak memory and a profiled step's device busy share a rank;
     then B1 / B1b at the stage shape [4, 1024, 32, 64] against their
     plain versions, timed (the *_pipe rows);
 51. GPipeSpmdEngine at pp 2 in the same rank processes (M 4, remat): the
     same gates (B1 / B1b 120 / 60 / 60 a step a rank: every one of the
     M + S - 1 ticks, forward, remat recompute and backward).
 52. compressed communication, in phase 30's rank processes (after phase
     33's stages): COMPRESSED_CALLS error-feedback 1-bit all-reduces in a
     row at GPT-2 125M's padded size (124,475,904 elements, buffers and
     starting error buffers from --seed), each held to the plain exchange
     (``plain_compressed``: every rank's corrected buffer gathered whole,
     the signs packed by numpy) and then to the same calls on host copies:
     sign bytes equal, average and both error buffers within
     COMPRESSED_TOL of the input's rms, the average the same bits on both
     ranks, the bytes a rank sent and received equal to
     wire_bytes_compressed(npad, 2); ms a call;
 53. the 1-bit optimizers in the same rank processes: OneBitAdam,
     OneBitLamb (freeze_step 2, 4 steps) and ZeroOneAdam (2, 1, 1, 2: 6
     steps) train GPT-2 125M (gpt2_125m_zero1's model, micro 4 a rank x
     RESUME_GAS, ZeRO-1, lr ONEBIT_LR) on phase 29's micro-batches: the
     modes the policy gives, losses finite and equal on both ranks, the
     master's checksum equal on both after every step, the ranks' worker
     errors different after the first compressed step (gradients kept
     local), ZeroOneAdam's delta zero after each sync, B1 / B1b 12 x gas x
     steps (x 2 forward), the compression ratio and each step's wire bytes
     the formula's, OneBitAdam's two warmup steps against the dense AdamW
     without bias correction (ONEBIT_WARM_MAX, ONEBIT_WARM_LOOSE); step s,
     a rank's device busy share and max_memory_allocated by optimizer and
     mode. ``tools/check_onebit_gates.py`` runs 52-53 alone and on planted
     faults.

The training MFU (phase 8) is ``telemetry.mfu.mfu_report`` over
gpt_flops_per_token x tokens and the card's ``peak_flops_per_device``.

Prints the kernel summary JSON (the flash rows twice: the training shape,
and ``*_d80`` at the capacity shape with phase 35's launches; the rows of
phase 37's head dim also carry its launches, the training shape's phase
44's; the decode rows at s_q 5, 16 and d 80, the sparse rows at d 80, B1
and B2 at GPT-Neo's shapes, B1 / B1b, B2 and B4 at GPT-MoE's, B1 / B1b,
B2, B3 and B4 at GPT-NeoX 20B's tp-2 rank shapes with phases 45-46's
launches on rank 0, B1 / B1b at phases 47-48's shapes with their
launches, and at the pipe stage shape with phases 50-51's launches a
rank; phase 53's on rank 0 with the training shape's), each phase group's
wall seconds (``phase_wall``), the card line
and, last,
{"ok": true, "device": {...}}. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

DECODE_ATOL = 2e-2       # bf16 cache: probabilities rounded differently
DECODE_INT8_RTOL = 2e-2  # int8 cache in bf16: the plain version rounds the
#                          dequantized cache to bf16, the kernels keep f32
TOP_P_MASS_TOL = 1e-5    # top-p: f32 mass sums in another order
LOGITS_ATOL = 5e-2       # bf16 model, 12 layers of differently rounded
#                          attention outputs
FLASH_TOL = (2e-2, 2e-2)  # (atol, rtol) of bf16 out/dq/dk/dv: both round
#                          their f32 result to bf16 (2^-8 relative), and the
#                          kernels round p and ds to bf16 for the tensor cores
LSE_ATOL = 1e-3          # f32 lse: summation order over the live keys
# B1 / B1b at SP_FLASH's shapes and the sp ring check (``_close_rows``):
# |err| of an element within SP_ROW_RTOL of the largest |plain| of its row
# (the d entries of one query or key of one head) plus SP_HEAD_ATOL of its
# head's rms. At S 8192-16384 a row's entries are ~sqrt(e/n) small, below
# FLASH_TOL's atol, so the bound scales with the row: rounding (a bf16
# result, p and dS in bf16) errs by a few 2^-9 of the row, and a KV tile
# of 128 keys left out of n moves a row by about sqrt(128 / n) of its size
# (>= 2^-3.5 at n 16384). The head's share covers rows that cancel (causal
# dq of query 0 is 0 in exact arithmetic). tools/check_sp_gates.py plants
# such faults.
SP_ROW_RTOL = 2.0 ** -5
SP_HEAD_ATOL = 2.0 ** -8
LOSS_ATOL = 2e-2         # model check: the einsum rounds attention
GRAD_NORM_RTOL = 5e-2    # probabilities to bf16, the kernels keep f32
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_HEAD_DIMS = (32, 64, 80, 96, 128)
# B1/B1b at the capacity tier's GPT 2.7B shape (2560 / 32 heads: d 80, which
# the 16-bit kernels run as d 96 with zero-filled columns)
CAPACITY_FLASH = (1, 1024, 32, 80, True)
SPARSE = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
SPARSE_F32_TOL = (1e-4, 1e-4)  # f32: CUDA-core FMAs, summation order only
# bench.py's long_context_sparse configuration (bench.py:344-399)
LONG_SEQ = 32768
LONG_CONFIG = {"train_micro_batch_size_per_gpu": 1,
               "gradient_accumulation_steps": 1,
               "bf16": {"enabled": True},
               "zero_optimization": {"stage": 1},
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
               "steps_per_print": 100_000}
BERT_LENGTHS = (4096, 3000, 1500, 40)
# bench.py's gpt2_125m_zero1 configuration (bench.py:156-160)
TRAIN_MICRO, TRAIN_GAS, TRAIN_SEQ = 8, 16, 1024
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": TRAIN_MICRO,
                "gradient_accumulation_steps": TRAIN_GAS,
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "steps_per_print": 100_000}
# phases 29-30: gpt2_125m_zero1 with gas cut from 16 to fit the time limit
RESUME_GAS = 4
DP_TIMEOUT_S = 300
# phases 30 and 33: the first DP_STEPS of phase 29's 4 steps (cut to fit)
DP_STEPS = 2
# phase 31: each optimizer's config (lr picked for a falling loss in 3
# steps from random weights) and the card-vs-CPU bound of one step's
# masters: f32 elementwise math on both, LAMB's norms summed in another
# order (|card - cpu| <= atol + rtol |cpu|)
OPTIMIZERS = {"Lamb": {"lr": 1e-3, "weight_decay": 0.01},
              "Adagrad": {"lr": 1e-4},
              "SGD": {"lr": 0.05, "momentum": 0.9}}
OPT_CPU_TOL = (1e-6, 1e-5)
# phase 32: bench.py's ladder_zero3_offload (bench.py:123-186, 247-257)
LADDER_MICRO, LADDER_GAS, LADDER_SEQ = 4, 2, 1024
LADDER_CONFIG = {"train_micro_batch_size_per_gpu": LADDER_MICRO,
                 "gradient_accumulation_steps": LADDER_GAS,
                 "bf16": {"enabled": True},
                 "zero_optimization": {"stage": 3, "offload_optimizer": {
                     "device": "cpu"}},
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                 "steps_per_print": 100_000}
# bytes a parameter: on the host the fp32 master and two moments (12), the
# pinned bf16 mirror (2) and fp32 grad staging (4); on the card the bf16
# parameters (2) and the fp32 grad accumulator (4)
OFFLOAD_HOST_BYTES, OFFLOAD_DEVICE_BYTES = 18, 6
# the native AdamW step with a bf16 mirror: reads params, grads and both
# moments (16 B), writes params and moments (12 B) and the mirror (2 B)
CPU_ADAM_BYTES = 30
MASTER_CHECK_LEAF = "blocks.0.attn.qkv.weight"
# phases 52-53: the 1-bit path in phase 30's two rank processes. Phase 52
# runs COMPRESSED_CALLS exchanges in a row at GPT-2 125M's padded size;
# card, host and the plain exchange do the same f32 operations in the same
# order with every norm summed in f64, so they should agree to the bit:
# the bound is COMPRESSED_TOL of the input's rms (a few f32 ulps)
COMPRESSED_CALLS = 3
COMPRESSED_TOL = 2.0 ** -20
# phase 53: each 1-bit optimizer (config params, the modes of its steps;
# ZeroOnePolicy(2, 1, 1, 2) gives dense, dense, grad_comp, sync, local,
# sync) on phase 29's micro-batches, micro 4 a rank x RESUME_GAS
ONEBIT_LR, ONEBIT_WD = 1e-4, 0.01
ONEBIT_RUNS = {
    "OneBitAdam": ({"freeze_step": 2}, ("warmup", "warmup", "comp", "comp")),
    "OneBitLamb": ({"freeze_step": 2}, ("warmup", "warmup", "comp", "comp")),
    "ZeroOneAdam": ({"var_freeze_step": 2, "var_update_scaler": 1,
                     "local_step_scaler": 1, "local_step_clipper": 2},
                    ("dense", "dense", "grad_comp", "sync", "local",
                     "sync")),
}
# phase 53's OneBitAdam warmup against the dense AdamW without bias
# correction, after 2 steps. The two sum each element's bf16 micro-batch
# grads in another order; Adam moves an element whose gradient is rounding
# noise by up to (1 - b1) / sqrt(1 - b2) lr (3.16 lr) a step either way,
# so every master within 4 x 3.16 lr, and at most ONEBIT_WARM_LOOSE
# elements (1e-4 of them) apart by more than lr. Measured on the H100:
# at most 4.74 lr, 2,246 elements over lr (20.3e6 over 1e-2 lr, 0.57e6
# over 0.1 lr); a step with bias correction would move every element 2.16
# lr away
ONEBIT_WARM_MAX = 4 * 0.1 / math.sqrt(0.001)
ONEBIT_WARM_LOOSE = 12_500
ONEBIT_TIMEOUT_S = 600


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, n_inputs: int = 1, kernel: str = "", iters: int = 50,
              warmup: int = 5) -> float:
    """Device time per call in ms: the kernels' durations under
    torch.profiler (CUPTI), summed over ``iters`` calls. Host launch
    overhead is excluded, so small kernels are not timed at the launch rate.
    ``kernel``: count only kernels whose name contains it, launched once a
    call (else all the call's kernels). ``fn(i)`` cycles over ``n_inputs``
    input copies so a working set larger than L2 is read cold."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    # a profiler session can come back without kernel records (CUPTI),
    # late in a long process or, once in a run, early; the window is
    # measured twice more before the run fails. A window can also lose some
    # of a kernel's records (often the first launch): a named kernel is
    # averaged over those recorded
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_inputs)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if kernel in e.key and _device_us(e) > 0]
        total_us = sum(_device_us(e) for e in events)
        launches = sum(e.count for e in events)
        if total_us > 0:
            if kernel and launches < iters:
                print(f"device_ms: {launches} of {iters} {kernel} launches "
                      f"recorded; averaged over those", flush=True)
                return total_us / 1e3 / launches
            return total_us / 1e3 / iters
        print(f"device_ms: no device time recorded for "
              f"{kernel or 'the call'} (attempt {attempt + 1})", flush=True)
    fail(f"no device time recorded for {kernel or 'the call'}")


def _device_us(event) -> float:
    if "CUDA" not in str(getattr(event, "device_type", "")):
        return 0.0
    return float(getattr(event, "self_device_time_total", 0.0))


def phase_decode_attention(torch, da, dev, gen):
    errs = {}
    inputs = {}
    for s_q in (1, 4):
        q, k, v, clen = decode_case_inputs(torch, dev, gen, s_q, full=False)
        out = da.decode_attention(q, k, v, clen)
        torch.cuda.synchronize()
        ref = da.decode_attention_reference(q, k, v, clen, 1 / 8)
        if not torch.isfinite(out).all():
            fail(f"decode_attention s_q={s_q}: non-finite output")
        errs[s_q] = (out.float() - ref.float()).abs().max().item()
        print(f"phase2 decode_attention s_q={s_q} max_abs_err={errs[s_q]} "
              f"(tol {DECODE_ATOL})", flush=True)
        if not errs[s_q] <= DECODE_ATOL:
            fail(f"decode_attention s_q={s_q} disagrees: {errs[s_q]}")
        inputs[s_q] = (q, k, v, clen)
    return max(errs.values()), inputs[1]


def _top_p_differs(torch, sp, x, top_k, top_p):
    """Compare the kernel's top-p kept set (after top-k) with the plain
    version's. A token may flip only where the mass strictly above it
    (f64, over the top-k output) sits at top_p within the f32 rounding of
    the mass sums. Returns the number of differing tokens."""
    kern = sp.threshold_filter_logits(x, 1.0, top_k, top_p) > -1e9
    ref = sp.filter_rows_reference(x, top_k, top_p) > -1e9
    diff = (kern != ref).nonzero().tolist()
    p = torch.softmax(sp.filter_rows_reference(x, top_k, None).double(), -1)
    for row, idx in diff:
        above = p[row][p[row] > p[row, idx]].sum().item()
        if abs(above - top_p) > TOP_P_MASS_TOL:
            fail(f"top_k={top_k} top_p={top_p} kept sets differ beyond "
                 f"rounding at row {row} token {idx}: mass above {above}")
    return len(diff)


def phase_sampling(torch, sp, dev, gen):
    b, V = 8, 50304
    x = torch.randn(b, V, device=dev, generator=gen) * 3
    greedy = sp.fused_sample(x, None, 0.0, None)
    torch.cuda.synchronize()
    if not torch.equal(greedy, sp.fused_sample_reference(x, None, None,
                                                         None)):
        fail("greedy tokens differ from the plain version")
    topk = sp.threshold_filter_logits(x, 1.0, 50)
    topk_ref = sp.filter_rows_reference(x, 50, None)
    if not torch.equal(topk, topk_ref):
        fail("top-k=50 filtered logits are not bitwise equal")
    err = (topk - topk_ref).abs().max().item()
    n_diff = _top_p_differs(torch, sp, x, None, 0.9)
    # the candidate path: top-k, then top-p on the gathered candidates
    n_diff_kp = _top_p_differs(torch, sp, x, 50, 0.9)
    gum = -torch.log(-torch.log(
        torch.rand(b, V, device=dev, generator=gen).clamp_min(1e-30)))
    drawn = sp.fused_sample(x, gum, 0.8, 50, 0.9).long()
    kept = sp.filter_rows_reference(x / 0.8, 50, 0.9) > -1e9
    if not kept[torch.arange(b, device=dev), drawn].all():
        fail("a temperature draw fell outside the filter")
    # the draw equals the plain version's on every row where the kernel
    # keeps the same tokens
    same = ((sp.threshold_filter_logits(x, 0.8, 50, 0.9) > -1e9)
            == kept).all(-1)
    drawn_ref = sp.fused_sample_reference(x / 0.8, gum, 50, 0.9).long()
    if not torch.equal(drawn[same], drawn_ref[same]):
        fail("top_k50+top_p0.9 draws differ from the plain version's on "
             "rows with equal kept sets")
    print(f"phase3 sampling greedy=equal top_k50=bitwise top_p0.9 "
          f"differing_tokens={n_diff} top_k50+top_p0.9 "
          f"differing_tokens={n_diff_kp} draws=inside_filter "
          f"draws_equal_on_{int(same.sum())}_of_{b}_rows", flush=True)
    return x, err


def phase_serving(torch, np, dev, seed, card):
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.serving.kv_cache import SlotKVCacheManager

    cfg = gpt2_125m(max_seq_len=1024, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(16, 129, 16)]
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128)
    n_new = 64

    ServingEngine(engine=ie, megakernel=True, **kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
    mega = ServingEngine(engine=ie, megakernel=True, **kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = mega.run([p.copy() for p in prompts], max_new_tokens=n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for name in ("decode_attention", "sampling"):
        if not launches.get(name):
            fail(f"the main path never launched the {name} kernel")
    for r in out:
        if r.status != "done" or len(r.tokens) != n_new:
            fail(f"request {r.uid}: status {r.status}, "
                 f"{len(r.tokens)} tokens")
    n_tokens = sum(len(r.tokens) for r in out)
    tok_s = n_tokens / seconds
    chunk_ms = mega.metrics.mean_decode_chunk_s * 1e3
    print(f"phase4 serving gpt2_125m requests=16 tokens={n_tokens} "
          f"launches={launches}", flush=True)
    print(f"serving_tokens_per_s={tok_s} card={card}", flush=True)
    print(f"serving_mean_decode_chunk_ms={chunk_ms} (K=8, batch 8) "
          f"card={card}", flush=True)

    # the same requests again with every logits tensor of the served path
    # (prefill and each decode step) checked for non-finite values; off the
    # timed run, since the check adds a reduction per call
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    module = ie.module
    unchecked = module.logits

    def checked_logits(hidden):
        out = unchecked(hidden)
        bad.logical_or_(~torch.isfinite(out).all())
        return out

    module.logits = checked_logits
    try:
        again = ServingEngine(engine=ie, megakernel=True, **kw).run(
            [p.copy() for p in prompts], max_new_tokens=n_new)
    finally:
        del module.logits
    if bool(bad):
        fail("non-finite logits while serving through the kernels")
    if [r.tokens for r in again] != [r.tokens for r in out]:
        fail("a second megakernel run served different greedy tokens")
    print("phase4 served logits all finite; rerun tokens identical",
          flush=True)

    plain = ServingEngine(engine=ie, megakernel=False, **kw).run(
        [p.copy() for p in prompts], max_new_tokens=n_new)
    agree = sum(int(a == b) for r, s in zip(out, plain)
                for a, b in zip(r.tokens, s.tokens))
    if any(r.tokens[0] != s.tokens[0] for r, s in zip(out, plain)):
        fail("prefill's greedy first tokens differ between the engines")
    print(f"phase4 greedy tokens agreeing with the plain engine: "
          f"{agree}/{n_tokens} = {agree / n_tokens}", flush=True)

    # one decode step through the kernels vs through the plain versions,
    # from the same prefilled arena
    with torch.inference_mode():
        lens = np.array([len(p) for p in prompts[:8]])
        ids = np.zeros((8, 128), np.int64)
        for i, p in enumerate(prompts[:8]):
            ids[i, :len(p)] = p
        hidden, keys, values = model.prefill(torch.from_numpy(ids).to(dev))
        lens_t = torch.from_numpy(lens).to(dev)
        first = model.logits(hidden[torch.arange(8, device=dev),
                                    lens_t - 1]).argmax(-1)
        kv = SlotKVCacheManager(cfg, 8, dev)
        kv.insert_batch(keys, values, range(8))
        logits = {}
        for impl in ("auto", "einsum"):
            logits[impl] = model.decode(
                first[:, None], lens_t[:, None], kv.cache_k.clone(),
                kv.cache_v.clone(), lens_t, decode_impl=impl)[:, 0].float()
    if not torch.isfinite(logits["auto"]).all():
        fail("non-finite logits through the kernels")
    err = (logits["auto"] - logits["einsum"]).abs().max().item()
    same = int((logits["auto"].argmax(-1)
                == logits["einsum"].argmax(-1)).sum())
    print(f"phase4 first decode step logits max_abs_err={err} "
          f"(tol {LOGITS_ATOL}) argmax_equal_rows={same}/8", flush=True)
    if not err <= LOGITS_ATOL:
        fail(f"decode-step logits disagree: {err}")
    phase_profile(torch, ie, prompts[:8], kw, card)
    return launches, ie, prompts, kw


def phase_profile(torch, ie, prompts, kw, card, tag="phase6",
                  max_new_tokens=None):
    """Two steady decode chunks (8 live lanes, K=8 steps each): the first
    timed without the profiler, the second under torch.profiler for device
    kernel time by name. The device's idle share is one minus the profiled
    chunk's device busy time over the unprofiled chunk's wall time (the
    profiler inflates the wall time of the chunk it records). The budget
    (default 1 + 3 K) keeps every lane live through the profiled chunk."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch import ServingEngine
    eng = ServingEngine(engine=ie, **{"megakernel": True, **kw})
    for p in prompts:
        eng.submit(p.copy(), max_new_tokens=max_new_tokens
                   or 1 + 3 * kw["decode_chunk"])
    eng.step()                       # admission, prefill, first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                       # one pure decode chunk, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()                   # the next one, profiled
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a decode chunk")
    print(f"{tag} profile decode chunk wall_ms={wall_ms} (unprofiled) "
          f"profiled_wall_ms={profiled_wall_ms} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"{tag} kernel ms={ms} count={count} {key[:90]}", flush=True)
    return busy_ms, rows


def phase_sampled_serving(torch, ie, prompts, kw, seed, card):
    """Phase 25: phase 4's requests drawn at temperature 0.8 with top-k 50
    and top-p 0.9, so every decode step runs the filtering B4 kernel."""
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.ops.cuda import _build
    skw = dict(kw, megakernel=True, temperature=0.8, top_k=50, top_p=0.9)
    n_new = CUT_NEW

    def serve():
        return ServingEngine(engine=ie, seed=seed, **skw).run(
            [p.copy() for p in prompts], max_new_tokens=n_new)

    ServingEngine(engine=ie, seed=seed, **skw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if not launches.get("sampling"):
        fail(f"sampled serving never launched the sampling kernel: "
             f"{launches}")
    for r in out:
        if r.status != "done" or len(r.tokens) != n_new:
            fail(f"sampled request {r.uid}: status {r.status}, "
                 f"{len(r.tokens)} tokens")
    n_tokens = sum(len(r.tokens) for r in out)
    if [r.tokens for r in serve()] != [r.tokens for r in out]:
        fail("a rerun with the same seed sampled different tokens")
    print(f"phase25 sampled serving gpt2_125m temperature=0.8 top_k=50 "
          f"top_p=0.9 requests=16 tokens={n_tokens} launches={launches}; "
          f"rerun with the same seed: tokens identical", flush=True)
    print(f"sampled_serving_tokens_per_s={n_tokens / seconds} card={card}",
          flush=True)
    busy_ms, rows = phase_profile(torch, ie, prompts[:8], skw, card,
                                  tag="phase25")
    k = kw["decode_chunk"]
    b4_ms = sum(ms for ms, _, key in rows if "sampling_kernel" in key)
    if b4_ms <= 0:
        fail("the profiled sampled chunk recorded no sampling kernel")
    print(f"phase25 sampling_kernel_ms_per_step={b4_ms / k} "
          f"step_device_busy_ms={busy_ms / k} share={b4_ms / busy_ms} "
          f"(K={k}, batch 8) card={card}", flush=True)


# B4's timed modes (tools/time_sampling.py times the same): (case, b, V,
# mode, top_k, top_p); serving's shape, a wide batch at a 128K vocabulary,
# and the smallest launch the C interface makes (the practical floor)
SAMPLING_TIME_CASES = (
    ("greedy", 8, 50304, "greedy", None, None),
    ("filter_top_k50_top_p0.9", 8, 50304, "filter", 50, 0.9),
    ("filter_top_p0.9", 8, 50304, "filter", None, 0.9),
    ("filter_top_k50", 8, 50304, "filter", 50, None),
    ("draw_top_k50_top_p0.9", 8, 50304, "draw", 50, 0.9),
    ("filter_top_k50_top_p0.9_b64_v131072", 64, 131072, "filter", 50, 0.9),
    ("filter_top_p0.9_b64_v131072", 64, 131072, "filter", None, 0.9),
    ("launch_floor_greedy_b1_v128", 1, 128, "greedy", None, None),
)


def sampling_time_cases(torch, sp, dev, gen):
    """B4's device ms per call in each of SAMPLING_TIME_CASES (logits
    3 * N(0, 1), temperature 1, or 0.8 with a gumbel row for the draw)
    beside its plain version's, its byte bound (read the logits, and the
    gumbel row, once; write the filtered row or the tokens once) and a
    PyTorch yardstick: greedy torch.argmax; top-k alone torch.topk(x, 50);
    the filters the sort-based serving.sampling.filter_logits (several
    calls); the draw that filter then torch.argmax of the filtered row +
    gumbel."""
    from deepspeed_tpu_torch.serving.sampling import filter_logits
    out = {}
    for case, b, V, mode, top_k, top_p in SAMPLING_TIME_CASES:
        x = torch.randn(b, V, device=dev, generator=gen) * 3
        gum = -torch.log(-torch.log(torch.rand(
            b, V, device=dev, generator=gen).clamp_min(1e-30)))
        if mode == "greedy":
            def fn(i):
                sp.fused_sample(x, None, 0.0, None)

            def plain(i):
                sp.fused_sample_reference(x, None, None, None)

            def yard(i):
                torch.argmax(x, dim=-1)
            yard_name, nbytes = "torch.argmax", b * V * 4 + b * 4
        elif mode == "filter":
            def fn(i):
                sp.threshold_filter_logits(x, 1.0, top_k, top_p)

            def plain(i):
                sp.filter_rows_reference(x, top_k, top_p)
            if top_p is None:
                def yard(i):
                    torch.topk(x, top_k, dim=-1)
                yard_name = f"torch.topk(x, {top_k})"
            else:
                def yard(i):
                    filter_logits(x, 1.0, top_k, top_p)
                yard_name = "serving.sampling.filter_logits"
            nbytes = 2 * b * V * 4
        else:
            def fn(i):
                sp.fused_sample(x, gum, 0.8, top_k, top_p)

            def plain(i):
                sp.fused_sample_reference(x / 0.8, gum, top_k, top_p)

            def yard(i):
                torch.argmax(filter_logits(x, 0.8, top_k, top_p) + gum,
                             dim=-1)
            yard_name = "filter_logits + argmax(y + gumbel)"
            nbytes = 2 * b * V * 4 + b * 4
        out[case] = {
            "b": b, "V": V,
            "ms": device_ms(fn, kernel="sampling_kernel"),
            "plain_ms": device_ms(plain, iters=10),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  b * V / F32_FLOPS),
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= b * V / F32_FLOPS else "operations",
            "yardstick": yard_name,
            "yardstick_ms": device_ms(yard)}
        del x, gum
    return out


def phase_timing(torch, da, qz, sp, dev, gen, decode_inputs, logits,
                 card):
    import torch.nn.functional as F
    q, k, v, clen = decode_inputs
    b, s_q, h, d = q.shape
    S = k.shape[1]
    # 8 cache copies (8 x 25 MB) so each call reads its K/V cold from HBM,
    # as a layer's call does in the model
    copies = [(k.clone(), v.clone()) for _ in range(8)]
    mask = (torch.arange(S, device=dev)[None, :]
            < clen.clamp(max=S)[:, None])[:, None, None, :]

    def kernel(i):
        da.decode_attention(q, copies[i][0], copies[i][1], clen)

    def plain(i):
        da.decode_attention_reference(q, copies[i][0], copies[i][1], clen,
                                      1 / 8)

    def library(i):
        kk = copies[i][0].view(b, S, h, d).transpose(1, 2)
        vv = copies[i][1].view(b, S, h, d).transpose(1, 2)
        F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                       attn_mask=mask, scale=1 / 8)

    live = clen.clamp(max=S).sum().item()
    item = k.element_size()
    da_bytes = 2 * live * h * d * item + 2 * q.numel() * item + 4 * b
    da_flops = 4 * live * h * d * s_q
    da_bound = 1e3 * max(da_bytes / HBM_BYTES_PER_S, da_flops / BF16_FLOPS)
    da_t = {"ms": device_ms(kernel, 8, "decode_attention_kernel"),
            "plain_ms": device_ms(plain, 8),
            "library_ms": device_ms(library, 8)}

    x = logits
    B, V = x.shape
    sp_t = {
        "ms": device_ms(lambda i: sp.fused_sample(x, None, 0.0, None),
                        kernel="sampling_kernel"),
        "plain_ms": device_ms(lambda i: sp.fused_sample_reference(
            x, None, None, None)),
        "library_ms": device_ms(lambda i: torch.argmax(x, dim=-1)),
    }
    sp_bytes = B * V * 4 + B * 4
    sp_bound = 1e3 * max(sp_bytes / HBM_BYTES_PER_S, B * V / F32_FLOPS)
    for name, t, bound in (("decode_attention", da_t, da_bound),
                           ("sampling", sp_t, sp_bound)):
        for key, val in t.items():
            print(f"{name}_{key}={val} card={card}", flush=True)
        print(f"{name}_bound_ms={bound} card={card}", flush=True)
    for case, row in sampling_time_cases(torch, sp, dev, gen).items():
        print(f"sampling_{case}: " + " ".join(
            f"{key}={val}" for key, val in row.items()) + f" card={card}",
            flush=True)
    print_decode_cases(torch, da, qz, dev, gen, ("decode_attention",),
                       "phase5", card)
    return (da_t, da_bound, "bytes" if da_bytes / HBM_BYTES_PER_S
            >= da_flops / BF16_FLOPS else "operations"), \
        (sp_t, sp_bound, "bytes" if sp_bytes / HBM_BYTES_PER_S
         >= B * V / F32_FLOPS else "operations")


def _close(got, ref, atol, rtol, rows=False) -> float:
    """max |got - ref| after checking |got - ref| <= atol + rtol |ref|;
    with ``rows``, rtol scales the largest |ref| of the element's row (the
    last dim) instead: a sum over thousands of bf16-rounded terms errs with
    the size of its terms, which a row's largest entry tracks and a
    cancelled small entry does not (used only at sparse BERT's padded
    shape, phase 17)."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        fail("non-finite kernel output")
    diff = (got - ref).abs()
    scale = ref.abs().amax(-1, keepdim=True) if rows else ref.abs()
    bad = diff > atol + rtol * scale
    if bool(bad.any()):
        at = tuple(bad.nonzero()[0].tolist())
        fail(f"kernel disagrees with its plain version: max abs err "
             f"{diff.max().item()}; first violation at {at}: "
             f"{got[at].item()} vs {ref[at].item()}")
    return diff.max().item()


def _row_atol(ref):
    """SP_HEAD_ATOL of the rms of each head (dim 2) of a [B, S, H, D]
    tensor."""
    return SP_HEAD_ATOL * ref.float().pow(2).mean((0, 1, 3),
                                                  keepdim=True).sqrt()


def _close_rows(got, ref) -> float:
    """``_close`` under the sp bound: SP_ROW_RTOL of the row's largest
    |ref| plus ``_row_atol``."""
    return _close(got, ref, _row_atol(ref), SP_ROW_RTOL, rows=True)


def _row_share(got, ref) -> float:
    """max |got - ref| over the bound of ``_close_rows`` (it passes at
    <= 1)."""
    ref = ref.float()
    bound = _row_atol(ref) + SP_ROW_RTOL * ref.abs().amax(-1, keepdim=True)
    return ((got.float() - ref).abs() / bound).max().item()


def _qkv(torch, dev, gen, B, S, H, D):
    """bf16 q, k, v as views of one fused [B, S, 3*H*D] projection output
    (the model's layout) and a random dO."""
    qkv = torch.randn(B, S, 3 * H * D, device=dev, generator=gen).bfloat16()
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, -1))
    do = torch.randn(B, S, H, D, device=dev, generator=gen).bfloat16()
    return q, k, v, do


def _flash_results(torch, fa, q, k, v, do, causal, plain_heads=None):
    """The three flash kernels once each and their plain versions: yields
    (name, kernel result, plain result) for "out", "lse", then "dq", "dk"
    and "dv" by head slices. ``plain_heads``: the plain versions run over
    slices of that many heads (the kernels over all)."""
    scale = q.shape[-1] ** -0.5
    H = q.shape[2]
    parts = [slice(h, h + (plain_heads or H)) for h in
             range(0, H, plain_heads or H)]
    out, lse = fa.flash_attention_forward(q, k, v, causal, scale)
    refs = [fa.flash_attention_forward_reference(
        q[:, :, h], k[:, :, h], v[:, :, h], causal, scale) for h in parts]
    ro = torch.cat([r[0] for r in refs], 2)
    rl = torch.cat([r[1] for r in refs], 1)
    del refs
    grads = fa.flash_attention_backward(q, k, v, ro, rl, do, causal, scale)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or any(g.dtype != q.dtype for g in grads):
        fail("a flash kernel returned another dtype than its inputs'")
    yield "out", out, ro
    yield "lse", lse, rl
    for h in parts:
        ref = fa.flash_attention_backward_reference(
            q[:, :, h], k[:, :, h], v[:, :, h], ro[:, :, h], rl[:, h],
            do[:, :, h], causal, scale)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            yield name, got[:, :, h], want
        del ref


FLASH_KEYS = {"out": "flash_fwd", "lse": "lse", "dq": "flash_bwd_dq",
              "dk": "flash_bwd_dkv", "dv": "flash_bwd_dkv"}


def _flash_pair(torch, fa, q, k, v, do, causal, plain_heads=None,
                rows=False):
    """The three flash kernels once each against the plain versions
    (``_flash_results``): out and the grads within FLASH_TOL, or with
    ``rows`` within ``_close_rows``'s bound (then ``e["row"]`` holds each
    one's ``_row_share``), lse within LSE_ATOL.
    Returns (max abs errs, (plain out, plain lse))."""
    e = dict.fromkeys(FLASH_KEYS.values(), 0.0)
    row, plain = {}, {}
    for name, got, ref in _flash_results(torch, fa, q, k, v, do, causal,
                                         plain_heads):
        if name == "lse":
            err = _close(got, ref, LSE_ATOL, 0.0)
        elif rows:
            err = _close_rows(got, ref)
            row[name] = max(row.get(name, 0.0), _row_share(got, ref))
        else:
            err = _close(got, ref, *FLASH_TOL)
        e[FLASH_KEYS[name]] = max(e[FLASH_KEYS[name]], err)
        if name in ("out", "lse"):
            plain[name] = ref
    if rows:
        e["row"] = row
    return e, (plain["out"], plain["lse"])


def phase_flash_parity(torch, fa, dev, gen):
    errs, train_inputs = {}, None
    # the training shapes of phases 8 (125M) and 32 (1.3B, the ladder), and
    # a ragged non-causal tail
    for tag, (B, S, H, D, causal) in (("train", (8, 1024, 12, 64, True)),
                                      ("ladder", (4, 1024, 32, 64, True)),
                                      ("tail", (2, 1000, 12, 64, False)),
                                      ("capacity", CAPACITY_FLASH)):
        q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
        e, (ro, rl) = _flash_pair(torch, fa, q, k, v, do, causal)
        print(f"phase7 flash {tag} B={B} S={S} H={H} D={D} causal={causal} "
              f"bf16 max_abs_err out={e['flash_fwd']} lse={e['lse']} "
              f"dq={e['flash_bwd_dq']} dk_dv={e['flash_bwd_dkv']} (tol "
              f"atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]}, lse {LSE_ATOL})",
              flush=True)
        if tag == "train":
            errs, train_inputs = e, (q, k, v, do, ro, rl)
        elif tag == "ladder":
            errs = {key: max(val, e[key]) for key, val in errs.items()}
        elif tag == "capacity":
            cap_errs = e
        del q, k, v, do, ro, rl
    # the Hopper kernels over their dtypes and head dims, S a multiple of
    # the 128-row block, a ragged tail, and shorter than one block
    worst = {}
    for dtype in (torch.bfloat16, torch.float16):
        for D in FLASH_HEAD_DIMS:
            for causal in (True, False):
                for S in (1024, 1000, 77):
                    q, k, v, do = (t.to(dtype) for t in _qkv(
                        torch, dev, gen, 2, S, 3, D))
                    e, _ = _flash_pair(torch, fa, q, k, v, do, causal)
                    for key, val in e.items():
                        worst[key] = max(worst.get(key, 0.0), val)
                    print(f"phase7 flash {str(dtype)[6:]} B=2 S={S} H=3 "
                          f"D={D} causal={causal} max_abs_err " + " ".join(
                              f"{k_}={v_:.3g}" for k_, v_ in e.items()),
                          flush=True)
    print(f"phase7 flash grid (bf16/fp16 x D {FLASH_HEAD_DIMS} x causal x "
          f"S 1024/1000/77) worst max_abs_err {worst} (tol atol "
          f"{FLASH_TOL[0]} + rtol {FLASH_TOL[1]} |ref|, lse {LSE_ATOL})",
          flush=True)
    # no atomics: a second backward gives bitwise the same grads
    q, k, v, do, ro, rl = train_inputs
    first, again = (fa.flash_attention_backward(q, k, v, ro, rl, do, True,
                                                64 ** -0.5)
                    for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("a second flash backward gave different grads")
    print("phase7 flash train: a second backward bitwise equal", flush=True)
    return errs, train_inputs, cap_errs


def phase_training(torch, np, dev, seed, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import (GPT, gpt2_125m,
                                                gpt_flops_per_token,
                                                lm_loss_fn)
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.telemetry.mfu import (mfu_report,
                                                   peak_flops_per_device)
    cfg = gpt2_125m(max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=TRAIN_CONFIG)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)
    losses, norms, secs = [], [], []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for _ in range(5):                 # 2 warm-up + 3 timed steps
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}] * TRAIN_GAS))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    print(f"phase8 training gpt2_125m losses={losses} grad_norms={norms} "
          f"step_s={secs} launches={launches}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 5 steps: {losses}")
    per_step = cfg.num_layers * TRAIN_GAS
    want = {"flash_fwd": 5 * 2 * per_step, "flash_bwd_dq": 5 * per_step,
            "flash_bwd_dkv": 5 * per_step}
    if launches != want:
        fail(f"flash launch counts {launches}, expected {want}")
    step_s = sum(secs[2:]) / 3
    tokens = TRAIN_MICRO * TRAIN_SEQ * TRAIN_GAS
    report = mfu_report(
        flops_per_call=gpt_flops_per_token(cfg, TRAIN_SEQ) * tokens,
        calls=3, wall_s=sum(secs[2:]), peak_flops=peak_flops_per_device(dev),
        label="gpt2_125m_zero1 train_batch")
    print(f"train_step_s={step_s} card={card}", flush=True)
    print(f"train_tokens_per_s={tokens / step_s} card={card}", flush=True)
    print(f"train_mfu={report['mfu']} (vs "
          f"{report['peak_flops_per_device']} FLOP/s bf16) mfu_report="
          f"{json.dumps(report)} card={card}", flush=True)
    return engine, cfg, torch.from_numpy(ids).long().to(dev), launches


def phase_model_check(torch, dev, engine, cfg, ids):
    """One micro-batch of the trained weights through the kernels and
    through the masked einsum, both bf16."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    result = {}
    for impl in ("auto", "xla"):
        m = GPT(dataclasses.replace(cfg, attention_impl=impl),
                device=dev).to(torch.bfloat16)
        m.load_state_dict(engine.module.state_dict())
        loss = lm_loss_fn(m(ids), {"input_ids": ids})
        loss.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m
    (lk, nk), (lx, nx) = result["auto"], result["xla"]
    print(f"phase9 model check loss kernels={lk} einsum={lx} (atol "
          f"{LOSS_ATOL}); grad norm kernels={nk} einsum={nx} (rtol "
          f"{GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lx) <= LOSS_ATOL and abs(nk - nx) <= GRAD_NORM_RTOL * nx):
        fail("the model through the kernels disagrees with the einsum path")


def phase_train_profile(torch, engine, ids, card, tag="phase10"):
    """One micro-step (forward + backward of one micro-batch) after a
    warm-up one, timed without the profiler (host issue time: until the
    calls return; wall: until the device is done), then one under it; idle
    share against the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    batch = {"input_ids": ids}
    engine.backward(engine(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.backward(engine(batch))
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.backward(engine(batch))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a training micro-step")
    print(f"{tag} profile train micro-step wall_ms={wall_ms} (unprofiled) "
          f"host_issue_ms={issue_ms} device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"{tag} kernel ms={ms} count={count} {key[:90]}", flush=True)
    return wall_ms, busy_ms


def _flash_times(torch, fa, q, k, v, do, out, lse, causal, scale=None,
                 plain_heads=None):
    """Device ms per call of the three kernels, their plain versions and
    scaled_dot_product_attention (forward, and its autograd backward: a
    yardstick, never called by the port), with each kernel's bound; the
    score scale defaults to D^-0.5. ``plain_heads``: a plain call covers
    every head in slices of that many (its f32 scores would not fit
    whole)."""
    import torch.nn.functional as F
    B, S, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    parts = [slice(h, h + (plain_heads or H)) for h in
             range(0, H, plain_heads or H)]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)
    do_t = do.transpose(1, 2).contiguous()

    def backward(i):
        fa.flash_attention_backward(q, k, v, out, lse, do, causal, scale)

    def plain_forward(i):
        for h in parts:
            fa.flash_attention_forward_reference(
                q[:, :, h], k[:, :, h], v[:, :, h], causal, scale)

    def plain_backward(i):
        for h in parts:
            fa.flash_attention_backward_reference(
                q[:, :, h], k[:, :, h], v[:, :, h], out[:, :, h], lse[:, h],
                do[:, :, h], causal, scale)

    def sdpa_backward(i):
        torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t, retain_graph=True)

    plain_bwd = device_ms(plain_backward, iters=10)
    sdpa_bwd = device_ms(sdpa_backward)
    t = {
        "flash_fwd": {
            "ms": device_ms(lambda i: fa.flash_attention_forward(
                q, k, v, causal, scale), kernel="flash_fwd"),
            "plain_ms": device_ms(plain_forward, iters=10),
            "library_ms": device_ms(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale))},
        # the plain and library backward compute dq, dk and dv together:
        # their times stand beside both kernels
        "flash_bwd_dq": {"ms": device_ms(backward, kernel="flash_bwd_dq"),
                         "plain_ms": plain_bwd, "library_ms": sdpa_bwd},
        "flash_bwd_dkv": {"ms": device_ms(backward, kernel="flash_bwd_dkv"),
                          "plain_ms": plain_bwd, "library_ms": sdpa_bwd},
    }
    # bytes: each input read once, each output written once; operations: 2
    # per multiply-add over the visible (q, k) pairs, at the 16-bit peak
    item = q.element_size()
    n = B * S * H * D * item                 # one [B, S, H, D] tensor
    stat = B * H * S * 4                     # one f32 [B, H, S] vector
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    work = {"flash_fwd": (4 * n + stat, 4 * D * pairs),
            "flash_bwd_dq": (5 * n + 2 * stat, 6 * D * pairs),
            "flash_bwd_dkv": (6 * n + 2 * stat, 8 * D * pairs)}
    for name, (nbytes, flops) in work.items():
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name]["bound_ms"] = 1e3 * max(tb, tf)
        t[name]["bound_by"] = "bytes" if tb >= tf else "operations"
    return t


def _issue_us(torch, fn, n: int = 100) -> float:
    """Host time to issue one call (until it returns), over n calls in a
    row after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_flash_timing(torch, fa, dev, gen, inputs, card):
    """The training shape (its entries feed the kernels line), then the
    layer's unmasked shape, the training shape in fp16 and at d = 96, and
    the capacity tier's d = 80 shape (its entries feed the d 80 rows); the
    host issue time of one forward and one backward call."""
    q, k, v, do, out, lse = inputs
    t = _flash_times(torch, fa, q, k, v, do, out, lse, True)
    for name, vals in t.items():
        for key, val in vals.items():
            print(f"{name}_{key}={val} card={card}", flush=True)
    for tag, (B, S, H, D, causal, dtype) in (
            ("layer", (8, 512, 16, 64, False, torch.bfloat16)),
            ("train_fp16", (8, 1024, 12, 64, True, torch.float16)),
            ("train_d96", (8, 1024, 8, 96, True, torch.bfloat16)),
            ("capacity_d80", CAPACITY_FLASH + (torch.bfloat16,))):
        xs = [x.to(dtype) for x in _qkv(torch, dev, gen, B, S, H, D)]
        o, l = fa.flash_attention_forward(*xs[:3], causal, D ** -0.5)
        extra = _flash_times(torch, fa, *xs, o, l, causal)
        if tag == "capacity_d80":
            t_d80 = extra
        for name, vals in extra.items():
            print(f"phase11 {tag} B={B} S={S} H={H} D={D} causal={causal} "
                  f"{str(dtype)[6:]} {name} " + " ".join(
                      f"{key}={val}" for key, val in vals.items())
                  + f" card={card}", flush=True)
        del xs, o, l, extra
    scale = q.shape[-1] ** -0.5
    fwd_us = _issue_us(torch, lambda: fa.flash_attention_forward(
        q, k, v, True, scale))
    bwd_us = _issue_us(torch, lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, True, scale))
    print(f"phase11 host issue us per call: forward={fwd_us} "
          f"backward (delta, dq, dk/dv)={bwd_us} card={card}", flush=True)
    return t, t_d80


def bench_sparsity(heads: int = 12):
    """bench.py's long-context layout (bench.py:365-371)."""
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    return BigBirdSparsityConfig(num_heads=heads, block=64,
                                 different_layout_per_head=False,
                                 num_random_blocks=3,
                                 num_sliding_window_blocks=3,
                                 num_global_blocks=1)


def live_causal_pairs(sparsity, S: int, batch: int) -> int:
    """The (query, key) pairs a causal layout at S lets attend, over heads
    and batch rows, counted from the fine layout: block^2 per live block
    below the diagonal, block (block + 1) / 2 per diagonal block (the work
    of one call, for the bounds)."""
    import numpy as np
    lay = np.asarray(sparsity.make_layout(S), bool)
    b = sparsity.block
    below = int(np.tril(lay, -1).sum())
    diagonal = int(np.trace(lay, axis1=1, axis2=2).sum())
    return batch * (below * b * b + diagonal * b * (b + 1) // 2)


def _layout(cfg, S, causal, dev):
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import compiled_layout
    return compiled_layout(cfg, S, causal).on(dev)


@contextlib.contextmanager
def plain_sparse(sa):
    """Route the SparseAttention autograd function through the plain
    versions (on the card they are reached only here, for comparison)."""
    saved = sa.sparse_attention_forward, sa.sparse_attention_backward
    sa.sparse_attention_forward = sa.sparse_attention_forward_reference
    sa.sparse_attention_backward = sa.sparse_attention_backward_reference
    try:
        yield
    finally:
        sa.sparse_attention_forward, sa.sparse_attention_backward = saved


def _over_bound(got, ref, atol, rtol):
    """(largest |got - ref| / (atol + rtol |ref|), elements above 1): the
    elementwise reading where the check uses the row-scaled bound."""
    ratio = (got.float() - ref.float()).abs() / (atol + rtol
                                                 * ref.float().abs())
    return ratio.max().item(), int((ratio > 1).sum())


def _sparse_pair(torch, sa, layout, q, k, v, do, kvm, tol, rows=False):
    """Kernels vs plain versions on one input (elementwise bound; ``rows``:
    the row-scaled one, and the elementwise reading printed beside it): max
    abs errs, and the plain forward's out/lse and the kernels' grads."""
    scale = q.shape[-1] ** -0.5
    out, lse = sa.sparse_attention_forward(q, k, v, layout, scale, kvm)
    ro, rl = sa.sparse_attention_forward_reference(q, k, v, layout, scale,
                                                   kvm)
    grads = sa.sparse_attention_backward(q, k, v, ro, rl, do, layout, scale,
                                         kvm)
    refs = sa.sparse_attention_backward_reference(q, k, v, ro, rl, do,
                                                  layout, scale, kvm)
    torch.cuda.synchronize()
    if rows:
        print("phase17 elementwise reading (largest |err| / (atol + rtol "
              "|ref|), elements above 1): " + " ".join(
                  f"{name}={_over_bound(g, r, *tol)}" for name, g, r in
                  zip(("out", "dq", "dk", "dv"), (out, *grads),
                      (ro, *refs))), flush=True)
    e = {"sparse_fwd": _close(out, ro, *tol, rows=rows),
         "lse": _close(lse, rl, LSE_ATOL, 0.0),
         "sparse_bwd_dq": _close(grads[0], refs[0], *tol, rows=rows),
         "sparse_bwd_dkv": max(_close(grads[1], refs[1], *tol, rows=rows),
                               _close(grads[2], refs[2], *tol, rows=rows))}
    return e, (out, lse, ro, rl, grads)


class _HoleyLayout:
    """Windows of 2 blocks of 16, no global block; key blocks 8.. are seen
    by no query (empty column LUTs) and query blocks 8.. see nothing."""
    block, attention = 16, "bidirectional"

    def __init__(self, heads):
        self.heads = heads

    def make_layout(self, seq_len):
        import numpy as np
        nb = seq_len // 16
        lay = np.zeros((self.heads, nb, nb), np.int64)
        for i in range(nb):
            lay[:, i, (i // 2) * 2:(i // 2) * 2 + 2] = 1
        lay[:, :, 8:] = 0
        return lay


def phase_sparse_parity(torch, sa, dev, gen):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    worst = {}
    for dtype, tol in ((torch.bfloat16, FLASH_TOL),
                       (torch.float16, FLASH_TOL),
                       (torch.float32, SPARSE_F32_TOL)):
        # d = 96 (gpt_neox_20b's head dim) and d = 80 (GPT 2.7B's: the
        # 16-bit kernels' d 96 instances over zero-filled columns 80-95),
        # block 32, S a partial tile; d 80 also with a key-padding mask
        cfg = BigBirdSparsityConfig(num_heads=4, block=32,
                                    different_layout_per_head=True,
                                    num_random_blocks=2)
        for D, masks in ((96, (False,)), (80, (False, True))):
            for causal in (True, False):
                for masked in masks:
                    q, k, v, do = (t.to(dtype) for t in _qkv(
                        torch, dev, gen, 2, 480, 4, D))
                    kvm = None
                    if masked:
                        kvm = torch.ones(2, 480, device=dev)
                        kvm[1, 200:] = 0
                    e, (*_, grads) = _sparse_pair(
                        torch, sa, _layout(cfg, 480, causal, dev), q, k, v,
                        do, kvm, tol)
                    if masked and (grads[1][1, 200:].any()
                                   or grads[2][1, 200:].any()):
                        fail(f"D={D}: non-zero dk/dv at masked keys")
                    print(f"phase12 sparse {str(dtype)[6:]} D={D} block=32 "
                          f"S=480 causal={causal} masked={masked} "
                          f"max_abs_err " + " ".join(
                              f"{k_}={v_:.3g}" for k_, v_ in e.items()),
                          flush=True)
        for block in (16, 32, 64, 128):
            S = 480 if block == 16 else 512     # 480: a partial last tile
            cfg = BigBirdSparsityConfig(num_heads=4, block=block,
                                        different_layout_per_head=True,
                                        num_random_blocks=2)
            for causal in (True, False):
                for masked in (False, True):
                    q, k, v, do = _qkv(torch, dev, gen, 2, S, 4, 64)
                    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
                    kvm = None
                    if masked:
                        kvm = torch.ones(2, S, device=dev)
                        kvm[0, 300:] = 0
                    e, (*_, grads) = _sparse_pair(
                        torch, sa, _layout(cfg, S, causal, dev), q, k, v,
                        do, kvm, tol)
                    if masked and (grads[1][0, 300:].any()
                                   or grads[2][0, 300:].any()):
                        fail("non-zero dk/dv at masked keys")
                    for key, val in e.items():
                        worst[key] = max(worst.get(key, 0.0), val)
                    print(f"phase12 sparse {str(dtype)[6:]} block={block} "
                          f"S={S} causal={causal} masked={masked} "
                          f"max_abs_err " + " ".join(
                              f"{k_}={v_:.3g}" for k_, v_ in e.items()),
                          flush=True)
        # dead query rows and key tiles no query reaches
        q, k, v, do = (t.to(dtype) for t in _qkv(torch, dev, gen, 2, 256,
                                                  2, 64))
        kvm = torch.ones(2, 256, device=dev)
        kvm[1, 40:] = 0
        _, (out, lse, *_, (dq, dk, dv)) = _sparse_pair(
            torch, sa, _layout(_HoleyLayout(2), 256, False, dev), q, k, v,
            do, kvm, tol)
        if (out[:, 128:].any() or out[1, 64:].any() or dq[:, 128:].any()
                or dk[:, 128:].any() or dv[:, 128:].any()
                or not bool((lse[:, :, 128:] == -1e30).all())
                or not bool((lse[1, :, 64:] == -1e30).all())
                or not bool((lse[0, :, :128] > -1e30).all())):
            fail("dead rows / unreached key tiles are not zero, or a dead "
                 "row's lse is not exactly -1e30")
        print(f"phase12 sparse {str(dtype)[6:]} dead rows and unreached key "
              f"tiles: zeros, lse -1e30", flush=True)
    print(f"phase12 sparse grid worst max_abs_err {worst} (tol bf16 and "
          f"fp16 atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]} |ref|, f32 "
          f"{SPARSE_F32_TOL})", flush=True)
    # the training shape with the bench's layout: a second forward gives
    # bitwise the same out and lse; its global key tile is split over 512 /
    # DKV_CHUNK dk/dv items, whose partials are summed in a fixed order: a
    # second backward gives bitwise the same grads
    layout = _layout(bench_sparsity(12), LONG_SEQ, True, dev)
    q, k, v, do = _qkv(torch, dev, gen, 1, LONG_SEQ, 12, 64)
    e, (out, lse, ro, rl, grads) = _sparse_pair(torch, sa, layout, q, k, v,
                                                do, None, FLASH_TOL)
    again = sa.sparse_attention_forward(q, k, v, layout, 64 ** -0.5)
    if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
        fail("a second sparse forward gave a different out or lse")
    again = sa.sparse_attention_backward(q, k, v, ro, rl, do, layout,
                                         64 ** -0.5)
    if not all(torch.equal(a, g) for a, g in zip(again, grads)):
        fail("a second sparse backward gave different grads")
    print(f"phase12 sparse train B=1 S={LONG_SEQ} H=12 D=64 bf16 causal "
          f"BigBird block 64 max_abs_err " + " ".join(
              f"{k_}={v_}" for k_, v_ in e.items())
          + "; a second forward and a second backward bitwise equal",
          flush=True)
    return e, (q, k, v, do, ro, rl, layout)


def phase_long_training(torch, np, dev, seed, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = gpt2_125m(max_seq_len=LONG_SEQ, dtype=torch.bfloat16,
                    attention_impl="sparse",
                    sparse_attention=bench_sparsity(12))
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=LONG_CONFIG)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, LONG_SEQ)).astype(np.int32)
    losses, norms, secs, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(4):                 # 1 warm-up + 3 timed steps
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        per_step.append({n: _build.LAUNCHES[n] - before.get(n, 0)
                         for n in SPARSE + FLASH})
    launches = {name: _build.LAUNCHES[name] for name in SPARSE}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase13 long-context training gpt2_125m seq={LONG_SEQ} "
          f"losses={losses} grad_norms={norms} step_s={secs} "
          f"launches_per_step={per_step}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training at seq 32768")
    if not losses[-1] < losses[0]:
        fail(f"the long-context loss did not fall: {losses}")
    want = {"sparse_fwd": 2 * cfg.num_layers,
            "sparse_bwd_dq": cfg.num_layers,
            "sparse_bwd_dkv": cfg.num_layers,
            **{n: 0 for n in FLASH}}
    if any(step != want for step in per_step):
        fail(f"launches per step {per_step}, expected {want}")
    step_s = sum(secs[1:]) / 3
    print(f"long_context_sparse_step_s={step_s} card={card}", flush=True)
    print(f"long_context_sparse_seq32k_tokens_s={LONG_SEQ / step_s} "
          f"card={card}", flush=True)
    print(f"long_context_sparse_peak_memory_gib={peak_gb} card={card}",
          flush=True)
    return engine, cfg, torch.from_numpy(ids).long().to(dev), launches


def phase_long_model_check(torch, sa, dev, engine, cfg, ids):
    """One step's loss and global grad norm of the trained long-context
    model through the kernels and through the plain versions, both bf16."""
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    result = {}
    for impl in ("kernels", "plain"):
        m = GPT(cfg, device=dev).to(torch.bfloat16)
        m.load_state_dict(engine.module.state_dict())
        before = sum(_build.LAUNCHES[n] for n in SPARSE)
        with (plain_sparse(sa) if impl == "plain"
              else contextlib.nullcontext()):
            loss = lm_loss_fn(m(ids), {"input_ids": ids})
            loss.backward()
        launched = sum(_build.LAUNCHES[n] for n in SPARSE) - before
        if (impl == "plain") != (launched == 0):
            fail(f"the {impl} model check launched {launched} kernels")
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase14 long-context model check seq={LONG_SEQ} loss "
          f"kernels={lk} plain={lp} (atol {LOSS_ATOL}); grad norm "
          f"kernels={nk} plain={np_} (rtol {GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LOSS_ATOL and abs(nk - np_) <= GRAD_NORM_RTOL
            * np_):
        fail("the long-context model through the kernels disagrees with "
             "the plain versions")


def phase_long_profile(torch, engine, ids, card):
    """One warmed long-context step (micro 1 x gas 1) timed without the
    profiler, then one under it; idle share against the unprofiled wall.
    Returns the step's wall, device busy ms, idle share and device ms by
    sparse kernel."""
    from torch.profiler import ProfilerActivity, profile
    batch = [{"input_ids": ids}]
    engine.train_batch(iter(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(iter(batch))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(iter(batch))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a sparse step")
    print(f"phase15 profile long-context step wall_ms={wall_ms} "
          f"(unprofiled) device_busy_ms={busy_ms} "
          f"idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"phase15 kernel ms={ms} count={count} {key[:90]}", flush=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "sparse_ms": {key: ms for ms, _, key in rows
                          if "sparse_" in key}}


def _sdpa_with_mask(torch, dev, gen, S, H=12, D=64):
    """scaled_dot_product_attention at [1, H, S, D] bf16 with the bench
    layout (causal) expanded to a boolean [S, S] mask: forward and backward
    calls, or None when it does not fit on the card."""
    import torch.nn.functional as F
    lay = torch.from_numpy(bench_sparsity(H).make_layout(S)[0]).to(dev)
    try:
        mask = lay.bool().repeat_interleave(64, 0).repeat_interleave(64, 1)
        mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        qt, kt, vt, do = (torch.randn(1, H, S, D, device=dev,
                                      generator=gen).bfloat16()
                          for _ in range(4))
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(out, (qt, kt, vt), do, retain_graph=True)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None
    return (lambda i: F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=mask),
            lambda i: torch.autograd.grad(out, (qt, kt, vt), do,
                                          retain_graph=True))


def phase_sparse_timing(torch, sa, dev, gen, inputs, card, suffix=""):
    """The sparse kernels' device ms at ``inputs``' shape (the training
    shape; ``suffix`` "_d80": SPARSE_D80's) beside their plain versions,
    SDPA with the expanded mask and their bounds."""
    q, k, v, do, out, lse, layout = inputs
    B, S, H, D = q.shape
    scale = D ** -0.5

    def backward(i):
        sa.sparse_attention_backward(q, k, v, out, lse, do, layout, scale)

    plain_bwd = device_ms(lambda i: sa.sparse_attention_backward_reference(
        q, k, v, out, lse, do, layout, scale), iters=3, warmup=1)
    lib_s = S
    lib = _sdpa_with_mask(torch, dev, gen, lib_s, H, D)
    while lib is None and lib_s > 1024:
        lib_s //= 2
        lib = _sdpa_with_mask(torch, dev, gen, lib_s, H, D)
    lib_fwd = device_ms(lib[0], iters=5, warmup=1)
    lib_bwd = device_ms(lib[1], iters=5, warmup=1)
    del lib
    torch.cuda.empty_cache()
    print(f"phase16{suffix} library yardstick: scaled_dot_product_attention "
          f"with the expanded boolean mask at S={lib_s} H={H} D={D} (dense "
          f"work), fwd {lib_fwd} ms, bwd {lib_bwd} ms card={card}",
          flush=True)
    t = {
        "sparse_fwd": {
            "ms": device_ms(lambda i: sa.sparse_attention_forward(
                q, k, v, layout, scale), kernel="sparse_fwd", iters=20),
            "plain_ms": device_ms(
                lambda i: sa.sparse_attention_forward_reference(
                    q, k, v, layout, scale), iters=3, warmup=1),
            "library_ms": lib_fwd},
        # the plain and library backward compute dq, dk and dv together:
        # their times stand beside both kernels
        "sparse_bwd_dq": {"ms": device_ms(backward, kernel="sparse_bwd_dq",
                                          iters=20),
                          "plain_ms": plain_bwd, "library_ms": lib_bwd},
        "sparse_bwd_dkv": {"ms": device_ms(backward,
                                           kernel="sparse_bwd_dkv",
                                           iters=20),
                           "plain_ms": plain_bwd, "library_ms": lib_bwd},
    }
    # bytes: each input read once, each output written once, of the LUTs
    # the counts and the live entries (a tile index and a mask each; the
    # rows' padding is never read) and the work lists (the forward's and
    # dq's: 8 bytes an item); operations: 2 per multiply-add over the
    # layout's live causal (q, k) pairs, at the bf16 peak
    item = q.element_size()
    n = B * S * H * D * item
    stat = B * H * S * 4
    lut_k = (4 * layout.cnt_k.numel() + 12 * int(layout.cnt_k.sum())
             + 4 * layout.dq_items.numel())
    lut_q = (4 * layout.cnt_q.numel() + 12 * int(layout.cnt_q.sum())
             + 4 * layout.dkv_items.numel())
    pairs = live_causal_pairs(bench_sparsity(H), S, B)
    print(f"phase16{suffix} live causal (q, k) pairs {pairs} of "
          f"{B * H * S * S} "
          f"({pairs / (B * H * S * S)}); LUT bytes read: row {lut_k}, "
          f"column {lut_q}", flush=True)
    work = {"sparse_fwd": (4 * n + stat + lut_k, 4 * D * pairs),
            "sparse_bwd_dq": (5 * n + 2 * stat + lut_k, 6 * D * pairs),
            "sparse_bwd_dkv": (6 * n + 2 * stat + lut_q, 8 * D * pairs)}
    issue = {
        "sparse_fwd": _issue_us(torch, lambda: sa.sparse_attention_forward(
            q, k, v, layout, scale)),
        "sparse_bwd": _issue_us(torch, lambda: backward(0))}
    print(f"phase16{suffix} host issue us per call: forward "
          f"{issue['sparse_fwd']}, backward (dq and dk/dv) "
          f"{issue['sparse_bwd']} card={card}", flush=True)
    for name, (nbytes, flops) in work.items():
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name]["bound_ms"] = 1e3 * max(tb, tf)
        t[name]["bound_by"] = "bytes" if tb >= tf else "operations"
        for key, val in t[name].items():
            print(f"{name}{suffix}_{key}={val} card={card}", flush=True)
        print(f"phase16{suffix} {name} {t[name]['ms']} ms = "
              f"{t[name]['ms'] / t[name]['bound_ms']} x its bound "
              f"({t[name]['bound_by']}); plain {t[name]['plain_ms']} ms, "
              f"SDPA with the mask {t[name]['library_ms']} ms card={card}",
              flush=True)
    return t


# B5/B5b at GPT 2.7B's head dim: (B, S, H, D) with bench.py's BigBird
# layout at 32 heads, causal; the sparse GPT at that width (d_model 2560,
# d_ff 10240) cut to SPARSE_D80_LAYERS, trained one step at seq S
SPARSE_D80 = (1, 8192, 32, 80)
SPARSE_D80_LAYERS = 2


def phase_sparse_d80(torch, np, sa, dev, gen, seed, card):
    """Phase 12 at d 80 (GPT 2.7B's head dim), at SPARSE_D80 in bf16: the
    kernels (the d 96 instances storing 80) vs their plain versions, their
    device times (phase 16's way), then a long-context sparse GPT at 2.7B's
    width cut to SPARSE_D80_LAYERS layers trained one step through
    initialize() (LONG_CONFIG), counts reset just before and read just
    after: 2 / 1 / 1 launches a layer (remat), a finite loss. Returns
    (errs, times, launches)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    B, S, H, D = SPARSE_D80
    layout = _layout(bench_sparsity(H), S, True, dev)
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    e, (out, lse, ro, rl, grads) = _sparse_pair(torch, sa, layout, q, k, v,
                                                do, None, FLASH_TOL)
    print(f"phase12 sparse d80 B={B} S={S} H={H} D={D} bf16 causal BigBird "
          f"block 64 max_abs_err " + " ".join(
              f"{k_}={v_}" for k_, v_ in e.items()), flush=True)
    times = phase_sparse_timing(torch, sa, dev, gen,
                                (q, k, v, do, ro, rl, layout), card,
                                suffix="_d80")
    del q, k, v, do, out, lse, ro, rl, grads
    torch.cuda.empty_cache()
    cfg = GPTConfig(vocab_size=50304, max_seq_len=S,
                    num_layers=SPARSE_D80_LAYERS, num_heads=H, d_model=H * D,
                    d_ff=4 * H * D, dtype=torch.bfloat16,
                    attention_impl="sparse", sparse_attention=bench_sparsity(H))
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=LONG_CONFIG)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    loss = float(engine.train_batch(iter([{"input_ids": ids}])))
    torch.cuda.synchronize()
    launches = {n: _build.LAUNCHES[n] for n in SPARSE}
    want = {"sparse_fwd": 2 * SPARSE_D80_LAYERS,
            "sparse_bwd_dq": SPARSE_D80_LAYERS,
            "sparse_bwd_dkv": SPARSE_D80_LAYERS}
    print(f"phase12 sparse GPT at GPT 2.7B's width (d_model {H * D}, {H} "
          f"heads of {D}) cut to {SPARSE_D80_LAYERS} layers, seq {S}: one "
          f"step loss={loss} launches={launches}", flush=True)
    if not math.isfinite(loss) or launches != want:
        fail(f"sparse d80 step: loss {loss}, launches {launches} (want "
             f"{want})")
    del engine, model
    torch.cuda.empty_cache()
    return e, times, launches


def phase_sparse_bert(torch, np, sa, dev, gen, seed):
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM, bert_base
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseAttentionUtils)
    sparsity = BigBirdSparsityConfig(num_heads=12, block=64)
    cfg = bert_base(max_seq_len=4096, dtype=torch.bfloat16,
                    hidden_dropout=0.0, attention_impl="sparse",
                    sparse_attention=sparsity)
    model = BertForMaskedLM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    b, S = len(BERT_LENGTHS), max(BERT_LENGTHS)
    ids = np.zeros((b, S), np.int64)
    mask = np.zeros((b, S), np.int64)
    for i, n in enumerate(BERT_LENGTHS):
        ids[i, :n] = rng.integers(1, cfg.vocab_size, n)
        mask[i, :n] = 1
    pad_len, ids_t, mask_t, _ = SparseAttentionUtils.pad_to_block_size(
        sparsity.block, torch.from_numpy(ids).to(dev),
        attention_mask=torch.from_numpy(mask).to(dev))
    picked = torch.from_numpy((rng.random((b, S)) < 0.15) * mask).to(dev)
    result = {}
    for impl in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        before = {n: _build.LAUNCHES[n] for n in SPARSE}
        with (plain_sparse(sa) if impl == "plain"
              else contextlib.nullcontext()):
            logits = model(ids_t, attention_mask=mask_t).float()
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, ids_t[..., None])[..., 0]
            loss = (nll * picked).sum() / picked.sum()
            loss.backward()
        torch.cuda.synchronize()
        launched = {n: _build.LAUNCHES[n] - before[n] for n in SPARSE}
        want = cfg.num_layers if impl == "kernels" else 0
        if any(v != want for v in launched.values()):
            fail(f"sparse BERT ({impl}) launches {launched}, expected "
                 f"{want} each")
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if not (torch.isfinite(loss) and all(
                bool(torch.isfinite(g).all()) for g in grads)):
            fail(f"sparse BERT ({impl}): non-finite loss or grads")
        norm = torch.linalg.vector_norm(torch.stack(
            [g.float().norm() for g in grads]))
        result[impl] = (loss.item(), norm.item())
        del logits, nll, loss
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase17 sparse BERT bert_base S={S} batch lengths "
          f"{BERT_LENGTHS} pad_len={pad_len} MLM loss kernels={lk} "
          f"plain={lp} (atol {LOSS_ATOL}); grad norm kernels={nk} "
          f"plain={np_} (rtol {GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LOSS_ATOL and abs(nk - np_) <= GRAD_NORM_RTOL
            * np_):
        fail("sparse BERT through the kernels disagrees with the plain "
             "versions")
    del model
    torch.cuda.empty_cache()
    # the kernels at BERT's shape with its key-padding mask
    q, k, v, do = _qkv(torch, dev, gen, b, S, 12, 64)
    kvm = mask_t.float().contiguous()
    e, (*_, (dq, dk, dv)) = _sparse_pair(
        torch, sa, _layout(sparsity, S, False, dev), q, k, v, do, kvm,
        FLASH_TOL, rows=True)
    padded = ~mask_t.bool()
    if dk[padded].any() or dv[padded].any():
        fail("sparse BERT: non-zero dk/dv at padded keys")
    print(f"phase17 sparse kernels at B={b} S={S} H=12 D=64 bf16 "
          f"bidirectional with key padding: dk/dv zero at padded keys, "
          f"max_abs_err " + " ".join(f"{k_}={v_}" for k_, v_ in e.items())
          + f" (tol atol {FLASH_TOL[0]} + rtol {FLASH_TOL[1]} x the row's "
          f"largest |ref|)", flush=True)


PAGED_BS = 16
INT8_KERNELS = ("decode_attention_int8", "paged_decode_attention_int8")
DECODE_KERNELS = ("decode_attention", "paged_decode_attention") \
    + INT8_KERNELS


def _to_pool(x, perm, bs):
    """A dense cache [b, S, ...] laid out as a block pool [b*T, bs, ...]
    whose block perm[j] holds the cache's j-th block (rows in order): read
    back through the tables perm.view(b, T)."""
    b, S = x.shape[:2]
    blocks = x.reshape(b * S // bs, bs, *x.shape[2:])
    pool = blocks.new_empty(blocks.shape)
    pool[perm] = blocks
    return pool


def _quantize(qz, x):
    """quantize_kv over the last dim: (int8 payload, f32 scales [..])."""
    q, s = qz.quantize_kv(x)
    return q, s[..., 0].contiguous()


def _decode_err(torch, got, ref, what, rtol=0.0) -> float:
    """max |got - ref| after checking |got - ref| <= DECODE_ATOL + rtol
    |ref| elementwise."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    diff = (got.float() - ref.float()).abs()
    if bool((diff > DECODE_ATOL + rtol * ref.float().abs()).any()):
        fail(f"{what} disagrees with its plain version: {diff.max().item()}")
    return diff.max().item()


def phase_paged_parity(torch, da, qz, dev, gen):
    b, S, h, d, bs = 8, 1024, 12, 64, PAGED_BS
    T, hd = S // bs, h * d
    errs = {name: 0.0 for name in ("paged_decode_attention",)
            + INT8_KERNELS}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for s_q in (1, 4):
            clen = torch.tensor([0, 1, 17, 512, 1024, 300, 777, S + s_q],
                                dtype=torch.int32, device=dev)
            q = torch.randn(b, s_q, h, d, device=dev, generator=gen).to(dtype)
            k = torch.randn(b, S, hd, device=dev, generator=gen).to(dtype)
            v = torch.randn(b, S, hd, device=dev, generator=gen).to(dtype)
            perm = torch.randperm(b * T, device=dev, generator=gen)
            tables = perm.view(b, T).int().contiguous()
            in_order = torch.arange(b * T, dtype=torch.int32,
                                    device=dev).view(b, T)
            live = (clen.clamp(max=S) + bs - 1) // bs
            sentinel = torch.where(
                torch.arange(T, device=dev)[None, :] >= live[:, None],
                b * T, tables).int().contiguous()
            kp, vp = _to_pool(k, perm, bs), _to_pool(v, perm, bs)
            dense = da.decode_attention(q, k, v, clen)
            outs = {"permuted": da.paged_decode_attention(q, kp, vp, tables,
                                                          clen),
                    "in-order": da.paged_decode_attention(
                        q, k.view(b * T, bs, hd), v.view(b * T, bs, hd),
                        in_order, clen),
                    "sentinel": da.paged_decode_attention(q, kp, vp,
                                                          sentinel, clen)}
            torch.cuda.synchronize()
            for name, out in outs.items():
                if not torch.equal(out, dense):
                    fail(f"B3 over the {name} table is not bitwise B2 "
                         f"({dtype}, s_q={s_q})")
            got = outs["sentinel"]
            ref = da.paged_decode_attention_reference(q, kp, vp, sentinel,
                                                      clen, 1 / 8)
            e3 = _decode_err(torch, got, ref, "paged_decode_attention")
            if got[0].any():
                fail("paged_decode_attention: the fill-0 row is not zero")
            (kq, ks), (vq, vs) = _quantize(qz, k), _quantize(qz, v)
            d8 = da.decode_attention(q, kq, vq, clen, k_scale=ks, v_scale=vs)
            p8 = da.paged_decode_attention(
                q, _to_pool(kq, perm, bs), _to_pool(vq, perm, bs), sentinel,
                clen, k_scale=_to_pool(ks, perm, bs),
                v_scale=_to_pool(vs, perm, bs))
            torch.cuda.synchronize()
            rtol = DECODE_INT8_RTOL if dtype != torch.float32 else 0.0
            e2q = _decode_err(torch, d8, da.decode_attention_reference(
                q, kq, vq, clen, 1 / 8, ks, vs), "decode_attention_int8",
                rtol)
            e3q = _decode_err(torch, p8, da.paged_decode_attention_reference(
                q, _to_pool(kq, perm, bs), _to_pool(vq, perm, bs), sentinel,
                clen, 1 / 8, _to_pool(ks, perm, bs), _to_pool(vs, perm, bs)),
                "paged_decode_attention_int8", rtol)
            if not torch.equal(p8, d8):
                fail(f"B3-int8 is not bitwise B2-int8 ({dtype}, s_q={s_q})")
            if d8[0].any() or p8[0].any():
                fail("int8 decode: the fill-0 row is not zero")
            for name, e in zip(errs, (e3, e2q, e3q)):
                errs[name] = max(errs[name], e)
            print(f"phase18 {str(dtype)[6:]} s_q={s_q} b={b} S={S} h={h} "
                  f"d={d} block={bs}: B3 bitwise B2 over permuted, in-order "
                  f"and sentinel tables; max_abs_err B3={e3} B2-int8={e2q} "
                  f"B3-int8={e3q} (tol {DECODE_ATOL}, int8 in 16 bits + "
                  f"{DECODE_INT8_RTOL} |ref|); fill-0 row zeros; "
                  f"B3-int8 bitwise B2-int8", flush=True)
    return errs


def _checked_logits(torch, module, dev):
    """Wrap ``module.logits`` so every served logits tensor is checked
    finite; returns the flag that turns True on a non-finite one."""
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    unchecked = module.logits

    def checked(hidden):
        out = unchecked(hidden)
        bad.logical_or_(~torch.isfinite(out).all())
        return out

    module.logits = checked
    return bad


def _serve(torch, eng, prompts, n_new):
    """One timed main-path run with the counts reset just before and read
    just after: (requests, seconds, launches)."""
    from deepspeed_tpu_torch.ops.cuda import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run([p.copy() for p in prompts], max_new_tokens=n_new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    for r in out:
        if r.status != "done" or len(r.tokens) != n_new:
            fail(f"request {r.uid}: status {r.status}, {len(r.tokens)} "
                 f"tokens")
    return out, seconds, launches


def _want_launches(launches, kernel, what):
    if not launches.get(kernel) or not launches.get("sampling"):
        fail(f"{what} never launched {kernel} and sampling: {launches}")
    other = [k for k in DECODE_KERNELS if k != kernel and launches.get(k)]
    if other:
        fail(f"{what} launched {other}: {launches}")


def phase_paged_serving(torch, np, dev, seed, card):
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
    cfg = gpt2_125m(max_seq_len=1024, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed + 1)
    distinct = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
                for n in rng.integers(16, 129, 12)]
    # the repeats follow the first round of 8 admissions, whose prompts
    # are in the prefix cache by then
    twins = {12: 0, 13: 2, 14: 5, 15: 7}
    prompts = distinct + [distinct[j].copy() for j in twins.values()]
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128,
              megakernel=True)
    paged_kw = dict(kw, paged=True, kv_block_size=PAGED_BS)
    n_new = 64
    ServingEngine(engine=ie, **paged_kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)    # warm-up
    eng = ServingEngine(engine=ie, **paged_kw)
    out, seconds, launches = _serve(torch, eng, prompts, n_new)
    print(f"phase19 paged serving gpt2_125m requests=16 block={PAGED_BS} "
          f"launches={launches}", flush=True)
    _want_launches(launches, "paged_decode_attention", "the paged main path")
    m = eng.metrics
    distinct_tokens = sum(len(p) for p in distinct)
    print(f"phase19 prefix cache hits={m.n_prefix_hits} "
          f"misses={m.n_prefix_misses} cow_forks={m.n_cow_forks} "
          f"prefill_prompt_tokens={m.prefill_prompt_tokens} (distinct "
          f"prompts {distinct_tokens})", flush=True)
    if (m.n_prefix_hits, m.n_prefix_misses) != (4, 12):
        fail("prefix-cache hits/misses are not 4/12")
    if m.prefill_prompt_tokens != distinct_tokens:
        fail("prefill ran over other prompts than the 12 distinct ones")
    for i, j in twins.items():
        if out[i].tokens != out[j].tokens:
            fail(f"prefix-cache hit {i} served other tokens than its twin "
                 f"{j}")
    n_tokens = sum(len(r.tokens) for r in out)
    print(f"paged_serving_tokens_per_s={n_tokens / seconds} card={card}",
          flush=True)
    print(f"paged_serving_mean_decode_chunk_ms="
          f"{m.mean_decode_chunk_s * 1e3} (K=8, batch 8) card={card}",
          flush=True)
    rep = eng.kv.arena_report()
    print(f"phase19 arena blocks_total={rep['blocks_total']} "
          f"blocks_peak_used={rep['blocks_peak_used']} "
          f"prefix_cache_blocks={rep['prefix_cache_blocks']} "
          f"kv_bytes={rep['kv_bytes']}", flush=True)
    dense, dense_s, dense_launches = _serve(
        torch, ServingEngine(engine=ie, **kw), prompts, n_new)
    _want_launches(dense_launches, "decode_attention", "the dense engine")
    print(f"dense_serving_tokens_per_s={n_tokens / dense_s} (the same 16 "
          f"requests) card={card}", flush=True)
    diff = [i for i, (r, s) in enumerate(zip(out, dense))
            if r.tokens != s.tokens]
    if diff:
        i = diff[0]
        at = next(t for t, (a, b) in enumerate(zip(out[i].tokens,
                                                   dense[i].tokens)) if a != b)
        fail(f"paged tokens differ from the dense engine's in requests "
             f"{diff} (request {i} from token {at})")
    print("phase19 paged tokens equal the dense megakernel engine's; hits "
          "equal their twins", flush=True)
    phase_profile(torch, ie, prompts[:8], paged_kw, card, tag="phase19")
    return launches, ie, prompts, [r.tokens for r in dense]


def phase_int8_serving(torch, np, dev, ie, prompts, bf16_tokens, card):
    from deepspeed_tpu_torch import ServingEngine
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128,
              megakernel=True, kv_dtype="int8")
    n_new = 64
    tokens, launches = {}, {}
    for name, extra, kernel in (
            ("dense", {}, "decode_attention_int8"),
            ("paged", dict(paged=True, kv_block_size=PAGED_BS),
             "paged_decode_attention_int8")):
        ServingEngine(engine=ie, **kw, **extra).run(
            [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
        eng = ServingEngine(engine=ie, **kw, **extra)
        bad = _checked_logits(torch, eng.module, dev)
        out, seconds, launched = _serve(torch, eng, prompts, n_new)
        print(f"phase20 int8 {name} serving launches={launched}", flush=True)
        _want_launches(launched, kernel, f"int8 {name} serving")
        if bool(bad):
            fail(f"non-finite logits while serving int8 {name}")
        rep = eng.kv.arena_report()
        share = rep["int8_payload_bytes"] / rep["kv_bytes_fp_equiv"]
        print(f"phase20 int8 {name} arena int8_payload_bytes="
              f"{rep['int8_payload_bytes']} scale_bytes={rep['scale_bytes']} "
              f"kv_bytes_fp_equiv={rep['kv_bytes_fp_equiv']} payload share "
              f"{share} kv_bytes/fp {rep['kv_bytes'] / rep['kv_bytes_fp_equiv']}"
              f" prefix hits={eng.metrics.n_prefix_hits}", flush=True)
        if not share <= 0.5:
            fail(f"int8 {name} payload is {share} of the fp bytes")
        n_tokens = sum(len(r.tokens) for r in out)
        print(f"int8_{name}_serving_tokens_per_s={n_tokens / seconds} (every "
              f"served logits tensor checked finite) card={card}", flush=True)
        tokens[name] = [r.tokens for r in out]
        launches[kernel] = launched[kernel]
    if tokens["dense"] != tokens["paged"]:
        fail("dense and paged int8 serving gave different greedy tokens")
    agree = sum(int(a == b) for r, s in zip(tokens["dense"], bf16_tokens)
                for a, b in zip(r, s))
    total = sum(len(r) for r in bf16_tokens)
    print(f"phase20 dense and paged int8 tokens equal; tokens equal to the "
          f"bf16 engine's: {agree}/{total} = {agree / total}", flush=True)
    return launches


# tools/time_decode.py's cases at phase 2's geometry (bf16): phase 2's mixed
# fills (and the sentinel row) with s_q 1 and 4, and every row full
DECODE_FILLS = (1, 17, 512, 1024, 300, 64, 777)
DECODE_TIME_CASES = {"mixed_sq1": (1, False), "mixed_sq4": (4, False),
                     "full_sq1": (1, True)}


def decode_case_inputs(torch, dev, gen, s_q, full):
    """(q, k, v, cache_len) at GPT-2 125M decode geometry (b 8, S 1024,
    h 12, d 64, bf16): phase 2's fills plus the retired-lane sentinel row,
    or every row at S."""
    b, S, h, d = 8, 1024, 12, 64
    fills = [S] * b if full else list(DECODE_FILLS) + [S + s_q]
    clen = torch.tensor(fills, dtype=torch.int32, device=dev)
    q = torch.randn(b, s_q, h, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, S, h * d, device=dev, generator=gen).bfloat16()
    return q, k, v, clen


def decode_copies(torch, da, qz, dev, gen, inputs):
    """8 copies of the cache in each layout (dense; paged over a random
    block order, block PAGED_BS; int8 dense and paged) so each call reads
    its K/V cold from HBM, as a layer's call does in the model; the block
    tables; and a call of each decode kernel on one copy."""
    q, k, v, clen = inputs
    b, S = k.shape[:2]
    bs = PAGED_BS
    T = S // bs
    perm = torch.randperm(b * T, device=dev, generator=gen)
    tables = perm.view(b, T).int().contiguous()
    copies = []
    for _ in range(8):
        (kq, ks), (vq, vs) = _quantize(qz, k), _quantize(qz, v)
        copies.append({
            "dense": (k.clone(), v.clone()),
            "paged": (_to_pool(k, perm, bs), _to_pool(v, perm, bs)),
            "dense8": (kq, vq, ks, vs),
            "paged8": tuple(_to_pool(t, perm, bs) for t in (kq, vq, ks, vs))})
    calls = {
        "decode_attention":
            lambda c: da.decode_attention(q, *c["dense"], clen),
        "paged_decode_attention":
            lambda c: da.paged_decode_attention(q, *c["paged"], tables, clen),
        "decode_attention_int8":
            lambda c: da.decode_attention(q, *c["dense8"][:2], clen,
                                          k_scale=c["dense8"][2],
                                          v_scale=c["dense8"][3]),
        "paged_decode_attention_int8":
            lambda c: da.paged_decode_attention(
                q, *c["paged8"][:2], tables, clen, k_scale=c["paged8"][2],
                v_scale=c["paged8"][3]),
    }
    return copies, tables, calls


def print_decode_cases(torch, da, qz, dev, gen, names, tag, card):
    """The named kernels' device ms at the s_q = 4 and full-fill cases."""
    for case in ("mixed_sq4", "full_sq1"):
        s_q, full = DECODE_TIME_CASES[case]
        copies, _, calls = decode_copies(
            torch, da, qz, dev, gen,
            decode_case_inputs(torch, dev, gen, s_q, full))
        for name in names:
            ms = device_ms(lambda i: calls[name](copies[i]), 8,
                           "decode_attention_kernel")
            print(f"{tag} {name} {case} ms={ms} card={card}", flush=True)


def phase_paged_timing(torch, da, qz, dev, gen, decode_inputs, card):
    import torch.nn.functional as F
    q, k, v, clen = decode_inputs              # bf16, s_q 1, B2's fills
    b, s_q, h, d = q.shape
    S, hd, bs = k.shape[1], h * d, PAGED_BS
    T = S // bs
    copies, tables, kernels = decode_copies(torch, da, qz, dev, gen,
                                            decode_inputs)
    p = torch.arange(S, device=dev)
    flat = (tables.long()[:, p // bs] * bs + p % bs).reshape(-1)
    mask = (p[None, :] < clen.clamp(max=S)[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(
            qt, kk.view(b, S, h, d).transpose(1, 2),
            vv.view(b, S, h, d).transpose(1, 2), attn_mask=mask, scale=1 / 8)

    def gather(pool):
        return pool.reshape(b * T * bs, -1).index_select(0, flat)

    def dequant(x, s):
        return (x.float() * s.reshape(*x.shape[:-1], 1)).bfloat16()

    calls = {
        "decode_attention": (kernels["decode_attention"], None, None),
        "paged_decode_attention": (
            kernels["paged_decode_attention"],
            lambda c: da.paged_decode_attention_reference(
                q, *c["paged"], tables, clen, 1 / 8),
            lambda c: sdpa(gather(c["paged"][0]), gather(c["paged"][1]))),
        "decode_attention_int8": (
            kernels["decode_attention_int8"],
            lambda c: da.decode_attention_reference(q, *c["dense8"][:2],
                                                    clen, 1 / 8,
                                                    *c["dense8"][2:]),
            lambda c: sdpa(dequant(c["dense8"][0], c["dense8"][2]),
                           dequant(c["dense8"][1], c["dense8"][3]))),
        "paged_decode_attention_int8": (
            kernels["paged_decode_attention_int8"],
            lambda c: da.paged_decode_attention_reference(
                q, *c["paged8"][:2], tables, clen, 1 / 8, *c["paged8"][2:]),
            lambda c: sdpa(dequant(gather(c["paged8"][0]),
                                   gather(c["paged8"][2])),
                           dequant(gather(c["paged8"][1]),
                                   gather(c["paged8"][3])))),
    }
    live = clen.clamp(max=S).sum().item()
    blocks = ((clen.clamp(max=S) + bs - 1) // bs).sum().item()
    item = q.element_size()
    qo = 2 * q.numel() * item + 4 * b          # q, out, cache_len
    nbytes = {"decode_attention": 2 * live * hd * item + qo,
              "paged_decode_attention": 2 * live * hd * item + qo + 4 * blocks,
              "decode_attention_int8": 2 * live * (hd + 4) + qo,
              "paged_decode_attention_int8": 2 * live * (hd + 4) + qo
              + 4 * blocks}
    flops = 4 * live * hd * s_q
    b2_ms = None
    t = {}
    for name, (kernel, plain, lib) in calls.items():
        ms = device_ms(lambda i: kernel(copies[i]), 8,
                       "decode_attention_kernel")
        if name == "decode_attention":
            b2_ms = ms
            print(f"phase21 B2 at the same fills {ms} ms card={card}",
                  flush=True)
            continue
        tb, tf = nbytes[name] / HBM_BYTES_PER_S, flops / BF16_FLOPS
        t[name] = {"ms": ms,
                   "plain_ms": device_ms(lambda i: plain(copies[i]), 8),
                   "library_ms": device_ms(lambda i: lib(copies[i]), 8),
                   "bound_ms": 1e3 * max(tb, tf),
                   "bound_by": "bytes" if tb >= tf else "operations"}
        for key, val in t[name].items():
            print(f"{name}_{key}={val} card={card}", flush=True)
        print(f"phase21 {name}: {ms / b2_ms} x B2's time at the same fills",
              flush=True)
    print("phase21 library_ms of B3 is a yardstick of two calls: "
          "index_select gathers of K and V through the table, then "
          "scaled_dot_product_attention with a boolean mask; int8 adds a "
          "dequantize (payload x scale, to bf16) between them (dense int8: "
          "dequantize + SDPA)", flush=True)
    print_decode_cases(torch, da, qz, dev, gen, DECODE_KERNELS[1:],
                       "phase21", card)
    return t

# ---------------------------------------------------------------------------
# Slice 12: speculative decoding and the double-buffered serve loop
# ---------------------------------------------------------------------------

SPEC_K, SPEC_NGRAM = 4, 2        # the TPU ServingEngine's defaults
# new tokens a request in phases 25-27, 38 and 40-41 (sampled,
# speculative, fused and GPT-Neo serving): phase 4's 64 cut to fit the
# time limit (to 32, then to 16 when phases 52-53 came)
CUT_NEW = 16
VERIFY_SQ = SPEC_K + 1
# the arenas a speculative GPT-2 engine builds (max_seq_len 1024): k
# positions of lookahead past S (dense), one more table entry (paged)
VERIFY_S_DENSE = 1024 + SPEC_K
VERIFY_T_PAGED = 1024 // PAGED_BS + -(-SPEC_K // PAGED_BS)
# cache lengths including the k + 1 verify tokens: short rows, a mid-row
# verify, 1028 = a verify from position 1023 (its last four columns past S),
# then the retired-lane sentinel
VERIFY_FILLS = (5, 17, 512, 1028, 300, 64, 777)
# spec vs non-spec greedy: the first differing position must be a near-tie
# of the non-spec run, its top-2 gap within SPEC_TIE_ULPS bf16 ulps of the
# top logit (the k + 1-row GEMMs round differently; 12 layers of such
# roundings reach a few ulps of the logits)
SPEC_TIE_ULPS = 8
# the sampled spec phase's filter, and B4's filter timed at the verify's
# rows (8 lanes x (k + 1))
SPEC_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# B2/B3 (and int8) at the fused prefill step's width (phase 38's
# prefill_chunk 16, the kSQ 16 instances) over the arenas a fused GPT-2
# engine builds (C - 1 = 15 positions of lookahead: dense S 1039, paged T
# 65): a step completing a 16-token prompt, mid-row steps, a step from
# position 1023 (1039), then the sentinel
FUSED_C = 16
SQ16_CASE = dict(s_q=FUSED_C, h=12, d=64, Sd=1024 + FUSED_C - 1,
                 T=1024 // PAGED_BS + -(-(FUSED_C - 1) // PAGED_BS),
                 fills=(16, 33, 512, 1039, 300, 64, 777))
# and at phase 38's prefill_chunk 24 (dense_c24): two launches a call, the
# pieces 16 + 8, each with its own fill, over 23 positions of lookahead
# (dense S 1047, paged T 66); fill 5 leaves every query of the first piece
# seeing nothing (its fill 5 - 8 < 0) and 18 of the 24 queries in all
SQ24_CASE = dict(s_q=24, h=12, d=64, Sd=1024 + 23,
                 T=1024 // PAGED_BS + -(-23 // PAGED_BS),
                 fills=(5, 24, 40, 512, 1047, 300, 777))
# and at GPT 2.7B's head dim (2560 / 32 = 80: phase 39's decode step), s_q 1
# over its max_seq_len 1024 with phase 2's fills
D80_CASE = dict(s_q=1, h=32, d=80, Sd=1024, T=1024 // PAGED_BS,
                fills=(1, 17, 512, 1024, 300, 64, 777))


def verify_case(torch, da, qz, dev, gen, n_copies, s_q=VERIFY_SQ, h=12,
                d=64, Sd=VERIFY_S_DENSE, T=VERIFY_T_PAGED,
                fills=VERIFY_FILLS, scale=None, exact=False):
    """B2/B3 (and int8) at the verify width s_q = k + 1 = 5, GPT-2 125M
    geometry (b 8, h 12, d 64, bf16): the dense cache [8, 1028, 768], the
    paged pool over a random block order with tables of 65 entries (S
    1040), VERIFY_FILLS and the sentinel; or at another width, head count,
    head dim, extent, fills and score scale (SQ16_CASE, D80_CASE,
    NEO_CASE; the scale defaults to d^-0.5). ``n_copies`` copies of each
    cache, read in turn so each call reads its K/V cold. Returns q, the
    copies, and per kernel name (call(copy), plain(copy), library(copy),
    cache length, S). ``exact``: the plain versions run in f32 on the same
    values (phase 40: at unscaled scores the bf16 einsum rounds them)."""
    import torch.nn.functional as F
    b, bs = 8, PAGED_BS
    Sp, hd = T * bs, h * d
    scale = d ** -0.5 if scale is None else scale
    q = torch.randn(b, s_q, h, d, device=dev, generator=gen).bfloat16()
    clen_d = torch.tensor(tuple(fills) + (Sd + s_q,), dtype=torch.int32,
                          device=dev)
    clen_p = torch.tensor(tuple(fills) + (Sp + s_q,), dtype=torch.int32,
                          device=dev)
    perm = torch.randperm(b * T, device=dev, generator=gen)
    tables = perm.view(b, T).int().contiguous()
    copies = []
    for _ in range(n_copies):
        k = torch.randn(b, Sp, hd, device=dev, generator=gen).bfloat16()
        v = torch.randn(b, Sp, hd, device=dev, generator=gen).bfloat16()
        kd, vd = k[:, :Sd].contiguous(), v[:, :Sd].contiguous()
        (kq, ks), (vq, vs) = _quantize(qz, k), _quantize(qz, v)
        copies.append({
            "dense": (kd, vd),
            "paged": (_to_pool(k, perm, bs), _to_pool(v, perm, bs)),
            "dense8": (kq[:, :Sd].contiguous(), vq[:, :Sd].contiguous(),
                       ks[:, :Sd].contiguous(), vs[:, :Sd].contiguous()),
            "paged8": tuple(_to_pool(t, perm, bs) for t in (kq, vq, ks, vs))})
    p = torch.arange(Sp, device=dev)
    flat = (tables.long()[:, p // bs] * bs + p % bs).reshape(-1)
    qp = q.float() if exact else q

    def up(kv):                  # a bf16 cache pair, in f32 under exact
        return tuple(t.float() for t in kv) if exact else kv
    qt = q.transpose(1, 2)

    def mask(clen, S):
        # the kernel's window: query i sees p < min(clen, S) - (s_q-1) + i
        lim = clen.clamp(max=S)[:, None] - (s_q - 1) \
            + torch.arange(s_q, device=dev)[None, :]
        return (torch.arange(S, device=dev)[None, None, :]
                < lim[:, :, None])[:, None]                  # [b,1,s_q,S]

    m_d, m_p = mask(clen_d, Sd), mask(clen_p, Sp)

    def sdpa(kk, vv, m):
        S = kk.shape[1]
        return F.scaled_dot_product_attention(
            qt, kk.view(b, S, h, d).transpose(1, 2),
            vv.view(b, S, h, d).transpose(1, 2), attn_mask=m, scale=scale)

    def gather(pool):
        return pool.reshape(b * T * bs, -1).index_select(0, flat).view(
            b, Sp, -1)

    def dequant(x, s):
        return (x.float() * s.reshape(*x.shape[:-1], 1)).bfloat16()

    cases = {
        "decode_attention": (
            lambda c: da.decode_attention(q, *c["dense"], clen_d,
                                          scale=scale),
            lambda c: da.decode_attention_reference(qp, *up(c["dense"]),
                                                    clen_d, scale),
            lambda c: sdpa(*c["dense"], m_d), clen_d, Sd),
        "paged_decode_attention": (
            lambda c: da.paged_decode_attention(q, *c["paged"], tables,
                                                clen_p, scale=scale),
            lambda c: da.paged_decode_attention_reference(
                qp, *up(c["paged"]), tables, clen_p, scale),
            lambda c: sdpa(gather(c["paged"][0]), gather(c["paged"][1]),
                           m_p), clen_p, Sp),
        "decode_attention_int8": (
            lambda c: da.decode_attention(q, *c["dense8"][:2], clen_d,
                                          scale=scale,
                                          k_scale=c["dense8"][2],
                                          v_scale=c["dense8"][3]),
            lambda c: da.decode_attention_reference(
                qp, *c["dense8"][:2], clen_d, scale, *c["dense8"][2:]),
            lambda c: sdpa(dequant(c["dense8"][0], c["dense8"][2]),
                           dequant(c["dense8"][1], c["dense8"][3]), m_d),
            clen_d, Sd),
        "paged_decode_attention_int8": (
            lambda c: da.paged_decode_attention(
                q, *c["paged8"][:2], tables, clen_p, scale=scale,
                k_scale=c["paged8"][2], v_scale=c["paged8"][3]),
            lambda c: da.paged_decode_attention_reference(
                qp, *c["paged8"][:2], tables, clen_p, scale,
                *c["paged8"][2:]),
            lambda c: sdpa(dequant(gather(c["paged8"][0]),
                                   gather(c["paged8"][2])),
                           dequant(gather(c["paged8"][1]),
                                   gather(c["paged8"][3])), m_p),
            clen_p, Sp),
    }
    return q, copies, cases


def case_parity(torch, da, qz, dev, gen, **case):
    """B2, B3 and their int8 branches at a verify_case shape vs their plain
    versions (tolerances as phase 18): (max abs errs, q, the copy, the
    cases)."""
    q, copies, cases = verify_case(torch, da, qz, dev, gen, 1, **case)
    c = copies[0]
    errs = {}
    for name, (call, plain, _, _, _) in cases.items():
        got = call(c)
        torch.cuda.synchronize()
        rtol = DECODE_INT8_RTOL if "int8" in name else 0.0
        errs[name] = _decode_err(torch, got, plain(c),
                                 f"{name} {_case_tag(q)}", rtol)
        print(f"phase2 {name} {_case_tag(q)} b=8 fills="
              f"{case.get('fills', VERIFY_FILLS)} + sentinel max_abs_err="
              f"{errs[name]} (tol {DECODE_ATOL}"
              f"{' + %g |ref|' % rtol if rtol else ''})", flush=True)
    return errs, q, c, cases


def phase_piece_parity(torch, da, qz, dev, gen):
    """Phase 2 at prefill_chunk 24 (SQ24_CASE): B2, B3 and their int8
    branches against their plain versions at phase 2's tolerances, each
    call launching its kernel once a piece of ``query_pieces(24)`` (16 +
    8). Returns the max abs errors."""
    from deepspeed_tpu_torch.ops.cuda import _build
    before = dict(_build.LAUNCHES)
    errs = case_parity(torch, da, qz, dev, gen, **SQ24_CASE)[0]
    want = len(da.query_pieces(SQ24_CASE["s_q"]))
    launched = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in errs}
    print(f"phase2 s_q={SQ24_CASE['s_q']} launches a call: {launched} "
          f"(want {want}: the pieces {da.query_pieces(SQ24_CASE['s_q'])})",
          flush=True)
    if any(n != want for n in launched.values()):
        fail(f"s_q {SQ24_CASE['s_q']}: launches {launched}, want {want} "
             f"a call")
    return errs


def _case_tag(q) -> str:
    b, s_q, h, d = q.shape
    return f"s_q={s_q} h={h} d={d}"


def phase_verify_parity(torch, da, qz, dev, gen):
    """Phase 2 at the verify width: B2, B3 and their int8 branches at
    s_q = 5 vs their plain versions (tolerances as phase 18); then whether
    B2's query i at s_q = 5 is bitwise an s_q = 1 call on the same cache at
    cache length clen - 4 + i (measured, not gated)."""
    errs, q, c, cases = case_parity(torch, da, qz, dev, gen)
    call, _, _, clen, _ = cases["decode_attention"]
    out = call(c)
    live = slice(0, len(VERIFY_FILLS))           # not the sentinel row
    n_equal, worst = 0, 0.0
    for i in range(VERIFY_SQ):
        one = da.decode_attention(q[:, i:i + 1].contiguous(), *c["dense"],
                                  clen - (VERIFY_SQ - 1) + i)
        a, b1 = out[live, i], one[live, 0]
        n_equal += int((a == b1).all(dim=-1).all(dim=-1).sum())
        worst = max(worst, (a.float() - b1.float()).abs().max().item())
    total = VERIFY_SQ * len(VERIFY_FILLS)
    print(f"phase2 B2 query i at s_q={VERIFY_SQ} vs an s_q=1 call at "
          f"clen-4+i: {n_equal}/{total} (row, query) pairs bitwise equal, "
          f"max abs diff {worst}", flush=True)
    return errs, n_equal == total


def verify_timing(torch, da, qz, dev, gen, card, **case):
    """Phase 5 at the verify width: B2/B3 (and int8) at s_q = 5 (device
    ms, 8 cold cache copies) beside their plain versions, SDPA with the
    kernel's boolean window (paged: index_select gathers first; int8: a
    dequantize first) and their bounds: the live K/V rows (int8: 1 byte an
    element and a 4-byte scale), q, out and the lengths (paged: 4 bytes a
    live table entry) over 3.35 TB/s, against 4 d operations a visible
    (query, key) pair at the bf16 peak; or at another verify_case shape
    (SQ16_CASE, D80_CASE)."""
    q, copies, cases = verify_case(torch, da, qz, dev, gen, 8, **case)
    b, s_q, h, d = q.shape
    hd, item = h * d, q.element_size()
    out = {}
    for name, (call, plain, lib, clen, S) in cases.items():
        fill = clen.clamp(max=S)
        live = int(fill.sum())
        lim = fill[:, None] - (s_q - 1) + torch.arange(s_q, device=dev)
        pairs = int(torch.minimum(lim.clamp(min=0), fill[:, None]).sum())
        per_pos = hd + 4 if "int8" in name else hd * item
        nbytes = 2 * live * per_pos + 2 * q.numel() * item + 4 * b
        if name.startswith("paged"):
            nbytes += 4 * int(((fill + PAGED_BS - 1) // PAGED_BS).sum())
        tb, tf = nbytes / HBM_BYTES_PER_S, 4 * pairs * d * h / BF16_FLOPS
        out[name] = {
            "ms": device_ms(lambda i: call(copies[i]), 8,
                            "decode_attention_kernel"),
            "plain_ms": device_ms(lambda i: plain(copies[i]), 8),
            "library_ms": device_ms(lambda i: lib(copies[i]), 8),
            "bound_ms": 1e3 * max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}
        print(f"phase5 {name} {_case_tag(q)} " + " ".join(
            f"{k}={v}" for k, v in out[name].items()) + f" card={card}",
            flush=True)
    print(f"phase5 library_ms at {_case_tag(q)} is "
          "scaled_dot_product_attention with the kernel's boolean window "
          "(paged: index_select gathers of K and V first; int8: a "
          "dequantize first)", flush=True)
    del copies
    return out


def filter_timing(torch, sp, dev, gen, card):
    """B4's filter at the sampled verify's shape: [8 lanes x (k + 1),
    50304] logits, temperature 0.8, top_k 50, top_p 0.9 (phase 27's),
    beside its plain version, the sort-based serving.sampling.filter_logits
    (several calls: no single PyTorch call filters top-k and top-p) and its
    byte bound (read the logits, write the filtered row)."""
    from deepspeed_tpu_torch.serving.sampling import filter_logits
    rows, V = 8 * VERIFY_SQ, 50304
    x = torch.randn(rows, V, device=dev, generator=gen) * 3
    t, k, p = (SPEC_SAMPLED[n] for n in ("temperature", "top_k", "top_p"))
    ref = sp.filter_rows_reference(x / t, k, None)
    kern_k = sp.threshold_filter_logits(x, t, k, None)
    err = (kern_k - ref).abs().max().item()
    if not torch.equal(kern_k, ref):
        fail("B4 filter top_k=50 at [40, 50304] is not bitwise its plain "
             "version")
    n_diff = _top_p_differs(torch, sp, x / t, k, p)
    nbytes = 2 * rows * V * 4
    res = {"ms": device_ms(lambda i: sp.threshold_filter_logits(x, t, k, p),
                           kernel="sampling_kernel"),
           "plain_ms": device_ms(lambda i: sp.filter_rows_reference(
               x / t, k, p), iters=10),
           "library_ms": None,
           "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 rows * V / F32_FLOPS),
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
           >= rows * V / F32_FLOPS else "operations"}
    yard = device_ms(lambda i: filter_logits(x, t, k, p))
    print(f"phase5 sampling_filter [{rows}, {V}] T={t} top_k={k} top_p={p}: "
          + " ".join(f"{key}={val}" for key, val in res.items())
          + f" yardstick filter_logits ms={yard} top_k_bitwise=True "
          f"top_p_differing_tokens={n_diff} card={card}", flush=True)
    return res, err


def _first_difference(a, b):
    return next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _near_tie_gap(torch, module, prompt, tokens, t, dev):
    """The top-2 logit gap and the tie bound where the non-speculative run
    emitted tokens[t]: a teacher-forced forward (the cacheless prefill
    path) of the prompt and tokens[:t]; bound = SPEC_TIE_ULPS bf16 ulps of
    the top logit."""
    ids = torch.tensor([list(prompt) + list(tokens[:t])], device=dev)
    with torch.inference_mode():
        hidden = module.prefill(ids)[0]
        logits = module.logits(hidden[:, -1]).float()[0]
    top = torch.topk(logits, 2).values
    gap = (top[0] - top[1]).item()
    ulp = 2.0 ** (math.floor(math.log2(abs(top[0].item()))) - 7)
    return gap, SPEC_TIE_ULPS * ulp


def phase_spec_serving(torch, dev, ie, prompts, kw, card):
    """Phase 26: phase 4's 16 requests through ServingEngine(megakernel=
    True, speculative=True, spec_k=4, spec_ngram=2) over the dense bf16,
    paged, int8 and paged int8 arenas, each beside the non-speculative
    kernel engine on the same arena in this call (every served logits
    tensor checked finite in both). Gates: every request done; logits
    finite; per spec step exactly num_layers launches of the arena's decode
    kernel (at s_q = 5) and none of another, no filter launch (greedy);
    greedy tokens equal to the non-spec engine's, or parting first at a
    near-tie of the non-spec run (top-2 gap within SPEC_TIE_ULPS bf16 ulps
    of the top logit). Prints tokens/s of both, acceptance rate, chunk ms,
    tokens a chunk, launches a step and (phase_profile) a steady spec
    chunk's idle share. Returns the decode kernels' launch counts."""
    from deepspeed_tpu_torch import ServingEngine
    n_new, K = CUT_NEW, kw["decode_chunk"]
    L = ie.module.cfg.num_layers
    spec_kw = dict(kw, megakernel=True, speculative=True, spec_k=SPEC_K,
                   spec_ngram=SPEC_NGRAM)
    launches = {}
    for name, extra, kernel in (
            ("dense", {}, "decode_attention"),
            ("paged", dict(paged=True, kv_block_size=PAGED_BS),
             "paged_decode_attention"),
            ("int8", dict(kv_dtype="int8"), "decode_attention_int8"),
            ("paged_int8", dict(paged=True, kv_block_size=PAGED_BS,
                                kv_dtype="int8"),
             "paged_decode_attention_int8")):
        ServingEngine(engine=ie, **spec_kw, **extra).run(
            [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
        base_eng = ServingEngine(engine=ie, megakernel=True, **kw, **extra)
        eng = ServingEngine(engine=ie, **spec_kw, **extra)
        flags = [_checked_logits(torch, m, dev)
                 for m in {id(base_eng.module): base_eng.module,
                           id(eng.module): eng.module}.values()]
        try:
            base, base_s, _ = _serve(torch, base_eng, prompts, n_new)
            out, seconds, launched = _serve(torch, eng, prompts, n_new)
        finally:
            for m in (base_eng.module, eng.module):
                m.__dict__.pop("logits", None)
        if any(bool(f) for f in flags):
            fail(f"non-finite logits while serving speculative {name}")
        m = eng.metrics
        steps = m.decode_steps * K
        other = [k for k in DECODE_KERNELS if k != kernel and launched.get(k)]
        print(f"phase26 spec {name} launches={launched} chunks="
              f"{m.decode_steps} steps={steps}", flush=True)
        if launched.get(kernel, 0) != L * steps or other:
            fail(f"spec {name}: {launched.get(kernel, 0)} {kernel} launches "
                 f"for {steps} steps (want {L} a step, no other decode "
                 f"kernel): {launched}")
        if launched.get("sampling_filter") or not launched.get("sampling"):
            fail(f"spec {name} greedy: filter launched or no prefill draw: "
                 f"{launched}")
        launches[kernel] = launched[kernel]
        n_tokens = sum(len(r.tokens) for r in out)
        decode_tokens = n_tokens - len(out)      # token #1 is prefill's
        parted = []
        for i, (r, s) in enumerate(zip(out, base)):
            t = _first_difference(r.tokens, s.tokens)
            if t is None:
                continue
            gap, bound = _near_tie_gap(torch, base_eng.module, prompts[i],
                                       s.tokens, t, dev)
            parted.append((i, t, gap, bound))
            if not gap <= bound:
                fail(f"spec {name} request {i} parts from the non-spec "
                     f"tokens at {t}, top-2 gap {gap} > bound {bound}")
        print(f"phase26 spec {name}: greedy tokens equal the non-spec "
              f"engine's in {len(out) - len(parted)}/{len(out)} requests; "
              f"parting (request, position, top-2 gap, bound): {parted}",
              flush=True)
        print(f"spec_{name}_serving_tokens_per_s={n_tokens / seconds} "
              f"non_spec_tokens_per_s={n_tokens / base_s} (the same 16 "
              f"requests, this call) acceptance_rate="
              f"{m.spec_acceptance_rate} mean_chunk_ms="
              f"{m.mean_decode_chunk_s * 1e3} decode_tokens_per_chunk="
              f"{decode_tokens / m.decode_steps} decode_attention_launches_"
              f"per_step={launched[kernel] / steps} (K={K}, k={SPEC_K}, "
              f"batch 8) card={card}", flush=True)
    # a spec chunk emits up to K (k + 1) tokens a lane: 600 keeps all 8
    # lanes live through the three chunks
    busy_ms, rows = phase_profile(torch, ie, prompts[:8], spec_kw, card,
                                  tag="phase26", max_new_tokens=600)
    b2_ms = sum(ms for ms, _, key in rows if "decode_attention_kernel" in key)
    print(f"phase26 spec chunk decode_attention_ms_per_step={b2_ms / K} "
          f"device_busy_ms_per_step={busy_ms / K} (K={K}, k={SPEC_K}, 8 "
          f"live lanes) card={card}", flush=True)
    return launches


def phase_spec_sampled(torch, ie, prompts, kw, seed, card):
    """Phase 27: phase 4's requests through the speculative engine at
    temperature 0.8, top-k 50, top-p 0.9 (dense bf16): exactly one B4
    filter launch (the [8 x 5, 50304] verify rows) and 12 B2 launches a
    spec step; a rerun with the same seed gives the same tokens."""
    from deepspeed_tpu_torch import ServingEngine
    skw = dict(kw, megakernel=True, speculative=True, spec_k=SPEC_K,
               spec_ngram=SPEC_NGRAM, seed=seed, **SPEC_SAMPLED)
    n_new, K = CUT_NEW, kw["decode_chunk"]
    L = ie.module.cfg.num_layers
    ServingEngine(engine=ie, **skw).run([p.copy() for p in prompts[:2]],
                                        max_new_tokens=4)     # warm-up
    eng = ServingEngine(engine=ie, **skw)
    out, seconds, launched = _serve(torch, eng, prompts, n_new)
    steps = eng.metrics.decode_steps * K
    print(f"phase27 sampled spec launches={launched} steps={steps}",
          flush=True)
    if launched.get("sampling_filter", 0) != steps:
        fail(f"sampled spec: {launched.get('sampling_filter', 0)} filter "
             f"launches for {steps} steps (want one a step)")
    if launched.get("decode_attention", 0) != L * steps:
        fail(f"sampled spec: {launched.get('decode_attention', 0)} B2 "
             f"launches for {steps} steps")
    again = ServingEngine(engine=ie, **skw).run(
        [p.copy() for p in prompts], max_new_tokens=n_new)
    if [r.tokens for r in again] != [r.tokens for r in out]:
        fail("a sampled spec rerun with the same seed gave other tokens")
    n_tokens = sum(len(r.tokens) for r in out)
    print(f"phase27 sampled spec gpt2_125m T=0.8 top_k=50 top_p=0.9 "
          f"requests=16: rerun with the same seed: tokens identical; "
          f"filter launches per step={launched['sampling_filter'] / steps}",
          flush=True)
    print(f"spec_sampled_serving_tokens_per_s={n_tokens / seconds} "
          f"acceptance_rate={eng.metrics.spec_acceptance_rate} "
          f"mean_chunk_ms={eng.metrics.mean_decode_chunk_s * 1e3} "
          f"card={card}", flush=True)
    return launched["sampling_filter"]


@contextlib.contextmanager
def _sync_errors(torch):
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _no_sync_launches(torch, eng):
    """Run the engine's launches (``_host_state``, ``_device_state``,
    ``_launch_chunk``) under torch.cuda.set_sync_debug_mode("error"): a
    host synchronisation inside one raises. Returns the per-method call
    counts."""
    counts = {}
    for name in ("_host_state", "_device_state", "_launch_chunk"):
        inner = getattr(eng, name)
        counts[name] = 0

        def wrapped(*args, _inner=inner, _name=name):
            counts[_name] += 1
            with _sync_errors(torch):
                return _inner(*args)

        setattr(eng, name, wrapped)
    return counts


def phase_serve_loop(torch, ie, prompts, kw, card):
    """Phase 28: the double-buffered loop. For the speculative, the
    non-speculative and the fused-prefill kernel engines (dense bf16; the
    fused engine's next prompt chunks come from the host's replay of its
    prompt cursors, never from device data): run() against a loop of
    step() calls (equal greedy tokens; run() launches from device-carried
    state, the step loop never; both timed), every launch under
    set_sync_debug_mode("error"); then a cancel in mid-run (after three
    pumps: the first running request and the last queued one): both end
    cancelled, the running one gets no token after its cancel, every other
    request is done with its whole budget."""
    from deepspeed_tpu_torch import ServingEngine
    n_new = 64
    for tag, extra in (("spec", dict(speculative=True, spec_k=SPEC_K,
                                     spec_ngram=SPEC_NGRAM)),
                       ("non_spec", {}),
                       ("fused", dict(fused_prefill=True,
                                      prefill_chunk=FUSED_C))):
        ekw = dict(kw, megakernel=True, **extra)
        eng = ServingEngine(engine=ie, **ekw)
        counts = _no_sync_launches(torch, eng)
        out, run_s, _ = _serve(torch, eng, prompts, n_new)
        stepper = ServingEngine(engine=ie, **ekw)
        step_counts = _no_sync_launches(torch, stepper)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [stepper.submit(p.copy(), max_new_tokens=n_new)
                for p in prompts]
        while stepper.scheduler.has_work():
            stepper.step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        if not counts["_device_state"] or step_counts["_device_state"]:
            fail(f"{tag}: run() launched {counts['_device_state']} chunks "
                 f"from device state, the step loop "
                 f"{step_counts['_device_state']}")
        if [r.tokens for r in reqs] != [r.tokens for r in out]:
            fail(f"{tag}: run() and a step() loop gave other greedy tokens")
        n_tokens = sum(len(r.tokens) for r in out)
        print(f"phase28 {tag}: run() == step() loop greedy tokens; "
              f"launches {counts} / {step_counts} under "
              f"set_sync_debug_mode('error'), no sync; tokens_per_s run="
              f"{n_tokens / run_s} step_loop={n_tokens / step_s} card={card}",
              flush=True)
    eng = ServingEngine(engine=ie, **dict(kw, megakernel=True,
                                          speculative=True, spec_k=SPEC_K))
    _no_sync_launches(torch, eng)
    reqs = [eng.submit(p.copy(), max_new_tokens=n_new) for p in prompts]
    for _ in range(3):
        eng.pump()
    running = [r for r in reqs if r.status == "running"]
    queued = [r for r in reqs if r.status == "queued"]
    if not running or not queued or not eng.chunk_in_flight:
        fail("phase28: no running and queued request with a chunk in "
             "flight after three pumps")
    victim, waiting = running[0], queued[-1]
    if not (eng.cancel(victim) and eng.cancel(waiting)):
        fail("phase28: cancel refused a live request")
    held = list(victim.tokens)
    while eng.scheduler.has_work() or eng.chunk_in_flight:
        eng.pump()
    if victim.tokens != held or waiting.tokens:
        fail("phase28: a cancelled request received tokens after cancel")
    rest = [r for r in reqs if r is not victim and r is not waiting]
    if any(r.status != "done" or len(r.tokens) != n_new for r in rest):
        fail("phase28: a request other than the cancelled ones did not "
             "finish its budget")
    if (victim.status, waiting.status) != ("cancelled", "cancelled"):
        fail("phase28: the cancelled requests are not cancelled")
    print(f"phase28 cancel mid-run (spec): request {victim.uid} after "
          f"{len(held)} tokens and queued request {waiting.uid}: both "
          f"cancelled, no token after cancel; the other {len(rest)} done "
          f"with {n_new} tokens each", flush=True)

# ---------------------------------------------------------------------------
# Slice 16: fused chunked prefill (A7) and decode at head dim 80 (C4)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def decode_widths():
    """Count the query widths of the model's decode attention calls (the
    wrappers' q.shape[1]; a width past 16 is one call of several launches),
    by (wrapper, width)."""
    import collections
    from deepspeed_tpu_torch.models import gpt
    seen = collections.Counter()
    saved = gpt.decode_attention, gpt.paged_decode_attention

    def counted(fn, name):
        def call(q, *args, **kwargs):
            seen[(name, q.shape[1])] += 1
            return fn(q, *args, **kwargs)
        return call

    gpt.decode_attention = counted(saved[0], "decode_attention")
    gpt.paged_decode_attention = counted(saved[1], "paged_decode_attention")
    try:
        yield seen
    finally:
        gpt.decode_attention, gpt.paged_decode_attention = saved


def _parting(torch, dev, module, prompts, out, base, what):
    """Requests whose greedy tokens part from the twin run's; each must
    part first at a near-tie of the twin run (SPEC_TIE_ULPS)."""
    parted = []
    for i, (r, t) in enumerate(zip(out, base)):
        pos = _first_difference(r.tokens, t.tokens)
        if pos is None:
            continue
        gap, bound = _near_tie_gap(torch, module, prompts[i], t.tokens, pos,
                                   dev)
        parted.append((i, pos, gap, bound))
        if not gap <= bound:
            fail(f"{what}: request {i} parts from its twin's tokens at "
                 f"{pos}, top-2 gap {gap} > bound {bound}")
    return parted


def _parting_stats(parted, n_req, n_new) -> str:
    """Where the requests part from their twins' tokens, and how many
    tokens the comparison covered (a request's tokens up to its parting
    position; all n_new of one that never parts)."""
    pos = sorted(p for _, p, _, _ in parted)
    compared = sum(pos) + (n_req - len(pos)) * n_new
    if not pos:
        return (f"no request parts; tokens compared {compared}/"
                f"{n_req * n_new}")
    mid = len(pos) // 2
    median = pos[mid] if len(pos) % 2 else (pos[mid - 1] + pos[mid]) / 2
    return (f"parting positions min {pos[0]} median {median} max {pos[-1]}; "
            f"tokens compared before parting {compared}/{n_req * n_new}")


@contextlib.contextmanager
def _completing_logits(eng):
    """Capture, by request uid, the logits row a fused engine takes a
    request's first token from: the completing prefill step's column
    n_cons - 1. A lane that enters a chunk with pf > 0 prompt tokens
    outstanding completes at step (pf - 1) // C, column (pf - 1) % C, when
    that step lies in the chunk. Reads the chunk's input state on the
    host, so only for untimed runs."""
    rows, steps = {}, []
    C, K = eng.prefill_chunk, eng.decode_chunk
    name = "_fused_spec_chunk" if eng.speculative else "_fused_chunk"
    decode, chunk = eng._decode, getattr(eng, name)

    def captured_decode(*args):
        logits = decode(*args)
        steps.append(logits)
        return logits

    def captured_chunk(*state):
        steps.clear()
        act, pf = state[2].cpu(), state[5].cpu()
        slots = {s: r.uid for s, r in eng.scheduler.running.items()}
        result = chunk(*state)
        for s, uid in slots.items():
            n = int(pf[s])
            if bool(act[s]) and 0 < n <= K * C:
                k = (n - 1) // C
                rows[uid] = steps[k][s, n - 1 - k * C].float().clone()
        steps.clear()
        return result

    eng._decode = captured_decode
    setattr(eng, name, captured_chunk)
    try:
        yield rows
    finally:
        eng.__dict__.pop("_decode", None)
        eng.__dict__.pop(name, None)


def _teacher_forced(torch, dev, ie, module, fused_kw, seqs, what):
    """Phase 38's logits check at the completing step: each sequence (a
    prompt and its twin run's tokens up to where they part) consumed as a
    prompt by the fused kernel engine and by the same engine over the plain
    versions (megakernel=False: the einsum route), and by the cacheless
    prefill. Fails unless each completing step's logits lie within
    LOGITS_ATOL of the einsum engine's and of the prefill's (under int8
    the prefill attends over its dequantized int8 K/V, as the cache holds
    them). Returns the largest |kernel - einsum| and |kernel - prefill|."""
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.ops.cuda import _build
    kw = dict(fused_kw, max_prompt_len=max(len(q) for q in seqs))
    got = {}
    for impl, mk in (("kernel", True), ("einsum", False)):
        eng = ServingEngine(engine=ie, **dict(kw, megakernel=mk))
        _build.reset_launch_counts()
        with _completing_logits(eng) as rows:
            out = eng.run([q.copy() for q in seqs], max_new_tokens=1)
        torch.cuda.synchronize()
        decode_launches = {k: _build.LAUNCHES[k] for k in DECODE_KERNELS
                           if _build.LAUNCHES[k]}
        if (len(rows) != len(seqs) or bool(decode_launches) != mk
                or any(r.status != "done" for r in out)):
            fail(f"{what}: the {impl} run captured {len(rows)} of "
                 f"{len(seqs)} completing steps, decode launches "
                 f"{decode_launches}")
        got[impl] = [rows[r.uid] for r in out]
    worst = {"einsum": 0.0, "prefill": 0.0}
    for i, q in enumerate(seqs):
        ids = torch.tensor([list(q)], device=dev)
        with torch.inference_mode():
            ref = module.logits(module.prefill(ids)[0][:, -1]).float()[0]
        k = got["kernel"][i]
        for against, r in (("einsum", got["einsum"][i]), ("prefill", ref)):
            err = (k - r).abs().max().item()
            worst[against] = max(worst[against], err)
            if not (torch.isfinite(k).all() and err <= LOGITS_ATOL):
                fail(f"{what}: sequence {i} (length {len(q)}) completing-step "
                     f"logits {err} from the {against} run's (tol "
                     f"{LOGITS_ATOL})")
    return worst


def _ttft(m, tag=""):
    pct = m.ttft_reservoir.percentiles((50, 99))
    return (f"{tag}ttft_mean_s={m.mean_ttft_s} {tag}ttft_p50_s={pct[50]} "
            f"{tag}ttft_p99_s={pct[99]}")


# phase 38's fused runs: (name, arena and knobs, prefill_chunk,
# speculative); the first four give the *_sq16 rows' launches. The default
# chunk_token_budget, 2 C + max_batch = 40, admits about two new prompts a
# step beside the running lanes; "dense_full_budget" gives room for all 8
# prompts' first chunks at once (8 C + 8), the unfused engine's admission
FUSED_RUNS = (("dense", {}, FUSED_C, False),
              ("paged", dict(paged=True, kv_block_size=PAGED_BS), FUSED_C,
               False),
              ("int8", dict(kv_dtype="int8"), FUSED_C, False),
              ("paged_int8", dict(paged=True, kv_block_size=PAGED_BS,
                                  kv_dtype="int8"), FUSED_C, False),
              ("spec_dense", {}, FUSED_C, True),
              ("dense_c24", {}, 24, False),
              ("dense_full_budget",
               dict(chunk_token_budget=8 * FUSED_C + 8), FUSED_C, False))


def _arena_kernel(extra) -> str:
    """The decode kernel an arena's engine launches."""
    name = ("paged_decode_attention" if extra.get("paged")
            else "decode_attention")
    return name + ("_int8" if extra.get("kv_dtype") == "int8" else "")


def phase_fused_serving(torch, dev, ie, prompts, kw, card):
    """Phase 38: fused chunked prefill on phase 4's GPT-2 125M and its 16
    greedy requests: ServingEngine(megakernel=True, fused_prefill=True,
    prefill_chunk=16) over the dense, paged, int8 and paged int8 arenas
    and speculative (k 4) on the dense one, each beside the unfused kernel
    engine on the same arena (speculative: the unfused speculative
    engine), prefill_chunk 24 once on the dense arena, and once with a
    chunk_token_budget that admits a whole batch at once. Gates: every
    request done, every logits tensor finite, no bucketed prefill program;
    each fused step calls the arena's decode wrapper once a layer at the
    step's width (16; 24 in two launches, the pieces 16 + 8) and no other
    width or decode kernel; greedy tokens equal to the twin's or parting
    first at a near-tie of the twin run. Prints tokens/s, time to first
    token (mean, p50, p99), chunk ms, prompt tokens consumed inline and
    launches a step for both, and a steady fused chunk's idle share.
    Then, teacher-forced, each prompt and its twin's tokens up to where
    they part go through the fused kernel engine, the fused einsum engine
    and the cacheless prefill, and the completing step's logits must agree
    (``_teacher_forced``). Returns the s_q 16 launches of each decode
    kernel."""
    import numpy as np
    from deepspeed_tpu_torch import ServingEngine
    n_new, K = CUT_NEW, kw["decode_chunk"]
    L = ie.module.cfg.num_layers
    launches = {}
    for name, extra, chunk, spec in FUSED_RUNS:
        base_kw = dict(kw, megakernel=True, **extra)
        if spec:
            base_kw.update(speculative=True, spec_k=SPEC_K,
                           spec_ngram=SPEC_NGRAM)
        fused_kw = dict(base_kw, fused_prefill=True, prefill_chunk=chunk)
        ServingEngine(engine=ie, **fused_kw).run(
            [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
        base_eng = ServingEngine(engine=ie, **base_kw)
        eng = ServingEngine(engine=ie, **fused_kw)
        flags = [_checked_logits(torch, m, dev)
                 for m in {id(base_eng.module): base_eng.module,
                           id(eng.module): eng.module}.values()]
        try:
            base, base_s, base_launched = _serve(torch, base_eng, prompts,
                                                 n_new)
            with decode_widths() as widths:
                out, seconds, launched = _serve(torch, eng, prompts, n_new)
        finally:
            for m in (base_eng.module, eng.module):
                m.__dict__.pop("logits", None)
        if any(bool(f) for f in flags):
            fail(f"phase38 {name}: non-finite logits")
        kernel = _arena_kernel(extra)
        wrapper = kernel.replace("_int8", "")
        m = eng.metrics
        steps = m.decode_steps * K
        pieces = -(-chunk // FUSED_C)
        other = [k for k in DECODE_KERNELS if k != kernel and launched.get(k)]
        print(f"phase38 fused {name} prefill_chunk={chunk} launches="
              f"{launched} widths={dict(widths)} chunks={m.decode_steps} "
              f"steps={steps}", flush=True)
        if m.prefill_programs or m.prefill_prompt_tokens:
            fail(f"phase38 {name}: a bucketed prefill ran")
        if (launched.get(kernel, 0) != pieces * L * steps or other
                or dict(widths) != {(wrapper, chunk): L * steps}):
            fail(f"phase38 {name}: {launched.get(kernel, 0)} {kernel} "
                 f"launches and widths {dict(widths)} for {steps} steps "
                 f"(want {pieces} a layer a step at width {chunk}, no other "
                 f"decode kernel or width): {launched}")
        if eng.inline_prefill_tokens != sum(len(p) for p in prompts):
            fail(f"phase38 {name}: {eng.inline_prefill_tokens} prompt "
                 f"tokens consumed inline")
        if name in ("dense", "paged", "int8", "paged_int8"):
            launches[kernel] = launched[kernel]
        parted = _parting(torch, dev, base_eng.module, prompts, out, base,
                          f"phase38 {name}")
        # teacher-forced: each prompt and its twin's tokens up to where the
        # two part (all but the last of a request that never parts)
        at = dict((i, pos) for i, pos, _, _ in parted)
        seqs = [np.concatenate([p, np.asarray(t.tokens[:at.get(i, n_new - 1)],
                                               p.dtype)])
                for i, (p, t) in enumerate(zip(prompts, base))]
        worst = _teacher_forced(torch, dev, ie, base_eng.module, fused_kw,
                                seqs, f"phase38 {name}")
        print(f"phase38 fused {name} teacher-forced completing step over "
              f"{len(seqs)} sequences of {min(map(len, seqs))}-"
              f"{max(map(len, seqs))} tokens: max |kernel - einsum engine| "
              f"{worst['einsum']}, max |kernel - prefill| {worst['prefill']}"
              f" (tol {LOGITS_ATOL})", flush=True)
        n_tokens = sum(len(r.tokens) for r in out)
        bm = base_eng.metrics
        base_steps = bm.decode_steps * K
        print(f"phase38 fused {name}: greedy tokens equal the unfused "
              f"engine's in {len(out) - len(parted)}/{len(out)} requests; "
              f"{_parting_stats(parted, len(out), n_new)}; parting "
              f"(request, position, top-2 gap, bound): {parted}", flush=True)
        print(f"fused_{name}_serving_tokens_per_s={n_tokens / seconds} "
              f"{_ttft(m)} mean_chunk_ms={m.mean_decode_chunk_s * 1e3} "
              f"inline_prefill_tokens={eng.inline_prefill_tokens} "
              f"{kernel}_launches_per_step={launched[kernel] / steps}; "
              f"unfused_tokens_per_s={n_tokens / base_s} "
              f"{_ttft(bm, 'unfused_')} unfused_mean_chunk_ms="
              f"{bm.mean_decode_chunk_s * 1e3} unfused_prefill_prompt_"
              f"tokens={bm.prefill_prompt_tokens} unfused_{kernel}_launches"
              f"_per_step={base_launched.get(kernel, 0) / base_steps}"
              f" (K={K}, batch 8) card={card}", flush=True)
    # a steady fused chunk: every prompt consumed by the first chunk (at
    # most 8 steps of 16 tokens), the profiled chunks pure C-wide decode
    busy_ms, rows = phase_profile(torch, ie, prompts[:8], dict(
        kw, fused_prefill=True, prefill_chunk=FUSED_C), card, tag="phase38")
    b2_ms = sum(ms for ms, _, key in rows if "decode_attention_kernel" in key)
    print(f"phase38 fused chunk decode_attention_ms_per_step={b2_ms / K} "
          f"device_busy_ms_per_step={busy_ms / K} (K={K}, s_q {FUSED_C}, 8 "
          f"live lanes) card={card}", flush=True)
    return launches


# phase 39: GPT 2.7B's width (bench.py:423: 32 layers, 32 heads of 80,
# d_model 2560, d_ff 10240, max_seq_len 1024, bf16) cut in depth to fit the
# time limit
D80_LAYERS = 4


def phase_d80_serving(torch, np, dev, seed, prompts, kw, card):
    """Phase 39 (fault C4): ServingEngine(megakernel=True) at GPT 2.7B's
    width, D80_LAYERS layers, random weights from --seed, phase 4's 16
    requests over the dense, paged, int8 and paged int8 arenas, each beside
    the megakernel=False engine (decode_impl "einsum", the plain sampler)
    on the same arena. Gates: every request done, logits finite, the
    arena's decode kernel launched L times a decode step (s_q 1, d 80) and
    no other, greedy tokens equal or parting first at a near-tie of the
    einsum run. Returns the d 80 launches of each decode kernel."""
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig(vocab_size=50304, max_seq_len=1024,
                    num_layers=D80_LAYERS, num_heads=32, d_model=2560,
                    d_ff=10240, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    n_new, K, L = 64, kw["decode_chunk"], cfg.num_layers
    print(f"phase39 GPT 2.7B width (d_model 2560, 32 heads of 80, d_ff "
          f"10240) cut to {L} of 32 layers, bf16", flush=True)
    launches = {}
    for name, extra, _, _ in FUSED_RUNS[:4]:
        ServingEngine(engine=ie, megakernel=True, **kw, **extra).run(
            [p.copy() for p in prompts[:2]], max_new_tokens=4)   # warm-up
        base_eng = ServingEngine(engine=ie, megakernel=False, **kw, **extra)
        eng = ServingEngine(engine=ie, megakernel=True, **kw, **extra)
        flags = [_checked_logits(torch, m, dev)
                 for m in {id(base_eng.module): base_eng.module,
                           id(eng.module): eng.module}.values()]
        try:
            base, base_s, base_launched = _serve(torch, base_eng, prompts,
                                                 n_new)
            out, seconds, launched = _serve(torch, eng, prompts, n_new)
        finally:
            for m in (base_eng.module, eng.module):
                m.__dict__.pop("logits", None)
        if any(bool(f) for f in flags):
            fail(f"phase39 {name}: non-finite logits")
        kernel = _arena_kernel(extra)
        steps = eng.metrics.decode_steps * K
        other = [k for k in DECODE_KERNELS if k != kernel and launched.get(k)]
        if (launched.get(kernel, 0) != L * steps or other
                or any(base_launched.get(k) for k in DECODE_KERNELS)):
            fail(f"phase39 {name}: {launched.get(kernel, 0)} {kernel} "
                 f"launches for {steps} steps (want {L} a step, no other "
                 f"decode kernel; the einsum engine none): {launched} / "
                 f"{base_launched}")
        launches[kernel] = launched[kernel]
        parted = _parting(torch, dev, base_eng.module, prompts, out, base,
                          f"phase39 {name}")
        n_tokens = sum(len(r.tokens) for r in out)
        print(f"phase39 d80 {name}: launches={launched}; greedy tokens equal "
              f"the einsum engine's in {len(out) - len(parted)}/{len(out)} "
              f"requests; parting (request, position, top-2 gap, bound): "
              f"{parted}", flush=True)
        print(f"d80_{name}_serving_tokens_per_s={n_tokens / seconds} "
              f"einsum_tokens_per_s={n_tokens / base_s} mean_chunk_ms="
              f"{eng.metrics.mean_decode_chunk_s * 1e3} (L={L}, K={K}, batch "
              f"8) card={card}", flush=True)
    del ie, model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Slice 17: HF injection, local windows and int8 weights at GPT-Neo 1.3B
# ---------------------------------------------------------------------------

# EleutherAI/gpt-neo-1.3B's published config.json: 24 layers alternating
# global and local attention (attention_types [[["global", "local"], 12]],
# window_size 256), 16 heads of 128, hidden_size 2048, intermediate_size
# null (so 4 x 2048), vocab 50257, max_position_embeddings 2048, unscaled
# scores; the weights are random from --seed under HF's key names
NEO_LAYERS = 12                      # of 24, cut to fit the time limit
NEO_CONFIG = dict(model_type="gpt_neo", vocab_size=50257,
                  max_position_embeddings=2048, hidden_size=2048,
                  num_heads=16, intermediate_size=None, window_size=256,
                  layer_norm_epsilon=1e-5, activation_function="gelu_new")
NEO_PARAMS = 711_424_000             # at 12 layers, tied head (24:
#                                      1_315_723_264)
NEO_IDS = (2, 1024)                  # phase 40's forward and generate
NEO_GEN = 32
# B1 at the global layers' forward shape, scale 1.0 (GPT-Neo's); B2 at a
# decode step (s_q 1) and a fused step (s_q 16) over the dense arenas the
# phase's engines build (max_seq_len 2048; C - 1 = 15 positions of
# lookahead), with fills up to the row end and the sentinel
NEO_FLASH = (2, 1024, 16, 128)
NEO_CASE = dict(s_q=1, h=16, d=128, Sd=2048, T=2048 // PAGED_BS,
                fills=(1, 17, 512, 2048, 300, 1500, 777), scale=1.0)
NEO_SQ16_CASE = dict(s_q=FUSED_C, h=16, d=128, Sd=2048 + FUSED_C - 1,
                     T=2048 // PAGED_BS + 1,
                     fills=(16, 33, 1024, 2063, 300, 1500, 777), scale=1.0)


def neo_hf_model(torch, dev, seed, layers):
    """A GPT-Neo 1.3B checkpoint as HF would hold it: (config namespace,
    state dict of bf16 tensors on the card under HF's key names), matrices
    and embeddings N(0, 0.02) from ``seed``, LayerNorm scales 1, biases 0;
    q / k / v without biases, the tied ``lm_head``."""
    import types
    cfg = types.SimpleNamespace(
        num_layers=layers,
        attention_layers=["global", "local"] * (layers // 2), **NEO_CONFIG)
    D, V, P = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings
    F_ = cfg.intermediate_size or 4 * D
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, device=dev, generator=gen)
                * 0.02).bfloat16()

    def ones(n):
        return torch.ones(n, device=dev, dtype=torch.bfloat16)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=torch.bfloat16)

    sd = {"transformer.wte.weight": w(V, D), "transformer.wpe.weight": w(P, D)}
    for i in range(layers):
        pre = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = ones(D), zeros(D)
        att = pre + "attn.attention."
        for n in ("k", "v", "q"):
            sd[att + f"{n}_proj.weight"] = w(D, D)
        sd[att + "out_proj.weight"], sd[att + "out_proj.bias"] = w(D, D), \
            zeros(D)
        sd[pre + "mlp.c_fc.weight"], sd[pre + "mlp.c_fc.bias"] = w(F_, D), \
            zeros(F_)
        sd[pre + "mlp.c_proj.weight"], sd[pre + "mlp.c_proj.bias"] = \
            w(D, F_), zeros(D)
    sd["transformer.ln_f.weight"], sd["transformer.ln_f.bias"] = ones(D), \
        zeros(D)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return cfg, sd


def _build_engine(torch, cfg, host, dev, **kw):
    """An InferenceEngine over a meta-device GPT taking ``host``'s tensors:
    (engine, bytes its build added to the card's peak, weight bytes at
    rest)."""
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.models.gpt import GPT
    from deepspeed_tpu_torch.ops.quantizer import weight_bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ie = InferenceEngine(GPT(cfg, device="meta"), model_parameters=host,
                         dtype=torch.bfloat16, device=dev, **kw)
    torch.cuda.synchronize()
    return (ie, torch.cuda.max_memory_allocated(dev) - base,
            weight_bytes(ie.module))


@contextlib.contextmanager
def kernel_checks(torch, errs, what):
    """Hold every B1, B2 and B3 call of the model against its plain version
    on the call's own inputs (no extra launch: the plain version runs
    beside the kernel's result): B1 within FLASH_TOL, B2 and B3 within
    DECODE_ATOL (+ DECODE_INT8_RTOL |ref| over an int8 cache). The plain versions run in
    f32 on the inputs' values: at GPT-Neo's unscaled scores (|s| up to
    about 40) the bf16 einsum of the plain decode version rounds a score
    by up to 0.125 and errs by up to 0.2 itself. ``errs`` collects the max
    abs error by kernel name."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    saved = (gpt.flash_attention, gpt.decode_attention,
             gpt.paged_decode_attention)

    def flash(q, k, v, causal=True, sm_scale=None):
        out = saved[0](q, k, v, causal=causal, sm_scale=sm_scale)
        ref = fa.flash_attention_forward_reference(
            q.float(), k.float(), v.float(), causal, sm_scale)[0]
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0),
                                _close(out, ref, *FLASH_TOL))
        return out

    def decode(q, ck, cv, cache_len, scale=None, k_scale=None, v_scale=None):
        out = saved[1](q, ck, cv, cache_len, scale=scale, k_scale=k_scale,
                       v_scale=v_scale)
        int8 = k_scale is not None
        ref = da.decode_attention_reference(
            q.float(), ck if int8 else ck.float(),
            cv if int8 else cv.float(), cache_len,
            q.shape[-1] ** -0.5 if scale is None else scale, k_scale,
            v_scale)
        errs["decode_attention"] = max(
            errs.get("decode_attention", 0.0), _decode_err(
                torch, out, ref, f"{what} decode_attention s_q "
                f"{q.shape[1]}", DECODE_INT8_RTOL if int8 else 0.0))
        return out

    def paged(q, kp, vp, tables, cache_len, scale=None, k_scale=None,
              v_scale=None):
        out = saved[2](q, kp, vp, tables, cache_len, scale=scale,
                       k_scale=k_scale, v_scale=v_scale)
        int8 = k_scale is not None
        ref = da.paged_decode_attention_reference(
            q.float(), kp if int8 else kp.float(),
            vp if int8 else vp.float(), tables, cache_len,
            q.shape[-1] ** -0.5 if scale is None else scale, k_scale,
            v_scale)
        errs["paged_decode_attention"] = max(
            errs.get("paged_decode_attention", 0.0), _decode_err(
                torch, out, ref, f"{what} paged_decode_attention s_q "
                f"{q.shape[1]}", DECODE_INT8_RTOL if int8 else 0.0))
        return out

    gpt.flash_attention, gpt.decode_attention, gpt.paged_decode_attention \
        = flash, decode, paged
    try:
        yield errs
    finally:
        (gpt.flash_attention, gpt.decode_attention,
         gpt.paged_decode_attention) = saved


def _forward_counted(torch, ie, ids, what, n_global, errs):
    """``ie.forward(ids)`` with the counts reset just before and read just
    after (B1 once a global layer, no other kernel) and every B1 call held
    to its plain version (``kernel_checks``)."""
    from deepspeed_tpu_torch.ops.cuda import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with kernel_checks(torch, errs, what):
        logits = ie.forward(ids)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launched != {"flash_fwd": n_global}:
        fail(f"{what} forward launched {launched} (want flash_fwd "
             f"{n_global}: once a global layer)")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{what} forward: non-finite logits")
    return logits, launched["flash_fwd"]


def _neo_profile(torch, ie, prompts, kw, card, tag):
    """A steady GPT-Neo decode chunk profiled (``phase_profile``), with B2's
    device ms a step beside the step's device busy ms."""
    K = kw["decode_chunk"]
    busy_ms, rows = phase_profile(torch, ie, prompts[:8], kw, card, tag=tag)
    b2_ms = sum(ms for ms, _, key in rows if "decode_attention_kernel" in key)
    print(f"{tag} decode chunk decode_attention_ms_per_step={b2_ms / K} "
          f"device_busy_ms_per_step={busy_ms / K} (K={K}, 8 live lanes) "
          f"card={card}", flush=True)


def _lm_loss(logits, ids):
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    return float(lm_loss_fn(logits, {"input_ids": ids}))


def _agreement(out, base):
    """Greedy tokens of a run against its twin's: (requests equal, tokens
    equal, tokens, first parting positions)."""
    parts = [_first_difference(r.tokens, t.tokens) for r, t in zip(out, base)]
    same = sum(int(a == b) for r, t in zip(out, base)
               for a, b in zip(r.tokens, t.tokens))
    return (sum(p is None for p in parts), same,
            sum(len(r.tokens) for r in out),
            sorted(p for p in parts if p is not None))


def phase_neo_serving(torch, np, dev, seed, prompts, kw, card):
    """Phase 40: GPT-Neo 1.3B (EleutherAI's config.json, NEO_LAYERS
    layers) from an HF-named state dict made from --seed on the card,
    converted there by HFGPTNeoPolicy and held on the host. Gates:
    ``InferenceEngine.forward`` on [2, 1024] launches B1 once a global
    layer (scale 1.0), each call within FLASH_TOL of its plain version on
    its own inputs, and its loss within LOSS_ATOL of the same weights'
    through attention_impl="xla" (the logits' max difference and top-1
    agreement are printed: with unscaled scores, 24 random layers carry a
    rounding difference far, so no logits tolerance holds across two bf16
    paths); greedy ``generate`` of 32 tokens, its first token the xla
    forward's argmax or a near-tie; the dense, fused (prefill_chunk 16)
    and speculative (k 4) megakernel ServingEngines serve phase 4's 16
    requests beside megakernel=False: every request done, logits finite,
    B2 once a global layer a step at the step's width (1, 16, 5) and no
    other decode kernel or width, B4 never (vocab 50257 is not
    lane-aligned), every B2 call of a warm-up run within DECODE_ATOL of its
    plain version, the first tokens equal where both engines prefill
    alike (dense, speculative); the share of greedy tokens equal to the
    twin's and where they part are printed; paged=True raises. Then B1 at
    the forward's shape and B2 at s_q 1 and 16 against their plain
    versions on random inputs, timed. Returns what phase 41 and the
    kernels line need."""
    import dataclasses
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT
    from deepspeed_tpu_torch.module_inject import HFGPTNeoPolicy
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops import quantizer as qz
    t0 = time.perf_counter()
    hf_cfg, hf_sd = neo_hf_model(torch, dev, seed, NEO_LAYERS)
    cfg = dataclasses.replace(HFGPTNeoPolicy.config_from_hf(hf_cfg),
                              dtype=torch.bfloat16)
    sd = HFGPTNeoPolicy.convert(hf_sd, cfg.num_layers)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    host = {k: v.cpu() for k, v in sd.items()}
    del hf_sd, sd
    torch.cuda.empty_cache()
    L = cfg.num_layers
    n_global = sum(cfg.window(i) is None for i in range(L))
    # phase 4's requests, their token ids folded into GPT-Neo's vocab
    prompts = [(p % cfg.vocab_size).astype(p.dtype) for p in prompts]
    n_params = sum(v.numel() for v in host.values())
    print(f"phase40 GPT-Neo 1.3B: {L} layers ({n_global} global, "
          f"{L - n_global} local, window {hf_cfg.window_size}), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, qk_scale {cfg.qk_scale}; "
          f"{n_params} parameters; HF state dict made and converted on the "
          f"card in {convert_s:.2f} s", flush=True)
    if L == NEO_LAYERS and n_params != NEO_PARAMS:
        fail(f"GPT-Neo 1.3B has {n_params} parameters, want {NEO_PARAMS}")
    if cfg.qk_scale != 1.0 or cfg.attn_windows[:2] != (
            None, hf_cfg.window_size):
        fail(f"HFGPTNeoPolicy config: qk_scale {cfg.qk_scale}, windows "
             f"{cfg.attn_windows[:2]}")
    ie, peak, at_rest = _build_engine(torch, cfg, host, dev)
    print(f"phase40 bf16 engine: weights at rest {at_rest} B, build peak "
          f"{peak} B card={card}", flush=True)

    rng = np.random.default_rng(seed + 40)
    ids = rng.integers(1, cfg.vocab_size, NEO_IDS).astype(np.int64)
    ids_t = torch.from_numpy(ids).to(dev)
    errs = {}
    logits, b1 = _forward_counted(torch, ie, ids, "phase40 bf16", n_global,
                                  errs)
    xla = GPT(dataclasses.replace(cfg, attention_impl="xla"), device="meta")
    xla.load_state_dict(ie.module.state_dict(), assign=True)
    with torch.inference_mode():
        ref = xla(ids_t)
    err = (logits.float() - ref.float()).abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    loss, loss_xla = _lm_loss(logits, ids_t), _lm_loss(ref, ids_t)
    print(f"phase40 forward {list(NEO_IDS)}: B1 launches {b1} (once a "
          f"global layer), each within max_abs_err={errs['flash_fwd']} of "
          f"its plain version on its own inputs; loss {loss} vs "
          f"attention_impl='xla' {loss_xla} (tol {LOSS_ATOL}); logits vs "
          f"xla max_abs_err={err} top1_agreement={top1}", flush=True)
    if not abs(loss - loss_xla) <= LOSS_ATOL:
        fail(f"GPT-Neo forward loss through B1 {loss} vs the einsum "
             f"{loss_xla}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ie.generate(ids, max_new_tokens=NEO_GEN, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    last = ref[:, -1].float()
    for r in range(NEO_IDS[0]):
        tok = int(out[r, NEO_IDS[1]])
        if tok != int(last[r].argmax()):
            top = torch.topk(last[r], 2).values
            gap = (top[0] - top[1]).item()
            ulp = 2.0 ** (math.floor(math.log2(abs(top[0].item()))) - 7)
            if not gap <= SPEC_TIE_ULPS * ulp:
                fail(f"generate's first token {tok} is not the forward's "
                     f"argmax {int(last[r].argmax())} (gap {gap})")
    print(f"phase40 generate greedy {NEO_GEN} tokens on {list(NEO_IDS)} "
          f"(einsum decode) in {gen_s} s: "
          f"{NEO_IDS[0] * NEO_GEN / gen_s} tokens/s card={card}", flush=True)
    del ref, xla, out

    n_new, K = CUT_NEW, kw["decode_chunk"]
    runs = (("dense", {}, 1),
            ("fused", dict(fused_prefill=True, prefill_chunk=FUSED_C),
             FUSED_C),
            ("spec", dict(speculative=True, spec_k=SPEC_K,
                          spec_ngram=SPEC_NGRAM), SPEC_K + 1))
    launches, tok_s = {}, {}
    for name, extra, width in runs:
        mk_kw = dict(kw, megakernel=True, **extra)
        with kernel_checks(torch, errs, f"phase40 {name}"):   # warm-up
            ServingEngine(engine=ie, **mk_kw).run(
                [p.copy() for p in prompts[:2]], max_new_tokens=4)
        base_eng = ServingEngine(engine=ie, **dict(mk_kw, megakernel=False))
        eng = ServingEngine(engine=ie, **mk_kw)
        flags = [_checked_logits(torch, m, dev)
                 for m in {id(base_eng.module): base_eng.module,
                           id(eng.module): eng.module}.values()]
        try:
            base, base_s, base_launched = _serve(torch, base_eng, prompts,
                                                 n_new)
            with decode_widths() as widths:
                got, seconds, launched = _serve(torch, eng, prompts, n_new)
        finally:
            for m in (base_eng.module, eng.module):
                m.__dict__.pop("logits", None)
        if any(bool(f) for f in flags):
            fail(f"phase40 {name}: non-finite logits")
        m = eng.metrics
        steps = m.decode_steps * K
        print(f"phase40 {name}: launches={launched} widths={dict(widths)} "
              f"steps={steps}; megakernel=False launches={base_launched}",
              flush=True)
        if (launched.get("decode_attention", 0) != n_global * steps
                or dict(widths) != {("decode_attention", width):
                                    n_global * steps}
                or set(launched) - {"decode_attention"}
                or any(base_launched.get(k) for k in DECODE_KERNELS)):
            fail(f"phase40 {name}: want decode_attention {n_global} a step "
                 f"at width {width} and nothing else ({steps} steps), the "
                 f"plain engine no decode kernel: {launched} "
                 f"{dict(widths)} / {base_launched}")
        if extra.get("fused_prefill") and (m.prefill_programs
                                           or m.prefill_prompt_tokens):
            fail(f"phase40 {name}: a bucketed prefill ran")
        if not extra.get("fused_prefill") and any(
                r.tokens[0] != t.tokens[0] for r, t in zip(got, base)):
            fail(f"phase40 {name}: first tokens (one prefill path) differ "
                 f"from the megakernel=False engine's")
        launches[name] = launched["decode_attention"]
        n_eq, same, n_tokens, parts = _agreement(got, base)
        tok_s[name] = n_tokens / seconds
        print(f"phase40 {name}: greedy tokens equal the megakernel=False "
              f"engine's in {n_eq}/{len(got)} requests, {same}/{n_tokens} "
              f"tokens; first parting positions {parts}", flush=True)
        print(f"neo_{name}_serving_tokens_per_s={tok_s[name]} {_ttft(m)} "
              f"mean_chunk_ms={m.mean_decode_chunk_s * 1e3} "
              f"plain_tokens_per_s={n_tokens / base_s} "
              f"{_ttft(base_eng.metrics, 'plain_')} (L={L}, K={K}, batch "
              f"8) card={card}", flush=True)
        if name == "dense":
            dense_tokens = [list(r.tokens) for r in got]
    print(f"phase40 every B1 / B2 call checked on its own inputs: max_abs_err "
          f"{errs}", flush=True)
    _neo_profile(torch, ie, prompts, kw, card, "phase40")
    try:
        ServingEngine(engine=ie, paged=True, megakernel=True, **kw)
    except NotImplementedError as e:
        print(f"phase40 paged=True raises: {e}", flush=True)
    else:
        fail("phase40: a paged engine over windowed layers was built")

    # B1 at the global layers' forward shape with GPT-Neo's scale 1.0
    B, S, H, D = NEO_FLASH
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    fo, fl = fa.flash_attention_forward(q, k, v, True, 1.0)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, True, 1.0)
    torch.cuda.synchronize()
    flash_err = _close(fo, ro, *FLASH_TOL)
    lse_err = _close(fl, rl, LSE_ATOL, 0.0)
    flash_t = _flash_times(torch, fa, q, k, v, do, ro, rl, True,
                           scale=1.0)["flash_fwd"]
    print(f"phase40 flash_fwd B={B} S={S} H={H} D={D} causal scale=1.0 "
          f"max_abs_err out={flash_err} lse={lse_err} " + " ".join(
              f"{key}={val}" for key, val in flash_t.items())
          + f" card={card}", flush=True)
    del q, k, v, do, fo, fl, ro, rl
    case_errs, times = {}, {}
    for tag, case in (("", NEO_CASE), ("_sq16", NEO_SQ16_CASE)):
        case_errs[tag] = case_parity(torch, da, qz, dev, gen, exact=True,
                                     **case)[0]
        times[tag] = verify_timing(torch, da, qz, dev, gen, card, **case)
    torch.cuda.empty_cache()
    return {"cfg": cfg, "host": host, "ie": ie, "ids": ids,
            "prompts": prompts, "logits": logits, "bf16_peak": peak,
            "bf16_bytes": at_rest, "tok_s": tok_s["dense"],
            "dense_tokens": dense_tokens, "n_global": n_global, "rows": [
                ("flash_fwd_neo", "flash_attention.cu",
                 "flash_attention.py:52", b1,
                 max(flash_err, lse_err, errs["flash_fwd"]), flash_t),
                ("decode_attention_neo", "decode_attention.cuh",
                 "decode_attention.py:74", launches["dense"],
                 max(case_errs[""]["decode_attention"],
                     errs["decode_attention"]),
                 times[""]["decode_attention"]),
                ("decode_attention_neo_sq16", "decode_attention.cuh",
                 "decode_attention.py:74", launches["fused"],
                 max(case_errs["_sq16"]["decode_attention"],
                     errs["decode_attention"]),
                 times["_sq16"]["decode_attention"])]}


def phase_neo_int8(torch, np, dev, neo, kw, card):
    """Phase 41: phase 40's GPT-Neo through InferenceEngine(quantize_bits=8),
    symmetric and asymmetric, built from the same host state dict. Gates:
    the weights at rest below 0.6 x bf16's and the build's peak below the
    bf16 build's (no whole bf16 tree on the card); every stored Linear's
    int8 codes and f32 scales (and zmin) equal to the plain quantize /
    quantize_asym of its bf16 weight on the card, one group a column, and
    its weight equal to the plain dequantize of them; the forward launches
    B1 once a global layer, each call within FLASH_TOL of its plain
    version, and its logits equal a bf16 model's over the dequantized
    weights within LOGITS_ATOL (the same arithmetic); ServingEngine(
    engine=ie, megakernel=True) serves phase 4's 16 requests (done, finite
    logits, B2 once a global layer a step, each call of a warm-up run
    within DECODE_ATOL of its plain version). Prints bytes at rest and the
    build peak beside bf16's, max |logit - bf16 engine| and top-1 agreement
    over the prompt positions, and tokens/s beside bf16's."""
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT
    from deepspeed_tpu_torch.ops import quantizer as qz
    cfg, host, n_global = neo["cfg"], neo["host"], neo["n_global"]
    prompts = neo["prompts"]
    n_new, K = CUT_NEW, kw["decode_chunk"]
    launches = {}
    for mode in ("symmetric", "asymmetric"):
        ie, peak, at_rest = _build_engine(torch, cfg, host, dev,
                                          quantize_bits=8, quantize_mode=mode)
        print(f"phase41 int8 {mode}: weights at rest {at_rest} B "
              f"({at_rest / neo['bf16_bytes']} x bf16's {neo['bf16_bytes']}),"
              f" build peak {peak} B (bf16: {neo['bf16_peak']}) card={card}",
              flush=True)
        if not (at_rest < 0.6 * neo["bf16_bytes"]
                and peak < neo["bf16_peak"]):
            fail(f"phase41 {mode}: {at_rest} B at rest, peak {peak} B "
                 f"against bf16's {neo['bf16_bytes']} / {neo['bf16_peak']}")
        n_lin = 0
        deq = {}
        for name, m in ie.module.named_modules():
            if not isinstance(m, qz.Int8Linear):
                continue
            n_lin += 1
            w = host[name + ".weight"].to(dev)
            if mode == "symmetric":
                want = qz.quantize(w, w.shape[0])
                plain = qz.dequantize(*want, torch.bfloat16)
                got = (m.q8, m.scale)
            else:
                want = qz.quantize_asym(w, w.shape[0])
                plain = qz.dequantize_asym(*want, torch.bfloat16)
                got = (m.q8, m.scale, m.zmin)
            if m.scale.dtype != torch.float32 or not all(
                    torch.equal(a, b) for a, b in zip(got, want)) \
                    or not torch.equal(m.weight, plain):
                fail(f"phase41 {mode}: {name}'s int8 weight is not the "
                     f"plain quantization of its bf16 weight")
            deq[name + ".weight"] = plain
        if n_lin != 4 * cfg.num_layers:
            fail(f"phase41 {mode}: {n_lin} int8 Linears, want "
                 f"{4 * cfg.num_layers}")
        errs = {}
        logits, _ = _forward_counted(torch, ie, neo["ids"],
                                     f"phase41 {mode}", n_global, errs)
        ref_model = GPT(cfg, device="meta")
        state = {k: v for k, v in ie.module.state_dict().items()
                 if not k.endswith((".q8", ".scale", ".zmin"))}
        ref_model.load_state_dict(dict(state, **deq), assign=True)
        with torch.inference_mode():
            ref = ref_model(torch.from_numpy(neo["ids"]).to(dev))
        deq_err = (logits.float() - ref.float()).abs().max().item()
        del ref_model, ref, deq, state
        bf = neo["logits"]
        err = (logits.float() - bf.float()).abs().max().item()
        top1 = (logits.argmax(-1) == bf.argmax(-1)).float().mean().item()
        print(f"phase41 int8 {mode}: {n_lin} Linears bitwise the plain "
              f"quantize/dequantize; forward vs a bf16 model over the "
              f"dequantized weights max_abs_err={deq_err} (tol "
              f"{LOGITS_ATOL}); vs the bf16 engine max_abs_err={err} "
              f"top1_agreement={top1} over {logits.shape[0]} x "
              f"{logits.shape[1]} prompt positions", flush=True)
        if not deq_err <= LOGITS_ATOL:
            fail(f"phase41 {mode}: int8 forward vs its dequantized weights "
                 f"{deq_err}")
        del logits
        with kernel_checks(torch, errs, f"phase41 {mode}"):   # warm-up
            ServingEngine(engine=ie, megakernel=True, **kw).run(
                [p.copy() for p in prompts[:2]], max_new_tokens=4)
        eng = ServingEngine(engine=ie, megakernel=True, **kw)
        flag = _checked_logits(torch, eng.module, dev)
        try:
            got, seconds, launched = _serve(torch, eng, prompts, n_new)
        finally:
            eng.module.__dict__.pop("logits", None)
        steps = eng.metrics.decode_steps * K
        if bool(flag) or launched.get("decode_attention", 0) \
                != n_global * steps or set(launched) - {"decode_attention"}:
            fail(f"phase41 {mode}: non-finite logits ({bool(flag)}) or "
                 f"launches {launched} for {steps} steps (want "
                 f"decode_attention {n_global} a step)")
        launches[mode] = launched["decode_attention"]
        if mode == "symmetric":
            _neo_profile(torch, ie, prompts, kw, card, "phase41")
        n_tokens = sum(len(r.tokens) for r in got)
        same = sum(int(a == b) for r, t in zip(got, neo["dense_tokens"])
                   for a, b in zip(r.tokens, t))
        print(f"neo_int8_{mode}_serving_tokens_per_s={n_tokens / seconds} "
              f"bf16_tokens_per_s={neo['tok_s']} mean_chunk_ms="
              f"{eng.metrics.mean_decode_chunk_s * 1e3} {_ttft(eng.metrics)}"
              f"; tokens equal to the bf16 engine's {same}/{n_tokens}; "
              f"B1 / B2 calls checked: max_abs_err {errs} (L="
              f"{cfg.num_layers}, K={K}, batch 8) card={card}", flush=True)
        del ie, eng
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Slice 5: the fused transformer ops (B6, B7, B8) and DeepSpeedTransformerLayer
# ---------------------------------------------------------------------------

# --------------------------------------------------------------------------
# Phases 42-44: GPT-MoE and expert parallelism
# --------------------------------------------------------------------------

# gpt_moe_1_3b (models/gpt.py, the MoE-NLG family) at its full width and
# depth (24 layers, d_model 2048, 16 heads of 128, d_ff 8192, vocab 50304)
# with its 128 experts cut to 16: 24 MoE layers x 128 x 33.6e6 expert
# parameters are 206 GB in bf16, past the card's 80 GB; 16 experts make
# 13.4e9 parameters (26.8 GB). Top-1, eval capacity 2.0, min capacity 4.
MOE_EXPERTS = 16
MOE_LAYERS = 4                       # of 24, cut to fit the time limit
MOE_PARAMS = 2_320_568_320           # at 4 layers, 16 experts, tied head
#                                      (6: 3_428_290_560; 12:
#                                      6_751_457_280; 24: 13_397_790_720)
MOE_IDS = (2, 1024)                  # phase 42's forward check
# one MoE layer in bf16 against the same function in f32 on the same bf16
# inputs (identical routing: the gate computes in f32 from the same
# weights): the expert GEMMs round to bf16 (2^-8 relative an element),
# the combine weights too; the max error is held to 2^-6 of the output's
# largest magnitude
MOE_OUT_RTOL = 2.0 ** -6
# B2 at the served decode step (s_q 1) and fused step (s_q 16) over the
# dense arenas phase 42's engines build (max_seq_len 1024; the fused one
# C - 1 = 15 positions of lookahead), with fills up to the row end
MOE_CASE = dict(s_q=1, h=16, d=128, Sd=1024, T=1024 // PAGED_BS,
                fills=(1, 17, 512, 1024, 300, 64, 777))
MOE_SQ16_CASE = dict(s_q=FUSED_C, h=16, d=128, Sd=1024 + FUSED_C - 1,
                     T=1024 // PAGED_BS + 1,
                     fills=(16, 33, 512, 1039, 300, 64, 777))
# phase 43: the same width cut to 2 layers, trained
MOE_TRAIN_LAYERS, MOE_TRAIN_MICRO, MOE_TRAIN_GAS = 2, 4, 2
MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1024, 4
MOE_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": MOE_TRAIN_MICRO,
                    "gradient_accumulation_steps": MOE_TRAIN_GAS,
                    "bf16": {"enabled": True},
                    "zero_optimization": {"stage": 1},
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                    "steps_per_print": 1000}
# phase 44: a small GPT-MoE (d_model 512, 8 heads of 64, d_ff 2048, 4
# experts, 2 layers, seq 256) in f32 at ep 2 x dp 1 on two gloo ranks
# sharing the card, against ep 1 in this process: the ep partners' expert
# GEMMs run over 2 experts a call instead of 4 (another cuBLAS batch),
# which may round differently; rtol on the losses
EP_CFG = dict(vocab_size=50304, max_seq_len=256, num_layers=2, num_heads=8,
              d_model=512, d_ff=2048, moe=True, num_experts=4)
EP_MICRO, EP_STEPS, EP_GEN = 4, 3, 16
EP_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": EP_MICRO,
                   "gradient_accumulation_steps": 1,
                   "zero_optimization": {"stage": 1},
                   "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                   "steps_per_print": 1000}
EP_LOSS_RTOL = 1e-3
EP_TIE_ATOL = 1e-4                   # f32 top-2 gap of a near-tie token


@contextlib.contextmanager
def sampling_checks(torch, errs):
    """Hold every B4 draw of the served path against its plain version on
    the call's own logits (greedy: the tokens must be equal); ``errs``
    collects the number of rows that differ under "sampling"."""
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    from deepspeed_tpu_torch.serving import sampling as serving_sampling
    saved = serving_sampling.fused_sample

    def checked(logits, gumbel, temperature, top_k, top_p=None):
        out = saved(logits, gumbel, temperature, top_k, top_p)
        x = logits.float()
        if temperature != 0.0:
            x = x / temperature
            gumbel = gumbel.float()
        ref = sp.fused_sample_reference(x, gumbel, top_k, top_p)
        errs["sampling"] = errs.get("sampling", 0) + int((out != ref).sum())
        return out

    serving_sampling.fused_sample = checked
    try:
        yield errs
    finally:
        serving_sampling.fused_sample = saved


@contextlib.contextmanager
def moe_route_stats(torch, module, decode_tokens):
    """Forward hooks on every MoE gate of ``module``: for the calls that
    route ``decode_tokens`` tokens (a decode step) and the others
    (prefill), the calls, the capacity and the tokens kept (device sums,
    read after the run). Top-1 with no ``used_token``: every token picks
    one expert, so the dropped ones are the tokens less the kept."""
    from deepspeed_tpu_torch.moe.sharded_moe import TopKGate
    dev = next(module.parameters()).device
    stats = {k: {"calls": 0, "tokens": 0, "capacity": set(),
                 "kept": torch.zeros((), dtype=torch.long, device=dev)}
             for k in ("decode", "prefill")}

    def hook(gate, inputs, outputs):
        s = stats["decode" if inputs[0].shape[0] == decode_tokens
                  else "prefill"]
        s["calls"] += 1
        s["tokens"] += inputs[0].shape[0]
        s["capacity"].add(outputs[1].shape[2])
        s["kept"] += outputs[2].sum()

    hooks = [m.register_forward_hook(hook) for m in module.modules()
             if isinstance(m, TopKGate)]
    try:
        yield stats
    finally:
        for h in hooks:
            h.remove()


def _moe_step_split(torch, ie, prompts, kw, card, tag):
    """A steady decode chunk of ``ie`` under torch.profiler: a decode
    step's device ms split into the attention kernel (B2), the expert
    bank's batched GEMMs (aten::baddbmm), the dispatch and combine einsums
    (aten::einsum) and the rest (the gate, the dense projections, the
    head, B4, ...), each the device time of the kernels launched under it,
    over the chunk's K steps; the chunk's idle share as phase 6 reads it."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch import ServingEngine
    K = kw["decode_chunk"]
    eng = ServingEngine(engine=ie, **{"megakernel": True, **kw})
    for p in prompts[:kw["max_batch"]]:
        eng.submit(p.copy(), max_new_tokens=1 + 3 * K)
    eng.step()                       # admission, prefill, first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                       # a pure decode chunk, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    busy = sum(_device_us(e) for e in rows) / 1e3

    def under(op):
        return sum(float(getattr(e, "device_time_total", 0.0)
                         or getattr(e, "cuda_time_total", 0.0))
                   for e in rows if e.key == op) / 1e3
    attn = sum(_device_us(e) for e in rows
               if "decode_attention_kernel" in e.key) / 1e3
    bmm, einsum = under("aten::baddbmm"), under("aten::einsum")
    if busy <= 0 or bmm <= 0 or einsum <= 0 or attn <= 0:
        fail(f"{tag}: the profiler did not see the decode step's parts "
             f"(busy {busy}, attention {attn}, bmm {bmm}, einsum {einsum})")
    print(f"{tag} decode step device ms (K={K}, {kw['max_batch']} lanes): "
          f"attention_kernels={attn / K} expert_bmm={bmm / K} "
          f"dispatch_combine={einsum / K} rest={(busy - attn - bmm - einsum) / K}"
          f" busy={busy / K}; chunk idle_share={1 - busy / wall_ms} "
          f"card={card}", flush=True)
    return {"attention_ms": attn / K, "expert_bmm_ms": bmm / K,
            "dispatch_combine_ms": einsum / K, "busy_ms": busy / K}


def _sampling_time(torch, sp, dev, gen, b, V):
    """B4 greedy at [b, V] f32 logits: device ms beside its plain version
    and torch.argmax, and its bound (the logits read once, the tokens
    written; one comparison an element at the f32 peak)."""
    x = torch.randn(b, V, device=dev, generator=gen)
    t = {"ms": device_ms(lambda i: sp.fused_sample(x, None, 0.0, None),
                         kernel="sampling_kernel"),
         "plain_ms": device_ms(lambda i: sp.fused_sample_reference(
             x, None, None, None)),
         "library_ms": device_ms(lambda i: torch.argmax(x, dim=-1))}
    tb, tf = (b * V * 4 + b * 4) / HBM_BYTES_PER_S, b * V / F32_FLOPS
    t["bound_ms"] = 1e3 * max(tb, tf)
    t["bound_by"] = "bytes" if tb >= tf else "operations"
    err = int((sp.fused_sample(x, None, 0.0, None)
               != sp.fused_sample_reference(x, None, None, None)).sum())
    return t, err


def phase_moe_serving(torch, np, dev, seed, prompts, kw, card):
    """Phase 42: gpt_moe_1_3b(num_experts=16) at full width, MOE_LAYERS
    deep,
    bf16, its weights made on the card from --seed (no f32 copy). Gates:
    ``InferenceEngine.forward`` on [2, 1024] launches B1 once a layer,
    each call within FLASH_TOL of its plain version on its own inputs, and
    its loss within LOSS_ATOL of the same weights through
    attention_impl="xla"; layer 0's MoE output on a prefill's own inputs
    within MOE_OUT_RTOL of the same function in f32; the dense and fused
    (prefill_chunk 16) megakernel ServingEngines serve phase 4's 16
    requests (64 new tokens, batch 8): every request done, logits finite,
    every B2 call within DECODE_ATOL and every B4 draw equal to its plain
    version's (one checked run), then a timed run with the counts reset
    just before: B2 once a layer a step at the step's width, B4 once a
    step, and its tokens the checked run's. Prints weight bytes,
    max_memory_allocated, tokens/s, chunk ms, the capacity and dropped
    tokens of a decode step's routing, and a decode step's device ms split
    (``_moe_step_split``); then B1 at the forward's shape, B2 at s_q 1
    and 16 and B4 at [8, 50304] against their plain versions, timed (the
    *_moe rows). Returns those rows."""
    import copy
    import dataclasses
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_moe_1_3b
    from deepspeed_tpu_torch.moe.utils import count_moe_params
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    from deepspeed_tpu_torch.ops import quantizer as qz
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(gpt_moe_1_3b(
        num_experts=MOE_EXPERTS, max_seq_len=1024, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16), num_layers=MOE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = GPT(cfg, device="meta")
    model.to_empty(device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    ie = InferenceEngine(model, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = cfg.num_layers
    n_params = sum(p.numel() for p in ie.module.parameters())
    shared, expert = count_moe_params(ie.module)
    at_rest = qz.weight_bytes(ie.module)
    print(f"phase42 gpt_moe_1_3b({MOE_EXPERTS} experts; 128 cut to fit the "
          f"card): {L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"top-{cfg.moe_top_k}, eval capacity {cfg.moe_eval_capacity_factor}"
          f", min {cfg.moe_min_capacity}; {n_params} parameters ({expert} in "
          f"expert banks, {shared} shared), built bf16 on the card in "
          f"{build_s:.2f} s: weights at rest {at_rest} B, build peak "
          f"{torch.cuda.max_memory_allocated(dev) - base} B card={card}",
          flush=True)
    if n_params != MOE_PARAMS:
        fail(f"gpt_moe_1_3b at {MOE_EXPERTS} experts has {n_params} "
             f"parameters, want {MOE_PARAMS}")

    rng = np.random.default_rng(seed + 42)
    ids = rng.integers(1, cfg.vocab_size, MOE_IDS).astype(np.int64)
    ids_t = torch.from_numpy(ids).to(dev)
    errs = {}
    logits, b1 = _forward_counted(torch, ie, ids, "phase42", L, errs)
    xla = GPT(dataclasses.replace(cfg, attention_impl="xla"), device="meta")
    xla.load_state_dict(ie.module.state_dict(), assign=True)
    with torch.inference_mode():
        ref = xla(ids_t)[0]
    loss, loss_xla = _lm_loss(logits, ids_t), _lm_loss(ref, ids_t)
    err = (logits.float() - ref.float()).abs().max().item()
    print(f"phase42 forward {list(MOE_IDS)}: B1 launches {b1} (once a "
          f"layer), each within max_abs_err={errs['flash_fwd']} of its plain "
          f"version on its own inputs; loss {loss} vs attention_impl='xla' "
          f"{loss_xla} (tol {LOSS_ATOL}); logits vs xla max_abs_err={err}",
          flush=True)
    if not abs(loss - loss_xla) <= LOSS_ATOL:
        fail(f"GPT-MoE forward loss through B1 {loss} vs the einsum "
             f"{loss_xla}")
    del logits, ref, xla

    # layer 0's MoE on a prefill's own inputs, against the function in f32
    moe = ie.module.blocks[0].moe
    seen = []
    hook = moe.register_forward_hook(
        lambda m, args, out: seen.append((args[0], out[0])))
    pids = np.zeros((kw["max_batch"], kw["max_prompt_len"]), np.int64)
    for i, p in enumerate(prompts[:kw["max_batch"]]):
        pids[i, :len(p)] = p
    with torch.inference_mode():
        ie.module.prefill(torch.from_numpy(pids).to(dev))
    hook.remove()
    x, out = seen[0]
    ref_moe = copy.deepcopy(moe).float()
    ref_moe.deepspeed_moe.experts.dtype = torch.float32
    with torch.inference_mode():
        want = ref_moe(x.float())[0]
    err = (out.float() - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"phase42 layer-0 MoE on a prefill's inputs [{x.shape[0]}, "
          f"{x.shape[1]}, {x.shape[2]}] (bf16) vs the same function in f32: "
          f"max_abs_err={err} (tol {MOE_OUT_RTOL} x max|ref| = "
          f"{MOE_OUT_RTOL * scale})", flush=True)
    if not err <= MOE_OUT_RTOL * scale:
        fail(f"layer 0's MoE output leaves its f32 twin by {err}")
    del ref_moe, seen, x, out, want
    torch.cuda.empty_cache()

    n_new, K = CUT_NEW, kw["decode_chunk"]
    runs = (("dense", {}, 1),
            ("fused", dict(fused_prefill=True, prefill_chunk=FUSED_C),
             FUSED_C))
    launches, sampled, tok_s = {}, {}, {}
    for name, extra, width in runs:
        mk_kw = dict(kw, megakernel=True, **extra)
        ServingEngine(engine=ie, **mk_kw).run(           # warm-up
            [p.copy() for p in prompts[:2]], max_new_tokens=4)
        checked_eng = ServingEngine(engine=ie, **mk_kw)
        bad = _checked_logits(torch, checked_eng.module, dev)
        try:
            with kernel_checks(torch, errs, f"phase42 {name}"), \
                    sampling_checks(torch, errs), \
                    moe_route_stats(torch, ie.module,
                                    kw["max_batch"] * width) as routes:
                checked, _, _ = _serve(torch, checked_eng, prompts, n_new)
        finally:
            checked_eng.module.__dict__.pop("logits", None)
        if bool(bad):
            fail(f"phase42 {name}: non-finite logits")
        if errs.get("sampling"):
            fail(f"phase42 {name}: {errs['sampling']} B4 draws differ from "
                 f"the plain version's")
        d, p = routes["decode"], routes["prefill"]
        steps_routed = d["calls"] // L
        print(f"phase42 {name} routing: a decode step routes "
              f"{kw['max_batch'] * width} tokens a layer at capacity "
              f"{sorted(d['capacity'])}, dropped "
              f"{(d['tokens'] - int(d['kept'])) / max(steps_routed, 1)} "
              f"tokens a step over {L} layers "
              f"({(d['tokens'] - int(d['kept'])) / max(d['tokens'], 1)} of "
              f"the routed tokens, {steps_routed} steps); prefill calls "
              f"{p['calls'] // L} at capacity {sorted(p['capacity'])}, "
              f"dropped {(p['tokens'] - int(p['kept'])) / max(p['tokens'], 1)}"
              f" of their tokens", flush=True)
        eng = ServingEngine(engine=ie, **mk_kw)
        torch.cuda.reset_peak_memory_stats(dev)
        with decode_widths() as widths:
            got, seconds, launched = _serve(torch, eng, prompts, n_new)
        peak = torch.cuda.max_memory_allocated(dev)
        m = eng.metrics
        steps = m.decode_steps * K
        print(f"phase42 {name}: launches={launched} widths={dict(widths)} "
              f"steps={steps}", flush=True)
        if (launched.get("decode_attention", 0) != L * steps
                or dict(widths) != {("decode_attention", width): L * steps}
                or set(launched) - {"decode_attention", "sampling"}
                or not launched.get("sampling")):
            fail(f"phase42 {name}: want decode_attention {L} a step at "
                 f"width {width}, sampling, and nothing else ({steps} "
                 f"steps): {launched} {dict(widths)}")
        if [r.tokens for r in got] != [r.tokens for r in checked]:
            fail(f"phase42 {name}: the timed run's tokens differ from the "
                 f"checked run's")
        if extra.get("fused_prefill") and (m.prefill_programs
                                           or m.prefill_prompt_tokens):
            fail(f"phase42 {name}: a bucketed prefill ran")
        launches[name] = launched["decode_attention"]
        sampled[name] = launched["sampling"]
        n_tokens = sum(len(r.tokens) for r in got)
        tok_s[name] = n_tokens / seconds
        print(f"moe_{name}_serving_tokens_per_s={tok_s[name]} {_ttft(m)} "
              f"mean_chunk_ms={m.mean_decode_chunk_s * 1e3} "
              f"max_memory_allocated={peak} weights_at_rest={at_rest} "
              f"(L={L}, {MOE_EXPERTS} experts, K={K}, batch "
              f"{kw['max_batch']}, {len(prompts)} requests x {n_new} tokens) "
              f"card={card}", flush=True)
        if name == "dense":
            dense = got
        else:
            n_eq, same, total, parts = _agreement(got, dense)
            print(f"phase42 fused tokens equal the dense engine's in "
                  f"{n_eq}/{len(got)} requests, {same}/{total} tokens (a "
                  f"call routes all its rows together, and a fused step "
                  f"routes other rows than a decode step: capacity drops "
                  f"differ); first parting positions {parts}", flush=True)
    print(f"phase42 every B1 / B2 / B4 call checked on its own inputs: "
          f"{errs}", flush=True)
    split = _moe_step_split(torch, ie, prompts, kw, card, "phase42")
    del ie, model
    gc.collect()
    torch.cuda.empty_cache()

    # B1 at the forward's shape, B2 at the served widths, B4 at the served
    # logits' shape, against their plain versions, timed
    gen = torch.Generator(device=dev).manual_seed(seed + 42)
    B, S, H, D = MOE_IDS + (cfg.num_heads, cfg.head_dim)
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    fo, fl = fa.flash_attention_forward(q, k, v, True, D ** -0.5)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, True, D ** -0.5)
    torch.cuda.synchronize()
    flash_err = max(_close(fo, ro, *FLASH_TOL), _close(fl, rl, LSE_ATOL, 0.0))
    flash_t = _flash_times(torch, fa, q, k, v, do, ro, rl,
                           True)["flash_fwd"]
    print(f"phase42 flash_fwd B={B} S={S} H={H} D={D} causal max_abs_err="
          f"{flash_err} " + " ".join(f"{key}={val}" for key, val in
                                     flash_t.items()) + f" card={card}",
          flush=True)
    del q, k, v, do, fo, fl, ro, rl
    case_errs, times = {}, {}
    for tag, case in (("", MOE_CASE), ("_sq16", MOE_SQ16_CASE)):
        case_errs[tag] = case_parity(torch, da, qz, dev, gen, **case)[0]
        times[tag] = verify_timing(torch, da, qz, dev, gen, card, **case)
    sp_t, sp_err = _sampling_time(torch, sp, dev, gen, kw["max_batch"],
                                  cfg.vocab_size)
    print(f"phase42 sampling b={kw['max_batch']} V={cfg.vocab_size} greedy "
          f"rows differing from the plain version: {sp_err} " + " ".join(
              f"{key}={val}" for key, val in sp_t.items())
          + f" card={card}", flush=True)
    if sp_err:
        fail(f"phase42: B4 differs from its plain version in {sp_err} rows")
    torch.cuda.empty_cache()
    print(f"phase42 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return {"split": split, "tok_s": tok_s, "rows": [
        ("flash_fwd_moe", "flash_attention.cu", "flash_attention.py:52", b1,
         max(flash_err, errs["flash_fwd"]), flash_t),
        ("decode_attention_moe", "decode_attention.cuh",
         "decode_attention.py:74", launches["dense"],
         max(case_errs[""]["decode_attention"], errs["decode_attention"]),
         times[""]["decode_attention"]),
        ("decode_attention_moe_sq16", "decode_attention.cuh",
         "decode_attention.py:74", launches["fused"],
         max(case_errs["_sq16"]["decode_attention"],
             errs["decode_attention"]),
         times["_sq16"]["decode_attention"]),
        ("sampling_moe", "sampling.cu", "sampling.py:132",
         sampled["dense"] + sampled["fused"], float(sp_err), sp_t)]}


def phase_moe_training(torch, np, dev, seed, card):
    """Phase 43: phase 42's width (16 experts) cut to MOE_TRAIN_LAYERS
    layers, trained through initialize() + train_batch: seq 1024, micro 4
    x gas 2, bf16 over fp32 masters, AdamW lr 1e-4, ZeRO-1, remat (the
    default policy), the training gate (capacity factor 1.25, Random Token
    Selection from the engine's seeded generator). 1 warm-up and 3 timed
    steps on one repeated batch, counts reset before the timed ones. Gates:
    losses finite and falling, every micro-batch's weighted l_aux finite,
    B1 / B1b launches of L x gas x (2, 1, 1) a step. Then B1 / B1b at the
    training attention shape [4, 1024, 16, 128] against their plain
    versions, timed (the flash_*_moe rows' errors and times; B1's forward
    row is phase 42's)."""
    import dataclasses
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_moe_1_3b, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(
        gpt_moe_1_3b(num_experts=MOE_EXPERTS, max_seq_len=MOE_TRAIN_SEQ,
                     dtype=torch.bfloat16), num_layers=MOE_TRAIN_LAYERS)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    auxes = []

    def loss_fn(out, batch):
        auxes.append(out[1].detach())
        return lm_loss_fn(out, batch)

    reset_peak(torch, dev)
    engine, *_ = dst.initialize(model=model, loss_fn=loss_fn,
                                config=MOE_TRAIN_CONFIG)
    ids = np.random.default_rng(seed + 43).integers(
        0, cfg.vocab_size, (MOE_TRAIN_MICRO, MOE_TRAIN_SEQ)).astype(np.int32)
    losses, norms, secs = [], [], []
    for step in range(MOE_TRAIN_STEPS):
        if step == 1:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}] * MOE_TRAIN_GAS))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    aux = [float(a) for a in auxes]
    per_step = cfg.num_layers * MOE_TRAIN_GAS
    timed = MOE_TRAIN_STEPS - 1
    want = {"flash_fwd": 2 * per_step * timed,
            "flash_bwd_dq": per_step * timed,
            "flash_bwd_dkv": per_step * timed}
    step_s = sum(secs[1:]) / timed
    tokens = MOE_TRAIN_MICRO * MOE_TRAIN_SEQ * MOE_TRAIN_GAS
    print(f"phase43 training gpt_moe_1_3b width ({cfg.num_layers} layers, "
          f"{MOE_EXPERTS} experts, {sum(p.numel() for p in model.parameters())}"
          f" parameters) losses={losses} grad_norms={norms} "
          f"weighted_l_aux={aux} step_s={secs} launches={launches} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}",
          flush=True)
    print(f"moe_train_step_s={step_s} moe_train_tokens_per_s="
          f"{tokens / step_s} (micro {MOE_TRAIN_MICRO} x gas "
          f"{MOE_TRAIN_GAS} x seq {MOE_TRAIN_SEQ}) card={card}", flush=True)
    if not all(np.isfinite(losses + norms + aux)):
        fail("phase43: a non-finite loss, grad norm or l_aux")
    if not losses[-1] < losses[0]:
        fail(f"phase43: the loss did not fall over {MOE_TRAIN_STEPS} steps: "
             f"{losses}")
    if launches != want:
        fail(f"phase43: flash launch counts {launches}, expected {want}")
    del engine, model, auxes
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    B, S, H, D = MOE_TRAIN_MICRO, MOE_TRAIN_SEQ, cfg.num_heads, cfg.head_dim
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    errs, (ro, rl) = _flash_pair(torch, fa, q, k, v, do, True)
    times = _flash_times(torch, fa, q, k, v, do, ro, rl, True)
    print(f"phase43 flash B={B} S={S} H={H} D={D} causal max_abs_err " +
          " ".join(f"{k_}={v_}" for k_, v_ in errs.items()) + " " + " ".join(
              f"{name}_{key}={val}" for name, t in times.items()
              for key, val in t.items()) + f" card={card}", flush=True)
    del q, k, v, do, ro, rl
    torch.cuda.empty_cache()
    print(f"phase43 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return {"launches": launches, "errs": errs, "times": times}


def _ep_model(torch, dev, seed):
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(dtype=torch.float32, **EP_CFG), device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model


def _ep_train(torch, np, dev, seed, config):
    """Phase 44's training run: losses of EP_STEPS steps, the engine's
    expert bytes, its B1 / B1b launches."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    engine, *_ = dst.initialize(model=_ep_model(torch, dev, seed),
                                loss_fn=lm_loss_fn, config=config)
    rng = np.random.default_rng(seed + 44)
    batches = [rng.integers(0, EP_CFG["vocab_size"],
                            (EP_MICRO, EP_CFG["max_seq_len"])).astype(np.int32)
               for _ in range(EP_STEPS)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses = [float(engine.train_batch(iter([{"input_ids": b}])))
              for b in batches]
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    out = {"losses": losses, "launches": launches,
           "expert_bytes": _expert_bytes(engine.module),
           "ep": engine.ep_world_size, "dp": engine.dp_world_size}
    del engine
    return out


def _expert_bytes(module) -> int:
    from deepspeed_tpu_torch.moe.utils import \
        split_params_into_shared_and_expert
    _, expert = split_params_into_shared_and_expert(module)
    return sum(p.numel() * p.element_size() for p in expert.values())


def _ep_prompts(np, seed):
    return np.random.default_rng(seed + 45).integers(
        1, EP_CFG["vocab_size"], (4, 32)).astype(np.int64)


def ep_rank_main(args) -> int:
    """One rank of phase 44 (this script with --ep-rank): ep 2 x dp 1 over
    gloo with both ranks on card 0; training losses and launches, and
    InferenceEngine ep_size 1 and 2 forward logits, greedy tokens and
    expert bytes; results as JSON to --dp-out."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine, comm
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{args.dp_port}",
                          rank=args.ep_rank, world_size=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"rank": comm.get_rank(), "backend":
           torch.distributed.get_backend()}
    t0 = time.perf_counter()
    out["train"] = _ep_train(torch, np, dev, args.seed,
                             dict(EP_TRAIN_CONFIG, mesh={"ep": 2}))
    out["train_s"] = time.perf_counter() - t0
    prompts = _ep_prompts(np, args.seed)
    for ep in (1, 2):
        ie = InferenceEngine(_ep_model(torch, dev, args.seed),
                             dtype=torch.float32, ep_size=ep, device=dev)
        tokens = ie.generate(prompts, max_new_tokens=EP_GEN,
                             temperature=0.0)
        logits = ie.forward(prompts)
        out[f"ie{ep}"] = {"tokens": tokens.cpu().tolist(),
                          "logits_last": logits[:, -1].cpu().tolist(),
                          "expert_bytes": _expert_bytes(ie.module),
                          "weight_bytes": sum(p.numel() * p.element_size()
                                              for p in ie.module.parameters())}
        if ep == 2:
            try:
                ServingEngine(engine=ie)
                out["serving"] = "built"
            except NotImplementedError as exc:
                out["serving"] = str(exc)
        del ie
    with open(args.dp_out, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(seed, n, args, phase, timeout, d, own_card=False,
                script=None):
    """``script`` (default this one) ``n`` times more as the ranks of a
    multi-rank phase: each run gets ``args`` with its rank after the first
    (the hidden flag), --dp-port (a free localhost port for gloo) and --dp-out (its JSON result
    under ``d``); LOCAL_RANK is 0 (every rank on card 0) or, with
    ``own_card``, the rank. Fails on a rank's exit code or on ``timeout``
    seconds; returns the ranks' JSON results."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs, outs = [], []
    for rank in range(n):
        env = dict(os.environ, LOCAL_RANK=str(rank if own_card else 0))
        procs.append(subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), "--seed",
             str(seed), args[0], str(rank), *args[1:], "--dp-port", str(port),
             "--dp-out", os.path.join(d, f"rank{rank}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        fail(f"phase {phase}: the ranks outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-6000:], flush=True)
            fail(f"phase {phase} rank {rank} exited {p.returncode}")
    ranks = []
    for rank in range(n):
        with open(os.path.join(d, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks


def run_ep_ranks(seed):
    """This script twice more as the two ranks of phase 44 (--ep-rank 0 /
    1); their JSON results."""
    with tempfile.TemporaryDirectory() as d:
        return spawn_ranks(seed, 2, ["--ep-rank"], 44, DP_TIMEOUT_S, d)


def phase_ep(torch, np, dev, seed, card):
    """Phase 44: expert parallelism over two gloo ranks sharing the card
    (EP_CFG in f32). This process trains ep 1 for EP_STEPS steps; the
    ranks train the same model and batches at mesh {"ep": 2} (dp 1). Gates:
    the two ranks' losses equal and within EP_LOSS_RTOL of ep 1's, B1 / B1b
    launched on each rank, each rank's engine holding half of ep 1's
    expert bytes; on each rank ``InferenceEngine(ep_size=2)`` greedy tokens
    equal ``ep_size=1``'s or parting first at a near-tie (top-2 gap of
    the ep 1 logits within EP_TIE_ATOL), its last-position logits within
    EP_TIE_ATOL of ep 1's, its expert bytes half of ep 1's, and a
    ServingEngine over it refused (ROADMAP A9)."""
    t_phase = time.perf_counter()
    ref = _ep_train(torch, np, dev, seed, EP_TRAIN_CONFIG)
    ranks = run_ep_ranks(seed)
    for r in ranks:
        t = r["train"]
        print(f"phase44 rank {r['rank']} ({r['backend']}) ep={t['ep']} "
              f"dp={t['dp']} losses={t['losses']} launches={t['launches']} "
              f"expert_bytes={t['expert_bytes']} train_s={r['train_s']}; "
              f"ep 1 here: losses={ref['losses']} expert_bytes="
              f"{ref['expert_bytes']} card={card}", flush=True)
        if (t["ep"], t["dp"]) != (2, 1):
            fail(f"phase44: rank {r['rank']} trained at ep {t['ep']} dp "
                 f"{t['dp']}")
        if not np.allclose(t["losses"], ref["losses"], rtol=EP_LOSS_RTOL,
                           atol=0):
            fail(f"phase44: ep 2 losses {t['losses']} leave ep 1's "
                 f"{ref['losses']}")
        if not all(t["launches"].values()):
            fail(f"phase44: rank {r['rank']} launches {t['launches']}")
        if 2 * t["expert_bytes"] != ref["expert_bytes"]:
            fail(f"phase44: rank {r['rank']} holds {t['expert_bytes']} expert"
                 f" bytes, not half of {ref['expert_bytes']}")
        one, two = r["ie1"], r["ie2"]
        last1, last2 = (np.asarray(x["logits_last"]) for x in (one, two))
        lerr = float(np.abs(last1 - last2).max())
        parts = [_first_difference(a, b) for a, b in
                 zip(one["tokens"], two["tokens"])]
        print(f"phase44 rank {r['rank']} InferenceEngine ep_size 2 vs 1: "
              f"tokens parting at {parts}, last-position logits max_abs_err="
              f"{lerr}, expert bytes {two['expert_bytes']} vs "
              f"{one['expert_bytes']} (weights {two['weight_bytes']} vs "
              f"{one['weight_bytes']}); ServingEngine over ep 2: "
              f"{r['serving']}", flush=True)
        if not lerr <= EP_TIE_ATOL:
            fail(f"phase44: ep 2 logits leave ep 1's by {lerr}")
        if 2 * two["expert_bytes"] != one["expert_bytes"]:
            fail("phase44: ep_size 2 does not halve the expert bytes")
        if "ROADMAP A9" not in r["serving"]:
            fail(f"phase44: a ServingEngine over ep 2 was {r['serving']}")
        for row, at in enumerate(parts):
            if at is not None:
                _ep_near_tie(torch, dev, seed, one["tokens"][row][:at], at,
                             row)
    if ranks[0]["train"]["losses"] != ranks[1]["train"]["losses"]:
        fail("phase44: the two ep ranks report different losses")
    print(f"phase44 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return {name: ranks[0]["train"]["launches"][name] for name in FLASH}


def _ep_near_tie(torch, dev, seed, prefix, at, row):
    """Fails unless ep 1's next token after ``prefix`` (where ep 2's tokens
    part from ep 1's) was a near-tie: its top-2 logits within
    EP_TIE_ATOL."""
    from deepspeed_tpu_torch import InferenceEngine
    ie = InferenceEngine(_ep_model(torch, dev, seed), dtype=torch.float32,
                         device=dev)
    with torch.inference_mode():
        top = torch.topk(ie.forward([prefix])[0, -1].float(), 2).values
    gap = float(top[0] - top[1])
    if not gap <= EP_TIE_ATOL:
        fail(f"phase44: ep 2 tokens part from ep 1's at {at} in row {row} "
             f"(top-2 gap {gap})")


# --------------------------------------------------------------------------
# Phases 45-46: tensor parallelism at GPT-NeoX 20B
# --------------------------------------------------------------------------

# gpt_neox_20b (models/gpt.py: 44 layers, d_model 6144, 64 heads of 96,
# d_ff 24576, rotary, parallel residual, untied head, vocab 50304) at tp 2
# over two gloo ranks sharing the card, cut in depth to fit the time limit:
# 4.9e9 B of bf16 weights whole (41.1e9 at 44 layers), half a rank, made on
# the card from --seed module by module (models.gpt.init_tp_shards), so no
# rank ever holds the whole model
NEOX_LAYERS = 4                      # of 44, cut to fit the time limit
NEOX_PARAMS = 2_430_406_656          # at 4 layers (44: 20_552_994_816)
NEOX_TP = 2
NEOX_IDS = (2, 1024)                 # the forward through B1
NEOX_BLOCK_IN = (1, 16)              # layer 0's input rows
NEOX_CUT = 2                         # the cut depth: tp 1 and int8 checks
NEOX_CUT_IDS = (1, 64)
NEOX_N_NEW = 16                      # phase 4's 64 tokens cut to fit
NEOX_GENERATE = 1                    # requests held to generate's tokens
# per-rank weight bytes within 1% of half the whole model's
NEOX_HALF_RTOL = 1e-2
# tp 2 against tp 1 (layer 0's output, the cut depth's logits): a rank's
# halves of the row-split GEMMs and of the two branches are rounded to bf16
# before they are summed, about four roundings an element of the branch
# outputs (up to the output's largest magnitude; each 2^-8 of it), so
# |got - ref| <= LOGITS_ATOL + NEOX_TP_RTOL max |ref|, as MOE_OUT_RTOL
# holds an MoE layer
NEOX_TP_RTOL = 2.0 ** -6
# phase 45's tp_overlap and fused runs: the first requests, fewer tokens
NEOX_FUSED_REQUESTS, NEOX_FUSED_NEW = 8, 8
# B2 at the served decode step and fused step over the arenas phase 45's
# engines build, with the local heads (h 32 of d 96)
NEOX_CASE = dict(s_q=1, h=32, d=96, Sd=1024, T=1024 // PAGED_BS,
                 fills=(1, 17, 512, 1024, 300, 64, 777))
NEOX_SQ16_CASE = dict(s_q=FUSED_C, h=32, d=96, Sd=1024 + FUSED_C - 1,
                      T=1024 // PAGED_BS + 1,
                      fills=(16, 33, 512, 1039, 300, 64, 777))
# phase 46: the width cut to NEOX_CUT layers, trained at mesh tp 2
NEOX_TRAIN_MICRO, NEOX_TRAIN_GAS, NEOX_TRAIN_STEPS = 2, 2, 3
NEOX_TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": NEOX_TRAIN_MICRO,
                     "gradient_accumulation_steps": NEOX_TRAIN_GAS,
                     "bf16": {"enabled": True},
                     "zero_optimization": {"stage": 1},
                     "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                     "steps_per_print": 1000}
TP_TIMEOUT_S = 600


def _neox_cfg(torch, layers=None, **kw):
    """gpt_neox_20b at max_seq_len 1024, bf16 (``layers``: cut depth)."""
    import dataclasses
    from deepspeed_tpu_torch.models.gpt import gpt_neox_20b
    cfg = gpt_neox_20b(max_seq_len=1024, dtype=torch.bfloat16,
                       param_dtype=kw.pop("param_dtype", torch.bfloat16),
                       **kw)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def _neox_model(torch, cfg, group, seed, dev):
    """GPT-NeoX at ``cfg`` built on the meta device, then given its random
    weights on the card module by module, keeping this rank's tp shard
    (whole when ``group`` is None): every build is a slice of one model."""
    from deepspeed_tpu_torch.models.gpt import GPT, init_tp_shards
    return init_tp_shards(GPT(cfg, device="meta"), group, seed, dev)


def _neox_prompts(np, seed, vocab):
    rng = np.random.default_rng(seed)         # phase 4's requests
    return [rng.integers(1, vocab, int(n)).astype(np.int32)
            for n in rng.integers(16, 129, 16)]


def _tp_mesh(torch):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.ensure_global_mesh(mesh_lib.MeshShape.infer(
        comm.get_world_size(), tp=NEOX_TP))
    return comm.new_group("tp", mesh)


def _tp_serve_runs(torch, np, dev, ie, prompts, kw, out):
    """Phase 45's serving on this rank: the dense and the paged engine
    each checked (every B2 / B3 call and B4 draw held to its plain
    version, logits finite), then timed (counts reset just before); the
    dense engine under tp_overlap and the fused engine (C 16), each on the
    first NEOX_FUSED_REQUESTS requests, NEOX_FUSED_NEW tokens each.
    Tokens, launches, seconds and metrics into ``out``."""
    import dataclasses
    from deepspeed_tpu_torch import ServingEngine
    from deepspeed_tpu_torch.serving.engine import _with_config
    L = ie.module.cfg.num_layers
    n_new = NEOX_N_NEW
    errs = {}
    runs = (("dense", {}), ("paged", dict(paged=True)),
            ("overlap", {}), ("fused", dict(fused_prefill=True,
                                            prefill_chunk=FUSED_C)))
    base_module = ie.module
    for name, extra in runs:
        if name == "overlap":
            ie.module = _with_config(base_module, dataclasses.replace(
                base_module.cfg, tp_overlap=True))
        mk = dict(kw, megakernel=True, tp=NEOX_TP, **extra)
        eng = ServingEngine(engine=ie, **mk)
        if name in ("dense", "paged"):
            bad = _checked_logits(torch, eng.module, dev)
            with kernel_checks(torch, errs, f"phase45 {name}"), \
                    sampling_checks(torch, errs):
                got, seconds, launched = _serve(torch, eng, prompts, n_new)
            eng.module.__dict__.pop("logits", None)
            if bool(bad):
                fail(f"phase45 {name}: non-finite logits")
            if errs.get("sampling"):
                fail(f"phase45 {name}: {errs['sampling']} B4 draws differ "
                     f"from the plain version's")
            out[f"{name}_checked_launches"] = launched
            checked = [r.tokens for r in got]
            del eng
            eng = ServingEngine(engine=ie, **mk)
        if name in ("overlap", "fused"):
            with decode_widths() as widths:
                got, seconds, launched = _serve(
                    torch, eng, prompts[:NEOX_FUSED_REQUESTS], NEOX_FUSED_NEW)
            out[f"{name}_widths"] = {f"{k[0]}@{k[1]}": v
                                     for k, v in widths.items()}
        else:
            with decode_widths() as widths:
                got, seconds, launched = _serve(torch, eng, prompts, n_new)
            out[f"{name}_widths"] = {f"{k[0]}@{k[1]}": v
                                     for k, v in widths.items()}
        m = eng.metrics
        out[name] = {"tokens": [list(map(int, r.tokens)) for r in got],
                     "requests": len(got), "n_new": len(got[0].tokens),
                     "seconds": seconds, "launches": launched,
                     "steps": m.decode_steps * kw["decode_chunk"],
                     "chunk_ms": m.mean_decode_chunk_s * 1e3,
                     "tok_s": sum(len(r.tokens) for r in got) / seconds,
                     "peak": torch.cuda.max_memory_allocated(dev)}
        if name in ("dense", "paged") and out[name]["tokens"] != checked:
            fail(f"phase45: the timed {name} run's tokens differ from the "
                 f"checked run's")
        del eng
        ie.module = base_module
        torch.cuda.empty_cache()
    out["errs"] = errs
    out["L"] = L


def tp_rank_main(args) -> int:
    """One rank of phases 45 and / or 46 (this script with --tp-rank,
    --tp-phase "45", "46" or "45,46"): tp 2 over gloo with both ranks on
    card 0; results as JSON (and tensors as .pt beside it) under
    --dp-out."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{args.dp_port}",
                          rank=args.tp_rank, world_size=NEOX_TP)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"rank": comm.get_rank(),
           "backend": torch.distributed.get_backend()}
    stem = os.path.splitext(args.dp_out)[0]
    phases = {int(p) for p in args.tp_phase.split(",")}
    if 45 in phases:
        _tp_rank_serve(torch, np, dev, args.seed, out, stem)
        gc.collect()
        torch.cuda.empty_cache()
    if 46 in phases:
        out["train"] = {
            "off": _neox_train(torch, np, dev, args.seed, _tp_mesh(torch),
                               False),
            "on": _neox_train(torch, np, dev, args.seed, _tp_mesh(torch),
                              True)}
    with open(args.dp_out, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def _tp_rank_serve(torch, np, dev, seed, out, stem):
    """Phase 45 on one rank: NeoX 20B split at tp 2, its forward, layer 0,
    the served runs, then the cut depth bf16 and int8."""
    import copy
    from deepspeed_tpu_torch import InferenceEngine, ServingEngine
    from deepspeed_tpu_torch.ops import quantizer as qz
    group = _tp_mesh(torch)
    cfg = _neox_cfg(torch, NEOX_LAYERS, decode_impl="auto")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = _neox_model(torch, cfg, group, seed, dev)
    ie = InferenceEngine(model, mp_size=NEOX_TP, dtype=torch.bfloat16,
                         device=dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["weight_bytes"] = qz.weight_bytes(ie.module)
    out["build_peak"] = torch.cuda.max_memory_allocated(dev)
    out["heads"] = ie.module.blocks[0].attn.local_heads
    # the forward through B1 (a launch a layer, each held to its plain
    # version)
    rng = np.random.default_rng(seed + 45)
    ids = rng.integers(1, cfg.vocab_size, NEOX_IDS).astype(np.int64)
    errs = {}
    logits, b1 = _forward_counted(torch, ie, ids, "phase45", cfg.num_layers,
                                  errs)
    out["forward"] = {"b1": b1, "err": errs["flash_fwd"],
                      "loss": _lm_loss(logits, torch.from_numpy(ids).to(dev))}
    del logits
    # layer 0 on a fixed input
    gen = torch.Generator(device=dev).manual_seed(seed + 46)
    x = torch.randn(*NEOX_BLOCK_IN, cfg.d_model, device=dev,
                    generator=gen).bfloat16()
    pos = torch.arange(NEOX_BLOCK_IN[1], device=dev)[None]
    with torch.inference_mode():
        y = ie.module.blocks[0](x, pos)[0]
    torch.save(y.float().cpu(), f"{stem}_block0.pt")
    prompts = _neox_prompts(np, seed, cfg.vocab_size)
    kw = dict(max_batch=8, decode_chunk=8, max_prompt_len=128)
    ServingEngine(engine=ie, megakernel=True, tp=NEOX_TP, **kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)    # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    _tp_serve_runs(torch, np, dev, ie, prompts, kw, out)
    # generate on the first requests: the greedy tokens of one prompt at a
    # time through the same kernels (decode_impl "auto")
    out["generate"] = [
        ie.generate(p[None], max_new_tokens=NEOX_N_NEW, temperature=0.0
                    )[0, len(p):].tolist() for p in prompts[:NEOX_GENERATE]]
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    # where a run parts from the dense one: the top-2 gap there (both
    # ranks hold the same tokens, so both run these forwards together)
    dense = out["dense"]["tokens"]
    out["partings"] = {}
    for name in ("overlap", "fused", "generate"):
        got = out[name] if name == "generate" else out[name]["tokens"]
        rows = []
        for p, a, b in zip(prompts, got, dense):
            t = _first_difference(a, b)
            rows.append(None if t is None else
                        (t,) + _near_tie_gap(torch, ie.module, p, b, t, dev))
        out["partings"][name] = rows
    del ie, model
    gc.collect()
    torch.cuda.empty_cache()
    # the cut depth: bf16 logits (against tp 1 in the main process), then
    # int8 weights quantized whole and split
    cut = _neox_cfg(torch, NEOX_CUT, decode_impl="auto")
    cids = np.random.default_rng(seed + 47).integers(
        1, cut.vocab_size, NEOX_CUT_IDS).astype(np.int64)
    ie = InferenceEngine(_neox_model(torch, cut, group, seed, dev),
                         mp_size=NEOX_TP, dtype=torch.bfloat16, device=dev)
    torch.save(ie.forward(cids)[0, -8:].float().cpu(), f"{stem}_cut.pt")
    del ie
    whole = _neox_model(torch, cut, None, seed, dev)
    ref = qz.quantize_module(copy.deepcopy(whole), dtype=torch.bfloat16,
                             device=dev, scan_layers=True)
    ie = InferenceEngine(whole, mp_size=NEOX_TP, dtype=torch.bfloat16,
                         quantize_bits=8, device=dev)
    from deepspeed_tpu_torch.runtime.sharding import tp_split
    mism = 0
    for name, m in ie.module.named_modules():
        if isinstance(m, qz.Int8Linear):
            r = ref.get_submodule(name)
            for buf in ("q8", "scale"):
                full = getattr(r, buf)
                split = tp_split(f"{name}.{buf}", full.shape, NEOX_TP)
                want = full if split is None else \
                    split.take(full, group.rank)
                mism += int(not torch.equal(getattr(m, buf), want))
    del ref
    out["int8"] = {"shard_mismatches": mism,
                   "weight_bytes": qz.weight_bytes(ie.module)}
    torch.save(ie.forward(cids)[0, -8:].float().cpu(), f"{stem}_int8.pt")
    eng = ServingEngine(engine=ie, megakernel=True, tp=NEOX_TP, **kw)
    got, seconds, launched = _serve(torch, eng, prompts[:8], 8)
    out["int8"].update(tokens=[list(map(int, r.tokens)) for r in got],
                       launches=launched)


def run_tp_ranks(seed, phases="45,46"):
    """This script twice more as the two ranks of phases ``phases`` ("45",
    "46" or both: one start of the ranks; --tp-rank 0 / 1); their JSON
    results and the directory of their tensors (removed by the caller)."""
    d = tempfile.mkdtemp(prefix=f"phase{phases.replace(',', '_')}_")
    first = int(phases.split(",")[0])
    return spawn_ranks(seed, NEOX_TP, ["--tp-rank", "--tp-phase", phases],
                       first, TP_TIMEOUT_S * len(phases.split(",")),
                       d), d


def phase_tp_serving(torch, np, dev, seed, card, spawned=None):
    """Phase 45: GPT-NeoX 20B at full width (NEOX_LAYERS of its 44 layers),
    bf16, split at tp 2
    over two gloo ranks sharing the card (the script re-runs itself with
    the hidden --tp-rank), each rank building only its shards on the card
    from --seed. Gates: each rank's weights at rest within NEOX_HALF_RTOL
    of half the whole model's bytes and its peak below the whole model's;
    the forward on [2, 1024] launching B1 once a layer, each call held to
    its plain version; layer 0's tp-2 output on a fixed input within
    LOGITS_ATOL of the whole layer 0 rebuilt here from the same seed; the
    width cut to NEOX_CUT layers at tp 2 against tp 1 here (logits,
    LOGITS_ATOL); phase 4's requests (NEOX_N_NEW tokens) through
    ServingEngine(tp=2, megakernel=True) dense and paged, one checked run
    each with every B2 / B3 call and B4 draw held to its plain version,
    tokens equal on both ranks bitwise, the dense timed run's tokens the
    checked run's, paged equal to dense, ``generate`` on the first
    request equal or parting at a near-tie; tp_overlap and the fused
    engine (C 16) equal or parting at a near-tie; the cut depth with int8
    weights: each rank's codes and scales bitwise the split of the whole
    model's quantization, logits within LOGITS_ATOL of tp 1 int8 here,
    served tokens equal on both ranks. Prints tokens/s, chunk ms and the
    memory; then B1 at [2, 1024, 32, 96], B2 / B3 at h 32, d 96 (s_q 1
    and 16) and B4 at [8, 50304] against their plain versions, timed (the
    *_neox rows)."""
    import shutil
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.ops import quantizer as qz
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    # ``spawned``: ranks already run (with phase 46's) by run_tp_ranks
    ranks, tmp = spawned or run_tp_ranks(seed, "45")
    try:
        rows = _check_tp_serving(torch, np, dev, seed, card, ranks, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 45)
    B, S = NEOX_IDS
    H, D = 64 // NEOX_TP, 96
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    fo, fl = fa.flash_attention_forward(q, k, v, True, D ** -0.5)
    ro, rl = fa.flash_attention_forward_reference(q, k, v, True, D ** -0.5)
    torch.cuda.synchronize()
    flash_err = max(_close(fo, ro, *FLASH_TOL), _close(fl, rl, LSE_ATOL, 0.0))
    dq, dk, dv = fa.flash_attention_backward(q, k, v, ro, rl, do, True,
                                             D ** -0.5)
    rdq, rdk, rdv = fa.flash_attention_backward_reference(
        q, k, v, ro, rl, do, True, D ** -0.5)
    bwd_err = {"flash_bwd_dq": _close(dq, rdq, *FLASH_TOL),
               "flash_bwd_dkv": max(_close(dk, rdk, *FLASH_TOL),
                                    _close(dv, rdv, *FLASH_TOL))}
    flash_t = _flash_times(torch, fa, q, k, v, do, ro, rl, True)
    print(f"phase45 flash B={B} S={S} H={H} D={D} causal max_abs_err fwd="
          f"{flash_err} bwd={bwd_err} " + " ".join(
              f"{n}:{t}" for n, t in flash_t.items()) + f" card={card}",
          flush=True)
    del q, k, v, do, fo, fl, ro, rl, dq, dk, dv, rdq, rdk, rdv
    case_errs, times = {}, {}
    for tag, case in (("", NEOX_CASE), ("_sq16", NEOX_SQ16_CASE)):
        case_errs[tag] = case_parity(torch, da, qz, dev, gen, **case)[0]
        times[tag] = verify_timing(torch, da, qz, dev, gen, card, **case)
    sp_t, sp_err = _sampling_time(torch, sp, dev, gen, 8, 50304)
    print(f"phase45 sampling b=8 V=50304 greedy rows differing from the "
          f"plain version: {sp_err} " + " ".join(
              f"{key}={val}" for key, val in sp_t.items())
          + f" card={card}", flush=True)
    if sp_err:
        fail(f"phase45: B4 differs from its plain version in {sp_err} rows")
    torch.cuda.empty_cache()
    print(f"phase45 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    errs = rows["errs"]
    return {"flash_t": flash_t, "flash_err": flash_err, "bwd_err": bwd_err,
            "rows": [
                ("flash_fwd_neox", "flash_attention.cu",
                 "flash_attention.py:52", rows["b1"],
                 max(flash_err, errs["flash_fwd"]), flash_t["flash_fwd"]),
                ("decode_attention_neox", "decode_attention.cuh",
                 "decode_attention.py:74", rows["dense"],
                 max(case_errs[""]["decode_attention"],
                     errs["decode_attention"]),
                 times[""]["decode_attention"]),
                ("paged_decode_attention_neox", "decode_attention.cuh",
                 "decode_attention.py:351", rows["paged"],
                 max(case_errs[""]["paged_decode_attention"],
                     errs["paged_decode_attention"]),
                 times[""]["paged_decode_attention"]),
                ("decode_attention_neox_sq16", "decode_attention.cuh",
                 "decode_attention.py:74", rows["fused"],
                 case_errs["_sq16"]["decode_attention"],
                 times["_sq16"]["decode_attention"]),
                ("sampling_neox", "sampling.cu", "sampling.py:132",
                 rows["sampling"], float(sp_err), sp_t)]}


def _tp_err(torch, path, ref, what) -> float:
    """max |got - ref| of the rank's tensor saved at ``path``, failing
    past LOGITS_ATOL + NEOX_TP_RTOL max |ref|."""
    diff = (torch.load(path) - ref).abs()
    if not diff.max().item() <= LOGITS_ATOL + NEOX_TP_RTOL * \
            ref.abs().max().item():
        fail(f"phase45 {what}: tp 2 leaves tp 1 by {diff.max().item()}")
    return diff.max().item()


def _check_tp_serving(torch, np, dev, seed, card, ranks, tmp):
    """Phase 45's gates over the ranks' results, with the tp 1 references
    built here; returns the launches a row carries and the checked
    errors."""
    from deepspeed_tpu_torch import InferenceEngine
    from deepspeed_tpu_torch.ops import quantizer as qz
    half = 2 * NEOX_PARAMS / NEOX_TP
    for r in ranks:
        print(f"phase45 rank {r['rank']} ({r['backend']}) tp={NEOX_TP}: "
              f"{r['heads']} local heads, weights at rest "
              f"{r['weight_bytes']} B (half the whole {2 * NEOX_PARAMS} B: "
              f"{half}), built in {r['build_s']} s, build peak "
              f"{r['build_peak']} B, max_memory_allocated {r['peak']} B "
              f"card={card}", flush=True)
        if abs(r["weight_bytes"] - half) > NEOX_HALF_RTOL * half:
            fail(f"phase45 rank {r['rank']} holds {r['weight_bytes']} B, "
                 f"not half of {2 * NEOX_PARAMS}")
        if not max(r["peak"], r["build_peak"]) < 2 * NEOX_PARAMS:
            fail(f"phase45 rank {r['rank']} peaked at {r['peak']} B, the "
                 f"whole model's size")
        f = r["forward"]
        print(f"phase45 rank {r['rank']} forward {list(NEOX_IDS)}: B1 "
              f"{f['b1']} launches, each within {f['err']} of its plain "
              f"version; loss {f['loss']}", flush=True)
        if not math.isfinite(f["loss"]):
            fail(f"phase45 rank {r['rank']}: non-finite forward loss")
    r0, r1 = ranks
    for key in ("dense", "paged", "overlap", "fused", "generate", "int8"):
        a = r0[key]["tokens"] if key != "generate" else r0[key]
        b = r1[key]["tokens"] if key != "generate" else r1[key]
        if a != b:
            fail(f"phase45 {key}: the two ranks' tokens differ")
    if r0["forward"]["loss"] != r1["forward"]["loss"]:
        fail("phase45: the two ranks' forward losses differ")
    L = r0["L"]
    for name in ("dense", "overlap", "fused", "paged"):
        run = r0[name]
        steps = run["steps"]
        width = FUSED_C if name == "fused" else 1
        kernel = ("paged_decode_attention" if name == "paged"
                  else "decode_attention")
        got = run["launches"]
        print(f"phase45 {name}: launches={got} widths="
              f"{r0.get(name + '_widths')} steps={steps} "
              f"neox_tp2_{name}_tokens_per_s={run['tok_s']} "
              f"mean_chunk_ms={run['chunk_ms']} max_memory_allocated="
              f"{run['peak']} (L={L}, K=8, batch 8, {run['requests']} "
              f"requests x {run['n_new']} tokens, rank 0) card={card}",
              flush=True)
        if got.get(kernel, 0) != L * steps or not got.get("sampling") \
                or set(got) - {kernel, "sampling"}:
            fail(f"phase45 {name}: want {kernel} {L} a step ({steps} "
                 f"steps) and sampling, nothing else: {got}")
        if r0[name + "_widths"] != {f"{kernel}@{width}": L * steps}:
            fail(f"phase45 {name}: decode widths {r0[name + '_widths']}")
    print(f"phase45 every B1 / B2 / B3 call and B4 draw checked on its own "
          f"inputs: {r0['errs']}", flush=True)
    dense = r0["dense"]["tokens"]
    if r0["paged"]["tokens"] != dense:
        fail("phase45: the paged engine's tokens differ from the dense "
             "engine's")
    # the references, whole, here: layer 0, then the cut depth
    cfg = _neox_cfg(torch, 1)
    whole = _neox_model(torch, cfg, None, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 46)
    x = torch.randn(*NEOX_BLOCK_IN, cfg.d_model, device=dev,
                    generator=gen).bfloat16()
    pos = torch.arange(NEOX_BLOCK_IN[1], device=dev)[None]
    with torch.inference_mode():
        want = whole.blocks[0](x, pos)[0].float().cpu()
    del whole
    errs = {r: _tp_err(torch, os.path.join(tmp, f"rank{r}_block0.pt"),
                       want, "layer 0") for r in range(NEOX_TP)}
    print(f"phase45 layer 0 at tp 2 vs whole layer 0 rebuilt here, input "
          f"{list(NEOX_BLOCK_IN)} x {cfg.d_model}: max_abs_err {errs} (tol "
          f"{LOGITS_ATOL} + {NEOX_TP_RTOL} max |ref|, max |ref| "
          f"{want.abs().max().item()})", flush=True)
    cut = _neox_cfg(torch, NEOX_CUT, decode_impl="auto")
    cids = np.random.default_rng(seed + 47).integers(
        1, cut.vocab_size, NEOX_CUT_IDS).astype(np.int64)
    ref = {}
    ie = InferenceEngine(_neox_model(torch, cut, None, seed, dev),
                         dtype=torch.bfloat16, device=dev)
    ref["cut"] = ie.forward(cids)[0, -8:].float().cpu()
    del ie
    ie = InferenceEngine(_neox_model(torch, cut, None, seed, dev),
                         dtype=torch.bfloat16, quantize_bits=8, device=dev)
    ref["int8"] = ie.forward(cids)[0, -8:].float().cpu()
    del ie
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("cut", "int8"):
        e = [_tp_err(torch, os.path.join(tmp, f"rank{r}_{key}.pt"),
                     ref[key], f"{key} logits") for r in range(NEOX_TP)]
        print(f"phase45 {key} ({NEOX_CUT} layers) tp 2 vs tp 1 logits, last "
              f"8 positions of {list(NEOX_CUT_IDS)}: max_abs_err {e} (tol "
              f"{LOGITS_ATOL} + {NEOX_TP_RTOL} max |ref|, max |ref| "
              f"{ref[key].abs().max().item()})", flush=True)
    i8 = r0["int8"]
    print(f"phase45 int8 ({NEOX_CUT} layers) tp 2: shard mismatches "
          f"{[r['int8']['shard_mismatches'] for r in ranks]}, weights at "
          f"rest {i8['weight_bytes']} B a rank, served launches "
          f"{i8['launches']} card={card}", flush=True)
    if any(r["int8"]["shard_mismatches"] for r in ranks):
        fail("phase45: an int8 shard is not the split of the whole "
             "model's quantization")
    if not i8["launches"].get("decode_attention"):
        fail(f"phase45 int8: launches {i8['launches']}")
    for name, rows in r0["partings"].items():
        print(f"phase45 {name} tokens vs the dense engine's: (parting "
              f"position, top-2 gap, tie bound) {rows}", flush=True)
        for row in rows:
            if row is not None and not row[1] <= row[2]:
                fail(f"phase45 {name}: tokens part from the dense engine's "
                     f"at {row[0]} with top-2 gap {row[1]} > {row[2]}")
    return {"errs": dict(r0["errs"], flash_fwd=max(
                r["forward"]["err"] for r in ranks)),
            "b1": r0["forward"]["b1"],
            "dense": r0["dense"]["launches"]["decode_attention"],
            "paged": r0["paged"]["launches"]["paged_decode_attention"],
            "fused": r0["fused"]["launches"]["decode_attention"],
            "sampling": r0["dense"]["launches"]["sampling"]}


def _neox_train(torch, np, dev, seed, group, partition):
    """Phase 46's run: NeoX 20B's width cut to NEOX_CUT layers (f32 masters
    made on the card from --seed, whole, then split by the engine over
    ``group``'s tp when it is given), NEOX_TRAIN_STEPS steps of
    NEOX_TRAIN_CONFIG on seq-1024 batches from the seed; with
    ``partition``, activation_checkpointing.partition_activations, on one
    repeated batch from the seed. Returns
    losses, grad norms, B1 / B1b launches a step, step seconds, peak."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = _neox_cfg(torch, NEOX_CUT, param_dtype=torch.float32)
    config = dict(NEOX_TRAIN_CONFIG)
    if group is not None:
        config["mesh"] = {"tp": NEOX_TP}
    if partition:
        config["activation_checkpointing"] = {"partition_activations": True}
    torch.cuda.reset_peak_memory_stats(dev)
    engine, *_ = dst.initialize(
        model=_neox_model(torch, cfg, None, seed, dev), loss_fn=lm_loss_fn,
        config=config, device=dev)
    # one repeated batch (as phase 43): random tokens teach nothing a
    # fresh batch would show, so a falling loss needs the same one
    ids = np.random.default_rng(seed + 48).integers(
        0, cfg.vocab_size, (NEOX_TRAIN_MICRO, cfg.max_seq_len))
    losses, norms, step_s = [], [], []
    launches = []
    for step in range(NEOX_TRAIN_STEPS):
        batch = [{"input_ids": ids}] * NEOX_TRAIN_GAS
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batch))))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches.append({name: _build.LAUNCHES[name] for name in FLASH})
        norms.append(float(engine.get_global_grad_norm()))
    out = {"losses": losses, "norms": norms, "step_s": step_s,
           "launches": launches, "tp": engine.mp_world_size,
           "peak": torch.cuda.max_memory_allocated(dev)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp_training(torch, np, dev, seed, card, ranks=None):
    """Phase 46: NeoX 20B's width cut to NEOX_CUT layers, trained (seq
    1024, micro 2 x gas 2, bf16 over fp32 masters, AdamW, ZeRO-1, remat)
    at tp 1 here, then at mesh {"tp": 2} on two gloo ranks sharing the card
    (the script re-runs itself with --tp-rank), without and with
    partition_activations. Gates: every step's B1 / B1b launches (2 x
    layers x gas forwards, the remat recompute included, and layers x gas
    of each backward), the tp 2 losses equal on both ranks and within
    LOSS_ATOL of tp 1's, partition_activations' within LOSS_ATOL of off,
    and falling. Returns rank 0's launches a step."""
    import shutil
    t_phase = time.perf_counter()
    ref = _neox_train(torch, np, dev, seed, None, False)
    if ranks is None:          # else phase 45's rank processes ran them
        ranks, tmp = run_tp_ranks(seed, "46")
        shutil.rmtree(tmp, ignore_errors=True)
    want = {"flash_fwd": 2 * NEOX_CUT * NEOX_TRAIN_GAS,
            "flash_bwd_dq": NEOX_CUT * NEOX_TRAIN_GAS,
            "flash_bwd_dkv": NEOX_CUT * NEOX_TRAIN_GAS}
    runs = [("tp1", ref)] + [
        (f"tp2 rank {r['rank']} partition_activations={key}", r["train"][key])
        for r in ranks for key in ("off", "on")]
    for name, run in runs:
        print(f"phase46 neox width x {NEOX_CUT} layers {name}: losses="
              f"{run['losses']} grad_norms={run['norms']} step_s="
              f"{run['step_s']} launches={run['launches'][-1]} "
              f"max_memory_allocated={run['peak']} card={card}", flush=True)
        if any(step != want for step in run["launches"]):
            fail(f"phase46 {name}: launches {run['launches']}, want {want} "
                 f"a step")
        if not all(math.isfinite(x) for x in run["losses"]) or \
                not run["losses"][-1] < run["losses"][0]:
            fail(f"phase46 {name}: losses {run['losses']} not falling")
        if not np.allclose(run["losses"], ref["losses"], rtol=0,
                           atol=LOSS_ATOL):
            fail(f"phase46 {name}: losses leave tp 1's by more than "
                 f"{LOSS_ATOL}")
    for key in ("off", "on"):
        if ranks[0]["train"][key]["losses"] != \
                ranks[1]["train"][key]["losses"]:
            fail(f"phase46: the two tp ranks' losses differ ({key})")
    print(f"phase46 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return ranks[0]["train"]["off"]["launches"][-1]


# --------------------------------------------------------------------------
# Phases 47-49: sequence parallelism at bench.py's long_context
# --------------------------------------------------------------------------

# bench.py's long_context (bench.py:332-341): gpt2_125m at max_seq_len 16384,
# micro 1 x gas 2, bf16 over fp32 masters, remat, AdamW 1e-4, ZeRO-1, dense
# flash attention; trained CTX_STEPS steps on one repeated batch from --seed
# at sp 1 (phase 47) and at mesh {"sp": SP} over two gloo ranks sharing the
# card, each rank 8192 of the 16384 positions (phase 48)
CTX_SEQ, CTX_GAS, CTX_STEPS, SP = 16384, 2, 2, 2   # 3 steps cut to fit
CTX_CONFIG = {"train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": CTX_GAS,
              "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
              "steps_per_print": 100_000}
CTX_LAYERS = 12
SP_TIMEOUT_S = 600
# B1 / B1b at the shapes phases 47-48 give them: (row tag, B, S, H, D,
# causal): the whole sequence, a Ulysses rank's 6 heads over it, a ring
# rank's diagonal and full 8192-row blocks
SP_FLASH = (("ctx16k", 1, CTX_SEQ, 12, 64, True),
            ("ulysses_sp2", 1, CTX_SEQ, 12 // SP, 64, True),
            ("ring_diag_sp2", 1, CTX_SEQ // SP, 12, 64, True),
            ("ring_full_sp2", 1, CTX_SEQ // SP, 12, 64, False))
# the plain versions' f32 scores of the whole sequence take 12.9e9 B (and
# their backward four such tensors): they run over slices of this many heads
SP_PLAIN_HEADS = 3
# phase 48's ring check: the ring's merged output and grads against the
# plain ring (ring_attention_reference, f32) at this many heads of the
# training sequence
SP_RING_CHECK_HEADS = 2
# the exchanges a layer makes a micro-step on a rank of phase 48: Ulysses
# two all-to-alls (q/k/v stacked, the output) in each of the forward, its
# remat recompute and the backward; ring one K/V hop in the forward and the
# recompute, and one hop of the dk/dv accumulators in the backward
SP_EXCHANGES = {"ulysses": ("all_to_all", 6), "ring": ("ring_hops", 3)}
# phase 49: phase 4's prompts (16-128 tokens) this long or longer take the
# sp prefill leg
SP_ROUTE_THRESHOLD = 64


def _ctx_want(cp_impl, rank):
    """B1 / B1b launches a step on ``rank``: a forward and its remat
    recompute and a backward a layer a micro-step, once a block; a causal
    ring rank r runs r + 1 blocks."""
    blocks = rank + 1 if cp_impl == "ring" else 1
    per = CTX_LAYERS * CTX_GAS * blocks
    return {"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per}


def ctx_train(torch, np, dev, seed, cp_impl=None):
    """bench.py's long_context trained CTX_STEPS steps on one batch from
    --seed: at sp 1, or under ``cp_impl`` at mesh {"sp": SP} (a rank of
    phase 48), the weights drawn alike. The counts are reset just before
    each step and read just after. Returns (results, engine, ids)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m, lm_loss_fn
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.ring_attention import SP_TRAFFIC
    kw = {} if cp_impl is None else dict(sequence_parallel=True,
                                         cp_impl=cp_impl)
    cfg = gpt2_125m(max_seq_len=CTX_SEQ, dtype=torch.bfloat16, **kw)
    config = dict(CTX_CONFIG)
    if cp_impl is not None:
        config["mesh"] = {"sp": SP}
    torch.cuda.reset_peak_memory_stats(dev)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=config, device=dev)
    ids = np.random.default_rng(seed + 47).integers(
        0, cfg.vocab_size, (1, CTX_SEQ)).astype(np.int32)
    out = {k: [] for k in ("losses", "norms", "step_s", "launches",
                           "traffic")}
    reduced = engine.comm_bytes["all_reduce"]
    for _ in range(CTX_STEPS):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        SP_TRAFFIC.clear()
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": ids}] * CTX_GAS))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({n: _build.LAUNCHES[n] for n in FLASH})
        out["traffic"].append(dict(SP_TRAFFIC))
        out["losses"].append(float(loss))
        out["norms"].append(float(engine.get_global_grad_norm()))
    out["grad_all_reduce_bytes_per_step"] = (
        engine.comm_bytes["all_reduce"] - reduced) / CTX_STEPS
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["sp"] = engine.sp_world_size
    return out, engine, ids


def _check_ctx_run(run, cp_impl, rank, what):
    want = _ctx_want(cp_impl, rank)
    if any(step != want for step in run["launches"]):
        fail(f"{what}: launches {run['launches']}, want {want} a step")
    if not all(math.isfinite(x) for x in run["losses"] + run["norms"]) or \
            not run["losses"][-1] < run["losses"][0]:
        fail(f"{what}: losses {run['losses']} not finite and falling")


def sp_flash_checks(torch, fa, dev, gen, card):
    """B1 / B1b at SP_FLASH's shapes against their plain versions (over
    head slices; ``_close_rows``) and timed beside
    scaled_dot_product_attention and their bounds. Returns ({tag: max abs errs}, {tag: times})."""
    errs, times = {}, {}
    for tag, B, S, H, D, causal in SP_FLASH:
        q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
        e, (ro, rl) = _flash_pair(torch, fa, q, k, v, do, causal,
                                  plain_heads=SP_PLAIN_HEADS, rows=True)
        errs[tag] = e
        print(f"phase47 flash {tag} B={B} S={S} H={H} D={D} causal={causal} "
              f"bf16 max_abs_err out={e['flash_fwd']} lse={e['lse']} "
              f"dq={e['flash_bwd_dq']} dk_dv={e['flash_bwd_dkv']}; max err "
              f"over its bound {e['row']} (tol: 1 of the bound, "
              f"{SP_ROW_RTOL} of the row's largest |plain| + {SP_HEAD_ATOL} "
              f"of the head's rms; lse atol {LSE_ATOL})", flush=True)
        del ro, rl
        out, lse = fa.flash_attention_forward(q, k, v, causal, D ** -0.5)
        times[tag] = _flash_times(torch, fa, q, k, v, do, out, lse, causal,
                                  plain_heads=SP_PLAIN_HEADS)
        for name, vals in times[tag].items():
            print(f"phase47 {tag} B={B} S={S} H={H} D={D} causal={causal} "
                  f"{name} " + " ".join(f"{key}={val}" for key, val in
                                         vals.items()) + f" card={card}",
                  flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return errs, times


def phase_long_context(torch, np, fa, dev, gen, seed, card):
    """Phase 47: bench.py's long_context at sp 1 (gates: B1 / B1b 48 / 24 /
    24 a step, losses finite and falling), a profiled micro-step's idle
    share, then B1 / B1b at SP_FLASH's shapes (``sp_flash_checks``).
    Returns (the run, errs, times)."""
    from deepspeed_tpu_torch.models.gpt import gpt_flops_per_token
    from deepspeed_tpu_torch.telemetry.mfu import (mfu_report,
                                                   peak_flops_per_device)
    t_phase = time.perf_counter()
    run, engine, ids = ctx_train(torch, np, dev, seed)
    print(f"phase47 long_context gpt2_125m seq={CTX_SEQ} micro 1 x gas "
          f"{CTX_GAS} sp 1: losses={run['losses']} grad_norms="
          f"{run['norms']} step_s={run['step_s']} launches_per_step="
          f"{run['launches'][-1]} max_memory_allocated={run['peak']} "
          f"card={card}", flush=True)
    _check_ctx_run(run, None, 0, "phase47")
    wall_ms, busy_ms = phase_train_profile(
        torch, engine, torch.from_numpy(ids).long().to(dev), card,
        tag="phase47")
    step_s = sum(run["step_s"][1:]) / (CTX_STEPS - 1)
    tokens = CTX_SEQ * CTX_GAS
    report = mfu_report(
        flops_per_call=gpt_flops_per_token(engine.module.cfg, CTX_SEQ)
        * tokens, calls=CTX_STEPS - 1, wall_s=sum(run["step_s"][1:]),
        peak_flops=peak_flops_per_device(dev), label="long_context sp 1")
    print(f"long_context_step_s={step_s} long_context_tokens_per_s="
          f"{tokens / step_s} long_context_mfu={report['mfu']} "
          f"long_context_peak_bytes={run['peak']} "
          f"long_context_micro_step_idle_share={1 - busy_ms / wall_ms} "
          f"card={card}", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    errs, times = sp_flash_checks(torch, fa, dev, gen, card)
    print(f"phase47 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return run, errs, times


def _sp_a2a_check(torch, comm, group, dev) -> None:
    """all_to_all_single of a CUDA tensor over the gloo sp group: row j of
    the result is rank j's row for this rank, on the card."""
    n, r = group.size, group.rank
    x = torch.arange(4.0 * n, device=dev).view(n, 4) + 100 * r
    got = comm.all_to_all_single(x, group)
    want = torch.stack([torch.arange(4.0 * r, 4.0 * r + 4, device=dev)
                        + 100 * j for j in range(n)])
    if got.device != x.device or not torch.equal(got, want):
        fail(f"all_to_all_single of a CUDA tensor over gloo gave {got}")


def _sp_ring_results(torch, group, dev, seed):
    """The ring over ``group`` at SP_RING_CHECK_HEADS heads of the training
    sequence (bf16, the kernels) and the plain ring in f32: (name, this
    rank's rows of the ring's result, the plain result's) for the output
    and the q / k / v grads."""
    from deepspeed_tpu_torch.ops.ring_attention import (
        ring_attention, ring_attention_reference)
    g = torch.Generator(device=dev).manual_seed(seed + 48)
    q, k, v, do = (torch.randn(1, CTX_SEQ, SP_RING_CHECK_HEADS, 64,
                               device=dev, generator=g).bfloat16()
                   for _ in range(4))
    s = CTX_SEQ // group.size
    rows = slice(group.rank * s, (group.rank + 1) * s)
    mine = [t[:, rows].clone().requires_grad_() for t in (q, k, v)]
    out = ring_attention(*mine, group)
    out.backward(do[:, rows])
    full = [t.float().requires_grad_() for t in (q, k, v)]
    ref = ring_attention_reference(*full, group.size)
    ref.backward(do.float())
    return [("out", out.detach(), ref[:, rows].detach())] + [
        (name, a.grad, b.grad[:, rows])
        for name, a, b in zip(("dq", "dk", "dv"), mine, full)]


def _sp_ring_check(torch, group, dev, seed):
    """``_sp_ring_results`` within ``_close_rows``'s bound. Returns the
    max abs errs and (``row``) each ``_row_share``."""
    errs, row = {}, {}
    for name, got, ref in _sp_ring_results(torch, group, dev, seed):
        errs[name] = _close_rows(got, ref)
        row[name] = _row_share(got, ref)
    errs["row"] = row
    return errs


def sp_rank_main(args) -> int:
    """One rank of phase 48 (this script with --sp-rank): mesh {"sp": SP}
    over gloo with both ranks on card 0; results as JSON under --dp-out."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{args.dp_port}",
                          rank=args.sp_rank, world_size=SP)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh_lib.ensure_global_mesh(mesh_lib.MeshShape.infer(SP, sp=SP))
    group = comm.new_group("sp")
    _sp_a2a_check(torch, comm, group, dev)
    out = {"rank": comm.get_rank(),
           "backend": torch.distributed.get_backend(),
           "ring_check": _sp_ring_check(torch, group, dev, args.seed)}
    torch.cuda.empty_cache()
    for cp_impl in ("ulysses", "ring"):
        out[cp_impl], engine, _ = ctx_train(torch, np, dev, args.seed,
                                            cp_impl)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if args.then_pipe:     # phases 50-51's ranks: the same two processes
        out["pipe"] = pipe_rank_work(args, args.sp_rank)
    with open(args.dp_out, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def phase_sp(seed, card, ctx, then_pipe=False):
    """Phase 48: bench.py's long_context at mesh {"sp": SP} over two gloo
    ranks sharing the card (this script re-run with --sp-rank), cp_impl
    "ulysses" then "ring" (``sp_rank_main``); with ``then_pipe`` the same
    rank processes then run phases 50-51's engines (their results under
    "pipe", by rank). Gates: all_to_all_single of a
    CUDA tensor over gloo, the ring's merged output and grads against the
    plain ring (``_close_rows``), every step's B1 / B1b launches
    (``_ctx_want``),
    the exchanges a step (SP_EXCHANGES), losses equal on both ranks, finite,
    falling and within LOSS_ATOL of phase 47's (``ctx``). Returns each
    cp_impl's runs by rank."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(
            seed, SP, ["--sp-rank"] + (["--then-pipe"] if then_pipe else []),
            48, SP_TIMEOUT_S + (PIPE_TIMEOUT_S if then_pipe else 0), d)
    for r in ranks:
        print(f"phase48 rank {r['rank']} ({r['backend']}): all_to_all_single "
              f"of a CUDA tensor checked; ring at {SP_RING_CHECK_HEADS} heads "
              f"vs the plain ring (f32) max_abs_err {r['ring_check']} (row: "
              f"max err over its bound, {SP_ROW_RTOL} of the row's largest "
              f"|plain| + {SP_HEAD_ATOL} of the head's rms)", flush=True)
    runs = {}
    for cp_impl in ("ulysses", "ring"):
        kind, per_layer = SP_EXCHANGES[cp_impl]
        calls = per_layer * CTX_LAYERS * CTX_GAS
        runs[cp_impl] = [r[cp_impl] for r in ranks]
        for rank, run in enumerate(runs[cp_impl]):
            what = f"phase48 {cp_impl} rank {rank}"
            traffic = run["traffic"][-1]
            print(f"{what}: losses={run['losses']} grad_norms={run['norms']} "
                  f"step_s={run['step_s']} launches_per_step="
                  f"{run['launches'][-1]} exchanges_per_step={traffic} "
                  f"grad_all_reduce_bytes_per_step="
                  f"{run['grad_all_reduce_bytes_per_step']} "
                  f"max_memory_allocated={run['peak']} (sp 1: losses "
                  f"{ctx['losses']} step_s {ctx['step_s']}) card={card}",
                  flush=True)
            _check_ctx_run(run, cp_impl, rank, what)
            if run["sp"] != SP or any(t.get(kind) != calls
                                      for t in run["traffic"]):
                fail(f"{what}: sp {run['sp']}, {kind} a step "
                     f"{[t.get(kind) for t in run['traffic']]}, want {calls}")
            if max(abs(a - b) for a, b in zip(run["losses"],
                                              ctx["losses"])) > LOSS_ATOL:
                fail(f"{what}: losses leave sp 1's by more than {LOSS_ATOL}")
        if runs[cp_impl][0]["losses"] != runs[cp_impl][1]["losses"]:
            fail(f"phase48 {cp_impl}: the two sp ranks' losses differ")
        step_s = sum(runs[cp_impl][0]["step_s"][1:]) / (CTX_STEPS - 1)
        print(f"long_context_sp{SP}_{cp_impl}_step_s={step_s} "
              f"long_context_sp{SP}_{cp_impl}_tokens_per_s="
              f"{CTX_SEQ * CTX_GAS / step_s} card={card}", flush=True)
    print(f"phase48 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    if then_pipe:
        runs["pipe"] = [r["pipe"] for r in ranks]
    return runs


def sp_launches(ctx, sp_runs, tag, name) -> int:
    """A SP_FLASH shape's launches of kernel ``name`` on phases 47-48's main
    paths: phase 47's steps, or phase 48's over both ranks (ring rank 1
    runs as many diagonal blocks as rank 0, and the rest full)."""
    def total(run):
        return sum(step[name] for step in run["launches"])
    if tag == "ctx16k":
        return total(ctx)
    if tag == "ulysses_sp2":
        return sum(total(r) for r in sp_runs["ulysses"])
    r0, r1 = (total(r) for r in sp_runs["ring"])
    return 2 * r0 if tag == "ring_diag_sp2" else r1 - r0


# --------------------------------------------------------------------------
# Phases 50-51: the pipeline at GPT-2 1.3B over two ranks (pp 2)
# --------------------------------------------------------------------------

# bench.py's ladder_zero1 (bench.py:231-238): GPT-2 1.3B at full width and
# depth (24 x 2048, 32 heads of 64, vocab 50304, seq 1024, tied head), bf16
# over fp32 masters, AdamW 1e-4, micro 4 x gas (M) 4, ZeRO-1; every engine
# from one state dict drawn from --seed, PIPE_STEPS steps on the same M
# micro-batches
PIPE_MICRO, PIPE_M, PIPE_SEQ, PIPE_STEPS, PIPE_S = 4, 4, 1024, 3, 2
PIPE_CONFIG = {"train_micro_batch_size_per_gpu": PIPE_MICRO,
               "gradient_accumulation_steps": PIPE_M,
               "bf16": {"enabled": True},
               "zero_optimization": {"stage": 1},
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
               "steps_per_print": 100_000}
PIPE_TIMEOUT_S = 900
# phases 50-51 against the dense engine on the same weights and batches:
# each step's loss within PIPE_LOSS_ATOL, the first step's global grad norm
# within PIPE_NORM_RTOL of it (AdamW divides each grad by its own size, so
# a fault that scales one group of grads, such as tied grads summed twice,
# barely moves the losses; the norm sees it). Measured clean on the card:
# losses 1.21e-4 (1F1B) and 1.43e-4 (GPipe) apart, norms 5.5e-7 and 1.8e-6
# of it; the planted faults of tools/check_pipe_gates.py move the losses by
# 0.054-0.080 or the norm by 0.044-0.24 of it (PERF.md)
PIPE_LOSS_ATOL = 1e-3
PIPE_NORM_RTOL = 1e-4
# B1 / B1b at the stage shape (rows flash_*_pipe)
PIPE_FLASH = (PIPE_MICRO, PIPE_SEQ, 32, 64)


def pipe_gpt(torch, dev, seed):
    """GPT-2 1.3B (PIPE_* config) on the card in f32, weights from
    ``seed``: (cfg, model)."""
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_1_3b
    cfg = gpt2_1_3b(max_seq_len=PIPE_SEQ, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return cfg, model


def pipe_micros(np, seed, vocab, m=PIPE_M):
    rng = np.random.default_rng(seed + 50)
    return [rng.integers(0, vocab, (PIPE_MICRO, PIPE_SEQ)).astype(np.int32)
            for _ in range(m)]


def pipe_want(engine_kind, stage, m, cfg=None):
    """B1 / B1b launches a step on ``stage``'s rank at pp PIPE_S with ``m``
    micro-batches: 1F1B runs each micro's stage forward, then replays it in
    the backward (the last stage only replays); GPipe runs its blocks at
    every one of the m + S - 1 ticks, forward, remat recompute and
    backward."""
    layers = (cfg.num_layers if cfg is not None else 24) // PIPE_S
    if engine_kind == "1f1b":
        per = layers * m
        fwd = per if stage == PIPE_S - 1 else 2 * per
        return {"flash_fwd": fwd, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    per = layers * (m + PIPE_S - 1)
    return {"flash_fwd": 2 * per, "flash_bwd_dq": per, "flash_bwd_dkv": per}


def _pipe_steps(torch, dev, engine, batches, steps=PIPE_STEPS):
    """``steps`` steps, counts reset just before and read just after each;
    then one more under torch.profiler for the device busy ms (None when
    the profiler records no device time). Returns the run's record."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.ops.cuda import _build
    out = {k: [] for k in ("losses", "norms", "step_s", "launches")}
    torch.cuda.reset_peak_memory_stats(dev)
    sent = dict(engine.comm_bytes)
    for _ in range(steps):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        loss = engine.train_batch(batches())
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({n: _build.LAUNCHES[n] for n in FLASH})
        out["losses"].append(float(loss))
        out["norms"].append(engine.get_global_grad_norm())
    out["comm_bytes_per_step"] = {k: (v - sent.get(k, 0)) / steps
                                  for k, v in engine.comm_bytes.items()}
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batches())
        torch.cuda.synchronize()
    out["profiled_step_s"] = time.perf_counter() - t0
    busy = sum(_device_us(e) for e in prof.key_averages()) / 1e6
    out["busy_s"] = busy if busy > 0 else None
    return out


def pipe_rank_main(args) -> int:
    """One rank of phases 50-51 alone (this script with --pipe-rank;
    ``pipe_rank_work``); results as JSON under --dp-out."""
    import torch
    out = pipe_rank_work(args, args.pipe_rank)
    with open(args.dp_out, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def pipe_rank_work(args, rank):
    """One rank of phases 50-51: mesh {"pp": PIPE_S} over gloo with both
    ranks on card 0; the 1F1B engine (phase 50) then GPipeSpmdEngine
    (phase 51) from the one GPT-2 1.3B state dict, with --pipe-m
    micro-batches. Returns the rank's results."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt_pipe import (gpt_pipe_module,
                                                     gpt_pipe_state_dict)
    from deepspeed_tpu_torch.runtime.pipe import (GPipeSpmdEngine,
                                                  gpt_pipe_spec)
    comm.init_distributed(dist_backend="gloo",
                          init_method=f"tcp://localhost:{args.dp_port}",
                          rank=rank, world_size=PIPE_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    m = args.pipe_m
    cfg, model = pipe_gpt(torch, dev, args.seed)
    micros = pipe_micros(np, args.seed, cfg.vocab_size, m)
    phases = {int(p) for p in args.pipe_phases.split(",")}
    out = {"rank": comm.get_rank(), "m": m,
           "backend": torch.distributed.get_backend()}
    if 50 in phases:
        t0 = time.perf_counter()
        engine, *_ = dst.initialize(
            model=gpt_pipe_module(cfg, PIPE_S),
            config=dict(PIPE_CONFIG, gradient_accumulation_steps=m,
                        mesh={"pp": PIPE_S}),
            model_parameters=gpt_pipe_state_dict(model.state_dict(), cfg),
            device=dev)
        build_s = time.perf_counter() - t0
        run = _pipe_steps(torch, dev, engine,
                          lambda: iter([(x, x) for x in micros]))
        run.update(stage=engine.stage_id, parts=engine.module.parts,
                   build_s=build_s, blocks=sum(
                       type(layer).__name__ == "PipeGPTBlock"
                       for layer in engine.stage_layers[engine.stage_id]))
        out["1f1b"] = run
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if 51 in phases:
        t0 = time.perf_counter()
        engine = GPipeSpmdEngine(
            gpt_pipe_spec(model), model.state_dict(), num_stages=PIPE_S,
            micro_batches=m, dp=1, lr=1e-4, remat=True, device=dev)
        model.to(device="meta")       # the engine holds its own masters
        torch.cuda.empty_cache()
        build_s = time.perf_counter() - t0
        run = _pipe_steps(torch, dev, engine, lambda: iter(
            [{"input_ids": x} for x in micros]))
        run.update(stage=engine.stage, build_s=build_s,
                   blocks=len(engine.blocks))
        out["gpipe"] = run
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_pipe_ranks(seed, phases="50,51", m=PIPE_M):
    """This script twice more as the two ranks of phases 50-51."""
    with tempfile.TemporaryDirectory() as d:
        return spawn_ranks(seed, PIPE_S, ["--pipe-rank", "--pipe-phases",
                                          phases, "--pipe-m", str(m)],
                           50, PIPE_TIMEOUT_S, d)


def pipe_dense(torch, np, dev, seed, card):
    """The dense engine (initialize + DeepSpeedEngine) on the phases'
    weights and batches: its losses, first-step grad norm, step s and peak
    memory."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import lm_loss_fn
    cfg, model = pipe_gpt(torch, dev, seed)
    micros = pipe_micros(np, seed, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(dev)
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=PIPE_CONFIG, device=dev)
    out = {"losses": [], "norms": [], "step_s": []}
    for _ in range(PIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([{"input_ids": x} for x in micros]))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss))
        out["norms"].append(float(engine.get_global_grad_norm()))
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    print(f"phase50 dense reference gpt2_1.3b micro {PIPE_MICRO} x gas "
          f"{PIPE_M} bf16 ZeRO-1: losses={out['losses']} grad_norms="
          f"{out['norms']} step_s={out['step_s']} max_memory_allocated="
          f"{out['peak']} card={card}", flush=True)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_pipe_run(run, dense, kind, rank, what, m=PIPE_M):
    """Gates of one rank's run: launches a step, losses within
    PIPE_LOSS_ATOL of the dense engine's, the first grad norm within
    PIPE_NORM_RTOL. Returns (loss gap, norm gap) for the record."""
    want = pipe_want(kind, run["stage"], m)
    if any(step != want for step in run["launches"]):
        fail(f"{what}: launches {run['launches']}, want {want} a step")
    if not all(math.isfinite(x) for x in run["losses"] + run["norms"]):
        fail(f"{what}: losses {run['losses']} or norms not finite")
    gap = max(abs(a - b) for a, b in zip(run["losses"], dense["losses"]))
    norm_gap = abs(run["norms"][0] - dense["norms"][0]) / dense["norms"][0]
    print(f"{what}: max |loss - dense| {gap} (gate {PIPE_LOSS_ATOL}); "
          f"first grad norm {run['norms'][0]} vs dense {dense['norms'][0]}: "
          f"rel gap {norm_gap} (gate {PIPE_NORM_RTOL})", flush=True)
    if gap > PIPE_LOSS_ATOL:
        fail(f"{what}: losses {run['losses']} leave the dense engine's "
             f"{dense['losses']} by {gap} > {PIPE_LOSS_ATOL}")
    if norm_gap > PIPE_NORM_RTOL:
        fail(f"{what}: the first grad norm {run['norms'][0]} leaves the "
             f"dense engine's {dense['norms'][0]} by {norm_gap} of it > "
             f"{PIPE_NORM_RTOL}")
    return gap, norm_gap


def print_pipe_run(run, kind, rank, m, card, dense=None):
    """One rank's record of phase 50 (``kind`` "1f1b") or 51 ("gpipe")."""
    steady = run["step_s"][1:] or run["step_s"]
    step_s = sum(steady) / len(steady)
    busy = run["busy_s"]
    share = None if busy is None else busy / run["profiled_step_s"]
    bubble = (PIPE_S - 1) / (m + PIPE_S - 1)
    tokens = PIPE_MICRO * m * PIPE_SEQ
    print(f"phase{50 if kind == '1f1b' else 51} {kind} pp {PIPE_S} rank "
          f"{rank} (stage {run['stage']}, {run['blocks']} blocks) M={m}: "
          f"losses={run['losses']} grad_norms={run['norms']} step_s="
          f"{run['step_s']} mean_step_s={step_s} tokens_per_s="
          f"{tokens / step_s} launches_per_step={run['launches'][-1]} "
          f"comm_bytes_per_step={run['comm_bytes_per_step']} "
          f"max_memory_allocated={run['peak']} build_s={run['build_s']} "
          f"profiled_step_s={run['profiled_step_s']} device_busy_s={busy} "
          f"device_busy_share={share} (both ranks share the card: the idle "
          f"share mixes the schedule's bubble {bubble} with the other rank's "
          f"time slices) card={card}", flush=True)
    return {"step_s": step_s, "busy_share": share, "bubble": bubble}


def phase_pipe(torch, np, fa, dev, gen, seed, card, ranks=None):
    """Phases 50-51: the dense reference here, then both pipeline engines
    over two gloo ranks sharing the card (``pipe_rank_main``); gates:
    losses equal on both ranks, each within PIPE_LOSS_ATOL of the dense
    engine's and the first grad norm within PIPE_NORM_RTOL, B1 / B1b
    launches a step (``pipe_want``). Then B1 / B1b at the stage shape
    against their plain versions, timed. ``ranks``: the ranks' results
    when phase 48's rank processes ran them. Returns (launches by engine
    and rank over the steps, errs, times)."""
    t_phase = time.perf_counter()
    dense = pipe_dense(torch, np, dev, seed, card)
    ranks = ranks or run_pipe_ranks(seed)
    launches = {}
    for kind in ("1f1b", "gpipe"):
        runs = [r[kind] for r in ranks]
        for rank, run in enumerate(runs):
            what = f"phase{50 if kind == '1f1b' else 51} {kind} rank {rank}"
            print_pipe_run(run, kind, rank, PIPE_M, card)
            check_pipe_run(run, dense, kind, rank, what)
        if runs[0]["losses"] != runs[1]["losses"]:
            fail(f"{kind}: the two ranks' losses differ: "
                 f"{[r['losses'] for r in runs]}")
        launches[kind] = [{n: sum(step[n] for step in r["launches"])
                           for n in FLASH} for r in runs]
    if ranks[0]["1f1b"]["parts"] != [0, 13, 27]:
        fail(f"phase50: parts {ranks[0]['1f1b']['parts']}, want "
             f"[0, 13, 27]")
    B, S, H, D = PIPE_FLASH
    q, k, v, do = _qkv(torch, dev, gen, B, S, H, D)
    errs, _ = _flash_pair(torch, fa, q, k, v, do, True)
    print(f"phase50 flash B={B} S={S} H={H} D={D} causal bf16 max_abs_err "
          f"{errs} (tol {FLASH_TOL})", flush=True)
    out, lse = fa.flash_attention_forward(q, k, v, True, D ** -0.5)
    times = _flash_times(torch, fa, q, k, v, do, out, lse, True)
    for name, vals in times.items():
        print(f"phase50 pipe stage shape {name} " + " ".join(
            f"{key}={val}" for key, val in vals.items()) + f" card={card}",
            flush=True)
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    print(f"phase50-51 seconds={time.perf_counter() - t_phase} card={card}",
          flush=True)
    return launches, errs, times


def phase_sp_route(torch, dev, ie, prompts, kw, card):
    """Phase 49: phase 38's dense fused engine (megakernel, prefill_chunk
    16) with sp_prefill_threshold=SP_ROUTE_THRESHOLD beside the same engine
    without it, on phase 4's requests. Gates: every request done, the long
    prompts' tokens through the sp leg and the short ones inline, every
    decode step after the route through B2 at the fused width (12 a step)
    and B4, greedy tokens equal or parting first at a near-tie of the twin
    run. Returns the route's launches."""
    from deepspeed_tpu_torch import ServingEngine
    n_new, K = 64, kw["decode_chunk"]
    L = ie.module.cfg.num_layers
    base_kw = dict(kw, megakernel=True, fused_prefill=True,
                   prefill_chunk=FUSED_C)
    route_kw = dict(base_kw, sp_prefill_threshold=SP_ROUTE_THRESHOLD)
    ServingEngine(engine=ie, **route_kw).run(
        [p.copy() for p in prompts[:2]], max_new_tokens=4)    # warm-up
    base = ServingEngine(engine=ie, **base_kw)
    eng = ServingEngine(engine=ie, **route_kw)
    base_out, base_s, _ = _serve(torch, base, prompts, n_new)
    with decode_widths() as widths:
        out, seconds, launched = _serve(torch, eng, prompts, n_new)
    long = sum(len(p) for p in prompts if len(p) >= SP_ROUTE_THRESHOLD)
    short = sum(len(p) for p in prompts) - long
    steps = eng.metrics.decode_steps * K
    print(f"phase49 sp route threshold={SP_ROUTE_THRESHOLD} launches="
          f"{launched} widths={dict(widths)} sp_prefill_tokens="
          f"{eng.sp_prefill_tokens} inline_prefill_tokens="
          f"{eng.inline_prefill_tokens} steps={steps}", flush=True)
    if not long or not short:
        fail(f"phase49: the threshold splits no prompts ({long} tokens at "
             f"or above it, {short} below)")
    if (eng.sp_prefill_tokens, eng.inline_prefill_tokens) != (long, short):
        fail(f"phase49: {eng.sp_prefill_tokens} tokens through the sp leg "
             f"and {eng.inline_prefill_tokens} inline, want {long} and "
             f"{short}")
    if (launched.get("decode_attention") != L * steps
            or not launched.get("sampling")
            or dict(widths) != {("decode_attention", FUSED_C): L * steps}):
        fail(f"phase49: launches {launched}, widths {dict(widths)} for "
             f"{steps} steps")
    parted = _parting(torch, dev, base.module, prompts, out, base_out,
                      "phase49 sp route")
    n_tokens = sum(len(r.tokens) for r in out)
    print(f"phase49 sp route: greedy tokens equal the engine's without it "
          f"in {len(out) - len(parted)}/{len(out)} requests; "
          f"{_parting_stats(parted, len(out), n_new)}; parting (request, "
          f"position, top-2 gap, bound): {parted}", flush=True)
    print(f"sp_route_serving_tokens_per_s={n_tokens / seconds} "
          f"{_ttft(eng.metrics)} without_route_tokens_per_s="
          f"{n_tokens / base_s} {_ttft(base.metrics, 'without_route_')} "
          f"(K={K}, batch 8) card={card}", flush=True)
    return launched


ROWWISE = ("layer_norm_fwd", "layer_norm_dx", "bias_gelu_fwd",
           "bias_gelu_bwd", "softmax_fwd", "softmax_bwd")
# (atol, rtol) of a row-wise kernel vs its plain version: both compute in
# f32 and round once to the element type, so bf16 agrees within one ulp
# (2^-7 relative) and f32 within summation order and the rsqrtf / tanhf /
# expf roundings; gradients sum rows of products (1e-4 absolute)
ROW_FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
ROW_GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2 ** -7)}
# bert_large widths (deepspeed_tpu/models/bert.py:69-71), pre-LN, BERT's eps
LAYER_KW = dict(hidden_size=1024, heads=16, intermediate_size=4096,
                num_hidden_layers=24, pre_layer_norm=True,
                layer_norm_eps=1e-12)
LAYER_MICRO, LAYER_SEQ = 8, 512
LAYER_LENGTHS = (512, 448, 384, 320, 256, 192, 128, 64)
LAYER_CONFIG = {"train_micro_batch_size_per_gpu": LAYER_MICRO,
                "gradient_accumulation_steps": 1,
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 1},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                "steps_per_print": 100_000}
# model check, bf16 body through 24 layers: the kernels and the plain
# versions round the same f32 values, apart by one ulp where summation
# order moves a value across a rounding boundary
LAYER_LOSS_RTOL = 1e-2
LAYER_GRAD_NORM_RTOL = 5e-2


# the path edges (csrc/layer_norm.cu, csrc/softmax.cu): the widest rows a
# warp holds (1016 and 1024 elements; 1023 takes one element a pack), the
# narrowest a block holds (1025, 1032), a block of two warps (2048), the
# widest a block holds (16384) and rows past it (16392, 20000: the loops)
ROW_EDGE_WIDTHS = (1016, 1032, 2048, 16384, 16392, 20000)
# LayerNorm dx timed at its path edges (phase 24)
DX_EDGE_WIDTHS = (1032, 16384, 16392)
ROW_EDGE_SEQS = (1023, 1024, 1025, 2048)


def _misaligned(torch, t):
    """A contiguous copy of t that starts one element past a 16-byte
    boundary (the row-wise forwards then take one element a pack)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _row_close(got, ref, grad=False) -> float:
    atol, rtol = (ROW_GRAD_TOL if grad else ROW_FWD_TOL)[_dtype_name(ref)]
    return _close(got, ref, atol, rtol)


def phase_rowwise_parity(torch, ln, gl, sm, dev, gen):
    """Each row-wise kernel vs its plain version at the layer's shapes
    (BERT-large width, micro 8 x seq 512), bf16 and f32, and one odd
    shape each. Returns the max abs err per kernel and the bf16 / f32
    inputs that phase 24 times."""
    errs = {name: 0.0 for name in ROWWISE}
    inputs = {}

    def note(name, err):
        errs[name] = max(errs[name], err)

    N = LAYER_MICRO * LAYER_SEQ
    for dtype in (torch.bfloat16, torch.float32):
        for tag, (n, d) in (("layer", (N, 1024)), ("odd", (37, 1000)),
                            *(("edge", (37, d)) for d in ROW_EDGE_WIDTHS),
                            ("misaligned", (37, 1024))):
            x = (torch.randn(n, d, device=dev, generator=gen) * 2 + 1
                 ).to(dtype)
            dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            if tag == "misaligned":
                x = _misaligned(torch, x)
            for pdt in (dtype, torch.float32):
                g = (1 + 0.3 * torch.randn(d, device=dev, generator=gen)
                     ).to(pdt)
                b = (0.3 * torch.randn(d, device=dev, generator=gen)).to(pdt)
                if tag == "misaligned":
                    g, b = _misaligned(torch, g), _misaligned(torch, b)
                y, mean, rstd = ln.layer_norm_forward(x, g, b, 1e-12)
                ry, rm, rr = ln.layer_norm_forward_reference(x, g, b, 1e-12)
                dx = ln.layer_norm_dx(x, g, rm, rr, dy)
                rdx = ln.layer_norm_backward_reference(x, g, rm, rr, dy)
                torch.cuda.synchronize()
                note("layer_norm_fwd", max(_row_close(y, ry),
                                           _close(mean, rm, 1e-5, 1e-5),
                                           _close(rstd, rr, 1e-5, 1e-5)))
                note("layer_norm_dx", _row_close(dx, rdx, grad=True))
                if tag == "layer" and pdt == dtype:
                    inputs[("ln", _dtype_name(x))] = (x, g, b, rm, rr, dy)
        for tag, (n, d) in (("ffn", (N, 4096)), ("odd", (37, 1001))):
            x = (2 * torch.randn(n, d, device=dev, generator=gen)).to(dtype)
            b = (0.5 * torch.randn(d, device=dev, generator=gen)).to(dtype)
            dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            y = gl.bias_gelu_forward(x, b)
            dx = gl.bias_gelu_backward(x, b, dy)
            torch.cuda.synchronize()
            note("bias_gelu_fwd",
                 _row_close(y, gl.bias_gelu_forward_reference(x, b)))
            note("bias_gelu_bwd", _row_close(
                dx, gl.bias_gelu_backward_reference(x, b, dy), grad=True))
            if tag == "ffn":
                inputs[("gelu", _dtype_name(x))] = (x, b, dy)
        for tag, shape in (("scores", (LAYER_MICRO, 16, LAYER_SEQ,
                                       LAYER_SEQ)),
                           ("odd", (2, 3, 77, 4099)),
                           *(("edge", (1, 2, 5, S)) for S in ROW_EDGE_SEQS),
                           ("misaligned", (2, 3, 77, 1024))):
            x = (3 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
            dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
            if tag == "misaligned":
                x, dy = _misaligned(torch, x), _misaligned(torch, dy)
            sq, S = shape[-2:]
            x2, dy2 = x.view(-1, S), dy.view(-1, S)
            for causal in (False, True):
                y = sm.softmax_forward(x2, sq, causal)
                ry = sm.softmax_forward_reference(x2, sq, causal)
                dx = sm.softmax_backward(ry, dy2)
                rdx = sm.softmax_backward_reference(ry, dy2)
                torch.cuda.synchronize()
                note("softmax_fwd", _row_close(y, ry))
                note("softmax_bwd", _row_close(dx, rdx, grad=True))
            if tag == "scores":
                inputs[("softmax", _dtype_name(x))] = (x2, ry, dy2)
                if dtype == torch.float32:
                    mask = torch.where(torch.rand(
                        LAYER_MICRO, 1, 1, LAYER_SEQ, device=dev,
                        generator=gen) < 0.25, -10000.0, 0.0)
                    got = sm.masked_softmax(x, mask, scale=0.125)
                    ref = sm.softmax_forward_reference(
                        (x * 0.125 + mask).view(-1, S), sq, False)
                    torch.cuda.synchronize()
                    note("softmax_fwd", _row_close(got.view(-1, S), ref))
        print(f"phase22 row-wise kernels vs plain {_dtype_name(x)}: "
              f"LayerNorm [{N}, 1024], [37, 1000], [37, d] for d in "
              f"{ROW_EDGE_WIDTHS} and [37, 1024] misaligned (gamma in the "
              f"element type and f32), bias-GELU [{N}, 4096] and [37, 1001], "
              f"softmax [{LAYER_MICRO}, 16, {LAYER_SEQ}, {LAYER_SEQ}], "
              f"[2, 3, 77, 4099], [1, 2, 5, S] for S in {ROW_EDGE_SEQS} and "
              f"[2, 3, 77, 1024] misaligned, causal and not, masked_softmax; "
              f"max_abs_err so far {errs}", flush=True)
    return errs, inputs


def phase_gelu_entry(torch, dev, gen):
    """The op entry of B7 (the layer's GELU is the erf GELU, so B7 is on no
    layer path): ``ops.transformer.bias_gelu`` and ``gelu`` forward and
    backward through autograd at the FFN activation of BERT-large width
    (micro 8 x seq 512 x 4096, bf16), counts reset just before and read
    just after."""
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.transformer import bias_gelu, gelu
    x = torch.randn(LAYER_MICRO, LAYER_SEQ, 4096, device=dev,
                    generator=gen).bfloat16().requires_grad_()
    b = torch.randn(4096, device=dev, generator=gen).bfloat16() \
        .requires_grad_()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    y = bias_gelu(x, b) + gelu(x)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    launches = {n: _build.LAUNCHES[n] for n in ("bias_gelu_fwd",
                                                 "bias_gelu_bwd")}
    print(f"phase22 op entry bias_gelu + gelu fwd/bwd launches={launches}",
          flush=True)
    if launches != {"bias_gelu_fwd": 2, "bias_gelu_bwd": 2}:
        fail(f"the bias-GELU op entry launched {launches}, expected 2 / 2")
    if not (bool(x.grad.isfinite().all()) and bool(b.grad.isfinite().all())):
        fail("non-finite bias-GELU gradients")
    return launches


def _layer_stack(torch, dev, gen):
    """24 DeepSpeedTransformerLayers at bert_large width and the fixed
    key-padding mask of the phase as an integer buffer (the engine hands
    the module only the batch's inputs)."""
    from torch import nn
    import deepspeed_tpu_torch as dst
    cfg = dst.DeepSpeedTransformerConfig(**LAYER_KW)

    class LayerStack(nn.Module):
        def __init__(self):
            super().__init__()
            self.layers = nn.ModuleList(
                dst.DeepSpeedTransformerLayer(cfg, device=dev, generator=gen)
                for _ in range(cfg.num_hidden_layers))
            lengths = torch.tensor(LAYER_LENGTHS, device=dev)
            self.register_buffer("mask", (torch.arange(
                LAYER_SEQ, device=dev)[None, :] < lengths[:, None]).int())
            self.use_mask = True

        def forward(self, x):
            mask = self.mask if self.use_mask else None
            for layer in self.layers:
                x = layer(x, mask, deterministic=True)
            return x
    return cfg, LayerStack()


def l2_loss(out, batch):
    """The TPU layer test's objective: the mean of the squared output."""
    return out.float().square().mean()


def phase_layer_training(torch, np, dev, gen, card):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg, stack = _layer_stack(torch, dev, gen)
    n_params = sum(p.numel() for p in stack.parameters())
    engine, *_ = dst.initialize(model=stack, loss_fn=l2_loss,
                                config=LAYER_CONFIG)
    x = torch.randn(LAYER_MICRO, LAYER_SEQ, cfg.hidden_size, device=dev,
                    generator=gen)
    batch = {"inputs": x}
    losses, norms, secs, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(4):                 # 1 warm-up + 3 timed steps
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([batch]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        per_step.append({n: _build.LAUNCHES[n] - before.get(n, 0)
                         for n in ROWWISE + FLASH})
    launches = {name: _build.LAUNCHES[name] for name in ROWWISE}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase23 layer training {cfg.num_hidden_layers} x "
          f"DeepSpeedTransformerLayer(hidden {cfg.hidden_size}, heads "
          f"{cfg.heads}, intermediate {cfg.intermediate_size}, pre-LN) "
          f"params={n_params} micro={LAYER_MICRO} seq={LAYER_SEQ} "
          f"lengths={LAYER_LENGTHS} losses={losses} grad_norms={norms} "
          f"step_s={secs} launches_per_step={per_step}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("non-finite loss or grad norm while training the layer stack")
    if not losses[-1] < losses[0]:
        fail(f"the layer stack's loss did not fall: {losses}")
    L = cfg.num_hidden_layers
    want = {"layer_norm_fwd": 2 * L, "layer_norm_dx": 2 * L,
            "softmax_fwd": L, "softmax_bwd": L, "bias_gelu_fwd": 0,
            "bias_gelu_bwd": 0, **{n: 0 for n in FLASH}}
    if any(step != want for step in per_step):
        fail(f"launches per step {per_step}, expected {want}")
    step_s = sum(secs[1:]) / 3
    print(f"layer_stack_step_s={step_s} card={card}", flush=True)
    print(f"layer_stack_tokens_per_s={LAYER_MICRO * LAYER_SEQ / step_s} "
          f"card={card}", flush=True)
    print(f"layer_stack_peak_memory_gib={peak_gib} card={card}", flush=True)
    return engine, batch, launches


def phase_layer_profile(torch, engine, batch, card):
    """One warmed step unprofiled (wall), then one under torch.profiler
    (device time by kernel; idle share against the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(iter([batch]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(iter([batch]))
        torch.cuda.synchronize()
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        fail("the profiler recorded no device time for a layer-stack step")
    print(f"phase23 profile layer-stack step wall_ms={wall_ms} (unprofiled) "
          f"device_busy_ms={busy_ms} idle_share={1 - busy_ms / wall_ms} "
          f"device_kernels={sum(r[1] for r in rows)} card={card}", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:14]:
        print(f"phase23 kernel ms={ms} count={count} {key[:90]}", flush=True)


def phase_layer_unmasked(torch, engine, batch):
    """One forward and backward of the stack without the mask: attention
    takes the flash kernels (B1, B1b), the softmax kernel is not launched."""
    from deepspeed_tpu_torch.ops.cuda import _build
    stack = engine.compute_module
    stack.use_mask = False
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        loss = engine(batch)
        engine.backward(loss)
        torch.cuda.synchronize()
    finally:
        stack.use_mask = True
    L = len(stack.layers)
    got = {n: _build.LAUNCHES[n] for n in ROWWISE + FLASH}
    loss = float(loss.detach())
    print(f"phase23 unmasked forward+backward loss={loss} launches={got}",
          flush=True)
    want = {"layer_norm_fwd": 2 * L, "layer_norm_dx": 2 * L,
            "softmax_fwd": 0, "softmax_bwd": 0, "bias_gelu_fwd": 0,
            "bias_gelu_bwd": 0, **{n: L for n in FLASH}}
    if got != want or not math.isfinite(loss):
        fail(f"the unmasked stack launched {got}, expected {want}")


@contextlib.contextmanager
def plain_rowwise(ln, sm):
    """Route the LayerNorm and softmax autograd functions through their
    plain versions (on the card they are reached only here, for
    comparison)."""
    saved = (ln.layer_norm_forward, ln.layer_norm_dx, sm.softmax_forward,
             sm.softmax_backward)
    ln.layer_norm_forward = ln.layer_norm_forward_reference
    ln.layer_norm_dx = ln.layer_norm_backward_reference
    sm.softmax_forward = sm.softmax_forward_reference
    sm.softmax_backward = sm.softmax_backward_reference
    try:
        yield
    finally:
        (ln.layer_norm_forward, ln.layer_norm_dx, sm.softmax_forward,
         sm.softmax_backward) = saved


def phase_layer_model_check(torch, ln, sm, engine, batch):
    """The trained stack's bf16 weights and the batch through the kernels
    and through the plain versions: loss and global grad norm."""
    import copy
    from deepspeed_tpu_torch.ops.cuda import _build
    result = {}
    for impl in ("kernels", "plain"):
        m = copy.deepcopy(engine.module).to(torch.bfloat16)
        before = sum(_build.LAUNCHES[n] for n in ROWWISE)
        with (plain_rowwise(ln, sm) if impl == "plain"
              else contextlib.nullcontext()):
            loss = l2_loss(m(batch["inputs"]), batch)
            loss.backward()
        launched = sum(_build.LAUNCHES[n] for n in ROWWISE) - before
        if (impl == "plain") != (launched == 0):
            fail(f"the {impl} layer model check launched {launched} kernels")
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in m.parameters()]))
        result[impl] = (loss.item(), norm.item())
        del m, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = result["kernels"], result["plain"]
    print(f"phase23 layer model check loss kernels={lk} plain={lp} (rtol "
          f"{LAYER_LOSS_RTOL}); grad norm kernels={nk} plain={np_} (rtol "
          f"{LAYER_GRAD_NORM_RTOL})", flush=True)
    if not (abs(lk - lp) <= LAYER_LOSS_RTOL * abs(lp)
            and abs(nk - np_) <= LAYER_GRAD_NORM_RTOL * np_):
        fail("the layer stack through the kernels disagrees with the plain "
             "versions")


# operations per element of each kernel's f32 arithmetic (CUDA cores,
# F32_FLOPS): the statistics, normalise and affine of LayerNorm; the
# derivative's products and row sums; tanh-GELU with its tanh counted as
# 20 operations; softmax's max, exp, sum and divide
ROW_OPS_PER_ELEMENT = {"layer_norm_fwd": 8, "layer_norm_dx": 12,
                       "bias_gelu_fwd": 30, "bias_gelu_bwd": 40,
                       "softmax_fwd": 8, "softmax_bwd": 4}


# input copies a cold timing reads in turn: past the H100's 50 MB L2
COLD_BYTES = 64 * 2 ** 20


def rowwise_time_inputs(torch, ln, sm, dev, gen, dt):
    """The LayerNorm and softmax inputs of phase 22 at the layer's shapes
    (x [8 * 512, 1024] with gamma and beta in x's type; the scores [8 * 16 *
    512, 512], the plain forward's y and a cotangent), keyed as phase 22
    keys them."""
    dtype = getattr(torch, dt)
    ln_in = ln_time_inputs(torch, ln, dev, gen, dtype,
                           LAYER_MICRO * LAYER_SEQ, LAYER_KW["hidden_size"])
    shape = (LAYER_MICRO * LAYER_KW["heads"] * LAYER_SEQ, LAYER_SEQ)
    xs = (3 * torch.randn(shape, device=dev, generator=gen)).to(dtype)
    dys = torch.randn(shape, device=dev, generator=gen).to(dtype)
    ys = sm.softmax_forward_reference(xs, LAYER_SEQ, False)
    return {("ln", dt): ln_in, ("softmax", dt): (xs, ys, dys)}


def ln_time_inputs(torch, ln, dev, gen, dtype, n, d):
    """LayerNorm inputs [n, d]: x, gamma and beta in x's type, the plain
    forward's mean and rstd, a cotangent."""
    x = (torch.randn(n, d, device=dev, generator=gen) * 2 + 1).to(dtype)
    g = (1 + 0.3 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    b = (0.3 * torch.randn(d, device=dev, generator=gen)).to(dtype)
    dy = torch.randn(n, d, device=dev, generator=gen).to(dtype)
    _, mean, rstd = ln.layer_norm_forward_reference(x, g, b, 1e-12)
    return x, g, b, mean, rstd, dy


def _grad_state(torch, fn, *leaves):
    """(fn's output, its leaves) of a fresh graph over leaf copies."""
    leaves = tuple(t.detach().requires_grad_() for t in leaves)
    return fn(*leaves), leaves


def rowwise_time_cases(torch, ln, gl, sm, inputs, dt):
    """The row-wise kernels timed at inputs[(op, dt)]: name -> (args,
    kernel(args), plain(args), library state(args), library(state),
    elements, bytes moved, bytes read). The library call is one PyTorch
    call of the same function (a yardstick the port never calls); a
    backward's state is its autograd graph."""
    import torch.nn.functional as F
    cases = {}
    if ("ln", dt) in inputs:
        x, g, b, mean, rstd, dy = args = inputs[("ln", dt)]
        d, par = x.shape[-1], g.numel() * g.element_size()
        cases["layer_norm_fwd"] = (
            args, lambda a: ln.layer_norm_forward(*a[:3], 1e-12),
            lambda a: ln.layer_norm_forward_reference(*a[:3], 1e-12),
            lambda a: a, lambda a: F.layer_norm(a[0], (d,), a[1], a[2],
                                                1e-12),
            x.numel(), 2 * x.numel() * x.element_size() + 2 * par
            + 8 * x.shape[0], x.numel() * x.element_size() + 2 * par)
        cases["layer_norm_dx"] = (
            args, lambda a: ln.layer_norm_dx(a[0], a[1], a[3], a[4], a[5]),
            lambda a: ln.layer_norm_backward_reference(a[0], a[1], a[3],
                                                       a[4], a[5]),
            lambda a: (*_grad_state(torch, lambda x_, g_, b_: F.layer_norm(
                x_, (d,), g_, b_, 1e-12), *a[:3]), a[5]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            x.numel(), 3 * x.numel() * x.element_size() + par
            + 8 * x.shape[0], 2 * x.numel() * x.element_size() + par)
    if ("gelu", dt) in inputs:
        xg, bg, dyg = args = inputs[("gelu", dt)]
        nb = xg.numel() * xg.element_size()
        bb = bg.numel() * bg.element_size()
        cases["bias_gelu_fwd"] = (
            args, lambda a: gl.bias_gelu_forward(a[0], a[1]),
            lambda a: gl.bias_gelu_forward_reference(a[0], a[1]),
            lambda a: a, lambda a: F.gelu(a[0] + a[1], approximate="tanh"),
            xg.numel(), 2 * nb + bb, nb + bb)
        cases["bias_gelu_bwd"] = (
            args, lambda a: gl.bias_gelu_backward(*a),
            lambda a: gl.bias_gelu_backward_reference(*a),
            lambda a: (*_grad_state(torch, lambda x_, b_: F.gelu(
                x_ + b_, approximate="tanh"), a[0], a[1]), a[2]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            xg.numel(), 3 * nb + bb, 2 * nb + bb)
    if ("softmax", dt) in inputs:
        xs, ys, dys = args = inputs[("softmax", dt)]
        nb = xs.numel() * xs.element_size()
        cases["softmax_fwd"] = (
            args, lambda a: sm.softmax_forward(a[0], LAYER_SEQ, False),
            lambda a: sm.softmax_forward_reference(a[0], LAYER_SEQ, False),
            lambda a: a, lambda a: torch.softmax(a[0], -1),
            xs.numel(), 2 * nb, nb)
        cases["softmax_bwd"] = (
            args, lambda a: sm.softmax_backward(a[1], a[2]),
            lambda a: sm.softmax_backward_reference(a[1], a[2]),
            lambda a: (*_grad_state(torch, lambda x_: torch.softmax(x_, -1),
                                    a[0]), a[2]),
            lambda st: torch.autograd.grad(st[0], st[1], st[2],
                                           retain_graph=True),
            xs.numel(), 3 * nb, 2 * nb)
    return cases


def time_row_case(torch, name, case, cold):
    """(kernel ms, library ms) of one case: warm (the same inputs each
    call, as the layer stack's working set may sit in L2) or cold (input
    copies of at least COLD_BYTES together, read in turn)."""
    args, kernel, _, state, library, _, _, in_bytes = case
    copies = [args]
    if cold:
        copies = [tuple(t.clone() for t in args)
                  for _ in range(max(2, math.ceil(COLD_BYTES / in_bytes)))]
    states = [state(c) for c in copies]
    ms = device_ms(lambda i: kernel(copies[i]), len(copies),
                   kernel=name + "_")
    lib_ms = device_ms(lambda i: library(states[i]), len(copies))
    del copies, states
    torch.cuda.empty_cache()
    return ms, lib_ms


def phase_rowwise_timing(torch, ln, gl, sm, inputs, card):
    """Device ms of the six row-wise kernels at the layer's shapes (bf16;
    softmax also f32, the dtype of the layer's logits) beside their plain
    versions, one PyTorch library call each (a yardstick the port never
    calls) and their bounds; warm (the same inputs each call, the kernels
    line's numbers) and cold (input copies past L2, read in turn).
    Returns the kernels-line numbers: LayerNorm and GELU at bf16, softmax
    at f32."""
    out = {}
    for dt in ("bfloat16", "float32"):
        for name, case in rowwise_time_cases(torch, ln, gl, sm, inputs,
                                             dt).items():
            if dt == "float32" and not name.startswith("softmax"):
                continue
            args, _, plain, _, _, n_el, nbytes, _ = case
            tb = nbytes / HBM_BYTES_PER_S
            tf = ROW_OPS_PER_ELEMENT[name] * n_el / F32_FLOPS
            ms, lib_ms = time_row_case(torch, name, case, cold=False)
            cold_ms, lib_cold_ms = time_row_case(torch, name, case,
                                                 cold=True)
            t = {"ms": ms, "plain_ms": device_ms(lambda i: plain(args),
                                                 iters=10),
                 "library_ms": lib_ms, "bound_ms": 1e3 * max(tb, tf),
                 "bound_by": "bytes" if tb >= tf else "operations"}
            for key, val in {**t, "cold_ms": cold_ms,
                             "library_cold_ms": lib_cold_ms}.items():
                print(f"{name}_{dt}_{key}={val} card={card}", flush=True)
            print(f"phase24 {name} {dt}: warm {t['ms'] / t['bound_ms']} x "
                  f"its bound, {t['ms'] / t['library_ms']} x the library "
                  f"call; cold {cold_ms / t['bound_ms']} x its bound, "
                  f"{cold_ms / lib_cold_ms} x the library call", flush=True)
            if (dt == "float32") == name.startswith("softmax"):
                out[name] = t
    # dx at its path edges: the narrowest block row, the widest a block
    # holds and the loop's narrowest, as many rows as the layer's elements
    x = inputs[("ln", "bfloat16")][0]
    gen = torch.Generator(device=x.device).manual_seed(24)
    for d in DX_EDGE_WIDTHS:
        n = x.numel() // d
        edge = {("ln", "bfloat16"): ln_time_inputs(
            torch, ln, x.device, gen, torch.bfloat16, n, d)}
        case = rowwise_time_cases(torch, ln, gl, sm, edge,
                                  "bfloat16")["layer_norm_dx"]
        bound = 1e3 * case[6] / HBM_BYTES_PER_S
        ms, lib_ms = time_row_case(torch, "layer_norm_dx", case, cold=False)
        cold_ms, lib_cold_ms = time_row_case(torch, "layer_norm_dx", case,
                                             cold=True)
        print(f"phase24 layer_norm_dx bfloat16 [{n}, {d}]: warm {ms} ms "
              f"({ms / bound} x its byte bound {bound}; library {lib_ms}), "
              f"cold {cold_ms} ms (library {lib_cold_ms}) card={card}",
              flush=True)
        del edge, case
    print("phase24 library calls (yardsticks, never called by the port): "
          "F.layer_norm and its autograd backward (dx, dgamma and dbeta "
          "together); F.gelu(x + b, approximate='tanh') (two kernels: the "
          "add, then the GELU) and its autograd backward (dx and dbias); "
          "torch.softmax and its autograd backward; cold: input copies of "
          f"at least {COLD_BYTES} bytes read in turn", flush=True)
    return out


def _cuobjdump():
    import glob
    import shutil
    return (shutil.which("cuobjdump")
            or next(iter(glob.glob("/usr/local/cuda/bin/cuobjdump")), None))


_DUMPS: dict = {}


def start_dumps(_build) -> None:
    """Start cuobjdump's resource-usage and SASS dumps of the built library
    together (each takes seconds over its hundreds of kernels); phase 1's
    register and SASS checks read them through ``library_dump``."""
    import glob
    tool = _cuobjdump()
    if tool is None:
        return
    lib = glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))[0]
    for kind in ("--dump-resource-usage", "--dump-sass"):
        out = tempfile.TemporaryFile(mode="w+")   # no pipe to fill up
        _DUMPS[kind] = (subprocess.Popen([tool, kind, lib], stdout=out),
                        out)


def library_dump(kind: str):
    """The text of a dump ``start_dumps`` started (None without
    cuobjdump); fails on the tool's error or after 300 s."""
    entry = _DUMPS.get(kind)
    if entry is None or isinstance(entry, str):
        return entry
    proc, out = entry
    if proc.wait(timeout=300):
        fail(f"cuobjdump {kind} exited {proc.returncode}")
    out.seek(0)
    _DUMPS[kind] = text = out.read()
    out.close()
    return text


def row_registers(_build, names=("layer_norm_fwd", "layer_norm_dx",
                                 "softmax_fwd")):
    """{kernel: (registers a thread, local bytes)} of the kernels whose
    names hold one of ``names`` (default: the LayerNorm forward and dx and
    the softmax forward) in the built library (cuobjdump --dump-resource-usage; local
    bytes count the stack frame, where spills go, and local memory), names
    demangled where c++filt is on PATH; None without cuobjdump."""
    import re
    import shutil
    if not _DUMPS:
        start_dumps(_build)
    usage = library_dump("--dump-resource-usage")
    if usage is None:
        return None
    found = {}
    for m in re.finditer(r"Function (\S+):\s*([^\n]*)", usage):
        if any(n in m.group(1) for n in names):
            field = {k: int(v) for k, v in
                     re.findall(r"(REG|STACK|LOCAL):(\d+)", m.group(2))}
            found[m.group(1)] = (field["REG"], field.get("STACK", 0)
                                 + field.get("LOCAL", 0))
    if shutil.which("c++filt") and found:
        names = subprocess.run(["c++filt"], input="\n".join(found),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.split("\n")
        found = dict(zip(names, found.values()))
    return found


def phase_row_registers(_build):
    """Registers a thread (and spilled local bytes) of each LayerNorm
    forward and dx and softmax forward kernel, and the warps an SM those
    registers allow (65536 registers, allocated 256 a warp, at most 64
    warps)."""
    regs = row_registers(_build)
    if regs is None:
        print("phase1 row-wise registers: no cuobjdump, not measured",
              flush=True)
        return
    if not regs:
        fail("no LayerNorm or softmax kernel in the resource usage")
    short = {}
    for name, (reg, local) in sorted(regs.items()):
        per_warp = -(-reg * 32 // 256) * 256
        warps = min(64, 65536 // max(per_warp, 1))
        name = name.split("(anonymous namespace)::")[-1].split("(")[0]
        short[name.replace("__nv_bfloat16", "bf16")] = [reg, local, warps]
    print("phase1 row-wise kernels (LayerNorm forward and dx, softmax "
          "forward) [registers a thread, local bytes, warps an SM those "
          f"registers allow]: {json.dumps(short)}", flush=True)


# the 16-bit sparse wgmma kernels (B5 forward, B5b dq and dk/dv): bf16 and
# fp16 x 5 head dims (d 80 the d 96 kernels storing 80) x causal or not of
# each
SPARSE_WGMMA = ("sparse_fwd_wgmma", "sparse_bwd_dq_wgmma",
                "sparse_bwd_dkv_wgmma")
SPARSE_WGMMA_KERNELS = 20 * len(SPARSE_WGMMA)


def phase_decode_registers(_build):
    """Registers a thread and local bytes (stack and local memory, where
    spills go) of the decode kernel's instances (B2/B3, int8 or not), by
    query bucket kSQ and head dim: the most of each over the instances and
    the spilled ones. Fails on a kSQ 16 instance (the fused prefill step's)
    with local memory; the kSQ 4 and 8 instances' spills are reported."""
    import re
    regs = row_registers(_build, ("decode_attention_kernel",))
    if regs is None:
        print("phase1 decode registers: no cuobjdump, not measured",
              flush=True)
        return
    groups = {}
    for name, (reg, local) in regs.items():
        # demangled "<T, TC, D, kSQ, Rows>", or mangled "...Li<D>ELi<kSQ>E"
        m = (re.search(r"decode_attention_kernel<[^,]+, [^,]+, (\d+), "
                       r"(\d+),", name)
             or re.search(r"Li(\d+)ELi(\d+)E", name))
        if m is None:
            fail(f"phase1: cannot read the decode instance {name}")
        d, sq = int(m.group(1)), int(m.group(2))
        g = groups.setdefault((sq, d), [0, 0, 0, 0])
        g[0] = max(g[0], reg)
        g[1] = max(g[1], local)
        g[2] += 1
        g[3] += local > 0
    if len(regs) != 300:
        fail(f"expected 300 decode instances (3 dtypes x int8 or not x 5 "
             f"head dims x 5 query buckets x 2 layouts), found {len(regs)}")
    print("phase1 decode instances by (kSQ, d): [most registers a thread, "
          "most local bytes, instances, instances with local memory]: "
          + json.dumps({f"{sq},{d}": v for (sq, d), v
                        in sorted(groups.items())}), flush=True)
    spilled16 = {k: v for k, v in groups.items() if k[0] == 16 and v[3]}
    if spilled16:
        fail(f"kSQ 16 decode instances with local memory: {spilled16}")


def phase_sparse_registers(_build):
    """Registers a thread and local bytes (stack and local memory) of each
    16-bit sparse kernel (B5 forward, B5b); fails on any local memory."""
    regs = row_registers(_build, SPARSE_WGMMA)
    if regs is None:
        print("phase1 sparse registers: no cuobjdump, not measured",
              flush=True)
        return
    if len(regs) != SPARSE_WGMMA_KERNELS:
        fail(f"expected {SPARSE_WGMMA_KERNELS} sparse wgmma kernels, found "
             f"{len(regs)}")
    spilled = {n: r for n, r in regs.items() if r[1] > 0}
    if spilled:
        fail(f"sparse wgmma kernels with local memory: {spilled}")
    for kind in SPARSE_WGMMA:
        print(f"phase1 sparse {kind} kernels: "
              f"{sum(kind in n for n in regs)}, registers a thread "
              f"{sorted({r[0] for n, r in regs.items() if kind in n})} (the "
              "launch's; setmaxnreg moves them to 224 / 56), no local "
              "memory", flush=True)


def phase_sass(_build):
    """From the built library's SASS (cuobjdump, the toolkit's or on PATH):
    the HGMMA (wgmma) instructions of each 16-bit flash kernel, the
    bulk-copy instructions (UBLKCP for cp.async.bulk, UTMALDG for a
    tensor-map load) of each decode kernel, and the HGMMA, UTMALDG and HMMA
    (mma.sync) instructions of each 16-bit sparse kernel. Fails if one
    has none of what it wants, or a sparse kernel an HMMA."""
    import re
    if not _DUMPS:
        start_dumps(_build)
    sass = library_dump("--dump-sass")
    if sass is None:
        print("phase1 SASS: no cuobjdump, HGMMA and UTMALDG counts not "
              "measured", flush=True)
        return
    flash, decode = {}, {}
    sparse = {}          # name: [HGMMA, UTMALDG, HMMA]
    # each function's text up to the next header; a SASS line holds one
    # instruction, so counting the text counts the lines
    parts = re.split(r"Function : (\S+)", sass)
    for name, body in zip(parts[1::2], parts[2::2]):
        if "flash" in name and "wgmma" in name:
            flash[name] = body.count("HGMMA")
        elif "decode_attention_kernel" in name:
            decode[name] = body.count("UBLKCP") + body.count("UTMALDG")
        elif any(kind in name for kind in SPARSE_WGMMA):
            sparse[name] = [len(re.findall(insn, body)) for insn in
                            (r"\bHGMMA", r"\bUTMALDG", r"\bHMMA\b")]
    for what, counts, insn in (("16-bit flash", flash, "HGMMA"),
                               ("decode", decode, "UTMALDG")):
        if not counts or min(counts.values()) == 0:
            fail(f"{what} kernels without {insn} in the SASS: {counts}")
        print(f"phase1 {what} SASS: {len(counts)} kernels, "
              f"{sum(counts.values())} {insn} instructions "
              f"({min(counts.values())}-{max(counts.values())} each)",
              flush=True)
    if (len(sparse) != SPARSE_WGMMA_KERNELS
            or any(h == 0 or u == 0 or mma for h, u, mma in sparse.values())):
        fail("the 16-bit sparse kernels want HGMMA and UTMALDG and no HMMA "
             f"each: {sparse}")
    for kind in SPARSE_WGMMA:
        counts = [c for n, c in sparse.items() if kind in n]
        print(f"phase1 16-bit {kind} SASS: {len(counts)} kernels, "
              f"{sum(c[0] for c in counts)} HGMMA and "
              f"{sum(c[1] for c in counts)} UTMALDG instructions, no HMMA",
              flush=True)


# --------------------------------------------------------------------------
# Phases 29-31: resume, ZeRO-1 over two ranks, LAMB / Adagrad / SGD
# --------------------------------------------------------------------------

def _gpt2_engine(torch, dev, seed, config):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m, lm_loss_fn
    cfg = gpt2_125m(max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16)
    model = GPT(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=config)
    return engine, cfg


def resume_micros(np, seed, vocab, steps=4):
    """Phases 29-30's global micro-batches of TRAIN_MICRO rows: phase 8's
    one batch, repeated (on random tokens only a repeated batch can show a
    falling loss)."""
    ids = np.random.default_rng(seed).integers(
        0, vocab, (TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)
    return [{"input_ids": ids}] * (steps * RESUME_GAS)


def _train_steps(torch, engine, micros, first, steps):
    losses, secs = [], []
    for step in range(first, first + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = engine.train_batch(iter(
            micros[RESUME_GAS * step:RESUME_GAS * (step + 1)]))
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs


def opt_state_bytes(engine) -> int:
    """The optimizer's fp32 masters (this rank's slices under ZeRO-1 over
    dp) and moments, in bytes."""
    held = list(engine._opt_params)
    for name in engine.optimizer.STATE:
        held += getattr(engine.optimizer, name)
    return sum(t.numel() * t.element_size() for t in held)


def phase_resume(torch, np, dev, seed, card):
    """Phase 29: train 2 steps, save, train 2; a fresh engine loads and
    trains the same 2, bitwise."""
    from deepspeed_tpu_torch.ops.cuda import _build
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=RESUME_GAS)
    engine, cfg = _gpt2_engine(torch, dev, seed, config)
    micros = resume_micros(np, seed, cfg.vocab_size)
    first, _ = _train_steps(torch, engine, micros, 0, 2)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tag_dir = engine.save_checkpoint(root, tag="two")
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tag_dir, f))
                     for f in os.listdir(tag_dir))
        cont, cont_s = _train_steps(torch, engine, micros, 2, 2)
        state_bytes = opt_state_bytes(engine)
        del engine
        torch.cuda.empty_cache()
        fresh, _ = _gpt2_engine(torch, dev, seed + 1, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    resumed, _ = _train_steps(torch, fresh, micros, 2, 2)
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    del fresh
    torch.cuda.empty_cache()
    print(f"phase29 resume gpt2_125m gas={RESUME_GAS} (cut from "
          f"{TRAIN_GAS}) losses={first + cont} resumed={resumed} "
          f"resumed_launches={launches} step_s={cont_s} (steps 3-4, dp 1) "
          f"card={card}", flush=True)
    print(f"checkpoint_save_s={save_s} checkpoint_load_s={load_s} "
          f"checkpoint_bytes={nbytes} card={card}", flush=True)
    if resumed != cont:
        fail(f"resumed losses {resumed} are not bitwise the uninterrupted "
             f"{cont}")
    if not all(np.isfinite(first + cont)) or not cont[-1] < first[0]:
        fail(f"phase 29's losses are not finite and falling: {first + cont}")
    if min(launches.values()) == 0:
        fail(f"the resumed steps launched no flash kernel: {launches}")
    return first + cont, state_bytes


def dp_rank_main(args) -> int:
    """One rank of phases 30 and 33 (this script with --dp-rank): its rows
    of phase 29's micro-batches for DP_STEPS steps at each ZeRO stage of
    --dp-stages; then the phases of --dp-onebit (52: ``compressed_rank``,
    53: ``onebit_rank``); results as JSON to --dp-out."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.cuda import _build
    nccl = torch.cuda.device_count() >= 2
    comm.init_distributed(dist_backend="nccl" if nccl else "gloo",
                          init_method=f"tcp://localhost:{args.dp_port}",
                          rank=args.dp_rank, world_size=2)
    dev = torch.device("cuda", torch.cuda.current_device())
    stages, cfg = {}, None
    for stage in (int(x) for x in args.dp_stages.split(",") if x):
        config = dict(TRAIN_CONFIG, gradient_accumulation_steps=RESUME_GAS,
                      train_micro_batch_size_per_gpu=TRAIN_MICRO // 2,
                      zero_optimization={"stage": stage})
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak(torch, dev)
        # what an earlier stage left in this process (cuBLAS workspaces)
        start = torch.cuda.memory_allocated(dev)
        engine, cfg = _gpt2_engine(torch, dev, args.seed, config)
        state_allocated = torch.cuda.memory_allocated(dev) - start
        micros = resume_micros(np, args.seed, cfg.vocab_size)
        marks, forward_peak, hooks = _block_marks(torch, engine, dev)
        _build.reset_launch_counts()
        losses, secs = _train_steps(torch, engine, micros, 0, DP_STEPS)
        for h in hooks:
            h.remove()
        launches = {name: _build.LAUNCHES[name] for name in FLASH}
        numel = sum(math.prod(s) for s in engine._shapes)
        wire = 2 if engine._comm_dtype is not None else 4
        split = [engine._shapes[i] for u in engine._units
                 for i, _, _ in u.entries]
        stages[stage] = {
            "losses": losses, "step_s": secs, "launches": launches,
            "numel": numel, "n_leaves": len(engine._shapes),
            "comm_bytes_per_step": {k: v // 4 for k, v in
                                    engine.comm_bytes.items()},
            "bytes_all_reduced_per_step": RESUME_GAS * numel * wire,
            "bytes_all_gathered_per_step": numel * 2,
            "opt_state_bytes": opt_state_bytes(engine),
            "acc_numel": sum(a.numel() for a in engine.acc),
            "partitioned_param_bytes": sum(
                u.shard.numel() * u.shard.element_size()
                for u in engine._units),
            "partitioned_leaf_bytes": sum(math.prod(s) * 2 for s in split),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "allocated_at_start": start,
            "state_allocated": state_allocated,
            # blocks 1.. of the first forward (block 0 also holds the
            # process's first cuBLAS workspace)
            "block_growth": (marks[-1] - marks[1]) / (len(marks) - 2),
            "forward_allocated": marks[-1],
            "forward_peak": forward_peak[0],
            "block_gathered_bytes": max(
                [sum(math.prod(engine._shapes[i]) for i, _, _ in u.entries)
                 * 2 for u in engine._units[:-1]] or [0])}
        del engine
    out = {"rank": comm.get_rank(), "dp": comm.get_world_size(),
           "backend": torch.distributed.get_backend(), "device": str(dev),
           "layers": cfg.num_layers if cfg else None, "stages": stages}
    onebit = args.dp_onebit.split(",")
    if "52" in onebit:
        gc.collect()
        torch.cuda.empty_cache()
        out["compressed"] = compressed_rank(torch, np, dev, args.seed)
    if "53" in onebit:
        gc.collect()
        torch.cuda.empty_cache()
        out["onebit"] = onebit_rank(torch, np, dev, args.seed)
    with open(args.dp_out, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()
    return 0


def _block_marks(torch, engine, dev):
    """Forward hooks that record ``memory_allocated`` before the first
    block and after each block of the first forward pass (the remat
    recompute in the backward calls the blocks again; it is not recorded),
    and the peak when that forward returns its logits. Returns (the marks,
    [the forward's peak], the hooks to remove)."""
    module = engine.compute_module
    blocks = list(getattr(module, "inner", module).blocks)
    marks, peak = [], []

    def before(*_):
        if not marks:
            marks.append(torch.cuda.memory_allocated(dev))

    def after(*_):
        if len(marks) <= len(blocks):
            marks.append(torch.cuda.memory_allocated(dev))

    def logits(*_):
        if not peak:
            peak.append(torch.cuda.max_memory_allocated(dev))
    return marks, peak, [blocks[0].register_forward_pre_hook(before),
                         module.register_forward_hook(logits)] + [
        b.register_forward_hook(after) for b in blocks]


def run_dp_ranks(seed, stages, phase, onebit="", script=None):
    """``script`` (default this one) twice more as the two ranks
    (--dp-rank 0 / 1) at each ZeRO stage of ``stages``, then the 1-bit
    phases of ``onebit`` ("52,53"); their JSON results."""
    with tempfile.TemporaryDirectory() as d:
        return spawn_ranks(
            seed, 2, ["--dp-rank", "--dp-stages",
                      ",".join(str(x) for x in stages),
                      "--dp-onebit", onebit], phase,
            DP_TIMEOUT_S * len(stages) + ONEBIT_TIMEOUT_S * bool(onebit), d,
            own_card=True, script=script)


def _check_dp_losses(ranks, stage, dp1_losses, phase):
    per_step = ranks[0]["layers"] * RESUME_GAS * DP_STEPS
    want = {"flash_fwd": 2 * per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    for r in ranks:
        got = r["stages"][str(stage)]
        if r["dp"] != 2 or got["launches"] != want:
            fail(f"phase {phase} rank {r['rank']} stage {stage}: dp "
                 f"{r['dp']}, launches {got['launches']}, expected {want}")
        if max(abs(a - b) for a, b in zip(got["losses"], dp1_losses)) \
                > LOSS_ATOL:
            fail(f"phase {phase} stage {stage}: dp 2 losses {got['losses']} "
                 f"leave dp 1's {dp1_losses}")
    if ranks[0]["stages"][str(stage)]["losses"] != \
            ranks[1]["stages"][str(stage)]["losses"]:
        fail(f"phase {phase} stage {stage}: the two ranks report different "
             f"losses")


def phase_dp(seed, card, dp1_losses, dp1_state_bytes):
    """Phase 30: two ranks of ZeRO-1 against phase 29's dp 1 losses. The
    rank processes then run phase 33's ZeRO-2 and ZeRO-3 and phases 52-53
    (one start of the ranks for the four); returns their results."""
    ranks = run_dp_ranks(seed, (1, 2, 3), 30, onebit="52,53")
    for r in ranks:
        z = r["stages"]["1"]
        print(f"phase30 zero1 dp=2 rank={r['rank']} backend={r['backend']} "
              f"device={r['device']} losses={z['losses']} step_s="
              f"{z['step_s']} launches={z['launches']} "
              f"bytes_all_reduced_per_step={z['bytes_all_reduced_per_step']} "
              f"bytes_all_gathered_per_step="
              f"{z['bytes_all_gathered_per_step']} opt_state_bytes="
              f"{z['opt_state_bytes']} dp1_opt_state_bytes={dp1_state_bytes} "
              f"max_memory_allocated={z['max_memory_allocated']} "
              f"card={card}", flush=True)
    print(f"phase30 dp2 vs dp1 losses {ranks[0]['stages']['1']['losses']} "
          f"vs {dp1_losses} (atol {LOSS_ATOL})", flush=True)
    _check_dp_losses(ranks, 1, dp1_losses, 30)
    for r in ranks:
        z = r["stages"]["1"]
        if abs(z["opt_state_bytes"] - dp1_state_bytes / 2) \
                > 3 * 4 * z["n_leaves"]:
            fail(f"rank {r['rank']} holds {z['opt_state_bytes']} bytes of "
                 f"optimizer state, not half of {dp1_state_bytes}")
    return ranks


def phase_dp_stages(card, dp1_losses, ranks):
    """Phase 33: ZeRO-2 and ZeRO-3 over two ranks (phase 30's rank
    processes, ``ranks``) against phase 29's dp 1 losses; the accumulator
    (stage 2) and the partitioned parameters (stage 3) a rank holds
    against dp 1's."""
    for stage in (2, 3):
        for r in ranks:
            z, one = r["stages"][str(stage)], \
                ranks[r["rank"]]["stages"]["1"]
            print(f"phase33 zero{stage} dp=2 rank={r['rank']} backend="
                  f"{r['backend']} losses={z['losses']} step_s={z['step_s']} "
                  f"launches={z['launches']} comm_bytes_per_step="
                  f"{z['comm_bytes_per_step']} acc_numel={z['acc_numel']} "
                  f"of {z['numel']} partitioned_param_bytes="
                  f"{z['partitioned_param_bytes']} of "
                  f"{z['partitioned_leaf_bytes']} max_memory_allocated="
                  f"{z['max_memory_allocated']} allocated_at_start="
                  f"{z['allocated_at_start']} state_allocated="
                  f"{z['state_allocated']} forward_allocated="
                  f"{z['forward_allocated']} forward_peak="
                  f"{z['forward_peak']} block_growth={z['block_growth']} "
                  f"(zero1: max_memory_allocated "
                  f"{one['max_memory_allocated']}, state_allocated "
                  f"{one['state_allocated']}, forward_allocated "
                  f"{one['forward_allocated']}, forward_peak "
                  f"{one['forward_peak']}, block_growth "
                  f"{one['block_growth']}, step_s {one['step_s']}) "
                  f"card={card}", flush=True)
        _check_dp_losses(ranks, stage, dp1_losses, 33)
    for r in ranks:
        z2, z3 = r["stages"]["2"], r["stages"]["3"]
        pad = z2["n_leaves"]
        if abs(z2["acc_numel"] - z2["numel"] / 2) > pad:
            fail(f"phase 33 rank {r['rank']}: the stage-2 accumulator holds "
                 f"{z2['acc_numel']} of {z2['numel']} elements, not half")
        if z3["partitioned_leaf_bytes"] == 0 or abs(
                z3["partitioned_param_bytes"]
                - z3["partitioned_leaf_bytes"] / 2) > 2 * pad:
            fail(f"phase 33 rank {r['rank']}: {z3['partitioned_param_bytes']}"
                 f" bytes of partitioned parameters, not half of "
                 f"{z3['partitioned_leaf_bytes']}")
        # the whole compute copies of the partitioned leaves are freed, not
        # kept beside the shards (kept, stage 3 would hold more than stage
        # 2); the allocator's block rounding moves each side by up to a MB
        # a large tensor, so the gate asks for half the saving
        saved = z3["partitioned_leaf_bytes"] - z3["partitioned_param_bytes"]
        print(f"phase33 rank={r['rank']} engine state stage 2 - stage 3: "
              f"{z2['state_allocated'] - z3['state_allocated']} B (the "
              f"partitioned bf16 leaves' other half: {saved} B; gate half "
              f"of that)", flush=True)
        if z2["state_allocated"] - z3["state_allocated"] < saved / 2:
            fail(f"phase 33 rank {r['rank']}: stage 3's engine holds "
                 f"{z3['state_allocated']} B on the card, stage 2's "
                 f"{z2['state_allocated']}: not {saved} B less")
        # a block's gathered weights die with its checkpointed forward: the
        # card grows by the block's saved activations a block, as at stage
        # 2, not by those and the block's whole bf16 weights
        kept = z3["block_growth"] - z2["block_growth"]
        print(f"phase33 rank={r['rank']} stage-3 growth a block beyond "
              f"stage 2's: {kept} B (a block's gathered weights: "
              f"{z3['block_gathered_bytes']} B; gate half of that)",
              flush=True)
        if not z3["block_gathered_bytes"] or \
                kept > z3["block_gathered_bytes"] / 2:
            fail(f"phase 33 rank {r['rank']}: the card grows {kept} B a "
                 f"block more at stage 3 than at stage 2: the gathered "
                 f"weights ({z3['block_gathered_bytes']} B a block) outlive "
                 f"their block")
    return {stage: ranks[0]["stages"][str(stage)]["launches"]
            for stage in (2, 3)}


def _host_group(torch, comm):
    """The group for phase 52's host run: the world over gloo, or a gloo
    group beside NCCL (NCCL moves no host tensor)."""
    if torch.distributed.get_backend() == "gloo":
        return None
    world = comm.get_world_size()
    return comm.CommGroup(axes=("dp",), ranks=tuple(range(world)),
                          group=torch.distributed.new_group(
                              list(range(world)), backend="gloo"))


def plain_compressed(torch, np, comm, corrected, server_error, group=None):
    """The 1-bit exchange written out plainly, for phase 52: every rank's
    corrected buffer (buffer + worker error) and server error all-gathered
    whole, then the worker and server compression of every chunk done
    here, the sign bits packed by numpy (``packbits``, little bit order).
    Returns this rank's (average, new worker error, new server error,
    phase-1 sign bytes, server sign bytes)."""
    world, rank = comm.get_world_size(group), comm.get_rank()
    everyone = comm.all_gather(corrected, group=group)        # [world, n]
    servers = comm.all_gather(server_error, group=group)
    n = corrected.numel()
    chunk = n // world

    def rms(x):
        norm = torch.linalg.vector_norm(x, dtype=torch.float64).float()
        return norm / torch.sqrt(torch.tensor(float(x.numel()),
                                              device=x.device))

    def pm1(x):
        return torch.where(x >= 0, 1.0, -1.0)
    scales = [rms(everyone[r]) for r in range(world)]
    new_worker = corrected - scales[rank] * pm1(corrected)
    out, server_bits, new_server = [], [], None
    for s in range(world):
        m = torch.zeros(chunk, device=corrected.device)
        for r in range(world):
            m = m + (scales[r] / world) * pm1(
                everyone[r, s * chunk:(s + 1) * chunk])
        m = m + servers[s]
        scale = rms(m)
        out.append(scale * pm1(m))
        server_bits.append((m >= 0).cpu().numpy())
        if s == rank:
            new_server = m - scale * pm1(m)
    return (torch.cat(out), new_worker, new_server,
            np.packbits((corrected >= 0).cpu().numpy(), bitorder="little"),
            np.packbits(np.concatenate(server_bits), bitorder="little"))


def _gap(got, want, rms) -> float:
    return float((got.to(want.device) - want).abs().max()) / rms


def compressed_rank(torch, np, dev, seed):
    """Phase 52 at this rank: COMPRESSED_CALLS compressed all-reduces in a
    row on the card at GPT-2 125M's padded size (buffers and starting
    error buffers from ``seed``, this rank's own), each held to
    ``plain_compressed`` on the same inputs; then the same calls on host
    copies of the same inputs. Returns each call's ms, the bytes this
    rank sent and received, the gaps (over the input's rms), whether the
    sign bytes agree, and a digest of the average."""
    import collections
    import hashlib
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm import compressed as cp
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m
    t_start = time.perf_counter()
    world, rank = comm.get_world_size(), comm.get_rank()
    cfg = gpt2_125m(max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16)
    n = sum(p.numel() for p in GPT(cfg, device="meta").parameters())
    npad = cp.padded_size(n, world)
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    bufs = [torch.randn(npad, generator=gen, device=dev)
            for _ in range(COMPRESSED_CALLS)]
    we = 0.1 * torch.randn(npad, generator=gen, device=dev)
    se = 0.1 * torch.randn(npad // world, generator=gen, device=dev)
    host_we, host_se = we.cpu(), se.cpu()
    calls, outs = [], []
    for buf in bufs:
        rms = float(buf.square().mean().sqrt())
        corrected = buf + we
        signs = cp.pack_signs(corrected >= 0).cpu().numpy()
        want = plain_compressed(torch, np, comm, corrected, se)
        del corrected
        before = collections.Counter(cp.WIRE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, we, se = cp.compressed_allreduce(buf, we, se)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        wire = collections.Counter(cp.WIRE) - before
        server = cp.pack_signs(res >= 0).cpu().numpy()
        calls.append({
            "ms": ms, "sent": wire["sent"], "received": wire["received"],
            "plain_gap": max(_gap(res, want[0], rms), _gap(we, want[1], rms),
                             _gap(se, want[2], rms)),
            "plain_signs_equal": bool(np.array_equal(signs, want[3])
                                      and np.array_equal(server, want[4])),
            "digest": hashlib.sha1(res.cpu().numpy().tobytes()).hexdigest()})
        outs.append((res.cpu(), we.cpu(), se.cpu(), signs, server, rms))
        del want, res
    # the same calls on host copies of the same inputs
    group = _host_group(torch, comm)
    for c, buf in enumerate(bufs):
        host = buf.cpu()
        res, we_c, se_c, signs, server, rms = outs[c]
        corrected = host + host_we
        signs_host = cp.pack_signs(corrected >= 0).numpy()
        del corrected
        t0 = time.perf_counter()
        hres, host_we, host_se = cp.compressed_allreduce(host, host_we,
                                                         host_se, group)
        calls[c]["host_s"] = time.perf_counter() - t0
        calls[c]["host_gap"] = max(_gap(hres, res, rms),
                                   _gap(host_we, we_c, rms),
                                   _gap(host_se, se_c, rms))
        calls[c]["host_signs_equal"] = bool(
            np.array_equal(signs_host, signs)
            and np.array_equal(cp.pack_signs(hres >= 0).numpy(), server))
    return {"n": n, "npad": npad, "calls": calls,
            "wall_s": time.perf_counter() - t_start}


def _int_sum(torch, x) -> int:
    """A checksum of an f32 tensor's bits: the sum of its int32 views."""
    return int(x.view(torch.int32).sum(dtype=torch.int64))


def onebit_rank(torch, np, dev, seed):
    """Phase 53 at this rank: each optimizer of ONEBIT_RUNS trains GPT-2
    125M (gpt2_125m_zero1's model, micro 4 a rank x RESUME_GAS on phase
    29's micro-batches, ZeRO-1, lr ONEBIT_LR) for its modes' steps, each
    step under torch.profiler; then the dense engine (AdamW without bias
    correction, ZeRO 0) takes OneBitAdam's two warmup steps. Returns per
    run and step the loss, mode, seconds, device busy seconds, checksums
    of the master and the worker error, the largest |delta|, the bytes
    this rank put on and took off the wire; the launches, the wire
    accounting and peak memory; the warmup's gap to the dense masters."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.comm import compressed as cp
    from deepspeed_tpu_torch.ops.cuda import _build
    t_start = time.perf_counter()
    base = dict(TRAIN_CONFIG, gradient_accumulation_steps=RESUME_GAS,
                train_micro_batch_size_per_gpu=TRAIN_MICRO // 2)
    runs, warm = {}, None
    for kind, (params, modes) in ONEBIT_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak(torch, dev)
        engine, cfg = _gpt2_engine(torch, dev, seed, dict(
            base, optimizer={"type": kind, "params": dict(
                lr=ONEBIT_LR, weight_decay=ONEBIT_WD, **params)}))
        run = engine._onebit
        micros = resume_micros(np, seed, cfg.vocab_size, steps=len(modes))
        rec = collections.defaultdict(list)
        _build.reset_launch_counts()
        for step in range(len(modes)):
            before = collections.Counter(cp.WIRE)
            dense = run.comm_bytes["dense"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                loss = engine.train_batch(iter(
                    micros[RESUME_GAS * step:RESUME_GAS * (step + 1)]))
                torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t0)
            rec["busy_s"].append(sum(_device_us(e) for e in
                                     prof.key_averages()) / 1e6)
            wire = collections.Counter(cp.WIRE) - before
            rec["losses"].append(float(loss))
            rec["modes"].append(run.last_mode)
            rec["master_sum"].append(_int_sum(torch, run.master))
            rec["worker_error_sum"].append(
                _int_sum(torch, run.state["worker_error"]))
            rec["delta_max"].append(float(run.state["delta"].abs().max())
                                    if "delta" in run.state else None)
            rec["wire_compressed"].append(wire["sent"] + wire["received"])
            rec["wire_dense"].append(run.comm_bytes["dense"] - dense)
            if kind == "OneBitAdam" and step == 1:
                warm = torch.cat([p.detach().reshape(-1)
                                  for p in engine.master])
        rec.update(launches={k: _build.LAUNCHES[k] for k in FLASH},
                   ratio=run.compression_ratio(), n=run.n,
                   npad=run.opt.npad, layers=cfg.num_layers,
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        runs[kind] = dict(rec)
        del engine, run
    gc.collect()
    torch.cuda.empty_cache()
    engine, cfg = _gpt2_engine(torch, dev, seed, dict(
        base, zero_optimization={"stage": 0}, optimizer={
            "type": "AdamW", "params": {"lr": ONEBIT_LR,
                                        "weight_decay": ONEBIT_WD,
                                        "bias_correction": False}}))
    micros = resume_micros(np, seed, cfg.vocab_size, steps=2)
    dense_losses, _ = _train_steps(torch, engine, micros, 0, 2)
    gap = (torch.cat([p.detach().reshape(-1) for p in engine.master])
           - warm).abs()
    runs["warmup_vs_dense"] = {
        "losses": dense_losses, "max": float(gap.max()),
        "over": {str(f): int((gap > f * ONEBIT_LR).sum())
                 for f in (1e-3, 1e-2, 1e-1, 1.0)}}
    del engine, warm, gap
    runs["wall_s"] = time.perf_counter() - t_start
    return runs


def phase_compressed(card, ranks):
    """Phase 52 (run in phase 30's rank processes): every call's average,
    worker and server error within COMPRESSED_TOL of the plain exchange's
    and of the host run's, their sign bytes equal, the average the same
    bits on both ranks, and each rank's bytes sent and received equal to
    wire_bytes_compressed(npad, 2)."""
    from deepspeed_tpu_torch.comm.compressed import (wire_bytes_compressed,
                                                     wire_bytes_dense)
    for r in ranks:
        got = r["compressed"]
        npad, n = got["npad"], got["n"]
        for c, call in enumerate(got["calls"]):
            print(f"phase52 compressed_allreduce rank={r['rank']} call={c} "
                  f"n={n} npad={npad} ms={call['ms']} host_s="
                  f"{call['host_s']} sent={call['sent']} received="
                  f"{call['received']} wire_bytes_compressed(npad, 2)="
                  f"{wire_bytes_compressed(npad, 2)} wire_bytes_dense(n, 2)="
                  f"{wire_bytes_dense(n, 2)} plain_gap={call['plain_gap']} "
                  f"host_gap={call['host_gap']} (of the input's rms; bound "
                  f"{COMPRESSED_TOL}) card={card}", flush=True)
            if not (call["plain_signs_equal"] and call["host_signs_equal"]):
                fail(f"phase 52 rank {r['rank']} call {c}: sign bytes equal "
                     f"to the plain exchange's: {call['plain_signs_equal']}, "
                     f"to the host run's: {call['host_signs_equal']}")
            if max(call["plain_gap"], call["host_gap"]) > COMPRESSED_TOL:
                fail(f"phase 52 rank {r['rank']} call {c}: gap "
                     f"{call['plain_gap']} / {call['host_gap']} over "
                     f"{COMPRESSED_TOL}")
            if call["sent"] + call["received"] != \
                    wire_bytes_compressed(npad, 2):
                fail(f"phase 52 rank {r['rank']}: {call['sent']} + "
                     f"{call['received']} B on the wire, not "
                     f"{wire_bytes_compressed(npad, 2)}")
        print(f"phase_wall 52 (rank {r['rank']}) seconds={got['wall_s']}",
              flush=True)
    for a, b in zip(*(r["compressed"]["calls"] for r in ranks)):
        if a["digest"] != b["digest"]:
            fail("phase 52: the ranks' averages differ")


def _onebit_want(kind, rec):
    """What a run's records must show: the B1 / B1b launches, the
    compression ratio for its modes, the wire bytes a step."""
    from deepspeed_tpu_torch.comm.compressed import (wire_bytes_compressed,
                                                     wire_bytes_dense)
    modes = ONEBIT_RUNS[kind][1]
    bwd = rec["layers"] * RESUME_GAS * len(modes)
    comp = wire_bytes_compressed(rec["npad"], 2)
    dense = wire_bytes_dense(rec["n"], 2)
    compressed = [m in ("comp", "grad_comp", "sync") for m in modes]
    wire = [(comp if c else 0, dense if m in ("warmup", "dense") else 0)
            for c, m in zip(compressed, modes)]
    ratio = len(modes) * dense / sum(a + b for a, b in wire)
    return ({"flash_fwd": 2 * bwd, "flash_bwd_dq": bwd,
             "flash_bwd_dkv": bwd}, ratio, wire)


def phase_onebit(card, ranks):
    """Phase 53 (run in phase 30's rank processes): gates on each 1-bit
    optimizer's run (see ``onebit_rank``). Returns rank 0's B1 / B1b
    launches over the three runs."""
    for kind, (params, modes) in ONEBIT_RUNS.items():
        recs = [r["onebit"][kind] for r in ranks]
        launches, ratio, wire = _onebit_want(kind, recs[0])
        for r, rec in zip(ranks, recs):
            for step, mode in enumerate(modes):
                print(f"phase53 {kind} {params} rank={r['rank']} step="
                      f"{step + 1} mode={rec['modes'][step]} loss="
                      f"{rec['losses'][step]} step_s={rec['step_s'][step]} "
                      f"device_busy_share="
                      f"{rec['busy_s'][step] / rec['step_s'][step]} "
                      f"wire_bytes={rec['wire_compressed'][step]} "
                      f"(compressed) + {rec['wire_dense'][step]} (dense) "
                      f"card={card}", flush=True)
            print(f"phase53 {kind} rank={r['rank']} launches="
                  f"{rec['launches']} compression_ratio={rec['ratio']} "
                  f"max_memory_allocated={rec['max_memory_allocated']} "
                  f"card={card}", flush=True)
            if rec["modes"] != list(modes):
                fail(f"phase 53 {kind}: modes {rec['modes']}, want {modes}")
            if not all(math.isfinite(x) for x in rec["losses"]):
                fail(f"phase 53 {kind}: losses {rec['losses']}")
            if rec["launches"] != launches:
                fail(f"phase 53 {kind} rank {r['rank']}: launches "
                     f"{rec['launches']}, want {launches}")
            if abs(rec["ratio"] - ratio) > 1e-9 * ratio:
                fail(f"phase 53 {kind}: compression ratio {rec['ratio']}, "
                     f"the formula gives {ratio}")
            if [tuple(w) for w in zip(rec["wire_compressed"],
                                      rec["wire_dense"])] != wire:
                fail(f"phase 53 {kind} rank {r['rank']}: wire bytes "
                     f"{rec['wire_compressed']} / {rec['wire_dense']}, "
                     f"want {wire}")
            for step, mode in enumerate(modes):
                delta = rec["delta_max"][step]
                if delta is not None and (delta == 0) != (mode != "local"):
                    fail(f"phase 53 {kind} step {step + 1} ({mode}): "
                         f"max |delta| {delta}")
        a, b = recs
        if a["losses"] != b["losses"]:
            fail(f"phase 53 {kind}: the ranks' losses differ")
        if a["master_sum"] != b["master_sum"]:
            fail(f"phase 53 {kind}: the ranks' masters differ "
                 f"({a['master_sum']} / {b['master_sum']})")
        first = next(i for i, m in enumerate(modes)
                     if m in ("comp", "grad_comp"))
        if a["worker_error_sum"][first] == b["worker_error_sum"][first]:
            fail(f"phase 53 {kind}: the ranks' worker errors are equal "
                 f"after the first compressed step: the gradients were "
                 f"averaged before compression")
    for r in ranks:
        w = r["onebit"]["warmup_vs_dense"]
        print(f"phase53 OneBitAdam warmup vs dense AdamW (no bias "
              f"correction) rank={r['rank']} after 2 steps: max |master "
              f"gap|={w['max']} elements over (x lr): {w['over']} losses "
              f"{r['onebit']['OneBitAdam']['losses'][:2]} vs {w['losses']} "
              f"card={card}", flush=True)
        if w["max"] > ONEBIT_WARM_MAX * ONEBIT_LR or \
                w["over"]["1.0"] > ONEBIT_WARM_LOOSE:
            fail(f"phase 53 rank {r['rank']}: OneBitAdam's warmup leaves "
                 f"the dense AdamW's masters (max {w['max']}, over "
                 f"{w['over']})")
        print(f"phase_wall 53 (rank {r['rank']}) seconds="
              f"{r['onebit']['wall_s']}", flush=True)
    return {name: sum(ranks[0]["onebit"][kind]["launches"][name]
                      for kind in ONEBIT_RUNS) for name in FLASH}


def _cpu_copy(opt):
    """The optimizer on CPU copies of its params and state."""
    import copy
    cpu = copy.copy(opt)
    cpu.__dict__.pop("step", None)          # phase 31's capture hook
    cpu.params = [p.detach().cpu().clone() for p in opt.params]
    for name in opt.STATE:
        setattr(cpu, name, [t.cpu().clone() for t in getattr(opt, name)])
    return cpu


def phase_optimizers(torch, np, dev, seed, card):
    """Phase 31: LAMB, Adagrad and SGD train 3 steps; the third step's
    masters against the same step on the CPU."""
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=1)
    for name, params in OPTIMIZERS.items():
        engine, cfg = _gpt2_engine(
            torch, dev, seed,
            dict(config, optimizer={"type": name, "params": params}))
        ids = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)
        batch = [{"input_ids": ids}]
        opt, seen = engine.optimizer, {}
        step = opt.step

        def capture(grads):
            seen["cpu"] = _cpu_copy(opt)
            seen["grads"] = [g.detach().cpu().clone() for g in grads]
            step(grads)
        losses, secs = [], []
        for i in range(3):
            if i == 2:
                opt.step = capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(iter(batch))))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        opt.step = step
        seen["cpu"].step(seen["grads"])
        err = max(float((p.detach().cpu() - q).abs().max())
                  for p, q in zip(opt.params, seen["cpu"].params))
        atol, rtol = OPT_CPU_TOL
        ok = all(torch.allclose(p.detach().cpu(), q, rtol=rtol, atol=atol)
                 for p, q in zip(opt.params, seen["cpu"].params))
        print(f"phase31 optimizer {name} {params} losses={losses} "
              f"step_s={secs} card_vs_cpu_max_abs_err={err} "
              f"(atol {atol}, rtol {rtol}) card={card}", flush=True)
        del engine, opt, seen, step, capture
        torch.cuda.empty_cache()
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{name}: losses not finite and falling: {losses}")
        if not ok:
            fail(f"{name}: the card's step leaves the CPU's by {err}")


def reset_peak(torch, dev) -> None:
    """Reset the card's peak-memory counter (the allocator exists only
    once a tensor has been allocated on the device)."""
    torch.zeros(1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)


def mem_available() -> int:
    """The host's MemAvailable, in bytes."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def plain_cpu_adamw(torch, np, master, grad, m, v, lr, step,
                    betas=(0.9, 0.999), eps=1e-8):
    """One AdamW step (no weight decay) in plain torch on CPU copies, its
    constants in f32 as the native step computes them."""
    f = np.float32
    b1, b2 = f(betas[0]), f(betas[1])
    m = m * float(b1) + float(f(1) - b1) * grad
    v = v * float(b2) + float(f(1) - b2) * grad * grad
    step_size = f(lr) / (f(1) - np.power(b1, f(step)))
    bc2_sqrt = np.sqrt(f(1) - np.power(b2, f(step)))
    return master - float(step_size) * m / (v.sqrt() / float(bc2_sqrt)
                                             + float(f(eps)))


def _gbps(nbytes, secs):
    return nbytes / secs / 1e9 if secs else None


def phase_zero3_offload(torch, np, dev, seed, card):
    """Phase 32: bench.py's ladder_zero3_offload, GPT-2 1.3B at full width
    from an abstract (meta-device) model, ZeRO-3 + CPU offload at dp 1."""
    import gc
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models.gpt import (GPT, gpt2_1_3b,
                                                gpt_flops_per_token,
                                                lm_loss_fn)
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops.cpu import _build as cpu_build
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.telemetry.mfu import (mfu_report,
                                                   peak_flops_per_device)
    cfg = gpt2_1_3b(max_seq_len=LADDER_SEQ, dtype=torch.bfloat16)
    model = zero.abstract_init(GPT, cfg)
    n = zero.num_params(model)
    need, avail = OFFLOAD_HOST_BYTES * n, mem_available()
    print(f"phase32 ladder_zero3_offload gpt2_1_3b params={n} "
          f"host_bytes_reckoned={need} MemAvailable={avail}", flush=True)
    if avail < need:
        fail(f"phase 32 needs {need} bytes of host memory for {n} "
             f"parameters and MemAvailable is {avail}")
    torch.cuda.empty_cache()
    reset_peak(torch, dev)
    before = torch.cuda.memory_allocated(dev)    # earlier phases' leftovers
    t0 = time.perf_counter()
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=dict(LADDER_CONFIG, seed=seed))
    init_s = time.perf_counter() - t0
    host = engine.host_optimizer
    print(f"phase32 init_s={init_s} (abstract model, counter fill, "
          f"{len(host.leaves)} leaves) host_bytes={host.host_bytes()} "
          f"device_state_bytes={engine.device_state_bytes()} "
          f"openmp_runtimes={cpu_build.loaded_openmp_runtimes()} "
          f"omp_threads={cpu_adam.omp_threads()} torch_threads="
          f"{torch.get_num_threads()} card={card}", flush=True)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LADDER_MICRO, LADDER_SEQ)).astype(np.int32)
    batch = [{"input_ids": ids}] * LADDER_GAS
    k = engine._names.index(MASTER_CHECK_LEAF)
    leaf, seen = host.leaves[k], {}
    real_step = host.opt.step

    def capture(params, grads, exp_avg, exp_avg_sq, **kw):
        if params.data_ptr() == leaf.master.data_ptr():
            seen.update(master=params.clone(), grad=grads.clone(),
                        m=exp_avg.clone(), v=exp_avg_sq.clone(), **kw)
        return real_step(params, grads, exp_avg, exp_avg_sq, **kw)
    engine.offload_timing = {}
    _build.reset_launch_counts()
    losses, secs, splits = [], [], []
    for i in range(3):                 # 1 warm-up + 2 timed steps
        if i == 2:
            host.opt.step = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batch))))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        splits.append(dict(engine.offload_timing, cpu_adam_s=host.adam_s))
    host.opt.step = real_step
    launches = {name: _build.LAUNCHES[name] for name in FLASH}
    peak = torch.cuda.max_memory_allocated(dev)
    live = torch.cuda.memory_allocated(dev) - before
    state = engine.device_state_bytes()
    want_master = plain_cpu_adamw(torch, np, seen["master"], seen["grad"],
                                  seen["m"], seen["v"], seen["lr"],
                                  seen["step"])
    err = float((leaf.master - want_master).abs().max())
    atol, rtol = OPT_CPU_TOL
    master_ok = torch.allclose(leaf.master, want_master, rtol=rtol,
                               atol=atol)
    mirror_ok = torch.equal(
        leaf.mirror.view(torch.int16),
        cpu_adam.f32_to_bf16_bits(leaf.master).view(torch.int16))
    tokens = LADDER_MICRO * LADDER_SEQ * LADDER_GAS
    report = mfu_report(
        flops_per_call=gpt_flops_per_token(cfg, LADDER_SEQ) * tokens,
        calls=2, wall_s=sum(secs[1:]), peak_flops=peak_flops_per_device(dev),
        label="ladder_zero3_offload train_batch")
    print(f"phase32 losses={losses} step_s={secs} launches={launches} "
          f"max_memory_allocated={peak} memory_allocated_after={live} "
          f"(beyond the {before} bytes live before the engine) "
          f"device_state_bytes={state} ({sum(state.values()) / n} B a "
          f"parameter) card={card}", flush=True)
    for i, sp in enumerate(splits):
        print(f"phase32 step{i} split: device_fwd_bwd_s="
              f"{sp.get('device_fwd_bwd_s')} d2h_s={sp.get('d2h_s')} "
              f"d2h_bytes={sp.get('d2h_bytes')} d2h_GBps="
              f"{_gbps(sp.get('d2h_bytes', 0), sp.get('d2h_s'))} "
              f"d2h_wait_s={sp.get('d2h_wait_s')} cpu_adam_s="
              f"{sp['cpu_adam_s']} cpu_adam_bytes={CPU_ADAM_BYTES * n} "
              f"cpu_adam_GBps={_gbps(CPU_ADAM_BYTES * n, sp['cpu_adam_s'])} "
              f"h2d_s={sp.get('h2d_s')} h2d_bytes={sp.get('h2d_bytes')} "
              f"h2d_GBps={_gbps(sp.get('h2d_bytes', 0), sp.get('h2d_s'))} "
              f"host_step_s={sp.get('host_step_s')} update_s="
              f"{sp.get('update_s')} card={card}", flush=True)
    step_s = sum(secs[1:]) / 2
    print(f"phase32 train_tokens_per_s={tokens / step_s} tflops="
          f"{report['achieved_tflops_per_s']} mfu={report['mfu']} "
          f"mfu_report={json.dumps(report)} card={card}", flush=True)
    print(f"phase32 master check {MASTER_CHECK_LEAF}: card_vs_cpu_adamw "
          f"max_abs_err={err} (atol {atol}, rtol {rtol}) mirror_bits_equal="
          f"{mirror_ok}", flush=True)
    host.close()
    del engine, host, leaf, seen, model
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[2] < losses[0]:
        fail(f"phase 32 losses are not finite and falling: {losses}")
    per_step = cfg.num_layers * LADDER_GAS * 3
    want = {"flash_fwd": 2 * per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    if launches != want:
        fail(f"phase 32 flash launches {launches}, expected {want}")
    if sum(state.values()) > OFFLOAD_DEVICE_BYTES * n \
            or live > OFFLOAD_DEVICE_BYTES * n + 2 ** 30:
        fail(f"phase 32: the card holds {state} ({live} bytes live) for {n} "
             f"parameters, more than {OFFLOAD_DEVICE_BYTES} B a parameter")
    if not master_ok or not mirror_ok:
        fail(f"phase 32: {MASTER_CHECK_LEAF}'s master leaves the plain "
             f"AdamW step by {err} (mirror bits equal: {mirror_ok})")
    return launches


def _aio_totals(host):
    opens, nbytes = {}, 0
    for h in host.handles():
        nbytes += h.bytes_read + h.bytes_written
        for mode, c in h.opens.items():
            opens[mode] = opens.get(mode, 0) + c
    return nbytes, opens


def phase_nvme(torch, np, dev, seed, card):
    """Phase 34: phase 29's model with offload_optimizer and offload_param
    on nvme against the cpu tier, then an offload checkpoint resumed."""
    import gc
    from deepspeed_tpu_torch.ops.cuda import _build
    base = dict(TRAIN_CONFIG, gradient_accumulation_steps=RESUME_GAS)
    with tempfile.TemporaryDirectory() as root:
        def nvme(tag):
            return {"stage": 3, "offload_optimizer": {
                "device": "nvme", "nvme_path": os.path.join(root, tag)},
                "offload_param": {"device": "nvme", "nvme_path":
                                  os.path.join(root, tag, "params")}}
        engine, cfg = _gpt2_engine(torch, dev, seed, dict(
            base, zero_optimization={"stage": 3, "offload_optimizer": {
                "device": "cpu"}}))
        micros = resume_micros(np, seed, cfg.vocab_size)
        cpu, cpu_s = _train_steps(torch, engine, micros, 0, 4)
        engine.host_optimizer.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine, _ = _gpt2_engine(torch, dev, seed,
                                 dict(base, zero_optimization=nvme("a")))
        host = engine.host_optimizer
        engine.offload_timing = {}
        first, first_s, moved = [], [], []
        for step in range(2):
            before = _aio_totals(host)[0]
            losses, secs = _train_steps(torch, engine, micros, step, 1)
            first += losses
            first_s += secs
            moved.append((_aio_totals(host)[0] - before,
                          engine.offload_timing.get("host_step_s")))
        t0 = time.perf_counter()
        tag_dir = engine.save_checkpoint(os.path.join(root, "ckpt"),
                                         tag="two")
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tag_dir, f))
                     for f in os.listdir(tag_dir))
        cont, cont_s = _train_steps(torch, engine, micros, 2, 2)
        _, opens = _aio_totals(host)
        host.close()
        del engine, host
        gc.collect()
        torch.cuda.empty_cache()
        fresh, _ = _gpt2_engine(torch, dev, seed + 1,
                                dict(base, zero_optimization=nvme("b")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.load_checkpoint(os.path.join(root, "ckpt"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        resumed, _ = _train_steps(torch, fresh, micros, 2, 2)
        launches = {name: _build.LAUNCHES[name] for name in FLASH}
        fresh.host_optimizer.close()
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase34 nvme tiers gpt2_125m gas={RESUME_GAS} cpu_tier_losses="
          f"{cpu} nvme_losses={first + cont} step_s cpu={cpu_s} "
          f"nvme={first_s + cont_s} card={card}", flush=True)
    for i, (b, s_) in enumerate(moved):
        print(f"phase34 step{i} aio_bytes={b} host_step_s={s_} "
              f"aio_GBps_over_host_step={_gbps(b, s_)} opens={opens} "
              f"O_DIRECT={'yes' if opens.get('O_DIRECT') else 'no'} "
              f"card={card}", flush=True)
    print(f"phase34 offload checkpoint_save_s={save_s} checkpoint_load_s="
          f"{load_s} checkpoint_bytes={nbytes} resumed={resumed} "
          f"resumed_launches={launches} card={card}", flush=True)
    if first != cpu[:2]:
        fail(f"phase 34: the nvme tiers' losses {first} are not bitwise the "
             f"cpu tier's {cpu[:2]}")
    if resumed != cont:
        fail(f"phase 34: resumed losses {resumed} are not bitwise the "
             f"uninterrupted {cont}")
    if min(launches.values()) == 0:
        fail(f"phase 34: the resumed steps launched no flash kernel: "
             f"{launches}")


# phase 35: the streamed engine against the plain offload engine at GPT
# 2.7B's width (d_model 2560, 32 heads of 80, d_ff 10240; 4 layers), bf16,
# micro 1 x gas 2 x seq 1024 (the capacity config with gas 2, so the host
# adds a second micro-batch's grads), 3 steps from one counter fill
PARITY_LAYERS, PARITY_GAS, PARITY_STEPS = 4, 2, 3
# phase 36: cpu_checkpointing against remat (policy "nothing": both save
# only the block input, one in host memory, one on the card), GPT-2 125M,
# micro 8 x seq 1024 x gas 1, 2 steps
CKPT_STEPS = 2
# phase 37: bench.py's capacity_streamed (bench.py:402-480): its menu and
# pick rule (bench.py:420-448; _cfg_params bench.py:199), copied here
CAPACITY_SEQ = 1024
CAPACITY_CONFIG = {"train_micro_batch_size_per_gpu": 1,
                   "gradient_accumulation_steps": 1,
                   "bf16": {"enabled": True},
                   "zero_optimization": {
                       "stage": 1,
                       "offload_optimizer": {"device": "cpu"},
                       "offload_param": {"layer_streaming": True}},
                   "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                   "steps_per_print": 100_000}
CAPACITY_HOST_SHARE = 0.45     # bench.py:437-438: a wide margin on a shared
CAPACITY_BYTES_PER_PARAM = 16  # host; master, moments and grads
# memory_allocated before and after a streamed step: equal up to the
# returned loss tensor and the allocator's rounding of small blocks
CAPACITY_MEM_SLACK = 1 << 20


def capacity_menu(torch):
    """bench.py's menu (bench.py:420-430), largest first."""
    from deepspeed_tpu_torch.models.gpt import GPTConfig, gpt_neox_6_7b
    return [
        ("gpt_neox_6.7b", gpt_neox_6_7b(max_seq_len=CAPACITY_SEQ,
                                        dtype=torch.bfloat16)),
        ("gpt_2.7b", GPTConfig(num_layers=32, num_heads=32, d_model=2560,
                               d_ff=10240, max_seq_len=CAPACITY_SEQ,
                               dtype=torch.bfloat16)),
        ("gpt2_1.3b", GPTConfig(num_layers=24, num_heads=32, d_model=2048,
                                d_ff=8192, max_seq_len=CAPACITY_SEQ,
                                dtype=torch.bfloat16)),
    ]


def bench_cfg_params(cfg) -> int:
    """bench.py's ``_cfg_params`` (bench.py:199), the pick's measure."""
    return ((12 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff)
            * cfg.num_layers + cfg.vocab_size * cfg.d_model
            + cfg.max_seq_len * cfg.d_model)


def _free_engine(torch, engine) -> None:
    import gc
    engine.host_optimizer.close()
    st = getattr(engine, "_layer_streamer", None)
    if st is not None:
        st.close_io()
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def _stream_engine(torch, cfg, config, seed):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models.gpt import GPT, lm_loss_fn
    model = zero.abstract_init(GPT, cfg)
    engine, *_ = dst.initialize(model=model, loss_fn=lm_loss_fn,
                                config=dict(config, seed=seed))
    return engine


def phase_streamed_parity(torch, np, dev, seed, card):
    """Phase 35: the layer-streamed engine against the plain offload
    engine (stage 1, offload_optimizer cpu) at GPT 2.7B's width, 4 layers,
    from one counter fill: bitwise losses (the same kernels on the same
    inputs; the block grads summed in f32 on the host instead of the card,
    the same IEEE sums)."""
    import dataclasses
    from deepspeed_tpu_torch.ops.cuda import _build
    cfg = dataclasses.replace(capacity_menu(torch)[1][1],
                              num_layers=PARITY_LAYERS)
    plain_cfg = dict(CAPACITY_CONFIG, gradient_accumulation_steps=PARITY_GAS,
                     zero_optimization={"stage": 1, "offload_optimizer": {
                         "device": "cpu"}})
    stream_cfg = dict(CAPACITY_CONFIG,
                      gradient_accumulation_steps=PARITY_GAS)
    rng = np.random.default_rng(seed)
    micros = [{"input_ids": rng.integers(0, cfg.vocab_size, (
        1, CAPACITY_SEQ)).astype(np.int32)} for _ in range(PARITY_GAS)]
    result = {}
    for tag, config in (("plain", plain_cfg), ("streamed", stream_cfg)):
        engine = _stream_engine(torch, cfg, config, seed)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        losses, secs = [], []
        for _ in range(PARITY_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(iter(micros))))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = {name: _build.LAUNCHES[name] for name in FLASH}
        st = engine._layer_streamer
        counts = None if st is None else (st.fetches, st.emits,
                                          st.peak_buffer_sets)
        result[tag] = (losses, secs, launches, counts)
        print(f"phase35 {tag} gpt_2.7b width x {PARITY_LAYERS} layers "
              f"(d 80) micro 1 x gas {PARITY_GAS} losses={losses} "
              f"step_s={secs} launches={launches} (fetches, emits, "
              f"buffer sets)={counts} card={card}", flush=True)
        _free_engine(torch, engine)
    plain, streamed = result["plain"][0], result["streamed"][0]
    L, n = PARITY_LAYERS, PARITY_GAS * PARITY_STEPS
    want = {"flash_fwd": 2 * L * n, "flash_bwd_dq": L * n,
            "flash_bwd_dkv": L * n}
    if plain != streamed:
        fail(f"phase 35: streamed losses {streamed} are not bitwise the "
             f"plain offload engine's {plain}")
    launches = result["streamed"][2]
    if launches != want:
        fail(f"phase 35 streamed flash launches {launches}, expected {want}")
    if result["streamed"][3] != (2 * L * n, L * n, 2):
        fail(f"phase 35: (fetches, emits, buffer sets) "
             f"{result['streamed'][3]}, expected {(2 * L * n, L * n, 2)}")
    return launches


def phase_cpu_checkpointing(torch, np, dev, seed, card):
    """Phase 36: GPT-2 125M with activation_checkpointing.cpu_checkpointing
    against remat, the card's bytes after each block's first forward."""
    import dataclasses
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt2_125m, lm_loss_fn
    cfg = gpt2_125m(max_seq_len=TRAIN_SEQ, dtype=torch.bfloat16,
                    remat_policy="nothing")
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_MICRO, TRAIN_SEQ)).astype(np.int32)
    block_bytes = TRAIN_MICRO * TRAIN_SEQ * cfg.d_model * 2
    result = {}
    for tag, extra in (("remat", {}), ("cpu_checkpointing", {
            "activation_checkpointing": {"cpu_checkpointing": True}})):
        model = GPT(cfg, device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        engine, *_ = dst.initialize(
            model=model, loss_fn=lm_loss_fn,
            config=dict(TRAIN_CONFIG, gradient_accumulation_steps=1,
                        **extra))
        marks, hooks = [], []
        for blk in engine.compute_module.blocks:
            hooks.append(blk.register_forward_hook(
                lambda *a: marks.append(torch.cuda.memory_allocated(dev))
                if len(marks) < cfg.num_layers else None))
        losses, secs = [], []
        for _ in range(CKPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(iter([{
                "input_ids": ids}]))))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        for h in hooks:
            h.remove()
        growth = [b - a for a, b in zip(marks, marks[1:])]
        result[tag] = (losses, sorted(growth)[len(growth) // 2])
        print(f"phase36 {tag} gpt2_125m micro {TRAIN_MICRO} x seq "
              f"{TRAIN_SEQ} losses={losses} step_s={secs} memory_allocated "
              f"after each block's first forward={marks} (median growth a "
              f"block {result[tag][1]}; one block input is {block_bytes} "
              f"bytes) cpu_checkpointing={engine.module.cfg.cpu_checkpointing}"
              f" card={card}", flush=True)
        del engine, model
        torch.cuda.empty_cache()
    (remat, g_remat), (cpu, g_cpu) = result["remat"], result[
        "cpu_checkpointing"]
    if remat != cpu or not all(np.isfinite(cpu)):
        fail(f"phase 36: cpu_checkpointing losses {cpu} are not bitwise "
             f"remat's {remat}")
    if not g_cpu < block_bytes <= g_remat * 1.1:
        fail(f"phase 36: the card grew {g_cpu} bytes a block under "
             f"cpu_checkpointing and {g_remat} under remat (one block input "
             f"is {block_bytes})")


def phase_capacity_streamed(torch, np, dev, seed, card, model=None):
    """Phase 37: bench.py's capacity_streamed through the port's entry
    points: the menu's largest model whose host bytes fit, full width and
    depth, layer-streamed, 1 warm-up and 2 timed steps and one eval.
    ``model`` names a menu entry to train instead of the pick
    (``tools/time_capacity.py --model``)."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models.gpt import gpt_flops_per_token
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.telemetry.mfu import (mfu_report,
                                                   peak_flops_per_device)
    host = mem_available()
    menu = capacity_menu(torch)
    pick = next(((name, c) for name, c in menu if bench_cfg_params(c)
                 * CAPACITY_BYTES_PER_PARAM < host * CAPACITY_HOST_SHARE),
                None)
    print(f"phase37 capacity_streamed MemAvailable={host} menu="
          f"{[(name, bench_cfg_params(c)) for name, c in menu]} pick="
          f"{pick and pick[0]} (bench's rule: _cfg_params x "
          f"{CAPACITY_BYTES_PER_PARAM} < {CAPACITY_HOST_SHARE} x "
          f"MemAvailable)", flush=True)
    if model is not None:
        pick = next((e for e in menu if e[0] == model), None)
        if pick is None:
            fail(f"phase 37: no menu entry {model!r}")
        print(f"phase37 training {model} instead of the pick", flush=True)
    if pick is None:
        need = bench_cfg_params(menu[-1][1]) * CAPACITY_BYTES_PER_PARAM
        fail(f"phase 37: the smallest menu model needs {need} bytes of host "
             f"memory, {CAPACITY_HOST_SHARE} x MemAvailable is "
             f"{host * CAPACITY_HOST_SHARE}")
    name, cfg = pick
    torch.cuda.empty_cache()
    reset_peak(torch, dev)
    t0 = time.perf_counter()
    engine = _stream_engine(torch, cfg, CAPACITY_CONFIG, seed)
    init_s = time.perf_counter() - t0
    n = zero.num_params(engine.module)
    st, hopt = engine._layer_streamer, engine.host_optimizer
    print(f"phase37 {name} params={n} layers={cfg.num_layers} d_model="
          f"{cfg.d_model} heads={cfg.num_heads} (d {cfg.head_dim}) init_s="
          f"{init_s} host_bytes={hopt.host_bytes()} block_numel="
          f"{st.block_numel} omp_threads={cpu_adam.omp_threads()} "
          f"card={card}", flush=True)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, CAPACITY_SEQ)).astype(np.int32)
    batch = [{"input_ids": ids}]
    engine.offload_timing = {}
    losses, secs, splits, steady = [], [], [], []
    _build.reset_launch_counts()
    for _ in range(3):                 # 1 warm-up + 2 timed steps
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batch))))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        steady.append(torch.cuda.memory_allocated(dev) - before)
        splits.append(dict(engine.offload_timing, cpu_adam_s=hopt.adam_s))
    launches = {k: _build.LAUNCHES[k] for k in FLASH}
    peak = torch.cuda.max_memory_allocated(dev)
    fetched = st.fetches
    ev_loss = float(engine.eval_batch({"input_ids": ids}))
    eval_fetches = st.fetches - fetched
    tokens = CAPACITY_SEQ
    step_s = sum(secs[1:]) / 2
    report = mfu_report(
        flops_per_call=gpt_flops_per_token(cfg, CAPACITY_SEQ) * tokens,
        calls=2, wall_s=sum(secs[1:]), peak_flops=peak_flops_per_device(dev),
        label="capacity_streamed train_batch")
    print(f"phase37 losses={losses} step_s={secs} launches={launches} "
          f"fetches={fetched} emits={st.emits} peak_buffer_sets="
          f"{st.peak_buffer_sets} max_memory_allocated={peak} "
          f"memory_allocated_change_a_step={steady} eval_loss={ev_loss} "
          f"eval_fetches={eval_fetches} card={card}", flush=True)
    for i, sp in enumerate(splits):
        print(f"phase37 step{i} split: device_fwd_bwd_s="
              f"{sp.get('device_fwd_bwd_s')} h2d_s={sp.get('h2d_s')} "
              f"h2d_bytes={sp.get('h2d_bytes')} h2d_GBps="
              f"{_gbps(sp.get('h2d_bytes', 0), sp.get('h2d_s'))} d2h_s="
              f"{sp.get('d2h_s')} d2h_bytes={sp.get('d2h_bytes')} d2h_GBps="
              f"{_gbps(sp.get('d2h_bytes', 0), sp.get('d2h_s'))} cpu_adam_s="
              f"{sp['cpu_adam_s']} cpu_adam_bytes={CPU_ADAM_BYTES * n} "
              f"cpu_adam_GBps={_gbps(CPU_ADAM_BYTES * n, sp['cpu_adam_s'])} "
              f"host_norm_s={sp.get('host_norm_s')} host_step_s="
              f"{sp.get('host_step_s')} update_s={sp.get('update_s')} "
              f"card={card}", flush=True)
    print(f"phase37 capacity_streamed {name} params={n} step_s={step_s} "
          f"tokens_per_s={tokens / step_s} tflops="
          f"{report['achieved_tflops_per_s']} mfu={report['mfu']} "
          f"mfu_report={json.dumps(report)} card={card}", flush=True)
    L = cfg.num_layers
    _free_engine(torch, engine)
    if not all(np.isfinite(losses)) or not np.isfinite(ev_loss):
        fail(f"phase 37: non-finite losses {losses} / eval {ev_loss}")
    if st.peak_buffer_sets > 2:
        fail(f"phase 37: the streamer held {st.peak_buffer_sets} device "
             f"block buffer sets")
    if max(abs(d) for d in steady[1:]) > CAPACITY_MEM_SLACK:
        fail(f"phase 37: memory_allocated changed by {steady} bytes over a "
             f"step (the card must hold nothing of the model between steps)")
    want = {"flash_fwd": 2 * L * 3, "flash_bwd_dq": L * 3,
            "flash_bwd_dkv": L * 3}
    if launches != want:
        fail(f"phase 37 flash launches {launches}, expected {want}")
    if eval_fetches != L:
        fail(f"phase 37: the eval fetched {eval_fetches} blocks, not {L}")
    return launches, name, cfg.head_dim


_LAP = [0.0]


def lap(label: str) -> None:
    """Print the wall seconds since the previous lap (or the start of
    ``main``) on a line of its own, labelled by the phases they cover."""
    now = time.perf_counter()
    print(f"phase_wall {label} seconds={now - _LAP[0]}", flush=True)
    _LAP[0] = now


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one rank of phase 30 (the script starts them itself)
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dp-stages", default="1", help=argparse.SUPPRESS)
    ap.add_argument("--dp-onebit", default="", help=argparse.SUPPRESS)
    # one rank of phase 44
    ap.add_argument("--ep-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    # one rank of phase 45 or 46
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-phase", default="45", help=argparse.SUPPRESS)
    # one rank of phase 48
    ap.add_argument("--sp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    # one rank of phases 50-51
    ap.add_argument("--pipe-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--pipe-phases", default="50,51", help=argparse.SUPPRESS)
    ap.add_argument("--pipe-m", type=int, default=PIPE_M,
                    help=argparse.SUPPRESS)
    # phase 48's ranks then run phases 50-51's
    ap.add_argument("--then-pipe", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.dp_rank is not None:
        return dp_rank_main(args)
    if args.ep_rank is not None:
        return ep_rank_main(args)
    if args.tp_rank is not None:
        return tp_rank_main(args)
    if args.sp_rank is not None:
        return sp_rank_main(args)
    if args.pipe_rank is not None:
        return pipe_rank_main(args)
    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import gelu as gl
    from deepspeed_tpu_torch.ops.cuda import layer_norm as ln
    from deepspeed_tpu_torch.ops.cuda import sampling as sp
    from deepspeed_tpu_torch.ops.cuda import softmax as sm
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
    from deepspeed_tpu_torch.ops import quantizer as qz

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    _LAP[0] = t_start
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the library's cuobjdump dumps run beside the phases; phase 1's
    # register and SASS checks read them at the end
    start_dumps(_build)
    lap("1 build")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    da_err, decode_inputs = phase_decode_attention(torch, da, dev, gen)
    verify_err, _ = phase_verify_parity(torch, da, qz, dev, gen)
    sq16_err = case_parity(torch, da, qz, dev, gen, **SQ16_CASE)[0]
    d80_err = case_parity(torch, da, qz, dev, gen, **D80_CASE)[0]
    phase_piece_parity(torch, da, qz, dev, gen)
    lap("2 decode parity")
    logits, sp_err = phase_sampling(torch, sp, dev, gen)
    flash_err, flash_inputs, flash_err_d80 = phase_flash_parity(torch, fa,
                                                                dev, gen)
    lap("3,7 sampling+flash parity")
    launches, ie, prompts, serve_kw = phase_serving(torch, np, dev,
                                                   args.seed, card)
    lap("4,6 serving")
    (da_t, da_bound, da_by), (sp_t, sp_bound, sp_by) = phase_timing(
        torch, da, qz, sp, dev, gen, decode_inputs, logits, card)
    verify_t = verify_timing(torch, da, qz, dev, gen, card)
    sq16_t = verify_timing(torch, da, qz, dev, gen, card, **SQ16_CASE)
    d80_t = verify_timing(torch, da, qz, dev, gen, card, **D80_CASE)
    filter_t, filter_err = filter_timing(torch, sp, dev, gen, card)
    lap("5 decode/sampling timing")
    torch.cuda.empty_cache()
    phase_sampled_serving(torch, ie, prompts, serve_kw, args.seed, card)
    spec_launches = phase_spec_serving(torch, dev, ie, prompts, serve_kw,
                                       card)
    filter_launches = phase_spec_sampled(torch, ie, prompts, serve_kw,
                                         args.seed, card)
    phase_serve_loop(torch, ie, prompts, serve_kw, card)
    lap("25-28 sampled/spec/serve loop")
    fused_launches = phase_fused_serving(torch, dev, ie, prompts, serve_kw,
                                         card)
    route_launches = phase_sp_route(torch, dev, ie, prompts, serve_kw, card)
    lap("38,49 fused prefill+sp route")
    del ie
    torch.cuda.empty_cache()
    d80_launches = phase_d80_serving(torch, np, dev, args.seed, prompts,
                                     serve_kw, card)
    lap("39 d80 serving")
    neo = phase_neo_serving(torch, np, dev, args.seed, prompts, serve_kw,
                            card)
    neo_int8 = phase_neo_int8(torch, np, dev, neo, serve_kw, card)
    neo_rows = neo["rows"]
    lap("40-41 neo")
    del neo
    torch.cuda.empty_cache()
    moe = phase_moe_serving(torch, np, dev, args.seed, prompts, serve_kw,
                            card)
    lap("42 moe serving")
    moe_train = phase_moe_training(torch, np, dev, args.seed, card)
    lap("43 moe training")
    launches_ep = phase_ep(torch, np, dev, args.seed, card)
    lap("44 ep")
    torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    tp_spawned = run_tp_ranks(args.seed)     # phases 45 and 46's ranks
    neox = phase_tp_serving(torch, np, dev, args.seed, card, tp_spawned)
    lap("45 tp serving (and 46's ranks)")
    neox_train = phase_tp_training(torch, np, dev, args.seed, card,
                                   tp_spawned[0])
    lap("46 tp training")
    torch.cuda.empty_cache()
    ctx, ctx_errs, ctx_t = phase_long_context(torch, np, fa, dev, gen,
                                              args.seed, card)
    lap("47 long_context sp 1")
    sp_runs = phase_sp(args.seed, card, ctx, then_pipe=True)
    lap("48 sp 2 (and 50-51's ranks)")
    torch.cuda.empty_cache()
    pipe_launches, pipe_errs, pipe_t = phase_pipe(
        torch, np, fa, dev, gen, args.seed, card, sp_runs["pipe"])
    lap("50-51 pipeline")
    torch.cuda.empty_cache()
    engine, cfg, ids, launches_train = phase_training(torch, np, dev,
                                                      args.seed, card)
    phase_model_check(torch, dev, engine, cfg, ids)
    phase_train_profile(torch, engine, ids, card)
    lap("8-10 training")
    del engine
    flash_t, flash_t_d80 = phase_flash_timing(torch, fa, dev, gen,
                                              flash_inputs, card)
    del flash_inputs
    lap("11 flash timing")
    torch.cuda.empty_cache()

    sparse_err, sparse_inputs = phase_sparse_parity(torch, sa, dev, gen)
    engine, cfg, ids, launches_long = phase_long_training(torch, np, dev,
                                                          args.seed, card)
    phase_long_model_check(torch, sa, dev, engine, cfg, ids)
    phase_long_profile(torch, engine, ids, card)
    lap("12-15 sparse parity+long training")
    del engine
    torch.cuda.empty_cache()
    sparse_t = phase_sparse_timing(torch, sa, dev, gen, sparse_inputs, card)
    del sparse_inputs
    torch.cuda.empty_cache()
    sparse_d80_err, sparse_d80_t, sparse_d80_launches = phase_sparse_d80(
        torch, np, sa, dev, gen, args.seed, card)
    phase_sparse_bert(torch, np, sa, dev, gen, args.seed)
    lap("16-17 sparse timing+d80+bert")
    torch.cuda.empty_cache()

    paged_err = phase_paged_parity(torch, da, qz, dev, gen)
    launches_paged, ie, prompts, bf16_tokens = phase_paged_serving(
        torch, np, dev, args.seed, card)
    launches_int8 = phase_int8_serving(torch, np, dev, ie, prompts,
                                       bf16_tokens, card)
    lap("18-20 paged+int8")
    del ie
    torch.cuda.empty_cache()
    paged_t = phase_paged_timing(torch, da, qz, dev, gen, decode_inputs,
                                 card)
    del decode_inputs
    lap("21 paged timing")
    torch.cuda.empty_cache()

    row_err, row_inputs = phase_rowwise_parity(torch, ln, gl, sm, dev, gen)
    launches_gelu = phase_gelu_entry(torch, dev, gen)
    torch.cuda.empty_cache()
    engine, batch, launches_layer = phase_layer_training(torch, np, dev, gen,
                                                         card)
    phase_layer_profile(torch, engine, batch, card)
    phase_layer_unmasked(torch, engine, batch)
    phase_layer_model_check(torch, ln, sm, engine, batch)
    lap("22-23 rowwise parity+layer")
    del engine, batch
    torch.cuda.empty_cache()
    row_t = phase_rowwise_timing(torch, ln, gl, sm, row_inputs, card)
    del row_inputs
    lap("24 rowwise timing")
    torch.cuda.empty_cache()
    dp1_losses, dp1_state_bytes = phase_resume(torch, np, dev, args.seed,
                                               card)
    lap("29 resume")
    dp_ranks = phase_dp(args.seed, card, dp1_losses, dp1_state_bytes)
    lap("30 dp 2 (and 33, 52-53's ranks)")
    phase_optimizers(torch, np, dev, args.seed, card)
    lap("31 optimizers")
    launches_offload = phase_zero3_offload(torch, np, dev, args.seed, card)
    lap("32 zero3 offload")
    launches_dp = phase_dp_stages(card, dp1_losses, dp_ranks)
    lap("33 zero2/3 dp 2")
    phase_compressed(card, dp_ranks)
    launches_onebit = phase_onebit(card, dp_ranks)
    lap("52-53 1-bit gates (run in 30's ranks)")
    phase_nvme(torch, np, dev, args.seed, card)
    lap("34 nvme")
    launches_parity = phase_streamed_parity(torch, np, dev, args.seed, card)
    lap("35 streamed parity")
    phase_cpu_checkpointing(torch, np, dev, args.seed, card)
    lap("36 cpu checkpointing")
    launches_capacity, cap_name, cap_d = phase_capacity_streamed(
        torch, np, dev, args.seed, card)
    lap("37 capacity streamed")
    phase_sass(_build)
    phase_row_registers(_build)
    phase_sparse_registers(_build)
    phase_decode_registers(_build)
    lap("1 registers+SASS (dumps started after the build)")
    # the capacity pick's launches go to the rows of its head dim
    cap_row = "_d80" if cap_d == 80 else ""

    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:74",
         "launches": launches["decode_attention"], "max_abs_err": da_err,
         **da_t, "bound_ms": da_bound, "bound_by": da_by},
        {"name": "sampling", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sampling.cu",
         "replaces": "deepspeed_tpu/ops/pallas/sampling.py:132",
         "launches": launches["sampling"],
         "launches_sp_prefill_route": route_launches["sampling"],
         "max_abs_err": sp_err,
         **sp_t, "bound_ms": sp_bound, "bound_by": sp_by},
    ] + [
        {"name": name + tag, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": replaces, **counts(name), **(
             {"launches_capacity_streamed": launches_capacity[name],
              "capacity_pick": f"{cap_name} (d {cap_d})"}
             if tag == cap_row else {}),
         "max_abs_err": errs[name], **times[name]}
        for tag, counts, errs, times in (
            ("", lambda name: {
                "launches": launches_train[name],
                "launches_zero3_offload": launches_offload[name],
                "launches_zero2_dp2": launches_dp[2][name],
                "launches_zero3_dp2": launches_dp[3][name],
                "launches_moe_ep2_rank0": launches_ep[name],
                "launches_onebit_dp2_rank0": launches_onebit[name]},
             flash_err, flash_t),
            ("_d80", lambda name: {
                "launches": launches_parity[name]},
             flash_err_d80, flash_t_d80))
        for name, replaces in (
            ("flash_fwd", "deepspeed_tpu/ops/pallas/flash_attention.py:52"),
            ("flash_bwd_dq",
             "deepspeed_tpu/ops/pallas/flash_attention.py:140"),
            ("flash_bwd_dkv",
             "deepspeed_tpu/ops/pallas/flash_attention.py:175"))
    ] + [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sparse_attention.cu",
         "replaces": "deepspeed_tpu/ops/sparse_attention/"
                     f"sparse_self_attention.py:{line}",
         "launches": launches_long[name], "max_abs_err": sparse_err[name],
         **sparse_t[name]}
        for name, line in (("sparse_fwd", 72), ("sparse_bwd_dq", 122),
                           ("sparse_bwd_dkv", 166))
    ] + [
        {"name": name, "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": f"deepspeed_tpu/ops/pallas/decode_attention.py:{line}",
         "launches": launches, "max_abs_err": paged_err[name],
         **paged_t[name]}
        for name, line, launches in (
            ("paged_decode_attention", 351,
             launches_paged["paged_decode_attention"]),
            ("decode_attention_int8", 74,
             launches_int8["decode_attention_int8"]),
            ("paged_decode_attention_int8", 351,
             launches_int8["paged_decode_attention_int8"]))
    ] + [
        {"name": name, "route": "cuda",
         "source": f"deepspeed_tpu_torch/ops/cuda/csrc/{source}",
         "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
         "launches": (launches_gelu if name.startswith("bias_gelu")
                      else launches_layer)[name],
         "max_abs_err": row_err[name], **row_t[name]}
        for name, source, replaces in (
            ("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:22"),
            ("layer_norm_dx", "layer_norm.cu", "layer_norm.py:34"),
            ("bias_gelu_fwd", "gelu.cu", "gelu.py:34"),
            ("bias_gelu_bwd", "gelu.cu", "gelu.py:39"),
            ("softmax_fwd", "softmax.cu", "softmax.py:23"),
            ("softmax_bwd", "softmax.cu", "softmax.py:38"))
    ] + [
        {"name": f"{name}_sq{VERIFY_SQ}", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": f"deepspeed_tpu/ops/pallas/decode_attention.py:{line}",
         "launches": spec_launches[name], "max_abs_err": verify_err[name],
         **verify_t[name]}
        for name, line in (("decode_attention", 74),
                           ("paged_decode_attention", 351),
                           ("decode_attention_int8", 74),
                           ("paged_decode_attention_int8", 351))
    ] + [
        {"name": f"{name}{tag}", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cuh",
         "replaces": f"deepspeed_tpu/ops/pallas/decode_attention.py:{line}",
         "launches": launched[name], **(
             {"launches_sp_prefill_route": route_launches[name]}
             if f"{name}{tag}" == f"decode_attention_sq{FUSED_C}" else {}),
         "max_abs_err": errs[name], **times[name]}
        for tag, launched, errs, times in (
            (f"_sq{FUSED_C}", fused_launches, sq16_err, sq16_t),
            ("_d80", d80_launches, d80_err, d80_t))
        for name, line in (("decode_attention", 74),
                           ("paged_decode_attention", 351),
                           ("decode_attention_int8", 74),
                           ("paged_decode_attention_int8", 351))
    ] + [
        {"name": f"{name}_d80", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sparse_attention.cu",
         "replaces": "deepspeed_tpu/ops/sparse_attention/"
                     f"sparse_self_attention.py:{line}",
         "launches": sparse_d80_launches[name],
         "max_abs_err": sparse_d80_err[name], **sparse_d80_t[name]}
        for name, line in (("sparse_fwd", 72), ("sparse_bwd_dq", 122),
                           ("sparse_bwd_dkv", 166))
    ] + [
        {"name": name, "route": "cuda",
         "source": f"deepspeed_tpu_torch/ops/cuda/csrc/{source}",
         "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
         "launches": launched, **({f"launches_int8_{m}": n
                                   for m, n in neo_int8.items()}
                                  if name == "decode_attention_neo" else {}),
         "max_abs_err": err, **times}
        for name, source, replaces, launched, err, times in neo_rows
    ] + [
        {"name": name, "route": "cuda",
         "source": f"deepspeed_tpu_torch/ops/cuda/csrc/{source}",
         "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
         "launches": launched, **({"launches_moe_training":
                                   moe_train["launches"]["flash_fwd"]}
                                  if name == "flash_fwd_moe" else {}),
         "max_abs_err": err, **times}
        for name, source, replaces, launched, err, times in moe["rows"]
    ] + [
        {"name": f"{name}_moe", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": moe_train["launches"][name],
         "max_abs_err": moe_train["errs"][name], **moe_train["times"][name]}
        for name, line in (("flash_bwd_dq", 140), ("flash_bwd_dkv", 175))
    ] + [
        {"name": name, "route": "cuda",
         "source": f"deepspeed_tpu_torch/ops/cuda/csrc/{source}",
         "replaces": f"deepspeed_tpu/ops/pallas/{replaces}",
         "launches": launched, "tp": NEOX_TP, "max_abs_err": err, **times}
        for name, source, replaces, launched, err, times in neox["rows"]
    ] + [
        {"name": f"{name}_neox", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": neox_train[name], "tp": NEOX_TP,
         "max_abs_err": neox["bwd_err"][name], **neox["flash_t"][name]}
        for name, line in (("flash_bwd_dq", 140), ("flash_bwd_dkv", 175))
    ] + [
        {"name": f"{name}_{tag}", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": sp_launches(ctx, sp_runs, tag, name),
         "max_abs_err": ctx_errs[tag][name], **ctx_t[tag][name]}
        for tag, *_ in SP_FLASH
        for name, line in (("flash_fwd", 52), ("flash_bwd_dq", 140),
                           ("flash_bwd_dkv", 175))
    ] + [
        {"name": f"{name}_pipe", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu",
         "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": pipe_launches["1f1b"][0][name],
         "launches_1f1b_rank1": pipe_launches["1f1b"][1][name],
         "launches_gpipe_rank0": pipe_launches["gpipe"][0][name],
         "launches_gpipe_rank1": pipe_launches["gpipe"][1][name],
         "max_abs_err": pipe_errs[name], **pipe_t[name]}
        for name, line in (("flash_fwd", 52), ("flash_bwd_dq", 140),
                           ("flash_bwd_dkv", 175))
    ] + [
        {"name": "sampling_filter", "route": "cuda",
         "source": "deepspeed_tpu_torch/ops/cuda/csrc/sampling.cu",
         "replaces": "deepspeed_tpu/ops/pallas/sampling.py:132",
         "launches": filter_launches, "max_abs_err": filter_err,
         **filter_t},
    ]
    print(f"chip_smoke total_s={time.perf_counter() - t_start} "
          f"card={card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
